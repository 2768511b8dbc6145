"""The port's int8 gradient compression with error feedback
(``repro_torch.training.compression``): the reference's four tests
(tests/test_compression.py) on the port, the same numpy inputs through
both packages (int8 values, scales, dequantized grads and residuals equal
bit for bit), and ``compressed_psum`` on a 4-process ``gloo`` world."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.training import compression as C  # noqa: E402

torch.set_num_threads(1)


def test_quantize_roundtrip_bounded():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(128,)) * 3).astype(np.float32))
    q, scale = C.quantize_int8(x)
    err = torch.abs(C.dequantize_int8(q, scale) - x)
    assert float(torch.max(err)) <= float(scale) / 2 + 1e-6
    assert q.dtype == torch.int8


def test_error_feedback_accumulates_residual():
    grads = {"w": torch.tensor([1e-4, 2e-4, 0.5])}
    err = C.init_error_feedback(grads)
    comp, err = C.compress_grads(grads, err)
    assert float(torch.abs(err["w"][0])) > 0
    np.testing.assert_allclose((comp["w"] + err["w"]).numpy(),
                               grads["w"].numpy(), atol=1e-7)


def test_compressed_sgd_converges_like_exact():
    target = torch.tensor([1.0, -2.0, 3.0])
    for compressed in (False, True):
        w = {"w": torch.zeros(3)}
        err = C.init_error_feedback(w)
        for _ in range(300):
            g = {"w": 2 * (w["w"] - target)}
            if compressed:
                g, err = C.compress_grads(g, err)
            w = {"w": w["w"] - 0.05 * g["w"]}
        np.testing.assert_allclose(w["w"].numpy(), target.numpy(), atol=0.05)


def test_compression_traffic_ratio():
    x = torch.zeros(1024)
    q, _ = C.quantize_int8(x)
    assert q.numel() * q.element_size() * 4 == x.numel() * x.element_size()


def _inputs():
    rng = np.random.default_rng(7)
    halves = (np.arange(-254, 255, dtype=np.float32) / 2)   # .5 ties
    return {"normal": (rng.standard_normal((64, 33)) * 3).astype(np.float32),
            "ties": halves,
            "tiny": (rng.standard_normal(40) * 1e-30).astype(np.float32),
            "zeros": np.zeros((5, 3), np.float32)}


@pytest.mark.parametrize("name", sorted(_inputs()))
def test_int8_values_and_scales_equal_the_reference(name):
    jnp = pytest.importorskip("jax.numpy")
    from repro.training import compression as JC
    x = _inputs()[name]
    jq, js = JC.quantize_int8(jnp.asarray(x))
    q, s = C.quantize_int8(torch.from_numpy(x))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert s.dtype == torch.float32
    assert np.asarray(js).tobytes() == s.numpy().tobytes()
    assert np.array_equal(C.dequantize_int8(q, s).numpy(),
                          np.asarray(JC.dequantize_int8(jq, js)))


def test_compress_grads_equal_the_reference():
    jax = pytest.importorskip("jax")
    from repro.training import compression as JC
    x = _inputs()
    grads = {"a": x["normal"], "b": [x["ties"], x["tiny"]]}
    rng = np.random.default_rng(8)
    err = {"a": (rng.standard_normal((64, 33)) * 0.01).astype(np.float32),
           "b": [np.zeros_like(x["ties"]), np.zeros_like(x["tiny"])]}
    jc, je = JC.compress_grads(jax.tree.map(jax.numpy.asarray, grads),
                               jax.tree.map(jax.numpy.asarray, err))
    tt = lambda tree: jax.tree.map(torch.from_numpy, tree)  # noqa: E731
    tc, te = C.compress_grads(tt(grads), tt(err))
    for a, b in zip(jax.tree.leaves(tc), jax.tree.leaves(jc)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(jax.tree.leaves(te), jax.tree.leaves(je)):
        assert np.array_equal(a.numpy(), np.asarray(b))


# ----------------------------------------------- 4-process world ----

def _grads(rank):
    g = torch.Generator().manual_seed(100 + rank)
    return {"w": torch.randn(6, 5, generator=g) * (rank + 1),
            "layers": [{"b": torch.randn(7, generator=g)}]}


def _psum_worker(rank, tmp):
    from test_torch_sharded_model import init_world
    init_world(rank, tmp)
    try:
        err = C.init_error_feedback(_grads(rank))
        got, new_err = C.compressed_psum(_grads(rank), None, err)
        comp = [C.compress_grads(_grads(r), err)[0] for r in range(4)]
        want = {"w": sum(c["w"] for c in comp) / 4,
                "b": sum(c["layers"][0]["b"] for c in comp) / 4}
        out = {"w": float((got["w"] - want["w"]).abs().max()),
               "b": float((got["layers"][0]["b"] - want["b"]).abs().max()),
               "scale": float(want["w"].abs().max()),
               "err_exact": bool(torch.equal(
                   new_err["w"], C.compress_grads(_grads(rank), err)[1]["w"]))}
        with open(f"{tmp}/psum{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def test_compressed_psum_is_the_mean_of_the_compressed_grads(tmp_path):
    from test_torch_sharded_model import run_world
    run_world(_psum_worker, tmp_path, timeout=120)
    for rank in range(4):
        with open(tmp_path / f"psum{rank}.json") as f:
            out = json.load(f)
        assert out["err_exact"]
        # the all-reduce sums in its own order: within fp32 rounding
        assert out["w"] <= 1e-6 * out["scale"] and out["b"] <= 1e-6
