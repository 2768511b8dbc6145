"""The port's ``Model`` against ``repro.models.Model`` with the same weights,
carried across by ``repro_torch.bridge``.

Logits are held to the repo's cross-implementation bound, max|dlogits| <
0.02 x the reference's logit spread (tests/test_engine_batching.py), for
``prefill``, ``prefill_batched`` (ragged), ``prefill_resume`` and a 10-step
forced decode walk (the same token fed to both sides each step) under all
four decode impls.  Greedy token streams are not compared across
frameworks: argmax flips on near-ties.  The model runs G = 3 query heads
per KV head, as the full-width Phi-4-mini does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving.engine import adopt_prefill_pages as jax_adopt  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving.engine import adopt_prefill_pages  # noqa: E402

torch.set_num_threads(1)

G3 = dict(num_heads=6, num_kv_heads=2)
MAX_LEN = 96


@pytest.fixture(scope="module")
def models():
    jcfg = jax_reduced("phi4-mini-3.8b", **G3)
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0), jnp.bfloat16)
    tcfg = get_reduced("phi4-mini-3.8b", **G3)
    tm = Model(tcfg)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    tp = params_from_numpy(tree, tcfg, dtype=torch.bfloat16, device="cpu")
    return jm, jp, tm, tp


def _prompt(template, n, vocab=512):
    return [(template * 1_000_003 + 7 * i) % vocab for i in range(n)]


def _assert_logits(port, ref):
    port = port.float().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    for row_p, row_r in zip(port.reshape(-1, ref.shape[-1]),
                            ref.reshape(-1, ref.shape[-1])):
        spread = float(row_r.max() - row_r.min())
        assert float(np.abs(row_p - row_r).max()) < 0.02 * spread


def test_bridge_is_exact(models):
    jm, jp, tm, tp = models
    assert len(tp["layers"]) == tm.n_layers
    for i, layer in enumerate(tp["layers"]):
        for block in ("attn", "mlp"):
            for name, t in layer[block].items():
                if name == "norm":
                    continue
                ref = np.asarray(jp["stack"]["p0"][block][name][i], np.float32)
                assert t.dtype == torch.bfloat16
                assert np.array_equal(t.float().numpy(), ref)
    assert np.array_equal(tp["unembed"].float().numpy(),
                          np.asarray(jp["unembed"], np.float32))


def test_prefill_and_caches(models):
    jm, jp, tm, tp = models
    toks = np.array([_prompt(0, 40), _prompt(1, 40)], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        max_len=MAX_LEN)
    assert tl.dtype == torch.float32
    _assert_logits(tl, jl)
    for n in "kv":
        ref = np.asarray(jc["p0"]["kv"][n], np.float32)
        assert tc[n].shape == ref.shape           # (P, B, T, K, hd)
        assert float(np.abs(tc[n].float().numpy() - ref).max()) <= \
            2e-2 * max(1.0, float(np.abs(ref).max()))


def test_prefill_batched_ragged(models):
    jm, jp, tm, tp = models
    lengths = np.array([48, 33, 40, 17], np.int32)
    toks = np.zeros((4, 48), np.int32)
    for r, n in enumerate(lengths):
        toks[r, :n] = _prompt(r, n)
    jl, _ = jm.prefill_batched(jp, jnp.asarray(toks), jnp.asarray(lengths),
                               max_len=MAX_LEN)
    tl, _ = tm.prefill_batched(tp, torch.from_numpy(toks),
                               torch.from_numpy(lengths), max_len=MAX_LEN)
    _assert_logits(tl, jl)


def test_prefill_resume_leaves_donor(models):
    jm, jp, tm, tp = models
    donor = np.array([_prompt(2, 45)], np.int32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(donor)}, max_len=MAX_LEN)
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(donor)},
                       max_len=MAX_LEN)
    before = {n: t.clone() for n, t in tc.items()}
    full = _prompt(2, 56)
    suffix = np.array([full[32:]], np.int32)
    jl, _ = jm.prefill_resume(jp, jc, jnp.asarray(suffix), 32)
    tl, _ = tm.prefill_resume(tp, tc, torch.from_numpy(suffix), 32)
    _assert_logits(tl, jl)
    # and the resumed pass equals the cold pass of the whole prompt
    cold, _ = tm.prefill(tp, {"tokens": torch.tensor([full])},
                         max_len=MAX_LEN)
    _assert_logits(tl, cold.numpy())
    for n in "kv":
        assert torch.equal(tc[n], before[n])   # the donor is untouched


def _paged_pools(jm, tm, jc, tc, lengths, pages):
    """Both sides' page pools, each row's prefill K/V adopted into its
    pages (non-contiguous ids, trash page 0 left free), and the table."""
    width = max(len(p) for p in pages)
    table = np.zeros((len(pages), width), np.int32)
    jpool = jm.paged_cache_init(12, 16)
    tpool = tm.paged_cache_init(12, 16, "cpu")
    for r, ids in enumerate(pages):
        table[r, :len(ids)] = ids
        row = jax.tree.map(lambda a, r=r: a[:, r:r + 1], jc)
        jpool = jax_adopt(jpool, row, jnp.asarray(ids, jnp.int32), block=16)
        adopt_prefill_pages(tpool, tc, r, torch.tensor(ids), block=16)
    return jpool, tpool, table


@pytest.mark.parametrize("impl", ["sdpa", "pallas", "paged_sdpa", "paged"])
def test_forced_decode_walk(models, impl):
    """Two ragged rows (a (B,) position vector) decode 10 steps; each step
    both sides get the reference's argmax."""
    jm, jp, tm, tp = models
    lengths = np.array([37, 22], np.int32)
    toks = np.zeros((2, 48), np.int32)
    for r, n in enumerate(lengths):
        toks[r, :n] = _prompt(r + 3, n)
    jl, jc = jm.prefill_batched(jp, jnp.asarray(toks), jnp.asarray(lengths),
                                max_len=MAX_LEN)
    _, tc = tm.prefill_batched(tp, torch.from_numpy(toks),
                               torch.from_numpy(lengths), max_len=MAX_LEN)
    table = None
    if impl.startswith("paged"):
        # pages cover every position the walk writes (37 + 10 < 3 * 16)
        jc, tc, table = _paged_pools(jm, tm, jc, tc, lengths,
                                     [[4, 9, 2], [7, 11]])
    step_fn = jax.jit(lambda p, c, t, i, tb: jm.decode(
        p, c, t, i, decode_impl=impl, page_table=tb))
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    for step in range(10):
        cur = lengths + step
        jl, jc = step_fn(jp, jc, jnp.asarray(tok)[:, None], jnp.asarray(cur),
                         None if table is None else jnp.asarray(table))
        tl, tc = tm.decode(tp, tc, torch.from_numpy(tok)[:, None],
                           torch.from_numpy(cur), decode_impl=impl,
                           page_table=None if table is None
                           else torch.from_numpy(table))
        _assert_logits(tl, jl)
        tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)


def test_encdec_and_vlm_families_build():
    """The port builds every family: dense, MoE, hybrid and SSM
    (tests/test_torch_moe_model.py, tests/test_torch_hybrid_model.py), and
    the encoder-decoder and VLM (tests/test_torch_encdec_vlm.py), which it
    refused until it ran them."""
    import dataclasses
    cfg = get_reduced("phi4-mini-3.8b")
    assert Model(get_reduced("qwen3-moe-30b-a3b")).cfg.moe is not None
    encdec = Model(dataclasses.replace(
        cfg, family="encdec", num_encoder_layers=2, cross_attention=True,
        frontend="audio", frontend_dim=64))
    assert all(d.cross for d in encdec.descs)
    assert set(encdec.cache_init(1, 16, "cpu")) == {"k", "v", "xk", "xv"}
    vlm = Model(get_reduced("phi-3-vision-4.2b"))
    assert not any(d.cross for d in vlm.descs)
    assert set(vlm.cache_init(1, 16, "cpu")) == {"k", "v"}
