"""The port's cost counter (``repro_torch.launch.jaxpr_cost``), its
roofline terms and report, and the model's dry-run methods, against the
reference's.

* The six tests of tests/test_jaxpr_cost.py on the port: a 10-step Python
  loop stands for the scan, ``torch.utils.checkpoint`` for the remat.
* The FLOPs of the contractions in a reduced prefill (B = 2, S = 64, meta
  tensors) against the ``dot_general`` FLOPs of the reference's jaxpr of
  the same prefill: equal for the dense and MoE models.  The recurrent
  mixers compute three products by another algorithm than the reference
  (each named below), and those remainders are held to their size; the
  total FLOPs to within ``TOTAL_RATIO``.
* ``input_specs``, ``cache_specs`` and ``model_flops`` for every config and
  every shape that applies to it.
* ``roofline_terms`` on fixed inputs, and the roofline report over a JSONL
  fixture, equal to the reference's but for its header.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro_torch.configs import SHAPES, get_config, get_reduced, shape_applicable  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS  # noqa: E402
from repro_torch.launch import hlo_analysis, roofline  # noqa: E402
from repro_torch.launch.jaxpr_cost import cost_of  # noqa: E402
from repro_torch.models import Model  # noqa: E402

ARCHS = [*ASSIGNED_ARCHS, "llama-3.1-70b"]
CELLS = [(a, s) for a in ARCHS for s in SHAPES
         if shape_applicable(get_config(a), SHAPES[s])]


# ------------------------------------------- tests/test_jaxpr_cost.py ----

def test_matmul_flops_exact():
    a = torch.zeros((8, 16))
    b = torch.zeros((16, 32))
    c = cost_of(lambda x, y: x @ y, a, b)
    assert c.flops == 2 * 8 * 16 * 32
    # bytes: operands + result
    assert c.bytes == (8 * 16 + 16 * 32 + 8 * 32) * 4


def test_batched_einsum_flops():
    a = torch.zeros((4, 8, 16))
    b = torch.zeros((4, 16, 32))
    c = cost_of(lambda x, y: torch.einsum("bij,bjk->bik", x, y), a, b)
    assert c.flops == 2 * 4 * 8 * 16 * 32


def test_loop_counts_every_trip():
    w = torch.zeros((16, 16))

    def one(x):
        return x @ w

    def looped(x):
        for _ in range(10):
            x = x @ w
        return x

    x = torch.zeros((16, 16))
    assert cost_of(looped, x).flops == pytest.approx(
        10 * cost_of(one, x).flops, rel=0.01)


def _grad(fn):
    return lambda w: torch.autograd.grad(fn(w), w)


def test_grad_includes_backward():
    w = torch.ones((32, 32), requires_grad=True)
    x = torch.ones((4, 32))

    def loss(w):
        return torch.sum((x @ w) ** 2)

    fwd = cost_of(loss, w)
    both = cost_of(_grad(loss), w)
    assert both.flops >= 1.9 * fwd.flops  # fwd + bwd matmul(s)


def test_remat_adds_recompute():
    w = torch.ones((32, 32), requires_grad=True)
    x = torch.ones((4, 32))

    def block(w):
        h = x @ w
        for _ in range(4):
            h = torch.tanh(h @ w)
        return torch.sum(h)

    plain = cost_of(_grad(block), w)
    remat = cost_of(_grad(lambda w: checkpoint(block, w,
                                               use_reentrant=False)), w)
    assert remat.flops > plain.flops  # recompute visible in the trace


def test_elementwise_and_reduce():
    x = torch.zeros((100,))
    c = cost_of(lambda x: torch.sum(x * 2.0), x)
    assert 100 <= c.flops <= 310  # mul (100) + reduce (100) (+ broadcasting)


# --------------------------------- contractions against dot_general ----

B, S = 2, 64
# |port total / reference total - 1| of a prefill's FLOPs: the composites
# follow the reference's decompositions, but the recurrent mixers compute
# some elementwise chains another way (a sigmoid as 1 / (1 + exp(-x)), a
# masked exp); measured at most 0.4% (jamba)
TOTAL_RATIO = 0.01


def _remainder(arch, cfg):
    """FLOPs of the reference's contractions that the port computes by
    another algorithm in a prefill of B x S, each named:

    * mLSTM, each layer and chunk of L positions: the reference pairs
      "bijh,bijh,bjhp->bihp" first as (scores, intra weights), a
      dot_general of 2·B·L²·H that the port does as an elementwise ``mul``
      before its ``matmul``; its denominator "bijh,bijh->bih", another
      2·B·L²·H, which the port takes as a ``sum`` of that product; and its
      state update "bjh,bjhp,bjhq->bhpq" pairs (w_end, k) first, 2·B·L·H·P,
      an elementwise ``mul`` in the port.
    * Mamba-2 SSD, each layer and chunk: "bijh,bjh,bjhp->bihp" pairs (dt,
      x) first, 2·B·L·H·P, and the state update "bjn,bjh,bjhp->bhnp" pairs
      (w, x) first, 2·B·L·H·P: both an elementwise ``mul`` in the port."""
    model = Model(cfg)
    if arch == "xlstm-125m":
        h = cfg.num_heads
        p = cfg.xlstm.proj_factor * cfg.d_model // h
        chunk = min(cfg.xlstm.chunk, S)
        per_chunk = 4 * B * chunk * chunk * h + 2 * B * chunk * h * p
        return model.mixers.count("mlstm") * (S // chunk) * per_chunk
    if arch == "jamba-v0.1-52b":
        s = cfg.ssm
        h = s.expand * cfg.d_model // s.head_dim
        chunk = min(s.chunk, S)
        per_chunk = 2 * (2 * B * chunk * h * s.head_dim)
        return model.mixers.count("mamba") * (S // chunk) * per_chunk
    return 0


def _ref_by_primitive(jaxpr, mult=1, out=None):
    """The reference counter's FLOPs (jaxpr_cost.py:119-141) by primitive."""
    from repro.launch import jaxpr_cost as jc
    out = {} if out is None else out
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "scan":
            body = eqn.params["jaxpr"]
            _ref_by_primitive(getattr(body, "jaxpr", body),
                              mult * int(eqn.params["length"]), out)
        elif name == "while":
            body = eqn.params["body_jaxpr"]
            _ref_by_primitive(getattr(body, "jaxpr", body), mult, out)
        elif name == "cond":
            subs = [getattr(b, "jaxpr", b) for b in eqn.params["branches"]]
            _ref_by_primitive(max(subs, key=lambda j: jc.jaxpr_cost(j).flops),
                              mult, out)
        elif name in jc._CALL_PRIMS or any(True for _ in jc._subjaxprs(eqn)):
            for sub in jc._subjaxprs(eqn):
                _ref_by_primitive(sub, mult, out)
        else:
            out[name] = out.get(name, 0.0) + jc._eqn_cost(eqn).flops * mult
    return out


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "qwen3-moe-30b-a3b",
                                  "xlstm-125m", "jamba-v0.1-52b"])
def test_prefill_contractions_equal_dot_general(arch):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_reduced as jax_reduced
    from repro.models.model import Model as JaxModel
    jm = JaxModel(jax_reduced(arch))
    jaxpr = jax.make_jaxpr(jm.prefill)(
        jm.init_abstract(jnp.bfloat16),
        {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}).jaxpr
    ref = _ref_by_primitive(jaxpr)
    cfg = get_reduced(arch)
    model = Model(cfg)
    cost = cost_of(model.prefill, model.init_abstract(torch.bfloat16),
                   {"tokens": torch.zeros((B, S), dtype=torch.int32,
                                          device="meta")})
    remainder = _remainder(arch, cfg)
    assert ref["dot_general"] - cost.contraction_flops() == remainder
    if arch in ("phi4-mini-3.8b", "qwen3-moe-30b-a3b"):
        assert remainder == 0
    total = sum(ref.values())
    assert abs(cost.flops / total - 1) <= TOTAL_RATIO


# ------------------------------------------------ dry-run methods ----

def _jax_model(arch):
    pytest.importorskip("jax")
    from repro.configs import get_config as jax_config
    from repro.models.model import Model as JaxModel
    return JaxModel(jax_config(arch))


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_and_model_flops_equal_reference(arch, shape):
    jm = _jax_model(arch)
    model = Model(get_config(arch))
    ref = jm.input_specs(SHAPES[shape])
    got = model.input_specs(SHAPES[shape])
    assert sorted(got) == sorted(ref)
    for name, spec in ref.items():
        assert got[name].is_meta
        assert tuple(got[name].shape) == tuple(spec.shape), name
        assert _dtype(got[name]) == str(spec.dtype), name
    assert model.model_flops(SHAPES[shape]) == jm.model_flops(SHAPES[shape])


# the reference's per-period cache leaves: (its path keys) by the port's
# leaf name
def _ref_leaf(name):
    if name in ("k", "v"):
        return "attn", ("kv", name)
    if name in ("xk", "xv"):
        return None, (name,)
    for kind in ("mlstm", "slstm"):
        if name.startswith(kind + "_"):
            return kind, ("state", name[len(kind) + 1:])
    return "mamba", ("state", name)


@pytest.mark.parametrize("arch,shape", [c for c in CELLS
                                        if SHAPES[c[1]].kind == "decode"])
def test_cache_specs_equal_reference(arch, shape):
    """Total bytes equal, and each leaf kind's per-layer slice has the
    reference's per-layer leaf shape and dtype (the port stacks by leaf
    kind, the reference by period)."""
    jm = _jax_model(arch)
    model = Model(get_config(arch))
    ref = jm.cache_specs(SHAPES[shape])
    got = model.cache_specs(SHAPES[shape])
    ref_bytes = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                    for x in _jax_leaves(ref))
    assert sum(t.numel() * t.element_size() for t in got.values()) \
        == ref_bytes
    for name, t in got.items():
        assert t.is_meta
        kind, keys = _ref_leaf(name)
        rows = [i for i, d in enumerate(model.descs)
                if (d.cross if kind is None else d.mixer == kind)]
        assert rows, name
        for i in rows:
            leaf = ref[f"p{i}"]
            for k in keys:
                leaf = leaf[k]
            assert tuple(t.shape[1:]) == tuple(leaf.shape[1:]), name
            assert _dtype(t) == str(leaf.dtype), name
        assert t.shape[0] == len(rows) * model.n_periods, name


def _jax_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _jax_leaves(v)
    else:
        yield tree


# ------------------------------------------ roofline terms and report ----

def test_roofline_terms_on_fixed_inputs():
    coll = hlo_analysis.CollectiveStats()
    coll.total_bytes = 4.5e9
    terms = hlo_analysis.roofline_terms(
        {"flops": 989e12, "bytes accessed": 6.7e12}, coll)
    assert terms["compute_s"] == pytest.approx(1.0)
    assert terms["memory_s"] == pytest.approx(2.0)
    assert terms["collective_s"] == pytest.approx(0.01)
    assert terms["bottleneck"] == "memory"
    assert terms["roofline_fraction"] == pytest.approx(0.5)
    assert terms["hlo_flops_per_device"] == 989e12
    assert terms["collective_bytes_per_device"] == 4.5e9
    idle = hlo_analysis.roofline_terms({}, hlo_analysis.CollectiveStats())
    assert idle["roofline_fraction"] == 0.0


def _record(arch, shape, mesh, c, m, k, args_gib, temp_gib, useful):
    terms = {"compute_s": c, "memory_s": m, "collective_s": k}
    return {"arch": arch, "shape": shape, "mesh": mesh, "skipped": False,
            "roofline": {**terms, "bottleneck": max(
                terms, key=terms.get).replace("_s", ""),
                "roofline_fraction": c / max(c, m, k)},
            "useful_flops_ratio": useful,
            "memory": {"argument_size_in_bytes": args_gib * 2**30,
                       "temp_size_in_bytes": temp_gib * 2**30}}


def test_report_equals_reference(tmp_path, capsys, monkeypatch):
    from repro.launch import roofline as ref_roofline
    recs = [_record("phi4-mini-3.8b", "decode_32k", "16x16", 1e-4, 5e-3,
                    2e-3, 0.5, 1.2, 0.9),
            _record("nemotron-4-340b", "decode_32k", "16x16", 2e-3, 1e-2,
                    3e-2, 3.0, 0.4, 0.7),
            _record("xlstm-125m", "train_4k", "16x16", 4e-2, 1e-2, 1e-3,
                    0.1, 2.5, 0.5),
            {"arch": "x", "shape": "long_500k", "skipped": True}]
    path = tmp_path / "cells.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    got, ref = roofline.load([path]), ref_roofline.load([path])
    assert got == ref and len(got) == 3
    assert roofline.report(got) == ref_roofline.report(ref)
    assert roofline.report(got, "16x16") == ref_roofline.report(ref, "16x16")
    assert roofline.summarize(got) == ref_roofline.summarize(ref)
    outs = []
    for mod in (roofline, ref_roofline):
        monkeypatch.setattr("sys.argv", ["roofline", str(path)])
        mod.main()
        outs.append(capsys.readouterr().out.splitlines())
    assert outs[0][0].startswith("# Roofline (H100 SXM constants: 989 "
                                 "TFLOP/s, 3350 GB/s HBM, 450 GB/s NVLink)")
    assert outs[0][1:] == outs[1][1:]
