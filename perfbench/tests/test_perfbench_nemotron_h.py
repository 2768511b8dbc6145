"""The Nemotron-H architecture (``architectures/nemotron_h.py``) and its
reference (``reference/nemotron_h.py``) against the program, at a tiny
size on the CPU.

The hooks describe the program's own tree: every leaf of ``Model.init``
is a random leaf or a skeleton leaf, at its shape, in the order one
generator draws them.  A pattern or a group count that differs from the
program's stops a run.  The FLOP and byte counts of the configuration's
stage are held to goldens worked out by hand.  A tiny cell runs through
``report.run_cell``: the sound run is ``correct`` and the fp8 control lies
further off; a hand-off that leaves the recurrent state at zero, or a
decode step that leaves it unchanged, makes ``correct`` false."""
import json
import math
import time

import pytest
import torch

import architectures
from harness import report, weights
from harness.spec import BENCH_DIR, Cell, ROOT, program_config
from harness.serve import Harness

ARCH = architectures.load({"architecture": "nemotron_h"})
CONFIG = json.loads((BENCH_DIR / "configs" / "nemotron-h-47b.json")
                    .read_text())
STAGE = CONFIG["model"]
CLOSED = {"generator": "closed_loop",
          "deployment": {"decoders": 2, "slots": 4, "max_len": 160,
                         "decode_impl": "pallas", "num_pages": None},
          "clients": 12, "ramp_s": 0.5, "requests_per_client": 4,
          "prompt_len": [16, 64], "output_len": [6, 16]}
LIMIT = 0.25       # the sound tiny run reads ~0; faults read > 1


def registry(pattern="M-*--M*M", **kw):
    from repro_torch.configs.nemotron_h_47b import reduced
    return reduced(pattern, **kw)


def model_of(cfg) -> dict:
    """The published keys of the program's config ``cfg``."""
    s = cfg.ssm
    return {"num_hidden_layers": cfg.num_layers, "hidden_size": cfg.d_model,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "attention_head_dim": cfg.head_dim,
            "intermediate_size": cfg.d_ff, "vocab_size": cfg.vocab_size,
            "layer_norm_epsilon": cfg.norm_eps,
            "hybrid_override_pattern": cfg.layer_pattern,
            "mamba_num_heads": s.expand * cfg.d_model // s.head_dim,
            "mamba_head_dim": s.head_dim, "n_groups": s.n_groups,
            "ssm_state_size": s.d_state, "conv_kernel": s.d_conv,
            "expand": s.expand, "chunk_size": s.chunk,
            "mlp_hidden_act": "relu2", "time_step_min": 0.001,
            "time_step_max": 0.1}


def cell(limit=LIMIT, model=None) -> Cell:
    e2e = [{"name": "output_tokens_per_s", "unit": "tokens/s"},
           {"name": "setup_s", "unit": "s"}]
    m = model or model_of(registry())
    return Cell("tiny.hybrid", 1, {"name": "tiny", "architecture":
                                   "nemotron_h", "model": m},
                json.loads(json.dumps(CLOSED)),
                {"logit_gap": limit, "requests": 4}, e2e, [])


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


def test_hooks_describe_the_programs_tree():
    from repro_torch.models.model import Model
    reg = registry()
    m = model_of(reg)
    assert ARCH.mismatches(m, reg) == []
    want = dict(_flat(Model(reg).init(torch.Generator().manual_seed(0),
                                      torch.bfloat16, "cpu")))
    random = [(tuple(p), tuple(s)) for p, s, _ in ARCH.leaves(m)]
    fixed = dict(_flat(ARCH.skeleton(m, "cpu")))
    assert len(random) + len(fixed) == len(want)
    assert {p for p, _ in random}.isdisjoint(fixed)
    for p, s in random:
        assert tuple(want[p].shape) == s, p
    for p, t in fixed.items():
        assert t.shape == want[p].shape and t.dtype == torch.bfloat16, p
    # draw order: the embedding, the unembedding, then layer by layer
    assert [p[:2] for p, _ in random[:3]] == [("embed",), ("unembed",),
                                             ("layers", 0)]
    layers = [p[1] for p, _ in random[2:]]
    assert layers == sorted(layers)
    sk = ARCH.skeleton(m, "cpu")["layers"][0]["mamba"]
    assert torch.equal(sk["A_log"].float().exp().round(),
                       torch.arange(1.0, 5.0))
    dt = torch.nn.functional.softplus(sk["dt_bias"].float())
    assert 0.0009 < float(dt[0]) < 0.0011 and 0.09 < float(dt[-1]) < 0.11
    w = weights.make_weights(ARCH, m, 2 ** 31 + 3, "cpu")
    assert dict((p, tuple(t.shape)) for p, t in _flat(w)) == \
        {p: tuple(t.shape) for p, t in want.items()}


@pytest.mark.parametrize("change,line", [
    ({"hybrid_override_pattern": "M-*--M**"},
     "hybrid_override_pattern: file M-*--M**, program M-*--M*M"),
    ({"n_groups": 4}, "n_groups: file 4, program 2"),
    ({"ssm_state_size": 8}, "ssm_state_size: file 8, program 4")])
def test_a_changed_pattern_or_width_stops_the_run(change, line):
    m = dict(model_of(registry()), **change)
    assert line in ARCH.mismatches(m, registry())
    with pytest.raises(ValueError, match="differs from the benchmark's"):
        Harness(cell(model=m), 1, "cpu", registry())


def test_the_stage_is_the_published_model_cut_in_depth():
    full = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in full["configs"] if c["name"] == CONFIG["name"])
    assert entry["reduced"] == ["num_hidden_layers",
                                "hybrid_override_pattern"]
    pattern = CONFIG["published"]["hybrid_override_pattern"]
    assert STAGE["hybrid_override_pattern"] == pattern[:19]
    assert STAGE["num_hidden_layers"] == 19
    assert [pattern.count(k) for k in "M-*"] == [45, 48, 5]
    assert ARCH.mismatches(STAGE, program_config(CONFIG)) == []
    assert sum(math.prod(s) for _, s, _ in ARCH.leaves(STAGE)) \
        == 10_773_991_424


def test_the_file_states_its_model_at_the_top_level_too():
    """The source's keys stand at the file's top level, as the published
    config has them, and again under ``model``, which the harness reads:
    the two say the same."""
    assert {k: CONFIG[k] for k in STAGE} == STAGE
    assert len(STAGE) == 37


def test_flop_and_byte_goldens():
    """The stage (d 8192; 9 Mamba layers of 256 heads of 64, 8 groups of
    state 256; 9 MLPs of 30,720; one attention layer of 64 / 8 heads of
    128; vocab 131,072), counted by hand."""
    d, v = 8192, 131072
    mamba = d * (2 * 16384 + 2 * 8 * 256 + 256) + 16384 * d
    attn = 2 * d * 64 * 128 + 2 * d * 8 * 128
    mlp = 2 * d * 30720
    matmul = 9 * mamba + attn + 9 * mlp
    scan = 9 * 256 * 4 * 256 * 64
    # a 1,000-token cold pass: every token through the layers, the keys
    # each query sees in the one attention layer, the last token's logits
    keys = 1000 * 1001 / 2
    assert ARCH.prompt_flops(STAGE, 0, 1000) == \
        1000 * (2.0 * matmul + scan) + 2.0 * d * v + 4.0 * 64 * 128 * keys
    assert ARCH.decode_flops(STAGE, [99, 4095]) == \
        2 * (2.0 * matmul + scan + 2.0 * d * v) \
        + 4.0 * 64 * 128 * (100 + 4096)
    state = 9 * (4 * 256 * 256 * 64 + 2 * 3 * 20480)
    assert ARCH.state_bytes(STAGE) == state == 152_100_864
    w = 2 * (9 * (mamba + 4 * 20480 + 20480 + 3 * 256 + d + 16384)
             + attn + d + 9 * (mlp + d) + d * v + d)
    per_key = 2 * 8 * 128 * 2
    assert ARCH.decode_bytes(STAGE, [99, 4095]) == \
        w + 2 * (2 * d + 2 * state) + per_key * (100 + 4096)
    assert ARCH.decode_attention_layers(STAGE) == 1
    assert ARCH.attention_widths(STAGE) == (64, 8, 128)
    assert ARCH.vocab(STAGE) == v


def test_hbm_share_reads_the_device_time_of_the_traced_steps():
    """``step.hbm_share.hybrid``: the traced steps' least bytes over their
    ``decode`` ranges less the idle gaps the trace put in them; a step
    before the profiler opened counts in neither sum, and an untraced run
    or an architecture without ``decode_bytes`` reads nothing."""
    from harness.load import load_module
    from harness.serve import Run
    from harness.trace import Trace
    share = load_module(BENCH_DIR / "metrics" / "step.hbm_share.hybrid.py")
    run = Run(STAGE, {}, "cuda", ARCH)
    run.device_kind = "NVIDIA H100 80GB HBM3"
    run.w0, run.w1 = 0.0, 10.0
    run.decode_steps = [(1.0, 1.5, [99, 0], [99]),
                        (2.0, 2.03, [100, 4095], [100, 4095]),
                        (2.1, 2.13, [101, 4096], [101, 4096]),
                        (9.0, 9.5, [102, 0], [102])]
    assert share.read(run) is None
    run.traced_from = 1.9
    run.traced_steps = [(ls, live) for _, _, ls, live in run.decode_steps[1:3]]
    run.trace = Trace(1.0, 0.5, {}, {"decode": 0.01, "harness": 0.2})
    moved = (ARCH.decode_bytes(STAGE, [100, 4095])
             + ARCH.decode_bytes(STAGE, [101, 4096]))
    assert share.read(run) == pytest.approx(
        100 * moved / ((0.06 - 0.01) * 3.35e12))
    run.trace.idle["decode"] = 0.06              # no device time left
    assert share.read(run) is None
    run.trace.idle["decode"] = 0.01
    run.arch = object()
    assert share.read(run) is None


def _run(limit=LIMIT, control=False):
    return report.run_cell(cell(limit), 2 ** 31 + 29, 2.0, False, "cpu",
                           time.perf_counter(), registry=registry(),
                           control=control)


def test_sound_run_is_correct_and_the_control_lies_further():
    res = _run(control=True)
    assert res["correct"], res["checks"]
    gap = res["checks"]["logit_gap"]["value"]
    assert gap < LIMIT / 3
    assert res["_control_gap"] > 3 * max(gap, 1e-3)
    n, toks = res["_compared"]
    assert n == 4 and toks > 20


def _patch(monkeypatch, owner, name, make):
    monkeypatch.setattr(owner, name, make(getattr(owner, name)))


def test_state_left_zero_in_the_hand_off(monkeypatch):
    from repro_torch.serving import engine

    def make(fn):
        def admit(self, slot, rid, caches, *a, **k):
            out = fn(self, slot, rid, caches, *a, **k)
            for name in self.model.state_leaves:
                self.caches[name][:, slot] = 0
            return out
        return admit
    _patch(monkeypatch, engine.DecodeEngine, "admit", make)
    assert not _run()["correct"]


def test_decode_state_unchanged(monkeypatch):
    from repro_torch.models.model import Model

    def make(fn):
        def decode(self, params, caches, *a, **k):
            kept = {n: caches[n].clone() for n in self.state_leaves}
            logits, _ = fn(self, params, caches, *a, **k)
            for n, t in kept.items():
                caches[n].copy_(t)
            return logits, caches
        return decode
    _patch(monkeypatch, Model, "decode", make)
    assert not _run()["correct"]


def test_the_new_modules_are_under_the_import_checks():
    """``test_perfbench_manifest.py`` checks every module of
    ``architectures/`` and ``reference/``; these two are among them."""
    names = {p.name for p in (BENCH_DIR / "architectures").glob("*.py")}
    refs = {p.name for p in (BENCH_DIR / "reference").rglob("*.py")}
    assert "nemotron_h.py" in names and "nemotron_h.py" in refs
    assert ARCH.reference.__name__.endswith("nemotron_h")
