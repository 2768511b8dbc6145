"""Nemotron-H on the port (``configs/nemotron_h_47b.py``): the layer
pattern, grouped SSD, the gate-then-group-norm and the model against the
benchmark's plain fp32 reference (``perfbench/reference/nemotron_h.py``,
loaded by path: it imports nothing of the port).

At a small size on the CPU: 4 Mamba heads of 16 in 2 groups, state 4,
chunk 8, prompts crossing chunk boundaries, and the pattern ``M-*--M*M``
(every kind, two MLP-only layers in a row).  The model tests set the
port's compute and K/V types to fp32, so both sides compute in fp32 and
differ only in the order of their sums: the chunked scan against the
reference's token-by-token recurrence, batched products against plain
ones.  Jamba's block, which has one group and the old norm order, is held
to its digest before grouping was added, bit for bit.
"""
import hashlib
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.configs import nemotron_h_47b as NH  # noqa: E402
from repro_torch.kernels.ssd_step.ops import ssd_step_plain  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1] / "perfbench"
# fp32 on both sides: sums in another order differ by a few ulps of the
# running values (logits of magnitude ~3 read 4e-6 apart), far below a
# fault (a dropped group, the norm before the gate, RoPE: > 1e-2)
MODEL_TOL = 1e-4
# the scan alone in fp32: the chunked form's exp(l_i - l_j) against a
# product of per-step decays
SCAN_TOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    """The benchmark's reference module, imported from its folder."""
    sys.path.insert(0, str(BENCH))
    try:
        from reference import nemotron_h
    finally:
        sys.path.remove(str(BENCH))
    return nemotron_h


@pytest.fixture
def fp32(monkeypatch):
    for mod in (L, S):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(M, "KV_DTYPE", torch.float32)


def published(cfg):
    """A configuration file's ``model`` keys for ``cfg``."""
    s = cfg.ssm
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "attention_head_dim": cfg.head_dim, "vocab_size": cfg.vocab_size,
            "intermediate_size": cfg.d_ff, "layer_norm_epsilon": cfg.norm_eps,
            "hybrid_override_pattern": cfg.layer_pattern,
            "mamba_num_heads": s.expand * cfg.d_model // s.head_dim,
            "mamba_head_dim": s.head_dim, "n_groups": s.n_groups,
            "ssm_state_size": s.d_state, "conv_kernel": s.d_conv}


def _perturbed(params, gen):
    """The port's init with its deterministic leaves (norm scales, A_log,
    D, dt_bias, the conv bias) moved, so a leaf read at the wrong place or
    a scale left out shows."""
    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if key in ("scale", "A_log", "D", "dt_bias", "conv_b"):
            return node + 0.1 * torch.randn(node.shape, generator=gen)
        return node
    return walk(params)


def _scan_inputs(seed, b=2, s=21, h=4, g=2, n=3, p=5):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=gen)
    dt = torch.rand((b, s, h), generator=gen) * 0.5
    a_log = torch.randn((h,), generator=gen)
    bb = torch.randn((b, s, g, n), generator=gen)
    cc = torch.randn((b, s, g, n), generator=gen)
    return x, dt, a_log, bb, cc


def _sequential(x, dt, a_log, bb, cc):
    """h_t = exp(-dt_t A) h_{t-1} + dt_t B_t x_tᵀ, y_t = C_t h_t, head h
    in group h // (H / G), in float64."""
    b, s, h, p = x.shape
    g, n = bb.shape[2:]
    a = torch.exp(a_log.double())
    state = torch.zeros((b, h, n, p), dtype=torch.float64)
    ys = []
    for t in range(s):
        for head in range(h):
            grp = head // (h // g)
            decay = torch.exp(-dt[:, t, head].double() * a[head])
            upd = (dt[:, t, head].double()[:, None, None]
                   * bb[:, t, grp].double()[:, :, None]
                   * x[:, t, head].double()[:, None, :])
            state[:, head] = decay[:, None, None] * state[:, head] + upd
        ys.append(torch.stack([
            torch.einsum("bn,bnp->bp", cc[:, t, head // (h // g)].double(),
                         state[:, head]) for head in range(h)], dim=1))
    return torch.stack(ys, dim=1), state


@pytest.mark.parametrize("chunk", [8, 4])
def test_grouped_ssd_chunked_equals_the_sequential_recurrence(chunk):
    x, dt, a_log, bb, cc = _scan_inputs(0)
    y, state = S.ssd_chunked(x, dt, a_log, bb, cc, chunk)
    y_ref, st_ref = _sequential(x, dt, a_log, bb, cc)
    assert torch.allclose(y.double(), y_ref, atol=SCAN_TOL, rtol=SCAN_TOL)
    assert torch.allclose(state.double(), st_ref, atol=SCAN_TOL,
                          rtol=SCAN_TOL)


def test_grouped_ssd_step_continues_the_chunked_scan():
    x, dt, a_log, bb, cc = _scan_inputs(1)
    _, state = S.ssd_chunked(x[:, :-1], dt[:, :-1], a_log, bb[:, :-1],
                             cc[:, :-1], 8)
    y, st = ssd_step_plain(x[:, -1], dt[:, -1], a_log, bb[:, -1], cc[:, -1],
                        state)
    y_full, st_full = S.ssd_chunked(x, dt, a_log, bb, cc, 8)
    assert torch.allclose(y, y_full[:, -1], atol=SCAN_TOL, rtol=SCAN_TOL)
    assert torch.allclose(st, st_full, atol=SCAN_TOL, rtol=SCAN_TOL)


def test_one_group_and_a_group_per_head_agree_with_shared_b_and_c():
    """Grouping B and C is the only change: G groups holding the same B
    and C give what the shared (B, S, N) form gives."""
    x, dt, a_log, bb, cc = _scan_inputs(2, g=1)
    shared = S.ssd_chunked(x, dt, a_log, bb[:, :, 0], cc[:, :, 0], 8)
    for g in (1, 2, 4):
        got = S.ssd_chunked(x, dt, a_log, bb.expand(-1, -1, g, -1),
                            cc.expand(-1, -1, g, -1), 8)
        for a, b in zip(got, shared):
            assert torch.allclose(a, b, atol=SCAN_TOL, rtol=SCAN_TOL)


def test_gate_then_group_norm(ref):
    gen = torch.Generator().manual_seed(3)
    y, z = torch.randn((2, 5, 12), generator=gen), \
        torch.randn((2, 5, 12), generator=gen)
    scale = {"scale": torch.randn((12,), generator=gen)}
    got = S.gated_group_norm(scale, y, z, 3, 1e-5)
    gated = y * z * torch.sigmoid(z)
    want = torch.cat([g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + 1e-5)
                      for g in gated.split(4, dim=-1)], dim=-1) \
        * scale["scale"]
    assert torch.allclose(got, want, atol=1e-6, rtol=1e-6)
    assert torch.allclose(ref.gated_norm(y, z, scale["scale"], 3, 1e-5),
                          want, atol=1e-6, rtol=1e-6)
    # the other orders read far apart: the whole width, the gate after
    whole = S.gated_group_norm(scale, y, z, 1, 1e-5)
    after = L.rmsnorm(scale, y) * S._silu(z)
    assert (whole - want).abs().max() > 1e-2
    assert (after - want).abs().max() > 1e-2


def test_pattern_layout():
    cfg = NH.reduced()
    model = M.Model(cfg)
    assert [(d.mixer, d.mlp) for d in model.layer_descs] == [
        ("mamba", None), (None, "dense"), ("attn", None), (None, "dense"),
        (None, "dense"), ("mamba", None), ("attn", None), ("mamba", None)]
    assert model.kind_row == [0, 0, 0, 1, 2, 1, 1, 2]
    assert not model.use_rope
    params = model.init(torch.Generator().manual_seed(0), torch.float32,
                        "cpu")
    assert [sorted(lp) for lp in params["layers"]] == [
        ["mamba"], ["mlp"], ["attn"], ["mlp"], ["mlp"], ["mamba"], ["attn"],
        ["mamba"]]
    s = cfg.ssm
    di, gn = s.expand * cfg.d_model, s.n_groups * s.d_state
    mamba = params["layers"][0]["mamba"]
    assert mamba["w_in"].shape == (cfg.d_model, 2 * di + 2 * gn + 4)
    assert mamba["conv_w"].shape == (s.d_conv, di + 2 * gn)
    caches = model.cache_init(3, 40, "cpu")
    assert {n: tuple(t.shape) for n, t in caches.items()} == {
        "k": (2, 3, 40, 2, 8), "v": (2, 3, 40, 2, 8),
        "ssm": (3, 3, 4, 4, 16), "conv": (3, 3, 3, di + 2 * gn)}
    assert model.state_leaves == ("ssm", "conv")
    assert not model.supports_prefill_resume
    assert not model.supports_padded_prefill
    assert not model.supports_paged_decode
    # the published model and the benchmark's stage
    assert M.Model(NH.CONFIG).mixers.count("mamba") == 45
    assert [i for i, c in enumerate(NH.PATTERN) if c == "*"] == \
        [17, 38, 49, 60, 86]
    stage = M.Model(NH.STAGE)
    assert [stage.mixers.count(k) for k in ("mamba", None, "attn")] == \
        [9, 9, 1]
    assert round(NH.CONFIG.param_count() / 1e9, 1) == 46.8
    assert round(NH.STAGE.param_count() / 1e9, 2) == 10.77
    assert M.Model(get_reduced("jamba-v0.1-52b")).period == 8


@pytest.mark.parametrize("pattern", ["M-*--M*M", "*M--M"])
def test_prompt_and_decode_steps_match_the_reference(ref, fp32, pattern):
    """The prompt pass over 20 tokens (chunks of 8), then 16 cached decode
    steps, against the reference's full forward pass."""
    cfg = NH.reduced(pattern)
    model = M.Model(cfg)
    gen = torch.Generator().manual_seed(4)
    params = _perturbed(model.init(gen, torch.float32, "cpu"), gen)
    toks = torch.randint(1, cfg.vocab_size, (1, 37), generator=gen)
    logits, caches = model.prefill(params, {"tokens": toks[:, :20]},
                                   max_len=64)
    got = [logits[0]]
    for t in range(20, 36):
        step, caches = model.decode(params, caches, toks[:, t:t + 1], t)
        got.append(step[0])
    want = {}
    m = published(cfg)
    ref.logits_at(params, m, [toks[0].tolist()], [range(19, 36)],
                  lambda i, lo, lg: want.setdefault(i, lg))
    diff = (torch.stack(got) - want[0]).abs().max()
    assert diff < MODEL_TOL, float(diff)


def test_batched_rows_match_the_reference(ref, fp32):
    """Two equal-length rows in one prompt pass (the only batches a
    recurrent stack forms), each against its own reference pass."""
    cfg = NH.reduced()
    model = M.Model(cfg)
    gen = torch.Generator().manual_seed(5)
    params = _perturbed(model.init(gen, torch.float32, "cpu"), gen)
    toks = torch.randint(1, cfg.vocab_size, (2, 19), generator=gen)
    logits, _ = model.prefill_batched(params, toks, torch.tensor([19, 19]),
                                      max_len=32)
    want = {}
    ref.logits_at(params, published(cfg), toks.tolist(),
                  [range(18, 19)] * 2, lambda i, lo, lg: want.setdefault(i, lg))
    for i in range(2):
        assert (logits[i] - want[i][0]).abs().max() < MODEL_TOL


def test_jamba_mamba_block_is_unchanged():
    """Jamba's block (one group, norm before the gate): prompt pass and one
    step, fp32 and bf16 weights, bit for bit as before grouping was added
    (the sha256 of every output and state)."""
    cfg = get_reduced("jamba-v0.1-52b")
    h = hashlib.sha256()
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator().manual_seed(7)
        p = S.mamba_init(gen, cfg, dtype, "cpu")
        x = torch.randn((2, 40, cfg.d_model), generator=gen).to(torch.bfloat16)
        y, cache = S.mamba_block(p, x, cfg)
        # hashed before the step, which writes its state into cache["ssm"]
        for t in (y, cache["ssm"], cache["conv"]):
            h.update(t.float().contiguous().numpy().tobytes())
        y1, cache1 = S.mamba_block(p, x[:, :1], cfg, cache=cache)
        for t in (y1, cache1["ssm"], cache1["conv"]):
            h.update(t.float().contiguous().numpy().tobytes())
    assert h.hexdigest() == \
        "a3b2281c3cce072864b35912e7893375d0749cb201c065803f1e5709ccd4fed4"


def test_hand_off_moves_the_state_and_counts_it():
    """Admitting a request copies its whole recurrent state into the slot,
    inside a ``decode.admit.state`` span, and counts its bytes."""
    cfg = NH.reduced()
    model = M.Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.bfloat16,
                        "cpu")
    pre = E.PrefillEngine(model, params, max_len=48, cache_entries=0,
                          device="cpu")
    dec = E.DecodeEngine(model, params, num_slots=2, max_len=48,
                         device="cpu")
    dec.tracer.enabled = True
    logits, caches = pre.prefill(list(range(1, 14)))
    dec.admit(1, "r0", caches, 5, 13, 4)
    for name in model.state_leaves:
        assert torch.equal(dec.caches[name][:, 1], caches[name][:, 0])
        assert caches[name].abs().sum() > 0
    row = sum(t[:, 0].nbytes for n, t in caches.items()
              if n in ("ssm", "conv"))
    assert dec.state_bytes_in == row
    spans = [s for s in dec.tracer.spans if s is not None]
    names = [s.name for s in spans]
    assert names == ["decode.admit", "decode.admit.state"]
    assert spans[1].parent == 0 and spans[1].rid == "r0"
    dense = M.Model(get_reduced("phi4-mini-3.8b"))
    assert dense.state_leaves == ()


def test_layer_ranges_only_while_the_tracer_is_on_and_profiled():
    cfg = NH.reduced()
    model = M.Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.bfloat16,
                        "cpu")
    pre = E.PrefillEngine(model, params, max_len=32, cache_entries=0,
                          device="cpu")

    def ranges():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            pre.prefill(list(range(1, 12)))
        return sorted(e.name for e in prof.events()
                      if e.name.startswith("layer."))
    assert ranges() == []
    pre.tracer.enabled = True
    assert ranges() == ["layer.attn"] * 2 + ["layer.mamba"] * 3 \
        + ["layer.mlp"] * 3
    pre.tracer.enabled = False
    assert ranges() == []
    assert not M.LAYER_RANGES.get()


def test_warmup_batches_one_row_where_prompts_are_not_padded(monkeypatch):
    """A model whose prompt batches hold one length only warms its batched
    pass at width 1, at each length; a padded model warms every width."""
    widths = {}
    for name, cfg in (("hybrid", NH.reduced()),
                      ("dense", get_reduced("phi4-mini-3.8b"))):
        model = M.Model(cfg)
        params = model.init(torch.Generator().manual_seed(0), torch.bfloat16,
                            "cpu")
        pre = E.PrefillEngine(model, params, max_len=48, cache_entries=0,
                              device="cpu")
        shapes = widths.setdefault(name, [])
        real = model.prefill_batched

        def batched(p, toks, lens, _real=real, _shapes=shapes, **kw):
            _shapes.append(tuple(toks.shape))
            return _real(p, toks, lens, **kw)
        monkeypatch.setattr(model, "prefill_batched", batched)
        pre.warmup([12, 20], batch_sizes=[1, 2, 4])
    assert widths["hybrid"] == [(1, 12), (1, 20)]
    assert sorted({w for w, _ in widths["dense"]}) == [1, 2, 4]


@pytest.mark.parametrize("name", ["hybrid", "dense"])
def test_prompt_rows_are_cut_only_to_be_stored(monkeypatch, name):
    """A batched prompt pass cuts a row out of its caches only for the
    prefix cache to keep it: never on a model whose prompt passes do not
    resume (Nemotron-H's ~185 MB rows at the benchmark's size), one per
    cold and per resumed row on a dense model."""
    from repro_torch.core.radix import BLOCK_SIZE, block_hashes
    cfg = NH.reduced() if name == "hybrid" else get_reduced("phi4-mini-3.8b")
    model = M.Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.bfloat16,
                        "cpu")
    pre = E.PrefillEngine(model, params, max_len=64, cache_entries=16,
                          device="cpu")
    cut = []
    real = E._row

    def row(caches, r):
        cut.append(r)
        return real(caches, r)
    monkeypatch.setattr(E, "_row", row)
    a = [(7 * i + 3) % cfg.vocab_size for i in range(40)]
    b = a[:2 * BLOCK_SIZE] + [(5 * i + 1) % cfg.vocab_size
                              for i in range(BLOCK_SIZE)]
    c = [(11 * i + 2) % cfg.vocab_size for i in range(40)]
    pre.prefill_many([(t, None, block_hashes(t, BLOCK_SIZE)) for t in (a, c)])
    pre.prefill_many([(b, None, block_hashes(b, BLOCK_SIZE))])
    if name == "hybrid":
        assert cut == [] and len(pre._cache) == 0
        assert pre.stats.reused_blocks == 0
    else:
        assert cut == [0, 1, 0] and len(pre._cache) == 3
        assert pre.stats.reused_blocks == 2
    assert pre.stats.requests == 3 and pre.stats.batches == 2
