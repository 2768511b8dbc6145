"""The port's encoder-decoder and VLM families against the JAX package's,
on reduced seamless-m4t-medium (2 encoder and 4 decoder layers, each
decoder layer with a cross attention; gelu MLPs) and reduced
phi-3-vision-4.2b (4 layers, 16 patches in front of the tokens), with the
reference's weights carried across by ``repro_torch.bridge``.

Layers are held in fp32 (2e-5) and bf16 (2e-2): ``_sdpa_chunked`` under its
three masks, the cross attention (with and without ``kv_lengths``), the
encoder's bidirectional self-attention and the gelu MLP.

The model-level tests (prompt logits within 2e-3, a 10-step forced decode
walk within 0.02 x the logit spread, the loss within 2e-3, the engines and
the cluster) run with ``COMPUTE_DTYPE`` set to fp32 in both packages and
fp32 weights.  In bf16 the reference differs from itself on these models:
its two decode paths (``"pallas"``, the Pallas kernel in interpret mode,
and ``"sdpa"``) land 0.006-0.015 x the logit spread apart on reduced
Phi-3-vision with patches, and the two packages' prompt logits differ by
~0.03-0.05 (a bf16 ulp of the logits), so a bf16 comparison could not
hold 2e-3 nor tell a fault from rounding.  In fp32 that floor is gone.

The two quirks of the reference that the port keeps (ROADMAP §C notes 6
and 7) have a test each: a VLM request decodes from position
``len(tokens)``, inside its prompt of ``num_patches + len(tokens)``
positions, and the cached cross attention attends to every one of the
``ENC_CTX_DECODE`` zero-padded keys, where the uncached one attends to the
frames only.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import disagg as jax_disagg  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.training import data as jax_data  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro_torch.bridge import opt_state_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import disagg, engine  # noqa: E402
from repro_torch.training import optimizer as opt_lib  # noqa: E402
from repro_torch.training.data import batch_for_model, to_bf16  # noqa: E402

torch.set_num_threads(1)

ARCHS = {"encdec": "seamless-m4t-medium", "vlm": "phi-3-vision-4.2b"}
MAX_LEN = 96
LOSS_BOUND = 2e-3
LOGITS_TOL = 2e-3
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


# --------------------------------------------------------------- layers ----

def _qkv(dtype, seed, b=2, s=37, t=45, kh=2, g=2, hd=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, kh * g, hd), np.float32)
    k = rng.standard_normal((b, t, kh, hd), np.float32)
    v = rng.standard_normal((b, t, kh, hd), np.float32)
    qpos = np.broadcast_to(np.arange(s, dtype=np.int32) + 5, (b, s)).copy()
    lens = np.array([t - 11, 3], np.int32)
    jd, td, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jd) for a in (q, k, v)]
            + [jnp.asarray(qpos), jnp.asarray(lens)],
            [torch.from_numpy(a).to(td) for a in (q, k, v)]
            + [torch.from_numpy(qpos), torch.from_numpy(lens)])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["causal", "full", "length"])
def test_sdpa_chunked_masks(kind, dtype):
    """The three masks, over query chunks of 16 (S = 37: two whole chunks
    and a ragged one), against the reference's."""
    (jq, jk, jv, jpos, jlens), (tq, tk, tv, tpos, tlens) = _qkv(dtype, 3)
    ref = JL._sdpa_chunked(jq, jk, jv, jpos, 2, kind=kind, kv_lengths=jlens,
                           q_chunk=16)
    out = TL._sdpa_chunked(tq, tk, tv, tpos, 2, kind=kind, kv_lengths=tlens,
                           q_chunk=16)
    _close(out, ref, DTYPES[dtype][2])
    if kind == "length":       # row 1 attends to its first 3 keys only
        short = TL._sdpa_chunked(tq[1:], tk[1:, :3], tv[1:, :3], tpos[1:], 2,
                                 kind="full")
        _close(out[1:], short.float().numpy(), DTYPES[dtype][2])


def _compute_in(monkeypatch, dtype):
    """Both packages compute in ``dtype`` (their default is bf16)."""
    jd, td, _ = DTYPES[dtype]
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jd)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", td)


def _attn_models(dtype):
    jcfg, tcfg = jax_reduced(ARCHS["encdec"]), get_reduced(ARCHS["encdec"])
    jd, td, _ = DTYPES[dtype]
    jp = JL.attention_init(jax.random.PRNGKey(1), jcfg, jd)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32))
                      .to(td), jp)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["cross", "cross_length", "bidirectional"])
def test_cross_and_bidirectional_attention(mode, dtype, monkeypatch):
    """``attention`` with ``kv_source`` (no RoPE; no mask, or 'length' over
    ``kv_lengths``) and the encoder's non-causal self-attention (RoPE,
    'full'), against the reference, computing in ``dtype``."""
    _compute_in(monkeypatch, dtype)
    jcfg, tcfg, jp, tp = _attn_models(dtype)
    jd, td, tol = DTYPES[dtype]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 19, tcfg.d_model), np.float32)
    src = rng.standard_normal((2, 33, tcfg.d_model), np.float32)
    lens = np.array([33, 12], np.int32)
    kw_j, kw_t = {}, {}
    if mode.startswith("cross"):
        kw_j = dict(kv_source=jnp.asarray(src).astype(jd), causal=False,
                    use_rope=False)
        kw_t = dict(kv_source=torch.from_numpy(src).to(td), causal=False,
                    use_rope=False)
        if mode == "cross_length":
            kw_j["kv_lengths"] = jnp.asarray(lens)
            kw_t["kv_lengths"] = torch.from_numpy(lens)
    else:
        kw_j = kw_t = dict(causal=False)
    ref, jc = JL.attention(jp, jnp.asarray(x).astype(jd), jcfg, **kw_j)
    out, tc = TL.attention(tp, torch.from_numpy(x).to(td), tcfg, **kw_t,
                           use_flash=True)     # never taken: not causal
    assert jc is None and tc is None
    _close(out, ref, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gelu_mlp_matches_reference(dtype, monkeypatch):
    """Seamless's MLP: gelu (tanh, ``jax.nn.gelu``'s default), computing in
    ``dtype``."""
    _compute_in(monkeypatch, dtype)
    jcfg, tcfg = jax_reduced(ARCHS["encdec"]), get_reduced(ARCHS["encdec"])
    assert tcfg.activation == "gelu"
    jd, td, tol = DTYPES[dtype]
    jp = JL.mlp_init(jax.random.PRNGKey(2), jcfg, jd)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32))
                      .to(td), jp)
    x = np.random.default_rng(4).standard_normal((2, 11, tcfg.d_model),
                                                 np.float32)
    _close(TL.mlp(tp, torch.from_numpy(x).to(td), tcfg),
           JL.mlp(jp, jnp.asarray(x).astype(jd), jcfg), tol)


# ---------------------------------------------------------------- model ----

@pytest.fixture
def fp32_compute(monkeypatch):
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)


def _bridged(name):
    jm = JaxModel(jax_reduced(name))
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    tm = Model(get_reduced(name))
    tp = params_from_numpy(_np(jp), tm.cfg, dtype=torch.float32, device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module", params=sorted(ARCHS))
def models(request):
    return (request.param, *_bridged(ARCHS[request.param]))


def _prompt(template, n, vocab=512):
    return [(template * 1_000_003 + 7 * i) % vocab for i in range(n)]


def _extras(family, cfg, seed, n_frames=40):
    """One request's frontend inputs, float32 numpy, no batch axis."""
    rng = np.random.default_rng(seed)
    if family == "vlm":
        return {"patches": rng.standard_normal(
            (cfg.num_patches, cfg.frontend_dim), np.float32)}
    return {"frames": rng.standard_normal((n_frames, cfg.frontend_dim),
                                          np.float32)}


def _batch(family, cfg, toks, seed):
    """A batch for both sides: tokens (B, S) and each row's extras."""
    rows = [_extras(family, cfg, seed + r) for r in range(len(toks))]
    batch = {"tokens": np.asarray(toks, np.int32)}
    for name in rows[0]:
        batch[name] = np.stack([r[name] for r in rows])
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _offset(family, cfg):
    return cfg.num_patches if family == "vlm" else 0


def _assert_logits(port, ref):
    port = port.float().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    for row_p, row_r in zip(port.reshape(-1, ref.shape[-1]),
                            ref.reshape(-1, ref.shape[-1])):
        spread = float(row_r.max() - row_r.min())
        assert float(np.abs(row_p - row_r).max()) < 0.02 * spread


def test_layout_and_bridge_are_exact(models):
    family, jm, jp, tm, tp = models
    assert tm.descs == [TM.BlockDesc(**vars(d)) for d in jm.descs]
    assert all(d.cross == (family == "encdec") for d in tm.layer_descs)
    assert tm.n_cross == (tm.n_layers if family == "encdec" else 0)
    gates = ("supports_paged_decode", "supports_padded_prefill",
             "supports_prefill_resume")
    assert [getattr(tm, g) for g in gates] == \
        [getattr(jm, g) for g in gates] == [False] * 3
    ref = _np(jp)
    assert np.array_equal(tp["frontend_proj"].numpy(), ref["frontend_proj"])
    blocks = [(layer, ref["stack"]["p0"], i)
              for i, layer in enumerate(tp["layers"])]
    if family == "encdec":
        assert len(tp["enc_layers"]) == tm.cfg.num_encoder_layers == 2
        assert np.array_equal(tp["enc_final_norm"]["scale"].numpy(),
                              ref["enc_final_norm"]["scale"])
        blocks += [(layer, ref["enc_stack"]["p0"], i)
                   for i, layer in enumerate(tp["enc_layers"])]
    else:
        assert "enc_layers" not in tp and "enc_final_norm" not in tp
    for layer, stacked, i in blocks:
        want = jax.tree.map(lambda a, i=i: a[i], stacked)
        assert set(layer) == set(want)
        for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
            got = layer
            for p in path:
                got = got[p.key]
            assert np.array_equal(got.numpy(), leaf), path


def test_cache_layout(models):
    """K/V over the self-attention layers, and an encoder-decoder's cross
    K/V (P_cross, B, ENC_CTX_DECODE, K, hd) in the compute dtype, equal to
    the reference's per-period leaves."""
    family, jm, _, tm, _ = models
    caches = tm.cache_init(3, MAX_LEN, "cpu")
    jc = jm.cache_init(3, MAX_LEN)["p0"]
    cfg = tm.cfg
    want = {"k", "v"} | ({"xk", "xv"} if family == "encdec" else set())
    assert set(caches) == want
    for name, t in caches.items():
        ref = jc["kv"][name] if name in ("k", "v") else jc[name]
        assert t.shape == ref.shape and str(ref.dtype) == \
            str(t.dtype).split(".")[-1], name
        assert not t.any()
    if family == "encdec":
        assert caches["xk"].shape == (tm.n_layers, 3, TM.ENC_CTX_DECODE,
                                      cfg.num_kv_heads, cfg.resolved_head_dim)


def _assert_caches(tc, jc, cols):
    """The port's leaves against the reference's, positions below ``cols``
    for the self-attention K/V, every key of the cross K/V."""
    for name, t in tc.items():
        ref = jc["p0"]["kv"][name] if name in ("k", "v") else jc["p0"][name]
        ref = np.asarray(ref, np.float32)
        got = t.float().numpy()
        if name in ("k", "v"):
            got, ref = got[:, :, :cols], ref[:, :, :cols]
        np.testing.assert_allclose(got, ref, atol=1e-2, rtol=1e-2,
                                   err_msg=name)


def test_prefill(models, fp32_compute):
    """Two prompts with their frames or patches: prompt logits within
    2e-3; the caches hold the patch positions before the tokens', and the
    encoder's K/V zero-padded to ENC_CTX_DECODE keys."""
    family, jm, jp, tm, tp = models
    batch = _batch(family, tm.cfg, [_prompt(0, 40), _prompt(1, 40)], 10)
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_len=MAX_LEN))(
        jp, _jax(batch))
    tl, tc = tm.prefill(tp, _torch(batch), max_len=MAX_LEN)
    _close(tl, jl, LOGITS_TOL)
    _assert_caches(tc, jc, _offset(family, tm.cfg) + 40)
    if family == "encdec":
        assert not tc["xk"][:, :, 40:].any() and tc["xk"][:, :, :40].all()


def _slots(family, jm, jp, tm, tp, lengths):
    """Each prompt prefilled with its extras and inserted into its slot,
    on both sides; returns (jax caches, port caches, first tokens, the
    slots' positions)."""
    jc = jm.cache_init(len(lengths), MAX_LEN)
    tc = tm.cache_init(len(lengths), MAX_LEN, "cpu")
    first = []
    for slot, n in enumerate(lengths):
        batch = _batch(family, tm.cfg, [_prompt(slot + 3, n)], 20 + slot)
        jl, jrow = jm.prefill(jp, _jax(batch), max_len=MAX_LEN)
        _, trow = tm.prefill(tp, _torch(batch), max_len=MAX_LEN)
        jc = jax_engine._insert_cache(jc, jrow, slot, jm)
        engine._insert_cache(tc, trow, slot)
        first.append(int(np.argmax(np.asarray(jl)[0])))
    pos = np.asarray(lengths, np.int32) + _offset(family, tm.cfg)
    return jc, tc, np.asarray(first, np.int32), pos


@pytest.mark.parametrize("impl", ["sdpa", "pallas"])
def test_forced_decode_walk(models, impl, fp32_compute):
    """Two slots (prompts of 37 and 22 tokens, each with its extras) decode
    10 steps at positions ``num_patches + len(tokens) + i``, as the
    reference's consistency test does (tests/test_smoke_archs.py:58-72);
    each step both sides get the reference's argmax."""
    family, jm, jp, tm, tp = models
    jc, tc, tok, pos = _slots(family, jm, jp, tm, tp, [37, 22])
    step_fn = jax.jit(lambda p, c, t, i: jm.decode(p, c, t, i,
                                                   decode_impl=impl))
    for step in range(10):
        cur = pos + step
        jl, jc = step_fn(jp, jc, jnp.asarray(tok)[:, None], jnp.asarray(cur))
        tl, tc = tm.decode(tp, tc, torch.from_numpy(tok)[:, None],
                           torch.from_numpy(cur), decode_impl=impl)
        _assert_logits(tl, jl)
        tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    _assert_caches(tc, jc, int(pos.min()) + 10)


def test_train_loss(models, fp32_compute):
    """The loss on ``batch_for_model``'s batch (a VLM's patch positions
    left out of it), within 2e-3, with and without remat."""
    family, jm, jp, tm, tp = models
    shape = ShapeConfig("t", 48, 2, "train")
    jb = jax_data.batch_for_model(jm.cfg, shape, 3, seed=1)
    tb = batch_for_model(tm.cfg, shape, 3, seed=1, device="cpu")
    want = float(jm.train_loss(jp, jb))
    with torch.no_grad():
        got = tm.train_loss(tp, tb)
        assert abs(float(tm.train_loss(tp, tb, remat=False)) - want) \
            < LOSS_BOUND
    assert got.dtype == torch.float32
    assert abs(float(got) - want) < LOSS_BOUND


def test_train_loss_gradient_reaches_the_encoder(fp32_compute):
    """Under remat the encoder's output reaches every decoder layer through
    the checkpoint: the encoder and frontend weights get gradients."""
    _, _, tm, tp = _bridged(ARCHS["encdec"])
    batch = batch_for_model(tm.cfg, ShapeConfig("t", 32, 2, "train"), 0,
                            device="cpu")
    leaves = [tp["frontend_proj"], tp["enc_layers"][0]["attn"]["wq"],
              tp["layers"][3]["xattn"]["wk"]]
    for t in leaves:
        t.requires_grad_(True)
    tm.train_loss(tp, batch, remat=True).backward()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0)
               for t in leaves)


# ----------------------------------------------------------------- data ----

@pytest.mark.parametrize("family", sorted(ARCHS))
def test_batch_for_model_bit_equal(family):
    """Tokens and the frontend stubs bit for bit, bf16 included."""
    cfg, jcfg = get_reduced(ARCHS[family]), jax_reduced(ARCHS[family])
    shape = ShapeConfig("t", 64, 3, "train")
    ref = jax_data.batch_for_model(jcfg, shape, 5, seed=2)
    port = batch_for_model(cfg, shape, 5, seed=2, device="cpu")
    assert set(port) == set(ref)
    for name, t in port.items():
        want = np.asarray(ref[name])
        assert str(t.dtype).split(".")[-1] == str(want.dtype), name
        assert t.shape == want.shape, name
        if t.dtype == torch.bfloat16:
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  want.view(np.int16)), name
        else:
            assert np.array_equal(t.numpy(), want), name


def test_bf16_cast_rounds_as_the_reference():
    """Values just above a bf16 halfway point that float32 rounds onto it
    (where a direct cast from float64 would round up) come out as
    ``jnp.asarray(..., jnp.bfloat16)`` makes them."""
    base = np.array([1.0, -3.0, 0.75, 1.5e-3, 2.0 ** 100])
    draw = np.concatenate([base * (1 + 2.0 ** -8 + 2.0 ** -40),
                           base * (1 + 3 * 2.0 ** -8 - 2.0 ** -40),
                           np.random.default_rng(0).standard_normal(1000)])
    want = np.asarray(jnp.asarray(draw, jnp.bfloat16)).view(np.int16)
    assert np.array_equal(to_bf16(draw).view(torch.int16).numpy(), want)


# ------------------------------------------------------------ optimizer ---

def test_optimizer_update_decays_encoder_norms():
    """One AdamW step on reduced Seamless: every leaf as the reference's,
    so the encoder layers' norm scales (2-D in the reference's stacked
    ``enc_stack``) are weight-decayed and ``enc_final_norm`` is not."""
    jm, jp, tm, _ = _bridged(ARCHS["encdec"])
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                         .astype(np.float32), _np(jp))
    zero = jax.tree.map(np.zeros_like, grads)
    cfg = jax_opt.OptimizerConfig(warmup_steps=2, total_steps=10,
                                  weight_decay=0.5)
    state = jax_opt.init(jp)
    want, state1, _ = jax_opt.update(cfg, jp, grads, state)
    tp = params_from_numpy(_np(jp), tm.cfg, dtype=torch.float32, device="cpu")
    topt = opt_state_from_numpy(_np(state), tm.cfg, device="cpu")
    tg = params_from_numpy(grads, tm.cfg, dtype=torch.float32, device="cpu")
    opt_lib.update(cfg, tp, tg, topt)
    ref = params_from_numpy(_np(want), tm.cfg, dtype=torch.float32,
                            device="cpu")
    for a, b in zip(opt_lib.leaves(tp), opt_lib.leaves(ref)):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    # with zero gradients only the decay moves a leaf
    tp = params_from_numpy(_np(jp), tm.cfg, dtype=torch.float32, device="cpu")
    opt_lib.update(cfg, tp, params_from_numpy(zero, tm.cfg,
                                              dtype=torch.float32,
                                              device="cpu"),
                   opt_lib.init(tp))
    scale = tp["enc_layers"][1]["attn"]["norm"]["scale"]
    assert bool((scale < 1).all())
    assert bool((tp["enc_final_norm"]["scale"] == 1).all())


# --------------------------------------------------------------- engine ----

def test_prefill_engine_extras_never_resume_nor_store(models, fp32_compute):
    """A request with extras takes the single-request pass, is never
    resumed and never stored, in ``prefill`` and ``prefill_many``, with the
    JAX engine's stats; a VLM request without them is an exact-length
    cold pass (no padding, no resume on these families)."""
    family, jm, jp, tm, tp = models
    je = jax_engine.PrefillEngine(jm, jp, MAX_LEN)
    te = engine.PrefillEngine(tm, tp, MAX_LEN, device="cpu")
    toks = _prompt(1, 48)
    extras = _extras(family, tm.cfg, 30)
    calls = []
    inner = tm.prefill

    def single(params, batch, max_len=None):
        calls.append({k: tuple(v.shape) for k, v in batch.items()})
        return inner(params, batch, max_len)
    tm.prefill = single
    try:
        for eng in (je, te):
            for _ in range(2):
                eng.prefill(toks, extras)
            eng.prefill_many([(toks, extras, None),
                              (_prompt(2, 33), _extras(family, tm.cfg, 31),
                               None)])
    finally:
        del tm.prefill
    assert len(calls) == 4 and all(c["tokens"] == (1, c["tokens"][1])
                                   for c in calls)
    name = "patches" if family == "vlm" else "frames"
    assert all(c[name][0] == 1 for c in calls)
    want, got = je.stats.as_dict(), te.stats.as_dict()
    for key in ("wall_s", "flops"):
        want.pop(key), got.pop(key)
    assert got == want
    assert te.stats.reused_blocks == 0 and te.stats.batches == 0
    assert len(te._cache) == len(je._cache) == 0
    logits, caches = te.prefill(toks, extras)
    jl, _ = je.prefill(toks, extras)
    np.testing.assert_allclose(logits, np.asarray(jl), atol=LOGITS_TOL,
                               rtol=LOGITS_TOL)
    n_pos = _offset(family, tm.cfg) + len(toks)
    assert bool(caches["k"][:, 0, n_pos - 1].any())
    assert not caches["k"][:, 0, n_pos:].any()


def test_kv_token_bytes_counts_self_attention_only(models):
    family, jm, _, tm, _ = models
    cfg = tm.cfg
    assert engine.kv_token_bytes(tm) == jax_engine.kv_token_bytes(jm) == \
        2 * tm.n_layers * cfg.num_kv_heads * cfg.resolved_head_dim * 2


CLUSTER = dict(num_decode=2, slots_per_worker=2, max_len=MAX_LEN,
               adaptive=False, cache_ttl=None)


def _requests(family, cfg):
    rng = np.random.default_rng(11)
    out = []
    for i in range(6):
        n = int(rng.choice([20, 31, 42]))
        out.append((f"r{i}", _prompt(int(rng.integers(0, 3)), n),
                    int(rng.integers(2, 5)),
                    _extras(family, cfg, 40 + i,
                            n_frames=int(rng.integers(24, 60)))))
    return out


def _serve(mod, model, params, requests, **kw):
    cluster = mod.DisaggregatedCluster(model, params, decode_impl="pallas",
                                       **CLUSTER, **kw)
    passes = []
    inner = cluster.prefill.prefill_many

    def recorded(reqs):
        out = inner(reqs)
        passes.append([np.asarray(r[0], np.float32) for r in out])
        return out
    cluster.prefill.prefill_many = recorded
    for rid, toks, max_new, extras in requests:
        cluster.submit(mod.ServeRequest(rid, list(toks),
                                        max_new_tokens=max_new,
                                        extras=extras))
    cluster.run_until_done()
    return cluster, passes


def test_cluster_matches_jax_cluster(models, fp32_compute):
    """Requests with extras through both clusters: equal routing decisions
    and finish order, no resume, and every prompt pass's logits."""
    family, jm, jp, tm, tp = models
    requests = _requests(family, tm.cfg)
    ref, want = _serve(jax_disagg, jm, jp, requests)
    port, got = _serve(disagg, tm, tp, requests, device="cpu")
    assert [(d.worker, d.overlap) for d in port.control.decision_log] == \
        [(d.worker, d.overlap) for d in ref.control.decision_log]
    assert [r.request_id for r in port.done] == \
        [r.request_id for r in ref.done]
    assert {r.request_id: len(r.output) for r in port.done} == \
        {rid: m + 1 for rid, _, m, _ in requests}
    assert port.prefill.stats.reused_blocks == \
        ref.prefill.stats.reused_blocks == 0
    assert len(got) == len(want)
    for g_logits, w_logits in zip(got, want):
        for g, w in zip(g_logits, w_logits):
            np.testing.assert_allclose(g, w, atol=LOGITS_TOL, rtol=LOGITS_TOL)


# ------------------------------------------------- the reference's quirks ----

def _k_leaf(caches):
    """The K cache of either package, (P, B, T, K, hd) fp32 numpy."""
    if "k" in caches:
        return caches["k"].float().numpy()
    return np.asarray(caches["p0"]["kv"]["k"], np.float32)


def test_vlm_decode_starts_inside_the_prompt(fp32_compute):
    """ROADMAP §C note 6: the cluster admits a VLM request at
    ``prompt_len=len(tokens)`` though its prefill cache holds
    ``num_patches + len(tokens)`` positions, so the first decode step
    writes its K/V at position ``len(tokens)``, over a prompt position, and
    attends to positions ``<= len(tokens)`` only.  Both engines do so, to
    the same logits."""
    jm, jp, tm, tp = _bridged(ARCHS["vlm"])
    toks = _prompt(2, 30)
    extras = _extras("vlm", tm.cfg, 50)
    outs = []
    for mod, model, params, kw in ((jax_engine, jm, jp, {}),
                                   (engine, tm, tp, {"device": "cpu"})):
        pre = mod.PrefillEngine(model, params, MAX_LEN, **kw)
        dec = mod.DecodeEngine(model, params, 1, MAX_LEN, **kw)
        logits, caches = pre.prefill(toks, extras)
        before = _k_leaf(caches)
        dec.admit(0, "r", caches, int(np.argmax(logits)),
                  prompt_len=len(toks), max_new=4)
        assert dec.slots[0].length == len(toks)
        captured = []
        inner = dec.model.decode if mod is engine else None
        if mod is engine:
            def decode(params, caches, tokens, cur, **kw):
                captured.append(cur.clone())
                return inner(params, caches, tokens, cur, **kw)
            dec.model.decode = decode
        try:
            dec.step()
        finally:
            if mod is engine:
                del dec.model.decode
        after = _k_leaf(dec.caches)
        outs.append((before, after, captured))
    (jb, ja, _), (tb, ta, cur) = outs
    assert int(cur[0][0]) == len(toks) < tm.cfg.num_patches + len(toks)
    n = len(toks)
    for before, after in ((jb, ja), (tb, ta)):
        # the prefill wrote position n (a prompt position); the step
        # overwrote it with the new token's K
        assert before[:, 0, n].any()
        assert not np.array_equal(after[:, 0, n], before[:, 0, n])
        np.testing.assert_array_equal(after[:, 0, :n], before[:, 0, :n])
    # K/V are bf16 on both sides: within an ulp
    np.testing.assert_allclose(ta[:, 0, n], ja[:, 0, n], atol=1e-2,
                               rtol=1e-2)


def test_cached_cross_attention_attends_padded_keys(fp32_compute):
    """ROADMAP §C note 7: with a cache, cross attention runs over all
    ``ENC_CTX_DECODE`` keys, the zero padding past the frames included and
    unmasked, as the reference's ``_cross_cached`` does; without one (the
    loss) it attends to the frames only.  The port equals the reference in
    both, and the two differ."""
    jm, jp, tm, tp = _bridged(ARCHS["encdec"])
    rng = np.random.default_rng(60)
    frames = rng.standard_normal((1, 40, tm.cfg.frontend_dim), np.float32)
    x = rng.standard_normal((1, 5, tm.cfg.d_model), np.float32)
    enc = np.array(jm._run_encoder(jp, jnp.asarray(frames)))
    t_enc = tm._run_encoder(tp, torch.from_numpy(frames))
    np.testing.assert_allclose(t_enc.numpy(), enc, atol=1e-4, rtol=1e-4)
    jx = jax.tree.map(lambda a: a[0], jp["stack"]["p0"]["xattn"])
    tx = tp["layers"][0]["xattn"]
    # the cached path, on the prefill's zero-padded cross K/V
    _, jc = jm.prefill(jp, {"tokens": jnp.zeros((1, 4), jnp.int32),
                            "frames": jnp.asarray(frames)}, max_len=16)
    _, tc = tm.prefill(tp, {"tokens": torch.zeros((1, 4), dtype=torch.int32),
                            "frames": torch.from_numpy(frames)}, max_len=16)
    xk, xv = tc["xk"][0], tc["xv"][0]
    assert xk.shape[1] == TM.ENC_CTX_DECODE and not xk[:, 40:].any()
    cached = tm._cross_cached(tx, torch.from_numpy(x), xk, xv)
    ref_cached = jm._cross_cached(jx, jnp.asarray(x), jc["p0"]["xk"][0],
                                  jc["p0"]["xv"][0])
    np.testing.assert_allclose(cached.numpy(), np.asarray(ref_cached),
                               atol=1e-4, rtol=1e-4)
    # the uncached path attends to the 40 frames only
    plain, _ = TL.attention(tx, torch.from_numpy(x), tm.cfg,
                            kv_source=torch.from_numpy(enc), causal=False,
                            use_rope=False)
    ref_plain, _ = JL.attention(jx, jnp.asarray(x), jm.cfg,
                                kv_source=jnp.asarray(enc), causal=False,
                                use_rope=False)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref_plain),
                               atol=1e-4, rtol=1e-4)
    assert float((cached - plain).abs().max()) > 0.1 * float(
        plain.abs().max())
    # masking the padding would give the uncached result
    lens = torch.tensor([40])
    masked = TL._sdpa_chunked(
        torch.einsum("bsd,dhk->bshk",
                     TL.rmsnorm(tx["norm"], torch.from_numpy(x)), tx["wq"]),
        xk, xv, torch.zeros((1, 5), dtype=torch.int32), 1, kind="length",
        kv_lengths=lens)
    masked = torch.einsum("bshk,hkd->bsd", masked, tx["wo"])
    np.testing.assert_allclose(masked.numpy(), plain.numpy(), atol=1e-4,
                               rtol=1e-4)
