"""The port's hybrid (Mamba + attention) and SSM (xLSTM) models and the
engine's capability gates against ``repro.models.Model`` and
``repro.serving.engine`` with the same weights, carried across by
``repro_torch.bridge``: reduced jamba-v0.1-52b (one period of 8 layers, 7
Mamba and 1 attention, 4 MoE) and reduced xlstm-125m (3 mLSTM and 1
sLSTM).

Every test here runs with ``COMPUTE_DTYPE`` set to fp32 in both packages
(``layers``, ``moe`` and ``ssm`` modules) and fp32 weights.  In
bf16 the reference does not meet the walk bound against itself on reduced
Jamba: its jitted prompt pass and the same blocks applied one by one differ
by 0.013-0.023 x the logit spread (7 Mamba layers amplify last-bit
differences), so a bf16 comparison could not tell a fault from rounding.
In fp32 that floor is gone and the repo's cross-implementation bound,
max|dlogits| < 0.02 x the reference's logit spread
(tests/test_engine_batching.py), holds ``prefill``, ``prefill_batched`` on
equal-length rows, a 10-step forced decode walk from caches inserted into
ragged slots (``"pallas"`` and ``"sdpa"``), the prompt passes of the
cluster, and the loss within 2e-3 (``chip_smoke.py``'s loss bound).  The
bf16 blocks are held one by one in tests/test_torch_ssm.py.

The engine gates (reference engine.py:144, 184, 207, 274, 353, 441,
722-727) are compared with the JAX engine on these models: no padded
bucket, no resume, no stored prefix, a paged decoder refused, and KV bytes
over the attention layers only; the dense and MoE families keep padding,
resume and paging.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import disagg as jax_disagg  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.radix import BLOCK_SIZE, block_hashes  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.model import CACHE_LEAVES  # noqa: E402
from repro_torch.serving import disagg  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

torch.set_num_threads(1)

ARCHS = {"jamba": "jamba-v0.1-52b", "xlstm": "xlstm-125m"}
MAX_LEN = 96
LOSS_BOUND = 2e-3


@pytest.fixture(autouse=True)
def _fp32_compute(monkeypatch):
    """Both packages compute in fp32 for every test of this file."""
    for mod in (JL, JMOE, JS):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    for mod in (TL, TMOE, TS):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


def _bridged(name):
    """(jax model, jax fp32 params, port model, the same params bridged)."""
    jm = JaxModel(jax_reduced(name))
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    tm = Model(get_reduced(name))
    tp = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                        jp), tm.cfg, dtype=torch.float32,
                           device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module", params=sorted(ARCHS))
def models(request):
    return _bridged(ARCHS[request.param])


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


def _ref_leaf(jm, tm, jc, name, j, raw=False):
    """The reference's leaf for the port's cache leaf ``name``, row ``j``,
    as fp32 numpy (``raw``: the JAX array, in its own dtype)."""
    kind = next(k for k, names in CACHE_LEAVES.items() if name in names)
    i = [n for n, m in enumerate(tm.mixers) if m == kind][j]
    block = jc[f"p{i % jm.period}"]
    if kind == "attn":
        leaf = block["kv"][name]
    else:
        leaf = block["state"][name.split("_", 1)[1] if kind != "mamba"
                              else name]
    leaf = leaf[i // jm.period]
    return leaf if raw else np.asarray(leaf, np.float32)


def _assert_caches(jm, tm, tc, jc, cols=None):
    """Every port leaf row against the reference's, within tol (1 + |ref|):
    1e-4 for fp32 leaves, 1e-2 (an ulp) for the K/V, which both keep in
    bf16; equal infinities agree.  ``cols`` limits K/V to positions below
    it (the reference writes its prompt's K/V, the rest is zero)."""
    for name, t in tc.items():
        tol = 1e-2 if t.dtype == torch.bfloat16 else 1e-4
        for j in range(t.shape[0]):
            ref = _ref_leaf(jm, tm, jc, name, j)
            got = t[j].float().numpy()
            if name in ("k", "v") and cols is not None:
                ref, got = ref[:, :cols], got[:, :cols]
            assert got.shape == ref.shape, name
            same = got == ref
            err = np.where(same, 0.0, np.abs(got - ref))
            assert np.all(err <= tol * (1 + np.abs(np.where(same, 0, ref)))), \
                (name, j, float(err.max()))


# --------------------------------------------------------------- layout ----

def test_layout_and_bridge_are_exact(models):
    jm, jp, tm, tp = models
    assert (tm.period, tm.descs, tm.n_periods) == (
        jm.period, [type(tm.descs[0])(**vars(d)) for d in jm.descs],
        jm.n_periods)
    gates = ("supports_paged_decode", "supports_padded_prefill",
             "supports_prefill_resume")
    assert [getattr(tm, g) for g in gates] == \
        [getattr(jm, g) for g in gates] == [False] * 3
    assert len(tp["layers"]) == tm.n_layers
    for i, layer in enumerate(tp["layers"]):
        ref = jax.tree.map(lambda a: np.asarray(a, np.float32)[i // jm.period],
                           jp["stack"][f"p{i % jm.period}"])
        assert set(layer) == set(ref)
        flat = jax.tree_util.tree_flatten_with_path(ref)[0]
        for path, want in flat:
            got = layer
            for p in path:
                got = got[p.key]
            assert got.shape == want.shape
            assert np.array_equal(got.numpy(), want), path


def test_cache_layout(models):
    """One stack per leaf kind over that kind's layers, batch at axis 1,
    equal to the reference's leaves (zeros, the stabilisers at -inf) in
    shape and dtype."""
    jm, _, tm, _ = models
    caches = tm.cache_init(3, MAX_LEN, "cpu")
    kinds = set(tm.mixers)
    assert set(caches) == {n for k in kinds for n in CACHE_LEAVES[k]}
    jc = jm.cache_init(3, MAX_LEN)
    for name, t in caches.items():
        kind = next(k for k, v in CACHE_LEAVES.items() if name in v)
        assert t.shape[:2] == (tm.mixers.count(kind), 3)
        for j in range(t.shape[0]):
            ref = _ref_leaf(jm, tm, jc, name, j)
            assert t[j].shape == ref.shape
            assert np.array_equal(t[j].float().numpy(), ref), name
            want = _ref_leaf(jm, tm, jc, name, j, raw=True).dtype
            assert str(t.dtype).split(".")[-1] == str(want), name
    assert [tm.mixers[i] for i in range(tm.n_layers)] == \
        [jm.descs[i % jm.period].mixer for i in range(tm.n_layers)]


# -------------------------------------------------------------- prompts ----

def test_prefill(models):
    jm, jp, tm, tp = models
    toks = np.array([_prompt(0, 40), _prompt(1, 40)], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        max_len=MAX_LEN)
    _assert_logits(tl, jl)
    _assert_caches(jm, tm, tc, jc)


def test_prefill_batched_equal_lengths(models):
    """Three equal-length rows and a width-padding row (the engine's
    power-of-two batch): the real rows' logits and states."""
    jm, jp, tm, tp = models
    toks = np.zeros((4, 33), np.int32)
    for r in range(3):
        toks[r] = _prompt(r + 5, 33)
    lengths = np.array([33, 33, 33, 1], np.int32)
    jl, jc = jm.prefill_batched(jp, jnp.asarray(toks), jnp.asarray(lengths),
                                max_len=MAX_LEN)
    tl, tc = tm.prefill_batched(tp, torch.from_numpy(toks),
                                torch.from_numpy(lengths), max_len=MAX_LEN)
    _assert_logits(tl[:3], np.asarray(jl)[:3])
    _assert_caches(jm, tm, {n: t[:, :3] for n, t in tc.items()},
                   jax.tree.map(lambda a: a[:, :3], jc))


def test_resume_and_paging_are_refused(models):
    _, _, tm, tp = models
    _, caches = tm.prefill(tp, {"tokens": torch.zeros((1, 20), dtype=torch
                                                      .int32)}, max_len=48)
    with pytest.raises(ValueError, match="resumed prompt pass"):
        tm.prefill_resume(tp, caches, torch.zeros((1, 4), dtype=torch.int32),
                          16)
    with pytest.raises(ValueError, match="paged KV"):
        tm.paged_cache_init(8, 16, "cpu")


# --------------------------------------------------------------- decode ----

def _ragged_slots(jm, jp, tm, tp, lengths):
    """Each prompt prefilled on its own and inserted into its decode slot,
    on both sides; returns (jax caches, port caches, first tokens)."""
    jc = jm.cache_init(len(lengths), MAX_LEN)
    tc = tm.cache_init(len(lengths), MAX_LEN, "cpu")
    first = []
    for slot, n in enumerate(lengths):
        toks = np.array([_prompt(slot + 3, n)], np.int32)
        jl, jrow = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                              max_len=MAX_LEN)
        _, trow = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                             max_len=MAX_LEN)
        jc = jax_engine._insert_cache(jc, jrow, slot, jm)
        engine._insert_cache(tc, trow, slot)
        first.append(int(np.argmax(np.asarray(jl)[0])))
    return jc, tc, np.asarray(first, np.int32)


@pytest.mark.parametrize("impl", ["sdpa", "pallas"])
def test_forced_decode_walk(models, impl):
    """Two slots at lengths 37 and 22 decode 10 steps; each step both sides
    get the reference's argmax."""
    jm, jp, tm, tp = models
    lengths = np.array([37, 22], np.int32)
    jc, tc, tok = _ragged_slots(jm, jp, tm, tp, lengths)
    _assert_caches(jm, tm, tc, jc)
    step_fn = jax.jit(lambda p, c, t, i: jm.decode(p, c, t, i,
                                                   decode_impl=impl))
    for step in range(10):
        cur = lengths + step
        jl, jc = step_fn(jp, jc, jnp.asarray(tok)[:, None], jnp.asarray(cur))
        tl, tc = tm.decode(tp, tc, torch.from_numpy(tok)[:, None],
                           torch.from_numpy(cur), decode_impl=impl)
        _assert_logits(tl, jl)
        tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    _assert_caches(jm, tm, tc, jc, cols=int(lengths.min()) + 10)


def test_insert_cache_copies_state_leaves():
    """A fresh prefill bundle (every stabiliser at -inf, K/V shorter than
    the decode cache) lands in its slot whole: the -inf leaves copied, not
    zeroed; K/V zero-padded; the other slot untouched.  Both engines."""
    for name in ARCHS.values():
        jm, tm = JaxModel(jax_reduced(name)), Model(get_reduced(name))
        dst = {n: torch.full_like(t, 7.0)
               for n, t in tm.cache_init(2, MAX_LEN, "cpu").items()}
        src = tm.cache_init(1, 40, "cpu")
        engine._insert_cache(dst, src, 1)
        jdst = jax.tree.map(lambda a: jnp.full_like(a, 7.0),
                            jm.cache_init(2, MAX_LEN))
        jdst = jax_engine._insert_cache(jdst, jm.cache_init(1, 40), 1, jm)
        for n, t in dst.items():
            assert bool((t[:, 0] == 7.0).all()), n
            want = src[n][:, 0]
            if n in ("k", "v"):
                want = torch.nn.functional.pad(
                    want, (0, 0, 0, 0, 0, MAX_LEN - 40))
            assert torch.equal(t[:, 1], want.to(t.dtype)), n
            for j in range(t.shape[0]):
                assert np.array_equal(t[j].float().numpy(),
                                      _ref_leaf(jm, tm, jdst, n, j)), n
        assert any(bool(torch.isinf(t).any()) for t in dst.values()) == \
            (name == "xlstm-125m")


def test_train_loss(models):
    jm, jp, tm, tp = models
    toks = np.random.default_rng(5).integers(0, tm.cfg.vocab_size, (2, 48),
                                             dtype=np.int32)
    want = float(jm.train_loss(jp, {"tokens": jnp.asarray(toks)}))
    with torch.no_grad():
        got = tm.train_loss(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    assert abs(float(got) - want) < LOSS_BOUND


# ----------------------------------------------------------- the gates ----

@pytest.fixture(scope="module")
def gate_models():
    """(label, jax model, jax params, port model, port params) for the two
    recurrent families and the dense and MoE ones."""
    return [(label, *_bridged(name)) for label, name in (
        ("jamba", ARCHS["jamba"]), ("xlstm", ARCHS["xlstm"]),
        ("dense", "phi4-mini-3.8b"), ("moe", "qwen3-moe-30b-a3b"))]


def test_padded_len_and_kv_bytes_match_the_jax_engine(gate_models):
    for label, jm, jp, tm, tp in gate_models:
        je = jax_engine.PrefillEngine(jm, jp, MAX_LEN)
        te = engine.PrefillEngine(tm, tp, MAX_LEN, device="cpu")
        for n in (1, 15, 16, 17, 40):
            assert te._padded_len(n) == je._padded_len(n), (label, n)
        recurrent = label in ("jamba", "xlstm")
        assert (te._padded_len(17) == 17) == recurrent, label
        assert engine.kv_token_bytes(tm) == jax_engine.kv_token_bytes(jm), \
            label
    bytes_of = {label: engine.kv_token_bytes(tm)
                for label, _, _, tm, _ in gate_models}
    assert bytes_of["xlstm"] == 0
    # reduced jamba attends in 1 of 8 layers: 2 x 1 x K x hd x 2 bytes
    jamba = next(tm for label, _, _, tm, _ in gate_models if label == "jamba")
    assert bytes_of["jamba"] == 4 * jamba.cfg.num_kv_heads * \
        jamba.cfg.resolved_head_dim


def test_paged_decoder_is_refused_for_recurrent_mixers(gate_models):
    for label, jm, jp, tm, tp in gate_models:
        if label in ("dense", "moe"):
            dec = engine.DecodeEngine(tm, tp, 2, MAX_LEN, decode_impl="paged",
                                      device="cpu")
            assert dec.paged and dec.allocator is not None
            continue
        with pytest.raises(ValueError) as ref:
            jax_engine.DecodeEngine(jm, jp, 2, MAX_LEN, decode_impl="paged")
        for impl in engine.PAGED_IMPLS:
            with pytest.raises(ValueError) as got:
                engine.DecodeEngine(tm, tp, 2, MAX_LEN, decode_impl=impl,
                                    device="cpu")
            assert str(got.value) == str(ref.value)
        dense = engine.DecodeEngine(tm, tp, 2, MAX_LEN, device="cpu")
        assert not dense.paged


def _shared_prefix_requests():
    """Two prompts sharing 32 tokens (a resume on an attention model), one
    of them twice, a third of the same length and a shorter one; the
    cluster passes each request's block hashes, so some carry theirs."""
    a = _prompt(1, 48)
    b = a[:32] + _prompt(2, 16)
    c = _prompt(3, 48)
    return [(a, None, block_hashes(a, BLOCK_SIZE)), (b, None, None),
            (a, None, None), (c, None, block_hashes(c, BLOCK_SIZE)),
            (_prompt(4, 21), None, None)]


def test_prefill_engine_gates_match_the_jax_engine(gate_models, monkeypatch):
    """The same requests through both engines, twice (the second call would
    resume every prompt on an attention model): equal stats, equal stored
    prefixes (none for the recurrent families), and equal bucketing."""
    for label, jm, jp, tm, tp in gate_models:
        je = jax_engine.PrefillEngine(jm, jp, MAX_LEN)
        te = engine.PrefillEngine(tm, tp, MAX_LEN, device="cpu")
        calls = []
        inner = tm.prefill_batched

        def batched(params, tokens, lengths, max_len=None, inner=inner):
            calls.append((tuple(tokens.shape), lengths.tolist()))
            return inner(params, tokens, lengths, max_len)
        monkeypatch.setattr(tm, "prefill_batched", batched)
        reqs = _shared_prefix_requests()
        for _ in range(2):
            je.prefill_many(reqs)
            te.prefill_many(reqs)
        je.prefill(reqs[1][0])
        te.prefill(reqs[1][0])
        want, got = je.stats.as_dict(), te.stats.as_dict()
        for key in ("wall_s", "flops"):
            want.pop(key), got.pop(key)
        assert got == want, label
        assert len(te._cache) == len(je._cache), label
        recurrent = label in ("jamba", "xlstm")
        assert (te.stats.reused_blocks == 0) == recurrent, label
        if recurrent:
            assert len(te._cache) == 0
            # cold buckets hold one exact length each: no right-padding
            for (w, plen), lens in calls:
                assert set(lens) <= {plen, 1}, (label, plen, lens)
            assert te.stats.padded_tokens == sum(
                (w - lens.count(plen)) * plen for (w, plen), lens in calls)
        monkeypatch.undo()


def test_warmup_runs_no_resume_on_recurrent_models(gate_models, monkeypatch):
    for label, jm, jp, tm, tp in gate_models:
        if label not in ("jamba", "xlstm"):
            continue
        te = engine.PrefillEngine(tm, tp, MAX_LEN, device="cpu")
        monkeypatch.setattr(tm, "prefill_resume", None)   # never called
        te.warmup([24, 40], suffix_lengths=[8, 16], batch_sizes=[1, 2])
        monkeypatch.undo()
        assert te.stats.requests == 0 and len(te._cache) == 0


# ---- the cluster against the JAX cluster (tests/test_torch_slice.py) ----

CLUSTER = dict(num_decode=2, slots_per_worker=2, max_len=MAX_LEN,
               adaptive=False, cache_ttl=None)


def _requests(vocab):
    rng = np.random.default_rng(11)
    out = []
    for i in range(8):
        template = int(rng.integers(0, 3))
        n = int(rng.choice([30, 41, 52]))
        toks = [(template * 1_000_003 + 7 * j) % vocab for j in range(n)]
        out.append((f"r{i}", toks, int(rng.integers(2, 5))))
    return out


def _serve(mod, model, params, requests, **kw):
    """Serve ``requests`` all at once; returns (cluster, the logits of
    every prompt pass in order)."""
    cluster = mod.DisaggregatedCluster(model, params, decode_impl="pallas",
                                       **CLUSTER, **kw)
    passes = []
    inner = cluster.prefill.prefill_many

    def recorded(reqs):
        out = inner(reqs)
        passes.append([np.asarray(r[0], np.float32) for r in out])
        return out
    cluster.prefill.prefill_many = recorded
    for rid, toks, max_new in requests:
        cluster.submit(mod.ServeRequest(rid, list(toks),
                                        max_new_tokens=max_new))
    cluster.run_until_done()
    return cluster, passes


def test_cluster_matches_jax_cluster(models):
    jm, jp, tm, tp = models
    requests = _requests(tm.cfg.vocab_size)
    ref, want = _serve(jax_disagg, jm, jp, requests)
    port, got = _serve(disagg, tm, tp, requests, device="cpu")
    decisions = [(d.worker, d.overlap) for d in port.control.decision_log]
    assert decisions == [(d.worker, d.overlap)
                         for d in ref.control.decision_log]
    assert [r.request_id for r in port.done] == \
        [r.request_id for r in ref.done]
    assert {r.request_id: len(r.output) for r in port.done} == \
        {rid: m + 1 for rid, _, m in requests}
    assert port.prefill.stats.reused_blocks == \
        ref.prefill.stats.reused_blocks == 0
    assert port.prefill.stats.padded_tokens == \
        ref.prefill.stats.padded_tokens
    assert len(got) == len(want)
    for g_logits, w_logits in zip(got, want):
        assert len(g_logits) == len(w_logits)
        for g, w in zip(g_logits, w_logits):
            _assert_logits(g, w)
