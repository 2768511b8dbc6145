"""The port's MoE models against ``repro.models.Model`` with the same
weights, carried across by ``repro_torch.bridge``: reduced qwen3-moe with
G = 8 query heads per KV head (as at full width) and reduced arctic (MoE
plus a dense residual).

Logits are held to the repo's cross-implementation bound, max|dlogits| <
0.02 x the reference's logit spread (tests/test_engine_batching.py), for
``prefill``, ``prefill_batched`` on a ragged batch at a tight capacity
factor (the padding rows count toward capacity, so rows are dropped),
``prefill_resume``, a 10-step forced decode walk under all four decode
impls, and the prompt passes of the cluster, which serves the same
requests as the JAX cluster with exactly equal (worker, overlap)
decisions.  ``train_loss`` with its aux term agrees within 2e-3, the loss
bound of ``chip_smoke.py``.

Routing is held apart from the rest.  The two frameworks' bf16 hidden
states differ in the last bit, so where a token's k-th and (k+1)-th router
logits nearly tie, the port may pick the other expert; from there the pass
follows another expert's output and, where capacity binds, drops other
rows, which no smooth bound covers.  So each test records the reference's
expert ids, call by call, and the port takes them in the same order (the
gate weights stay the softmax of the port's own logits at those ids): the
logits bound then holds the attention, the dispatch, the capacity and its
drops, and the combine.  The port's own choices are recorded beside them
and must equal the reference's expert sets for at least 95% of the (token,
layer) choices of every pass, the near-tie share allowed in
tests/test_torch_moe.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.layers import rmsnorm as jax_rmsnorm  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import disagg as jax_disagg  # noqa: E402
from repro.serving.engine import adopt_prefill_pages as jax_adopt  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.serving import disagg  # noqa: E402
from repro_torch.serving.engine import adopt_prefill_pages  # noqa: E402

torch.set_num_threads(1)

ARCHS = {"qwen3": ("qwen3-moe-30b-a3b", dict(num_heads=8, num_kv_heads=1)),
         "arctic": ("arctic-480b", {})}
MAX_LEN = 96
TOL = 2e-2
LOSS_BOUND = 2e-3
TIGHT = 0.5         # capacity factor at which the padded batch drops rows


def _tight(cfg):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=TIGHT))


@pytest.fixture(scope="module", params=sorted(ARCHS))
def models(request):
    name, heads = ARCHS[request.param]
    jcfg = jax_reduced(name, **heads)
    tcfg = get_reduced(name, **heads)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0), jnp.bfloat16)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    tp = params_from_numpy(tree, tcfg, dtype=torch.bfloat16, device="cpu")
    return jm, jp, Model(tcfg), tp


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


# ------------------------------------------------------------ routing ----

# The reference's MoE calls, (fp32 router logits, top-k ids) each, appended
# by an ordered callback traced into its passes.  One list for the module:
# a pass that the JAX engine traced in an earlier test appends here too.
_REF_CALLS = []


@pytest.fixture
def routing(monkeypatch):
    """Record the reference's routing, and make the port's MoE calls take
    it in call order: the port's n-th call gets the reference's n-th expert
    ids, and records its own (router logits, top-k ids) beside them."""
    rec = {"ref": _REF_CALLS, "port": []}
    _REF_CALLS.clear()
    ref_moe = jax_moe.moe

    def ref_recorded(params, x, cfg):
        # the reference's own router ops (moe.py:84-88), so that the ids
        # recorded are the ones it routes by
        xn = jax_rmsnorm(params["norm"], x, cfg.norm_eps)
        xn = xn.reshape(-1, x.shape[-1])
        logits = jnp.einsum("td,de->te", xn,
                            params["wr"].astype(jnp.bfloat16))
        logits = logits.astype(jnp.float32)
        _, idx = jax.lax.top_k(logits, cfg.moe.top_k)
        jax.debug.callback(
            lambda *a: _REF_CALLS.append(tuple(np.asarray(v) for v in a)),
            logits, idx, ordered=True)
        return ref_moe(params, x, cfg)

    port_route = moe_lib._route

    def port_forced(params, xn, k):
        logits, _, idx = port_route(params, xn, k)
        n = len(rec["port"])
        if n >= len(_REF_CALLS):
            jax.effects_barrier()
        ref_idx = torch.from_numpy(_REF_CALLS[n][1].astype(np.int64))
        assert ref_idx.shape == idx.shape
        rec["port"].append((logits.numpy(), idx.numpy()))
        return (logits, torch.softmax(torch.gather(logits, 1, ref_idx), -1),
                ref_idx)

    monkeypatch.setattr(jax_moe, "moe", ref_recorded)
    monkeypatch.setattr(moe_lib, "_route", port_forced)
    return rec


def _take(rec):
    """The records so far, after the reference's callbacks have run; the
    record lists are left empty."""
    jax.effects_barrier()
    out = {n: list(v) for n, v in rec.items()}
    for v in rec.values():
        v.clear()
    return out


def _own_choices_agree(ref, port):
    """The port's own expert sets equal the reference's for at least 95%
    of the (token, layer) choices of these calls."""
    assert len(ref) == len(port) > 0
    flips = choices = 0
    for (_, ref_idx), (_, port_idx) in zip(ref, port):
        diff = np.any(np.sort(ref_idx, -1) != np.sort(port_idx, -1), -1)
        flips += int(diff.sum())
        choices += diff.size
    assert flips <= 0.05 * choices


def _check_pass(rec, port_logits, ref_logits):
    got = _take(rec)
    _own_choices_agree(got["ref"], got["port"])
    _assert_logits(port_logits, ref_logits)


# -------------------------------------------------------------- tests ----

def test_layout_and_bridge_are_exact(models):
    jm, jp, tm, tp = models
    assert (tm.period, tm.descs, tm.n_periods) == (
        jm.period, [type(tm.descs[0])(**vars(d)) for d in jm.descs],
        jm.n_periods)
    assert all(d.mlp == "moe" for d in tm.descs)
    assert tm.supports_paged_decode and tm.supports_padded_prefill \
        and tm.supports_prefill_resume
    assert len(tp["layers"]) == tm.n_layers
    names = {"norm", "wr", "wu", "wg", "wd"}
    if tm.cfg.moe.dense_residual:
        names |= {"du", "dg", "dd"}
    for i, layer in enumerate(tp["layers"]):
        assert set(layer) == {"attn", "moe"}
        assert set(layer["moe"]) == names
        for name, t in layer["moe"].items():
            t = t["scale"] if name == "norm" else t
            ref = jp["stack"]["p0"]["moe"][name]
            ref = np.asarray(ref["scale"] if name == "norm" else ref,
                             np.float32)[i]
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.float().numpy(), ref)


def test_init_draws_every_moe_leaf():
    cfg = get_reduced("arctic-480b")
    params = Model(cfg).init(torch.Generator().manual_seed(0),
                             torch.bfloat16, device="cpu")
    m = cfg.moe
    moe = params["layers"][0]["moe"]
    assert moe["wu"].shape == (m.num_experts, cfg.d_model, m.d_ff_expert)
    assert moe["wd"].shape == (m.num_experts, m.d_ff_expert, cfg.d_model)
    assert moe["dd"].shape == (m.d_ff_dense, cfg.d_model)
    assert not torch.equal(params["layers"][0]["moe"]["wu"],
                           params["layers"][1]["moe"]["wu"])


def test_prefill(models, routing):
    jm, jp, tm, tp = models
    toks = np.array([_prompt(0, 40), _prompt(1, 40)], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        max_len=MAX_LEN)
    _check_pass(routing, tl, jl)
    assert tc["k"].shape == np.asarray(jc["p0"]["kv"]["k"]).shape


def test_prefill_batched_padding_drops_rows(models, routing):
    """A ragged batch right-padded to 48: capacity counts all 4 x 48 rows,
    padding included, and at the tight factor rows are dropped."""
    jm, jp, tm, tp = models
    jt, tt = JaxModel(_tight(jm.cfg)), Model(_tight(tm.cfg))
    lengths = np.array([48, 33, 40, 17], np.int32)
    toks = np.zeros((4, 48), np.int32)
    for r, n in enumerate(lengths):
        toks[r, :n] = _prompt(r, n)
    m = tt.cfg.moe
    cap = moe_lib._capacity(4 * 48, m)
    assert cap < 4 * 48 * m.top_k // m.num_experts          # rows dropped
    assert cap != moe_lib._capacity(int(lengths.sum()), m)  # padding counts
    jl, _ = jt.prefill_batched(jp, jnp.asarray(toks), jnp.asarray(lengths),
                               max_len=MAX_LEN)
    tl, _ = tt.prefill_batched(tp, torch.from_numpy(toks),
                               torch.from_numpy(lengths), max_len=MAX_LEN)
    _check_pass(routing, tl, jl)
    # the same batch at the default factor: the drops moved the logits
    jl, _ = jm.prefill_batched(jp, jnp.asarray(toks), jnp.asarray(lengths),
                               max_len=MAX_LEN)
    loose, _ = tm.prefill_batched(tp, torch.from_numpy(toks),
                                  torch.from_numpy(lengths), max_len=MAX_LEN)
    _check_pass(routing, loose, jl)
    assert not torch.allclose(loose, tl)


def test_prefill_resume(models, routing):
    jm, jp, tm, tp = models
    donor = np.array([_prompt(2, 45)], np.int32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(donor)}, max_len=MAX_LEN)
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(donor)},
                       max_len=MAX_LEN)
    _take(routing)
    suffix = np.array([_prompt(2, 56)[32:]], np.int32)
    jl, _ = jm.prefill_resume(jp, jc, jnp.asarray(suffix), 32)
    tl, _ = tm.prefill_resume(tp, tc, torch.from_numpy(suffix), 32)
    _check_pass(routing, tl, jl)


def _paged_pools(jm, tm, jc, tc, pages):
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
def test_forced_decode_walk(models, impl, routing):
    """Two ragged rows decode 10 steps; each step both sides get the
    reference's argmax."""
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
        jc, tc, table = _paged_pools(jm, tm, jc, tc, [[4, 9, 2], [7, 11]])
    step_fn = jax.jit(lambda p, c, t, i, tb: jm.decode(
        p, c, t, i, decode_impl=impl, page_table=tb))
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    _take(routing)
    walk = {"ref": [], "port": []}
    for step in range(10):
        cur = lengths + step
        jl, jc = step_fn(jp, jc, jnp.asarray(tok)[:, None], jnp.asarray(cur),
                         None if table is None else jnp.asarray(table))
        tl, tc = tm.decode(tp, tc, torch.from_numpy(tok)[:, None],
                           torch.from_numpy(cur), decode_impl=impl,
                           page_table=None if table is None
                           else torch.from_numpy(table))
        got = _take(routing)
        assert len(got["port"]) == tm.n_layers
        _assert_logits(tl, jl)
        tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        for n in walk:
            walk[n] += got[n]
    _own_choices_agree(walk["ref"], walk["port"])


def test_train_loss_with_aux(models):
    jm, jp, tm, tp = models
    toks = np.random.default_rng(5).integers(0, tm.cfg.vocab_size, (2, 64),
                                             dtype=np.int32)
    want = float(jm.train_loss(jp, {"tokens": jnp.asarray(toks)}))
    with torch.no_grad():
        got = tm.train_loss(tp, {"tokens": torch.from_numpy(toks)})
        _, aux = tm._run_stack(tp, tm._embed(tp, toks), None,
                               positions=None)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) < LOSS_BOUND
    assert float(aux) > 0.5 * tm.n_layers     # the aux term is in the loss


# ---- the cluster against the JAX cluster (tests/test_torch_slice.py) ----

CLUSTER = dict(num_decode=2, slots_per_worker=2, max_len=MAX_LEN,
               adaptive=False, cache_ttl=None)


def _requests(vocab):
    rng = np.random.default_rng(11)
    out = []
    for i in range(10):
        template = int(rng.integers(0, 3))
        n = int(rng.integers(30, 60))
        toks = [(template * 1_000_003 + 7 * j) % vocab for j in range(n)]
        out.append((f"r{i}", toks, int(rng.integers(2, 5))))
    return out


def _serve(mod, model, params, impl, requests, rec, side, **kw):
    """Serve ``requests`` all at once; returns (cluster, per prompt-pass
    batch: (its requests' logits, its span of ``side``'s MoE records)).
    Nothing is cleared meanwhile: the port's run takes the reference's
    routing call by call."""
    cluster = mod.DisaggregatedCluster(model, params, decode_impl=impl,
                                       **CLUSTER, **kw)
    passes = []
    inner = cluster.prefill.prefill_many

    def recorded(reqs):
        jax.effects_barrier()
        start = len(rec[side])
        out = inner(reqs)
        jax.effects_barrier()
        passes.append(([np.asarray(r[0], np.float32) for r in out],
                       slice(start, len(rec[side]))))
        return out
    cluster.prefill.prefill_many = recorded
    for rid, toks, max_new in requests:
        cluster.submit(mod.ServeRequest(rid, list(toks),
                                        max_new_tokens=max_new))
    cluster.run_until_done()
    jax.effects_barrier()
    return cluster, passes


@pytest.mark.parametrize("impl", ["pallas", "paged"])
def test_cluster_matches_jax_cluster(models, impl, routing):
    jm, jp, tm, tp = models
    requests = _requests(tm.cfg.vocab_size)
    ref, want = _serve(jax_disagg, jm, jp, impl, requests, routing, "ref")
    port, got = _serve(disagg, tm, tp, impl, requests, routing, "port",
                       device="cpu")
    decisions = [(d.worker, d.overlap) for d in port.control.decision_log]
    assert decisions == [(d.worker, d.overlap)
                         for d in ref.control.decision_log]
    assert [r.request_id for r in port.done] == \
        [r.request_id for r in ref.done]
    assert {r.request_id: len(r.output) for r in port.done} == \
        {rid: m + 1 for rid, _, m in requests}
    assert port.prefill.stats.reused_blocks == \
        ref.prefill.stats.reused_blocks > 0
    # the same model calls in the same order on both sides
    assert len(routing["port"]) == len(routing["ref"])
    assert len(got) == len(want)
    for (g_logits, g_span), (w_logits, w_span) in zip(got, want):
        assert g_span == w_span
        _own_choices_agree(routing["ref"][w_span], routing["port"][g_span])
        assert len(g_logits) == len(w_logits)
        for g, w in zip(g_logits, w_logits):
            _assert_logits(g, w)
    if impl == "paged":
        for dec in port.decoders:
            assert dec.allocator.audit() == []
            assert dec.allocator.free_pages == dec.allocator.num_pages
