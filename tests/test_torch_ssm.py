"""The port's sequence mixers (``repro_torch.models.ssm``) against
``repro.models.ssm`` on the same numpy inputs and weights, and the reference
tests' naive-recurrence oracles (tests/test_ssm.py) on the port's side.

Each function runs twice:

* in fp32, with ``COMPUTE_DTYPE`` set to fp32 in both modules (the blocks
  cast their weights and some results to it), held to 1e-5 elementwise,
  |port - ref| <= 1e-5 (1 + |ref|): the math, step for step;
* in bf16 as the model runs it (bf16 activations and weights, fp32 states
  and gates), held to the repo's bf16 kernel tolerance 2e-2 the same way
  (tests/test_kernels_decode.py).

Weights are the reference's ``*_init`` draws; their deterministic leaves
(norm scales, ``A_log``, ``D``, ``dt_bias``, the biases) get a seeded
perturbation, so a leaf taken at the wrong index shows.  Lengths are off
the chunk sizes (S = 17, 40), so the chunked scans' padding is held too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.bridge import tree_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from test_ssm import _mlstm_naive, _ssd_naive  # noqa: E402

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = sorted(TOL)
JAMBA, XLSTM = "jamba-v0.1-52b", "xlstm-125m"


@pytest.fixture(params=DTYPES)
def dtype(request, monkeypatch):
    """The compute dtype of both modules for one test."""
    name = request.param
    monkeypatch.setattr(JS, "COMPUTE_DTYPE", getattr(jnp, name))
    monkeypatch.setattr(TS, "COMPUTE_DTYPE", getattr(torch, name))
    return name


def _close(port, ref, dtype):
    ref = np.asarray(ref, np.float32)
    port = port.float().numpy() if isinstance(port, torch.Tensor) else port
    assert port.shape == ref.shape
    tol = TOL[dtype]
    # equal infinities (the -inf stabilisers of an untouched state) agree
    same = (port == ref)
    err = np.where(same, 0.0, np.abs(port - ref))
    assert np.all(err <= tol * (1 + np.abs(np.where(same, 0.0, ref)))), \
        float(err.max())


def _arrays(rng, dtype, *shapes):
    """Standard-normal arrays as (jax, torch) pairs in ``dtype``."""
    out = []
    for shape in shapes:
        a = rng.standard_normal(shape).astype(np.float32)
        out.append((jnp.asarray(a).astype(getattr(jnp, dtype)),
                    torch.from_numpy(a).to(getattr(torch, dtype))))
    return out


def _params(init, name, dtype, seed=0):
    """The reference's ``init`` for reduced ``name`` in ``dtype``, 1-D
    leaves perturbed, as (jax tree, torch tree, jax cfg, torch cfg)."""
    jcfg, tcfg = jax_reduced(name), get_reduced(name)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        init(jax.random.PRNGKey(seed), jcfg, jnp.float32))
    rng = np.random.default_rng(seed + 100)
    tree = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape)
                        .astype(np.float32) if a.ndim == 1 else a, tree)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(getattr(jnp, dtype)),
                      tree)
    tp = tree_from_numpy(tree, dtype=getattr(torch, dtype), device="cpu")
    return jp, tp, jcfg, tcfg


def _to_torch(tree):
    return jax.tree.map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(
            torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32),
        tree)


# ---------------------------------------------------------- SSD / Mamba ----

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(dtype, with_state):
    rng = np.random.default_rng(1)
    (jx, tx), (jw, tw), (jb, tb), (js, ts) = _arrays(
        rng, dtype, (2, 17, 24), (4, 24), (24,), (2, 3, 24))
    jy, jst = JS._causal_conv(jx, jw, jb, js if with_state else None)
    ty, tst = TS._causal_conv(tx, tw, tb, ts if with_state else None)
    _close(ty, jy, dtype)
    _close(tst, jst, dtype)


@pytest.mark.parametrize("s,chunk", [(17, 8), (40, 16), (32, 8), (16, 64)])
def test_ssd_chunked_matches_reference(dtype, s, chunk):
    rng = np.random.default_rng(2)
    b, h, p, n = 2, 3, 4, 5
    (jx, tx), (jb, tb), (jc, tc) = _arrays(rng, dtype, (b, s, h, p),
                                           (b, s, n), (b, s, n))
    dt = rng.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32)
    a_log = np.log(rng.uniform(1, 8, size=(h,))).astype(np.float32)
    jy, jst = JS.ssd_chunked(jx, jnp.asarray(dt), jnp.asarray(a_log), jb, jc,
                             chunk)
    ty, tst = TS.ssd_chunked(tx, torch.from_numpy(dt),
                             torch.from_numpy(a_log), tb, tc, chunk)
    assert ty.dtype == tx.dtype and tst.dtype == torch.float32
    _close(ty, jy, dtype)
    _close(tst, jst, dtype)


@pytest.mark.parametrize("s", [17, 40])
def test_mamba_block_matches_reference(dtype, s):
    """The prompt pass (y and the cache it leaves), then one cached step
    from the reference's cache."""
    jp, tp, jcfg, tcfg = _params(JS.mamba_init, JAMBA, dtype)
    (jx, tx), = _arrays(np.random.default_rng(3), dtype,
                        (2, s + 1, jcfg.d_model))
    jy, jc = JS.mamba_block(jp, jx[:, :s], jcfg)
    ty, tc = TS.mamba_block(tp, tx[:, :s], tcfg)
    _close(ty, jy, dtype)
    assert set(tc) == set(jc) == {"ssm", "conv"}
    assert tc["ssm"].dtype == torch.float32
    for k in jc:
        _close(tc[k], jc[k], dtype)
    jy1, jc1 = JS.mamba_block(jp, jx[:, s:], jcfg, cache=jc)
    ty1, tc1 = TS.mamba_block(tp, tx[:, s:], tcfg, cache=_to_torch(jc))
    _close(ty1, jy1, dtype)
    for k in jc1:
        _close(tc1[k], jc1[k], dtype)


def test_mamba_cache_init_matches_reference():
    cfg = get_reduced(JAMBA)
    ref = JS.mamba_cache_init(jax_reduced(JAMBA), 3)
    got = TS.mamba_cache_init(cfg, 3, "cpu")
    for k, v in ref.items():
        assert got[k].shape == v.shape
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype)


# ---------------------------------------------------------------- mLSTM ----

def _gates(rng, b, s, h):
    log_i = rng.standard_normal((b, s, h)).astype(np.float32)
    log_f = np.log(rng.uniform(0.5, 0.99, size=(b, s, h))).astype(np.float32)
    return log_i, log_f


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("s,chunk", [(17, 8), (40, 16), (16, 64)])
def test_mlstm_chunked_matches_reference(dtype, s, chunk, carried):
    rng = np.random.default_rng(4)
    b, h, p = 2, 2, 6
    (jq, tq), (jk, tk), (jv, tv) = _arrays(rng, dtype, *[(b, s, h, p)] * 3)
    log_i, log_f = _gates(rng, b, s, h)
    state = None
    if carried:   # the state an earlier 11-token pass left
        (pq, _), (pk, _), (pv, _) = _arrays(rng, dtype, *[(b, 11, h, p)] * 3)
        pi, pf = _gates(rng, b, 11, h)
        _, state = JS.mlstm_chunked(pq, pk, pv, jnp.asarray(pi),
                                    jnp.asarray(pf), chunk)
    jh, jst = JS.mlstm_chunked(jq, jk, jv, jnp.asarray(log_i),
                               jnp.asarray(log_f), chunk, state)
    th, tst = TS.mlstm_chunked(
        tq, tk, tv, torch.from_numpy(log_i), torch.from_numpy(log_f), chunk,
        None if state is None else tuple(_to_torch(state)))
    assert th.dtype == tq.dtype
    _close(th, jh, dtype)
    for t, j in zip(tst, jst):
        assert t.dtype == torch.float32
        _close(t, j, dtype)


def test_mlstm_step_matches_reference(dtype):
    rng = np.random.default_rng(5)
    b, h, p = 2, 3, 8
    (jq, tq), (jk, tk), (jv, tv), (jc, _), (jn, _) = _arrays(
        rng, dtype, (b, h, p), (b, h, p), (b, h, p), (b, h, p, p), (b, h, p))
    state = (jc.astype(jnp.float32), jn.astype(jnp.float32),
             jnp.asarray(rng.standard_normal((b, h)), jnp.float32))
    li = rng.standard_normal((b, h)).astype(np.float32)
    lf = np.log(rng.uniform(0.5, 0.99, size=(b, h))).astype(np.float32)
    jh, jst = JS.mlstm_step(jq, jk, jv, jnp.asarray(li), jnp.asarray(lf),
                            state)
    th, tst = TS.mlstm_step(tq, tk, tv, torch.from_numpy(li),
                            torch.from_numpy(lf), tuple(_to_torch(state)))
    _close(th, jh, dtype)
    for t, j in zip(tst, jst):
        _close(t, j, dtype)


@pytest.mark.parametrize("s", [17, 40])
def test_mlstm_block_matches_reference(dtype, s):
    jp, tp, jcfg, tcfg = _params(JS.mlstm_init, XLSTM, dtype)
    (jx, tx), = _arrays(np.random.default_rng(6), dtype,
                        (2, s + 1, jcfg.d_model))
    jy, jc = JS.mlstm_block(jp, jx[:, :s], jcfg)
    ty, tc = TS.mlstm_block(tp, tx[:, :s], tcfg)
    _close(ty, jy, dtype)
    assert set(tc) == set(jc) == {"C", "n", "m"}
    for k in jc:
        _close(tc[k], jc[k], dtype)
    jy1, jc1 = JS.mlstm_block(jp, jx[:, s:], jcfg, cache=jc)
    ty1, tc1 = TS.mlstm_block(tp, tx[:, s:], tcfg, cache=_to_torch(jc))
    _close(ty1, jy1, dtype)
    for k in jc1:
        _close(tc1[k], jc1[k], dtype)


# ---------------------------------------------------------------- sLSTM ----

@pytest.mark.parametrize("s", [1, 17])
def test_slstm_block_matches_reference(dtype, s):
    """The scan over a prompt (S = 1 is a scan of one step from the fresh
    state), then one cached step from the reference's cache."""
    jp, tp, jcfg, tcfg = _params(JS.slstm_init, XLSTM, dtype)
    (jx, tx), = _arrays(np.random.default_rng(7), dtype,
                        (2, s + 1, jcfg.d_model))
    jy, jc = JS.slstm_block(jp, jx[:, :s], jcfg)
    ty, tc = TS.slstm_block(tp, tx[:, :s], tcfg)
    _close(ty, jy, dtype)
    assert set(tc) == set(jc) == {"c", "n", "h", "m"}
    for k in jc:
        assert tc[k].dtype == torch.float32
        _close(tc[k], jc[k], dtype)
    jy1, jc1 = JS.slstm_block(jp, jx[:, s:], jcfg, cache=jc)
    ty1, tc1 = TS.slstm_block(tp, tx[:, s:], tcfg, cache=_to_torch(jc))
    _close(ty1, jy1, dtype)
    for k in jc1:
        _close(tc1[k], jc1[k], dtype)


@pytest.mark.parametrize("name,fn", [
    (XLSTM, "mlstm_cache_init"), (XLSTM, "slstm_cache_init")])
def test_xlstm_cache_init_matches_reference(name, fn):
    ref = getattr(JS, fn)(jax_reduced(name), 3)
    got = getattr(TS, fn)(get_reduced(name), 3, "cpu")
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == torch.float32
        assert np.array_equal(got[k].numpy(), np.asarray(v))   # 0 and -inf


@pytest.mark.parametrize("name,init", [
    (JAMBA, "mamba_init"), (XLSTM, "mlstm_init"), (XLSTM, "slstm_init")])
def test_init_matches_reference_layout(name, init):
    """Same leaves, shapes and dtypes as the reference's init; its
    deterministic leaves equal."""
    ref = getattr(JS, init)(jax.random.PRNGKey(0), jax_reduced(name),
                            jnp.float32)
    got = getattr(TS, init)(torch.Generator().manual_seed(0),
                            get_reduced(name), torch.bfloat16, "cpu")
    assert set(got) == set(ref)
    for k, v in ref.items():
        t = got[k]["scale"] if k.endswith("norm") else got[k]
        v = v["scale"] if k.endswith("norm") else v
        assert t.shape == v.shape and t.dtype == torch.bfloat16
        if k in ("A_log", "D", "dt_bias", "conv_b", "b_f", "b_z", "b_i",
                 "b_o") or k.endswith("norm"):
            want = np.asarray(jnp.asarray(v).astype(jnp.bfloat16), np.float32)
            assert np.array_equal(t.float().numpy(), want), k
        else:
            assert float(t.float().std()) > 0, k


# ------------------------------------ the reference tests' oracles (port) ----

@pytest.mark.parametrize("s,chunk", [(32, 8), (40, 16), (16, 16), (24, 64),
                                     (17, 16)])
def test_port_ssd_chunked_matches_naive(s, chunk):
    rng = np.random.default_rng(0)
    b, h, p, n = 2, 3, 4, 5
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32)
    a_log = np.log(rng.uniform(1, 8, size=(h,))).astype(np.float32)
    b_in = rng.normal(size=(b, s, n)).astype(np.float32)
    c_in = rng.normal(size=(b, s, n)).astype(np.float32)
    y, st = TS.ssd_chunked(*(torch.from_numpy(a) for a in
                             (x, dt, a_log, b_in, c_in)), chunk)
    y_ref, st_ref = _ssd_naive(x, dt, a_log, b_in, c_in)
    np.testing.assert_allclose(y.double().numpy(), y_ref, atol=2e-3,
                               rtol=2e-3)
    np.testing.assert_allclose(st.double().numpy(), st_ref, atol=2e-3,
                               rtol=2e-3)


def test_port_ssd_chunk_size_invariance():
    rng = np.random.default_rng(1)
    b, s, h, p, n = 1, 48, 2, 4, 3
    args = [torch.from_numpy(rng.normal(size=(b, s, h, p)).astype(np.float32)),
            torch.from_numpy(rng.uniform(0.01, 0.2, size=(b, s, h))
                             .astype(np.float32)),
            torch.zeros((h,)),
            torch.from_numpy(rng.normal(size=(b, s, n)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(b, s, n)).astype(np.float32))]
    y1, s1 = TS.ssd_chunked(*args, 8)
    y2, s2 = TS.ssd_chunked(*args, 24)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-4)
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), atol=1e-4)


def test_port_ssd_long_chunk_stays_finite():
    """Decays that underflow across a chunk: exp(l_i - l_j) for j > i
    overflows in fp32, and the port masks it before the exp."""
    b, s, h, p, n = 1, 64, 2, 4, 3
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(b, s, h, p)).astype(np.float32))
    dt = torch.full((b, s, h), 2.0)
    a_log = torch.log(torch.tensor([16.0, 1.0]))
    bc = torch.from_numpy(rng.normal(size=(b, s, n)).astype(np.float32))
    y, st = TS.ssd_chunked(x, dt, a_log, bc, bc, 64)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())


def test_port_mamba_block_decode_matches_fullseq():
    tcfg = get_reduced(JAMBA)
    p = TS.mamba_init(torch.Generator().manual_seed(0), tcfg, torch.float32,
                      "cpu")
    x = torch.randn((2, 17, tcfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    y_full, _ = TS.mamba_block(p, x.to(torch.bfloat16), tcfg)
    _, cache = TS.mamba_block(p, x[:, :16].to(torch.bfloat16), tcfg)
    y_step, _ = TS.mamba_block(p, x[:, 16:17].to(torch.bfloat16), tcfg,
                               cache=cache)
    np.testing.assert_allclose(y_step[:, 0].float().numpy(),
                               y_full[:, 16].float().numpy(), atol=3e-2,
                               rtol=3e-2)


@pytest.mark.parametrize("s,chunk", [(24, 8), (32, 16), (16, 64), (17, 8)])
def test_port_mlstm_chunked_matches_naive(s, chunk):
    rng = np.random.default_rng(2)
    b, h, p = 2, 2, 6
    q, k, v = (rng.normal(size=(b, s, h, p)).astype(np.float32)
               for _ in range(3))
    log_i = rng.normal(size=(b, s, h)).astype(np.float32)
    log_f = np.log(rng.uniform(0.5, 0.99, size=(b, s, h))).astype(np.float32)
    hs, (C, n, m) = TS.mlstm_chunked(
        *(torch.from_numpy(a) for a in (q, k, v, log_i, log_f)), chunk)
    hs_ref, (C_ref, n_ref, m_ref) = _mlstm_naive(q, k, v, log_i, log_f)
    np.testing.assert_allclose(hs.double().numpy(), hs_ref, atol=2e-3,
                               rtol=2e-3)
    # states match up to the shared stabilizer normalization
    np.testing.assert_allclose(
        C.double().numpy() * np.exp(m.double().numpy())[..., None, None],
        C_ref * np.exp(m_ref)[..., None, None], atol=2e-3, rtol=2e-3)


def test_port_mlstm_chunk_size_invariance():
    rng = np.random.default_rng(9)
    b, s, h, p = 1, 40, 2, 4
    args = [torch.from_numpy(rng.normal(size=(b, s, h, p)).astype(np.float32))
            for _ in range(3)]
    args += [torch.from_numpy(rng.normal(size=(b, s, h)).astype(np.float32)),
             torch.from_numpy(np.log(rng.uniform(0.5, 0.99, size=(b, s, h)))
                              .astype(np.float32))]
    h1, (c1, n1, m1) = TS.mlstm_chunked(*args, 8)
    h2, (c2, n2, m2) = TS.mlstm_chunked(*args, 24)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        (c1 * torch.exp(m1)[..., None, None]).numpy(),
        (c2 * torch.exp(m2)[..., None, None]).numpy(), atol=1e-4, rtol=1e-4)


def test_port_mlstm_step_continues_chunked():
    rng = np.random.default_rng(3)
    b, s, h, p = 1, 16, 2, 4
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s + 1, h, p))
                                .astype(np.float32)) for _ in range(3))
    log_i = torch.from_numpy(rng.normal(size=(b, s + 1, h)).astype(np.float32))
    log_f = torch.from_numpy(np.log(rng.uniform(0.5, 0.99, size=(b, s + 1, h)))
                             .astype(np.float32))
    full, _ = TS.mlstm_chunked(q, k, v, log_i, log_f, 8)
    _, st = TS.mlstm_chunked(q[:, :s], k[:, :s], v[:, :s], log_i[:, :s],
                             log_f[:, :s], 8)
    h_step, _ = TS.mlstm_step(q[:, s], k[:, s], v[:, s], log_i[:, s],
                              log_f[:, s], st)
    np.testing.assert_allclose(h_step.numpy(), full[:, s].numpy(), atol=2e-3,
                               rtol=2e-3)


def test_port_slstm_step_vs_scan():
    tcfg = get_reduced(XLSTM)
    p = TS.slstm_init(torch.Generator().manual_seed(0), tcfg, torch.float32,
                      "cpu")
    x = torch.randn((2, 9, tcfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    y_full, cache_full = TS.slstm_block(p, x.to(torch.bfloat16), tcfg)
    _, cache = TS.slstm_block(p, x[:, :8].to(torch.bfloat16), tcfg)
    y_step, cache_step = TS.slstm_block(p, x[:, 8:9].to(torch.bfloat16), tcfg,
                                        cache=cache)
    np.testing.assert_allclose(y_step[:, 0].float().numpy(),
                               y_full[:, 8].float().numpy(), atol=3e-2,
                               rtol=3e-2)
    np.testing.assert_allclose(cache_step["c"].numpy(),
                               cache_full["c"].numpy(), atol=2e-3, rtol=2e-3)
