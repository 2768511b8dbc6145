"""The port's ``moe()`` against ``repro.models.moe.moe``, and the reference
tests' five properties (tests/test_moe.py) on the port's own ``moe()``.

Against the reference: the same inputs (a numpy seed) and the same bf16
weights (the reference's ``moe_init``, carried by ``repro_torch.bridge``),
on reduced qwen3-moe with G = 8 query heads per KV head (as at full width)
and reduced arctic (dense residual), at the default capacity factor and at
a tight one (0.05) that drops rows.  ``expert_load`` is exactly equal,
``moe_aux_loss`` within 1e-5 relative, the output within the repo's bf16
kernel tolerance 2e-2 (tests/test_kernels_decode.py).  Per-token top-k
expert ids are equal except where the reference's k-th and (k+1)-th router
logits lie within one bf16 ulp of each other (a near-tie, which the two
frameworks' bf16 products may order either way); those tokens are counted
and held to at most 5%.
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
from repro_torch.bridge import tree_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.layers import rmsnorm  # noqa: E402

torch.set_num_threads(1)

ARCHS = {"qwen3": ("qwen3-moe-30b-a3b", dict(num_heads=8, num_kv_heads=1)),
         "arctic": ("arctic-480b", {})}
TOL = 2e-2


def _with_capacity(cfg, factor):
    if factor is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


def _near_ties(logits, k):
    """Tokens whose k-th and (k+1)-th largest logits are within one bf16
    ulp (at the k-th's magnitude) of each other."""
    top = np.sort(logits, axis=-1)[:, ::-1]
    kth, nxt = top[:, k - 1], top[:, k]
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(kth), 1e-30))) - 7)
    return (kth - nxt) <= ulp


@pytest.mark.parametrize("factor", [None, 0.05], ids=["default", "tight"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_matches_reference(arch, factor):
    name, heads = ARCHS[arch]
    jcfg = _with_capacity(jax_reduced(name, **heads), factor)
    tcfg = _with_capacity(get_reduced(name, **heads), factor)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    if arch == "qwen3":
        assert tcfg.q_heads_per_kv == 8
    jp = jax_moe.moe_init(jax.random.PRNGKey(3), jcfg, jnp.bfloat16)
    tp = tree_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                      jp), dtype=torch.bfloat16,
                         device="cpu")
    x = np.random.default_rng(4).standard_normal((4, 24, jcfg.d_model),
                                                 np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)

    y, aux = jax_moe.moe(jp, jx, jcfg)
    ty, taux = moe_lib.moe(tp, tx, tcfg)
    y = np.asarray(y, np.float32)
    assert ty.shape == y.shape and ty.dtype == torch.bfloat16
    torch.testing.assert_close(ty.float(), torch.from_numpy(y), atol=TOL,
                               rtol=TOL)
    assert np.array_equal(taux["expert_load"].numpy(),
                          np.asarray(aux["expert_load"], np.float32))
    assert float(taux["moe_aux_loss"]) == pytest.approx(
        float(aux["moe_aux_loss"]), rel=1e-5)

    # per-token top-k ids, near-ties aside
    k = jcfg.moe.top_k
    xn = jax_rmsnorm(jp["norm"], jx, jcfg.norm_eps).reshape(-1, jcfg.d_model)
    jlogits = jnp.einsum("td,de->te", xn, jp["wr"].astype(jnp.bfloat16))
    jlogits = np.asarray(jlogits.astype(jnp.float32))
    _, jidx = jax.lax.top_k(jnp.asarray(jlogits), k)
    txn = rmsnorm(tp["norm"], tx, tcfg.norm_eps).reshape(-1, tcfg.d_model)
    _, _, tidx = moe_lib._route(tp, txn, k)
    ties = _near_ties(jlogits, k)
    differ = np.any(tidx.numpy() != np.asarray(jidx), axis=-1)
    assert not np.any(differ & ~ties)
    assert ties.mean() <= 0.05


def test_route_breaks_ties_toward_the_lower_index():
    """Equal router logits: the lower expert index comes first, as
    ``jax.lax.top_k`` orders them."""
    cfg = get_reduced("qwen3-moe-30b-a3b")
    e, d = cfg.moe.num_experts, cfg.d_model
    wr = torch.zeros((d, e), dtype=torch.bfloat16)
    wr[:, 1] = wr[:, 3] = 0.5
    xn = torch.ones((5, d), dtype=torch.bfloat16)
    logits, w, idx = moe_lib._route({"wr": wr}, xn, 2)
    _, jidx = jax.lax.top_k(jnp.asarray(logits.numpy()), 2)
    assert idx.tolist() == [[1, 3]] * 5 == np.asarray(jidx).tolist()
    assert torch.allclose(w, torch.full((5, 2), 0.5))


# ---- the reference tests' properties (tests/test_moe.py) on the port ----

@pytest.fixture
def cfg():
    return _with_capacity(get_reduced("qwen3-moe-30b-a3b"), 64.0)


def _params(cfg, seed=0):
    return moe_lib.moe_init(torch.Generator().manual_seed(seed), cfg,
                            torch.float32, "cpu")


def _x(cfg, b, s, seed=1):
    """bf16 hidden states, as the model feeds every block."""
    x = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model),
                                                    np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


def _dense_loop(params, x, cfg):
    """Per-token loop over its top-k experts (no capacity), fp64."""
    m = cfg.moe
    d = x.shape[-1]
    xn = rmsnorm(params["norm"], x, cfg.norm_eps).reshape(-1, d).double()
    logits = xn @ params["wr"].double()
    w, idx = torch.topk(logits, m.top_k, dim=-1)
    w = torch.softmax(w, dim=-1)
    out = torch.zeros_like(xn)
    for t in range(xn.shape[0]):
        for j in range(m.top_k):
            e = int(idx[t, j])
            gate = xn[t] @ params["wg"][e].double()
            up = xn[t] @ params["wu"][e].double()
            h = torch.nn.functional.silu(gate) * up
            out[t] += w[t, j] * (h @ params["wd"][e].double())
    return out.reshape(x.shape).float()


def test_moe_matches_dense_loop(cfg):
    params = _params(cfg)
    x = _x(cfg, 2, 6)
    y, _ = moe_lib.moe(params, x, cfg)
    assert torch.allclose(y.float(), _dense_loop(params, x, cfg), atol=0.05,
                          rtol=0.05)


def test_expert_load_sums_to_tk(cfg):
    _, aux = moe_lib.moe(_params(cfg), _x(cfg, 2, 8), cfg)
    assert float(aux["expert_load"].sum()) == 2 * 8 * cfg.moe.top_k


def test_capacity_drops_tokens(cfg):
    tight = _with_capacity(cfg, 0.05)
    params = _params(tight)
    x = _x(tight, 4, 16)
    assert moe_lib._capacity(64, tight.moe) < 64 * tight.moe.top_k // 4
    y_tight, _ = moe_lib.moe(params, x, tight)
    y_loose, _ = moe_lib.moe(params, x, cfg)
    assert not torch.allclose(y_tight.float(), y_loose.float(), atol=1e-4)


def test_aux_loss_prefers_balance(cfg):
    """Uniform router logits => aux loss ~ 1 (its minimum for top-1 share)."""
    params = dict(_params(cfg))
    params["wr"] = torch.zeros_like(params["wr"])
    _, aux = moe_lib.moe(params, _x(cfg, 2, 32), cfg)
    assert float(aux["moe_aux_loss"]) == pytest.approx(1.0, abs=0.05)


def test_dense_residual_arctic():
    arctic = _with_capacity(get_reduced("arctic-480b"), 64.0)
    params = _params(arctic)
    assert {"du", "dg", "dd"} <= set(params)
    x = _x(arctic, 1, 4)
    y, _ = moe_lib.moe(params, x, arctic)
    y2, _ = moe_lib.moe(dict(params, dd=torch.zeros_like(params["dd"])), x,
                        arctic)
    assert not torch.allclose(y.float(), y2.float(), atol=1e-5)
