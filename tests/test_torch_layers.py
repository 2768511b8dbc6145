"""The port's layers against ``repro.models.layers`` on the same numpy
inputs and weights.

Both sides compute in bf16 (``COMPUTE_DTYPE``) and the two frameworks round
bf16 at different places, so outputs and caches are held to 2e-2, scaled by
max|ref| where that is above 1.  RoPE tables are fp32 on both sides.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

torch.set_num_threads(1)

# the reduced phi4-mini (G = 2) and the full model's group G = 3
HEADS = {"g2": {}, "g3": dict(num_heads=6, num_kv_heads=2)}


def _close(port, ref, bound=2e-2):
    ref = np.asarray(ref, np.float32)
    port = port.float().numpy()
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(port - ref).max()) <= bound * scale


def _params(tree):
    """numpy fp32 tree -> (jax bf16 tree, torch bf16 tree)."""
    if isinstance(tree, dict):
        pairs = {k: _params(v) for k, v in tree.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    return (jnp.asarray(tree).astype(jnp.bfloat16),
            torch.from_numpy(tree).to(torch.bfloat16))


def _attn_params(rng, cfg):
    d, h, k, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                   cfg.resolved_head_dim)
    return _params({
        "norm": {"scale": 1 + 0.1 * rng.standard_normal(d, np.float32)},
        "wq": rng.standard_normal((d, h, hd), np.float32) * d ** -0.5,
        "wk": rng.standard_normal((d, k, hd), np.float32) * d ** -0.5,
        "wv": rng.standard_normal((d, k, hd), np.float32) * d ** -0.5,
        "wo": rng.standard_normal((h, hd, d), np.float32) * (h * hd) ** -0.5,
    })


def _x(rng, *shape):
    a = rng.standard_normal(shape, np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(
        torch.bfloat16)


def _cfgs(heads):
    return (jax_reduced("phi4-mini-3.8b", **HEADS[heads]),
            get_reduced("phi4-mini-3.8b", **HEADS[heads]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64), np.float32) * 3
    s = 1 + 0.1 * rng.standard_normal(64, np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = JL.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x).astype(jd))
    out = TL.rmsnorm({"scale": torch.from_numpy(s)},
                     torch.from_numpy(x).to(td))
    assert out.dtype == td
    _close(out, ref, 1e-6 if dtype == "float32" else 2e-2)


def test_rope_table_and_apply():
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 200, (3, 7)).astype(np.int32)
    jc, js = JL.rope_table(jnp.asarray(pos), 32, 10_000.0)
    tc, ts = TL.rope_table(torch.from_numpy(pos), 32, 10_000.0)
    assert tc.dtype == torch.float32 and tc.shape == (3, 7, 16)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    jx, tx = _x(rng, 3, 7, 4, 32)
    _close(TL.apply_rope(tx, tc, ts), JL.apply_rope(jx, jc, js))
    # the (S, half) table form broadcasts over the batch
    jc1, js1 = JL.rope_table(jnp.arange(7), 32, 10_000.0)
    tc1, ts1 = TL.rope_table(torch.arange(7), 32, 10_000.0)
    _close(TL.apply_rope(tx, tc1, ts1), JL.apply_rope(jx, jc1, js1))


@pytest.mark.parametrize("activation", ["swiglu", "squared_relu", "gelu"])
def test_mlp(activation):
    import dataclasses
    jcfg, tcfg = (dataclasses.replace(c, activation=activation)
                  for c in _cfgs("g2"))
    rng = np.random.default_rng(3)
    d, f = tcfg.d_model, tcfg.d_ff
    tree = {"norm": {"scale": 1 + 0.1 * rng.standard_normal(d, np.float32)},
            "wu": rng.standard_normal((d, f), np.float32) * d ** -0.5,
            "wd": rng.standard_normal((f, d), np.float32) * f ** -0.5}
    if activation == "swiglu":
        tree["wg"] = rng.standard_normal((d, f), np.float32) * d ** -0.5
    jp, tp = _params(tree)
    jx, tx = _x(rng, 2, 9, d)
    _close(TL.mlp(tp, tx, tcfg), JL.mlp(jp, jx, jcfg))


@pytest.mark.parametrize("heads", sorted(HEADS))
def test_attention_causal_prefill(heads):
    """No cache, and the prefill form: a cache written at index 0."""
    jcfg, tcfg = _cfgs(heads)
    rng = np.random.default_rng(4)
    jp, tp = _attn_params(rng, tcfg)
    jx, tx = _x(rng, 2, 24, tcfg.d_model)
    ref, _ = JL.attention(jp, jx, jcfg)
    out, none = TL.attention(tp, tx, tcfg)
    assert none is None
    _close(out, ref)
    kh, hd = tcfg.num_kv_heads, tcfg.resolved_head_dim
    jc = {n: jnp.zeros((2, 40, kh, hd), jnp.bfloat16) for n in "kv"}
    tc = {n: torch.zeros((2, 40, kh, hd), dtype=torch.bfloat16) for n in "kv"}
    ref, jc = JL.attention(jp, jx, jcfg, positions=jnp.arange(24),
                           kv_cache=jc, write_index=0)
    out, tc = TL.attention(tp, tx, tcfg, positions=torch.arange(24),
                           kv_cache=tc, write_index=0)
    _close(out, ref)
    for n in "kv":
        _close(tc[n], jc[n])


def _decode_case(rng, cfg, b=3, t=40):
    kh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    cache = {n: rng.standard_normal((b, t, kh, hd), np.float32) for n in "kv"}
    jc = {n: jnp.asarray(a).astype(jnp.bfloat16) for n, a in cache.items()}
    tc = {n: torch.from_numpy(a).to(torch.bfloat16) for n, a in cache.items()}
    return jc, tc


@pytest.mark.parametrize("impl", ["sdpa", "pallas"])
@pytest.mark.parametrize("heads", sorted(HEADS))
def test_attention_decode_scalar_index(heads, impl):
    jcfg, tcfg = _cfgs(heads)
    rng = np.random.default_rng(5)
    jp, tp = _attn_params(rng, tcfg)
    jc, tc = _decode_case(rng, tcfg)
    jx, tx = _x(rng, 3, 1, tcfg.d_model)
    cur = 17
    ref, jc = JL.attention(jp, jx, jcfg, positions=jnp.full((3, 1), cur),
                           kv_cache=jc, write_index=cur, decode_impl=impl)
    out, tc = TL.attention(tp, tx, tcfg, positions=torch.full((3, 1), cur),
                           kv_cache=tc, write_index=cur, decode_impl=impl)
    _close(out, ref)
    for n in "kv":
        _close(tc[n], jc[n])


@pytest.mark.parametrize("impl", ["sdpa", "pallas"])
@pytest.mark.parametrize("heads", sorted(HEADS))
def test_attention_decode_vector_index(heads, impl):
    """Ragged continuous batching: one write per row at its own position,
    row 0 at position 0 (an inactive slot)."""
    jcfg, tcfg = _cfgs(heads)
    rng = np.random.default_rng(6)
    jp, tp = _attn_params(rng, tcfg)
    jc, tc = _decode_case(rng, tcfg)
    jx, tx = _x(rng, 3, 1, tcfg.d_model)
    cur = np.array([0, 9, 39], np.int32)
    ref, jc = JL.attention(jp, jx, jcfg, positions=jnp.asarray(cur)[:, None],
                           kv_cache=jc, write_index=jnp.asarray(cur),
                           decode_impl=impl)
    tcur = torch.from_numpy(cur)
    out, tc = TL.attention(tp, tx, tcfg, positions=tcur[:, None],
                           kv_cache=tc, write_index=tcur, decode_impl=impl)
    _close(out, ref)
    for n in "kv":
        _close(tc[n], jc[n])


@pytest.mark.parametrize("impl", ["paged_sdpa", "paged"])
@pytest.mark.parametrize("heads", sorted(HEADS))
def test_attention_paged_decode(heads, impl):
    """Writes land at pool[table[b, pos // 16], pos % 16]; the inactive row
    (position 0, all-trash table row) writes into page 0."""
    jcfg, tcfg = _cfgs(heads)
    rng = np.random.default_rng(7)
    jp, tp = _attn_params(rng, tcfg)
    kh, hd = tcfg.num_kv_heads, tcfg.resolved_head_dim
    pool = {n: rng.standard_normal((9, 16, kh, hd), np.float32) for n in "kv"}
    jc = {n: jnp.asarray(a).astype(jnp.bfloat16) for n, a in pool.items()}
    tc = {n: torch.from_numpy(a).to(torch.bfloat16) for n, a in pool.items()}
    table = np.array([[0, 0, 0, 0], [3, 7, 0, 0], [1, 2, 5, 8]], np.int32)
    cur = np.array([0, 20, 49], np.int32)
    jx, tx = _x(rng, 3, 1, tcfg.d_model)
    ref, jc = JL.attention(jp, jx, jcfg, positions=jnp.asarray(cur)[:, None],
                           kv_cache=jc, decode_impl=impl,
                           page_table=jnp.asarray(table))
    out, tc = TL.attention(tp, tx, tcfg,
                           positions=torch.from_numpy(cur)[:, None],
                           kv_cache=tc, decode_impl=impl,
                           page_table=torch.from_numpy(table))
    _close(out, ref)
    for n in "kv":
        _close(tc[n], jc[n])


def _prompt_case(rng, cfg, width, start, s=11, t=40):
    """fp32 attention weights, ``width`` rows of ``s`` new tokens, and a
    cache of ``t`` positions holding random K/V (a donor's) below
    ``start``."""
    d, kh, hd = cfg.d_model, cfg.num_kv_heads, cfg.resolved_head_dim
    params = _attn_params(rng, cfg)[1]
    params = {k: ({"scale": v["scale"].float()} if isinstance(v, dict)
                  else v.float()) for k, v in params.items()}
    x = torch.from_numpy(rng.standard_normal((width, s, d), np.float32))
    cache = {n: torch.zeros((width, t, kh, hd)) for n in "kv"}
    for n in "kv":
        cache[n][:, :start] = torch.from_numpy(
            rng.standard_normal((width, start, kh, hd), np.float32))
    return params, x, cache, torch.arange(s) + start


@pytest.mark.parametrize("start", [0, 17])
@pytest.mark.parametrize("width", [1, 3])
def test_prompt_pass_live_keys_match_masked_cache(width, start, monkeypatch):
    """The cached multi-token branch's flash path, forced (on the CPU the
    wrapper runs ``flash_attention_plain``): over the live keys ``[0,
    start + S)`` alone, with the diagonal shifted by ``start``, it gives
    ``_sdpa_chunked``'s attention over the whole masked cache, in fp32
    within 1e-5, and writes the cache alike."""
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
    cfg = _cfgs("g3")[1]
    params, x, cache, pos = _prompt_case(np.random.default_rng(8), cfg,
                                         width, start)
    plain = {n: c.clone() for n, c in cache.items()}
    want, plain = TL.attention(params, x, cfg, positions=pos,
                               kv_cache=plain, write_index=start)
    seen, kernel = [], TL.flash_attention

    def flash(q, k, v, *, causal):
        seen.append((tuple(k.shape), k.is_contiguous(), causal))
        return kernel(q, k, v, causal=causal)
    monkeypatch.setattr(TL, "_prompt_on_flash", lambda *a: True)
    monkeypatch.setattr(TL, "flash_attention", flash)
    got, cache = TL.attention(params, x, cfg, positions=pos, kv_cache=cache,
                              write_index=start)
    kh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    assert seen == [((width, start + x.shape[1], kh, hd), True, True)]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    for n in "kv":
        assert torch.equal(cache[n], plain[n])


def test_prompt_pass_on_the_cpu_takes_the_plain_path(monkeypatch):
    """A CPU call of the cached multi-token branch runs ``_sdpa_chunked``
    over the whole cache, as before: no flash call, nothing counted as a
    fallback (the count is of calls on a card)."""
    cfg = _cfgs("g3")[1]
    rng = np.random.default_rng(9)
    tp = _attn_params(rng, cfg)[1]
    tx = _x(rng, 2, 11, cfg.d_model)[1]
    kh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    cache = {n: torch.zeros((2, 40, kh, hd), dtype=torch.bfloat16)
             for n in "kv"}
    keys, sdpa_chunked = [], TL._sdpa_chunked

    def sdpa(q, k, *a, **kw):
        keys.append(k.shape[1])
        return sdpa_chunked(q, k, *a, **kw)

    def flash(*a, **kw):
        raise AssertionError("the flash kernel ran on the CPU")
    monkeypatch.setattr(TL, "_sdpa_chunked", sdpa)
    monkeypatch.setattr(TL, "flash_attention", flash)
    before = TL.attention.plain_prompt_calls
    TL.attention(tp, tx, cfg, positions=torch.arange(11) + 5,
                 kv_cache=cache, write_index=5)
    assert keys == [40]
    assert TL.attention.plain_prompt_calls == before
    assert not TL._prompt_on_flash(tx, tx, cache["k"], 5, 11)
