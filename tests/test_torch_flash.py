"""The port's flash attention (K3), plain version, against the JAX package's
Pallas kernel (interpret mode on the CPU, as tests/test_kernels_flash.py
runs it) and its pure-jnp oracle ``flash_attention_ref``, on the same
numpy inputs.

Shapes are those of tests/test_kernels_flash.py (MHA, GQA, MQA, a ragged
length, hd 96) plus offset caches (T > S, the diagonal shifted by T - S).
Tolerances are the repo's kernel bounds: 2e-5 in fp32, 2e-2 in bf16 (atol
and rtol).  The CUDA kernel itself is held against this plain version on
the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as jax_flash)
from repro.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

SHAPES = [
    # (b, s, h, kh, hd), as tests/test_kernels_flash.py:11-18
    (1, 64, 2, 2, 32),     # MHA
    (2, 128, 4, 2, 64),    # GQA g=2
    (1, 256, 8, 1, 64),    # MQA
    (2, 96, 4, 4, 128),    # non-block-multiple seq
    (1, 128, 8, 2, 96),    # hd not a lane multiple
]


def _inputs(b, s, t, h, kh, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    jd, td, _ = DTYPES[dtype]
    arrs = [rng.standard_normal(shape, np.float32)
            for shape in ((b, s, h, hd), (b, t, kh, hd), (b, t, kh, hd))]
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _close(port, ref, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_and_ref(shape, dtype, causal):
    b, s, h, kh, hd = shape
    (jq, jk, jv), (tq, tk, tv) = _inputs(b, s, s, h, kh, hd, dtype,
                                         seed=s * h + hd)
    port = fops.flash_attention(tq, tk, tv, causal=causal)
    assert port.dtype == tq.dtype and port.shape == tq.shape
    _close(port, jax_flash(jq, jk, jv, causal=causal, blk_q=64, blk_k=64,
                           interpret=True), dtype)
    _close(port, flash_attention_ref(jq, jk, jv, causal=causal), dtype)


@pytest.mark.parametrize("s,t", [(64, 101), (96, 96 + 37), (1, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_offset_cache_diagonal(s, t, dtype):
    """T > S: the causal diagonal shifts by T - S (ref.py:22); the Pallas
    wrapper pads both lengths and masks the padded keys."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, s, t, 6, 2, 32, dtype, seed=t)
    port = fops.flash_attention(tq, tk, tv)
    _close(port, flash_attention_ref(jq, jk, jv), dtype)
    _close(port, jax_flash(jq, jk, jv, blk_q=32, blk_k=32, interpret=True),
           dtype)


def test_first_token_attends_only_itself():
    """Causal with T = S: row 0 equals v[0] (softmax over one key)."""
    _, (q, k, v) = _inputs(1, 64, 64, 2, 2, 32, "float32", seed=1)
    out = fops.flash_attention(q, k, v)
    np.testing.assert_allclose(out[:, 0].numpy(), v[:, 0].numpy(), atol=1e-6)


def test_wrapper_raises_on_grad_and_short_keys():
    _, (q, k, v) = _inputs(1, 128, 128, 4, 2, 32, "float32", seed=2)
    with pytest.raises(RuntimeError, match="no gradient"):
        fops.flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        fops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="T >= S"):
        fops.flash_attention(q.detach(), k[:, :100], v[:, :100])
    before = (fops.flash_attention.launches,
              fops.flash_attention.launches_f32)
    fops.flash_attention(q.detach(), k, v)
    assert (fops.flash_attention.launches,
            fops.flash_attention.launches_f32) == before   # no kernel here


# --- the fp32 kernel's split plan (csrc/flash_attention_f32.cuh) ----------
# (b, s, t, kh, g, hd): bench_kernels.py's shape, the loss's, S*G one short
# of, at and one past a 64-row block, one row block over key ranges one
# short of, at and one past a 64-key chunk and two, one query over an
# offset cache, and G 1..8 over a ragged offset cache
SPLIT_SHAPES = {
    "bench": (1, 512, 512, 2, 4, 64),
    "loss": (2, 2048, 2048, 8, 3, 128),
    "rows-1": (1, 63, 63, 2, 1, 64),
    "rows": (1, 64, 64, 2, 1, 64),
    "rows+1": (1, 65, 65, 2, 1, 64),
    **{f"keys{t}": (1, 16, t, 2, 4, 64) for t in (63, 64, 65, 127, 128, 129)},
    "s1": (2, 1, 38, 2, 4, 64),
    **{f"g{g}": (1, 100, 137, 2, g, 32) for g in range(1, 9)},
}
SMS = 132          # an H100's SMs


def _visible(s, t, g, causal):
    """(S*G, T) bool: key t visible to flattened row r = s * G + g."""
    rows = np.arange(s * g)[:, None]
    keys = np.arange(t)[None, :]
    return keys <= rows // g + (t - s) if causal else np.ones((s * g, t),
                                                             bool)


def _row_keys(s, t, g, causal):
    """Keys [0, n) each F32_ROWS row block must walk, read off the mask:
    one past the last key any of its rows sees."""
    vis, n = _visible(s, t, g, causal), fops.F32_ROWS
    return [int(np.nonzero(vis[r:r + n].any(0))[0].max()) + 1
            for r in range(0, s * g, n)]


def _tasks(plan, s, t, g, causal):
    """(row block, chunk, first key, end key) of each task of one (batch,
    KV head), in the order csrc/flash_attention_f32.cuh maps its block
    index to them: row blocks last first, then ``plan.chunks`` slots, a
    slot past its row block's keys exiting at once."""
    row_keys = _row_keys(s, t, g, causal)
    for rb in reversed(range(len(row_keys))):
        n = row_keys[rb]
        for c in range(plan.chunks):
            if c * plan.chunk < n:
                yield rb, c, c * plan.chunk, min(n, (c + 1) * plan.chunk)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", list(SPLIT_SHAPES))
def test_split_plan_covers_each_visible_pair_once(name, causal):
    b, s, t, kh, g, hd = SPLIT_SHAPES[name]
    plan = fops.split_plan(b, s, t, kh, g, hd, causal, SMS)
    rows, n, n_rb = s * g, fops.F32_ROWS, -(-s * g // fops.F32_ROWS)
    row_keys = _row_keys(s, t, g, causal)
    assert plan.chunk * plan.chunks >= max(row_keys)
    assert plan.chunk * (plan.chunks - 1) < max(row_keys)   # no idle slot
    seen = np.zeros((rows, t), np.int32)
    tasks = list(_tasks(plan, s, t, g, causal))
    for rb, c, lo, hi in tasks:
        assert 0 <= c < plan.chunks and 0 <= lo < hi <= t
        assert hi - lo <= plan.chunk
        seen[rb * n:(rb + 1) * n, lo:hi] += 1
    vis = _visible(s, t, g, causal)
    assert (seen[vis] == 1).all() and seen.max() == 1
    order = [rb for rb, _, _, _ in tasks]
    assert order == sorted(order, reverse=True)          # longest first
    assert plan.scratch == (b * kh * n_rb * plan.chunks * n * (hd + 2)
                            if plan.chunks > 1 else 0)

    def n_tasks(chunk):
        return b * kh * sum(-(-m // chunk) for m in row_keys)
    assert n_tasks(plan.chunk) == b * kh * len(tasks)
    if b * kh * n_rb >= 2 * SMS:        # the row blocks fill the card
        assert plan.chunks == 1
    else:                               # the longest chunk that fills it
        assert n_tasks(plan.chunk) >= 2 * SMS or \
            plan.chunk == fops.F32_MIN_CHUNK
        assert 2 * plan.chunk >= max(row_keys) or \
            n_tasks(2 * plan.chunk) < 2 * SMS
    if name == "bench" and causal:
        assert (plan.chunk, plan.chunks, n_tasks(plan.chunk)) == (64, 8, 288)
        assert plan.scratch == 2 * 32 * 8 * 64 * 66
    if name == "loss":
        assert (plan.chunks, plan.scratch, n_tasks(plan.chunk)) == \
            (1, 0, 1536)
    if name.startswith("keys") and causal:
        assert plan.chunk == 64 and plan.chunks == -(-t // 64)


def _emulate_split(q, k, v, causal, plan):
    """The fp32 kernel's arithmetic in torch, task by task as ``plan`` cuts
    it: each chunk's partial (m, l, acc) over its keys with the -1e30 fill,
    then each row block's partials merged as the merge kernel does
    (w_c = exp(m_c - max m), out = sum w_c acc_c / max(sum w_c l_c,
    1e-30)); a row block of one chunk is its own acc / max(l, 1e-30)."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    rows, n = s * g, fops.F32_ROWS
    qf = q.reshape(b, s, kh, g, hd).permute(0, 2, 1, 3, 4).reshape(
        b, kh, rows, hd)
    kf, vf = (x.permute(0, 2, 1, 3) for x in (k, v))
    parts = {}
    for rb, _, lo, hi in _tasks(plan, s, t, g, causal):
        r = torch.arange(rb * n, min(rows, rb * n + n))
        sc = qf[:, :, r] @ kf[:, :, lo:hi].transpose(-1, -2) / math.sqrt(hd)
        if causal:
            lim = r // g + (t - s)
            sc = sc.masked_fill(torch.arange(lo, hi)[None, :] > lim[:, None],
                                -1e30)
        m = sc.amax(-1)
        p = torch.exp(sc - m[..., None])
        parts.setdefault(rb, []).append((m, p.sum(-1), p @ vf[:, :, lo:hi]))
    out = torch.empty(b, kh, rows, hd)
    for rb, ps in parts.items():
        mx = torch.stack([m for m, _, _ in ps]).amax(0)
        w = [torch.exp(m - mx) for m, _, _ in ps]
        den = sum(wc * l for wc, (_, l, _) in zip(w, ps)).clamp_min(1e-30)
        out[:, :, rb * n:rb * n + n] = sum(
            wc[..., None] * acc for wc, (_, _, acc) in zip(w, ps)) / \
            den[..., None]
    return out.reshape(b, kh, s, g, hd).permute(0, 2, 1, 3, 4).reshape(
        b, s, h, hd)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape,chunks", [
    ((1, 512, 512, 8, 2, 64), 8),    # bench_kernels.py's shape
    ((2, 100, 137, 6, 2, 32), 3),    # ragged, offset cache
    ((1, 16, 129, 8, 2, 64), 3),     # one row block, one key past 2 chunks
    ((1, 65, 65, 2, 2, 128), 2),     # one row past a row block
    ((2, 1, 38, 6, 2, 96), 1),       # one query over an offset cache
])
def test_chunked_partials_match_pallas(shape, chunks, causal):
    """The split's partials and their merge, driven by the plan, against
    the Pallas kernel in interpret mode at 2e-5 in fp32."""
    b, s, t, h, kh, hd = shape
    (jq, jk, jv), (tq, tk, tv) = _inputs(b, s, t, h, kh, hd, "float32",
                                         seed=s + t + hd)
    plan = fops.split_plan(b, s, t, kh, h // kh, hd, causal, SMS)
    assert plan.chunks == chunks
    got = _emulate_split(tq, tk, tv, causal, plan)
    _close(got, jax_flash(jq, jk, jv, causal=causal, blk_q=64, blk_k=64,
                          interpret=True), "float32")
    _close(got, fops.flash_attention_plain(tq, tk, tv, causal=causal)
           .numpy(), "float32")
