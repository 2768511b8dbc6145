"""The split plan of the dense decode kernel (K1) and a plain mirror of its
partition-and-combine, on the CPU.

The kernel (``csrc/decode_attention.cu`` over ``csrc/decode_split.cuh``)
cuts each slot's keys into chunks of ``split_plan(...).chunk`` keys,
attends each chunk in its own thread block as an online softmax over
64-row tiles, and combines the chunks' partial softmax states (m, l, acc)
in chunk order.  A CUDA kernel cannot run here, so this file holds the
arithmetic it relies on: ``split_plan`` (the function the wrapper calls to
size the grid and the scratch), and a plain PyTorch mirror of the tiles,
the chunks and the combine, held to ``decode_attention_plain`` and to the
JAX package's ``decode_attention`` (the Pallas kernel in interpret mode,
as tests/test_torch_kernels.py runs it).  The mirror lives here: the port
never calls it.

Tolerances are the repo's kernel bounds: 2e-5 in fp32, 2e-2 in bf16 (atol
and rtol).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention as jax_decode)
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
TILE = 64           # rows of a shared-memory tile (kTileKeys in the kernel)


def dense_split_mirror(q, k, v, lengths, chunk=None):
    """The kernel's arithmetic in plain PyTorch: lengths clamped to [0, T];
    each chunk of ``chunk`` keys (the plan's by default) an online softmax
    over its 64-row tiles, from m = -1e30, l = 0, acc = 0, keys past the
    length left out; then the chunks combined one after another in chunk
    order, out = acc / max(l, 1e-30)."""
    b, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    chunk = chunk or dops.split_plan(b, t, kh, g, hd).chunk
    splits = -(-t // chunk)
    lengths = lengths.clamp(0, t).to(torch.long)
    scores = torch.einsum("bkgh,btkh->bkgt", q.float().reshape(b, kh, g, hd),
                          k.float()) / math.sqrt(hd)
    vf = v.float()
    keys = torch.arange(t)
    parts = []
    for j in range(splits):
        m = torch.full((b, kh, g), -1e30)
        l = torch.zeros((b, kh, g))
        acc = torch.zeros((b, kh, g, hd))
        for lo in range(j * chunk, min((j + 1) * chunk, t), TILE):
            hi = min(lo + TILE, (j + 1) * chunk, t)
            valid = (keys[lo:hi][None, :] < lengths[:, None])[:, None, None, :]
            s = scores[..., lo:hi].masked_fill(~valid, -1e30)
            mn = torch.maximum(m, s.max(-1).values)
            p = torch.exp(s - mn[..., None]) * valid
            alpha = torch.exp(m - mn)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgt,btkh->bkgh", p, vf[:, lo:hi])
            m = mn
        parts.append((m, l, acc))
    mx = torch.stack([m for m, _, _ in parts]).max(0).values
    den = torch.zeros_like(mx)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:                          # in chunk order
        wgt = torch.exp(m - mx)
        den = den + l * wgt
        acc = acc + a * wgt[..., None]
    out = acc / den.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, hd).to(q.dtype)


def _inputs(b, t, kh, g, hd, lengths, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kh * g, hd), np.float32)
    k = rng.standard_normal((b, t, kh, hd), np.float32)
    v = rng.standard_normal((b, t, kh, hd), np.float32)
    jd, td, _ = DTYPES[dtype]
    lens = np.array(lengths, np.int32)
    return ([jnp.asarray(a).astype(jd) for a in (q, k, v)]
            + [jnp.asarray(np.minimum(lens, t))],
            [torch.from_numpy(a).to(td) for a in (q, k, v)]
            + [torch.from_numpy(lens)])


def _close(port, ref, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def test_dense_split_plan_at_phi3_vision_shape():
    """4 slots, T = 1664, 32 KV heads of G = 1, hd 96 (Phi-3-vision): 13
    splits of 128 keys; 1,664 blocks, 1,472 of them with keys at the
    lengths of 576 patches plus 577-1041 tokens."""
    plan = dops.split_plan(4, 1664, 32, 1, 96)
    assert (plan.chunk, plan.splits) == (128, 13)
    assert plan.partial_shape == (4, 32, 13, 96 + 2)
    assert plan.counters == 128
    with_keys = sum(-(-n // plan.chunk) for n in (1617, 1489, 1336, 1153))
    assert with_keys * 32 == 1472
    assert 96 in dops.HEAD_DIMS


def test_dense_split_plan_at_the_main_shape():
    """4 slots, T = 1088, 8 KV heads of G = 3, hd 128: 128-key splits, 9
    per slot; 288 blocks, 224 of them with keys at the decode step's
    lengths."""
    plan = dops.split_plan(4, 1088, 8, 3, 128)
    assert (plan.chunk, plan.splits) == (128, 9)
    assert plan.partial_shape == (4, 8, 9, 3 * (128 + 2))
    assert plan.counters == 32
    assert plan.splits * 8 * 4 == 288
    with_keys = sum(-(-n // plan.chunk) for n in (1041, 913, 760, 577))
    assert with_keys * 8 == 224


@pytest.mark.parametrize("t", [1, 63, 64, 127, 128, 129, 1000, 1088, 4097])
def test_dense_split_plan_covers_the_cache_in_whole_chunks(t):
    plan = dops.split_plan(2, t, 2, 4, 64)
    assert plan.chunk == dops.SPLIT_KEYS and plan.chunk % TILE == 0
    assert plan.splits == -(-t // plan.chunk)
    assert (plan.splits - 1) * plan.chunk < t <= plan.splits * plan.chunk
    assert plan.partial_shape == (2, 2, plan.splits, 4 * 66)
    assert plan.counters == 4


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("g", [1, 3, 4, 8])
def test_dense_mirror_matches_plain_and_pallas(g, dtype):
    """T = 2 chunks + 37 keys (not a multiple of a chunk or a tile);
    lengths 0 and 1, one short of, at and one past a tile and a chunk, the
    full cache and past it (clamped: the JAX wrapper is given the clamped
    lengths, the port the raw ones)."""
    b, kh, hd = 11, 2, 32
    chunk = dops.split_plan(b, 1, kh, g, hd).chunk
    t = 2 * chunk + 37
    lengths = [0, 1, TILE - 1, TILE, TILE + 1, chunk - 1, chunk, chunk + 1,
               2 * chunk + 1, t, t + 9]
    jax_args, args = _inputs(b, t, kh, g, hd, lengths, dtype, seed=40 + g)
    mirror = dense_split_mirror(*args)
    plain = dops.decode_attention_plain(*args)
    _close(mirror, plain.float().numpy(), dtype)
    _close(mirror, jax_decode(*jax_args), dtype)
    _close(plain, jax_decode(*jax_args), dtype)
    assert torch.all(mirror[0] == 0) and torch.isfinite(mirror).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("g", [1, 3])
def test_dense_mirror_matches_plain_and_pallas_at_hd96(g, dtype):
    """hd = 96 (Phi-3-vision's), which does not divide the kernel's 256
    column pairs: the same lengths as above, G 1 and 3."""
    b, kh, hd = 11, 2, 96
    chunk = dops.split_plan(b, 1, kh, g, hd).chunk
    t = 2 * chunk + 37
    lengths = [0, 1, TILE - 1, TILE, TILE + 1, chunk - 1, chunk, chunk + 1,
               2 * chunk + 1, t, t + 9]
    jax_args, args = _inputs(b, t, kh, g, hd, lengths, dtype, seed=90 + g)
    mirror = dense_split_mirror(*args)
    _close(mirror, dops.decode_attention_plain(*args).float().numpy(), dtype)
    _close(mirror, jax_decode(*jax_args), dtype)
    assert torch.all(mirror[0] == 0) and torch.isfinite(mirror).all()


def pv_owners(hd, threads=128):
    """The kernel's P V mapping (csrc/decode_split.cuh, split_attend): the
    thread that accumulates each (key of a 64-row tile, column pair), and
    the key groups the reduction sums.  Thread tid holds column pair tid %
    (hd / 2) in key group tid // (hd / 2), keys kg, kg + KG, ...; a thread
    with kg >= KG = 2 * threads // hd (rounded down) holds none."""
    kg_count = 2 * threads // hd
    owners = {}
    for tid in range(threads):
        dp, kg = tid % (hd // 2), tid // (hd // 2)
        if kg >= kg_count:
            continue
        for key in range(kg, TILE, kg_count):
            owners.setdefault((key, dp), []).append(tid)
    return owners, kg_count


@pytest.mark.parametrize("hd", dops.HEAD_DIMS)
def test_pv_mapping_covers_each_key_and_column_once(hd):
    """Every (key, column pair) of a tile is accumulated by exactly one
    thread for every head_dim the kernels are built for, hd = 96 included
    (2 key groups of 48 threads; 32 threads idle), and the reduction's
    buffer of KG rows of G * hd floats fits the shared memory of one
    stage (the static_assert of SplitLayout)."""
    owners, kg_count = pv_owners(hd)
    assert kg_count >= 1
    assert set(owners) == {(k, dp) for k in range(TILE)
                           for dp in range(hd // 2)}
    assert all(len(t) == 1 for t in owners.values())
    for dtype_bytes, vec in ((4, 4), (2, 8)):
        assert hd % vec == 0                          # 16-byte row pieces
        stage = 2 * TILE * (hd + 32 // dtype_bytes) * dtype_bytes
        assert kg_count * dops.MAX_GROUP * hd * 4 <= stage


@pytest.mark.parametrize("chunk", [64, 256])
def test_dense_mirror_matches_plain_at_other_split_sizes(chunk):
    """The A/B script's other split sizes: 64 keys (one tile a split) and
    256 (four tiles through the ring)."""
    b, t, kh, g, hd = 6, 600, 2, 3, 64
    lengths = [0, chunk - 1, chunk + 1, 3 * chunk, t, t + 1]
    _, args = _inputs(b, t, kh, g, hd, lengths, "float32", seed=chunk)
    _close(dense_split_mirror(*args, chunk=chunk),
           dops.decode_attention_plain(*args).float().numpy(), "float32")


def test_combine_counters_are_shared_by_the_dense_and_paged_kernels():
    """One zeroed buffer per device serves both split kernels, which leave
    it at zero after every launch; it grows only when a launch needs more
    counters than it holds."""
    dev = torch.device("cpu")
    dops._COUNTERS.pop(dev, None)
    try:
        first = dops._counters(dev, 32)
        assert pops._counters is dops._counters
        assert pops._counters(dev, 8) is first
        assert first.dtype == torch.int32 and not first.any()
        bigger = pops._counters(dev, first.numel() + 1)
        assert bigger.numel() > first.numel()
        assert dops._counters(dev, 1) is bigger
    finally:
        dops._COUNTERS.pop(dev, None)
