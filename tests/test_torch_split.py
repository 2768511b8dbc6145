"""The split plan of the paged-decode kernel (K2) and a plain mirror of its
partition-and-combine, on the CPU.

The kernel (``csrc/paged_attention.cu``) cuts each slot's window into
chunks of whole pages, attends each chunk in its own thread block, and
combines the chunks' partial softmax states (m, l, acc) in chunk order.  A
CUDA kernel cannot run here, so this file holds the arithmetic it relies
on: ``split_plan`` (the function the wrapper calls to size the chunks and
the scratch), and a plain PyTorch mirror of the partition and the combine,
held to ``paged_attention_plain`` and through it to the JAX package's
``paged_attention`` (the Pallas kernel in interpret mode, as
tests/test_torch_kernels.py runs it).  The mirror lives here: the port
never calls it.

Tolerances are the repo's kernel bounds: 2e-5 in fp32, 2e-2 in bf16 (atol
and rtol).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention.ops import (  # noqa: E402
    paged_attention as jax_paged)
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def split_mirror(q, k_pool, v_pool, page_table, lengths):
    """The kernel's partition and combine in plain PyTorch: the window's
    keys in the plan's chunks, each chunk's (m, l, acc) over its keys below
    the slot's length (m = -1e30, l = 0, acc = 0 for a chunk with none),
    then the chunks combined one after another in chunk order."""
    b, h, hd = q.shape
    _, block, kh, _ = k_pool.shape
    w = page_table.shape[1]
    g = h // kh
    plan = pops.split_plan(b, w, block, kh, g, hd)
    k = pops.gather_pages(k_pool, page_table).float()
    v = pops.gather_pages(v_pool, page_table).float()
    lengths = lengths.clamp(0, w * block).to(torch.long)
    scores = torch.einsum("bkgh,btkh->bkgt",
                          q.float().reshape(b, kh, g, hd), k) / math.sqrt(hd)
    t = torch.arange(w * block)
    parts = []
    for j in range(plan.splits):
        lo, hi = j * plan.chunk, min((j + 1) * plan.chunk, w * block)
        valid = (t[lo:hi][None, :] < lengths[:, None])[:, None, None, :]
        s = scores[..., lo:hi].masked_fill(~valid, -1e30)
        m = s.max(-1).values
        p = torch.exp(s - m[..., None]) * valid
        parts.append((m, p.sum(-1),
                      torch.einsum("bkgt,btkh->bkgh", p, v[:, lo:hi])))
    mx = torch.stack([m for m, _, _ in parts]).max(0).values
    den = torch.zeros_like(mx)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:                          # in chunk order
        wgt = torch.exp(m - mx)
        den = den + l * wgt
        acc = acc + a * wgt[..., None]
    out = acc / den.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, hd).to(q.dtype)


def _inputs(b, w, n, kh, g, hd, block, lengths, dtype, seed):
    rng = np.random.default_rng(seed)
    table = rng.integers(1, n, (b, w)).astype(np.int32)
    table[0, -1] = 0                       # the trash page
    table[1, 0] = n + 2                    # clamped into the pool
    q = rng.standard_normal((b, kh * g, hd), np.float32)
    kp = rng.standard_normal((n, block, kh, hd), np.float32)
    vp = rng.standard_normal((n, block, kh, hd), np.float32)
    jd, td, _ = DTYPES[dtype]
    arrs = (q, kp, vp)
    return ([jnp.asarray(a).astype(jd) for a in arrs]
            + [jnp.asarray(table), jnp.asarray(np.array(lengths, np.int32))],
            [torch.from_numpy(a).to(td) for a in arrs]
            + [torch.from_numpy(table),
               torch.tensor(lengths, dtype=torch.int32)])


def _close(port, ref, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def test_split_plan_at_the_paged_paths_shape():
    """4 slots, 8 KV heads of G = 3, hd 128, W = 68 pages of 16: 64-key
    splits, 17 per slot; 544 blocks, 432 of them with keys at the decode
    step's lengths."""
    plan = pops.split_plan(4, 68, 16, 8, 3, 128)
    assert (plan.chunk_pages, plan.chunk, plan.splits) == (4, 64, 17)
    assert plan.partial_shape == (4, 8, 17, 3 * (128 + 2))
    assert plan.counters == 32
    assert plan.splits * 8 * 4 == 544
    with_keys = sum(-(-n // plan.chunk) for n in (1041, 913, 760, 577))
    assert with_keys * 8 == 432


@pytest.mark.parametrize("width,block", [(1, 16), (68, 16), (5, 128),
                                         (3, 1), (7, 48), (9, 8)])
def test_split_plan_covers_the_window_in_whole_pages(width, block):
    plan = pops.split_plan(2, width, block, 2, 4, 64)
    assert plan.chunk == plan.chunk_pages * block
    assert 1 <= plan.chunk_pages <= pops.MAX_SPLIT_PAGES
    assert plan.splits == -(-width // plan.chunk_pages)
    assert (plan.splits - 1) * plan.chunk < width * block
    assert plan.splits * plan.chunk >= width * block
    assert plan.partial_shape == (2, 2, plan.splits, 4 * 66)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("g", [1, 3, 4])
def test_mirror_matches_plain_and_pallas(g, dtype):
    """Ragged lengths 0 and 1, one short of, at and one past a split
    boundary, two splits and one, the full window and past it."""
    b, w, n, kh, hd, block = 9, 9, 40, 2, 32, 16
    chunk = pops.split_plan(b, w, block, kh, g, hd).chunk
    assert chunk == 64 and w * block == 144
    lengths = [0, 1, chunk - 1, chunk, chunk + 1, 2 * chunk, 2 * chunk + 1,
               w * block, w * block + 9]
    jax_args, args = _inputs(b, w, n, kh, g, hd, block, lengths, dtype,
                             seed=30 + g)
    mirror = split_mirror(*args)
    plain = pops.paged_attention_plain(*args)
    _close(mirror, plain.float().numpy(), dtype)
    _close(mirror, jax_paged(*jax_args), dtype)
    assert torch.all(mirror[0] == 0) and torch.isfinite(mirror).all()


@pytest.mark.parametrize("block", [8, 32, 128])
def test_mirror_matches_plain_for_other_page_sizes(block):
    """Pages of 8 (8 to a split), 32 (2) and 128 (one page, larger than
    the kernel's 64-row tile)."""
    w, n, kh, g, hd = 6, 20, 2, 3, 64
    plan = pops.split_plan(4, w, block, kh, g, hd)
    lengths = [0, plan.chunk + 1, w * block - 1, w * block]
    _, args = _inputs(4, w, n, kh, g, hd, block, lengths, "float32",
                      seed=block)
    _close(split_mirror(*args),
           pops.paged_attention_plain(*args).float().numpy(), "float32")


def test_empty_splits_drop_out_of_the_combine():
    """A split with no keys below the length has m = -1e30 and l = 0, so
    its weight in the combine is exactly 0: appending empty splits to a
    slot's states leaves the output unchanged."""
    rng = np.random.default_rng(5)
    m = torch.from_numpy(rng.standard_normal(3).astype(np.float32))
    l = torch.from_numpy(rng.random(3).astype(np.float32)) + 0.5
    acc = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))

    def combine(m, l, acc):
        mx = m.max()
        wgt = torch.exp(m - mx)
        return (acc * wgt[:, None]).sum(0) / (l * wgt).sum().clamp_min(1e-30)

    empty = torch.tensor([-1e30, -1e30])
    out = combine(torch.cat([m, empty]), torch.cat([l, torch.zeros(2)]),
                  torch.cat([acc, torch.zeros(2, 8)]))
    assert torch.equal(out, combine(m, l, acc))
    assert torch.equal(combine(empty, torch.zeros(2), torch.zeros(2, 8)),
                       torch.zeros(8))
