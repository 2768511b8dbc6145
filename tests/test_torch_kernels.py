"""The port's decode-attention kernels, plain versions, against the JAX
package's Pallas kernels (interpret mode on the CPU, as the JAX kernel
tests run them), on the same numpy inputs.

Tolerances are the repo's kernel bounds (tests/test_kernels_decode.py):
2e-5 in fp32, 2e-2 in bf16 (atol and rtol).  The CUDA kernels themselves
are held against these plain versions on the card by ``chip_smoke.py``
and ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention as jax_decode)
from repro.kernels.paged_attention.ops import (  # noqa: E402
    paged_attention as jax_paged)
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _both(a, dtype):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _close(port, ref, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("g", [1, 3, 4])
def test_decode_plain_matches_pallas(g, dtype):
    """Ragged lengths 0, 1 and the 256-row block edges, with T not a
    multiple of the Pallas block."""
    rng = np.random.default_rng(10 + g)
    b, t, kh, hd = 6, 300, 2, 32
    lengths = np.array([0, 1, 255, 256, 257, 300], np.int32)
    q = rng.standard_normal((b, kh * g, hd), np.float32)
    k = rng.standard_normal((b, t, kh, hd), np.float32)
    v = rng.standard_normal((b, t, kh, hd), np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    ref = jax_decode(jq, jk, jv, jnp.asarray(lengths))
    out = dops.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    assert out.dtype == DTYPES[dtype][1] and out.shape == (b, kh * g, hd)
    _close(out, ref, dtype)
    assert torch.all(out[0] == 0)          # length 0: zeros, never NaN


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("g", [1, 3, 4])
def test_paged_plain_matches_pallas(g, dtype):
    """Shared pages, the trash page 0, a partial last page, out-of-range
    table entries (clamped into the pool) and a length past the table's
    window (clamped to W * block)."""
    rng = np.random.default_rng(20 + g)
    b, w, n, kh, hd, block = 4, 5, 12, 2, 32, 16
    table = rng.integers(1, n, (b, w)).astype(np.int32)
    table[0, 2:] = 0                       # unmapped tail -> trash page
    table[1] = table[2]                    # shared pages
    table[2, 4] = n + 3                    # clamped to N - 1
    table[3, 0] = -2                       # clamped to 0
    lengths = np.array([0, 2 * block + 1, w * block - 1, w * block + 9],
                       np.int32)
    q = rng.standard_normal((b, kh * g, hd), np.float32)
    kp = rng.standard_normal((n, block, kh, hd), np.float32)
    vp = rng.standard_normal((n, block, kh, hd), np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, kp, vp))
    ref = jax_paged(jq, jk, jv, jnp.asarray(table), jnp.asarray(lengths))
    out = pops.paged_attention(tq, tk, tv, torch.from_numpy(table),
                               torch.from_numpy(lengths))
    assert out.dtype == DTYPES[dtype][1] and out.shape == (b, kh * g, hd)
    _close(out, ref, dtype)
    assert torch.all(out[0] == 0)


def test_gather_pages_clamps_into_pool():
    pool = torch.arange(4 * 2 * 1 * 1, dtype=torch.float32).reshape(4, 2, 1, 1)
    table = torch.tensor([[3, -1], [9, 0]], dtype=torch.int32)
    dense = pops.gather_pages(pool, table)
    assert dense.shape == (2, 4, 1, 1)
    assert dense[:, :, 0, 0].tolist() == [[6, 7, 0, 1], [6, 7, 0, 1]]


@pytest.mark.parametrize("bad", ["group", "head_dim", "dtype", "device"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(bad):
    """The checks run before any launch, so they are exercised here on a
    tensor the wrapper is told lives elsewhere: a 'meta' tensor takes no
    plain version and must raise, as must shapes no kernel is built for."""
    if bad == "device":
        q = torch.zeros((1, 2, 32), device="meta")
        k = torch.zeros((1, 8, 2, 32), device="meta")
        with pytest.raises(ValueError, match="no kernel for meta"):
            dops.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32,
                                                      device="meta"))
        return
    h, kh, hd, dt = 4, 2, 32, torch.bfloat16
    if bad == "group":
        h = 18                             # G = 9
    elif bad == "head_dim":
        hd = 48
    else:
        dt = torch.float16
    with pytest.raises(ValueError):
        dops.check_shape("decode_attention", h, kh, hd, dt)
