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
    before = fops.flash_attention.launches
    fops.flash_attention(q.detach(), k, v)
    assert fops.flash_attention.launches == before   # the CPU runs no kernel
