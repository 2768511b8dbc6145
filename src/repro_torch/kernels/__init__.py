"""Hand-written CUDA kernels for Hopper (sm_90a) that replace the JAX
package's Pallas TPU kernels: decode and paged decode attention on the
serving path, flash attention under the teacher-forced loss.  Each kernel
module holds the wrapper (plain PyTorch version for a CPU tensor, the
kernel for a CUDA tensor) and a launch counter; ``build`` compiles
``csrc/`` with ``nvcc``."""
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: F401
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.paged_attention.ops import (  # noqa: F401
    gather_pages, paged_attention)
