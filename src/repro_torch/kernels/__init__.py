"""Hand-written Hopper kernels of the port and their plain versions.

  paged_attention  K1: paged attention over the fused step's mixed rows
                   (replaces repro/kernels/paged_attention.py::paged_attention)
  nbl_linear       K2: the NBL block y = x @ W + b (+ x)
                   (replaces repro/kernels/nbl_linear.py::nbl_linear)
  flash_attention  K3: flash attention forward over explicit positions
                   (replaces repro/kernels/flash_attention.py::flash_attention)
  cov_accum        K4: covariance accumulation acc += y^T x, in place
                   (replaces repro/kernels/cov_accum.py::cov_accum)

CUDA sources live in ``repro_torch/csrc/`` and are built by ``nvcc`` at
first use (kernels/_build.py). ``K1`` .. ``K4`` are the kernels'
launch counters. A wrapper runs its plain version only for CPU tensors;
for CUDA tensors it launches its kernel or raises.
"""
from repro_torch.kernels._build import build_all  # noqa: F401
from repro_torch.kernels.cov_accum import K4  # noqa: F401
from repro_torch.kernels.flash_attention import K3  # noqa: F401
from repro_torch.kernels.nbl_linear import K2  # noqa: F401
from repro_torch.kernels.paged_attention import K1  # noqa: F401

KERNEL_SOURCES = ("paged_attention", "nbl_linear", "flash_attention",
                  "cov_accum")
