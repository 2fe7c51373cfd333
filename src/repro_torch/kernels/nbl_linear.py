"""K2: the NBL replacement block ``y = x @ W + b (+ x)``.

Port of the Pallas kernel ``repro.kernels.nbl_linear.nbl_linear``. The
hand-written CUDA kernel is ``csrc/nbl_linear.cu``; ``nbl_linear_ref`` is
its plain PyTorch version.

Numerics: the product accumulates in float32, and bias and residual are
added in float32 before the one cast to x's dtype, as in the Pallas kernel.
The JAX model computes the block in the compute dtype instead
(``transformer.py``: ``x + (x @ W + b)``); at float32 the two agree up to
the summation order of the product. At bf16 the kernel rounds once where
the model rounds three times; tolerances are stated per dtype where the
two are compared.

``nbl_linear`` takes the plain version only for tensors on the CPU. For a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import LaunchCounter, load

K2 = LaunchCounter("nbl_linear")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def nbl_linear_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                   residual: bool = True) -> torch.Tensor:
    """Plain version: x (M, K), w (K, N), b (N,) -> (M, N) in x's dtype,
    float32 product, bias and residual."""
    y = x.float() @ w.float() + b.float()
    if residual:
        y = y + x.float()
    return y.to(x.dtype)


def _lib():
    lib = load("nbl_linear")
    fn = lib.nbl_linear_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(x, w, b, residual):
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"nbl_linear wants x (M,K), w (K,N), b (N,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    m, k = x.shape
    k2, n = w.shape
    if k != k2 or b.shape[0] != n:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    if residual and k != n:
        raise ValueError("residual needs a square W (d_model -> d_model)")
    if not (x.dtype == w.dtype == b.dtype):
        raise ValueError(f"dtype mismatch: {x.dtype}, {w.dtype}, {b.dtype}")
    return m, k, n


def nbl_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
               residual: bool = True) -> torch.Tensor:
    """x (M, K), w (K, N), b (N,) -> (M, N). ``residual`` adds x (K == N)."""
    m, k, n = _check(x, w, b, residual)
    devs = {x.device.type, w.device.type, b.device.type}
    if devs == {"cpu"}:
        return nbl_linear_ref(x, w, b, residual=residual)
    if devs != {"cuda"} or len({x.device, w.device, b.device}) != 1:
        raise ValueError(f"nbl_linear: all inputs on one CUDA device, got "
                         f"{x.device}, {w.device}, {b.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"nbl_linear kernel supports float32 and bfloat16, "
                         f"got {x.dtype}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("nbl_linear kernel needs contiguous inputs")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                     m, n, k, int(residual), _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"nbl_linear kernel launch failed: cudaError {err}")
    K2.launches += 1
    return y
