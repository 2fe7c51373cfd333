"""K4: covariance accumulation ``acc += yᵀx`` in float32, in place.

Port of the Pallas kernel ``repro.kernels.cov_accum.cov_accum`` and of its
oracle ``repro.kernels.ref.cov_accum_ref``. The hand-written CUDA kernel is
``csrc/cov_accum.cu``; ``cov_accum_ref`` is its plain version. The JAX
package's padding wrapper (``ops.cov_update``, tokens padded to 512 with
zero rows) has no counterpart: the kernel masks ragged T, Dx and Dy.

``acc`` (Dy, Dx) float32 is the running sum; x (T, Dx) and y (T, Dy) may
be float32 or bfloat16 (one dtype for both) and are converted to float32
before the product, as in the Pallas kernel. ``y=None`` is the Gram update
``acc += xᵀx``. ``cov_accum`` updates ``acc`` IN PLACE and returns it, as
the Pallas kernel's ``input_output_aliases={2: 0}`` does.

The kernel sums each output element over T in a fixed order inside one
block (no atomics), so repeated runs on the same inputs are bit-identical;
``core.moments`` relies on that.

``cov_accum`` takes the plain version only for tensors on the CPU. For a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import LaunchCounter, load

K4 = LaunchCounter("cov_accum")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def cov_accum_ref(acc: torch.Tensor, x: torch.Tensor,
                  y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: ``acc + y.float()ᵀ @ x.float()`` (a new tensor)."""
    y = x if y is None else y
    return acc + y.float().t() @ x.float()


def _lib():
    lib = load("cov_accum")
    fn = lib.cov_accum_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(acc, x, y):
    if x.dim() != 2 or y.dim() != 2 or acc.dim() != 2:
        raise ValueError(f"cov_accum wants x (T, Dx), y (T, Dy), acc "
                         f"(Dy, Dx); got {tuple(x.shape)}, {tuple(y.shape)}, "
                         f"{tuple(acc.shape)}")
    if x.shape[0] != y.shape[0] or acc.shape != (y.shape[1], x.shape[1]):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, y "
                         f"{tuple(y.shape)}, acc {tuple(acc.shape)}")
    if acc.dtype != torch.float32:
        raise ValueError(f"acc must be float32, got {acc.dtype}")


def cov_accum(acc: torch.Tensor, x: torch.Tensor,
              y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """acc (Dy, Dx) float32 += yᵀx in place (y defaults to x); returns acc."""
    gram = y is None
    y = x if gram else y
    _check(acc, x, y)
    devs = {acc.device.type, x.device.type, y.device.type}
    if devs == {"cpu"}:
        return acc.copy_(cov_accum_ref(acc, x, None if gram else y))
    if devs != {"cuda"} or len({acc.device, x.device, y.device}) != 1:
        raise ValueError(f"cov_accum: all inputs on one CUDA device, got "
                         f"{acc.device}, {x.device}, {y.device}")
    if x.dtype not in _DTYPES or y.dtype != x.dtype:
        raise ValueError(f"cov_accum kernel takes float32 or bfloat16 x and "
                         f"y of one dtype, got {x.dtype}, {y.dtype}")
    if not (acc.is_contiguous() and x.is_contiguous() and y.is_contiguous()):
        raise ValueError("cov_accum kernel needs contiguous inputs")
    if acc.data_ptr() in (x.data_ptr(), y.data_ptr()):
        raise ValueError("cov_accum: acc must not alias x or y")
    t, dx = x.shape
    dy = y.shape[1]
    if t == 0 or dx == 0 or dy == 0:
        return acc
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(x.data_ptr(), y.data_ptr(), acc.data_ptr(), t, dx, dy,
                     _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"cov_accum kernel launch failed: cudaError {err}")
    K4.launches += 1
    return acc
