"""K3: flash attention forward over explicit query and key positions.

Port of the Pallas kernel ``repro.kernels.flash_attention.flash_attention``,
of its padding wrapper ``repro.kernels.ops.attention`` and of its oracle
``repro.kernels.ref.flash_attention_ref``. The hand-written CUDA kernel is
``csrc/flash_attention.cu``; ``flash_attention_ref`` is its plain version.

The Pallas kernel places query s and key t at positions s and t. The port
takes the positions as arguments, with the semantics of the JAX model's
full-sequence path (``repro.models.attention._chunked_attention``):
``qpos`` (S,) and ``kpos`` (T,) int32, shared by the batch, ``kpos = -1``
for a padded or invalid key. Query s attends key t iff ``kpos[t] >= 0``,
``kpos[t] <= qpos[s]`` when causal, and ``qpos[s] - kpos[t] < window``
with a window. ``arange`` positions give the Pallas kernel's masks; the
prefill's bucket padding and the partial prefill's ``[prefix ++ suffix]``
keys are further cases. Ragged S and T need no padding.

Numerics follow the Pallas kernel: scores, softmax statistics and the
output accumulator in float32, one cast to q's dtype at the end. (The JAX
model's XLA path keeps score tiles in the compute dtype; at float32 the two
agree.) A query row with no attended key comes back as ZEROS, as in K1;
the JAX code returns the mean of V for such a row, so comparisons use rows
with at least one attended key.

``flash_attention`` takes the plain version only for tensors on the CPU.
For a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import LaunchCounter, load

K3 = LaunchCounter("flash_attention")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)


def attend_mask(qpos: torch.Tensor, kpos: torch.Tensor, *, causal: bool,
                window: Optional[int]) -> torch.Tensor:
    """(S, T) bool: which keys each query attends."""
    qp, kp = qpos.long()[:, None], kpos.long()[None, :]
    mask = (kp >= 0).expand(qp.shape[0], kp.shape[1])
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & ((qp - kp) < window)
    return mask


def flash_attention_ref(q, k, v, qpos, kpos, *, scale: Optional[float] = None,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Plain version of K3: full masked softmax in float32. q (B, H, S, hd),
    k / v (B, KV, T, hd) -> (B, H, S, hd) in q's dtype."""
    b, h, s, hd = q.shape
    kvh = k.shape[1]
    scale = hd ** -0.5 if scale is None else scale
    qg = q.float().reshape(b, kvh, h // kvh, s, hd)
    sc = torch.einsum("bgrsd,bgtd->bgrst", qg, k.float()) * scale
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    mask = attend_mask(qpos, kpos, causal=causal, window=window)
    sc = sc.masked_fill(~mask, float("-inf"))
    m = sc.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(sc - m)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bgrst,bgtd->bgrsd", p, v.float())
    return out.reshape(b, h, s, hd).to(q.dtype)


def _lib():
    lib = load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, qpos, kpos):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention wants q (B,H,S,hd) and k, v "
                         f"(B,KV,T,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, hd = q.shape
    b2, kvh, t, hd2 = k.shape
    if b2 != b or hd2 != hd or kvh == 0 or h % kvh:
        raise ValueError(f"k / v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if qpos.shape != (s,) or kpos.shape != (t,):
        raise ValueError(f"qpos {tuple(qpos.shape)} / kpos "
                         f"{tuple(kpos.shape)} do not fit S={s}, T={t}")
    return b, h, kvh, s, t, hd


def flash_attention(q, k, v, qpos, kpos, *, scale: Optional[float] = None,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Attention of q (B, H, S, hd) over k, v (B, KV, T, hd) at positions
    qpos (S,), kpos (T,) -> (B, H, S, hd)."""
    b, h, kvh, s, t, hd = _check(q, k, v, qpos, kpos)
    ts = (q, k, v, qpos, kpos)
    if all(x.device.type == "cpu" for x in ts):
        return flash_attention_ref(q, k, v, qpos, kpos, scale=scale,
                                   causal=causal, window=window,
                                   softcap=softcap)
    if any(x.device != q.device for x in ts) or q.device.type != "cuda":
        raise ValueError("flash_attention: all inputs on one CUDA device, "
                         "got " + ", ".join(str(x.device) for x in ts))
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel supports float32 and "
                         f"bfloat16 with q, k, v alike; got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if qpos.dtype != torch.int32 or kpos.dtype != torch.int32:
        raise ValueError("flash_attention kernel wants int32 qpos, kpos")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel supports head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    max_rep = 32 if (q.dtype == torch.float32 and hd >= 256) else 64
    if h // kvh > max_rep:
        raise ValueError(f"flash_attention kernel supports at most {max_rep} "
                         f"query heads per kv head here, got {h // kvh}")
    if not all(x.is_contiguous() for x in ts):
        raise ValueError("flash_attention kernel needs contiguous inputs")
    if q.dtype == torch.bfloat16 and any(x.data_ptr() % 16
                                         for x in (q, k, v)):
        raise ValueError("flash_attention bf16 kernel needs 16-byte aligned "
                         "q, k, v")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0 or None, got {softcap}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = hd ** -0.5 if scale is None else float(scale)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     qpos.data_ptr(), kpos.data_ptr(), out.data_ptr(), b, h,
                     kvh, s, t, hd, scale, int(causal), window or 0,
                     softcap or 0.0, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    K3.launches += 1
    return out
