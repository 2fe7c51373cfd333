"""K1: paged attention over the fused step's mixed rows.

Port of the Pallas kernel ``repro.kernels.paged_attention.paged_attention``
and of its plain versions ``paged_mixed_xla`` / ``paged_decode_xla``. The
hand-written CUDA kernel is ``csrc/paged_attention.cu``; it takes the mixed
``(B, W)`` rows directly (``row_pos``, ``row_len``) instead of B*W virtual
decode rows, so every staged page serves all W*rep query rows of a slot.

Layouts (the JAX package's): q (B, KV, rep, W, hd); k_pages / v_pages
(n_pages, KV, page_size, hd); page_tbl (B, n_lpages) int32 with -1 =
unallocated; row_pos / row_len (B,) int32. Query w of slot b sits at
position ``row_pos[b] + w`` and is valid while ``w < row_len[b]``; it
attends positions ``t <= qpos`` whose page is allocated and, with a window,
``qpos - t < window``.

Fully masked query rows (invalid rows, or rows whose every key is masked)
come back as ZEROS, in the plain versions and in the kernel alike. The
JAX reference returns the mean of the gathered V for such rows (its
docstring says zeros), so comparisons with it use valid rows only.

``paged_mixed`` takes the plain version only for tensors on the CPU. For a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import LaunchCounter, load

K1 = LaunchCounter("paged_mixed")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128, 256)


def _gather(pages: torch.Tensor, page_tbl: torch.Tensor) -> torch.Tensor:
    """(B, KV, n_lpages * page_size, hd) float32 view of each slot's
    logical sequence; unallocated (-1) entries clamp to page 0 and are
    masked by the caller (negative ids would wrap)."""
    b, n_lp = page_tbl.shape
    _, kvh, ps, hd = pages.shape
    g = pages[page_tbl.clamp(min=0).long()]          # (B, P, KV, ps, hd)
    return g.permute(0, 2, 1, 3, 4).reshape(b, kvh, n_lp * ps, hd).float()


def _softmax_rows(s: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked softmax over the last dim; all-masked rows give zeros."""
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def paged_mixed_ref(q, k_pages, v_pages, page_tbl, row_pos, row_len, *,
                    scale: Optional[float] = None,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Plain version of K1 (port of ``paged_mixed_xla``): one page gather
    per slot feeding a dense masked softmax. Returns (B, KV, rep, W, hd)
    in q's dtype."""
    b, kvh, rep, w, hd = q.shape
    ps = k_pages.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    kg = _gather(k_pages, page_tbl)
    vg = _gather(v_pages, page_tbl)
    s = torch.einsum("bgrwd,bgtd->bgrwt", q.float(), kg) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    dev = q.device
    t = torch.arange(kg.shape[2], device=dev)[None, None, :]
    ar = torch.arange(w, device=dev)
    qpos = row_pos.long()[:, None] + ar[None, :]                 # (B, W)
    qvalid = ar[None, :] < row_len.long()[:, None]               # (B, W)
    alloc = (page_tbl >= 0).repeat_interleave(ps, dim=1)         # (B, T)
    valid = (t <= qpos[:, :, None]) & alloc[:, None, :] & qvalid[:, :, None]
    if window is not None:
        valid &= (qpos[:, :, None] - t) < window
    p = _softmax_rows(s, valid[:, None, None])
    out = torch.einsum("bgrwt,bgtd->bgrwd", p, vg)
    return out.to(q.dtype)


def paged_decode_ref(q, k_pages, v_pages, page_tbl, lengths, *,
                     scale: Optional[float] = None,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """Plain single-query decode (port of ``paged_decode_xla``):
    q (B, KV, rep, hd), lengths (B,) valid tokens per slot (the query sits
    at lengths - 1). Returns (B, KV, rep, hd)."""
    b, kvh, rep, hd = q.shape
    ps = k_pages.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    kg = _gather(k_pages, page_tbl)
    vg = _gather(v_pages, page_tbl)
    s = torch.einsum("bgrd,bgtd->bgrt", q.float(), kg) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    t = torch.arange(kg.shape[2], device=q.device)[None]         # (1, T)
    ln = lengths.long()[:, None]                                 # (B, 1)
    valid = (t < ln) & (page_tbl >= 0).repeat_interleave(ps, dim=1)
    if window is not None:
        valid &= (ln - 1 - t) < window
    p = _softmax_rows(s, valid[:, None, None])
    return torch.einsum("bgrt,bgtd->bgrd", p, vg).to(q.dtype)


def _lib():
    lib = load("paged_attention")
    fn = lib.paged_mixed_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k_pages, v_pages, page_tbl, row_pos, row_len):
    if q.dim() != 5 or k_pages.dim() != 4:
        raise ValueError(f"paged_mixed wants q (B,KV,rep,W,hd) and pages "
                         f"(n_pages,KV,ps,hd); got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}")
    b, kvh, rep, w, hd = q.shape
    n_pages, kvh2, ps, hd2 = k_pages.shape
    if v_pages.shape != k_pages.shape or kvh2 != kvh or hd2 != hd:
        raise ValueError(f"page pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not fit q {tuple(q.shape)}")
    if page_tbl.dim() != 2 or page_tbl.shape[0] != b \
            or row_pos.shape != (b,) or row_len.shape != (b,):
        raise ValueError(f"page_tbl {tuple(page_tbl.shape)}, row_pos "
                         f"{tuple(row_pos.shape)}, row_len "
                         f"{tuple(row_len.shape)} do not fit B={b}")
    return b, kvh, rep, w, hd, ps


def paged_mixed(q, k_pages, v_pages, page_tbl, row_pos, row_len, *,
                scale: Optional[float] = None, window: Optional[int] = None,
                softcap: Optional[float] = None) -> torch.Tensor:
    """Mixed-row paged attention, (B, KV, rep, W, hd) -> same shape."""
    b, kvh, rep, w, hd, ps = _check(q, k_pages, v_pages, page_tbl, row_pos,
                                    row_len)
    ts = (q, k_pages, v_pages, page_tbl, row_pos, row_len)
    if all(t.device.type == "cpu" for t in ts):
        return paged_mixed_ref(q, k_pages, v_pages, page_tbl, row_pos,
                               row_len, scale=scale, window=window,
                               softcap=softcap)
    if any(t.device != q.device for t in ts) or q.device.type != "cuda":
        raise ValueError("paged_mixed: all inputs on one CUDA device, got "
                         + ", ".join(str(t.device) for t in ts))
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"paged_mixed kernel supports float32 and bfloat16 "
                         f"with q and pages alike; got {q.dtype}, "
                         f"{k_pages.dtype}, {v_pages.dtype}")
    if any(t.dtype != torch.int32 for t in (page_tbl, row_pos, row_len)):
        raise ValueError("paged_mixed kernel wants int32 page_tbl, row_pos, "
                         "row_len")
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged_mixed kernel supports head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    if ps < 8 or ps & (ps - 1):
        raise ValueError(f"paged_mixed kernel wants a power-of-two "
                         f"page_size >= 8, got {ps}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_mixed kernel needs contiguous inputs")
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
        err = _lib()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                     page_tbl.data_ptr(), row_pos.data_ptr(),
                     row_len.data_ptr(), out.data_ptr(), b, kvh, rep, w, hd,
                     ps, page_tbl.shape[1], scale, window or 0,
                     softcap or 0.0, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_mixed kernel launch failed: cudaError {err}")
    K1.launches += 1
    return out

