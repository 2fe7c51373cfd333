"""Paged self-attention for the fused engine step (port of
``repro.models.attention.fused_paged_attention``).

Two hazards of the JAX version do not carry over to torch as written:

1. The reference scatters the K/V of invalid tokens to the out-of-range
   page ``n_pages`` and relies on ``mode="drop"``. Torch has no such mode,
   and on CUDA an out-of-range index is a device-side assert. The port
   instead FILTERS the flat (page, offset) list by the write mask before
   ``index_put_`` (:func:`paged_write_plan`), so an invalid token is never
   written at all.
2. The page table uses -1 for "unallocated" and negative indices wrap in
   torch. Gathers clamp at 0 and mask (kernels/paged_attention.py); the
   write plan drops tokens whose table entry is negative, as the
   reference's write mask does.

The page pools are updated IN PLACE (the JAX version returns new arrays):
the engine owns one cache and every step rewrites a few pages of it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.paged_attention import paged_mixed
from repro_torch.models.layers import apply_rope


class WritePlan(NamedTuple):
    """Where a step's new K/V go: ``sel`` indexes the flat (B*W) tokens
    that are valid AND land on an allocated page; ``pid`` / ``off`` are
    their physical page and in-page offset."""
    sel: torch.Tensor
    pid: torch.Tensor
    off: torch.Tensor


def paged_write_plan(row_pos: torch.Tensor, row_len: torch.Tensor,
                     page_tbl: torch.Tensor, page_size: int,
                     width: int) -> WritePlan:
    """The filtered scatter list of one fused step. The page table is
    shared by every layer, so the step computes this once (one
    data-dependent ``nonzero``) and every attention layer reuses it."""
    b = row_pos.shape[0]
    dev = row_pos.device
    ar = torch.arange(width, device=dev)
    tpos = row_pos.long()[:, None] + ar[None, :]                 # (B, W)
    valid = ar[None, :] < row_len.long()[:, None]
    safe = torch.where(valid, tpos, torch.zeros_like(tpos))
    rows = torch.arange(b, device=dev)[:, None].expand(b, width)
    pid = page_tbl.long()[rows, safe // page_size]
    keep = (valid & (pid >= 0)).reshape(-1)
    sel = torch.nonzero(keep).squeeze(1)
    return WritePlan(sel, pid.reshape(-1)[sel], (safe % page_size).reshape(-1)[sel])


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd).transpose(1, 2)               # (B, n, S, hd)


def fused_paged_attention(cfg, p: dict, x: torch.Tensor, cache: dict,
                          row_pos: torch.Tensor, row_len: torch.Tensor,
                          page_tbl: torch.Tensor, *, window: Optional[int],
                          writes: Optional[WritePlan] = None):
    """Mixed-row step attention: decode rows AND prefill-chunk rows against
    the shared paged KV layout.

    x: (B, W, d); row_pos: (B,) absolute position of each row's first
    token; row_len: (B,) valid tokens this step (0 = inactive row);
    page_tbl: (B, n_lpages) int32, -1 = unallocated; cache: this layer's
    ``{"k_pages", "v_pages"}`` pools (n_pages, KV, page_size, hd).

    All valid tokens are written into their pages first, then token t of
    row b attends positions [0, row_pos[b] + t] of its slot through K1
    (write-before-attend gives exact in-chunk causality). Returns
    (out (B, W, d), cache) with the pools updated in place.
    """
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, w, _ = x.shape
    dt = x.dtype
    page_size = cache["k_pages"].shape[2]
    if writes is None:
        writes = paged_write_plan(row_pos, row_len, page_tbl, page_size, w)

    q = _split_heads(x @ p["wq"].to(dt), h, hd)                 # (B, h, W, hd)
    k_new = _split_heads(x @ p["wk"].to(dt), kvh, hd)
    v_new = _split_heads(x @ p["wv"].to(dt), kvh, hd)
    tpos = row_pos.long()[:, None] + torch.arange(w, device=x.device)[None, :]
    ppos = tpos[:, None, :]                    # (B, 1, W) broadcasts over heads
    q = apply_rope(q, ppos, cfg.rope_theta)
    k_new = apply_rope(k_new, ppos, cfg.rope_theta)

    k_pages, v_pages = cache["k_pages"], cache["v_pages"]
    k_flat = k_new.transpose(1, 2).reshape(b * w, kvh, hd)[writes.sel]
    v_flat = v_new.transpose(1, 2).reshape(b * w, kvh, hd)[writes.sel]
    k_pages[writes.pid, :, writes.off] = k_flat.to(k_pages.dtype)
    v_pages[writes.pid, :, writes.off] = v_flat.to(v_pages.dtype)

    rep = h // kvh
    qg = q.reshape(b, kvh, rep, w, hd).contiguous()
    out = paged_mixed(qg, k_pages, v_pages, page_tbl, row_pos, row_len,
                      scale=cfg.attn_scale or hd ** -0.5, window=window,
                      softcap=cfg.attn_logit_softcap)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, w, h * hd).to(dt)
    return out @ p["wo"].to(dt), cache
