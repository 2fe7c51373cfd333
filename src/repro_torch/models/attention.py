"""Self-attention of the port: the full-sequence path (prefill, ``apply``)
through K3, the scalar-position decode against a monolithic cache, and the
paged decode and fused step against the page pools through K1.

Port of ``repro.models.attention``: ``self_attention`` (with its
``prefix=`` triple), ``decode_attention`` in scalar-position mode,
``decode_paged_attention`` and ``fused_paged_attention``. Two hazards of the
JAX version do not carry over to torch as written:

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

Caches are updated IN PLACE (the JAX version returns new arrays): the
engine owns one paged cache and every step rewrites a few pages of it, and
``generate`` writes one ring slot of its monolithic cache per step.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_mixed
from repro_torch.models.layers import apply_rope, softcap


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


def _qkv(cfg, p: dict, x: torch.Tensor):
    """Projected q (B, h, S, hd), k, v (B, kv, S, hd), before RoPE."""
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    return (_split_heads(x @ p["wq"].to(dt), h, hd),
            _split_heads(x @ p["wk"].to(dt), kvh, hd),
            _split_heads(x @ p["wv"].to(dt), kvh, hd))


def _scale(cfg) -> float:
    return cfg.attn_scale or cfg.head_dim ** -0.5


def self_attention(cfg, p: dict, x: torch.Tensor, *, window: Optional[int],
                   positions: torch.Tensor, prefix=None):
    """Causal self-attention over x (B, S, d) at absolute ``positions``
    (S,) int32, through K3.

    ``prefix`` serves the partial (suffix-only) prefill: a (k_pre, v_pre,
    kpos_pre) triple of already-cached KV, k/v (B or 1, KV, P, hd) and
    kpos_pre (P,) with -1 = invalid. Queries then attend [prefix ++ suffix]
    keys; causality and window stay purely positional. Returns
    (out (B, S, d), (k, v)) with the roped K/V of x's tokens only."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv(cfg, p, x)
    ppos = positions[None, None, :]
    q = apply_rope(q, ppos, cfg.rope_theta)
    k = apply_rope(k, ppos, cfg.rope_theta)
    kk, vv, kpos = k, v, positions
    if prefix is not None:
        k_pre, v_pre, kpos_pre = prefix
        k_pre = k_pre.expand((b,) + k_pre.shape[1:])
        v_pre = v_pre.expand((b,) + v_pre.shape[1:])
        kk = torch.cat([k_pre.to(k.dtype), k], dim=2)
        vv = torch.cat([v_pre.to(v.dtype), v], dim=2)
        kpos = torch.cat([kpos_pre, positions])
    out = flash_attention(q.contiguous(), kk.contiguous(), vv.contiguous(),
                          positions, kpos, scale=_scale(cfg), causal=True,
                          window=window, softcap=cfg.attn_logit_softcap)
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    return out @ p["wo"].to(x.dtype), (k, v)


def decode_attention(cfg, p: dict, x: torch.Tensor, cache: dict, pos: int, *,
                     window: Optional[int]):
    """Single-token decode, every sequence at the same absolute position
    ``pos`` (``generate``). x: (B, 1, d); cache: {k, v: (B, KV, W, hd),
    kpos (W,)}, a ring of width W: the new K/V go to slot ``pos % W``
    (in place). A plain computation, as in the JAX package (no kernel):
    float32 scores, probabilities cast to V's dtype for the product.
    The JAX package's per-slot ring mode (vector ``pos``, kpos (B, W))
    comes with the ring slot layout (ROADMAP.md §A7)."""
    if cache["kpos"].dim() != 1:
        raise NotImplementedError(
            "per-slot ring decode: not in this slice of the port; it comes "
            "with the ring slot layout (ROADMAP.md §A7)")
    b = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = int(pos)
    q, k_new, v_new = _qkv(cfg, p, x)
    ppos = torch.full((1, 1, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, ppos, cfg.rope_theta)
    k_new = apply_rope(k_new, ppos, cfg.rope_theta)
    k, v, kpos = cache["k"], cache["v"], cache["kpos"]
    slot = pos % k.shape[2]
    k[:, :, slot] = k_new[:, :, 0].to(k.dtype)
    v[:, :, slot] = v_new[:, :, 0].to(v.dtype)
    kpos[slot] = pos
    rep = h // kvh
    qg = q.reshape(b, kvh, rep, hd)
    sc = torch.einsum("bgrd,bgtd->bgrt", qg.float(), k.float()) * _scale(cfg)
    sc = softcap(sc, cfg.attn_logit_softcap)
    valid = (kpos >= 0) & (kpos <= pos)
    if window is not None:
        valid &= (pos - kpos) < window
    pr = torch.softmax(sc.masked_fill(~valid, float("-inf")), dim=-1)
    out = torch.einsum("bgrt,bgtd->bgrd", pr.to(v.dtype).float(), v.float())
    out = out.reshape(b, 1, h * hd).to(x.dtype)
    return out @ p["wo"].to(x.dtype), cache


def decode_paged_attention(cfg, p: dict, x: torch.Tensor, cache: dict,
                           pos: torch.Tensor, page_tbl: torch.Tensor, *,
                           window: Optional[int]):
    """Single-token decode against the page pools: x (B, 1, d); pos (B,)
    int32 position of each row's token, -1 for an inactive row. K1 runs
    with W = 1 rows (row_pos = pos, row_len = 1; 0 where pos < 0): the
    new K/V are written first, then each row attends [0, pos]. Returns
    (out (B, 1, d), cache) with the pools updated in place."""
    live = pos >= 0
    row_pos = torch.where(live, pos, torch.zeros_like(pos)).to(torch.int32)
    row_len = live.to(torch.int32)
    return fused_paged_attention(cfg, p, x, cache, row_pos, row_len,
                                 page_tbl, window=window)


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

    q, k_new, v_new = _qkv(cfg, p, x)                           # (B, n, W, hd)
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
                      scale=_scale(cfg), window=window,
                      softcap=cfg.attn_logit_softcap)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, w, h * hd).to(dt)
    return out @ p["wo"].to(dt), cache
