"""Model assembly: init, the full-sequence forward (``apply``), ``prefill``,
``decode_step`` and the engine's ``fused_step``.

Port of ``repro.models.transformer``. Parameters are a plain dict of
tensors: ``embed`` (V, d), ``final_norm`` (d,), ``head`` (d, V) when the
embeddings are untied, and ``layers``, a list with one dict per global
block in ``cfg.blocks()`` order (the JAX package stacks them per stack
group and scans; the port loops over layers). Each layer dict has the JAX
block's keys: ``norm1`` / ``mixer`` {wq, wk, wv, wo} for attention,
``mixer`` {w, b} for an NBL block, ``norm2`` / ``ffn`` {w_gate, w_up,
w_down} for the dense FFN. A shared block's dict is the same object at
every position it runs.

Block kinds: attn, nbl, nbl_block, drop, drop_block with a dense FFN. An
NBL block computes ``x + (x @ W + b)`` through K2 (kernels/nbl_linear);
full-sequence attention runs K3 (kernels/flash_attention), paged attention
K1 (kernels/paged_attention).

Caches are ``{"layers": [...]}`` with one entry per block in
``cfg.blocks()`` order, None for a block that keeps no state: page pools
``{"k_pages", "v_pages"}`` for the engine, or the monolithic ring
``{"k", "v": (B, KV, W, hd), "kpos": (W,)}`` that ``prefill`` returns and
``decode_step`` extends.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import Block, ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.kernels.nbl_linear import nbl_linear
from repro_torch.models.attention import (
    decode_attention, decode_paged_attention, fused_paged_attention,
    paged_write_plan, self_attention,
)
from repro_torch.models.layers import embed_tokens, mlp, rmsnorm, softcap

SUPPORTED_KINDS = ("attn", "nbl", "nbl_block", "drop", "drop_block")


def _normal(gen: torch.Generator, shape, scale: float, dtype, device):
    t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return t.mul_(scale).to(dtype)


def _check_block(blk: Block) -> None:
    if blk.kind not in SUPPORTED_KINDS:
        raise NotImplementedError(
            f"block kind {blk.kind!r} is not in this slice of the port "
            f"(supported: {SUPPORTED_KINDS}); see ROADMAP.md §A8")
    if blk.ffn not in ("dense", "none"):
        raise NotImplementedError(f"ffn {blk.ffn!r}: see ROADMAP.md §A8")


def init_nbl_linear(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Random NBL linear map (real W, b come from calibration): lets an
    NBL-m config be initialised and served without calibrating."""
    d = cfg.d_model
    dt = torch_dtype(cfg.param_dtype)
    return {"w": _normal(gen, (d, d), d ** -0.5, dt, device),
            "b": torch.zeros(d, dtype=dt, device=device)}


def init_block(cfg: ModelConfig, blk: Block, gen: torch.Generator,
               device) -> dict:
    _check_block(blk)
    d = cfg.d_model
    dt = torch_dtype(cfg.param_dtype)
    p: dict = {}
    if blk.kind == "attn":
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        s, so = d ** -0.5, (h * hd) ** -0.5
        p["norm1"] = torch.zeros(d, dtype=dt, device=device)
        p["mixer"] = {
            "wq": _normal(gen, (d, h * hd), s, dt, device),
            "wk": _normal(gen, (d, kv * hd), s, dt, device),
            "wv": _normal(gen, (d, kv * hd), s, dt, device),
            "wo": _normal(gen, (h * hd, d), so, dt, device),
        }
    elif blk.kind in ("nbl", "nbl_block"):
        p["mixer"] = init_nbl_linear(cfg, gen, device)
    if blk.kind in ("nbl_block", "drop_block") or blk.ffn == "none":
        return p
    ff = cfg.d_ff
    p["norm2"] = torch.zeros(d, dtype=dt, device=device)
    p["ffn"] = {
        "w_gate": _normal(gen, (d, ff), d ** -0.5, dt, device),
        "w_up": _normal(gen, (d, ff), d ** -0.5, dt, device),
        "w_down": _normal(gen, (ff, d), ff ** -0.5, dt, device),
    }
    return p


def init_params(cfg: ModelConfig, *, seed: int = 0,
                generator: Optional[torch.Generator] = None,
                device="cuda") -> dict:
    """Random parameters drawn on ``device`` from ``generator`` (default: a
    fresh generator on that device seeded with ``seed``). Same shapes and
    scales as the JAX init; the numbers differ (torch and JAX generators
    differ), so parity tests convert JAX params with ``interop``."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(seed)
    d, v = cfg.d_model, cfg.vocab_size
    dt = torch_dtype(cfg.param_dtype)
    params: dict = {"embed": _normal(gen, (v, d), d ** -0.5, dt, dev),
                    "final_norm": torch.zeros(d, dtype=dt, device=dev)}
    if not cfg.tie_embeddings:
        params["head"] = _normal(gen, (d, v), d ** -0.5, dt, dev)
    layers = []
    for g in cfg.stack:
        shared = {}
        for _ in range(g.repeat):
            for u, blk in enumerate(g.unit):
                if blk.shared:
                    if u not in shared:
                        shared[u] = init_block(cfg, blk, gen, dev)
                    layers.append(shared[u])
                else:
                    layers.append(init_block(cfg, blk, gen, dev))
    params["layers"] = layers
    return params


def params_to(params: dict, device) -> dict:
    """Copy a params tree to ``device`` (shared layer dicts stay shared)."""
    dev = resolve_device(device)
    memo: dict = {}

    def conv(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if id(x) in memo:
            return memo[id(x)]
        if isinstance(x, dict):
            out = {k: conv(v) for k, v in x.items()}
        elif isinstance(x, list):
            out = [conv(v) for v in x]
        else:
            return x
        memo[id(x)] = out
        return out

    return conv(params)


def _block_fwd(cfg: ModelConfig, blk: Block, p: dict, x: torch.Tensor, *,
               mode: str, cache=None, positions=None, pos=None,
               cache_len: int = 0, page_tbl=None, paged: bool = False,
               valid_len: Optional[int] = None, prefix_tbl=None,
               prefix_len: Optional[int] = None, row_len=None, writes=None):
    """One residual block in one mode; returns (x, new cache entry).

    mode "train" (``apply``) and "prefill" run full-sequence attention at
    ``positions`` through K3; "prefill" also returns the block's ring cache
    (``_ring_cache``), and with ``prefix_tbl`` it gathers the already-paged
    prefix from ``cache`` (this layer's pools). "decode" runs one token at
    ``pos`` against a monolithic ring (scalar ``pos``) or the page pools
    (``pos`` (B,), ``page_tbl``). "fused" is the engine's mixed step:
    ``pos`` is each row's first position, ``row_len`` its valid tokens and
    ``writes`` the step's shared write plan. Caches are updated in place.
    """
    new_cache = None
    if blk.kind == "attn":
        h = rmsnorm(x, p["norm1"], cfg.norm_eps)
        if mode == "decode":
            if "k_pages" in cache:
                h, new_cache = decode_paged_attention(
                    cfg, p["mixer"], h, cache, pos, page_tbl,
                    window=blk.window)
            else:
                h, new_cache = decode_attention(cfg, p["mixer"], h, cache,
                                                pos, window=blk.window)
        elif mode == "fused":
            h, new_cache = fused_paged_attention(
                cfg, p["mixer"], h, cache, pos, row_len, page_tbl,
                window=blk.window, writes=writes)
        else:
            prefix = None
            if mode == "prefill" and prefix_tbl is not None:
                prefix = _gather_prefix(cache, prefix_tbl, prefix_len)
            h, (k, v) = self_attention(cfg, p["mixer"], h, window=blk.window,
                                       positions=positions, prefix=prefix)
            if mode == "prefill":
                new_cache = _ring_cache(cfg, blk, k, v, cache_len,
                                        paged=paged, valid_len=valid_len)
        x = x + h.to(x.dtype)
    elif blk.kind in ("nbl", "nbl_block"):
        # the paper's replacement: one GEMM, residual retained (Alg. 2) — K2
        d = x.shape[-1]
        x = nbl_linear(x.reshape(-1, d), p["mixer"]["w"].to(x.dtype),
                       p["mixer"]["b"].to(x.dtype),
                       residual=True).reshape(x.shape)
    elif blk.kind in ("drop", "drop_block"):
        pass
    else:
        _check_block(blk)
    if blk.kind in ("nbl_block", "drop_block") or blk.ffn == "none":
        return x, new_cache
    h = rmsnorm(x, p["norm2"], cfg.norm_eps)
    return x + mlp(p["ffn"], h, cfg.mlp_act).to(x.dtype), new_cache


def _gather_prefix(pool: dict, prefix_tbl: torch.Tensor, prefix_len: int):
    """Shared-prefix KV for a partial prefill: ``pool`` is one layer's
    pools (n_pages, KV, ps, hd); ``prefix_tbl`` (Pb,) physical ids, -1 past
    the prefix (clamped to page 0 and masked). Returns (k, v, kpos) with
    k/v (1, KV, Pb*ps, hd) and kpos -1 from ``prefix_len`` on."""
    idx = prefix_tbl.long().clamp(min=0)
    kg = pool["k_pages"][idx]                           # (Pb, KV, ps, hd)
    vg = pool["v_pages"][idx]
    pb, kvh, ps, hd = kg.shape
    kg = kg.transpose(0, 1).reshape(1, kvh, pb * ps, hd)
    vg = vg.transpose(0, 1).reshape(1, kvh, pb * ps, hd)
    t = torch.arange(pb * ps, dtype=torch.int32, device=kg.device)
    kpos = torch.where(t < int(prefix_len), t, torch.full_like(t, -1))
    return kg, vg, kpos


def _ring_cache(cfg: ModelConfig, blk: Block, k: torch.Tensor,
                v: torch.Tensor, cache_len: int, *, paged: bool = False,
                valid_len: Optional[int] = None) -> dict:
    """Full-sequence roped K/V (B, KV, S, hd) as a decode ring
    ``{"k", "v": (B, KV, W, hd), "kpos": (W,)}``, W = min(window,
    cache_len) (cache_len for a global layer). A prompt longer than the
    ring keeps its last W tokens, token i in slot i % W. ``paged`` keeps
    the cache POSITION-ALIGNED at full ``cache_len`` width even for
    windowed layers (pages map positions linearly). Positions >=
    ``valid_len`` (bucket padding) get kpos -1."""
    s = k.shape[2]
    dev = k.device
    if paged:
        w = cache_len
        assert w >= s, (w, s)
    else:
        w = min(blk.window, cache_len) if blk.window is not None \
            else cache_len
    if w >= s:
        pad = (0, 0, 0, w - s)
        kr, vr = F.pad(k, pad), F.pad(v, pad)
        kpos = torch.cat([torch.arange(s, dtype=torch.int32, device=dev),
                          torch.full((w - s,), -1, dtype=torch.int32,
                                     device=dev)])
    else:
        start = s - w
        slots = torch.arange(w, device=dev)
        src = start + (slots - start) % w
        kr, vr = k[:, :, src], v[:, :, src]
        kpos = src.to(torch.int32)
    if valid_len is not None:
        kpos = torch.where((kpos >= 0) & (kpos < int(valid_len)), kpos,
                           torch.full_like(kpos, -1))
    dt = torch_dtype(cfg.compute_dtype)
    return {"k": kr.to(dt).contiguous(), "v": vr.to(dt).contiguous(),
            "kpos": kpos}


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """float32 logits. The product runs in the compute dtype with float32
    accumulation; at bf16 its output is rounded to bf16 before the cast
    (the JAX einsum returns float32 directly)."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].t() if cfg.tie_embeddings else params["head"]
    logits = (x @ head.to(x.dtype)).float()
    return softcap(logits, cfg.final_logit_softcap)


@torch.no_grad()
def apply(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """Full-sequence forward. Returns (logits float32 (B, S, V), aux), aux
    a float32 zero (the JAX package's MoE auxiliary loss; the port has no
    MoE yet)."""
    dt = torch_dtype(cfg.compute_dtype)
    x = embed_tokens(params["embed"], tokens.long(), dt)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    for blk, p in zip(cfg.blocks(), params["layers"]):
        x, _ = _block_fwd(cfg, blk, p, x, mode="train", positions=positions)
    return _logits(cfg, params, x), torch.zeros((), device=x.device)


@torch.no_grad()
def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            cache_len: Optional[int] = None, paged: bool = False,
            valid_len: Optional[int] = None, prefix_cache=None,
            prefix_tbl: Optional[torch.Tensor] = None,
            prefix_len: Optional[int] = None, n_logits: int = 1):
    """Run the prompt ``tokens`` (B, S), build each attention layer's ring
    cache, return the last ``n_logits`` positions' logits (B, n_logits, V)
    float32, oldest first, and the cache.

    ``cache_len`` (default S) is the ring width of a global layer.
    ``paged`` keeps every layer's cache POSITION-ALIGNED at ``cache_len``
    for ``paging.assign_pages``. ``valid_len`` supports prompt bucketing:
    ``tokens`` may be right-padded; logits come from the positions before
    ``valid_len`` and cache entries from it on get kpos -1.

    PARTIAL prefill: with ``prefix_cache`` (the paged cache),
    ``prefix_tbl`` ((Pb,) int32 physical page per logical prefix page, -1
    padding) and ``prefix_len`` (prefix tokens, a page multiple), ``tokens``
    hold only the suffix, at positions ``prefix_len + i``, and attend the
    paged prefix through the table. The returned cache covers the suffix
    only; ``valid_len`` then counts valid suffix tokens."""
    b, s = tokens.shape
    cache_len = cache_len or s
    dt = torch_dtype(cfg.compute_dtype)
    x = embed_tokens(params["embed"], tokens.long(), dt)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    pools = [None] * len(params["layers"])
    if prefix_tbl is not None:
        assert paged, "partial prefill is a paged-engine path"
        positions = positions + int(prefix_len)
        pools = prefix_cache["layers"]
    layers = []
    for blk, p, pool in zip(cfg.blocks(), params["layers"], pools):
        x, c = _block_fwd(cfg, blk, p, x, mode="prefill", cache=pool,
                          positions=positions, cache_len=cache_len,
                          paged=paged, valid_len=valid_len,
                          prefix_tbl=prefix_tbl, prefix_len=prefix_len)
        layers.append(c)
    assert 1 <= n_logits <= s, (n_logits, tokens.shape)
    end = s if valid_len is None else int(valid_len)
    start = min(max(end - n_logits, 0), s - n_logits)   # JAX's slice clamp
    return (_logits(cfg, params, x[:, start:start + n_logits]),
            {"layers": layers})


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict, pos, page_tbl: Optional[torch.Tensor] = None):
    """One autoregressive step. token: (B, 1) int. With the monolithic
    cache ``prefill`` returns, ``pos`` is the one absolute position of
    every sequence (an int); with a PAGED cache, ``pos`` is (B,) int32 per
    row (-1 = inactive row) and ``page_tbl`` (B, n_lpages) int32 maps each
    row's logical pages. Returns (logits (B, 1, V) float32, cache), the
    cache updated in place."""
    dt = torch_dtype(cfg.compute_dtype)
    x = embed_tokens(params["embed"], token.long(), dt)
    for blk, p, c in zip(cfg.blocks(), params["layers"], cache["layers"]):
        x, _ = _block_fwd(cfg, blk, p, x, mode="decode", cache=c, pos=pos,
                          page_tbl=page_tbl)
    return _logits(cfg, params, x), cache


@torch.no_grad()
def fused_step(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
               cache: dict, row_pos: torch.Tensor, row_len: torch.Tensor,
               page_tbl: torch.Tensor):
    """One FUSED engine step: a mixed batch of decode rows (1 new token) and
    page-aligned prefill-chunk rows (up to W new tokens) against the shared
    paged cache.

    tokens: (B, W) int, each row right-padded past its valid span;
    row_pos: (B,) int32 position of each row's FIRST token; row_len: (B,)
    int32 valid tokens this step (1 decode, the span for a chunk row, 0 for
    an inactive row); page_tbl: (B, n_lpages) int32.

    Returns (logits (B, 1, V) float32, cache): logits at each row's LAST
    valid token, ``clip(row_len - 1, 0)`` (inactive rows give finite
    values the caller discards). The pools are updated in place.
    """
    dt = torch_dtype(cfg.compute_dtype)
    b, w = tokens.shape
    blocks = cfg.blocks()
    writes = None
    pools = [c for c in cache["layers"] if c is not None]
    if pools:
        writes = paged_write_plan(row_pos, row_len, page_tbl,
                                  pools[0]["k_pages"].shape[2], w)
    x = embed_tokens(params["embed"], tokens.long(), dt)
    for i, blk in enumerate(blocks):
        x, _ = _block_fwd(cfg, blk, params["layers"][i], x, mode="fused",
                          cache=cache["layers"][i], pos=row_pos,
                          row_len=row_len, page_tbl=page_tbl, writes=writes)
    idx = (row_len.long() - 1).clamp(min=0)
    x_last = x[torch.arange(b, device=x.device), idx][:, None]   # (B, 1, d)
    return _logits(cfg, params, x_last), cache
