"""Model assembly for the paged serving path: init and the fused step.

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
NBL block computes ``x + (x @ W + b)`` through K2 (kernels/nbl_linear).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import Block, ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.kernels.nbl_linear import nbl_linear
from repro_torch.models.attention import fused_paged_attention, paged_write_plan
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
               cache, row_pos, row_len, page_tbl, writes) -> torch.Tensor:
    """One residual block of the fused step; attention layers update their
    page pools in place."""
    if blk.kind == "attn":
        h = rmsnorm(x, p["norm1"], cfg.norm_eps)
        h, _ = fused_paged_attention(cfg, p["mixer"], h, cache, row_pos,
                                     row_len, page_tbl, window=blk.window,
                                     writes=writes)
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
        return x
    h = rmsnorm(x, p["norm2"], cfg.norm_eps)
    return x + mlp(p["ffn"], h, cfg.mlp_act).to(x.dtype)


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """float32 logits. The product runs in the compute dtype with float32
    accumulation; at bf16 its output is rounded to bf16 before the cast
    (the JAX einsum returns float32 directly)."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].t() if cfg.tie_embeddings else params["head"]
    logits = (x @ head.to(x.dtype)).float()
    return softcap(logits, cfg.final_logit_softcap)


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
        x = _block_fwd(cfg, blk, params["layers"][i], x,
                       cache=cache["layers"][i], row_pos=row_pos,
                       row_len=row_len, page_tbl=page_tbl, writes=writes)
    idx = (row_len.long() - 1).clamp(min=0)
    x_last = x[torch.arange(b, device=x.device), idx][:, None]   # (B, 1, d)
    return _logits(cfg, params, x_last), cache
