"""Serving driver: prompts in, tokens out, through the paged chunked engine.

Port of ``repro.launch.serve.serve_requests``. The JAX version runs the
ring-layout engine by default; the port runs the paged, chunked, fused
engine, the only one this slice carries. ``generate`` (the fixed-batch
reference loop) needs the full-sequence path and K3, and comes with the
next slice.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.engine import Engine
from repro_torch.models.paging import DEFAULT_PAGE_SIZE


def serve_requests(cfg: ModelConfig, params, prompts: Sequence, *,
                   max_new: int, max_len: Optional[int] = None,
                   n_slots: Optional[int] = None,
                   cache_budget_bytes: Optional[int] = None,
                   eos_id: Optional[int] = None,
                   page_size: int = DEFAULT_PAGE_SIZE,
                   prefill_chunk_tokens: Optional[int] = None,
                   step_tokens: Optional[int] = None,
                   device="cuda"):
    """Serve a batch of (possibly ragged) prompts through the engine.

    Returns (list of per-request token arrays in submission order, stats).
    An unservable prompt raises (this wrapper has no per-request error
    channel)."""
    prompts = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
    if not prompts:
        raise ValueError("serve_requests needs at least one prompt")
    if max_len is None:
        max_len = max(p.shape[0] for p in prompts) + max_new
    if n_slots is None and cache_budget_bytes is None:
        n_slots = min(len(prompts), 8)
    eng = Engine(cfg, params, max_len=max_len, n_slots=n_slots,
                 cache_budget_bytes=cache_budget_bytes, eos_id=eos_id,
                 page_size=page_size,
                 prefill_chunk_tokens=prefill_chunk_tokens,
                 step_tokens=step_tokens, device=device)
    rids = [eng.submit(p, max_new, strict=True) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids], eng.stats()
