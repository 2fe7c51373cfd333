"""Serving entry points: prompts in, tokens out.

Port of ``repro.launch.serve``:

  serve_requests   runs the paged, fused engine (the JAX version runs the
                   ring-layout engine by default; the port carries only
                   the paged layout so far).
  generate         the fixed-batch, fixed-length decode loop: ``prefill``
                   (K3) into a monolithic cache, then ``decode_step`` at one
                   shared position. It is the port's own greedy reference:
                   the engine's tokens per request must equal it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.engine import Engine
from repro_torch.models.paging import DEFAULT_PAGE_SIZE
from repro_torch.models.transformer import decode_step, prefill


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


@torch.no_grad()
def generate(cfg: ModelConfig, params, tokens, *, max_new: int,
             greedy: bool = True, seed: int = 0) -> torch.Tensor:
    """Fixed-batch generation: every sequence shares one position.
    tokens: (B, S) int prompt (moved to the params' device). Returns
    (B, max_new) int32 on that device.

    The first token is the prompt's argmax, as in the JAX version. With
    ``greedy=False`` the later tokens are drawn from softmax(logits) by a
    ``torch.Generator`` seeded with ``seed``; they cannot equal the JAX
    package's draws (another generator)."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens if isinstance(tokens, torch.Tensor)
                             else np.asarray(tokens), device=dev).long()
    b, s = tokens.shape
    logits, cache = prefill(cfg, params, tokens, cache_len=s + max_new)
    gen = None if greedy else torch.Generator(device=dev).manual_seed(seed)
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    out = [tok]
    for i in range(max_new - 1):
        logits, cache = decode_step(cfg, params, tok, cache, s + i)
        if greedy:
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        else:
            tok = torch.multinomial(torch.softmax(logits[:, -1], dim=-1), 1,
                                    generator=gen)
        out.append(tok)
    return torch.cat(out, dim=1).to(torch.int32)
