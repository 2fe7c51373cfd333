"""Primitive layers: RMSNorm, RoPE, gated MLP, softcap, embeddings.

Conventions match ``repro.models.layers`` exactly:
  * RMSNorm computes in float32 and scales by ``(1 + w)`` (zero-init w);
  * RoPE rotates split halves (x1 = x[..., :hd/2], x2 = x[..., hd/2:]),
    not interleaved pairs;
  * GeGLU uses the tanh approximation of GELU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + w.float())).to(dt)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, head_dim); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """Gated MLP: silu (Llama/SwiGLU) or geglu (Gemma)."""
    dt = x.dtype
    g = x @ p["w_gate"].to(dt)
    u = x @ p["w_up"].to(dt)
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return (g * u) @ p["w_down"].to(dt)


def softcap(logits: torch.Tensor, cap) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    return table[tokens].to(dtype)
