"""Config system: model configs, block/stack plans, registry.

The PyTorch port's own copy of ``repro.configs.base`` (the port imports
nothing of the JAX package). A model is an ordered tuple of
``StackGroup``s, each repeating a short ``unit`` of ``Block`` descriptors;
the port executes the flattened ``cfg.blocks()`` list layer by layer.

Only what the paged serving path runs is kept: dense attention stacks and
the NBL block kinds. Mixture-of-experts, SSM and cross-attention configs
belong to later slices of the port.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional


@dataclass(frozen=True)
class Block:
    """One residual block (mixer + optional ffn) in the stack.

    kind:
      "attn"        self-attention (GQA; optional sliding window / softcap)
      "nbl"         NBL-linearized attention: x + (x @ W + b)
      "drop"        attention removed entirely (Attn DROP baseline)
      "nbl_block"   whole block linearized: x + (x @ W + b), no ffn
      "drop_block"  whole block removed (SLEB / Block DROP baseline)
    ffn: "dense" | "none"
    window: sliding-window size for local attention (None = global).
    shared: params shared across all repeats of the group (Zamba2).
    """
    kind: str = "attn"
    ffn: str = "dense"
    window: Optional[int] = None
    shared: bool = False

    def replace(self, **kw) -> "Block":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class StackGroup:
    unit: tuple[Block, ...]
    repeat: int = 1

    @property
    def n_blocks(self) -> int:
        return len(self.unit) * self.repeat


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    d_model: int
    vocab_size: int
    stack: tuple[StackGroup, ...]
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    mlp_act: str = "silu"       # silu | geglu
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    attn_scale: Optional[float] = None     # None -> 1/sqrt(head_dim)
    tie_embeddings: bool = True
    sub_quadratic: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    nbl_layers: tuple[int, ...] = ()
    max_seq_len: int = 8192

    @property
    def n_blocks(self) -> int:
        return sum(g.n_blocks for g in self.stack)

    def blocks(self) -> list[Block]:
        """Flattened per-position block descriptors."""
        out: list[Block] = []
        for g in self.stack:
            out.extend(list(g.unit) * g.repeat)
        return out

    def attn_layer_indices(self) -> list[int]:
        """Global block indices whose mixer is (unshared) self-attention:
        the NBL candidates."""
        return [i for i, b in enumerate(self.blocks())
                if b.kind == "attn" and not b.shared]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def dense_stack(n_layers: int, *, window: Optional[int] = None,
                pattern: tuple[Optional[int], ...] = ()) -> tuple[StackGroup, ...]:
    """Uniform dense stack; ``pattern`` gives a cycle of per-layer windows
    (e.g. (4096, None) for Gemma-2 local/global alternation)."""
    if pattern:
        period = len(pattern)
        assert n_layers % period == 0, (n_layers, pattern)
        unit = tuple(Block(kind="attn", ffn="dense", window=w) for w in pattern)
        return (StackGroup(unit=unit, repeat=n_layers // period),)
    unit = (Block(kind="attn", ffn="dense", window=window),)
    return (StackGroup(unit=unit, repeat=n_layers),)


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str, **overrides: Any) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (registers the arch modules)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    return cfg.replace(**overrides) if overrides else cfg

