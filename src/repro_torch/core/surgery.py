"""Model surgery: rewrite a config's stack plan and its params after
linearizing (NBL) or removing (DROP/SLEB) blocks.

The port's copy of ``repro.core.surgery``. The config half regroups the
flat block list into maximal repeated runs, so a port config and its JAX
twin have the same ``stack`` (and so the same params layout for
``interop.from_jax_params``). The params half is simpler than the JAX
one: the port's params are a per-layer list (no stacking per group), so
``compress_params`` rewrites the chosen layers and keeps every other
layer dict as it is. A shared block's dict is the same object at every
position it runs; a rewritten layer always gets a new dict, so the shared
one is never mutated.
"""
from __future__ import annotations

from typing import Iterable, Mapping, Optional

import torch

from repro_torch.configs.base import Block, ModelConfig, StackGroup
from repro_torch.device import torch_dtype

MODES = ("nbl", "drop", "nbl_block", "drop_block")


def transform_block(blk: Block, mode: str) -> Block:
    if mode == "nbl":
        return blk.replace(kind="nbl", window=None)
    if mode == "drop":
        return blk.replace(kind="drop", window=None)
    if mode == "nbl_block":
        return blk.replace(kind="nbl_block", ffn="none", window=None,
                           shared=False)
    if mode == "drop_block":
        return blk.replace(kind="drop_block", ffn="none", window=None,
                           shared=False)
    raise ValueError(mode)


def _regroup(blocks: list[Block], max_period: int = 8) -> tuple[StackGroup, ...]:
    """Greedy periodic run-length grouping of a flat block list."""
    groups: list[StackGroup] = []
    i, n = 0, len(blocks)
    while i < n:
        best_unit, best_rep, best_cover = (blocks[i],), 1, 1
        for period in range(1, max_period + 1):
            if i + period > n:
                break
            unit = tuple(blocks[i:i + period])
            rep = 1
            while (i + (rep + 1) * period <= n
                   and tuple(blocks[i + rep * period:
                             i + (rep + 1) * period]) == unit):
                rep += 1
            cover = rep * period
            # only repeated units beat the single-block fallback; among
            # those prefer more coverage, then shorter units
            if rep >= 2 and (cover > best_cover
                             or (cover == best_cover
                                 and period < len(best_unit))):
                best_unit, best_rep, best_cover = unit, rep, cover
        groups.append(StackGroup(unit=best_unit, repeat=best_rep))
        i += best_cover
    return tuple(groups)


def compress_config(cfg: ModelConfig, layer_ids: Iterable[int],
                    mode: str = "nbl") -> ModelConfig:
    """New config with ``layer_ids`` transformed per ``mode``."""
    assert mode in MODES, mode
    ids = set(layer_ids)
    blocks = cfg.blocks()
    for i in ids:
        blocks[i] = transform_block(blocks[i], mode)
    nbl_prev = set(cfg.nbl_layers)
    if mode in ("nbl", "nbl_block"):
        nbl_prev |= ids
    return cfg.replace(stack=_regroup(blocks),
                       nbl_layers=tuple(sorted(nbl_prev)))


def nbl_variant(cfg: ModelConfig, m: int) -> ModelConfig:
    """Compressed config: linearize the m deepest self-attention layers
    (paper App. G: selected layers concentrate at the end of the stack).
    m=0 returns the config unchanged."""
    cand = cfg.attn_layer_indices()
    return compress_config(cfg, cand[-m:], "nbl") if m else cfg


def _transform_params(p_old: dict, mode: str, linear, dtype,
                      device) -> dict:
    """Per-layer param rewrite into a new dict. ``linear`` = (W (d_out,
    d_in), b) from LMMSE, tensors or numpy arrays. The model computes
    h = x @ w + b, so w stores Wᵀ in the param dtype."""
    if mode in ("nbl", "nbl_block"):
        if linear is None:
            raise ValueError("NBL needs the LMMSE (W, b) of every layer")
        w, b = (torch.as_tensor(a, device=device) for a in linear)
        mixer = {"w": w.t().to(dtype).contiguous(),
                 "b": b.to(dtype).contiguous()}
        if mode == "nbl_block":
            return {"mixer": mixer}
        p = {"mixer": mixer}
    elif mode == "drop":
        p = {}
    else:  # drop_block
        return {}
    # retain the FFN path (and its norm) untouched
    for k in ("norm2", "ffn"):
        if k in p_old:
            p[k] = p_old[k]
    return p


def compress_params(cfg: ModelConfig, params: dict, layer_ids: Iterable[int],
                    mode: str = "nbl",
                    linear_maps: Optional[Mapping[int, tuple]] = None) -> dict:
    """Params for ``compress_config(cfg, layer_ids, mode)``: a new top-level
    dict and layer list; the rewritten layers get new dicts, every other
    layer (and every other tensor) is shared with ``params``. (The JAX
    version also takes the new config, to re-stack its groups; the port's
    per-layer list needs no re-stacking.)"""
    ids = set(layer_ids)
    dtype = torch_dtype(cfg.param_dtype)
    device = params["embed"].device
    layers = list(params["layers"])
    for i in ids:
        lin = None if linear_maps is None else linear_maps.get(i)
        layers[i] = _transform_params(layers[i], mode, lin, dtype, device)
    return dict(params, layers=layers)


def compress(cfg: ModelConfig, params: dict, layer_ids: Iterable[int],
             mode: str = "nbl",
             linear_maps: Optional[Mapping[int, tuple]] = None
             ) -> tuple[ModelConfig, dict]:
    layer_ids = list(layer_ids)
    new_cfg = compress_config(cfg, layer_ids, mode)
    return new_cfg, compress_params(cfg, params, layer_ids, mode, linear_maps)
