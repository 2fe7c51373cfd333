"""Model surgery, config half: rewrite a config's stack plan after
linearizing (NBL) or removing (DROP/SLEB) blocks.

This is the port's copy of the config functions of
``repro.core.surgery``. With them an NBL-m config is built without
calibration; the per-layer (W, b) maps come from calibration in a later
slice, or from ``models.transformer.init_nbl_linear`` for random-weight
runs. The regrouping into maximal repeated runs is kept so a port config
and its JAX twin have the same ``stack`` (and so the same params layout
for ``interop.from_jax_params``).
"""
from __future__ import annotations

from typing import Iterable

from repro_torch.configs.base import Block, ModelConfig, StackGroup

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
