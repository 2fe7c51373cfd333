"""Removal baselines the paper compares against.

Port of ``repro.core.drop``.

  Attn DROP / Block DROP  [He et al. 2024]: rank blocks by cosine distance
      between block input and output (most-similar first), remove the
      attention sub-block / whole block.
  SLEB [Song et al. 2024]: greedy transformer-block removal by perplexity
      impact on a calibration stream.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.core.calibrate import calibrate
from repro_torch.core.selection import select_layers
from repro_torch.core.surgery import compress
from repro_torch.eval.perplexity import perplexity


def drop_compress(cfg: ModelConfig, params: dict, data_factory: Callable,
                  m: int, *, block: bool = False, device="cuda"
                  ) -> tuple[ModelConfig, dict, list[int]]:
    """Attn DROP (block=False) / Block DROP (block=True)."""
    calib = calibrate(cfg, params, data_factory, tap_block=block,
                      device=device)
    ids = select_layers(calib, m, criterion="cosine")
    mode = "drop_block" if block else "drop"
    new_cfg, new_params = compress(cfg, params, ids, mode)
    return new_cfg, new_params, ids


def sleb_compress(cfg: ModelConfig, params: dict, data_factory: Callable,
                  m: int, *, device="cuda"
                  ) -> tuple[ModelConfig, dict, list[int]]:
    """Greedy block removal: at each of m rounds remove the block whose
    removal hurts calibration perplexity least."""
    removed: list[int] = []
    cur_cfg, cur_params = cfg, params
    for _ in range(m):
        candidates = [i for i, b in enumerate(cur_cfg.blocks())
                      if b.kind not in ("drop_block",) and not b.shared]
        best, best_ppl = None, float("inf")
        for i in candidates:
            t_cfg, t_params = compress(cur_cfg, cur_params, [i], "drop_block")
            ppl = perplexity(t_cfg, t_params, data_factory, device=device)
            if ppl < best_ppl:
                best, best_ppl = i, ppl
        removed.append(best)
        cur_cfg, cur_params = compress(cur_cfg, cur_params, [best],
                                       "drop_block")
    return cur_cfg, cur_params, removed
