"""Layer-selection criteria (Algorithm 1 step 7 + paper ablations F.3/F.4).

Port of ``repro.core.selection``.

  - "cca":    rank by the Theorem-3.2 NMSE bound (the paper's criterion)
  - "cosine": rank by DROP's cosine distance 1 − E[cos(x, y₊)]
               (layers whose output is most similar to their input first)
"""
from __future__ import annotations

from typing import Callable, Mapping

from repro_torch.configs.base import ModelConfig
from repro_torch.core.calibrate import LayerCalib, calibrate
from repro_torch.core.surgery import compress


def rank_layers(calib: Mapping[int, LayerCalib],
                criterion: str = "cca") -> list[int]:
    if criterion == "cca":
        return sorted(calib, key=lambda i: calib[i].bound)
    if criterion == "cosine":
        return sorted(calib, key=lambda i: calib[i].cos_dist)
    raise ValueError(criterion)


def select_layers(calib: Mapping[int, LayerCalib], m: int,
                  criterion: str = "cca") -> list[int]:
    """The m most-linearizable layers (lowest bound / distance)."""
    return rank_layers(calib, criterion)[:m]


def greedy_select(cfg: ModelConfig, params: dict,
                  data_factory: Callable, m: int, *, mode: str = "nbl",
                  device="cuda") -> tuple[list[int], dict[int, LayerCalib]]:
    """Paper Appendix F.4 ablation: iteratively pick the single best layer,
    apply its linearization, re-calibrate on the compressed model (whose
    linearized layers run K2), repeat. (The paper finds one-shot CCA
    ranking outperforms this.)"""
    chosen: list[int] = []
    cur_cfg, cur_params = cfg, params
    all_calib: dict[int, LayerCalib] = {}
    for _ in range(m):
        remaining = [i for i in cur_cfg.attn_layer_indices()
                     if i not in chosen]
        calib = calibrate(cur_cfg, cur_params, data_factory,
                          layers=remaining, device=device)
        best = min(calib, key=lambda i: calib[i].bound)
        all_calib[best] = calib[best]
        chosen.append(best)
        cur_cfg, cur_params = compress(
            cur_cfg, cur_params, [best], mode,
            linear_maps={best: calib[best].linear})
    return chosen, all_calib
