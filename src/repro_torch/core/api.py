"""One-call public API for the paper's technique and its baselines.

Port of ``repro.core.api``."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core.calibrate import LayerCalib, calibrate, candidate_layers
from repro_torch.core.selection import rank_layers, select_layers
from repro_torch.core.surgery import compress


@dataclasses.dataclass
class CompressionReport:
    method: str
    layers: list[int]
    ranking: list[int]
    bounds: dict[int, float]
    cos_dists: dict[int, float]
    nmse: dict[int, float]

    def summary(self) -> str:
        rows = [f"{self.method}: linearized/removed layers {self.layers}"]
        for i in self.layers:
            rows.append(f"  layer {i:3d} bound={self.bounds[i]:.4f} "
                        f"nmse={self.nmse.get(i, float('nan')):.4f} "
                        f"cos_dist={self.cos_dists[i]:.4f}")
        return "\n".join(rows)


def nbl_compress(cfg: ModelConfig, params: dict, data_factory: Callable,
                 m: int, *, block: bool = False, criterion: str = "cca",
                 layers: Optional[Sequence[int]] = None,
                 calib: Optional[dict[int, LayerCalib]] = None,
                 device="cuda", timings: Optional[dict] = None,
                 ) -> tuple[ModelConfig, dict, CompressionReport]:
    """Neural Block Linearization (Algorithm 1).

    block=False  -> Attn NBL-m (the paper's main configuration)
    block=True   -> Block NBL-m (whole transformer blocks)
    criterion    -> "cca" (Theorem 3.2 bound) or "cosine" (ablation F.3)
    device       -> where the params live and calibration runs ("cuda"
                    unless the caller asks for the CPU)
    timings      -> filled by ``calibrate`` when given
    """
    if calib is None:
        cand = layers if layers is not None else candidate_layers(cfg)
        calib = calibrate(cfg, params, data_factory, layers=cand,
                          tap_block=block, device=device, timings=timings)
    ids = select_layers(calib, m, criterion)
    mode = "nbl_block" if block else "nbl"
    new_cfg, new_params = compress(
        cfg, params, ids, mode,
        linear_maps={i: calib[i].linear for i in ids})
    report = CompressionReport(
        method=("Block" if block else "Attn") + f" NBL-{m} ({criterion})",
        layers=ids, ranking=rank_layers(calib, criterion),
        bounds={i: c.bound for i, c in calib.items()},
        cos_dists={i: c.cos_dist for i, c in calib.items()},
        nmse={i: c.nmse for i, c in calib.items()})
    return new_cfg, new_params, report
