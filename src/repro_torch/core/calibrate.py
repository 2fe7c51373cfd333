"""NBL calibration: stream calibration batches through the model,
accumulate per-layer (X, Y) moments, compute CCA bounds and LMMSE maps.

Port of ``repro.core.calibrate``. Layers are processed in chunks of
``chunk_layers``; for each chunk the calibration stream is replayed (data
factories are deterministic) and only that chunk's taps and moments are
alive at once. Per batch: one ``forward_with_taps`` (K3 in every attention
layer, K2 in every NBL layer), then ``update_moments`` per tapped layer
(four K4 launches each). Per layer: ``finalize``, the CCA bound and the
LMMSE map in float64 on the calibration device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cca, lmmse
from repro_torch.core.moments import finalize, init_moments, update_moments
from repro_torch.device import params_device
from repro_torch.models.transformer import forward_with_taps


@dataclasses.dataclass
class LayerCalib:
    layer: int
    bound: float                 # Theorem 3.2 NMSE upper bound
    cos_dist: float              # DROP's criterion: 1 − E[cos(x, y₊)]
    rho: torch.Tensor            # canonical correlations, float64
    w: torch.Tensor              # LMMSE weight (d_out, d_in), float64
    b: torch.Tensor              # LMMSE bias (d_out,), float64
    mse: float                   # achieved MSE Tr(C_YY) − Tr(W C_XY)
    nmse: float                  # mse / Tr(C_Y₊Y₊)

    @property
    def linear(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.w, self.b


def candidate_layers(cfg: ModelConfig) -> list[int]:
    """Default NBL candidates: non-shared self-attention blocks."""
    return cfg.attn_layer_indices()


def _now(dev: torch.device, sync: bool) -> float:
    if sync and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def calibrate(cfg: ModelConfig, params: dict,
              data_factory: Callable[[], Iterable[dict]], *,
              layers: Optional[Sequence[int]] = None,
              tap_block: bool = False,
              chunk_layers: int = 8,
              ridge: float = 1e-6,
              device="cuda",
              timings: Optional[dict] = None) -> dict[int, LayerCalib]:
    """Run Algorithm 1 steps 3-6 and the (W, b) computation of step 9 for
    all candidate layers. ``data_factory()`` returns a fresh iterator of
    batches ({"tokens": (B, S)} numpy) — replayed once per layer chunk.

    ``timings``, when given, accumulates the seconds spent in the forward
    passes (``forward_s``), the moment updates (``moments_s``) and
    finalize + CCA + LMMSE (``solve_s``), and the tokens streamed
    (``tokens``); each part then ends in a device synchronisation."""
    dev = params_device(params, device)
    layers = list(layers if layers is not None else candidate_layers(cfg))
    d = cfg.d_model
    sync = timings is not None
    t = {"forward_s": 0.0, "moments_s": 0.0, "solve_s": 0.0, "tokens": 0}

    results: dict[int, LayerCalib] = {}
    for c0 in range(0, len(layers), chunk_layers):
        chunk = layers[c0:c0 + chunk_layers]
        moms = {i: init_moments(d, d, device=dev) for i in chunk}
        for batch in data_factory():
            tokens = torch.as_tensor(batch["tokens"], device=dev)
            t0 = _now(dev, sync)
            _, taps = forward_with_taps(cfg, params, tokens,
                                        tap_layers=tuple(chunk),
                                        tap_block=tap_block)
            t1 = _now(dev, sync)
            for i in chunk:
                update_moments(moms[i], *taps.pop(i))
            t2 = _now(dev, sync)
            t["forward_s"] += t1 - t0
            t["moments_s"] += t2 - t1
            t["tokens"] += tokens.numel()
        t0 = _now(dev, sync)
        for i in chunk:
            fin = finalize(moms.pop(i))
            bound, rho = cca.cca_bound_from_moments(fin)
            w, b = lmmse.lmmse_from_moments(fin, ridge)
            mse = lmmse.lmmse_mse(fin, w)
            tr = float(torch.trace(fin["cypyp"]))
            results[i] = LayerCalib(
                layer=i, bound=bound, cos_dist=1.0 - fin["cos_mean"],
                rho=rho, w=w, b=b, mse=mse, nmse=mse / max(tr, 1e-30))
        t["solve_s"] += _now(dev, sync) - t0
    if timings is not None:
        for k, v in t.items():
            timings[k] = timings.get(k, 0) + v
    return results
