"""Closed-form LMMSE estimator (Proposition 3.1).

    W = C_YX C_XX^{-1},   b = E[Y] − W E[X].

Port of ``repro.core.lmmse``: float64, a small ridge on C_XX (calibration
sample noise makes the smallest eigenvalues unreliable; the ridge is
relative to the mean diagonal magnitude), solved with ``torch.linalg`` on
the device that holds the moments (the JAX package: numpy on the host).
"""
from __future__ import annotations

import torch


def lmmse_from_moments(fin: dict, ridge: float = 1e-6
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (W (d_out, d_in), b (d_out,)) in float64."""
    cxx, cyx = fin["cxx"].double(), fin["cyx"].double()
    d = cxx.shape[0]
    lam = ridge * torch.trace(cxx) / d
    a = cxx + lam * torch.eye(d, dtype=cxx.dtype, device=cxx.device)
    # W = C_yx A^{-1}  <=>  A Wᵀ = C_yxᵀ  (A symmetric PD)
    w = torch.linalg.solve(a, cyx.t()).t()
    b = fin["ey"] - w @ fin["ex"]
    return w, b


def lmmse_mse(fin: dict, w: torch.Tensor) -> float:
    """Achieved MSE of the estimator: Tr(C_YY) − Tr(W C_XY) (eq. 12 with
    the optimal W; for the ridge solution up to O(ridge)). Only C_Y₊Y₊ is
    kept, so Tr(C_YY) comes from C_Y₊Y₊ = C_YY + C_YX + C_XY + C_XX;
    Tr(W C_XY) = Σ W ∘ C_YX needs no d×d product."""
    cyx = fin["cyx"].double()
    cyy = fin["cypyp"].double() - cyx - cyx.t() - fin["cxx"].double()
    return float(torch.trace(cyy) - (w * cyx).sum())
