"""Canonical Correlation Analysis and the Theorem-3.2 NMSE bound.

Port of ``repro.core.cca``. The JAX package does this dense linear algebra
in float64 numpy on the host; the port runs it in float64 with
``torch.linalg`` on the device that holds the moments (the calibration
device): at d = 4096 each layer needs two eigendecompositions of d×d,
which take minutes in numpy for a 32-layer model.

The canonical correlations ρ_i are the singular values of
C_W = C_YY^{-1/2} C_YX C_XX^{-1/2}. The port takes them as the square
roots of the eigenvalues of the symmetric C_W C_Wᵀ (or C_Wᵀ C_W, the
smaller side) through ``eigvalsh``, where the reference takes an SVD: a
symmetric eigensolver is much faster on the card than a d×d SVD. ρ² is
what the bound uses, and it agrees with the SVD route to float64 rounding
(tests/test_torch_calibrate.py); a ρ near 0 is resolved only to ~1e-8,
the square root of that rounding.
"""
from __future__ import annotations

import torch


def inv_sqrt_psd(c: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """C^{-1/2} of a symmetric PSD matrix via eigh, eigenvalue-floored at
    ``eps * max(1, λ_max)``."""
    c = c.double()
    c = 0.5 * (c + c.t())
    w, v = torch.linalg.eigh(c)
    floor = eps * w.max().clamp_min(1.0)
    w = torch.maximum(w, floor)
    return (v * w.rsqrt()) @ v.t()


def canonical_correlations(cxx: torch.Tensor, cyx: torch.Tensor,
                           cyy: torch.Tensor, eps: float = 1e-6
                           ) -> torch.Tensor:
    """ρ_i, the singular values of C_W = C_YY^{-1/2} C_YX C_XX^{-1/2} in
    descending order, clipped to [0, 1] (floating point can nudge them
    past the ends); min(d_out, d_in) of them."""
    cw = inv_sqrt_psd(cyy, eps) @ cyx.double() @ inv_sqrt_psd(cxx, eps)
    g = cw @ cw.t() if cw.shape[0] <= cw.shape[1] else cw.t() @ cw
    rho2 = torch.linalg.eigvalsh(g).flip(0)
    return rho2.clamp(0.0, 1.0).sqrt()


def nmse_bound(rho: torch.Tensor, h_out: int, h_in: int) -> float:
    """Theorem 3.2: NMSE ≤ (h_out − r) + Σ_{i≤r} (1 − ρ_i²), r = min(h_out, h_in)."""
    r = min(h_out, h_in)
    rho = rho.double()[:r]
    return float((h_out - r) + (1.0 - rho ** 2).sum())


def cca_bound_from_moments(fin: dict) -> tuple[float, torch.Tensor]:
    """Algorithm 2: the bound is computed on (X, Y₊) — the *post-residual*
    attention output — while the LMMSE weights use (X, Y)."""
    rho = canonical_correlations(fin["cxx"], fin["cypx"], fin["cypyp"])
    h_out, h_in = fin["cypx"].shape
    return nmse_bound(rho, h_out, h_in), rho
