"""Streaming first/second-moment accumulation for NBL calibration.

Port of ``repro.core.moments``. The paper (App. D) forms X, Y ∈ R^{(s·t)×d}
by stacking all calibration tokens and computes covariances in one shot;
here raw moments are accumulated streamingly, one batch at a time:

    n, Σx, Σy, Σy₊, ΣxᵀX, Σy x᳕, Σy₊x᳕, Σy₊y₊᳕, Σcos(x, y₊)

with y₊ = y + x (Algorithm 2). Covariances are finalized once, in float64
(``finalize``). ``Σcos`` streams the DROP baseline's cosine-distance
criterion (1 − E[cos(x, y₊)]) so both selection criteria come from one
pass.

The four d×d sums go through K4 (``kernels.cov_accum``), which updates the
accumulators IN PLACE: ``update_moments`` mutates and returns the state it
is given (the JAX version returns a new state). Everything else is plain
torch in float32. The accumulation order is fixed by the data order and K4
sums in a fixed order, so the moments are bit-identical from run to run on
one device.

The JAX package's ``psum_moments`` (a cross-shard ``psum``) has no meaning
on one card and is not ported (ROADMAP.md §A).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.cov_accum import cov_accum


def init_moments(d_in: int, d_out: int, *, device="cuda",
                 dtype=torch.float32) -> dict:
    device = resolve_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {
        "n": z(), "sx": z(d_in), "sy": z(d_out), "syp": z(d_out),
        "sxx": z(d_in, d_in), "syx": z(d_out, d_in),
        "sypx": z(d_out, d_in), "sypyp": z(d_out, d_out), "scos": z(),
    }


def update_moments(state: dict, x: torch.Tensor, y: torch.Tensor) -> dict:
    """Accumulate one batch into ``state`` in place and return it. x:
    (..., d_in), y: (..., d_out) — the attention (or block) input and its
    pre-residual output."""
    d_in, d_out = x.shape[-1], y.shape[-1]
    xt = x.reshape(-1, d_in).float().contiguous()
    yt = y.reshape(-1, d_out).float().contiguous()
    yp = yt + xt if d_in == d_out else yt

    nrm = torch.linalg.vector_norm(xt, dim=-1) \
        * torch.linalg.vector_norm(yp, dim=-1)
    cos = (xt * yp).sum(-1) / nrm.clamp_min(1e-20)

    state["n"] += xt.shape[0]
    state["sx"] += xt.sum(0)
    state["sy"] += yt.sum(0)
    state["syp"] += yp.sum(0)
    cov_accum(state["sxx"], xt)
    cov_accum(state["syx"], xt, yt)
    cov_accum(state["sypx"], xt, yp)
    cov_accum(state["sypyp"], yp)
    state["scos"] += cos.sum()
    return state


def merge_moments(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def finalize(state: dict) -> dict:
    """float64 means and (unbiased) covariances, on the state's device."""
    s = {k: v.double() for k, v in state.items()}
    n = float(s["n"])
    if n <= 1:
        raise ValueError("need >1 calibration tokens")
    ex, ey, eyp = s["sx"] / n, s["sy"] / n, s["syp"] / n
    c = 1.0 / (n - 1.0)
    return {
        "n": n,
        "ex": ex, "ey": ey, "eyp": eyp,
        "cxx": c * (s["sxx"] - n * torch.outer(ex, ex)),
        "cyx": c * (s["syx"] - n * torch.outer(ey, ex)),
        "cypx": c * (s["sypx"] - n * torch.outer(eyp, ex)),
        "cypyp": c * (s["sypyp"] - n * torch.outer(eyp, eyp)),
        "cos_mean": float(s["scos"]) / n,
    }
