"""atan2/asin as the JAX kernel's branchless polynomials (ops/kernel_math.py).

The same polynomial, not torch.atan2, so the plain rollout and the CUDA
kernel (rollout_body.cuh) compute the cost exactly as the TPU kernel does:
~1e-5 rad from the true function, identical to JAX to rounding in f64."""

from __future__ import annotations

import torch

_PI = 3.14159265358979
_HALF_PI = 1.5707963267948966


def _atan_poly(t):
    """atan on [0, 1] (odd polynomial in t)."""
    s = t * t
    p = 0.0208351
    p = p * s - 0.0851330
    p = p * s + 0.1801410
    p = p * s - 0.3302995
    p = p * s + 0.9998660
    return p * t


def atan2(y: torch.Tensor, x: torch.Tensor, precise: bool = False) -> torch.Tensor:
    """Four-quadrant arctangent, branchless (torch.where).

    precise=True adds one Newton step on tan(r)=t over [0, pi/4]."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    t = lo / torch.clamp_min(hi, 1e-30)
    r = _atan_poly(t)
    if precise:
        s, c = torch.sin(r), torch.cos(r)
        r = r + (t * c - s) * c
    r = torch.where(ay > ax, _HALF_PI - r, r)
    r = torch.where(x < 0, _PI - r, r)
    return torch.where(y < 0, -r, r)


def asin(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, -1.0, 1.0)
    return atan2(x, torch.sqrt(torch.clamp_min(1.0 - x * x, 1e-30)))
