"""Principal-branch Lambert W on z >= 0 (twin of ``repro/core/lambertw.py``).

Same piecewise initial guess and exactly four Halley steps with the 1e-30
denominator guard, in the reference's op order, so float32 results agree
with the JAX version to a few ulp.
"""

from __future__ import annotations

import torch

_HALLEY_ITERS = 4


def _initial_guess(z: torch.Tensor) -> torch.Tensor:
    """Series z (1 - z + 1.5 z^2) below 1, asymptotic log z - log log z
    above (the 2.718282 guard keeps both logs defined)."""
    safe = torch.clamp_min(z, 2.718282)
    lz = torch.log(safe)
    llz = torch.log(lz)
    asym = lz - llz + llz / lz
    series = z * (1.0 - z + 1.5 * z * z)
    return torch.where(z < 1.0, series, asym)


def lambertw0(z: torch.Tensor) -> torch.Tensor:
    """W0(z) for real z >= 0; z < 0 is clamped to 0."""
    if not z.is_floating_point():
        z = z.to(torch.float32)
    z = torch.clamp_min(z, 0.0)
    w = _initial_guess(z)
    for _ in range(_HALLEY_ITERS):
        ew = torch.exp(w)
        f = w * ew - z
        denom = ew * (w + 1.0) - (w + 2.0) * f / (2.0 * w + 2.0)
        w = w - f / torch.where(denom.abs() < 1e-30, 1e-30, denom)
    return w
