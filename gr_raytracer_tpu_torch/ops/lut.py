"""Uniform-grid lookup-table interpolation (port of gr_raytracer_tpu/ops/lut.py).

The blackbody log-T grid and the Novikov-Thorne radial grid are uniform, so
the bracketing index is one multiply and two gathers per lookup.
"""

from __future__ import annotations

import torch

from gr_raytracer_tpu_torch.geometry.base import clip


def uniform_interp(x, x0, dx, values):
    """Linear interpolation of `values` sampled at x0 + k·dx, clamped at the
    ends. x: [...] queries; values: [L] or [L, C]. Returns [...] or [..., C].
    A NaN query (a table on a NaN grid: the Novikov-Thorne table of a hole
    with r_s = 0) reads index 0, as XLA's float-to-int conversion does, and
    interpolates to NaN."""
    length = values.shape[0]
    t = (x - x0) / dx
    idx = torch.nan_to_num(torch.clamp(torch.floor(t), 0, length - 2), nan=0.0).to(torch.int64)
    frac = clip(t - idx, 0.0, 1.0)
    lo = values[idx]
    hi = values[idx + 1]
    if values.ndim == 2:
        frac = frac[..., None]
    return lo + frac * (hi - lo)
