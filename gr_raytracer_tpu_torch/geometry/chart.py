"""Coordinate charts and conversions (port of gr_raytracer_tpu/geometry/chart.py).

Points and four-vectors are [..., 4] tensors with t first; the chart is
static metadata carried by the geometry. This slice ports the Kerr-Schild
(Cartesian) chart; the spherical and Boyer-Lindquist charts come with the
geometries that use them.
"""

from __future__ import annotations

import torch

CARTESIAN = "cartesian"


def _not_ported(chart):
    return NotImplementedError(f"chart {chart!r} is not yet ported")


def cartesian_to_spherical(p):
    t, x, y, z = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    r = torch.sqrt(x * x + y * y + z * z)
    safe_r = torch.where(r > 0.0, r, 1.0)
    theta = torch.where(r > 0.0, torch.arccos(torch.clamp(z / safe_r, -1.0, 1.0)), 0.0)
    phi = torch.where(r > 0.0, torch.arctan2(y, x), 0.0)
    return torch.stack([t, r, theta, phi], dim=-1)


def bl_radius_sq_from_cartesian(a, x, y, z):
    """Boyer-Lindquist r² from Cartesian via the Kerr-Schild implicit relation
    r⁴ − (ρ² − a²) r² − a² z² = 0."""
    rho_sq = x * x + y * y + z * z
    d = rho_sq - a * a
    return 0.5 * (d + torch.sqrt(d * d + 4.0 * a * a * z * z))


def from_cartesian(p, chart, a=0.0):
    if chart == CARTESIAN:
        return p
    raise _not_ported(chart)


def get_as_spherical(x, chart):
    """(r, θ, φ) view of a point."""
    if chart == CARTESIAN:
        s = cartesian_to_spherical(x)
        return s[..., 1], s[..., 2], s[..., 3]
    raise _not_ported(chart)


def spatial_vector_to_cartesian(position, vector, chart, a=0.0):
    """Contravariant spatial components of `vector` in the Cartesian frame."""
    if chart == CARTESIAN:
        return vector[..., 1:4]
    raise _not_ported(chart)
