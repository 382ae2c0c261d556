"""Coordinate charts and conversions (port of gr_raytracer_tpu/geometry/chart.py).

Points and four-vectors are [..., 4] tensors with t first; the chart is
static metadata carried by the geometry.

  * CARTESIAN        (t, x, y, z): the Kerr-Schild chart
  * SPHERICAL        (t, r, θ, φ) with x = r sinθ cosφ, ...: Schwarzschild
  * BOYER_LINDQUIST  (t, r, θ, φ) with the Kerr-Schild embedding
        x = (r cosφ − a sinφ) sinθ,  y = (r sinφ + a cosφ) sinθ,  z = r cosθ

The BL↔KS Jacobian (`jacobian_bl_to_cartesian`) serves only the invariant
tracking of the RKF45 path and is not yet ported.
"""

from __future__ import annotations

import math

import torch

from gr_raytracer_tpu_torch.geometry.base import acos_clip

CARTESIAN = "cartesian"
SPHERICAL = "spherical"
BOYER_LINDQUIST = "boyer_lindquist"


def wrap_theta(theta):
    """Wrap an angle to [0, π)."""
    return torch.remainder(theta, math.pi)


def wrap_phi(phi):
    """Wrap an angle to [−π, π)."""
    return torch.remainder(phi + math.pi, 2.0 * math.pi) - math.pi


def spherical_to_cartesian(x):
    t, r, theta, phi = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    return torch.stack([t, r * st * cp, r * st * sp, r * ct], dim=-1)


def cartesian_to_spherical(p):
    t, x, y, z = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    r = torch.sqrt(x * x + y * y + z * z)
    safe_r = torch.where(r > 0.0, r, 1.0)
    theta = torch.where(r > 0.0, acos_clip(z / safe_r), 0.0)
    phi = torch.where(r > 0.0, torch.arctan2(y, x), 0.0)
    return torch.stack([t, r, theta, phi], dim=-1)


def bl_radius_sq_from_cartesian(a, x, y, z):
    """Boyer-Lindquist r² from Cartesian via the Kerr-Schild implicit relation
    r⁴ − (ρ² − a²) r² − a² z² = 0."""
    rho_sq = x * x + y * y + z * z
    d = rho_sq - a * a
    return 0.5 * (d + torch.sqrt(d * d + 4.0 * a * a * z * z))


def bl_to_cartesian(a, p):
    t, r, theta, phi = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    x = (r * cp - a * sp) * st
    y = (r * sp + a * cp) * st
    z = r * ct
    return torch.stack([t, x, y, z], dim=-1)


def cartesian_to_bl(a, p):
    """Cartesian -> BL with φ = atan2(ry − ax, rx + ay)."""
    t, x, y, z = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    r = torch.sqrt(bl_radius_sq_from_cartesian(a, x, y, z))
    safe_r = torch.where(r > 0.0, r, 1.0)
    theta = torch.where(r > 0.0, acos_clip(z / safe_r), 0.0)
    phi = torch.arctan2(r * y - a * x, r * x + a * y)
    return torch.stack([t, r, theta, phi], dim=-1)


def _unknown(chart):
    return ValueError(f"unknown chart {chart!r}")


def to_cartesian(x, chart, a=0.0):
    if chart == CARTESIAN:
        return x
    if chart == SPHERICAL:
        return spherical_to_cartesian(x)
    if chart == BOYER_LINDQUIST:
        return bl_to_cartesian(a, x)
    raise _unknown(chart)


def from_cartesian(p, chart, a=0.0):
    if chart == CARTESIAN:
        return p
    if chart == SPHERICAL:
        return cartesian_to_spherical(p)
    if chart == BOYER_LINDQUIST:
        return cartesian_to_bl(a, p)
    raise _unknown(chart)


def get_as_spherical(x, chart):
    """(r, θ, φ) view of a point: Cartesian converts; spherical and BL return
    their own components with θ wrapped to [0, π) and φ to [−π, π)."""
    if chart == CARTESIAN:
        s = cartesian_to_spherical(x)
        return s[..., 1], s[..., 2], s[..., 3]
    if chart in (SPHERICAL, BOYER_LINDQUIST):
        return x[..., 1], wrap_theta(x[..., 2]), wrap_phi(x[..., 3])
    raise _unknown(chart)


def spatial_vector_to_cartesian(position, vector, chart, a=0.0):
    """Contravariant spatial components of `vector` at `position`, pushed
    forward to the Cartesian frame, [..., 3] (the camera's handedness
    triple product). For spherical and BL charts the (r, θ, φ) of the
    position is taken through get_as_spherical."""
    if chart == CARTESIAN:
        return vector[..., 1:4]
    if chart not in (SPHERICAL, BOYER_LINDQUIST):
        raise _unknown(chart)
    r, theta, phi = get_as_spherical(position, chart)
    dr, dtheta, dphi = vector[..., 1], vector[..., 2], vector[..., 3]
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    if chart == SPHERICAL:
        vx = st * cp * dr + r * ct * cp * dtheta - r * st * sp * dphi
        vy = st * sp * dr + r * ct * sp * dtheta + r * st * cp * dphi
        vz = ct * dr - r * st * dtheta
    else:  # the spatial part of the BL Jacobian
        vx = st * cp * dr + (r * cp - a * sp) * ct * dtheta + (-r * sp - a * cp) * st * dphi
        vy = st * sp * dr + (r * sp + a * cp) * ct * dtheta + (r * cp - a * sp) * st * dphi
        vz = ct * dr - r * st * dtheta
    return torch.stack([vx, vy, vz], dim=-1)
