"""Equatorial circular-orbit scalars (port of
gr_raytracer_tpu/geometry/circular_orbit.py).

Chart-independent functions of (r_s, a, r[, θ]) in Boyer-Lindquist terms,
geometric units with r_s = 2M. Nothing raises: functions that can fail
return an `ok` mask beside NaN-free masked values.
"""

from __future__ import annotations

import torch

from gr_raytracer_tpu_torch.geometry.base import maximum


def bl_metric_components_at(r_s, a, r, theta):
    """(g_tt, g_tφ, g_φφ) of the BL metric at (r, θ)."""
    ct = torch.cos(theta)
    st = torch.sin(theta)
    sigma = r * r + a * a * ct * ct
    sin2 = st * st
    g_tt = -(1.0 - r_s * r / sigma)
    g_tphi = -a * r_s * r * sin2 / sigma
    g_phiphi = (r * r + a * a + a * a * r_s * r * sin2 / sigma) * sin2
    return g_tt, g_tphi, g_phiphi


def bl_metric_components(r_s, a, r):
    """Equatorial (θ = π/2) BL metric components."""
    one = torch.ones_like(r)
    sigma = r * r
    g_tt = -(1.0 - r_s * r / sigma)
    g_tphi = -a * r_s * r / sigma
    g_phiphi = r * r + a * a + a * a * r_s * r / sigma
    return g_tt, g_tphi, g_phiphi * one


def zamo_killing_coefficients(r_s, a, r, theta):
    """(u^t, u^φ) of the zero-angular-momentum observer at (r, θ)."""
    g_tt, g_tphi, g_phiphi = bl_metric_components_at(r_s, a, r, theta)
    omega = -g_tphi / g_phiphi
    norm = g_tt + 2.0 * g_tphi * omega + g_phiphi * omega * omega
    u_t = 1.0 / torch.sqrt(-norm)
    return u_t, omega * u_t


def angular_velocity(r_s, a, r):
    """Ω = dφ/dt of a prograde circular orbit: √M / (r^1.5 + a√M)."""
    sqrt_m = torch.sqrt(0.5 * r_s)
    return sqrt_m / (torch.pow(r, 1.5) + a * sqrt_m)


def killing_coefficients(r_s, a, r):
    """(u^t, u^φ, ok) of the circular orbit at radius r; masked entries are
    0, never NaN. The clamp away from the marginal orbit keeps the
    derivative finite (see the JAX module for the measured failure)."""
    omega = angular_velocity(r_s, a, r)
    g_tt, g_tphi, g_phiphi = bl_metric_components(r_s, a, r)
    ut_pre = g_tt + 2.0 * omega * g_tphi + omega * omega * g_phiphi
    ok = ut_pre < 0.0
    safe = torch.where(ok, maximum(-ut_pre, 1e-12), 1.0)
    u_t = torch.where(ok, 1.0 / torch.sqrt(safe), 0.0)
    return u_t, omega * u_t, ok


def conserved_energy(r_s, a, r):
    """(E, ok): conserved specific energy of the circular orbit."""
    omega = angular_velocity(r_s, a, r)
    g_tt, g_tphi, _ = bl_metric_components(r_s, a, r)
    u_t, _, ok = killing_coefficients(r_s, a, r)
    return -(g_tt + g_tphi * omega) * u_t, ok


def conserved_angular_momentum(r_s, a, r):
    """(L, ok): conserved specific angular momentum of the circular orbit."""
    omega = angular_velocity(r_s, a, r)
    _, g_tphi, g_phiphi = bl_metric_components(r_s, a, r)
    u_t, _, ok = killing_coefficients(r_s, a, r)
    return (g_tphi + g_phiphi * omega) * u_t, ok


def _cbrt(x):
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def r_isco(r_s, a):
    """Prograde ISCO radius (Bardeen)."""
    a_s = 2.0 * a / r_s
    z1 = 1.0 + _cbrt(1.0 - a_s * a_s) * (_cbrt(1.0 + a_s) + _cbrt(1.0 - a_s))
    z2 = torch.sqrt(3.0 * a_s * a_s + z1 * z1)
    return (3.0 + z2 - torch.sqrt((3.0 - z1) * (3.0 + z1 + 2.0 * z2))) * r_s / 2.0
