"""Accretion-disc temperature models (port of
gr_raytracer_tpu/rendering/temperature.py).

A Novikov-Thorne thin-disc radial profile, built once at scene-build time
and queried through a uniform-grid lookup table, and a constant
temperature (ConstantTemperature; the loader builds none yet). The flux is
    F(r) = −ṁ/(π r₀²) · [ (dΩ/dr) / (√−g (E−ΩL)²) ] · ∫_{isco}^{r} (E−ΩL) (dL/dr) dr
with ṁ calibrated so the peak temperature matches the configured one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from gr_raytracer_tpu_torch.geometry import circular_orbit
from gr_raytracer_tpu_torch.geometry.base import abs_, clip, maximum
from gr_raytracer_tpu_torch.ops.lut import uniform_interp

NUM_LUT_STEPS = 1000
NUM_INTEGRATION_STEPS = 1000
NUM_STEPS_FIND_MAXIMUM = 10
SIGMA_SB = 1.0  # calibrated away
_CHUNK = 100


@dataclass(frozen=True)
class ConstantTemperature:
    """One temperature everywhere; never rejects a sample."""

    value: torch.Tensor

    def at(self, r):
        return torch.broadcast_to(self.value, r.shape)

    def below_isco(self, r):
        return torch.zeros(r.shape, dtype=torch.bool, device=r.device)


@dataclass(frozen=True)
class TemperatureLUT:
    """(r, T) table on a uniform grid, linearly interpolated and clamped at
    both ends; `below_isco` exposes the per-pixel BelowRISCO error."""

    radii: torch.Tensor  # [L]
    temps: torch.Tensor  # [L]
    r_isco: torch.Tensor

    def at(self, r):
        dx = (self.radii[-1] - self.radii[0]) / (self.radii.shape[0] - 1)
        r = clip(r, self.radii[0], self.radii[-1])
        return uniform_interp(r, self.radii[0], dx, self.temps)

    def below_isco(self, r):
        """radius < r_isco, with a dtype-relative tolerance for discs whose
        inner edge sits exactly at the boundary (kerr.toml)."""
        tol = 64.0 * torch.finfo(r.dtype).eps
        return r < self.r_isco * (1.0 - tol)


def _e_omega_l(r_s, a, r):
    e, _ = circular_orbit.conserved_energy(r_s, a, r)
    l, _ = circular_orbit.conserved_angular_momentum(r_s, a, r)
    omega = circular_orbit.angular_velocity(r_s, a, r)
    return e, omega, l


def _derivative(f, r):
    """Exact df/dr by forward-mode AD (the JAX package's jax.jvp)."""
    _, d = torch.func.jvp(f, (r,), (torch.ones_like(r),))
    return d


def _dl_dr(r_s, a, r):
    return _derivative(lambda rr: circular_orbit.conserved_angular_momentum(r_s, a, rr)[0], r)


def _d_omega_dr(r_s, a, r):
    return _derivative(lambda rr: circular_orbit.angular_velocity(r_s, a, rr), r)


def _flux_unit_mdot(r_s, a, r, isco):
    """F(r) at ṁ = 1, vectorized over r. The inner midpoint integral is
    summed in chunks of 100 samples, in the order of the JAX package's scan."""
    e, omega, l = _e_omega_l(r_s, a, r)
    denom = (r * r) * (e - omega * l) ** 2  # √−g = r² equatorial
    prefactor = _d_omega_dr(r_s, a, r) / denom

    dr = (r - isco) / NUM_INTEGRATION_STEPS
    jc = torch.arange(_CHUNK, dtype=r.dtype, device=r.device)
    total = torch.zeros_like(r)
    for j0 in range(0, NUM_INTEGRATION_STEPS, _CHUNK):
        r_prime = isco + (j0 + jc + 0.5) * dr[..., None]
        e_p, omega_p, l_p = _e_omega_l(r_s, a, r_prime)
        integrand = (e_p - omega_p * l_p) * _dl_dr(r_s, a, r_prime)
        total = total + torch.sum(integrand, dim=-1)
    integral = total * dr

    r0 = r_s
    coefficient = -1.0 / (math.pi * r0 * r0)
    return coefficient * prefactor * integral


def build_disc_temperature(r_s, a, target_temperature, outer_radius, dtype, device):
    """Novikov-Thorne table: calibrate ṁ so the peak T equals
    `target_temperature`, then tabulate T(r) on [r_isco, outer]. Co-rotating
    disc: uses |a|."""
    as_ = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    r_s = as_(r_s)
    a_abs = abs_(as_(a))
    target = as_(target_temperature)
    outer = as_(outer_radius)

    isco = circular_orbit.r_isco(r_s, a_abs)
    adjusted = isco + maximum(abs_(isco) * 1e-9, 1e-6)
    outer_eff = torch.where(outer <= isco, adjusted, outer)

    i = torch.arange(NUM_STEPS_FIND_MAXIMUM, dtype=dtype, device=device)
    dr = (outer_eff - isco) / NUM_STEPS_FIND_MAXIMUM
    r_probe = isco + (i + 0.5) * dr
    f_probe = _flux_unit_mdot(r_s, a_abs, r_probe, isco)
    max_r = r_probe[torch.argmax(f_probe)]

    f_unit_max = _flux_unit_mdot(r_s, a_abs, max_r[None], isco)[0]
    m_dot = SIGMA_SB * target**4 / f_unit_max

    k = torch.arange(NUM_LUT_STEPS, dtype=dtype, device=device)
    radii = isco + k * (outer_eff - isco) / (NUM_LUT_STEPS - 1)
    flux = m_dot * _flux_unit_mdot(r_s, a_abs, radii, isco)
    # Double-where: zero at the ISCO grid point with a finite gradient.
    pos = flux / SIGMA_SB > 0.0
    safe_flux = torch.where(pos, flux / SIGMA_SB, 1.0)
    temps = torch.where(pos, torch.pow(safe_flux, 0.25), 0.0)
    return TemperatureLUT(radii=radii, temps=temps, r_isco=isco)
