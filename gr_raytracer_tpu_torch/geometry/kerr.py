"""Kerr spacetime in the Kerr-Schild Cartesian chart, signature (−,+,+,+)
(port of gr_raytracer_tpu/geometry/kerr.py).

g_{μν} = η_{μν} + f k_μ k_ν with analytic inverse g^{μν} = η^{μν} − f k^μ k^ν.
The state carries the covariant momentum. Geodesics are Hamiltonian,
H = ½ g^{αβ} p_α p_β: ẋ^μ = g^{μν} p_ν and ṗ_μ = −∂H/∂x^μ, the latter in
the closed form that the march kernel's plain version uses
(ops/geodesic_march.py `_rhs`; the JAX package differentiates H).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gr_raytracer_tpu_torch.geometry import chart as charts
from gr_raytracer_tpu_torch.geometry import circular_orbit
from gr_raytracer_tpu_torch.geometry.base import (
    TRAPPED_ORBIT_RADIUS_FACTOR,
    Geometry,
    acos_clip,
    gram_schmidt,
    lower,
    maximum,
    unit_time_vector,
)

_ETA_DIAG = (-1.0, 1.0, 1.0, 1.0)


def _eta(x):
    # Filled on the device (no host copy), so that it can be captured in a
    # CUDA graph (rendering/integrator.py).
    diag = torch.ones(4, dtype=x.dtype, device=x.device)
    diag.narrow(0, 0, 1).fill_(_ETA_DIAG[0])
    return torch.diag(diag)


def _f_and_k(radius, a, x):
    """Kerr-Schild scalar f and covector k at Cartesian x."""
    xs, ys, zs = x[..., 1], x[..., 2], x[..., 3]
    r_sq = charts.bl_radius_sq_from_cartesian(a, xs, ys, zs)
    r = torch.sqrt(r_sq)
    f = (r * r_sq * radius) / (r_sq * r_sq + a * a * zs * zs)
    k_t = torch.ones_like(r)
    k_x = (r * xs + a * ys) / (r_sq + a * a)
    k_y = (r * ys - a * xs) / (r_sq + a * a)
    k_z = zs / r
    return f, torch.stack([k_t, k_x, k_y, k_z], dim=-1)


def kerr_metric(radius, a, x):
    """Covariant Kerr-Schild metric, [..., 4, 4]."""
    f, k = _f_and_k(radius, a, x)
    return _eta(x) + f[..., None, None] * k[..., :, None] * k[..., None, :]


def kerr_metric_contravariant(radius, a, x):
    """Analytic inverse: η^{μν} − f k^μ k^ν."""
    f, k = _f_and_k(radius, a, x)
    k_up = torch.cat([-k[..., :1], k[..., 1:]], dim=-1)
    return _eta(x) - f[..., None, None] * k_up[..., :, None] * k_up[..., None, :]


@dataclass(frozen=True)
class KerrSolver:
    radius: torch.Tensor
    a: torch.Tensor

    @property
    def chart(self):
        return charts.CARTESIAN

    def rhs(self, y):
        """dy/dλ for y = [x | p_cov], [..., 8]."""
        from gr_raytracer_tpu_torch.ops.geodesic_march import _rhs

        return _rhs(self.radius, self.a, y.movedim(-1, 0)).movedim(0, -1)

    def initial_state(self, x, p):
        """Lower the index: the state carries covariant momentum."""
        return torch.cat([x, lower(kerr_metric(self.radius, self.a, x), p)], dim=-1)

    def momentum(self, y):
        return lower(kerr_metric_contravariant(self.radius, self.a, y[..., :4]), y[..., 4:8])


@dataclass(frozen=True)
class Kerr(Geometry):
    radius: torch.Tensor  # r_s = 2M
    a: torch.Tensor
    horizon_epsilon: torch.Tensor

    @property
    def chart(self):
        return charts.CARTESIAN

    @property
    def spin(self):
        return self.a

    def signature(self):
        return _ETA_DIAG

    def metric(self, x):
        return kerr_metric(self.radius, self.a, x)

    def tetrad(self, x):
        """ADM lapse/shift frame orthonormalized by metric Gram-Schmidt."""
        f, k = _f_and_k(self.radius, self.a, x)
        alpha = 1.0 / torch.sqrt(1.0 + f)
        bfac = f / (1.0 + f)
        e_t = torch.stack(
            [
                1.0 / alpha,
                -bfac * k[..., 1] / alpha,
                -bfac * k[..., 2] / alpha,
                -bfac * k[..., 3] / alpha,
            ],
            dim=-1,
        )
        eye = torch.eye(4, dtype=x.dtype, device=x.device).expand(x.shape[:-1] + (4, 4))
        vectors = torch.cat([e_t[..., None, :], eye[..., 1:, :]], dim=-2)
        return gram_schmidt(self, x, vectors)

    def inside_horizon(self, x):
        m = 0.5 * self.radius
        r = torch.sqrt(charts.bl_radius_sq_from_cartesian(self.a, x[..., 1], x[..., 2], x[..., 3]))
        rp = m + torch.sqrt(maximum(m * m - self.a * self.a, 0.0))
        over_extremal = torch.abs(self.a) > m
        return (r <= rp + self.horizon_epsilon) & ~over_extremal

    def closed_orbit(self, x, step_index, max_steps):
        r = self.radial_coordinate(x, charts.CARTESIAN)
        return (step_index == max_steps - 1) & (r < TRAPPED_ORBIT_RADIUS_FACTOR * self.radius)

    def radial_coordinate(self, x, chart):
        if chart == charts.CARTESIAN:
            return torch.sqrt(
                charts.bl_radius_sq_from_cartesian(self.a, x[..., 1], x[..., 2], x[..., 3])
            )
        return x[..., 1]  # BL r

    def stationary_velocity(self, x):
        f, _ = _f_and_k(self.radius, self.a, x)
        u = torch.zeros_like(x)
        u[..., 0] = 1.0 / torch.sqrt(1.0 - f)
        return u

    def zamo_velocity(self, x):
        xs, ys, zs = x[..., 1], x[..., 2], x[..., 3]
        r = torch.sqrt(charts.bl_radius_sq_from_cartesian(self.a, xs, ys, zs))
        theta = torch.where(
            r > 0.0,
            acos_clip(zs / torch.where(r > 0.0, r, 1.0)),
            0.0,
        )
        u_t, u_phi = circular_orbit.zamo_killing_coefficients(self.radius, self.a, r, theta)
        return u_t[..., None] * unit_time_vector(x) + u_phi[..., None] * self.axial_killing(x)

    def orbit_coefficients_at_radius(self, r):
        return circular_orbit.killing_coefficients(self.radius, self.a, r)

    def axial_killing(self, x):
        """∂_φ = x ∂_y − y ∂_x."""
        zero = torch.zeros_like(x[..., 0])
        return torch.stack([zero, -x[..., 2], x[..., 1], zero], dim=-1)

    def make_solver(self, x0, p0):
        return KerrSolver(radius=self.radius, a=self.a)

    def constants_of_motion(self, x, p):
        """E = −p_t (covariant) and L_z = −y p_x + x p_y."""
        p_cov = lower(kerr_metric(self.radius, self.a, x), p)
        return {
            "E": -p_cov[..., 0],
            "L_z": -x[..., 2] * p_cov[..., 1] + x[..., 1] * p_cov[..., 2],
        }
