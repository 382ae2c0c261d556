"""Schwarzschild spacetime in the spherical chart (t, r, θ, φ), signature
(+,−,−,−) (port of gr_raytracer_tpu/geometry/schwarzschild.py).

The kernel path marches Schwarzschild scenes as Boyer-Lindquist Kerr with
a = 0, whose chart is this spherical one (rendering/fast_path.py); this
class serves the camera, the redshift scalars and the shading. Its own
geodesic right-hand side belongs to the RKF45 path, which is not yet
ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gr_raytracer_tpu_torch.geometry import chart as charts
from gr_raytracer_tpu_torch.geometry import circular_orbit
from gr_raytracer_tpu_torch.geometry.base import TRAPPED_ORBIT_RADIUS_FACTOR, Geometry


@dataclass(frozen=True)
class SchwarzschildSolver:
    radius: torch.Tensor

    @property
    def chart(self):
        return charts.SPHERICAL

    def rhs(self, y):
        """The geodesic equations, [..., 8] -> [..., 8]."""
        r, theta = y[..., 1], y[..., 2]
        v_t, v_r, v_theta, v_phi = y[..., 4], y[..., 5], y[..., 6], y[..., 7]
        a = 1.0 - self.radius / r
        a_prime = self.radius / (r * r)
        ap_over_a = a_prime / a
        st, ct = torch.sin(theta), torch.cos(theta)
        acc_t = -ap_over_a * v_t * v_r
        acc_r = (
            -0.5 * a * a_prime * v_t * v_t
            + 0.5 * ap_over_a * v_r * v_r
            + a * r * (v_theta * v_theta + v_phi * v_phi * st * st)
        )
        # A tensor dividend: torch takes a Python scalar over a tensor as the
        # tensor's reciprocal times the scalar, one more rounding.
        two_over_r = torch.full_like(r, 2.0) / r
        acc_theta = -two_over_r * v_r * v_theta + st * ct * v_phi * v_phi
        acc_phi = -two_over_r * v_phi * v_r - 2.0 * (ct / st) * v_theta * v_phi
        return torch.stack([v_t, v_r, v_theta, v_phi, acc_t, acc_r, acc_theta, acc_phi], dim=-1)

    def initial_state(self, x, p):
        return torch.cat([x, p], dim=-1)

    def momentum(self, y):
        return y[..., 4:8]


@dataclass(frozen=True)
class Schwarzschild(Geometry):
    radius: torch.Tensor  # r_s = 2M
    horizon_epsilon: torch.Tensor

    @property
    def chart(self):
        return charts.SPHERICAL

    def signature(self):
        return (1.0, -1.0, -1.0, -1.0)

    def metric(self, x):
        r, theta = x[..., 1], x[..., 2]
        a = 1.0 - self.radius / r
        st = torch.sin(theta)
        diag = torch.stack([a, -1.0 / a, -r * r, -r * r * (st * st)], dim=-1)
        return diag[..., :, None] * torch.eye(4, dtype=x.dtype, device=x.device)

    def inner_product(self, x, v, w):
        r, theta = x[..., 1], x[..., 2]
        a = 1.0 - self.radius / r
        st = torch.sin(theta)
        return (
            a * v[..., 0] * w[..., 0]
            - v[..., 1] * w[..., 1] / a
            - r * r * v[..., 2] * w[..., 2]
            - r * r * (st * st) * v[..., 3] * w[..., 3]
        )

    def tetrad(self, x):
        """Freely-falling-observer tetrad: t = (1/a, −√(r_s/r), 0, 0), x = e_φ,
        y = e_θ, z = radial."""
        r, theta = x[..., 1], x[..., 2]
        rr0 = self.radius / r
        a = 1.0 - rr0
        zero = torch.zeros_like(r)
        sq = torch.sqrt(rr0)
        e_t = torch.stack([1.0 / a, -sq, zero, zero], dim=-1)
        e_x = torch.stack([zero, zero, zero, 1.0 / (r * torch.sin(theta))], dim=-1)
        e_y = torch.stack([zero, zero, 1.0 / r, zero], dim=-1)
        e_z = torch.stack([-sq / a, torch.ones_like(r), zero, zero], dim=-1)
        return torch.stack([e_t, e_x, e_y, e_z], dim=-2)

    def inside_horizon(self, x):
        return x[..., 1] <= self.radius + self.horizon_epsilon

    def closed_orbit(self, x, step_index, max_steps):
        return (step_index == max_steps - 1) & (x[..., 1] < TRAPPED_ORBIT_RADIUS_FACTOR * self.radius)

    def radial_coordinate(self, x, chart):
        if chart == charts.CARTESIAN:
            return torch.sqrt(x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2] + x[..., 3] * x[..., 3])
        return x[..., 1]

    def stationary_velocity(self, x):
        a = 1.0 - self.radius / x[..., 1]
        u = torch.zeros_like(x)
        u[..., 0] = 1.0 / torch.sqrt(a)
        return u

    def zamo_velocity(self, x):
        return self.stationary_velocity(x)

    def orbit_coefficients_at_radius(self, r):
        return circular_orbit.killing_coefficients(self.radius, torch.zeros_like(self.radius), r)

    def axial_killing(self, x):
        e_phi = torch.zeros_like(x)
        e_phi[..., 3] = 1.0
        return e_phi

    def make_solver(self, x0, p0):
        return SchwarzschildSolver(radius=self.radius)

    def constants_of_motion(self, x, p):
        """E = a v^t and L_z = −r² sin²θ v^φ."""
        r, theta = x[..., 1], x[..., 2]
        a = 1.0 - self.radius / r
        st = torch.sin(theta)
        return {"E": a * p[..., 0], "L_z": -r * r * (st * st) * p[..., 3]}
