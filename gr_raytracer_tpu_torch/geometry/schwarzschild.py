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
from gr_raytracer_tpu_torch.geometry.base import Geometry


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
        raise NotImplementedError(
            "the Schwarzschild RKF45 solver is not yet ported; the kernel path marches "
            "Schwarzschild as KerrBL with a = 0"
        )
