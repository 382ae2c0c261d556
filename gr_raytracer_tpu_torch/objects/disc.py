"""Thin equatorial accretion disc, the annulus in the z = 0 plane (port of
gr_raytracer_tpu/objects/disc.py).

The march kernels detect the crossings; the RKF45 path tests each accepted
step with `segment_hit`. Shading: the emitter moves on the local circular
orbit and the temperature comes from the disc model at the geometry's
radial coordinate.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gr_raytracer_tpu_torch.geometry import chart as charts
from gr_raytracer_tpu_torch.geometry.base import dot


@dataclass(frozen=True)
class Disc:
    inner_radius: torch.Tensor
    outer_radius: torch.Tensor
    temperature_model: object  # TemperatureLUT or ConstantTemperature
    texture: object

    def segment_hit(self, cart_prev, cart_new):
        """Test [N] segments (Cartesian 4-points) against the annulus in
        z = 0. Returns (hit [N], t [N], point [N, 3], uv [N, 2]), uv polar
        across the annulus."""
        s = cart_prev[..., 1:4]
        d = cart_new[..., 1:4] - s
        p1 = -s[..., 2]
        p2 = d[..., 2]
        safe_p2 = torch.where(p2 != 0.0, p2, 1.0)
        t = p1 / safe_p2
        in_seg = (t >= 0.0) & (t <= 1.0) & (p2 != 0.0)

        point = s + t[..., None] * d
        rr = dot(point, point)
        in_annulus = (rr >= self.inner_radius**2) & (rr <= self.outer_radius**2)
        phi = torch.atan2(point[..., 1], point[..., 0])
        r_norm = (torch.sqrt(rr) - self.inner_radius) / (self.outer_radius - self.inner_radius)
        u = 0.5 + 0.5 * r_norm * torch.cos(phi)
        v = 0.5 + 0.5 * r_norm * torch.sin(phi)
        return in_seg & in_annulus, t, point, torch.stack([u, v], dim=-1)

    def emitter_velocity(self, geometry, pos_native):
        """Circular-orbit emitter."""
        return geometry.circular_orbit_velocity(pos_native)

    def temperature_at(self, geometry, point_cart4):
        r = geometry.radial_coordinate(point_cart4, charts.CARTESIAN)
        return self.temperature_model.at(r)

    def temperature_fail(self, geometry, point_cart4):
        """True where the temperature model rejects the sample: a hit below
        r_isco with a Novikov-Thorne table is a per-pixel error."""
        r = geometry.radial_coordinate(point_cart4, charts.CARTESIAN)
        return self.temperature_model.below_isco(r)
