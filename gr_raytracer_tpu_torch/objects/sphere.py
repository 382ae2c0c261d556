"""Textured sphere (port of gr_raytracer_tpu/objects/sphere.py).

The march kernels detect the crossings (ops/geodesic_march.py,
csrc/sphere_events.cuh); this object shades them: a static-observer
emitter at a constant temperature. `segment_hit` is the object's own
segment test, with the reference's surface-crossing precondition: the
segment's endpoint radii straddle the surface, so a segment that passes
fully through the sphere is a miss.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from gr_raytracer_tpu_torch.geometry.base import acos_clip, sqrt_nonneg


@dataclass(frozen=True)
class Sphere:
    radius: torch.Tensor
    center: torch.Tensor  # [4] Cartesian (t ignored)
    temperature: torch.Tensor
    texture: object

    def segment_hit(self, cart_prev, cart_new):
        """Test [N] segments (Cartesian 4-points). Returns (hit [N], t [N],
        point_cart [N, 3] in world coordinates, uv [N, 2]); the + root is
        preferred, uv is the local spherical (φ, θ) map."""
        s = cart_prev[..., 1:4] - self.center[1:4]
        e = cart_new[..., 1:4] - self.center[1:4]
        r2 = self.radius * self.radius
        rs = torch.sum(s * s, dim=-1)
        re = torch.sum(e * e, dim=-1)
        crossing = ((rs >= r2) & (re <= r2)) | ((rs <= r2) & (re >= r2))

        d = e - s
        a = torch.sum(d * d, dim=-1)
        b = 2.0 * torch.sum(s * d, dim=-1)
        c = rs - r2
        disc = b * b - 4.0 * a * c
        sqrt_disc = sqrt_nonneg(disc)
        safe_a = torch.where(a != 0.0, a, 1.0)
        t1 = (-b + sqrt_disc) / (2.0 * safe_a)
        t2 = (-b - sqrt_disc) / (2.0 * safe_a)
        t1_ok = (t1 >= 0.0) & (t1 <= 1.0)
        t2_ok = (t2 >= 0.0) & (t2 <= 1.0)
        t = torch.where(t1_ok, t1, t2)
        hit = crossing & (disc >= 0.0) & (t1_ok | t2_ok) & (a != 0.0)

        local = s + t[..., None] * d
        r_loc = torch.sqrt(torch.sum(local * local, dim=-1))
        safe_r = torch.where(r_loc > 0.0, r_loc, 1.0)
        theta = acos_clip(local[..., 2] / safe_r)
        phi = torch.atan2(local[..., 1], local[..., 0])
        u = 1.0 - (math.pi + phi) / (2.0 * math.pi)
        v = theta / math.pi
        world = local + self.center[1:4]
        return hit, t, world, torch.stack([u, v], dim=-1)

    def emitter_velocity(self, geometry, pos_native):
        """Static observer. Returns (u [..., 4], ok [...])."""
        u = geometry.stationary_velocity(pos_native)
        return u, torch.ones(pos_native.shape[:-1], dtype=torch.bool, device=pos_native.device)

    def temperature_at(self, geometry, point_cart4):
        return torch.broadcast_to(self.temperature, point_cart4.shape[:-1])

    def temperature_fail(self, geometry, point_cart4):
        """A constant temperature never rejects a sample."""
        return torch.zeros(point_cart4.shape[:-1], dtype=torch.bool, device=point_cart4.device)
