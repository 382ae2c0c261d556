"""Thin equatorial accretion disc, the annulus in the z = 0 plane (port of
gr_raytracer_tpu/objects/disc.py).

The kernel detects the crossings; this object shades them: the emitter
moves on the local circular orbit and the temperature comes from the disc
model at the geometry's radial coordinate.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gr_raytracer_tpu_torch.geometry import chart as charts


@dataclass(frozen=True)
class Disc:
    inner_radius: torch.Tensor
    outer_radius: torch.Tensor
    temperature_model: object  # TemperatureLUT
    texture: object

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
