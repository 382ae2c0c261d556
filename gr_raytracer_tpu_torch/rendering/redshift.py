"""Transport-free redshift via conserved Killing scalars (port of
gr_raytracer_tpu/rendering/redshift.py).

observer_energy = <u_cam, p>, p_t = <∂_t, p> and p_φ = <∂_φ, p> are taken
once per ray at the camera; by conservation they hold anywhere along the
geodesic, so g = E_obs/E_em needs no parallel transport.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gr_raytracer_tpu_torch.geometry.base import unit_time_vector


@dataclass(frozen=True)
class RayFrequencyData:
    observer_energy: torch.Tensor  # [N]
    p_t: torch.Tensor  # [N]
    p_phi: torch.Tensor  # [N]


def ray_frequency_data(geometry, x, p, camera_velocity):
    """Per-ray conserved scalars at the camera."""
    vel = camera_velocity.expand(p.shape)
    observer_energy = geometry.inner_product(x, vel, p)
    p_t = geometry.inner_product(x, unit_time_vector(p), p)
    p_phi = geometry.inner_product(x, geometry.axial_killing(x), p)
    return RayFrequencyData(observer_energy=observer_energy, p_t=p_t, p_phi=p_phi)
