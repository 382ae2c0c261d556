"""Built-in scene preset: the flagship Kerr blackbody-disc scene (port of
gr_raytracer_tpu/presets.py).

The builder is a function of a parameter dict of tensors (the scene's
"weights"): metric parameters, camera pose, disc geometry and temperature.
`params_from_numpy` carries the JAX package's parameter pytree across, so
both builders compute the same scene.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gr_raytracer_tpu_torch.geometry.kerr import Kerr
from gr_raytracer_tpu_torch.objects.disc import Disc
from gr_raytracer_tpu_torch.rendering import camera as cam
from gr_raytracer_tpu_torch.rendering import integrator as integ
from gr_raytracer_tpu_torch.rendering import scene as scn
from gr_raytracer_tpu_torch.rendering.temperature import build_disc_temperature
from gr_raytracer_tpu_torch.rendering.texture import BlackBodyMap, CheckerMap

_DEFAULTS = {
    "radius": 1.0,
    "a": 0.45,
    "camera_position": [0.0, -10.0, 0.0, -0.5],
    "camera_phi": 0.0,
    "camera_theta": 1.52,
    "camera_psi": -1.57,
    "disc_inner": 1.0,  # scaled by sqrt(r_isco² + a²) at build
    "disc_outer": 6.0,
    "disc_temperature": 10000.0,
    "celestial_temperature": 0.0,
}


def kerr_flagship_params(dtype, device):
    """Default parameters (r_s = 1, a = 0.45, camera at (-10, 0, -0.5)
    turned to face the hole)."""
    return params_from_numpy(_DEFAULTS, dtype, device)


def params_from_numpy(d, dtype, device):
    """A parameter dict of array-likes (e.g. the JAX kerr_flagship_params
    pytree as numpy arrays) -> the port's dict of tensors."""
    return {k: torch.as_tensor(np.array(v), dtype=dtype, device=device) for k, v in d.items()}


def build_kerr_flagship(
    params,
    rows: int,
    cols: int,
    max_steps: int = 2000,
    max_radius: float = 40.0,
    step_size: float = 0.05,
    epsilon: float = 1e-5,
    validate: bool = False,
    differentiable: bool = False,
):
    """Kerr (Kerr-Schild) + blackbody Novikov-Thorne disc + checker sky.
    differentiable=True takes the RKF45 path's reverse-mode loop
    (IntegrationConfig.differentiable) for `scene.trace_rays`."""
    radius = params["radius"]
    dtype, device = radius.dtype, radius.device
    geometry = Kerr(
        radius=radius,
        a=params["a"],
        horizon_epsilon=torch.tensor(1e-3, dtype=dtype, device=device),
    )
    position = params["camera_position"]
    velocity = geometry.stationary_velocity(position)
    camera = cam.build_camera(
        geometry, position, velocity, alpha=math.pi / 4, rows=rows, columns=cols,
        phi=params["camera_phi"], theta=params["camera_theta"], psi=params["camera_psi"],
        validate=validate,
    )
    temp_model = build_disc_temperature(
        radius, params["a"], params["disc_temperature"], params["disc_outer"], dtype, device
    )
    # The minimum Cartesian inner radius that keeps every sample at or above
    # r_isco is sqrt(isco² + a²).
    disc = Disc(
        inner_radius=torch.sqrt(temp_model.r_isco**2 + params["a"] ** 2) * params["disc_inner"],
        outer_radius=params["disc_outer"],
        temperature_model=temp_model,
        texture=BlackBodyMap.create(3.0, dtype, device),
    )
    celestial = CheckerMap.from_srgb(0.0, 36.0, 18.0, (8, 8, 24), (2, 2, 8), dtype, device)
    cfg = integ.IntegrationConfig(
        max_radius=float(max_radius),
        step_size=float(step_size),
        epsilon=float(epsilon),
        max_steps=max_steps,
        differentiable=differentiable,
    )
    return scn.Scene(
        geometry=geometry,
        camera=camera,
        objects=(disc,),
        celestial_map=celestial,
        celestial_temperature=params["celestial_temperature"],
        integration=cfg,
    )
