"""Relativistic pinhole camera (port of gr_raytracer_tpu/rendering/camera.py).

The geometry's tetrad at the camera is rotated by intrinsic angles (φ
pre-roll, θ tilt, ψ roll), Lorentz-boosted to the camera four-velocity, and
each pixel's null direction is built on the image plane:

    w = e_z + i' e_x + j' e_y
    N = −e_z + 2 w / (1 + i'² + j'²)
    p = N − e_t      (past-directed: the traced photon arrives at the camera)
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from gr_raytracer_tpu_torch.geometry import chart as charts
from gr_raytracer_tpu_torch.geometry.base import validate_tetrad


@dataclass(frozen=True)
class Camera:
    position: torch.Tensor  # [4], geometry-native chart
    velocity: torch.Tensor  # [4]
    tetrad: torch.Tensor  # [4, 4] rows (t, x, y, z), boosted
    spatial_handedness: torch.Tensor  # ±1
    alpha: float  # vertical field of view (radians)
    rows: int
    columns: int
    spatial_signature: float
    chart: str


def _rotate(v1, v2, angle):
    """Rotate the (v1, v2) plane by `angle`."""
    c, s = torch.cos(angle), torch.sin(angle)
    return c * v1 + s * v2, -s * v1 + c * v2


def _spatial_handedness(geometry, position, tetrad):
    """Sign of the spatial triple product x·(y×z) in Cartesian components,
    with the chart-convention fallback for degenerate values."""
    chart = geometry.chart
    a = geometry.spin
    x = charts.spatial_vector_to_cartesian(position, tetrad[..., 1, :], chart, a)
    y = charts.spatial_vector_to_cartesian(position, tetrad[..., 2, :], chart, a)
    z = charts.spatial_vector_to_cartesian(position, tetrad[..., 3, :], chart, a)
    triple = torch.sum(x * torch.linalg.cross(y, z), dim=-1)
    fallback = 1.0 if chart == charts.CARTESIAN else -1.0
    degenerate = ~torch.isfinite(triple) | (torch.abs(triple) <= 1e-12)
    sign = torch.where(triple >= 0.0, 1.0, -1.0).to(triple.dtype)
    return torch.where(degenerate, fallback, sign)


def build_camera(
    geometry, position, velocity, alpha, rows, columns, phi=0.0, theta=0.0, psi=0.0,
    validate=True,
):
    """Rotate the geometry tetrad, boost, orient. `position`/`velocity` are
    [4] tensors in the geometry's native chart; with `validate` the pre- and
    post-boost tetrads are checked for orthonormality."""
    as_ = lambda v: torch.as_tensor(v, dtype=position.dtype, device=position.device)
    tet = geometry.tetrad(position)
    if validate:
        validate_tetrad(geometry, position, tet)

    e_t, e_x, e_y, e_z = tet[..., 0, :], tet[..., 1, :], tet[..., 2, :], tet[..., 3, :]
    a_prime, b_prime = _rotate(e_x, e_y, as_(phi))
    z_rot, a_two_prime = _rotate(e_z, a_prime, as_(theta))
    x_rot, y_rot = _rotate(a_two_prime, b_prime, as_(psi))
    rotated = torch.stack([e_t, x_rot, y_rot, z_rot], dim=-2)

    lam = geometry.lorentz_transformation(position, velocity)
    boosted = torch.einsum("...ij,...kj->...ki", lam, rotated)
    if validate:
        validate_tetrad(geometry, position, boosted)

    handedness = _spatial_handedness(geometry, position, boosted)
    sig = geometry.signature()
    if not (abs(sig[1] - sig[2]) < 1e-12 and abs(sig[2] - sig[3]) < 1e-12):
        raise ValueError("the camera needs equal spatial signature entries")
    return Camera(
        position=position,
        velocity=velocity,
        tetrad=boosted,
        spatial_handedness=handedness,
        alpha=float(alpha),
        rows=int(rows),
        columns=int(columns),
        spatial_signature=sig[3],
        chart=geometry.chart,
    )


def pixel_directions(camera, row_f, col_f):
    """Null directions [..., 4] for (possibly fractional, 0-based) pixel
    coordinates; square pixels, alpha is the vertical field of view."""
    tan_half = math.tan(camera.alpha / 2.0)
    scale = 2.0 * tan_half / camera.rows
    i_prime = camera.spatial_handedness * scale * ((col_f + 1.0) - (camera.columns + 1.0) / 2.0)
    j_prime = scale * ((row_f + 1.0) - (camera.rows + 1.0) / 2.0)
    e_x = camera.tetrad[1]
    e_y = camera.tetrad[2]
    e_z = camera.tetrad[3]
    w = e_z + i_prime[..., None] * e_x + j_prime[..., None] * e_y
    denom = 1.0 + i_prime * i_prime + j_prime * j_prime
    return -e_z + 2.0 * w / denom[..., None]


def pixel_rays(camera, row_f, col_f):
    """(positions [..., 4], momenta [..., 4]); momenta are past-directed."""
    direction = pixel_directions(camera, row_f, col_f)
    momentum = direction - camera.tetrad[0]
    position = camera.position.expand(momentum.shape)
    return position, momentum
