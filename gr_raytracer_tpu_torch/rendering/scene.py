"""Scene, deferred event shading and the ordered alpha fold (port of
gr_raytracer_tpu/rendering/scene.py).

The march records object crossings into a bounded per-ray event buffer;
shading runs afterwards as one batched pass over that buffer, then a
front-to-back premultiplied fold composites the events over the terminal
color (exact against the reference's back-to-front blend over opaque black).

The safe-park and double-where guards below keep masked lanes finite: a
masked inf still turns a backward pass into 0·inf = NaN.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from gr_raytracer_tpu_torch.geometry import chart as charts
from gr_raytracer_tpu_torch.objects.volumetric_disc import VolumetricDisc
from gr_raytracer_tpu_torch.rendering import integrator as integ
from gr_raytracer_tpu_torch.rendering.integrator import IntegrationConfig

# Ray classification.
ESCAPED = 0
CAPTURED = 1
HIT = 2

# Event payload layout (ops/geodesic_march.py): [point_cart(3) | p_interp(4)
# | uv(2) | seg_dir(3)].


@dataclass(frozen=True)
class AdaptiveSamplingConfig:
    """Adaptive supersampling knobs."""

    enabled: bool = True
    samples_per_axis: int = 4
    luminance_contrast_threshold: float = 0.15
    opacity_contrast_threshold: float = 0.1
    minimum_luminance: Optional[float] = None
    object_hit_opacity_threshold: float = 0.5
    exclude_background_contrast: bool = True

    def validate(self):
        if self.samples_per_axis <= 0:
            raise ValueError("adaptive_sampling.samples_per_axis must be > 0")
        for name in (
            "luminance_contrast_threshold",
            "opacity_contrast_threshold",
            "object_hit_opacity_threshold",
        ):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"adaptive_sampling.{name} must be within [0, 1], got {v}")
        if self.minimum_luminance is not None and not self.minimum_luminance >= 0.0:
            raise ValueError("adaptive_sampling.minimum_luminance must be >= 0")


@dataclass(frozen=True)
class Scene:
    geometry: object
    camera: object
    objects: tuple
    celestial_map: object
    celestial_temperature: torch.Tensor
    integration: IntegrationConfig
    adaptive: AdaptiveSamplingConfig = AdaptiveSamplingConfig()


class RaySamples(NamedTuple):
    color: torch.Tensor  # [N, 4] XYZA
    ray_class: torch.Tensor  # [N] int32
    stop_code: torch.Tensor  # [N]
    steps: torch.Tensor  # [N]
    ev_overflow: torch.Tensor  # [N] bool


class GeoTrace(NamedTuple):
    """The geometric pass (march and surface shading) with what the render driver
    needs to raymarch the volumetric events separately."""

    surface_colors: torch.Tensor  # [N, K, 4], volumetric slots zero
    celestial: torch.Tensor  # [N, 4]
    ev_kind: torch.Tensor  # [N, K]
    ev_data: torch.Tensor  # [N, K, 12]
    stop_code: torch.Tensor  # [N]
    observer_energy: torch.Tensor  # [N]
    p_t: torch.Tensor  # [N]
    p_phi: torch.Tensor  # [N]
    ev_overflow: torch.Tensor  # [N] bool
    steps: torch.Tensor  # [N] march steps


def _shade_events(scene, freq, res, include_volumetric=True):
    """Deferred shading of the [N, K] event buffer -> (colors [N, K, 4],
    shade_fail [N]). A thin-disc sample below r_isco with a Novikov-Thorne
    model is the reference's per-pixel error; callers map the flag to
    STEP_FAILED, which the fold renders as the default sample.

    With include_volumetric=False the volumetric slots stay zero: the render driver
    raymarches them on a compacted lane set (rendering/fast_path.py) and
    folds. Shading them here (the JAX package's lax raymarch) is not yet
    ported and raises."""
    geometry = scene.geometry
    n, k = res.ev_kind.shape
    dtype, device = res.ev_data.dtype, res.ev_data.device
    valid = res.ev_kind >= 0

    point3 = res.ev_data[..., 0:3]
    # Empty slots hold zeros: park them off the origin.
    safe_point3 = torch.where(
        valid[..., None], point3, torch.tensor([10.0, 0.0, 0.0], dtype=dtype, device=device)
    )
    point_cart4 = torch.cat([torch.zeros((n, k, 1), dtype=dtype, device=device), safe_point3], -1)
    pos_native = charts.from_cartesian(point_cart4, geometry.chart, geometry.spin)
    p_interp = res.ev_data[..., 3:7]
    uv = res.ev_data[..., 7:9]

    obs_e = freq.observer_energy[:, None]
    colors = torch.zeros((n, k, 4), dtype=dtype, device=device)
    shade_fail = torch.zeros((n,), dtype=torch.bool, device=device)
    for idx, obj in enumerate(scene.objects):
        if isinstance(obj, VolumetricDisc):
            if include_volumetric:
                raise NotImplementedError(
                    "volumetric events are shaded by the compacted raymarch only "
                    "(fast_path.trace_rays_fast_vol)"
                )
            continue
        mask = res.ev_kind == idx
        u_emit, ok = obj.emitter_velocity(geometry, pos_native)
        emitter_energy = geometry.inner_product(pos_native, u_emit, p_interp)
        # Double-where: empty slots carry zero momentum -> redshift inf.
        live = valid & ok & (torch.abs(emitter_energy) > 0.0)
        safe_e = torch.where(live, emitter_energy, 1.0)
        redshift = torch.where(live, obs_e / safe_e, 1.0)
        temp = obj.temperature_at(geometry, point_cart4)
        c = obj.texture.color_at_uv(uv[..., 0], uv[..., 1], temp, redshift)
        ev_fail = obj.temperature_fail(geometry, point_cart4) & mask & valid
        shade_fail = shade_fail | torch.any(ev_fail, dim=-1)
        colors = torch.where(mask[..., None], c, colors)
    return torch.where(valid[..., None], colors, torch.zeros_like(colors)), shade_fail


def _celestial_color(scene, freq, solver, res):
    """Terminal color for escaped rays: equirectangular UV from the final
    position and the redshifted celestial texture."""
    geometry = scene.geometry
    x_last = res.y[..., 0:4]
    finite_x = torch.where(torch.isfinite(x_last), x_last, 1.0)
    r, theta, phi = charts.get_as_spherical(finite_x, geometry.chart)
    u = 1.0 - (math.pi + phi) / (2.0 * math.pi)
    v = theta / math.pi

    # Park every non-escaped or non-finite lane at a safe far-field state
    # before the momentum and the emitter frame are evaluated there.
    escaped = res.stop_code == integ.CELESTIAL
    state_ok = torch.all(torch.isfinite(res.y), dim=-1, keepdim=True) & escaped[:, None]
    safe_state = torch.zeros_like(res.y)
    safe_state[..., 1] = 100.0
    if geometry.chart != charts.CARTESIAN:
        safe_state[..., 2] = math.pi / 2
        safe_state[..., 5] = 0.0
    y_safe = torch.where(state_ok, res.y, safe_state)
    p_last = solver.momentum(y_safe)
    p_last = torch.where(torch.isfinite(p_last), p_last, 0.0)
    safe_far = torch.zeros_like(finite_x)
    safe_far[..., 1] = 100.0
    x_emit = torch.where(escaped[:, None], finite_x, safe_far)
    u_stat = geometry.stationary_velocity(x_emit)
    emitter_energy = geometry.inner_product(x_emit, u_stat, p_last)
    live = escaped & torch.isfinite(emitter_energy) & (torch.abs(emitter_energy) > 0.0)
    safe_e = torch.where(live, emitter_energy, 1.0)
    redshift = torch.where(live, freq.observer_energy / safe_e, 1.0)
    return scene.celestial_map.color_at_uv(u, v, scene.celestial_temperature, redshift)


def fold_samples(scene, ev_kind, ev_colors, stop_code, celestial):
    """Ordered alpha fold of shaded events over the terminal color.
    Returns (color [N, 4], ray_class [N] int32)."""
    n, k = ev_kind.shape
    dtype, device = ev_colors.dtype, ev_colors.device
    premul = torch.zeros((n, 3), dtype=dtype, device=device)
    trans = torch.ones((n,), dtype=dtype, device=device)
    obj_opacity = torch.zeros((n,), dtype=dtype, device=device)
    for j in range(k):
        valid = ev_kind[:, j] >= 0
        a = torch.clamp(ev_colors[:, j, 3], 0.0, 1.0) * valid
        premul = premul + (trans * a)[:, None] * ev_colors[:, j, :3]
        trans = trans * (1.0 - a)
        obj_opacity = a + obj_opacity * (1.0 - a)

    # Terminal layer: celestial texture for escaped rays, opaque black else.
    black = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)
    escaped = stop_code == integ.CELESTIAL
    term = torch.where(escaped[:, None], celestial, black)
    a_t = torch.clamp(term[:, 3], 0.0, 1.0)
    premul = premul + (trans * a_t)[:, None] * term[:, :3]
    color = torch.cat([premul, torch.ones((n, 1), dtype=dtype, device=device)], dim=-1)

    ray_class = torch.where(escaped, ESCAPED, CAPTURED)
    ray_class = torch.where(
        obj_opacity >= scene.adaptive.object_hit_opacity_threshold, HIT, ray_class
    )
    # Shading failure -> the buffer-default sample (black, Escaped).
    failed = stop_code == integ.STEP_FAILED
    color = torch.where(failed[:, None], black, color)
    ray_class = torch.where(failed, ESCAPED, ray_class)
    return color, ray_class.to(torch.int32)
