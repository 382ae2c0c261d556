"""Scene, deferred event shading and the ordered alpha fold (port of
gr_raytracer_tpu/rendering/scene.py).

The march records object crossings into a bounded per-ray event buffer
(the kernel path's march, or the RKF45 path's `integrate_rays` with the
nearest-hit segment test `_segment_fn`); shading runs afterwards as one
batched pass over that buffer, then a front-to-back premultiplied fold
composites the events over the terminal color (exact against the
reference's back-to-front blend over opaque black). `trace_rays` and
`trace_geometric` are the RKF45 path's tracers.

The safe-park and double-where guards below keep masked lanes finite: a
masked inf still turns a backward pass into 0·inf = NaN.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from gr_raytracer_tpu_torch.geometry import chart as charts
from gr_raytracer_tpu_torch.geometry.base import clip, dot
from gr_raytracer_tpu_torch.objects.volumetric_disc import VolumetricDisc
from gr_raytracer_tpu_torch.rendering import integrator as integ
from gr_raytracer_tpu_torch.rendering.integrator import IntegrationConfig
from gr_raytracer_tpu_torch.rendering.redshift import ray_frequency_data

# Ray classification.
ESCAPED = 0
CAPTURED = 1
HIT = 2

# Event payload layout (ops/geodesic_march.py): [point_cart(3) | p_interp(4)
# | uv(2) | seg_dir(3)].
EVENT_WIDTH = 12


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
    kk_drift: Optional[torch.Tensor] = None  # the RKF45 path's invariant drifts
    const_drift: Optional[torch.Tensor] = None


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


def _segment_fn(scene):
    """The in-loop nearest-hit segment test over all scene objects (the
    RKF45 path's segment_fn, rendering/integrator.py): of the objects a
    step's segment hits, the one whose hit point is nearest its start."""
    objects = scene.objects

    def fn(x_prev, cart_prev, p_prev, x_new, cart_new, p_new):
        n = x_prev.shape[0]
        dtype, device = x_prev.dtype, x_prev.device
        best_hit = torch.zeros((n,), dtype=torch.bool, device=device)
        best_dist = torch.full((n,), math.inf, dtype=dtype, device=device)
        best_kind = torch.full((n,), -1, dtype=torch.int32, device=device)
        best_t = torch.zeros((n,), dtype=dtype, device=device)
        best_point = torch.zeros((n, 3), dtype=dtype, device=device)
        best_uv = torch.zeros((n, 2), dtype=dtype, device=device)
        start = cart_prev[..., 1:4]
        for idx, obj in enumerate(objects):
            hit, t, point, uv = obj.segment_hit(cart_prev, cart_new)
            # Squared distance: the same nearest-hit order without a sqrt.
            rel = point - start
            dist = dot(rel, rel)
            better = hit & (dist < best_dist)
            best_hit = best_hit | hit
            best_dist = torch.where(better, dist, best_dist)
            best_kind = torch.where(better, idx, best_kind)
            best_t = torch.where(better, t, best_t)
            best_point = torch.where(better[:, None], point, best_point)
            best_uv = torch.where(better[:, None], uv, best_uv)

        # The momentum interpolated linearly between the segment's ends in the
        # integrator's components; the position is the solved hit point.
        p_interp = (1.0 - best_t)[:, None] * p_prev + best_t[:, None] * p_new
        seg_dir = cart_new[..., 1:4] - cart_prev[..., 1:4]
        return best_hit, best_kind, torch.cat([best_point, p_interp, best_uv, seg_dir], dim=-1)

    return fn


def _shade_events(scene, freq, res, include_volumetric=True):
    """Deferred shading of the [N, K] event buffer -> (colors [N, K, 4],
    shade_fail [N]). A thin-disc sample below r_isco with a Novikov-Thorne
    model is the reference's per-pixel error; callers map the flag to
    STEP_FAILED, which the fold renders as the default sample.

    Volumetric slots are raymarched by their object's `shade_events` (the
    RKF45 path's raymarch over the object's live slots); with
    include_volumetric=False they stay zero, for a render driver that
    raymarches them on its own compacted lane set and folds."""
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
        mask = res.ev_kind == idx
        if isinstance(obj, VolumetricDisc):
            if include_volumetric:
                c = obj.shade_events(geometry, freq, res, idx)
                colors = torch.where(mask[..., None], c, colors)
            continue
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
        a = clip(ev_colors[:, j, 3], 0.0, 1.0) * valid
        premul = premul + (trans * a)[:, None] * ev_colors[:, j, :3]
        trans = trans * (1.0 - a)
        obj_opacity = a + obj_opacity * (1.0 - a)

    # Terminal layer: celestial texture for escaped rays, opaque black else.
    black = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)
    escaped = stop_code == integ.CELESTIAL
    term = torch.where(escaped[:, None], celestial, black)
    a_t = clip(term[:, 3], 0.0, 1.0)
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


def trace_geometric(scene, positions, momenta) -> GeoTrace:
    """The RKF45 march, event detection and surface and sky shading,
    without the volumetric raymarch (the render driver's split path)."""
    geometry = scene.geometry
    solver = geometry.make_solver(positions, momenta)
    y0 = solver.initial_state(positions, momenta)
    freq = ray_frequency_data(geometry, positions, momenta, scene.camera.velocity)
    res = integ.integrate_rays(geometry, solver, scene.integration, y0, _segment_fn(scene), EVENT_WIDTH)
    colors, shade_fail = _shade_events(scene, freq, res, include_volumetric=False)
    stop = torch.where(shade_fail, integ.STEP_FAILED, res.stop_code)
    celestial = _celestial_color(scene, freq, solver, res)
    return GeoTrace(
        surface_colors=colors, celestial=celestial, ev_kind=res.ev_kind, ev_data=res.ev_data, stop_code=stop,
        observer_energy=freq.observer_energy, p_t=freq.p_t, p_phi=freq.p_phi, ev_overflow=res.ev_overflow,
        steps=res.steps,
    )


def trace_rays(scene, positions, momenta) -> RaySamples:
    """Color a batch of camera rays ([N, 4] native-chart positions and
    momenta) through the RKF45 path. The color's alpha is 1. Volumetric
    slots are raymarched inline (`_shade_events`). With
    scene.integration.differentiable (and a gas disc's `differentiable`)
    the colors carry gradients to the scene's tensors through the solver,
    the march, the shading and the fold, with no host sync inside the loop
    (one a block)."""
    geometry = scene.geometry
    solver = geometry.make_solver(positions, momenta)
    y0 = solver.initial_state(positions, momenta)
    freq = ray_frequency_data(geometry, positions, momenta, scene.camera.velocity)
    res = integ.integrate_rays(geometry, solver, scene.integration, y0, _segment_fn(scene), EVENT_WIDTH)
    return finish_rays(scene, freq, solver, res)


def finish_rays(scene, freq, solver, res) -> RaySamples:
    """Shade and fold an integrated batch (`trace_rays` after its march)."""
    colors, shade_fail = _shade_events(scene, freq, res)
    stop = torch.where(shade_fail, integ.STEP_FAILED, res.stop_code)
    celestial = _celestial_color(scene, freq, solver, res)
    color, ray_class = fold_samples(scene, res.ev_kind, colors, stop, celestial)
    return RaySamples(color, ray_class, stop, res.steps, res.ev_overflow, res.kk_drift, res.const_drift)
