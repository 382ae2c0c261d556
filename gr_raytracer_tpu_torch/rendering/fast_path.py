"""Kernel path: full-scene tracing through the RK4 marches (port of the
disc part of gr_raytracer_tpu/rendering/fast_path.py).

Applies to Kerr (Kerr-Schild Cartesian, the K1 march) and to KerrBL and
Schwarzschild (the Mino-time K3 march; Schwarzschild rides it as KerrBL
with a = 0, whose chart is its spherical one) with thin discs: kerr.toml,
kerr-bl.toml and the flagship preset. Integration and disc-crossing
detection run in the march (ops/geodesic_march.py); shading and the alpha
fold are the deferred passes of rendering/scene.py, with the scene's own
geometry. Nothing here synchronizes with the card, so chunks of rays can be
queued ahead of the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gr_raytracer_tpu_torch.geometry.kerr import Kerr
from gr_raytracer_tpu_torch.geometry.kerr_bl import KerrBL
from gr_raytracer_tpu_torch.geometry.schwarzschild import Schwarzschild
from gr_raytracer_tpu_torch.objects.disc import Disc
from gr_raytracer_tpu_torch.ops import geodesic_march as gm
from gr_raytracer_tpu_torch.rendering import integrator as integ
from gr_raytracer_tpu_torch.rendering import scene as scn
from gr_raytracer_tpu_torch.rendering.redshift import ray_frequency_data

# Deep budgets get the Kahan-compensated state update: at the 1e6-step
# budget the y += delta summation random walk dominated the drift of the
# conserved quantities; below this budget it never approaches the bar.
DEEP_BUDGET_COMPENSATION = 100_000


def supports_scene(scene) -> bool:
    """Kerr, KerrBL or Schwarzschild with thin discs only (the part of the
    JAX fast path that is ported so far)."""
    return isinstance(scene.geometry, (Kerr, KerrBL, Schwarzschild)) and all(
        isinstance(o, Disc) for o in scene.objects
    )


def _march_geometry_of(scene):
    """The geometry the march integrates: Schwarzschild's spherical chart is
    the a = 0 BL chart, so positions and momenta carry over verbatim and
    the Mino-time march integrates the same geodesics. Shading keeps the
    scene's own geometry."""
    geometry = scene.geometry
    if isinstance(geometry, Schwarzschild):
        return KerrBL(
            radius=geometry.radius, a=torch.zeros_like(geometry.radius),
            horizon_epsilon=geometry.horizon_epsilon,
        )
    return geometry


def _impact_proxy(geometry, x, p):
    """(E, |L|) per ray for the cost sort. KerrBL: √(L_z² + Q); Kerr-Schild:
    |r × p| with E from the covariant p_t."""
    if isinstance(geometry, KerrBL):
        e, l_z, q = geometry.conserved_from_bl(x, p)
        return e, torch.sqrt(torch.clamp(l_z * l_z + q, min=0.0))
    g = geometry.metric(x)
    p_cov = torch.einsum("...ij,...j->...i", g, p)
    e = -p_cov[..., 0]
    l = torch.linalg.cross(x[..., 1:4], p[..., 1:4])
    return e, torch.sqrt(torch.sum(l * l, dim=-1))


class KernelSpec(NamedTuple):
    """Static march configuration read once from a concrete scene: the
    march geometry's parameters as host floats, the disc specs, the
    far-field safe radius (Kerr-Schild only), whether every texture is
    opaque (the first hit saturates the alpha fold), and whether the march
    is the Mino-time one."""

    radius: float
    a: float
    horizon_epsilon: float
    discs: tuple
    r_safe: float
    opaque: bool
    mino: bool


def scene_kernel_spec(scene) -> KernelSpec:
    if not supports_scene(scene):
        raise NotImplementedError(
            "the kernel path supports Kerr, KerrBL and Schwarzschild with thin discs only; "
            "other scenes are not yet ported"
        )
    host = lambda v: float(torch.as_tensor(v).detach())  # frozen: no gradient
    discs = []
    extent = 0.0
    for idx, o in enumerate(scene.objects):
        discs.append(gm.DiscSpec(host(o.inner_radius), host(o.outer_radius), idx))
        extent = max(extent, host(o.outer_radius))
    geometry = _march_geometry_of(scene)
    # Far-field lever: 2× the outermost object extent, floored at 10×M so the
    # strong-field region keeps the h0 cadence.
    r_safe = 2.0 * max(extent, 5.0 * host(geometry.radius))
    opaque = bool(scene.objects) and all(o.texture.is_opaque() for o in scene.objects)
    return KernelSpec(
        host(geometry.radius), host(geometry.a), host(geometry.horizon_epsilon),
        tuple(discs), r_safe, opaque, isinstance(geometry, KerrBL),
    )


def _prepare_march(scene, positions, momenta):
    """Cost-sort the rays, build solver / initial state / frequency data.
    Everything returned is in sorted lane order; callers unsort with
    [inverse].

    The sort: lanes near the photon ring (b ≈ b_crit ≈ 3√3 M) march longest
    and lie on a thin ring through the image. Sorting by |b − b_crit| puts
    them next to each other, so the lanes of a warp finish together."""
    geometry = _march_geometry_of(scene)
    e_g, lz_tot = _impact_proxy(geometry, positions, momenta)
    b = torch.abs(lz_tot) / torch.clamp(torch.abs(e_g), min=1e-12)
    b_crit = 2.598 * geometry.radius  # 3√3 M, Schwarzschild value as proxy
    order = torch.argsort(torch.abs(b - b_crit), stable=True)
    inverse = torch.argsort(order, stable=True)
    positions = positions[order]
    momenta = momenta[order]
    solver = geometry.make_solver(positions, momenta)
    y0 = solver.initial_state(positions, momenta)
    # The shading scalars use the scene's geometry: every redshift is an
    # energy ratio in one metric, so the sign between (+,−,−,−)
    # Schwarzschild and (−,+,+,+) BL cancels.
    freq = ray_frequency_data(scene.geometry, positions, momenta, scene.camera.velocity)
    return solver, y0, freq, inverse


def _run_kernel(spec: KernelSpec, cfg, solver, y0):
    """The march; returns the raw 7-tuple (y, stop, steps, ev_kind, ev_data,
    ev_count, ev_overflow).

    Kerr-Schild: h0 = H_MAX = 1.0 (the reference's step cap). Mino time:
    h0 = 0.01 (a far-field spatial step of ~h0·r_ref² = 1) and twice the
    budget, because the fixed Mino step is finer than the adaptive
    controller's steps near the hole, and near-critical rays would stop
    TRAPPED at the nominal count."""
    compensated = cfg.max_steps >= DEEP_BUDGET_COMPENSATION
    if spec.mino:
        return gm.kerr_bl_rk4_march(
            spec.radius, spec.a, spec.horizon_epsilon, y0, solver.e.contiguous(),
            solver.l_z.contiguous(), solver.q.contiguous(), h0=0.01,
            max_steps=2 * cfg.max_steps, max_radius=cfg.max_radius, discs=spec.discs,
            opaque_stop=spec.opaque, compensated=compensated,
        )
    return gm.kerr_rk4_march(
        spec.radius,
        spec.a,
        spec.horizon_epsilon,
        y0,
        h0=1.0,
        max_steps=cfg.max_steps,
        max_radius=cfg.max_radius,
        discs=spec.discs,
        r_safe=spec.r_safe,
        opaque_stop=spec.opaque,
        compensated=compensated,
    )


def _finish_samples(scene, res, freq, solver, inverse, first_event_only=False):
    """Shade and fold a marched result into RaySamples, in the caller's ray
    order. first_event_only (every texture opaque): the first event
    saturates the fold, so only slot 0 is shaded."""
    if first_event_only:
        res = res._replace(ev_kind=res.ev_kind[:, :1], ev_data=res.ev_data[:, :1, :])
    colors, shade_fail = scn._shade_events(scene, freq, res)
    stop_shaded = torch.where(shade_fail, integ.STEP_FAILED, res.stop_code)
    celestial = scn._celestial_color(scene, freq, solver, res)
    color, ray_class = scn.fold_samples(scene, res.ev_kind, colors, stop_shaded, celestial)
    return scn.RaySamples(
        color=color[inverse],
        ray_class=ray_class[inverse],
        stop_code=stop_shaded[inverse],
        steps=res.steps[inverse],
        ev_overflow=res.ev_overflow[inverse],
    )


def trace_rays_fast(scene, positions, momenta, spec=None):
    """Color a batch of camera rays ([N, 4] positions and momenta) through
    the march; `spec` (scene_kernel_spec) may be computed once per scene."""
    if spec is None:
        spec = scene_kernel_spec(scene)
    solver, y0, freq, inverse = _prepare_march(scene, positions, momenta)
    res = integ.IntegrationResult(*_run_kernel(spec, scene.integration, solver, y0))
    return _finish_samples(scene, res, freq, solver, inverse, first_event_only=spec.opaque)


def supports_diff(scene) -> bool:
    """Reverse mode through the march (ops/geodesic_adjoint.py) covers Kerr,
    KerrBL and Schwarzschild with thin discs whose textures are all opaque:
    slot-0 shading is then exact, and the adjoint takes one payload
    cotangent per lane at its last step. Sphere scenes are not yet ported."""
    return bool(scene.objects) and supports_scene(scene) and scene_kernel_spec(scene).opaque


def trace_rays_fast_diff(scene, positions, momenta, spec=None, k_ckpt=None):
    """Differentiable `trace_rays_fast` on supports_diff scenes: gradients
    flow through the final state (sky shading) and the slot-0 event payload
    (disc shading), and through every step of the march to the metric
    parameters radius and a; on the Mino-time march also through each ray's
    (E, L_z, Q) back into the camera and the metric (the solver's
    construction is plain torch). Discrete decisions (stop codes, the
    crossing step, the cost sort) are locally constant. The disc bounds of
    the march are host floats from `spec`, so UV cotangents see frozen
    bounds (the blackbody texture ignores UV; the temperature reads the hit
    point, which is fully differentiated)."""
    from gr_raytracer_tpu_torch.ops import geodesic_adjoint as gadj

    if spec is None:
        if not supports_diff(scene):
            raise ValueError("scene shape unsupported by the differentiable kernel path")
        spec = scene_kernel_spec(scene)
    solver, y0, freq, inverse = _prepare_march(scene, positions, momenta)
    cfg = scene.integration
    geometry = _march_geometry_of(scene)
    k_ckpt = k_ckpt or gadj.K_CKPT
    if spec.mino:
        # The same step rule and budget as _run_kernel's Mino-time branch.
        march = gadj.make_bl_march_diff(
            h0=0.01, max_steps=2 * cfg.max_steps, discs=spec.discs, k_ckpt=k_ckpt,
        )
        out = march(geometry.radius, geometry.a, geometry.horizon_epsilon, cfg.max_radius,
                    solver.e, solver.l_z, solver.q, y0)
    else:
        march = gadj.make_ks_march_diff(
            h0=1.0, max_steps=cfg.max_steps, discs=spec.discs, r_safe=spec.r_safe, k_ckpt=k_ckpt,
        )
        out = march(geometry.radius, geometry.a, geometry.horizon_epsilon, cfg.max_radius, y0)
    y_f, ev_data, stop, steps, ev_kind, ev_count, ev_ovf = out
    res = integ.IntegrationResult(y_f, stop, steps, ev_kind, ev_data, ev_count, ev_ovf)
    return _finish_samples(scene, res, freq, solver, inverse, first_event_only=True)
