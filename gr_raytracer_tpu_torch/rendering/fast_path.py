"""Kernel path: full-scene tracing through the RK4 marches (port of the
disc, sphere and volumetric parts of gr_raytracer_tpu/rendering/fast_path.py).

Applies to Kerr (Kerr-Schild Cartesian, the K1 march) and to KerrBL and
Schwarzschild (the Mino-time K3 march; Schwarzschild rides it as KerrBL
with a = 0, whose chart is its spherical one) with thin discs, spheres and
z-axis volumetric discs: kerr.toml, kerr-bl.toml, the sphere scenes
(schwarzschild.toml among them), the flagship preset and the volumetric
scenes. Integration and crossing detection run in the march
(ops/geodesic_march.py); shading and the alpha fold are the deferred passes
of rendering/scene.py, with the scene's own geometry. A scene whose one
object is a volumetric disc goes through `trace_rays_fast_vol`: the
geometric march, the compaction of its volumetric event slots, and one
raymarch K5 over them (ops/volumetric_march.py). A Mino-time march goes
in two launches of K3 (`_march`). A scene with a volumetric disc beside
other objects, or whose raymarch K5 does not cover, takes the render
driver's split path (rendering/raytracer.py), whose geometric pass is
`trace_geometric_fast` here when `supports_scene` holds. Nothing here
synchronizes with the card except that compaction (one count per call), so
chunks of rays can be queued ahead of the host. `trace_rays_fast_vol_diff` is the differentiable
form of that path: gradients flow from the colors to the five medium
parameters through K6 and K7 (ops/volumetric_adjoint.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from gr_raytracer_tpu_torch.geometry.base import dot, lower
from gr_raytracer_tpu_torch.geometry.kerr import Kerr
from gr_raytracer_tpu_torch.geometry.kerr_bl import KerrBL
from gr_raytracer_tpu_torch.geometry.schwarzschild import Schwarzschild
from gr_raytracer_tpu_torch.objects.disc import Disc
from gr_raytracer_tpu_torch.objects.sphere import Sphere
from gr_raytracer_tpu_torch.objects.volumetric_disc import CAP_HEIGHT_SIGMAS, VolumetricDisc
from gr_raytracer_tpu_torch.ops import geodesic_march as gm
from gr_raytracer_tpu_torch.ops import volumetric_march as vm
from gr_raytracer_tpu_torch.rendering import integrator as integ
from gr_raytracer_tpu_torch.rendering import scene as scn
from gr_raytracer_tpu_torch.rendering.redshift import ray_frequency_data

# Deep budgets get the Kahan-compensated state update: at the 1e6-step
# budget the y += delta summation random walk dominated the drift of the
# conserved quantities; below this budget it never approaches the bar.
DEEP_BUDGET_COMPENSATION = 100_000
# The first leg of a Mino-time march, in steps (`_march`): the
# lanes that stop within it (disc and horizon hits: the median lane of the
# kerr-bl.toml frame takes 84) leave the second launch to the long ones.
FIRST_LEG = 512


def supports_scene(scene) -> bool:
    """Kerr, KerrBL or Schwarzschild with thin discs, spheres and z-axis
    volumetric discs."""
    supported = lambda o: isinstance(o, (Disc, Sphere)) or (isinstance(o, VolumetricDisc) and o.axis_is_z())
    return isinstance(scene.geometry, (Kerr, KerrBL, Schwarzschild)) and all(
        supported(o) for o in scene.objects
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
    e = -lower(geometry.metric(x), p)[..., 0]
    l = torch.linalg.cross(x[..., 1:4], p[..., 1:4])
    return e, torch.sqrt(dot(l, l))


class KernelSpec(NamedTuple):
    """Static march configuration read once from a concrete scene: the
    march geometry's parameters as host floats, the disc, sphere and
    bounding-volume specs, the far-field safe radius (Kerr-Schild only),
    whether every texture is opaque (the first hit saturates the alpha
    fold), whether the march is the Mino-time one, and the raymarch spec
    when the scene's one object is a volumetric disc the raymarch
    supports."""

    radius: float
    a: float
    horizon_epsilon: float
    discs: tuple
    r_safe: float
    opaque: bool
    mino: bool
    vols: tuple = ()
    vol_spec: Optional[vm.VolSpec] = None
    spheres: tuple = ()


def scene_kernel_spec(scene) -> KernelSpec:
    if not supports_scene(scene):
        raise NotImplementedError(
            "the kernel path supports Kerr, KerrBL and Schwarzschild with thin discs, spheres and "
            "z-axis volumetric discs only; other scenes are not yet ported"
        )
    host = lambda v: float(torch.as_tensor(v).detach())  # frozen: no gradient
    discs, spheres, vols = [], [], []
    extent = 0.0
    for idx, o in enumerate(scene.objects):
        if isinstance(o, Sphere):
            cx, cy, cz = (host(v) for v in o.center[1:4])
            spheres.append(gm.SphereSpec(host(o.radius), cx, cy, cz, idx))
            # A sphere reaches |c| + R from the origin.
            extent = max(extent, math.sqrt(cx * cx + cy * cy + cz * cz) + host(o.radius))
            continue
        if isinstance(o, VolumetricDisc):
            vols.append(gm.VolSpec(host(o.inner_radius), host(o.outer_radius),
                                   host(o.thickness) * CAP_HEIGHT_SIGMAS, idx))
        else:
            discs.append(gm.DiscSpec(host(o.inner_radius), host(o.outer_radius), idx))
        extent = max(extent, host(o.outer_radius))
    geometry = _march_geometry_of(scene)
    # Far-field lever: 2× the outermost object extent, floored at 10×M so the
    # strong-field region keeps the h0 cadence.
    r_safe = 2.0 * max(extent, 5.0 * host(geometry.radius))
    # A volumetric fold has alpha < 1 whatever its texture (Beer-Lambert), so
    # any volumetric object turns the opaque stop off.
    opaque = bool(scene.objects) and not vols and all(o.texture.is_opaque() for o in scene.objects)
    vol_spec = None
    if len(scene.objects) == 1 and vols and vm.supports(scene.objects[0], scene.geometry):
        vol_spec = vm.build_vol_spec(scene.objects[0], scene.geometry)
    return KernelSpec(
        host(geometry.radius), host(geometry.a), host(geometry.horizon_epsilon),
        tuple(discs), r_safe, opaque, isinstance(geometry, KerrBL), tuple(vols), vol_spec, tuple(spheres),
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


def _run_kernel(spec: KernelSpec, cfg, solver, y0, attempts=None, resume=None, finalize=True):
    """The march; returns the raw 7-tuple (y, stop, steps, ev_kind, ev_data,
    ev_count, ev_overflow).

    Kerr-Schild: h0 = H_MAX = 1.0 (the reference's step cap). Mino time:
    h0 = 0.01 (a far-field spatial step of ~h0·r_ref² = 1) and twice the
    budget, because the fixed Mino step is finer than the adaptive
    controller's steps near the hole, and near-critical rays would stop
    TRAPPED at the nominal count.

    `attempts` bounds this call's iterations; `resume`, a previous call's
    7-tuple, continues its march (the budget stays the lanes' total);
    finalize=False leaves unfinished lanes RUNNING. A resumed leg restarts
    the Kahan compensation at zero, one more rounding per leg on deep
    budgets; below DEEP_BUDGET_COMPENSATION legs give one march's results
    bit for bit."""
    compensated = cfg.max_steps >= DEEP_BUDGET_COMPENSATION
    legs = dict(attempts=attempts, resume=resume, finalize=finalize)
    if spec.mino:
        return gm.kerr_bl_rk4_march(
            spec.radius, spec.a, spec.horizon_epsilon, y0, solver.e.contiguous(),
            solver.l_z.contiguous(), solver.q.contiguous(), h0=0.01,
            max_steps=2 * cfg.max_steps, max_radius=cfg.max_radius, discs=spec.discs,
            spheres=spec.spheres, vols=spec.vols, opaque_stop=spec.opaque, compensated=compensated,
            max_events=cfg.max_events, **legs,
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
        spheres=spec.spheres,
        vols=spec.vols,
        r_safe=spec.r_safe,
        opaque_stop=spec.opaque,
        compensated=compensated,
        max_events=cfg.max_events,
        **legs,
    )


class _Conserved(NamedTuple):
    """A Mino-time march's per-lane E, L_z and Q (what `_run_kernel` reads
    of a solver)."""

    e: torch.Tensor
    l_z: torch.Tensor
    q: torch.Tensor


def _march(spec: KernelSpec, cfg, solver, y0, attempts=None):
    """The march of a batch of lanes: its raw 7-tuple in the lanes' order.
    `solver` holds the Mino-time march's E, L_z and Q; `attempts` bounds
    each lane's iterations over the legs and leaves the unfinished lanes
    RUNNING (a comparison with the plain march on a cut budget).

    K3 takes its lanes in index order, one a resident thread at a time
    (ops/geodesic_march.py), so a Mino-time march runs in two legs: every
    lane's first FIRST_LEG steps in the given order, where the lanes that
    hit a disc or the horizon early stop; then the lanes still running
    first, nearest the hole first (the orbiting ones, which march longest;
    escaping ones are far out by then), each lane's state, counters and
    events carried over (`resume`: one march's results bit for bit). Deep
    budgets (the Kahan update, which a leg would restart) and Kerr-Schild
    lanes march in one launch."""
    if not spec.mino or cfg.max_steps >= DEEP_BUDGET_COMPENSATION:
        return _run_kernel(spec, cfg, solver, y0, attempts=attempts, finalize=attempts is None)
    first = FIRST_LEG if attempts is None else min(FIRST_LEG, attempts)
    leg1 = _run_kernel(spec, cfg, solver, y0, attempts=first, finalize=False)
    running = leg1[1] == integ.RUNNING
    order = torch.argsort(torch.where(running, leg1[0][:, 1], torch.inf), stable=True)
    leg1 = [v[order] for v in leg1]
    lanes = _Conserved(solver.e[order], solver.l_z[order], solver.q[order])
    leg2 = _run_kernel(spec, cfg, lanes, leg1[0], resume=leg1, attempts=None if attempts is None else attempts - first,
                       finalize=attempts is None)
    unsort = torch.empty_like(order)
    unsort[order] = torch.arange(order.numel(), device=order.device)
    return [v[unsort] for v in leg2]


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
    res = integ.IntegrationResult(*_march(spec, scene.integration, solver, y0))
    return _finish_samples(scene, res, freq, solver, inverse, first_event_only=spec.opaque)


def trace_geometric_fast(scene, positions, momenta, spec=None) -> scn.GeoTrace:
    """The march, event detection and surface and sky shading, without the
    volumetric raymarch; in the caller's ray order."""
    if spec is None:
        spec = scene_kernel_spec(scene)
    solver, y0, freq, inverse = _prepare_march(scene, positions, momenta)
    res = integ.IntegrationResult(*_march(spec, scene.integration, solver, y0))
    colors, shade_fail = scn._shade_events(scene, freq, res, include_volumetric=False)
    stop_shaded = torch.where(shade_fail, integ.STEP_FAILED, res.stop_code)
    celestial = scn._celestial_color(scene, freq, solver, res)
    return scn.GeoTrace(
        surface_colors=colors[inverse], celestial=celestial[inverse], ev_kind=res.ev_kind[inverse],
        ev_data=res.ev_data[inverse], stop_code=stop_shaded[inverse],
        observer_energy=freq.observer_energy[inverse], p_t=freq.p_t[inverse],
        p_phi=freq.p_phi[inverse], ev_overflow=res.ev_overflow[inverse], steps=res.steps[inverse],
    )


def volumetric_lanes(obj, ev_kind, ev_data, observer_energy, p_t, p_phi, idx=0):
    """The raymarch's lanes for every event slot of `obj`, the scene's
    object of index idx: (slots [M] into the flattened [N·K] slots, (ro, rd,
    obs_e, p_t, p_phi, active, exit_d)), both sorted by the clipped march
    length, ascending: K5 and K6 take a warp per lane from the last lane
    back, so the longest start first; K7's one thread per lane finds lanes
    of similar length side by side in a warp. ro is the crossing point and
    rd the unit chord of the step that crossed. The compaction reads its
    exact count: one host sync."""
    k = ev_kind.shape[1]
    slots = torch.nonzero((ev_kind == idx).reshape(-1)).flatten()
    ev = ev_data.reshape(-1, ev_data.shape[-1])[slots]
    ro = ev[:, 0:3]
    seg = ev[:, 9:12]
    rd = seg / torch.clamp(torch.sqrt(torch.sum(seg * seg, dim=-1, keepdim=True)), min=1e-30)
    exit_d = obj.exit_distance(ro, rd)
    order = torch.argsort(vm.march_length(obj, ro, rd, exit_d))
    ray = (slots // k)[order]
    lanes = (
        ro[order].contiguous(), rd[order].contiguous(), observer_energy[ray].contiguous(),
        p_t[ray].contiguous(), p_phi[ray].contiguous(), torch.ones_like(order, dtype=torch.bool),
        exit_d[order].contiguous(),
    )
    return slots[order], lanes


class VolTrace(NamedTuple):
    """`trace_rays_fast_vol`'s result: the samples, the number of volumetric
    event lanes raymarched, the samples K5 marched over them and the lanes
    whose alpha came out > 0 (0-d tensors on the rays' device, so reading
    them is the caller's choice)."""

    samples: scn.RaySamples
    lanes: int
    marched: torch.Tensor
    emitting: torch.Tensor


def trace_rays_fast_vol(scene, positions, momenta, spec=None) -> VolTrace:
    """Color camera rays of a scene whose one object is a z-axis volumetric
    disc: the geometric march, the compaction of the volumetric event slots
    (`volumetric_lanes`: their exact count, exit_distance, the march-length
    sort), one raymarch K5 over the slots, scatter and the alpha fold. K5's
    per-lane result does not depend on lane order, so the sort only sets
    which lanes start first (the longest). With the exact count there are no
    padding lanes to park. Other volumetric scenes raise
    NotImplementedError here; the render driver's split path takes them."""
    if spec is None:
        spec = scene_kernel_spec(scene)
    if spec.vol_spec is None:
        raise NotImplementedError(
            "the volumetric kernel path takes scenes whose one object is a z-axis volumetric "
            "disc with a blackbody or checker texture"
        )
    g = trace_geometric_fast(scene, positions, momenta, spec)
    n, k = g.ev_kind.shape
    slots, lanes = volumetric_lanes(scene.objects[0], g.ev_kind, g.ev_data, g.observer_energy, g.p_t, g.p_phi)
    colors = torch.zeros((n * k, 4), dtype=g.ev_data.dtype, device=g.ev_data.device)
    marched = torch.zeros((), dtype=torch.int64, device=g.ev_data.device)
    emitting = torch.zeros_like(marched)
    if slots.numel():
        xyza, lane_samples = vm.raymarch(spec.vol_spec, *lanes)
        colors[slots] = xyza
        marched = lane_samples.sum(dtype=torch.int64)
        emitting = (xyza[:, 3] > 0.0).sum()
    color, ray_class = scn.fold_samples(
        scene, g.ev_kind, colors.reshape(n, k, 4), g.stop_code, g.celestial
    )
    samples = scn.RaySamples(color, ray_class, g.stop_code, g.steps, g.ev_overflow)
    return VolTrace(samples, int(slots.numel()), marched, emitting)


def supports_diff(scene) -> bool:
    """Reverse mode through the march (ops/geodesic_adjoint.py) covers
    scenes whose textures are all opaque (slot-0 shading is then exact, and
    the adjoint takes one payload cotangent per lane at its last step):
    Kerr (the Kerr-Schild sweep) with thin discs and spheres, the payload
    picked per lane by the slot-0 kind; KerrBL and Schwarzschild (the
    Mino-time sweep) with thin discs only, as in the JAX package, whose BL
    sweep has no sphere payload."""
    if not scene.objects or not supports_scene(scene) or not scene_kernel_spec(scene).opaque:
        return False
    kinds = (Disc, Sphere) if isinstance(scene.geometry, Kerr) else (Disc,)
    return all(isinstance(o, kinds) for o in scene.objects)


def trace_rays_fast_diff(scene, positions, momenta, spec=None, k_ckpt=None):
    """Differentiable `trace_rays_fast` on supports_diff scenes: gradients
    flow through the final state (sky shading) and the slot-0 event payload
    (disc and sphere shading), and through every step of the march to the
    metric parameters radius and a; on the Mino-time march also through each ray's
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
    if spec.spheres and spec.mino:
        raise ValueError("the differentiable Mino-time march has no sphere payload (nor has the JAX package's)")
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
            h0=1.0, max_steps=cfg.max_steps, discs=spec.discs, spheres=spec.spheres, r_safe=spec.r_safe,
            k_ckpt=k_ckpt,
        )
        out = march(geometry.radius, geometry.a, geometry.horizon_epsilon, cfg.max_radius, y0)
    y_f, ev_data, stop, steps, ev_kind, ev_count, ev_ovf = out
    res = integ.IntegrationResult(y_f, stop, steps, ev_kind, ev_data, ev_count, ev_ovf)
    return _finish_samples(scene, res, freq, solver, inverse, first_event_only=True)


def supports_vol_diff(scene) -> bool:
    """Reverse mode through the raymarch (ops/volumetric_adjoint.py) covers
    the scenes of `trace_rays_fast_vol`: one z-axis volumetric disc with a
    raymarch-supported texture and temperature on Kerr, KerrBL or
    Schwarzschild."""
    return (
        isinstance(scene.geometry, (Kerr, KerrBL, Schwarzschild))
        and len(scene.objects) == 1
        and isinstance(scene.objects[0], VolumetricDisc)
        and scene.objects[0].axis_is_z()
        and vm.supports(scene.objects[0], scene.geometry)
    )


def trace_rays_fast_vol_diff(scene, med, positions, momenta, spec=None) -> scn.RaySamples:
    """Differentiable `trace_rays_fast_vol` on supports_vol_diff scenes:
    gradients flow from the colors to `med` ([5] of the rays' dtype and
    device: volumetric_march.MED_NAMES, the medium the raymarch reads in
    place of the disc's own five values) through the raymarch K6 and its
    backward K7. The geometric pass runs without gradient (the bounding-
    volume crossings do not move with the medium), then the compaction of
    the volumetric slots (`volumetric_lanes`, to their exact count: JAX's
    fixed bucket, its overflow flag and its parked padding lanes have no
    counterpart), the differentiable march, `combine_alpha`, the scatter
    and the alpha fold."""
    from gr_raytracer_tpu_torch.ops import volumetric_adjoint as va

    if spec is None:
        if not supports_vol_diff(scene):
            raise ValueError("scene shape unsupported by the differentiable volumetric path")
        spec = scene_kernel_spec(scene)
    with torch.no_grad():
        g = trace_geometric_fast(scene, positions, momenta, spec)
        n, k = g.ev_kind.shape
        slots, lanes = volumetric_lanes(scene.objects[0], g.ev_kind, g.ev_data, g.observer_energy, g.p_t,
                                        g.p_phi)
    colors = torch.zeros((n * k, 4), dtype=g.ev_data.dtype, device=g.ev_data.device)
    if slots.numel():
        acc, t_fin, ws, wt = va.make_vol_march_diff(spec.vol_spec)(med, *lanes)
        colors = colors.index_put((slots,), va.combine_alpha(acc, t_fin, ws, wt))
    color, ray_class = scn.fold_samples(scene, g.ev_kind, colors.reshape(n, k, 4), g.stop_code, g.celestial)
    return scn.RaySamples(color, ray_class, g.stop_code, g.steps, g.ev_overflow)
