"""The port's adaptive RKF45 path (rendering/rkf45.py, the solvers'
right-hand sides, rendering/integrator.py::integrate_rays) against the JAX
package's, float64 on the CPU.

- `rkf45_step` and `controller` on seeded states and errors, at 1e-13;
- each solver's `rhs`, `inside_horizon`, `closed_orbit` and
  `constants_of_motion` at 1e-12;
- `integrate_rays` with the scene's nearest-hit segment test on the disc
  and sphere scenes of tests/test_golden_frames.py (Kerr-Schild with a disc
  and a sphere, KerrBL and Schwarzschild with a disc): stop codes, steps,
  event kinds and counts equal, event payloads within 1e-9 of each lane's
  scale, final states within 1e-8 (STATE_RTOL);
- `attempts_budget` + `resume` in two legs on the same lanes equal one shot
  bit for bit;
- `track_invariants`: the drift of k·k and of the constants of motion;
- the loops that integrator.run_lanes replays from a CUDA graph on the card
  (this path's march and raymarch, and the plain K1, K3, K5 and K7 marches)
  run an iteration here without an op a graph cannot capture.

The JAX loop runs compiled (lax.while_loop), where XLA contracts a·b + c
into fused multiply-adds (23 % of a·b + c differ from the unfused
product-then-sum in float64 on the CPU), and torch's vectorized sin, cos
and sqrt differ from the ones XLA calls in the last bit for 0.2-0.8 % of
inputs. The port's one step equals JAX's op-by-op step bit for bit; over a
march the two drift apart by rounding, and the controller amplifies it:
its error estimate cancels to ~1e-8 of its terms, so the step sizes differ
by ~1e-9 relative and the KerrBL scene's escaped lanes end up to 2.5e-9
apart (its payloads 2.3e-10). So the final states are held at 1e-8 (the
port's color bar against JAX) and the payloads at 1e-9. The final state
of a HORIZON lane in a chart that is singular at the horizon (KerrBL,
Schwarzschild: coordinate time and the momentum grow without bound there)
is held to its stop code only.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_raytracer_tpu import config as jcfg
from gr_raytracer_tpu.rendering import camera as jcam
from gr_raytracer_tpu.rendering import integrator as jint
from gr_raytracer_tpu.rendering import rkf45 as jrk
from gr_raytracer_tpu.rendering import scene as jscn
from gr_raytracer_tpu_torch import config as tcfg
from gr_raytracer_tpu_torch.rendering import camera as tcam
from gr_raytracer_tpu_torch.rendering import integrator as tint
from gr_raytracer_tpu_torch.rendering import rkf45 as trk
from gr_raytracer_tpu_torch.rendering import scene as tscn
from gr_raytracer_tpu_torch.ops import geodesic_march as tgm
from gr_raytracer_tpu_torch.ops import volumetric_adjoint as tva
from gr_raytracer_tpu_torch.ops import volumetric_march as tvm
from gr_raytracer_tpu_torch.rendering import fast_path as tfp
from gr_raytracer_tpu_torch.rendering import raytracer as trt
from test_golden_frames import SCENES
from torch.utils._python_dispatch import TorchDispatchMode
from torch_port_scenes import CPU, F64, lane_relative_error, pixel_grid, t

RTOL = 1e-9
STATE_RTOL = 1e-8
# The golden scenes' frame options (tests/test_golden_frames.py render()),
# on a smaller grid and budget.
ROWS, COLS = 8, 8
OPTIONS = dict(width=COLS, height=ROWS, max_steps=2000, max_radius=30.0, step_size=0.05)
GEOMETRIES = ("kerr_ks_disc_sphere", "kerr_bl_disc", "schwarzschild_disc")


def _scenes(name, **extra):
    toml, camera = SCENES[name]
    kw = dict(OPTIONS, **camera, **extra)
    j_scene = jcfg.create_scene(jcfg.parse_config(toml), jcfg.RenderOptions(**kw), jnp.float64)
    t_scene = tcfg.create_scene(tcfg.parse_config(toml), tcfg.RenderOptions(**kw), F64, CPU)
    return j_scene, t_scene


@pytest.fixture(scope="module")
def all_rays():
    """Per scene of GEOMETRIES: (name, JAX scene, port scene, JAX x, p,
    port x, p) of the 8×8 frame."""
    out = []
    rr, cc = pixel_grid(ROWS, COLS)
    for name in GEOMETRIES:
        j_scene, t_scene = _scenes(name)
        jx, jp = jcam.pixel_rays(j_scene.camera, jnp.asarray(rr), jnp.asarray(cc))
        tx, tp = tcam.pixel_rays(t_scene.camera, t(rr), t(cc))
        out.append((name, j_scene, t_scene, jx, jp, tx, tp))
    return out


def _states(j_scene, t_scene, jx, jp, tx, tp):
    jsol, tsol = j_scene.geometry.make_solver(jx, jp), t_scene.geometry.make_solver(tx, tp)
    return jsol, tsol, jsol.initial_state(jx, jp), tsol.initial_state(tx, tp)


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_rkf45_step_and_controller_match_jax(all_rays):
    """One trial step of each solver from the camera states at two step
    sizes; the controller on seeded errors
    around ε with zeros, NaNs and lanes at H_MIN."""
    for rays in all_rays:
        _, j_scene, t_scene, jx, jp, tx, tp = rays
        jsol, tsol, jy0, ty0 = _states(j_scene, t_scene, jx, jp, tx, tp)
        n = jy0.shape[0]
        rng = np.random.default_rng(0)
        for h in (0.05, 0.5):
            hh = rng.uniform(0.5, 1.0, n) * h
            jy, je = jrk.rkf45_step(jsol.rhs, jy0, jnp.asarray(hh))
            ty, te = trk.rkf45_step(tsol.rhs, ty0, t(hh))
            assert lane_relative_error(jy, ty.numpy()) < 1e-13
            _close(te, je, 1e-13)
    eps = 1e-5
    err = eps * 10 ** rng.uniform(-7, 2, 512)
    err[:8] = 0.0
    err[8:12] = np.nan
    h = 10 ** rng.uniform(-12.5, 0.5, 512)
    h[12:20] = trk.H_MIN
    for got, want in zip(trk.controller(t(h), t(err), eps), jrk.controller(jnp.asarray(h), jnp.asarray(err), eps)):
        if got.dtype == torch.bool:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            _close(got, want, 1e-13)


def test_solver_rhs_and_stop_tests_match_jax(all_rays):
    """rhs at the camera states and along a step, the horizon and trapped
    tests and the constants of motion; the disc's and the sphere's segment
    tests on seeded segments."""
    rng = np.random.default_rng(1)
    start = np.concatenate([np.zeros((4000, 1)), rng.uniform(-7.0, 7.0, (4000, 3))], -1)
    end = start + np.concatenate([np.zeros((4000, 1)), rng.normal(size=(4000, 3))], -1)
    for jo, to in zip(all_rays[0][1].objects, all_rays[0][2].objects):  # the disc, the sphere
        jh, th = jo.segment_hit(jnp.asarray(start), jnp.asarray(end)), to.segment_hit(t(start), t(end))
        np.testing.assert_array_equal(th[0].numpy(), np.asarray(jh[0]))
        assert th[0].any()
        for got, want in zip(th[1:], jh[1:]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    for rays in all_rays:
        _, j_scene, t_scene, jx, jp, tx, tp = rays
        jsol, tsol, jy0, ty0 = _states(j_scene, t_scene, jx, jp, tx, tp)
        jg, tg = j_scene.geometry, t_scene.geometry
        for s in (0.0, 0.7, 2.5):
            jy = jy0 + s * jsol.rhs(jy0) / jnp.maximum(jnp.abs(jsol.rhs(jy0)).max(axis=-1, keepdims=True), 1.0)
            ty = t(jy)
            assert lane_relative_error(jsol.rhs(jy), tsol.rhs(ty).numpy()) < 1e-12
            jxx, txx = jy[..., :4], ty[..., :4]
            np.testing.assert_array_equal(tg.inside_horizon(txx).numpy(), np.asarray(jg.inside_horizon(jxx)))
            steps = np.full(jxx.shape[0], 1999, np.int32)
            np.testing.assert_array_equal(tg.closed_orbit(txx, t(steps), 2000).numpy(),
                                          np.asarray(jg.closed_orbit(jxx, jnp.asarray(steps), 2000)))
            jc, tc = jg.constants_of_motion(jxx, jsol.momentum(jy)), tg.constants_of_motion(txx, tsol.momentum(ty))
            assert sorted(jc) == sorted(tc) and jc
            for k in jc:
                _close(tc[k], jc[k], 1e-12)
        # Inside the horizon, and trapped only at the budget's last step.
        inside = ty0.clone()
        inside[:, 1:4] = inside[:, 1:4] * 0.0 + (0.3 if tg.chart == "cartesian" else torch.tensor([0.6, 1.0, 0.5]))
        assert tg.inside_horizon(inside[:, :4]).all()
        steps = torch.full((inside.shape[0],), 10, dtype=torch.int32)
        assert not tg.closed_orbit(inside[:, :4], steps, 2000).any() and tg.closed_orbit(inside[:, :4], steps, 11).all()


def _integrate(j_scene, t_scene, jx, jp, tx, tp, **kw):
    jsol, tsol, jy0, ty0 = _states(j_scene, t_scene, jx, jp, tx, tp)
    jr = jint.integrate_rays(j_scene.geometry, jsol, j_scene.integration, jy0, jscn._segment_fn(j_scene),
                             jscn.EVENT_WIDTH, **kw)
    tr = tint.integrate_rays(t_scene.geometry, tsol, t_scene.integration, ty0, tscn._segment_fn(t_scene),
                             tscn.EVENT_WIDTH, **kw)
    return jr, tr


def _hold(jr, tr, what, horizon_ok=True):
    np.testing.assert_array_equal(tr.stop_code.numpy(), np.asarray(jr.stop_code), err_msg=what)
    np.testing.assert_array_equal(tr.steps.numpy(), np.asarray(jr.steps), err_msg=what)
    np.testing.assert_array_equal(tr.ev_kind.numpy(), np.asarray(jr.ev_kind), err_msg=what)
    np.testing.assert_array_equal(tr.ev_count.numpy(), np.asarray(jr.ev_count), err_msg=what)
    np.testing.assert_array_equal(tr.ev_overflow.numpy(), np.asarray(jr.ev_overflow), err_msg=what)
    keep = np.ones(tr.y.shape[0], bool)
    if tr.y.shape[0] and not horizon_ok:
        keep = tr.stop_code.numpy() != tint.HORIZON
    assert lane_relative_error(np.asarray(jr.y)[keep], tr.y.numpy()[keep]) < STATE_RTOL, what
    assert lane_relative_error(jr.ev_data, tr.ev_data.numpy()) < RTOL, what


def test_integrate_rays_matches_jax(all_rays):
    most = 0
    for rays in all_rays:
        name, j_scene, t_scene, jx, jp, tx, tp = rays
        jr, tr = _integrate(j_scene, t_scene, jx, jp, tx, tp)
        _hold(jr, tr, name, t_scene.geometry.chart == "cartesian")
        stops = set(tr.stop_code.tolist())
        assert {tint.HORIZON, tint.CELESTIAL} <= stops, (name, stops)
        assert (tr.ev_count > 0).any()
        most = max(most, int(tr.ev_count.max()))
        if name == "kerr_ks_disc_sphere":  # the sphere (kind 1) lands in some slot
            assert (tr.ev_kind == 1).any() and (tr.ev_kind == 0).any()
        keep = (tr.stop_code != tint.HORIZON).numpy()
        assert lane_relative_error(np.asarray(jr.affine)[keep], tr.affine.numpy()[keep]) < STATE_RTOL
        assert lane_relative_error(np.asarray(jr.h)[keep], tr.h.numpy()[keep]) < 1e-6
    assert most >= 2  # a lane with two crossings

def test_resume_in_two_legs_equals_one_shot(all_rays):
    """Leg 1 runs half the slowest lane's iterations with finalize off, leg
    2 resumes every lane on the same lanes in the same order: the two legs
    give the one shot's results bit for bit. On the KerrBL scene each leg is
    also held against JAX's."""
    for name, j_scene, t_scene, jx, jp, tx, tp in all_rays:
        jsol, tsol, jy0, ty0 = _states(j_scene, t_scene, jx, jp, tx, tp)
        seg = tscn._segment_fn(t_scene)
        march = lambda **kw: tint.integrate_rays(t_scene.geometry, tsol, t_scene.integration, ty0, seg,
                                                 tscn.EVENT_WIDTH, **kw)
        one = march()
        first = int(one.steps.max()) // 2
        tl1 = march(attempts_budget=first, finalize=False)
        assert (tl1.stop_code == tint.RUNNING).any() and not (one.stop_code == tint.RUNNING).any()
        tl2 = march(resume=tl1)
        for k, v in one._asdict().items():
            assert torch.equal(v, getattr(tl2, k)), (name, k)
        if name == "kerr_bl_disc":
            jmarch = lambda **kw: jint.integrate_rays(j_scene.geometry, jsol, j_scene.integration, jy0,
                                                      jscn._segment_fn(j_scene), jscn.EVENT_WIDTH, **kw)
            jl1 = jmarch(attempts_budget=first, finalize=False)
            _hold(jl1, tl1, name, False)
            _hold(jmarch(resume=jl1), tl2, name, False)


def test_track_invariants_match_jax(all_rays):
    """The invariant monitor on the Kerr-Schild and KerrBL scenes: max |k·k|
    and each constant's max relative drift within 1e-6 of JAX's (both are
    differences of nearly equal quantities) on the lanes that do not end at
    the horizon, the march unchanged."""
    for name, j_scene, t_scene, jx, jp, tx, tp in all_rays[:2]:
        j_scene = j_scene.replace(integration=j_scene.integration.replace(track_invariants=True))
        t_scene = dataclasses.replace(
            t_scene, integration=dataclasses.replace(t_scene.integration, track_invariants=True))
        jr, tr = _integrate(j_scene, t_scene, jx, jp, tx, tp)
        _hold(jr, tr, name, t_scene.geometry.chart == "cartesian")
        assert tr.const_drift.shape == jr.const_drift.shape and tr.const_drift.shape[1] >= 2
        assert (tr.kk_drift > 0).any() and np.isfinite(tr.kk_drift.numpy()).all()
        # A HORIZON lane's last steps near the hole make its drift there.
        keep = (tr.stop_code != tint.HORIZON).numpy()
        np.testing.assert_allclose(tr.kk_drift.numpy()[keep], np.asarray(jr.kk_drift)[keep], rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(tr.const_drift.numpy()[keep], np.asarray(jr.const_drift)[keep], rtol=1e-6,
                                   atol=1e-12)


# Ops a CUDA graph cannot capture: each waits for the device or copies host
# data to it.
_HOST_OPS = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select", "aten.lift_fresh",
             "aten.is_nonzero")


class _HostOps(TorchDispatchMode):
    """Records the host-bound ops that run inside the block, boolean-mask
    indexing (a hidden nonzero) among them."""

    def __init__(self):
        super().__init__()
        self.found = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        masks = [i for a in args if isinstance(a, (list, tuple)) for i in a
                 if isinstance(i, torch.Tensor) and i.dtype == torch.bool]
        if name in _HOST_OPS or (name.startswith("aten.index") and masks):
            self.found.add(name)
        return func(*args, **(kwargs or {}))


def test_loop_bodies_run_without_host_sync(monkeypatch):
    """A gas disc, a thin disc and a sphere around a Kerr hole in both
    charts, traced on the split path through the plain K1 and K3 marches
    (disc, sphere and volume events) and K5's plain raymarch, and with
    lax=True through this path's march and raymarch; then K7's plain
    march on the gas lanes. One iteration of every loop they hand to
    run_lanes, on its running lanes, holds no op that a CUDA graph cannot
    capture; the plain steps take their card branch (no early-out on an
    empty event test)."""
    seen = {}
    inner = tint.run_lanes

    def scan(step, state, lanes, running, max_iters, compact=True, name="march", **kw):
        idx = torch.nonzero(running(state)).flatten()
        sub = kw.get("take", tint._take_rows)(state, idx)
        with _HostOps() as ops:
            step(sub, {k: v[idx] for k, v in lanes.items()})
        seen.setdefault(name, set()).update(ops.found)
        return inner(step, state, lanes, running, max_iters, compact, name, **kw)

    monkeypatch.setattr(tint, "run_lanes", scan)
    monkeypatch.setattr(tgm, "_any_lane", lambda mask: True)
    gas = SCENES["schwarzschild_volumetric"][0].split("[[objects]]")[1].replace("max_steps = 400", "max_steps = 40")
    objects = gas + """[[objects]]
[objects.Disc]
inner_radius = 7.0
outer_radius = 9.0
temperature = 4000.0
[objects.Disc.texture.BlackBody]
beaming_exponent = 0.0
[[objects]]
[objects.Sphere]
radius = 1.6
position = [0.0, 0.0, 0.0]
temperature = 0.0
[objects.Sphere.texture.Checker]
beaming_exponent = 0.0
width = 8.0
height = 8.0
color1 = [255, 120, 0]
color2 = [120, 40, 0]
"""
    opts = tcfg.RenderOptions(width=6, height=6, max_steps=60, max_radius=20.0, step_size=0.05,
                              **SCENES["schwarzschild_volumetric"][1])
    rr, cc = pixel_grid(6, 6)
    for chart in ("Kerr", "KerrBL"):
        toml = SCENES["schwarzschild_volumetric"][0].split("[geometry_type")[0] + (
            f"[geometry_type.{chart}]\nradius = 1.0\na = 0.45\nhorizon_epsilon = 1e-3\n[[objects]]") + objects
        scene = tcfg.create_scene(tcfg.parse_config(toml), opts, F64, CPU)
        assert trt._route(scene, lax=False) == "split"
        for lax in (False, True):
            trt.trace_pixels_chunked(scene, rr, cc, chunk_size=36, lax=lax)
    x, p = tcam.pixel_rays(scene.camera, t(rr), t(cc))
    g = tfp.trace_geometric_fast(scene, x, p, tfp.scene_kernel_spec(scene))
    gas_disc = scene.objects[0]
    _, lanes = tfp.volumetric_lanes(gas_disc, g.ev_kind, g.ev_data, g.observer_energy, g.p_t, g.p_phi, 0)
    spec = tvm.build_vol_spec(gas_disc, scene.geometry)
    med = t([8.0, 0.0, 0.6, 0.4, 4000.0])
    tva.vol_march_bwd_plain(spec, med, *lanes, torch.ones((lanes[0].shape[0], tva.CT_VARS), dtype=F64))
    assert {"march", "raymarch", "plain"} <= set(seen), seen
    assert not any(seen.values()), seen
