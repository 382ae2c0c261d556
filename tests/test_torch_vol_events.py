"""Bounding-volume events of the port's marches (K1's and K3's plain
versions) against the JAX kernels kerr_rk4_march and kerr_bl_rk4_march in
interpret mode, float64.

The rays are 32×32 frames of the test volumetric disc (inner 3, outer 6,
thickness 0.1: caps at ±0.3), from a camera below the disc plane, so that
rays cross the slab, pass through the hole and miss it. Stop codes, steps,
event counts and kinds and overflow flags equal; states and event payloads
within 1e-9 of each lane's scale."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_raytracer_tpu.ops import geodesic_pallas as gp
from gr_raytracer_tpu_torch import config as tcfg
from gr_raytracer_tpu_torch.ops import geodesic_march as gm
from gr_raytracer_tpu_torch.rendering import camera as tcam
from gr_raytracer_tpu_torch.rendering import fast_path as tfp
from test_pallas import KERR_VOLUMETRIC_SCENE
from torch_port_scenes import CPU, F64, lane_relative_error, pixel_grid, t

MAX_STEPS = 600
MAX_RADIUS = 30.0
RTOL = 1e-9
CAMERA = dict(camera_position=(-12.0, 0.0, -1.5), theta=1.52, psi=-1.57)
BL_CAMERA = dict(camera_position=(-10.0, 0.0, -0.5), theta=-3.14159)


def _frame(geometry, camera):
    """(march spec, y0 and for the Mino march e, l_z, q as numpy) of a 32×32
    frame of the test volumetric scene in `geometry`."""
    cfg = tcfg.parse_config(KERR_VOLUMETRIC_SCENE)
    cfg = dataclasses.replace(cfg, geometry_type=dict(cfg.geometry_type, kind=geometry))
    opts = tcfg.RenderOptions(width=32, height=32, max_steps=MAX_STEPS, max_radius=MAX_RADIUS, **camera)
    scene = tcfg.create_scene(cfg, opts, F64, CPU)
    x, p = tcam.pixel_rays(scene.camera, *(t(a) for a in pixel_grid(32, 32)))
    solver, y0, _, _ = tfp._prepare_march(scene, x, p)
    spec = tfp.scene_kernel_spec(scene)
    assert len(spec.vols) == 1 and not spec.discs and not spec.opaque
    consts = (solver.e.numpy(), solver.l_z.numpy(), solver.q.numpy()) if spec.mino else ()
    return spec, y0.numpy(), consts


def _jax_vols(vols):
    return tuple(gp.VolSpec(*v) for v in vols)


def _assert_same(ref, got):
    y_r, stop_r, steps_r, kind_r, data_r, count_r, ovf_r = ref
    y_g, stop_g, steps_g, kind_g, data_g, count_g, ovf_g = got
    np.testing.assert_array_equal(stop_g, stop_r)
    np.testing.assert_array_equal(steps_g, steps_r)
    np.testing.assert_array_equal(count_g, count_r)
    np.testing.assert_array_equal(kind_g, kind_r)
    np.testing.assert_array_equal(ovf_g, ovf_r)
    assert lane_relative_error(y_r, y_g) <= RTOL
    assert lane_relative_error(data_r, data_g) <= RTOL


def _assert_crossings(count, kind, vol_kind):
    """The frame has rays with no crossing, one, and several (in and out of
    the slab, through the hole), and every recorded event is the volume's."""
    counts = np.bincount(count, minlength=3)
    assert counts[0] > 0 and counts[1:].sum() > 50 and counts[2:].sum() > 10, counts
    assert set(np.unique(kind[kind >= 0])) == {vol_kind}


def test_ks_march_volume_events_match_jax_kernel():
    spec, y0, _ = _frame("Kerr", CAMERA)
    args = (spec.radius, spec.a, spec.horizon_epsilon)
    kw = dict(h0=1.0, max_steps=MAX_STEPS, max_radius=MAX_RADIUS, r_safe=spec.r_safe)
    ref = gp.kerr_rk4_march(*args, jnp.asarray(y0), vols=_jax_vols(spec.vols), interpret=True, **kw)
    ref = [np.asarray(a) for a in ref]
    got = [a.numpy() for a in gm.kerr_rk4_march(*args, t(y0), vols=spec.vols, **kw)]
    _assert_same(ref, got)
    _assert_crossings(got[5], got[3], spec.vols[0].kind)
    # A thin disc beside the volume: its events come first within a step.
    disc = gm.DiscSpec(6.5, 12.0, 1)
    vol = spec.vols[0]._replace(kind=0)
    ref = gp.kerr_rk4_march(*args, jnp.asarray(y0), discs=(gp.DiscSpec(*disc),),
                            vols=_jax_vols((vol,)), interpret=True, **kw)
    got = gm.kerr_rk4_march(*args, t(y0), discs=(disc,), vols=(vol,), **kw)
    _assert_same([np.asarray(a) for a in ref], [a.numpy() for a in got])
    assert set(np.unique(got[3].numpy())) == {-1, 0, 1}


def test_bl_march_volume_events_match_jax_kernel():
    spec, y0, consts = _frame("KerrBL", BL_CAMERA)
    args = (spec.radius, spec.a, spec.horizon_epsilon)
    kw = dict(h0=0.01, max_steps=2 * MAX_STEPS, max_radius=MAX_RADIUS)
    ref = gp.kerr_bl_rk4_march(*args, jnp.asarray(y0), *(jnp.asarray(c) for c in consts),
                               vols=_jax_vols(spec.vols), interpret=True, **kw)
    ref = [np.asarray(a) for a in ref]
    got = [a.numpy() for a in gm.kerr_bl_rk4_march(*args, t(y0), *(t(c) for c in consts), vols=spec.vols, **kw)]
    _assert_same(ref, got)
    _assert_crossings(got[5], got[3], spec.vols[0].kind)


def test_event_capacity_is_the_buffer_width():
    """With max_events slots a lane keeps its first events and flags the
    rest as overflow: the render driver's re-trace of overflowing rays relies on
    it."""
    spec, y0, _ = _frame("Kerr", CAMERA)
    args = (spec.radius, spec.a, spec.horizon_epsilon, t(y0), 1.0, MAX_STEPS, MAX_RADIUS)
    kw = dict(vols=spec.vols, r_safe=spec.r_safe)
    full = gm.kerr_rk4_march(*args, **kw)
    few = gm.kerr_rk4_march(*args, max_events=2, **kw)
    assert few[3].shape == (1024, 2) and few[4].shape == (1024, 2, 12)
    assert torch.equal(few[3], full[3][:, :2]) and torch.equal(few[4], full[4][:, :2])
    assert torch.equal(few[5], torch.clamp(full[5], max=2))
    assert torch.equal(few[6], full[5] > 2) and bool(few[6].any())
    assert all(torch.equal(a, b) for a, b in zip(few[:3], full[:3]))
    with pytest.raises(ValueError):
        gm.kerr_rk4_march(*args, max_events=0, **kw)


def test_wrappers_check_volume_specs():
    y0 = torch.zeros((4, 8), dtype=F64)
    args = (1.0, 0.45, 1e-3, y0, 1.0, 10, 40.0)
    vol = gm.VolSpec(3.0, 6.0, 0.3, 0)
    with pytest.raises(NotImplementedError):
        gm.kerr_rk4_march(*args, vols=(vol,) * (gm.MAX_VOLS + 1))
    with pytest.raises(TypeError):
        gm.kerr_rk4_march(*args, vols=((3.0, 6.0, 0.3, 0),))
    # A lane that never leaves the axis far above the caps records nothing.
    y0[:, 3] = 5.0
    y0[:, 7] = 1.0
    y0[:, 4] = -1.0
    out = gm.kerr_rk4_march(*args, vols=(vol,))
    assert (out[5] == 0).all() and (out[3] == -1).all()


@pytest.mark.cuda
def test_cuda_marches_record_the_plain_volume_events():
    """K1 and K3 with a volume against their plain versions on the card:
    equal outputs, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for geometry, camera in (("Kerr", CAMERA), ("KerrBL", BL_CAMERA)):
        spec, y0, consts = _frame(geometry, camera)
        args = (spec.radius, spec.a, spec.horizon_epsilon, t(y0).cuda(), *(t(c).cuda() for c in consts))
        if spec.mino:
            kw = dict(h0=0.01, max_steps=2 * MAX_STEPS, max_radius=MAX_RADIUS, vols=spec.vols)
            kernel, plain = gm.kerr_bl_rk4_march, gm.march_bl_plain
        else:
            kw = dict(h0=1.0, max_steps=MAX_STEPS, max_radius=MAX_RADIUS, r_safe=spec.r_safe, vols=spec.vols)
            kernel, plain = gm.kerr_rk4_march, gm.march_plain
        got, ref = kernel(*args, **kw), plain(*args, **kw)
        for g, r in zip(got, ref):
            assert torch.equal(g, r) or bool(((g == r) | (g.isnan() & r.isnan())).all())
