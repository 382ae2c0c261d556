"""`resume` of the port's marches against the JAX kernels' (the K1 and K3
options of gr_raytracer_tpu/ops/geodesic_pallas.py), float64 on the CPU.

A march of `attempts` iterations that ends with finalize=False hands its
seven results to the next call, which continues every lane: its state,
stop code, step count and events carry over, and max_steps stays the
lane's total budget. On three scenes (the flagship Kerr-Schild frame and
the KerrBL disc scene of tests/test_pallas.py's resume tests, and the
Kerr disc and sphere probe of tests/test_adjoint.py), leg 1 runs half the
slowest lane's steps, so that some lanes are still RUNNING after it:
- the plain two legs give one shot's seven results bit for bit;
- each leg matches the JAX package's `_run_kernel(..., attempts=,
  finalize=False)` and `(..., resume=)` in interpret mode on the same
  lanes: stop codes, steps, event kinds and counts equal, states and
  payloads within 1e-9 of each lane's scale.
Malformed resume tuples raise ValueError. On a card, two kernel legs are
held against one kernel shot.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_raytracer_tpu import config as jcfg
from gr_raytracer_tpu import presets as jpresets
from gr_raytracer_tpu.rendering import camera as jcam
from gr_raytracer_tpu.rendering import fast_path as jfp
from gr_raytracer_tpu.rendering import integrator as jinteg
from gr_raytracer_tpu_torch import config as tcfg
from gr_raytracer_tpu_torch.ops import geodesic_march as gm
from gr_raytracer_tpu_torch.rendering import fast_path as tfp
from gr_raytracer_tpu_torch.rendering import integrator as integ
from torch_port_scenes import (
    CPU, F64, KERR_BL_DISC_SCENE_OPTIONS, KERR_BL_DISC_SCENE_TOML, REPO, lane_relative_error, port_flagship,
    sphere_probe_scenes,
)

RTOL = 1e-9
NAMES = ("y", "stop", "steps", "ev_kind", "ev_data", "ev_count", "ev_overflow")


def _scenes(name):
    """(JAX scene, port scene, rows, cols): the same scene built by both."""
    if name == "ks":
        params = jpresets.kerr_flagship_params(jnp.float64)
        j_scene = jpresets.build_kerr_flagship(params, 8, 16, max_steps=2000, max_radius=40.0, step_size=0.05)
        return j_scene, port_flagship(8, 16), 8, 16
    if name == "bl":
        kw = dict(width=16, height=8, **KERR_BL_DISC_SCENE_OPTIONS)
        j_scene = jcfg.create_scene(jcfg.parse_config(KERR_BL_DISC_SCENE_TOML), jcfg.RenderOptions(**kw),
                                    jnp.float64)
        t_scene = tcfg.create_scene(tcfg.parse_config(KERR_BL_DISC_SCENE_TOML, REPO), tcfg.RenderOptions(**kw),
                                    F64, CPU)
        return j_scene, t_scene, 8, 16
    return (*sphere_probe_scenes(), 4, 8)


def _port_run(spec, scene, lanes, **kw):
    """The port's fast_path._run_kernel on the JAX march's lanes."""
    y0, e, l_z, q = lanes
    solver = types.SimpleNamespace(e=e, l_z=l_z, q=q)
    return tfp._run_kernel(spec, scene.integration, solver, y0, **kw)


def _numpy(state):
    return [np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for v in state]


@pytest.fixture(scope="module", params=["ks", "bl", "sphere"])
def legs(request):
    """One scene's lanes (the JAX package's padded, cost-sorted march
    inputs), the port's one shot and two legs, and the JAX kernel's two
    legs in interpret mode."""
    j_scene, t_scene, rows, cols = _scenes(request.param)
    rr, cc = jnp.meshgrid(jnp.arange(rows, dtype=jnp.float64), jnp.arange(cols, dtype=jnp.float64), indexing="ij")
    x, p = jcam.pixel_rays(j_scene.camera, rr.ravel(), cc.ravel())
    geo, solver, y0, _, _ = jfp._prepare_march(j_scene, x, p)
    j_spec = jfp.scene_kernel_spec(j_scene)
    spec = tfp.scene_kernel_spec(t_scene)
    assert spec.mino == (request.param == "bl") and bool(spec.spheres) == (request.param == "sphere")
    n = y0.shape[0]
    consts = (solver.e, solver.l_z, solver.q) if spec.mino else (np.zeros(n),) * 3
    lanes = tuple(torch.from_numpy(np.array(v)).contiguous() for v in (y0, *consts))

    one = _port_run(spec, t_scene, lanes)
    attempts = int(one[2].max()) // 2
    leg1 = _port_run(spec, t_scene, lanes, attempts=attempts, finalize=False)
    leg2 = _port_run(spec, t_scene, lanes, resume=leg1)
    cfg = j_scene.integration
    j_leg1 = jfp._run_kernel(geo, cfg, solver, y0, j_spec, interpret=True, attempts=attempts, finalize=False)
    j_leg2 = jfp._run_kernel(geo, cfg, solver, j_leg1[0], j_spec, interpret=True, resume=j_leg1)
    return {
        "spec": spec, "scene": t_scene, "lanes": lanes, "attempts": attempts, "one": one, "legs": (leg1, leg2),
        "jax": (_numpy(j_leg1), _numpy(j_leg2)),
    }


def _assert_equal(got, want):
    for name, g, w in zip(NAMES, _numpy(got), _numpy(want)):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_plain_two_legs_equal_one_shot(legs):
    leg1, leg2 = legs["legs"]
    assert legs["attempts"] >= 1
    # Leg 1 leaves lanes running, and leg 2 finishes them.
    assert (leg1[1] == integ.RUNNING).any() and not (leg2[1] == integ.RUNNING).any()
    _assert_equal(leg2, legs["one"])


def test_legs_match_jax_run_kernel(legs):
    for got, want in zip(legs["legs"], legs["jax"]):
        got = _numpy(got)
        for k in (1, 2, 3, 5, 6):
            np.testing.assert_array_equal(got[k], want[k], err_msg=NAMES[k])
        assert lane_relative_error(want[0], got[0]) <= RTOL
        assert lane_relative_error(want[4], got[4]) <= RTOL
    assert (legs["jax"][0][1] == jinteg.RUNNING).any()


def test_malformed_resume_raises():
    """A resume tuple must be the seven results of a march of the same N
    lanes, dtype and event slots."""
    y0 = torch.zeros((4, 8), dtype=F64)
    y0[:, 1] = 20.0
    y0[:, 4] = -1.0
    y0[:, 5] = 1.0
    args = (1.0, 0.45, 1e-3, y0, 1.0, 10, 40.0)
    c = torch.ones(4, dtype=F64)
    bl_args = (1.0, 0.45, 1e-3, y0, c, c, c, 0.01, 10, 40.0)
    for march, a in ((gm.kerr_rk4_march, args), (gm.kerr_bl_rk4_march, bl_args)):
        prev = march(*a, attempts=2, finalize=False)
        assert len(march(*a, resume=prev)) == 7
        bad = [
            prev[:6],  # six results
            (prev[0][:3],) + prev[1:],  # another N
            (prev[0].float(),) + prev[1:],  # another dtype
            prev[:1] + (prev[1].long(),) + prev[2:],  # i64 stop codes
            prev[:3] + (prev[3][:, :4],) + prev[4:],  # fewer event slots
        ]
        for resume in bad:
            with pytest.raises(ValueError):
                march(*a, resume=resume)
        with pytest.raises(ValueError):
            march(*a, resume=prev, max_events=gm.MAX_EVENTS + 1)


@pytest.mark.cuda
def test_cuda_two_legs_equal_one_shot():
    """K1 and K3 in two legs against one shot on the card (chip_smoke.py
    does the same at the main paths' size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name in ("ks", "bl"):
        j_scene, t_scene, rows, cols = _scenes(name)
        rr, cc = jnp.meshgrid(jnp.arange(rows, dtype=jnp.float64), jnp.arange(cols, dtype=jnp.float64),
                              indexing="ij")
        x, p = jcam.pixel_rays(j_scene.camera, rr.ravel(), cc.ravel())
        _, solver, y0, _, _ = jfp._prepare_march(j_scene, x, p)
        spec = tfp.scene_kernel_spec(t_scene)
        consts = (solver.e, solver.l_z, solver.q) if spec.mino else (np.zeros(y0.shape[0]),) * 3
        lanes = tuple(torch.from_numpy(np.array(v)).cuda().contiguous() for v in (y0, *consts))
        before = gm.launches + gm.bl_launches
        one = _port_run(spec, t_scene, lanes)
        leg1 = _port_run(spec, t_scene, lanes, attempts=int(one[2].max()) // 2, finalize=False)
        leg2 = _port_run(spec, t_scene, lanes, resume=leg1)
        assert gm.launches + gm.bl_launches == before + 3
        assert (leg1[1] == integ.RUNNING).any()
        _assert_equal(leg2, one)
