"""The port's RKF45-path volumetric disc (`VolumetricDisc.density`,
`segment_hit`, `raymarch`, `shade_events`) and the render driver's split
path against the JAX package, float64 on the CPU.

The scene is the gas disc of tests/test_golden_frames.py's
schwarzschild_volumetric frame (inner 2, outer 6, budget 400 samples of
0.02), z-axis and tilted (axis (0.2, 0, 1) normalized). Density and the
segment test at 1e-12; the raymarch (a compiled loop in JAX, whose fused
multiply-adds round differently) and colors at 1e-8 relative, the port's
color bar against JAX; stop codes, classes and hit sets equal:
- the split driver on the gas disc beside a sphere: the port's
  `trace_pixels_chunked(..., lax=True)` against the JAX driver, which on
  the CPU takes `_trace_chunk_split` with its lax geometric pass and lax
  raymarch;
- the tilted gas disc, which the kernel path does not take: the port's
  driver routes it to the split path's RKF45 forms.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_raytracer_tpu import config as jcfg
from gr_raytracer_tpu.rendering import camera as jcam
from gr_raytracer_tpu.rendering import raytracer as jrt
from gr_raytracer_tpu.rendering import scene as jscn
from gr_raytracer_tpu.rendering.redshift import ray_frequency_data as jfreq
from gr_raytracer_tpu_torch import config as tcfg
from gr_raytracer_tpu_torch.objects.volumetric_disc import VolumetricDisc
from gr_raytracer_tpu_torch.rendering import camera as tcam
from gr_raytracer_tpu_torch.rendering import fast_path as tfp
from gr_raytracer_tpu_torch.rendering import integrator as tint
from gr_raytracer_tpu_torch.rendering import raytracer as trt
from gr_raytracer_tpu_torch.rendering.redshift import ray_frequency_data as tfreq
from test_golden_frames import SCENES
from torch_port_scenes import CPU, F64, lane_relative_error, pixel_grid, t

COLOR_TOL = 1e-8
ROWS, COLS = 8, 8
OPTIONS = dict(width=COLS, height=ROWS, max_steps=2000, max_radius=30.0, step_size=0.05)
TILT = (0.2, 0.0, 1.0)
GAS_TOML, CAMERA = SCENES["schwarzschild_volumetric"]
SPHERE = """
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


def _tilted(obj):
    """The port's disc with its axis and in-plane basis turned to TILT."""
    ref = VolumetricDisc.create(1.0, 2.0, None, None, axis=TILT, dtype=obj.axis.dtype)
    return dataclasses.replace(obj, axis=ref.axis, e1=ref.e1, e2=ref.e2)


def _scenes(toml=GAS_TOML, tilt=False):
    """(JAX scene, port scene): the port's loader takes the z axis only, so
    its tilted disc is turned after the build."""
    kw = dict(OPTIONS, **CAMERA)
    j_toml = toml.replace("axis = [0.0, 0.0, 1.0]", f"axis = {list(TILT)}") if tilt else toml
    j_scene = jcfg.create_scene(jcfg.parse_config(j_toml), jcfg.RenderOptions(**kw), jnp.float64)
    t_scene = tcfg.create_scene(tcfg.parse_config(toml), tcfg.RenderOptions(**kw), F64, CPU)
    if tilt:
        t_scene = dataclasses.replace(t_scene, objects=tuple(
            _tilted(o) if isinstance(o, VolumetricDisc) else o for o in t_scene.objects))
    return j_scene, t_scene


@pytest.fixture(scope="module")
def gas():
    """z-axis and tilted (JAX scene, port scene) pairs of the gas disc."""
    return {tilt: _scenes(tilt=tilt) for tilt in (False, True)}


def _points(rng, n):
    """Points in and around the gas: radii 0.5-7, heights within ±0.8."""
    r = rng.uniform(0.5, 7.0, n)
    phi = rng.uniform(-np.pi, np.pi, n)
    return np.stack([r * np.cos(phi), r * np.sin(phi), rng.uniform(-0.8, 0.8, n)], axis=-1)


def test_density_and_segment_hit_match_jax(gas):
    rng = np.random.default_rng(0)
    for tilt, (j_scene, t_scene) in gas.items():
        (jo,), (to,) = j_scene.objects, t_scene.objects
        np.testing.assert_allclose(to.axis.numpy(), np.asarray(jo.axis), rtol=0, atol=1e-15)
        p = _points(rng, 4000)
        want = np.asarray(jo.density(jnp.asarray(p)))
        got = to.density(t(p)).numpy()
        assert (want > 0).mean() > 0.2 and (want == 0).any()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * want.max())
        np.testing.assert_allclose(torch.stack(to.uv(t(p)), -1).numpy(), np.stack(jo.uv(jnp.asarray(p)), -1),
                                   rtol=1e-12, atol=1e-12)
        # Segments from a point toward another: many cross the boundary.
        s, e = _points(rng, 4000), _points(rng, 4000)
        cs = np.concatenate([np.zeros((4000, 1)), s], -1)
        ce = np.concatenate([np.zeros((4000, 1)), s + 0.3 * (e - s)], -1)
        jh = jo.segment_hit(jnp.asarray(cs), jnp.asarray(ce))
        th = to.segment_hit(t(cs), t(ce))
        np.testing.assert_array_equal(th[0].numpy(), np.asarray(jh[0]))
        assert th[0].float().mean() > 0.1, tilt
        for got, want in zip(th[1:], jh[1:]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def _jax_march(j_scene):
    """The JAX package's RKF45 march of the 8×8 frame, with its frequency
    data."""
    x, p = jcam.pixel_rays(j_scene.camera, *(jnp.asarray(a) for a in pixel_grid(ROWS, COLS)))
    solver = j_scene.geometry.make_solver(x, p)
    res = jscn.integ.integrate_rays(j_scene.geometry, solver, j_scene.integration, solver.initial_state(x, p),
                                    jscn._segment_fn(j_scene), jscn.EVENT_WIDTH)
    return jfreq(j_scene.geometry, x, p, j_scene.camera.velocity), res


def test_raymarch_and_shade_events_match_jax(gas):
    """The JAX march's event buffer of the tilted disc's frame shaded by
    both packages' shade_events, and the raymarch on its volumetric slots,
    compacted in the port: equal hit sets, XYZA within 1e-8 of each slot's
    scale; a compacted march equals one over every lane (compact=False on
    the CPU), and one of 7 samples a loop iteration equals it within
    1e-12. (The z-axis disc's raymarch is held through the split driver
    below.)"""
    for tilt, (j_scene, t_scene) in [(True, gas[True])]:
        jf, jres = _jax_march(j_scene)
        (jo,), (to,) = j_scene.objects, t_scene.objects
        # Shade JAX's own buffer in both packages, so only the raymarch differs.
        tres = tint.IntegrationResult(
            t(jres.y), t(jres.stop_code), t(jres.steps), t(jres.ev_kind), t(jres.ev_data), t(jres.ev_count),
            t(jres.ev_overflow))
        tf = tfreq(t_scene.geometry, *tcam.pixel_rays(t_scene.camera, *(t(a) for a in pixel_grid(ROWS, COLS))),
                   t_scene.camera.velocity)
        want = np.asarray(jo.shade_events(j_scene.geometry, jf, jres, 0))
        got = to.shade_events(t_scene.geometry, tf, tres, 0).numpy()
        live = np.asarray(jres.ev_kind) == 0
        assert live.sum() > 8 and (want[live][:, 3] > 0).mean() > 0.3, tilt
        assert (got[~live] == 0).all()
        assert lane_relative_error(want[live], got[live]) < COLOR_TOL, tilt
        # The raymarch over the live slots as lanes: compacted or not.
        n, k = live.shape
        ev = tres.ev_data.reshape(n * k, -1)[torch.from_numpy(live.reshape(-1))]
        seg = ev[:, 9:12]
        rd = seg / torch.sqrt((seg * seg).sum(-1, keepdim=True))
        ray = torch.from_numpy(np.nonzero(live.reshape(-1))[0] // k)
        ins = (ev[:, 0:3], rd, tf.observer_energy[ray], tf.p_t[ray], tf.p_phi[ray],
               torch.ones(ray.shape, dtype=torch.bool))
        a = to.raymarch(t_scene.geometry, *ins)
        b = to.raymarch(t_scene.geometry, *ins, compact=False)
        assert torch.equal(a, b)
        # Several samples a loop iteration, as on the card, give each lane
        # the samples one at a time gives, the budget ending inside an
        # iteration included (7 does not divide it).
        assert to.max_steps % 7 != 0
        c = to.raymarch(t_scene.geometry, *ins, unroll=7)
        assert lane_relative_error(a.numpy(), c.numpy()) <= 1e-12


def _jax_driver(j_scene):
    rr, cc = pixel_grid(ROWS, COLS)
    # The lax raymarch batches are padded to the lane chunk; a small chunk
    # keeps the CPU run short and changes no lane's result.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrt, "VOLUMETRIC_LANE_CHUNK", 64)
        c, k, ok = jrt.trace_pixels_chunked(j_scene, rr, cc, chunk_size=ROWS * COLS)
    return c, k, ok


def _hold_frame(j_scene, t_scene, lax):
    rr, cc = pixel_grid(ROWS, COLS)
    c_r, k_r, ok_r = _jax_driver(j_scene)
    c, k, ok, stats = trt.trace_pixels_chunked(t_scene, rr, cc, chunk_size=ROWS * COLS, lax=lax)
    np.testing.assert_array_equal(k, k_r)
    np.testing.assert_array_equal(ok, ok_r)
    np.testing.assert_allclose(c, c_r, rtol=COLOR_TOL, atol=1e-12)
    return c, k, stats


def test_split_driver_with_a_sphere_matches_jax():
    """The gas disc beside a sphere in its inner hole: the split path."""
    j_scene, t_scene = _scenes(GAS_TOML + SPHERE)
    assert trt._route(t_scene, lax=True) == trt._route(t_scene, lax=False) == "split"
    c, k, stats = _hold_frame(j_scene, t_scene, lax=True)
    assert stats.vol_lanes > 0 and stats.vol_samples == 0  # no K5 lane on the lax split path
    assert {0, 2} <= set(np.unique(k).tolist())
    # (tests/test_torch_vol_render.py renders a split scene through the
    # kernel geometric pass and K5's plain version.)


def test_tilted_gas_disc_matches_jax(gas):
    j_scene, t_scene = gas[True]
    assert not tfp.supports_scene(t_scene) and trt._route(t_scene, lax=False) == "split"
    with pytest.raises(NotImplementedError):
        tfp.scene_kernel_spec(t_scene)
    c, k, stats = _hold_frame(j_scene, t_scene, lax=False)
    assert stats.vol_lanes > 0 and (k == 2).any()
