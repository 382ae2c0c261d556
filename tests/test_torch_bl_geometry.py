"""The port's spherical and Boyer-Lindquist charts, KerrBL and Schwarzschild
geometries, and scene assembly for kerr-bl.toml and a Schwarzschild disc
scene, against the JAX package in float64 on the CPU (1e-12)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_raytracer_tpu import config as jcfg
from gr_raytracer_tpu.geometry import chart as jchart
from gr_raytracer_tpu.geometry import kerr_bl as jbl
from gr_raytracer_tpu.geometry.schwarzschild import Schwarzschild as JSchwarzschild
from gr_raytracer_tpu.rendering import camera as jcam
from gr_raytracer_tpu_torch import config as tcfg
from gr_raytracer_tpu_torch.geometry import chart as tchart
from gr_raytracer_tpu_torch.geometry import kerr_bl as tbl
from gr_raytracer_tpu_torch.geometry.schwarzschild import Schwarzschild as TSchwarzschild
from torch_port_scenes import (
    BL_CAMERA, CPU, F64, KERR_BL_TOML, REPO, SCHWARZSCHILD_DISC_TOML, pixel_grid, t,
)

TOL = 1e-12


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _bl_points(n=64, seed=1):
    """[n, 4] BL/spherical points off the poles and outside the horizon."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.normal(size=n), rng.uniform(2.0, 30.0, n), rng.uniform(0.2, 2.9, n),
                     rng.uniform(-3.0, 3.0, n)], axis=-1)


def test_spherical_and_bl_charts_match_jax():
    rng = np.random.default_rng(0)
    p = _bl_points()
    cart = np.concatenate([rng.normal(size=(64, 1)), rng.normal(size=(64, 3)) * 8.0], axis=-1)
    vec = rng.normal(size=(64, 4))
    angles = rng.uniform(-10.0, 10.0, 64)
    _close(tchart.wrap_theta(t(angles)), jchart.wrap_theta(jnp.asarray(angles)))
    _close(tchart.wrap_phi(t(angles)), jchart.wrap_phi(jnp.asarray(angles)))
    for chart, a in ((tchart.SPHERICAL, 0.0), (tchart.BOYER_LINDQUIST, 0.499)):
        _close(tchart.to_cartesian(t(p), chart, a), jchart.to_cartesian(jnp.asarray(p), chart, a))
        _close(tchart.from_cartesian(t(cart), chart, a), jchart.from_cartesian(jnp.asarray(cart), chart, a))
        _close(tchart.from_cartesian(tchart.to_cartesian(t(p), chart, a), chart, a), p, 1e-10)
        for got, want in zip(tchart.get_as_spherical(t(p), chart), jchart.get_as_spherical(jnp.asarray(p), chart)):
            _close(got, want)
        _close(tchart.spatial_vector_to_cartesian(t(p), t(vec), chart, a),
               jchart.spatial_vector_to_cartesian(jnp.asarray(p), jnp.asarray(vec), chart, a))
    with pytest.raises(ValueError):
        tchart.from_cartesian(t(cart), "polar")


def _geometries(a=0.499):
    j = jbl.KerrBL(radius=jnp.asarray(1.0), a=jnp.asarray(a), horizon_epsilon=jnp.asarray(1e-4))
    tg = tbl.KerrBL(radius=torch.tensor(1.0, dtype=F64), a=torch.tensor(a, dtype=F64),
                    horizon_epsilon=torch.tensor(1e-4, dtype=F64))
    return j, tg


def test_kerr_bl_metric_frames_and_velocities_match_jax():
    x = _bl_points()
    j, tg = _geometries()
    jx, tx = jnp.asarray(x), t(x)
    r, th = x[:, 1], x[:, 2]
    _close(tbl.metric_bl(tg.radius, tg.a, t(r), t(th)), jbl.metric_bl(j.radius, j.a, jnp.asarray(r), jnp.asarray(th)))
    _close(tbl.metric_bl_contravariant(tg.radius, tg.a, t(r), t(th)),
           jbl.metric_bl_contravariant(j.radius, j.a, jnp.asarray(r), jnp.asarray(th)))
    _close(tg.tetrad(tx), j.tetrad(jx), 1e-10)
    _close(tg.stationary_velocity(tx), j.stationary_velocity(jx))
    _close(tg.zamo_velocity(tx), j.zamo_velocity(jx))
    _close(tg.axial_killing(tx), j.axial_killing(jx))
    _close(tg.radial_coordinate(tx, tchart.CARTESIAN), j.radial_coordinate(jx, jchart.CARTESIAN))
    u_t, u_phi, ok = tg.orbit_coefficients_at_radius(t(r))
    w_t, w_phi, w_ok = j.orbit_coefficients_at_radius(jnp.asarray(r))
    _close(u_t, w_t)
    _close(u_phi, w_phi)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(w_ok))
    v = np.random.default_rng(2).normal(size=(64, 4))
    _close(tg.inner_product(tx, t(v), t(v)), j.inner_product(jx, jnp.asarray(v), jnp.asarray(v)))
    assert tg.spin is tg.a and tg.chart == tchart.BOYER_LINDQUIST


def test_kerr_bl_solver_matches_jax():
    """conserved_from_bl, initial_state and momentum on camera rays of
    kerr-bl.toml, including rays launched at a turning point."""
    j, tg = _geometries()
    pos = jchart.from_cartesian(jnp.asarray([0.0, *BL_CAMERA["camera_position"]]), j.chart, j.a)
    camera = jcam.build_camera(j, pos, j.stationary_velocity(pos), alpha=math.pi / 4, rows=16,
                               columns=16, theta=BL_CAMERA["theta"])
    rr, cc = pixel_grid(16, 16)
    x, p = jcam.pixel_rays(camera, jnp.asarray(rr), jnp.asarray(cc))
    for got, want in zip(tg.conserved_from_bl(t(x), t(p)), j.conserved_from_bl(x, p)):
        _close(got, want, 1e-10)
    js = j.make_solver(x, p)
    ts = tg.make_solver(t(x), t(p))
    _close(ts.initial_state(t(x), t(p)), js.initial_state(x, p), 1e-10)
    y = js.initial_state(x, p)
    _close(ts.momentum(t(y)), js.momentum(y), 1e-10)
    assert ts.chart == tchart.BOYER_LINDQUIST


def test_schwarzschild_matches_jax():
    x = _bl_points()
    v = np.random.default_rng(3).normal(size=(64, 4))
    j = JSchwarzschild(radius=jnp.asarray(1.0), horizon_epsilon=jnp.asarray(1e-4))
    tg = TSchwarzschild(radius=torch.tensor(1.0, dtype=F64), horizon_epsilon=torch.tensor(1e-4, dtype=F64))
    jx, tx = jnp.asarray(x), t(x)
    _close(tg.metric(tx), j.metric(jx))
    _close(tg.inner_product(tx, t(v), t(v)), j.inner_product(jx, jnp.asarray(v), jnp.asarray(v)))
    _close(tg.tetrad(tx), j.tetrad(jx))
    _close(tg.stationary_velocity(tx), j.stationary_velocity(jx))
    _close(tg.zamo_velocity(tx), j.zamo_velocity(jx))
    _close(tg.lorentz_transformation(tx, tg.stationary_velocity(tx)),
           j.lorentz_transformation(jx, j.stationary_velocity(jx)))
    u_t, u_phi, ok = tg.orbit_coefficients_at_radius(tx[:, 1])
    w_t, w_phi, w_ok = j.orbit_coefficients_at_radius(jx[:, 1])
    _close(u_t, w_t)
    _close(u_phi, w_phi)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(w_ok))
    _close(tg.circular_orbit_velocity(tx)[0], j.circular_orbit_velocity(jx)[0])
    assert tg.signature() == j.signature() and tg.spin == 0.0 and tg.chart == tchart.SPHERICAL
    # The RKF45 solver (its right-hand side is held in tests/test_torch_rkf45.py).
    ts, js = tg.make_solver(tx, t(v)), j.make_solver(jx, jnp.asarray(v))
    y = np.concatenate([x, v], axis=-1)
    _close(ts.initial_state(tx, t(v)), js.initial_state(jx, jnp.asarray(v)))
    _close(ts.momentum(t(y)), js.momentum(jnp.asarray(y)))


def test_create_scene_matches_jax():
    """kerr-bl.toml and the Schwarzschild disc scene: geometry, camera
    (position, velocity, boosted tetrad, handedness) and the disc's
    Novikov-Thorne table (at a = 0 for Schwarzschild). kerr-bl.toml's
    bitmap sky is swapped for a blackbody one here: decoding it takes most
    of a scene build, and tests/test_torch_bl_render.py renders it."""
    sky = {"celestial_texture": {"kind": "BlackBody", "beaming_exponent": 0.0}}
    for j_cfg, t_cfg in (
        (dataclasses.replace(jcfg.load_config(KERR_BL_TOML), **sky),
         dataclasses.replace(tcfg.load_config(KERR_BL_TOML), **sky)),
        (jcfg.parse_config(SCHWARZSCHILD_DISC_TOML, REPO), tcfg.parse_config(SCHWARZSCHILD_DISC_TOML, REPO)),
    ):
        j_scene = jcfg.create_scene(j_cfg, jcfg.RenderOptions(width=12, height=10, **BL_CAMERA), jnp.float64)
        t_scene = tcfg.create_scene(t_cfg, tcfg.RenderOptions(width=12, height=10, **BL_CAMERA), F64, CPU)
        assert type(t_scene.geometry).__name__ == type(j_scene.geometry).__name__
        for name in ("position", "velocity", "tetrad", "spatial_handedness"):
            _close(getattr(t_scene.camera, name), getattr(j_scene.camera, name))
        assert t_scene.camera.chart == j_scene.camera.chart
        (j_disc,), (t_disc,) = j_scene.objects, t_scene.objects
        _close(t_disc.temperature_model.r_isco, j_disc.temperature_model.r_isco)
        _close(t_disc.temperature_model.temps, j_disc.temperature_model.temps, 1e-9)


def test_turning_safe_sqrt_gradient_is_zero_at_and_below_the_floor():
    floor = tbl._POT_GRAD_FLOOR
    pot = torch.tensor([-1.0, 0.0, 0.5 * floor, floor, 2.0 * floor, 0.25, 4.0], dtype=F64, requires_grad=True)
    val = tbl._turning_safe_sqrt(pot)
    want = jax.vmap(jax.value_and_grad(jbl._turning_safe_sqrt))(jnp.asarray(pot.detach().numpy()))
    _close(val, want[0], 0.0)
    (grad,) = torch.autograd.grad(val.sum(), pot)
    assert (grad[:4] == 0.0).all()
    _close(grad, want[1], 1e-15)
    assert bool(torch.isfinite(grad).all())


def test_sphere_scene_still_raises_config_error():
    """schwarzschild.toml, whose loader raised before spheres were ported,
    now builds; its Sphere equals the JAX loader's."""
    path = f"{REPO}/scene-definitions/schwarzschild.toml"
    scene = tcfg.create_scene(tcfg.load_config(path), tcfg.RenderOptions(width=4, height=4, **BL_CAMERA), F64, CPU)
    j_cfg = jcfg.load_config(path)
    bitmap = type("Textures", (), {"build": lambda self, tex: tex["kind"]})()
    _, j_sphere = jcfg.build_objects(j_cfg, jcfg.build_geometry(j_cfg, jnp.float64), bitmap, jnp.float64)
    t_sphere = scene.objects[1]
    assert type(t_sphere).__name__ == type(j_sphere).__name__ == "Sphere"
    for name in ("radius", "center", "temperature"):
        _close(getattr(t_sphere, name), getattr(j_sphere, name), 0.0)
    np.testing.assert_array_equal(t_sphere.center.numpy(), [0.0, 0.0, 0.0, 20.0])
    assert math.isclose(BL_CAMERA["theta"], -3.14159)
