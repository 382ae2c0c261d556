"""Reverse mode through the port's RKF45 ("lax") path on what the kernel
path's gradient does not take, against the JAX package, float64 on the CPU.

- The differentiable raymarch (VolumetricDisc(differentiable=True):
  checkpointed segments of samples) on tests/test_grad.py's 16 chords
  through the emitting annulus: its forward equal to the while-loop
  raymarch (rtol 1e-12, as that test), and its gradients in the five medium
  parameters within 1e-9 relative of JAX's and within 2e-4 of central
  differences of the port's own forward.
- Three small scenes outside `fast_path.supports_diff` (false in both
  packages): a KerrBL disc and sphere, a Schwarzschild disc with a
  translucent checker texture, and a tilted differentiable gas disc; the
  loss Σ c / (1 + c) and its gradients in the scene's tensors through
  `scene.trace_rays` with IntegrationConfig(differentiable=True), within
  1e-8 and 1e-6 relative of the JAX package's. Each frame holds hits of
  the objects whose tensors are differentiated.

The JAX package's reverse mode gives NaN on all three scenes, from two
faults the port does not copy (ROADMAP Queue 3): its loop feeds a stopped
lane the far-field state (t, r, θ, φ) = (0, 10, 0, 0) in every chart, on
the axis of the BL and spherical charts, where their right-hand sides
divide by sin θ (the port's sits on the equator there), and a sphere's or
a gas disc's segment test takes √max(disc, 0) of a discriminant that is
exactly 0 on the zero-length segments of lanes that did not move, whose
gradient is 0.5·∞·0 (the port's `geometry.base.sqrt_nonneg` passes 0).
Both NaNs sit in branches the forward masks out, so JAX's forward mode
(jax.jacfwd of the same differentiable forward) is finite: the port's
reverse-mode gradients are held against it. Two more, met by float32 lanes
that stall near a horizon (the controller's ε / max(err, tiny) once err²
underflows, arccos at ±1), are shown against the port's departures in the
last test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_raytracer_tpu import config as jcfg
from gr_raytracer_tpu.geometry.kerr import Kerr as JKerr
from gr_raytracer_tpu.geometry.schwarzschild import SchwarzschildSolver as JSchwarzschildSolver
from gr_raytracer_tpu.objects.volumetric_disc import VolumetricDisc as JVolumetricDisc
from gr_raytracer_tpu.rendering import camera as jcam
from gr_raytracer_tpu.rendering import fast_path as jfp
from gr_raytracer_tpu.rendering import rkf45 as jrk
from gr_raytracer_tpu.rendering import scene as jscn
from gr_raytracer_tpu.rendering.temperature import ConstantTemperature as JConstantTemperature
from gr_raytracer_tpu.rendering.texture import BlackBodyMap as JBlackBodyMap
from gr_raytracer_tpu_torch import config as tcfg
from gr_raytracer_tpu_torch.geometry import chart as tcharts
from gr_raytracer_tpu_torch.geometry.base import acos_clip, sqrt_nonneg
from gr_raytracer_tpu_torch.geometry.kerr import Kerr as TKerr
from gr_raytracer_tpu_torch.geometry.schwarzschild import SchwarzschildSolver as TSchwarzschildSolver
from gr_raytracer_tpu_torch.objects.volumetric_disc import VolumetricDisc as TVolumetricDisc
from gr_raytracer_tpu_torch.rendering import camera as tcam
from gr_raytracer_tpu_torch.rendering import fast_path as tfp
from gr_raytracer_tpu_torch.rendering import integrator as tint
from gr_raytracer_tpu_torch.rendering import rkf45 as trk
from gr_raytracer_tpu_torch.rendering import scene as tscn
from gr_raytracer_tpu_torch.rendering.temperature import ConstantTemperature as TConstantTemperature
from gr_raytracer_tpu_torch.rendering.texture import BlackBodyMap as TBlackBodyMap
from test_golden_frames import SCENES
from torch_port_scenes import BL_CAMERA, CPU, F64, SCHWARZSCHILD_DISC_TOML, _SPHERE_SCENE, pixel_grid, t

LOSS_RTOL = 1e-8
GRAD_RTOL = 1e-6
# (name, base value, central-difference step): test_grad.py's steps for the
# first three; the other two at steps of the same relative size.
MEDIUM = (
    ("density_multiplier", 5.0, 1e-5),
    ("absorption", 0.3, 1e-4),
    ("noise_offset", 0.4, 1e-5),
    ("scattering", 0.4, 1e-4),
    ("brightness_reference_temperature", 1000.0, 1e-2),
)


def _chords():
    """test_grad.py's 16 chords through the emitting annulus."""
    rng = np.random.default_rng(11)
    n = 16
    phi = rng.uniform(0.0, 2 * np.pi, n)
    r0 = rng.uniform(2.6, 4.5, n)
    ro = np.stack([r0 * np.cos(phi), r0 * np.sin(phi), rng.uniform(-0.2, 0.2, n)], -1)
    tang = np.stack([-np.sin(phi), np.cos(phi), 0.1 * rng.standard_normal(n)], -1)
    rd = tang / np.linalg.norm(tang, axis=-1, keepdims=True)
    return ro, rd, np.ones(n), np.full(n, 1.0), np.full(n, 0.2)


def _disc_kw(**over):
    kw = dict(inner_radius=2.2, outer_radius=5.0, num_octaves=4, max_steps=500, step_size=0.01, thickness=0.3,
              density_multiplier=5.0, brightness_reference_temperature=1000.0, absorption=0.3, scattering=0.4,
              noise_scale=(2.0, 2.0, 2.0), noise_offset=0.4)
    kw.update(over)
    return kw


def test_differentiable_raymarch_matches_while_loop_jax_and_differences():
    ro, rd, obs, p_t, p_phi = _chords()
    names = [m[0] for m in MEDIUM]

    j_geo = JKerr(radius=jnp.asarray(1.0), a=jnp.asarray(0.3), horizon_epsilon=jnp.asarray(1e-3))
    j_args = [jnp.asarray(v) for v in (ro, rd, obs, p_t, p_phi)] + [jnp.ones((16,), bool)]

    def j_disc(differentiable, **over):
        return JVolumetricDisc.create(temperature_model=JConstantTemperature(jnp.asarray(5000.0)),
                                      texture=JBlackBodyMap.create(jnp.asarray(0.0), dtype=jnp.float64),
                                      dtype=jnp.float64, differentiable=differentiable, **_disc_kw(**over))

    def j_loss(med):
        c = j_disc(True, **dict(zip(names, med))).raymarch(j_geo, *j_args)[..., :3]
        return jnp.sum(c / (1.0 + c))

    base = np.array([m[1] for m in MEDIUM])
    j_grad = np.asarray(jax.grad(j_loss)(jnp.asarray(base)))
    j_out = np.asarray(j_disc(True).raymarch(j_geo, *j_args))

    t_geo = TKerr(radius=torch.tensor(1.0, dtype=F64), a=torch.tensor(0.3, dtype=F64),
                  horizon_epsilon=torch.tensor(1e-3, dtype=F64))
    t_args = [t(v) for v in (ro, rd, obs, p_t, p_phi)] + [torch.ones(16, dtype=torch.bool)]

    def t_disc(differentiable, **over):
        return TVolumetricDisc.create(temperature_model=TConstantTemperature(torch.tensor(5000.0, dtype=F64)),
                                      texture=TBlackBodyMap.create(0.0, F64, CPU), dtype=F64, device=CPU,
                                      differentiable=differentiable, **_disc_kw(**over))

    def t_loss(med, differentiable=True):
        out = t_disc(differentiable, **dict(zip(names, med))).raymarch(t_geo, *t_args)
        c = out[..., :3]
        return torch.sum(c / (1.0 + c)), out

    with torch.no_grad():
        _, out_w = t_loss(t(base), differentiable=False)
    med = t(base).requires_grad_(True)
    loss, out_d = t_loss(med)
    (grad,) = torch.autograd.grad(loss, [med])
    assert out_w.any(), "probe chords never emit"
    np.testing.assert_allclose(out_d.detach().numpy(), out_w.numpy(), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(out_d.detach().numpy(), j_out, rtol=LOSS_RTOL, atol=1e-14)
    rel_jax = np.abs(grad.numpy() - j_grad) / np.abs(j_grad)
    print("gradient vs JAX, relative:", dict(zip(names, rel_jax)))
    assert np.all(rel_jax <= 1e-9), dict(zip(names, rel_jax))
    for i, (name, value, eps) in enumerate(MEDIUM):
        with torch.no_grad():
            fp = float(t_loss(t(np.where(np.arange(5) == i, base + eps, base)))[0])
            fm = float(t_loss(t(np.where(np.arange(5) == i, base - eps, base)))[0])
        fd = (fp - fm) / (2 * eps)
        assert np.isfinite(float(grad[i])) and abs(fd) > 0.0, (name, float(grad[i]), fd)
        assert abs(float(grad[i]) - fd) <= 2e-4 * abs(fd), (name, float(grad[i]), fd)


# Scenes outside supports_diff: (TOML, render options, the port's tensors
# that take gradients, as (object index or None for the geometry, field)).
_SMALL = dict(width=5, height=5, max_steps=300, max_radius=20.0, step_size=0.05)
_TRANSLUCENT_DISC = SCHWARZSCHILD_DISC_TOML.replace(
    "[objects.Disc.texture.BlackBody]\nbeaming_exponent = 3.0\n",
    "[objects.Disc.texture.Checker]\nbeaming_exponent = 2.0\nwidth = 6.0\nheight = 6.0\n"
    "color1 = [255, 120, 0, 128]\ncolor2 = [120, 40, 0, 200]\n",
)
_GAS_TOML, _GAS_CAMERA = SCENES["schwarzschild_volumetric"]
_TILT = "axis = [0.2, 0.0, 1.0]"
# Checker textures are constant between their cells' edges: the objects'
# colors move with the scene's tensors through their beaming (the sky's
# stays constant).
_BEAMING = ("beaming_exponent = 0.0\nwidth = 6.0", "beaming_exponent = 2.0\nwidth = 6.0")
CASES = {
    "kerr_bl_sphere": (_SPHERE_SCENE.format(geometry="KerrBL", radius=1.0, spin="a = 0.45\n").replace(*_BEAMING),
                       dict(_SMALL, **BL_CAMERA), ((None, "radius"), (None, "a"), (1, "radius"))),
    "schwarzschild_translucent_disc": (_TRANSLUCENT_DISC, dict(_SMALL, **SCENES["schwarzschild_disc"][1]),
                                       ((None, "radius"), (0, "texture.beaming_exponent"), (0, "texture.c2"))),
    "tilted_gas_disc": (_GAS_TOML.replace("axis = [0.0, 0.0, 1.0]", _TILT), dict(_SMALL, **_GAS_CAMERA),
                        ((None, "radius"), (0, "density_multiplier"), (0, "absorption"))),
}


def _get(scene, where):
    obj, field = where
    node = scene.geometry if obj is None else scene.objects[obj]
    for part in field.split("."):
        node = getattr(node, part)
    return node


def _put(scene, where, value, replace):
    """scene with the tensor at `where` replaced (replace: the package's
    dataclass or pytree replace)."""
    obj, field = where
    if obj is None:
        return replace(scene, geometry=replace(scene.geometry, **{field: value}))
    node = scene.objects[obj]
    parts = field.split(".")
    if len(parts) == 2:
        node = replace(node, **{parts[0]: replace(getattr(node, parts[0]), **{parts[1]: value})})
    else:
        node = replace(node, **{parts[0]: value})
    objects = list(scene.objects)
    objects[obj] = node
    return replace(scene, objects=tuple(objects))


def _jax_replace(node, **kw):
    return node.replace(**kw)


def _differentiable(scene, replace):
    scene = replace(scene, integration=replace(scene.integration, differentiable=True))
    objects = tuple(replace(o, differentiable=True) if hasattr(o, "raymarch") else o for o in scene.objects)
    return replace(scene, objects=objects)


@pytest.mark.parametrize("case", sorted(CASES))
def test_scene_outside_supports_diff_matches_jax(case):
    toml, options, wheres = CASES[case]
    j_scene = jcfg.create_scene(jcfg.parse_config(toml), jcfg.RenderOptions(**options), jnp.float64)
    t_scene = tcfg.create_scene(tcfg.parse_config(toml.replace(_TILT, "axis = [0.0, 0.0, 1.0]")),
                                tcfg.RenderOptions(**options), F64, CPU)
    if _TILT in toml:
        # The port's loader takes the z axis only: turn its disc after the build.
        ref = TVolumetricDisc.create(1.0, 2.0, None, None, axis=(0.2, 0.0, 1.0), dtype=F64)
        t_scene = _put(_put(_put(t_scene, (0, "axis"), ref.axis, dataclasses.replace), (0, "e1"), ref.e1,
                            dataclasses.replace), (0, "e2"), ref.e2, dataclasses.replace)
    assert not jfp.supports_diff(j_scene) and not tfp.supports_diff(t_scene), case
    j_scene, t_scene = _differentiable(j_scene, _jax_replace), _differentiable(t_scene, dataclasses.replace)

    rr, cc = pixel_grid(options["height"], options["width"])
    jx, jp = jcam.pixel_rays(j_scene.camera, jnp.asarray(rr), jnp.asarray(cc))

    def j_loss(values):
        s = j_scene
        for where, v in zip(wheres, values):
            s = _put(s, where, v, _jax_replace)
        out = jscn.trace_rays(s, jx, jp)
        c = out.color[..., :3]
        loss = jnp.sum(c / (1.0 + c))
        return loss, (loss, out.stop_code)

    j_vals = [_get(j_scene, w) for w in wheres]
    j_grads, (j_val, j_stop) = jax.jit(jax.jacfwd(j_loss, has_aux=True))(j_vals)

    tx, tp = tcam.pixel_rays(t_scene.camera, t(rr), t(cc))
    leaves = [_get(t_scene, w).detach().clone().requires_grad_(True) for w in wheres]
    s = t_scene
    for where, v in zip(wheres, leaves):
        s = _put(s, where, v, dataclasses.replace)
    out = tscn.trace_rays(s, tx, tp)
    c = out.color[..., :3]
    loss = torch.sum(c / (1.0 + c))
    grads = torch.autograd.grad(loss, leaves)

    np.testing.assert_array_equal(out.stop_code.numpy(), np.asarray(j_stop))
    assert abs(float(loss) - float(j_val)) <= LOSS_RTOL * abs(float(j_val)), (float(loss), float(j_val))
    for where, got, want in zip(wheres, grads, j_grads):
        got, want = got.numpy(), np.asarray(want)
        assert np.all(np.isfinite(got)) and np.any(want != 0.0), (case, where, got, want)
        err = np.max(np.abs(got - want)) / np.max(np.abs(want))
        print(case, where, f"{err:.3e}")
        assert err <= GRAD_RTOL, (case, where, got, want)


def test_reference_nan_sources_and_the_port_departures():
    """The two NaN sources of the JAX package's reverse mode (module
    docstring), each against the port's departure from it, with a zero
    cotangent (a masked-out lane's or root's):
    - an RKF45 step from the stopped-lane state, in the spherical chart:
      JAX's state lies on the axis, where the right-hand side's value is
      NaN (cot θ · 0), so the step's VJP in its step size h is NaN (h
      carries it into every parameter); the port's is 0;
    - √max(disc, 0) at disc = 0: JAX's gradient is NaN, sqrt_nonneg's 0,
      with the same values as √max(x, 0) (NaN stays NaN)."""
    j_state = jnp.zeros((1, 8)).at[..., 1].set(10.0)
    j_solver = JSchwarzschildSolver(radius=jnp.asarray(1.0))
    assert not bool(jnp.all(jnp.isfinite(j_solver.rhs(j_state))))
    _, j_vjp = jax.vjp(lambda h: jrk.rkf45_step(j_solver.rhs, j_state, h), jnp.full((1,), 0.5))
    assert np.isnan(np.asarray(j_vjp((jnp.zeros((1, 8)), jnp.zeros((1,))))[0])).all()
    t_state = tint.far_field_state(torch.zeros((1, 8), dtype=F64), tcharts.SPHERICAL)
    t_solver = TSchwarzschildSolver(radius=torch.tensor(1.0, dtype=F64))
    assert bool(torch.all(torch.isfinite(t_solver.rhs(t_state))))
    h = torch.full((1,), 0.5, dtype=F64, requires_grad=True)
    y_new, err = trk.rkf45_step(t_solver.rhs, t_state, h)
    (g,) = torch.autograd.grad((y_new, err), [h], grad_outputs=(torch.zeros((1, 8), dtype=F64),
                                                                 torch.zeros((1,), dtype=F64)))
    assert float(g) == 0.0

    masked = lambda x: jnp.where(x > 0.0, jnp.sqrt(jnp.maximum(x, 0.0)), 0.0)  # noqa: E731
    assert np.isnan(float(jax.grad(masked)(0.0)))
    x = torch.tensor([0.0, -1.0, 4.0, -0.0, np.nan], dtype=F64, requires_grad=True)
    y = sqrt_nonneg(x)
    want = torch.sqrt(torch.clamp(x.detach(), min=0.0))
    assert torch.equal(torch.isnan(y), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(y.detach(), nan=-1.0), torch.nan_to_num(want, nan=-1.0))
    (g,) = torch.autograd.grad(torch.where(x[:4] > 0.0, y[:4], 0.0).sum(), [x])
    np.testing.assert_array_equal(g.numpy()[:4], [0.0, 0.0, 0.25, 0.0])


def test_stalled_lane_nan_sources_and_the_port_departures():
    """Two more NaN sources of reverse mode, met by float32 lanes that stall
    near a horizon (schwarzschild.toml at 128², budget 1,000), each with a
    zero cotangent from a branch the forward does not take:
    - the controller's proposal ε / max(err, tiny) once err² underflows
      (err = 1e-25 in float32): a lane with err / ε < SMALL_ERROR_RATIO
      grows h by the cap and leaves the proposal unused, and the
      division's gradient in err, -g·ε/err², is 0·∞. JAX's gradient is NaN
      there, the port's 0; elsewhere the two agree;
    - arccos at ±1 (a sphere's or a chart's axis): JAX's arccos(clip(x))
      has the gradient NaN there, the port's `acos_clip` 0, with the same
      values as torch.acos(torch.clamp(x, -1, 1))."""
    eps = 1e-5
    h = np.full(3, 1e-3, dtype=np.float32)
    err = np.array([1e-25, 2e-6, 3e-5], dtype=np.float32)
    j_derr = np.asarray(jax.grad(lambda e: jnp.sum(jrk.controller(jnp.asarray(h), e, eps)[1]))(jnp.asarray(err)))
    terr = torch.tensor(err, requires_grad=True)
    (t_derr,) = torch.autograd.grad(trk.controller(torch.tensor(h), terr, eps)[1].sum(), [terr])
    assert np.isnan(j_derr[0]) and float(t_derr[0]) == 0.0
    np.testing.assert_allclose(t_derr.numpy()[1:], j_derr[1:], rtol=1e-5)

    x = np.array([-1.5, -1.0, -0.3, 0.0, 0.7, 1.0, 1.5])
    cot = np.array([0.0, 0.0, 1.0, 1.0, 1.0, 0.0, 0.0])
    _, j_vjp = jax.vjp(lambda v: jnp.arccos(jnp.clip(v, -1.0, 1.0)), jnp.asarray(x))
    j_g = np.asarray(j_vjp(jnp.asarray(cot))[0])
    assert np.isnan(j_g[[1, 5]]).all()
    tx = t(x).requires_grad_(True)
    y = acos_clip(tx)
    assert torch.equal(y.detach(), torch.acos(torch.clamp(tx.detach(), -1.0, 1.0)))
    (t_g,) = torch.autograd.grad(y, [tx], grad_outputs=t(cot))
    np.testing.assert_array_equal(t_g.numpy()[[0, 1, 5, 6]], 0.0)
    np.testing.assert_allclose(t_g.numpy()[2:5], j_g[2:5], rtol=1e-14)
