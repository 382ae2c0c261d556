"""The port's differentiable volumetric scene path against the JAX
package's, float64 on the CPU: `fast_path.trace_rays_fast_vol_diff`
(geometric march without gradient, compaction, the differentiable raymarch
K6/K7 in their plain versions, combine_alpha, fold) against
`make_fast_vol_diff_tracer(interpret=True)` on the tiny scene of
tests/test_vol_adjoint.py::test_scene_level_vol_diff_fd: colors within 1e-9
and the five medium gradients of sum(color[:, :3]) within 1e-8 relative.
The port's raymarch spec takes the JAX spec's Chebyshev coefficients (its
own fits agree to 1e-9, tests/test_torch_volumetric.py), so that the
comparison holds the path, not the fits. Then which scenes the path takes,
and two steps of the medium fit at 8² lowering the loss."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_raytracer_tpu import config as jcfg
from gr_raytracer_tpu.ops import volumetric_adjoint as jva
from gr_raytracer_tpu.ops import volumetric_pallas as vp
from gr_raytracer_tpu.rendering import fast_path as jfp
from gr_raytracer_tpu_torch import config as tcfg
from gr_raytracer_tpu_torch import inverse
from gr_raytracer_tpu_torch.objects.volumetric_disc import VolumetricDisc
from gr_raytracer_tpu_torch.ops import volumetric_adjoint as va
from gr_raytracer_tpu_torch.ops import volumetric_march as vm
from gr_raytracer_tpu_torch.rendering import camera as tcam
from gr_raytracer_tpu_torch.rendering import fast_path as tfp
from torch_port_scenes import CPU, F64, KERR_TOML, pixel_grid, t

# tests/test_vol_adjoint.py::test_scene_level_vol_diff_fd's scene and frame
# (hero #5's camera; the march budget cut for the CPU).
SCENE = """
celestial_temperature = 5000.0

[geometry_type.Kerr]
radius = 1.0
a = 0.45
horizon_epsilon = 1e-4

[[objects]]
[objects.VolumetricDisc]
inner_radius = 4.05
outer_radius = 16.0
temperature = 5000.0
num_octaves = 3
perlin_seed = 3
max_steps = 300
step_size = 0.02
thickness = 0.03
density_multiplier = 500.0
brightness_reference_temperature = 1000.0
absorption = 0.3
scattering = 0.4
noise_scale = [60.0, 2.0, 30.0]
noise_offset = -0.2
[objects.VolumetricDisc.texture.BlackBody]
beaming_exponent = 0.0
"""
SIZE = 12
CAMERA = dict(max_steps=600, step_size=0.01, camera_position=(-10.0, 0.0, -0.5), theta=1.52, psi=-1.57)


def _scenes(size=SIZE, geometry="Kerr"):
    j_cfg, t_cfg = jcfg.parse_config(SCENE), tcfg.parse_config(SCENE)
    if geometry != "Kerr":
        kind = dict(geometry_type={"kind": geometry, "radius": 1.0, "horizon_epsilon": 1e-4}
                    | ({"a": 0.45} if geometry == "KerrBL" else {}))
        j_cfg, t_cfg = dataclasses.replace(j_cfg, **kind), dataclasses.replace(t_cfg, **kind)
    j_scene = jcfg.create_scene_host(j_cfg, jcfg.RenderOptions(width=size, height=size, **CAMERA), jnp.float64)
    t_scene = tcfg.create_scene(t_cfg, tcfg.RenderOptions(width=size, height=size, **CAMERA), F64, CPU)
    return j_scene, t_scene


def _port_spec(j_scene, t_scene):
    """The port's kernel spec with the JAX raymarch spec's Chebyshev
    coefficients."""
    spec = tfp.scene_kernel_spec(t_scene)
    jv = vp.build_vol_spec(j_scene.objects[0], j_scene.geometry)
    v = spec.vol_spec
    fields = ("cx", "cy", "cz", "cx2", "cy2", "cz2")
    for f in fields:
        np.testing.assert_allclose(getattr(v.tex, f), getattr(jv.tex, f), rtol=1e-9, atol=1e-9)
    v = v._replace(temp=v.temp._replace(coeffs=tuple(jv.temp.coeffs)),
                   tex=v.tex._replace(**{f: tuple(getattr(jv.tex, f)) for f in fields}))
    return spec._replace(vol_spec=v)


@pytest.fixture(scope="module")
def jax_gradient():
    """The JAX tracer's colors and medium gradients, once (interpret mode,
    the rolled loops: bit-equivalent and quicker to compile)."""
    j_scene, _ = _scenes()
    rr, cc = pixel_grid(SIZE, SIZE)
    obj = j_scene.objects[0]
    med = tuple(jnp.asarray(v, jnp.float64) for v in (
        obj.density_multiplier, obj.noise_offset, obj.absorption, obj.scattering,
        obj.brightness_reference_temperature))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vp, "UNROLL", 1)
        mp.setattr(jva, "BWD_UNROLL", 1)
        tracer = jfp.make_fast_vol_diff_tracer(j_scene, bucket=2 * SIZE * SIZE, interpret=True)

        def loss(m):
            color, _, overflow = tracer(m, j_scene, jnp.asarray(rr), jnp.asarray(cc))
            return jnp.sum(color[:, :3]), (color, overflow)

        (_, (color, overflow)), grads = jax.value_and_grad(loss, has_aux=True)(med)
    assert not bool(overflow)
    return np.asarray(color), np.array([float(g) for g in grads]), np.array([float(m) for m in med])


def test_scene_gradient_matches_the_jax_tracer(jax_gradient):
    color_j, grads_j, med_j = jax_gradient
    j_scene, t_scene = _scenes()
    spec = _port_spec(j_scene, t_scene)
    rr, cc = pixel_grid(SIZE, SIZE)
    x, p = tcam.pixel_rays(t_scene.camera, t(rr), t(cc))
    med = inverse.disc_medium(t_scene.objects[0]).requires_grad_(True)
    np.testing.assert_array_equal(med.detach().numpy(), med_j)
    out = tfp.trace_rays_fast_vol_diff(t_scene, med, x, p, spec)
    np.testing.assert_allclose(out.color.detach().numpy(), color_j, rtol=1e-9, atol=1e-12)
    (g,) = torch.autograd.grad(out.color[:, :3].sum(), med)
    rel = np.abs(g.numpy() - grads_j) / np.abs(grads_j)
    assert rel.max() <= 1e-8, (g.numpy(), grads_j)
    assert (np.abs(grads_j) > 0).all() and float(out.color[:, :3].sum()) > 0
    assert vm.raw_launches == 0 and va.launches == 0


def test_supports_vol_diff_agrees_with_jax():
    cases = {}
    for geometry in ("Kerr", "KerrBL", "Schwarzschild"):
        cases[geometry] = _scenes(4, geometry)
    j_kerr, t_kerr = cases["Kerr"]
    # Refused: a thin disc scene, a tilted volumetric disc, two objects.
    j_disc = jcfg.create_scene_host(jcfg.load_config(KERR_TOML), jcfg.RenderOptions(width=4, height=4),
                                    jnp.float64)
    t_disc = tcfg.create_scene(tcfg.load_config(KERR_TOML), tcfg.RenderOptions(width=4, height=4), F64, CPU)
    cases["thin disc"] = (j_disc, t_disc)
    j_obj, t_obj = j_kerr.objects[0], t_kerr.objects[0]
    tilt = np.array([0.0, 0.6, 0.8])
    j_tilted = j_obj.replace(axis=jnp.asarray(tilt))
    t_tilted = dataclasses.replace(t_obj, axis=torch.tensor(tilt, dtype=F64))
    cases["tilted axis"] = (j_kerr.replace(objects=(j_tilted,)), dataclasses.replace(t_kerr, objects=(t_tilted,)))
    cases["two objects"] = (j_kerr.replace(objects=(j_obj, j_disc.objects[0])),
                            dataclasses.replace(t_kerr, objects=(t_obj, t_disc.objects[0])))
    got = {name: (bool(jfp.supports_vol_diff(j)), tfp.supports_vol_diff(s)) for name, (j, s) in cases.items()}
    assert all(a == b for a, b in got.values()), got
    assert [name for name, (a, _) in got.items() if a] == ["Kerr", "KerrBL", "Schwarzschild"], got


def test_two_steps_of_the_medium_fit_lower_the_loss():
    """scripts/grad_scale_probe.py --vol's recovery at 8²: density_multiplier
    and absorption from 0.6× and 2× their true values, log-reparametrised,
    clip 1.0 ahead of Adam with the cosine schedule (5e-2, 60, 0.02)."""
    _, scene = _scenes(8)
    rr, cc = pixel_grid(8, 8)
    x, p = tcam.pixel_rays(scene.camera, t(rr), t(cc))
    render = inverse.medium_render(scene, x, p)
    dm, ab = float(scene.objects[0].density_multiplier), float(scene.objects[0].absorption)
    as_params = lambda d, a: {"log_dm": torch.tensor(math.log(d), dtype=F64),
                              "log_ab": torch.tensor(math.log(a), dtype=F64)}
    with torch.no_grad():
        target = render(as_params(dm, ab))
    assert float(target[:, :3].sum()) > 0
    params, losses = inverse.fit(
        render, as_params(0.6 * dm, 2.0 * ab), target, trainable=("log_dm", "log_ab"), steps=2,
        learning_rate=inverse.cosine_decay_schedule(5e-2, 60, 0.02), clip_norm=1.0,
    )
    assert losses[1] < losses[0]
    assert abs(math.exp(float(params["log_dm"])) - dm) < 0.4 * dm
    assert math.isfinite(float(params["log_ab"])) and isinstance(scene.objects[0], VolumetricDisc)
