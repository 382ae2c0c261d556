"""The port's spheres against the JAX package, float64 on the CPU.

The sphere object's segment test; the plain marches K1 (Kerr-Schild) and K3
(Mino-time Boyer-Lindquist) with sphere events against the JAX kernels in
interpret mode (stop codes, steps, event kinds and counts equal; states
and payloads within 1e-9 of each lane's scale); `trace_rays_fast` against
the JAX kernel path (colors within 1e-8 relative) on the disc and sphere
scenes of tests/test_pallas.py and on a flat (r_s = 0) scene of
schwarzschild-sphere.toml's shape; the loader on the three sphere scene
files; the gradient path on sphere scenes (Kerr taken, the Mino-time march's
refused). On a card, the CUDA
kernels with sphere events are held against their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_raytracer_tpu import config as jcfg
from gr_raytracer_tpu.objects.sphere import Sphere as JSphere
from gr_raytracer_tpu.ops import geodesic_pallas as gp
from gr_raytracer_tpu.rendering import camera as jcam
from gr_raytracer_tpu.rendering import fast_path as jfp
from gr_raytracer_tpu_torch import config as tcfg
from gr_raytracer_tpu_torch.objects.sphere import Sphere
from gr_raytracer_tpu_torch.ops import geodesic_march as gm
from gr_raytracer_tpu_torch.rendering import camera as tcam
from gr_raytracer_tpu_torch.rendering import fast_path as tfp
from torch_port_scenes import (
    BL_CAMERA, CPU, F64, FLAT_SPHERE_SCENE_TOML, KERR_CAMERA, KERR_SPHERE_SCENE_TOML, REPO,
    SCHWARZSCHILD_SPHERE_SCENE_TOML, lane_relative_error, pixel_grid, t,
)

RTOL = 1e-9
COLOR_TOL = 1e-8
# tests/test_pallas.py's options for both sphere scenes.
OPTS = dict(max_steps=3000, max_radius=40.0, step_size=0.05)
CAMERAS = {"Kerr": dict(KERR_CAMERA), "Schwarzschild": dict(BL_CAMERA, theta=-np.pi)}
SCENES = {
    "kerr": (KERR_SPHERE_SCENE_TOML, "Kerr"),
    "schwarzschild": (SCHWARZSCHILD_SPHERE_SCENE_TOML, "Schwarzschild"),
    "flat": (FLAT_SPHERE_SCENE_TOML, "Schwarzschild"),
}


def _scenes(name, rows, cols):
    """(JAX scene, port scene) of SCENES[name] at rows×cols."""
    toml, camera = SCENES[name]
    kw = dict(width=cols, height=rows, **OPTS, **CAMERAS[camera])
    j_scene = jcfg.create_scene(jcfg.parse_config(toml), jcfg.RenderOptions(**kw), jnp.float64)
    t_scene = tcfg.create_scene(tcfg.parse_config(toml, REPO), tcfg.RenderOptions(**kw), F64, CPU)
    return j_scene, t_scene


def _march_inputs(name):
    """(spec, march kwargs, port inputs, JAX inputs) for the 32×32 rays of
    SCENES[name] (the JAX kernel takes whole 1,024-lane tiles)."""
    _, scene = _scenes(name, 32, 32)
    spec = tfp.scene_kernel_spec(scene)
    x, p = tcam.pixel_rays(scene.camera, *(t(a) for a in pixel_grid(32, 32)))
    solver, y0, _, _ = tfp._prepare_march(scene, x, p)
    inputs = (y0, solver.e, solver.l_z, solver.q) if spec.mino else (y0,)
    if spec.mino:
        kw = dict(h0=0.01, max_steps=2 * OPTS["max_steps"], max_radius=OPTS["max_radius"])
    else:
        kw = dict(h0=1.0, max_steps=OPTS["max_steps"], max_radius=OPTS["max_radius"], r_safe=spec.r_safe)
    kw["opaque_stop"] = spec.opaque
    return spec, kw, tuple(v.contiguous() for v in inputs), tuple(jnp.asarray(v.numpy()) for v in inputs)


def _port_march(spec, kw, inputs):
    march = gm.kerr_bl_rk4_march if spec.mino else gm.kerr_rk4_march
    return march(spec.radius, spec.a, spec.horizon_epsilon, *inputs, discs=spec.discs,
                 spheres=spec.spheres, **kw)


@pytest.fixture(scope="module", params=["kerr", "schwarzschild"])
def marches(request):
    """(spec, kwargs, port inputs, JAX kernel outputs as numpy) of the K1
    (kerr) or K3 (schwarzschild) march of a scene's 32×32 rays."""
    spec, kw, inputs, j_inputs = _march_inputs(request.param)
    assert spec.mino == (request.param == "schwarzschild")
    march = gp.kerr_bl_rk4_march if spec.mino else gp.kerr_rk4_march
    ref = march(
        spec.radius, spec.a, spec.horizon_epsilon, *j_inputs,
        discs=tuple(gp.DiscSpec(*d) for d in spec.discs),
        spheres=tuple(gp.SphereSpec(*s) for s in spec.spheres), interpret=True, **kw,
    )
    return spec, kw, inputs, [np.asarray(a) for a in ref]


def test_segment_hit_matches_jax():
    """Straddling (either way), fully-through, missing and tangent
    segments against an off-center sphere."""
    rng = np.random.default_rng(11)
    center = np.array([0.0, 0.7, -1.3, 2.1])
    radius = 1.9
    n = 400
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    inside = center[1:] + dirs * radius * rng.uniform(0.0, 0.99, size=(n, 1))
    far = rng.normal(size=(n, 3))
    far /= np.linalg.norm(far, axis=1, keepdims=True)
    outside = center[1:] + far * radius * rng.uniform(1.01, 3.0, size=(n, 1))
    through = center[1:] + dirs * radius * 1.5
    on = center[1:] + dirs * radius  # tangent point
    tangent = np.cross(dirs, rng.normal(size=(n, 3)))
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True)
    starts = np.concatenate([inside, outside, through, on - tangent, on - tangent])
    ends = np.concatenate([outside, inside, -through + 2 * center[1:], on + tangent, on])
    pad = lambda a: np.concatenate([np.zeros((a.shape[0], 1)), a], axis=1)
    j_sphere = JSphere(radius=jnp.asarray(radius), center=jnp.asarray(center), temperature=jnp.asarray(2000.0),
                       texture=None)
    t_sphere = Sphere(radius=torch.tensor(radius, dtype=F64), center=t(center),
                      temperature=torch.tensor(2000.0, dtype=F64), texture=None)
    ref = [np.asarray(a) for a in j_sphere.segment_hit(jnp.asarray(pad(starts)), jnp.asarray(pad(ends)))]
    got = [a.numpy() for a in t_sphere.segment_hit(t(pad(starts)), t(pad(ends)))]
    hit = ref[0]
    np.testing.assert_array_equal(got[0], hit)
    for r, g in zip(ref[1:], got[1:]):
        np.testing.assert_allclose(g[hit], r[hit], rtol=0.0, atol=1e-12)
    # Each group does what it names: straddles hit, fully-through chords miss.
    assert hit[: 2 * n].all() and not hit[2 * n : 3 * n].any()


def test_plain_march_with_spheres_matches_jax_kernel(marches):
    spec, kw, inputs, ref = marches
    got = [a.numpy() for a in _port_march(spec, kw, inputs)]
    y_r, stop_r, steps_r, kind_r, data_r, count_r, ovf_r = ref
    y_g, stop_g, steps_g, kind_g, data_g, count_g, ovf_g = got
    np.testing.assert_array_equal(stop_g, stop_r)
    np.testing.assert_array_equal(steps_g, steps_r)
    np.testing.assert_array_equal(count_g, count_r)
    np.testing.assert_array_equal(kind_g, kind_r)
    np.testing.assert_array_equal(ovf_g, ovf_r)
    assert lane_relative_error(y_r, y_g) <= RTOL
    assert lane_relative_error(data_r, data_g) <= RTOL
    # Sphere (kind 1) and disc (kind 0) events both occur; the opaque stop
    # fires on them.
    assert (kind_r == 1).sum() > 10 and (kind_r == 0).any() and (stop_r == 7).any()


@pytest.mark.parametrize("name", ["kerr", "schwarzschild", "flat"])
def test_trace_rays_fast_matches_jax_kernel_path(name):
    """tests/test_pallas.py's 16×8 frames, and the r_s = 0 scene (its
    Novikov-Thorne table is NaN in both packages: the disc's temperature
    is NaN and its checker texture ignores it)."""
    j_scene, t_scene = _scenes(name, 8, 16)
    assert tfp.supports_scene(t_scene)
    rr, cc = pixel_grid(8, 16)
    x, p = jcam.pixel_rays(j_scene.camera, jnp.asarray(rr), jnp.asarray(cc))
    ref = jax.tree.map(np.asarray, jfp.trace_rays_fast(j_scene, x, p, interpret=True))
    x, p = tcam.pixel_rays(t_scene.camera, t(rr), t(cc))
    got = tfp.trace_rays_fast(t_scene, x, p)
    np.testing.assert_array_equal(got.ray_class.numpy(), ref.ray_class)
    np.testing.assert_array_equal(got.stop_code.numpy(), ref.stop_code)
    np.testing.assert_array_equal(got.steps.numpy(), ref.steps)
    np.testing.assert_allclose(got.color.numpy(), ref.color, rtol=COLOR_TOL, atol=1e-12)
    assert (ref.stop_code == 7).any() and (ref.stop_code == 2).any()
    if name == "flat":
        assert np.isnan(float(t_scene.objects[0].temperature_model.r_isco))


class _Textures:
    """A texture factory that decodes nothing: the loader test compares the
    objects, not the bitmaps."""

    def build(self, tex):
        return tex["kind"]


def test_loader_builds_sphere_scenes_like_jax():
    """schwarzschild.toml, kerr-sphere.toml and schwarzschild-sphere.toml:
    the same objects, the sphere's fields equal, the disc's Novikov-Thorne
    table equal (NaN r_isco and zero temperatures at r_s = 0)."""
    for name in ("schwarzschild", "kerr-sphere", "schwarzschild-sphere"):
        path = f"{REPO}/scene-definitions/{name}.toml"
        j_cfg, t_cfg = jcfg.load_config(path), tcfg.load_config(path)
        j_geo = jcfg.build_geometry(j_cfg, jnp.float64)
        t_geo = tcfg.build_geometry(t_cfg, F64, CPU)
        j_objs = jcfg.build_objects(j_cfg, j_geo, _Textures(), jnp.float64)
        t_objs = tcfg.build_objects(t_cfg, t_geo, _Textures(), F64, CPU)
        assert [type(o).__name__ for o in t_objs] == [type(o).__name__ for o in j_objs] == ["Disc", "Sphere"]
        (j_disc, j_sph), (t_disc, t_sph) = j_objs, t_objs
        for field in ("radius", "center", "temperature"):
            np.testing.assert_array_equal(getattr(t_sph, field).numpy(), np.asarray(getattr(j_sph, field)))
        assert t_sph.texture == j_sph.texture == "Bitmap"
        j_lut, t_lut = j_disc.temperature_model, t_disc.temperature_model
        np.testing.assert_array_equal(t_lut.r_isco.numpy(), np.asarray(j_lut.r_isco))
        np.testing.assert_allclose(t_lut.temps.numpy(), np.asarray(j_lut.temps), rtol=1e-9, atol=0.0)
        flat = float(t_geo.radius) == 0.0
        assert np.isnan(float(t_lut.r_isco)) == flat and (not flat or not t_lut.temps.any())


def test_gradient_path_refuses_sphere_scenes():
    """The gradient path refuses the sphere scenes of the Mino-time march
    (Schwarzschild and the flat r_s = 0 one: the BL sweep has no sphere
    payload, in the JAX package either), whatever spec it is handed; it
    takes the Kerr disc and sphere scene (its gradient against JAX's is in
    tests/test_torch_sphere_adjoint.py) and the disc-only one."""
    for name in SCENES:
        _, scene = _scenes(name, 4, 4)
        x, p = tcam.pixel_rays(scene.camera, *(t(a) for a in pixel_grid(4, 4)))
        assert tfp.supports_scene(scene) and tfp.supports_diff(scene) == (name == "kerr")
        if name == "kerr":
            assert torch.isfinite(tfp.trace_rays_fast_diff(scene, x, p).color).all()
            continue
        with pytest.raises(ValueError):
            tfp.trace_rays_fast_diff(scene, x, p)
        with pytest.raises(ValueError):
            tfp.trace_rays_fast_diff(scene, x, p, spec=tfp.scene_kernel_spec(scene))
    disc_only = tcfg.parse_config(KERR_SPHERE_SCENE_TOML.split("[[objects]]\n[objects.Sphere]")[0], REPO)
    kw = dict(width=4, height=4, **OPTS, **CAMERAS["Kerr"])
    assert tfp.supports_diff(tcfg.create_scene(disc_only, tcfg.RenderOptions(**kw), F64, CPU))


@pytest.mark.cuda
def test_cuda_kernels_with_spheres_match_plain_marches():
    """K1 and K3 with sphere events against their plain versions on the
    card (chip_smoke.py does the same at the main path's size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name in ("kerr", "schwarzschild"):
        spec, kw, inputs, _ = _march_inputs(name)
        inputs = tuple(v.cuda() for v in inputs)
        before = (gm.launches, gm.bl_launches)
        got = _port_march(spec, kw, inputs)
        march = gm.march_bl_plain if spec.mino else gm.march_plain
        ref = march(spec.radius, spec.a, spec.horizon_epsilon, *inputs, discs=spec.discs, spheres=spec.spheres,
                    **kw)
        assert (gm.launches, gm.bl_launches) == (before[0] + (not spec.mino), before[1] + spec.mino)
        for g, r in zip(got, ref):
            assert torch.equal(g, r) or lane_relative_error(r.cpu().numpy(), g.cpu().numpy()) <= RTOL
        assert int((got[3] == 1).sum()) > 0
