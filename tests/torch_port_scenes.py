"""Shared inputs for the tests that hold the PyTorch port against the JAX
package: the same scene, built by both from the same numbers, in float64
on the CPU."""

import dataclasses
import functools
import math
import os

import jax.numpy as jnp
import numpy as np
import torch

from gr_raytracer_tpu import config as jcfg
from gr_raytracer_tpu import presets as jpresets
from gr_raytracer_tpu.geometry.kerr import Kerr as JKerr
from gr_raytracer_tpu.rendering import camera as jcam
from gr_raytracer_tpu_torch import config as tcfg
from gr_raytracer_tpu_torch import presets as tpresets
from gr_raytracer_tpu_torch.geometry.kerr import Kerr as TKerr
from gr_raytracer_tpu_torch.rendering import camera as tcam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERR_TOML = os.path.join(REPO, "scene-definitions", "kerr.toml")
KERR_BL_TOML = os.path.join(REPO, "scene-definitions", "kerr-bl.toml")
# The README's kerr.toml render command: camera pose and orientation.
KERR_CAMERA = dict(camera_position=(-10.0, 0.0, -0.5), theta=1.52, psi=-1.57)
# docs/examples.md's KerrBL and Schwarzschild commands: the tetrad's z is
# radial, so the camera turns by π to face the hole.
BL_CAMERA = dict(camera_position=(-10.0, 0.0, -0.5), theta=-3.14159)
# The disc-only Schwarzschild scene of tests/test_golden_frames.py.
SCHWARZSCHILD_DISC_TOML = """
celestial_temperature = 0.0
[celestial_texture.Checker]
beaming_exponent = 0.0
width = 18.0
height = 9.0
color1 = [30, 30, 90]
color2 = [4, 4, 12]
[geometry_type.Schwarzschild]
radius = 1.0
horizon_epsilon = 1e-4
[[objects]]
[objects.Disc]
inner_radius = 3.0
outer_radius = 6.0
temperature = 4000.0
[objects.Disc.texture.BlackBody]
beaming_exponent = 3.0
"""
# The disc and sphere scenes of tests/test_pallas.py: Kerr-Schild
# (test_kerr_sphere_kernel_parity, with KERR_CAMERA) and Schwarzschild
# (test_bl_kernel_sphere_parity, with the camera turned by π); both a disc
# 3–5 and a sphere of radius 2 at the origin, checker textures.
_SPHERE_SCENE = """
celestial_temperature = 0.0
[celestial_texture.Checker]
beaming_exponent = 0.0
width = 18.0
height = 9.0
color1 = [40, 40, 120]
color2 = [5, 5, 20]
[geometry_type.{geometry}]
radius = {radius}
{spin}horizon_epsilon = 1e-3
[[objects]]
[objects.Disc]
inner_radius = 3.0
outer_radius = 5.0
temperature = 2000.0
[objects.Disc.texture.Checker]
beaming_exponent = 0.0
width = 6.0
height = 6.0
color1 = [255, 120, 0]
color2 = [120, 40, 0]
[[objects]]
[objects.Sphere]
radius = 2.0
position = [0.0, 0.0, 0.0]
temperature = 2000.0
[objects.Sphere.texture.Checker]
beaming_exponent = 0.0
width = 6.0
height = 6.0
color1 = [255, 0, 0]
color2 = [90, 0, 0]
"""
# The KerrBL disc scene of tests/test_pallas.py (kerr_bl_scene, the scene
# of test_kernel_march_resume_bl): a = 0.45, a blackbody disc 2–6.
KERR_BL_DISC_SCENE_TOML = """
celestial_temperature = 0.0
[celestial_texture.Checker]
beaming_exponent = 0.0
width = 18.0
height = 9.0
color1 = [40, 40, 120]
color2 = [5, 5, 20]
[geometry_type.KerrBL]
radius = 1.0
a = 0.45
horizon_epsilon = 1e-3
[[objects]]
[objects.Disc]
inner_radius = 2.0
outer_radius = 6.0
temperature = 5000.0
[objects.Disc.texture.BlackBody]
beaming_exponent = 3.0
"""
KERR_BL_DISC_SCENE_OPTIONS = dict(
    max_steps=3000, max_radius=40.0, step_size=0.01, camera_position=(-10.0, 0.0, -0.5), theta=-math.pi,
)
# The disc and sphere probe of tests/test_adjoint.py (sphere_loss_fn):
# kerr-sphere.toml (bitmap disc 3–5, bitmap sphere R = 3 at the origin)
# with a Kerr hole of r_s = 1, a = 0.499 put in after the scene is built,
# framed so that both kinds land in slot 0 of a 4×8 frame.
SPHERE_PROBE_OPTIONS = dict(
    width=8, height=4, max_steps=400, max_radius=30.0, camera_position=(-10.0, 0.0, -2.5), theta=1.35,
    psi=-1.57,
)
SPHERE_PROBE_HOLE = (1.0, 0.499)


@functools.lru_cache(maxsize=1)
def sphere_probe_scenes():
    """(JAX scene, port scene) of the disc and sphere probe, float64; built
    once a process (three 2048² bitmaps on each side)."""
    path = os.path.join(REPO, "scene-definitions", "kerr-sphere.toml")
    radius, a = SPHERE_PROBE_HOLE
    j_scene = jcfg.create_scene_host(jcfg.load_config(path), jcfg.RenderOptions(**SPHERE_PROBE_OPTIONS), jnp.float64)
    j_scene = j_scene.replace(geometry=JKerr(
        radius=jnp.asarray(radius), a=jnp.asarray(a), horizon_epsilon=j_scene.geometry.horizon_epsilon))
    t_scene = tcfg.create_scene(tcfg.load_config(path), tcfg.RenderOptions(**SPHERE_PROBE_OPTIONS), F64, CPU)
    t_scene = dataclasses.replace(t_scene, geometry=TKerr(
        radius=torch.tensor(radius, dtype=F64), a=torch.tensor(a, dtype=F64),
        horizon_epsilon=t_scene.geometry.horizon_epsilon))
    return j_scene, t_scene


KERR_SPHERE_SCENE_TOML = _SPHERE_SCENE.format(geometry="Kerr", radius=0.4, spin="a = 0.15\n")
SCHWARZSCHILD_SPHERE_SCENE_TOML = _SPHERE_SCENE.format(geometry="Schwarzschild", radius=0.5, spin="")
# schwarzschild-sphere.toml's shape (r_s = 0) with the checker textures.
FLAT_SPHERE_SCENE_TOML = _SPHERE_SCENE.format(geometry="Schwarzschild", radius=0.0, spin="")
CPU = torch.device("cpu")
F64 = torch.float64
# The port tests run small tensors: one intra-op thread each keeps parallel
# test workers from oversubscribing the cores.
torch.set_num_threads(1)


def kerr_toml_scenes(rows, cols, max_steps=2000):
    """(JAX scene, port scene) of scene-definitions/kerr.toml."""
    j_opts = jcfg.RenderOptions(width=cols, height=rows, max_steps=max_steps, **KERR_CAMERA)
    t_opts = tcfg.RenderOptions(width=cols, height=rows, max_steps=max_steps, **KERR_CAMERA)
    j_scene = jcfg.create_scene(jcfg.load_config(KERR_TOML), j_opts, jnp.float64)
    t_scene = tcfg.create_scene(tcfg.load_config(KERR_TOML), t_opts, F64, CPU)
    return j_scene, t_scene


def with_frame(j_scene, t_scene, rows, cols):
    """The same kerr.toml scenes with their cameras rebuilt for a rows×cols
    frame (static observer, the README camera angles)."""
    kw = dict(alpha=math.pi / 4, rows=rows, columns=cols, theta=KERR_CAMERA["theta"], psi=KERR_CAMERA["psi"])
    jg, tg = j_scene.geometry, t_scene.geometry
    jpos, tpos = j_scene.camera.position, t_scene.camera.position
    j_cam = jcam.build_camera(jg, jpos, jg.stationary_velocity(jpos), **kw)
    t_cam = tcam.build_camera(tg, tpos, tg.stationary_velocity(tpos), **kw)
    return j_scene.replace(camera=j_cam), dataclasses.replace(t_scene, camera=t_cam)


def jax_flagship_params():
    return {k: np.asarray(v) for k, v in jpresets.kerr_flagship_params(jnp.float64).items()}


def port_flagship(rows, cols, max_steps=2000):
    """The port's flagship scene, built from the JAX parameter pytree."""
    params = tpresets.params_from_numpy(jax_flagship_params(), F64, CPU)
    return tpresets.build_kerr_flagship(params, rows, cols, max_steps=max_steps, max_radius=40.0, step_size=0.05)


def jax_flagship_camera(rows, cols):
    """The JAX flagship camera alone (what presets.build_kerr_flagship
    builds), without the scene's lookup tables."""
    p = {k: jnp.asarray(v) for k, v in jax_flagship_params().items()}
    geometry = JKerr(radius=p["radius"], a=p["a"], horizon_epsilon=jnp.asarray(1e-3))
    pos = p["camera_position"]
    return geometry, jcam.build_camera(
        geometry, pos, geometry.stationary_velocity(pos), alpha=jnp.pi / 4, rows=rows,
        columns=cols, phi=p["camera_phi"], theta=p["camera_theta"], psi=p["camera_psi"],
        validate=False,
    )


def pixel_grid(rows, cols):
    rr, cc = np.meshgrid(np.arange(rows, dtype=np.float64), np.arange(cols, dtype=np.float64), indexing="ij")
    return rr.ravel(), cc.ravel()


def t(a):
    """numpy / JAX array -> CPU float64-or-int torch tensor (copied)."""
    return torch.from_numpy(np.array(a))


def lane_relative_error(ref, got):
    """max |ref − got| over finite entries, scaled by each lane's largest
    finite |ref| component; lanes are the leading axis."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    fin = np.isfinite(ref)
    assert np.array_equal(fin, np.isfinite(got)), "non-finite entries differ"
    scale = np.max(np.abs(np.where(fin, ref, 0.0)).reshape(ref.shape[0], -1), axis=1)
    scale = np.maximum(scale, 1e-300).reshape((-1,) + (1,) * (ref.ndim - 1))
    return float(np.max(np.where(fin, np.abs(ref - got), 0.0) / scale, initial=0.0))
