"""The longest float32 K1 lane of the 500² kerr-volumetric-streaky frame
(pixel (252, 216), AA sub-sample 5; ROADMAP Queue 3), marched in float64
by the port's plain march and by the JAX kernel in interpret mode from the
card's float32 initial state. On the card in float32 the lane runs to its
20,000-step budget (from a state an ulp away, as the frame was prepared
before its per-ray contractions were summed elementwise, it overflowed 32
event slots); in float64 both packages march it to escape
after ~3,050 steps with two volume-bound events. So its float32 length is
rounding on a chaotic lane near the photon ring, not a port fault. Even in
float64 the lane amplifies the last-bit differences between XLA's and
torch's rounding (their states part from the second step) to ~1e-4 of its
scale by its end, so its states are held at CHAOTIC_RTOL, not at the
port's 1e-9 bar for ordinary lanes; its stop code, step count and events
are equal."""

import os

import jax.numpy as jnp
import numpy as np
import torch

from gr_raytracer_tpu.ops import geodesic_pallas as gp
from gr_raytracer_tpu_torch import config as tcfg
from gr_raytracer_tpu_torch.ops import geodesic_march as gm
from gr_raytracer_tpu_torch.rendering import fast_path as tfp
from gr_raytracer_tpu_torch.rendering import integrator as integ
from torch_port_scenes import REPO, lane_relative_error

VOL_TOML = os.path.join(REPO, "scene-definitions", "kerr-volumetric-streaky.toml")
# The lane's float32 initial state as the card prepared it (t, x, y, z | p).
Y0 = [float.fromhex(h) for h in (
    "0x0.0p+0", "-0x1.4p+3", "0x0.0p+0", "-0x1.0p-1",
    "0x1.e5b9e4p-1", "0x1.26c6bcp+0", "0x1.9d2090p-4", "0x1.b1cf38p-5",
)]
CHAOTIC_RTOL = 1e-3


def test_traced_volumetric_lane_matches_jax_kernel_in_float64():
    opts = tcfg.RenderOptions(width=500, height=500, max_steps=20000, camera_position=(-10.0, 0.0, -0.5),
                              theta=1.52, psi=-1.57)
    # The march's parameters as the float32 frame hands them to K1.
    scene = tcfg.create_scene(tcfg.load_config(VOL_TOML), opts, torch.float32, torch.device("cpu"))
    spec = tfp.scene_kernel_spec(scene)
    cfg = scene.integration
    kw = dict(h0=1.0, max_steps=cfg.max_steps, max_radius=cfg.max_radius, r_safe=spec.r_safe,
              opaque_stop=spec.opaque)
    args = (spec.radius, spec.a, spec.horizon_epsilon)
    y0 = np.tile(np.asarray(Y0, np.float64), (gp.LANE_TILE, 1))
    ref = gp.kerr_rk4_march(*args, jnp.asarray(y0), vols=tuple(gp.VolSpec(*v) for v in spec.vols),
                            interpret=True, **kw)
    ref = [np.asarray(a)[:1] for a in ref]
    got = [a.numpy() for a in gm.kerr_rk4_march(*args, torch.from_numpy(y0[:1]), vols=spec.vols, **kw)]
    y_r, stop_r, steps_r, kind_r, data_r, count_r, ovf_r = ref
    y_g, stop_g, steps_g, kind_g, data_g, count_g, ovf_g = got
    for g, r in ((stop_g, stop_r), (steps_g, steps_r), (count_g, count_r), (kind_g, kind_r), (ovf_g, ovf_r)):
        np.testing.assert_array_equal(g, r)
    assert lane_relative_error(y_r, y_g) <= CHAOTIC_RTOL
    assert lane_relative_error(data_r, data_g) <= CHAOTIC_RTOL
    # In float64 the lane escapes after ~3,050 steps, crossing the disc's
    # bounding volume twice: far from its float32 length on the card.
    assert int(stop_g[0]) == integ.CELESTIAL and 3000 < int(steps_g[0]) < 3100 and int(count_g[0]) == 2
