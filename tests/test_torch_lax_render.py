"""The port's RKF45 render driver (`render_section(..., lax=True)` and
`trace_pixels_chunked`), float64 on the CPU.

- The four lax-path goldens of tests/test_golden_frames.py (16², budget
  4,000, chunk 256, adaptive supersampling on), read from the committed
  .npz: the Kerr-Schild disc and sphere and the KerrBL and Schwarzschild
  disc frames go through the requeue driver (4,000 + 256 attempts exceed
  two phases), the volumetric one through the split driver. Ray classes
  equal; colors within 1e-8 relative (the port's color bar against the
  JAX package), and at least 99 % of the frame's color values within the
  golden test's own 1e-9. The golden frames come from the JAX loop
  compiled by XLA, which contracts a·b + c into fused multiply-adds; the
  adaptive controller amplifies that rounding in a few sub-samples (the
  KerrBL frame's pixel (8, 6), sub-sample 14: its step sizes differ from
  the JAX run's by ~1e-9 relative from the first accepted step on, its
  color by 2.1e-9), so those pixels are off the 1e-9 bar by a few 1e-9.
- That sub-sample traced by the JAX package op by op (jax.disable_jit: no
  fusion) and by the port: colors within 1e-12, where the compiled JAX
  loop's differs from the op-by-op one by ~1.7e-9.
- A requeued chunk (phases of PHASE_ATTEMPTS attempts, continued over the
  running lanes) against the one-shot chunk at 1e-10, after
  tests/test_raytracer.py::test_requeued_chunk_matches_direct_trace.
- The port of tests/test_raytracer.py::test_overflow_retrace_recovers_dropped_events:
  with one event slot the driver re-traces the overflowing rays on the
  RKF45 path with 32 and reproduces the eight-slot frame at 1e-12.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gr_raytracer_tpu_torch import config as tcfg
from gr_raytracer_tpu_torch.objects.disc import Disc
from gr_raytracer_tpu_torch.rendering import camera as tcam
from gr_raytracer_tpu_torch.rendering import raytracer as trt
from gr_raytracer_tpu_torch.rendering import scene as tscn
from gr_raytracer_tpu_torch.rendering.temperature import ConstantTemperature
from gr_raytracer_tpu_torch.rendering.texture import CheckerMap
from test_golden_frames import GOLDEN_DIR, SCENES
from torch_port_scenes import CPU, F64, port_flagship

COLOR_TOL = 1e-8
GOLDEN_TOL = 1e-9


def _golden_scene(name):
    toml, camera = SCENES[name]
    opts = tcfg.RenderOptions(width=16, height=16, max_steps=4000, max_radius=30.0, step_size=0.05, **camera)
    return tcfg.create_scene(tcfg.parse_config(toml), opts, F64, CPU)


@pytest.mark.parametrize("name", ["kerr_bl_disc", "kerr_ks_disc_sphere", "schwarzschild_disc",
                                  "schwarzschild_volumetric"])
def test_lax_golden_frame(name):
    scene = _golden_scene(name)
    assert trt._route(scene, lax=True) == ("split" if name.endswith("volumetric") else "requeue")
    out = trt.render_section(scene, chunk_size=256, lax=True)
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    np.testing.assert_array_equal(out.ray_class, golden["ray_class"])
    np.testing.assert_allclose(out.color, golden["color"], rtol=COLOR_TOL, atol=COLOR_TOL)
    within = np.abs(out.color - golden["color"]) <= GOLDEN_TOL * (1.0 + np.abs(golden["color"]))
    assert within.mean() >= 0.99, within.mean()
    assert out.supersample_mask.any() and out.stats["aa"].rays > 0


def test_golden_sub_sample_matches_jax_without_fusion():
    import jax
    import jax.numpy as jnp

    from gr_raytracer_tpu import config as jcfg
    from gr_raytracer_tpu.rendering import camera as jcam
    from gr_raytracer_tpu.rendering import scene as jscn

    toml, camera = SCENES["kerr_bl_disc"]
    opts = dict(width=16, height=16, max_steps=4000, max_radius=30.0, step_size=0.05, **camera)
    j_scene = jcfg.create_scene(jcfg.parse_config(toml), jcfg.RenderOptions(**opts), jnp.float64)
    t_scene = _golden_scene("kerr_bl_disc")
    # Pixel (8, 6)'s sub-sample 14, placed as render_section places it.
    dx, dy = trt.stratified_sample_offsets(np.array([8]), np.array([6]), 4)
    rf, cf = 8 + (dy[:, 14] - 0.5), 6 + (dx[:, 14] - 0.5)
    with jax.disable_jit():
        want = jscn.trace_rays(j_scene, *jcam.pixel_rays(j_scene.camera, jnp.asarray(rf), jnp.asarray(cf)))
    got = tscn.trace_rays(t_scene, *tcam.pixel_rays(t_scene.camera, torch.as_tensor(rf), torch.as_tensor(cf)))
    assert int(got.steps[0]) == int(want.steps[0]) > 100
    assert int(got.ray_class[0]) == int(want.ray_class[0])
    np.testing.assert_allclose(got.color.numpy(), np.asarray(want.color), rtol=1e-12, atol=1e-12)


def test_requeued_chunk_matches_one_shot(monkeypatch):
    """Phased integration with compaction between phases takes the same
    steps and events as one integration: same classes, colors within
    1e-10 (the CPU's vectorized and scalar-tail transcendentals may differ
    in the last bit when a lane moves in the batch)."""
    scene = port_flagship(8, 8, max_steps=6000)
    scene = dataclasses.replace(scene, integration=dataclasses.replace(scene.integration, max_radius=25.0))
    rf = torch.arange(64, dtype=F64) // 8
    cf = torch.arange(64, dtype=F64) % 8
    x, p = tcam.pixel_rays(scene.camera, rf, cf)
    monkeypatch.setattr(trt, "PHASE_ATTEMPTS", 64)  # phases of 64, 128, 256, ... attempts
    got = trt._trace_chunk_requeued(scene, x, p)
    ref = tscn.trace_rays(scene, x, p)
    assert int(ref.steps.max()) > 64 + 128  # the chunk needs three phases
    np.testing.assert_array_equal(got.ray_class.numpy(), ref.ray_class.numpy())
    np.testing.assert_array_equal(got.stop_code.numpy(), ref.stop_code.numpy())
    np.testing.assert_allclose(got.color.numpy(), ref.color.numpy(), rtol=1e-10, atol=1e-10)


def _photon_disc_scene(max_events):
    """tests/test_raytracer.py::_photon_disc_scene: the flagship Kerr scene
    with a checker disc reaching into the photon region (inner 0.92) at a
    constant temperature, so near-critical rays cross it on every
    half-winding."""
    scene = port_flagship(32, 64, max_steps=20000)
    disc = Disc(
        inner_radius=torch.tensor(0.92, dtype=F64), outer_radius=torch.tensor(6.0, dtype=F64),
        temperature_model=ConstantTemperature(value=torch.tensor(0.0, dtype=F64)),
        texture=CheckerMap.from_srgb(0.0, 6.0, 6.0, (255, 120, 0), (120, 40, 0), F64, CPU),
    )
    integration = dataclasses.replace(scene.integration, max_radius=25.0, max_events=max_events)
    return dataclasses.replace(scene, objects=(disc,), integration=integration)


def test_overflow_retrace_recovers_dropped_events():
    """With a one-slot buffer the driver finds the overflowing rays and
    re-traces them on the RKF45 path with 32 slots: the frame equals the
    eight-slot render at 1e-12 (the row crossing the critical curve of
    tests/test_raytracer.py)."""
    rr = np.full(64, 15.0)
    cols = np.linspace(24.0, 32.0, 64)
    c1, k1, ok1, s1 = trt.trace_pixels_chunked(_photon_disc_scene(1), rr, cols, chunk_size=64, lax=True)
    c8, k8, ok8, s8 = trt.trace_pixels_chunked(_photon_disc_scene(8), rr, cols, chunk_size=64, lax=True)
    assert s1.overflow > 0 and s1.overflow_dropped == 0 and s8.overflow == 0
    assert s1.ray_steps > s8.ray_steps  # the re-trace's steps count
    np.testing.assert_array_equal(k1, k8)
    np.testing.assert_allclose(c1, c8, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(ok1, ok8)
