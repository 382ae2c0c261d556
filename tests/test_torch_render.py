"""The port's render path against the JAX package on kerr.toml, float64.

The JAX side runs its kernel path with the Pallas march in interpret mode:
on the CPU its driver would otherwise take the RKF45 path, a different
integrator. Ray classes and stop codes must be equal; colors agree to 1e-8
relative (XYZ radiances span 1e-25 to 1e4);
the CLI's PNG is within 1 LSB of the JAX writer's image of the JAX frame.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gr_raytracer_tpu.rendering import camera as jcam
from gr_raytracer_tpu.rendering import fast_path as jfp
from gr_raytracer_tpu.rendering import raytracer as jrt
from gr_raytracer_tpu_torch.rendering import camera as tcam
from gr_raytracer_tpu_torch.rendering import fast_path as tfp
from gr_raytracer_tpu_torch.rendering import raytracer as trt
from gr_raytracer_tpu_torch.utils.png import png_decode
from torch_port_scenes import KERR_TOML, REPO, kerr_toml_scenes, pixel_grid, t, with_frame

COLOR_TOL = 1e-8
FRAME = 24


def _jax_kernel_tracer(scene):
    """The JAX kernel path (make_fast_tracer's body) in interpret mode."""
    spec = jfp.scene_kernel_spec(scene)

    @jax.jit
    def body(scene, row_f, col_f):
        x, p = jcam.pixel_rays(scene.camera, row_f, col_f)
        s = jfp.trace_rays_fast(scene, x, p, interpret=True, spec=spec)
        return s, jrt._wire(s.color, s.ray_class, s.stop_code, s.ev_overflow)

    return body


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, port scene, JAX kernel-path tracer) of kerr.toml at
    24×24; the tracer is compiled for FRAME² rays."""
    j_scene, t_scene = kerr_toml_scenes(FRAME, FRAME)
    return j_scene, t_scene, _jax_kernel_tracer(j_scene)


def test_trace_rays_fast_matches_jax_kernel_path(scenes):
    j_scene, t_scene = with_frame(*scenes[:2], 16, 16)
    rr, cc = pixel_grid(16, 16)
    # Padded to the tracer's compiled size, as the JAX driver pads chunks.
    pad = lambda a: jnp.asarray(np.concatenate([a, np.full(FRAME * FRAME - a.size, a[0])]))
    ref, _ = scenes[2](j_scene, pad(rr), pad(cc))
    ref = jax.tree.map(lambda a: np.asarray(a)[: rr.size], ref)
    x, p = tcam.pixel_rays(t_scene.camera, t(rr), t(cc))
    got = tfp.trace_rays_fast(t_scene, x, p)
    np.testing.assert_array_equal(got.ray_class.numpy(), ref.ray_class)
    np.testing.assert_array_equal(got.stop_code.numpy(), ref.stop_code)
    np.testing.assert_array_equal(got.steps.numpy(), ref.steps)
    np.testing.assert_allclose(got.color.numpy(), ref.color, rtol=COLOR_TOL, atol=1e-12)
    # The frame shows the shadow, the disc and the sky.
    assert set(np.unique(ref.stop_code)) >= {1, 2, 7}


@pytest.fixture(scope="module")
def frames(scenes):
    """(JAX RenderOutput, port RenderOutput) of a 24×24 kerr.toml frame with
    adaptive supersampling."""
    j_scene, t_scene, tracer = scenes
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrt, "_use_fast_path", lambda scene: True)
        mp.setattr(jrt, "_trace_chunk_fast", lambda scene, rf, cf, mesh=None: tracer(scene, rf, cf)[1])
        ref = jrt.render_section(j_scene, chunk_size=FRAME * FRAME)
    return ref, trt.render_section(t_scene)


def test_render_section_with_supersampling_matches_jax(frames):
    ref, got = frames
    assert ref.supersample_mask.any()
    np.testing.assert_array_equal(got.supersample_mask, ref.supersample_mask)
    np.testing.assert_array_equal(got.ray_class, ref.ray_class)
    np.testing.assert_allclose(got.color, ref.color, rtol=COLOR_TOL, atol=1e-12)
    n_sub = int(ref.supersample_mask.sum()) * 16
    assert got.stats["aa"].rays == n_sub


def test_cli_png_matches_jax_writer(frames, tmp_path):
    ref, _ = frames
    ref_png = str(tmp_path / "ref.png")
    jrt.write_image(ref_png, ref.color)
    out_png = str(tmp_path / "port.png")
    cmd = [
        sys.executable, "-m", "gr_raytracer_tpu_torch", "--device", "cpu", "--f64",
        "--width", str(FRAME), "--height", str(FRAME), "--max-steps", "2000",
        "--camera-position=-10,0,-0.5", "--theta=1.52", "--psi=-1.57",
        "-c", KERR_TOML, "render", "--filename", out_png,
    ]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    subprocess.run(cmd, check=True, cwd=str(tmp_path), env=env, capture_output=True, timeout=300)
    with open(out_png, "rb") as f:
        got = png_decode(f.read()).astype(np.int16)
    with open(ref_png, "rb") as f:
        want = png_decode(f.read()).astype(np.int16)
    assert got.shape == (FRAME, FRAME, 4)
    assert np.abs(got - want).max() <= 1
    assert got[..., :3].std() > 1.0  # a real picture, not a flat field
