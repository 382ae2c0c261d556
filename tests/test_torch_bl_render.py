"""The port's render path on Boyer-Lindquist and Schwarzschild scenes against
the JAX package, float64.

The JAX side runs its kernel path with the Mino-time Pallas march in
interpret mode (on the CPU its renderer would otherwise take the RKF45 path,
a different integrator). Ray classes, stop codes and steps must be equal;
colors agree to 1e-8 relative; the CLI's PNG of kerr-bl.toml is within 1
LSB of the JAX writer's image of the JAX frame. Budgets are cut to 300
nominal steps (600 Mino steps) and the sky sphere to r = 30.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gr_raytracer_tpu import config as jcfg
from gr_raytracer_tpu.rendering import camera as jcam
from gr_raytracer_tpu.rendering import fast_path as jfp
from gr_raytracer_tpu.rendering import raytracer as jrt
from gr_raytracer_tpu_torch import config as tcfg
from gr_raytracer_tpu_torch.rendering import camera as tcam
from gr_raytracer_tpu_torch.rendering import fast_path as tfp
from gr_raytracer_tpu_torch.rendering import raytracer as trt
from gr_raytracer_tpu_torch.utils.png import png_decode
from torch_port_scenes import (
    BL_CAMERA, CPU, F64, KERR_BL_TOML, REPO, SCHWARZSCHILD_DISC_TOML, pixel_grid, t,
)

COLOR_TOL = 1e-8
# The chunk of the chunked renders: the 16² frame's 256 rays make 8, and
# the rays that overflow one event slot fall in several of them.
CHUNK = 32
TRANSLUCENT_CHECKER = """[objects.Disc.texture.Checker]
beaming_exponent = 0.0
width = 6.0
height = 6.0
color1 = [255, 120, 0, 128]
color2 = [120, 40, 0, 128]"""
FRAME = 16
MAX_STEPS = 300
MAX_RADIUS = 30.0


def _scenes(j_cfg, t_cfg):
    kw = dict(width=FRAME, height=FRAME, max_steps=MAX_STEPS, max_radius=MAX_RADIUS, **BL_CAMERA)
    j_scene = jcfg.create_scene(j_cfg, jcfg.RenderOptions(**kw), jnp.float64)
    t_scene = tcfg.create_scene(t_cfg, tcfg.RenderOptions(**kw), F64, CPU)
    return j_scene, t_scene


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
def kerr_bl():
    """(JAX scene, port scene, JAX kernel-path tracer) of kerr-bl.toml at
    16×16; the tracer is compiled for FRAME² rays."""
    j_scene, t_scene = _scenes(jcfg.load_config(KERR_BL_TOML), tcfg.load_config(KERR_BL_TOML))
    return j_scene, t_scene, _jax_kernel_tracer(j_scene)


def _assert_samples_match(ref, got):
    np.testing.assert_array_equal(got.ray_class.numpy(), ref.ray_class)
    np.testing.assert_array_equal(got.stop_code.numpy(), ref.stop_code)
    np.testing.assert_array_equal(got.steps.numpy(), ref.steps)
    np.testing.assert_allclose(got.color.numpy(), ref.color, rtol=COLOR_TOL, atol=1e-12)


def test_trace_rays_fast_matches_jax_kernel_path(kerr_bl):
    """kerr-bl.toml, and the Schwarzschild disc scene (marched at a = 0,
    shaded with the (+,−,−,−) Schwarzschild metric)."""
    sch = _scenes(jcfg.parse_config(SCHWARZSCHILD_DISC_TOML, REPO), tcfg.parse_config(SCHWARZSCHILD_DISC_TOML, REPO))
    rr, cc = pixel_grid(FRAME, FRAME)
    for j_scene, t_scene, tracer in (kerr_bl, (*sch, _jax_kernel_tracer(sch[0]))):
        assert tfp.supports_scene(t_scene) and tfp.scene_kernel_spec(t_scene).mino
        ref, _ = tracer(j_scene, jnp.asarray(rr), jnp.asarray(cc))
        ref = jax.tree.map(np.asarray, ref)
        x, p = tcam.pixel_rays(t_scene.camera, t(rr), t(cc))
        _assert_samples_match(ref, tfp.trace_rays_fast(t_scene, x, p))
        # The frame shows the sky and the disc.
        assert set(np.unique(ref.stop_code)) >= {2, 7}


@pytest.fixture(scope="module")
def frames(kerr_bl):
    """(JAX RenderOutput, port RenderOutput) of the 16×16 kerr-bl.toml frame
    with adaptive supersampling."""
    j_scene, t_scene, tracer = kerr_bl
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
    assert got.stats["aa"].rays == int(ref.supersample_mask.sum()) * 16


def _render_chunks(scene, chunk_size, monkeypatch):
    """render_section of `scene` with `chunk_size`, and per traced chunk
    (trt._trace_chunk's calls and the RKF45 re-traces of the rays that
    overflowed, trt._retrace_overflow's, in order): its event slots, a key
    of each ray's pixel coordinates, its rays' stop codes and steps."""
    chunks = []
    inner, inner_retrace = trt._trace_chunk, trt._retrace_overflow
    key = lambda row_f, col_f: (row_f * 4 * FRAME + col_f).numpy()  # unique for the AA pass's quarter-pixel offsets

    def traced(scene, spec, row_f, col_f):
        outs, lanes = inner(scene, spec, row_f, col_f)
        chunks.append((scene.integration.max_events, key(row_f, col_f), outs[2].numpy(), outs[4].numpy()))
        return outs, lanes

    def retraced(scene, row_f, col_f):
        outs, secs = inner_retrace(scene, row_f, col_f)
        chunks.append((trt.OVERFLOW_MAX_EVENTS, key(row_f, col_f), outs[2], outs[4]))
        return outs, secs

    monkeypatch.setattr(trt, "_trace_chunk", traced)
    monkeypatch.setattr(trt, "_retrace_overflow", retraced)
    out = trt.render_section(scene, chunk_size=chunk_size)
    monkeypatch.undo()
    return out, chunks


@pytest.mark.parametrize("max_events", [8, 1])
def test_chunks_match_one_chunk(kerr_bl, max_events, monkeypatch):
    """trace_pixels_chunked with chunk_size=CHUNK: each pass of the 16²
    frame in several chunks, each marched in two legs (fast_path._march)
    and shaded on its own; with max_events=1 the rays that overflow their
    one slot are re-traced chunk by chunk (on the RKF45 path). Held against
    the same render at the default chunk size, where each pass is one
    chunk."""
    scene = kerr_bl[1]
    if max_events == 1:
        # The disc made translucent, so that a ray records every crossing
        # (an opaque one stops at its first).
        with open(KERR_BL_TOML) as f:
            text = f.read().replace("[objects.Disc.texture.BlackBody]\nbeaming_exponent = 0.0", TRANSLUCENT_CHECKER)
        opts = tcfg.RenderOptions(width=FRAME, height=FRAME, max_steps=MAX_STEPS, max_radius=MAX_RADIUS, **BL_CAMERA)
        scene = tcfg.create_scene(tcfg.parse_config(text, REPO), opts, F64, CPU)
        scene = dataclasses.replace(scene, integration=dataclasses.replace(scene.integration, max_events=1))
    ref, ref_chunks = _render_chunks(scene, trt.CHUNK_SIZE, monkeypatch)
    got, got_chunks = _render_chunks(scene, CHUNK, monkeypatch)
    # One chunk: pass 1 and AA, each followed by one re-trace when rays
    # overflowed; CHUNK: the re-traces of several chunks.
    kinds = [c[0] for c in ref_chunks]
    assert kinds == ([1, trt.OVERFLOW_MAX_EVENTS] * 2 if max_events == 1 else [8, 8])
    retraces = sum(c[0] == trt.OVERFLOW_MAX_EVENTS for c in got_chunks)
    assert retraces > 2 if max_events == 1 else retraces == 0
    # The rays of each kind of trace, in the order they were traced.
    for slots in set(kinds):
        joined = [[np.concatenate(v) for v in zip(*(c[1:] for c in chunks if c[0] == slots))]
                  for chunks in (ref_chunks, got_chunks)]
        for r, g in zip(*joined):
            np.testing.assert_array_equal(g, r)
    assert got.supersample_mask.any()
    np.testing.assert_array_equal(got.supersample_mask, ref.supersample_mask)
    np.testing.assert_array_equal(got.ray_class, ref.ray_class)
    np.testing.assert_allclose(got.color, ref.color, rtol=COLOR_TOL, atol=1e-12)


def test_cli_png_matches_jax_writer(frames, tmp_path):
    ref, _ = frames
    ref_png = str(tmp_path / "ref.png")
    jrt.write_image(ref_png, ref.color)
    out_png = str(tmp_path / "port.png")
    cmd = [
        sys.executable, "-m", "gr_raytracer_tpu_torch", "--device", "cpu", "--f64",
        "--width", str(FRAME), "--height", str(FRAME), "--max-steps", str(MAX_STEPS),
        "--max-radius", str(MAX_RADIUS), "--camera-position=-10,0,-0.5", "--theta=-3.14159",
        "-c", KERR_BL_TOML, "render", "--filename", out_png,
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
