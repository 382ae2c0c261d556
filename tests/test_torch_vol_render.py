"""The port's volumetric kernel path against the JAX package's, float64.

`fast_path.trace_rays_fast_vol` (geometric march, compaction of the
volumetric event slots, the raymarch K5's plain version, fold) against the
JAX fused tracer `make_fast_vol_fused_tracer` with its Pallas kernels in
interpret mode, on the 16×8 frame of tests/test_raytracer.py's fused-split
test (a Kerr volumetric disc seen from below its plane) and on the same
scene in Boyer-Lindquist coordinates: stop codes and ray classes equal,
colors within 1e-8 relative. Then the CLI renders a small volumetric frame
on the CPU, the rays that overflow their event slots are re-traced on the
RKF45 path and held against the JAX driver's re-trace, a volumetric disc
beside a thin disc renders through the split path, and on a card K5 is
held against its plain version."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_raytracer_tpu import config as jcfg
from gr_raytracer_tpu.objects.disc import Disc as JDisc
from gr_raytracer_tpu.ops import volumetric_pallas as vp
from gr_raytracer_tpu.rendering import fast_path as jfp
from gr_raytracer_tpu.rendering import raytracer as jrt
from gr_raytracer_tpu_torch import cli
from gr_raytracer_tpu_torch import config as tcfg
from gr_raytracer_tpu_torch.objects.disc import Disc
from gr_raytracer_tpu_torch.ops import volumetric_march as vm
from gr_raytracer_tpu_torch.rendering import camera as tcam
from gr_raytracer_tpu_torch.rendering import fast_path as tfp
from gr_raytracer_tpu_torch.rendering import raytracer as trt
from gr_raytracer_tpu_torch.utils.png import png_decode
from test_pallas import KERR_VOLUMETRIC_SCENE
from torch_port_scenes import CPU, F64, pixel_grid, t

COLOR_TOL = 1e-8
ROWS, COLS = 8, 16
# tests/test_raytracer.py::test_fused_split_tracer_matches_compact_and_shards.
FRAME = dict(width=COLS, height=ROWS, max_steps=4000, max_radius=30.0, step_size=0.05)
CAMERA = dict(camera_position=(-12.0, 0.0, -1.5), theta=1.52, psi=-1.57)
BL_CAMERA = dict(camera_position=(-10.0, 0.0, -0.5), theta=-3.14159)


def _scenes(geometry, camera):
    j_cfg, t_cfg = jcfg.parse_config(KERR_VOLUMETRIC_SCENE), tcfg.parse_config(KERR_VOLUMETRIC_SCENE)
    j_cfg = dataclasses.replace(j_cfg, geometry_type=dict(j_cfg.geometry_type, kind=geometry))
    t_cfg = dataclasses.replace(t_cfg, geometry_type=dict(t_cfg.geometry_type, kind=geometry))
    j_scene = jcfg.create_scene(j_cfg, jcfg.RenderOptions(**FRAME, **camera), jnp.float64)
    t_scene = tcfg.create_scene(t_cfg, tcfg.RenderOptions(**FRAME, **camera), F64, CPU)
    return j_scene, t_scene


def _jax_frame(geometry, camera):
    """The JAX fused tracer's frame: (color, class, stop, overflow, lanes)."""
    j_scene, _ = _scenes(geometry, camera)
    rr, cc = pixel_grid(ROWS, COLS)
    tracer = jfp.make_fast_vol_fused_tracer(j_scene, 2 * ROWS * COLS, interpret=True)
    # The raymarch kernel's unroll is bit-equivalent to its rolled loop, which
    # compiles in a quarter of the time.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vp, "UNROLL", 1)
        outs = jax.device_get(tracer(j_scene, jnp.asarray(rr), jnp.asarray(cc)))
    return tuple(np.asarray(a) for a in outs)


@pytest.fixture(scope="module")
def kerr_jax_frame():
    return _jax_frame("Kerr", CAMERA)


def _compare_frame(geometry, camera, jax_frame):
    """Both frames; returns the port's VolTrace."""
    _, t_scene = _scenes(geometry, camera)
    rr, cc = pixel_grid(ROWS, COLS)
    c_r, k_r, s_r, o_r, n_r = jax_frame
    x, p = tcam.pixel_rays(t_scene.camera, t(rr), t(cc))
    got = tfp.trace_rays_fast_vol(t_scene, x, p)
    s = got.samples
    assert got.lanes == int(n_r[0]) > 0
    np.testing.assert_array_equal(s.stop_code.numpy(), s_r)
    np.testing.assert_array_equal(s.ray_class.numpy(), k_r)
    np.testing.assert_array_equal(s.ev_overflow.numpy(), o_r.astype(bool))
    np.testing.assert_allclose(s.color[:, :3].numpy(), c_r, rtol=COLOR_TOL, atol=1e-12)
    assert (s.color[:, 3] == 1.0).all()
    return got


def test_fused_volumetric_frame_matches_jax(kerr_jax_frame):
    got = _compare_frame("Kerr", CAMERA, kerr_jax_frame)
    s = got.samples
    # The frame has sky, gas in front of the sky and the hole's shadow.
    assert {0, 2} <= set(np.unique(s.ray_class.numpy())) and int(got.marched) > got.lanes
    assert {1, 2} <= set(np.unique(s.stop_code.numpy()))


def test_bl_volumetric_frame_matches_jax():
    got = _compare_frame("KerrBL", BL_CAMERA, _jax_frame("KerrBL", BL_CAMERA))
    assert int(got.marched) > 0 and (got.samples.ray_class.numpy() == 2).any()


def test_cli_renders_a_volumetric_png(tmp_path):
    scene = tmp_path / "volumetric.toml"
    scene.write_text(KERR_VOLUMETRIC_SCENE)
    png = tmp_path / "volumetric.png"
    out = cli.main([
        "--device", "cpu", "--width", "12", "--height", "8", "--max-steps", "2000", "--max-radius", "30",
        "--camera-position=-12,0,-1.5", "--theta=1.52", "--psi=-1.57", "-c", str(scene), "render",
        "--filename", str(png),
    ])
    img = png_decode(png.read_bytes())
    assert img.shape == (8, 12, 4) and img[..., :3].std() > 1.0
    pass1 = out.stats["pass1"]
    assert pass1.vol_lanes > 0 and pass1.vol_samples > pass1.vol_lanes and pass1.overflow == 0
    assert out.supersample_mask.any() and out.stats["aa"].vol_lanes > 0
    assert np.isfinite(out.color).all()


def test_overflowing_rays_are_retraced_with_more_slots(kerr_jax_frame):
    """With one event slot a ray, the rays crossing the slab twice or more
    overflow; the render driver traces them again on the RKF45 path with
    OVERFLOW_MAX_EVENTS slots, as the JAX driver does. The other rays equal
    the frame traced with eight slots bit for bit, and the re-traced rays
    match the JAX package's `_retrace_overflow` on the same rays (classes
    and stop codes equal, colors within 1e-8)."""
    j_scene, t_scene = _scenes("Kerr", CAMERA)
    rr, cc = pixel_grid(ROWS, COLS)
    ref = trt.trace_pixels_chunked(t_scene, rr, cc, chunk_size=64)
    narrow = dataclasses.replace(t_scene, integration=dataclasses.replace(t_scene.integration, max_events=1))
    got = trt.trace_pixels_chunked(narrow, rr, cc, chunk_size=64)
    assert ref[3].overflow == 0 and got[3].overflow > 0 and got[3].overflow_dropped == 0
    assert got[3].ray_steps > ref[3].ray_steps and got[3].overflow_march_s > 0.0

    x, p = tcam.pixel_rays(narrow.camera, t(rr), t(cc))
    ovf = tfp.trace_geometric_fast(narrow, x, p, tfp.scene_kernel_spec(narrow)).ev_overflow.numpy()
    assert ovf.sum() == got[3].overflow
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(a[~ovf], b[~ovf])

    # The re-traced rays, held against the JAX driver's re-trace of them.
    idx = np.nonzero(ovf)[0]
    colors = np.zeros((rr.size, 4))
    classes = np.zeros(rr.size, np.int32)
    stops = np.zeros(rr.size, np.int32)
    jrt._retrace_overflow(j_scene, rr, cc, idx, colors, classes, stops)
    np.testing.assert_array_equal(got[1][idx], classes[idx])
    np.testing.assert_array_equal(got[2][idx], stops[idx] != 6)
    np.testing.assert_allclose(got[0][idx], colors[idx], rtol=COLOR_TOL, atol=1e-12)
    assert (got[0][idx, :3] != ref[0][idx, :3]).any()  # the RKF45 path, not the kernel path


def test_unported_volumetric_scenes_raise():
    """A volumetric disc beside a thin disc: the kernel path's one-object
    tracer still refuses it (trace_rays_fast_vol raises NotImplementedError
    for its direct callers), and the render driver renders it through the
    split path: with lax=True (the RKF45 geometric pass and raymarch) equal
    to the JAX driver's frame, which on the CPU takes the same forms
    (stop codes, classes equal; colors within 1e-8); without, through the
    kernel geometric pass and K5's plain version."""
    j_scene, t_scene = _scenes("Kerr", CAMERA)
    (vol,) = t_scene.objects
    disc = Disc(vol.inner_radius, vol.outer_radius, vol.temperature_model, vol.texture)
    both = dataclasses.replace(t_scene, objects=(vol, disc))
    (jvol,) = j_scene.objects
    j_both = j_scene.replace(objects=(jvol, JDisc(jvol.inner_radius, jvol.outer_radius, jvol.temperature_model,
                                                  jvol.texture)))
    assert tfp.supports_scene(both) and tfp.scene_kernel_spec(both).vol_spec is None
    rr, cc = pixel_grid(4, 8)
    rr, cc = rr + 2.0, cc + 4.0  # the frame's middle, where gas and disc are
    x, p = tcam.pixel_rays(both.camera, t(rr), t(cc))
    with pytest.raises(NotImplementedError):
        tfp.trace_rays_fast_vol(both, x, p)
    assert trt._route(both, lax=False) == trt._route(both, lax=True) == "split"

    c, k, ok, stats = trt.trace_pixels_chunked(both, rr, cc, chunk_size=64, lax=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrt, "VOLUMETRIC_LANE_CHUNK", 64)  # lax raymarch batches of 64 lanes
        c_r, k_r, ok_r = jrt.trace_pixels_chunked(j_both, rr, cc, chunk_size=64)
    np.testing.assert_array_equal(k, k_r)
    np.testing.assert_array_equal(ok, ok_r)
    np.testing.assert_allclose(c, c_r, rtol=COLOR_TOL, atol=1e-12)
    assert stats.vol_lanes > 0 and (k == 2).any()
    c2, k2, _, s2 = trt.trace_pixels_chunked(both, rr, cc, chunk_size=64)
    assert np.isfinite(c2).all() and s2.vol_lanes > 0 and s2.vol_samples > 0


@pytest.mark.cuda
def test_cuda_raymarch_matches_plain_version():
    """K5 against its plain version on the card, float64 and float32, on the
    volumetric lanes of the 16×8 frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for dtype in (torch.float64, torch.float32):
        t_cfg = tcfg.parse_config(KERR_VOLUMETRIC_SCENE)
        scene = tcfg.create_scene(t_cfg, tcfg.RenderOptions(**FRAME, **CAMERA), dtype, torch.device("cuda"))
        rr, cc = pixel_grid(ROWS, COLS)
        x, p = tcam.pixel_rays(scene.camera, *(t(a).to(dtype).cuda() for a in (rr, cc)))
        spec = tfp.scene_kernel_spec(scene)
        g = tfp.trace_geometric_fast(scene, x, p, spec)
        _, ins = tfp.volumetric_lanes(scene.objects[0], g.ev_kind, g.ev_data, g.observer_energy, g.p_t, g.p_phi)
        got, n_got = vm.raymarch(spec.vol_spec, *ins)
        ref, n_ref = vm.raymarch_plain(spec.vol_spec, *ins)
        assert torch.equal(n_got, n_ref)
        assert torch.equal(got, ref)
