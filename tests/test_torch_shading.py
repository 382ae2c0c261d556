"""The port's shading against the JAX package, float64: the blackbody and
Novikov-Thorne lookup tables (1e-10), the three textures, the decoded
celestial bitmap (exactly), and the alpha fold on random event buffers
(1e-12)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_raytracer_tpu.rendering import blackbody as jbb
from gr_raytracer_tpu.rendering import color as jcol
from gr_raytracer_tpu.rendering import scene as jscn
from gr_raytracer_tpu.rendering import temperature as jtemp
from gr_raytracer_tpu.rendering import texture as jtex
from gr_raytracer_tpu_torch.rendering import blackbody as tbb
from gr_raytracer_tpu_torch.rendering import color as tcol
from gr_raytracer_tpu_torch.rendering import scene as tscn
from gr_raytracer_tpu_torch.rendering import temperature as ttemp
from gr_raytracer_tpu_torch.rendering import texture as ttex
from gr_raytracer_tpu_torch.utils.png import png_decode, png_encode
from torch_port_scenes import CPU, F64, REPO, t

CELESTIAL_PNG = os.path.join(REPO, "resources", "celestial.png")


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300), initial=0.0))


def test_blackbody_lut_matches():
    log_t_j, xyz_j = jbb.build_blackbody_lut(jnp.float64)
    log_t_t, xyz_t = tbb.build_blackbody_lut(F64, CPU)
    assert _rel(log_t_t, log_t_j) <= 1e-10
    # atol: XLA on the CPU flushes subnormal results to zero, torch keeps
    # them; the table's entries below ~1e-200 (T < 25 K) carry that noise.
    np.testing.assert_allclose(xyz_t.numpy(), np.asarray(xyz_j), rtol=1e-10, atol=1e-200)
    temps = np.array([800.0, 2000.0, 5800.0, 12000.0])
    z = np.array([0.5, 1.0, 1.3, 2.0])
    assert _rel(tbb.blackbody_xyz(t(temps), t(z)), jbb.blackbody_xyz(jnp.asarray(temps), jnp.asarray(z))) <= 1e-10


@pytest.mark.parametrize("a,temperature,outer", [(0.499, 2000.0, 15.0), (0.45, 10000.0, 6.0), (0.0, 5000.0, 20.0)])
def test_novikov_thorne_lut_matches(a, temperature, outer):
    ref = jtemp.build_disc_temperature(1.0, a, temperature, outer, jnp.float64)
    got = ttemp.build_disc_temperature(1.0, a, temperature, outer, F64, CPU)
    assert _rel(got.r_isco, ref.r_isco) <= 1e-10
    assert _rel(got.radii, ref.radii) <= 1e-10
    assert _rel(got.temps[1:], np.asarray(ref.temps)[1:]) <= 1e-10
    r = np.linspace(0.5, outer + 1.0, 300)
    assert _rel(got.at(t(r)), ref.at(jnp.asarray(r))) <= 1e-10
    np.testing.assert_array_equal(got.below_isco(t(r)).numpy(), np.asarray(ref.below_isco(jnp.asarray(r))))


def _uvtz(n=500):
    rng = np.random.default_rng(11)
    return (rng.uniform(-0.2, 1.2, n), rng.uniform(-0.2, 1.2, n),
            rng.uniform(500.0, 20000.0, n), rng.uniform(0.3, 2.5, n))


def test_textures_color_at_uv_match():
    u, v, temp, z = _uvtz()
    jargs = tuple(jnp.asarray(a) for a in (u, v, temp, z))
    targs = tuple(t(a) for a in (u, v, temp, z))
    pairs = [
        (jtex.CheckerMap.from_srgb(1.5, 36.0, 18.0, (8, 8, 24), (200, 90, 8, 128), dtype=jnp.float64),
         ttex.CheckerMap.from_srgb(1.5, 36.0, 18.0, (8, 8, 24), (200, 90, 8, 128), F64, CPU)),
        (jtex.BlackBodyMap.create(3.0, dtype=jnp.float64), ttex.BlackBodyMap.create(3.0, F64, CPU)),
    ]
    for jmap, tmap in pairs:
        np.testing.assert_allclose(tmap.color_at_uv(*targs).numpy(), np.asarray(jmap.color_at_uv(*jargs)), rtol=1e-10, atol=1e-14)


def test_celestial_bitmap_decodes_and_samples_like_jax():
    """The decoded RGBA bytes are identical to the JAX package's decoder;
    the XYZA image then agrees to the last bits of the sRGB power law and
    the 3-term matrix product (2.2e-16 relative)."""
    from gr_raytracer_tpu import native

    with open(CELESTIAL_PNG, "rb") as f:
        data = f.read()
    ref_rgba = native.png_decode(data)
    if ref_rgba is None:  # the JAX package's own fallback
        from PIL import Image

        ref_rgba = np.asarray(Image.open(CELESTIAL_PNG).convert("RGBA"))
    np.testing.assert_array_equal(png_decode(data), ref_rgba)
    jmap = jtex.BitmapMap.from_file(CELESTIAL_PNG, 3.0, dtype=jnp.float64)
    tmap = ttex.BitmapMap.from_file(CELESTIAL_PNG, 3.0, F64, CPU)
    np.testing.assert_allclose(tmap.image.numpy(), np.asarray(jmap.image), rtol=4.5e-16, atol=0)
    u, v, temp, z = _uvtz()
    got = tmap.color_at_uv(t(u), t(v), t(temp), t(z))
    ref = jmap.color_at_uv(*(jnp.asarray(a) for a in (u, v, temp, z)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-15)


def test_png_round_trip_and_tone_map():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(9, 13, 3), dtype=np.uint8)
    np.testing.assert_array_equal(png_decode(png_encode(img))[..., :3], img)
    xyza = np.concatenate([rng.uniform(0.0, 3.0, size=(9, 13, 3)), np.ones((9, 13, 1))], axis=-1)
    for method in ("reinhard", "global-linear"):
        np.testing.assert_array_equal(
            tcol.xyza_buffer_to_srgb8(t(xyza), method=method).numpy(),
            np.asarray(jcol.xyza_buffer_to_srgb8(jnp.asarray(xyza), method=method)),
        )


class _Adaptive:
    object_hit_opacity_threshold = 0.5


class _SceneStub:
    adaptive = _Adaptive()


def test_fold_samples_matches_on_random_event_buffers():
    rng = np.random.default_rng(5)
    n, k = 400, 8
    ev_kind = rng.integers(-1, 2, size=(n, k)).astype(np.int32)
    colors = rng.uniform(0.0, 2.0, size=(n, k, 4))
    colors[..., 3] = rng.uniform(-0.2, 1.2, size=(n, k))
    stop = rng.integers(0, 8, size=n).astype(np.int32)
    celestial = rng.uniform(0.0, 1.0, size=(n, 4))
    got = tscn.fold_samples(_SceneStub(), t(ev_kind), t(colors), t(stop), t(celestial))
    ref = jscn.fold_samples(_SceneStub(), *(jnp.asarray(a) for a in (ev_kind, colors, stop, celestial)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
