"""The port's volumetric disc and raymarch against the JAX package, float64:
the bounding-volume exit distance, UV and march length within 1e-12; the
Chebyshev temperature and blackbody fits within 1e-9; `raymarch_plain` (K5's
plain version) against the JAX kernel `volumetric_pallas.raymarch` in
interpret mode within 1e-9 of each lane's scale, with a blackbody and a
checker texture, inactive lanes included; the loader's validation."""

import dataclasses
import math
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_raytracer_tpu.geometry.kerr import Kerr as JKerr
from gr_raytracer_tpu.ops import volumetric_pallas as vp
from gr_raytracer_tpu.rendering.texture import BlackBodyMap as JBlackBody
from gr_raytracer_tpu.rendering.texture import CheckerMap as JChecker
from gr_raytracer_tpu_torch import config as tcfg
from gr_raytracer_tpu_torch.geometry.kerr import Kerr
from gr_raytracer_tpu_torch.objects.volumetric_disc import VolumetricDisc
from gr_raytracer_tpu_torch.ops import volumetric_march as vm
from gr_raytracer_tpu_torch.rendering.temperature import build_disc_temperature
from gr_raytracer_tpu_torch.rendering.texture import BlackBodyMap, CheckerMap
from torch_port_scenes import CPU, F64, REPO, t

sys.path.insert(0, f"{REPO}/tests")
from test_volumetric_pallas import make_disc, make_inputs  # noqa: E402

TOL = 1e-9
# The hero disc of kerr-volumetric-streaky.toml with a short march.
DISC = dict(num_octaves=8, perlin_seed=3, max_steps=600, step_size=0.02, thickness=0.03,
            density_multiplier=500.0, brightness_reference_temperature=1000.0, absorption=0.3,
            scattering=0.4, noise_scale=(60.0, 2.0, 30.0), noise_offset=-0.2)
CHECKER = (2.0, 8.0, 8.0, (255, 120, 0), (120, 40, 0))


def _port_disc(texture):
    temp = build_disc_temperature(1.0, 0.499, 5000.0, 16.0, F64, CPU)
    return VolumetricDisc.create(4.05, 16.0, temp, texture, dtype=F64, device=CPU, **DISC)


def _grazing_lanes(n, seed):
    """Lanes that enter the slab at a shallow angle from the cap and march
    hundreds of samples, many across the inner hole."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(5.0, 14.0, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    ro = np.stack([r * np.cos(phi), r * np.sin(phi), np.full(n, 0.09)], axis=-1)
    to_center = -ro[:, :2] / r[:, None] + rng.normal(0, 0.15, (n, 2))
    rd = np.concatenate([to_center, -rng.uniform(0.01, 0.04, (n, 1))], axis=-1)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


@pytest.fixture(scope="module")
def marches():
    """{texture: (port spec, inputs as numpy, JAX kernel's XYZA)}: the JAX
    side in interpret mode, once per module."""
    geometry = JKerr(radius=jnp.asarray(1.0), a=jnp.asarray(0.499), horizon_epsilon=jnp.asarray(1e-4))
    tgeometry = Kerr(radius=torch.tensor(1.0, dtype=F64), a=torch.tensor(0.499, dtype=F64),
                     horizon_epsilon=torch.tensor(1e-4, dtype=F64))
    out = {}
    for name, jtex, ttex in (
        ("blackbody", JBlackBody.create(jnp.asarray(0.0)), BlackBodyMap.create(0.0, F64, CPU)),
        ("checker", JChecker.from_srgb(*CHECKER), CheckerMap.from_srgb(*CHECKER, F64, CPU)),
    ):
        jdisc = make_disc(jtex, geometry)
        jspec = vp.build_vol_spec(jdisc, geometry)
        ro, rd, obs, p_t, p_phi, active, _ = (np.asarray(v) for v in make_inputs(jdisc, n=160, seed=1))
        g_ro, g_rd = _grazing_lanes(96, seed=2)
        ro, rd = np.concatenate([ro, g_ro]), np.concatenate([rd, g_rd])
        rng = np.random.default_rng(3)
        obs, p_t, p_phi = (np.concatenate([v, rng.uniform(lo, hi, 96)])
                           for v, (lo, hi) in ((obs, (0.9, 1.1)), (p_t, (0.8, 1.2)), (p_phi, (-0.5, 0.5))))
        active = np.concatenate([active, np.arange(96) % 13 != 0])
        ed = np.where(active, np.asarray(jdisc.exit_distance(jnp.asarray(ro), jnp.asarray(rd))), 0.0)
        ins = (ro, rd, obs, p_t, p_phi, active, ed)
        # The kernel's unroll is bit-equivalent to the rolled loop (each
        # sub-sample carries its own live mask); rolled, it compiles in a
        # quarter of the time.
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(vp, "UNROLL", 1)
            ref = np.asarray(vp.raymarch(jspec, *(jnp.asarray(v) for v in ins), interpret=True))
        out[name] = (vm.build_vol_spec(_port_disc(ttex), tgeometry), jspec, jdisc, ins, ref)
    return out


def test_exit_distance_uv_and_march_length_match_jax(marches):
    _, _, jdisc, (ro, rd, *_), _ = marches["blackbody"]
    disc = _port_disc(BlackBodyMap.create(0.0, F64, CPU))
    ed_t = disc.exit_distance(t(ro), t(rd))
    ed_j = np.asarray(jdisc.exit_distance(jnp.asarray(ro), jnp.asarray(rd)))
    np.testing.assert_allclose(ed_t.numpy(), ed_j, rtol=1e-12, atol=1e-12)
    assert (ed_j < disc.max_steps * 0.02).any()  # real exits, not only the budget
    for got, want in zip(disc.uv(t(ro)), jdisc.uv(jnp.asarray(ro))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    ml_t = vm.march_length(disc, t(ro), t(rd), ed_t)
    ml_j = np.asarray(vp.march_length_jnp(jdisc, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(ed_j)))
    np.testing.assert_allclose(ml_t.numpy(), ml_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ml_j, vp.march_length(jdisc, ro, rd, ed_j), rtol=1e-12, atol=1e-12)


def test_chebyshev_specs_match_jax(marches):
    for name, (spec, jspec, *_rest) in marches.items():
        t4_scale = max(map(abs, jspec.temp.coeffs))
        np.testing.assert_allclose(spec.temp.coeffs, jspec.temp.coeffs, rtol=TOL, atol=TOL * t4_scale)
        assert (spec.temp.lo, spec.temp.hi) == pytest.approx((jspec.temp.lo, jspec.temp.hi), rel=1e-15)
        assert spec.tex.kind == jspec.tex.kind == name
        for field in ("beaming", "lo", "hi", "split", "width", "height"):
            assert getattr(spec.tex, field) == pytest.approx(getattr(jspec.tex, field), rel=1e-15), (name, field)
        for field in ("cx", "cy", "cz", "cx2", "cy2", "cz2", "c1", "c2"):
            np.testing.assert_allclose(getattr(spec.tex, field), getattr(jspec.tex, field), rtol=TOL, atol=TOL)
        for field in ("inner", "outer", "thickness", "density_multiplier", "brightness_ref", "absorption",
                      "scattering", "noise_scale", "noise_offset", "step_size", "max_steps", "num_octaves",
                      "key", "axis", "e1", "e2", "r_s", "a"):
            assert getattr(spec, field) == getattr(jspec, field), (name, field)


def test_raymarch_plain_matches_jax_kernel(marches):
    for name, (spec, _, _, ins, ref) in marches.items():
        active = ins[5]
        got, samples = vm.raymarch(spec, *(t(v) for v in ins))  # CPU: the plain version
        got = got.numpy()
        scale = np.abs(ref).max(axis=1, keepdims=True)
        err = np.abs(got - ref) / np.maximum(scale, 1e-300)
        assert err.max() <= TOL, (name, err.max())
        assert (got[~active] == 0).all() and (samples.numpy()[~active] == 0).all()
        # The lanes emit, some march hundreds of samples, and some stop early.
        assert (ref[active, 3] > 0).mean() > 0.5, name
        assert samples.max() > 200 and samples.max() < spec.max_steps, (name, int(samples.max()))
        assert vm.launches == 0


def test_raymarch_rejects_bad_arguments(marches):
    spec, _, _, ins, _ = marches["checker"]
    args = [t(v) for v in ins]
    with pytest.raises(ValueError):
        vm.raymarch(spec, args[0][:, :2], *args[1:])
    with pytest.raises(ValueError):
        vm.raymarch(spec, *args[:5], args[5].to(F64), args[6])
    with pytest.raises(NotImplementedError):
        vm.raymarch(spec._replace(num_octaves=vm.MAX_OCTAVES + 1), *args)


def test_loader_builds_and_validates_volumetric_discs():
    cfg = tcfg.load_config(f"{REPO}/scene-definitions/kerr-volumetric-streaky.toml")
    opts = tcfg.RenderOptions(width=4, height=4)
    scene = tcfg.create_scene(cfg, opts, F64, CPU)
    (obj,) = scene.objects
    assert isinstance(obj, VolumetricDisc) and obj.axis_is_z() and obj.max_steps == 50_000
    assert obj.key == (0 * 0x9E3779B9 + 1) & 0xFFFFFFFF
    raw = dict(cfg.objects[0])
    bad = {"inner_radius": 20.0, "thickness": 0.0, "max_steps": 0, "step_size": -1.0,
           "brightness_reference_temperature": 0.0, "absorption": -0.1, "scattering": -0.1,
           "axis": [1.0, 0.0, 0.0]}
    for key, value in bad.items():
        broken = dict(raw, **{key: value})
        with pytest.raises(tcfg.ConfigError, match=r"objects\[0\]\.VolumetricDisc"):
            tcfg.create_scene(dataclasses.replace(cfg, objects=(broken,)), opts, F64, CPU)
    # A scene the port does not build yet (a flat-space geometry) still raises.
    with pytest.raises(tcfg.ConfigError):
        tcfg.create_scene(tcfg.load_config(f"{REPO}/scene-definitions/euclidean.toml"), opts, F64, CPU)
    assert math.isclose(obj.step_size.item(), 0.0002)
