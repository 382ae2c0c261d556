"""The port's Boyer-Lindquist (Mino-time) march against the JAX kernel
kerr_bl_rk4_march.

On the CPU the port's entry point runs its plain torch version; the JAX
kernel runs in interpret mode. The same rays (a 32×32 kerr-bl.toml frame,
and a 32×32 Schwarzschild disc frame marched at a = 0), float64: stop
codes, steps, event counts and kinds, overflow flags equal; states, event
payloads and checkpoint rows within 1e-9 of each lane's scale. On a card,
the hand-written CUDA kernel is held against the plain version."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_raytracer_tpu.ops import geodesic_pallas as gp
from gr_raytracer_tpu_torch import config as tcfg
from gr_raytracer_tpu_torch.ops import geodesic_march as gm
from gr_raytracer_tpu_torch.rendering import camera as tcam
from gr_raytracer_tpu_torch.rendering import fast_path as tfp
from torch_port_scenes import (
    BL_CAMERA, CPU, F64, KERR_BL_TOML, REPO, SCHWARZSCHILD_DISC_TOML, lane_relative_error, pixel_grid, t,
)

MAX_STEPS = 300  # the nominal budget; the Mino march takes twice as many
MAX_RADIUS = 30.0
RTOL = 1e-9
K_CKPT = 64


def _frame(cfg):
    """(march spec, y0, e, l_z, q as numpy) of a 32×32 frame of `cfg`."""
    opts = tcfg.RenderOptions(width=32, height=32, max_steps=MAX_STEPS, max_radius=MAX_RADIUS, **BL_CAMERA)
    scene = tcfg.create_scene(cfg, opts, F64, CPU)
    x, p = tcam.pixel_rays(scene.camera, *(t(a) for a in pixel_grid(32, 32)))
    solver, y0, _, _ = tfp._prepare_march(scene, x, p)
    spec = tfp.scene_kernel_spec(scene)
    assert spec.mino
    return spec, y0.numpy(), solver.e.numpy(), solver.l_z.numpy(), solver.q.numpy()


@pytest.fixture(scope="module")
def kerr_bl():
    # The sky's bitmap plays no part in the march.
    sky = {"kind": "BlackBody", "beaming_exponent": 0.0}
    return _frame(dataclasses.replace(tcfg.load_config(KERR_BL_TOML), celestial_texture=sky))


def _both(spec, y0, e, l_z, q, **kw):
    """(JAX kernel in interpret mode, port march) outputs as numpy."""
    args = (spec.radius, spec.a, spec.horizon_epsilon)
    discs = tuple(gp.DiscSpec(*d) for d in spec.discs)
    ref = gp.kerr_bl_rk4_march(
        *args, jnp.asarray(y0), jnp.asarray(e), jnp.asarray(l_z), jnp.asarray(q), discs=discs,
        interpret=True, **kw,
    )
    got = gm.kerr_bl_rk4_march(*args, t(y0), t(e), t(l_z), t(q), discs=spec.discs, **kw)
    return [np.asarray(a) for a in ref], [a.numpy() for a in got]


def _assert_same(ref, got):
    y_r, stop_r, steps_r, kind_r, data_r, count_r, ovf_r = ref[:7]
    y_g, stop_g, steps_g, kind_g, data_g, count_g, ovf_g = got[:7]
    np.testing.assert_array_equal(stop_g, stop_r)
    np.testing.assert_array_equal(steps_g, steps_r)
    np.testing.assert_array_equal(count_g, count_r)
    np.testing.assert_array_equal(kind_g, kind_r)
    np.testing.assert_array_equal(ovf_g, ovf_r)
    assert lane_relative_error(y_r, y_g) <= RTOL
    assert lane_relative_error(data_r, data_g) <= RTOL


def test_plain_bl_march_matches_jax_kernel(kerr_bl):
    """The opaque stop, the Kahan update with every event kept, and the
    reverse sweep's checkpoints (rows a lane reaches)."""
    spec, y0, e, l_z, q = kerr_bl
    base = dict(h0=0.01, max_steps=2 * MAX_STEPS, max_radius=MAX_RADIUS)
    for kw in (dict(opaque_stop=True), dict(compensated=True), dict(opaque_stop=True, ckpt_every=K_CKPT)):
        ref, got = _both(spec, y0, e, l_z, q, **base, **kw)
        _assert_same(ref, got)
        stop = ref[1]
        # The case exercises what it names: sky, disc and trapped lanes.
        assert (stop == 2).any() and (stop == 4).any()
        assert (stop == 7).any() == bool(kw.get("opaque_stop"))
        assert (ref[5] > 0).any()
        if "ckpt_every" in kw:
            ckpt_r, ckpt_g = ref[7], got[7]
            assert ckpt_g.shape == ckpt_r.shape == (-(-2 * MAX_STEPS // K_CKPT), 8, len(y0))
            reached = np.arange(ckpt_r.shape[0])[:, None] * K_CKPT < ref[2][None]
            assert reached[1:].any()
            rows = lambda c: c.transpose(2, 0, 1)[reached.T]
            assert lane_relative_error(rows(ckpt_r), rows(ckpt_g)) <= RTOL


def test_schwarzschild_frame_at_zero_spin_matches_jax_kernel():
    """Schwarzschild marched as KerrBL with a = 0; bounded attempts without
    finalize leave unfinished lanes RUNNING, as in the JAX kernel."""
    spec, y0, e, l_z, q = _frame(tcfg.parse_config(SCHWARZSCHILD_DISC_TOML, REPO))
    assert spec.a == 0.0
    ref, got = _both(spec, y0, e, l_z, q, h0=0.01, max_steps=2 * MAX_STEPS, max_radius=MAX_RADIUS,
                     opaque_stop=True)
    _assert_same(ref, got)
    assert (ref[1] == 2).any() and (ref[1] == 7).any()
    ref, got = _both(spec, y0, e, l_z, q, h0=0.01, max_steps=2 * MAX_STEPS, max_radius=MAX_RADIUS,
                     opaque_stop=True, attempts=40, finalize=False)
    _assert_same(ref, got)
    assert (got[1] == 0).any() and (got[2] <= 40).all()


def test_bl_rhs_and_momentum_match_jax():
    rng = np.random.default_rng(11)
    n = 256
    y = np.stack([rng.normal(size=n), rng.uniform(1.5, 40.0, n), rng.uniform(0.1, 3.0, n),
                  rng.uniform(-3.0, 3.0, n), rng.normal(size=n) * 5.0, rng.normal(size=n),
                  np.zeros(n), np.zeros(n)])
    e, l_z, q = rng.uniform(0.5, 1.5, n), rng.normal(size=n) * 3.0, rng.uniform(0.0, 20.0, n)
    for a in (0.0, 0.499):
        args_t = (torch.tensor(1.0, dtype=F64), torch.tensor(a, dtype=F64), t(e), t(l_z))
        args_j = (1.0, a, jnp.asarray(e), jnp.asarray(l_z))
        got = gm._bl_rhs(*args_t, t(q), t(y))
        ref = gp._bl_rhs(*args_j, jnp.asarray(q), jnp.asarray(y))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)
        got = gm._bl_momentum(*args_t, t(y))
        ref = gp._bl_momentum(*args_j, jnp.asarray(y))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)
    # At a pole the right-hand side is not finite: the march stops NAN.
    y_pole = y[:, :1].copy()
    y_pole[2] = 0.0
    assert not np.isfinite(gm._bl_rhs(*args_t[:2], t(e[:1]), t(l_z[:1]), t(q[:1]), t(y_pole)).numpy()).all()


def test_bl_wrapper_rejects_unported_options():
    """Malformed options raise: spheres up to MAX_SPHERES SphereSpecs,
    volumes up to MAX_VOLS, and a resume tuple of a march of the same lanes
    (tests/test_torch_resume.py holds resumed legs against one shot)."""
    y0 = torch.zeros((4, 8), dtype=F64)
    c = torch.ones(4, dtype=F64)
    args = (1.0, 0.45, 1e-3, y0, c, c, c, 0.01, 10, 40.0)
    with pytest.raises(TypeError):
        gm.kerr_bl_rk4_march(*args, spheres=(object(),))
    sphere = gm.SphereSpec(2.0, 0.0, 0.0, 0.0, 0)
    with pytest.raises(NotImplementedError):
        gm.kerr_bl_rk4_march(*args, spheres=(sphere,) * (gm.MAX_SPHERES + 1))
    assert gm.kerr_bl_rk4_march(*args, spheres=(sphere,) * gm.MAX_SPHERES)[0].shape == (4, 8)
    with pytest.raises(NotImplementedError):
        gm.kerr_bl_rk4_march(*args, vols=(gm.VolSpec(3.0, 6.0, 0.3, 0),) * (gm.MAX_VOLS + 1))
    prev = gm.kerr_bl_rk4_march(*args)
    assert gm.kerr_bl_rk4_march(*args, resume=prev)[0].shape == (4, 8)
    with pytest.raises(ValueError):
        gm.kerr_bl_rk4_march(*args, resume=prev[:1] + (prev[1].long(),) + prev[2:])
    with pytest.raises(ValueError):
        gm.kerr_bl_rk4_march(1.0, 0.45, 1e-3, y0, c[:3], c, c, 0.01, 10, 40.0)
    with pytest.raises(ValueError):
        gm.kerr_bl_rk4_march(*args, ckpt_every=-1)


@pytest.mark.cuda
def test_cuda_bl_kernel_matches_plain_march(kerr_bl):
    """Runs only on a machine with a card (chip_smoke.py does the same at
    the main path's size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec, y0, e, l_z, q = kerr_bl
    kw = dict(h0=0.01, max_steps=2 * MAX_STEPS, max_radius=MAX_RADIUS, discs=spec.discs, opaque_stop=True)
    args = (spec.radius, spec.a, spec.horizon_epsilon) + tuple(t(v).cuda() for v in (y0, e, l_z, q))
    before = gm.bl_launches
    got = gm.kerr_bl_rk4_march(*args, **kw)
    ref = gm.march_bl_plain(*args, **kw)
    assert gm.bl_launches == before + 1
    stop_g, stop_r = got[1].cpu().numpy(), ref[1].cpu().numpy()
    assert (stop_g == stop_r).mean() >= 0.999
    same = stop_g == stop_r
    assert lane_relative_error(ref[0].cpu().numpy()[same], got[0].cpu().numpy()[same]) <= RTOL
