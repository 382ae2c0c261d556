"""The port's geodesic march (K1) against the JAX kernel.

On the CPU the port's entry point runs its plain torch version; the JAX
kernel runs in interpret mode. Same 1,024 flagship rays, float64: stop
codes, steps, event counts and kinds equal; states and event payloads
within 1e-9 of each lane's scale. On a card, the hand-written CUDA kernel
is held against the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_raytracer_tpu.ops import geodesic_pallas as gp
from gr_raytracer_tpu_torch.ops import geodesic_march as gm
from gr_raytracer_tpu_torch.rendering import camera as tcam
from gr_raytracer_tpu_torch.rendering import fast_path as tfp
from torch_port_scenes import lane_relative_error, pixel_grid, port_flagship, t

MAX_STEPS = 2000
RTOL = 1e-9


@pytest.fixture(scope="module")
def flagship():
    """(march spec, y0 [1024, 8] as numpy) of a 32×32 flagship frame: both
    marches get the same numbers."""
    scene = port_flagship(32, 32, max_steps=MAX_STEPS)
    x, p = tcam.pixel_rays(scene.camera, *(t(a) for a in pixel_grid(32, 32)))
    y0 = scene.geometry.make_solver(x, p).initial_state(x, p)
    return tfp.scene_kernel_spec(scene), y0.numpy()


def _both(spec, y0, **kw):
    """(JAX kernel in interpret mode, port march) outputs as numpy."""
    args = (spec.radius, spec.a, spec.horizon_epsilon)
    discs = tuple(gp.DiscSpec(*d) for d in spec.discs)
    ref = gp.kerr_rk4_march(*args, jnp.asarray(y0), discs=discs, interpret=True, **kw)
    got = gm.kerr_rk4_march(*args, t(y0), discs=spec.discs, **kw)
    return [np.asarray(a) for a in ref], [a.numpy() for a in got]


@pytest.mark.parametrize(
    "far_field,opaque,compensated",
    [(True, True, False), (False, False, True), (True, False, True), (False, True, False)],
)
def test_plain_march_matches_jax_kernel(flagship, far_field, opaque, compensated):
    spec, y0 = flagship
    ref, got = _both(
        spec, y0, h0=1.0, max_steps=MAX_STEPS, max_radius=40.0,
        r_safe=spec.r_safe if far_field else 0.0, opaque_stop=opaque, compensated=compensated,
    )
    y_r, stop_r, steps_r, kind_r, data_r, count_r, ovf_r = ref
    y_g, stop_g, steps_g, kind_g, data_g, count_g, ovf_g = got
    np.testing.assert_array_equal(stop_g, stop_r)
    np.testing.assert_array_equal(steps_g, steps_r)
    np.testing.assert_array_equal(count_g, count_r)
    np.testing.assert_array_equal(kind_g, kind_r)
    np.testing.assert_array_equal(ovf_g, ovf_r)
    assert lane_relative_error(y_r, y_g) <= RTOL
    assert lane_relative_error(data_r, data_g) <= RTOL
    # The case exercises what it names.
    assert (stop_r == 2).any() and (stop_r == 1).any()
    assert ((stop_r == 7).any()) == opaque


def test_bounded_attempts_without_finalize_match_jax_kernel(flagship):
    """attempts < budget with finalize=False leaves unfinished lanes RUNNING
    (stop code 0) instead of BUDGET, as the JAX kernel does."""
    spec, y0 = flagship
    ref, got = _both(
        spec, y0, h0=1.0, max_steps=MAX_STEPS, max_radius=40.0, r_safe=spec.r_safe,
        opaque_stop=True, attempts=40, finalize=False,
    )
    for r, g in zip(ref[1:4] + ref[5:], got[1:4] + got[5:]):
        np.testing.assert_array_equal(g, r)
    assert lane_relative_error(ref[0], got[0]) <= RTOL
    assert (got[1] == 0).any() and (got[1] != 0).any()
    assert (got[2] <= 40).all()


def test_rhs_matches_jax_analytic_and_autodiff():
    rng = np.random.default_rng(7)
    y = rng.normal(size=(8, 256)) * 3.0
    y[1:4] += np.sign(y[1:4]) * 2.0  # keep off the ring singularity
    for a in (0.0, 0.45, 0.9):
        got = gm._rhs(torch.tensor(1.0, dtype=torch.float64), torch.tensor(a, dtype=torch.float64), t(y))
        for ref in (gp._rhs(1.0, a, jnp.asarray(y)), gp._rhs_autodiff(1.0, a, jnp.asarray(y))):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)


def test_wrapper_rejects_unported_options():
    """Malformed options raise: spheres up to MAX_SPHERES SphereSpecs, and a
    resume tuple of a march of the same lanes (tests/test_torch_resume.py
    holds resumed legs against one shot and against JAX)."""
    y0 = torch.zeros((4, 8), dtype=torch.float64)
    args = (1.0, 0.45, 1e-3, y0, 1.0, 10, 40.0)
    with pytest.raises(TypeError):
        gm.kerr_rk4_march(*args, spheres=(object(),))
    sphere = gm.SphereSpec(2.0, 0.0, 0.0, 0.0, 0)
    with pytest.raises(NotImplementedError):
        gm.kerr_rk4_march(*args, spheres=(sphere,) * (gm.MAX_SPHERES + 1))
    assert gm.kerr_rk4_march(*args, spheres=(sphere,) * gm.MAX_SPHERES)[0].shape == (4, 8)
    prev = gm.kerr_rk4_march(*args)
    assert gm.kerr_rk4_march(*args, resume=prev)[0].shape == (4, 8)
    with pytest.raises(ValueError):
        gm.kerr_rk4_march(*args, resume=tuple(v[:3] for v in prev))
    with pytest.raises(ValueError):
        gm.kerr_rk4_march(*args, ckpt_every=-1)
    with pytest.raises(ValueError):
        gm.kerr_rk4_march(1.0, 0.45, 1e-3, torch.zeros((4, 7), dtype=torch.float64), 1.0, 10, 40.0)


def test_nan_lane_of_the_kerr_toml_frame():
    """Pixel (581, 623) of the 1000² kerr.toml frame (the README camera,
    budget 20,000) stops NAN at step 40 in float32, on the card and on the
    CPU. Its 40th step ends near the horizon, where an RK4 stage lands in
    the equatorial plane inside the ring (ρ < a), the Kerr-Schild r
    underflows and the right-hand side is not finite. The JAX kernel, given
    the port's state after 39 steps, stops NAN at the same step; from y0
    it wanders by a few float32 ulps in 39 steps (XLA and torch round
    differently) and steps over the ring. In float64 both stop HORIZON at
    step 40, which renders as the same black pixel as NAN. The march also
    leaves a one-lane y0 untouched."""
    y0 = [0.0, -10.0, 0.0, -0.5, 0.9486839175224304, 1.133610486984253, -0.21163426339626312,
          -0.0735451951622963]
    y39 = [float.fromhex(h) for h in (
        "-0x1.a82b1ep+4", "0x1.d9fa14p-2", "0x1.4fd9e0p-1", "0x1.8d2680p-12", "0x1.e5b9e6p-1",
        "-0x1.c25c6ap+6", "-0x1.d92a20p+6", "-0x1.a4cc00p-4",
    )]
    args = (1.0, 0.499, 1e-4)
    kw = dict(h0=1.0, max_steps=20000, max_radius=15000.0, r_safe=30.0, opaque_stop=True)
    disc = (0.795, 15.0, 0)
    for start, dtype, attempts, want in ((y0, np.float64, None, (1, 40)), (y39, np.float32, 1, (3, 1))):
        lanes = np.repeat(np.asarray([start], dtype), gp.LANE_TILE, axis=0)
        ref = gp.kerr_rk4_march(*args, jnp.asarray(lanes), discs=(gp.DiscSpec(*disc),), interpret=True,
                                attempts=attempts, **kw)
        y_in = t(lanes[:1])
        got = gm.kerr_rk4_march(*args, y_in, discs=(gm.DiscSpec(*disc),), attempts=attempts, **kw)
        np.testing.assert_array_equal(y_in.numpy(), lanes[:1])
        assert (int(ref[1][0]), int(ref[2][0])) == want == (int(got[1][0]), int(got[2][0]))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_march(flagship):
    """Runs only on a machine with a card (chip_smoke.py does the same at
    the main path's size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec, y0 = flagship
    kw = dict(h0=1.0, max_steps=MAX_STEPS, max_radius=40.0, discs=spec.discs,
              r_safe=spec.r_safe, opaque_stop=True)
    args = (spec.radius, spec.a, spec.horizon_epsilon)
    before = gm.launches
    got = gm.kerr_rk4_march(*args, t(y0).cuda(), **kw)
    ref = gm.march_plain(*args, t(y0).cuda(), **kw)
    assert gm.launches == before + 1
    stop_g, stop_r = got[1].cpu().numpy(), ref[1].cpu().numpy()
    assert (stop_g == stop_r).mean() >= 0.999
    same = stop_g == stop_r
    assert lane_relative_error(ref[0].cpu().numpy()[same], got[0].cpu().numpy()[same]) <= RTOL
