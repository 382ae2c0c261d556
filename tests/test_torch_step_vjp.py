"""The reverse sweeps' step VJP written by hand (ops/geodesic_adjoint.py
ks_step_vjp and bl_step_vjp, the lines of the CUDA sweeps K2 and K4)
against torch.func.vjp of the port's own step map and against jax.vjp of
the JAX package's step map (gr_raytracer_tpu/ops/geodesic_adjoint.py
_step_with_payload and _bl_step_with_payload, plain JAX), in float64 on
the CPU; and the preparation of a batch of rays (initial state, momentum,
cost-sort proxy), which must not depend on how the rays are batched.

Bars: λ and the step's partials within 1e-12 of each lane's scale (its
largest entry) against torch.func.vjp, within 1e-9 against JAX; the
preparation bit for bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gr_raytracer_tpu.ops import geodesic_adjoint as jadj
from gr_raytracer_tpu.ops import geodesic_pallas as gp
from gr_raytracer_tpu_torch import config as tcfg
from gr_raytracer_tpu_torch.ops import geodesic_adjoint as tadj
from gr_raytracer_tpu_torch.ops import geodesic_march as gm
from gr_raytracer_tpu_torch.rendering import camera as tcam
from gr_raytracer_tpu_torch.rendering import fast_path as tfp
from torch_port_scenes import CPU, F64, KERR_BL_TOML, KERR_CAMERA, KERR_TOML, BL_CAMERA, t

KS_KW = dict(h0=1.0, h_min_frac=0.01, r_ref_scale=10.0, r_safe=30.0)
BL_KW = dict(h0=0.01, h_min_frac=0.02, r_ref_scale=10.0)
DISCS = ((1.2, 6.0, 0),)
SPIN = 0.499


def _ks_lanes(n=96, seed=3):
    """Kerr-Schild states: a = 0.499 on the first half of the lanes and 0 on
    the rest; positions from just outside r₊ (h clipped at h_min_frac) to
    beyond r_safe (outward lanes take the far-field lever, inward ones do
    not); covariant momenta with p_t = −1."""
    rng = np.random.default_rng(seed)
    a = np.where(np.arange(n) < n // 2, SPIN, 0.0)
    radius = np.ones(n)
    r_plus = 0.5 + np.sqrt(0.25 - a * a)
    u = rng.normal(size=(3, n))
    u /= np.linalg.norm(u, axis=0)
    rho = rng.uniform(3.0, 60.0, n)
    near = np.arange(n) % 8 == 0  # just outside r₊, on the equator
    rho = np.where(near, np.sqrt((r_plus + 0.04) ** 2 + a * a), rho)
    u[2] = np.where(near, 0.0, u[2])
    u[:2] /= np.where(near, np.linalg.norm(u[:2], axis=0), 1.0)
    pos = u * rho
    mom = rng.normal(size=(3, n)) + np.where(np.arange(n) % 2 == 0, 1.5, -1.5) * u
    y = np.concatenate([rng.normal(size=(1, n)), pos, -np.ones((1, n)), mom])
    return radius, a, y


def _bl_lanes(n=96, seed=4):
    """Boyer-Lindquist states (t, r, θ, φ, v_r, v_θ, 0, 0) with per-lane
    E, L_z, Q: a = 0.499 and 0 (Schwarzschild) as above, lanes just outside
    r₊ (h clipped) and lanes near a pole (θ = 0.05 or π − 0.05)."""
    rng = np.random.default_rng(seed)
    a = np.where(np.arange(n) < n // 2, SPIN, 0.0)
    radius = np.ones(n)
    r_plus = 0.5 + np.sqrt(0.25 - a * a)
    r = np.where(np.arange(n) % 8 == 0, r_plus + 0.02, rng.uniform(2.0, 40.0, n))
    theta = rng.uniform(0.4, math.pi - 0.4, n)
    theta = np.where(np.arange(n) % 8 == 3, 0.05, np.where(np.arange(n) % 8 == 5, math.pi - 0.05, theta))
    y = np.stack([rng.normal(size=n), r, theta, rng.uniform(-3.0, 3.0, n), rng.normal(size=n) * 20.0,
                  rng.normal(size=n) * 3.0, np.zeros(n), np.zeros(n)])
    e, l_z, q = rng.uniform(0.5, 1.5, n), rng.normal(size=n) * 3.0, rng.uniform(0.0, 20.0, n)
    return radius, a, e, l_z, q, y


def _lane_err(got, want):
    """max over lanes of |got − want| over the lane's largest |want| entry;
    got and want are lists of [8, N] and [N] arrays."""
    g = np.concatenate([np.asarray(v, np.float64).reshape(-1, np.shape(v)[-1]) for v in got])
    w = np.concatenate([np.asarray(v, np.float64).reshape(-1, np.shape(v)[-1]) for v in want])
    return float((np.abs(g - w).max(axis=0) / np.abs(w).max(axis=0)).max())


def _ks_hand(radius, a, y, lam):
    lam_new, parts = tadj.ks_step_vjp(t(radius), t(a), t(y), t(lam), **KS_KW)
    return [lam_new.numpy(), *(p.numpy() for p in parts)]


def _bl_hand(radius, a, e, l_z, q, y, lam):
    lam_new, parts = tadj.bl_step_vjp(*(t(v) for v in (radius, a, e, l_z, q, y, lam)), **BL_KW)
    return [lam_new.numpy(), *(p.numpy() for p in parts)]


def test_ks_step_vjp_matches_torch_vjp():
    """Both spins, h clipped near r₊, the far-field lever taken and not."""
    radius, a, y = _ks_lanes()
    lam = np.random.default_rng(7).normal(size=y.shape)
    active = torch.ones(y.shape[1], dtype=torch.bool)
    _, vjp = torch.func.vjp(lambda r_, a_, y_: tadj._masked_step(r_, a_, y=y_, active=active, **KS_KW),
                            t(radius), t(a), t(y))
    w_r, w_a, w_y = vjp(t(lam))
    assert _lane_err(_ks_hand(radius, a, y, lam), [w_y, w_r, w_a]) <= 1e-12
    # The cases are there: a clipped step and far-field lanes both ways.
    k1 = gm._rhs(t(radius), t(a), t(y)).numpy()
    rho = np.linalg.norm(y[1:4], axis=0)
    outward = (y[1:4] * k1[1:4]).sum(axis=0) > 0
    far = rho > KS_KW["r_safe"]
    assert (far & outward).sum() >= 5 and (far & ~outward).sum() >= 5
    r_here = gm._ks_radius(t(a), *(t(v) for v in y[1:4])).numpy()
    r_plus = 0.5 + np.sqrt(0.25 - a * a)
    assert ((r_here - r_plus) / KS_KW["r_ref_scale"] < KS_KW["h_min_frac"]).sum() >= 8


def test_bl_step_vjp_matches_torch_vjp():
    """Both spins, h clipped near r₊, lanes near either pole."""
    radius, a, e, l_z, q, y = _bl_lanes()
    lam = np.random.default_rng(8).normal(size=y.shape)
    active = torch.ones(y.shape[1], dtype=torch.bool)
    _, vjp = torch.func.vjp(
        lambda r_, a_, e_, l_, q_, y_: tadj._bl_masked_step(r_, a_, e=e_, l_z=l_, q=q_, y=y_, active=active, **BL_KW),
        *(t(v) for v in (radius, a, e, l_z, q, y)),
    )
    w = vjp(t(lam))
    assert _lane_err(_bl_hand(radius, a, e, l_z, q, y, lam), [w[5], *w[:5]]) <= 1e-12
    # λ of t, φ and components 6–7 passes through.
    got = _bl_hand(radius, a, e, l_z, q, y, lam)[0]
    np.testing.assert_array_equal(got[[0, 3, 6, 7]], lam[[0, 3, 6, 7]])


def test_ks_step_vjp_matches_jax():
    radius, a, y = _ks_lanes(seed=11)
    n = y.shape[1]
    lam = np.random.default_rng(9).normal(size=y.shape)

    @jax.jit
    def jax_vjp(r_, a_, y_, ct):
        def fn(r2, a2, y2):
            return jadj._step_with_payload(
                tuple(gp.DiscSpec(*d) for d in DISCS), (), KS_KW["h0"], KS_KW["h_min_frac"],
                KS_KW["r_ref_scale"], KS_KW["r_safe"], jnp.zeros(n, jnp.int32), jnp.zeros(n, bool), r2, a2, y2,
                jnp.ones(n, bool),
            )

        _, vjp = jax.vjp(fn, r_, a_, y_)
        return vjp((ct, jnp.zeros((12, n))))

    w_r, w_a, w_y = jax_vjp(jnp.asarray(radius), jnp.asarray(a), jnp.asarray(y), jnp.asarray(lam))
    assert _lane_err(_ks_hand(radius, a, y, lam), [w_y, w_r, w_a]) <= 1e-9


def test_bl_step_vjp_matches_jax():
    radius, a, e, l_z, q, y = _bl_lanes(seed=12)
    n = y.shape[1]
    lam = np.random.default_rng(10).normal(size=y.shape)

    @jax.jit
    def jax_vjp(args, ct):
        def fn(*v):
            return jadj._bl_step_with_payload(
                tuple(gp.DiscSpec(*d) for d in DISCS), BL_KW["h0"], BL_KW["h_min_frac"], BL_KW["r_ref_scale"],
                jnp.zeros(n, jnp.int32), *v, jnp.ones(n, bool),
            )

        _, vjp = jax.vjp(fn, *args)
        return vjp((ct, jnp.zeros((12, n))))

    w = jax_vjp(tuple(jnp.asarray(v) for v in (radius, a, e, l_z, q, y)), jnp.asarray(lam))
    assert _lane_err(_bl_hand(radius, a, e, l_z, q, y, lam), [w[5], *w[:5]]) <= 1e-9


def test_non_finite_state_and_trust_region():
    """A lane whose state is not finite, or whose step is inactive, passes
    λ through with zero partials; a lane whose λ leaves the trust region
    (LAM_CAP) is zeroed and drops its partials; the other lanes are the
    plain VJP's."""
    radius, a, y = _ks_lanes(n=8)
    lam = np.random.default_rng(13).normal(size=y.shape)
    y[5, 1] = np.nan
    lam[:, 2] *= 1e16 / np.abs(lam[:, 2]).max()
    active = torch.ones(8, dtype=torch.bool)
    active[3] = False
    lam_new, parts = tadj.ks_step_vjp(t(radius), t(a), t(y), t(lam), active=active, **KS_KW)
    ref = _ks_hand(radius[[0]], a[[0]], y[:, [0]], lam[:, [0]])
    for lane in (1, 3):
        np.testing.assert_array_equal(lam_new[:, lane].numpy(), lam[:, lane])
        assert all(float(p[lane]) == 0.0 for p in parts)
    assert not lam_new[:, 2].any() and all(float(p[2]) == 0.0 for p in parts)
    np.testing.assert_allclose(lam_new[:, 0].numpy(), ref[0][:, 0], rtol=1e-14, atol=0)

    radius, a, e, l_z, q, y = _bl_lanes(n=8)
    lam = np.random.default_rng(14).normal(size=y.shape)
    y[2, 1] = np.inf
    lam[:, 2] *= 1e16 / np.abs(lam[:, 2]).max()
    lam_new, parts = tadj.bl_step_vjp(*(t(v) for v in (radius, a, e, l_z, q, y, lam)), active=active, **BL_KW)
    for lane in (1, 3):
        np.testing.assert_array_equal(lam_new[:, lane].numpy(), lam[:, lane])
        assert all(float(p[lane]) == 0.0 for p in parts)
    assert not lam_new[:, 2].any() and all(float(p[2]) == 0.0 for p in parts)
    assert torch.isfinite(lam_new).all() and all(torch.isfinite(p).all() for p in parts)


def test_preparation_does_not_depend_on_the_batch():
    """initial_state, momentum and the cost-sort proxy of the same rays in
    one batch and in two halves: equal bit for bit (Kerr-Schild and
    Boyer-Lindquist)."""
    for toml, camera in ((KERR_TOML, KERR_CAMERA), (KERR_BL_TOML, BL_CAMERA)):
        size = 12
        opts = tcfg.RenderOptions(width=size, height=size, max_steps=100, **camera)
        scene = tcfg.create_scene(tcfg.load_config(toml), opts, F64, CPU)
        rr, cc = torch.meshgrid(torch.arange(size, dtype=F64), torch.arange(size, dtype=F64), indexing="ij")
        x, p = tcam.pixel_rays(scene.camera, rr.ravel(), cc.ravel())
        geometry = tfp._march_geometry_of(scene)

        def prepare(lo, hi):
            solver = geometry.make_solver(x[lo:hi], p[lo:hi])
            y0 = solver.initial_state(x[lo:hi], p[lo:hi])
            conserved = (solver.e, solver.l_z, solver.q) if hasattr(solver, "e") else ()
            return (y0, solver.momentum(y0), *conserved, *tfp._impact_proxy(geometry, x[lo:hi], p[lo:hi]))

        n = x.shape[0]
        whole = prepare(0, n)
        halves = [torch.cat(v) for v in zip(prepare(0, n // 2 + 5), prepare(n // 2 + 5, n))]
        for w, h in zip(whole, halves):
            assert torch.equal(w, h)
