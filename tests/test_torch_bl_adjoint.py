"""The port's reverse mode through the Boyer-Lindquist (Mino-time) march
against the JAX package's kernel VJP (make_bl_march_diff), float64 on the
CPU.

The probe is tests/test_adjoint.py's BL probe: kerr-bl.toml at 4×8, a
150-step nominal budget (300 Mino steps), the sky sphere at r = 30,
checkpoints every 32 steps, a weighted tone-mapped loss, and parameters
radius, a and dth (a shift of the ray origins' θ). The camera stays at the
base scene's. The JAX kernels run in interpret mode. The JAX side runs
once, in one module fixture: the gradient of the probe loss, from inside
which the kernel VJP's inputs, residuals (checkpoints included),
cotangents and results are taken for the march-level comparisons.

Bars: the step VJP to 1e-10 relative; checkpoint rows and the plain
backward to 1e-9 of each lane's scale (sums of the parameter partials to
1e-9 relative); the gradients of the probe loss to 1e-8 relative; a
central finite difference on the port alone to JAX's own bar, 5e-5.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_raytracer_tpu import config as jcfg
from gr_raytracer_tpu.geometry.kerr_bl import KerrBL as JKerrBL
from gr_raytracer_tpu.ops import geodesic_adjoint as jadj
from gr_raytracer_tpu.ops import geodesic_pallas as gp
from gr_raytracer_tpu.rendering import camera as jcam
from gr_raytracer_tpu.rendering import fast_path as jfp
from gr_raytracer_tpu_torch import config as tcfg
from gr_raytracer_tpu_torch.geometry.kerr_bl import KerrBL
from gr_raytracer_tpu_torch.ops import geodesic_adjoint as tadj
from gr_raytracer_tpu_torch.ops import geodesic_march as gm
from gr_raytracer_tpu_torch.rendering import camera as tcam
from gr_raytracer_tpu_torch.rendering import fast_path as tfp
from torch_port_scenes import (
    CPU, F64, KERR_BL_TOML, KERR_CAMERA, REPO, SCHWARZSCHILD_DISC_TOML, lane_relative_error,
    pixel_grid, t,
)

ROWS, COLS = 4, 8
MAX_STEPS = 150
MAX_RADIUS = 30.0
K_CKPT = 32
BASE = {"radius": 1.0, "a": 0.499, "dth": 0.0}
GRAD_KEYS = ("radius", "a", "dth")


def _opts(mod):
    return mod.RenderOptions(width=COLS, height=ROWS, max_steps=MAX_STEPS, max_radius=MAX_RADIUS, **KERR_CAMERA)


def _weights():
    return np.random.default_rng(7).uniform(0.5, 1.5, (ROWS * COLS, 3))


@pytest.fixture(scope="module")
def port():
    """The port's probe: base scene, march spec, camera rays, and the loss
    value, ray classes and gradients at the base parameters."""
    scene = tcfg.create_scene(tcfg.load_config(KERR_BL_TOML), _opts(tcfg), F64, CPU)
    spec = tfp.scene_kernel_spec(scene)
    x0, p0 = tcam.pixel_rays(scene.camera, *(t(a) for a in pixel_grid(ROWS, COLS)))

    def loss(params):
        geo = KerrBL(radius=params["radius"], a=params["a"], horizon_epsilon=scene.geometry.horizon_epsilon)
        x = torch.cat([x0[:, :2], (x0[:, 2] + params["dth"])[:, None], x0[:, 3:]], dim=1)
        s = tfp.trace_rays_fast_diff(dataclasses.replace(scene, geometry=geo), x, p0, spec=spec, k_ckpt=K_CKPT)
        c = s.color[..., :3]
        return torch.sum(t(_weights()) * (c / (1.0 + c))), s

    params = {k: torch.tensor(v, dtype=F64, requires_grad=True) for k, v in BASE.items()}
    value, samples = loss(params)
    grads = torch.autograd.grad(value, [params[k] for k in GRAD_KEYS])
    return {
        "spec": spec, "loss_fn": loss, "loss": float(value.detach()), "classes": samples.ray_class.numpy(),
        "grads": {k: float(g) for k, g in zip(GRAD_KEYS, grads)},
    }


@pytest.fixture(scope="module")
def ref(port):
    """Everything the tests need from the JAX package, computed once: the
    gradient of the probe loss, and on the way the kernel VJP's march
    inputs, residuals, cotangents and results, captured by a test-local
    wrapper around make_bl_march_diff."""
    spec = port["spec"]
    j_scene = jcfg.create_scene_host(jcfg.load_config(KERR_BL_TOML), _opts(jcfg), jnp.float64)
    jspec = jfp.KernelSpec(tuple(gp.DiscSpec(*d) for d in spec.discs), (), (), spec.r_safe, spec.opaque)
    captured = {}
    make = jadj.make_bl_march_diff

    def capturing_make(**kw):
        march = make(**kw)
        fwd, bwd = march.fwd, march.bwd

        def fwd_capture(*args):
            out = fwd(*args)
            jax.debug.callback(lambda *v: captured.update(fwd=[np.asarray(x) for x in v]), *args[4:8])
            return out

        def bwd_capture(residuals, cts):
            grads = bwd(residuals, cts)
            jax.debug.callback(
                lambda *v: captured.update(bwd=[np.asarray(x) for x in v]),
                *residuals, cts[0], cts[1], *grads,
            )
            return grads

        march.defvjp(fwd_capture, bwd_capture)
        return march

    rr, cc = pixel_grid(ROWS, COLS)
    x0, p0 = jcam.pixel_rays(j_scene.camera, jnp.asarray(rr), jnp.asarray(cc))
    w = jnp.asarray(_weights())

    def loss(params):
        geo = JKerrBL(radius=params["radius"], a=params["a"], horizon_epsilon=j_scene.geometry.horizon_epsilon)
        x = x0.at[:, 2].add(params["dth"])
        s = jfp.trace_rays_fast_diff(j_scene.replace(geometry=geo), x, p0, interpret=True, spec=jspec, k_ckpt=K_CKPT)
        c = s.color[..., :3]
        return jnp.sum(w * (c / (1.0 + c)))

    base = {k: jnp.asarray(v, jnp.float64) for k, v in BASE.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jadj, "make_bl_march_diff", capturing_make)
        value, grads = jax.jit(jax.value_and_grad(loss))(base)
        jax.effects_barrier()
    e, l_z, q, y0 = captured["fwd"]
    (radius, a, _, _, _, ckpt, stop, steps, ev_kind, ev_count, ct_y, ct_ev,
     d_radius, d_a, _, _, d_e, d_lz, d_q, d_y0) = captured["bwd"]
    assert (float(radius), float(a)) == (spec.radius, spec.a)
    assert not ct_ev[:, 1:].any()  # only slot 0 is shaded
    # The lanes are the probe's rays, cost-sorted and padded with copies of
    # ray 0 to the kernel's tile; keep each distinct ray and every lane with
    # a cotangent (a lane without one gets exact zeros on both sides).
    first = np.unique(y0, axis=0, return_index=True)[1]
    lanes = np.union1d(first, np.nonzero(ct_y.any(axis=1) | ct_ev[:, 0].any(axis=1))[0])
    assert len(first) == ROWS * COLS
    return {
        "y0": y0[lanes], "consts": (e[lanes], l_z[lanes], q[lanes]),
        "march": (stop[lanes], steps[lanes], ev_kind[lanes], ev_count[lanes], ckpt[:, :, lanes]),
        "ct": (ct_y[lanes], ct_ev[lanes, 0]),
        "bwd": (d_y0[lanes], d_e[lanes], d_lz[lanes], d_q[lanes], float(d_radius), float(d_a)),
        "loss": float(value), "grads": {k: float(grads[k]) for k in GRAD_KEYS},
    }


def test_bl_step_vjp_matches_jax():
    """The BL step map with its slot-0 payload (two discs), by torch
    autograd against jax.vjp of the JAX step, over states near the
    equator so that many steps cross it."""
    rng = np.random.default_rng(5)
    n = 64
    y = np.stack([rng.normal(size=n), rng.uniform(3.0, 25.0, n), math.pi / 2 + rng.uniform(-0.05, 0.05, n),
                  rng.uniform(-3.0, 3.0, n), rng.normal(size=n) * 20.0, rng.normal(size=n) * 3.0,
                  np.zeros(n), np.zeros(n)])
    e, l_z, q = rng.uniform(0.5, 1.5, n), rng.normal(size=n) * 3.0, rng.uniform(0.0, 20.0, n)
    ct_y, ct_p = rng.normal(size=(8, n)), rng.normal(size=(12, n))
    kind0 = rng.integers(0, 2, n).astype(np.int32)
    active = rng.uniform(size=n) < 0.8
    discs = ((1.2, 6.0, 0), (6.5, 12.0, 1))
    step_kw = dict(h0=0.01, h_min_frac=0.02, r_ref_scale=10.0)
    radius, a = 1.0, 0.45

    def jax_fn(r_, a_, e_, lz_, q_, y_):
        return jadj._bl_step_with_payload(
            tuple(gp.DiscSpec(*d) for d in discs), step_kw["h0"], step_kw["h_min_frac"],
            step_kw["r_ref_scale"], jnp.asarray(kind0), r_, a_, e_, lz_, q_, y_, jnp.asarray(active),
        )

    @jax.jit
    def jax_vjp(*args):
        out, vjp = jax.vjp(jax_fn, *args[:6])
        return out, vjp(args[6])

    inputs = (np.full(n, radius), np.full(n, a), e, l_z, q, y)
    (y_ref, p_ref), want = jax_vjp(*(jnp.asarray(v) for v in inputs), (jnp.asarray(ct_y), jnp.asarray(ct_p)))
    leaves = [t(v).requires_grad_(True) for v in inputs]
    y_new, payload = tadj._bl_step_with_payload(
        tuple(gm.DiscSpec(*d) for d in discs), ev_kind0=t(kind0), radius=leaves[0], a=leaves[1],
        e=leaves[2], l_z=leaves[3], q=leaves[4], y=leaves[5], active=t(active), **step_kw,
    )
    np.testing.assert_allclose(y_new.detach().numpy(), np.asarray(y_ref), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(payload.detach().numpy(), np.asarray(p_ref), rtol=1e-9, atol=1e-10)
    got = torch.autograd.grad((y_new, payload), leaves, (t(ct_y), t(ct_p)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-10 * np.abs(w).max()


def test_bl_checkpoint_rows_match_jax(port, ref):
    spec = port["spec"]
    got = gm.march_bl_plain(
        spec.radius, spec.a, spec.horizon_epsilon, t(ref["y0"]), *(t(v) for v in ref["consts"]), h0=0.01,
        max_steps=2 * MAX_STEPS, max_radius=MAX_RADIUS, discs=spec.discs, opaque_stop=True, ckpt_every=K_CKPT,
    )
    stop, steps, ev_kind, ev_count, ckpt = ref["march"]
    np.testing.assert_array_equal(got[1].numpy(), stop)
    np.testing.assert_array_equal(got[2].numpy(), steps)
    np.testing.assert_array_equal(got[5].numpy(), ev_count)
    assert got[7].shape == ckpt.shape == (-(-2 * MAX_STEPS // K_CKPT), 8, len(ref["y0"]))
    reached = np.arange(ckpt.shape[0])[:, None] * K_CKPT < steps[None]
    assert reached[1:].any()  # some lane reaches a second segment
    rows = lambda c: c.transpose(2, 0, 1)[reached.T]
    assert lane_relative_error(rows(ckpt), rows(got[7].numpy())) <= 1e-9


def test_bl_plain_backward_matches_jax_march_bwd(port, ref):
    stop, steps, ev_kind, ev_count, ckpt = ref["march"]
    ct_y, ct_ev = ref["ct"]
    spec = port["spec"]
    grad_ok, has_ev, kind0 = tadj.sweep_lanes(t(stop), t(ev_kind), t(ev_count))
    cfg = tadj.SweepConfig(0.01, 2 * MAX_STEPS, spec.discs, 0.0, 0.02, 10.0, K_CKPT)
    got = tadj.bl_march_bwd(
        t(ckpt), t(ct_y), t(ct_ev), t(steps), grad_ok, has_ev, kind0, spec.radius, spec.a,
        *(t(v) for v in ref["consts"]), cfg,
    )
    want_y0, want_e, want_lz, want_q, want_r, want_a = ref["bwd"]
    # The loss reaches the march through the disc hits and the sky (the
    # kerr-bl sky is a beamed bitmap, so escaped lanes carry a cotangent).
    assert (ct_ev.any(axis=1) & (ev_count > 0)).any() and ct_y[stop == 2].any()
    assert np.abs(want_y0).max() > 0 and np.abs(want_e).max() > 0
    assert lane_relative_error(want_y0, got[0].numpy()) <= 1e-9
    lane_partials = np.stack([want_e, want_lz, want_q], axis=1)
    assert lane_relative_error(lane_partials, torch.stack(got[1:4], dim=1).numpy()) <= 1e-9
    assert abs(float(got[4].sum()) - want_r) <= 1e-9 * abs(want_r)
    assert abs(float(got[5].sum()) - want_a) <= 1e-9 * abs(want_a)


def test_bl_probe_gradients_match_jax(port, ref):
    """The whole slice: the conserved scalars, march, reverse sweep,
    shading and fold, back to radius, a and the ray origins."""
    assert (port["classes"] == 0).any() and (port["classes"] == 2).any()  # sky and disc
    assert abs(port["loss"] - ref["loss"]) <= 1e-10 * abs(ref["loss"])
    for k in GRAD_KEYS:
        want, got = ref["grads"][k], port["grads"][k]
        assert abs(got - want) <= 1e-8 * abs(want), (k, got, want)


def test_bl_spin_gradient_matches_finite_difference(port):
    """Central finite difference of the port's own probe loss (JAX's bar)."""
    eps = 1e-6
    base = {k: torch.tensor(v, dtype=F64) for k, v in BASE.items()}
    with torch.no_grad():
        shifted = lambda s: float(port["loss_fn"](dict(base, a=base["a"] + s))[0])
        fd = (shifted(eps) - shifted(-eps)) / (2 * eps)
    g = port["grads"]["a"]
    assert np.isfinite(g) and np.isfinite(fd)
    assert abs(g - fd) / max(abs(fd), 1e-12) < 5e-5


def test_bl_diff_scope():
    """KerrBL and Schwarzschild disc scenes take the Mino-time reverse
    sweep; a march without discs is refused."""
    cfg = tcfg.parse_config(SCHWARZSCHILD_DISC_TOML, REPO)
    scene = tcfg.create_scene(cfg, tcfg.RenderOptions(width=4, height=4), F64, CPU)
    assert tfp.supports_diff(scene) and tfp.scene_kernel_spec(scene).mino
    with pytest.raises(ValueError):
        tadj.make_bl_march_diff(h0=0.01, max_steps=10, discs=())


@pytest.mark.cuda
def test_cuda_bl_reverse_sweep_matches_plain(port, ref):
    """Runs only on a machine with a card (chip_smoke.py does the same at
    the fit frame's size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    stop, steps, ev_kind, ev_count, ckpt = ref["march"]
    ct_y, ct_ev = ref["ct"]
    spec = port["spec"]
    cfg = tadj.SweepConfig(0.01, 2 * MAX_STEPS, spec.discs, 0.0, 0.02, 10.0, K_CKPT)
    lanes = [v.cuda() for v in tadj.sweep_lanes(t(stop), t(ev_kind), t(ev_count))]
    args = (t(ckpt).cuda(), t(ct_y).cuda(), t(ct_ev).cuda(), t(steps).cuda(), *lanes, spec.radius, spec.a,
            *(t(v).cuda() for v in ref["consts"]), cfg)
    before = tadj.bl_launches
    got = tadj.bl_march_bwd(*args)
    want = tadj.bl_march_bwd_plain(*args)
    assert tadj.bl_launches == before + 1
    assert lane_relative_error(want[0].cpu().numpy(), got[0].cpu().numpy()) <= 1e-9
    for g, w in zip(got[1:], want[1:]):
        assert abs(float(g.sum()) - float(w.sum())) <= 1e-9 * abs(float(w.sum()))
