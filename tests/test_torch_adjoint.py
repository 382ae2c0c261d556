"""The port's reverse mode through the march against the JAX package's
kernel VJP (gr_raytracer_tpu/ops/geodesic_adjoint.py), float64 on the CPU.

The probe is tests/test_adjoint.py's: the 4×8 flagship frame, a 200-step
budget, checkpoints every 32 steps, and a weighted tone-mapped loss. The
JAX kernels run in interpret mode. The JAX side runs once, in one module
fixture: the gradient of the probe loss, from inside which the kernel
VJP's residuals (checkpoints included), cotangents and results are taken
for the march-level comparisons.

Bars: the step VJP to 1e-10 relative; checkpoint rows and the plain
backward to 1e-9 of each lane's scale (sums of the partials to 1e-9
relative); the gradients of the probe loss to 1e-8 relative; a central
finite difference on the port alone to JAX's own bar, 5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_raytracer_tpu import presets as jpresets
from gr_raytracer_tpu.ops import geodesic_adjoint as jadj
from gr_raytracer_tpu.ops import geodesic_pallas as gp
from gr_raytracer_tpu.rendering import camera as jcam
from gr_raytracer_tpu.rendering import fast_path as jfp
from gr_raytracer_tpu_torch import presets as tpresets
from gr_raytracer_tpu_torch.ops import geodesic_adjoint as tadj
from gr_raytracer_tpu_torch.ops import geodesic_march as gm
from gr_raytracer_tpu_torch.rendering import camera as tcam
from gr_raytracer_tpu_torch.rendering import fast_path as tfp
from torch_port_scenes import CPU, F64, jax_flagship_params, lane_relative_error, pixel_grid, t

ROWS, COLS = 4, 8
MAX_STEPS = 200
K_CKPT = 32
GRAD_KEYS = ("a", "radius", "camera_position", "camera_theta", "disc_temperature")


def _jax_build(params):
    return jpresets.build_kerr_flagship(params, ROWS, COLS, max_steps=MAX_STEPS, max_radius=40.0, step_size=0.05)


def _port_build(params):
    return tpresets.build_kerr_flagship(params, ROWS, COLS, max_steps=MAX_STEPS, max_radius=40.0, step_size=0.05)


def _weights():
    return np.random.default_rng(3).uniform(0.5, 1.5, (ROWS * COLS, 3))


def _port_loss(params, spec):
    scene = _port_build(params)
    rr, cc = pixel_grid(ROWS, COLS)
    x, p = tcam.pixel_rays(scene.camera, t(rr), t(cc))
    s = tfp.trace_rays_fast_diff(scene, x, p, spec=spec, k_ckpt=K_CKPT)
    c = s.color[..., :3]
    return torch.sum(t(_weights()) * (c / (1.0 + c))), s


@pytest.fixture(scope="module")
def ref():
    """Everything the tests need from the JAX package, computed once: the
    gradient of the probe loss, and on the way the kernel VJP's march input,
    residuals, cotangents and results, captured by a test-local wrapper
    around make_ks_march_diff. The march configuration comes from the
    port's scene (the same numbers)."""
    spec = tfp.scene_kernel_spec(_port_build(tpresets.params_from_numpy(jax_flagship_params(), F64, CPU)))
    jspec = jfp.KernelSpec(tuple(gp.DiscSpec(*d) for d in spec.discs), (), (), spec.r_safe, spec.opaque)
    captured = {}
    make = jadj.make_ks_march_diff

    def capturing_make(**kw):
        march = make(**kw)
        fwd, bwd = march.fwd, march.bwd

        def fwd_capture(*args):
            out = fwd(*args)
            jax.debug.callback(lambda y0: captured.update(y0=np.asarray(y0)), args[4])
            return out

        def bwd_capture(residuals, cts):
            grads = bwd(residuals, cts)
            jax.debug.callback(
                lambda *v: captured.update(bwd=[np.asarray(x) for x in v]),
                *residuals, cts[0], cts[1], grads[0], grads[1], grads[4],
            )
            return grads

        march.defvjp(fwd_capture, bwd_capture)
        return march

    rr, cc = pixel_grid(ROWS, COLS)
    w = jnp.asarray(_weights())

    def loss(params):
        sc = _jax_build(params)
        xx, pp = jcam.pixel_rays(sc.camera, jnp.asarray(rr), jnp.asarray(cc))
        s = jfp.trace_rays_fast_diff(sc, xx, pp, interpret=True, spec=jspec, k_ckpt=K_CKPT)
        c = s.color[..., :3]
        return jnp.sum(w * (c / (1.0 + c)))

    base = {k: jnp.asarray(v) for k, v in jax_flagship_params().items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jadj, "make_ks_march_diff", capturing_make)
        value, grads = jax.jit(jax.value_and_grad(loss))(base)
        jax.effects_barrier()
    radius, a, ckpt, stop, steps, ev_kind, ev_count, ct_y, ct_ev, d_radius, d_a, d_y0 = captured["bwd"]
    assert (float(radius), float(a)) == (spec.radius, spec.a)
    assert not ct_ev[:, 1:].any()  # only slot 0 is shaded
    # The lanes are the probe's rays, cost-sorted and padded with copies of
    # ray 0 to the kernel's tile; keep each distinct ray and every lane with
    # a cotangent (a lane without one gets exact zeros on both sides).
    y0 = captured["y0"]
    first = np.unique(y0, axis=0, return_index=True)[1]
    lanes = np.union1d(first, np.nonzero(ct_y.any(axis=1) | ct_ev[:, 0].any(axis=1))[0])
    assert len(first) == ROWS * COLS
    return {
        "spec": spec, "y0": y0[lanes],
        "march": (stop[lanes], steps[lanes], ev_kind[lanes], ev_count[lanes], ckpt[:, :, lanes]),
        "ct": (ct_y[lanes], ct_ev[lanes, 0]), "bwd": (d_y0[lanes], float(d_radius), float(d_a)),
        "loss": float(value), "grads": {k: np.asarray(grads[k]) for k in GRAD_KEYS},
    }


def test_step_vjp_matches_jax():
    """The step map with its slot-0 payload (two discs, mixed activity),
    by torch autograd against jax.vjp of the JAX step."""
    rng = np.random.default_rng(5)
    n = 64
    pos = rng.normal(size=(3, n))
    pos *= rng.uniform(3.0, 20.0, n) / np.linalg.norm(pos, axis=0)
    pos[2] = rng.uniform(-0.3, 0.3, n)  # near the disc plane: many steps cross it
    y = np.concatenate([rng.normal(size=(1, n)), pos, -np.ones((1, n)), rng.normal(size=(3, n))])
    ct_y, ct_p = rng.normal(size=(8, n)), rng.normal(size=(12, n))
    kind0 = rng.integers(0, 2, n).astype(np.int32)
    active = rng.uniform(size=n) < 0.8
    discs = ((1.2, 6.0, 0), (6.5, 12.0, 1))
    step_kw = dict(h0=1.0, h_min_frac=0.01, r_ref_scale=10.0, r_safe=30.0)
    radius, a = 1.0, 0.45

    def jax_fn(r_, a_, y_):
        return jadj._step_with_payload(
            tuple(gp.DiscSpec(*d) for d in discs), (), step_kw["h0"], step_kw["h_min_frac"],
            step_kw["r_ref_scale"], step_kw["r_safe"], jnp.asarray(kind0), jnp.zeros(n, bool), r_, a_, y_,
            jnp.asarray(active),
        )

    @jax.jit
    def jax_vjp(r_, a_, y_, cts):
        out, vjp = jax.vjp(jax_fn, r_, a_, y_)
        return out, vjp(cts)

    (y_ref, p_ref), want = jax_vjp(jnp.full(n, radius), jnp.full(n, a), jnp.asarray(y),
                                   (jnp.asarray(ct_y), jnp.asarray(ct_p)))
    want = [np.asarray(v) for v in want]

    r_t = torch.full((n,), radius, dtype=F64, requires_grad=True)
    a_t = torch.full((n,), a, dtype=F64, requires_grad=True)
    y_t = t(y).requires_grad_(True)
    y_new, payload = tadj._step_with_payload(
        tuple(gm.DiscSpec(*d) for d in discs), (), ev_kind0=t(kind0), radius=r_t, a=a_t, y=y_t,
        active=t(active), **step_kw,
    )
    np.testing.assert_allclose(y_new.detach().numpy(), np.asarray(y_ref), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(payload.detach().numpy(), np.asarray(p_ref), rtol=1e-9, atol=1e-10)
    got = torch.autograd.grad((y_new, payload), (r_t, a_t, y_t), (t(ct_y), t(ct_p)))
    for g, w in zip(got, want):
        scale = np.abs(w).max()
        assert np.abs(g.numpy() - w).max() <= 1e-10 * scale
    # A scene of spheres alone takes the sphere payload on every lane: the
    # rows of the mixed scene's sphere lanes (tests/test_torch_sphere_adjoint.py
    # holds the sphere payload against JAX's).
    sphere = (gm.SphereSpec(3.0, 0.0, 0.0, 0.0, 2),)
    kind2 = torch.full((n,), 2, dtype=torch.int32)
    mixed = tadj._step_with_payload(tuple(gm.DiscSpec(*d) for d in discs), sphere, ev_kind0=kind2, radius=r_t,
                                    a=a_t, y=y_t, active=t(active), **step_kw)[1]
    alone = tadj._step_with_payload((), sphere, ev_kind0=kind2, radius=r_t, a=a_t, y=y_t, active=t(active),
                                    **step_kw)[1]
    assert torch.equal(mixed, alone) and not torch.equal(alone, payload)


def test_checkpoint_rows_match_jax(ref):
    spec = ref["spec"]
    got = gm.march_plain(
        spec.radius, spec.a, spec.horizon_epsilon, t(ref["y0"]), h0=1.0, max_steps=MAX_STEPS,
        max_radius=40.0, discs=spec.discs, r_safe=spec.r_safe, opaque_stop=True, ckpt_every=K_CKPT,
    )
    stop, steps, ev_kind, ev_count, ckpt = ref["march"]
    np.testing.assert_array_equal(got[1].numpy(), stop)
    np.testing.assert_array_equal(got[2].numpy(), steps)
    assert got[7].shape == ckpt.shape == (-(-MAX_STEPS // K_CKPT), 8, len(ref["y0"]))
    reached = np.arange(ckpt.shape[0])[:, None] * K_CKPT < steps[None]
    assert reached[1:].any()  # some lane reaches a second segment
    rows_ref = ckpt.transpose(2, 0, 1)[reached.T]  # [rows, 8]
    rows_got = got[7].numpy().transpose(2, 0, 1)[reached.T]
    assert lane_relative_error(rows_ref, rows_got) <= 1e-9


def test_plain_backward_matches_jax_march_bwd(ref):
    stop, steps, ev_kind, ev_count, ckpt = ref["march"]
    ct_y, ct_ev = ref["ct"]
    spec = ref["spec"]
    grad_ok, has_ev, kind0 = tadj.sweep_lanes(t(stop), t(ev_kind), t(ev_count))
    cfg = tadj.SweepConfig(1.0, MAX_STEPS, spec.discs, spec.r_safe, 0.01, 10.0, K_CKPT)
    d_y0, d_r, d_a = tadj.ks_march_bwd(
        t(ckpt), t(ct_y), t(ct_ev), t(steps), grad_ok, has_ev, kind0, spec.radius, spec.a, cfg,
    )
    want_y0, want_r, want_a = ref["bwd"]
    # The loss reaches the march through the disc hits (the probe's sky has
    # no beaming, so escaped lanes carry no cotangent; the step VJP test
    # holds the final-state route with seeded cotangents).
    assert (ct_ev.any(axis=1) & (ev_count > 0)).any() and (stop == 2).any()
    assert np.abs(want_y0).max() > 0
    assert lane_relative_error(want_y0, d_y0.numpy()) <= 1e-9
    assert abs(float(d_r.sum()) - want_r) <= 1e-9 * abs(want_r)
    assert abs(float(d_a.sum()) - want_a) <= 1e-9 * abs(want_a)


@pytest.fixture(scope="module")
def port():
    """The port's probe: parameters, march spec, loss value, ray classes
    and gradients, computed once."""
    params = tpresets.params_from_numpy(jax_flagship_params(), F64, CPU)
    for v in params.values():
        v.requires_grad_(True)
    spec = tfp.scene_kernel_spec(_port_build(params))
    loss, samples = _port_loss(params, spec)
    grads = torch.autograd.grad(loss, [params[k] for k in GRAD_KEYS])
    return {
        "params": params, "spec": spec, "loss": float(loss.detach()),
        "classes": samples.ray_class.numpy(), "grads": {k: g.numpy() for k, g in zip(GRAD_KEYS, grads)},
    }


def test_probe_gradients_match_jax(ref, port):
    """The whole slice: camera, march, reverse sweep, shading and fold."""
    assert (port["classes"] == 0).any() and (port["classes"] == 2).any()  # sky and disc
    assert abs(port["loss"] - ref["loss"]) <= 1e-10 * abs(ref["loss"])
    for k in GRAD_KEYS:
        want, got = ref["grads"][k], port["grads"][k]
        if k == "camera_position":
            want, got = want[3], got[3]
        assert abs(float(got) - float(want)) <= 1e-8 * abs(float(want)), (k, got, want)


def test_spin_gradient_matches_finite_difference(port):
    """Central finite difference of the port's own probe loss (JAX's bar)."""
    eps = 1e-6
    params = {k: v.detach() for k, v in port["params"].items()}
    with torch.no_grad():
        shifted = lambda s: float(_port_loss(dict(params, a=params["a"] + s), port["spec"])[0])
        fd = (shifted(eps) - shifted(-eps)) / (2 * eps)
    g = float(port["grads"]["a"])
    assert np.isfinite(g) and np.isfinite(fd)
    assert abs(g - fd) / max(abs(fd), 1e-12) < 5e-5


def test_unported_scenes_are_refused():
    """The differentiable Kerr-Schild march takes discs, spheres or both; it
    refuses a sphere that is not a SphereSpec and a scene with neither."""
    scene = _port_build(tpresets.params_from_numpy(jax_flagship_params(), F64, CPU))
    assert tfp.supports_diff(scene)
    sphere = gm.SphereSpec(3.0, 0.0, 0.0, 0.0, 1)
    for discs, spheres in (((gm.DiscSpec(1.0, 6.0, 0),), (sphere,)), ((), (sphere,))):
        assert callable(tadj.make_ks_march_diff(h0=1.0, max_steps=10, discs=discs, spheres=spheres, r_safe=30.0))
    with pytest.raises(TypeError):
        tadj.make_ks_march_diff(h0=1.0, max_steps=10, discs=(gm.DiscSpec(1.0, 6.0, 0),), spheres=(object(),), r_safe=30.0)
    with pytest.raises(ValueError):
        tadj.make_ks_march_diff(h0=1.0, max_steps=10, discs=(), r_safe=30.0)


@pytest.mark.cuda
def test_cuda_reverse_sweep_matches_plain(ref):
    """Runs only on a machine with a card (chip_smoke.py does the same at
    the fit frame's size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    stop, steps, ev_kind, ev_count, ckpt = ref["march"]
    ct_y, ct_ev = ref["ct"]
    spec = ref["spec"]
    cfg = tadj.SweepConfig(1.0, MAX_STEPS, spec.discs, spec.r_safe, 0.01, 10.0, K_CKPT)
    lanes = [v.cuda() for v in tadj.sweep_lanes(t(stop), t(ev_kind), t(ev_count))]
    args = (t(ckpt).cuda(), t(ct_y).cuda(), t(ct_ev).cuda(), t(steps).cuda(), *lanes, spec.radius, spec.a, cfg)
    before = tadj.launches
    got = tadj.ks_march_bwd(*args)
    want = tadj.ks_march_bwd_plain(*args)
    assert tadj.launches == before + 1
    assert lane_relative_error(want[0].cpu().numpy(), got[0].cpu().numpy()) <= 1e-9
    for g, w in zip(got[1:], want[1:]):
        assert abs(float(g.sum()) - float(w.sum())) <= 1e-9 * abs(float(w.sum()))
