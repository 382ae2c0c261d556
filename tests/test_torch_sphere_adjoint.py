"""The port's reverse mode through a Kerr-Schild scene with a disc and a
sphere against the JAX package's kernel VJP (gr_raytracer_tpu/ops/
geodesic_adjoint.py, the sphere route of tests/test_adjoint.py), float64
on the CPU.

The probe is tests/test_adjoint.py's `sphere_loss_fn`: kerr-sphere.toml
(bitmap disc 3–5, bitmap sphere R = 3 at the origin) around a Kerr hole of
r_s = 1, a = 0.499, a 4×8 frame from (−10, 0, −2.5), 400 steps,
checkpoints every 32 steps, and a tone-mapped loss weighted from seed 11,
differentiated in the radius, the spin and a shift `dth` of the camera
rays' y. Slot 0 of its rays holds both kinds, so the per-lane choice of
the sphere or the disc payload is exercised. The JAX kernels run in
interpret mode, once, in one module fixture, which also captures the
kernel VJP's residuals, cotangents and results.

Bars: the step VJP and the checkpoint rows and the plain backward to 1e-9
(of each lane's scale; sums of the partials relative); the probe's
gradients to 1e-8 relative; a central finite difference on the port alone
to JAX's bitmap bar, 5e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_raytracer_tpu.geometry.kerr import Kerr as JKerr
from gr_raytracer_tpu.ops import geodesic_adjoint as jadj
from gr_raytracer_tpu.ops import geodesic_pallas as gp
from gr_raytracer_tpu.rendering import camera as jcam
from gr_raytracer_tpu.rendering import fast_path as jfp
from gr_raytracer_tpu_torch.geometry.kerr import Kerr
from gr_raytracer_tpu_torch.ops import geodesic_adjoint as tadj
from gr_raytracer_tpu_torch.ops import geodesic_march as gm
from gr_raytracer_tpu_torch.rendering import camera as tcam
from gr_raytracer_tpu_torch.rendering import fast_path as tfp
from torch_port_scenes import (
    F64, SPHERE_PROBE_HOLE, SPHERE_PROBE_OPTIONS, lane_relative_error, pixel_grid, sphere_probe_scenes, t,
)

ROWS, COLS = SPHERE_PROBE_OPTIONS["height"], SPHERE_PROBE_OPTIONS["width"]
MAX_STEPS = SPHERE_PROBE_OPTIONS["max_steps"]
MAX_RADIUS = SPHERE_PROBE_OPTIONS["max_radius"]
K_CKPT = 32
GRAD_KEYS = ("a", "radius", "dth")
BASE = {"radius": SPHERE_PROBE_HOLE[0], "a": SPHERE_PROBE_HOLE[1], "dth": 0.0}


def _weights():
    return np.random.default_rng(11).uniform(0.5, 1.5, (ROWS * COLS, 3))


def _port_rays(scene):
    rr, cc = pixel_grid(ROWS, COLS)
    return tcam.pixel_rays(scene.camera, t(rr), t(cc))


def _port_loss(scene, spec, x0, p0, params):
    geometry = Kerr(radius=params["radius"], a=params["a"], horizon_epsilon=scene.geometry.horizon_epsilon)
    x = torch.cat([x0[:, :2], (x0[:, 2] + params["dth"])[:, None], x0[:, 3:]], dim=1)
    s = tfp.trace_rays_fast_diff(dataclasses.replace(scene, geometry=geometry), x, p0, spec=spec, k_ckpt=K_CKPT)
    c = s.color[..., :3]
    return torch.sum(t(_weights()) * (c / (1.0 + c))), s


def _sweep_config(spec):
    return tadj.SweepConfig(1.0, MAX_STEPS, spec.discs, spec.r_safe, 0.01, 10.0, K_CKPT, spec.spheres)


@pytest.fixture(scope="module")
def ref():
    """Everything the tests need from the JAX package, computed once: the
    probe's loss and gradient, and on the way the kernel VJP's march input,
    residuals, cotangents and results, captured by a test-local wrapper
    around make_ks_march_diff."""
    j_scene, t_scene = sphere_probe_scenes()
    assert jfp.supports_diff(j_scene) and tfp.supports_diff(t_scene)
    j_spec, spec = jfp.scene_kernel_spec(j_scene), tfp.scene_kernel_spec(t_scene)
    assert j_spec.discs == spec.discs and j_spec.spheres == spec.spheres and j_spec.r_safe == spec.r_safe
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
    x0, p0 = jcam.pixel_rays(j_scene.camera, jnp.asarray(rr), jnp.asarray(cc))
    w = jnp.asarray(_weights())

    def loss(params):
        geometry = JKerr(radius=params["radius"], a=params["a"], horizon_epsilon=j_scene.geometry.horizon_epsilon)
        x = x0.at[:, 2].add(params["dth"])
        s = jfp.trace_rays_fast_diff(j_scene.replace(geometry=geometry), x, p0, interpret=True, spec=j_spec,
                                     k_ckpt=K_CKPT)
        c = s.color[..., :3]
        return jnp.sum(w * (c / (1.0 + c)))

    base = {k: jnp.asarray(v, jnp.float64) for k, v in BASE.items()}
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
        "spec": spec, "scene": t_scene, "y0": y0[lanes],
        "march": (stop[lanes], steps[lanes], ev_kind[lanes], ev_count[lanes], ckpt[:, :, lanes]),
        "ct": (ct_y[lanes], ct_ev[lanes, 0]), "bwd": (d_y0[lanes], float(d_radius), float(d_a)),
        "loss": float(value), "grads": {k: float(grads[k]) for k in GRAD_KEYS},
    }


@pytest.fixture(scope="module")
def port(ref):
    """The port's probe: its loss, ray classes and gradients, computed once."""
    scene, spec = ref["scene"], ref["spec"]
    params = {k: torch.tensor(v, dtype=F64, requires_grad=True) for k, v in BASE.items()}
    x0, p0 = _port_rays(scene)
    loss, samples = _port_loss(scene, spec, x0, p0, params)
    grads = torch.autograd.grad(loss, [params[k] for k in GRAD_KEYS])
    return {
        "rays": (x0, p0), "loss": float(loss.detach()), "classes": samples.ray_class.numpy(),
        "grads": {k: float(g) for k, g in zip(GRAD_KEYS, grads)},
    }


def test_sphere_step_vjp_matches_jax():
    """The step map with its slot-0 payload (a disc and two spheres, lanes
    of each kind, mixed activity), by torch autograd against jax.vjp of the
    JAX step. The last lane is frozen at the sweep's benign state (0, 10,
    0, 0 | −1, 0, 1, 0), where the sphere at the origin sees cos θ = 0: its
    λ stays finite (the payload's θ = π/2 − atan(cos/sin), not atan2)."""
    rng = np.random.default_rng(5)
    n = 96
    # Positions just outside or inside the spheres, stepping across them.
    pos = rng.normal(size=(3, n))
    pos *= rng.uniform(2.6, 3.6, n) / np.linalg.norm(pos, axis=0)
    mom = -pos / np.linalg.norm(pos, axis=0) + 0.3 * rng.normal(size=(3, n))
    y = np.concatenate([rng.normal(size=(1, n)), pos, -np.ones((1, n)), mom])
    y[:, -1] = (0.0, 10.0, 0.0, 0.0, -1.0, 0.0, 1.0, 0.0)
    ct_y, ct_p = rng.normal(size=(8, n)), rng.normal(size=(12, n))
    kind0 = rng.integers(0, 3, n).astype(np.int32)
    kind0[-1] = 1
    active = rng.uniform(size=n) < 0.8
    active[-1] = False
    discs = ((3.0, 5.0, 0),)
    spheres = ((3.0, 0.0, 0.0, 0.0, 1), (1.5, 0.4, -0.3, 0.2, 2))
    step_kw = dict(h0=1.0, h_min_frac=0.01, r_ref_scale=10.0, r_safe=10.0)
    radius, a = 1.0, 0.499
    is_sphere = (kind0 == 1) | (kind0 == 2)

    def jax_fn(r_, a_, y_):
        return jadj._step_with_payload(
            tuple(gp.DiscSpec(*d) for d in discs), tuple(gp.SphereSpec(*s) for s in spheres), step_kw["h0"],
            step_kw["h_min_frac"], step_kw["r_ref_scale"], step_kw["r_safe"], jnp.asarray(kind0),
            jnp.asarray(is_sphere), r_, a_, y_, jnp.asarray(active),
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
        tuple(gm.DiscSpec(*d) for d in discs), tuple(gm.SphereSpec(*s) for s in spheres), ev_kind0=t(kind0),
        radius=r_t, a=a_t, y=y_t, active=t(active), **step_kw,
    )
    np.testing.assert_allclose(y_new.detach().numpy(), np.asarray(y_ref), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(payload.detach().numpy(), np.asarray(p_ref), rtol=1e-9, atol=1e-10)
    got = torch.autograd.grad((y_new, payload), (r_t, a_t, y_t), (t(ct_y), t(ct_p)))
    assert np.isfinite(got[2][:, -1].numpy()).all() and np.isfinite(want[2][:, -1]).all()
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - w).max() <= 1e-9 * np.abs(w).max()
    # Active lanes of both kinds are held.
    assert is_sphere[active].any() and (~is_sphere[active]).any()


def test_checkpoint_rows_with_sphere_events_match_jax(ref):
    spec = ref["spec"]
    got = gm.march_plain(
        spec.radius, spec.a, spec.horizon_epsilon, t(ref["y0"]), h0=1.0, max_steps=MAX_STEPS,
        max_radius=MAX_RADIUS, discs=spec.discs, spheres=spec.spheres, r_safe=spec.r_safe, opaque_stop=True,
        ckpt_every=K_CKPT,
    )
    stop, steps, ev_kind, ev_count, ckpt = ref["march"]
    np.testing.assert_array_equal(got[1].numpy(), stop)
    np.testing.assert_array_equal(got[2].numpy(), steps)
    np.testing.assert_array_equal(got[3].numpy(), ev_kind)
    assert got[7].shape == ckpt.shape == (-(-MAX_STEPS // K_CKPT), 8, len(ref["y0"]))
    reached = np.arange(ckpt.shape[0])[:, None] * K_CKPT < steps[None]
    assert reached[1:].any()  # some lane reaches a second segment
    rows_ref = ckpt.transpose(2, 0, 1)[reached.T]  # [rows, 8]
    rows_got = got[7].numpy().transpose(2, 0, 1)[reached.T]
    assert lane_relative_error(rows_ref, rows_got) <= 1e-9


def test_slot0_holds_both_kinds(ref, port):
    """The probe shades sphere lanes and disc lanes (slot 0, the JAX
    march's), with cotangents on both, and the port's rays hit."""
    stop, steps, ev_kind, ev_count, _ = ref["march"]
    _, ct_ev = ref["ct"]
    spec = ref["spec"]
    with_ct = ct_ev.any(axis=1) & (ev_count > 0)
    kinds = set(ev_kind[with_ct, 0].tolist())
    assert kinds & {s.kind for s in spec.spheres} and kinds & {d.kind for d in spec.discs}
    assert (port["classes"] == 2).any()  # HIT


def test_plain_backward_matches_jax_march_bwd(ref):
    stop, steps, ev_kind, ev_count, ckpt = ref["march"]
    ct_y, ct_ev = ref["ct"]
    spec = ref["spec"]
    grad_ok, has_ev, kind0 = tadj.sweep_lanes(t(stop), t(ev_kind), t(ev_count))
    d_y0, d_r, d_a = tadj.ks_march_bwd(
        t(ckpt), t(ct_y), t(ct_ev), t(steps), grad_ok, has_ev, kind0, spec.radius, spec.a, _sweep_config(spec),
    )
    want_y0, want_r, want_a = ref["bwd"]
    assert np.abs(want_y0).max() > 0
    assert lane_relative_error(want_y0, d_y0.numpy()) <= 1e-9
    assert abs(float(d_r.sum()) - want_r) <= 1e-9 * abs(want_r)
    assert abs(float(d_a.sum()) - want_a) <= 1e-9 * abs(want_a)


def test_probe_gradients_match_jax(ref, port):
    """The whole slice: camera, march with sphere events, the reverse sweep
    with the sphere payload, shading and fold."""
    assert abs(port["loss"] - ref["loss"]) <= 1e-10 * abs(ref["loss"])
    for k in GRAD_KEYS:
        want, got = ref["grads"][k], port["grads"][k]
        assert want != 0.0 and abs(got - want) <= 1e-8 * abs(want), (k, got, want)


@pytest.mark.parametrize("name", GRAD_KEYS)
def test_probe_gradient_matches_finite_difference(ref, port, name):
    """Central finite difference of the port's own probe loss (JAX's bar
    for bitmap textures, whose texel corners kink the loss)."""
    eps = 1e-6
    scene, spec = ref["scene"], ref["spec"]
    x0, p0 = port["rays"]
    shifted = lambda s: float(_port_loss(scene, spec, x0, p0, {
        k: torch.tensor(v + (s if k == name else 0.0), dtype=F64) for k, v in BASE.items()})[0])
    with torch.no_grad():
        fd = (shifted(eps) - shifted(-eps)) / (2 * eps)
    g = port["grads"][name]
    assert np.isfinite(g) and np.isfinite(fd)
    assert abs(g - fd) / max(abs(fd), 1e-12) < 5e-4


@pytest.mark.cuda
def test_cuda_reverse_sweep_with_spheres_matches_plain(ref):
    """K2 with the sphere payload against its plain version (chip_smoke.py
    does the same at the slice's size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    stop, steps, ev_kind, ev_count, ckpt = ref["march"]
    ct_y, ct_ev = ref["ct"]
    spec = ref["spec"]
    lanes = [v.cuda() for v in tadj.sweep_lanes(t(stop), t(ev_kind), t(ev_count))]
    args = (t(ckpt).cuda(), t(ct_y).cuda(), t(ct_ev).cuda(), t(steps).cuda(), *lanes, spec.radius, spec.a,
            _sweep_config(spec))
    before = tadj.launches
    got = tadj.ks_march_bwd(*args)
    want = tadj.ks_march_bwd_plain(*args)
    assert tadj.launches == before + 1
    assert lane_relative_error(want[0].cpu().numpy(), got[0].cpu().numpy()) <= 1e-9
    for g, w in zip(got[1:], want[1:]):
        assert abs(float(g.sum()) - float(w.sum())) <= 1e-9 * abs(float(w.sum()))
