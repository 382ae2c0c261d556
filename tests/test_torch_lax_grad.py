"""Reverse mode through the port's RKF45 ("lax") path
(IntegrationConfig(differentiable=True): checkpointed blocks in
integrate_rays) against the JAX package's, float64 on the CPU.

The scene is tests/test_grad.py's: the flagship preset at 6×6, budget 200,
sky radius 25, step 0.1, loss Σ c / (1 + c) over the XYZ colors.
- the loss within 1e-8 of the JAX package's (the port's color bar against
  compiled JAX) and the seven parameter gradients of test_grad.py within
  1e-6 relative of its `jax.value_and_grad`;
- the same seven against central differences of the port's own forward, at
  test_grad.py's steps and tolerances;
- the differentiable forward equal bit for bit to the while-loop forward
  (no lane of this frame reaches the attempt cap), and values and
  gradients equal bit for bit at checkpoint_block 1, 7, 32 and one block;
- a frame whose lanes reach the attempt cap: the blocks run past it, as
  the JAX package's, so stop codes and steps equal its differentiable
  forward's and not the while loop's;
- a lane that starts non-finite: finite gradients, equal to JAX's;
- the step-size controller's gradient at a clamp tie (JAX passes half of
  it to each side, torch.clamp all of it);
- three steps of `inverse.fit` on tests/test_inverse.py's 8×8 scene
  against the JAX package's `inverse.fit`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_raytracer_tpu import inverse as jinv
from gr_raytracer_tpu import presets as jpresets
from gr_raytracer_tpu.rendering import camera as jcam
from gr_raytracer_tpu.rendering import integrator as jint
from gr_raytracer_tpu.rendering import rkf45 as jrk
from gr_raytracer_tpu.rendering import scene as jscn
from gr_raytracer_tpu_torch import inverse as tinv
from gr_raytracer_tpu_torch import presets as tpresets
from gr_raytracer_tpu_torch.rendering import camera as tcam
from gr_raytracer_tpu_torch.rendering import integrator as tint
from gr_raytracer_tpu_torch.rendering import rkf45 as trk
from gr_raytracer_tpu_torch.rendering import scene as tscn
from torch_port_scenes import F64, jax_flagship_params, lane_relative_error, pixel_grid, t

ROWS = COLS = 6
MAX_STEPS = 200
FRAME = dict(max_steps=MAX_STEPS, max_radius=25.0, step_size=0.1)
LOSS_RTOL = 1e-8
GRAD_RTOL = 1e-6
# (parameter, component, central-difference step, rtol): test_grad.py's.
GRADS = (
    ("a", None, 1e-6, 5e-4),
    ("radius", None, 1e-6, 5e-4),
    ("camera_position", 1, 1e-6, 5e-4),
    ("camera_theta", None, 1e-6, 5e-4),
    ("camera_psi", None, 1e-6, 5e-4),
    ("disc_temperature", None, 1e-2, 1e-3),
    ("disc_outer", None, 1e-5, 5e-3),
)


def _jax_loss(params, rows=ROWS, cols=COLS, frame=FRAME):
    scene = jpresets.build_kerr_flagship(params, rows, cols, differentiable=True, **frame)
    x, p = jcam.pixel_rays(scene.camera, *(jnp.asarray(v) for v in pixel_grid(rows, cols)))
    c = jscn.trace_rays(scene, x, p).color[..., :3]
    return jnp.sum(c / (1.0 + c))


def _port_scene(params, block=32, differentiable=True, rows=ROWS, cols=COLS, frame=FRAME):
    scene = tpresets.build_kerr_flagship(params, rows, cols, differentiable=differentiable, **frame)
    return dataclasses.replace(scene, integration=dataclasses.replace(scene.integration, checkpoint_block=block))


def _port_trace(scene, rows=ROWS, cols=COLS):
    x, p = tcam.pixel_rays(scene.camera, *(t(v) for v in pixel_grid(rows, cols)))
    return tscn.trace_rays(scene, x, p)


def _port_loss(params, **kw):
    out = _port_trace(_port_scene(params, **kw))
    c = out.color[..., :3]
    return torch.sum(c / (1.0 + c)), out


def _leaves():
    return {k: t(v).requires_grad_(True) for k, v in jax_flagship_params().items()}


def _value_and_grads(**kw):
    params = _leaves()
    loss, out = _port_loss(params, **kw)
    keys = list(params)
    g = torch.autograd.grad(loss, [params[k] for k in keys], allow_unused=True)
    return float(loss), {k: (torch.zeros_like(params[k]) if v is None else v) for k, v in zip(keys, g)}, out


def _pick(g, name, component):
    v = np.asarray(g[name].detach() if isinstance(g[name], torch.Tensor) else g[name])
    return float(v if component is None else v[component])


@pytest.fixture(scope="module")
def ref():
    """JAX's value and gradients; the port's at block 32, and its forward."""
    params = {k: jnp.asarray(v) for k, v in jax_flagship_params().items()}
    j_val, j_grads = jax.jit(jax.value_and_grad(_jax_loss))(params)
    tint.loop_stats.clear()
    val, grads, out = _value_and_grads()
    return dict(j_val=float(j_val), j_grads=j_grads, val=val, grads=grads, out=out,
                stats=dict(tint.loop_stats["march_diff"]))


def test_loss_and_gradients_match_jax(ref):
    assert ref["stats"]["blocks"] >= 2, ref["stats"]
    assert abs(ref["val"] - ref["j_val"]) <= LOSS_RTOL * abs(ref["j_val"]), (ref["val"], ref["j_val"])
    errs = {}
    for name, comp, _, _ in GRADS:
        got, want = _pick(ref["grads"], name, comp), _pick(ref["j_grads"], name, comp)
        assert np.isfinite(got) and want != 0.0, (name, got, want)
        errs[name] = abs(got - want) / abs(want)
    worst = max(errs, key=errs.get)
    print(f"worst gradient: {worst} {errs[worst]:.3e}")
    assert errs[worst] <= GRAD_RTOL, errs
    for k, v in ref["grads"].items():
        assert bool(torch.all(torch.isfinite(v))), k


def test_gradients_match_central_differences(ref):
    base = jax_flagship_params()
    for name, comp, eps, rtol in GRADS:

        def shifted(sign):
            p = {k: t(v) for k, v in base.items()}
            if comp is None:
                p[name] = p[name] + sign * eps
            else:
                p[name] = p[name].clone()
                p[name][comp] += sign * eps
            with torch.no_grad():
                return float(_port_loss(p)[0])

        want = (shifted(1.0) - shifted(-1.0)) / (2.0 * eps)
        got = _pick(ref["grads"], name, comp)
        np.testing.assert_allclose(got, want, rtol=rtol, err_msg=name)


def test_differentiable_forward_equals_while_loop(ref):
    params = {k: t(v) for k, v in jax_flagship_params().items()}
    with torch.no_grad():
        _, out = _port_loss(params, differentiable=False)
    diff = ref["out"]
    assert int(diff.steps.max()) < MAX_STEPS + tint.IntegrationConfig(0.0, 0.0, 0.0).extra_attempts
    for name in ("color", "ray_class", "stop_code", "steps", "ev_overflow"):
        assert torch.equal(getattr(out, name), getattr(diff, name).detach()), name


def test_block_sizes_give_equal_bits(ref):
    """Whole blocks of 1, 7 and 456 (one block: max_steps + extra_attempts)
    iterations against the fixture's 32."""
    for block in (1, 7, MAX_STEPS + 256):
        val, grads, _ = _value_and_grads(block=block)
        assert val == ref["val"], block
        for k, v in grads.items():
            assert torch.equal(v, ref["grads"][k]), (block, k)


def test_lanes_at_the_attempt_cap_match_jax_differentiable_forward():
    """attempts_budget 50 with blocks of 32: the lanes still running at the
    cap march to the end of the second block (64 iterations) in both
    packages; the while loop stops them at 50."""
    budget = 50
    params = {k: jnp.asarray(v) for k, v in jax_flagship_params().items()}
    j_scene = jpresets.build_kerr_flagship(params, ROWS, COLS, differentiable=True, **FRAME)
    t_scene = _port_scene({k: t(v) for k, v in jax_flagship_params().items()})

    @jax.jit
    def j_march(x, p):
        solver = j_scene.geometry.make_solver(x, p)
        return jint.integrate_rays(j_scene.geometry, solver, j_scene.integration, solver.initial_state(x, p),
                                   jscn._segment_fn(j_scene), jscn.EVENT_WIDTH, attempts_budget=budget)

    jx, jp = jcam.pixel_rays(j_scene.camera, *(jnp.asarray(v) for v in pixel_grid(ROWS, COLS)))
    jr = j_march(jx, jp)
    tx, tp = tcam.pixel_rays(t_scene.camera, *(t(v) for v in pixel_grid(ROWS, COLS)))

    def t_march(scene):
        solver = scene.geometry.make_solver(tx, tp)
        return tint.integrate_rays(scene.geometry, solver, scene.integration, solver.initial_state(tx, tp),
                                   tscn._segment_fn(scene), tscn.EVENT_WIDTH, attempts_budget=budget)

    with torch.no_grad():
        tr = t_march(t_scene)
        wr = t_march(_port_scene({k: t(v) for k, v in jax_flagship_params().items()}, differentiable=False))
    np.testing.assert_array_equal(tr.stop_code.numpy(), np.asarray(jr.stop_code))
    np.testing.assert_array_equal(tr.steps.numpy(), np.asarray(jr.steps))
    np.testing.assert_array_equal(tr.ev_count.numpy(), np.asarray(jr.ev_count))
    assert lane_relative_error(np.asarray(jr.y), tr.y.numpy()) <= LOSS_RTOL
    # Past the cap: the lanes the while loop leaves BUDGET at 50 iterations
    # march on and take more steps.
    capped = wr.stop_code == tint.BUDGET
    assert bool(capped.any()) and bool((tr.steps[capped] > wr.steps[capped]).all())


def test_non_finite_lane_has_finite_gradients_matching_jax():
    """Lane 7 of the march starts with a NaN state: the loop steps it from a
    far-field state (a NaN Jacobian would turn its zero cotangents into
    NaN), so the gradients of the other lanes' final states in the metric
    and the camera are finite, and equal JAX's."""
    bad = 7
    names = ("a", "radius", "camera_theta")

    def j_loss(params):
        scene = jpresets.build_kerr_flagship(params, ROWS, COLS, differentiable=True, **FRAME)
        x, p = jcam.pixel_rays(scene.camera, *(jnp.asarray(v) for v in pixel_grid(ROWS, COLS)))
        solver = scene.geometry.make_solver(x, p)
        y0 = solver.initial_state(x, p).at[bad].set(jnp.nan)
        res = jint.integrate_rays(scene.geometry, solver, scene.integration, y0, jscn._segment_fn(scene),
                                  jscn.EVENT_WIDTH)
        return jnp.sum(jnp.where(jnp.isfinite(res.y), res.y, 0.0)), (res.stop_code, res.y)

    params = {k: jnp.asarray(v) for k, v in jax_flagship_params().items()}
    (j_val, (j_stop, j_y)), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(params)

    leaves = _leaves()
    scene = _port_scene(leaves)
    x, p = tcam.pixel_rays(scene.camera, *(t(v) for v in pixel_grid(ROWS, COLS)))
    solver = scene.geometry.make_solver(x, p)
    y0 = solver.initial_state(x, p)
    y0 = torch.where((torch.arange(y0.shape[0]) == bad)[:, None], torch.nan, y0)
    res = tint.integrate_rays(scene.geometry, solver, scene.integration, y0, tscn._segment_fn(scene),
                              tscn.EVENT_WIDTH)
    loss = torch.sum(torch.where(torch.isfinite(res.y), res.y, 0.0))
    g = torch.autograd.grad(loss, [leaves[k] for k in names])
    np.testing.assert_array_equal(res.stop_code.numpy(), np.asarray(j_stop))
    assert lane_relative_error(np.asarray(j_y), res.y.detach().numpy()) <= LOSS_RTOL
    assert abs(float(loss) - float(j_val)) <= LOSS_RTOL * abs(float(j_val))
    for name, got in zip(names, g):
        want = float(np.asarray(j_grads[name]))
        assert np.isfinite(float(got)) and np.isfinite(want), (name, float(got), want)
        assert abs(float(got) - want) <= GRAD_RTOL * abs(want), (name, float(got), want)


def test_controller_gradient_at_a_clamp_tie_matches_jax():
    """Lane 0: h = 0.25 grows by the 4× cap to exactly H_MAX; lane 1: a
    proposal of exactly H_MAX. jnp.clip passes half of the gradient to its
    input at a tie, as the port's controller does (torch.clamp passes all
    of it)."""
    eps = 1e-5
    h = np.array([0.25, 0.5, 0.1, 0.25])
    # err / ε < SMALL_ERROR_RATIO (grown); 0.9·0.5·(ε/err)^0.2 == 1.0 in
    # float64; an ordinary proposal; a rejection.
    err = np.array([1e-11, 1.8452812499999992e-07, 2e-6, 3e-5])

    def j_f(h_, err_):
        accept, h_acc, h_rej = jrk.controller(h_, err_, eps)
        return jnp.sum(h_acc * jnp.arange(1.0, 5.0)) + jnp.sum(h_rej * jnp.arange(5.0, 9.0))

    j_dh, j_derr = jax.grad(j_f, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(err))
    th, terr = t(h).requires_grad_(True), t(err).requires_grad_(True)
    accept, h_acc, h_rej = trk.controller(th, terr, eps)
    f = torch.sum(h_acc * torch.arange(1.0, 5.0, dtype=F64)) + torch.sum(h_rej * torch.arange(5.0, 9.0, dtype=F64))
    dh, derr = torch.autograd.grad(f, [th, terr])
    np.testing.assert_array_equal(h_acc.detach().numpy()[:2], [trk.H_MAX, trk.H_MAX])
    np.testing.assert_array_equal(accept.numpy(), [True, True, True, False])
    np.testing.assert_allclose(dh.numpy(), np.asarray(j_dh), rtol=1e-14, atol=0)
    np.testing.assert_allclose(derr.numpy(), np.asarray(j_derr), rtol=1e-12, atol=0)
    # At lane 0's tie JAX passes half of the growth's ∂/∂h = 4 (through
    # h_acc, weight 1) where torch.clamp passes all of it.
    x = t(h[:1]).requires_grad_(True)
    (full,) = torch.autograd.grad(torch.clamp(x * trk.H_GROWTH_CAP, trk.H_MIN, trk.H_MAX).sum(), [x])
    assert float(full) == 4.0 and float(np.asarray(jax.grad(
        lambda v: jnp.clip(v * jrk.H_GROWTH_CAP, jrk.H_MIN, jrk.H_MAX))(0.25))) == 2.0


def test_inverse_fit_matches_jax():
    """Three steps of test_inverse.py's spin fit (8×8, budget 300, a 0.40
    toward 0.62, lr 5e-2): losses and a within 1e-6 of the JAX package's."""
    rows = cols = 8
    frame = dict(max_steps=300, max_radius=30.0, step_size=0.05)
    a_true, a_init, steps = 0.62, 0.40, 3

    def j_render(params):
        scene = jpresets.build_kerr_flagship(params, rows, cols, differentiable=True, **frame)
        x, p = jcam.pixel_rays(scene.camera, *(jnp.asarray(v) for v in pixel_grid(rows, cols)))
        return jscn.trace_rays(scene, x, p).color

    def t_render(params):
        return _port_trace(_port_scene(params, rows=rows, cols=cols, frame=frame), rows, cols).color

    # One target for both fits: the port's while-loop render at a = 0.62.
    t_params = {k: t(v) for k, v in jax_flagship_params().items()}
    with torch.no_grad():
        target = _port_trace(_port_scene(dict(t_params, a=torch.tensor(a_true, dtype=F64)), differentiable=False,
                                         rows=rows, cols=cols, frame=frame), rows, cols).color
    base = {k: jnp.asarray(v) for k, v in jax_flagship_params().items()}
    j_fit, j_losses = jinv.fit(j_render, dict(base, a=jnp.asarray(a_init)), jnp.asarray(target.numpy()),
                               trainable=["a"], steps=steps, learning_rate=5e-2)
    t_fit, t_losses = tinv.fit(t_render, dict(t_params, a=torch.tensor(a_init, dtype=F64)), target,
                               trainable=["a"], steps=steps, learning_rate=5e-2)
    np.testing.assert_allclose(t_losses, np.asarray(j_losses, np.float64), rtol=1e-6)
    assert t_losses[-1] < t_losses[0]
    np.testing.assert_allclose(float(t_fit["a"]), float(np.asarray(j_fit["a"])), rtol=1e-6)
