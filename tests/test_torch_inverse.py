"""The port's inverse-rendering API (gr_raytracer_tpu_torch/inverse.py)
against the JAX package's (gr_raytracer_tpu/inverse.py and optax), float64
on the CPU.

Losses on seeded buffers to 1e-12 relative; the optimizer (global-norm
clip, then Adam with a cosine-decayed rate, frozen keys masked) fed the
same gradients as the optax chain, and `fit` on a toy renderer against the
JAX `fit`, parameters to 1e-12 after 5 updates. The gradients of the
kernel path itself are held in tests/test_torch_adjoint.py."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gr_raytracer_tpu import inverse as jinv
from gr_raytracer_tpu_torch import inverse as tinv
from torch_port_scenes import F64, t

TOL = 1e-12


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300), (got, want)


def _optax_chain(lr, decay, alpha, mask):
    """What grad_scale_probe.py --fit3 hands to inverse.fit, with inverse.fit's
    own masking of frozen keys."""
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(optax.cosine_decay_schedule(lr, decay, alpha)))
    return optax.chain(opt, optax.masked(optax.set_to_zero(), {k: not m for k, m in mask.items()}))


def test_losses_match_jax():
    rng = np.random.default_rng(1)
    rows = cols = 16
    rendered = 10.0 ** rng.uniform(-3, 4, (rows * cols, 4))
    target = 10.0 ** rng.uniform(-3, 4, (rows * cols, 4))
    for tgt in (target, np.log1p(target[:, :3])):
        _close(float(tinv.image_loss(t(rendered), t(tgt))), float(jinv.image_loss(jnp.asarray(rendered), jnp.asarray(tgt))))
        for pools in ((1, 4, 16), (4, 16)):
            got = tinv.pyramid_image_loss(rows, cols, pools)(t(rendered), t(tgt))
            want = jinv.pyramid_image_loss(rows, cols, pools)(jnp.asarray(rendered), jnp.asarray(tgt))
            _close(float(got), float(want))
    _close(tinv.log_radiance(t(rendered)).numpy(), np.asarray(jinv.log_radiance(jnp.asarray(rendered))))
    with pytest.raises(ValueError):
        tinv.pyramid_image_loss(rows, cols, (3,))


def test_optimizer_matches_optax_chain():
    """Clip by the global norm (frozen keys included), Adam with the cosine
    schedule, frozen keys masked: 5 updates from the same gradients, with
    norms above and below the clip; a long and a short decay."""
    rng = np.random.default_rng(2)
    init = {"u": rng.normal(), "v": rng.normal(size=3), "frozen": rng.normal(size=2)}
    grads = [{k: rng.normal(size=np.shape(v)) * s for k, v in init.items()} for s in (3.0, 0.1, 2.0, 0.2, 5.0)]
    trainable = ("u", "v")
    for lr, decay, alpha in ((1e-2, 400, 0.01), (5e-2, 3, 0.1)):
        params_t = {k: torch.tensor(v, dtype=F64) for k, v in init.items()}
        opt_t = tinv.Optimizer(params_t, trainable, tinv.cosine_decay_schedule(lr, decay, alpha), clip_norm=1.0)
        params_j = {k: jnp.asarray(v) for k, v in init.items()}
        opt_j = _optax_chain(lr, decay, alpha, {k: k in trainable for k in init})
        state = opt_j.init(params_j)

        @jax.jit
        def step_j(g, state, params):
            updates, state = opt_j.update(g, state, params)
            return optax.apply_updates(params, updates), state

        for g in grads:
            with torch.no_grad():
                opt_t.update({k: torch.tensor(v, dtype=F64) for k, v in g.items()})
            params_j, state = step_j({k: jnp.asarray(v) for k, v in g.items()}, state, params_j)
            for k in init:
                _close(params_t[k].numpy(), np.asarray(params_j[k]))
        np.testing.assert_array_equal(params_t["frozen"].numpy(), init["frozen"])


def _toy_render(p, xs, lib):
    """A smooth [N, 4] radiance buffer of three parameters and a frozen one."""
    bump = lib.exp(-((xs - p["c"]) ** 2) / (0.05 + p["w"] ** 2))
    rgb = [p["amp"] * bump * (1.0 + 0.1 * k) + p["floor"] for k in range(3)]
    return lib.stack(rgb + [lib.ones_like(xs)], -1)


def test_fit_matches_jax_fit():
    """`fit` on a toy renderer: losses and parameters of 5 steps against the
    JAX fit driven by the optax chain."""
    xs = np.linspace(-1.0, 1.0, 64)
    init = {"c": 0.3, "w": 0.4, "amp": 2.0, "floor": 0.1}
    true = {"c": -0.1, "w": 0.3, "amp": 5.0, "floor": 0.1}
    trainable = ("c", "w", "amp")
    target = np.asarray(_toy_render({k: jnp.asarray(v) for k, v in true.items()}, jnp.asarray(xs), jnp))
    fitted_j, losses_j = jinv.fit(
        lambda p: _toy_render(p, jnp.asarray(xs), jnp), {k: jnp.asarray(v) for k, v in init.items()}, target,
        trainable, steps=5, optimizer=optax.chain(optax.clip_by_global_norm(1.0), optax.adam(optax.cosine_decay_schedule(5e-2, 4, 0.1))),
    )
    seen = []
    fitted_t, losses_t = tinv.fit(
        lambda p: _toy_render(p, t(xs), torch), {k: torch.tensor(v, dtype=F64) for k, v in init.items()},
        t(target), trainable, steps=5, learning_rate=tinv.cosine_decay_schedule(5e-2, 4, 0.1), clip_norm=1.0,
        callback=lambda i, loss, params, grads: seen.append((i, loss, set(grads))),
    )
    _close(losses_t, losses_j)
    for k in init:
        _close(float(fitted_t[k]), float(fitted_j[k]))
    assert float(fitted_t["floor"]) == init["floor"]
    assert [s[0] for s in seen] == list(range(5)) and seen[0][2] == set(init)

