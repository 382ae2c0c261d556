"""The port's Kerr-Schild frame math against the JAX package, float64 on
random points made with numpy: metric, analytic inverse, stationary and
circular-orbit observers, the solver's state packing, chart helpers and the
march's per-lane scalars, each within 1e-12."""

import jax.numpy as jnp
import numpy as np
import torch

from gr_raytracer_tpu.geometry import chart as jchart
from gr_raytracer_tpu.geometry import circular_orbit as jco
from gr_raytracer_tpu.geometry import kerr as jkerr
from gr_raytracer_tpu.ops import geodesic_pallas as gp
from gr_raytracer_tpu_torch.geometry import chart as tchart
from gr_raytracer_tpu_torch.geometry import circular_orbit as tco
from gr_raytracer_tpu_torch.geometry import kerr as tkerr
from gr_raytracer_tpu_torch.ops import geodesic_march as gm
from torch_port_scenes import t

TOL = dict(rtol=1e-12, atol=1e-12)
SPINS = (0.0, 0.3, 0.499)


def _points(seed, n=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)) * 4.0
    x[:, 1:4] += np.sign(x[:, 1:4]) * 2.5  # outside the horizon, off the ring
    v = rng.normal(size=(n, 4))
    return x, v


def _geoms(a):
    jg = jkerr.Kerr(radius=jnp.asarray(1.0), a=jnp.asarray(a), horizon_epsilon=jnp.asarray(1e-4))
    tg = tkerr.Kerr(
        radius=torch.tensor(1.0, dtype=torch.float64),
        a=torch.tensor(a, dtype=torch.float64),
        horizon_epsilon=torch.tensor(1e-4, dtype=torch.float64),
    )
    return jg, tg


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **TOL)


def test_metric_inverse_and_inner_product():
    x, v = _points(1)
    for a in SPINS:
        jg, tg = _geoms(a)
        _close(tg.metric(t(x)), jg.metric(jnp.asarray(x)))
        _close(
            tkerr.kerr_metric_contravariant(tg.radius, tg.a, t(x)),
            jkerr.kerr_metric_contravariant(jg.radius, jg.a, jnp.asarray(x)),
        )
        _close(
            tg.inner_product(t(x), t(v), t(v)),
            jg.inner_product(jnp.asarray(x), jnp.asarray(v), jnp.asarray(v)),
        )


def test_observers_and_killing_vectors():
    x, _ = _points(2)
    xj = jnp.asarray(x)
    for a in SPINS:
        jg, tg = _geoms(a)
        _close(tg.stationary_velocity(t(x)), jg.stationary_velocity(xj))
        _close(tg.zamo_velocity(t(x)), jg.zamo_velocity(xj))
        _close(tg.axial_killing(t(x)), jg.axial_killing(xj))
        u_t, ok_t = tg.circular_orbit_velocity(t(x))
        u_j, ok_j = jg.circular_orbit_velocity(xj)
        _close(u_t, u_j)
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        _close(tg.radial_coordinate(t(x), tchart.CARTESIAN), jg.radial_coordinate(xj, jchart.CARTESIAN))
        _close(tg.tetrad(t(x[:4])), jg.tetrad(xj[:4]))


def test_solver_state_packing():
    x, p = _points(3)
    xj, pj = jnp.asarray(x), jnp.asarray(p)
    for a in SPINS:
        jg, tg = _geoms(a)
        js, ts = jg.make_solver(xj, pj), tg.make_solver(t(x), t(p))
        y_j = js.initial_state(xj, pj)
        y_t = ts.initial_state(t(x), t(p))
        _close(y_t, y_j)
        _close(ts.momentum(y_t), js.momentum(y_j))
        # The march's own contravariant momentum and radius helpers.
        y8 = np.asarray(y_j).T
        _close(gm._momentum_contra(tg.radius, tg.a, t(y8)), gp._momentum_contra(1.0, a, jnp.asarray(y8)))
        _close(gm._ks_radius(tg.a, *t(y8[1:4])), gp._ks_radius(a, *jnp.asarray(y8[1:4])))


def test_circular_orbit_scalars_and_isco():
    r = np.linspace(0.8, 30.0, 200)
    for a in SPINS:
        args_j = (jnp.asarray(1.0), jnp.asarray(a), jnp.asarray(r))
        args_t = (torch.tensor(1.0, dtype=torch.float64), torch.tensor(a, dtype=torch.float64), t(r))
        for name in ("killing_coefficients", "conserved_energy", "conserved_angular_momentum"):
            for got, ref in zip(getattr(tco, name)(*args_t), getattr(jco, name)(*args_j)):
                _close(got, ref)
        _close(tco.angular_velocity(*args_t), jco.angular_velocity(*args_j))
        _close(tco.r_isco(args_t[0], args_t[1]), jco.r_isco(args_j[0], args_j[1]))


def test_cartesian_to_spherical():
    x, _ = _points(4)
    x[0, 1:4] = 0.0  # the origin branch
    _close(tchart.cartesian_to_spherical(t(x)), jchart.cartesian_to_spherical(jnp.asarray(x)))
