"""Kerr in Boyer-Lindquist coordinates with Carter-separated geodesics (port
of gr_raytracer_tpu/geometry/kerr_bl.py).

The null geodesic equations decouple in Mino time λ with the conserved
(E, L_z, Q) of each ray, taken once at the camera:

    state = (t, r, θ, φ, v_r, v_θ, 0, 0),  v = d(·)/dλ
    dv_r = R'(r)/2,  dv_θ = Θ'(θ)/2,  dt/dλ and dφ/dλ algebraic.

The kernel path's march is ops/geodesic_march.py::kerr_bl_rk4_march; this
module holds the metric, the solver (its right-hand side serves the RKF45
path), the ZAMO frame and the conserved scalars.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gr_raytracer_tpu_torch.geometry import chart as charts
from gr_raytracer_tpu_torch.geometry import circular_orbit
from gr_raytracer_tpu_torch.geometry.base import TRAPPED_ORBIT_RADIUS_FACTOR, Geometry, gram_schmidt, lower, maximum

# Floor for sin²θ in the Carter-constant axis guard.
SIN2_FLOOR = 1e-28

# Gradient floor for the launch-velocity square roots (_turning_safe_sqrt).
_POT_GRAD_FLOOR = 1e-9


def _turning_safe_sqrt(pot):
    """√(max(pot, 0)) with the plain forward value and a gradient that is 0
    at and below _POT_GRAD_FLOOR. Camera rays launch at a turning point of
    their potential (R(r₀) = v_r² with v_r ≈ 0 for near-tangential pixels;
    in f32 the potential often rounds to 0), where d√x is infinite: the
    JAX package measured NaN parameter gradients from it on the chip, and
    zero is the defensible subgradient there."""
    val = torch.sqrt(maximum(pot, 0.0))
    capped = torch.sqrt(maximum(pot, _POT_GRAD_FLOOR))
    return torch.where(pot > _POT_GRAD_FLOOR, capped, val.detach())


def _sigma(r, a, theta):
    ct = torch.cos(theta)
    return r * r + a * a * (ct * ct)


def _delta(r, r_s, a):
    return r * r - r_s * r + a * a


def _sin2(theta):
    st = torch.sin(theta)
    return st * st


def _matrix(g_tt, g_rr, g_thth, g_phph, g_tph):
    zero = torch.zeros_like(g_tt)
    rows = [
        [g_tt, zero, zero, g_tph],
        [zero, g_rr, zero, zero],
        [zero, zero, g_thth, zero],
        [g_tph, zero, zero, g_phph],
    ]
    return torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)


def metric_bl(r_s, a, r, theta):
    """Covariant BL metric, [..., 4, 4]."""
    sig = _sigma(r, a, theta)
    sin2 = _sin2(theta)
    g_tt = -(1.0 - r_s * r / sig)
    g_rr = sig / _delta(r, r_s, a)
    g_phph = (r * r + a * a + a * a * r_s * r * sin2 / sig) * sin2
    g_tph = -a * r_s * r * sin2 / sig
    return _matrix(g_tt, g_rr, sig, g_phph, g_tph)


def metric_bl_contravariant(r_s, a, r, theta):
    """Contravariant BL metric."""
    sig = _sigma(r, a, theta)
    dl = _delta(r, r_s, a)
    sin2 = _sin2(theta)
    r2, a2 = r * r, a * a
    big_a = (r2 + a2) * (r2 + a2) - dl * a2 * sin2
    g_tt = -big_a / (sig * dl)
    g_rr = dl / sig
    g_thth = 1.0 / sig
    g_phph = (dl - a2 * sin2) / (sig * dl * sin2)
    g_tph = -a * r_s * r / (sig * dl)
    return _matrix(g_tt, g_rr, g_thth, g_phph, g_tph)


def potential_r(r, r_s, a, e, l_z, q):
    """R(r) = [(r²+a²)E − aL_z]² − Δ[(L_z−aE)² + Q]."""
    p_r = (r * r + a * a) * e - a * l_z
    lae = l_z - a * e
    return p_r * p_r - _delta(r, r_s, a) * (lae * lae + q)


def potential_r_derivative(r, r_s, a, e, l_z, q):
    """R'(r)."""
    p_r = (r * r + a * a) * e - a * l_z
    lae = l_z - a * e
    return 4.0 * r * e * p_r - (2.0 * r - r_s) * (lae * lae + q)


def potential_theta(theta, a, e, l_z, q):
    """Θ(θ) for null geodesics: Q + a²E²cos²θ − L_z²cos²θ/sin²θ. Diverges at
    the poles by design; the march's NaN stop handles rays that reach the
    axis."""
    ct, st = torch.cos(theta), torch.sin(theta)
    return q + a * a * e * e * ct * ct - l_z * l_z * ct * ct / (st * st)


def potential_theta_derivative(theta, a, e, l_z, q):
    """Θ'(θ)."""
    ct, st = torch.cos(theta), torch.sin(theta)
    return -2.0 * a * a * e * e * ct * st + 2.0 * l_z * l_z * ct / (st * st * st)


@dataclass(frozen=True)
class KerrBLSolver:
    radius: torch.Tensor
    a: torch.Tensor
    e: torch.Tensor  # per-ray conserved energy           [...]
    l_z: torch.Tensor  # per-ray conserved angular momentum  [...]
    q: torch.Tensor  # per-ray Carter constant             [...]

    @property
    def chart(self):
        return charts.BOYER_LINDQUIST

    def _dt_dphi(self, r, theta):
        """Algebraic Mino-time dt/dλ and dφ/dλ."""
        dl = _delta(r, self.radius, self.a)
        p_r = (r * r + self.a * self.a) * self.e - self.a * self.l_z
        sin2 = _sin2(theta)
        dt = (r * r + self.a * self.a) / dl * p_r + self.a * (self.l_z - self.a * self.e * sin2)
        dphi = self.a / dl * p_r + self.l_z / sin2 - self.a * self.e
        return dt, dphi

    def rhs(self, y):
        """Mino-time dy/dλ, [..., 8]: (dt, v_r, v_θ, dφ, R'/2, Θ'/2, 0, 0)."""
        r, theta = y[..., 1], y[..., 2]
        dt, dphi = self._dt_dphi(r, theta)
        dv_r = potential_r_derivative(r, self.radius, self.a, self.e, self.l_z, self.q) / 2.0
        dv_theta = potential_theta_derivative(theta, self.a, self.e, self.l_z, self.q) / 2.0
        zero = torch.zeros_like(dv_r)
        return torch.stack([dt, y[..., 4], y[..., 5], dphi, dv_r, dv_theta, zero, zero], dim=-1)

    def initial_state(self, x, p):
        """Mino-time velocities from the potentials, with the signs of the BL
        contravariant momentum."""
        r, theta = x[..., 1], x[..., 2]
        sign_r = torch.where(p[..., 1] >= 0.0, 1.0, -1.0).to(x.dtype)
        sign_theta = torch.where(p[..., 2] >= 0.0, 1.0, -1.0).to(x.dtype)
        r_pot = potential_r(r, self.radius, self.a, self.e, self.l_z, self.q)
        th_pot = potential_theta(theta, self.a, self.e, self.l_z, self.q)
        v_r = sign_r * _turning_safe_sqrt(r_pot)
        v_theta = sign_theta * _turning_safe_sqrt(th_pot)
        zero = torch.zeros_like(v_r)
        return torch.stack([x[..., 0], r, theta, x[..., 3], v_r, v_theta, zero, zero], dim=-1)

    def momentum(self, y):
        """Affine-parameter momentum p^μ = (1/Σ) dx^μ/dλ."""
        r, theta = y[..., 1], y[..., 2]
        sig = _sigma(r, self.a, theta)
        dt, dphi = self._dt_dphi(r, theta)
        return torch.stack([dt, y[..., 4], y[..., 5], dphi], dim=-1) / sig[..., None]


@dataclass(frozen=True)
class KerrBL(Geometry):
    radius: torch.Tensor  # r_s = 2M
    a: torch.Tensor
    horizon_epsilon: torch.Tensor

    @property
    def chart(self):
        return charts.BOYER_LINDQUIST

    @property
    def spin(self):
        return self.a

    def signature(self):
        return (-1.0, 1.0, 1.0, 1.0)

    def metric(self, x):
        return metric_bl(self.radius, self.a, x[..., 1], x[..., 2])

    def tetrad(self, x):
        """ZAMO-based frame, Gram-Schmidt over (t, e_φ, e_θ, e_r), so that z
        is radial as in Schwarzschild."""
        r, theta = x[..., 1], x[..., 2]
        u_t, u_phi = circular_orbit.zamo_killing_coefficients(self.radius, self.a, r, theta)
        zero = torch.zeros_like(r)
        one = torch.ones_like(r)
        e_t = torch.stack([u_t, zero, zero, u_phi], dim=-1)
        e_ph = torch.stack([zero, zero, zero, one], dim=-1)
        e_th = torch.stack([zero, zero, one, zero], dim=-1)
        e_r = torch.stack([zero, one, zero, zero], dim=-1)
        return gram_schmidt(self, x, torch.stack([e_t, e_ph, e_th, e_r], dim=-2))

    def inside_horizon(self, x):
        m = 0.5 * self.radius
        rp = m + torch.sqrt(maximum(m * m - self.a * self.a, 0.0))
        over_extremal = torch.abs(self.a) > m
        return (x[..., 1] <= rp + self.horizon_epsilon) & ~over_extremal

    def closed_orbit(self, x, step_index, max_steps):
        return (step_index == max_steps - 1) & (x[..., 1] < TRAPPED_ORBIT_RADIUS_FACTOR * self.radius)

    def radial_coordinate(self, x, chart):
        if chart == charts.CARTESIAN:
            return torch.sqrt(
                charts.bl_radius_sq_from_cartesian(self.a, x[..., 1], x[..., 2], x[..., 3])
            )
        return x[..., 1]

    def stationary_velocity(self, x):
        r, theta = x[..., 1], x[..., 2]
        sig = _sigma(r, self.a, theta)
        ut = 1.0 / torch.sqrt(1.0 - self.radius * r / sig)
        u = torch.zeros_like(x)
        u[..., 0] = 1.0
        return u * ut[..., None]

    def zamo_velocity(self, x):
        r, theta = x[..., 1], x[..., 2]
        u_t, u_phi = circular_orbit.zamo_killing_coefficients(self.radius, self.a, r, theta)
        zero = torch.zeros_like(r)
        return torch.stack([u_t, zero, zero, u_phi], dim=-1)

    def orbit_coefficients_at_radius(self, r):
        return circular_orbit.killing_coefficients(self.radius, self.a, r)

    def axial_killing(self, x):
        e_phi = torch.zeros_like(x)
        e_phi[..., 3] = 1.0
        return e_phi

    def conserved_from_bl(self, x, p):
        """(E, L_z, Q) from a BL point and contravariant momentum."""
        r, theta = x[..., 1], x[..., 2]
        p_cov = lower(metric_bl(self.radius, self.a, r, theta), p)
        e = -p_cov[..., 0]
        l_z = p_cov[..., 3]
        p_theta = p_cov[..., 2]
        ct = torch.cos(theta)
        sin2 = _sin2(theta)
        q = p_theta * p_theta + ct * ct * (
            l_z * l_z / maximum(sin2, SIN2_FLOOR) - self.a * self.a * e * e
        )
        return e, l_z, q

    def make_solver(self, x0, p0):
        e, l_z, q = self.conserved_from_bl(x0, p0)
        return KerrBLSolver(radius=self.radius, a=self.a, e=e, l_z=l_z, q=q)

    def constants_of_motion(self, x, p):
        e, l_z, q = self.conserved_from_bl(x, p)
        return {"E": e, "L_z": l_z, "Q": q}
