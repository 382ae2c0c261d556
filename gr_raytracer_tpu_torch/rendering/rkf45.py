"""Runge-Kutta-Fehlberg 4(5) embedded step, batched over rays (port of
gr_raytracer_tpu/rendering/rkf45.py).

The reference's controller: β = 0.9, the order-5 exponent, H_MIN/H_MAX
clamps, a 4× growth cap, halve-and-retry on error > ε with accept-at-H_MIN,
at most MAX_RETRIES retries. The retry loop is the integration loop
itself: a rejected lane does not advance that iteration.

Every constant divides or multiplies as in the JAX module; the error norm
sums its squares in component order (`geometry.base.dot`), and the divisions
by ε take ε as a tensor (a Python-scalar divisor becomes a multiply by its
reciprocal in torch).
"""

from __future__ import annotations

import torch

from gr_raytracer_tpu_torch.geometry.base import clip, dot, maximum

# Butcher tableau (RKF45).
_B21 = 2.0 / 9.0
_B31, _B32 = 1.0 / 12.0, 1.0 / 4.0
_B41, _B42, _B43 = 69.0 / 128.0, -243.0 / 128.0, 135.0 / 64.0
_B51, _B52, _B53, _B54 = -17.0 / 12.0, 27.0 / 4.0, -27.0 / 5.0, 16.0 / 15.0
_B61, _B62, _B63, _B64, _B65 = 65.0 / 432.0, -5.0 / 16.0, 13.0 / 16.0, 4.0 / 27.0, 5.0 / 144.0

_CH = (47.0 / 450.0, 0.0, 12.0 / 25.0, 32.0 / 225.0, 1.0 / 30.0, 6.0 / 25.0)
_CT = (1.0 / 150.0, 0.0, -3.0 / 100.0, 16.0 / 75.0, 1.0 / 20.0, -6.0 / 25.0)

BETA = 0.9
ORDER = 5.0
SMALL_ERROR_RATIO = 1e-5
MAX_RETRIES = 100
# Hard cap on a single step, so that the controller does not tunnel rays
# through small objects in flat regions.
H_MAX = 1.0
H_MIN = 1e-12
H_GROWTH_CAP = 4.0


def rkf45_step(rhs, y, h):
    """One embedded RKF45 trial step. rhs: [..., D] -> [..., D]; y: [..., D];
    h: [...] per-lane step sizes. Returns (y5 [..., D], err [...]), err the
    l2 norm of the embedded truncation-error estimate."""
    hh = h[..., None]
    k1 = hh * rhs(y)
    k2 = hh * rhs(y + _B21 * k1)
    k3 = hh * rhs(y + _B31 * k1 + _B32 * k2)
    k4 = hh * rhs(y + _B41 * k1 + _B42 * k2 + _B43 * k3)
    k5 = hh * rhs(y + _B51 * k1 + _B52 * k2 + _B53 * k3 + _B54 * k4)
    k6 = hh * rhs(y + _B61 * k1 + _B62 * k2 + _B63 * k3 + _B64 * k4 + _B65 * k5)

    y_new = y + _CH[0] * k1 + _CH[2] * k3 + _CH[3] * k4 + _CH[4] * k5 + _CH[5] * k6
    te = _CT[0] * k1 + _CT[2] * k3 + _CT[3] * k4 + _CT[4] * k5 + _CT[5] * k6
    sq = dot(te, te)
    pos = sq > 0.0
    err = torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)
    return y_new, err


class _Quotient(torch.autograd.Function):
    """num / den, with the gradient -(g·q)/den in den. Its value has the
    division's bits. Where g is 0 the gradient is 0, where autograd's
    -g·num/den² is 0·∞ = NaN once den² underflows: a float32 lane that
    stalls has err ~1e-20, and its proposal, not taken, passes g = 0."""

    @staticmethod
    def forward(ctx, num, den):
        q = num / den
        ctx.save_for_backward(q, den)
        return q

    @staticmethod
    def backward(ctx, g):
        q, den = ctx.saved_tensors
        g_num = g / den if ctx.needs_input_grad[0] else None
        return g_num, -(g * q) / den


def controller(h, err, epsilon):
    """Step-size decisions, batched: (accept [...] bool, h_on_accept [...],
    h_on_reject [...]). On zero error grow by the cap; proposals are clamped
    to [H_MIN, H_MAX] and at most 4·h; a rejection halves the proposal; a
    lane at H_MIN accepts what it has. A NaN error is accepted (~(err > ε)),
    so that the integrator's NaN stop classifies the ray."""
    eps = torch.full_like(h, epsilon)
    tiny = torch.finfo(h.dtype).tiny
    proposed = torch.where(
        err > 0.0,
        BETA * h * torch.pow(_Quotient.apply(eps, maximum(err, tiny)), 1.0 / ORDER),
        h * H_GROWTH_CAP,
    )
    proposed = clip(torch.minimum(proposed, h * H_GROWTH_CAP), H_MIN, H_MAX)

    at_floor = h <= H_MIN
    accept = ~(err > eps) | at_floor

    grown = clip(h * H_GROWTH_CAP, H_MIN, H_MAX)
    h_on_accept = torch.where(
        at_floor & (err > eps),
        h,
        torch.where(err / eps < SMALL_ERROR_RATIO, grown, proposed),
    )
    h_on_reject = clip(proposed / 2.0, H_MIN, H_MAX)
    return accept, h_on_accept, h_on_reject
