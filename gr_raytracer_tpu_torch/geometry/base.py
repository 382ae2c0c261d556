"""Geometry base: inner product, frames, observers (port of
gr_raytracer_tpu/geometry/base.py).

Geometries are frozen dataclasses of 0-d tensors; every method is a plain
function of [..., 4] tensors and keeps their device and dtype.
"""

from __future__ import annotations

import torch

# Radius, in units of r_s, inside which a photon that used up its step budget
# is classified as trapped.
TRAPPED_ORBIT_RADIUS_FACTOR = 5.0


def lower(g, v):
    """g_{μν} v^ν: [..., n, n] and [..., n] → [..., n], the products summed
    elementwise in index order. The same contraction written as einsum runs
    as a batched matmul, whose library kernel, and so its rounding, changes
    with the batch count; the rays' colors then moved in their last bits
    with --chunk-size. This form rounds alike at every batch size."""
    out = g[..., :, 0] * v[..., None, 0]
    for j in range(1, v.shape[-1]):
        out = out + g[..., :, j] * v[..., None, j]
    return out


def dot(v, w):
    """Σ_μ v_μ w_μ over the last axis, summed elementwise in index order
    (batch-invariant, as `lower`)."""
    out = v[..., 0] * w[..., 0]
    for j in range(1, v.shape[-1]):
        out = out + v[..., j] * w[..., j]
    return out


# The JAX package's elementwise bounds, with its gradients. At a tie,
# jnp.maximum, jnp.minimum and jnp.clip pass half of the gradient to each
# side, where torch.clamp passes all of it to its input; torch.maximum and
# torch.minimum split it as JAX does. jnp.abs has derivative 1 at 0, where
# torch.abs has 0. Each gives the same bits as the torch op it replaces.


def _bound(x, b):
    # A float bound becomes a 0-dim CPU tensor, which a CUDA op takes as a
    # scalar argument: no fill kernel, no tensor the size of x and no copy
    # to the card (a CUDA graph captures it).
    return b if isinstance(b, torch.Tensor) else torch.scalar_tensor(b, dtype=x.dtype)


def maximum(x, lo):
    """jnp.maximum(x, lo) for a float or tensor bound."""
    return torch.maximum(x, _bound(x, lo))


def minimum(x, hi):
    """jnp.minimum(x, hi) for a float or tensor bound."""
    return torch.minimum(x, _bound(x, hi))


def clip(x, lo, hi):
    """jnp.clip(x, lo, hi): the maximum, then the minimum."""
    return minimum(maximum(x, lo), hi)


def abs_(x):
    """jnp.abs(x): |x| (−0 gives +0) with derivative 1 at 0."""
    return torch.where(x >= 0.0, x, -x) + 0.0


def acos_clip(x):
    """arccos(clip(x, −1, 1)), with a zero gradient at ±1, where arccos' is
    infinite. A lane whose point lies on an axis there (a sphere's or a
    chart's; a float32 lane that stalls meets it) passes g = 0 through an
    unused branch, and g·∞ = NaN would spread through its state, as in
    the JAX package's reverse mode. Same bits as the plain form, which
    runs where nothing needs the gradient."""
    c = clip(x, -1.0, 1.0)
    if not (torch.is_grad_enabled() and c.requires_grad):
        return torch.acos(c)
    pole = (c <= -1.0) | (c >= 1.0)
    return torch.where(pole, torch.acos(c.detach()), torch.acos(torch.where(pole, 0.0, c)))


def sqrt_nonneg(x):
    """√max(x, 0) (NaN stays NaN) with a zero gradient where x ≤ 0. A
    segment test's discriminant is exactly 0 on the zero-length segments
    of lanes that did not move in an iteration, where
    jnp.sqrt(jnp.maximum(x, 0)) has the gradient 0.5·∞·0 = NaN: it spreads
    through the lane's state into every parameter, though the root is
    masked out (the JAX package's reverse mode through the lax path has
    it, ROADMAP Queue 3)."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), torch.where(x <= 0.0, 0.0, x))


def unit_time_vector(x):
    """e_t = (1, 0, 0, 0) broadcast like x."""
    e_t = torch.zeros_like(x)
    e_t[..., 0] = 1.0
    return e_t


class Geometry:
    """Frame and observer methods shared by the geometries. A subclass
    provides chart, signature(), metric(x), tetrad(x),
    radial_coordinate(x, chart), orbit_coefficients_at_radius(r),
    axial_killing(x), stationary_velocity(x), make_solver(x0, p0) and, for
    the RKF45 path, inside_horizon(x) and closed_orbit(x, step_index,
    max_steps) (the trapped-photon test at budget exhaustion); the solver
    gives rhs(y), initial_state(x, p) and momentum(y)."""

    @property
    def spin(self):
        """The BL-embedding spin used by chart conversions (0 unless Kerr)."""
        return 0.0

    def inner_product(self, x, v, w):
        """g_{μν} v^μ w^ν at x."""
        return dot(v, lower(self.metric(x), w))

    def constants_of_motion(self, x, p):
        """name -> [...] conserved scalars, for drift monitoring."""
        return {}

    def lorentz_transformation(self, x, velocity):
        """Boost matrix mapping the tetrad frame to the observer with
        four-velocity `velocity`."""
        g = self.metric(x)
        t = self.tetrad(x)[..., 0, :]
        s = self.signature()[0]
        gamma = s * torch.einsum("...ij,...i,...j->...", g, t, velocity)
        tv = t + velocity
        tv_lower = torch.einsum("...ij,...j->...i", g, tv)
        gt = torch.einsum("...ij,...j->...i", g, t)
        eye = torch.eye(4, dtype=x.dtype, device=x.device)
        outer1 = tv[..., :, None] * tv_lower[..., None, :]
        outer2 = velocity[..., :, None] * gt[..., None, :]
        return eye - s * (outer1 / (1.0 + gamma)[..., None, None] - 2.0 * outer2)

    def circular_orbit_killing_coefficients(self, x, chart=None):
        """(u_t, u_φ, ok) at the point's radius."""
        r = self.radial_coordinate(x, chart or self.chart)
        return self.orbit_coefficients_at_radius(r)

    def circular_orbit_velocity(self, x):
        """(u [..., 4], ok): circular-orbit four-velocity at x."""
        u_t, u_phi, ok = self.circular_orbit_killing_coefficients(x)
        u = u_t[..., None] * unit_time_vector(x) + u_phi[..., None] * self.axial_killing(x)
        return u, ok


def gram_schmidt(geometry, x, vectors):
    """Metric-aware Gram-Schmidt along axis -2 of `vectors` [..., n, 4]."""
    out = []
    for i in range(vectors.shape[-2]):
        w = vectors[..., i, :]
        for u in out:
            num = geometry.inner_product(x, w, u)
            den = geometry.inner_product(x, u, u)
            w = w - (num / den)[..., None] * u
        norm = torch.sqrt(abs_(geometry.inner_product(x, w, w)))
        out.append(w / norm[..., None])
    return torch.stack(out, dim=-2)


def validate_tetrad(geometry, x, tetrad, tol=None):
    """Host-side orthonormality check; raises ValueError when any of the 10
    inner products deviates from the signature by more than `tol` (1e-5 in
    float64, 1e-4 in float32)."""
    if tol is None:
        tol = 1e-5 if tetrad.dtype == torch.float64 else 1e-4
    sig = geometry.signature()
    for i in range(4):
        for j in range(i, 4):
            got = geometry.inner_product(x, tetrad[..., i, :], tetrad[..., j, :])
            want = sig[i] if i == j else 0.0
            if not bool(torch.all(torch.abs(got - want) < tol)):
                raise ValueError(
                    f"tetrad not orthonormal: <e{i}, e{j}> = {got.tolist()} (want {want})"
                )
