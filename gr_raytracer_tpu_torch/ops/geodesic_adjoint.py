"""Reverse mode through the marches: checkpointed reverse sweeps
(counterpart of gr_raytracer_tpu/ops/geodesic_adjoint.py).

  forward   ops/geodesic_march.kerr_rk4_march (K1) or kerr_bl_rk4_march
            (K3) with ckpt_every = K: the production march plus the
            pre-step state every K iterations, [S, 8, N].
  backward  the reverse sweep (K2 for Kerr-Schild, K4 for Boyer-Lindquist):
            per lane, segments in reverse order; each re-forwards its steps
            from the checkpoint, replaying the march bit for bit, then walks
            them backwards applying the VJP of the whole step (RK4, the step
            rule, the far-field lever of K1 and the slot-0 disc or sphere
            payload) to carry the adjoint λ and the per-lane partials
            ∂L/∂radius, ∂L/∂a, and on the BL march ∂L/∂E, ∂L/∂L_z, ∂L/∂Q.

For tensors on the card the backward launches the hand-written CUDA kernel
(csrc/kerr_ks_adjoint.cu, csrc/kerr_bl_adjoint.cu); for tensors on the CPU
it runs the same sweep in plain torch (`ks_march_bwd_plain`,
`bl_march_bwd_plain`). Both take the step's VJP written by hand in reverse
mode (`ks_step_vjp`, `bl_step_vjp`, the kernels' lines) on every step but
a hit lane's last, whose payload cotangent enters through the dual numbers
of the kernels and torch.func.vjp of the plain step with its payload.

The VJP differentiates the discrete march (same steps, same masks), not a
continuous adjoint. Stop codes, the crossing step and the cost sort are
locally constant. Scope: scenes whose textures are all opaque, so that the
only shaded event is slot 0, recorded at the lane's last step; with thin
discs and spheres on the Kerr-Schild march (the slot-0 kind picks the
payload per lane), with thin discs on the Boyer-Lindquist one (the JAX
package's BL sweep has no sphere payload either).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from gr_raytracer_tpu_torch.ops import geodesic_march as gm
from gr_raytracer_tpu_torch.rendering import integrator as integ

K_CKPT = 128  # steps per checkpoint segment
# Adjoint trust region: a λ component or per-step parameter partial at or
# beyond this is treated as diverged, and the lane is retired from the
# sums (|x| < CAP is False for NaN, so non-finite values retire too). A
# near-critical (photon-ring) lane's λ grows like the product of its step
# Jacobians and overflows f32 within a few thousand reverse steps; its
# forward is chaotic beyond f32 and carries no usable signal.
LAM_CAP = 1e15

# Launches of the CUDA kernels K2 and K4 (the plain versions do not count).
launches = 0
bl_launches = 0
# When set to a list, each launch of K2 (K4) appends its (start, end) CUDA
# events.
launch_timer = None
bl_launch_timer = None


class SweepConfig(NamedTuple):
    """The static configuration of a differentiable march."""

    h0: float
    max_steps: int
    discs: tuple
    r_safe: float
    h_min_frac: float
    r_ref_scale: float
    k_ckpt: int
    spheres: tuple = ()  # SphereSpec; the Kerr-Schild sweep only


# ---------------------------------------------------------------------------
# The step map G: y ↦ (y_new, slot-0 payload), in plain torch. States are
# [8, N] (component-major); radius and a may be [N] tiles so that the VJP
# gives per-lane partials.
# ---------------------------------------------------------------------------


def _masked_step(radius, a, h0, h_min_frac, r_ref_scale, r_safe, y, active):
    """One masked RK4 advance, op for op the march's (geodesic_march
    _plain_step, csrc/kerr_ks_common.cuh rk4_delta). r₊ is recomputed from
    (radius, a) here so that ∂/∂a flows through h; its sqrt and the
    far-field speed are guarded by max(·, 1e-30), which leaves every real
    lane's value unchanged and keeps the derivative finite. Ties of
    maximum/minimum split the derivative half and half, as in JAX."""
    dt = y.dtype
    c = lambda v: torch.tensor(float(v), dtype=dt, device=y.device)
    m = 0.5 * radius
    r_plus = m + torch.sqrt(torch.maximum(m * m - a * a, c(1e-30)))
    r_here = gm._ks_radius(a, y[1], y[2], y[3])
    # Divisors are tensors, as in the march (see _plain_step).
    h = h0 * torch.minimum(torch.maximum((r_here - r_plus) / c(r_ref_scale), c(h_min_frac)), c(1.0))
    k1 = gm._rhs(radius, a, y)
    if r_safe > 0.0:
        rho = torch.sqrt(y[1] * y[1] + y[2] * y[2] + y[3] * y[3])
        speed = torch.sqrt(torch.maximum(k1[1] ** 2 + k1[2] ** 2 + k1[3] ** 2, c(1e-30)))
        outward = (y[1] * k1[1] + y[2] * k1[2] + y[3] * k1[3]) > 0.0
        h_far = torch.minimum(0.5 * (rho - r_safe), 0.125 * rho) / torch.maximum(speed, c(1e-12))
        h = torch.where(outward & (rho > r_safe), torch.maximum(h, h_far), h)
    k2 = gm._rhs(radius, a, y + 0.5 * h * k1)
    k3 = gm._rhs(radius, a, y + 0.5 * h * k2)
    k4 = gm._rhs(radius, a, y + h * k3)
    y_new = y + (h / c(6.0)) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return torch.where(active[None], y_new, y)


def _disc_payload(discs, ev_kind0, y, y_new):
    """The slot-0 disc-crossing payload of the step y → y_new, as the march
    stores it; multi-disc scenes select the disc bounds by the recorded
    kind. The denominator guard is |dz| ≥ 1e-12 (the march guards exact
    equality only): the VJP divides by dz², and a real crossing has |dz| at
    the step scale."""
    z_prev, z_new = y[3], y_new[3]
    den_raw = z_prev - z_new
    ok = torch.abs(den_raw) >= 1e-12
    frac = torch.where(ok, z_prev, 0.0) / torch.where(ok, den_raw, 1.0)
    px = y[1] + frac * (y_new[1] - y[1])
    py = y[2] + frac * (y_new[2] - y[2])
    u, v = _disc_uv(discs, ev_kind0, px, py)
    return frac, px, py, u, v


def _disc_uv(discs, ev_kind0, px, py):
    """The disc UV of a crossing point, with the bounds of the disc that the
    slot-0 kind names; the radius is guarded by max(·, 1e-30)."""
    rr = torch.sqrt(torch.maximum(px * px + py * py, px.new_tensor(1e-30)))
    phi = torch.atan2(py, px)
    inner = torch.zeros_like(px) + float(discs[0].inner)
    outer = torch.zeros_like(px) + float(discs[0].outer)
    for d in discs[1:]:
        sel = ev_kind0 == d.kind
        inner = torch.where(sel, float(d.inner), inner)
        outer = torch.where(sel, float(d.outer), outer)
    r_norm = (rr - inner) / (outer - inner)
    return 0.5 + 0.5 * r_norm * torch.cos(phi), 0.5 + 0.5 * r_norm * torch.sin(phi)


def _sphere_payload(spheres, ev_kind0, y, y_new):
    """The slot-0 sphere-crossing payload of the step y → y_new, as the
    march stores it: the crossing fraction t, the world point and the local
    spherical UV of the sphere that the slot-0 kind names (the first
    sphere's where it names none). Every sqrt and division is guarded
    (sqrt(max(·, 1e-30)), |a| > 1e-30), so that a lane whose slot 0 is not
    this sphere contributes exact zeros under its zero cotangent. The +
    root is taken where it lies in [0, 1], a locally constant choice.

    θ = π/2 − atan(cos θ / sin θ), with sin θ = sqrt(max(1 − cos², 1e-30)),
    is atan2(sin θ, cos θ) in value, but its derivative stays finite at
    cos θ = 0, where a frozen lane's benign state sits: through atan2's
    y/x the derivative is infinite there, and 0 · ∞ turns λ into NaN."""
    s3 = y[1:4]
    d = y_new[1:4] - y[1:4]
    tiny = y.new_tensor(1e-30)
    a_q = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    out = None
    for sp in spheres:
        s_loc = torch.stack([s3[0] - sp.cx, s3[1] - sp.cy, s3[2] - sp.cz])
        b_q = 2.0 * (s_loc[0] * d[0] + s_loc[1] * d[1] + s_loc[2] * d[2])
        c_q = (s_loc[0] * s_loc[0] + s_loc[1] * s_loc[1] + s_loc[2] * s_loc[2]) - sp.radius * sp.radius
        disc = b_q * b_q - 4.0 * a_q * c_q
        sq = torch.sqrt(torch.maximum(disc, tiny))
        safe_a = torch.where(torch.abs(a_q) > 1e-30, a_q, 1.0)
        t1 = (-b_q + sq) / (2.0 * safe_a)
        t2 = (-b_q - sq) / (2.0 * safe_a)
        t = torch.where((t1 >= 0.0) & (t1 <= 1.0), t1, t2)
        local = s_loc + t[None] * d
        r_loc = torch.sqrt(torch.maximum(local[0] * local[0] + local[1] * local[1] + local[2] * local[2], tiny))
        cos_th = torch.clamp(local[2] / r_loc, -1.0, 1.0)
        sin_th = torch.sqrt(torch.maximum(1.0 - cos_th * cos_th, tiny))
        theta = math.pi / 2 - torch.atan(cos_th / sin_th)
        phi = torch.atan2(local[1], local[0])
        u = 1.0 - (math.pi + phi) / (2.0 * math.pi)
        v = theta / math.pi
        vals = (t, local[0] + sp.cx, local[1] + sp.cy, local[2] + sp.cz, u, v)
        if out is None:
            out = vals
        else:
            sel = ev_kind0 == sp.kind
            out = tuple(torch.where(sel, new, old) for new, old in zip(vals, out))
    return out


def _step_with_payload(discs, spheres, h0, h_min_frac, r_ref_scale, r_safe, ev_kind0, radius, a, y, active):
    """y ↦ (y_new [8, N], payload [12, N]): [point3 | p_interp4 | uv2 | seg3].
    With discs and spheres both present, each lane takes the sphere
    payload where its slot-0 kind is a sphere's and the disc payload
    elsewhere; a scene of spheres alone takes the sphere payload."""
    y_new = _masked_step(radius, a, h0, h_min_frac, r_ref_scale, r_safe, y, active)
    p_prev = gm._momentum_contra(radius, a, y)
    p_new = gm._momentum_contra(radius, a, y_new)
    seg = y_new[1:4] - y[1:4]
    if discs:
        frac, px, py, u, v = _disc_payload(discs, ev_kind0, y, y_new)
        pz = torch.zeros_like(px)
    if spheres:
        sphere = _sphere_payload(spheres, ev_kind0, y, y_new)
        if discs:
            is_sphere = torch.zeros_like(ev_kind0, dtype=torch.bool)
            for sp in spheres:
                is_sphere = is_sphere | (ev_kind0 == sp.kind)
            disc = (frac, px, py, pz, u, v)
            frac, px, py, pz, u, v = (torch.where(is_sphere, s_, d_) for s_, d_ in zip(sphere, disc))
        else:
            frac, px, py, pz, u, v = sphere
    p_interp = p_prev + frac[None] * (p_new - p_prev)
    payload = torch.cat([px[None], py[None], pz[None], p_interp, u[None], v[None], seg])
    return y_new, payload


def _trusted(*vals):
    """Lanes whose every value (rows of [R, N] or [N] tensors) lies strictly
    inside the trust region."""
    ok = None
    for v in vals:
        t = torch.abs(v) < LAM_CAP
        t = t.all(dim=0) if v.dim() == 2 else t
        ok = t if ok is None else ok & t
    return ok


# ---------------------------------------------------------------------------
# The step VJP written by hand in reverse mode: one forward pass that keeps
# the stages, then one backward pass through the RK4 combination, the
# stages, the right-hand side at each stage and the step size. The same
# lines, in the same order, are the CUDA sweeps' (csrc/kerr_ks_adjoint.cu,
# csrc/kerr_bl_adjoint.cu). Ties of max/min split the derivative half and
# half, as jnp.maximum's VJP does; a clipped value takes the bound's zero.
# ---------------------------------------------------------------------------


def _d_max(x, y):
    """∂max(x, y)/∂x: 1 where x wins, ½ at a tie, 0 where y wins."""
    return torch.where(x > y, 1.0, torch.where(x == y, 0.5, 0.0)).to(x.dtype)


def _d_min(x, y):
    """∂min(x, y)/∂x."""
    return torch.where(x < y, 1.0, torch.where(x == y, 0.5, 0.0)).to(x.dtype)


def _d_clip(x, lo, hi):
    """∂clip(x, lo, hi)/∂x as max then min of values: the select on values
    passes x's derivative where it lies strictly inside, half at a bound."""
    return _d_max(x, torch.full_like(x, lo)) * _d_min(torch.maximum(x, torch.full_like(x, lo)), torch.full_like(x, hi))


def _step_select(y, lam, lam_new, parts, active, cap=LAM_CAP):
    """The sweep's per-step conventions: an inactive step or one whose
    state is not finite is the identity on λ with zero partials; a step
    whose λ or any partial leaves the trust region zeroes λ and drops its
    partials."""
    take = active & torch.isfinite(y).all(dim=0)
    trust = _trusted(lam_new, *parts)
    lam_out = torch.where(take[None], torch.where(trust[None], lam_new, 0.0), lam)
    parts = tuple(torch.where(take & trust, p_, 0.0) for p_ in parts)
    return lam_out, parts


def _ks_radius_vjp(a, x, y, z, r_bar):
    """(x̄, ȳ, z̄, ā) of Kerr-Schild r (geodesic_march._ks_radius)."""
    rho_sq = x * x + y * y + z * z
    d = rho_sq - a * a
    s = torch.sqrt(d * d + 4.0 * a * a * z * z)
    r = torch.sqrt(0.5 * (d + s))
    w_bar = r_bar / (2.0 * r)
    d_bar = 0.5 * w_bar
    v_bar = 0.5 * w_bar / (2.0 * s)
    d_bar = d_bar + 2.0 * d * v_bar
    a_bar = 8.0 * a * z * z * v_bar - 2.0 * a * d_bar
    z_bar = 8.0 * a * a * z * v_bar
    return 2.0 * x * d_bar, 2.0 * y * d_bar, z_bar + 2.0 * z * d_bar, a_bar


def _ks_rhs_vjp(radius, a, y, ob):
    """The VJP of geodesic_march._rhs at y ([8, N]) along ob ([8, N]; row 4
    is ṗ_t = 0 and takes none): (ȳ [8, N], radius̄, ā). The forward lines
    are _rhs's; the backward walks them in reverse."""
    x, yy, z = y[1], y[2], y[3]
    p0, p1, p2, p3 = y[4], y[5], y[6], y[7]
    a2 = a * a
    rho_sq = x * x + yy * yy + z * z
    d = rho_sq - a2
    dd4 = d * d + 4.0 * a2 * z * z
    inv_s = torch.rsqrt(dd4)
    r_sq = 0.5 * (d + dd4 * inv_s)
    inv_r = torch.rsqrt(r_sq)
    r = r_sq * inv_r
    D = r_sq * r_sq + a2 * z * z
    denom = r_sq + a2
    inv_Dd = 1.0 / (D * denom)
    inv_D = inv_Dd * denom
    inv_denom = inv_Dd * D
    f = radius * r * r_sq * inv_D
    kx = (r * x + a * yy) * inv_denom
    ky = (r * yy - a * x) * inv_denom
    kz = z * inv_r
    k_dot_p = -p0 + kx * p1 + ky * p2 + kz * p3
    common = 1.0 + d * inv_s
    dr2_x = x * common
    dr2_y = yy * common
    dr2_z = z * common + 2.0 * a2 * z * inv_s
    half_inv_r = 0.5 * inv_r
    dr_x = dr2_x * half_inv_r
    dr_y = dr2_y * half_inv_r
    dr_z = dr2_z * half_inv_r
    cf = radius * r_sq * inv_D * inv_D
    t1 = 3.0 * a2 * z * z - r_sq * r_sq
    df_x = cf * t1 * dr_x
    df_y = cf * t1 * dr_y
    df_z = cf * (t1 * dr_z - 2.0 * a2 * z * r)
    n_xx = dr_x * x + r - kx * dr2_x
    n_xy = dr_y * x + a - kx * dr2_y
    n_xz = dr_z * x - kx * dr2_z
    n_yx = dr_x * yy - a - ky * dr2_x
    n_yy = dr_y * yy + r - ky * dr2_y
    n_yz = dr_z * yy - ky * dr2_z
    dkx_x, dkx_y, dkx_z = n_xx * inv_denom, n_xy * inv_denom, n_xz * inv_denom
    dky_x, dky_y, dky_z = n_yx * inv_denom, n_yy * inv_denom, n_yz * inv_denom
    zir2 = z * inv_r * inv_r
    dkz_x = -zir2 * dr_x
    dkz_y = -zir2 * dr_y
    dkz_z = inv_r - zir2 * dr_z
    dkp_x = p1 * dkx_x + p2 * dky_x + p3 * dkz_x
    dkp_y = p1 * dkx_y + p2 * dky_y + p3 * dkz_y
    dkp_z = p1 * dkx_z + p2 * dky_z + p3 * dkz_z
    kp2 = k_dot_p * k_dot_p
    fkp = f * k_dot_p

    # Backward. ṗ_i = ½ ∂f_i (k·p)² + f (k·p) ∂(k·p)_i.
    o0, o1, o2, o3, o5, o6, o7 = ob[0], ob[1], ob[2], ob[3], ob[5], ob[6], ob[7]
    df_x_b, df_y_b, df_z_b = 0.5 * kp2 * o5, 0.5 * kp2 * o6, 0.5 * kp2 * o7
    kp2_b = 0.5 * (df_x * o5 + df_y * o6 + df_z * o7)
    fkp_b = dkp_x * o5 + dkp_y * o6 + dkp_z * o7
    dkp_x_b, dkp_y_b, dkp_z_b = fkp * o5, fkp * o6, fkp * o7
    f_b = k_dot_p * fkp_b
    kdp_b = f * fkp_b + 2.0 * k_dot_p * kp2_b
    # ∂(k·p)_i = Σ_j p_j ∂k_j/∂x_i.
    p1_b = dkx_x * dkp_x_b + dkx_y * dkp_y_b + dkx_z * dkp_z_b
    p2_b = dky_x * dkp_x_b + dky_y * dkp_y_b + dky_z * dkp_z_b
    p3_b = dkz_x * dkp_x_b + dkz_y * dkp_y_b + dkz_z * dkp_z_b
    dkx_x_b, dkx_y_b, dkx_z_b = p1 * dkp_x_b, p1 * dkp_y_b, p1 * dkp_z_b
    dky_x_b, dky_y_b, dky_z_b = p2 * dkp_x_b, p2 * dkp_y_b, p2 * dkp_z_b
    dkz_x_b, dkz_y_b, dkz_z_b = p3 * dkp_x_b, p3 * dkp_y_b, p3 * dkp_z_b
    # ∂k_z.
    inv_r_b = dkz_z_b
    zir2_b = -(dr_x * dkz_x_b + dr_y * dkz_y_b + dr_z * dkz_z_b)
    dr_x_b = -zir2 * dkz_x_b
    dr_y_b = -zir2 * dkz_y_b
    dr_z_b = -zir2 * dkz_z_b
    z_b = inv_r * inv_r * zir2_b
    inv_r_b = inv_r_b + 2.0 * z * inv_r * zir2_b
    # ∂k_x, ∂k_y: n_ji · 1/(r² + a²).
    inv_denom_b = (n_xx * dkx_x_b + n_xy * dkx_y_b + n_xz * dkx_z_b
                   + n_yx * dky_x_b + n_yy * dky_y_b + n_yz * dky_z_b)
    nxx_b, nxy_b, nxz_b = dkx_x_b * inv_denom, dkx_y_b * inv_denom, dkx_z_b * inv_denom
    nyx_b, nyy_b, nyz_b = dky_x_b * inv_denom, dky_y_b * inv_denom, dky_z_b * inv_denom
    dr_x_b = dr_x_b + x * nxx_b + yy * nyx_b
    dr_y_b = dr_y_b + x * nxy_b + yy * nyy_b
    dr_z_b = dr_z_b + x * nxz_b + yy * nyz_b
    x_b = dr_x * nxx_b + dr_y * nxy_b + dr_z * nxz_b
    yy_b = dr_x * nyx_b + dr_y * nyy_b + dr_z * nyz_b
    r_b = nxx_b + nyy_b
    a_b = nxy_b - nyx_b
    kx_b = -(dr2_x * nxx_b + dr2_y * nxy_b + dr2_z * nxz_b)
    ky_b = -(dr2_x * nyx_b + dr2_y * nyy_b + dr2_z * nyz_b)
    dr2_x_b = -(kx * nxx_b + ky * nyx_b)
    dr2_y_b = -(kx * nxy_b + ky * nyy_b)
    dr2_z_b = -(kx * nxz_b + ky * nyz_b)
    # ∂f.
    m_z = t1 * dr_z - 2.0 * a2 * z * r
    cft1_b = dr_x * df_x_b + dr_y * df_y_b
    cf_b = t1 * cft1_b + m_z * df_z_b
    mz_b = cf * df_z_b
    t1_b = cf * cft1_b + dr_z * mz_b
    dr_x_b = dr_x_b + cf * t1 * df_x_b
    dr_y_b = dr_y_b + cf * t1 * df_y_b
    dr_z_b = dr_z_b + t1 * mz_b
    a2_b = -2.0 * z * r * mz_b
    z_b = z_b - 2.0 * a2 * r * mz_b
    r_b = r_b - 2.0 * a2 * z * mz_b
    a2_b = a2_b + 3.0 * z * z * t1_b
    z_b = z_b + 6.0 * a2 * z * t1_b
    r_sq_b = -2.0 * r_sq * t1_b
    radius_b = r_sq * inv_D * inv_D * cf_b
    r_sq_b = r_sq_b + radius * inv_D * inv_D * cf_b
    inv_D_b = 2.0 * radius * r_sq * inv_D * cf_b
    # ∂r_i = ∂r²_i / (2r).
    dr2_x_b = dr2_x_b + half_inv_r * dr_x_b
    dr2_y_b = dr2_y_b + half_inv_r * dr_y_b
    dr2_z_b = dr2_z_b + half_inv_r * dr_z_b
    inv_r_b = inv_r_b + 0.5 * (dr2_x * dr_x_b + dr2_y * dr_y_b + dr2_z * dr_z_b)
    common_b = x * dr2_x_b + yy * dr2_y_b + z * dr2_z_b
    x_b = x_b + common * dr2_x_b
    yy_b = yy_b + common * dr2_y_b
    z_b = z_b + (common + 2.0 * a2 * inv_s) * dr2_z_b
    a2_b = a2_b + 2.0 * z * inv_s * dr2_z_b
    inv_s_b = 2.0 * a2 * z * dr2_z_b + d * common_b
    d_b = inv_s * common_b
    # ẋ = ∂H/∂p.
    fk_dot = f * k_dot_p
    p1_b = p1_b + o1
    p2_b = p2_b + o2
    p3_b = p3_b + o3
    p0_b = -o0
    f_b = f_b + k_dot_p * (o0 - kx * o1 - ky * o2 - kz * o3)
    kx_b = kx_b - fk_dot * o1
    ky_b = ky_b - fk_dot * o2
    kz_b = -fk_dot * o3
    kdp_b = kdp_b + f * (o0 - kx * o1 - ky * o2 - kz * o3)
    # k·p = −p_0 + k_x p_1 + k_y p_2 + k_z p_3.
    p0_b = p0_b - kdp_b
    p1_b = p1_b + kx * kdp_b
    p2_b = p2_b + ky * kdp_b
    p3_b = p3_b + kz * kdp_b
    kx_b = kx_b + p1 * kdp_b
    ky_b = ky_b + p2 * kdp_b
    kz_b = kz_b + p3 * kdp_b
    # k and f.
    z_b = z_b + inv_r * kz_b
    inv_r_b = inv_r_b + z * kz_b
    inv_denom_b = inv_denom_b + (r * x + a * yy) * kx_b + (r * yy - a * x) * ky_b
    nkx_b, nky_b = kx_b * inv_denom, ky_b * inv_denom
    r_b = r_b + x * nkx_b + yy * nky_b
    x_b = x_b + r * nkx_b - a * nky_b
    yy_b = yy_b + a * nkx_b + r * nky_b
    a_b = a_b + yy * nkx_b - x * nky_b
    radius_b = radius_b + r * r_sq * inv_D * f_b
    r_b = r_b + radius * r_sq * inv_D * f_b
    r_sq_b = r_sq_b + radius * r * inv_D * f_b
    inv_D_b = inv_D_b + radius * r * r_sq * f_b
    # The shared divide 1/(D·(r² + a²)).
    inv_Dd_b = D * inv_denom_b + denom * inv_D_b
    prod_b = -inv_Dd * inv_Dd * inv_Dd_b
    D_b = inv_Dd * inv_denom_b + denom * prod_b
    denom_b = inv_Dd * inv_D_b + D * prod_b
    r_sq_b = r_sq_b + denom_b + 2.0 * r_sq * D_b
    a2_b = a2_b + denom_b + z * z * D_b
    z_b = z_b + 2.0 * a2 * z * D_b
    # r = r²·r⁻¹, r⁻¹ = rsqrt(r²), r² = ½(d + s), s⁻¹ = rsqrt(dd4).
    r_sq_b = r_sq_b + inv_r * r_b
    inv_r_b = inv_r_b + r_sq * r_b
    r_sq_b = r_sq_b - 0.5 * inv_r * inv_r * inv_r * inv_r_b
    d_b = d_b + 0.5 * r_sq_b
    dd4_b = 0.5 * inv_s * r_sq_b
    inv_s_b = inv_s_b + 0.5 * dd4 * r_sq_b
    dd4_b = dd4_b - 0.5 * inv_s * inv_s * inv_s * inv_s_b
    d_b = d_b + 2.0 * d * dd4_b
    a2_b = a2_b + 4.0 * z * z * dd4_b - d_b
    z_b = z_b + 8.0 * a2 * z * dd4_b
    x_b = x_b + 2.0 * x * d_b
    yy_b = yy_b + 2.0 * yy * d_b
    z_b = z_b + 2.0 * z * d_b
    a_b = a_b + 2.0 * a * a2_b
    zero = torch.zeros_like(x_b)
    return torch.stack([zero, x_b, yy_b, z_b, p0_b, p1_b, p2_b, p3_b]), radius_b, a_b


def ks_step_vjp(radius, a, y, lam, h0, h_min_frac, r_ref_scale, r_safe, active=None):
    """The VJP of one Kerr-Schild sweep step (_masked_step without its
    payload) along λ, written by hand in reverse mode, the lines of K2's
    non-payload step (csrc/kerr_ks_adjoint.cu). radius and a are [N]
    tiles; y and λ [8, N]. Returns (λ_next [8, N], (∂radius, ∂a) [N]) with
    the sweep's per-step conventions (_step_select): an inactive or
    non-finite step passes λ through, a step outside the trust region
    zeroes λ and its partials."""
    dt = y.dtype
    c = lambda v: torch.tensor(float(v), dtype=dt, device=y.device)
    if active is None:
        active = torch.ones(y.shape[1], dtype=torch.bool, device=y.device)
    # Forward: the step's stages.
    m = 0.5 * radius
    z_rp = m * m - a * a
    s_rp = torch.sqrt(torch.maximum(z_rp, c(1e-30)))
    r_plus = m + s_rp
    r_here = gm._ks_radius(a, y[1], y[2], y[3])
    g_raw = (r_here - r_plus) / c(r_ref_scale)
    h = h0 * torch.minimum(torch.maximum(g_raw, c(h_min_frac)), c(1.0))
    k1 = gm._rhs(radius, a, y)
    far = torch.zeros_like(active)
    if r_safe > 0.0:
        rho = torch.sqrt(y[1] * y[1] + y[2] * y[2] + y[3] * y[3])
        speed2 = k1[1] * k1[1] + k1[2] * k1[2] + k1[3] * k1[3]
        speed = torch.sqrt(torch.maximum(speed2, c(1e-30)))
        outward = (y[1] * k1[1] + y[2] * k1[2] + y[3] * k1[3]) > 0.0
        a1, a2 = 0.5 * (rho - r_safe), 0.125 * rho
        num, den = torch.minimum(a1, a2), torch.maximum(speed, c(1e-12))
        h_far = num / den
        far = outward & (rho > r_safe)
        h_base = h
        h = torch.where(far, torch.maximum(h, h_far), h)
    half_h = 0.5 * h
    tmp1 = y + half_h * k1
    k2 = gm._rhs(radius, a, tmp1)
    tmp2 = y + half_h * k2
    k3 = gm._rhs(radius, a, tmp2)
    tmp3 = y + h * k3
    k4 = gm._rhs(radius, a, tmp3)
    acc = k1 + 2.0 * k2 + 2.0 * k3

    # Backward: δ = h/6·(k1 + 2k2 + 2k3 + k4), y_new = y + δ.
    h6 = h / c(6.0)
    h6_b = (lam * (acc + k4)).sum(dim=0)
    acc_b = h6 * lam
    h_b = h6_b / c(6.0)
    y_b = lam.clone()
    t_b, r_b, a_b = _ks_rhs_vjp(radius, a, tmp3, acc_b)
    y_b = y_b + t_b
    h_b = h_b + (t_b * k3).sum(dim=0)
    k_b = 2.0 * acc_b + h * t_b
    t_b, rb, ab = _ks_rhs_vjp(radius, a, tmp2, k_b)
    r_b, a_b, y_b = r_b + rb, a_b + ab, y_b + t_b
    half_b = (t_b * k2).sum(dim=0)
    k_b = 2.0 * acc_b + half_h * t_b
    t_b, rb, ab = _ks_rhs_vjp(radius, a, tmp1, k_b)
    r_b, a_b, y_b = r_b + rb, a_b + ab, y_b + t_b
    half_b = half_b + (t_b * k1).sum(dim=0)
    k1_b = acc_b + half_h * t_b
    h_b = h_b + 0.5 * half_b
    # The step size: h = max(h0·clip(·), h_far) on a far-field lane.
    if r_safe > 0.0:
        w = _d_max(h_base, h_far)
        hf_b = torch.where(far, (1.0 - w) * h_b, 0.0)
        h_b = torch.where(far, w * h_b, h_b)
        num_b = hf_b / den
        den_b = -hf_b * h_far / den
        w = _d_min(a1, a2)
        rho_b = 0.5 * w * num_b + 0.125 * (1.0 - w) * num_b
        speed_b = den_b * _d_max(speed, torch.full_like(speed, 1e-12))
        speed2_b = speed_b / (2.0 * speed) * _d_max(speed2, torch.full_like(speed2, 1e-30))
        k1_b = k1_b.clone()
        for i in (1, 2, 3):
            k1_b[i] = k1_b[i] + 2.0 * k1[i] * speed2_b
            y_b[i] = y_b[i] + y[i] / rho * rho_b
    t_b, rb, ab = _ks_rhs_vjp(radius, a, y, k1_b)
    r_b, a_b, y_b = r_b + rb, a_b + ab, y_b + t_b
    g_b = h0 * h_b * _d_clip(g_raw, h_min_frac, 1.0)
    rh_b = g_b / c(r_ref_scale)
    rp_b = -rh_b
    xb, yb, zb, ab = _ks_radius_vjp(a, y[1], y[2], y[3], rh_b)
    y_b[1], y_b[2], y_b[3] = y_b[1] + xb, y_b[2] + yb, y_b[3] + zb
    a_b = a_b + ab
    # r₊ = m + sqrt(max(m² − a², 1e-30)), m = radius/2.
    z_b = rp_b / (2.0 * s_rp) * _d_max(z_rp, torch.full_like(z_rp, 1e-30))
    m_b = rp_b + 2.0 * m * z_b
    a_b = a_b - 2.0 * a * z_b
    r_b = r_b + 0.5 * m_b
    return _step_select(y, lam, y_b, (r_b, a_b), active)


def ks_march_bwd_plain(ckpt, ct_y, ct_ev, steps, grad_ok, has_ev, ev_kind0, radius, a, cfg):
    """The reverse sweep in plain torch. ckpt [S, 8, N]; ct_y [N, 8]; ct_ev
    [N, 12] (slot 0); steps, grad_ok, has_ev, ev_kind0 i32 [N]; radius and
    a 0-d. Returns (d_y0 [N, 8], d_radius [N], d_a [N]) per lane.

    Vectorized over lanes: each segment takes only the lanes with
    seg·K < steps that need an adjoint (grad_ok), re-forwards them, and
    each reverse step takes the VJP on the lanes active at that step."""
    n = ct_y.shape[0]
    dtype, device = ct_y.dtype, ct_y.device
    sc = lambda v: torch.as_tensor(v, dtype=dtype, device=device).detach()
    radius, a = sc(radius), sc(a)
    step_kw = dict(h0=float(sc(cfg.h0)), h_min_frac=float(sc(cfg.h_min_frac)),
                   r_ref_scale=float(sc(cfg.r_ref_scale)), r_safe=float(sc(cfg.r_safe)))
    discs = tuple(gm.DiscSpec(float(sc(d.inner)), float(sc(d.outer)), int(d.kind)) for d in cfg.discs)
    spheres = tuple(cfg.spheres)
    lam = ct_y.T.clone()  # [8, N]
    # The trust test of a step whose lane is inactive, applied once.
    lam = torch.where(_trusted(lam)[None], lam, 0.0)
    d_r = torch.zeros(n, dtype=dtype, device=device)
    d_a = torch.zeros(n, dtype=dtype, device=device)
    steps = steps.long()
    live = grad_ok != 0
    k = int(cfg.k_ckpt)
    for seg in reversed(range(ckpt.shape[0])):
        start = seg * k
        idx = torch.nonzero(live & (steps > start)).flatten()
        if idx.numel() == 0:
            continue
        k_eff = torch.clamp(steps[idx] - start, max=k)
        kind0 = ev_kind0[idx]
        r_t, a_t = radius.expand(idx.numel()), a.expand(idx.numel())
        # Re-forward, keeping the pre-step states.
        y = ckpt[seg][:, idx]
        states, acts = [], []
        for j in range(int(k_eff.max())):
            act = (j < k_eff) & torch.isfinite(y).all(dim=0)
            states.append(y)
            acts.append(act)
            y = _masked_step(r_t, a_t, y=y, active=act, **step_kw)
        # Reverse sweep: a hit lane's last step carries the payload's
        # cotangent (torch.func.vjp of the step with its payload); every
        # other step takes the hand-written VJP.
        for j in reversed(range(len(states))):
            sub = torch.nonzero(acts[j]).flatten()
            if sub.numel() == 0:
                continue
            stored = (has_ev[idx[sub]] != 0) & (steps[idx[sub]] - 1 == start + j)
            plain = sub[~stored]
            if plain.numel():
                lanes, m = idx[plain], plain.numel()
                lam[:, lanes], (d_r_l, d_a_l) = ks_step_vjp(radius.expand(m), a.expand(m), states[j][:, plain],
                                                            lam[:, lanes], **step_kw)
                d_r[lanes] += d_r_l
                d_a[lanes] += d_a_l
            sub = sub[stored]
            if sub.numel() == 0:
                continue
            lanes, m = idx[sub], sub.numel()
            step = functools.partial(
                _step_with_payload, discs, spheres, ev_kind0=kind0[sub],
                active=torch.ones(m, dtype=torch.bool, device=device), **step_kw,
            )
            _, vjp = torch.func.vjp(
                lambda r_, a_, y_: step(radius=r_, a=a_, y=y_), radius.expand(m), a.expand(m), states[j][:, sub]
            )
            d_r_l, d_a_l, lam_new = vjp((lam[:, lanes], ct_ev[lanes].T))
            trust = _trusted(lam_new, d_r_l, d_a_l)
            lam[:, lanes] = torch.where(trust[None], lam_new, 0.0)
            d_r[lanes] += torch.where(trust, d_r_l, 0.0)
            d_a[lanes] += torch.where(trust, d_a_l, 0.0)
    return lam.T.contiguous(), d_r, d_a


# ---------------------------------------------------------------------------
# The Boyer-Lindquist (Mino-time) step map and its reverse sweep. The march's
# per-lane E, L_z, Q are inputs of the step, so their partials come out per
# lane beside λ; Schwarzschild scenes take this route at a = 0.
# ---------------------------------------------------------------------------


def _bl_masked_step(radius, a, h0, h_min_frac, r_ref_scale, e, l_z, q, y, active):
    """One masked Mino-time RK4 advance, op for op the march's
    (geodesic_march._bl_plain_step, csrc/kerr_bl_common.cuh). r₊'s sqrt is
    guarded by max(·, 1e-30) (the march: 0), the same value for every
    sub-extremal spin and a finite derivative at a → M."""
    c = lambda v: torch.tensor(float(v), dtype=y.dtype, device=y.device)
    m = 0.5 * radius
    r_plus = m + torch.sqrt(torch.maximum(m * m - a * a, c(1e-30)))
    inv_e = 1.0 / torch.maximum(torch.abs(e), c(1e-12))
    rule = {"radius": radius, "a": a, "h0": c(h0), "r_ref": c(r_ref_scale), "h_min_frac": h_min_frac}
    y_new = y + gm._bl_rk4_delta(rule, e, l_z, q, inv_e, r_plus, y)
    return torch.where(active[None], y_new, y)


def _bl_disc_payload(discs, ev_kind0, radius, a, e, l_z, y, y_new):
    """The slot-0 payload of the BL step y → y_new, as the march stores it:
    the θ = π/2 crossing, the Kerr-Schild embedding of the crossing point,
    the interpolated BL momentum, the disc UV and the embedded segment; the
    division guard is |Δθ| ≥ 1e-12, as in the Kerr-Schild payload."""
    half_pi = y.new_tensor(math.pi / 2)
    d_prev = y[2] - half_pi
    d_new = y_new[2] - half_pi
    den_raw = d_prev - d_new
    ok = torch.abs(den_raw) >= 1e-12
    frac = torch.where(ok, d_prev, 0.0) / torch.where(ok, den_raw, 1.0)
    r_c = y[1] + frac * (y_new[1] - y[1])
    phi_c = y[3] + frac * (y_new[3] - y[3])
    sp, cp = torch.sin(phi_c), torch.cos(phi_c)
    px = r_c * cp - a * sp
    py = r_c * sp + a * cp
    u, v = _disc_uv(discs, ev_kind0, px, py)
    p_prev = gm._bl_momentum(radius, a, e, l_z, y)
    p_new = gm._bl_momentum(radius, a, e, l_z, y_new)
    p_interp = p_prev + frac[None] * (p_new - p_prev)
    seg = gm._bl_embed3(a, y_new) - gm._bl_embed3(a, y)
    return torch.cat([px[None], py[None], torch.zeros_like(px)[None], p_interp, u[None], v[None], seg])


def _bl_step_with_payload(discs, h0, h_min_frac, r_ref_scale, ev_kind0, radius, a, e, l_z, q, y, active):
    """y ↦ (y_new [8, N], payload [12, N]) of the BL march."""
    y_new = _bl_masked_step(radius, a, h0, h_min_frac, r_ref_scale, e, l_z, q, y, active)
    return y_new, _bl_disc_payload(discs, ev_kind0, radius, a, e, l_z, y, y_new)


def _bl_rhs_vjp(r_s, a, e, l_z, consts, r, st, ct, ob):
    """The VJP of the Mino-time right-hand side (kerr_bl_common.cuh
    mino_rhs, geodesic_march._bl_rhs) along the cotangents of its
    components 0, 3, 4 and 5 (ob0, ob3, ob4, ob5; components 1 and 2 are
    v_r and v_θ, whose cotangents pass straight to them): (r̄, sin θ̄,
    cos θ̄, r̄_s, ā, Ē, L̄_z, and the bars of the lane terms (a², a·L_z,
    a·E, carter, th_a, th_l))."""
    a2, a_lz, a_e, carter, th_a, th_l = consts
    ob0, ob3, ob4, ob5 = ob
    # Forward.
    delta = r * r - r_s * r + a2
    big_a = r * r + a2
    p_r = big_a * e - a_lz
    sin2 = st * st
    inv_ds = 1.0 / (delta * sin2)
    inv_delta = inv_ds * sin2
    inv_sin2 = inv_ds * delta
    b0 = big_a * inv_delta
    w = l_z - a_e * sin2
    ai = a * inv_delta
    inv_st3 = st * inv_sin2 * inv_sin2
    four_re = 4.0 * r * e
    # Backward.
    b0_b = ob0 * p_r
    p_r_b = ob0 * b0 + ob3 * ai
    a_b = ob0 * w
    w_b = ob0 * a
    ai_b = ob3 * p_r
    a_b = a_b + ai_b * inv_delta
    inv_delta_b = ai_b * a + b0_b * big_a
    big_a_b = b0_b * inv_delta
    l_z_b = w_b + ob3 * inv_sin2
    inv_sin2_b = ob3 * l_z
    a_e_b = -ob3 - w_b * sin2
    sin2_b = -w_b * a_e
    x4 = 0.5 * ob4
    p_r_b = p_r_b + x4 * four_re
    four_re_b = x4 * p_r
    r_b = 4.0 * e * four_re_b - 2.0 * x4 * carter
    e_b = 4.0 * r * four_re_b
    r_s_b = x4 * carter
    carter_b = -x4 * (2.0 * r - r_s)
    x5 = 0.5 * ob5
    th_a_b = x5 * ct * st
    th_l_b = x5 * ct * inv_st3
    ct_b = x5 * (th_a * st + th_l * inv_st3)
    st_b = x5 * th_a * ct
    inv_st3_b = x5 * th_l * ct
    st_b = st_b + inv_st3_b * inv_sin2 * inv_sin2
    inv_sin2_b = inv_sin2_b + 2.0 * inv_st3_b * st * inv_sin2
    inv_ds_b = inv_sin2_b * delta + inv_delta_b * sin2
    delta_b = inv_sin2_b * inv_ds
    sin2_b = sin2_b + inv_delta_b * inv_ds
    prod_b = -inv_ds * inv_ds * inv_ds_b
    delta_b = delta_b + prod_b * sin2
    sin2_b = sin2_b + prod_b * delta
    st_b = st_b + 2.0 * st * sin2_b
    big_a_b = big_a_b + p_r_b * e
    e_b = e_b + p_r_b * big_a
    a_lz_b = -p_r_b
    r_b = r_b + 2.0 * r * big_a_b + delta_b * (2.0 * r - r_s)
    r_s_b = r_s_b - delta_b * r
    a2_b = big_a_b + delta_b
    return r_b, st_b, ct_b, r_s_b, a_b, e_b, l_z_b, (a2_b, a_lz_b, a_e_b, carter_b, th_a_b, th_l_b)


def bl_step_vjp(radius, a, e, l_z, q, y, lam, h0, h_min_frac, r_ref_scale, active=None):
    """The VJP of one Boyer-Lindquist sweep step (_bl_masked_step without
    its payload) along λ, written by hand in reverse mode, the lines of
    K4's non-payload step (csrc/kerr_bl_adjoint.cu). radius, a, E, L_z, Q
    are [N]; y and λ [8, N]. t, φ and components 6–7 enter neither the
    right-hand side nor the step size, so their λ passes through. Returns
    (λ_next [8, N], (∂radius, ∂a, ∂E, ∂L_z, ∂Q) [N]) with the sweep's
    per-step conventions (_step_select)."""
    dt = y.dtype
    c = lambda v: torch.tensor(float(v), dtype=dt, device=y.device)
    if active is None:
        active = torch.ones(y.shape[1], dtype=torch.bool, device=y.device)
    # Forward.
    m = 0.5 * radius
    z_rp = m * m - a * a
    s_rp = torch.sqrt(torch.maximum(z_rp, c(1e-30)))
    r_plus = m + s_rp
    e_abs = torch.maximum(torch.abs(e), c(1e-12))
    inv_e = 1.0 / e_abs
    a_e = a * e
    lae = l_z - a_e
    consts = (a * a, a * l_z, a_e, lae * lae + q, -2.0 * a * a * e * e, 2.0 * l_z * l_z)
    r0 = y[1]
    u = r0 / c(r_ref_scale)
    g_raw = (r0 - r_plus) / c(r_ref_scale)
    gap = torch.minimum(torch.maximum(g_raw, c(h_min_frac)), c(1.0))
    num = c(h0) * inv_e
    den = 1.0 + u * u
    h1 = num / den
    h = h1 * gap
    half_h = 0.5 * h
    rhs = lambda s: gm._bl_rhs(radius, a, e, l_z, q, s)
    stages, ks = [y], []
    for coef in (half_h, half_h, h, None):
        s_ = stages[-1]
        ks.append(rhs(s_))
        if coef is not None:
            stages.append(y + coef * ks[-1])
    k1, k2, k3, k4 = ks
    acc = k1 + 2.0 * k2 + 2.0 * k3

    # Backward.
    h6 = h / c(6.0)
    h6_b = (lam[0:6] * (acc[0:6] + k4[0:6])).sum(dim=0)
    acc_b = h6 * lam
    h_b = h6_b / c(6.0)
    half_b = torch.zeros_like(h_b)
    y_b = lam.clone()
    r_b = torch.zeros_like(h_b)
    a_b, e_b, l_z_b = torch.zeros_like(h_b), torch.zeros_like(h_b), torch.zeros_like(h_b)
    c_b = [torch.zeros_like(h_b) for _ in range(6)]
    k_b = acc_b
    for j in (3, 2, 1, 0):
        s_ = stages[j]
        st, ct = torch.sin(s_[2]), torch.cos(s_[2])
        rb_, st_b, ct_b, rs_b, ab_, eb_, lzb_, cb_ = _bl_rhs_vjp(
            radius, a, e, l_z, consts, s_[1], st, ct, (k_b[0], k_b[3], k_b[4], k_b[5]))
        t_b = torch.zeros_like(y_b)
        t_b[1] = rb_
        t_b[2] = st_b * ct - ct_b * st
        t_b[4] = k_b[1]
        t_b[5] = k_b[2]
        r_b, a_b, e_b, l_z_b = r_b + rs_b, a_b + ab_, e_b + eb_, l_z_b + lzb_
        c_b = [u_ + v_ for u_, v_ in zip(c_b, cb_)]
        y_b = y_b + t_b
        if j == 0:
            break
        # stage j's input: y + coef·k_j (coef h for stage 4, h/2 before).
        k_prev = ks[j - 1]
        if j == 3:
            h_b = h_b + (t_b * k_prev).sum(dim=0)
            k_b = 2.0 * acc_b + h * t_b
        else:
            half_b = half_b + (t_b * k_prev).sum(dim=0)
            k_b = (2.0 * acc_b if j == 2 else acc_b) + half_h * t_b
    h_b = h_b + 0.5 * half_b
    # h = (h0/|E|)/(1 + u²)·gap.
    h1_b = h_b * gap
    gap_b = h_b * h1
    num_b = h1_b / den
    den_b = -h1_b * h1 / den
    u_b = 2.0 * u * den_b
    inv_e_b = c(h0) * num_b
    g_b = gap_b * _d_clip(g_raw, h_min_frac, 1.0)
    y_b[1] = y_b[1] + (u_b + g_b) / c(r_ref_scale)
    rp_b = -g_b / c(r_ref_scale)
    ea_b = -inv_e_b * inv_e * inv_e
    e_b = e_b + ea_b * torch.sign(e) * _d_max(torch.abs(e), torch.full_like(e, 1e-12))
    # r₊.
    z_b = rp_b / (2.0 * s_rp) * _d_max(z_rp, torch.full_like(z_rp, 1e-30))
    r_b = r_b + 0.5 * (rp_b + 2.0 * m * z_b)
    a_b = a_b - 2.0 * a * z_b
    # The lane terms: a², a·L_z, a·E, (L_z − a·E)² + Q, −2a²E², 2L_z².
    a2_b, a_lz_b, a_e_b, carter_b, th_a_b, th_l_b = c_b
    lae_b = 2.0 * lae * carter_b
    q_b = carter_b
    l_z_b = l_z_b + lae_b + a * a_lz_b + 4.0 * l_z * th_l_b
    a_e_b = a_e_b - lae_b
    a_b = a_b + 2.0 * a * a2_b + l_z * a_lz_b + e * a_e_b - 4.0 * a * e * e * th_a_b
    e_b = e_b + a * a_e_b - 4.0 * a * a * e * th_a_b
    return _step_select(y[0:6], lam, y_b, (r_b, a_b, e_b, l_z_b, q_b), active)


def bl_march_bwd_plain(ckpt, ct_y, ct_ev, steps, grad_ok, has_ev, ev_kind0, radius, a, e, l_z, q, cfg):
    """The BL reverse sweep in plain torch; arguments as
    `ks_march_bwd_plain` plus the march's per-lane E, L_z, Q [N]. Returns
    (d_y0 [N, 8], d_e [N], d_l_z [N], d_q [N], d_radius [N], d_a [N]) per
    lane. A lane is active at a step while seg·K + k < steps and its state
    (components 0..5) is finite."""
    n = ct_y.shape[0]
    dtype, device = ct_y.dtype, ct_y.device
    sc = lambda v: torch.as_tensor(v, dtype=dtype, device=device).detach()
    radius, a = sc(radius), sc(a)
    e, l_z, q = sc(e), sc(l_z), sc(q)
    step_kw = dict(h0=float(sc(cfg.h0)), h_min_frac=float(sc(cfg.h_min_frac)),
                   r_ref_scale=float(sc(cfg.r_ref_scale)))
    discs = tuple(gm.DiscSpec(float(sc(d.inner)), float(sc(d.outer)), int(d.kind)) for d in cfg.discs)
    lam = ct_y.T.clone()  # [8, N]
    lam = torch.where(_trusted(lam)[None], lam, 0.0)
    zeros = lambda: torch.zeros(n, dtype=dtype, device=device)
    d_e, d_lz, d_q, d_r, d_a = zeros(), zeros(), zeros(), zeros(), zeros()
    steps = steps.long()
    live = grad_ok != 0
    k = int(cfg.k_ckpt)
    for seg in reversed(range(ckpt.shape[0])):
        start = seg * k
        idx = torch.nonzero(live & (steps > start)).flatten()
        if idx.numel() == 0:
            continue
        k_eff = torch.clamp(steps[idx] - start, max=k)
        kind0 = ev_kind0[idx]
        r_t, a_t = radius.expand(idx.numel()), a.expand(idx.numel())
        e_i, lz_i, q_i = e[idx], l_z[idx], q[idx]
        # Re-forward, keeping the pre-step states.
        y = ckpt[seg][:, idx]
        states, acts = [], []
        for j in range(int(k_eff.max())):
            act = (j < k_eff) & torch.isfinite(y[0:6]).all(dim=0)
            states.append(y)
            acts.append(act)
            y = _bl_masked_step(r_t, a_t, y=y, active=act, e=e_i, l_z=lz_i, q=q_i, **step_kw)
        # Reverse sweep, as the Kerr-Schild one.
        for j in reversed(range(len(states))):
            sub = torch.nonzero(acts[j]).flatten()
            if sub.numel() == 0:
                continue
            stored = (has_ev[idx[sub]] != 0) & (steps[idx[sub]] - 1 == start + j)
            plain = sub[~stored]
            if plain.numel():
                lanes, m = idx[plain], plain.numel()
                lam[:, lanes], parts = bl_step_vjp(radius.expand(m), a.expand(m), e[lanes], l_z[lanes], q[lanes],
                                                   states[j][:, plain], lam[:, lanes], **step_kw)
                for acc, part in zip((d_r, d_a, d_e, d_lz, d_q), parts):
                    acc[lanes] += part
            sub = sub[stored]
            if sub.numel() == 0:
                continue
            lanes, m = idx[sub], sub.numel()
            step = functools.partial(
                _bl_step_with_payload, discs, ev_kind0=kind0[sub],
                active=torch.ones(m, dtype=torch.bool, device=device), **step_kw,
            )
            _, vjp = torch.func.vjp(
                lambda r_, a_, e_, lz_, q_, y_: step(radius=r_, a=a_, e=e_, l_z=lz_, q=q_, y=y_),
                radius.expand(m), a.expand(m), e[lanes], l_z[lanes], q[lanes], states[j][:, sub],
            )
            d_r_l, d_a_l, d_e_l, d_lz_l, d_q_l, lam_new = vjp((lam[:, lanes], ct_ev[lanes].T))
            trust = _trusted(lam_new, d_r_l, d_a_l, d_e_l, d_lz_l, d_q_l)
            lam[:, lanes] = torch.where(trust[None], lam_new, 0.0)
            for acc, part in ((d_r, d_r_l), (d_a, d_a_l), (d_e, d_e_l), (d_lz, d_lz_l), (d_q, d_q_l)):
                acc[lanes] += torch.where(trust, part, 0.0)
    return lam.T.contiguous(), d_e, d_lz, d_q, d_r, d_a


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

# The two sweeps: K2 (Kerr-Schild) and K4 (Boyer-Lindquist). Entry points
# take (ckpt, ct_y, ct_ev, steps, grad_ok, has_ev, ev_kind0[, e, l_z, q], n,
# d_y0[, d_e, d_l_z, d_q], d_radius, d_a, scratch, params, discs, n_discs,
# [spheres, n_spheres,] ints, stream) and return the CUDA error code of the
# launch; K2 alone takes spheres.
_KERNELS = {
    False: ("kerr_ks_adjoint", "kerr_ks_adjoint.cu"),
    True: ("kerr_bl_adjoint", "kerr_bl_adjoint.cu"),
}
_bound: dict = {}


def _entry(bl, dtype):
    """A sweep's C entry point for `dtype`, built on first use."""
    fn = _bound.get((bl, dtype))
    if fn is None:
        from gr_raytracer_tpu_torch.ops import cuda_build

        stem, source = _KERNELS[bl]
        lib = cuda_build.load(source)
        fn = getattr(lib, f"{stem}_f32" if dtype == torch.float32 else f"{stem}_f64")
        p = ctypes.c_void_p
        n_lane = 3 if bl else 0  # e, l_z, q in; d_e, d_l_z, d_q out
        rows = [ctypes.POINTER(ctypes.c_double), ctypes.c_int]
        fn.argtypes = [p] * (7 + n_lane) + [ctypes.c_int64] + [p] * (4 + n_lane) + [
            ctypes.POINTER(ctypes.c_double), *rows, *([] if bl else rows), ctypes.POINTER(ctypes.c_int), p,
        ]
        fn.restype = ctypes.c_int
        _bound[(bl, dtype)] = fn
    return fn


def _bwd_cuda(ckpt, ct_y, ct_ev, steps, grad_ok, has_ev, ev_kind0, radius, a, cfg, consts=()):
    """Launch K2 (consts empty) or K4 (consts = (e, l_z, q)); returns
    (d_y0, [d_e, d_l_z, d_q,] d_radius, d_a) per lane."""
    global launches, bl_launches
    bl = bool(consts)
    n = ct_y.shape[0]
    dev, dtype = ct_y.device, ct_y.dtype
    ints32 = (steps, grad_ok, has_ev, ev_kind0)
    floats = (ckpt, ct_ev) + tuple(consts)
    if any(t.dtype != dtype for t in floats) or any(t.dtype != torch.int32 for t in ints32):
        raise TypeError("the reverse sweep takes float ckpt/cotangents of one dtype and i32 lane data")
    if ckpt.dim() != 3 or ckpt.shape[1:] != (8, n) or ct_y.shape != (n, 8) or ct_ev.shape != (n, gm.EVENT_WIDTH):
        raise ValueError("the reverse sweep takes ckpt [S, 8, N], ct_y [N, 8], ct_ev [N, 12]")
    if any(t.shape != (n,) for t in ints32 + tuple(consts)):
        raise ValueError("the reverse sweep takes [N] lane data")
    tensors = (ckpt, ct_y, ct_ev) + ints32 + tuple(consts)
    if any(t.device != dev or not t.is_contiguous() for t in tensors):
        raise ValueError("the reverse sweep takes contiguous tensors on one device")
    if len(cfg.discs) > gm.MAX_DISCS or len(cfg.spheres) > gm.MAX_SPHERES:
        raise NotImplementedError(f"the reverse sweep takes up to {gm.MAX_DISCS} discs and "
                                  f"{gm.MAX_SPHERES} spheres")
    if bl and (cfg.spheres or not cfg.discs):
        raise NotImplementedError("the BL reverse sweep takes 1 or more discs and no sphere")
    if not (cfg.discs or cfg.spheres):
        raise ValueError("the reverse sweep needs at least one disc or sphere")
    d_y0 = torch.empty_like(ct_y)
    partials = [torch.empty(n, dtype=dtype, device=dev) for _ in range(5 if bl else 2)]
    # Pre-step states of the segment being swept, [K, 8, N], lanes fastest.
    scratch = torch.empty((cfg.k_ckpt, 8, n), dtype=dtype, device=dev)
    vals = (radius, a, cfg.h0, cfg.h_min_frac, cfg.r_ref_scale) + (() if bl else (cfg.r_safe,))
    params = (ctypes.c_double * len(vals))(*[float(v) for v in vals])
    tables = (gm.disc_rows(cfg.discs), len(cfg.discs))
    if not bl:
        tables += (gm.sphere_rows(cfg.spheres), len(cfg.spheres))
    ints = (ctypes.c_int * 2)(int(ckpt.shape[0]), int(cfg.k_ckpt))
    fn = _entry(bl, dtype)
    timer = bl_launch_timer if bl else launch_timer
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        if timer is not None:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
        err = fn(
            *(t.data_ptr() for t in (ckpt, ct_y, ct_ev) + ints32 + tuple(consts)), n,
            d_y0.data_ptr(), *(t.data_ptr() for t in partials), scratch.data_ptr(), params, *tables,
            ints, stream.cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"{_KERNELS[bl][0]} kernel launch failed: CUDA error {err}")
        if bl:
            bl_launches += 1
        else:
            launches += 1
        if timer is not None:
            end.record(stream)
            timer.append((start, end))
    return (d_y0, *partials)


def ks_march_bwd(ckpt, ct_y, ct_ev, steps, grad_ok, has_ev, ev_kind0, radius, a, cfg):
    """The reverse sweep: the CUDA kernel for tensors on the card,
    `ks_march_bwd_plain` for tensors on the CPU. Same arguments and per-lane
    results as `ks_march_bwd_plain`."""
    if ct_y.device.type == "cpu":
        return ks_march_bwd_plain(ckpt, ct_y, ct_ev, steps, grad_ok, has_ev, ev_kind0, radius, a, cfg)
    if ct_y.device.type != "cuda":
        raise ValueError(f"unsupported device {ct_y.device}")
    return _bwd_cuda(ckpt, ct_y, ct_ev, steps, grad_ok, has_ev, ev_kind0, radius, a, cfg)


def sweep_lanes(stop, ev_kind, ev_count):
    """(grad_ok, has_ev, ev_kind0), i32 [N]. The adjoint runs only where a
    cotangent can be nonzero: escaped lanes (the sky shading reads y_f)
    and event lanes (the disc shading reads the slot-0 payload). Captured,
    NaN and budget lanes shade as constant black."""
    grad_ok = ((stop == integ.CELESTIAL) | (ev_count > 0)).to(torch.int32)
    has_ev = ((ev_count > 0) & (ev_kind[:, 0] >= 0)).to(torch.int32)
    ev_kind0 = torch.clamp(ev_kind[:, 0], min=0).to(torch.int32).contiguous()
    return grad_ok, has_ev, ev_kind0


class _KSMarchDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, radius, a, horizon_eps, max_radius, y0, cfg):
        host = lambda v: float(torch.as_tensor(v).detach())
        out = gm.kerr_rk4_march(
            host(radius), host(a), host(horizon_eps), y0.contiguous(), h0=cfg.h0,
            max_steps=cfg.max_steps, max_radius=float(max_radius), discs=cfg.discs, spheres=cfg.spheres,
            h_min_frac=cfg.h_min_frac, r_ref_scale=cfg.r_ref_scale, r_safe=cfg.r_safe,
            opaque_stop=True, ckpt_every=cfg.k_ckpt,
        )
        y_f, stop, steps, ev_kind, ev_data, ev_count, ev_ovf, ckpt = out
        ctx.save_for_backward(radius, a, ckpt, stop, steps, ev_kind, ev_count)
        ctx.cfg = cfg
        ctx.mark_non_differentiable(stop, steps, ev_kind, ev_count, ev_ovf)
        return y_f, ev_data, stop, steps, ev_kind, ev_count, ev_ovf

    @staticmethod
    def backward(ctx, ct_yf, ct_ev, *_):
        # Cotangents of event slots ≥ 1 are structurally zero under the
        # opaque stop (only slot 0 is shaded).
        radius, a, ckpt, stop, steps, ev_kind, ev_count = ctx.saved_tensors
        grad_ok, has_ev, ev_kind0 = sweep_lanes(stop, ev_kind, ev_count)
        d_y0, d_r, d_a = ks_march_bwd(
            ckpt, ct_yf.contiguous(), ct_ev[:, 0, :].contiguous(), steps, grad_ok, has_ev,
            ev_kind0, radius, a, ctx.cfg,
        )
        d_radius = torch.sum(d_r).to(radius.dtype).reshape(radius.shape)
        d_a_sum = torch.sum(d_a).to(a.dtype).reshape(a.shape)
        return d_radius, d_a_sum, None, None, d_y0, None


def make_ks_march_diff(
    *, h0, max_steps, discs=(), spheres=(), r_safe, h_min_frac=0.01, r_ref_scale=10.0, k_ckpt=K_CKPT,
):
    """The differentiable Kerr-Schild march for a static configuration.

    Returns fn(radius, a, horizon_eps, max_radius, y0) → (y_f [N, 8],
    ev_data [N, K, 12], stop, steps, ev_kind, ev_count, ev_ovf), with
    radius and a 0-d tensors. Gradients flow from y_f and ev_data[:, 0] to
    radius, a and y0; horizon_eps and max_radius only move discrete stop
    decisions and get none. The march runs with the opaque stop; thin discs
    (DiscSpec) and spheres (SphereSpec) both record their slot-0 payload at
    a lane's last step, and the sweep takes the one of the recorded kind."""
    if not all(isinstance(s, gm.SphereSpec) for s in spheres):
        raise TypeError("spheres must be SphereSpec")
    if not discs and not spheres:
        raise ValueError("the differentiable march needs at least one disc or sphere")
    cfg = SweepConfig(
        float(h0), int(max_steps), tuple(discs), float(r_safe), float(h_min_frac),
        float(r_ref_scale), int(k_ckpt), tuple(spheres),
    )

    def march(radius, a, horizon_eps, max_radius, y0):
        return _KSMarchDiff.apply(radius, a, horizon_eps, max_radius, y0, cfg)

    return march


def bl_march_bwd(ckpt, ct_y, ct_ev, steps, grad_ok, has_ev, ev_kind0, radius, a, e, l_z, q, cfg):
    """The BL reverse sweep: the CUDA kernel for tensors on the card,
    `bl_march_bwd_plain` for tensors on the CPU. Same arguments and per-lane
    results as `bl_march_bwd_plain`."""
    if ct_y.device.type == "cpu":
        return bl_march_bwd_plain(ckpt, ct_y, ct_ev, steps, grad_ok, has_ev, ev_kind0, radius, a,
                                  e, l_z, q, cfg)
    if ct_y.device.type != "cuda":
        raise ValueError(f"unsupported device {ct_y.device}")
    return _bwd_cuda(ckpt, ct_y, ct_ev, steps, grad_ok, has_ev, ev_kind0, radius, a, cfg,
                     consts=(e, l_z, q))


class _BLMarchDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, radius, a, e, l_z, q, y0, horizon_eps, max_radius, cfg):
        host = lambda v: float(torch.as_tensor(v).detach())
        e, l_z, q = (v.contiguous() for v in (e, l_z, q))
        out = gm.kerr_bl_rk4_march(
            host(radius), host(a), host(horizon_eps), y0.contiguous(), e, l_z, q, h0=cfg.h0,
            max_steps=cfg.max_steps, max_radius=float(max_radius), discs=cfg.discs,
            h_min_frac=cfg.h_min_frac, r_ref_scale=cfg.r_ref_scale, opaque_stop=True,
            ckpt_every=cfg.k_ckpt,
        )
        y_f, stop, steps, ev_kind, ev_data, ev_count, ev_ovf, ckpt = out
        ctx.save_for_backward(radius, a, e, l_z, q, ckpt, stop, steps, ev_kind, ev_count)
        ctx.cfg = cfg
        ctx.mark_non_differentiable(stop, steps, ev_kind, ev_count, ev_ovf)
        return y_f, ev_data, stop, steps, ev_kind, ev_count, ev_ovf

    @staticmethod
    def backward(ctx, ct_yf, ct_ev, *_):
        radius, a, e, l_z, q, ckpt, stop, steps, ev_kind, ev_count = ctx.saved_tensors
        grad_ok, has_ev, ev_kind0 = sweep_lanes(stop, ev_kind, ev_count)
        d_y0, d_e, d_lz, d_q, d_r, d_a = bl_march_bwd(
            ckpt, ct_yf.contiguous(), ct_ev[:, 0, :].contiguous(), steps, grad_ok, has_ev,
            ev_kind0, radius, a, e, l_z, q, ctx.cfg,
        )
        d_radius = torch.sum(d_r).to(radius.dtype).reshape(radius.shape)
        d_a_sum = torch.sum(d_a).to(a.dtype).reshape(a.shape)
        return d_radius, d_a_sum, d_e, d_lz, d_q, d_y0, None, None, None


def make_bl_march_diff(*, h0, max_steps, discs, h_min_frac=0.02, r_ref_scale=10.0, k_ckpt=K_CKPT):
    """The differentiable Boyer-Lindquist (Mino-time) march for a static
    configuration.

    Returns fn(radius, a, horizon_eps, max_radius, e, l_z, q, y0) → (y_f
    [N, 8], ev_data [N, K, 12], stop, steps, ev_kind, ev_count, ev_ovf),
    with gradients from y_f and ev_data[:, 0] to radius, a (0-d), the
    per-lane E, L_z, Q and y0; horizon_eps and max_radius get none. The
    march runs with the opaque stop. Scope as the Kerr-Schild one: opaque
    thin discs (slot-0 shading)."""
    if not discs:
        raise ValueError("the differentiable march needs at least one disc")
    cfg = SweepConfig(
        float(h0), int(max_steps), tuple(discs), 0.0, float(h_min_frac), float(r_ref_scale),
        int(k_ckpt),
    )

    def march(radius, a, horizon_eps, max_radius, e, l_z, q, y0):
        return _BLMarchDiff.apply(radius, a, e, l_z, q, y0, horizon_eps, max_radius, cfg)

    return march
