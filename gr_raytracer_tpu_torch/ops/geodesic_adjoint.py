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
`bl_march_bwd_plain`) with torch.func.vjp of the plain step.

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
        # Reverse sweep.
        for j in reversed(range(len(states))):
            sub = torch.nonzero(acts[j]).flatten()
            if sub.numel() == 0:
                continue
            lanes = idx[sub]
            m = sub.numel()
            stored = (has_ev[lanes] != 0) & (steps[lanes] - 1 == start + j)
            ct_p = torch.where(stored[None], ct_ev[lanes].T, 0.0)
            step = functools.partial(
                _step_with_payload, discs, spheres, ev_kind0=kind0[sub],
                active=torch.ones(m, dtype=torch.bool, device=device), **step_kw,
            )
            _, vjp = torch.func.vjp(
                lambda r_, a_, y_: step(radius=r_, a=a_, y=y_), radius.expand(m), a.expand(m), states[j][:, sub]
            )
            d_r_l, d_a_l, lam_new = vjp((lam[:, lanes], ct_p))
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
        # Reverse sweep.
        for j in reversed(range(len(states))):
            sub = torch.nonzero(acts[j]).flatten()
            if sub.numel() == 0:
                continue
            lanes = idx[sub]
            m = sub.numel()
            stored = (has_ev[lanes] != 0) & (steps[lanes] - 1 == start + j)
            ct_p = torch.where(stored[None], ct_ev[lanes].T, 0.0)
            step = functools.partial(
                _bl_step_with_payload, discs, ev_kind0=kind0[sub],
                active=torch.ones(m, dtype=torch.bool, device=device), **step_kw,
            )
            _, vjp = torch.func.vjp(
                lambda r_, a_, e_, lz_, q_, y_: step(radius=r_, a=a_, e=e_, l_z=lz_, q=q_, y=y_),
                radius.expand(m), a.expand(m), e[lanes], l_z[lanes], q[lanes], states[j][:, sub],
            )
            d_r_l, d_a_l, d_e_l, d_lz_l, d_q_l, lam_new = vjp((lam[:, lanes], ct_p))
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
