"""Fixed-step RK4 geodesic marches with in-loop disc, sphere and volume
events (counterpart of gr_raytracer_tpu/ops/geodesic_pallas.py::
kerr_rk4_march and ::kerr_bl_rk4_march).

`kerr_rk4_march` marches Kerr-Schild states (position | covariant
momentum); `kerr_bl_rk4_march` marches Boyer-Lindquist states in Mino time
with per-ray conserved (E, L_z, Q). For tensors on the card each launches
its hand-written CUDA kernel (csrc/kerr_rk4_march.cu, csrc/kerr_bl_march.cu);
for tensors on the CPU it runs its plain torch version (`march_plain`,
`march_bl_plain`), vectorized over lanes with masks. A kernel and its plain
version share the arithmetic line for line: see the kernels' headers for
their design and what bounds them.

Kerr-Schild step size: h = h0 · clip((r − r₊)/r_ref, h_min_frac, 1), with
the far-field lever (half-gap steps for outward lanes beyond r_safe).
Events go into a K-slot per-lane buffer of 12-wide payloads (point3 |
p_contra4 | uv2 | seg_dir3), stored within a step in this order:
equatorial thin-disc crossings; sphere surface crossings of the step's
Cartesian chord (the endpoint radii straddle the surface; local spherical
UV); crossings of a z-axis volumetric disc's bounding volume (its inner
and outer cylinders clipped to ±cap_h), found by six candidate roots on
the chord, where the raymarch then starts (ops/volumetric_march.py).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from gr_raytracer_tpu_torch.rendering import integrator as integ

MAX_EVENTS = 8
EVENT_WIDTH = 12
MAX_DISCS = 8  # kMaxDiscs in the CUDA source
MAX_SPHERES = 8  # kMaxSpheres in csrc/sphere_events.cuh
MAX_VOLS = 8  # kMaxVols in csrc/vol_events.cuh
MIN_INTERSECTION_T = 1e-9  # objects/volumetric_disc.py
# Lanes are re-gathered every this many iterations of the plain march on the
# CPU, so finished lanes stop costing work (_march_lanes).
_COMPACT_EVERY = 32

# Launches of the CUDA kernels K1 and K3 (the plain versions do not count).
launches = 0
bl_launches = 0
# When set to a list, each launch of K1 (K3) appends its (start, end) CUDA
# events.
launch_timer = None
bl_launch_timer = None


class DiscSpec(NamedTuple):
    """Static per-disc radial bounds for in-kernel crossing detection."""

    inner: float
    outer: float
    kind: int  # object index in the scene


class SphereSpec(NamedTuple):
    """A sphere for in-kernel surface-crossing detection: radius and
    Cartesian center."""

    radius: float
    cx: float
    cy: float
    cz: float
    kind: int  # object index in the scene


class VolSpec(NamedTuple):
    """Bounding volume of a z-axis volumetric disc: inner and outer
    cylinders clipped to the caps at ±cap_h."""

    inner: float
    outer: float
    cap_h: float
    kind: int  # object index in the scene


# ---------------------------------------------------------------------------
# Plain torch version. Per-lane variables are [N] tensors; states are [8, N]
# (component-major, as in the TPU kernel) so every line reads like the
# kernel's. Every division has a tensor divisor (see _plain_step).
# ---------------------------------------------------------------------------


def _ks_radius(a, x, y, z):
    rho_sq = x * x + y * y + z * z
    d = rho_sq - a * a
    s = torch.sqrt(d * d + 4.0 * a * a * z * z)
    return torch.sqrt(0.5 * (d + s))


def _ks_scalars(radius, a, x, y, z):
    """f and k (covariant) for Kerr-Schild, componentwise over lanes."""
    rho_sq = x * x + y * y + z * z
    d = rho_sq - a * a
    r_sq = 0.5 * (d + torch.sqrt(d * d + 4.0 * a * a * z * z))
    r = torch.sqrt(r_sq)
    f = (r * r_sq * radius) / (r_sq * r_sq + a * a * z * z)
    denom = r_sq + a * a
    kx = (r * x + a * y) / denom
    ky = (r * y - a * x) / denom
    kz = z / torch.clamp(r, min=1e-30)
    return f, kx, ky, kz, r


def _rhs(radius, a, y):
    """dy/dλ for y = [x4 | p_cov4] as [8, N], with the hand-derived ∂H/∂x
    (ṗ_μ = −½ ∂_μ g^{αβ} p_α p_β written out along the Kerr-Schild chain)."""
    x, yy, z = y[1], y[2], y[3]
    p = y[4:8]
    a2 = a * a
    rho_sq = x * x + yy * yy + z * z
    d = rho_sq - a2
    dd4 = d * d + 4.0 * a2 * z * z
    inv_s = torch.rsqrt(dd4)
    s = dd4 * inv_s
    r_sq = 0.5 * (d + s)
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

    k_dot_p = -p[0] + kx * p[1] + ky * p[2] + kz * p[3]
    xdot_t = -p[0] + f * k_dot_p
    xdot_x = p[1] - f * kx * k_dot_p
    xdot_y = p[2] - f * ky * k_dot_p
    xdot_z = p[3] - f * kz * k_dot_p

    # ∂r²/∂xi = xi(1 + d/s) + 2a²z δiz/s ;  ∂r = ∂r²/(2r)
    common = 1.0 + d * inv_s
    dr2_x = x * common
    dr2_y = yy * common
    dr2_z = z * common + 2.0 * a2 * z * inv_s
    half_inv_r = 0.5 * inv_r
    dr_x = dr2_x * half_inv_r
    dr_y = dr2_y * half_inv_r
    dr_z = dr2_z * half_inv_r

    # ∂f/∂xi = R r² [(3D − 4r⁴) ∂r_i − 2a²z r δiz] / D²; 3D − 4r⁴ = 3a²z² − r⁴
    cf = radius * r_sq * inv_D * inv_D
    t1 = 3.0 * a2 * z * z - r_sq * r_sq
    df_x = cf * t1 * dr_x
    df_y = cf * t1 * dr_y
    df_z = cf * (t1 * dr_z - 2.0 * a2 * z * r)

    # ∂k/∂xi via the quotient rule on (r·x+a·y)/(r²+a²) etc.
    dkx_x = (dr_x * x + r - kx * dr2_x) * inv_denom
    dkx_y = (dr_y * x + a - kx * dr2_y) * inv_denom
    dkx_z = (dr_z * x - kx * dr2_z) * inv_denom
    dky_x = (dr_x * yy - a - ky * dr2_x) * inv_denom
    dky_y = (dr_y * yy + r - ky * dr2_y) * inv_denom
    dky_z = (dr_z * yy - ky * dr2_z) * inv_denom
    zir2 = z * inv_r * inv_r
    dkz_x = -zir2 * dr_x
    dkz_y = -zir2 * dr_y
    dkz_z = inv_r - zir2 * dr_z

    dkp_x = p[1] * dkx_x + p[2] * dky_x + p[3] * dkz_x
    dkp_y = p[1] * dkx_y + p[2] * dky_y + p[3] * dkz_y
    dkp_z = p[1] * dkx_z + p[2] * dky_z + p[3] * dkz_z

    kp2 = k_dot_p * k_dot_p
    fkp = f * k_dot_p
    # ṗ_i = −∂H/∂xi = ½ ∂f_i (k·p)² + f (k·p) ∂(k·p)_i
    pdot_x = 0.5 * df_x * kp2 + fkp * dkp_x
    pdot_y = 0.5 * df_y * kp2 + fkp * dkp_y
    pdot_z = 0.5 * df_z * kp2 + fkp * dkp_z
    zero = torch.zeros_like(xdot_t)  # p_t conserved (stationary metric)
    return torch.stack([xdot_t, xdot_x, xdot_y, xdot_z, zero, pdot_x, pdot_y, pdot_z])


def _momentum_contra(radius, a, y):
    """p^μ from the covariant state, [4, N]."""
    f, kx, ky, kz, _ = _ks_scalars(radius, a, y[1], y[2], y[3])
    p = y[4:8]
    k_dot_p = -p[0] + kx * p[1] + ky * p[2] + kz * p[3]
    return torch.stack(
        [
            -p[0] + f * k_dot_p,
            p[1] - f * kx * k_dot_p,
            p[2] - f * ky * k_dot_p,
            p[3] - f * kz * k_dot_p,
        ]
    )


class _Lanes(NamedTuple):
    """The plain march's per-lane state; ev_kind [N, K], ev_data [N, K, 12]."""

    y: torch.Tensor  # [8, N]
    r: torch.Tensor
    stop: torch.Tensor
    steps: torch.Tensor
    ev_kind: torch.Tensor
    ev_data: torch.Tensor
    ev_count: torch.Tensor
    ev_ovf: torch.Tensor
    comp: torch.Tensor  # [8, N] Kahan compensation


_COMPONENT_MAJOR = ("y", "comp")


def _take(lanes, idx):
    return type(lanes)(
        *(t[:, idx] if name in _COMPONENT_MAJOR else t[idx] for name, t in zip(lanes._fields, lanes))
    )


def _put(lanes, idx, sub):
    for name, t, s in zip(lanes._fields, lanes, sub):
        if name in _COMPONENT_MAJOR:
            t[:, idx] = s
        else:
            t[idx] = s


def _store_event(ev_kind, ev_data, ev_count, ev_ovf, lanes, hit, kind, payload):
    """Append `payload` [N, 12] as an event of `kind` on the `hit` lanes
    that have a free slot, through masks (no host sync, so a CUDA graph can
    capture it); a hit with no free slot sets its lane's overflow flag.
    Returns (ev_count, ev_ovf)."""
    store = hit & (ev_count < ev_kind.shape[1])
    slot = torch.clamp(ev_count, max=ev_kind.shape[1] - 1).long()
    ev_kind[lanes, slot] = torch.where(store, kind, ev_kind[lanes, slot])
    ev_data[lanes, slot] = torch.where(store[:, None], payload, ev_data[lanes, slot])
    return ev_count + store.to(ev_count.dtype), ev_ovf | (hit & ~store)


def _store_disc_events(discs, crossing, px, py, p_interp, seg, ev_kind, ev_data, ev_count, ev_ovf):
    """Append one event per hitting lane and disc into the K-slot buffers."""
    rr = torch.sqrt(px * px + py * py)
    phi = torch.atan2(py, px)
    zero = torch.zeros_like(px)
    lanes = torch.arange(px.shape[0], device=px.device)
    for disc in discs:
        hit = crossing & (rr >= disc.inner) & (rr <= disc.outer)
        width = rr.new_full((), disc.outer) - rr.new_full((), disc.inner)
        r_norm = (rr - disc.inner) / width
        u = 0.5 + 0.5 * r_norm * torch.cos(phi)
        v = 0.5 + 0.5 * r_norm * torch.sin(phi)
        payload = torch.stack([px, py, zero, *p_interp, u, v, *seg], dim=-1)  # [N, 12]
        ev_count, ev_ovf = _store_event(ev_kind, ev_data, ev_count, ev_ovf, lanes, hit, disc.kind, payload)
    return ev_count, ev_ovf


def _store_sphere_events(spheres, gate, s3, e3, p_prev, p_new, ev_kind, ev_data, ev_count, ev_ovf):
    """Append one event per sphere whose surface the chord s3 → e3 ([3, N]
    each) crosses, on `gate` lanes: the endpoint radii straddle the
    surface (a chord fully through the sphere is a miss), the + root is
    preferred, θ of the local spherical UV is atan2(√max(1 − c², 0), c),
    as in the kernel."""
    d = e3 - s3
    two_pi = s3.new_full((), 2.0 * math.pi)
    pi = s3.new_full((), math.pi)
    lanes = torch.arange(s3.shape[1], device=s3.device)
    for sp in spheres:
        s_loc = torch.stack([s3[0] - sp.cx, s3[1] - sp.cy, s3[2] - sp.cz])
        e_loc = torch.stack([e3[0] - sp.cx, e3[1] - sp.cy, e3[2] - sp.cz])
        r2 = sp.radius * sp.radius
        rs = s_loc[0] * s_loc[0] + s_loc[1] * s_loc[1] + s_loc[2] * s_loc[2]
        re = e_loc[0] * e_loc[0] + e_loc[1] * e_loc[1] + e_loc[2] * e_loc[2]
        crossing = ((rs >= r2) & (re <= r2)) | ((rs <= r2) & (re >= r2))

        a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        b = 2.0 * (s_loc[0] * d[0] + s_loc[1] * d[1] + s_loc[2] * d[2])
        c = rs - r2
        disc = b * b - 4.0 * a * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        safe_a = torch.where(a != 0.0, a, 1.0)
        t1 = (-b + sq) / (2.0 * safe_a)
        t2 = (-b - sq) / (2.0 * safe_a)
        t1_ok = (t1 >= 0.0) & (t1 <= 1.0)
        t2_ok = (t2 >= 0.0) & (t2 <= 1.0)
        t = torch.where(t1_ok, t1, t2)
        hit = gate & crossing & (disc >= 0.0) & (t1_ok | t2_ok) & (a != 0.0)

        local = s_loc + t[None] * d
        r_loc = torch.sqrt(torch.clamp(local[0] * local[0] + local[1] * local[1] + local[2] * local[2], min=1e-30))
        cos_th = torch.clamp(local[2] / r_loc, -1.0, 1.0)
        theta = torch.atan2(torch.sqrt(torch.clamp(1.0 - cos_th * cos_th, min=0.0)), cos_th)
        phi = torch.atan2(local[1], local[0])
        u = 1.0 - (math.pi + phi) / two_pi
        v = theta / pi
        world = (local[0] + sp.cx, local[1] + sp.cy, local[2] + sp.cz)
        p_interp = p_prev + t[None] * (p_new - p_prev)
        payload = torch.stack([*world, *p_interp, u, v, *d], dim=-1)  # [N, 12]
        ev_count, ev_ovf = _store_event(ev_kind, ev_data, ev_count, ev_ovf, lanes, hit, sp.kind, payload)
    return ev_count, ev_ovf


def _sphere_candidates_ks(spheres, active, y, y_new):
    """Lanes whose step may cross a sphere: (|s − c|² − R²)(|e − c|² − R²)
    ≤ 0 for some sphere, with the store's own |s − c|², so it holds on
    every lane the store's straddle test passes."""
    cand = torch.zeros_like(active)
    for sp in spheres:
        r2 = sp.radius * sp.radius
        rs = (y[1] - sp.cx) * (y[1] - sp.cx) + (y[2] - sp.cy) * (y[2] - sp.cy) + (y[3] - sp.cz) * (y[3] - sp.cz)
        re = (
            (y_new[1] - sp.cx) * (y_new[1] - sp.cx) + (y_new[2] - sp.cy) * (y_new[2] - sp.cy)
            + (y_new[3] - sp.cz) * (y_new[3] - sp.cz)
        )
        cand = cand | ((rs - r2) * (re - r2) <= 0.0)
    return cand & active


def _sphere_candidates_bl(spheres, a, active, y, y_new):
    """Lanes of a BL step that may cross a sphere: an endpoint inside a
    sphere has ||p| − |c|| ≤ R, where |p|² = r² + a² sin²θ is the norm of
    its Kerr-Schild embedding (the reverse triangle inequality). Evaluated
    before the embedding."""
    st0, st1 = torch.sin(y[2]), torch.sin(y_new[2])
    n0 = torch.sqrt(y[1] * y[1] + a * a * (st0 * st0))
    n1 = torch.sqrt(y_new[1] * y_new[1] + a * a * (st1 * st1))
    cand = torch.zeros_like(active)
    for sp in spheres:
        c_norm = math.sqrt(sp.cx * sp.cx + sp.cy * sp.cy + sp.cz * sp.cz)
        cand = cand | (torch.abs(n0 - c_norm) <= sp.radius) | (torch.abs(n1 - c_norm) <= sp.radius)
    return cand & active


def _store_vol_events(vols, cand, s3, e3, p_prev, p_new, ev_kind, ev_data, ev_count, ev_ovf):
    """Append, per volume, the first bounding-volume crossing of each
    candidate lane's chord s3 → e3 ([3, N] each): the smallest root in
    (MIN_INTERSECTION_T, 1] of the two cylinders (within the caps) and the
    two caps (within the annulus). Root finding cannot tunnel: a chord that
    crosses the boundary has a root whatever its length."""
    d = e3 - s3
    d_dot = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    a_cyl = d[0] * d[0] + d[1] * d[1]
    b_half = s3[0] * d[0] + s3[1] * d[1]
    ss_xy = s3[0] * s3[0] + s3[1] * s3[1]
    lanes = torch.arange(s3.shape[1], device=s3.device)
    for vs in vols:
        best_t = torch.full_like(ss_xy, math.inf)
        for radius in (vs.outer, vs.inner):
            c = ss_xy - radius * radius
            disc = b_half * b_half - a_cyl * c
            ok_base = (a_cyl >= 1e-10 * d_dot) & (disc >= 0.0)
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            safe_a = torch.where(a_cyl > 0.0, a_cyl, 1.0)
            for tt in ((-b_half - sq) / safe_a, (-b_half + sq) / safe_a):
                z_at = s3[2] + tt * d[2]
                ok = ok_base & (tt > MIN_INTERSECTION_T) & (tt <= 1.0) & (torch.abs(z_at) <= vs.cap_h)
                best_t = torch.where(ok & (tt < best_t), tt, best_t)
        dz_ok = torch.abs(d[2]) > 1e-10
        safe_dz = torch.where(dz_ok, d[2], 1.0)
        for zc in (vs.cap_h, -vs.cap_h):
            tt = (zc - s3[2]) / safe_dz
            px = s3[0] + tt * d[0]
            py = s3[1] + tt * d[1]
            r2 = px * px + py * py
            ok = (
                dz_ok & (tt > MIN_INTERSECTION_T) & (tt <= 1.0)
                & (r2 <= vs.outer * vs.outer) & (r2 >= vs.inner * vs.inner)
            )
            best_t = torch.where(ok & (tt < best_t), tt, best_t)

        hit = cand & (best_t < math.inf)
        t_ev = torch.where(hit, best_t, 0.0)
        point = s3 + t_ev[None] * d
        rr = torch.sqrt(point[0] * point[0] + point[1] * point[1])
        phi = torch.atan2(point[1], point[0])
        width = rr.new_full((), vs.outer) - rr.new_full((), vs.inner)
        r_norm = (rr - vs.inner) / width
        u = 0.5 + 0.5 * r_norm * torch.cos(phi)
        v = 0.5 + 0.5 * r_norm * torch.sin(phi)
        p_interp = p_prev + t_ev[None] * (p_new - p_prev)
        payload = torch.stack([*point, *p_interp, u, v, *d], dim=-1)  # [N, 12]
        ev_count, ev_ovf = _store_event(ev_kind, ev_data, ev_count, ev_ovf, lanes, hit, vs.kind, payload)
    return ev_count, ev_ovf


def _vol_candidates(vols, active, z_prev, z_new, rho_min2=None):
    """Lanes whose step may cross a bounding volume: the chord's z range
    meets a volume's band and (when given) its closest squared distance to
    the axis is inside the outer cylinder. Both are necessary for every
    root, so gating the store on them changes no event."""
    zmin = torch.minimum(z_prev, z_new)
    zmax = torch.maximum(z_prev, z_new)
    cand = torch.zeros_like(active)
    for vs in vols:
        near = (zmin <= vs.cap_h) & (zmax >= -vs.cap_h)
        if rho_min2 is not None:
            near = near & (rho_min2 <= vs.outer * vs.outer)
        cand = cand | near
    return cand & active


def _ks_rk4_delta(c, y, r_here):
    """y_new − y of one RK4 step with the step rule and the far-field
    lever."""
    radius, a = c["radius"], c["a"]
    h = c["h0"] * torch.clamp((r_here - c["r_plus"]) / c["r_ref"], c["h_min_frac"], 1.0)

    k1 = _rhs(radius, a, y)
    r_safe = c["r_safe"]
    if r_safe > 0.0:
        rho = torch.sqrt(y[1] * y[1] + y[2] * y[2] + y[3] * y[3])
        speed = torch.sqrt(k1[1] ** 2 + k1[2] ** 2 + k1[3] ** 2)
        outward = (y[1] * k1[1] + y[2] * k1[2] + y[3] * k1[3]) > 0.0
        h_far = torch.minimum(0.5 * (rho - r_safe), 0.125 * rho) / torch.clamp(speed, min=1e-12)
        h = torch.where(outward & (rho > r_safe), torch.maximum(h, h_far), h)
    k2 = _rhs(radius, a, y + 0.5 * h * k1)
    k3 = _rhs(radius, a, y + 0.5 * h * k2)
    k4 = _rhs(radius, a, y + h * k3)
    # Divisors are tensors: on the card torch turns division by a Python
    # scalar into multiplication by its reciprocal, which the kernel's true
    # division would not match. new_full fills on the device, so a CUDA
    # graph can capture it.
    return (h / h.new_full((), 6.0)) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def _plain_step(c, lanes, discs, spheres=(), vols=()):
    """One march iteration over `lanes`; stopped lanes stay frozen. On the
    card it does not synchronize with the host (a CUDA graph captures it,
    integrator.run_lanes); on the CPU it skips the event stores of a step
    that no lane's test passes."""
    y, r_here, stop, steps, ev_kind, ev_data, ev_count, ev_ovf, comp = lanes
    radius, a = c["radius"], c["a"]
    active = stop == integ.RUNNING
    delta = _ks_rk4_delta(c, y, r_here)
    y_new, comp = _update(c, active, y, delta, comp)

    pos_finite = torch.all(torch.isfinite(y_new[0:4]), dim=0)
    mom_finite = torch.all(torch.isfinite(y_new[4:8]), dim=0)
    r_new = _ks_radius(a, y_new[1], y_new[2], y_new[3])
    rho_sq = y_new[1] ** 2 + y_new[2] ** 2 + y_new[3] ** 2
    stop_new, steps_new = _stop_codes(
        c, active, stop, steps, r_new, pos_finite, mom_finite, rho_sq
    )

    if discs:
        z_prev, z_new = y[3], y_new[3]
        crossing = (z_prev * z_new < 0.0) & active
        if _any_lane(crossing):
            p_prev = _momentum_contra(radius, a, y)
            p_new = _momentum_contra(radius, a, y_new)
            frac = z_prev / (z_prev - z_new + (z_prev == z_new).to(y.dtype))
            px = y[1] + frac * (y_new[1] - y[1])
            py = y[2] + frac * (y_new[2] - y[2])
            p_interp = p_prev + frac[None] * (p_new - p_prev)
            seg = y_new[1:4] - y[1:4]
            ev_count, ev_ovf = _store_disc_events(
                discs, crossing, px, py, p_interp, seg, ev_kind, ev_data, ev_count, ev_ovf
            )
    if spheres:
        cand = _sphere_candidates_ks(spheres, active, y, y_new)
        if _any_lane(cand):
            p_prev = _momentum_contra(radius, a, y)
            p_new = _momentum_contra(radius, a, y_new)
            ev_count, ev_ovf = _store_sphere_events(
                spheres, cand, y[1:4], y_new[1:4], p_prev, p_new, ev_kind, ev_data, ev_count, ev_ovf
            )
    if vols:
        # The chord's closest approach to the axis in the xy plane.
        dx = y_new[1] - y[1]
        dy = y_new[2] - y[2]
        a_c = dx * dx + dy * dy
        b_h = y[1] * dx + y[2] * dy
        rho0 = y[1] * y[1] + y[2] * y[2]
        t_star = torch.clamp(-b_h / torch.clamp(a_c, min=1e-20), 0.0, 1.0)
        rho_min2 = rho0 + (2.0 * b_h + a_c * t_star) * t_star
        cand = _vol_candidates(vols, active, y[3], y_new[3], rho_min2)
        if _any_lane(cand):
            p_prev = _momentum_contra(radius, a, y)
            p_new = _momentum_contra(radius, a, y_new)
            ev_count, ev_ovf = _store_vol_events(
                vols, cand, y[1:4], y_new[1:4], p_prev, p_new, ev_kind, ev_data, ev_count, ev_ovf
            )
    if (discs or spheres) and c["opaque_stop"]:
        # Every texture is opaque: the first disc or sphere event saturates
        # the fold, so the lane stops after the step's stores.
        stop_new = torch.where(
            (stop_new == integ.RUNNING) & (ev_count > 0), integ.SATURATED, stop_new
        )
    r_carry = torch.where(active, r_new, r_here)
    return _Lanes(y_new, r_carry, stop_new, steps_new, ev_kind, ev_data, ev_count, ev_ovf, comp)


def _any_lane(mask):
    """Whether a step's event stores must run: always on the card (no host
    sync), on the CPU only if some lane's test passed."""
    return mask.is_cuda or bool(mask.any())


def _check_args(y0, discs, spheres, vols, resume, ckpt_every, max_events=MAX_EVENTS):
    if int(max_events) < 1:
        raise ValueError(f"max_events must be >= 1, got {max_events}")
    if int(ckpt_every) < 0:
        raise ValueError(f"ckpt_every must be >= 0, got {ckpt_every}")
    if y0.dim() != 2 or y0.shape[1] != 8:
        raise ValueError(f"y0 must be [N, 8], got {tuple(y0.shape)}")
    if y0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"y0 must be float32 or float64, got {y0.dtype}")
    if resume is not None:
        _check_resume(y0, resume, int(max_events))
    if len(discs) > MAX_DISCS:
        raise NotImplementedError(f"at most {MAX_DISCS} discs per scene")
    if len(spheres) > MAX_SPHERES:
        raise NotImplementedError(f"at most {MAX_SPHERES} spheres per scene")
    if not all(isinstance(s, SphereSpec) for s in spheres):
        raise TypeError("spheres must be SphereSpec")
    if len(vols) > MAX_VOLS:
        raise NotImplementedError(f"at most {MAX_VOLS} volumetric discs per scene")
    if not all(isinstance(v, VolSpec) for v in vols):
        raise TypeError("vols must be VolSpec bounding volumes")


def _check_resume(y0, resume, max_events):
    """A resume tuple is a previous march's seven results (y, stop, steps,
    ev_kind, ev_data, ev_count, ev_overflow) for y0's N lanes, dtype and
    device, with max_events slots a lane."""
    n, dt, dev = y0.shape[0], y0.dtype, y0.device
    if not isinstance(resume, (tuple, list)) or len(resume) != 7:
        raise ValueError("resume must be the 7 results (y, stop, steps, ev_kind, ev_data, ev_count, "
                         "ev_overflow) of a previous march")
    shapes = ((n, 8), (n,), (n,), (n, max_events), (n, max_events, EVENT_WIDTH), (n,), (n,))
    dtypes = (dt, torch.int32, torch.int32, torch.int32, dt, torch.int32, torch.bool)
    names = ("y", "stop", "steps", "ev_kind", "ev_data", "ev_count", "ev_overflow")
    for name, v, shape, dtype in zip(names, resume, shapes, dtypes):
        if not isinstance(v, torch.Tensor) or tuple(v.shape) != shape or v.dtype != dtype or v.device != dev:
            got = (tuple(v.shape), v.dtype, v.device) if isinstance(v, torch.Tensor) else type(v)
            raise ValueError(f"resume's {name} must be {shape} {dtype} on {dev}, got {got}")


def _initial_lanes(y0, resume, max_events):
    """(y [8, N], stop, steps, ev_kind, ev_data, ev_count, ev_ovf) a plain
    march starts from: fresh buffers, or copies of a previous march's
    results (resume), whose y replaces y0."""
    n, dtype, device = y0.shape[0], y0.dtype, y0.device
    if resume is None:
        zeros = lambda: torch.zeros(n, dtype=torch.int32, device=device)
        return (_lane_major_copy(y0), zeros(), zeros(), *_event_buffers(n, dtype, device, max_events))
    y, stop, steps, ev_kind, ev_data, ev_count, ev_ovf = resume
    return (_lane_major_copy(y), *(v.clone() for v in (stop, steps, ev_kind, ev_data, ev_count, ev_ovf)))


def march_plain(
    radius, a, horizon_epsilon, y0, h0, max_steps, max_radius, discs=(), spheres=(), vols=(),
    h_min_frac=0.01, r_ref_scale=10.0, r_safe=0.0, opaque_stop=False, attempts=None,
    resume=None, finalize=True, ckpt_every=0, compensated=False, max_events=MAX_EVENTS,
):
    """The march in plain torch on y0's device; same arguments and results
    as `kerr_rk4_march`, its lanes run by _march_lanes."""
    _check_args(y0, discs, spheres, vols, resume, ckpt_every, max_events)
    dtype, device = y0.dtype, y0.device
    attempts = max_steps if attempts is None else int(attempts)
    c = _march_constants(radius, a, horizon_epsilon, h0, max_steps, max_radius, h_min_frac,
                         r_ref_scale, opaque_stop, compensated, dtype, device)
    c["r_safe"] = float(torch.tensor(float(r_safe), dtype=dtype))
    discs = _rounded_discs(discs, dtype)
    spheres = tuple(spheres)
    y, *state = _initial_lanes(y0, resume, int(max_events))
    # The carried radius is recomputed from y and the Kahan compensation
    # starts at zero, on a resumed leg as on a fresh march.
    lanes = _Lanes(y, _ks_radius(c["a"], y[1], y[2], y[3]), *state, torch.zeros_like(y))

    return _march_lanes(lambda s: _plain_step(c, s, discs, spheres, vols), lanes, attempts, finalize, ckpt_every)


def _march_lanes(step, lanes, attempts, finalize, ckpt_every):
    """Run the RUNNING lanes for up to `attempts` iterations of `step`
    (lanes -> lanes) on integrator.run_lanes: blocks of _COMPACT_EVERY
    iterations over the lanes running at each block's start on the CPU;
    on the card blocks doubling from integrator.BLOCK_FIRST to BLOCK_MAX,
    each replayed from a CUDA graph of one step. With checkpoints, blocks of
    ckpt_every iterations, each writing its row at its start (a lane that
    stopped inside the block writes no later row, and no row it reached is
    left out). Returns the march's results (y [N, 8], stop, steps, ev_kind,
    ev_data, ev_count, ev_overflow, and the checkpoints [S, 8, N] when
    ckpt_every > 0). The checkpoint rows go by this call's iteration
    count."""
    k_ckpt = int(ckpt_every)
    at_block = None
    if k_ckpt:
        ckpt = lanes.y.new_zeros((-(-attempts // k_ckpt),) + tuple(lanes.y.shape))
        blocks = (k_ckpt, k_ckpt)

        def at_block(it, idx, sub):
            ckpt[it // k_ckpt][:, idx] = sub.y
    elif lanes.y.is_cuda:
        blocks = (integ.BLOCK_FIRST, integ.BLOCK_MAX)
    else:
        blocks = (_COMPACT_EVERY, _COMPACT_EVERY)
    integ.run_lanes(lambda s, _: step(s), lanes, {}, lambda s: s.stop == integ.RUNNING, attempts,
                    name="plain", take=_take, put=_put, blocks=blocks, at_block=at_block)
    stop = lanes.stop
    if finalize:
        stop = torch.where(stop == integ.RUNNING, integ.BUDGET, stop)
    out = (
        lanes.y.T.contiguous(), stop, lanes.steps, lanes.ev_kind, lanes.ev_data,
        lanes.ev_count, lanes.ev_ovf,
    )
    return out + (ckpt,) if k_ckpt else out


def _lane_major_copy(y0):
    """y0 [N, 8] as a fresh [8, N] tensor. The march updates its state in
    place, and y0.T.contiguous() would alias y0 when N = 1."""
    return y0.T.clone(memory_format=torch.contiguous_format)


def _event_buffers(n, dtype, device, max_events=MAX_EVENTS):
    """Fresh (ev_kind, ev_data, ev_count, ev_ovf) of a march with
    max_events slots a lane."""
    return (
        torch.full((n, max_events), -1, dtype=torch.int32, device=device),
        torch.zeros((n, max_events, EVENT_WIDTH), dtype=dtype, device=device),
        torch.zeros(n, dtype=torch.int32, device=device),
        torch.zeros(n, dtype=torch.bool, device=device),
    )


def _stop_codes(c, active, stop, steps, r_new, pos_finite, mom_finite, rho_sq):
    """(stop_new, steps_new): the stop decision of one step, its priority
    set by the order of the where-chain; shared by both marches."""
    horizon = r_new <= c["r_plus"] + c["horizon_eps"]
    escaped = rho_sq > c["max_radius_sq"]
    steps_new = steps + active.to(steps.dtype)
    budget = steps_new >= c["budget_steps"] - 1
    trapped = budget & (r_new < 5.0 * c["radius"])
    code = torch.full_like(stop, integ.RUNNING)
    code = torch.where(~mom_finite, integ.NAN, code)
    code = torch.where(escaped, integ.CELESTIAL, code)
    code = torch.where(trapped, integ.TRAPPED, code)
    code = torch.where(horizon, integ.HORIZON, code)
    code = torch.where(~pos_finite, integ.NAN, code)
    code = torch.where((code == integ.RUNNING) & budget, integ.BUDGET, code)
    return torch.where(active, code, stop), steps_new


def _update(c, active, y, delta, comp):
    """(y_new, comp): y += delta on active lanes, Kahan-compensated when
    c["compensated"]."""
    if c["compensated"]:
        adj = delta - comp
        t_sum = y + adj
        comp_new = (t_sum - y) - adj
        return torch.where(active[None, :], t_sum, y), torch.where(active[None, :], comp_new, comp)
    return torch.where(active[None, :], y + delta, y), comp


def _rounded_discs(discs, dtype):
    """Disc bounds rounded to the march dtype, as the kernel's are."""
    rd = lambda v: float(torch.tensor(float(v), dtype=dtype))
    return tuple(DiscSpec(rd(d.inner), rd(d.outer), int(d.kind)) for d in discs)


def _march_constants(radius, a, horizon_epsilon, h0, max_steps, max_radius, h_min_frac,
                     r_ref_scale, opaque_stop, compensated, dtype, device):
    """The scalars of a march, rounded to the march dtype as the kernel's
    parameters are."""
    sc = lambda v: torch.tensor(float(v), dtype=dtype, device=device)
    radius_t, a_t = sc(radius), sc(a)
    m = 0.5 * radius_t
    return {
        "radius": radius_t,
        "a": a_t,
        "h0": sc(h0),
        "r_ref": sc(r_ref_scale),
        "h_min_frac": float(sc(h_min_frac)),
        "r_plus": m + torch.sqrt(torch.clamp(m * m - a_t * a_t, min=0.0)),
        "horizon_eps": sc(horizon_epsilon),
        "max_radius_sq": sc(max_radius) * sc(max_radius),
        "budget_steps": int(max_steps),
        "opaque_stop": bool(opaque_stop),
        "compensated": bool(compensated),
    }


# ---------------------------------------------------------------------------
# Boyer-Lindquist: the Carter-separated Mino-time march (K3's plain version).
# States are [8, N] = (t, r, θ, φ, v_r, v_θ, 0, 0); E, L_z, Q are [N].
# ---------------------------------------------------------------------------


def _bl_rhs(r_s, a, e, l_z, q, y):
    """Mino-time dy/dλ, [8, N]. The three reciprocals 1/Δ, 1/sin²θ and
    1/sin³θ share one divide, 1/(Δ·sin²θ), as in the JAX kernel. At a pole
    (sin θ = 0) the result is not finite: the march stops the lane NAN,
    the documented classification."""
    r, theta = y[1], y[2]
    delta = r * r - r_s * r + a * a
    p_r = (r * r + a * a) * e - a * l_z
    st = torch.sin(theta)
    ct = torch.cos(theta)
    sin2 = st * st
    inv_ds = 1.0 / (delta * sin2)
    inv_delta = inv_ds * sin2
    inv_sin2 = inv_ds * delta
    dt = (r * r + a * a) * inv_delta * p_r + a * (l_z - a * e * sin2)
    dphi = a * inv_delta * p_r + l_z * inv_sin2 - a * e
    lae = l_z - a * e
    carter_term = lae * lae + q
    dv_r = 0.5 * (4.0 * r * e * p_r - (2.0 * r - r_s) * carter_term)
    inv_st3 = st * inv_sin2 * inv_sin2
    dv_theta = 0.5 * (-2.0 * a * a * e * e * ct * st + 2.0 * l_z * l_z * ct * inv_st3)
    zero = torch.zeros_like(dt)
    return torch.stack([dt, y[4], y[5], dphi, dv_r, dv_theta, zero, zero])


def _bl_momentum(r_s, a, e, l_z, y):
    """p^μ = (1/Σ)(dt/dλ, v_r, v_θ, dφ/dλ), [4, N]. Unlike _bl_rhs, each
    reciprocal is its own divide (as in the JAX kernel)."""
    r, theta = y[1], y[2]
    ct = torch.cos(theta)
    sig = r * r + a * a * (ct * ct)
    delta = r * r - r_s * r + a * a
    p_r = (r * r + a * a) * e - a * l_z
    st = torch.sin(theta)
    sin2 = st * st
    dt = (r * r + a * a) / delta * p_r + a * (l_z - a * e * sin2)
    dphi = a / delta * p_r + l_z / sin2 - a * e
    return torch.stack([dt, y[4], y[5], dphi]) / sig[None]


def _bl_embed3(a, y):
    """The Kerr-Schild Cartesian embedding of a BL state's position, [3, N]."""
    sp, cp = torch.sin(y[3]), torch.cos(y[3])
    st, ct = torch.sin(y[2]), torch.cos(y[2])
    return torch.stack([(y[1] * cp - a * sp) * st, (y[1] * sp + a * cp) * st, y[1] * ct])


def _bl_step_size(c, inv_e, r_here, r_plus):
    """h = h0/|E| / (1 + (r/r_ref)²) · clip((r − r₊)/r_ref, h_min_frac, 1):
    dr/dλ ~ E r² far out, so the far-field spatial step is ~h0·r_ref², and
    near the hole the step shrinks with the distance above the horizon."""
    u = r_here / c["r_ref"]
    gap = torch.clamp((r_here - r_plus) / c["r_ref"], c["h_min_frac"], 1.0)
    return c["h0"] * inv_e / (1.0 + u * u) * gap


def _bl_rk4_delta(c, e, l_z, q, inv_e, r_plus, y):
    """y_new − y of one Mino-time RK4 step (no far-field lever: huge Mino
    steps wreck the t and φ quadratures, whose integrands grow with r)."""
    radius, a = c["radius"], c["a"]
    h = _bl_step_size(c, inv_e, y[1], r_plus)
    k1 = _bl_rhs(radius, a, e, l_z, q, y)
    k2 = _bl_rhs(radius, a, e, l_z, q, y + 0.5 * h * k1)
    k3 = _bl_rhs(radius, a, e, l_z, q, y + 0.5 * h * k2)
    k4 = _bl_rhs(radius, a, e, l_z, q, y + h * k3)
    return (h / h.new_full((), 6.0)) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


class _BLLanes(NamedTuple):
    """The BL march's per-lane state: _Lanes without the carried radius,
    with the conserved scalars and 1/max(|E|, 1e-12)."""

    y: torch.Tensor  # [8, N]
    stop: torch.Tensor
    steps: torch.Tensor
    ev_kind: torch.Tensor
    ev_data: torch.Tensor
    ev_count: torch.Tensor
    ev_ovf: torch.Tensor
    comp: torch.Tensor  # [8, N] Kahan compensation
    e: torch.Tensor
    l_z: torch.Tensor
    q: torch.Tensor
    inv_e: torch.Tensor


def _bl_plain_step(c, lanes, discs, spheres=(), vols=()):
    """One BL march iteration over `lanes`; stopped lanes stay frozen. On
    the card it does not synchronize with the host (_plain_step)."""
    y, stop, steps, ev_kind, ev_data, ev_count, ev_ovf, comp, e, l_z, q, inv_e = lanes
    radius, a = c["radius"], c["a"]
    active = stop == integ.RUNNING
    delta = _bl_rk4_delta(c, e, l_z, q, inv_e, c["r_plus"], y)
    y_new, comp = _update(c, active, y, delta, comp)

    pos_finite = torch.all(torch.isfinite(y_new[0:4]), dim=0)
    mom_finite = torch.all(torch.isfinite(y_new[4:6]), dim=0)
    r_new = y_new[1]
    stop_new, steps_new = _stop_codes(
        c, active, stop, steps, r_new, pos_finite, mom_finite, r_new * r_new
    )

    if discs:
        # The equatorial crossing in BL: θ through π/2.
        d_prev = y[2] - c["half_pi"]
        d_new = y_new[2] - c["half_pi"]
        crossing = (d_prev * d_new < 0.0) & active
        if _any_lane(crossing):
            p_prev = _bl_momentum(radius, a, e, l_z, y)
            p_new = _bl_momentum(radius, a, e, l_z, y_new)
            frac = d_prev / (d_prev - d_new + (d_prev == d_new).to(y.dtype))
            r_c = y[1] + frac * (y_new[1] - y[1])
            phi_c = y[3] + frac * (y_new[3] - y[3])
            sp = torch.sin(phi_c)
            cp = torch.cos(phi_c)
            px = r_c * cp - a * sp  # the KS embedding at θ = π/2
            py = r_c * sp + a * cp
            p_interp = p_prev + frac[None] * (p_new - p_prev)
            seg = _bl_embed3(a, y_new) - _bl_embed3(a, y)
            ev_count, ev_ovf = _store_disc_events(
                discs, crossing, px, py, p_interp, seg, ev_kind, ev_data, ev_count, ev_ovf
            )
    if spheres:
        cand = _sphere_candidates_bl(spheres, a, active, y, y_new)
        if _any_lane(cand):
            p_prev = _bl_momentum(radius, a, e, l_z, y)
            p_new = _bl_momentum(radius, a, e, l_z, y_new)
            ev_count, ev_ovf = _store_sphere_events(
                spheres, cand, _bl_embed3(a, y), _bl_embed3(a, y_new), p_prev, p_new, ev_kind, ev_data,
                ev_count, ev_ovf,
            )
    if vols:
        # The embedded chord's z = r cos θ is linear between its ends.
        cand = _vol_candidates(vols, active, y[1] * torch.cos(y[2]), y_new[1] * torch.cos(y_new[2]))
        if _any_lane(cand):
            p_prev = _bl_momentum(radius, a, e, l_z, y)
            p_new = _bl_momentum(radius, a, e, l_z, y_new)
            ev_count, ev_ovf = _store_vol_events(
                vols, cand, _bl_embed3(a, y), _bl_embed3(a, y_new), p_prev, p_new, ev_kind, ev_data,
                ev_count, ev_ovf,
            )
    if (discs or spheres) and c["opaque_stop"]:
        stop_new = torch.where(
            (stop_new == integ.RUNNING) & (ev_count > 0), integ.SATURATED, stop_new
        )
    return _BLLanes(y_new, stop_new, steps_new, ev_kind, ev_data, ev_count, ev_ovf, comp,
                    e, l_z, q, inv_e)


def _check_bl_args(y0, e, l_z, q, discs, spheres, vols, resume, ckpt_every,
                   max_events=MAX_EVENTS):
    _check_args(y0, discs, spheres, vols, resume, ckpt_every, max_events)
    n = y0.shape[0]
    for name, v in (("e", e), ("l_z", l_z), ("q", q)):
        if v.shape != (n,) or v.dtype != y0.dtype or v.device != y0.device:
            raise ValueError(f"{name} must be [N] of y0's dtype and device, got {tuple(v.shape)} {v.dtype}")


def march_bl_plain(
    radius, a, horizon_epsilon, y0, e, l_z, q, h0, max_steps, max_radius, discs=(), spheres=(),
    vols=(), h_min_frac=0.02, r_ref_scale=10.0, opaque_stop=False, attempts=None, resume=None,
    finalize=True, compensated=False, ckpt_every=0, max_events=MAX_EVENTS,
):
    """The BL march in plain torch on y0's device; same arguments and
    results as `kerr_bl_rk4_march`."""
    _check_bl_args(y0, e, l_z, q, discs, spheres, vols, resume, ckpt_every, max_events)
    dtype, device = y0.dtype, y0.device
    attempts = max_steps if attempts is None else int(attempts)
    c = _march_constants(radius, a, horizon_epsilon, h0, max_steps, max_radius, h_min_frac,
                         r_ref_scale, opaque_stop, compensated, dtype, device)
    c["half_pi"] = torch.tensor(math.pi / 2, dtype=dtype, device=device)
    discs = _rounded_discs(discs, dtype)
    spheres = tuple(spheres)
    y, *state = _initial_lanes(y0, resume, int(max_events))
    # Copies: the march writes the lanes' fields back in place.
    e, l_z, q = (v.detach().clone() for v in (e, l_z, q))
    lanes = _BLLanes(y, *state, torch.zeros_like(y), e, l_z, q, 1.0 / torch.clamp(torch.abs(e), min=1e-12))

    return _march_lanes(lambda s: _bl_plain_step(c, s, discs, spheres, vols), lanes, attempts, finalize,
                        ckpt_every)


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

# The two kernels: K1 (Kerr-Schild) and K3 (Boyer-Lindquist). Entry points
# take (y0[, e, l_z, q], n, outputs..., ckpt, resume[, next], params, discs,
# n_discs, spheres, n_spheres, vols, n_vols, ints, stream) and return the
# CUDA error code of the launch; resume is null or the six per-lane inputs
# (stop, steps, ev_kind, ev_data, ev_count, ev_ovf) of a resumed march;
# next is K3's lane counter for its refill, an int32 on the card set to 0.
_KERNELS = {
    False: ("kerr_rk4_march", "kerr_rk4_march.cu"),
    True: ("kerr_bl_rk4_march", "kerr_bl_march.cu"),
}
_bound: dict = {}


def _entry(bl, dtype):
    """A kernel's C entry point for `dtype`, built on first use."""
    fn = _bound.get((bl, dtype))
    if fn is None:
        from gr_raytracer_tpu_torch.ops import cuda_build

        stem, source = _KERNELS[bl]
        lib = cuda_build.load(source)
        fn = getattr(lib, f"{stem}_f32" if dtype == torch.float32 else f"{stem}_f64")
        p = ctypes.c_void_p
        fn.argtypes = [p] * (4 if bl else 1) + [
            ctypes.c_int64, p, p, p, p, p, p, p, p, ctypes.POINTER(p), p,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), p,
        ]
        fn.restype = ctypes.c_int
        _bound[(bl, dtype)] = fn
    return fn


def disc_rows(discs):
    """The (inner, outer, kind) rows of a kernel's disc table."""
    return (ctypes.c_double * (3 * MAX_DISCS))(*[float(v) for d in discs for v in (d.inner, d.outer, d.kind)])


def sphere_rows(spheres):
    """The (radius, cx, cy, cz, radius², |c|, kind) rows of a kernel's
    sphere table (csrc/sphere_events.cuh); R² and |c| in double, as the
    plain version's Python floats are."""
    return (ctypes.c_double * (7 * MAX_SPHERES))(
        *[float(v) for s in spheres for v in (
            s.radius, s.cx, s.cy, s.cz, s.radius * s.radius,
            math.sqrt(s.cx * s.cx + s.cy * s.cy + s.cz * s.cz), s.kind,
        )]
    )


def _march_cuda(y0, consts, params, discs, spheres, vols, max_steps, opaque_stop, attempts, finalize,
                compensated, ckpt_every, max_events, resume=None):
    """Allocate the outputs and launch K1 (consts empty) or K3 (consts =
    (e, l_z, q)); params are the kernel's float parameters in its order.
    A resumed march reads its lanes' state from the resume tuple (y in
    place of y0) and writes fresh outputs."""
    global launches, bl_launches
    bl = bool(consts)
    if resume is not None:
        y0 = resume[0]
    n = y0.shape[0]
    dev, dtype = y0.device, y0.dtype
    if not all(v.is_contiguous() for v in (y0, *consts, *(resume or ()))):
        raise ValueError("the march takes contiguous y0, e, l_z, q and resume tensors")
    y_out = torch.empty_like(y0)
    stop = torch.empty(n, dtype=torch.int32, device=dev)
    steps = torch.empty(n, dtype=torch.int32, device=dev)
    ev_kind = torch.empty((n, max_events), dtype=torch.int32, device=dev)
    ev_data = torch.empty((n, max_events, EVENT_WIDTH), dtype=dtype, device=dev)
    ev_count = torch.empty(n, dtype=torch.int32, device=dev)
    ev_ovf = torch.empty(n, dtype=torch.bool, device=dev)
    # Rows a lane never reaches stay unwritten (undefined), as on the TPU.
    ckpt = torch.empty((-(-attempts // ckpt_every), 8, n), dtype=dtype, device=dev) if ckpt_every else None
    params = (ctypes.c_double * len(params))(*[float(v) for v in params])
    resume_ptrs = None if resume is None else (ctypes.c_void_p * 6)(*(v.data_ptr() for v in resume[1:]))
    vol_rows = (ctypes.c_double * (4 * MAX_VOLS))(
        *[float(v) for vs in vols for v in (vs.inner, vs.outer, vs.cap_h, vs.kind)]
    )
    ints = (ctypes.c_int * 7)(
        int(attempts), int(max_steps), int(bool(opaque_stop)), int(bool(finalize)),
        int(bool(compensated)), int(ckpt_every), int(max_events),
    )
    # The refill counter: the lanes the kernel's threads have taken past
    # their first.
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    fn = _entry(bl, dtype)
    timer = bl_launch_timer if bl else launch_timer
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        if timer is not None:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
        err = fn(
            y0.data_ptr(), *(v.data_ptr() for v in consts), n, y_out.data_ptr(), stop.data_ptr(),
            steps.data_ptr(), ev_kind.data_ptr(), ev_data.data_ptr(), ev_count.data_ptr(),
            ev_ovf.data_ptr(), None if ckpt is None else ckpt.data_ptr(), resume_ptrs, counter.data_ptr(), params,
            disc_rows(discs), len(discs), sphere_rows(spheres), len(spheres), vol_rows, len(vols), ints,
            stream.cuda_stream,
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
    out = (y_out, stop, steps, ev_kind, ev_data, ev_count, ev_ovf)
    return out + (ckpt,) if ckpt_every else out


def kerr_rk4_march(
    radius, a, horizon_epsilon, y0, h0, max_steps, max_radius, discs=(), spheres=(), vols=(),
    h_min_frac=0.01, r_ref_scale=10.0, r_safe=0.0, opaque_stop=False, attempts=None,
    resume=None, finalize=True, ckpt_every=0, compensated=False, max_events=MAX_EVENTS,
):
    """March N rays from y0 [N, 8] (position | covariant momentum).

    Returns (y [N, 8], stop [N] i32, steps [N] i32, ev_kind [N, K] i32,
    ev_data [N, K, 12], ev_count [N] i32, ev_overflow [N] bool) with K =
    max_events slots a lane (an event past them sets ev_overflow), and with
    ckpt_every = K > 0 an 8th result: the pre-step state every K
    iterations, [S, 8, N] with S = ceil(attempts / K) (the reverse sweep's
    checkpoints, ops/geodesic_adjoint.py; rows with seg·K ≥ steps[lane] are
    undefined).

    discs (DiscSpec) records thin-disc crossings, spheres (SphereSpec)
    sphere surface crossings, vols (VolSpec) bounding-volume crossings of
    z-axis volumetric discs, in that order within a step. r_safe > 0
    enables the far-field lever; opaque_stop stops a lane at its first disc
    or sphere event (exact when every texture is opaque); `attempts`
    bounds this call's iterations (default max_steps); finalize=False
    leaves unfinished lanes RUNNING instead of BUDGET; compensated selects
    the Kahan state update. `resume`, a previous call's seven results,
    continues that march: each lane's state, stop code, step count and
    events carry over (its y replaces y0), max_steps stays the lane's total
    budget, and the Kahan compensation restarts at zero; with
    compensation off, legs of `attempts` iterations ending in
    finalize=False give one march's results bit for bit. A CUDA tensor goes
    through the kernel csrc/kerr_rk4_march.cu, a CPU tensor through
    `march_plain`. The kernel runs as many threads as the card keeps
    resident, each taking the next lane (in index order) when its own
    stops."""
    _check_args(y0, discs, spheres, vols, resume, ckpt_every, max_events)
    if y0.device.type == "cpu":
        return march_plain(
            radius, a, horizon_epsilon, y0, h0, max_steps, max_radius, discs=discs, spheres=spheres,
            vols=vols, h_min_frac=h_min_frac, r_ref_scale=r_ref_scale, r_safe=r_safe,
            opaque_stop=opaque_stop, attempts=attempts, resume=resume, finalize=finalize,
            ckpt_every=ckpt_every, compensated=compensated, max_events=max_events,
        )
    if y0.device.type != "cuda":
        raise ValueError(f"unsupported device {y0.device}")
    attempts = max_steps if attempts is None else int(attempts)
    params = (radius, a, horizon_epsilon, h0, max_radius, h_min_frac, r_ref_scale, r_safe)
    return _march_cuda(y0, (), params, tuple(discs), tuple(spheres), tuple(vols), max_steps, opaque_stop,
                       attempts, finalize, compensated, int(ckpt_every), int(max_events), resume)


def kerr_bl_rk4_march(
    radius, a, horizon_epsilon, y0, e, l_z, q, h0, max_steps, max_radius, discs=(), spheres=(),
    vols=(), h_min_frac=0.02, r_ref_scale=10.0, opaque_stop=False, attempts=None, resume=None,
    finalize=True, compensated=False, ckpt_every=0, max_events=MAX_EVENTS,
):
    """The Carter-separated Mino-time march of N rays from y0 [N, 8] =
    (t, r, θ, φ, v_r, v_θ, 0, 0) with their conserved E, L_z, Q [N].

    Same options (`resume` too) and results as `kerr_rk4_march`, without
    the far-field lever; a resumed leg takes the lanes' E, L_z, Q again. Disc, sphere and volume events record the Kerr-Schild embedding
    of the crossing point, the interpolated BL contravariant momentum and
    the embedded segment (sphere and volume roots are found on the embedded
    chord, after a near test in BL). A
    CUDA tensor goes through the kernel csrc/kerr_bl_march.cu,
    a CPU tensor through `march_bl_plain`. The kernel runs as many threads
    as the card keeps resident, each taking the next lane (in index order)
    when its own stops, so lanes expected to march longest go first."""
    _check_bl_args(y0, e, l_z, q, discs, spheres, vols, resume, ckpt_every, max_events)
    if y0.device.type == "cpu":
        return march_bl_plain(
            radius, a, horizon_epsilon, y0, e, l_z, q, h0, max_steps, max_radius, discs=discs,
            spheres=spheres, vols=vols, h_min_frac=h_min_frac, r_ref_scale=r_ref_scale, opaque_stop=opaque_stop,
            attempts=attempts, resume=resume, finalize=finalize, compensated=compensated,
            ckpt_every=ckpt_every, max_events=max_events,
        )
    if y0.device.type != "cuda":
        raise ValueError(f"unsupported device {y0.device}")
    attempts = max_steps if attempts is None else int(attempts)
    params = (radius, a, horizon_epsilon, h0, max_radius, h_min_frac, r_ref_scale)
    return _march_cuda(y0, (e, l_z, q), params, tuple(discs), tuple(spheres), tuple(vols), max_steps,
                       opaque_stop, attempts, finalize, compensated, int(ckpt_every), int(max_events), resume)
