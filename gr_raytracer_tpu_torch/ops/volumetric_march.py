"""Constant-step volumetric raymarch K5 (port of
gr_raytracer_tpu/ops/volumetric_pallas.py::raymarch) and its host side.

Each lane marches straight from a bounding-volume entry point of a
volumetric disc (objects/volumetric_disc.py) in steps of `step_size`:
  * density: hash-Perlin fBm (ops/noise.py) times radial, vertical and edge
    envelopes;
  * redshift: transport-free, from the ray's conserved (p_t, p_φ) and the
    Killing coefficients of the prograde circular orbit at the sample's
    Boyer-Lindquist radius;
  * temperature: a Chebyshev fit of T⁴(r) over the emitting range (T⁴ is
    smooth where T has its (r − r_isco)^¼ cusp), then two square roots;
  * blackbody texture: Chebyshev fits of log₁₀X/Y/Z(log₁₀T) split at
    log₁₀T = 3.8, exponentiated; or a checker in UV;
  * Beer-Lambert attenuation and emission, the hole jump, the saturation
    exit, and the texture-alpha quotient at the end.
The march range of each lane is clipped exactly to where the density can be
nonzero (`_march_bounds`).

`raymarch` launches the hand-written CUDA kernel K5 (csrc/vol_raymarch.cu)
for tensors on the card and runs `raymarch_plain`, the same loop in plain
torch, for tensors on the CPU. The two share every operation in the same
order; every plain division has a tensor divisor (torch on the card turns
division by a Python scalar into multiplication by its reciprocal).
`raymarch_raw` (K6: the same kernel with its raw-output flag; plain version
`raymarch_raw_plain`) is the forward of the differentiable march
(ops/volumetric_adjoint.py): the five medium parameters arrive at run time
as a [5] tensor (`MED_NAMES`) and the lane results are the raw reductions
(acc XYZ, transparency, Σ alpha weights).

Chebyshev coefficients are host floats fitted in float64 numpy from the
port's own temperature table and blackbody integral; the kernel receives
them in its parameter struct, rounded to the march dtype once, as torch
rounds a Python scalar. The JAX package's TPU switches GR_VOL_UNROLL (an
unroll that is bit-equivalent to the rolled loop) and GR_VOL_DROP_OCTAVES
are not ported.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from gr_raytracer_tpu_torch.objects.volumetric_disc import (
    ALPHA_WT_MIN, DENSITY_VERTICAL_CUTOFF, SATURATION_EPS,
)
from gr_raytracer_tpu_torch.ops import noise
from gr_raytracer_tpu_torch.rendering import integrator as integ

TEMP_DEG = 32
# Blackbody log-XYZ fits: two domains split at log₁₀T = 3.8, evaluated by
# one Clenshaw recurrence over per-lane selected coefficients.
BB_SPLIT = 3.8
BB_DEG_LO = 16  # [lo, BB_SPLIT], the steep Wien side
BB_DEG_HI = 12  # [BB_SPLIT, hi]
BB_LOG_FLOOR = -120.0  # log10 of "no emission"
MAX_OCTAVES = 16  # kMaxOctaves in the CUDA source
_LN10 = float(np.log(10.0))
# Lanes are re-gathered every this many iterations of the plain march on the
# CPU (march_compacted).
_COMPACT_EVERY = 32

# The medium parameters of the differentiable march, in the order of its
# [5] `med` tensor (JAX: volumetric_pallas.MedParams).
MED_NAMES = ("density_multiplier", "noise_offset", "absorption", "scattering", "brightness_ref")

# Launches of the CUDA kernels K5 (`launches`) and K6 (`raw_launches`); the
# plain versions do not count. When a launch_timer is a list, each launch
# appends its (start, end) CUDA events.
launches = 0
launch_timer = None
raw_launches = 0
raw_launch_timer = None


# ---------------------------------------------------------------------------
# Chebyshev fits (host side)
# ---------------------------------------------------------------------------


def cheb_fit(fn, lo: float, hi: float, deg: int):
    """Chebyshev interpolation coefficients (c0 ... c_deg, host floats) of
    fn over [lo, hi], from its values at the deg+1 Chebyshev points."""
    k = np.arange(deg + 1)
    nodes = np.cos(np.pi * (k + 0.5) / (deg + 1))
    x = 0.5 * (hi + lo) + 0.5 * (hi - lo) * nodes
    f = np.asarray(fn(x), np.float64)
    tk = np.arccos(nodes)
    n = deg + 1
    c = [float(2.0 / n * np.sum(f * np.cos(j * tk))) for j in range(n)]
    c[0] *= 0.5
    return tuple(c)


def cheb_eval(coeffs, lo, hi, x):
    """Clenshaw evaluation of host coefficients at x (a tensor)."""
    t = (2.0 * x - (lo + hi)) / x.new_full((), hi - lo)
    t2 = 2.0 * t
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    for c in reversed(coeffs[1:]):
        b1, b2 = t2 * b1 - b2 + c, b1
    return t * b1 - b2 + coeffs[0]


def cheb_eval_dual(c_lo, c_hi, lo, split, hi, in_hi, x):
    """Split-domain Clenshaw: one recurrence over per-lane selected
    coefficients (both tuples zero-padded to a common degree); `in_hi`
    selects the [split, hi] domain and its affine map."""
    n = max(len(c_lo), len(c_hi))
    c_lo = tuple(c_lo) + (0.0,) * (n - len(c_lo))
    c_hi = tuple(c_hi) + (0.0,) * (n - len(c_hi))
    t = torch.where(
        in_hi,
        (2.0 * x - (split + hi)) / x.new_full((), hi - split),
        (2.0 * x - (lo + split)) / x.new_full((), split - lo),
    )
    t2 = 2.0 * t
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    for a, b in zip(reversed(c_lo[1:]), reversed(c_hi[1:])):
        c = _select(in_hi, b, a, x) if a != b else a
        b1, b2 = t2 * b1 - b2 + c, b1
    return t * b1 - b2 + _select(in_hi, c_hi[0], c_lo[0], x)


def _select(cond, b, a, like):
    """where(cond, b, a) of two host floats, in like's dtype (torch.where
    of two Python scalars would give the default dtype)."""
    return torch.where(cond, like.new_full((), b), like.new_full((), a))


class TempSpec(NamedTuple):
    """Chebyshev fit of T⁴(r) over [lo, hi]."""

    lo: float
    hi: float
    coeffs: tuple


class TexSpec(NamedTuple):
    """Blackbody (split-domain log-XYZ fits: cx/cy/cz over [lo, split],
    cx2/cy2/cz2 over [split, hi]) or checker (c1/c2 XYZA, width, height)."""

    kind: str  # "blackbody" | "checker"
    beaming: float = 0.0
    lo: float = 0.0
    hi: float = 1.0
    split: float = 1.0
    cx: tuple = ()
    cy: tuple = ()
    cz: tuple = ()
    cx2: tuple = ()
    cy2: tuple = ()
    cz2: tuple = ()
    c1: tuple = ()
    c2: tuple = ()
    width: float = 1.0
    height: float = 1.0


class VolSpec(NamedTuple):
    """Everything the march needs of a volumetric disc and its geometry, as
    host scalars."""

    inner: float
    outer: float
    thickness: float
    density_multiplier: float
    brightness_ref: float
    absorption: float
    scattering: float
    noise_scale: tuple  # (3,)
    noise_offset: float
    step_size: float
    max_steps: int
    num_octaves: int
    key: int
    axis: tuple  # (3,)
    e1: tuple
    e2: tuple
    r_s: float
    a: float
    temp: TempSpec
    tex: TexSpec


def _host(v) -> float:
    return float(torch.as_tensor(v).detach().cpu().double())


def build_temp_spec(model, emit_lo=None, emit_hi=None) -> TempSpec:
    """Fit the Novikov-Thorne table's T⁴ over the disc's emitting range
    [emit_lo, emit_hi] ∩ the table's range (the density is zero outside)."""
    radii = model.radii.detach().cpu().double().numpy()
    lo = float(radii[0]) if emit_lo is None else max(float(radii[0]), float(emit_lo))
    hi = float(radii[-1]) if emit_hi is None else min(float(radii[-1]), float(emit_hi))
    if not hi > lo:
        lo, hi = float(radii[0]), float(radii[-1])

    def t4(r):
        rr = torch.as_tensor(r, dtype=model.radii.dtype, device=model.radii.device)
        return model.at(rr).detach().cpu().double().numpy() ** 4

    return TempSpec(lo=lo, hi=hi, coeffs=cheb_fit(t4, lo, hi, TEMP_DEG))


def build_tex_spec(texture) -> TexSpec:
    from gr_raytracer_tpu_torch.rendering import blackbody
    from gr_raytracer_tpu_torch.rendering.texture import BlackBodyMap, CheckerMap

    if isinstance(texture, CheckerMap):
        return TexSpec(
            kind="checker", beaming=_host(texture.beaming_exponent),
            c1=tuple(float(v) for v in texture.c1.detach().cpu().double()),
            c2=tuple(float(v) for v in texture.c2.detach().cpu().double()),
            width=_host(texture.width), height=_host(texture.height),
        )
    if not isinstance(texture, BlackBodyMap):
        raise NotImplementedError(
            f"the raymarch takes blackbody or checker textures, got {type(texture).__name__}"
        )
    log_t = texture.log_t.detach().cpu().double().numpy()
    # Fit the smooth Planck×CIE integral, not the linear table; below ~400 K
    # (log₁₀T = 2.6) the radiance underflows even float64.
    lo = max(float(log_t[0]), 2.6)
    hi = float(log_t[-1])
    split = min(max(BB_SPLIT, lo + 0.1), hi - 0.1)

    def chan(c):
        def f(l):
            t = torch.as_tensor(10.0**l, dtype=torch.float64)
            v = blackbody.blackbody_xyz(t)[:, c].numpy()
            return np.log10(np.maximum(v, 10.0**BB_LOG_FLOOR))

        return f

    return TexSpec(
        kind="blackbody", beaming=_host(texture.beaming_exponent), lo=lo, hi=hi, split=split,
        cx=cheb_fit(chan(0), lo, split, BB_DEG_LO), cy=cheb_fit(chan(1), lo, split, BB_DEG_LO),
        cz=cheb_fit(chan(2), lo, split, BB_DEG_LO), cx2=cheb_fit(chan(0), split, hi, BB_DEG_HI),
        cy2=cheb_fit(chan(1), split, hi, BB_DEG_HI), cz2=cheb_fit(chan(2), split, hi, BB_DEG_HI),
    )


def build_vol_spec(obj, geometry) -> VolSpec:
    """The march's spec from a concrete VolumetricDisc and geometry."""
    vec = lambda v: tuple(float(x) for x in v.detach().cpu().double())
    return VolSpec(
        inner=_host(obj.inner_radius), outer=_host(obj.outer_radius),
        thickness=_host(obj.thickness), density_multiplier=_host(obj.density_multiplier),
        brightness_ref=_host(obj.brightness_reference_temperature),
        absorption=_host(obj.absorption), scattering=_host(obj.scattering),
        noise_scale=vec(obj.noise_scale), noise_offset=_host(obj.noise_offset),
        step_size=_host(obj.step_size), max_steps=int(obj.max_steps),
        num_octaves=int(obj.num_octaves), key=int(obj.key), axis=vec(obj.axis), e1=vec(obj.e1),
        e2=vec(obj.e2), r_s=_host(geometry.radius), a=_host(getattr(geometry, "a", 0.0)),
        temp=build_temp_spec(obj.temperature_model, _host(obj.inner_radius), _host(obj.outer_radius)),
        tex=build_tex_spec(obj.texture),
    )


def supports(obj, geometry) -> bool:
    """Kernel coverage: Kerr, KerrBL or Schwarzschild (one Boyer-Lindquist
    radius formula covers the three at their own spin), a blackbody or
    checker texture, a Novikov-Thorne temperature table, the z axis."""
    from gr_raytracer_tpu_torch.geometry.kerr import Kerr
    from gr_raytracer_tpu_torch.geometry.kerr_bl import KerrBL
    from gr_raytracer_tpu_torch.geometry.schwarzschild import Schwarzschild
    from gr_raytracer_tpu_torch.rendering.temperature import TemperatureLUT
    from gr_raytracer_tpu_torch.rendering.texture import BlackBodyMap, CheckerMap

    return (
        isinstance(geometry, (Kerr, KerrBL, Schwarzschild))
        and isinstance(obj.texture, (BlackBodyMap, CheckerMap))
        and isinstance(obj.temperature_model, TemperatureLUT)
        and obj.axis_is_z()
    )


def march_length(obj, ro, rd, exit_d):
    """Clipped march length per lane ([N]): the same band ∩ cylinder
    interval math as `_march_bounds`, less the hole crossing the march jumps
    over. The sort key of the raymarch's lanes (fast_path.volumetric_lanes):
    K5 and K6 start their longest lanes first."""
    axis = obj.axis.to(ro.dtype)
    d_s = obj.step_size
    h_cut = obj.thickness * math.sqrt(math.log(1.0 / DENSITY_VERTICAL_CUTOFF))
    h0 = ro @ axis
    dh = rd @ axis
    big = torch.tensor(math.inf, dtype=ro.dtype, device=ro.device)
    flat = torch.abs(dh) <= 1e-12
    safe_dh = torch.where(flat, 1.0, dh)
    ta = (-h_cut - h0) / safe_dh
    tb = (h_cut - h0) / safe_dh
    in_band = torch.abs(h0) <= h_cut
    h_lo = torch.where(flat, torch.where(in_band, 0.0, big), torch.minimum(ta, tb))
    h_hi = torch.where(flat, torch.where(in_band, big, -big), torch.maximum(ta, tb))
    qa = 1.0 - dh * dh
    qb = 2.0 * (torch.sum(ro * rd, dim=-1) - h0 * dh)
    qc = torch.sum(ro * ro, dim=-1) - h0 * h0 - obj.outer_radius**2
    qdisc = qb * qb - 4.0 * qa * qc
    degen = qa <= 1e-8
    sq = torch.sqrt(torch.clamp(qdisc, min=0.0))
    safe_qa = torch.where(degen, 1.0, qa)
    miss = (~degen) & (qdisc < 0.0)
    r_lo = torch.where(degen, 0.0, torch.where(miss, big, (-qb - sq) / (2.0 * safe_qa)))
    r_hi = torch.where(degen, big, torch.where(miss, -big, (-qb + sq) / (2.0 * safe_qa)))
    d_budget = obj.max_steps * d_s
    d_lo = torch.clamp(torch.maximum(h_lo, r_lo), min=0.0)
    d_hi = torch.minimum(torch.minimum(h_hi, r_hi) + d_s, torch.minimum(exit_d, d_budget))
    qc_i = qc + (obj.outer_radius**2 - obj.inner_radius**2)
    qd_i = qb * qb - 4.0 * qa * qc_i
    enters = (~degen) & (qd_i > 0.0)
    sq_i = torch.sqrt(torch.clamp(qd_i, min=0.0))
    i_lo = torch.where(enters, (-qb - sq_i) / (2.0 * safe_qa), big)
    i_hi = torch.where(enters, (-qb + sq_i) / (2.0 * safe_qa), -big)
    hole = torch.clamp(torch.minimum(i_hi, d_hi) - torch.maximum(i_lo, d_lo), min=0.0)
    return torch.clamp(d_hi - d_lo - hole, min=0.0)


# ---------------------------------------------------------------------------
# The march in plain torch: the kernel's arithmetic, op for op
# ---------------------------------------------------------------------------


def _derived(spec: VolSpec) -> dict:
    """The host scalars the march derives from its spec, in float64, in the
    order the JAX kernel folds its Python constants; csrc/vol_raymarch.cu
    receives the same values."""
    a, r_s = spec.a, spec.r_s
    sqrt_m = (0.5 * r_s) ** 0.5
    return {
        "sigma": spec.absorption + spec.scattering,
        "h_cut": spec.thickness * math.sqrt(math.log(1.0 / DENSITY_VERTICAL_CUTOFF)),
        "outer2": spec.outer * spec.outer,
        "hole_q": spec.outer * spec.outer - spec.inner * spec.inner,
        "d_budget": float(spec.max_steps) * spec.step_size,
        "width": spec.outer - spec.inner,
        "r_floor": max(0.5 * spec.inner, 1e-3),
        "a2": a * a,
        "four_a2": 4.0 * a * a,
        "sqrt_m": sqrt_m,
        "a_sqrt_m": a * sqrt_m,
        "neg_a_rs": -a * r_s,
        "a2_rs": a * a * r_s,
    }


def _constants(spec: VolSpec, dtype, device) -> dict:
    """`_derived` plus 0-d tensors of the march dtype for every divisor and
    numerator the march divides with."""
    c = _derived(spec)
    t = lambda v: torch.tensor(float(v), dtype=dtype, device=device)
    c.update(
        thickness_t=t(spec.thickness), inner_t=t(spec.inner), width_t=t(c["width"]),
        sqrt_m_t=t(c["sqrt_m"]), br_t=t(spec.brightness_ref), ln10_t=t(_LN10),
        d_s_t=t(spec.step_size),
    )
    return c


class Medium(NamedTuple):
    """The medium parameters one march reads: host floats from the spec
    (K5) or 0-d tensors of the march dtype from a `med` tensor (K6), where
    σ = absorption + scattering is summed in the march dtype as JAX's
    _fwd_kernel sums it. The backward gives dm, off and br per-lane [N]
    tensors so that autograd returns per-lane partials."""

    dm: object
    off: object
    sigma: object
    ss: object
    br: object


def _medium(spec, c, med=None) -> Medium:
    if med is None:
        return Medium(spec.density_multiplier, spec.noise_offset, c["sigma"], spec.scattering, c["br_t"])
    dm, off, sa, ss, br = med.unbind(0)
    return Medium(dm, off, sa + ss, ss, br)


def _density(spec, c, px, py, pz, med: Medium):
    """Density at (px, py, pz), with r (distance from the axis), cos φ and
    sin φ of the in-plane azimuth."""
    axx, axy, axz = spec.axis
    h = torch.abs(px * axx + py * axy + pz * axz)
    cx, cy, cz = py * axz - pz * axy, pz * axx - px * axz, px * axy - py * axx
    r = torch.sqrt(torch.clamp(cx * cx + cy * cy + cz * cz, min=1e-30))
    inside = (r > spec.inner) & (r < spec.outer)
    q = h / c["thickness_t"]
    vertical = torch.exp(-(q * q))
    inside = inside & (vertical >= DENSITY_VERTICAL_CUTOFF)
    # Envelope radius floored at inner/2: value-neutral (the density is zero
    # for r <= inner) and keeps (inner/r)^1.5 finite on the axis.
    safe_r = torch.clamp(r, min=c["r_floor"])
    t_ratio = c["inner_t"] / safe_r
    radial_base = t_ratio * torch.sqrt(t_ratio)
    qo = spec.outer - safe_r
    qi = safe_r - spec.inner
    boundary = torch.exp(-1.0 / torch.clamp(qo * qo, min=1e-4) - 1.0 / torch.clamp(qi * qi, min=1e-4))
    e1x, e1y, e1z = spec.e1
    e2x, e2y, e2z = spec.e2
    x_loc = px * e1x + py * e1y + pz * e1z
    y_loc = px * e2x + py * e2y + pz * e2z
    inv_r = 1.0 / safe_r
    cphi = x_loc * inv_r
    sphi = y_loc * inv_r
    # The fBm octaves and the vertical term: one stacked Perlin evaluation,
    # summed in the order of fbm_lanes + 0.5·perlin3_lanes.
    ns0, ns1, ns2 = spec.noise_scale
    nx, ny, nz = r * ns0, cphi * ns1, sphi * ns1
    octaves = max(1, spec.num_octaves)
    freqs = noise.fbm_frequencies(octaves)
    p = noise.perlin3_lanes(
        spec.key, torch.stack([nx * f for f in freqs] + [r * 0.5]),
        torch.stack([ny * f for f in freqs] + [h * ns2]), torch.stack([nz * f for f in freqs] + [cphi]),
    )
    n = torch.zeros_like(r)
    for amplitude, octave in zip(noise.fbm_amplitudes(octaves), p[:-1].unbind(0)):
        n = n + amplitude * octave
    n = n + 0.5 * p[-1]
    n = torch.clamp(n + med.off, min=0.0) * med.dm
    density = torch.where(inside, n * radial_base * vertical * boundary, 0.0)
    return density, r, cphi, sphi


def _killing_coefficients(c, r_s, r):
    """(u^t, u^φ, ok) of the prograde circular orbit at BL radius r."""
    omega = c["sqrt_m_t"] / (r * torch.sqrt(r) + c["a_sqrt_m"])
    sigma = r * r
    g_tt = -(1.0 - r_s * r / sigma)
    g_tphi = c["neg_a_rs"] * r / sigma
    g_phiphi = r * r + c["a2"] + c["a2_rs"] * r / sigma
    ut_pre = g_tt + 2.0 * omega * g_tphi + omega * omega * g_phiphi
    ok = ut_pre < 0.0
    safe = torch.where(ok, -ut_pre, 1.0)
    u_t = torch.where(ok, 1.0 / torch.sqrt(safe), 0.0)
    return u_t, omega * u_t, ok


def _temperature(spec, r_dist):
    tp = spec.temp
    r = torch.clamp(r_dist, tp.lo, tp.hi)
    t4 = torch.clamp(cheb_eval(tp.coeffs, tp.lo, tp.hi, r), min=0.0)
    return torch.sqrt(torch.sqrt(t4))


def _texture_color(spec, c, u, v, temperature, redshift):
    """XYZ and texture alpha at (u, v, T, z)."""
    tex = spec.tex
    if tex.kind == "checker":
        ut = torch.floor(u * tex.width).to(torch.int32)
        vt = torch.floor(v * tex.height).to(torch.int32)
        even = (ut + vt) % 2 == 0
        x, y, z, alpha = (_select(even, tex.c1[i], tex.c2[i], u) for i in range(4))
    else:
        t_shift = torch.clamp(temperature * redshift, min=1e-10)
        l = torch.log(t_shift) / c["ln10_t"]
        in_dom = l >= tex.lo
        lc = torch.clamp(l, tex.lo, tex.hi)
        in_hi = lc >= tex.split
        ev = lambda c_lo, c_hi: torch.exp(
            cheb_eval_dual(c_lo, c_hi, tex.lo, tex.split, tex.hi, in_hi, lc) * _LN10
        )
        x = torch.where(in_dom, ev(tex.cx, tex.cx2), 0.0)
        y = torch.where(in_dom, ev(tex.cy, tex.cy2), 0.0)
        z = torch.where(in_dom, ev(tex.cz, tex.cz2), 0.0)
        alpha = torch.ones_like(x)
    if tex.beaming != 0.0:
        factor = torch.exp(tex.beaming * torch.log(torch.clamp(redshift, min=1e-30)))
        x, y, z = x * factor, y * factor, z * factor
    return x, y, z, alpha


def _sample_optics(spec, c, px, py, pz, obs_e, p_t, p_phi, med: Medium):
    """Everything of one sample that does not touch the carry: (density,
    emit_ok, intensity-scaled XYZ, texture alpha)."""
    density, r_axis, cphi, sphi = _density(spec, c, px, py, pz, med)
    emitting = density > 0.0
    # Boyer-Lindquist radius of the Cartesian sample (exact for a = 0 too).
    rho_sq = px * px + py * py + pz * pz
    dd = rho_sq - c["a2"]
    r_bl = torch.sqrt(torch.clamp(0.5 * (dd + torch.sqrt(dd * dd + c["four_a2"] * pz * pz)), min=1e-30))
    u_t, u_phi, orbit_ok = _killing_coefficients(c, spec.r_s, r_bl)
    emitter_energy = u_t * p_t + u_phi * p_phi
    emit_ok = emitting & orbit_ok & (torch.abs(emitter_energy) > 0.0)
    safe_e = torch.where(emit_ok, emitter_energy, 1.0)
    redshift = torch.where(emit_ok, obs_e / safe_e, 1.0)

    temperature = _temperature(spec, r_axis)
    r_norm = (r_axis - spec.inner) / c["width_t"]
    u_uv = 0.5 + 0.5 * r_norm * cphi
    v_uv = 0.5 + 0.5 * r_norm * sphi
    lx, ly, lz, lalpha = _texture_color(spec, c, u_uv, v_uv, temperature, redshift)
    t_ratio = temperature / med.br
    t2 = t_ratio * t_ratio
    intensity = t2 * t2
    return density, emit_ok, intensity * lx, intensity * ly, intensity * lz, lalpha


def _march_bounds(spec, c, ro, rd, exit_d, active):
    """The possibly-emitting sample range [k0·d_s, d_hi) of each lane and
    its inner-hole crossing: (k0, d_hi, empty, i_lo, i_hi, k_hole_exit).
    The density is identically zero outside the band |h| <= h_cut, outside
    r < outer and inside r < inner; along the chord h is linear and r²
    quadratic, so each is one interval. The hole interval is shrunk by one
    step per side, so rounding can only under-skip."""
    d_s = spec.step_size
    h_cut = c["h_cut"]
    rox, roy, roz = ro.unbind(-1)
    rdx, rdy, rdz = rd.unbind(-1)
    axx, axy, axz = spec.axis
    h0 = rox * axx + roy * axy + roz * axz
    dh = rdx * axx + rdy * axy + rdz * axz
    big = 3.4e38
    flat = torch.abs(dh) <= 1e-12
    safe_dh = torch.where(flat, 1.0, dh)
    ta = (-h_cut - h0) / safe_dh
    tb = (h_cut - h0) / safe_dh
    in_band = torch.abs(h0) <= h_cut
    h_lo = torch.where(flat, torch.where(in_band, 0.0, big), torch.minimum(ta, tb))
    h_hi = torch.where(flat, torch.where(in_band, big, -big), torch.maximum(ta, tb))
    qa = 1.0 - dh * dh
    qb = 2.0 * (rox * rdx + roy * rdy + roz * rdz - h0 * dh)
    qc = rox * rox + roy * roy + roz * roz - h0 * h0 - c["outer2"]
    qdisc = qb * qb - 4.0 * qa * qc
    degen = qa <= 1e-8
    sq = torch.sqrt(torch.clamp(qdisc, min=0.0))
    safe_qa = torch.where(degen, 1.0, qa)
    miss = (~degen) & (qdisc < 0.0)
    r_lo = torch.where(degen, 0.0, torch.where(miss, big, (-qb - sq) / (2.0 * safe_qa)))
    r_hi = torch.where(degen, big, torch.where(miss, -big, (-qb + sq) / (2.0 * safe_qa)))
    d_lo = torch.clamp(torch.maximum(h_lo, r_lo), min=0.0)
    d_hi = torch.minimum(torch.minimum(h_hi, r_hi) + d_s, torch.clamp(exit_d, max=c["d_budget"]))
    k0 = torch.floor(d_lo / c["d_s_t"])
    k0 = torch.clamp(k0 - 1.0, min=0.0)
    empty = (k0 * d_s >= d_hi) | ~active
    qc_i = qc + c["hole_q"]
    qd_i = qb * qb - 4.0 * qa * qc_i
    enters = (~degen) & (qd_i > 0.0)
    sq_i = torch.sqrt(torch.clamp(qd_i, min=0.0))
    i_lo = torch.where(enters, (-qb - sq_i) / (2.0 * safe_qa) + d_s, big)
    i_hi = torch.where(enters, (-qb + sq_i) / (2.0 * safe_qa) - d_s, -big)
    k_hole_exit = torch.ceil(i_hi / c["d_s_t"])
    return k0, d_hi, empty, i_lo, i_hi, k_hole_exit


class _Lanes(NamedTuple):
    """The plain march's per-lane inputs and carry, [N] each (ro, rd [N, 3])."""

    ro: torch.Tensor
    rd: torch.Tensor
    obs_e: torch.Tensor
    p_t: torch.Tensor
    p_phi: torch.Tensor
    d_hi: torch.Tensor
    i_lo: torch.Tensor
    i_hi: torch.Tensor
    k_hole_exit: torch.Tensor
    k: torch.Tensor
    trans: torch.Tensor
    acc: torch.Tensor  # [N, 3]
    ws: torch.Tensor
    wt: torch.Tensor
    done: torch.Tensor
    samples: torch.Tensor  # int32


_CARRY = ("k", "trans", "acc", "ws", "wt", "done", "samples")


def _next_k(spec, s, k):
    """The sample after k; when it lands in the hole interval, the hole's
    exit (every skipped sample is an exact zero)."""
    k_next = k + 1.0
    d_next = k_next * spec.step_size
    in_hole = (d_next >= s.i_lo) & (d_next < s.i_hi)
    return torch.where(in_hole, torch.maximum(s.k_hole_exit, k_next), k_next)


def _march_step(spec, c, s: _Lanes, med: Medium) -> _Lanes:
    """One sample of every lane of `s`; done lanes stay frozen."""
    d_s = spec.step_size
    live = ~s.done
    d_o = s.k * d_s
    p = s.ro + s.rd * d_o[:, None]
    density, emit_ok, ex, ey, ez, lalpha = _sample_optics(
        spec, c, p[:, 0], p[:, 1], p[:, 2], s.obs_e, s.p_t, s.p_phi, med
    )
    attenuation = torch.exp(-d_s * density * med.sigma)
    trans = s.trans * attenuation
    weight = trans * attenuation * med.ss * density * d_s
    wscale = weight * emit_ok.to(weight.dtype)
    acc = s.acc + wscale[:, None] * torch.stack([ex, ey, ez], dim=-1)
    alpha_w = torch.where(emit_ok, density * d_s, 0.0)
    ws = s.ws + torch.clamp(lalpha, 0.0, 1.0) * alpha_w
    wt = s.wt + alpha_w
    k_next = _next_k(spec, s, s.k)
    done = (k_next * d_s >= s.d_hi) | (trans < SATURATION_EPS)
    keep = lambda new, old: torch.where(live, new, old)
    return s._replace(
        k=keep(k_next, s.k), trans=keep(trans, s.trans), acc=torch.where(live[:, None], acc, s.acc),
        ws=keep(ws, s.ws), wt=keep(wt, s.wt), done=s.done | (live & done),
        samples=s.samples + live.to(torch.int32),
    )


def march_compacted(lanes, step, carry, max_steps):
    """Run `step` (lanes -> lanes) on the lanes that are not done, at most
    max_steps times, on integrator.run_lanes: blocks of _COMPACT_EVERY
    steps over the lanes not done at each block's start on the CPU, on the
    card blocks doubling from integrator.BLOCK_FIRST to BLOCK_MAX, each
    replayed from a CUDA graph of one step; the `carry` fields of each
    gathered batch are written back. `lanes` is a NamedTuple of per-lane
    tensors with a bool `done`; updated in place."""

    def put(state, idx, sub):
        for name in carry:
            getattr(state, name)[idx] = getattr(sub, name)

    blocks = (integ.BLOCK_FIRST, integ.BLOCK_MAX) if lanes.done.is_cuda else (_COMPACT_EVERY, _COMPACT_EVERY)
    integ.run_lanes(lambda s, _: step(s), lanes, {}, lambda s: ~s.done, max_steps, name="plain",
                    take=lambda state, idx: type(state)(*(t[idx] for t in state)), put=put, blocks=blocks)
    return lanes


def _march(spec, c, med: Medium, ro, rd, obs_e, p_t, p_phi, active, exit_d) -> _Lanes:
    """Every lane marched from its first sample; returns the final carry."""
    k0, d_hi, empty, i_lo, i_hi, k_hole_exit = _march_bounds(spec, c, ro, rd, exit_d, active)
    n = ro.shape[0]
    zeros = torch.zeros(n, dtype=ro.dtype, device=ro.device)
    lanes = _Lanes(
        ro, rd, obs_e, p_t, p_phi, d_hi, i_lo, i_hi, k_hole_exit, k0, torch.ones_like(zeros),
        torch.zeros((n, 3), dtype=ro.dtype, device=ro.device), zeros, zeros.clone(), empty.clone(),
        torch.zeros(n, dtype=torch.int32, device=ro.device),
    )
    return march_compacted(lanes, lambda s: _march_step(spec, c, s, med), _CARRY, spec.max_steps)


def raymarch_plain(spec: VolSpec, ro, rd, obs_e, p_t, p_phi, active, exit_d):
    """The march in plain torch on ro's device; same arguments and results
    as `raymarch`, its lanes run by march_compacted."""
    _check_args(spec, ro, rd, obs_e, p_t, p_phi, active, exit_d)
    c = _constants(spec, ro.dtype, ro.device)
    lanes = _march(spec, c, _medium(spec, c), ro, rd, obs_e, p_t, p_phi, active, exit_d)
    # The texture-alpha quotient, gated at ALPHA_WT_MIN.
    ok = lanes.wt > ALPHA_WT_MIN
    texture_alpha = torch.where(ok, lanes.ws / torch.where(ok, lanes.wt, 1.0), 1.0)
    alpha = (1.0 - lanes.trans) * texture_alpha
    return torch.cat([lanes.acc, alpha[:, None]], dim=-1), lanes.samples


def raymarch_raw_plain(spec: VolSpec, med, ro, rd, obs_e, p_t, p_phi, active, exit_d):
    """K6's plain version: the march of `raymarch_plain` with the medium
    parameters read from `med` ([5], MED_NAMES, of ro's dtype and device),
    returning the raw reductions (acc [N, 3], transparency, alpha_w_sum,
    alpha_w_tot [N]) of JAX's _fwd_kernel."""
    _check_args(spec, ro, rd, obs_e, p_t, p_phi, active, exit_d, med)
    c = _constants(spec, ro.dtype, ro.device)
    lanes = _march(spec, c, _medium(spec, c, med), ro, rd, obs_e, p_t, p_phi, active, exit_d)
    return lanes.acc, lanes.trans, lanes.ws, lanes.wt


def _check_args(spec, ro, rd, obs_e, p_t, p_phi, active, exit_d, med=None):
    if med is not None and (med.shape != (len(MED_NAMES),) or med.dtype != ro.dtype or med.device != ro.device):
        raise ValueError(f"med must be [{len(MED_NAMES)}] of ro's dtype and device, got {tuple(med.shape)} {med.dtype}")
    if ro.dim() != 2 or ro.shape[1] != 3 or rd.shape != ro.shape:
        raise ValueError(f"ro and rd must be [N, 3], got {tuple(ro.shape)} and {tuple(rd.shape)}")
    if ro.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ro must be float32 or float64, got {ro.dtype}")
    n = ro.shape[0]
    for name, v in (("obs_e", obs_e), ("p_t", p_t), ("p_phi", p_phi), ("exit_d", exit_d)):
        if v.shape != (n,) or v.dtype != ro.dtype or v.device != ro.device:
            raise ValueError(f"{name} must be [N] of ro's dtype and device, got {tuple(v.shape)} {v.dtype}")
    if active.shape != (n,) or active.dtype != torch.bool or active.device != ro.device:
        raise ValueError("active must be a [N] bool tensor on ro's device")
    if rd.dtype != ro.dtype or rd.device != ro.device:
        raise ValueError("rd must have ro's dtype and device")
    if not 1 <= spec.num_octaves <= MAX_OCTAVES:
        raise NotImplementedError(f"the raymarch takes 1 to {MAX_OCTAVES} octaves, got {spec.num_octaves}")
    if len(spec.temp.coeffs) != TEMP_DEG + 1:
        raise ValueError(f"the temperature fit must have {TEMP_DEG + 1} coefficients")


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

_BB_N = max(BB_DEG_LO, BB_DEG_HI) + 1


class _HostParams(ctypes.Structure):
    """struct HostParams of csrc/vol_raymarch.cu, field for field."""

    _fields_ = [(name, ctypes.c_double) for name in (
        "inner", "outer", "thickness", "dm", "br", "sca", "noise_off", "d_s", "sigma",
        "ns0", "ns1", "ns2", "h_cut", "outer2", "hole_q", "d_budget", "width", "r_floor",
        "r_s", "a2", "four_a2", "sqrt_m", "a_sqrt_m", "neg_a_rs", "a2_rs",
        "temp_lo", "temp_hi", "temp_sum", "temp_width",
        "beaming", "tex_lo", "tex_hi", "tex_split", "sum_lo", "w_lo", "sum_hi", "w_hi",
        "chk_w", "chk_h",
    )] + [
        ("axis", ctypes.c_double * 3), ("e1", ctypes.c_double * 3), ("e2", ctypes.c_double * 3),
        ("c1", ctypes.c_double * 4), ("c2", ctypes.c_double * 4),
        ("temp_c", ctypes.c_double * (TEMP_DEG + 1)),
        ("bb_lo", (ctypes.c_double * _BB_N) * 3), ("bb_hi", (ctypes.c_double * _BB_N) * 3),
        ("amp", ctypes.c_double * MAX_OCTAVES),
        ("max_steps", ctypes.c_int), ("octaves", ctypes.c_int), ("checker", ctypes.c_int),
        ("key", ctypes.c_uint32),
    ]


def _host_params(spec: VolSpec) -> _HostParams:
    d = _derived(spec)
    tex = spec.tex
    hp = _HostParams(
        inner=spec.inner, outer=spec.outer, thickness=spec.thickness,
        dm=spec.density_multiplier, br=spec.brightness_ref, sca=spec.scattering,
        noise_off=spec.noise_offset, d_s=spec.step_size, ns0=spec.noise_scale[0],
        ns1=spec.noise_scale[1], ns2=spec.noise_scale[2], r_s=spec.r_s,
        temp_lo=spec.temp.lo, temp_hi=spec.temp.hi, temp_sum=spec.temp.lo + spec.temp.hi,
        temp_width=spec.temp.hi - spec.temp.lo, beaming=tex.beaming, tex_lo=tex.lo,
        tex_hi=tex.hi, tex_split=tex.split, sum_lo=tex.lo + tex.split,
        w_lo=tex.split - tex.lo, sum_hi=tex.split + tex.hi, w_hi=tex.hi - tex.split,
        chk_w=tex.width, chk_h=tex.height, max_steps=int(spec.max_steps),
        octaves=max(1, int(spec.num_octaves)), checker=int(tex.kind == "checker"),
        key=int(spec.key) & noise.MASK32,
        **{k: d[k] for k in ("sigma", "h_cut", "outer2", "hole_q", "d_budget", "width", "r_floor",
                              "a2", "four_a2", "sqrt_m", "a_sqrt_m", "neg_a_rs", "a2_rs")},
    )
    hp.axis[:], hp.e1[:], hp.e2[:] = spec.axis, spec.e1, spec.e2
    if tex.kind == "checker":
        hp.c1[:], hp.c2[:] = tex.c1, tex.c2
    else:
        # Zero-padded to a common degree, as cheb_eval_dual pads them.
        pad = lambda c: tuple(c) + (0.0,) * (_BB_N - len(c))
        for i, (lo, hi) in enumerate(((tex.cx, tex.cx2), (tex.cy, tex.cy2), (tex.cz, tex.cz2))):
            hp.bb_lo[i][:], hp.bb_hi[i][:] = pad(lo), pad(hi)
    hp.temp_c[:] = spec.temp.coeffs
    amps = noise.fbm_amplitudes(hp.octaves)
    hp.amp[: len(amps)] = amps
    return hp


_bound: dict = {}


def _entry(dtype, raw=False):
    """The C entry point of K5 (K6 with `raw`) for `dtype`, built on first
    use."""
    fn = _bound.get((dtype, raw))
    if fn is None:
        from gr_raytracer_tpu_torch.ops import cuda_build

        lib = cuda_build.load("vol_raymarch.cu")
        name = "vol_raymarch_raw" if raw else "vol_raymarch"
        fn = getattr(lib, f"{name}_f32" if dtype == torch.float32 else f"{name}_f64")
        p = ctypes.c_void_p
        if raw:
            fn.argtypes = [ctypes.POINTER(_HostParams)] + [p] * 8 + [ctypes.c_int64, p, p]
        else:
            fn.argtypes = [ctypes.POINTER(_HostParams)] + [p] * 7 + [ctypes.c_int64, p, p, p]
        fn.restype = ctypes.c_int
        _bound[(dtype, raw)] = fn
    return fn


def _launch(name, fn, timer, device, *args):
    """Call the C entry point `fn` on the current stream of `device` (the
    stream is its last argument), raising on a CUDA error; when `timer` is
    a list, append the launch's (start, end) CUDA events to it."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        if timer is not None:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
        err = fn(*args, stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
        if timer is not None:
            end.record(stream)
            timer.append((start, end))


def _cuda_lanes(ins):
    if ins[0].device.type != "cuda":
        raise ValueError(f"unsupported device {ins[0].device}")
    if not all(v.is_contiguous() for v in ins):
        raise ValueError("the raymarch takes contiguous inputs")


def raymarch(spec: VolSpec, ro, rd, obs_e, p_t, p_phi, active, exit_d):
    """March N lanes from ro along the unit rd, [N, 3] each; obs_e, p_t,
    p_phi and exit_d (the exit distance, 0 on inactive lanes) are [N],
    active [N] bool. Returns (XYZA [N, 4], samples [N] int32: the samples
    each lane marched). A CUDA tensor goes through the kernel
    csrc/vol_raymarch.cu, a CPU tensor through `raymarch_plain`."""
    global launches
    _check_args(spec, ro, rd, obs_e, p_t, p_phi, active, exit_d)
    if ro.device.type == "cpu":
        return raymarch_plain(spec, ro, rd, obs_e, p_t, p_phi, active, exit_d)
    ins = (ro, rd, obs_e, p_t, p_phi, exit_d, active)
    _cuda_lanes(ins)
    n = ro.shape[0]
    out = torch.empty((n, 4), dtype=ro.dtype, device=ro.device)
    samples = torch.empty(n, dtype=torch.int32, device=ro.device)
    hp = _host_params(spec)
    _launch("vol_raymarch", _entry(ro.dtype), launch_timer, ro.device, ctypes.byref(hp),
            *(v.data_ptr() for v in ins), n, out.data_ptr(), samples.data_ptr())
    launches += 1
    return out, samples


def raymarch_raw(spec: VolSpec, med, ro, rd, obs_e, p_t, p_phi, active, exit_d):
    """K6: the march of `raymarch` with the medium parameters read at run
    time from `med` ([5], MED_NAMES, of ro's dtype and device: a fit step
    never rebuilds the kernel's parameter struct from them) and the raw
    reductions as its results: (acc [N, 3], transparency, alpha_w_sum,
    alpha_w_tot [N]). A CUDA tensor goes through csrc/vol_raymarch.cu with
    its raw-output flag, a CPU tensor through `raymarch_raw_plain`."""
    global raw_launches
    _check_args(spec, ro, rd, obs_e, p_t, p_phi, active, exit_d, med)
    if ro.device.type == "cpu":
        return raymarch_raw_plain(spec, med, ro, rd, obs_e, p_t, p_phi, active, exit_d)
    ins = (ro, rd, obs_e, p_t, p_phi, exit_d, active)
    _cuda_lanes(ins)
    n = ro.shape[0]
    out = torch.empty((n, 6), dtype=ro.dtype, device=ro.device)
    med = med.contiguous()
    hp = _host_params(spec)
    _launch("vol_raymarch_raw", _entry(ro.dtype, raw=True), raw_launch_timer, ro.device, ctypes.byref(hp),
            med.data_ptr(), *(v.data_ptr() for v in ins), n, out.data_ptr())
    raw_launches += 1
    return out[:, 0:3], out[:, 3], out[:, 4], out[:, 5]
