"""Perlin-noise volumetric accretion disc (port of
gr_raytracer_tpu/objects/volumetric_disc.py).

The bounding volume is an inner and an outer cylinder clipped to
±3·thickness caps. The march records where a ray segment crosses its
boundary (ops/geodesic_march.py, vols, on the kernel path; `segment_hit`
on the RKF45 path); shading then runs a straight-line constant-step
raymarch from each such entry point: Perlin-fBm density with a seamless
cylindrical noise mapping, Beer-Lambert attenuation, per-sample redshift
from the ray's conserved (p_t, p_φ) and the local circular orbit, T⁴
emission weighting and texture alpha. The kernel path raymarches with K5
(ops/volumetric_march.py, a z axis and Chebyshev fits of the temperature
and texture); `raymarch` is the RKF45 path's, for any axis, with the
scene's own temperature model and texture, and runs its samples through
integrator.run_lanes (on the card a CUDA graph of one loop iteration, up
to RAYMARCH_UNROLL samples of every lane still marching); with
differentiable=True it runs its samples in checkpointed segments
(integrator.run_blocks), for reverse mode. Projections onto
the axis and the disc-plane basis sum elementwise in index order
(`_along`), on both paths, as every per-ray contraction does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from gr_raytracer_tpu_torch.geometry import chart as charts
from gr_raytracer_tpu_torch.geometry.base import abs_, clip, dot, maximum, sqrt_nonneg
from gr_raytracer_tpu_torch.ops import noise

MIN_INTERSECTION_T = 1e-9
# Saturation early exit: once transparency < eps every remaining emission
# weight carries that factor, so truncating changes XYZ by < eps·intensity.
SATURATION_EPS = 1e-7
DENSITY_VERTICAL_CUTOFF = 1e-3
CAP_HEIGHT_SIGMAS = 3.0
# Texture-alpha quotient gate: alpha_w_tot <= this counts as "nothing
# emitted" (texture alpha 1), which keeps the ws/wt quotient finite.
ALPHA_WT_MIN = 1e-18
# The RKF45 path's raymarch on the card: samples a loop iteration takes of
# every lane, at most RAYMARCH_UNROLL and with lanes · samples within
# RAYMARCH_BATCH (the iteration's per-sample terms are [lanes, samples]).
RAYMARCH_UNROLL = 32
RAYMARCH_BATCH = 1 << 21
# The differentiable raymarch's checkpointed segments: samples, at most.
RAYMARCH_SEGMENT = 256


def _along(v, w):
    """v · w over the last axis of v [..., 3] and w [3], summed in index
    order."""
    return v[..., 0] * w[0] + v[..., 1] * w[1] + v[..., 2] * w[2]


@dataclass(frozen=True)
class VolumetricDisc:
    inner_radius: torch.Tensor
    outer_radius: torch.Tensor
    temperature_model: object  # TemperatureLUT
    texture: object
    axis: torch.Tensor  # [3] unit
    e1: torch.Tensor  # [3] disc-plane basis
    e2: torch.Tensor  # [3]
    key: int  # uint32 noise-hash key (noise.permutation_table)
    thickness: torch.Tensor
    density_multiplier: torch.Tensor
    brightness_reference_temperature: torch.Tensor
    absorption: torch.Tensor
    scattering: torch.Tensor
    noise_scale: torch.Tensor  # [3]
    noise_offset: torch.Tensor
    step_size: torch.Tensor
    num_octaves: int
    max_steps: int
    # Reverse mode through `raymarch`: checkpointed segments of samples.
    differentiable: bool = False

    @classmethod
    def create(
        cls, inner_radius, outer_radius, temperature_model, texture, axis=(0.0, 0.0, 1.0),
        num_octaves=8, perlin_seed=0, max_steps=50000, step_size=0.001, thickness=0.03,
        density_multiplier=500.0, brightness_reference_temperature=1000.0, absorption=0.3,
        scattering=0.4, noise_scale=(1.0, 1.0, 1.0), noise_offset=0.0, dtype=torch.float64,
        device="cpu", differentiable=False,
    ):
        ax = np.asarray(axis, np.float64)
        if np.dot(ax, ax) <= np.finfo(np.float64).eps:
            ax = np.array([0.0, 0.0, 1.0])
        ax = ax / np.linalg.norm(ax)
        # Disc-plane basis (the reference's volumetric_disc.rs:66-73).
        pick = np.array([0.0, 1.0, 0.0]) if abs(ax[0]) > 0.9 else np.array([1.0, 0.0, 0.0])
        e1 = np.cross(pick, ax)
        e1 = e1 / np.linalg.norm(e1)
        e2 = np.cross(ax, e1)
        e2 = e2 / np.linalg.norm(e2)
        # A tensor parameter keeps its graph (a differentiable medium).
        as_ = lambda v: (v.to(dtype=dtype, device=device) if isinstance(v, torch.Tensor)  # noqa: E731
                         else torch.as_tensor(np.asarray(v, np.float64), dtype=dtype, device=device))
        return cls(
            inner_radius=as_(inner_radius), outer_radius=as_(outer_radius),
            temperature_model=temperature_model, texture=texture, axis=as_(ax), e1=as_(e1),
            e2=as_(e2), key=noise.permutation_table(perlin_seed), thickness=as_(thickness),
            density_multiplier=as_(density_multiplier),
            brightness_reference_temperature=as_(brightness_reference_temperature),
            absorption=as_(absorption), scattering=as_(scattering), noise_scale=as_(noise_scale),
            noise_offset=as_(noise_offset), step_size=as_(step_size), num_octaves=int(num_octaves),
            max_steps=int(max_steps), differentiable=bool(differentiable),
        )

    def axis_is_z(self) -> bool:
        """The kernels' bounding volume and raymarch take the z axis only."""
        return bool(np.allclose(self.axis.detach().cpu().numpy(), [0.0, 0.0, 1.0]))

    def density(self, p):
        """Perlin-fBm gas density at points p [..., 3]."""
        h = abs_(_along(p, self.axis))
        cross = torch.linalg.cross(p, self.axis.expand_as(p))
        r = torch.sqrt(maximum(dot(cross, cross), 1e-30))
        inside = (r > self.inner_radius) & (r < self.outer_radius)
        hr = h / self.thickness
        vertical = torch.exp(-(hr * hr))
        inside = inside & (vertical >= DENSITY_VERTICAL_CUTOFF)
        # The envelope radius is floored at inner/2: the density is 0 there
        # anyway, and the floor keeps (inner/r)^1.5 finite on the axis.
        safe_r = maximum(r, maximum(0.5 * self.inner_radius, 1e-3))
        radial_base = torch.pow(self.inner_radius / safe_r, 1.5)
        out_gap = self.outer_radius - safe_r
        in_gap = safe_r - self.inner_radius
        boundary = torch.exp(
            -1.0 / maximum(out_gap * out_gap, 1e-4) - 1.0 / maximum(in_gap * in_gap, 1e-4)
        )
        # cos φ and sin φ of the in-plane azimuth: |p × axis| = r.
        cphi = _along(p, self.e1) / safe_r
        sphi = _along(p, self.e2) / safe_r
        # φ mapped to a circle in noise space: seam-free periodic noise.
        noise_p = torch.stack([r * self.noise_scale[0], cphi * self.noise_scale[1], sphi * self.noise_scale[1]], -1)
        n = noise.fbm(self.key, noise_p, self.num_octaves, 0.5)
        vert_p = torch.stack([r * 0.5, h * self.noise_scale[2], cphi], dim=-1)
        n = n + 0.5 * noise.perlin3(self.key, vert_p)
        n = maximum(n + self.noise_offset, 0.0) * self.density_multiplier
        return torch.where(inside, n * radial_base * vertical * boundary, 0.0)

    def uv(self, p):
        """Texture (u, v) of points p [..., 3]: radius across the annulus and
        azimuth, mapped into the unit square."""
        x = _along(p, self.e1)
        y = _along(p, self.e2)
        rr = torch.sqrt(x * x + y * y)
        phi = torch.atan2(y, x)
        r = (rr - self.inner_radius) / (self.outer_radius - self.inner_radius)
        return 0.5 + 0.5 * r * torch.cos(phi), 0.5 + 0.5 * r * torch.sin(phi)

    def _candidate_ts(self, s, d):
        """Every boundary-crossing parameter of the segments s + t·d,
        t ∈ [0, 1]: two roots each for the clipped inner and outer cylinders
        and the two annular caps. Returns (t [..., 6], valid [..., 6])."""
        cap_h = self.thickness * CAP_HEIGHT_SIGMAS
        axis = self.axis

        def cylinder_roots(radius):
            v = torch.linalg.cross(s, axis.expand_as(s))
            w = torch.linalg.cross(d, axis.expand_as(d))
            a = torch.sum(w * w, dim=-1)
            b = 2.0 * torch.sum(v * w, dim=-1)
            c = torch.sum(v * v, dim=-1) - radius * radius
            disc = b * b - 4.0 * a * c
            ok = (a >= 1e-10 * torch.sum(d * d, dim=-1)) & (disc >= 0.0)
            sq = sqrt_nonneg(disc)
            safe_a = torch.where(a > 0.0, a, 1.0)
            roots = []
            for sign in (-1.0, 1.0):
                t = (-b + sign * sq) / (2.0 * safe_a)
                p = s + t[..., None] * d
                height_ok = torch.abs(_along(p, axis)) <= cap_h
                roots.append((t, ok & (t >= 0.0) & (t <= 1.0) & height_ok))
            return roots

        def cap_root(pos):
            denom = _along(d, axis)
            s_h = _along(s, axis)
            safe = torch.where(torch.abs(denom) > 1e-10, denom, 1.0)
            t = (pos - s_h) / safe
            p = s + t[..., None] * d
            cr = torch.linalg.cross(p, axis.expand_as(p))
            r_sq = torch.sum(cr * cr, dim=-1)
            ok = (
                (torch.abs(denom) > 1e-10) & (t >= 0.0) & (t <= 1.0)
                & (r_sq <= self.outer_radius**2) & (r_sq >= self.inner_radius**2)
            )
            return t, ok

        roots = cylinder_roots(self.outer_radius) + cylinder_roots(self.inner_radius)
        roots.append(cap_root(cap_h))
        roots.append(cap_root(-cap_h))
        return torch.stack([r[0] for r in roots], dim=-1), torch.stack([r[1] for r in roots], dim=-1)

    def exit_distance(self, ro, rd):
        """Distance along the unit rd from ro to the first boundary crossing
        past MIN_INTERSECTION_T, or the full march length step·max_steps."""
        max_dist = self.step_size * self.max_steps
        t_all, valid = self._candidate_ts(ro, rd * max_dist)
        valid = valid & (t_all > MIN_INTERSECTION_T)
        t = torch.amin(torch.where(valid, t_all, math.inf), dim=-1)
        return torch.where(torch.isfinite(t), t * max_dist, max_dist)

    def segment_hit(self, cart_prev, cart_new):
        """(hit, t, point, uv) of [N] segments: the first boundary crossing
        past MIN_INTERSECTION_T."""
        s = cart_prev[..., 1:4]
        d = cart_new[..., 1:4] - s
        t_all, valid = self._candidate_ts(s, d)
        valid = valid & (t_all > MIN_INTERSECTION_T)
        t = torch.amin(torch.where(valid, t_all, math.inf), dim=-1)
        hit = torch.isfinite(t)
        t = torch.where(hit, t, 0.0)
        point = s + t[..., None] * d
        u, v = self.uv(point)
        return hit, t, point, torch.stack([u, v], dim=-1)

    def raymarch(self, geometry, ro, rd, obs_energy, p_t, p_phi, active, compact=True, unroll=None):
        """Constant-step raymarch of [M] lanes: ro, rd [M, 3] (rd unit), the
        ray's conserved scalars [M], active [M]. Returns XYZA [M, 4]; an
        inactive lane gives 0. Marches until every lane has passed its exit
        distance or saturated, at most max_steps samples; compact as in
        integrator.run_lanes.

        Each loop iteration takes `unroll` samples of every lane: their
        densities, orbits, temperatures and texture colors at once, then
        the fold over them in sample order, so a lane's result is the one
        sample at a time gives. The default takes 1 on the CPU (the lanes
        keep their places in the vectors) and on the card up to
        RAYMARCH_UNROLL, as many as keep M · unroll within
        RAYMARCH_BATCH.

        differentiable (the object's field): segments of
        min(RAYMARCH_SEGMENT, max_steps) samples (rounded up to whole
        iterations), each checkpointed and skipped once every lane is done
        (integrator.run_blocks), as the JAX package's; a lane's samples
        stop at max_steps in both forms, so their forwards are equal."""
        from gr_raytracer_tpu_torch.rendering.integrator import run_blocks, run_lanes

        dtype, device = ro.dtype, ro.device
        m = ro.shape[0]
        if unroll is None:
            unroll = 1
            while ro.is_cuda and unroll < RAYMARCH_UNROLL and 2 * unroll * m <= RAYMARCH_BATCH:
                unroll *= 2
        exit_d = torch.where(active, self.exit_distance(ro, rd), 0.0)
        carry = dict(
            d_o=torch.zeros((m,), dtype=dtype, device=device),
            transparency=torch.ones((m,), dtype=dtype, device=device),
            accum=torch.zeros((m, 3), dtype=dtype, device=device),
            alpha_w_sum=torch.zeros((m,), dtype=dtype, device=device),
            alpha_w_tot=torch.zeros((m,), dtype=dtype, device=device),
            done=~active,
            taken=torch.zeros((m,), dtype=torch.int32, device=device),
        )
        lanes = dict(ro=ro, rd=rd, obs=obs_energy, p_t=p_t, p_phi=p_phi, exit_d=exit_d)
        step = lambda c, ln: self._samples(geometry, c, ln, unroll)  # noqa: E731
        running = lambda c: ~c["done"]  # noqa: E731
        compact = compact and ro.is_cuda
        if self.differentiable:
            iters = -(-min(RAYMARCH_SEGMENT, self.max_steps) // unroll)

            def segment(c, ln):
                for _ in range(iters):
                    c = step(c, ln)
                return c

            carry = run_blocks(segment, carry, lanes, running, -(-self.max_steps // (iters * unroll)), iters,
                               compact, name="raymarch_diff")
        else:
            carry = run_lanes(step, carry, lanes, running, -(-self.max_steps // unroll), compact=compact,
                              name="raymarch")
        physical_opacity = 1.0 - carry["transparency"]
        wt = carry["alpha_w_tot"]
        texture_alpha = torch.where(
            wt > ALPHA_WT_MIN, carry["alpha_w_sum"] / torch.where(wt > ALPHA_WT_MIN, wt, 1.0), 1.0
        )
        return torch.cat([carry["accum"], (physical_opacity * texture_alpha)[..., None]], dim=-1)

    def _samples(self, geometry, c, ln, unroll):
        """`unroll` samples of `raymarch` over its lanes: the per-sample terms
        of the next `unroll` positions at once, then the fold in order."""
        d_s = self.step_size
        sigma = self.absorption + self.scattering
        # Sample k sits at d_o advanced k times by d_s, as one at a time.
        dist = [c["d_o"]]
        for _ in range(unroll):
            dist.append(dist[-1] + d_s)
        p = ln["ro"][:, None, :] + ln["rd"][:, None, :] * torch.stack(dist[:-1], dim=-1)[..., None]
        density_all = self.density(p)
        attenuation_all = torch.exp(-d_s * density_all * sigma)

        # Transport-free redshift from the local circular orbit; where no
        # timelike orbit exists the gas attenuates but emits nothing.
        p4 = torch.cat([torch.zeros_like(p[..., :1]), p], dim=-1)
        u_t, u_phi, orbit_ok = geometry.circular_orbit_killing_coefficients(p4, charts.CARTESIAN)
        emitter_energy = u_t * ln["p_t"][:, None] + u_phi * ln["p_phi"][:, None]
        emits = (density_all > 0.0) & orbit_ok & (torch.abs(emitter_energy) > 0.0)
        safe_e = torch.where(emits, emitter_energy, 1.0)
        redshift = torch.where(emits, ln["obs"][:, None] / safe_e, 1.0)

        cross = torch.linalg.cross(p, self.axis.expand_as(p))
        r_dist = torch.sqrt(maximum(dot(cross, cross), 1e-30))
        temperature = self.temperature_model.at(r_dist)
        u, v = self.uv(p)
        light = self.texture.color_at_uv(u, v, temperature, redshift)
        t_ratio = temperature / self.brightness_reference_temperature
        t2 = t_ratio * t_ratio
        intensity = t2 * t2

        done, taken = c["done"], c["taken"]
        d_o, transparency, accum = c["d_o"], c["transparency"], c["accum"]
        alpha_w_sum, alpha_w_tot = c["alpha_w_sum"], c["alpha_w_tot"]
        for k in range(unroll):
            live = ~done & (taken + k < self.max_steps)
            live_emit = live & emits[:, k]
            density = torch.where(live, density_all[:, k], 0.0)
            attenuation = attenuation_all[:, k]
            transparency = torch.where(live, transparency * attenuation, transparency)
            weight = transparency * attenuation * self.scattering * density * d_s
            emit_mask = live_emit.to(density.dtype)
            accum = torch.where(
                live[:, None], accum + (weight * intensity[:, k] * emit_mask)[..., None] * light[:, k, :3], accum)
            alpha_w = torch.where(live_emit, density * d_s, 0.0)
            alpha_w_sum = torch.where(live, alpha_w_sum + clip(light[:, k, 3], 0.0, 1.0) * alpha_w, alpha_w_sum)
            alpha_w_tot = torch.where(live, alpha_w_tot + alpha_w, alpha_w_tot)
            d_o = torch.where(live, dist[k + 1], d_o)
            done = done | (live & ((dist[k + 1] >= ln["exit_d"]) | (transparency < SATURATION_EPS)))
        return dict(d_o=d_o, transparency=transparency, accum=accum, alpha_w_sum=alpha_w_sum,
                    alpha_w_tot=alpha_w_tot, done=done, taken=taken + unroll)

    def shade_events(self, geometry, freq, res, idx, compact=True):
        """Raymarch every event slot of this object (kind idx) of an [N, K]
        event buffer -> XYZA [N, K, 4], 0 in the other slots. Only the
        object's slots are marched (one host sync for their count); each
        lane's result does not depend on the others, so this equals a march
        of all N·K slots under a mask."""
        n, k = res.ev_kind.shape
        slots = torch.nonzero((res.ev_kind == idx).reshape(-1)).flatten()
        out = torch.zeros((n * k, 4), dtype=res.ev_data.dtype, device=res.ev_data.device)
        if slots.numel():
            ev = res.ev_data.reshape(n * k, -1)[slots]
            seg = ev[:, 9:12]
            rd = seg / torch.sqrt(maximum(dot(seg, seg), 1e-30))[:, None]
            ray = slots // k
            out = out.index_put((slots,), self.raymarch(
                geometry, ev[:, 0:3], rd, freq.observer_energy[ray], freq.p_t[ray], freq.p_phi[ray],
                torch.ones_like(slots, dtype=torch.bool), compact=compact,
            ))
        return out.reshape(n, k, 4)


def build_volumetric_disc(obj: dict, make_temperature, texture, dtype, device, index: int = 0):
    """A VolumetricDisc from its parsed TOML table, with the reference's
    validation (cli/shared.rs:237-277) ahead of `make_temperature()`, which
    builds its temperature model. Raises ValueError with the object's place
    in the file; the loader turns it into a ConfigError."""

    def err(msg):
        raise ValueError(f"objects[{index}].VolumetricDisc: {msg}")

    inner, outer = obj["inner_radius"], obj["outer_radius"]
    if not outer > inner:
        err(f"requires outer_radius > inner_radius (got outer={outer}, inner={inner})")
    if not obj["thickness"] > 0.0:
        err(f"requires thickness > 0 (got {obj['thickness']})")
    if not obj["max_steps"] > 0:
        err("requires max_steps > 0")
    if not obj["step_size"] > 0.0:
        err(f"requires step_size > 0 (got {obj['step_size']})")
    if not obj["brightness_reference_temperature"] > 0.0:
        err("requires brightness_reference_temperature > 0")
    if obj["absorption"] < 0.0:
        err("requires absorption >= 0")
    if obj["scattering"] < 0.0:
        err("requires scattering >= 0")
    return VolumetricDisc.create(
        inner_radius=inner, outer_radius=outer, temperature_model=make_temperature(),
        texture=texture, axis=tuple(obj.get("axis") or (0.0, 0.0, 1.0)),
        num_octaves=obj["num_octaves"], perlin_seed=obj.get("perlin_seed") or 0,
        max_steps=obj["max_steps"], step_size=obj["step_size"], thickness=obj["thickness"],
        density_multiplier=obj["density_multiplier"],
        brightness_reference_temperature=obj["brightness_reference_temperature"],
        absorption=obj["absorption"], scattering=obj["scattering"],
        noise_scale=tuple(obj["noise_scale"]), noise_offset=obj["noise_offset"], dtype=dtype,
        device=device,
    )
