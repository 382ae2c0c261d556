"""Perlin-noise volumetric accretion disc (port of the construction, UV and
bounding-volume parts of gr_raytracer_tpu/objects/volumetric_disc.py).

The bounding volume is an inner and an outer cylinder clipped to
±3·thickness caps. The march records where a ray segment crosses its
boundary (ops/geodesic_march.py, vols); shading then runs a straight-line
constant-step raymarch from each such entry point (ops/volumetric_march.py,
the K5 kernel): Perlin-fBm density with a seamless cylindrical noise
mapping, Beer-Lambert attenuation, per-sample redshift from the ray's
conserved (p_t, p_φ) and the local circular orbit, T⁴ emission weighting
and texture alpha.

The lax raymarch of the JAX package (`density`, `raymarch`,
`segment_hit`, `shade_events`) belongs to its RKF45 path and is not part of
this port yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

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

    @classmethod
    def create(
        cls, inner_radius, outer_radius, temperature_model, texture, axis=(0.0, 0.0, 1.0),
        num_octaves=8, perlin_seed=0, max_steps=50000, step_size=0.001, thickness=0.03,
        density_multiplier=500.0, brightness_reference_temperature=1000.0, absorption=0.3,
        scattering=0.4, noise_scale=(1.0, 1.0, 1.0), noise_offset=0.0, dtype=torch.float64,
        device="cpu",
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
        as_ = lambda v: torch.as_tensor(np.asarray(v, np.float64), dtype=dtype, device=device)
        return cls(
            inner_radius=as_(inner_radius), outer_radius=as_(outer_radius),
            temperature_model=temperature_model, texture=texture, axis=as_(ax), e1=as_(e1),
            e2=as_(e2), key=noise.permutation_table(perlin_seed), thickness=as_(thickness),
            density_multiplier=as_(density_multiplier),
            brightness_reference_temperature=as_(brightness_reference_temperature),
            absorption=as_(absorption), scattering=as_(scattering), noise_scale=as_(noise_scale),
            noise_offset=as_(noise_offset), step_size=as_(step_size), num_octaves=int(num_octaves),
            max_steps=int(max_steps),
        )

    def axis_is_z(self) -> bool:
        """The kernels' bounding volume and raymarch take the z axis only."""
        return bool(np.allclose(self.axis.detach().cpu().numpy(), [0.0, 0.0, 1.0]))

    def uv(self, p):
        """Texture (u, v) of points p [..., 3]: radius across the annulus and
        azimuth, mapped into the unit square."""
        x = p @ self.e1
        y = p @ self.e2
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
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            safe_a = torch.where(a > 0.0, a, 1.0)
            roots = []
            for sign in (-1.0, 1.0):
                t = (-b + sign * sq) / (2.0 * safe_a)
                p = s + t[..., None] * d
                height_ok = torch.abs(p @ axis) <= cap_h
                roots.append((t, ok & (t >= 0.0) & (t <= 1.0) & height_ok))
            return roots

        def cap_root(pos):
            denom = d @ axis
            s_h = s @ axis
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
