"""Texture maps: checker, bitmap (bilinear), blackbody lookup table (port of
gr_raytracer_tpu/rendering/texture.py).

Every map has `color_at_uv(u, v, temperature, redshift) -> [..., 4]` XYZA.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gr_raytracer_tpu_torch.geometry.base import clip, maximum
from gr_raytracer_tpu_torch.ops.lut import uniform_interp
from gr_raytracer_tpu_torch.rendering import blackbody
from gr_raytracer_tpu_torch.rendering.color import apply_beaming, srgb8_to_xyza
from gr_raytracer_tpu_torch.utils.png import png_decode


@dataclass(frozen=True)
class CheckerMap:
    """Checker pattern in UV space."""

    c1: torch.Tensor  # [4] XYZA
    c2: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor
    beaming_exponent: torch.Tensor

    @classmethod
    def from_srgb(cls, beaming_exponent, width, height, color1, color2, dtype, device):
        """color1/color2: (r, g, b[, a]) 8-bit tuples."""
        as_ = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
        return cls(
            c1=srgb8_to_xyza(color1, dtype, device),
            c2=srgb8_to_xyza(color2, dtype, device),
            width=as_(width),
            height=as_(height),
            beaming_exponent=as_(beaming_exponent),
        )

    def is_opaque(self) -> bool:
        return float(self.c1[3]) == 1.0 and float(self.c2[3]) == 1.0

    def color_at_uv(self, u, v, temperature, redshift):
        ut = torch.floor(u * self.width).to(torch.int32)
        vt = torch.floor(v * self.height).to(torch.int32)
        even = (ut + vt) % 2 == 0
        color = torch.where(even[..., None], self.c1, self.c2)
        return apply_beaming(color, redshift, self.beaming_exponent)


@dataclass(frozen=True)
class BitmapMap:
    """Bitmap texture, bilinear filtered; `image` is [H, W, 4] XYZA."""

    image: torch.Tensor
    beaming_exponent: torch.Tensor

    @classmethod
    def from_file(cls, path, beaming_exponent, dtype, device):
        with open(path, "rb") as f:
            rgba = png_decode(f.read())
        return cls(
            image=srgb8_to_xyza(torch.from_numpy(rgba), dtype, device),
            beaming_exponent=torch.as_tensor(beaming_exponent, dtype=dtype, device=device),
        )

    def is_opaque(self) -> bool:
        return float(self.image[..., 3].min()) == 1.0

    def color_at_uv(self, u, v, temperature, redshift):
        h, w = self.image.shape[0], self.image.shape[1]
        px = w * u
        py = h * v
        # Clipped floor/ceil corners with fractions from the clipped floor
        # (the reference's edge behavior, saturating negative casts included).
        x0 = torch.clamp(torch.floor(px), 0, w - 1).to(torch.int64)
        y0 = torch.clamp(torch.floor(py), 0, h - 1).to(torch.int64)
        x1 = torch.clamp(torch.ceil(px), 0, w - 1).to(torch.int64)
        y1 = torch.clamp(torch.ceil(py), 0, h - 1).to(torch.int64)
        dx = px - x0
        dy = py - y0
        c00 = self.image[y0, x0]
        c01 = self.image[y1, x0]
        c10 = self.image[y0, x1]
        c11 = self.image[y1, x1]
        w00 = ((1.0 - dx) * (1.0 - dy))[..., None]
        w01 = ((1.0 - dx) * dy)[..., None]
        w10 = (dx * (1.0 - dy))[..., None]
        w11 = (dx * dy)[..., None]
        color = w00 * c00 + w10 * c10 + w01 * c01 + w11 * c11
        return apply_beaming(color, redshift, self.beaming_exponent)


@dataclass(frozen=True)
class BlackBodyMap:
    """Physical blackbody emission via a log₁₀T lookup table of z = 1 colors,
    sampled at T·z; `beaming_exponent` is an extra artistic z^e factor."""

    log_t: torch.Tensor  # [L]
    xyz: torch.Tensor  # [L, 3]
    beaming_exponent: torch.Tensor

    @classmethod
    def create(cls, beaming_exponent, dtype, device):
        log_t, xyz = blackbody.build_blackbody_lut(dtype, device)
        return cls(
            log_t=log_t,
            xyz=xyz,
            beaming_exponent=torch.as_tensor(beaming_exponent, dtype=dtype, device=device),
        )

    def is_opaque(self) -> bool:
        return True  # sample() appends alpha = 1 unconditionally

    def sample(self, temperature):
        lt = torch.log10(maximum(temperature, blackbody.MIN_TEMPERATURE))
        lt = clip(lt, self.log_t[0], self.log_t[-1])
        dx = (self.log_t[-1] - self.log_t[0]) / (self.log_t.shape[0] - 1)
        xyz = uniform_interp(lt, self.log_t[0], dx, self.xyz)
        return torch.cat([xyz, torch.ones_like(xyz[..., :1])], dim=-1)

    def color_at_uv(self, u, v, temperature, redshift):
        color = self.sample(temperature * redshift)
        return apply_beaming(color, redshift, self.beaming_exponent)
