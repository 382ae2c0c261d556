"""CIE-XYZ / sRGB color pipeline, beaming, tone mapping (port of
gr_raytracer_tpu/rendering/color.py).

Colors are [..., 4] tensors (X, Y, Z, alpha).
"""

from __future__ import annotations

import numpy as np
import torch


def _g(lam, mu, tau_left, tau_right):
    # A 0-d tensor keeps lam's dtype (two Python floats would give float32).
    tau = torch.where(lam < mu, torch.tensor(tau_left, dtype=lam.dtype, device=lam.device), tau_right)
    t = (lam - mu) * tau
    return torch.exp(-0.5 * t * t)


def x_bar(lam):
    """CIE x̄(λ), λ in nm."""
    return (
        1.056 * _g(lam, 599.8, 0.0264, 0.0323)
        + 0.362 * _g(lam, 442.0, 0.0624, 0.0374)
        - 0.065 * _g(lam, 501.1, 0.0490, 0.0382)
    )


def y_bar(lam):
    """CIE ȳ(λ), λ in nm."""
    return 0.821 * _g(lam, 568.8, 0.0213, 0.0247) + 0.286 * _g(lam, 530.9, 0.0613, 0.0322)


def z_bar(lam):
    """CIE z̄(λ), λ in nm."""
    return 1.217 * _g(lam, 437.0, 0.0845, 0.0278) + 0.681 * _g(lam, 459.0, 0.0385, 0.0725)


# 2003 IEC matrices.
XYZ_TO_LINEAR_SRGB = np.array(
    [
        [3.2406255, -1.5372080, -0.4986286],
        [-0.9689307, 1.8757561, 0.0415175],
        [0.0557101, -0.2040211, 1.0569959],
    ]
)
LINEAR_SRGB_TO_XYZ = np.array(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ]
)


def _as(t, like):
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


def compand_srgb(linear):
    """Linear -> encoded sRGB, sign-preserving, clamped to [0, 1]."""
    sign = torch.where(linear < 0.0, -1.0, 1.0).to(linear.dtype)
    a = torch.abs(linear)
    encoded = torch.where(
        a <= 0.0031308, 12.92 * a, 1.055 * torch.pow(a, 1.0 / 2.4) - 0.055
    )
    return torch.clamp(sign * encoded, 0.0, 1.0)


def inv_compand_srgb(u):
    """Encoded sRGB in [0, 1] -> linear."""
    return torch.where(u <= 0.04045, u / 12.92, torch.pow((u + 0.055) / 1.055, 2.4))


def xyz_to_linear_srgb(xyz):
    """[..., 3] XYZ -> [..., 3] linear sRGB."""
    return torch.einsum("ij,...j->...i", _as(XYZ_TO_LINEAR_SRGB, xyz), xyz)


def srgb8_to_xyza(rgba, dtype, device):
    """8-bit sRGB(A) values ([..., 3] or [..., 4], 0..255; alpha defaults to
    255) -> [..., 4] XYZA."""
    rgba = torch.as_tensor(rgba, dtype=dtype, device=device)
    rgb = rgba[..., :3] / 255.0
    if rgba.shape[-1] == 4:
        alpha = rgba[..., 3] / 255.0
    else:
        alpha = torch.ones(rgba.shape[:-1], dtype=dtype, device=device)
    lin = inv_compand_srgb(rgb)
    xyz = torch.einsum("ij,...j->...i", _as(LINEAR_SRGB_TO_XYZ, lin), lin)
    return torch.cat([xyz, alpha[..., None]], dim=-1)


def apply_beaming(xyza, redshift, beaming_exponent):
    """Artistic relativistic-beaming multiplier z**exponent on the color part."""
    factor = torch.pow(redshift, beaming_exponent)
    return torch.cat([xyza[..., :3] * factor[..., None], xyza[..., 3:4]], dim=-1)


TONE_MAPPING_REINHARD = "reinhard"
TONE_MAPPING_GLOBAL_LINEAR = "global-linear"

_REC709_LUMA = np.array([0.2126, 0.7152, 0.0722])


def tone_map_linear_srgb(linear_rgb, exposure=1.0, method=TONE_MAPPING_REINHARD):
    """Reinhard per-pixel luminance L/(1+L), or normalization by the
    buffer-wide max channel value (global-linear)."""
    c = linear_rgb * exposure
    if method == TONE_MAPPING_REINHARD:
        luma = torch.einsum("...i,i->...", c, _as(_REC709_LUMA, c))
        scale = torch.where(luma > 0.0, 1.0 / (1.0 + luma), 1.0)
        return c * scale[..., None]
    if method == TONE_MAPPING_GLOBAL_LINEAR:
        max_component = torch.max(torch.clamp(c, min=0.0))
        scale = torch.where(max_component > 0.0, 1.0 / max_component, 1.0)
        return c * scale
    raise ValueError(f"unknown tone mapping method: {method!r}")


def xyza_buffer_to_srgb8(xyza, exposure=1.0, method=TONE_MAPPING_REINHARD):
    """[..., 4] XYZA buffer -> [..., 3] uint8 sRGB image."""
    lin = xyz_to_linear_srgb(xyza[..., :3])
    mapped = tone_map_linear_srgb(lin, exposure=exposure, method=method)
    enc = compand_srgb(torch.clamp(mapped, min=0.0))
    return torch.round(enc * 255.0).to(torch.uint8)
