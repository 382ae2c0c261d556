"""Black-body radiation -> CIE XYZ, with relativistic redshift (port of
gr_raytracer_tpu/rendering/blackbody.py).

Observer-frame intensity of an emitter at temperature T seen at redshift
z = ν_obs/ν_em is z⁵ · B_λ(λ_obs · z, T), integrated by a 450-sample
midpoint rule over 380-830 nm against the analytic CIE fits.
"""

from __future__ import annotations

import math

import torch

from gr_raytracer_tpu_torch.rendering.color import x_bar, y_bar, z_bar

PLANCK_CONSTANT = 6.62607015e-34
SPEED_OF_LIGHT = 299_792_458.0
BOLTZMANN_CONSTANT = 1.380649e-23

MIN_WAVELENGTH_NM = 380.0
MAX_WAVELENGTH_NM = 830.0
NM_TO_M = 1e-9


def planck_spectral_radiance(lam_m, temperature):
    """B_λ(λ, T), λ in meters."""
    a = 2.0 * PLANCK_CONSTANT * SPEED_OF_LIGHT * SPEED_OF_LIGHT
    b = PLANCK_CONSTANT * SPEED_OF_LIGHT / (lam_m * BOLTZMANN_CONSTANT * temperature)
    return a / (lam_m**5 * torch.expm1(b))


def blackbody_xyz(temperature, redshift=None):
    """[..., 4] XYZA (alpha 1) of a redshifted blackbody; `temperature` and
    `redshift` are tensors that broadcast together."""
    if redshift is None:
        redshift = torch.ones_like(temperature)
    num = int(MAX_WAVELENGTH_NM - MIN_WAVELENGTH_NM)
    i = torch.arange(num, dtype=temperature.dtype, device=temperature.device)
    lam_m = (MIN_WAVELENGTH_NM + (i + 0.5)) * NM_TO_M
    lam_nm = lam_m / NM_TO_M
    rad = planck_spectral_radiance(lam_m * redshift[..., None], temperature[..., None])
    step = NM_TO_M
    x = torch.sum(rad * x_bar(lam_nm), dim=-1) * step
    y = torch.sum(rad * y_bar(lam_nm), dim=-1) * step
    z = torch.sum(rad * z_bar(lam_nm), dim=-1) * step
    boost = redshift**5
    return torch.stack([x * boost, y * boost, z * boost, torch.ones_like(x)], dim=-1)


# Log-temperature lookup-table bounds.
LUT_STEPS = 1000
MIN_TEMPERATURE = 10.0
MAX_TEMPERATURE = 1e7


def build_blackbody_lut(dtype, device):
    """(log10_T [L], xyz [L, 3]): blackbody colors at z = 1 over a log-T
    grid. A Doppler-shifted blackbody is a blackbody at T·z and the z⁵ boost
    cancels the Planck rescaling, so any z reads the table at T·z."""
    log_t = torch.linspace(
        math.log10(MIN_TEMPERATURE), math.log10(MAX_TEMPERATURE), LUT_STEPS,
        dtype=dtype, device=device,
    )
    xyz = blackbody_xyz(10.0**log_t)[:, :3]
    return log_t, xyz
