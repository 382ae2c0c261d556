"""Seedable 3-D Perlin gradient noise and fBm over lanes, gather-free (port
of gr_raytracer_tpu/ops/noise.py, lane-wise variants).

The lattice hash is computational: uint32 multiply-xor-shift mixing with a
Wang-hash finish, no permutation table. Gradients come from the hash's low
four bits (Improved Perlin), with the quintic fade and a trilinear blend;
values lie in about [-1, 1] and are exactly 0 at lattice points.

torch has no full uint32 arithmetic, so the hash is carried in int64 and
masked to 32 bits after every multiply and add (`_u32`): the low 32 bits of
an int64 product are those of the uint32 product. The int32 lattice index
is negative on half the domain; it is masked to its two's-complement uint32
value before its multiply, as the JAX package's astype(uint32) does. The
hashes equal the JAX package's bit for bit, negative indices included. The
CUDA raymarch (csrc/vol_raymarch.cu) computes the same hash in uint32.

The eight corners of a cell, and the octaves of an fBm, go through one
stacked tensor each, so a sample is a few hundred torch ops instead of
thousands; every element sees the same operations as in one call per corner
and octave.

`perlin3_lanes_grad` and `fbm_lanes_grad` are the plain twins of the CUDA
backward's closed-form noise gradient (csrc/vol_common.cuh perlin3_grad and
density_noise), formula for formula; the tests hold them against automatic
differentiation. Nothing on the main path calls them.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_AX = 0x8DA6B343
_AY = 0xD8163841
_AZ = 0xCB1AB31F
_MIX1 = 0x7FEB352D
_MIX2 = 0x846CA68B


def permutation_table(seed: int) -> int:
    """Seed -> the uint32 hash key (the name is kept from the JAX package,
    whose 'table' became this key)."""
    return (int(seed) * 0x9E3779B9 + 1) & MASK32


def _u32(h):
    return h & MASK32


def _mix(h):
    """Wang-style avalanche finish on a combined uint32 lattice term."""
    h = h ^ (h >> 16)
    h = _u32(h * _MIX1)
    h = h ^ (h >> 15)
    h = _u32(h * _MIX2)
    return h ^ (h >> 16)


def _lattice(i):
    """int32 lattice index -> its uint32 value, in int64."""
    return i.to(torch.int64) & MASK32


# Corner c = dx + 2·dy + 4·dz of a cell, as (dx, dy, dz) selectors.
_DX = (0, 1, 0, 1, 0, 1, 0, 1)
_DY = (0, 0, 1, 1, 0, 0, 1, 1)
_DZ = (0, 0, 0, 0, 1, 1, 1, 1)


def _corners(lo, hi, sel):
    return torch.stack([hi if s else lo for s in sel])


def _corner_hash_stack(key: int, xi, yi, zi):
    """The 8 cube-corner hashes of int32 lattice indices, [8, ...] int64
    holding uint32, corner c = dx + 2·dy + 4·dz. (i+1)·A = i·A + A in
    wrapping uint32, so the corners share the per-axis products."""
    hx0 = _u32(_lattice(xi) * _AX)
    hx1 = _u32(hx0 + _AX) ^ key  # the key is folded into x after the add
    hx0 = hx0 ^ key
    hy0 = _u32(_lattice(yi) * _AY)
    hy1 = _u32(hy0 + _AY)
    hz0 = _u32(_lattice(zi) * _AZ)
    hz1 = _u32(hz0 + _AZ)
    # The four x-y terms are shared by both z layers (as in the CUDA kernel).
    hxy = _corners(hx0, hx1, _DX[:4]) ^ _corners(hy0, hy1, _DY[:4])
    return _mix(torch.cat([hxy, hxy]) ^ _corners(hz0, hz1, _DZ))


def _corner_hashes(key: int, xi, yi, zi):
    """The corner hashes in the JAX package's nesting h[dx][dy][dz]."""
    h = _corner_hash_stack(key, xi, yi, zi)
    return tuple(
        tuple(tuple(h[dx + 2 * dy + 4 * dz] for dz in (0, 1)) for dy in (0, 1)) for dx in (0, 1)
    )


def _grad(h, x, y, z):
    """Gradient dot product from the hash's low 4 bits (Improved Perlin)."""
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    return torch.where((h & 1) == 0, u, -u) + torch.where((h & 2) == 0, v, -v)


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _perlin3_steps(key: int, x, y, z):
    """Perlin noise of the points (x, y, z), with the steps its gradient
    reads: ((xf, yf, zf) the cell fractions, (u, v, w) their fades, the
    [8, ...] corner hashes, the eight corner terms, the blend's lerps (y00,
    y10, y01, y11, z0, z1), the value)."""
    xi0, yi0, zi0 = torch.floor(x), torch.floor(y), torch.floor(z)
    xf, yf, zf = x - xi0, y - yi0, z - zi0
    xi, yi, zi = xi0.to(torch.int32), yi0.to(torch.int32), zi0.to(torch.int32)

    u, v, w = _fade(xf), _fade(yf), _fade(zf)
    hashes = _corner_hash_stack(key, xi, yi, zi)
    g = _grad(hashes, _corners(xf, xf - 1.0, _DX), _corners(yf, yf - 1.0, _DY), _corners(zf, zf - 1.0, _DZ))
    x000, x100, x010, x110, x001, x101, x011, x111 = corners = g.unbind(0)

    y00 = x000 + u * (x100 - x000)
    y10 = x010 + u * (x110 - x010)
    y01 = x001 + u * (x101 - x001)
    y11 = x011 + u * (x111 - x011)
    z0 = y00 + v * (y10 - y00)
    z1 = y01 + v * (y11 - y01)
    return (xf, yf, zf), (u, v, w), hashes, corners, (y00, y10, y01, y11, z0, z1), z0 + w * (z1 - z0)


def perlin3_lanes(key: int, x, y, z):
    """Lane-wise 3-D Perlin noise of the points (x, y, z), [...] each."""
    return _perlin3_steps(key, x, y, z)[-1]


def perlin3(key: int, p):
    """3-D Perlin noise of points p [..., 3] -> [...]."""
    return perlin3_lanes(key, p[..., 0], p[..., 1], p[..., 2])


def _grad_vectors(h):
    """The gradient vectors of `_grad` for the hashes h, [..., 3]: the
    partials of _grad(h, x, y, z) along x, y and z, each 0 or ±1."""
    h = h & 15
    u_is_x = h < 8
    v_is_y = h < 4
    v_is_x = ~v_is_y & ((h == 12) | (h == 14))
    one = torch.ones(h.shape, dtype=torch.float64)
    su = torch.where((h & 1) == 0, one, -one)
    sv = torch.where((h & 2) == 0, one, -one)
    zero = torch.zeros_like(one)
    gx = torch.where(u_is_x, su, zero) + torch.where(v_is_x, sv, zero)
    gy = torch.where(u_is_x, zero, su) + torch.where(v_is_y, sv, zero)
    gz = torch.where(v_is_y | v_is_x, zero, sv)
    return torch.stack([gx, gy, gz], dim=-1)


def _lerp(t, a, b):
    return a + t * (b - a)


def _fade_slope(t):
    """fade'(t) = 30·t²·(t − 1)²."""
    tm = t - 1.0
    return 30.0 * (t * t) * (tm * tm)


def perlin3_lanes_grad(key: int, x, y, z):
    """`perlin3_lanes` and its gradient in closed form: (value, ∂/∂x, ∂/∂y,
    ∂/∂z), [...] each. The gradient of the trilinear blend of the corner
    terms is the same blend of the corners' gradient vectors plus, along
    each axis, the fade's slope times the blend of the corner differences
    along that axis; floor contributes nothing."""
    (xf, yf, zf), (u, v, w), hashes, corners, lerps, value = _perlin3_steps(key, x, y, z)
    x000, x100, x010, x110, x001, x101, x011, x111 = corners
    y00, y10, y01, y11, z0, z1 = lerps
    gv = _grad_vectors(hashes).to(x.dtype)
    c000, c100, c010, c110, c001, c101, c011, c111 = (c.unbind(-1) for c in gv.unbind(0))
    blend = [
        _lerp(w, _lerp(v, _lerp(u, c000[a], c100[a]), _lerp(u, c010[a], c110[a])),
              _lerp(v, _lerp(u, c001[a], c101[a]), _lerp(u, c011[a], c111[a])))
        for a in range(3)
    ]
    gx = blend[0] + _fade_slope(xf) * _lerp(w, _lerp(v, x100 - x000, x110 - x010), _lerp(v, x101 - x001, x111 - x011))
    gy = blend[1] + _fade_slope(yf) * _lerp(w, y10 - y00, y11 - y01)
    gz = blend[2] + _fade_slope(zf) * (z1 - z0)
    return value, gx, gy, gz


def fbm_amplitudes(num_octaves: int, h: float = 0.5):
    """Octave amplitudes as host floats: 1, g, g², ... with g = 2^(−h),
    multiplied up in float64 as the JAX package's loop does."""
    g = 2.0 ** (-h)
    amps, amplitude = [], 1.0
    for _ in range(num_octaves):
        amps.append(amplitude)
        amplitude *= g
    return amps


def fbm_frequencies(num_octaves: int):
    """4, 8, 16, ...: the octave frequencies (exact powers of two)."""
    return [4.0 * 2.0**o for o in range(num_octaves)]


def fbm_lanes(key: int, x, y, z, num_octaves: int, h: float = 0.5):
    """Lane-wise fBm: gain 2^(−h), base frequency 4, amplitude 1. The
    octaves are one stacked Perlin evaluation, summed in octave order."""
    freqs = fbm_frequencies(num_octaves)
    noise = perlin3_lanes(
        key, torch.stack([x * f for f in freqs]), torch.stack([y * f for f in freqs]),
        torch.stack([z * f for f in freqs]),
    )
    t = torch.zeros_like(x)
    for amplitude, octave in zip(fbm_amplitudes(num_octaves, h), noise.unbind(0)):
        t = t + amplitude * octave
    return t


def fbm_lanes_grad(key: int, x, y, z, num_octaves: int, h: float = 0.5):
    """`fbm_lanes` and its gradient: (value, ∂/∂x, ∂/∂y, ∂/∂z). The value
    sums the octaves in octave order as `fbm_lanes`; the gradient sums each
    octave's `perlin3_lanes_grad` weighted by amplitude·frequency, as the
    CUDA backward does (csrc/vol_common.cuh density_noise)."""
    freqs = fbm_frequencies(num_octaves)
    value, ox, oy, oz = perlin3_lanes_grad(
        key, torch.stack([x * f for f in freqs]), torch.stack([y * f for f in freqs]),
        torch.stack([z * f for f in freqs]),
    )
    t = torch.zeros_like(x)
    gx, gy, gz = torch.zeros_like(x), torch.zeros_like(x), torch.zeros_like(x)
    for i, (amplitude, freq) in enumerate(zip(fbm_amplitudes(num_octaves, h), freqs)):
        t = t + amplitude * value[i]
        weight = amplitude * freq
        gx, gy, gz = gx + weight * ox[i], gy + weight * oy[i], gz + weight * oz[i]
    return t, gx, gy, gz


def fbm(key: int, p, num_octaves: int, h: float = 0.5):
    """fBm of points p [..., 3] -> [...] (fbm_lanes on the components)."""
    return fbm_lanes(key, p[..., 0], p[..., 1], p[..., 2], num_octaves, h)
