"""The port's hash-Perlin noise (gr_raytracer_tpu_torch/ops/noise.py) against
the JAX package's (gr_raytracer_tpu/ops/noise.py): the uint32 lattice hash
bit for bit on random lattice points, negative indices included; Perlin
noise and fBm within 1e-12 in float64; the closed-form gradients of the
CUDA backward's noise (perlin3_lanes_grad, fbm_lanes_grad) against
jax.jacfwd of the JAX package's functions and torch.autograd of the port's,
within 1e-12 of the largest |gradient|, at points that include some within
1e-9 of lattice planes."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gr_raytracer_tpu.ops import noise as jnoise
from gr_raytracer_tpu_torch.ops import noise as tnoise
from torch_port_scenes import t

SEEDS = (0, 3, 42, 2**31 + 7)


def test_permutation_key_matches_jax():
    for seed in SEEDS:
        assert tnoise.permutation_table(seed) == int(jnoise.permutation_table(seed))


def test_corner_hashes_are_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    # Negative indices on half the domain, the int32 extremes, and zero.
    idx = rng.integers(-(2**31), 2**31, size=(3, 4096), dtype=np.int64).astype(np.int32)
    idx[:, :6] = np.array([[-(2**31), 2**31 - 1, -1, 0, 1, -2]] * 3, np.int32)
    small = rng.integers(-1000, 1000, size=(3, 4096), dtype=np.int64).astype(np.int32)
    for xi, yi, zi in (idx, small):
        assert (xi < 0).any()
        for seed in SEEDS:
            key = tnoise.permutation_table(seed)
            got = tnoise._corner_hashes(key, t(xi), t(yi), t(zi))
            want = jnoise._corner_hashes(
                jnp.uint32(key), jnp.asarray(xi), jnp.asarray(yi), jnp.asarray(zi)
            )
            for dx in (0, 1):
                for dy in (0, 1):
                    for dz in (0, 1):
                        np.testing.assert_array_equal(
                            got[dx][dy][dz].numpy(), np.asarray(want[dx][dy][dz]).astype(np.int64)
                        )


def test_perlin_and_fbm_match_jax():
    rng = np.random.default_rng(1)
    # Points on both sides of zero, exactly on lattice points, and at the
    # magnitudes the raymarch reaches (r·60·4·2⁷ ≈ 5e5).
    pts = [rng.uniform(-40.0, 40.0, (3, 2000)), rng.uniform(-6e5, 6e5, (3, 500)),
           rng.integers(-20, 20, (3, 100)).astype(np.float64)]
    for x, y, z in pts:
        for seed in (0, 42):
            key = tnoise.permutation_table(seed)
            jkey = jnp.uint32(key)
            got = tnoise.perlin3_lanes(key, t(x), t(y), t(z)).numpy()
            want = np.asarray(jnoise.perlin3_lanes(jkey, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
            for octaves in (1, 3, 8):
                got = tnoise.fbm_lanes(key, t(x), t(y), t(z), octaves).numpy()
                want = np.asarray(
                    jnoise.fbm_lanes(jkey, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), octaves, 0.5)
                )
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    lattice = pts[2]
    assert np.abs(tnoise.perlin3_lanes(7, *(t(v) for v in lattice)).numpy()).max() == 0.0


def _gradient_points():
    """Seeded points: both signs, the raymarch's magnitudes (r·60·4·2⁷ ≈
    5e5), and points within 1e-9 of lattice planes (one, two or three
    coordinates an integer plus or minus up to 1e-9)."""
    rng = np.random.default_rng(5)
    near = rng.integers(-20, 20, (3, 600)).astype(np.float64)
    near += rng.uniform(-1e-9, 1e-9, near.shape) * (rng.uniform(size=near.shape) < 0.7)
    near[:, :200] += rng.uniform(0.0, 1.0, (3, 200)) * (np.arange(3)[:, None] == rng.integers(0, 3, 200))
    return np.concatenate([rng.uniform(-40.0, 40.0, (3, 1500)), rng.uniform(-6e5, 6e5, (3, 300)), near], axis=1)


def _assert_gradient(got, want, what):
    scale = np.max(np.abs(want))
    err = np.max(np.abs(np.asarray(got) - want))
    assert err <= 1e-12 * scale, f"{what}: max error {err:.3e} over max |gradient| {scale:.3e}"


def _check_closed_form(closed, port_fn, jax_fn, pts):
    """closed(x, y, z) -> (value, gx, gy, gz) against jax.jacfwd of
    jax_fn(p) at each point (vmapped) and torch.autograd of port_fn."""
    value, *grad = (v.numpy() for v in closed(*(t(v) for v in pts)))
    got = np.stack(grad, axis=-1)
    want_jax = np.asarray(jax.vmap(jax.jacfwd(jax_fn))(jnp.asarray(pts.T)))
    _assert_gradient(got, want_jax, "against jax.jacfwd")
    leaves = [t(v).requires_grad_(True) for v in pts]
    out = port_fn(*leaves)
    want_torch = np.stack([g.numpy() for g in torch.autograd.grad(out.sum(), leaves)], axis=-1)
    _assert_gradient(got, want_torch, "against torch.autograd")
    np.testing.assert_array_equal(value, out.detach().numpy())


def test_perlin_gradient_matches_jacfwd_and_autograd():
    pts = _gradient_points()
    for seed in (0, 42):
        key = tnoise.permutation_table(seed)
        jkey = jnp.uint32(key)
        _check_closed_form(
            lambda x, y, z: tnoise.perlin3_lanes_grad(key, x, y, z),
            lambda x, y, z: tnoise.perlin3_lanes(key, x, y, z),
            lambda p: jnoise.perlin3_lanes(jkey, p[0], p[1], p[2]),
            pts,
        )


def test_fbm_gradient_matches_jacfwd_and_autograd():
    pts = _gradient_points() / 4.0  # the first octave (frequency 4) sees the points above
    key = tnoise.permutation_table(3)
    jkey = jnp.uint32(key)
    for octaves in (1, 3, 8):
        _check_closed_form(
            lambda x, y, z: tnoise.fbm_lanes_grad(key, x, y, z, octaves),
            lambda x, y, z: tnoise.fbm_lanes(key, x, y, z, octaves),
            lambda p: jnoise.fbm_lanes(jkey, p[0], p[1], p[2], octaves, 0.5),
            pts,
        )
