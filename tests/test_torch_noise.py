"""The port's hash-Perlin noise (gr_raytracer_tpu_torch/ops/noise.py) against
the JAX package's (gr_raytracer_tpu/ops/noise.py): the uint32 lattice hash
bit for bit on random lattice points, negative indices included; Perlin
noise and fBm within 1e-12 in float64."""

import jax.numpy as jnp
import numpy as np

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
