"""The port's camera against the JAX package, float64: the boosted tetrad,
handedness and the per-pixel rays of the flagship camera and of the
kerr.toml render command's camera, within 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_raytracer_tpu.geometry.kerr import Kerr as JKerr
from gr_raytracer_tpu.rendering import camera as jcam
from gr_raytracer_tpu_torch.geometry.base import validate_tetrad
from gr_raytracer_tpu_torch.geometry.kerr import Kerr as TKerr
from gr_raytracer_tpu_torch.rendering import camera as tcam
from torch_port_scenes import jax_flagship_camera, pixel_grid, port_flagship, t

TOL = dict(rtol=1e-12, atol=1e-12)


def _kerr_toml_cameras(rows, cols):
    """The kerr.toml geometry (r_s 1, a 0.499) with the README's camera:
    static observer at (-10, 0, -0.5), θ = 1.52, ψ = −1.57."""
    jg = JKerr(radius=jnp.asarray(1.0), a=jnp.asarray(0.499), horizon_epsilon=jnp.asarray(1e-4))
    f64 = dict(dtype=torch.float64)
    tg = TKerr(torch.tensor(1.0, **f64), torch.tensor(0.499, **f64), torch.tensor(1e-4, **f64))
    pos = [0.0, -10.0, 0.0, -0.5]
    kw = dict(alpha=np.pi / 4, rows=rows, columns=cols, theta=1.52, psi=-1.57)
    jc = jcam.build_camera(jg, jnp.asarray(pos), jg.stationary_velocity(jnp.asarray(pos)), **kw)
    tpos = torch.tensor(pos, **f64)
    tc = tcam.build_camera(tg, tpos, tg.stationary_velocity(tpos), **kw)
    return jc, tc, tg


@pytest.mark.parametrize("which", ["flagship", "kerr.toml"])
def test_camera_and_pixel_rays_match_jax(which):
    rows, cols = 12, 16
    if which == "flagship":
        _, jc = jax_flagship_camera(rows, cols)
        t_scene = port_flagship(rows, cols)
        tc, tg = t_scene.camera, t_scene.geometry
        validate_tetrad(tg, tc.position, tc.tetrad)
    else:
        jc, tc, tg = _kerr_toml_cameras(rows, cols)
    np.testing.assert_allclose(tc.tetrad.numpy(), np.asarray(jc.tetrad), **TOL)
    assert float(tc.spatial_handedness) == float(jc.spatial_handedness)
    rr, cc = pixel_grid(rows, cols)
    # Fractional coordinates too, as the supersampling pass uses them.
    rr = np.concatenate([rr, rr[:20] + 0.37])
    cc = np.concatenate([cc, cc[:20] - 0.21])
    xj, pj = jcam.pixel_rays(jc, jnp.asarray(rr), jnp.asarray(cc))
    xt, pt = tcam.pixel_rays(tc, t(rr), t(cc))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)
    # Past-directed null rays.
    norm = tg.inner_product(xt, pt, pt)
    assert float(torch.abs(norm).max()) < 1e-12
    assert bool((pt[:, 0] < 0).all())


def test_validate_tetrad_rejects_a_skewed_frame():
    _, tc, tg = _kerr_toml_cameras(4, 4)
    skewed = tc.tetrad.clone()
    skewed[1] = skewed[1] + 1e-3 * skewed[2]
    with pytest.raises(ValueError):
        validate_tetrad(tg, tc.position, skewed)
