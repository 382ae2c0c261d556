"""The port's scene configuration, presets and supersampling jitter
against the JAX package: every scene file parses to the same
configuration, unported scene parts raise, the flagship parameters carry
across, and the splitmix64 jitter is bit-exact."""

import glob
import os
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_raytracer_tpu import config as jcfg
from gr_raytracer_tpu import presets as jpresets
from gr_raytracer_tpu.rendering import raytracer as jrt
from gr_raytracer_tpu_torch import config as tcfg
from gr_raytracer_tpu_torch import presets as tpresets
from gr_raytracer_tpu_torch.rendering import raytracer as trt
from torch_port_scenes import CPU, F64, REPO


def test_stratified_offsets_are_bit_exact():
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 5000, size=300)
    cols = rng.integers(0, 5000, size=300)
    for n in (1, 2, 4):
        dx_t, dy_t = trt.stratified_sample_offsets(rows, cols, n)
        dx_j, dy_j = jrt.stratified_sample_offsets(rows, cols, n)
        np.testing.assert_array_equal(dx_t, dx_j)
        np.testing.assert_array_equal(dy_t, dy_j)


def test_scene_files_parse_like_jax():
    paths = sorted(glob.glob(os.path.join(REPO, "scene-definitions", "*.toml")))
    assert len(paths) == 14
    for path in paths:
        got = tcfg.load_config(path)
        ref = jcfg.load_config(path)
        for name in ("geometry_type", "objects", "celestial_texture", "celestial_temperature",
                     "camera_velocity", "base_dir"):
            assert getattr(got, name) == getattr(ref, name), (os.path.basename(path), name)
        assert asdict(got.adaptive_sampling) == asdict(ref.adaptive_sampling), path


def test_unported_scene_raises_config_error():
    """euclidean.toml: flat-space geometries are not ported yet."""
    cfg = tcfg.load_config(os.path.join(REPO, "scene-definitions", "euclidean.toml"))
    with pytest.raises(tcfg.ConfigError):
        tcfg.create_scene(cfg, tcfg.RenderOptions(width=4, height=4), F64, CPU)


def test_params_from_numpy_round_trip():
    j_params = jpresets.kerr_flagship_params(jnp.float64)
    as_np = {k: np.asarray(v) for k, v in j_params.items()}
    got = tpresets.params_from_numpy(as_np, F64, CPU)
    assert set(got) == set(j_params)
    for k, v in got.items():
        assert v.dtype == torch.float64 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), as_np[k])
    own = tpresets.kerr_flagship_params(F64, CPU)
    for k in own:
        np.testing.assert_allclose(own[k].numpy(), as_np[k], rtol=1e-15)
