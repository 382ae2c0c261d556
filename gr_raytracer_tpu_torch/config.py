"""Scene configuration: the TOML schema and scene assembly (port of
gr_raytracer_tpu/config.py).

`parse_config` reads every scene file of scene-definitions/. `create_scene`
assembles the geometries and objects this port supports so far — Kerr,
KerrBL and Schwarzschild with thin discs, spheres and z-axis volumetric
discs, and BlackBody, Checker or Bitmap textures — and raises ConfigError
for the rest.
"""

from __future__ import annotations

import math
import os
import tomllib
from dataclasses import dataclass, field

import torch

from gr_raytracer_tpu_torch.geometry import chart as charts
from gr_raytracer_tpu_torch.geometry.kerr import Kerr
from gr_raytracer_tpu_torch.geometry.kerr_bl import KerrBL
from gr_raytracer_tpu_torch.geometry.schwarzschild import Schwarzschild
from gr_raytracer_tpu_torch.objects.disc import Disc
from gr_raytracer_tpu_torch.objects.sphere import Sphere
from gr_raytracer_tpu_torch.objects.volumetric_disc import build_volumetric_disc
from gr_raytracer_tpu_torch.rendering import camera as cam
from gr_raytracer_tpu_torch.rendering import integrator as integ
from gr_raytracer_tpu_torch.rendering import scene as scn
from gr_raytracer_tpu_torch.rendering.temperature import build_disc_temperature
from gr_raytracer_tpu_torch.rendering.texture import BitmapMap, BlackBodyMap, CheckerMap


class ConfigError(ValueError):
    """Invalid or unsupported scene configuration."""


@dataclass(frozen=True)
class RenderOptions:
    """Global CLI options (the reference CLI's defaults)."""

    width: int = 500
    height: int = 500
    step_size: float = 0.01
    max_steps: int = 20000
    max_radius: float = 15000.0
    epsilon: float = 1e-5
    camera_position: tuple = (18.0, 0.0, 0.8)  # Cartesian (x, y, z)
    phi: float = 0.0
    theta: float = 0.0
    psi: float = 0.0
    tone_mapping: str = "reinhard"
    show_sampling_mask: bool = False
    sampling_mask_color: tuple = (255, 0, 255)


@dataclass(frozen=True)
class RenderConfig:
    """Parsed TOML scene."""

    geometry_type: dict  # {"kind": name, **params}
    objects: tuple = ()
    celestial_texture: dict = field(
        default_factory=lambda: {"kind": "BlackBody", "beaming_exponent": 0.0}
    )
    celestial_temperature: float = 0.0
    camera_velocity: dict = field(default_factory=lambda: {"kind": "StaticObserver"})
    adaptive_sampling: scn.AdaptiveSamplingConfig = field(
        default_factory=scn.AdaptiveSamplingConfig
    )
    base_dir: str = "."


def _tagged(table, what: str) -> dict:
    """serde external tagging: {"Kerr": {...}} -> {"kind": "Kerr", ...};
    a bare string tag ("StaticObserver") -> {"kind": ...}."""
    if isinstance(table, str):
        return {"kind": table}
    if not isinstance(table, dict) or len(table) != 1:
        raise ConfigError(f"{what}: expected a single-variant table, got {table!r}")
    ((kind, params),) = table.items()
    if params is None:
        params = {}
    if not isinstance(params, dict):
        raise ConfigError(f"{what}.{kind}: expected a table of parameters")
    return {"kind": kind, **params}


def parse_config(text: str, base_dir: str = ".") -> RenderConfig:
    raw = tomllib.loads(text)
    if "geometry_type" not in raw:
        raise ConfigError("missing geometry_type")
    geometry = _tagged(raw["geometry_type"], "geometry_type")
    if geometry["kind"] not in ("Euclidean", "EuclideanSpherical", "Schwarzschild", "Kerr", "KerrBL"):
        raise ConfigError(f"unknown geometry_type {geometry['kind']!r}")

    objects = []
    for i, entry in enumerate(raw.get("objects", [])):
        obj = _tagged(entry, f"objects[{i}]")
        if "texture" in obj:
            obj["texture"] = _tagged(obj["texture"], f"objects[{i}].texture")
        objects.append(obj)

    celestial = _tagged(
        raw.get("celestial_texture", {"BlackBody": {"beaming_exponent": 0.0}}),
        "celestial_texture",
    )
    velocity = _tagged(raw.get("camera_velocity", "StaticObserver"), "camera_velocity")

    aa_raw = raw.get("adaptive_sampling", {})
    aa = scn.AdaptiveSamplingConfig(
        enabled=aa_raw.get("enabled", True),
        samples_per_axis=aa_raw.get("samples_per_axis", 4),
        luminance_contrast_threshold=aa_raw.get("luminance_contrast_threshold", 0.15),
        opacity_contrast_threshold=aa_raw.get("opacity_contrast_threshold", 0.1),
        minimum_luminance=aa_raw.get("minimum_luminance"),
        object_hit_opacity_threshold=aa_raw.get("object_hit_opacity_threshold", 0.5),
        exclude_background_contrast=aa_raw.get("exclude_background_contrast", True),
    )
    try:
        aa.validate()
    except ValueError as e:
        raise ConfigError(str(e)) from e

    return RenderConfig(
        geometry_type=geometry,
        objects=tuple(objects),
        celestial_texture=celestial,
        celestial_temperature=raw.get("celestial_temperature", 0.0),
        camera_velocity=velocity,
        adaptive_sampling=aa,
        base_dir=base_dir,
    )


def load_config(path: str) -> RenderConfig:
    with open(path, "r") as f:
        return parse_config(f.read(), base_dir=os.path.dirname(os.path.abspath(path)))


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------


def build_geometry(cfg: RenderConfig, dtype, device):
    g = cfg.geometry_type
    kind = g["kind"]
    as_ = lambda k: torch.tensor(float(g[k]), dtype=dtype, device=device)
    if kind == "Schwarzschild":
        return Schwarzschild(radius=as_("radius"), horizon_epsilon=as_("horizon_epsilon"))
    if kind in ("Kerr", "KerrBL"):
        cls = Kerr if kind == "Kerr" else KerrBL
        return cls(radius=as_("radius"), a=as_("a"), horizon_epsilon=as_("horizon_epsilon"))
    raise ConfigError(f"geometry {kind!r} is not yet ported (Kerr, KerrBL, Schwarzschild only)")


class TextureFactory:
    """Bitmap and blackbody-table cache keyed by resolved path."""

    def __init__(self, base_dir: str, dtype, device):
        self.base_dir = base_dir
        self.dtype = dtype
        self.device = device
        self._cache: dict = {}

    def resolve_path(self, path: str) -> str:
        """Scene files use repo-root-relative paths ("resources/x.png"): try
        the working directory, the scene file's directory, and its parent."""
        if os.path.isabs(path) or os.path.exists(path):
            return path
        for base in (self.base_dir, os.path.dirname(self.base_dir)):
            candidate = os.path.join(base, path)
            if os.path.exists(candidate):
                return candidate
        return path  # the loader reports the raw path

    def build(self, tex: dict):
        kind = tex["kind"]
        if kind == "Bitmap":
            path = self.resolve_path(tex["path"])
            key = (path, float(tex["beaming_exponent"]))
            if key not in self._cache:
                try:
                    self._cache[key] = BitmapMap.from_file(
                        path, tex["beaming_exponent"], self.dtype, self.device
                    )
                except (OSError, ValueError) as e:
                    raise ConfigError(f"cannot load texture {tex['path']!r}: {e}") from e
            return self._cache[key]
        if kind == "Checker":
            return CheckerMap.from_srgb(
                tex["beaming_exponent"], tex["width"], tex["height"],
                tuple(tex["color1"]), tuple(tex["color2"]), self.dtype, self.device,
            )
        if kind == "BlackBody":
            key = ("__blackbody__", float(tex["beaming_exponent"]))
            if key not in self._cache:
                self._cache[key] = BlackBodyMap.create(tex["beaming_exponent"], self.dtype, self.device)
            return self._cache[key]
        raise ConfigError(f"unknown texture kind {kind!r}")


def build_objects(cfg: RenderConfig, geometry, factory: TextureFactory, dtype, device):
    out = []
    for i, obj in enumerate(cfg.objects):
        kind = obj["kind"]
        if kind not in ("Disc", "Sphere", "VolumetricDisc"):
            raise ConfigError(f"objects[{i}]: unknown object kind {kind!r}")
        if kind == "Disc" and not obj["inner_radius"] < obj["outer_radius"]:
            raise ConfigError(f"objects[{i}].Disc: inner_radius must be < outer_radius")
        tex = factory.build(obj["texture"])
        if kind == "Sphere":
            px, py, pz = obj["position"]
            out.append(
                Sphere(
                    radius=torch.tensor(float(obj["radius"]), dtype=dtype, device=device),
                    center=torch.tensor([0.0, px, py, pz], dtype=dtype, device=device),
                    temperature=torch.tensor(float(obj["temperature"]), dtype=dtype, device=device),
                    texture=tex,
                )
            )
            continue
        # Novikov-Thorne table: every geometry ported so far is a black hole;
        # Schwarzschild has no spin.
        make_temperature = lambda: build_disc_temperature(
            geometry.radius, getattr(geometry, "a", 0.0), obj["temperature"], obj["outer_radius"],
            dtype, device,
        )
        if kind == "VolumetricDisc":
            try:
                vol = build_volumetric_disc(obj, make_temperature, tex, dtype, device, index=i)
            except ValueError as e:
                raise ConfigError(str(e)) from e
            if not vol.axis_is_z():
                raise ConfigError(
                    f"objects[{i}].VolumetricDisc: only the z axis is ported (got axis {obj.get('axis')})"
                )
            out.append(vol)
            continue
        out.append(
            Disc(
                inner_radius=torch.tensor(float(obj["inner_radius"]), dtype=dtype, device=device),
                outer_radius=torch.tensor(float(obj["outer_radius"]), dtype=dtype, device=device),
                temperature_model=make_temperature(),
                texture=tex,
            )
        )
    return tuple(out)


def resolve_camera_velocity(geometry, position, velocity_cfg: dict):
    """Static / ZAMO / Explicit observer; Explicit is normalization-checked
    (tolerance 1e-6)."""
    kind = velocity_cfg["kind"]
    if kind == "StaticObserver":
        return geometry.stationary_velocity(position)
    if kind == "Zamo":
        return geometry.zamo_velocity(position)
    if kind == "Explicit":
        u = torch.tensor(velocity_cfg["components"], dtype=position.dtype, device=position.device)
        norm = float(geometry.inner_product(position, u, u))
        expected = geometry.signature()[0]
        if abs(norm - expected) > 1e-6:
            raise ConfigError(
                f"Explicit camera_velocity is not normalized: u.u = {norm} (expected {expected})"
            )
        return u
    raise ConfigError(f"unknown camera_velocity kind {kind!r}")


def assert_future_directed(context, geometry, position, vec):
    """s0 · <e_t, v> must be positive."""
    e_t = geometry.tetrad(position)[..., 0, :]
    orientation = float(geometry.signature()[0]) * float(geometry.inner_product(position, e_t, vec))
    t = float(vec[..., 0])
    if not (math.isfinite(t) and orientation > 0.0):
        raise ConfigError(
            f"{context} has wrong time orientation (orientation={orientation} with t={t})"
        )


def create_scene(cfg: RenderConfig, opts: RenderOptions, dtype, device) -> scn.Scene:
    """Full scene assembly; the CLI camera position is Cartesian and is
    converted to the geometry's chart."""
    geometry = build_geometry(cfg, dtype, device)
    x, y, z = opts.camera_position
    cart = torch.tensor([0.0, x, y, z], dtype=dtype, device=device)
    position = charts.from_cartesian(cart, geometry.chart, geometry.spin)

    velocity = resolve_camera_velocity(geometry, position, cfg.camera_velocity)
    assert_future_directed("camera velocity", geometry, position, velocity)
    camera = cam.build_camera(
        geometry, position, velocity, alpha=math.pi / 4, rows=opts.height, columns=opts.width,
        phi=opts.phi, theta=opts.theta, psi=opts.psi, validate=True,
    )

    factory = TextureFactory(cfg.base_dir, dtype, device)
    objects = build_objects(cfg, geometry, factory, dtype, device)
    celestial = factory.build(cfg.celestial_texture)
    integration = integ.IntegrationConfig(
        max_radius=float(opts.max_radius),
        step_size=float(opts.step_size),
        epsilon=float(opts.epsilon),
        max_steps=int(opts.max_steps),
    )
    return scn.Scene(
        geometry=geometry,
        camera=camera,
        objects=objects,
        celestial_map=celestial,
        celestial_temperature=torch.tensor(float(cfg.celestial_temperature), dtype=dtype, device=device),
        integration=integration,
        adaptive=cfg.adaptive_sampling,
    )
