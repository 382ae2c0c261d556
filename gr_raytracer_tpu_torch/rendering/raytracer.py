"""Render driver: chunked frame render, adaptive supersampling, output
(port of gr_raytracer_tpu/rendering/raytracer.py).

  * Pass 1 traces the section of the pixel grid in fixed-size chunks. Each
    scene takes one route (`_route`), as the JAX driver's dispatch does: the
    kernel path (a Mino-time chunk in two launches of K3, fast_path._march)
    for the scenes `fast_path.supports_scene` takes, a lone z-axis
    volumetric disc included (geometric march, compaction, K5, fold); the
    split path for any other scene with a volumetric disc; the RKF45 path
    (scene.trace_rays, phased by the requeue driver on deep budgets) for
    the rest, and for every scene with lax=True. The chunks form a
    one-deep pipeline: chunk i+1 is queued on the card before chunk i's
    results are read on the host (the RKF45 path and the volumetric
    compaction sync inside a chunk). Rays that overflow their event slots
    are traced again on the RKF45 path with OVERFLOW_MAX_EVENTS slots.
  * The 8-neighbor contrast selection is a host stencil in numpy, faithful
    to the reference's pair test (Michelson epsilon, luminance floor,
    exclude_background_contrast).
  * The stratified jitter is the reference's splitmix64 hash, bit-exact, in
    host uint64; the jittered sub-rays run through the same chunked driver
    and are averaged over their successful samples.
  * Output: tone-mapped PNG, or Radiance .hdr of the raw XYZ.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from gr_raytracer_tpu_torch.objects.volumetric_disc import VolumetricDisc
from gr_raytracer_tpu_torch.ops import volumetric_march as vm
from gr_raytracer_tpu_torch.rendering import camera as cam
from gr_raytracer_tpu_torch.rendering import color as col
from gr_raytracer_tpu_torch.rendering import fast_path
from gr_raytracer_tpu_torch.rendering import integrator as integ
from gr_raytracer_tpu_torch.rendering import scene as scn
from gr_raytracer_tpu_torch.rendering.redshift import ray_frequency_data
from gr_raytracer_tpu_torch.utils.png import png_encode

# A ray whose event slots overflow is traced again on the RKF45 path with
# this many (the JAX package's re-trace capacity).
OVERFLOW_MAX_EVENTS = 32
# Rays a chunk by default (the CLI's `--chunk-size`): a 1000² pass in one,
# so that a K3 launch holds far more lanes than the card keeps threads and
# its longest lanes run beside the others' bulk, and the host dispatches
# each step of the preparation and shading once a pass. The float32 frames
# of scene-definitions/ up to 1500² peak at 0.4-1.7 GiB of device memory
# with it (the CLI's report on an NVIDIA H100).
CHUNK_SIZE = 1 << 20
MICHELSON_DENOMINATOR_EPSILON = 1e-4
RELATIVE_MINIMUM_LUMINANCE_FRACTION = 1e-3

_NEIGHBOR_SHIFTS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]


# ---------------------------------------------------------------------------
# splitmix64 stratified jitter (bit-exact against the reference)
# ---------------------------------------------------------------------------


def mix64(z: np.ndarray) -> np.ndarray:
    z = np.asarray(z, np.uint64)
    with np.errstate(over="ignore"):
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def hash_pixel_samples(row, col, k) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = mix64(np.asarray(row, np.uint64) + mix64(np.asarray(col, np.uint64) + mix64(np.asarray(k, np.uint64))))
    return (z >> np.uint64(11)).astype(np.float64) * (1.0 / float(1 << 53))


def stratified_sample_offsets(rows: np.ndarray, cols: np.ndarray, samples_per_axis: int):
    """All n² jittered (dx, dy) offsets for each (row, col): [P, n²] each."""
    n = samples_per_axis
    sr, sc = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    idx = (sr * n + sc).ravel()  # [n²]
    r = rows[:, None]
    c = cols[:, None]
    dx = (sc.ravel()[None, :] + hash_pixel_samples(r, c, 2 * idx[None, :])) / n
    dy = (sr.ravel()[None, :] + hash_pixel_samples(r, c, 2 * idx[None, :] + 1)) / n
    return dx, dy


# ---------------------------------------------------------------------------
# Adaptive-sampling pixel selection (host stencil)
# ---------------------------------------------------------------------------


def resolve_minimum_luminance(cfg, luminance: np.ndarray) -> float:
    """Explicit floor, or 1e-3 × the 99th-percentile frame luminance
    (kth-smallest with k = floor((len−1)·0.99), matching select_nth)."""
    if cfg.minimum_luminance is not None:
        return float(cfg.minimum_luminance)
    flat = luminance.ravel()
    if flat.size == 0:
        return 0.0
    k = int((flat.size - 1) * 0.99)
    return RELATIVE_MINIMUM_LUMINANCE_FRACTION * float(np.partition(flat, k)[k])


def collect_supersample_mask(cfg, luminance, alpha, ray_class, minimum_luminance):
    """Boolean [H, W] mask of pixels with any triggering 8-neighbor pair."""
    h, w = luminance.shape
    mask = np.zeros((h, w), bool)
    for dr, dc in _NEIGHBOR_SHIFTS:
        rs, re = max(dr, 0), h + min(dr, 0)
        cs, ce = max(dc, 0), w + min(dc, 0)
        p_l = luminance[rs:re, cs:ce]
        p_a = alpha[rs:re, cs:ce]
        p_k = ray_class[rs:re, cs:ce]
        q_l = luminance[rs - dr : re - dr, cs - dc : ce - dc]
        q_a = alpha[rs - dr : re - dr, cs - dc : ce - dc]
        q_k = ray_class[rs - dr : re - dr, cs - dc : ce - dc]

        class_diff = p_k != q_k
        lum_contrast = np.abs(p_l - q_l) / (p_l + q_l + MICHELSON_DENOMINATOR_EPSILON)
        opa_contrast = np.abs(p_a - q_a)
        visible = np.maximum(p_l, q_l) > minimum_luminance
        contrast = visible & (
            (lum_contrast > cfg.luminance_contrast_threshold)
            | (opa_contrast > cfg.opacity_contrast_threshold)
        )
        if cfg.exclude_background_contrast:
            contrast &= p_k != scn.ESCAPED
        mask[rs:re, cs:ce] |= class_diff | contrast
    return mask


# ---------------------------------------------------------------------------
# Chunked tracing
# ---------------------------------------------------------------------------


class TraceStats(NamedTuple):
    seconds: float
    rays: int
    ray_steps: int  # Σ per-ray march steps (accepted steps on the RKF45 path), re-traces included
    stop_counts: np.ndarray  # rays per stop code (rendering/integrator.py)
    vol_lanes: int = 0  # volumetric event slots raymarched (K5 or the RKF45 path's raymarch)
    vol_samples: int = 0  # Σ samples K5 took over its lanes
    vol_emitting: int = 0  # raymarched lanes whose alpha came out > 0
    overflow: int = 0  # rays that overflowed their event slots and were re-traced
    overflow_dropped: int = 0  # of those, rays that overflowed the re-trace's slots too
    overflow_steps: int = 0  # the re-traces' accepted steps (in ray_steps too)
    overflow_march_s: float = 0.0  # the re-traces' RKF45 march, host seconds
    overflow_shade_s: float = 0.0  # their shading (volumetric raymarch included) and fold


# The RKF45 path's phased integration (the requeue driver): a chunk whose
# attempt budget exceeds two phases is integrated PHASE_ATTEMPTS attempts at
# a time, doubling, and each phase continues only the lanes still running.
PHASE_ATTEMPTS = 2048


def _route(scene, lax: bool) -> str:
    """How trace_pixels_chunked traces a scene, as the JAX driver routes it:
    "kernel" (no volumetric disc, supports_scene), "kernel_vol" (the one
    object a volumetric disc that K5 covers), "split" (any other scene with
    a volumetric disc: geometric pass, compaction, raymarch, fold), else
    "requeue" or "lax" (the RKF45 path, phased when the attempt budget
    exceeds two phases). lax=True takes the RKF45 forms: the lax geometric
    pass and raymarch in "split", and never a kernel route."""
    has_vol = any(isinstance(o, VolumetricDisc) for o in scene.objects)
    supported = not lax and fast_path.supports_scene(scene)
    if has_vol:
        if supported and len(scene.objects) == 1 and fast_path.scene_kernel_spec(scene).vol_spec is not None:
            return "kernel_vol"
        return "split"
    if supported:
        return "kernel"
    cfg = scene.integration
    return "requeue" if cfg.max_steps + cfg.extra_attempts > 2 * PHASE_ATTEMPTS else "lax"


def _trace_chunk(scene, spec, row_f, col_f):
    """One chunk on the scene's route: the kernel routes where `spec`
    (scene_kernel_spec) is given, the RKF45 forms where it is None.
    Returns ((color, ray_class, stop_code, ev_overflow, steps, and on the
    split and kernel_vol routes the samples K5 marched and the emitting
    lanes as 0-d tensors), the number of volumetric lanes)."""
    route = _route(scene, lax=spec is None)
    x, p = cam.pixel_rays(scene.camera, row_f, col_f)
    if route == "kernel_vol":
        v = fast_path.trace_rays_fast_vol(scene, x, p, spec=spec)
        s, extra, lanes = v.samples, (v.marched, v.emitting), v.lanes
    elif route == "split":
        s, marched, emitting, lanes = _trace_chunk_split(scene, spec, x, p)
        extra = (marched, emitting)
    elif route == "kernel":
        s, extra, lanes = fast_path.trace_rays_fast(scene, x, p, spec=spec), (), 0
    elif route == "requeue":
        s, extra, lanes = _trace_chunk_requeued(scene, x, p), (), 0
    else:
        s, extra, lanes = scn.trace_rays(scene, x, p), (), 0
    return (s.color, s.ray_class, s.stop_code, s.ev_overflow, s.steps, *extra), lanes


def _take(res, idx):
    return res._replace(**{k: v[idx] for k, v in res._asdict().items() if v is not None})


def _trace_chunk_requeued(scene, x, p):
    """The RKF45 path in phases: every lane for PHASE_ATTEMPTS attempts,
    then phases of doubling attempts over the lanes still running, each
    continuing its lanes' state (`resume`), until the attempt budget is
    spent. A lane's result equals a one-shot integration's."""
    geometry = scene.geometry
    cfg = scene.integration
    solver = geometry.make_solver(x, p)
    y0 = solver.initial_state(x, p)
    freq = ray_frequency_data(geometry, x, p, scene.camera.velocity)
    seg = scn._segment_fn(scene)
    max_attempts = cfg.max_steps + cfg.extra_attempts
    phase = min(PHASE_ATTEMPTS, max_attempts)
    res = integ.integrate_rays(geometry, solver, cfg, y0, seg, scn.EVENT_WIDTH, attempts_budget=phase, finalize=False)
    spent = phase
    while spent < max_attempts:
        active = torch.nonzero(res.stop_code == integ.RUNNING).flatten()
        if active.numel() == 0:
            break
        phase = min(phase * 2, max_attempts - spent)
        sub = _take(res, active)
        lane_fields = integ._lane_fields(solver, x.shape[0])
        sub_solver = dataclasses.replace(solver, **{k: v[active] for k, v in lane_fields.items()})
        out = integ.integrate_rays(geometry, sub_solver, cfg, sub.y, seg, scn.EVENT_WIDTH, resume=sub,
                                   attempts_budget=phase, finalize=False)
        res = res._replace(**{k: v.index_put((active,), getattr(out, k))
                              for k, v in res._asdict().items() if v is not None})
        spent += phase
        integ.loop_stats["requeue_phases"] = integ.loop_stats.get("requeue_phases", 0) + 1
    res = res._replace(stop_code=torch.where(res.stop_code == integ.RUNNING, integ.BUDGET, res.stop_code))
    return scn.finish_rays(scene, freq, solver, res)


def _trace_chunk_split(scene, spec, x, p):
    """The split path for a scene with volumetric discs: the geometric pass
    (the kernel path's `trace_geometric_fast` when `spec` is given, else the
    RKF45 `trace_geometric`), the compaction of each volumetric object's
    event slots, their raymarch (K5 where volumetric_march.supports holds
    and `spec` is given, else the object's RKF45 raymarch) and the alpha
    fold. Returns (RaySamples, samples K5 marched, emitting lanes, lanes)."""
    if spec is not None:
        g = fast_path.trace_geometric_fast(scene, x, p, spec)
    else:
        g = scn.trace_geometric(scene, x, p)
    n, k = g.ev_kind.shape
    colors = g.surface_colors.reshape(n * k, 4).clone()
    marched = torch.zeros((), dtype=torch.int64, device=x.device)
    emitting = torch.zeros_like(marched)
    lanes = 0
    for idx, obj in enumerate(scene.objects):
        if not isinstance(obj, VolumetricDisc):
            continue
        slots, ins = fast_path.volumetric_lanes(obj, g.ev_kind, g.ev_data, g.observer_energy, g.p_t, g.p_phi, idx)
        if not slots.numel():
            continue
        if spec is not None and vm.supports(obj, scene.geometry):
            xyza, lane_samples = vm.raymarch(vm.build_vol_spec(obj, scene.geometry), *ins)
            marched = marched + lane_samples.sum(dtype=torch.int64)
        else:
            xyza = obj.raymarch(scene.geometry, *ins[:6])
        colors[slots] = xyza
        emitting = emitting + (xyza[:, 3] > 0.0).sum()
        lanes += int(slots.numel())
    color, ray_class = scn.fold_samples(scene, g.ev_kind, colors.reshape(n, k, 4), g.stop_code, g.celestial)
    return scn.RaySamples(color, ray_class, g.stop_code, g.steps, g.ev_overflow), marched, emitting, lanes


def _retrace_overflow(scene, row_f, col_f):
    """Trace the rays whose event slots overflowed again on the RKF45 path
    with OVERFLOW_MAX_EVENTS slots (the reference records every crossing),
    as the JAX driver does. Returns ((color, ray_class, stop_code,
    ev_overflow, steps) on the host, (march seconds, shading seconds)). A
    ray that overflows those slots too keeps its first OVERFLOW_MAX_EVENTS
    events, with a warning."""
    cfg = scene.integration
    wide = dataclasses.replace(scene, integration=dataclasses.replace(cfg, max_events=OVERFLOW_MAX_EVENTS))
    geometry = wide.geometry
    sync = torch.cuda.synchronize if row_f.is_cuda else (lambda: None)
    t0 = time.perf_counter()
    x, p = cam.pixel_rays(wide.camera, row_f, col_f)
    solver = geometry.make_solver(x, p)
    y0 = solver.initial_state(x, p)
    freq = ray_frequency_data(geometry, x, p, wide.camera.velocity)
    res = integ.integrate_rays(geometry, solver, wide.integration, y0, scn._segment_fn(wide), scn.EVENT_WIDTH)
    sync()
    t1 = time.perf_counter()
    s = scn.finish_rays(wide, freq, solver, res)
    outs = [o.cpu().numpy() for o in (s.color, s.ray_class, s.stop_code, s.ev_overflow, s.steps)]
    t2 = time.perf_counter()
    if outs[3].any():
        print(
            f"[raytracer] {int(outs[3].sum())} rays still overflow {OVERFLOW_MAX_EVENTS} events "
            "after their re-trace",
            file=sys.stderr,
        )
    return outs, (t1 - t0, t2 - t1)


def trace_pixels_chunked(scene, row_f, col_f, chunk_size: int, progress: bool = False, lax: bool = False):
    """Trace arbitrary (fractional) pixel coordinates in fixed-size chunks.
    Returns (color [N, 4], ray_class [N], ok [N], TraceStats) with numpy
    arrays; ok=False marks rays whose shading failed or whose controller
    gave up, which supersample averages exclude. The scene's route
    (`_route`; lax=True takes the RKF45 forms) traces each chunk. Rays that
    overflow their event slots are traced again on the RKF45 path with
    OVERFLOW_MAX_EVENTS (`_retrace_overflow`); the re-trace's steps count
    in the stats."""
    spec = fast_path.scene_kernel_spec(scene) if (not lax and fast_path.supports_scene(scene)) else None
    n = row_f.shape[0]
    device = scene.camera.position.device
    dtype = scene.camera.position.dtype
    on_cuda = device.type == "cuda"
    # One upload per pass; coordinates are rounded to the scene dtype.
    rows_d = torch.as_tensor(np.asarray(row_f, np.float64), device=device).to(dtype)
    cols_d = torch.as_tensor(np.asarray(col_f, np.float64), device=device).to(dtype)
    colors = np.zeros((n, 4), np.float32 if dtype == torch.float32 else np.float64)
    classes = np.zeros((n,), np.int32)
    ok_all = np.ones((n,), bool)
    ray_steps = vol_lanes = vol_samples = vol_emitting = overflowed = dropped = overflow_steps = 0
    retrace_s = [0.0, 0.0]
    stop_counts = np.zeros(integ.SATURATED + 1, np.int64)
    t_start = time.perf_counter()

    def _dispatch(start, end):
        outs, lanes = _trace_chunk(scene, spec, rows_d[start:end], cols_d[start:end])
        if not on_cuda:
            return start, end, outs, lanes, None
        # Queue the copies now, so they precede the next chunk on the stream.
        host = tuple(o.to("cpu", non_blocking=True) for o in outs)
        done = torch.cuda.Event()
        done.record()
        return start, end, host, lanes, done

    def _drain(chunk):
        nonlocal ray_steps, vol_lanes, vol_samples, vol_emitting, overflowed, dropped, overflow_steps
        start, end, outs, lanes, done = chunk
        if done is not None:
            done.synchronize()
        c, k, stop, ovf, steps, *vol = (o.numpy() for o in outs)
        idx = np.nonzero(ovf)[0]
        if idx.size:
            sel = torch.as_tensor(start + idx, device=device)
            (c2, k2, stop2, ovf2, steps2), secs = _retrace_overflow(scene, rows_d[sel], cols_d[sel])
            c[idx], k[idx], stop[idx] = c2, k2, stop2
            overflow_steps += int(steps2.astype(np.int64).sum())
            overflowed += idx.size
            dropped += int(ovf2.sum())
            retrace_s[0] += secs[0]
            retrace_s[1] += secs[1]
        colors[start:end] = c
        classes[start:end] = k
        ok_all[start:end] = stop != integ.STEP_FAILED
        ray_steps += int(steps.astype(np.int64).sum())
        vol_lanes += lanes
        if vol:
            vol_samples += int(vol[0])
            vol_emitting += int(vol[1])
        stop_counts[:] += np.bincount(stop, minlength=stop_counts.size)
        if progress:
            rate = end / max(time.perf_counter() - t_start, 1e-9)
            print(f"\r  traced {end}/{n} rays ({rate:.0f} rays/s)", end="", file=sys.stderr)

    pending = None
    for start in range(0, n, chunk_size):
        nxt = _dispatch(start, min(start + chunk_size, n))
        if pending is not None:
            _drain(pending)
        pending = nxt
    if pending is not None:
        _drain(pending)
    if progress:
        print(file=sys.stderr)
    stats = TraceStats(time.perf_counter() - t_start, n, ray_steps + overflow_steps, stop_counts, vol_lanes,
                       vol_samples, vol_emitting, overflowed, dropped, overflow_steps, retrace_s[0], retrace_s[1])
    return colors, classes, ok_all, stats


# ---------------------------------------------------------------------------
# Render driver
# ---------------------------------------------------------------------------


class RenderOutput(NamedTuple):
    color: np.ndarray  # [H, W, 4] CIE XYZA
    ray_class: np.ndarray  # [H, W]
    supersample_mask: Optional[np.ndarray]  # [H, W] bool (None if AA disabled)
    stats: dict  # "pass1" / "aa": TraceStats of each traced pass
    timings: Optional[dict] = None  # seconds of the CLI's other parts (cli.cmd_render)


def render_section(
    scene,
    from_row: int = 0,
    from_col: int = 0,
    to_row: Optional[int] = None,
    to_col: Optional[int] = None,
    chunk_size: int = CHUNK_SIZE,
    sampling_mask_color: Optional[tuple] = None,
    progress: bool = False,
    lax: bool = False,
) -> RenderOutput:
    """Render [from_row, to_row) × [from_col, to_col) of the camera grid
    with the scene's adaptive supersampling. With sampling_mask_color (an
    XYZA tuple) selected pixels are painted instead of re-traced. lax=True
    traces on the RKF45 path (trace_pixels_chunked)."""
    camera = scene.camera
    to_row = camera.rows if to_row is None else to_row
    to_col = camera.columns if to_col is None else to_col
    h, w = to_row - from_row, to_col - from_col
    rr, cc = np.meshgrid(
        np.arange(from_row, to_row, dtype=np.float64),
        np.arange(from_col, to_col, dtype=np.float64),
        indexing="ij",
    )
    colors, classes, _, pass1 = trace_pixels_chunked(
        scene, rr.ravel(), cc.ravel(), chunk_size, progress, lax
    )
    stats = {"pass1": pass1}
    colors = colors.reshape(h, w, 4)
    classes = classes.reshape(h, w)

    cfg = scene.adaptive
    if not (cfg.enabled or sampling_mask_color is not None):
        return RenderOutput(colors, classes, None, stats)

    minimum_luminance = resolve_minimum_luminance(cfg, colors[..., 1])
    mask = collect_supersample_mask(cfg, colors[..., 1], colors[..., 3], classes, minimum_luminance)
    if sampling_mask_color is not None:
        out = colors.copy()
        out[mask] = np.asarray(sampling_mask_color, colors.dtype)
        return RenderOutput(out, classes, mask, stats)

    sel_r, sel_c = np.nonzero(mask)
    if sel_r.size:
        n_spp = cfg.samples_per_axis**2
        abs_r = sel_r + from_row
        abs_c = sel_c + from_col
        dx, dy = stratified_sample_offsets(abs_r, abs_c, cfg.samples_per_axis)
        # Sub-pixel ray: row + (dy − ½), col + (dx − ½).
        row_f = (abs_r[:, None] + (dy - 0.5)).ravel()
        col_f = (abs_c[:, None] + (dx - 0.5)).ravel()
        sub_colors, _, sub_ok, aa = trace_pixels_chunked(scene, row_f, col_f, chunk_size, progress, lax)
        stats["aa"] = aa
        # Average over successful samples only; all-failed keeps the base.
        ok = sub_ok.reshape(-1, n_spp)
        n_ok = ok.sum(axis=1)
        sums = (sub_colors.reshape(-1, n_spp, 4) * ok[..., None]).sum(axis=1)
        averaged = sums / np.maximum(n_ok, 1)[:, None]
        use = n_ok > 0
        colors[sel_r[use], sel_c[use]] = averaged[use]
    return RenderOutput(colors, classes, mask, stats)


# ---------------------------------------------------------------------------
# Output formats
# ---------------------------------------------------------------------------


def write_image(path: str, output_color: np.ndarray, tone_mapping: str = col.TONE_MAPPING_REINHARD):
    """Write [H, W, 4] XYZA: Radiance .hdr (raw XYZ) or a tone-mapped PNG."""
    if path.endswith(".hdr"):
        write_radiance_hdr(path, output_color[..., :3].astype(np.float32))
        return
    if not path.endswith(".png"):
        raise ValueError(f"unsupported image format: {path!r} (use .png or .hdr)")
    img = col.xyza_buffer_to_srgb8(torch.from_numpy(np.ascontiguousarray(output_color)), method=tone_mapping)
    with open(path, "wb") as f:
        f.write(png_encode(img.numpy()))


def write_radiance_hdr(path: str, rgb: np.ndarray):
    """Minimal Radiance RGBE writer (flat scanlines)."""
    h, w, _ = rgb.shape
    rgb = np.maximum(rgb, 0.0).astype(np.float64)
    v = rgb.max(axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        mant, exp = np.frexp(v)
        scale = np.where(v >= 1e-32, mant * 256.0 / np.maximum(v, 1e-300), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(v >= 1e-32, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
