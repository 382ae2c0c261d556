"""Command-line interface (port of the `render` action of
gr_raytracer_tpu/cli.py, with the same flags).

    python -m gr_raytracer_tpu_torch --width 1000 --height 1000 \\
      --camera-position=-10,0,-0.5 --theta=1.52 --psi=-1.57 \\
      -c scene-definitions/kerr.toml render --filename render-kerr.png

Runs on the CUDA card unless `--device cpu` is given; without a card and
without `--device cpu` it raises.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch


def _build_parser():
    from gr_raytracer_tpu_torch.rendering.raytracer import CHUNK_SIZE

    p = argparse.ArgumentParser(prog="gr-raytracer-tpu-torch", description=__doc__)
    p.add_argument("--width", type=int, default=500)
    p.add_argument("--height", type=int, default=500)
    p.add_argument("--step-size", type=float, default=0.01)
    p.add_argument("--max-steps", type=int, default=20000)
    p.add_argument("--max-radius", type=float, default=15000.0)
    p.add_argument("--epsilon", type=float, default=1e-5)
    p.add_argument("--camera-position", type=str, default="18.0,0.0,0.8", help="Cartesian x,y,z")
    p.add_argument("--phi", type=float, default=0.0, help="camera pre-roll (radians)")
    p.add_argument("--theta", type=float, default=0.0, help="camera tilt (radians)")
    p.add_argument("--psi", type=float, default=0.0, help="camera roll (radians)")
    p.add_argument("--tone-mapping", choices=["reinhard", "global-linear"], default="reinhard")
    p.add_argument("--show-sampling-mask", action="store_true")
    p.add_argument("--sampling-mask-color", type=str, default="255,0,255")
    p.add_argument("-c", "--config-file", type=str, default=None)
    p.add_argument("--f64", action="store_true", help="float64 instead of float32")
    p.add_argument("--chunk-size", type=int, default=CHUNK_SIZE,
                   help="rays traced together: prepared, marched (two K3 launches in Mino time), shaded and folded")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")

    sub = p.add_subparsers(dest="action", required=True)
    r = sub.add_parser("render")
    r.add_argument("--filename", type=str, default="render.png")
    r.add_argument("--from-row", type=int, default=None)
    r.add_argument("--from-col", type=int, default=None)
    r.add_argument("--to-row", type=int, default=None)
    r.add_argument("--to-col", type=int, default=None)
    return p


def _floats(s: str, n: int, what: str):
    parts = [float(v) for v in s.split(",")]
    if len(parts) != n:
        raise SystemExit(f"error: {what} expects {n} comma-separated values, got {len(parts)}")
    return tuple(parts)


def _load_scene(args, dtype, device):
    from gr_raytracer_tpu_torch import config as cfgmod

    if args.config_file is None:
        raise SystemExit("error: --config-file is required for this action")
    cfg = cfgmod.load_config(args.config_file)
    opts = cfgmod.RenderOptions(
        width=args.width,
        height=args.height,
        step_size=args.step_size,
        max_steps=args.max_steps,
        max_radius=args.max_radius,
        epsilon=args.epsilon,
        camera_position=_floats(args.camera_position, 3, "--camera-position"),
        phi=args.phi,
        theta=args.theta,
        psi=args.psi,
        tone_mapping=args.tone_mapping,
        show_sampling_mask=args.show_sampling_mask,
        sampling_mask_color=_floats(args.sampling_mask_color, 3, "--sampling-mask-color"),
    )
    return opts, cfgmod.create_scene(cfg, opts, dtype, device)


def cmd_render(args, dtype, device):
    """Render and save the image; returns the RenderOutput."""
    from gr_raytracer_tpu_torch.rendering import raytracer as rt
    from gr_raytracer_tpu_torch.rendering.color import srgb8_to_xyza

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    opts, scene = _load_scene(args, dtype, device)
    t_scene = time.perf_counter() - t0
    mask_color = None
    if args.show_sampling_mask:
        mask_color = tuple(srgb8_to_xyza(opts.sampling_mask_color, torch.float64, "cpu").tolist())
    out = rt.render_section(
        scene,
        from_row=args.from_row or 0,
        from_col=args.from_col or 0,
        to_row=args.to_row,
        to_col=args.to_col,
        chunk_size=args.chunk_size,
        sampling_mask_color=mask_color,
        progress=True,
    )
    t_write = time.perf_counter()
    rt.write_image(args.filename, out.color, tone_mapping=args.tone_mapping)
    out = out._replace(timings={"scene_build": t_scene, "write": time.perf_counter() - t_write})
    print(f"scene build {t_scene:.2f}s", file=sys.stderr)
    for name, s in out.stats.items():
        vol = ""
        if s.vol_lanes:
            vol = f", {s.vol_lanes} volumetric lanes ({s.vol_emitting} emitting), {s.vol_samples} samples"
        print(
            f"{name}: {s.rays} rays, {s.ray_steps} ray-steps in {s.seconds:.3f}s "
            f"({s.rays / s.seconds:.0f} rays/s, {s.ray_steps / s.seconds:.4g} ray-steps/s"
            f"{vol}, {s.overflow} re-traced for event overflow, {s.overflow_dropped} of them "
            "still overflowing)",
            file=sys.stderr,
        )
    if device.type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB", file=sys.stderr)
    print(f"saved image to {args.filename} ({time.perf_counter() - t0:.1f}s)")
    return out


def main(argv=None):
    from gr_raytracer_tpu_torch.precision import resolve_device

    args = _build_parser().parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.float64 if args.f64 else torch.float32
    return {"render": cmd_render}[args.action](args, dtype, device)


if __name__ == "__main__":
    main()
