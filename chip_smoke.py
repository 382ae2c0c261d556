#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (gr_raytracer_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit. Phases, each of which exits
non-zero on failure:

  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel);
  3. the march kernel K1 against its plain torch version on the card, on
     65,536 kerr.toml camera rays (the frame's middle CLI chunk) at a
     20,000-step budget, in float32 and float64 with the Kahan update off
     and on;
  4. the main path: the CLI `render` of kerr.toml at 1000×1000, float32,
     adaptive supersampling on, into a temporary directory; the kernel's
     launch count must rise and the frame must show horizon, sky and disc;
  5. one JSON line {"kernels": [...]} with each kernel's launches, error
     against its plain version, times and bound;
  6. the last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_RAYS = 65_536
MAX_STEPS = 20_000
FRAME = 1000
KERR_TOML = os.path.join(HERE, "scene-definitions", "kerr.toml")
CAMERA = ["--camera-position=-10,0,-0.5", "--theta=1.52", "--psi=-1.57"]
# Bars for the kernel against its plain version (the repo's own bars):
F64_STOP_AGREEMENT = 0.999  # stop codes and event counts, float64
F64_RTOL = 1e-9  # state and event payloads on agreeing lanes, per-lane scale
F32_STOP_AGREEMENT = 0.99  # docs/fastpath_accuracy.md kernel-against-lax bar
F32_TONE_ATOL = 0.01  # tone-mapped color c/(1+c) on agreeing lanes
FP32_LANES_PER_SM = 128  # Hopper: FP32 units per SM
FP64_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name):
    print(f"\n== {name}", flush=True)


def nvidia_smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def count_step_flops():
    """Arithmetic operations of one RK4 step of the march, per ray, counted
    by running the plain step on one lane and tallying every elementwise
    arithmetic op (add, sub, mul, div, neg, sqrt, rsqrt, pow, min/max,
    clamp, abs) that torch executes. Compares, selects and copies are not
    counted; event stores are rare and not counted."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from gr_raytracer_tpu_torch.ops import geodesic_march as gm

    arith = {
        "add", "sub", "mul", "div", "neg", "sqrt", "rsqrt", "pow", "minimum", "maximum",
        "clamp", "clamp_min", "abs", "rsub",
    }

    class Counter(TorchDispatchMode):
        flops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__.rstrip("_") in arith and isinstance(out, torch.Tensor):
                Counter.flops += out.numel()
            return out

    y = torch.tensor([[0.0, 8.0, 3.0, 0.5, -1.0, 0.9, 0.2, -0.1]], dtype=torch.float64).T
    c = {
        "radius": torch.tensor(1.0, dtype=torch.float64), "a": torch.tensor(0.499, dtype=torch.float64),
        "h0": torch.tensor(1.0, dtype=torch.float64), "r_ref": torch.tensor(10.0, dtype=torch.float64),
        "h_min_frac": 0.01, "r_plus": torch.tensor(0.53, dtype=torch.float64),
        "horizon_eps": torch.tensor(1e-4, dtype=torch.float64),
        "max_radius_sq": torch.tensor(1e8, dtype=torch.float64), "r_safe": 30.0,
        "budget_steps": 100, "opaque_stop": True, "compensated": False,
    }
    lanes = gm._Lanes(
        y=y, r=gm._ks_radius(c["a"], y[1], y[2], y[3]), stop=torch.zeros(1, dtype=torch.int32),
        steps=torch.zeros(1, dtype=torch.int32), ev_kind=torch.full((1, 8), -1, dtype=torch.int32),
        ev_data=torch.zeros((1, 8, 12), dtype=torch.float64), ev_count=torch.zeros(1, dtype=torch.int32),
        ev_ovf=torch.zeros(1, dtype=torch.bool), comp=torch.zeros_like(y),
    )
    with Counter():
        gm._plain_step(c, lanes, ())
    return Counter.flops


def card_peak_flops(dtype):
    """SMs × FP lanes × 2 (FMA) × the card's maximum SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm")) * 1e6
    lanes = FP32_LANES_PER_SM if dtype == torch.float32 else FP64_LANES_PER_SM
    return sms * lanes * 2.0 * clock_hz


def time_cuda(fn, reps):
    """Mean milliseconds of `fn` over `reps` runs, between CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def march_inputs(dtype, device="cuda"):
    """(scene, spec, y0, freq, solver, inverse) for the middle CLI chunk of
    the 1000×1000 kerr.toml frame, cost-sorted as the main path sorts it."""
    import numpy as np
    import torch

    from gr_raytracer_tpu_torch import config
    from gr_raytracer_tpu_torch.rendering import camera as cam
    from gr_raytracer_tpu_torch.rendering import fast_path

    opts = config.RenderOptions(
        width=FRAME, height=FRAME, max_steps=MAX_STEPS,
        camera_position=(-10.0, 0.0, -0.5), theta=1.52, psi=-1.57,
    )
    scene = config.create_scene(config.load_config(KERR_TOML), opts, dtype, torch.device(device))
    first = FRAME * FRAME // 2 - N_RAYS // 2
    flat = np.arange(first, first + N_RAYS)
    rows = torch.as_tensor(flat // FRAME, dtype=dtype, device=device)
    cols = torch.as_tensor(flat % FRAME, dtype=dtype, device=device)
    x, p = cam.pixel_rays(scene.camera, rows, cols)
    spec = fast_path.scene_kernel_spec(scene)
    solver, y0, freq, inverse = fast_path._prepare_march(scene, x, p)
    return scene, spec, y0.contiguous(), freq, solver, inverse


def lane_relative_error(ref, got):
    import torch

    fin = torch.isfinite(ref)
    scale = torch.where(fin, ref.abs(), 0).reshape(ref.shape[0], -1).amax(dim=1)
    scale = scale.clamp(min=1e-300).reshape((-1,) + (1,) * (ref.dim() - 1))
    err = torch.where(fin, (ref - got).abs(), 0) / scale
    return float(err.max()) if err.numel() else 0.0


def compare_march(dtype, compensated, flops_per_step):
    """K1 against march_plain on the same inputs; returns a result dict."""
    import torch

    from gr_raytracer_tpu_torch.ops import geodesic_march as gm
    from gr_raytracer_tpu_torch.rendering import fast_path
    from gr_raytracer_tpu_torch.rendering.integrator import IntegrationResult

    scene, spec, y0, freq, solver, inverse = march_inputs(dtype)
    args = (spec.radius, spec.a, spec.horizon_epsilon, y0)
    kw = dict(h0=1.0, max_steps=MAX_STEPS, max_radius=scene.integration.max_radius,
              discs=spec.discs, r_safe=spec.r_safe, opaque_stop=spec.opaque,
              compensated=compensated)
    got = gm.kerr_rk4_march(*args, **kw)  # first launch: checks the kernel runs
    torch.cuda.synchronize()
    kernel_ms, got = time_cuda(lambda: gm.kerr_rk4_march(*args, **kw), reps=3)
    t0 = time.perf_counter()
    ref = gm.march_plain(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    y_g, stop_g, steps_g, kind_g, data_g, count_g, ovf_g = got
    y_r, stop_r, steps_r, kind_r, data_r, count_r, ovf_r = ref
    same = (stop_g == stop_r) & (count_g == count_r)
    agree = float(same.double().mean())
    res = {
        "dtype": str(dtype).replace("torch.", ""), "compensated": compensated,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "stop_agreement": agree,
        "stops": torch.bincount(stop_g, minlength=8).tolist(),
        "max_steps_taken": int(steps_g.max()), "sum_steps": int(steps_g.long().sum()),
        "steps_equal_on_agreeing": float((steps_g == steps_r)[same].double().mean()),
    }
    n = y0.shape[0]
    elem = y0.element_size()
    bytes_moved = n * (8 * elem + 8 * elem + 3 * 4 + 8 * 4 + 8 * 12 * elem + 1)
    peak = card_peak_flops(dtype)
    ops_ms = res["sum_steps"] * flops_per_step / peak * 1e3
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    res["bound_ms"] = max(ops_ms, bytes_ms)
    res["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    res["peak_tflops"] = peak / 1e12

    if dtype == torch.float64:
        res["y_rel_err"] = lane_relative_error(y_r[same], y_g[same])
        res["ev_rel_err"] = lane_relative_error(data_r[same], data_g[same])
        res["max_abs_err"] = float(torch.where(torch.isfinite(y_r[same]), (y_r[same] - y_g[same]).abs(), 0).max())
        bad = torch.nonzero(~same).flatten()[:20].tolist()
        res["mismatching_lanes"] = [
            {"lane": i, "stop": [int(stop_r[i]), int(stop_g[i])], "steps": [int(steps_r[i]), int(steps_g[i])]}
            for i in bad
        ]
        ok = agree >= F64_STOP_AGREEMENT and res["y_rel_err"] <= F64_RTOL and res["ev_rel_err"] <= F64_RTOL
    else:
        # Shade both through the same code and compare tone-mapped colors.
        def colors(state):
            r = IntegrationResult(*state)
            return fast_path._finish_samples(scene, r, freq, solver, inverse, spec.opaque).color

        tone = lambda c: c / (1.0 + c)
        c_g, c_r = tone(colors(got)), tone(colors(ref))
        same_px = same[inverse]
        err = (c_g - c_r).abs().amax(dim=1)[same_px]
        res["max_abs_err"] = float(err.max())
        res["tone_err_q999"] = float(torch.quantile(err.double(), 0.999))
        ok = agree >= F32_STOP_AGREEMENT and res["max_abs_err"] <= F32_TONE_ATOL
    res["ok"] = bool(ok)
    return res


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "gr_raytracer_tpu_torch")):
        print("chip_smoke: gr_raytracer_tpu_torch/ is missing next to this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from gr_raytracer_tpu_torch import cli
    from gr_raytracer_tpu_torch.ops import cuda_build
    from gr_raytracer_tpu_torch.ops import geodesic_march as gm
    from gr_raytracer_tpu_torch.utils.png import png_decode

    t_all = time.perf_counter()
    phase("1. card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    phase("2. build")
    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"build {time.perf_counter() - t0:.1f}s")
    for src, (secs, log) in cuda_build.BUILD_LOG.items():
        print(f"  {src}: nvcc {secs:.1f}s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("   ", line.strip())

    phase("3. K1 against its plain version")
    flops_per_step = count_step_flops()
    print(f"flops per ray-step (plain step, counted): {flops_per_step}")
    variants = {}
    for dtype in (torch.float32, torch.float64):
        for compensated in (False, True):
            r = compare_march(dtype, compensated, flops_per_step)
            variants[(dtype, compensated)] = r
            print(json.dumps(r), flush=True)
            if not r["ok"]:
                fail(f"K1 disagrees with its plain version: {r}")

    phase("4. main path: CLI render of kerr.toml")
    gm.launches = 0
    gm.launch_timer = []
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "render-kerr.png")
        argv = ["--width", str(FRAME), "--height", str(FRAME), *CAMERA, "--max-steps", str(MAX_STEPS),
                "-c", KERR_TOML, "render", "--filename", png]
        t0 = time.perf_counter()
        out = cli.main(argv)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = gm.launches
        k1_ms = sum(s.elapsed_time(e) for s, e in gm.launch_timer)
        gm.launch_timer = None
        with open(png, "rb") as f:
            img = png_decode(f.read())
    if launches == 0:
        fail("the main path launched K1 no time")
    pass1, aa = out.stats["pass1"], out.stats.get("aa")
    if aa is None or not out.supersample_mask.any():
        fail("no pixel was supersampled")
    stops = pass1.stop_counts
    for code, name in ((1, "HORIZON"), (2, "CELESTIAL"), (7, "SATURATED")):
        if stops[code] == 0:
            fail(f"no {name} ray in the frame: {stops.tolist()}")
    if img.shape != (FRAME, FRAME, 4) or img[..., :3].std() < 5.0:
        fail(f"the PNG looks trivial: shape {img.shape}, std {img[..., :3].std():.2f}")
    if not (out.color.shape == (FRAME, FRAME, 4) and bool(np.isfinite(out.color).all())):
        fail("the frame has non-finite values or a wrong shape")
    peak32 = card_peak_flops(torch.float32)
    ray_steps = pass1.ray_steps + aa.ray_steps
    frame_bound_ms = ray_steps * flops_per_step / peak32 * 1e3
    main = {
        "frame": f"{FRAME}x{FRAME}", "max_steps": MAX_STEPS, "launches": launches,
        "pass1_s": pass1.seconds, "pass1_rays": pass1.rays, "pass1_ray_steps": pass1.ray_steps,
        "aa_s": aa.seconds, "aa_rays": aa.rays, "aa_ray_steps": aa.ray_steps,
        "total_s": total_s,
        "rays_per_s": (pass1.rays + aa.rays) / (pass1.seconds + aa.seconds),
        "ray_steps_per_s": ray_steps / (pass1.seconds + aa.seconds),
        "k1_ms": k1_ms, "k1_bound_ms": frame_bound_ms,
        "k1_ray_steps_per_s": ray_steps / (k1_ms / 1e3),
        "supersampled_pixels": int(out.supersample_mask.sum()),
        "stop_counts_pass1": stops.tolist(),
    }
    print(json.dumps(main), flush=True)

    phase("5. kernels")
    prod = variants[(torch.float32, False)]
    kernels = [{
        "name": "kerr_rk4_march",
        "route": "cuda",
        "source": "gr_raytracer_tpu_torch/csrc/kerr_rk4_march.cu",
        "replaces": "gr_raytracer_tpu/ops/geodesic_pallas.py:790",
        "launches": launches,
        "max_abs_err": max(prod["max_abs_err"], variants[(torch.float32, True)]["max_abs_err"]),
        "ms": prod["kernel_ms"],
        "plain_ms": prod["plain_ms"],
        "bound_ms": prod["bound_ms"],
        "bound_by": prod["bound_by"],
        "library_ms": None,
    }]
    print(f"wall {time.perf_counter() - t_all:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
