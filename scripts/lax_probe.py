#!/usr/bin/env python3
"""Time the port's RKF45 ("lax") path on a CUDA card.

    python3 scripts/lax_probe.py [--size 256] [--check 64]

Prints JSON lines:
  1. "check": a --check² kerr.toml pass in float32 traced for its first
     CHECK_ATTEMPTS iterations through the compacted, graph-replayed loop
     and through one eager run of the same body over every lane
     (integrate_rays(compact=False)); the results must be equal bit for bit;
  2. "kerr": kerr.toml's pass 1 at --size² in float32 on the lax path (the
     requeue driver): seconds, the loop's iterations, compactions and
     lane-iterations, Σ accepted steps, the longest lane, requeue phases,
     the elementwise operations of one loop body on one lane (chip_smoke's
     dispatch counter) and the time of one iteration;
  3. "bl_volumetric": the CLI render of kerr-bl-volumetric-streaky at 256²
     (kernel path, float32, AA), its rays re-traced on the lax path for
     overflowing their 8 event slots, the re-trace's march and shading
     seconds, its accepted steps and the rays that overflow 32 slots too.
Every line carries the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECK_ATTEMPTS = 1000
sys.path.insert(0, HERE)


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def kerr_scene(size, dtype, device):
    from gr_raytracer_tpu_torch import config as tcfg

    import chip_smoke as cs

    opts = tcfg.RenderOptions(width=size, height=size, max_steps=cs.MAX_STEPS, **cs.KERR_CAMERA_KW)
    return tcfg.create_scene(tcfg.load_config(cs.KERR_TOML), opts, dtype, device)


def pixels(size, device, dtype):
    import numpy as np
    import torch

    rr, cc = np.meshgrid(np.arange(size, dtype=np.float64), np.arange(size, dtype=np.float64), indexing="ij")
    return (torch.as_tensor(rr.ravel(), device=device).to(dtype), torch.as_tensor(cc.ravel(), device=device).to(dtype))


def check(size):
    """Compacted and replayed against one eager run of the same body."""
    import torch

    from gr_raytracer_tpu_torch.rendering import camera as cam
    from gr_raytracer_tpu_torch.rendering import integrator as integ
    from gr_raytracer_tpu_torch.rendering import scene as scn

    device = torch.device("cuda")
    scene = kerr_scene(size, torch.float32, device)
    x, p = cam.pixel_rays(scene.camera, *pixels(size, device, torch.float32))
    solver = scene.geometry.make_solver(x, p)
    y0 = solver.initial_state(x, p)
    # The first CHECK_ATTEMPTS iterations: the eager run dispatches every op.
    runs = [integ.integrate_rays(scene.geometry, solver, scene.integration, y0, scn._segment_fn(scene),
                                 scn.EVENT_WIDTH, attempts_budget=CHECK_ATTEMPTS, finalize=False, compact=c)
            for c in (True, False)]
    equal = {k: bool(torch.equal(a, b)) for (k, a), b in zip(runs[0]._asdict().items(), runs[1])}
    return {"rays": size * size, "equal": equal, "bit_identical": all(equal.values()),
            "longest": int(runs[0].steps.max()), "stop_counts": torch.bincount(runs[0].stop_code.to(torch.int64)).tolist()}


def kerr(size):
    import torch

    import chip_smoke as cs
    from gr_raytracer_tpu_torch.rendering import integrator as integ
    from gr_raytracer_tpu_torch.rendering import raytracer as rt

    device = torch.device("cuda")
    scene = kerr_scene(size, torch.float32, device)
    rows, cols = pixels(size, device, torch.float32)
    route = rt._route(scene, lax=True)
    integ.loop_stats.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, _ = rt._trace_chunk(scene, None, rows, cols)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    steps = outs[4]
    march = integ.loop_stats.get("march", {})
    # One body on one lane, counted by chip_smoke's dispatch counter.
    one = kerr_scene(1, torch.float64, torch.device("cpu"))
    from gr_raytracer_tpu_torch.rendering import camera as cam
    from gr_raytracer_tpu_torch.rendering import scene as scn

    x1, p1 = cam.pixel_rays(one.camera, torch.zeros(1, dtype=torch.float64), torch.zeros(1, dtype=torch.float64))
    sol = one.geometry.make_solver(x1, p1)
    y1 = sol.initial_state(x1, p1)
    ops = cs.count_ops(lambda: integ.integrate_rays(one.geometry, sol, one.integration, y1, scn._segment_fn(one),
                                                    scn.EVENT_WIDTH, attempts_budget=1, finalize=False))
    return {"size": size, "route": route, "seconds": secs, "rays": size * size,
            "accepted_steps": int(steps.to(torch.int64).sum()), "longest_lane": int(steps.max()),
            "p99_lane": float(torch.quantile(steps.double(), 0.99)), "march": march,
            "requeue_phases": integ.loop_stats.get("requeue_phases", 0),
            "ops_per_body_one_lane": ops,
            "ms_per_iteration": secs * 1e3 / max(march.get("iterations", 1), 1),
            "stop_counts": torch.bincount(outs[2].to(torch.int64), minlength=8).tolist(),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def bl_volumetric():
    import torch

    import chip_smoke as cs
    from gr_raytracer_tpu_torch.ops import geodesic_march as gm
    from gr_raytracer_tpu_torch.ops import volumetric_march as vm
    from gr_raytracer_tpu_torch.rendering import integrator as integ

    integ.loop_stats.clear()
    with tempfile.TemporaryDirectory() as tmp:
        out, total_s, ran = cs.cli_render(cs.BL_VOL_TOML, cs.BL_VOL_FRAME, cs.BL_CAMERA, os.path.join(tmp, "f.png"),
                                          (("K3", gm, "bl_launches"), ("K5", vm, "launches")))
    passes = {k: s._asdict() for k, s in out.stats.items()}
    for s in passes.values():
        s["stop_counts"] = s["stop_counts"].tolist()
    return {"frame_s": total_s, "kernels": ran, "passes": passes, "loops": integ.loop_stats}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--check", type=int, default=64)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("lax_probe: needs a CUDA card", file=sys.stderr)
        return 2
    name = card()
    for label, fn in (("check", lambda: check(args.check)), ("kerr", lambda: kerr(args.size)),
                      ("bl_volumetric", bl_volumetric)):
        t0 = time.perf_counter()
        r = fn()
        print(json.dumps({label: r, "wall_s": time.perf_counter() - t0, "card": name}, default=str), flush=True)
        if label == "check" and not r["bit_identical"]:
            print("lax_probe: the compacted loop differs from the eager one", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
