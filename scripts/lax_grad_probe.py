#!/usr/bin/env python3
"""Time reverse mode through the port's RKF45 ("lax") path on a CUDA card.

    python3 scripts/lax_grad_probe.py [--grad-budgets 2000] [--forward-budgets 20000]
                                      [--size 128] [--block 256]

scripts/grad_scale_probe.py's grad_step on the port: the flagship preset at
--size² in float32 (sky radius 40, step 0.05), the loop in checkpointed
blocks of --block iterations, loss mean(log1p(max(c, 0))). Prints JSON
lines, each with the card's name and power limit:
  1. "grad": per --grad-budgets budget, one value and gradient
     (chip_smoke.lax_value_and_grad): forward and backward seconds, loop
     iterations and blocks, the lanes each block ran over, ms an iteration
     each way, peak device memory, the loss and the seven gradients of
     tests/test_grad.py (all finite?);
  2. "forward": per --forward-budgets budget, the differentiable forward
     alone without gradients (iterations, blocks, lanes per block, seconds):
     how far the lanes that stall keep the blocks running;
  3. "f64": the 16² sub-grid of chip_smoke's phase 37 in float64 at its
     budget (value and gradient on the card; seconds);
  4. "scene": schwarzschild.toml at --size² in float32 (chip_smoke's phase
     39) at --scene-budget, value and gradient.
A measurement stopped by SIGINT (`timeout -s INT`) prints a "cut" line
instead: its seconds so far, and the lanes and start time of each
checkpointed block its forward reached.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


class BlockLog:
    """Wraps torch.utils.checkpoint.checkpoint (which run_blocks calls once
    a block, in the forward) to log each block's lanes and start time."""

    def __init__(self):
        import torch.utils.checkpoint as ckpt

        self.ckpt, self.inner, self.rows, self.t0 = ckpt, ckpt.checkpoint, [], time.perf_counter()

        def logged(fn, *args, **kw):
            lanes = next(iter(args[0].values())).shape[0] if args and isinstance(args[0], dict) else None
            self.rows.append((round(time.perf_counter() - self.t0, 3), lanes))
            return self.inner(fn, *args, **kw)

        ckpt.checkpoint = logged

    def close(self):
        self.ckpt.checkpoint = self.inner


def measured(tag, name, fn):
    """Prints {tag: fn(), "card": name}, or on SIGINT the "cut" line."""
    log = BlockLog()
    try:
        out = fn()
    except KeyboardInterrupt:
        print(json.dumps({"cut": {"what": tag, "s": time.perf_counter() - log.t0, "blocks": len(log.rows),
                                  "block_start_s_and_lanes": log.rows}, "card": name}), flush=True)
        sys.exit(124)
    finally:
        log.close()
    print(json.dumps({tag: out, "card": name}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--block", type=int, default=256)
    ap.add_argument("--grad-budgets", type=int, nargs="*", default=[2000])
    ap.add_argument("--forward-budgets", type=int, nargs="*", default=[20000])
    ap.add_argument("--f64-budget", type=int, default=0, help="0: skip")
    ap.add_argument("--scene-budget", type=int, default=0, help="0: skip")
    ap.add_argument("--detect-anomaly", action="store_true",
                    help="run the measurements under torch.autograd.detect_anomaly: the first backward op "
                         "that makes a NaN raises, with the traceback of its forward op")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from gr_raytracer_tpu_torch import presets
    from gr_raytracer_tpu_torch.rendering import integrator as integ

    if not torch.cuda.is_available():
        sys.exit("lax_grad_probe: needs a CUDA card")
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True, check_nan=True)
    name = card()
    dt = torch.float32
    params = presets.kerr_flagship_params(dt, "cuda")
    for budget in args.grad_budgets:
        def grad(budget=budget):
            r = cs.lax_value_and_grad(cs.lax_flagship_render(args.size, budget, dt, "cuda", block=args.block),
                                      params)
            r.update(budget=budget, block=args.block,
                     finite=all(v == v and abs(v) != float("inf") for v in r["grads"].values()))
            return r

        measured("grad", name, grad)
    for budget in args.forward_budgets:
        def forward(budget=budget):
            render = cs.lax_flagship_render(args.size, budget, dt, "cuda", block=args.block)
            integ.loop_stats.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                loss = float(cs.lax_probe_loss(render(params)))
            torch.cuda.synchronize()
            st = integ.loop_stats["march_diff"]
            return {"budget": budget, "block": args.block, "s": time.perf_counter() - t0, "loss": loss,
                    "iterations": st["iterations"], "blocks": st["blocks"], "lane_iterations": st["lane_iterations"],
                    "lanes_per_block": st["lanes_per_block"]}

        measured("forward", name, forward)
    if args.f64_budget:
        stride = args.size // cs.LAX_GRAD_F64_SIDE
        measured("f64", name, lambda: dict(cs.lax_value_and_grad(
            cs.lax_flagship_render(args.size, args.f64_budget, torch.float64, "cuda", stride=stride,
                                   block=args.block),
            presets.kerr_flagship_params(torch.float64, "cuda")), budget=args.f64_budget))
    if args.scene_budget:
        measured("scene", name, lambda: cs.lax_scene_phase(budget=args.scene_budget, size=args.size))


if __name__ == "__main__":
    main()
