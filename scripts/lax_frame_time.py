#!/usr/bin/env python3
"""Time the lax main path of chip_smoke.py's phase 33 for one source tree.

    python3 scripts/lax_frame_time.py [--root DIR] [--repeat 2] [--tag NAME]

render_section(..., lax=True) of kerr.toml and schwarzschild.toml at
chip_smoke.FRAME² in float32 (phase 33's sky radius and budget), built and
rendered with the chip_smoke.py and gr_raytracer_tpu_torch of --root (by
default this checkout). One untimed render first (it captures the
iteration's CUDA graph), then --repeat timed ones. Prints one JSON line a
scene, with the card's name and power limit: seconds of each render, loop
iterations and ms an iteration. To compare two trees, unpack one beside
the other (git archive) and run them in turns on one card, one after another:
A, B, B, A.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--tag", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        sys.exit("lax_frame_time: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for name, toml, camera_kw in (("kerr.toml", cs.KERR_TOML, cs.KERR_CAMERA_KW),
                                  ("schwarzschild.toml", cs.SCHWARZSCHILD_TOML, cs.BL_CAMERA_KW)):
        scene = cs.lax_scene(toml, cs.FRAME, camera_kw, torch.float32)
        cs.lax_render(scene, name)
        runs = [cs.lax_render(scene, name)[1] for _ in range(args.repeat)]
        print(json.dumps({"lax_frame_time": {
            "tree": args.tag or root, "scene": name, "frame": runs[0]["frame"],
            "seconds": [r["seconds"] for r in runs], "iterations": [r["iterations"] for r in runs],
            "ms_per_iteration": [r["ms_per_iteration"] for r in runs]}, "card": card}), flush=True)


if __name__ == "__main__":
    main()
