#!/usr/bin/env python3
"""Which rays the float32 RKF45 ("lax") path stops BUDGET, in the port and
in the JAX package, and what the kernel path and the float64 lax path say of
them. CPU only; it imports both packages, as the port's tests do.

    python3 scripts/lax_stall_probe.py {split,kerr,schwarzschild} [--size 32]

The scene is the one chip_smoke.py's phases 33 and 35 hold the lax path to
its kernel frame with: kerr.toml or schwarzschild.toml at 1000², or the
split scene (kerr-volumetric-streaky.toml's gas disc beside
kerr-sphere.toml's sphere) at 256², sky radius 40, budget 4,000. The probe
traces a --size² sub-grid of the frame's pixels (every (frame // size)-th
row and column) and prints one JSON line:
  - the geometric march's stop codes on the port's lax path and on the JAX
    package's (float32), and on which rays they stop BUDGET;
  - the port's kernel path (its plain march here) on every ray, and the
    stop agreement of chip_smoke.py (a lax BUDGET ray agrees only with a
    kernel HORIZON; a kernel SATURATED ray agrees iff the lax ray class is
    HIT);
  - on the rays the port's lax path stops BUDGET: the JAX kernel's stop
    codes (interpret mode), and the JAX lax path's in float32 and float64
    at budgets 4,000 and 20,000 (the CLI's).
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CAMERAS = {
    "split": dict(camera_position=(-10.0, 0.0, -0.5), theta=1.52, psi=-1.57),
    "kerr": dict(camera_position=(-10.0, 0.0, -0.5), theta=1.52, psi=-1.57),
    "schwarzschild": dict(camera_position=(-10.0, 0.0, -0.5), theta=-3.14159),
}
FRAMES = {"split": 256, "kerr": 1000, "schwarzschild": 1000}
MAX_RADIUS = 40.0
MAX_STEPS = 4000


def scene_toml(which):
    """The scene's TOML text: the split scene joins the gas disc's file and
    the sphere table of kerr-sphere.toml."""
    read = lambda name: open(os.path.join(REPO, "scene-definitions", name)).read()
    if which != "split":
        return read(f"{which}.toml")
    sphere = read("kerr-sphere.toml")
    sphere = sphere[sphere.index("[[objects]]\n[objects.Sphere]"):]
    return read("kerr-volumetric-streaky.toml") + "\n" + sphere


def counts(codes):
    import numpy as np

    return np.bincount(np.asarray(codes), minlength=8).tolist()


def jax_lax_stops(toml, opts, rows, cols, dtype, max_steps):
    import jax
    import jax.numpy as jnp

    from gr_raytracer_tpu import config as jcfg
    from gr_raytracer_tpu.rendering import camera as jcam
    from gr_raytracer_tpu.rendering import integrator as jint
    from gr_raytracer_tpu.rendering import scene as jscn

    scene = jcfg.create_scene(jcfg.parse_config(toml, base_dir=REPO),
                              jcfg.RenderOptions(**dict(opts, max_steps=max_steps)), dtype)
    x, p = jcam.pixel_rays(scene.camera, jnp.asarray(rows, dtype), jnp.asarray(cols, dtype))
    solver = scene.geometry.make_solver(x, p)
    march = jax.jit(lambda y0: jint.integrate_rays(scene.geometry, solver, scene.integration, y0,
                                                   jscn._segment_fn(scene), jscn.EVENT_WIDTH))
    return march(solver.initial_state(x, p)).stop_code, scene, x, p


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", choices=sorted(CAMERAS))
    ap.add_argument("--size", type=int, default=32)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch

    from gr_raytracer_tpu.rendering import fast_path as jfp
    from gr_raytracer_tpu_torch import config as tcfg
    from gr_raytracer_tpu_torch.rendering import camera as tcam
    from gr_raytracer_tpu_torch.rendering import fast_path as tfp
    from gr_raytracer_tpu_torch.rendering import integrator as tint
    from gr_raytracer_tpu_torch.rendering import scene as tscn
    from gr_raytracer_tpu_torch.rendering.redshift import ray_frequency_data

    which, frame = args.scene, FRAMES[args.scene]
    toml = scene_toml(which)
    opts = dict(width=frame, height=frame, max_steps=MAX_STEPS, max_radius=MAX_RADIUS, **CAMERAS[which])
    grid = np.arange(0, frame, frame // args.size, dtype=np.float64)
    rows, cols = (v.ravel() for v in np.meshgrid(grid, grid, indexing="ij"))

    t0 = time.perf_counter()
    scene = tcfg.create_scene(tcfg.parse_config(toml, base_dir=REPO), tcfg.RenderOptions(**opts), torch.float32,
                              torch.device("cpu"))
    x, p = tcam.pixel_rays(scene.camera, torch.as_tensor(rows, dtype=torch.float32),
                           torch.as_tensor(cols, dtype=torch.float32))
    solver = scene.geometry.make_solver(x, p)
    res = tint.integrate_rays(scene.geometry, solver, scene.integration, solver.initial_state(x, p),
                              tscn._segment_fn(scene), tscn.EVENT_WIDTH)
    lax_stop = res.stop_code.numpy()
    port_s = time.perf_counter() - t0
    # The kernel path: the full tracer where every texture is opaque (its
    # SATURATED stop, which agrees with a lax ray classified HIT), else the
    # geometric pass the split driver runs (no SATURATED stop, so the lax
    # ray classes and their raymarch are not needed).
    spec = tfp.scene_kernel_spec(scene)
    lax_class = (tscn.finish_rays(scene, ray_frequency_data(scene.geometry, x, p, scene.camera.velocity), solver,
                                  res).ray_class.numpy() if spec.opaque else np.zeros_like(lax_stop))
    kernel = (tfp.trace_rays_fast(scene, x, p, spec=spec) if spec.opaque
              else tfp.trace_geometric_fast(scene, x, p, spec))
    kernel_stop = kernel.stop_code.numpy()

    jax_stop, j_scene, jx, jp = jax_lax_stops(toml, opts, rows, cols, jnp.float32, MAX_STEPS)
    jax_stop = np.asarray(jax_stop)
    budget = np.nonzero(lax_stop == 5)[0]
    sat = kernel_stop == 7
    agree = (kernel_stop == lax_stop) | (sat & (lax_class == 2)) | ((lax_stop == 5) & (kernel_stop == 1))
    out = {
        "scene": which, "frame": frame, "rays": int(rows.size), "port_lax_s": port_s,
        "port_lax_f32": counts(lax_stop), "jax_lax_f32": counts(jax_stop),
        "lax_f32_equal_stops": float((lax_stop == jax_stop).mean()),
        "budget_port_and_jax": int(((lax_stop == 5) & (jax_stop == 5)).sum()),
        "budget_port_only": int(((lax_stop == 5) & (jax_stop != 5)).sum()),
        "budget_jax_only": int(((lax_stop != 5) & (jax_stop == 5)).sum()),
        "port_kernel": counts(kernel_stop), "stop_agreement": float(agree.mean()),
        "disagreeing_lax_codes": counts(lax_stop[~agree]), "disagreeing_kernel_codes": counts(kernel_stop[~agree]),
        "budget_rays": {"port_kernel": counts(kernel_stop[budget])},
    }
    if budget.size:
        j_trace = jfp.trace_rays_fast if spec.opaque else jfp.trace_geometric_fast
        jk = np.asarray(j_trace(j_scene, jx[budget], jp[budget], interpret=True).stop_code)
        out["budget_rays"]["jax_kernel"] = counts(jk)
        out["budget_rays"]["jax_kernel_equals_port_kernel"] = bool((jk == kernel_stop[budget]).all())
        for dtype in (jnp.float32, jnp.float64):
            for steps in (MAX_STEPS, 20_000):
                stop, _, _, _ = jax_lax_stops(toml, opts, rows[budget], cols[budget], dtype, steps)
                out["budget_rays"][f"jax_lax_{jnp.dtype(dtype).name}_{steps}"] = counts(stop)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
