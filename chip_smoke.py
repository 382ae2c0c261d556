#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (gr_raytracer_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit. The phases, each of which exits
non-zero on failure:

  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel)
     and print each kernel's registers, spill stores, shared memory and
     resident warps per SM (ptxas; its report is kept beside each library,
     so a cached build prints it too);
  3. the march kernel K1 against its plain torch version on the card, on
     65,536 kerr.toml camera rays (the frame's middle 65,536 pixels) at a
     20,000-step budget, in float32 and float64 with the Kahan update off
     and on; and each one's critical path (its longest lane, and the
     kernel's time on the 128 longest lanes alone; as in phases 8, 13, 21
     and 22); then K1's registers and the instructions of one common-path
     step in its SASS (as K3's in phase 8), and K1's launch table
     (K1Launches: per launch its lanes, Σ steps, longest lane, p99, p50,
     ms, steps/s, warp efficiency in launch order and the ms of its 128
     longest lanes alone) on the KS, disc and sphere, and medium fit
     frames, with each one's issue share;
  4. the main path: the CLI `render` of kerr.toml at 1000×1000, float32,
     adaptive supersampling on, into a temporary directory; the kernel's
     launch count must rise and the frame must show horizon, sky and disc;
     its K1 launch table; then K1 at the main path's shape against its
     plain version: pass 1's 1,000,000 lanes marched as the render marches
     them (fast_path._march: one launch, most lanes taken by the kernel's
     refill) with phase 3's float32 chunk in the place of its own pixels,
     whose lanes must equal phase 3's plain results bit for bit;
  5. K1 with checkpoints (every 128 steps) against its plain version on the
     65,536 rays of the 256² flagship fit frame at its true parameters,
     budget 2,000, float32 and float64: outputs and the checkpoint rows a
     lane reaches must be equal;
  6. the reverse sweep K2 against its plain version on the same rays, with
     seeded cotangents on the final state of escaped lanes and on event
     slot 0 of hit lanes, float64 and float32; first K2's registers and
     the SASS instructions of one re-forward and one reverse step
     (sass_sweep_step), then with each comparison its critical path (its
     lanes' reverse steps, and the kernel on its 128 longest lanes alone)
     and issue share (as for K4 in phase 11 and K2 in phase 28);
  7. the gradient path: 10 steps of inverse.fit, the joint three-parameter
     fit of scripts/grad_scale_probe.py --fit3 (256², budget 2,000,
     float32, pyramid loss (4, 16), clip 1.0 ahead of Adam with the cosine
     schedule (1e-2, 400, 0.01)) from its start1; K1 and K2 must launch
     and every gradient must be finite;
  8. the Mino-time march K3 against its plain version on the card, on the
     middle 65,536-ray chunk of the 1000² kerr-bl.toml frame at the CLI's
     Mino budget of 40,000 (nominal 20,000): float32 without Kahan (the
     main path's configuration) over the whole budget, float32 with Kahan
     and float64 with and without over their first 4,000 steps (the plain
     march costs milliseconds an iteration whatever the lane count; each
     kernel is timed over the whole budget); then K3
     with checkpoints (every 128 steps) on the 16,384 rays of the BL fit
     frame, float32 (whole budget) and float64 (first 4,000 steps); first
     K3's registers, spills and resident warps (ptxas) and the instructions
     of one common-path step of its loop, counted in its SASS (cuobjdump);
  9. the BL main path: the CLI `render` of kerr-bl.toml at 1000×1000
     (docs/examples.md), float32, 4×4 AA; K3 must launch and the frame must
     show horizon, sky and disc; a table of its K3 launches (pass, march or
     re-trace, leg, lanes, steps, longest lane, ms, steps/s, the share of
     the steps its first 10 % of lanes take; as for the frames of phases
     10, 16, 23 and 25), the host seconds spent in the kernel path's
     functions and the issue share of its steps; then K3 at the main
     path's shape against its plain version: pass 1's 1,000,000 lanes
     marched as the render marches them (fast_path._march: two launches,
     most lanes taken by the kernel's refill) with phase 8's float32 chunk
     in the place of its own pixels, whose lanes must equal phase 8's plain
     results bit for bit;
 10. Schwarzschild through K3 at a = 0: the CLI `render` of the disc-only
     Schwarzschild scene of tests/test_golden_frames.py at 512×512;
 11. the BL reverse sweep K4 against its plain version on the BL fit
     frame's checkpoints, with seeded cotangents, float64 and float32,
     with phase 6's readings;
 12. the BL gradient path: the 12-step spin fit of
     scripts/grad_scale_probe.py --bl (kerr-bl.toml 128², nominal budget
     10,000, float32, target a = 0.45, start 0.30, Adam 3e-2); K3 and K4
     must launch, every gradient must be finite, the loss must fall and a
     must move toward 0.45;
 13. K1 and K3 with volume-bound events against their plain versions: K1
     on the middle 65,536-ray chunk of the 500² kerr-volumetric-streaky
     frame at budget 20,000, K3 on the 256² kerr-bl-volumetric-streaky
     frame over its first 4,000 steps, float32 and float64;
 14. the raymarch K5 against its plain version on the volumetric lanes of
     that K1 chunk, float32 and float64, with the march budget cut to
     VOL_COMPARE_STEPS samples (the plain loop costs milliseconds per
     sample whatever the lane count), with 128 lanes added that cross the
     disc's inner hole within that budget; a replay of the plain k walk
     counts the compared lanes that take next_k's hole jump, and some of
     the added ones must; then K5 alone at the scene's full
     50,000-sample budget, its batch use on those lanes (Σ nᵢ over
     Σ 32·⌈nᵢ/32⌉: a warp evaluates a lane's samples 32 at a time) and its
     critical path: the lanes' sample counts (longest, p99, p50, the share
     that march) and K5's time on the 128 longest lanes alone and on all
     but the longest 1 %;
 15. the volumetric main path: the CLI `render` of kerr-volumetric-streaky
     at 500×500 (docs/examples.md), float32, 4×4 AA; K1 and K5 must
     launch, the frame must show horizon and sky and K5 lanes that emit;
     it prints the rays re-traced on the lax path because they overflowed
     their 8 event slots (their count, accepted steps, march and shading
     seconds, `lax_retrace`), and, as a fault, those that overflowed the
     re-trace's 32 too,
     and the batch use and longest lane of each K5 launch and the frame's
     batch use; its K1 launch table, and phase 4's check of K1 at the main
     path's shape on its AA pass, with phase 13's float32 chunk in the
     middle;
 15b. kerr.toml at 1000² and kerr-volumetric-streaky at 500² rendered by
     the CLI at --chunk-size 65,536 and at 2^20: each pair of frames must
     be equal bit for bit;
 16. the BL volumetric path: the CLI `render` of
     kerr-bl-volumetric-streaky at 256×256 through K3 and K5 (the same K5
     figures, and its lax re-trace: the frame's K3 launches are its main
     passes alone); then phase 9's check of K3 at the main path's shape
     on its AA pass, with phase 13's float32 chunk in the middle, over the
     first 4,000 steps against phase 13's plain results;
 17. the raw-output raymarch K6 against its plain version on phase 14's
     lanes, float32 and float64, at VOL_COMPARE_STEPS samples; its results
     combined (combine_alpha) against K5's XYZA; K6 alone at 50,000;
 18. the volumetric backward K7 against its plain version on the same
     lanes with seeded cotangents, float64 and float32, at
     VOL_BWD_COMPARE_STEPS samples (K2's bars); K7 alone at 50,000;
 18b. K7's five medium sums in float64 on those lanes at the full 50,000-
     sample budget against central differences of K6 on the same lanes
     and cotangents (L = Σ ct·(acc, T_f, Ws, Wt), a step of 1e-5 of each
     parameter) over the lanes whose saturation step does not move within
     the step (there Ws and Wt jump; the difference over all lanes is
     printed beside it): within 1e-5 relative, with at most 1 % of the
     marching lanes left out for any parameter;
 19. the volumetric gradient path of scripts/grad_scale_probe.py --vol
     (kerr-volumetric-streaky 256², hero #5's camera, budget 20,000, the
     TOML's 50,000-sample raymarch, float32): one value and gradient of its
     loss over the five medium parameters (finite; K1, K6 and K7 must
     launch), then the first 20 steps of its 60-step density_multiplier and
     absorption fit from (300, 0.6): the loss must fall and both must move
     toward (500, 0.3); where a step's time goes; K5's batch use on the
     frame's volumetric lanes;
 20. one value and gradient on kerr-bl-volumetric-streaky at 128² through
     K3, K6 and K7: finite and nonzero;
 21. K1 with sphere events against its plain version, float32 and
     float64, over the whole budget: the middle 65,536-ray chunk of
     kerr-sphere.toml at 1000² (r_s = 0: straight chords) and of the disc
     and sphere scene of tests/test_pallas.py::test_kerr_sphere_kernel_
     parity at 1000² (its camera, budget 3,000, sky radius 40); every
     compared chunk must hold sphere events;
 22. K3 with sphere events against its plain version, float32 and float64:
     the last 65,536 pixels of schwarzschild.toml at 1000² (where a CPU
     preview found its sphere's image) over their first 1,000 steps,
     and the middle chunk of the scene of tests/test_pallas.py::
     test_bl_kernel_sphere_parity at 1000² (its camera and budget), float32
     over the whole budget and float64 over its first 4,000 steps;
 23. the sphere path: the CLI `render` of schwarzschild.toml at 1000×1000,
     the command of docs/examples.md (through K3; the frame must hold disc
     hits);
 24. the CLI `render` of kerr-sphere.toml at 1000×1000 (K1, r_s = 0; the
     frame must hold sphere hits);
 25. the CLI `render` of schwarzschild-sphere.toml at 512×512 (K3 at
     r_s = 0; sphere hits): each of 23-25 prints its seconds, scene build,
     passes, the kernel's launches, ms and share of the frame, and the rays
     whose first event is a sphere or a disc (24 also K1's launch table);
 26. phase 19's value and gradient in float64, beside the float32 one and
     the JAX package's (docs/gradient_bench.json "volumetric");
 27. K1 with checkpoints and sphere events against its plain version on
     the 65,536 rays of the 256² Kerr disc and sphere frame of phase 29
     (kerr-sphere.toml around a hole of r_s = 1, a = 0.499; budget 2,000),
     float32 and float64, with a checkpoint every 16 steps (the frame's
     rays end within ~60): outputs and the checkpoint rows a lane reaches
     must be equal, lanes must reach rows after row 0, and slot 0 must
     hold sphere and disc events, each kind also past row 0;
 28. the reverse sweep K2 with the sphere payload against its plain
     version on that march's checkpoints, with seeded cotangents, float64
     and float32 (phase 6's bars and readings), its error printed apart
     for the lanes whose slot 0 is a sphere and those whose slot 0 is a
     disc;
 29. the Kerr disc and sphere gradient path (the probe of
     tests/test_adjoint.py's sphere_loss_fn at 256²): image_loss must be 0
     at the target parameters; at a = 0.30, ∂a, ∂radius and ∂dth of the
     image loss over the pixels that are smooth in the parameters (the
     same class, stop code and step count, and no jump of a texel within
     the step), float64 and float32, must agree with a central difference
     of the float64 render (float64 to 5e-4 of it, float32 to 1e-3 of the
     mean |per-pixel term|); then 10 steps of
     inverse.fit of the spin in float32: target at a = 0.499, start 0.30,
     image_loss, Adam 5e-2; the radius and a tilt of the camera rays stay
     frozen and their gradients are printed; every gradient must be finite
     and nonzero, the loss must fall, K1 and K2 must launch;
 30. `resume`: K1 on phase 3's kerr.toml chunk and K3 on phase 8's kerr-bl
     chunk, float32, through fast_path._run_kernel, in two legs (the first
     of half the slowest lane's steps, finalize off, leaving lanes
     RUNNING) against one shot: all seven results equal; each leg against
     its plain version (K3's over legs of 2,000 iterations);
 31. (no longer run: K5 and K7 built with FMA contraction and timed
     against the -fmad=false build; its numbers stay in PERF.md);
 33. the lax (RKF45) main path at full width, float32, sky radius 40 and
     budget 4,000 (LAX_MAX_RADIUS, LAX_MAX_STEPS): render_section(...,
     lax=True) of kerr.toml, schwarzschild.toml and kerr-bl.toml at 1000²
     with AA (seconds, rays/s, accepted steps, loop iterations,
     compactions, requeue phases, peak memory), each against the kernel
     frame of the same settings (lax_against_kernel: pass 1's stop
     agreement, a lax BUDGET ray agreeing only with a kernel HORIZON; the
     rays where they disagree re-traced in float64 on the lax path, and
     those it settles for the lax frame counted with the agreeing ones,
     ≥ 99 %; the tone q99 printed); and 65,536 kerr.toml rays through the
     compacted, graph-replayed loop against one eager run of its body over
     their first 1,000 iterations, bit for bit;
 34. 512 of kerr.toml's rays (the 128 with the most accepted steps in
     phase 33's pass 1 among them) in float64 through the lax path on the
     card and, in a spawned process started in phase 33, on the CPU: stop
     codes and event counts equal on ≥ 99.9 %, payloads and colors within
     1e-9 of each lane's scale (the states printed);
 35. the split path: kerr-volumetric-streaky's gas disc beside
     kerr-sphere.toml's sphere at 256² with AA through K1's geometric pass
     and K5 (its launches, ms, samples, batch use; the frame's K1 and K5
     launches count in the kernels line); 4,096 of its first K5 launch's
     lanes against raymarch_plain bit for bit at 2,000 samples; pass 1
     against the lax path by phase 33's stop bar;
 36. reverse mode through the lax path (IntegrationConfig(differentiable=
     True), checkpointed blocks of LAX_GRAD_BLOCK iterations):
     grad_scale_probe.py's grad_step on the flagship at 128² in float32,
     its budget cut to LAX_GRAD_BUDGET: forward and backward seconds,
     iterations, blocks, lanes a block, peak memory, the loss and the seven
     gradients of tests/test_grad.py, beside the kernel VJP's (K1, K2) on
     the same loss; finite, ∂a and ∂radius nonzero;
 37. a 16² sub-grid of that frame in float64 on the card against a spawned
     CPU process (started in phase 36): the loss within 1e-9, the seven
     gradients within 1e-6 relative, the card's ∂a within 5e-4 of a
     central difference of its own float64 forward;
 38. the probe's inverse_fit on the lax path: a from 0.30 toward 0.45 at
     128² (steps and budget cut: LAX_FIT_STEPS, LAX_FIT_BUDGET), s a step
     and the device's busy share of one more step; the loss falls and a
     moves toward 0.45;
 39. scenes outside fast_path.supports_diff: schwarzschild.toml at 128²
     (the gradient in the Schwarzschild radius and the sphere's radius,
     finite and nonzero), and the differentiable raymarch on test_grad.py's
     16 chords in float64 on the card against the CPU within 1e-9;
 32. one JSON line {"kernels": [...]} with each kernel's launches, error
     against its plain version, times and bound (phases 36-39 add no
     kernel);
 40. the last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
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
# The gradient path: grad_scale_probe.py --fit3.
FIT_SIZE = 256
FIT_BUDGET = 2000
FIT_STEPS = 10
K_CKPT = 128
A_MAX = 0.49  # a = A_MAX·tanh(u) keeps the spin sub-extremal
FIT_TRUE = (0.45, 0.0, 1.52)  # a, v (T = 1e4·exp(v)), theta
FIT_START1 = (0.30, -0.2231435513142097, 1.42)  # v = log(0.8)
# Bars for K2 against its plain version: per-lane relative error of d_y0 on
# grad_ok lanes, and relative error of the summed parameter partials.
K2_BARS = {"float64": (1e-9, 0.999, 1e-9), "float32": (1e-3, 0.99, 1e-3)}
# The Boyer-Lindquist paths: docs/examples.md's KerrBL and Schwarzschild
# commands (the tetrad's z is radial, so the camera turns by π).
KERR_BL_TOML = os.path.join(HERE, "scene-definitions", "kerr-bl.toml")
BL_CAMERA = ["--camera-position=-10,0,-0.5", "--theta=-3.14159"]
BL_CAMERA_KW = dict(camera_position=(-10.0, 0.0, -0.5), theta=-3.14159)
SCHWARZSCHILD_SIZE = 512
# The disc-only Schwarzschild scene of tests/test_golden_frames.py.
SCHWARZSCHILD_DISC_TOML = """
celestial_temperature = 0.0
[celestial_texture.Checker]
beaming_exponent = 0.0
width = 18.0
height = 9.0
color1 = [30, 30, 90]
color2 = [4, 4, 12]
[geometry_type.Schwarzschild]
radius = 1.0
horizon_epsilon = 1e-4
[[objects]]
[objects.Disc]
inner_radius = 3.0
outer_radius = 6.0
temperature = 4000.0
[objects.Disc.texture.BlackBody]
beaming_exponent = 3.0
"""
# The BL gradient path: the spin fit of grad_scale_probe.py --bl.
BL_FIT_SIZE = 128
BL_FIT_BUDGET = 10_000  # nominal; the Mino march takes twice as many
BL_FIT_RADIUS = 1000.0
BL_FIT_STEPS = 12
BL_FIT_TRUE, BL_FIT_START = 0.45, 0.30
BL_FIT_CAMERA = dict(camera_position=(-10.0, 0.0, -0.5), theta=1.52, psi=-1.57)
# Iterations of the K3-against-plain comparisons that do not run the whole
# budget (see phase 8).
BL_COMPARE_ATTEMPTS = 4000
# The volumetric paths: docs/examples.md's volumetric command (kerr-volumetric-
# streaky at 500²) and its BL variant at 256².
VOL_TOML = os.path.join(HERE, "scene-definitions", "kerr-volumetric-streaky.toml")
BL_VOL_TOML = os.path.join(HERE, "scene-definitions", "kerr-bl-volumetric-streaky.toml")
VOL_FRAME = 500
BL_VOL_FRAME = 256
VOL_CAMERA_KW = dict(camera_position=(-10.0, 0.0, -0.5), theta=1.52, psi=-1.57)
# The K5 comparison's march budget (samples): the plain loop costs a few
# milliseconds per sample, so this keeps each plain run near half a minute.
VOL_COMPARE_STEPS = 2000
# The K7 comparison's march budget (samples): the plain backward (the
# forward sample and its torch.autograd VJP, ~1,000 torch ops) costs several
# times K5's plain sample, so this keeps each plain run near twenty seconds.
VOL_BWD_COMPARE_STEPS = 400
# Phase 18b: K7's medium sums at the full budget against central differences
# of K6, in float64: the step is this fraction of each parameter.
VOL_FD_STEP = 1e-5
VOL_FD_BAR = 1e-5  # relative
# The lanes whose saturation step moves within a parameter's step are left
# out of its difference; at most this share of the marching lanes may be.
VOL_FD_EXIT_MOVED_CAP = 0.01
# The volumetric gradient path: scripts/grad_scale_probe.py --vol (hero #5's
# camera at 256², budget 20,000, the TOML's 50,000-sample raymarch; the fit
# of density_multiplier and absorption from 0.6× and 2× their true values,
# clip 1.0 ahead of Adam with the cosine schedule (5e-2, 60, 0.02), of which
# the first VOL_FIT_STEPS steps run), and its BL variant at 128².
VOL_FIT_SIZE = 256
VOL_FIT_STEPS = 20
VOL_FIT_SCHEDULE = (5e-2, 60, 0.02)
VOL_FIT_START = (0.6, 2.0)  # × the true density_multiplier and absorption
BL_VOL_GRAD_SIZE = 128
# The sphere paths: docs/examples.md's schwarzschild.toml command (1000²,
# the BL camera), kerr-sphere.toml at 1000² (the Kerr camera) and
# schwarzschild-sphere.toml at 512² (the BL camera); both flat scenes have
# r_s = 0.
SCHWARZSCHILD_TOML = os.path.join(HERE, "scene-definitions", "schwarzschild.toml")
KERR_SPHERE_TOML = os.path.join(HERE, "scene-definitions", "kerr-sphere.toml")
SCHWARZSCHILD_SPHERE_TOML = os.path.join(HERE, "scene-definitions", "schwarzschild-sphere.toml")
SPHERE_SMALL_FRAME = 512
# schwarzschild.toml's sphere (R = 2 at z = 20) is off the axis of view:
# the frame's middle chunk holds none of its events. A float64 preview on
# the CPU found its image in a thin band of central columns near the
# frame's top and bottom edges, most of it in the frame's last 65,536
# pixels, the chunk compared here.
SCHWARZSCHILD_CHUNK_FIRST = FRAME * FRAME - N_RAYS
# Its comparison runs the first 1,000 steps: the chunk's sphere events all
# come within them (a 4,000-step comparison records the same ones), and
# every plain iteration of the chunk costs the same whatever it records.
SCHWARZSCHILD_COMPARE_ATTEMPTS = 1000
# The disc and sphere scenes of tests/test_pallas.py (test_kerr_sphere_
# kernel_parity and test_bl_kernel_sphere_parity): a disc 3-5 and a sphere
# of radius 2 at the origin around a Kerr hole (r_s = 0.4, a = 0.15) or a
# Schwarzschild one (r_s = 0.5), checker textures; their cameras and their
# budget of 3,000 steps inside a sky sphere of radius 40.
SPHERE_TEST_SCENE = """
celestial_temperature = 0.0
[celestial_texture.Checker]
beaming_exponent = 0.0
width = 18.0
height = 9.0
color1 = [40, 40, 120]
color2 = [5, 5, 20]
[geometry_type.{geometry}]
radius = {radius}
{spin}horizon_epsilon = 1e-3
[[objects]]
[objects.Disc]
inner_radius = 3.0
outer_radius = 5.0
temperature = 2000.0
[objects.Disc.texture.Checker]
beaming_exponent = 0.0
width = 6.0
height = 6.0
color1 = [255, 120, 0]
color2 = [120, 40, 0]
[[objects]]
[objects.Sphere]
radius = 2.0
position = [0.0, 0.0, 0.0]
temperature = 2000.0
[objects.Sphere.texture.Checker]
beaming_exponent = 0.0
width = 6.0
height = 6.0
color1 = [255, 0, 0]
color2 = [90, 0, 0]
"""
SPHERE_TEST_SCENES = {
    "kerr-sphere-test-scene.toml": SPHERE_TEST_SCENE.format(geometry="Kerr", radius=0.4, spin="a = 0.15\n"),
    "schwarzschild-sphere-test-scene.toml": SPHERE_TEST_SCENE.format(geometry="Schwarzschild", radius=0.5,
                                                                      spin=""),
}
SPHERE_TEST_OPTIONS = dict(max_steps=3000, max_radius=40.0)
KERR_CAMERA_KW = dict(camera_position=(-10.0, 0.0, -0.5), theta=1.52, psi=-1.57)
# The Kerr disc and sphere gradient path: the probe of tests/test_adjoint.py
# (sphere_loss_fn) at the KS fit's size and budget: kerr-sphere.toml built
# as the file says (r_s = 0: the camera's tetrad is flat), then given a hole
# of r_s = 1, a = 0.499; the framing puts both kinds in slot 0.
SPHERE_FIT_SIZE = 256
SPHERE_FIT_BUDGET = 2000
SPHERE_FIT_RADIUS = 30.0
SPHERE_FIT_CAMERA = dict(camera_position=(-10.0, 0.0, -2.5), theta=1.35, psi=-1.57)
SPHERE_FIT_HOLE = (1.0, 0.499)  # radius, a: the target
SPHERE_FIT_START = 0.30
SPHERE_FIT_STEPS = 10
SPHERE_FIT_LR = 5e-2
SPHERE_K_CKPT = 16  # phases 27-28: most lanes of the frame take 20-59 steps
SPHERE_FD_STEP = 1e-6  # central difference of the float64 render
# ∂ of the masked image loss against that difference: float64 relative to
# the difference, at the JAX package's bar for bitmap textures
# (tests/test_adjoint.py); float32 relative to the mean |per-pixel term|,
# at K2's float32 bar.
SPHERE_FD_BARS = {"float64": 5e-4, "float32": 1e-3}
# Phase 30: the iterations of each leg of K3's comparison with its plain
# version (the plain march costs milliseconds an iteration).
BL_RESUME_COMPARE_ATTEMPTS = 2000
FP32_LANES_PER_SM = 128  # Hopper: FP32 units per SM
FP64_LANES_PER_SM = 64
INT32_LANES_PER_SM = 64  # Hopper: INT32 units per SM
# critical_path: a launch's longest lanes timed alone (one block of 128
# threads in K1, K3 and K7; 128 warps in K5 and K6).
TAIL_LANES = 128
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# Phases 33-35, the RKF45 ("lax") path, and the kernel frames they are held
# against, render with the sky at LAX_MAX_RADIUS (the radius of the study
# behind the kernel-against-lax bar, scripts/fastpath_accuracy.py:92) and a
# budget of LAX_MAX_STEPS (tests/test_golden_frames.py's). At the CLI's
# 15,000 the lax controller's H_MAX = 1 makes every escaping ray take
# ~15,000 accepted steps (scripts/lax_probe.py on an H100: 15,960 a ray on kerr.toml 256², 5.9 % of
# them stopped BUDGET where the kernel's far-field lever escapes), which
# would make a 1000² lax frame take many minutes. Phase 33 renders kerr.toml
# at FRAME² and schwarzschild.toml and kerr-bl.toml at LAX_FRAMES² (see
# there), and holds LAX_CHECK_SIDE² rays of kerr.toml compacted against one
# eager run for their first LAX_CHECK_ATTEMPTS iterations (the eager run
# dispatches every op).
LAX_MAX_RADIUS = 40.0
LAX_MAX_STEPS = 4000
LAX_CHECK_SIDE = 256
LAX_CHECK_ATTEMPTS = 1000
# Phase 34: LAX_F64_RAYS rays of kerr.toml in float64 on the card and the
# CPU, the LAX_F64_LONGEST with the most accepted steps of phase 33's pass 1
# among them, the others drawn with LAX_F64_SEED.
LAX_F64_RAYS = 512
LAX_F64_LONGEST = 128
LAX_F64_SEED = 0
# Phases 33 and 35: the rays where a kernel frame and its lax frame
# disagree are re-traced in float64 on the lax path, at most LAX_REF_RAYS
# of them a frame (a sample drawn with LAX_REF_SEED beyond).
LAX_REF_RAYS = 16_384
LAX_REF_SEED = 0
# Phase 35: the gas disc beside a sphere at SPLIT_SIZE², and SPLIT_BATCH of
# its K5 lanes against the plain raymarch.
SPLIT_SIZE = 256
SPLIT_BATCH = 4096
# Phase 33's other frames: (name, TOML, size, camera, why this size).
LAX_FRAMES = (
    ("schwarzschild.toml", SCHWARZSCHILD_TOML, FRAME, BL_CAMERA_KW, "the CLI frame"),
    ("kerr-bl.toml", KERR_BL_TOML, FRAME, BL_CAMERA_KW, "the CLI frame"),
)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


_T0 = time.perf_counter()


def phase(name):
    print(f"\n== {name} (t = {time.perf_counter() - _T0:.1f} s)", flush=True)


def nvidia_smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def resident_warps(registers, smem=0, threads=128):
    """Warps an SM holds at `registers` a thread and `smem` bytes of static
    shared memory a block, for blocks of `threads` (Hopper: 65,536
    registers an SM, allocated 256 a warp at a time; 233,472 bytes of shared
    memory, 1 KB of it reserved a block; at most 64 warps)."""
    per_warp = -(-registers * 32 // 256) * 256
    warps_per_block = threads // 32
    blocks = (65_536 // per_warp) // warps_per_block
    if smem:
        blocks = min(blocks, 233_472 // (smem + 1024))
    return min(blocks * warps_per_block, 64)


# The bool template flags of a kernel, in order, as ptxas_summary names
# them (the set ones).
KERNEL_FLAGS = {"raymarch_kernel": ("raw",), "bl_march_kernel": ("comp",)}


def ptxas_summary(log):
    """[{kernel, registers, spill_stores, smem, resident_warps}] of each
    entry function in nvcc's -Xptxas -v report (the kernel's name and
    type; smem: its static shared memory in bytes)."""
    import re

    rows, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"\d+([a-z_]+_kernel)I([fd])((?:Lb[01]E)*)", m.group(1))
            flags = zip(KERNEL_FLAGS.get(k.group(1), ()), re.findall(r"Lb([01])", k.group(3))) if k else ()
            name = (f"{k.group(1)} {'f32' if k.group(2) == 'f' else 'f64'}"
                    + "".join(f" {flag}" for flag, on in flags if on == "1") if k else m.group(1)[:48])
            spill = 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            regs = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            smem = int(m.group(1)) if m else 0
            rows.append({"kernel": name, "registers": regs, "spill_stores": spill, "smem": smem,
                         "resident_warps": resident_warps(regs, smem)})
            name = None
    return rows


def count_ops(fn):
    """Elementwise operations that `fn` runs on one lane, by class, counted
    by a dispatch mode over what torch executes: "float" (add, sub, mul,
    div, reciprocal, neg, sqrt, rsqrt, pow, min/max, clamp, abs, and sin,
    cos, atan2 as one operation each, on floating tensors), "exp_log" (exp,
    log), "floor" (floor, ceil) and "int" (add, sub, mul, remainder, xor,
    and, or, shifts on integer tensors). Compares, selects, casts and copies
    are not counted. A `& 0xFFFFFFFF` is not counted either: the plain
    noise carries its uint32 hash in int64 and masks it to 32 bits after
    each multiply and add, which native uint32 arithmetic does not need."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    arith = {
        "add", "sub", "mul", "div", "reciprocal", "neg", "sqrt", "rsqrt", "pow", "minimum",
        "maximum", "clamp", "clamp_min", "abs", "rsub", "sin", "cos", "atan2",
    }
    integer = {"add", "sub", "mul", "remainder", "bitwise_xor", "bitwise_and", "bitwise_or",
               "__rshift", "__lshift", "bitwise_right_shift", "bitwise_left_shift"}
    counts = {"float": 0, "exp_log": 0, "floor": 0, "int": 0}

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if isinstance(out, torch.Tensor):
                if not out.is_floating_point():
                    u32_mask = name == "bitwise_and" and any(type(v) is int and v == 0xFFFFFFFF for v in args[1:])
                    if name in integer and out.dtype != torch.bool and not u32_mask:
                        counts["int"] += out.numel()
                elif name in arith:
                    counts["float"] += out.numel()
                elif name in ("exp", "log"):
                    counts["exp_log"] += out.numel()
                elif name in ("floor", "ceil"):
                    counts["floor"] += out.numel()
            return out

    with Counter():
        fn()
    return counts


def _one_lane():
    import torch

    return torch.tensor([[0.0, 8.0, 3.0, 0.5, -1.0, 0.9, 0.2, -0.1]], dtype=torch.float64).T


def count_step_flops(spheres=()):
    """Arithmetic operations of one RK4 step of the march, per ray, counted
    on the plain step (count_ops's "float" class) with the sphere candidate
    tests of `spheres`; event stores are rare and not counted."""
    import torch

    from gr_raytracer_tpu_torch.ops import geodesic_march as gm

    y = _one_lane()
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
    return count_ops(lambda: gm._plain_step(c, lanes, (), spheres))["float"]


def _ks_sweep_inputs():
    """One lane's inputs of the Kerr-Schild sweep's step map: y, radius, a
    (leaves that require grad) and the active mask."""
    import torch

    f64 = torch.float64
    y = _one_lane().requires_grad_(True)
    r = torch.tensor([1.0], dtype=f64, requires_grad=True)
    a = torch.tensor([0.45], dtype=f64, requires_grad=True)
    return y, r, a, torch.ones(1, dtype=torch.bool)


def count_vjp_flops(payload=None, spheres=()):
    """Arithmetic operations of one reverse step of the sweep, per ray, on
    one lane: the plain step map (ops/geodesic_adjoint.py _masked_step) and
    its VJP by torch.autograd. With `payload` "disc" or "sphere" (the first
    of `spheres`), the step map with that slot-0 payload
    (_step_with_payload) and its VJP: the sweep takes it once per hit lane,
    at the lane's stored step, so the payload's own cost is the difference
    from the plain count."""
    import torch

    from gr_raytracer_tpu_torch.ops import geodesic_adjoint as gadj
    from gr_raytracer_tpu_torch.ops import geodesic_march as gm

    y, r, a, active = _ks_sweep_inputs()

    def vjp():
        if payload is None:
            y_new = gadj._masked_step(r, a, 1.0, 0.01, 10.0, 30.0, y, active)
            torch.autograd.grad(y_new, (r, a, y), torch.ones_like(y_new))
            return
        discs = (gm.DiscSpec(1.0, 6.0, 0),) if payload == "disc" else ()
        sph = tuple(spheres[:1]) if payload == "sphere" else ()
        kind0 = torch.full((1,), sph[0].kind if sph else 0, dtype=torch.int32)
        y_new, out = gadj._step_with_payload(discs, sph, 1.0, 0.01, 10.0, 30.0, kind0, r, a, y, active)
        torch.autograd.grad((y_new, out), (r, a, y), (torch.ones_like(y_new), torch.ones_like(out)))

    return count_ops(vjp)["float"]


def count_sweep_flops(spheres=()):
    """The operation counts of the Kerr-Schild sweep's bound, per ray:
    "forward" (one re-forward step: the plain step map alone), "reverse"
    (one reverse step: the step map and its VJP), and per slot-0 kind the
    payload's extra cost at the stored step ("payload")."""
    import torch

    from gr_raytracer_tpu_torch.ops import geodesic_adjoint as gadj

    y, r, a, active = _ks_sweep_inputs()
    with torch.no_grad():
        forward = count_ops(lambda: gadj._masked_step(r, a, 1.0, 0.01, 10.0, 30.0, y, active))["float"]
    reverse = count_vjp_flops()
    payload = {"disc": count_vjp_flops("disc") - reverse}
    if spheres:
        payload["sphere"] = count_vjp_flops("sphere", spheres) - reverse
    return {"forward": forward, "reverse": reverse, "payload": payload}


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


def critical_path(launch, lanes_of, counts, reps=3):
    """How a launch's longest lanes hold it. `counts` are its lanes' samples
    or steps; `lanes_of(idx)` gathers the inputs of the lanes `idx` (kept in
    their given order) and `launch(inputs)` runs the kernel on them. Returns
    the longest lane, the p99 and p50, the share of lanes that run at all,
    and the kernel's ms on every lane, on the TAIL_LANES longest alone and
    on all but the longest 1 %."""
    import torch

    n = counts.long()
    order = torch.argsort(n, descending=True, stable=True)
    subsets = {"all": None, "longest": torch.sort(order[:TAIL_LANES]).values,
               "less_top_1pct": torch.sort(order[max(1, n.numel() // 100):]).values}
    ms = {}
    for key, idx in subsets.items():
        inputs = lanes_of(idx)
        launch(inputs)
        torch.cuda.synchronize()
        ms[key] = time_cuda(lambda: launch(inputs), reps)[0]
    q = torch.quantile(n.double(), torch.tensor([0.99, 0.5], dtype=torch.float64, device=n.device))
    return {"longest_lane": int(n.max()), "p99": float(q[0]), "p50": float(q[1]),
            "share_running": float((n > 0).double().mean()), "ms": ms["all"],
            f"ms_longest_{TAIL_LANES}": ms["longest"], "ms_less_top_1pct": ms["less_top_1pct"],
            f"longest_{TAIL_LANES}_share": ms["longest"] / ms["all"]}


def gather_lanes(lanes, idx):
    """The lanes `idx` of a tuple of per-lane tensors, contiguous (all of
    them for None)."""
    return lanes if idx is None else tuple(v[idx].contiguous() for v in lanes)


def chunk_inputs(dtype, toml=KERR_TOML, size=FRAME, camera=None, first=None, options=None):
    """(scene, spec, y0, freq, solver, inverse) for the middle N_RAYS pixels
    of the size×size frame of `toml` (default: kerr.toml at 1000², the
    README camera), or the N_RAYS that start at pixel `first`, cost-sorted
    as the main path sorts a chunk. `options` override the RenderOptions (budget
    MAX_STEPS, the CLI's sky radius)."""
    import numpy as np
    import torch

    from gr_raytracer_tpu_torch import config
    from gr_raytracer_tpu_torch.rendering import camera as cam
    from gr_raytracer_tpu_torch.rendering import fast_path

    camera = camera or dict(camera_position=(-10.0, 0.0, -0.5), theta=1.52, psi=-1.57)
    opts = config.RenderOptions(width=size, height=size, **{"max_steps": MAX_STEPS, **(options or {})}, **camera)
    scene = config.create_scene(config.load_config(toml), opts, dtype, torch.device("cuda"))
    n = min(N_RAYS, size * size)
    first = size * size // 2 - n // 2 if first is None else first
    flat = np.arange(first, first + n)
    rows = torch.as_tensor(flat // size, dtype=dtype, device="cuda")
    cols = torch.as_tensor(flat % size, dtype=dtype, device="cuda")
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


def compare_march(dtype, compensated, flops_per_step, bl=False, attempts=None, toml=None, size=FRAME,
                  camera=None, first=None, options=None, keep=None):
    """K1 (K3 with `bl`) against its plain version on the same inputs, the
    middle N_RAYS pixels of `toml` (kerr.toml, kerr-bl.toml; `first`
    and `options` as chunk_inputs takes them) at its budget. The kernel is
    timed over the whole budget; `attempts` bounds the iterations of the
    comparison (unfinished lanes stay RUNNING). Returns a result dict; a
    `keep` dict receives the per-lane inputs ("inputs") and the plain
    version's results ("ref")."""
    import torch

    from gr_raytracer_tpu_torch.ops import geodesic_march as gm
    from gr_raytracer_tpu_torch.rendering.integrator import IntegrationResult

    toml = toml or (KERR_BL_TOML if bl else KERR_TOML)
    scene, spec, y0, freq, solver, inverse = chunk_inputs(
        dtype, toml, size, camera or (BL_CAMERA_KW if bl else None), first, options)
    budget = scene.integration.max_steps
    if bl:
        consts = (solver.e.contiguous(), solver.l_z.contiguous(), solver.q.contiguous())
        args = (spec.radius, spec.a, spec.horizon_epsilon, y0, *consts)
        kw = dict(h0=0.01, max_steps=2 * budget, max_radius=scene.integration.max_radius,
                  discs=spec.discs, spheres=spec.spheres, vols=spec.vols, opaque_stop=spec.opaque,
                  compensated=compensated)
        kernel, plain = gm.kerr_bl_rk4_march, gm.march_bl_plain
    else:
        consts = ()
        args = (spec.radius, spec.a, spec.horizon_epsilon, y0)
        kw = dict(h0=1.0, max_steps=budget, max_radius=scene.integration.max_radius,
                  discs=spec.discs, spheres=spec.spheres, vols=spec.vols, r_safe=spec.r_safe,
                  opaque_stop=spec.opaque, compensated=compensated)
        kernel, plain = gm.kerr_rk4_march, gm.march_plain
    full = kernel(*args, **kw)  # first launch: checks the kernel runs
    torch.cuda.synchronize()
    kernel_ms, full = time_cuda(lambda: kernel(*args, **kw), reps=3)
    # Per-lane inputs follow the three scalars.
    tail = critical_path(lambda ins: kernel(*args[:3], *ins, **kw), lambda idx: gather_lanes(args[3:], idx),
                         full[2])
    if attempts is not None:
        kw.update(attempts=attempts, finalize=False)
    got = full if attempts is None else kernel(*args, **kw)
    t0 = time.perf_counter()
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if keep is not None:
        keep.update(inputs=args[3:], ref=ref)

    y_g, stop_g, steps_g, kind_g, data_g, count_g, ovf_g = got
    y_r, stop_r, steps_r, kind_r, data_r, count_r, ovf_r = ref
    same = (stop_g == stop_r) & (count_g == count_r)
    agree = float(same.double().mean())
    eq = lambda g, r: bool(((g == r) | (g.isnan() & r.isnan()) if g.is_floating_point() else (g == r)).all())
    res = {
        "kernel": "K3" if bl else "K1", "scene": os.path.basename(toml), "vols": len(spec.vols),
        "dtype": str(dtype).replace("torch.", ""), "compensated": compensated,
        "budget": kw["max_steps"], "attempts": kw.get("attempts", kw["max_steps"]),
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "stop_agreement": agree,
        "bit_identical": all(eq(g, r) for g, r in zip(got, ref)),
        "stops": torch.bincount(stop_g, minlength=8).tolist(),
        "events": int(count_g.long().sum()), "overflowed": int(ovf_g.sum()),
        "events_by_kind": torch.bincount(kind_g[kind_g >= 0].long()).tolist(),
        "sphere_events": sum(int((kind_g == s.kind).sum()) for s in spec.spheres),
        "max_steps_taken": int(full[2].max()), "sum_steps": int(full[2].long().sum()), "critical_path": tail,
        "steps_equal_on_agreeing": float((steps_g == steps_r)[same].double().mean()),
    }
    n = y0.shape[0]
    elem = y0.element_size()
    bytes_moved = n * ((8 + len(consts)) * elem + 8 * elem + 3 * 4 + 8 * 4 + 8 * 12 * elem + 1)
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
        # Shade both through the same code and compare tone-mapped colors
        # (volumetric slots unshaded: K5 is held against its plain version
        # on its own).
        def colors(state):
            return geometric_colors(scene, spec, IntegrationResult(*state), freq, solver, inverse)

        tone = lambda c: c / (1.0 + c)
        c_g, c_r = tone(colors(got)), tone(colors(ref))
        same_px = same[inverse]
        err = (c_g - c_r).abs().amax(dim=1)[same_px]
        res["max_abs_err"] = float(err.max())
        res["tone_err_q999"] = float(torch.quantile(err.double(), 0.999))
        ok = agree >= F32_STOP_AGREEMENT and res["max_abs_err"] <= F32_TONE_ATOL
    res["ok"] = bool(ok)
    return res


def geometric_colors(scene, spec, res, freq, solver, inverse):
    """The frame's colors from a march result through the geometric pass's
    shading and fold, in pixel order; volumetric slots stay unshaded."""
    import torch

    from gr_raytracer_tpu_torch.rendering import fast_path
    from gr_raytracer_tpu_torch.rendering import integrator as integ
    from gr_raytracer_tpu_torch.rendering import scene as scn

    if not spec.vols:
        return fast_path._finish_samples(scene, res, freq, solver, inverse, spec.opaque).color
    colors, fail = scn._shade_events(scene, freq, res, include_volumetric=False)
    stop = torch.where(fail, integ.STEP_FAILED, res.stop_code)
    celestial = scn._celestial_color(scene, freq, solver, res)
    return scn.fold_samples(scene, res.ev_kind, colors, stop, celestial)[0][inverse]


def fit_frame_inputs(dtype):
    """(spec, y0) of the 65,536 rays of the 256² flagship fit frame at its
    true parameters, cost-sorted as the differentiable path sorts them."""
    import torch

    from gr_raytracer_tpu_torch import presets
    from gr_raytracer_tpu_torch.rendering import camera as cam
    from gr_raytracer_tpu_torch.rendering import fast_path

    scene = presets.build_kerr_flagship(
        presets.kerr_flagship_params(dtype, "cuda"), FIT_SIZE, FIT_SIZE, max_steps=FIT_BUDGET,
        max_radius=40.0, step_size=0.05,
    )
    rr, cc = torch.meshgrid(
        torch.arange(FIT_SIZE, dtype=dtype, device="cuda"),
        torch.arange(FIT_SIZE, dtype=dtype, device="cuda"), indexing="ij",
    )
    x, p = cam.pixel_rays(scene.camera, rr.ravel(), cc.ravel())
    _, y0, _, _ = fast_path._prepare_march(scene, x, p)
    return fast_path.scene_kernel_spec(scene), y0.contiguous()


def sphere_fit_scene(dtype):
    """(scene, spec, x, p): the 256² Kerr disc and sphere frame of the
    sphere gradient path (SPHERE_FIT_*) with its hole, and its camera
    rays."""
    import dataclasses

    import torch

    from gr_raytracer_tpu_torch import config
    from gr_raytracer_tpu_torch.geometry.kerr import Kerr
    from gr_raytracer_tpu_torch.rendering import camera as cam
    from gr_raytracer_tpu_torch.rendering import fast_path

    opts = config.RenderOptions(width=SPHERE_FIT_SIZE, height=SPHERE_FIT_SIZE, max_steps=SPHERE_FIT_BUDGET,
                                max_radius=SPHERE_FIT_RADIUS, **SPHERE_FIT_CAMERA)
    scene = config.create_scene(config.load_config(KERR_SPHERE_TOML), opts, dtype, torch.device("cuda"))
    radius, a = (torch.tensor(v, dtype=dtype, device="cuda") for v in SPHERE_FIT_HOLE)
    scene = dataclasses.replace(scene, geometry=Kerr(radius=radius, a=a,
                                                     horizon_epsilon=scene.geometry.horizon_epsilon))
    rr, cc = torch.meshgrid(
        torch.arange(SPHERE_FIT_SIZE, dtype=dtype, device="cuda"),
        torch.arange(SPHERE_FIT_SIZE, dtype=dtype, device="cuda"), indexing="ij",
    )
    x, p = cam.pixel_rays(scene.camera, rr.ravel(), cc.ravel())
    return scene, fast_path.scene_kernel_spec(scene), x, p


def ckpt_march_setup(dtype, bl=False, sphere=False, k_ckpt=K_CKPT):
    """The checkpointed march of the 256² flagship fit frame at its true
    parameters (the BL fit frame with `bl`, the Kerr disc and sphere frame
    with `sphere`): (kernel, plain, args, kw, spec, consts), where
    kernel(*args, **kw) runs K1 (K3) with a checkpoint every `k_ckpt`
    steps, plain(*args, **kw) its plain version, and consts are the
    lanes' (E, L_z, Q) on the BL frame, else ()."""
    import torch

    from gr_raytracer_tpu_torch.ops import geodesic_march as gm
    from gr_raytracer_tpu_torch.rendering import fast_path

    if sphere:
        scene, spec, x, p = sphere_fit_scene(dtype)
        _, y0, _, _ = fast_path._prepare_march(scene, x, p)
        consts = ()
        kw = dict(h0=1.0, max_steps=SPHERE_FIT_BUDGET, max_radius=SPHERE_FIT_RADIUS, r_safe=spec.r_safe,
                  spheres=spec.spheres)
        kernel, plain = gm.kerr_rk4_march, gm.march_plain
    elif bl:
        scene, spec, x, p = bl_fit_scene(dtype)
        solver, y0, _, _ = fast_path._prepare_march(scene, x, p)
        consts = (solver.e.contiguous(), solver.l_z.contiguous(), solver.q.contiguous())
        kw = dict(h0=0.01, max_steps=2 * BL_FIT_BUDGET, max_radius=BL_FIT_RADIUS)
        kernel, plain = gm.kerr_bl_rk4_march, gm.march_bl_plain
    else:
        spec, y0 = fit_frame_inputs(dtype)
        consts = ()
        kw = dict(h0=1.0, max_steps=FIT_BUDGET, max_radius=40.0, r_safe=spec.r_safe)
        kernel, plain = gm.kerr_rk4_march, gm.march_plain
    args = (spec.radius, spec.a, spec.horizon_epsilon, y0.contiguous(), *consts)
    kw.update(discs=spec.discs, opaque_stop=True, ckpt_every=k_ckpt)
    return kernel, plain, args, kw, spec, consts


def compare_march_ckpt(dtype, bl=False, attempts=None, sphere=False, k_ckpt=K_CKPT):
    """K1 (K3 with `bl`) with checkpoints against its plain version on the
    256² flagship fit frame (the BL fit frame; with `sphere`, the Kerr disc
    and sphere frame) at its true parameters, both bounded by `attempts`
    if given, with a checkpoint every `k_ckpt` steps. Outputs and the
    checkpoint rows a lane reaches must be equal. Returns (result dict, the whole march's outputs with checkpoints (the
    kernel's when `attempts` bounds the comparison), spec, the lanes' (E,
    L_z, Q) or ())."""
    import torch

    kernel, plain, args, kw, spec, consts = ckpt_march_setup(dtype, bl, sphere, k_ckpt)
    full = kernel(*args, **kw)
    torch.cuda.synchronize()
    kernel_ms, full = time_cuda(lambda: kernel(*args, **kw), reps=3)
    if attempts is not None:
        kw.update(attempts=attempts, finalize=False)
    got = full if attempts is None else kernel(*args, **kw)
    t0 = time.perf_counter()
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    steps = ref[2].long()
    reached = torch.arange(ref[7].shape[0], device="cuda")[:, None] * k_ckpt < steps[None]
    same = lambda g, r: (g == r) | (g.isnan() & r.isnan()) if g.is_floating_point() else g == r
    rows_equal = bool(torch.where(reached[:, None, :], same(got[7], ref[7]), True).all())
    outputs_equal = all(bool(same(g, r).all()) for g, r in zip(got[:7], ref[:7]))
    res = {
        "kernel": "K3" if bl else "K1", "dtype": str(dtype).replace("torch.", ""),
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "budget": kw["max_steps"],
        "attempts": kw.get("attempts", kw["max_steps"]), "k_ckpt": k_ckpt, "lanes": int(steps.numel()),
        "outputs_equal": outputs_equal, "ckpt_rows_equal": rows_equal,
        "ckpt_rows_reached": int(reached.sum()), "max_steps_taken": int(steps.max()),
        "sum_steps": int(steps.sum()), "stops": torch.bincount(ref[1], minlength=8).tolist(),
    }
    if spec.spheres:
        kind0 = torch.where(ref[5] > 0, ref[3][:, 0], -1)
        res["slot0_sphere"] = sum(int((kind0 == sp.kind).sum()) for sp in spec.spheres)
        res["slot0_disc"] = sum(int((kind0 == d.kind).sum()) for d in spec.discs)
        # Hit lanes whose stored step lies after their first checkpoint
        # segment: the sweep replays their payload from a later row.
        late = ref[2] > k_ckpt
        res["slot0_sphere_after_row0"] = sum(int(((kind0 == sp.kind) & late).sum()) for sp in spec.spheres)
        res["slot0_disc_after_row0"] = sum(int(((kind0 == d.kind) & late).sum()) for d in spec.discs)
    res["ok"] = outputs_equal and rows_equal
    return res, (ref if attempts is None else full), spec, consts


def sweep_inputs(dtype, march, spec, consts=(), k_ckpt=K_CKPT):
    """The reverse sweep's inputs on the checkpoints of `march` (the fit
    frame's), with seeded cotangents on the final state of escaped lanes
    and on event slot 0 of hit lanes: (sweep, plain, args), where
    sweep(*args) launches K2 (K4 when `consts` holds the lanes' (E, L_z,
    Q)) and plain(*args) runs its plain version; args are (ckpt, ct_y,
    ct_ev, steps, grad_ok, has_ev, ev_kind0, radius, a, *consts, cfg)."""
    import torch

    from gr_raytracer_tpu_torch.ops import geodesic_adjoint as gadj

    y_f, stop, steps, ev_kind, ev_data, ev_count, ev_ovf, ckpt = march
    grad_ok, has_ev, kind0 = gadj.sweep_lanes(stop, ev_kind, ev_count)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n = y_f.shape[0]
    ct_y = torch.randn((n, 8), generator=gen, dtype=dtype, device="cuda") * (stop == 2)[:, None]
    ct_ev = torch.randn((n, 12), generator=gen, dtype=dtype, device="cuda") * (has_ev != 0)[:, None]
    if consts:
        cfg = gadj.SweepConfig(0.01, 2 * BL_FIT_BUDGET, spec.discs, 0.0, 0.02, 10.0, k_ckpt)
        sweep, plain = gadj.bl_march_bwd, gadj.bl_march_bwd_plain
    else:
        cfg = gadj.SweepConfig(1.0, FIT_BUDGET, spec.discs, spec.r_safe, 0.01, 10.0, k_ckpt, spec.spheres)
        sweep, plain = gadj.ks_march_bwd, gadj.ks_march_bwd_plain
    args = (ckpt, ct_y.contiguous(), ct_ev.contiguous(), steps, grad_ok, has_ev, kind0,
            spec.radius, spec.a, *consts, cfg)
    return sweep, plain, args


def sweep_critical_path(sweep, args):
    """critical_path of a sweep launch: its lanes' reverse steps (steps on
    grad_ok lanes), and the kernel on its TAIL_LANES longest alone."""
    ckpt, per_lane, consts = args[0], args[1:7], args[9:-1]

    def lanes_of(idx):
        if idx is None:
            return (ckpt, *per_lane, *consts)
        return (ckpt[:, :, idx].contiguous(), *gather_lanes(per_lane + consts, idx))

    def launch(ins):
        return sweep(*ins[:7], *args[7:9], *ins[7:], args[-1])

    steps, grad_ok = args[3], args[4]
    return critical_path(launch, lanes_of, steps * (grad_ok != 0))


def sweep_issue_share(args, ms, instructions):
    """issue_share of a sweep launch of `ms`: the common-path
    instructions of its steps (sass_sweep_step's re-forward step plus
    reverse step, each taken once per step of a grad_ok lane); a hit
    lane's payload step is counted as a plain one."""
    return issue_share(float((args[3].long() * (args[4] != 0)).sum()), ms, instructions)


def compare_adjoint(dtype, march, spec, flops, consts=(), k_ckpt=K_CKPT, sass=None):
    """K2 (K4 when `consts` holds the lanes' (E, L_z, Q)) against its plain
    version on the checkpoints of `march` (the fit frame's), with seeded
    cotangents on the final state of escaped lanes and on event slot 0 of
    hit lanes; every grad_ok lane is held. With spheres in `spec`, the
    errors of the lanes whose slot 0 is a sphere and of those whose slot 0
    is a disc are reported apart. `flops` holds count_sweep_flops's counts
    (count_bl_sweep_flops's with `consts`); `k_ckpt` is the march's
    checkpoint interval. The kernel's critical path is read too, and with
    `sass` (sass_sweep_step's counts) its issue share."""
    import torch

    y_f, stop, steps, ev_kind, ev_data, ev_count, ev_ovf, ckpt = march
    sweep, plain, args = sweep_inputs(dtype, march, spec, consts, k_ckpt)
    n, grad_ok, has_ev, kind0 = y_f.shape[0], args[4], args[5], args[6]
    got = sweep(*args)  # first launch: checks the kernel runs
    torch.cuda.synchronize()
    kernel_ms, got = time_cuda(lambda: sweep(*args), reps=3)
    tail = sweep_critical_path(sweep, args)
    t0 = time.perf_counter()
    ref = plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    # Per grad_ok lane: the error of d_y0 over its largest entry and, on
    # the BL sweep, that of (dE, dL_z, dQ) over theirs.
    ok_lanes = grad_ok != 0

    def lane_err(g, r):
        g, r = g[ok_lanes], r[ok_lanes]
        return (g - r).abs().amax(dim=1) / r.abs().amax(dim=1).clamp(min=1e-300)

    lane = lane_err(got[0], ref[0])
    if consts:
        lane = torch.maximum(lane, lane_err(torch.stack(got[1:4], 1), torch.stack(ref[1:4], 1)))
    rel = lambda g, r: abs(float(g.double().sum()) - float(r.double().sum())) / max(abs(float(r.double().sum())), 1e-300)
    name = str(dtype).replace("torch.", "")
    lane_tol, share, sum_tol = K2_BARS[name]
    res = {
        "kernel": "K4" if consts else "K2", "dtype": name, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "grad_ok_lanes": int(ok_lanes.sum()), "max_steps_grad_ok": int(steps[ok_lanes].max()),
        "lanes_within_tol": float((lane <= lane_tol).double().mean()),
        "lane_rel_err_max": float(lane.max()),
        "lane_rel_err_q999": float(torch.quantile(lane.double(), 0.999)),
        "max_abs_err": max(float((g - r)[ok_lanes].abs().max()) for g, r in zip(got[:-2], ref[:-2])),
        "d_radius": [float(got[-2].double().sum()), float(ref[-2].double().sum())],
        "d_a": [float(got[-1].double().sum()), float(ref[-1].double().sum())],
        "d_radius_rel_err": rel(got[-2], ref[-2]), "d_a_rel_err": rel(got[-1], ref[-1]),
        "critical_path": tail,
    }
    build = sass.get("f32" if dtype == torch.float32 else "f64", {}) if sass else {}
    if "reverse_step" in build:
        per_step = build["reforward_step"] + build["reverse_step"]
        res["sass_per_step"] = {"reforward": build["reforward_step"], "reverse": build["reverse_step"]}
        res["issue_share"] = sweep_issue_share(args, kernel_ms, per_step)
    hit_kind = torch.where(has_ev != 0, kind0, -1)[ok_lanes]
    groups = {"sphere": [sp.kind for sp in spec.spheres], "disc": [d.kind for d in spec.discs]}
    hits = {g: torch.isin(hit_kind, torch.tensor(k, device=hit_kind.device)) for g, k in groups.items() if k}
    if spec.spheres:
        res["by_slot0_kind"] = {}
        for group, sel in hits.items():
            err = lane[sel]
            res["by_slot0_kind"][group] = {
                "lanes": int(sel.sum()),
                "lanes_within_tol": float((err <= K2_BARS[name][0]).double().mean()) if err.numel() else None,
                "lane_rel_err_max": float(err.max()) if err.numel() else None,
            }
    # Bound: per grad_ok lane, `steps` re-forward steps (the step map
    # alone) and `steps` reverse steps (the step map and its VJP), and once
    # per hit lane its slot-0 kind's payload; bytes are the checkpoint
    # reads, the scratch traffic (each re-forward step writes its state,
    # each reverse step reads it), the lane inputs and the outputs.
    elem = ckpt.element_size()
    s_ok = steps.long()[ok_lanes]
    ops = float(s_ok.sum()) * (flops["forward"] + flops["reverse"])
    ops += sum(float(sel.sum()) * flops["payload"][g] for g, sel in hits.items())
    res["payload_lanes"] = {g: int(sel.sum()) for g, sel in hits.items()}
    ckpt_rows = float(((s_ok + k_ckpt - 1) // k_ckpt).sum())
    bytes_moved = ((ckpt_rows * 8 + 2.0 * 8 * float(s_ok.sum())) * elem
                   + n * ((8 + 12 + 8 + 2 + 2 * len(consts)) * elem + 16))
    ops_ms = ops / card_peak_flops(dtype) * 1e3
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    res["bound_ms"] = max(ops_ms, bytes_ms)
    res["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    res["ok"] = (res["lanes_within_tol"] >= share and res["d_radius_rel_err"] <= sum_tol
                 and res["d_a_rel_err"] <= sum_tol)
    return res


def fit_step_breakdown(render, loss_fn, target, params):
    """Where one fit step's time goes: host clock around each part, each
    ended by a synchronize; then the device's busy share of one more step
    from a torch.profiler trace: the union of the device's kernel, copy and
    set intervals inside the step's window over the window's length (None
    when the trace shows no device activity)."""
    import torch

    leaves = [v.requires_grad_(True) for v in params.values()]
    marks = [("start", time.perf_counter())]

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    def step():
        color = render(params, mark)
        mark("rays_march_shade")
        loss = loss_fn(color, target)
        mark("loss")
        torch.autograd.grad(loss, leaves)
        mark("backward")

    step()
    split = {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}
    mark = lambda name: None  # the profiled step runs without the synchronizes
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("fit_step"):
            step()
            torch.cuda.synchronize()
    return split, device_busy_share(prof, "fit_step")


def device_busy_share(prof, window_name=None):
    """The union of the device intervals of a torch.profiler trace that
    fall in the host range `window_name`, over that range's length; with
    no `window_name` (a trace of the device alone), over the span from the
    trace's first device interval to its last, so that the profiler's own
    start and stop count as neither busy nor idle. None when no device
    interval falls in the window. The range's own device-side annotation
    is not device work and is left out. Read from the trace's raw events:
    a lax gradient step holds ~1.5 M device events, which prof.events()
    takes minutes to turn into Python objects."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    if window_name is None:
        device = [(e.start_ns(), e.end_ns()) for e in events if e.device_type() == cuda]
        if not device:
            return None
        lo, hi = min(t[0] for t in device), max(t[1] for t in device)
    else:
        device = [(e.start_ns(), e.end_ns()) for e in events if e.device_type() == cuda
                  and e.name() != window_name and not e.is_user_annotation()]
        window = next(e for e in events if e.name() == window_name and e.device_type() != cuda)
        lo, hi = window.start_ns(), window.end_ns()
    busy, end = 0, lo
    for start, stop in sorted((max(a, lo), min(b, hi)) for a, b in device):
        start = max(start, end)
        if stop > start:
            busy += stop - start
            end = stop
    return busy / (hi - lo) if busy > 0 else None


def fit_phase():
    """10 steps of the joint three-parameter fit (grad_scale_probe.py
    --fit3, start1) through inverse.fit on the card; returns its summary."""
    import math

    import torch

    from gr_raytracer_tpu_torch import inverse, presets
    from gr_raytracer_tpu_torch.ops import geodesic_adjoint as gadj
    from gr_raytracer_tpu_torch.ops import geodesic_march as gm
    from gr_raytracer_tpu_torch.rendering import camera as cam
    from gr_raytracer_tpu_torch.rendering import fast_path

    dt = torch.float32
    base = presets.kerr_flagship_params(dt, "cuda")
    spec = fast_path.scene_kernel_spec(presets.build_kerr_flagship(base, FIT_SIZE, FIT_SIZE, max_steps=FIT_BUDGET))
    rr, cc = torch.meshgrid(
        torch.arange(FIT_SIZE, dtype=dt, device="cuda"), torch.arange(FIT_SIZE, dtype=dt, device="cuda"),
        indexing="ij",
    )
    rf, cf = rr.ravel(), cc.ravel()

    def to_phys(p):
        return A_MAX * torch.tanh(p["u_a"]), 1e4 * torch.exp(p["v_t"]), p["theta"]

    def render(p, mark=lambda name: None):
        a, temp, theta = to_phys(p)
        full = dict(base, a=a, disc_temperature=temp, camera_theta=theta)
        scene = presets.build_kerr_flagship(full, FIT_SIZE, FIT_SIZE, max_steps=FIT_BUDGET, max_radius=40.0, step_size=0.05)
        mark("scene_build")
        x, m = cam.pixel_rays(scene.camera, rf, cf)
        return fast_path.trace_rays_fast_diff(scene, x, m, spec=spec, k_ckpt=K_CKPT).color

    as_params = lambda a, v, th: {
        "u_a": torch.tensor(math.atanh(a / A_MAX), dtype=dt, device="cuda"),
        "v_t": torch.tensor(v, dtype=dt, device="cuda"),
        "theta": torch.tensor(th, dtype=dt, device="cuda"),
    }
    with torch.no_grad():
        target = render(as_params(*FIT_TRUE))
    torch.cuda.synchronize()

    rows = []
    clock = [time.perf_counter()]

    def callback(step, loss, params, grads):
        torch.cuda.synchronize()
        now = time.perf_counter()
        a, temp, theta = (float(v.detach()) for v in to_phys(params))
        rows.append({
            "step": step, "loss": loss, "a": a, "disc_temperature": temp, "camera_theta": theta,
            "grads": {k: float(g) for k, g in grads.items()}, "s": now - clock[0],
            "k1_ms": sum(s.elapsed_time(e) for s, e in gm.launch_timer),
            "k2_ms": sum(s.elapsed_time(e) for s, e in gadj.launch_timer),
        })
        gm.launch_timer.clear()
        gadj.launch_timer.clear()
        print(json.dumps(rows[-1]), flush=True)
        clock[0] = time.perf_counter()

    gm.launches = 0
    gadj.launches = 0
    gm.launch_timer, gadj.launch_timer = [], []
    _, losses = inverse.fit(
        render, as_params(*FIT_START1), target, trainable=("u_a", "v_t", "theta"), steps=FIT_STEPS,
        learning_rate=inverse.cosine_decay_schedule(1e-2, 400, 0.01), clip_norm=1.0,
        loss_fn=inverse.pyramid_image_loss(FIT_SIZE, FIT_SIZE, (4, 16)), callback=callback,
    )
    k1_launches, k2_launches = gm.launches, gadj.launches
    gm.launch_timer = gadj.launch_timer = None
    split, busy = fit_step_breakdown(
        render, inverse.pyramid_image_loss(FIT_SIZE, FIT_SIZE, (4, 16)), target, as_params(*FIT_START1)
    )
    mean = lambda key: sum(r[key] for r in rows) / len(rows)
    summary = {
        "frame": f"{FIT_SIZE}x{FIT_SIZE}", "max_steps": FIT_BUDGET, "steps": FIT_STEPS,
        "k1_launches": k1_launches, "k2_launches": k2_launches,
        "loss_first": losses[0], "loss_last": losses[-1],
        "final": {k: rows[-1][k] for k in ("a", "disc_temperature", "camera_theta")},
        "s_per_step": mean("s"), "k1_ms_per_step": mean("k1_ms"), "k2_ms_per_step": mean("k2_ms"),
        "step_breakdown_s": split, "device_busy_share": busy,
    }
    finite = all(math.isfinite(g) for r in rows for g in r["grads"].values())
    moving = all(any(r["grads"][k] != 0.0 for r in rows) for k in ("u_a", "v_t", "theta"))
    summary["grads_finite"], summary["grads_nonzero"] = finite, moving
    if not finite:
        fail(f"a fit gradient is not finite: {rows}")
    if not moving:
        fail(f"a trainable's gradient is zero on every step: {rows}")
    if k1_launches == 0 or k2_launches == 0:
        fail(f"the fit launched K1 {k1_launches} and K2 {k2_launches} times")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"the fit's loss did not fall: {losses}")
    return summary


def _bl_one_lane():
    import torch

    return torch.tensor([[0.0, 8.0, 1.4, 0.5, -30.0, 0.9, 0.0, 0.0]], dtype=torch.float64).T


def count_bl_step_flops(spheres=()):
    """Arithmetic operations of one Mino-time RK4 step of the BL march, per
    ray, counted on the plain step (count_ops's "float" class) with the
    near tests of `spheres`; event stores are rare and not counted."""
    import math

    import torch

    from gr_raytracer_tpu_torch.ops import geodesic_march as gm

    f64 = torch.float64
    c = gm._march_constants(1.0, 0.499, 1e-4, 0.01, 100, 1000.0, 0.02, 10.0, True, False, f64, "cpu")
    c["half_pi"] = torch.tensor(math.pi / 2, dtype=f64)
    y = _bl_one_lane()
    one = lambda v: torch.tensor([v], dtype=f64)
    lanes = gm._BLLanes(
        y, torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
        *gm._event_buffers(1, f64, "cpu"), torch.zeros_like(y), one(1.0), one(2.0), one(5.0), one(1.0),
    )
    return count_ops(lambda: gm._bl_plain_step(c, lanes, (), spheres))["float"]


def count_bl_sweep_flops():
    """count_sweep_flops for the BL sweep: one re-forward step
    (_bl_masked_step), one reverse step (it and its VJP by torch.autograd)
    and the disc payload's extra cost at the stored step
    (_bl_step_with_payload and its VJP, less the reverse step)."""
    import torch

    from gr_raytracer_tpu_torch.ops import geodesic_adjoint as gadj
    from gr_raytracer_tpu_torch.ops import geodesic_march as gm

    f64 = torch.float64
    leaves = [torch.tensor([v], dtype=f64, requires_grad=True) for v in (1.0, 0.45, 1.0, 2.0, 5.0)]
    y = _bl_one_lane().requires_grad_(True)
    disc = (gm.DiscSpec(1.0, 15.0, 0),)
    active = torch.ones(1, dtype=torch.bool)
    step = lambda: gadj._bl_masked_step(*leaves[:2], 0.01, 0.02, 10.0, *leaves[2:], y, active)

    def vjp(with_payload):
        if with_payload:
            outs = gadj._bl_step_with_payload(disc, 0.01, 0.02, 10.0, torch.zeros(1, dtype=torch.int32), *leaves, y,
                                              active)
        else:
            outs = (step(),)
        torch.autograd.grad(outs, (*leaves, y), tuple(torch.ones_like(o) for o in outs))

    with torch.no_grad():
        forward = count_ops(step)["float"]
    reverse = count_ops(lambda: vjp(False))["float"]
    return {"forward": forward, "reverse": reverse,
            "payload": {"disc": count_ops(lambda: vjp(True))["float"] - reverse}}


def bl_fit_scene(dtype):
    """(scene, spec, x, p): kerr-bl.toml at the BL fit's size, budget and
    camera (grad_scale_probe.py --bl), and its camera rays."""
    import torch

    from gr_raytracer_tpu_torch import config
    from gr_raytracer_tpu_torch.rendering import camera as cam
    from gr_raytracer_tpu_torch.rendering import fast_path

    opts = config.RenderOptions(width=BL_FIT_SIZE, height=BL_FIT_SIZE, max_steps=BL_FIT_BUDGET,
                                max_radius=BL_FIT_RADIUS, **BL_FIT_CAMERA)
    scene = config.create_scene(config.load_config(KERR_BL_TOML), opts, dtype, torch.device("cuda"))
    rr, cc = torch.meshgrid(
        torch.arange(BL_FIT_SIZE, dtype=dtype, device="cuda"),
        torch.arange(BL_FIT_SIZE, dtype=dtype, device="cuda"), indexing="ij",
    )
    x, p = cam.pixel_rays(scene.camera, rr.ravel(), cc.ravel())
    return scene, fast_path.scene_kernel_spec(scene), x, p


def cli_render(toml, size, camera, png, counters, extra=()):
    """One CLI `render` (float32, the TOML's AA) into `png`. `counters` are
    (label, module, launch-counter name) triples, each counter set to 0
    just before the render; `extra` are more CLI options. Returns
    (RenderOutput, seconds, {label: (launches, ms from the launch
    timer)})."""
    import torch

    from gr_raytracer_tpu_torch import cli

    from gr_raytracer_tpu_torch.rendering import integrator as integ

    integ.loop_stats.clear()  # the lax loops of the frame's re-traces
    timers = [(label, module, name, name.replace("launches", "launch_timer")) for label, module, name in counters]
    for _, module, name, timer in timers:
        setattr(module, name, 0)
        setattr(module, timer, [])
    argv = ["--width", str(size), "--height", str(size), *camera, "--max-steps", str(MAX_STEPS), *extra,
            "-c", toml, "render", "--filename", png]
    t0 = time.perf_counter()
    out = cli.main(argv)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    kernels = {}
    for label, module, name, timer in timers:
        kernels[label] = (getattr(module, name), sum(s.elapsed_time(e) for s, e in getattr(module, timer)))
        setattr(module, timer, None)
    return out, total_s, kernels


class K3Launches:
    """Records each K3 launch of the renders inside the block (by wrapping
    geodesic_march._march_cuda and raytracer.trace_pixels_chunked): its
    traced pass (1 or AA), whether it marches the pass's rays or re-traces
    those that overflowed their event slots (OVERFLOW_MAX_EVENTS slots),
    its lanes, their steps (on the card until read) and its CUDA events
    from the launch timer (cli_render sets it); and the pixel coordinates
    of each traced pass."""

    def __enter__(self):
        from gr_raytracer_tpu_torch.ops import geodesic_march as gm
        from gr_raytracer_tpu_torch.rendering import raytracer as rt

        self.gm, self.rt = gm, rt
        self.inner_march, self.inner_trace = gm._march_cuda, rt.trace_pixels_chunked
        self.launches, self.passes = [], []

        def march(y0, consts, params, discs, spheres, vols, max_steps, opaque_stop, attempts, finalize, *rest,
                  **kwargs):
            out = self.inner_march(y0, consts, params, discs, spheres, vols, max_steps, opaque_stop, attempts,
                                   finalize, *rest, **kwargs)
            resume = rest[3] if len(rest) > 3 else kwargs.get("resume")
            leg = "2" if resume is not None else ("" if finalize else "1")
            if consts and gm.bl_launch_timer:
                self.launches.append((len(self.passes), leg, out[3].shape[1], out[2], gm.bl_launch_timer[-1]))
            return out

        def trace(scene, row_f, col_f, chunk_size, progress=False, lax=False):
            self.passes.append((row_f, col_f))
            return self.inner_trace(scene, row_f, col_f, chunk_size, progress, lax)

        gm._march_cuda = march
        rt.trace_pixels_chunked = trace
        return self

    def __exit__(self, *exc):
        self.gm._march_cuda = self.inner_march
        self.rt.trace_pixels_chunked = self.inner_trace

    def table(self):
        """One row a launch: [pass, kind, leg (1 or 2 of a chunk's two legs,
        "" for one launch), lanes, Σ steps (a lane's total at the end of the
        launch), longest lane, ms, steps/s (over the steps the launch took:
        a second leg's less its lanes' steps before it), the share of the
        launch's steps its first 10 % of lanes take], and a summary by pass
        and kind."""
        from gr_raytracer_tpu_torch.rendering.raytracer import OVERFLOW_MAX_EVENTS

        rows, summary, before = [], {}, 0
        for p, leg, slots, steps, (start, end) in self.launches:
            n = steps.long()
            total, ms = int(n.sum()), start.elapsed_time(end)
            taken = total - (before if leg == "2" else 0)
            before = total if leg == "1" else 0
            head = int(n[: max(1, n.numel() // 10)].sum())
            key = ("1" if p <= 1 else "AA", "retrace" if slots == OVERFLOW_MAX_EVENTS else "march")
            rows.append([*key, leg, n.numel(), total, int(n.max()) if n.numel() else 0, round(ms, 3),
                         taken / max(ms / 1e3, 1e-9), round(head / max(total, 1), 4)])
            s = summary.setdefault(" ".join(key), {"launches": 0, "lanes": 0, "sum_steps": 0, "ms": 0.0})
            s["launches"] += 1
            s["ms"] += ms
            if leg != "1":  # a second leg's lanes and steps hold its first's
                s["lanes"] += n.numel()
                s["sum_steps"] += total
        return {"columns": ["pass", "kind", "leg", "lanes", "sum_steps", "longest", "ms", "steps_per_s",
                            "first_10pct_share"], "rows": rows, "summary": summary}


class K1Launches:
    """Records each K1 launch inside the block (by wrapping
    geodesic_march._march_cuda and raytracer.trace_pixels_chunked): its
    traced pass (0 outside a render, 1, or 2 for AA), whether it marches
    the pass's rays or re-traces those that overflowed their event slots
    (OVERFLOW_MAX_EVENTS slots), its arguments (to time its longest lanes
    alone), its outputs (on the card until read) and its CUDA events (the
    launch timer is set to a list inside the block where it is not one);
    and the pixel coordinates of each traced pass."""

    def __enter__(self):
        from gr_raytracer_tpu_torch.ops import geodesic_march as gm
        from gr_raytracer_tpu_torch.rendering import raytracer as rt

        self.gm, self.rt = gm, rt
        self.inner_march, self.inner_trace = gm._march_cuda, rt.trace_pixels_chunked
        self.launches, self.passes = [], []
        self.own_timer = gm.launch_timer is None
        if self.own_timer:
            gm.launch_timer = []

        def march(y0, consts, *rest, **kwargs):
            if not consts and gm.launch_timer is None:  # cli_render's timer ended with its render
                gm.launch_timer = []
                self.own_timer = True
            out = self.inner_march(y0, consts, *rest, **kwargs)
            if not consts:
                self.launches.append({"pass": len(self.passes), "args": (y0.clone(), consts, *rest),
                                      "kwargs": kwargs, "out": out, "events": gm.launch_timer[-1]})
            return out

        def trace(scene, row_f, col_f, chunk_size, progress=False, lax=False):
            self.passes.append((row_f, col_f))
            return self.inner_trace(scene, row_f, col_f, chunk_size, progress, lax)

        gm._march_cuda = march
        rt.trace_pixels_chunked = trace
        return self

    def __exit__(self, *exc):
        self.gm._march_cuda = self.inner_march
        self.rt.trace_pixels_chunked = self.inner_trace
        if self.own_timer:
            self.gm.launch_timer = None

    def kind(self, launch):
        from gr_raytracer_tpu_torch.rendering.raytracer import OVERFLOW_MAX_EVENTS

        return "retrace" if launch["out"][3].shape[1] == OVERFLOW_MAX_EVENTS else "march"

    def tail_ms(self, launch, reps=3):
        """K1's ms on the launch's TAIL_LANES longest lanes alone, in their
        launch order (not counted as launches)."""
        import torch

        y0, *rest = launch["args"]
        idx = torch.sort(torch.argsort(launch["out"][2], descending=True, stable=True)[:TAIL_LANES]).values
        sub = y0[idx].contiguous()
        count = self.gm.launches
        run = lambda: self.inner_march(sub, *rest, **launch["kwargs"])
        run()
        torch.cuda.synchronize()
        ms = time_cuda(run, reps)[0]
        self.gm.launches = count
        return ms

    def table(self, instructions_per_step=None, tail=True):
        """One row a launch: [pass, kind, lanes, Σ steps, longest lane,
        p99, p50, ms, steps/s, warp efficiency (Σ steps over Σ 32 × each
        warp's longest lane, warps taken as 32 lanes in launch order), ms
        of its TAIL_LANES longest lanes alone (with `tail`)]; with
        `instructions_per_step` (K1's common-path step in SASS) the issue
        share of the launches together and of each."""
        import torch

        rows = []
        for launch in self.launches:
            n = launch["out"][2].long()
            total = int(n.sum())
            warps = torch.nn.functional.pad(n, (0, -n.numel() % 32)).reshape(-1, 32).amax(dim=1)
            q = torch.quantile(n.double(), torch.tensor([0.99, 0.5], dtype=torch.float64, device=n.device))
            ms = launch["events"][0].elapsed_time(launch["events"][1])
            p = launch["pass"]
            rows.append(["" if p == 0 else ("1" if p == 1 else "AA"), self.kind(launch), n.numel(), total,
                         int(n.max()), float(q[0]), float(q[1]), round(ms, 4), total / max(ms / 1e3, 1e-9),
                         round(total / max(32 * int(warps.sum()), 1), 4),
                         round(self.tail_ms(launch), 4) if tail else None])
        out = {"columns": ["pass", "kind", "lanes", "sum_steps", "longest", "p99", "p50", "ms", "steps_per_s",
                           "warp_efficiency", f"ms_longest_{TAIL_LANES}"], "rows": rows,
               "ms": sum(r[7] for r in rows), "launches": len(rows)}
        if instructions_per_step:
            out["issue_share"] = issue_share(sum(r[3] for r in rows), out["ms"], instructions_per_step)
            out["issue_share_by_launch"] = [issue_share(r[3], r[7], instructions_per_step) for r in rows]
        return out


def k1_fit_frame_tables(instructions_per_step):
    """K1's launch table (K1Launches) on the frames of the KS fit (the
    flagship 256² frame at its true parameters, a checkpoint every
    K_CKPT steps), the Kerr disc and sphere fit (its target, a
    checkpoint every SPHERE_K_CKPT steps) and the medium fit (the 256²
    kerr-volumetric-streaky frame's geometric pass), each the one launch
    of a forward."""
    import torch

    from gr_raytracer_tpu_torch.rendering import fast_path

    with K1Launches() as rec:
        for sphere, k_ckpt in ((False, K_CKPT), (True, SPHERE_K_CKPT)):
            kernel, _, args, kw, _, _ = ckpt_march_setup(torch.float32, sphere=sphere, k_ckpt=k_ckpt)
            kernel(*args, **kw)
        scene, spec, x, p = vol_grad_scene(VOL_TOML, VOL_FIT_SIZE, VOL_CAMERA_KW)
        fast_path.trace_geometric_fast(scene, x, p, spec)
        torch.cuda.synchronize()
    table = rec.table(instructions_per_step)
    table["frames"] = ["KS fit", "Kerr disc+sphere fit", "medium fit"]
    return table


class HostTime:
    """Host seconds spent in the kernel path's functions inside the block
    (fast_path._prepare_march, _march's dispatch, _finish_samples),
    by wrapping them; a call that waits for the card counts the wait."""

    NAMES = ("_prepare_march", "_march", "_finish_samples")

    def __enter__(self):
        from gr_raytracer_tpu_torch.rendering import fast_path

        self.module, self.inner, self.seconds = fast_path, {}, {}
        for name in self.NAMES:
            self.inner[name] = getattr(fast_path, name)
            setattr(fast_path, name, self._timed(name, self.inner[name]))
        return self

    def _timed(self, name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
            return out

        return call

    def __exit__(self, *exc):
        for name, fn in self.inner.items():
            setattr(self.module, name, fn)


def issue_share(steps, ms, instructions_per_step):
    """The share of the card's issue slots (132 SMs × 4 schedulers × 32
    lanes × the SM clock) that `steps` march steps of
    `instructions_per_step` common-path instructions each fill in `ms`
    milliseconds. Lanes idle in a diverged warp are not counted."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm")) * 1e6
    return steps / max(ms / 1e3, 1e-12) * instructions_per_step / (sms * 4 * 32 * clock_hz)


def at_main_shape(toml, size, camera_kw, row_f, col_f, compared, attempts=None):
    """K1 or K3 (the scene's march) at the main path's shape against its
    plain version: the lanes of one traced pass of the CLI render of
    `toml` (pixel coordinates row_f, col_f; float32, the CLI's options;
    the render's one chunk), prepared as the render prepares them, with a
    compared chunk's lanes (`compared`, kept by compare_march: its inputs
    and the plain version's results) in the place of as many lanes in the
    middle, all marched as the render marches them (fast_path._march;
    `attempts` as there). The pass holds more lanes than the card keeps
    threads, so most of them are taken by the kernel's refill. The compared
    chunk's lanes must equal the plain version's results bit for bit."""
    import numpy as np
    import torch

    from gr_raytracer_tpu_torch import config
    from gr_raytracer_tpu_torch.rendering import camera as cam
    from gr_raytracer_tpu_torch.rendering import fast_path

    dt = torch.float32
    opts = config.RenderOptions(width=size, height=size, max_steps=MAX_STEPS, **camera_kw)
    scene = config.create_scene(config.load_config(toml), opts, dt, torch.device("cuda"))
    spec = fast_path.scene_kernel_spec(scene)
    rows = torch.as_tensor(np.asarray(row_f, np.float64), device="cuda").to(dt)
    cols = torch.as_tensor(np.asarray(col_f, np.float64), device="cuda").to(dt)
    inputs, ref = compared["inputs"], compared["ref"]
    n, total = inputs[0].shape[0], rows.numel()
    at = total // 2 - n // 2
    lanes = []
    for lo, hi in ((0, at), (at + n, total)):
        x, p = cam.pixel_rays(scene.camera, rows[lo:hi], cols[lo:hi])
        solver, y0, _, _ = fast_path._prepare_march(scene, x, p)
        lanes.append((y0, solver.e, solver.l_z, solver.q) if spec.mino else (y0,))
        if lo == 0:
            lanes.append(inputs)
    y0, *consts = (torch.cat(v).contiguous() for v in zip(*lanes))
    solver = fast_path._Conserved(*consts) if spec.mino else None
    got = fast_path._march(spec, scene.integration, solver, y0, attempts=attempts)
    eq = lambda g, r: bool(((g == r) | (g.isnan() & r.isnan())).all() if g.is_floating_point() else (g == r).all())
    return {"kernel": "K3" if spec.mino else "K1", "pass_lanes": total, "compared_lanes": n, "compared_at": at,
            "attempts": attempts, "bit_identical": all(eq(g[at:at + n], r) for g, r in zip(got, ref))}


def _sass_classify(seq):
    """An instruction count split into MUFU, conversions (F2I, I2F, FRND,
    F2F), calls (named by their target) and the rest."""
    import re

    c = {"instructions": len(seq), "mufu": 0, "conversions": 0, "calls": {}}
    for v in seq:
        if v["op"].startswith("MUFU"):
            c["mufu"] += 1
        elif v["op"].split(".")[0] in ("F2I", "I2F", "FRND", "F2F", "I2FP", "F2IP"):
            c["conversions"] += 1
        elif v["op"].startswith("CALL"):
            name = re.sub(r"^.*\$", "", v["args"].strip(" `()"))
            c["calls"][name] = c["calls"].get(name, 0) + 1
    return c


def _sass_sections(source, kernel):
    """{build key: (instructions, backward branches, walk)} of `kernel` in
    the SASS of the library built from `source` (cuobjdump), one entry for
    each of its builds (keyed by type and set template flags); None where
    the toolkit has no cuobjdump. A backward branch is (span, target index,
    index); walk(lo, hi, keep_tail) is the path from lo that takes every
    forward branch whose target lies before the last keep_tail
    instructions up to hi (None unless it reaches hi)."""
    import re

    from gr_raytracer_tpu_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    lib = cuda_build._lib_path(source, cuda_build.NVCC_FLAGS)
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    ins_re = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
    label_re = re.compile(r"^\s*([.$][^\s:]+):\s*$")
    out = {}
    for section in text.split("Function : ")[1:]:
        m = re.search(kernel + r"I([fd])((?:Lb[01]E)*)", section.split()[0])
        if not m:
            continue
        flags = "".join(f" {flag}" for flag, on in zip(KERNEL_FLAGS.get(kernel, ()), re.findall(r"Lb([01])", m.group(2)))
                        if on == "1")
        ins, labels, pending = [], {}, []
        for line in section.splitlines():
            lm = label_re.match(line)
            if lm:
                pending.append(lm.group(1))
                continue
            im = ins_re.search(line)
            if im:
                for name in pending:
                    labels[name] = len(ins)
                pending = []
                ins.append({"addr": int(im.group(1), 16), "pred": im.group(2), "op": im.group(3),
                            "args": im.group(4)})
        by_addr = {v["addr"]: i for i, v in enumerate(ins)}

        def target(v, labels=labels, by_addr=by_addr):
            lm = re.search(r"`\(([^)]+)\)", v["args"])
            if lm:
                return labels.get(lm.group(1))
            hm = re.search(r"0x([0-9a-f]+)", v["args"])
            return by_addr.get(int(hm.group(1), 16)) if hm else None

        backs = [(i - t, t, i) for i, v in enumerate(ins)
                 if v["op"].startswith("BRA") and (t := target(v)) is not None and t < i]

        def walk(lo, hi, keep_tail=0, ins=ins, target=target):
            path, pc = [], lo
            while lo <= pc <= hi and len(path) < len(ins):
                v = ins[pc]
                path.append(v)
                if pc == hi:
                    return path
                t = target(v) if v["op"].startswith("BRA") else None
                if t is not None and pc < t <= hi - keep_tail:
                    pc = t
                    continue
                if t is not None and v["pred"] is None:
                    return None
                pc += 1
            return None

        out[("f32" if m.group(1) == "f" else "f64") + flags] = (ins, backs, walk)
    return out


def sass_k3_step(source="kerr_bl_march.cu", kernel="bl_march_kernel"):
    """Instructions of `kernel` in the SASS of its built library (cuobjdump,
    where the toolkit has it), in f32 and f64: the whole function, and one
    iteration of its step loop along the common path, for each of its
    builds (keyed by type and set template flags). The loop's backward
    branches are those that span at least half the widest one's; a walk
    from a backward branch's target takes every forward branch that stays
    before it (they skip the event blocks, the checkpoint store and the
    calls of the slow paths; the refill of a stopped lane lies past the
    step's own backward branch), and the longest such walk is the step. It
    counts every instruction issued, predicated ones too. Each count is
    split into MUFU, conversions (F2I, I2F, FRND, F2F), calls (named by their
    target) and the rest."""
    sections = _sass_sections(source, kernel)
    if sections is None:
        return {"cuobjdump": "not in the toolkit"}
    out = {}
    for key, (ins, backs, walk) in sections.items():
        entry = _sass_classify(ins)
        if backs:
            # The loop's back edges (the step's, and the refilled lane's)
            # span most of the function; the step's walk is the longest.
            widest = max(backs)[0]
            paths = [p for span, t, i in backs if 2 * span >= widest and (p := walk(t, i))]
            entry["loop"] = {"span": widest + 1, "common_path": _sass_classify(max(paths, key=len, default=[]))}
        out[key] = entry
    return out


# sass_sweep_step: a forward branch to the last this many instructions of a
# loop ends its body (a `continue` past a step whose state is not finite,
# the skip of a re-forward step on such a state) and is not taken.
SWEEP_LATCH = 12


def sass_sweep_step(source, kernel, directions):
    """Instructions of one step of a reverse sweep (K2, K4) in its SASS,
    in f32 and f64, along the common path (a walk as sass_k3_step's, which
    keeps the branches that skip a step's whole body: SWEEP_LATCH). The
    sweep's loops nest: a lane's segments (the widest loop), in each the
    re-forward loop and then the reverse loop, whose step may hold a loop
    of its own over `directions` dual evaluations (a sweep that forms
    the step's Jacobian a column at a time), counted that many times; a
    sweep whose common path holds no such loop takes 1. Returns, per build, the
    instructions of one re-forward step and of one reverse step, and every
    loop (span, common path, depth)."""
    sections = _sass_sections(source, kernel)
    if sections is None:
        return {"cuobjdump": "not in the toolkit"}
    out = {}
    for key, (ins, backs, walk) in sections.items():
        loops = []
        for span, t, i in sorted(backs, key=lambda b: b[1]):
            path = walk(t, i, SWEEP_LATCH)
            depth = sum(1 for s2, t2, i2 in backs if t2 <= t and i <= i2 and (t2, i2) != (t, i))
            loops.append({"first": t, "last": i, "span": span + 1, "depth": depth,
                          "common_path": len(path) if path else None})
        entry = {"instructions": len(ins), "loops": [{k: v for k, v in lp.items() if k not in ("first", "last")}
                                                     for lp in loops]}
        outer = max(loops, key=lambda lp: lp["span"], default=None)
        inner = lambda lp: [c for c in loops if lp["first"] <= c["first"] and c["last"] <= lp["last"] and c is not lp]
        if outer is not None:
            kids = [c for c in inner(outer) if not any(c in inner(o) for o in inner(outer))]
            if len(kids) >= 2 and all(c["common_path"] for c in kids[:2]):
                fwd, rev = kids[0], kids[-1]
                step = rev["common_path"]
                if directions > 1:
                    kids_rev = [c for c in inner(rev) if not any(c in inner(o) for o in inner(rev))]
                    step += (directions - 1) * sum(c["common_path"] or 0 for c in kids_rev)
                entry["reforward_step"] = fwd["common_path"]
                entry["reverse_step"] = step
        out[key] = entry
    return out


class Slot0Kinds:
    """Counts the slot-0 event kinds of every ray the kernel path shades
    (pass 1 and AA) by wrapping fast_path._finish_samples; the counts stay
    on the card until read."""

    def __enter__(self):
        import torch

        from gr_raytracer_tpu_torch.rendering import fast_path

        self.module, self.inner = fast_path, fast_path._finish_samples
        self.counts = None

        def finish(scene, res, *args, **kwargs):
            kinds = torch.bincount(res.ev_kind[:, 0].long() + 1, minlength=len(scene.objects) + 1)
            self.counts = kinds if self.counts is None else self.counts + kinds
            return self.inner(scene, res, *args, **kwargs)

        fast_path._finish_samples = finish
        return self

    def __exit__(self, *exc):
        self.module._finish_samples = self.inner

    def by_kind(self):
        """[rays with no event, rays whose slot 0 is object 0, object 1, ...]."""
        return [] if self.counts is None else self.counts.tolist()


def check_frame(out, png, size, codes, what):
    """The frame's checks: supersampled pixels, the stop codes `codes` in
    pass 1, finite colors, a non-trivial PNG; returns its summary."""
    import numpy as np

    from gr_raytracer_tpu_torch.utils.png import png_decode

    with open(png, "rb") as f:
        img = png_decode(f.read())
    pass1, aa = out.stats["pass1"], out.stats.get("aa")
    if aa is None or not out.supersample_mask.any():
        fail(f"{what}: no pixel was supersampled")
    stops = pass1.stop_counts
    names = {1: "HORIZON", 2: "CELESTIAL", 7: "SATURATED"}
    for code in codes:
        if stops[code] == 0:
            fail(f"{what}: no {names[code]} ray in the frame: {stops.tolist()}")
    if img.shape != (size, size, 4) or img[..., :3].std() < 5.0:
        fail(f"{what}: the PNG looks trivial: shape {img.shape}, std {img[..., :3].std():.2f}")
    if not (out.color.shape == (size, size, 4) and bool(np.isfinite(out.color).all())):
        fail(f"{what}: the frame has non-finite values or a wrong shape")
    return {
        "frame": f"{size}x{size}", "pass1_s": pass1.seconds, "pass1_rays": pass1.rays,
        "pass1_ray_steps": pass1.ray_steps, "aa_s": aa.seconds, "aa_rays": aa.rays,
        "aa_ray_steps": aa.ray_steps,
        "rays_per_s": (pass1.rays + aa.rays) / (pass1.seconds + aa.seconds),
        "ray_steps_per_s": (pass1.ray_steps + aa.ray_steps) / (pass1.seconds + aa.seconds),
        "supersampled_pixels": int(out.supersample_mask.sum()),
        "stop_counts_pass1": stops.tolist(),
        "hit_pixels": int((out.ray_class == 2).sum()),
    }


def nan_lanes_report(limit=20):
    """Every pass-1 ray of the 1000² kerr.toml frame that stops NAN: its
    pixel, initial state (exact float32 values) and stop step. Marched in
    N_RAYS-ray pieces (a lane's march does not depend on the others),
    outside the main path's count."""
    import numpy as np
    import torch

    from gr_raytracer_tpu_torch import config
    from gr_raytracer_tpu_torch.rendering import camera as cam
    from gr_raytracer_tpu_torch.rendering import fast_path
    from gr_raytracer_tpu_torch.rendering import integrator as integ

    dt = torch.float32
    opts = config.RenderOptions(width=FRAME, height=FRAME, max_steps=MAX_STEPS,
                                camera_position=(-10.0, 0.0, -0.5), theta=1.52, psi=-1.57)
    scene = config.create_scene(config.load_config(KERR_TOML), opts, dt, torch.device("cuda"))
    spec = fast_path.scene_kernel_spec(scene)
    lanes = []
    for start in range(0, FRAME * FRAME, N_RAYS):
        flat = np.arange(start, min(start + N_RAYS, FRAME * FRAME))
        rows = torch.as_tensor(flat // FRAME, dtype=dt, device="cuda")
        cols = torch.as_tensor(flat % FRAME, dtype=dt, device="cuda")
        x, p = cam.pixel_rays(scene.camera, rows, cols)
        solver, y0, _, inverse = fast_path._prepare_march(scene, x, p)
        res = fast_path._run_kernel(spec, scene.integration, solver, y0.contiguous())
        stop, steps = res[1][inverse], res[2][inverse]
        for i in torch.nonzero(stop == integ.NAN).flatten().tolist():
            lanes.append({
                "pixel": [int(flat[i] // FRAME), int(flat[i] % FRAME)],
                "y0": [float(v) for v in y0[inverse][i].double().tolist()],
                "stop_step": int(steps[i]),
                "y_final": [float(v) for v in res[0][inverse][i].double().tolist()],
            })
    return {"nan_lanes": len(lanes), "lanes": lanes[:limit]}


def chunk_size_phase():
    """Phase 15b: kerr.toml at 1000² and kerr-volumetric-streaky at 500²
    rendered by the CLI at --chunk-size 65,536 and at 2^20 (the default:
    each frame's pass one chunk); each pair of frames must be equal bit
    for bit."""
    import numpy as np

    res = {}
    for name, toml, size in (("kerr.toml", KERR_TOML, FRAME), ("kerr-volumetric-streaky", VOL_TOML, VOL_FRAME)):
        frames = {}
        for chunk in (65_536, 1 << 20):
            with tempfile.TemporaryDirectory() as tmp:
                out, secs, _ = cli_render(toml, size, CAMERA, os.path.join(tmp, "frame.png"), (),
                                          extra=("--chunk-size", str(chunk)))
            frames[chunk] = (out.color, secs)
        a, b = frames[65_536][0], frames[1 << 20][0]
        same = (a == b) | (np.isnan(a) & np.isnan(b))
        res[name] = {"frame": f"{size}x{size}", "pixels_differing": int((~same.all(axis=-1)).sum()),
                     "s_chunk_65536": frames[65_536][1], "s_chunk_2^20": frames[1 << 20][1]}
    res["ok"] = all(r["pixels_differing"] == 0 for r in res.values())
    return res


def bl_fit_phase():
    """The 12-step spin fit of grad_scale_probe.py --bl through inverse.fit
    on the card; returns its summary."""
    import dataclasses
    import math

    import torch

    from gr_raytracer_tpu_torch import inverse
    from gr_raytracer_tpu_torch.geometry.kerr_bl import KerrBL
    from gr_raytracer_tpu_torch.ops import geodesic_adjoint as gadj
    from gr_raytracer_tpu_torch.ops import geodesic_march as gm
    from gr_raytracer_tpu_torch.rendering import fast_path

    dt = torch.float32
    scene, spec, x, p = bl_fit_scene(dt)

    def render(pl, mark=lambda name: None):
        geo = KerrBL(radius=pl["radius"], a=pl["a"], horizon_epsilon=scene.geometry.horizon_epsilon)
        moved = dataclasses.replace(scene, geometry=geo)
        mark("scene_build")
        return fast_path.trace_rays_fast_diff(moved, x, p, spec=spec).color

    as_params = lambda a: {"radius": torch.tensor(1.0, dtype=dt, device="cuda"),
                           "a": torch.tensor(a, dtype=dt, device="cuda")}
    with torch.no_grad():
        target = render(as_params(BL_FIT_TRUE))
    torch.cuda.synchronize()
    rows = []
    clock = [time.perf_counter()]

    def callback(step, loss, params, grads):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rows.append({
            "step": step, "loss": loss, "a": float(params["a"].detach()),
            "grads": {k: float(g) for k, g in grads.items()}, "s": now - clock[0],
            "k3_ms": sum(s.elapsed_time(e) for s, e in gm.bl_launch_timer),
            "k4_ms": sum(s.elapsed_time(e) for s, e in gadj.bl_launch_timer),
        })
        gm.bl_launch_timer.clear()
        gadj.bl_launch_timer.clear()
        print(json.dumps(rows[-1]), flush=True)
        clock[0] = time.perf_counter()

    gm.bl_launches = 0
    gadj.bl_launches = 0
    gm.bl_launch_timer, gadj.bl_launch_timer = [], []
    params, losses = inverse.fit(
        render, as_params(BL_FIT_START), target, trainable=("a",), steps=BL_FIT_STEPS, learning_rate=3e-2,
        callback=callback,
    )
    k3_launches, k4_launches = gm.bl_launches, gadj.bl_launches
    gm.bl_launch_timer = gadj.bl_launch_timer = None
    split, busy = fit_step_breakdown(render, inverse.image_loss, target, as_params(BL_FIT_START))
    mean = lambda key: sum(r[key] for r in rows) / len(rows)
    a_final = float(params["a"].detach())
    summary = {
        "frame": f"{BL_FIT_SIZE}x{BL_FIT_SIZE}", "max_steps": BL_FIT_BUDGET, "mino_budget": 2 * BL_FIT_BUDGET,
        "steps": BL_FIT_STEPS, "k3_launches": k3_launches, "k4_launches": k4_launches,
        "loss_first": losses[0], "loss_last": losses[-1], "a_start": BL_FIT_START, "a_final": a_final,
        "a_true": BL_FIT_TRUE, "s_per_step": mean("s"), "k3_ms_per_step": mean("k3_ms"),
        "k4_ms_per_step": mean("k4_ms"), "step_breakdown_s": split, "device_busy_share": busy,
    }
    if not all(math.isfinite(g) for r in rows for g in r["grads"].values()):
        fail(f"a BL fit gradient is not finite: {rows}")
    if not any(r["grads"]["a"] != 0.0 for r in rows):
        fail(f"the BL fit's da is zero on every step: {rows}")
    if k3_launches == 0 or k4_launches == 0:
        fail(f"the BL fit launched K3 {k3_launches} and K4 {k4_launches} times")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"the BL fit's loss did not fall: {losses}")
    if not abs(a_final - BL_FIT_TRUE) < abs(BL_FIT_START - BL_FIT_TRUE):
        fail(f"the BL fit's spin did not move toward {BL_FIT_TRUE}: {a_final}")
    return summary


def count_raymarch_ops():
    """Operations of one raymarch sample per lane, by class (count_ops), on
    the plain sample of the main path's spec (kerr-volumetric-streaky: 8
    octaves, blackbody texture)."""
    import torch

    from gr_raytracer_tpu_torch import config
    from gr_raytracer_tpu_torch.ops import volumetric_march as vm
    from gr_raytracer_tpu_torch.rendering import fast_path

    f64 = torch.float64
    scene = config.create_scene(config.load_config(VOL_TOML), config.RenderOptions(width=4, height=4), f64,
                                torch.device("cpu"))
    spec = fast_path.scene_kernel_spec(scene).vol_spec
    one = lambda *v: torch.tensor([v], dtype=f64) if len(v) > 1 else torch.tensor(v, dtype=f64)
    lanes = vm._Lanes(
        one(8.0, 1.0, 0.01), one(-0.6, 0.8, -0.01), one(1.0), one(1.0), one(0.1), one(5.0), one(1e30),
        one(-1e30), one(-1e30), one(10.0), one(1.0), torch.zeros((1, 3), dtype=f64), one(0.0), one(0.0),
        torch.zeros(1, dtype=torch.bool), torch.zeros(1, dtype=torch.int32),
    )
    c = vm._constants(spec, f64, "cpu")
    return count_ops(lambda: vm._march_step(spec, c, lanes, vm._medium(spec, c)))


def raymarch_bound_ms(samples, n_lanes, ops, dtype, lane_bytes=None):
    """(bound ms, "bytes" or "operations") of a raymarch over `samples`
    samples of `n_lanes` lanes: the larger of the float operations (with
    exp, log and floor) over the FP peak, the integer operations over the
    INT32 peak (SMs × 64 lanes × max clock), and `lane_bytes` per lane over
    the memory rate (default K5's: 11 inputs and 4 outputs and the int32
    sample count)."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_peak = sms * INT32_LANES_PER_SM * float(nvidia_smi("clocks.max.sm")) * 1e6
    elem = 8 if dtype == torch.float64 else 4
    float_ms = samples * (ops["float"] + ops["exp_log"] + ops["floor"]) / card_peak_flops(dtype) * 1e3
    int_ms = samples * ops["int"] / int_peak * 1e3
    bytes_ms = n_lanes * (15 * elem + 4 if lane_bytes is None else lane_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = max(float_ms, int_ms)
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def lane_errors(got, ref):
    """Per lane: max |got − ref| over the lane's largest |ref|, or max |got|
    where the reference lane is all zero."""
    import torch

    scale = ref.abs().amax(dim=1)
    diff = (got - ref).abs().amax(dim=1)
    return torch.where(scale > 0, diff / scale.clamp(min=1e-300), got.abs().amax(dim=1))


def batch_use(samples):
    """Σ n_i / Σ 32·⌈n_i / 32⌉: the share of the samples K5 and K6 evaluate
    that their lanes fold (a warp evaluates a lane's samples 32 at a time
    and drops those past the lane's exit)."""
    n = samples.long()
    slots = 32 * int(((n + 31) // 32).sum())
    return int(n.sum()) / slots if slots else 1.0


class RaymarchSamples:
    """Keeps the per-lane sample counts of every K5 launch of the main path
    (vm.raymarch's second result) by wrapping vm.raymarch; the counts stay
    on the card until read."""

    def __enter__(self):
        from gr_raytracer_tpu_torch.ops import volumetric_march as vm

        self.module, self.inner = vm, vm.raymarch
        self.launches = []

        def raymarch(*args, **kwargs):
            out = self.inner(*args, **kwargs)
            self.launches.append(out[1])
            return out

        vm.raymarch = raymarch
        return self

    def __exit__(self, *exc):
        self.module.raymarch = self.inner

    def batch_use(self):
        """The batch use of the first launch, of each launch, and of the
        frame (every launch's lanes together), and each launch's lanes and
        longest lane (its critical path)."""
        import torch

        per_launch = [batch_use(n) for n in self.launches]
        return {"first_launch": per_launch[0] if per_launch else None,
                "frame": batch_use(torch.cat(self.launches)) if self.launches else None,
                "per_launch": per_launch, "lanes": [int(n.numel()) for n in self.launches],
                "longest_lane_per_launch": [int(n.max()) if n.numel() else 0 for n in self.launches]}


def hole_jump_lanes(spec, lanes, counts):
    """Lanes whose plain walk of `counts` samples crosses the disc's inner
    hole: their k moves by more than 1 between two samples they evaluate
    (next_k's hole branch). A replay of the k walk alone (_march_bounds,
    _next_k), without the optics. Returns a bool [N]."""
    import types

    import torch

    from gr_raytracer_tpu_torch.ops import volumetric_march as vm

    ro, rd, _, _, _, active, exit_d = lanes
    c = vm._constants(spec, ro.dtype, ro.device)
    k, _, _, i_lo, i_hi, k_hole_exit = vm._march_bounds(spec, c, ro, rd, exit_d, active)
    bounds = types.SimpleNamespace(i_lo=i_lo, i_hi=i_hi, k_hole_exit=k_hole_exit)
    jumped = torch.zeros_like(active)
    for j in range(int(counts.max()) - 1):
        k_next = vm._next_k(spec, bounds, k)
        jumped |= (k_next > k + 1.0) & (counts > j + 1)
        k = k_next
    return jumped


def hole_crossing_lanes(spec, lanes, n=128, seed=0):
    """`n` lanes that take next_k's hole jump and march on within their
    first VOL_COMPARE_STEPS samples (the budget caps a lane's march at
    VOL_COMPARE_STEPS·d_s): each lies in the disc's plane, crosses the
    inner hole on a chord 0.05 to 0.2 long, starts 20 to 800 samples
    before the hole and has the scene's full march length as exit_d. The
    main path's lanes rarely take the jump, as their exit_d ends at the
    inner wall. So close to the inner wall the density's boundary factor
    is ~0: these lanes hold the walk and the sample counts, the chunk's
    lanes the fold. obs_e, p_t and p_phi are those of the chunk's `n`
    longest lanes. Same order as `lanes`."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    ro0 = lanes[0]
    axis, e1, e2 = (np.asarray(v, dtype=np.float64) for v in (spec.axis, spec.e1, spec.e2))
    half_chord = 0.5 * rng.uniform(0.05, 0.2, n)
    impact = np.sqrt(spec.inner * spec.inner - half_chord * half_chord)
    start = half_chord + spec.step_size * rng.uniform(20.0, 800.0, n)
    psi = rng.uniform(0.0, 2.0 * np.pi, n)
    u = np.cos(psi)[:, None] * e1 + np.sin(psi)[:, None] * e2
    normal = -np.sin(psi)[:, None] * e1 + np.cos(psi)[:, None] * e2
    h = spec.thickness * rng.uniform(-0.3, 0.3, n)
    ro = impact[:, None] * normal - start[:, None] * u + h[:, None] * axis
    as_lane = lambda v: torch.as_tensor(v, dtype=ro0.dtype, device=ro0.device).contiguous()
    return (as_lane(ro), as_lane(u), lanes[2][-n:].clone(), lanes[3][-n:].clone(), lanes[4][-n:].clone(),
            torch.ones(n, dtype=torch.bool, device=ro0.device),
            torch.full((n,), spec.step_size * spec.max_steps, dtype=ro0.dtype, device=ro0.device))


def compare_raymarch(dtype, ops):
    """K5 against its plain version on the volumetric lanes of the main
    path's middle chunk (the kerr-volumetric-streaky 500² frame), both with
    the march budget cut to VOL_COMPARE_STEPS samples, with
    `hole_crossing_lanes` added, of which some must take next_k's hole
    jump; then K5 alone at the scene's full budget on the chunk's lanes.
    Returns a result dict."""
    import torch

    from gr_raytracer_tpu_torch.ops import volumetric_march as vm

    vol_spec, lanes, _ = vol_chunk_lanes(dtype)
    cut = vol_spec._replace(max_steps=VOL_COMPARE_STEPS)
    hole = hole_crossing_lanes(vol_spec, lanes)
    compared = tuple(torch.cat([a, b]) for a, b in zip(lanes, hole))
    vm.raymarch(cut, *compared)  # first launch: checks the kernel runs
    torch.cuda.synchronize()
    cut_ms, (got, n_got) = time_cuda(lambda: vm.raymarch(cut, *compared), reps=3)
    t0 = time.perf_counter()
    ref, n_ref = vm.raymarch_plain(cut, *compared)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    full_ms, (out, n_full) = time_cuda(lambda: vm.raymarch(vol_spec, *lanes), reps=3)
    tail = critical_path(lambda ins: vm.raymarch(vol_spec, *ins), lambda idx: gather_lanes(lanes, idx), n_full)

    n = lanes[0].shape[0]
    samples = int(n_full.long().sum())
    bound_ms, bound_by = raymarch_bound_ms(samples, n, ops, dtype)
    tone = lambda c: c / (1.0 + c)
    tone_err = (tone(got) - tone(ref)).abs().amax(dim=1)
    lane_err = lane_errors(got, ref)
    jumped = hole_jump_lanes(cut, compared, n_ref)
    r = {
        "kernel": "K5", "dtype": str(dtype).replace("torch.", ""), "lanes": n,
        "compare_budget": VOL_COMPARE_STEPS, "full_budget": vol_spec.max_steps,
        "bit_identical": bool(torch.equal(got, ref)) and bool(torch.equal(n_got, n_ref)),
        "samples_equal": float((n_got == n_ref).double().mean()),
        "compare_samples": int(n_ref.long().sum()), "compare_lanes_marched": int((n_ref[:n] > 0).sum()),
        "compare_lanes_hole_jump": int(jumped[:n].sum()), "hole_lanes": int(jumped.numel() - n),
        "hole_lanes_jumped": int(jumped[n:].sum()),
        "kernel_ms_compare_budget": cut_ms, "plain_ms": plain_ms,
        "kernel_ms": full_ms, "samples": samples, "max_samples": int(n_full.max()),
        "lanes_alpha_gt_0": int((out[:, 3] > 0).sum()), "finite": bool(torch.isfinite(out).all()),
        "samples_per_s": samples / (full_ms / 1e3), "bound_ms": bound_ms, "bound_by": bound_by,
        "lane_rel_err_max": float(lane_err.max()), "max_abs_err": float(tone_err.max()),
        "batch_use": batch_use(n_full), "critical_path": tail,
    }
    if dtype == torch.float64:
        r["lanes_within_tol"] = float((lane_err <= F64_RTOL).double().mean())
        ok = r["lanes_within_tol"] >= F64_STOP_AGREEMENT
    else:
        r["lanes_within_tol"] = float((tone_err <= F32_TONE_ATOL).double().mean())
        ok = r["lanes_within_tol"] >= F32_STOP_AGREEMENT
    r["ok"] = bool(ok and r["finite"] and r["lanes_alpha_gt_0"] > 0 and r["compare_lanes_marched"] > 0
                   and r["hole_lanes_jumped"] > 0)
    return r


def vol_frame_summary(out, png, size, total_s, ran, what, ops, use):
    """The checks and numbers of a volumetric CLI frame: horizon and sky
    rays, emitting K5 lanes, each kernel of `ran` (cli_render's) launched,
    its ms, K5's share of the frame and the batch use and longest lane of
    its launches (RaymarchSamples.batch_use), the rays re-traced because they
    overflowed their event slots, and (printed as a fault) those that
    overflow the re-trace's slots too."""
    import torch

    from gr_raytracer_tpu_torch.rendering.raytracer import OVERFLOW_MAX_EVENTS

    frame = check_frame(out, png, size, (1, 2), what)
    pass1, aa = out.stats["pass1"], out.stats["aa"]
    for label, (launches, _) in ran.items():
        if launches == 0:
            fail(f"{what}: the frame launched {label} no time")
    if pass1.vol_emitting == 0:
        fail(f"{what}: no raymarch lane emitted: {pass1}")
    # Rays that overflowed their 8 event slots were traced again with 32 on
    # the lax path, as the JAX driver does; a ray that overflows those too
    # keeps a truncated fold: a fault.
    from gr_raytracer_tpu_torch.rendering import integrator as integ

    overflow = pass1.overflow + aa.overflow
    dropped = pass1.overflow_dropped + aa.overflow_dropped
    retrace = {"rays": overflow, "accepted_steps": pass1.overflow_steps + aa.overflow_steps,
               "march_s": pass1.overflow_march_s + aa.overflow_march_s,
               "shade_s": pass1.overflow_shade_s + aa.overflow_shade_s,
               "loops": {k: v for k, v in integ.loop_stats.items()}, "still_overflowing": dropped}
    if dropped:
        print(f"chip_smoke: FAULT (ROADMAP Queue 3): {what}: {dropped} rays overflow "
              f"{OVERFLOW_MAX_EVENTS} event slots after their re-trace; their fold is truncated", flush=True)
    k5_launches, k5_ms = ran["K5"]
    samples = pass1.vol_samples + aa.vol_samples
    frame.update({
        "total_s": total_s, "scene_build_s": out.timings["scene_build"], "write_s": out.timings["write"],
        "vol_lanes_pass1": pass1.vol_lanes, "vol_lanes_aa": aa.vol_lanes,
        "vol_emitting_pass1": pass1.vol_emitting, "vol_emitting_aa": aa.vol_emitting,
        "vol_samples_pass1": pass1.vol_samples, "vol_samples_aa": aa.vol_samples,
        "overflow_retraced": overflow, "fault_overflow_truncated": dropped, "lax_retrace": retrace,
        "k5_launches": k5_launches, "k5_ms": k5_ms,
        "k5_share": k5_ms / 1e3 / total_s, "k5_samples_per_s": samples / max(k5_ms / 1e3, 1e-9),
        "k5_bound_ms": raymarch_bound_ms(samples, pass1.vol_lanes + aa.vol_lanes, ops, torch.float32)[0],
        "k5_batch_use": use,
    })
    for label, (launches, ms) in ran.items():
        if label != "K5":
            frame[f"{label.lower()}_launches"], frame[f"{label.lower()}_ms"] = launches, ms
    return frame


def vol_chunk_lanes(dtype):
    """(raymarch spec, lanes, the disc's [5] medium) of the volumetric slots
    of the middle 65,536 pixels of the 500² kerr-volumetric-streaky
    frame, compacted and sorted as the render does."""
    from gr_raytracer_tpu_torch import inverse
    from gr_raytracer_tpu_torch.rendering import fast_path

    scene, spec, y0, freq, solver, _ = chunk_inputs(dtype, VOL_TOML, VOL_FRAME, VOL_CAMERA_KW)
    res = fast_path._run_kernel(spec, scene.integration, solver, y0)
    _, lanes = fast_path.volumetric_lanes(scene.objects[0], res[3], res[4], freq.observer_energy, freq.p_t,
                                          freq.p_phi)
    return spec.vol_spec, lanes, inverse.disc_medium(scene.objects[0]).contiguous()


def compare_raymarch_raw(dtype, ops):
    """K6 against its plain version on phase 14's lanes, both with the march
    budget cut to VOL_COMPARE_STEPS samples; K6 alone at the scene's full
    budget, and its results combined (combine_alpha) against K5's XYZA on
    the same lanes. Returns a result dict."""
    import torch

    from gr_raytracer_tpu_torch.ops import volumetric_adjoint as va
    from gr_raytracer_tpu_torch.ops import volumetric_march as vm

    vol_spec, lanes, med = vol_chunk_lanes(dtype)
    cut = vol_spec._replace(max_steps=VOL_COMPARE_STEPS)
    vm.raymarch_raw(cut, med, *lanes)  # first launch: checks the kernel runs
    torch.cuda.synchronize()
    cut_ms, got = time_cuda(lambda: vm.raymarch_raw(cut, med, *lanes), reps=3)
    t0 = time.perf_counter()
    ref = vm.raymarch_raw_plain(cut, med, *lanes)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    full_ms, full = time_cuda(lambda: vm.raymarch_raw(vol_spec, med, *lanes), reps=3)
    k5, n_full = vm.raymarch(vol_spec, *lanes)
    combined = va.combine_alpha(*full)

    stack = lambda r: torch.cat([r[0], torch.stack(r[1:], dim=1)], dim=1)
    lane_err = lane_errors(stack(got), stack(ref))
    tone = lambda c: c / (1.0 + c)
    n = lanes[0].shape[0]
    samples = int(n_full.long().sum())
    bound_ms, bound_by = raymarch_bound_ms(samples, n, ops, dtype, lane_bytes=17 * lanes[0].element_size())
    k5_err = (tone(combined) - tone(k5)).abs().amax(dim=1)
    r = {
        "kernel": "K6", "dtype": str(dtype).replace("torch.", ""), "lanes": n,
        "compare_budget": VOL_COMPARE_STEPS, "full_budget": vol_spec.max_steps,
        "bit_identical": all(bool(torch.equal(g, w)) for g, w in zip(got, ref)),
        "kernel_ms_compare_budget": cut_ms, "plain_ms": plain_ms, "kernel_ms": full_ms, "samples": samples,
        "samples_per_s": samples / (full_ms / 1e3), "bound_ms": bound_ms, "bound_by": bound_by,
        "lane_rel_err_max": float(lane_err.max()),
        "max_abs_err": float((tone(stack(got)) - tone(stack(ref))).abs().max()),
        "finite": all(bool(torch.isfinite(v).all()) for v in full),
        "k5_bit_identical": bool(torch.equal(combined, k5)),
        "k5_lanes_equal": float((combined == k5).all(dim=1).double().mean()),
        "k5_tone_err_max": float(k5_err.max()),
        "sigma_sum_in_dtype": float(med[2] + med[3]), "sigma_host": float(vol_spec.absorption + vol_spec.scattering),
    }
    if dtype == torch.float64:
        r["lanes_within_tol"] = float((lane_err <= F64_RTOL).double().mean())
        ok = r["lanes_within_tol"] >= F64_STOP_AGREEMENT and r["k5_bit_identical"]
    else:
        r["lanes_within_tol"] = float(((tone(stack(got)) - tone(stack(ref))).abs().amax(dim=1) <= F32_TONE_ATOL)
                                      .double().mean())
        ok = r["lanes_within_tol"] >= F32_STOP_AGREEMENT and r["k5_tone_err_max"] <= F32_TONE_ATOL
    r["ok"] = bool(ok and r["finite"])
    return r


def count_vol_bwd_ops():
    """Operations of one sample of the plain backward per lane, by class
    (count_ops): the forward optics and their torch.autograd VJP
    (ops/volumetric_adjoint.py _bwd_step), on the main path's spec."""
    import torch

    from gr_raytracer_tpu_torch import config
    from gr_raytracer_tpu_torch.ops import volumetric_adjoint as va
    from gr_raytracer_tpu_torch.ops import volumetric_march as vm
    from gr_raytracer_tpu_torch.rendering import fast_path

    f64 = torch.float64
    scene = config.create_scene(config.load_config(VOL_TOML), config.RenderOptions(width=4, height=4), f64,
                                torch.device("cpu"))
    spec = fast_path.scene_kernel_spec(scene).vol_spec
    one = lambda *v: torch.tensor([v], dtype=f64) if len(v) > 1 else torch.tensor(v, dtype=f64)
    lanes = va._BwdLanes(
        one(8.0, 1.0, 0.01), one(-0.6, 0.8, -0.01), one(1.0), one(1.0), one(0.1), one(5.0), one(1e30),
        one(-1e30), one(-1e30), torch.ones((1, va.CT_VARS), dtype=f64), one(10.0), one(1.0), one(0.0),
        torch.zeros(1, dtype=torch.bool), torch.zeros((1, va.DIN_VARS), dtype=f64),
        torch.zeros((1, va.N_MED), dtype=f64),
    )
    c = vm._constants(spec, f64, "cpu")
    med = vm._medium(spec, c, torch.tensor([spec.density_multiplier, spec.noise_offset, spec.absorption,
                                            spec.scattering, spec.brightness_ref], dtype=f64))
    return count_ops(lambda: va._bwd_step(spec, c, med, lanes))


def compare_vol_adjoint(dtype, ops):
    """K7 against its plain version on phase 14's lanes with seeded
    cotangents (numpy), both with the march budget cut to
    VOL_BWD_COMPARE_STEPS samples; then K7 alone at the scene's full budget.
    The bars are K2's (K2_BARS): d_in per lane against its largest entry,
    the five medium sums relative."""
    import numpy as np
    import torch

    from gr_raytracer_tpu_torch.ops import volumetric_adjoint as va
    from gr_raytracer_tpu_torch.ops import volumetric_march as vm

    vol_spec, lanes, med = vol_chunk_lanes(dtype)
    n = lanes[0].shape[0]
    ct = torch.as_tensor(np.random.default_rng(0).normal(size=(n, 6)), dtype=dtype, device="cuda")

    def cotangents(spec):
        acc, t_f, _, _ = vm.raymarch_raw(spec, med, *lanes)
        s_tot = torch.sum(ct[:, :3] * acc, dim=-1)
        return torch.cat([ct, s_tot[:, None], t_f[:, None]], dim=1).contiguous()

    cut = vol_spec._replace(max_steps=VOL_BWD_COMPARE_STEPS)
    cts = cotangents(cut)
    va.vol_march_bwd(cut, med, *lanes, cts)  # first launch: checks the kernel runs
    torch.cuda.synchronize()
    cut_ms, got = time_cuda(lambda: va.vol_march_bwd(cut, med, *lanes, cts), reps=2)
    t0 = time.perf_counter()
    ref = va.vol_march_bwd_plain(cut, med, *lanes, cts)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    n_cut = vm.raymarch(cut, *lanes)[1]
    cts_full = cotangents(vol_spec)
    full_ms, out = time_cuda(lambda: va.vol_march_bwd(vol_spec, med, *lanes, cts_full), reps=2)
    n_full = vm.raymarch(vol_spec, *lanes)[1]

    lane = lane_errors(got[0], ref[0])
    sums = [float(v) for v in got[1].double().sum(0)], [float(v) for v in ref[1].double().sum(0)]
    sum_err = max(abs(g - r) / max(abs(r), 1e-300) for g, r in zip(*sums))
    name = str(dtype).replace("torch.", "")
    lane_tol, share, sum_tol = K2_BARS[name]
    samples = int(n_full.long().sum())
    bound_ms, bound_by = raymarch_bound_ms(samples, n, ops, dtype, lane_bytes=33 * lanes[0].element_size())
    res = {
        "kernel": "K7", "dtype": name, "lanes": n, "compare_budget": VOL_BWD_COMPARE_STEPS,
        "full_budget": vol_spec.max_steps, "compare_samples": int(n_cut.long().sum()),
        "kernel_ms_compare_budget": cut_ms, "plain_ms": plain_ms,
        "plain_ms_per_sample": plain_ms / max(int(n_cut.max()), 1),
        "kernel_ms": full_ms, "samples": samples, "samples_per_s": samples / (full_ms / 1e3),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "lanes_within_tol": float((lane <= lane_tol).double().mean()),
        "lane_rel_err_max": float(lane.max()), "lane_rel_err_q999": float(torch.quantile(lane.double(), 0.999)),
        "max_abs_err": max(float((g - r).abs().max()) for g, r in zip(got, ref)),
        "med_sums": sums[0], "med_sums_plain": sums[1], "med_sum_rel_err": sum_err,
        "finite": all(bool(torch.isfinite(v).all()) for v in out),
    }
    res["ok"] = res["lanes_within_tol"] >= share and sum_err <= sum_tol and res["finite"]
    return res


def k7_fd_check():
    """Phase 18b: K7's five medium sums in float64 on phase 14's lanes at
    the scene's full budget against central differences of K6 on the same
    lanes: L = Σ ct·(acc, T_f, Ws, Wt) with phase 18's seeded cotangents,
    a step of VOL_FD_STEP times each parameter.

    The march's exit step is locally constant in the gradient (as in the
    JAX package), but a parameter that moves a lane's transparency moves
    its saturation step, and there the alpha weights Ws and Wt, which do
    not fade with the transparency, jump by a sample's ρ·d_s. So each
    parameter's difference is taken over the lanes whose sample count (K5
    at the same medium: in float64 K5 and K6 march bit-identically) is the
    same at both steps as at the centre, as phase 29 drops the pixels with
    a texel jump; the difference over every lane is printed beside it. So
    that this cannot hide a fault, no parameter may leave out more than
    VOL_FD_EXIT_MOVED_CAP of the marching lanes."""
    import numpy as np
    import torch

    from gr_raytracer_tpu_torch.ops import volumetric_adjoint as va
    from gr_raytracer_tpu_torch.ops import volumetric_march as vm

    dtype = torch.float64
    vol_spec, lanes, med = vol_chunk_lanes(dtype)
    n = lanes[0].shape[0]
    ct = torch.as_tensor(np.random.default_rng(0).normal(size=(n, 6)), dtype=dtype, device="cuda")
    fields = ("density_multiplier", "noise_offset", "absorption", "scattering", "brightness_ref")

    def per_lane_loss(m):
        acc, t_f, ws, wt = vm.raymarch_raw(vol_spec, m, *lanes)
        raw = torch.cat([acc, t_f[:, None], ws[:, None], wt[:, None]], dim=1)
        return torch.sum(ct * raw, dim=1), acc, t_f

    def samples_at(m):
        spec = vol_spec._replace(**{f: float(v) for f, v in zip(fields, m.tolist())})
        return vm.raymarch(spec, *lanes)[1]

    _, acc, t_f = per_lane_loss(med)
    cts = torch.cat([ct, torch.sum(ct[:, :3] * acc, dim=-1)[:, None], t_f[:, None]], dim=1).contiguous()
    _, d_med = va.vol_march_bwd(vol_spec, med, *lanes, cts)
    centre = samples_at(med)
    marching = int((centre > 0).sum())
    r = {"kernel": "K7", "check": "full-budget medium sums against central differences of K6", "dtype": "float64",
         "lanes": n, "budget": vol_spec.max_steps, "step": VOL_FD_STEP, "bar": VOL_FD_BAR,
         "names": list(vm.MED_NAMES), "k7_sums": [], "k6_central_differences": [], "rel_err": [],
         "marching_lanes": marching, "lanes_exit_moved_cap": VOL_FD_EXIT_MOVED_CAP * marching,
         "lanes_exit_moved": [], "all_lanes": {"k7_sums": [float(v) for v in d_med.sum(0)],
                                               "k6_central_differences": [], "rel_err": []}}
    for i in range(len(vm.MED_NAMES)):
        h = VOL_FD_STEP * abs(float(med[i]))
        step = torch.zeros_like(med)
        step[i] = h
        plus, minus = per_lane_loss(med + step)[0], per_lane_loss(med - step)[0]
        keep = (samples_at(med + step) == centre) & (samples_at(med - step) == centre)
        fd_all = float(torch.sum(plus - minus)) / (2.0 * h)
        fd = float(torch.sum((plus - minus)[keep])) / (2.0 * h)
        got = float(d_med[keep, i].sum())
        r["k7_sums"].append(got)
        r["k6_central_differences"].append(fd)
        r["rel_err"].append(abs(got - fd) / max(abs(fd), 1e-300))
        r["lanes_exit_moved"].append(int((~keep).sum()))
        r["all_lanes"]["k6_central_differences"].append(fd_all)
        r["all_lanes"]["rel_err"].append(abs(r["all_lanes"]["k7_sums"][i] - fd_all) / max(abs(fd_all), 1e-300))
    r["ok"] = (all(e <= VOL_FD_BAR for e in r["rel_err"]) and all(np.isfinite(r["k7_sums"]))
               and max(r["lanes_exit_moved"]) <= r["lanes_exit_moved_cap"])
    return r


def probe_loss(color):
    """scripts/grad_scale_probe.py --vol's loss: mean(log1p(max(c, 0))) over
    the XYZ channels."""
    import torch

    return torch.mean(torch.log1p(torch.clamp(color[:, :3], min=0.0)))


def vol_grad_scene(toml, size, camera, dt=None):
    """(scene, spec, x, p): `toml` at size² in `dt` (float32) with `camera`,
    budget MAX_STEPS, and its camera rays."""
    import torch

    from gr_raytracer_tpu_torch import config
    from gr_raytracer_tpu_torch.rendering import camera as cam
    from gr_raytracer_tpu_torch.rendering import fast_path

    dt = dt or torch.float32
    opts = config.RenderOptions(width=size, height=size, max_steps=MAX_STEPS, **camera)
    scene = config.create_scene(config.load_config(toml), opts, dt, torch.device("cuda"))
    rr, cc = torch.meshgrid(torch.arange(size, dtype=dt, device="cuda"),
                            torch.arange(size, dtype=dt, device="cuda"), indexing="ij")
    x, p = cam.pixel_rays(scene.camera, rr.ravel(), cc.ravel())
    if not fast_path.supports_vol_diff(scene):
        fail(f"{os.path.basename(toml)} is not a differentiable volumetric scene")
    return scene, fast_path.scene_kernel_spec(scene), x, p


def vol_value_and_grad(scene, spec, x, p):
    """One value and gradient of probe_loss over the disc's five medium
    parameters; returns (loss, {name: gradient}, seconds)."""
    import torch

    from gr_raytracer_tpu_torch import inverse
    from gr_raytracer_tpu_torch.ops import volumetric_march as vm
    from gr_raytracer_tpu_torch.rendering import fast_path

    med = inverse.disc_medium(scene.objects[0]).requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = probe_loss(fast_path.trace_rays_fast_vol_diff(scene, med, x, p, spec).color)
    (g,) = torch.autograd.grad(loss, med)
    torch.cuda.synchronize()
    return float(loss), dict(zip(vm.MED_NAMES, (float(v) for v in g))), time.perf_counter() - t0


def vol_fit_phase():
    """The volumetric gradient path of grad_scale_probe.py --vol on the card
    (kerr-volumetric-streaky at 256², float32): one value and gradient of
    its loss over the five medium parameters, then the first VOL_FIT_STEPS
    steps of its density_multiplier and absorption fit through inverse.fit;
    returns its summary."""
    import math

    import torch

    from gr_raytracer_tpu_torch import inverse
    from gr_raytracer_tpu_torch.ops import geodesic_march as gm
    from gr_raytracer_tpu_torch.ops import volumetric_adjoint as va
    from gr_raytracer_tpu_torch.ops import volumetric_march as vm
    from gr_raytracer_tpu_torch.rendering import fast_path

    scene, spec, x, p = vol_grad_scene(VOL_TOML, VOL_FIT_SIZE, VOL_CAMERA_KW)
    # K5's batch use on the frame's lanes (the samples it marches for the
    # disc's own medium).
    with torch.no_grad():
        g = fast_path.trace_geometric_fast(scene, x, p, spec)
        _, lanes = fast_path.volumetric_lanes(scene.objects[0], g.ev_kind, g.ev_data, g.observer_energy, g.p_t,
                                              g.p_phi)
        fit_batch_use = batch_use(vm.raymarch(spec.vol_spec, *lanes)[1])
    gm.launches = vm.raw_launches = va.launches = 0
    vm.raw_launch_timer, va.launch_timer = [], []
    loss, grads, grad_s = vol_value_and_grad(scene, spec, x, p)
    ms = lambda timer: sum(s.elapsed_time(e) for s, e in timer)
    vg = {"frame": f"{VOL_FIT_SIZE}x{VOL_FIT_SIZE}", "loss": loss, "grads": grads, "s": grad_s,
          "k1_launches": gm.launches, "k6_launches": vm.raw_launches, "k7_launches": va.launches,
          "k6_ms": ms(vm.raw_launch_timer), "k7_ms": ms(va.launch_timer)}
    print(json.dumps({"value_and_grad": vg}), flush=True)
    if not all(math.isfinite(v) for v in grads.values()) or not math.isfinite(loss):
        fail(f"a volumetric gradient is not finite: {vg}")
    if 0 in (vg["k1_launches"], vg["k6_launches"], vg["k7_launches"]):
        fail(f"the volumetric gradient launched K1, K6, K7 {vg['k1_launches']}, {vg['k6_launches']}, "
             f"{vg['k7_launches']} times")

    render = inverse.medium_render(scene, x, p, spec)
    obj = scene.objects[0]
    true = (float(obj.density_multiplier), float(obj.absorption))
    start = (true[0] * VOL_FIT_START[0], true[1] * VOL_FIT_START[1])
    as_params = lambda dm, ab: {"log_dm": torch.tensor(math.log(dm), dtype=torch.float32, device="cuda"),
                                "log_ab": torch.tensor(math.log(ab), dtype=torch.float32, device="cuda")}
    with torch.no_grad():
        target = render(as_params(*true))
    torch.cuda.synchronize()
    rows = []
    clock = [time.perf_counter()]

    def callback(step, loss, params, grads):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rows.append({
            "step": step, "loss": loss, "dm": math.exp(float(params["log_dm"].detach())),
            "ab": math.exp(float(params["log_ab"].detach())), "grads": {k: float(g) for k, g in grads.items()},
            "s": now - clock[0], "k6_ms": ms(vm.raw_launch_timer), "k7_ms": ms(va.launch_timer),
        })
        vm.raw_launch_timer.clear()
        va.launch_timer.clear()
        print(json.dumps(rows[-1]), flush=True)
        clock[0] = time.perf_counter()

    vm.raw_launch_timer.clear()
    va.launch_timer.clear()
    _, losses = inverse.fit(
        render, as_params(*start), target, trainable=("log_dm", "log_ab"), steps=VOL_FIT_STEPS,
        learning_rate=inverse.cosine_decay_schedule(*VOL_FIT_SCHEDULE), clip_norm=1.0, callback=callback,
    )
    launches = {"k1": gm.launches, "k6": vm.raw_launches, "k7": va.launches}
    vm.raw_launch_timer = va.launch_timer = None
    split, busy = fit_step_breakdown(lambda prm, mark: render(prm), inverse.image_loss, target,
                                     as_params(*start))
    mean = lambda key: sum(r[key] for r in rows) / len(rows)
    final = (rows[-1]["dm"], rows[-1]["ab"])
    summary = {
        "frame": f"{VOL_FIT_SIZE}x{VOL_FIT_SIZE}", "max_steps": MAX_STEPS, "steps": VOL_FIT_STEPS,
        "schedule": VOL_FIT_SCHEDULE, "true": true, "start": start, "final": final,
        "loss_first": losses[0], "loss_last": losses[-1], "launches": launches,
        "s_per_step": mean("s"), "k6_ms_per_step": mean("k6_ms"), "k7_ms_per_step": mean("k7_ms"),
        "step_breakdown_s": split, "device_busy_share": busy, "value_and_grad": vg,
        "k5_batch_use": fit_batch_use, "vol_lanes": int(lanes[0].shape[0]),
    }
    if not all(math.isfinite(g) for r in rows for g in r["grads"].values()):
        fail(f"a volumetric fit gradient is not finite: {rows}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"the volumetric fit's loss did not fall: {losses}")
    for name, got, want, was in zip(("density_multiplier", "absorption"), final, true, start):
        if not abs(got - want) < abs(was - want):
            fail(f"the volumetric fit's {name} did not move toward {want}: {was} -> {got}")
    return summary


def sphere_march_phases():
    """Phases 21 and 22: K1 and K3 with sphere events against their plain
    versions; returns {(kernel, chunk, dtype): result}."""
    import math

    import torch

    from gr_raytracer_tpu_torch.ops import geodesic_march as gm

    phase("21. K1 with sphere events against its plain version")
    sphere_marches = {}
    with tempfile.TemporaryDirectory() as tmp:
        test_tomls = {}
        for name, text in SPHERE_TEST_SCENES.items():
            test_tomls[name] = os.path.join(tmp, name)
            with open(test_tomls[name], "w") as f:
                f.write(text)
        # The step's operations with the scene's one sphere's candidate test.
        one_sphere = (gm.SphereSpec(2.0, 0.0, 0.0, 0.0, 1),)
        sphere_flops = count_step_flops(one_sphere)
        bl_sphere_flops = count_bl_step_flops(one_sphere)
        print(f"flops per ray-step with one sphere (plain step, counted): K1 {sphere_flops}, K3 {bl_sphere_flops}")
        k1_chunks = (("kerr-sphere.toml", dict(toml=KERR_SPHERE_TOML, camera=KERR_CAMERA_KW)),
                     ("test scene", dict(toml=test_tomls["kerr-sphere-test-scene.toml"], camera=KERR_CAMERA_KW,
                                         options=SPHERE_TEST_OPTIONS)))
        for label, chunk in k1_chunks:
            for dtype in (torch.float32, torch.float64):
                r = compare_march(dtype, False, sphere_flops, **chunk)
                sphere_marches[("K1", label, dtype)] = r
                print(json.dumps(r), flush=True)
                if not (r["ok"] and r["sphere_events"] > 0):
                    fail(f"K1 with sphere events disagrees with its plain version or saw no sphere: {r}")

        phase("22. K3 with sphere events against its plain version")
        # schwarzschild.toml's chunk compares its first
        # SCHWARZSCHILD_COMPARE_ATTEMPTS steps, the test scene's f32 variant
        # its whole budget and its f64 one its first BL_COMPARE_ATTEMPTS.
        sch_camera = dict(BL_CAMERA_KW, theta=-math.pi)
        k3_chunks = (("schwarzschild.toml", dict(toml=SCHWARZSCHILD_TOML, camera=BL_CAMERA_KW,
                                                  first=SCHWARZSCHILD_CHUNK_FIRST)),
                     ("test scene", dict(toml=test_tomls["schwarzschild-sphere-test-scene.toml"], camera=sch_camera,
                                         options=SPHERE_TEST_OPTIONS)))
        for label, chunk in k3_chunks:
            for dtype in (torch.float32, torch.float64):
                if label == "test scene":
                    attempts = None if dtype == torch.float32 else BL_COMPARE_ATTEMPTS
                else:
                    attempts = SCHWARZSCHILD_COMPARE_ATTEMPTS
                r = compare_march(dtype, False, bl_sphere_flops, bl=True, attempts=attempts, **chunk)
                sphere_marches[("K3", label, dtype)] = r
                print(json.dumps(r), flush=True)
                if not (r["ok"] and r["sphere_events"] > 0):
                    fail(f"K3 with sphere events disagrees with its plain version or saw no sphere: {r}")

    return sphere_marches


def sphere_render_phases(k1_step=None):
    """Phases 23-25: the CLI renders of the sphere scenes (a K1 launch
    table with the issue share of `k1_step` instructions a step); returns
    {scene file: summary}."""
    from gr_raytracer_tpu_torch.ops import geodesic_march as gm

    sphere_renders = {}
    for number, (name, toml, size, camera, label) in enumerate((
        ("schwarzschild.toml", SCHWARZSCHILD_TOML, FRAME, BL_CAMERA, "K3"),
        ("kerr-sphere.toml", KERR_SPHERE_TOML, FRAME, CAMERA, "K1"),
        ("schwarzschild-sphere.toml", SCHWARZSCHILD_SPHERE_TOML, SPHERE_SMALL_FRAME, BL_CAMERA, "K3"),
    ), start=23):
        phase(f"{number}. sphere path: CLI render of {name}")
        counter = ("K3", gm, "bl_launches") if label == "K3" else ("K1", gm, "launches")
        with tempfile.TemporaryDirectory() as tmp, Slot0Kinds() as slot0, K3Launches() as k3, K1Launches() as k1:
            png = os.path.join(tmp, name.replace(".toml", ".png"))
            out, total_s, ran = cli_render(toml, size, camera, png, (counter,))
            # Flat scenes (r_s = 0) have no horizon.
            codes = (1, 2, 7) if name == "schwarzschild.toml" else (2, 7)
            summary = check_frame(out, png, size, codes, name)
        k_launches, k_ms = ran[label]
        none, disc_hits, sphere_hits = slot0.by_kind()
        summary.update({"scene": name, "max_steps": MAX_STEPS, "total_s": total_s,
                        "scene_build_s": out.timings["scene_build"], "write_s": out.timings["write"],
                        "kernel": label, "launches": k_launches, "kernel_ms": k_ms,
                        "kernel_share": k_ms / 1e3 / total_s, "slot0_sphere_hits": sphere_hits,
                        "slot0_disc_hits": disc_hits, "slot0_no_event": none})
        if label == "K3":
            summary["k3_launch_table"] = k3.table()
        else:
            summary["k1_launch_table"] = k1.table(k1_step)
        sphere_renders[name] = summary
        print(json.dumps(summary), flush=True)
        if k_launches == 0:
            fail(f"the {name} render launched {label} no time")
        if (disc_hits if name == "schwarzschild.toml" else sphere_hits) == 0:
            fail(f"the {name} frame holds no {'disc' if name == 'schwarzschild.toml' else 'sphere'} hit: {summary}")

    return sphere_renders


def f64_gradient_phase(vol_fit):
    """Phase 26: phase 19's value and gradient in float64 beside its
    float32 one (`vol_fit`) and the JAX package's; returns the summary."""
    import math

    import torch

    from gr_raytracer_tpu_torch.ops import volumetric_march as vm

    phase("26. the volumetric value and gradient of phase 19 in float64")
    scene, spec, x, p = vol_grad_scene(VOL_TOML, VOL_FIT_SIZE, VOL_CAMERA_KW, torch.float64)
    loss64, grads64, s64 = vol_value_and_grad(scene, spec, x, p)
    with open(os.path.join(HERE, "docs", "gradient_bench.json")) as f:
        jax_tpu = json.load(f)["volumetric"]
    f32 = vol_fit["value_and_grad"]
    grad64 = {
        "frame": f"{VOL_FIT_SIZE}x{VOL_FIT_SIZE}", "s": s64,
        "loss": {"f64": loss64, "f32": f32["loss"], "jax_tpu_f32": jax_tpu["loss"]},
        "grads": {name: {"f64": grads64[name], "f32": f32["grads"][name], "jax_tpu_f32": jax_tpu["grads"][name],
                         "f64_over_jax": grads64[name] / jax_tpu["grads"][name]} for name in vm.MED_NAMES},
    }
    # Where the two types part: the forward frame of each (no gradient),
    # its volumetric lanes, samples and loss, and the pixels' agreement.
    from gr_raytracer_tpu_torch.rendering import fast_path

    frames = {}
    with torch.no_grad():
        for dt in (torch.float32, torch.float64):
            sc, sp, xx, pp = vol_grad_scene(VOL_TOML, VOL_FIT_SIZE, VOL_CAMERA_KW, dt)
            vt = fast_path.trace_rays_fast_vol(sc, xx, pp, sp)
            frames[dt] = vt.samples
            # Lanes whose exit from the bounding volume is found at their
            # entry point (within 1e-6): they march no sample.
            g = fast_path.trace_geometric_fast(sc, xx, pp, sp)
            _, lanes = fast_path.volumetric_lanes(sc.objects[0], g.ev_kind, g.ev_data, g.observer_energy, g.p_t,
                                                  g.p_phi)
            grad64.setdefault("frames", {})[str(dt).replace("torch.", "")] = {
                "loss": float(probe_loss(vt.samples.color)), "vol_lanes": vt.lanes, "samples": int(vt.marched),
                "emitting": int(vt.emitting), "exit_at_entry": int((lanes[6] < 1e-6).sum()),
                "stops": torch.bincount(vt.samples.stop_code, minlength=8).tolist(),
            }
    tone = lambda c: (c[:, :3] / (1.0 + c[:, :3])).double()
    diff = (tone(frames[torch.float32].color) - tone(frames[torch.float64].color)).abs().amax(dim=1)
    grad64["pixels"] = {
        "within_1e-3": float((diff <= 1e-3).double().mean()), "q50": float(diff.quantile(0.5)),
        "q99": float(diff.quantile(0.99)), "max": float(diff.max()),
        "same_stop": float((frames[torch.float32].stop_code == frames[torch.float64].stop_code).double().mean()),
    }
    print(json.dumps({"value_and_grad_f64": grad64}), flush=True)
    if not (math.isfinite(loss64) and all(math.isfinite(v) for v in grads64.values())):
        fail(f"a float64 volumetric gradient is not finite: {grad64}")
    return grad64


def sphere_renderer(dtype):
    """(render, params) of the sphere gradient path in `dtype`: render(p)
    gives the RaySamples of the 256² Kerr disc and sphere frame through
    trace_rays_fast_diff at p = {radius, a, dth} (dth tilts the camera
    rays' θ); params(a, grad) gives p at the target radius, spin a and
    dth = 0."""
    import dataclasses

    import torch

    from gr_raytracer_tpu_torch.geometry.kerr import Kerr
    from gr_raytracer_tpu_torch.rendering import fast_path

    scene, spec, x0, p0 = sphere_fit_scene(dtype)
    horizon_eps = scene.geometry.horizon_epsilon

    def render(p, mark=lambda name: None):
        geometry = Kerr(radius=p["radius"], a=p["a"], horizon_epsilon=horizon_eps)
        x = torch.cat([x0[:, :2], (x0[:, 2] + p["dth"])[:, None], x0[:, 3:]], dim=1)
        mark("scene_build")
        return fast_path.trace_rays_fast_diff(dataclasses.replace(scene, geometry=geometry), x, p0, spec=spec,
                                              k_ckpt=K_CKPT)

    def params(a, grad=False):
        value = {"radius": SPHERE_FIT_HOLE[0], "a": a, "dth": 0.0}
        return {k: torch.tensor(v, dtype=dtype, device="cuda", requires_grad=grad) for k, v in value.items()}

    return render, params


def sphere_gradient_check():
    """Phase 29's check of the gradient's value. image_loss of the target
    parameters' float32 render against the fit's target must be 0. At the
    fit's start (a = SPHERE_FIT_START), ∂a, ∂radius and ∂dth of image_loss
    over the pixels that are smooth in every parameter are held against
    a central difference of the float64 render, step SPHERE_FD_STEP. A
    pixel is smooth when its ray class, stop code and step count are the
    same in every render below and its own central difference at the step
    and at a tenth of it agree to 1e-3 (a texel or a class that changes
    within the step is a jump, which the gradient leaves out). Bars: the
    float64 gradient relative to the difference, the float32 one relative
    to the mean |per-pixel term| of the difference (the sum cancels)."""
    import math

    import torch

    from gr_raytracer_tpu_torch import inverse

    keys = ("a", "radius", "dth")
    steps = (SPHERE_FD_STEP, SPHERE_FD_STEP / 10)
    renders = {dt: sphere_renderer(dt) for dt in (torch.float32, torch.float64)}
    targets, samples, leaves = {}, {}, {}
    for dt, (render, params) in renders.items():
        with torch.no_grad():
            targets[dt] = render(params(SPHERE_FIT_HOLE[1])).color
        leaves[dt] = params(SPHERE_FIT_START, grad=True)
        samples[dt] = render(leaves[dt])
    with torch.no_grad():
        render32, params32 = renders[torch.float32]
        loss_at_target = float(inverse.image_loss(render32(params32(SPHERE_FIT_HOLE[1])).color,
                                                  targets[torch.float32]))
        render64, params64 = renders[torch.float64]
        shifted = {}
        for k in keys:
            for h in steps:
                for sign in (1, -1):
                    p = params64(SPHERE_FIT_START)
                    p[k] = p[k] + sign * h
                    shifted[k, h, sign] = render64(p)
    # image_loss is the mean of these per-pixel terms.
    log_target = inverse.log_radiance(targets[torch.float64])
    term = lambda s: ((inverse.log_radiance(s.color) - log_target) ** 2).mean(dim=1)
    pixel_fd = {(k, h): (term(shifted[k, h, 1]) - term(shifted[k, h, -1])) / (2 * h) for k in keys for h in steps}
    struct = lambda s: torch.stack([s.ray_class.long(), s.stop_code.long(), s.steps.long()])
    ref = struct(samples[torch.float64])
    keep = torch.ones_like(ref[0], dtype=torch.bool)
    for s in (samples[torch.float32], *shifted.values()):
        keep &= (struct(s) == ref).all(dim=0)
    same_class = int(keep.sum())
    for k in keys:
        coarse, fine = pixel_fd[k, steps[0]], pixel_fd[k, steps[1]]
        keep &= (coarse - fine).abs() <= 1e-3 * torch.maximum(coarse.abs(), fine.abs())
    fd = {k: float(pixel_fd[k, steps[0]][keep].mean()) for k in keys}
    scale = {k: float(pixel_fd[k, steps[0]][keep].abs().mean()) for k in keys}
    res = {"loss_at_target_f32": loss_at_target, "a": SPHERE_FIT_START, "fd_step": SPHERE_FD_STEP,
           "pixels": int(keep.numel()), "pixels_same_class": same_class, "pixels_kept": int(keep.sum()),
           "central_difference_f64": fd, "mean_abs_pixel_term": scale}
    ok = loss_at_target == 0.0 and res["pixels_kept"] >= 0.99 * res["pixels"]
    for dt in (torch.float64, torch.float32):
        name = str(dt).replace("torch.", "")
        loss = inverse.image_loss(samples[dt].color[keep], targets[dt][keep])
        grads = dict(zip(keys, (float(g) for g in torch.autograd.grad(loss, [leaves[dt][k] for k in keys]))))
        against = fd if dt == torch.float64 else scale
        err = {k: abs(grads[k] - fd[k]) / max(abs(against[k]), 1e-300) for k in keys}
        res[f"grad_{name}"] = grads
        res[f"err_{name}"] = err
        ok = ok and all(math.isfinite(grads[k]) and err[k] <= SPHERE_FD_BARS[name] for k in keys)
    res["bars"] = SPHERE_FD_BARS
    res["ok"] = ok
    return res


def sphere_gradient_phases(k2_sass=None):
    """Phases 27-29: K1 with checkpoints and sphere events against its
    plain version, K2 with the sphere payload against its plain version
    (both with a checkpoint every SPHERE_K_CKPT steps, so that lanes
    reach later rows), and the Kerr disc and sphere gradient: its value
    against a central difference, then the 10-step spin fit (sphere_fit);
    `k2_sass` are phase 6's SASS counts of K2. Returns (K2's comparisons
    by dtype, the fit's summary)."""
    import torch

    phase("27. K1 with checkpoints and sphere events against its plain version")
    marches, sweeps = {}, {}
    for dtype in (torch.float32, torch.float64):
        r, marches[dtype], spec, _ = compare_march_ckpt(dtype, sphere=True, k_ckpt=SPHERE_K_CKPT)
        print(json.dumps(r), flush=True)
        if not r["ok"]:
            fail(f"K1 with checkpoints and sphere events disagrees with its plain version: {r}")
        if not (r["slot0_sphere"] > 0 and r["slot0_disc"] > 0):
            fail(f"slot 0 of the sphere frame lacks a sphere or a disc event: {r}")
        if not (r["ckpt_rows_reached"] > r["lanes"] and r["slot0_sphere_after_row0"] > 0
                and r["slot0_disc_after_row0"] > 0):
            fail(f"no lane of a kind reaches a checkpoint row after row 0 with its event: {r}")

    phase("28. K2 with the sphere payload against its plain version")
    sweep_flops = count_sweep_flops(spec.spheres)
    print(f"flops per ray of the sweep (re-forward step, reverse step, payload at the stored step; counted): "
          f"{json.dumps(sweep_flops)}")
    for dtype in (torch.float64, torch.float32):
        r = compare_adjoint(dtype, marches[dtype], spec, sweep_flops, k_ckpt=SPHERE_K_CKPT, sass=k2_sass)
        r["chunk"] = "kerr-sphere 256²"
        sweeps[dtype] = r
        print(json.dumps(r), flush=True)
        if not r["ok"]:
            fail(f"K2 with the sphere payload disagrees with its plain version: {r}")
        if not all(g["lanes"] > 0 for g in r["by_slot0_kind"].values()):
            fail(f"the K2 comparison lacks sphere or disc lanes: {r}")
    del marches

    phase("29. Kerr disc and sphere gradient path: its value, then 10 steps of the 256² spin fit")
    check = sphere_gradient_check()
    print(json.dumps({"gradient_check": check}), flush=True)
    if not check["ok"]:
        fail(f"the sphere gradient is not 0-loss at its target or disagrees with a central difference: {check}")
    fit = sphere_fit()
    return sweeps, fit


def sphere_fit():
    """Phase 29's spin fit: 10 steps of inverse.fit of the spin on the 256²
    Kerr disc and sphere frame in float32 (target a = 0.499, start 0.30,
    image_loss, Adam 5e-2); returns its summary."""
    import math

    import torch

    from gr_raytracer_tpu_torch import inverse
    from gr_raytracer_tpu_torch.ops import geodesic_adjoint as gadj
    from gr_raytracer_tpu_torch.ops import geodesic_march as gm

    dt = torch.float32
    sphere_render, as_params = sphere_renderer(dt)

    def render(p, mark=lambda name: None):
        return sphere_render(p, mark).color

    with torch.no_grad():
        target = render(as_params(SPHERE_FIT_HOLE[1]))
    torch.cuda.synchronize()
    rows = []
    clock = [time.perf_counter()]

    def callback(step, loss, params, grads):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rows.append({
            "step": step, "loss": loss, "a": float(params["a"].detach()),
            "grads": {k: float(g) for k, g in grads.items()}, "s": now - clock[0],
            "k1_ms": sum(s.elapsed_time(e) for s, e in gm.launch_timer),
            "k2_ms": sum(s.elapsed_time(e) for s, e in gadj.launch_timer),
        })
        gm.launch_timer.clear()
        gadj.launch_timer.clear()
        print(json.dumps(rows[-1]), flush=True)
        clock[0] = time.perf_counter()

    gm.launch_timer, gadj.launch_timer = [], []
    gm.launches = gadj.launches = 0
    _, losses = inverse.fit(render, as_params(SPHERE_FIT_START), target, trainable=("a",), steps=SPHERE_FIT_STEPS,
                            learning_rate=SPHERE_FIT_LR, loss_fn=inverse.image_loss, callback=callback)
    k1_launches, k2_launches = gm.launches, gadj.launches
    gm.launch_timer = gadj.launch_timer = None
    split, busy = fit_step_breakdown(render, inverse.image_loss, target, as_params(SPHERE_FIT_START))
    mean = lambda key: sum(r[key] for r in rows) / len(rows)
    fit = {
        "frame": f"{SPHERE_FIT_SIZE}x{SPHERE_FIT_SIZE}", "max_steps": SPHERE_FIT_BUDGET, "steps": SPHERE_FIT_STEPS,
        "k1_launches": k1_launches, "k2_launches": k2_launches, "loss_first": losses[0], "loss_last": losses[-1],
        "a_first": SPHERE_FIT_START, "a_last": rows[-1]["a"], "a_target": SPHERE_FIT_HOLE[1],
        "s_per_step": mean("s"), "k1_ms_per_step": mean("k1_ms"), "k2_ms_per_step": mean("k2_ms"),
        "step_breakdown_s": split, "device_busy_share": busy,
    }
    print(json.dumps(fit), flush=True)
    grads = [g for r in rows for g in r["grads"].values()]
    if not all(math.isfinite(g) for g in grads):
        fail(f"a sphere fit gradient is not finite: {rows}")
    if not all(any(r["grads"][k] != 0.0 for r in rows) for k in ("a", "radius", "dth")):
        fail(f"a sphere fit gradient is zero on every step: {rows}")
    if k1_launches == 0 or k2_launches == 0:
        fail(f"the sphere fit launched K1 {k1_launches} and K2 {k2_launches} times")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"the sphere fit's loss did not fall: {losses}")
    return fit


def compare_resume(bl):
    """Phase 30's check of one kernel: K1 on the kerr.toml chunk (K3 on the
    kerr-bl chunk), float32, in two legs against one shot, all three
    through fast_path._run_kernel with the scene's spec and integration
    settings (the construction of the JAX package's resume tests), and
    each leg against its plain version called with the same arguments."""
    import torch

    from gr_raytracer_tpu_torch.ops import geodesic_march as gm
    from gr_raytracer_tpu_torch.rendering import fast_path
    from gr_raytracer_tpu_torch.rendering import integrator as integ

    toml = KERR_BL_TOML if bl else KERR_TOML
    scene, spec, y0, _, solver, _ = chunk_inputs(torch.float32, toml, FRAME, BL_CAMERA_KW if bl else None)
    cfg = scene.integration
    if cfg.max_steps >= fast_path.DEEP_BUDGET_COMPENSATION:
        fail(f"the resume chunk's budget {cfg.max_steps} is compensated: legs would not be bit-identical")
    kw = dict(max_radius=cfg.max_radius, discs=spec.discs, spheres=spec.spheres, vols=spec.vols,
              opaque_stop=spec.opaque, max_events=cfg.max_events)
    if bl:
        args = (spec.radius, spec.a, spec.horizon_epsilon, y0, solver.e.contiguous(), solver.l_z.contiguous(),
                solver.q.contiguous())
        kw.update(h0=0.01, max_steps=2 * cfg.max_steps)
        plain = gm.march_bl_plain
    else:
        args = (spec.radius, spec.a, spec.horizon_epsilon, y0)
        kw.update(h0=1.0, max_steps=cfg.max_steps, r_safe=spec.r_safe)
        plain = gm.march_plain
    kernel = lambda **legs: fast_path._run_kernel(spec, cfg, solver, y0, **legs)
    same = lambda g, r: bool(((g == r) | (g.isnan() & r.isnan()) if g.is_floating_point() else (g == r)).all())
    kernel()
    one_ms, one = time_cuda(kernel, reps=3)
    attempts = int(one[2].max()) // 2

    def two_legs():
        first = kernel(attempts=attempts, finalize=False)
        return first, kernel(resume=first)

    legs_ms, (leg1, leg2) = time_cuda(two_legs, reps=3)
    res = {
        "kernel": "K3" if bl else "K1", "chunk": os.path.basename(toml), "dtype": "float32",
        "budget": kw["max_steps"], "slowest_lane_steps": int(one[2].max()), "attempts_leg1": attempts,
        "running_after_leg1": int((leg1[1] == integ.RUNNING).sum()), "one_shot_ms": one_ms, "two_legs_ms": legs_ms,
        "legs_equal_one_shot": all(same(g, r) for g, r in zip(leg2, one)),
    }
    # Each leg against its plain version. K1's plain march runs the legs
    # whole; K3's two legs of BL_RESUME_COMPARE_ATTEMPTS iterations each.
    if bl:
        a1 = a2 = BL_RESUME_COMPARE_ATTEMPTS
        k1 = kernel(attempts=a1, finalize=False)
        k2 = kernel(resume=k1, attempts=a2, finalize=False)
    else:
        a1, a2 = attempts, None
        k1, k2 = leg1, leg2
    t0 = time.perf_counter()
    p1 = plain(*args, **kw, attempts=a1, finalize=False)
    p2 = plain(*args, **kw, resume=p1, attempts=a2, finalize=a2 is None)
    torch.cuda.synchronize()
    res["plain_legs"] = {
        "attempts": [a1, a2 if a2 is not None else kw["max_steps"]], "plain_ms": (time.perf_counter() - t0) * 1e3,
        "running_after_leg2": int((p2[1] == integ.RUNNING).sum()),
        "leg1_equal": all(same(g, r) for g, r in zip(k1, p1)), "leg2_equal": all(same(g, r) for g, r in zip(k2, p2)),
    }
    res["ok"] = (res["legs_equal_one_shot"] and res["running_after_leg1"] > 0 and res["plain_legs"]["leg1_equal"]
                 and res["plain_legs"]["leg2_equal"])
    return res


def resume_phase():
    """Phase 30: `resume` in K1 and K3; returns {kernel: result}."""
    phase("30. resume: K1 and K3 in two legs against one shot")
    out = {}
    for bl in (False, True):
        r = compare_resume(bl)
        out[r["kernel"]] = r
        print(json.dumps(r), flush=True)
        if not r["ok"]:
            fail(f"{r['kernel']} in two resumed legs disagrees with one shot or with its plain version: {r}")
    return out


# ---------------------------------------------------------------------------
# Phases 33-35: the RKF45 ("lax") path
# ---------------------------------------------------------------------------


def lax_scene(toml, size, camera_kw, dtype, device="cuda", objects=None):
    """The scene the CLI builds for `toml` at size², with phase 33's sky
    radius LAX_MAX_RADIUS and budget LAX_MAX_STEPS."""
    import torch

    from gr_raytracer_tpu_torch import config as tcfg

    opts = tcfg.RenderOptions(width=size, height=size, max_steps=LAX_MAX_STEPS, max_radius=LAX_MAX_RADIUS,
                              **camera_kw)
    cfg = tcfg.load_config(toml)
    if objects is not None:
        cfg = dataclasses.replace(cfg, objects=objects)
    return tcfg.create_scene(cfg, opts, dtype, torch.device(device))


class ChunkOutputs:
    """Records the host results of every chunk the renders inside the block
    trace (by wrapping raytracer._trace_chunk and trace_pixels_chunked):
    per traced pass, its pixel coordinates and the chunks' (stop code,
    ray class, steps) in ray order."""

    def __enter__(self):
        from gr_raytracer_tpu_torch.rendering import raytracer as rt

        self.rt, self.inner_chunk, self.inner_trace = rt, rt._trace_chunk, rt.trace_pixels_chunked
        self.passes = []

        def chunk(scene, spec, row_f, col_f):
            outs, lanes = self.inner_chunk(scene, spec, row_f, col_f)
            self.passes[-1]["chunks"].append((outs[2].cpu(), outs[1].cpu(), outs[4].cpu()))
            return outs, lanes

        def trace(scene, row_f, col_f, chunk_size, progress=False, lax=False):
            self.passes.append({"rows": row_f, "cols": col_f, "chunks": []})
            return self.inner_trace(scene, row_f, col_f, chunk_size, progress, lax)

        rt._trace_chunk, rt.trace_pixels_chunked = chunk, trace
        return self

    def __exit__(self, *exc):
        self.rt._trace_chunk, self.rt.trace_pixels_chunked = self.inner_chunk, self.inner_trace

    def pass1(self):
        """(stop codes, ray classes, steps) of the first traced pass."""
        import torch

        return [torch.cat(v) for v in zip(*self.passes[0]["chunks"])]


def tone_q99(a, b):
    """q99 over pixels of the largest per-channel difference of the
    tone-mapped XYZ c/(1+c) (F32_TONE_ATOL's measure)."""
    import numpy as np

    tone = lambda c: c[..., :3] / (1.0 + c[..., :3])
    err = np.abs(tone(np.asarray(a, np.float64)) - tone(np.asarray(b, np.float64))).max(axis=-1)
    if err.size == 0:
        return 0.0, 0.0
    return float(np.quantile(err, 0.99)), float(err.max())


def stop_agreement(stop_kernel, stop_lax, class_lax):
    """Per-ray agreement of the kernel-against-lax bar: stop codes equal; a
    kernel SATURATED ray agrees iff the lax path classifies it HIT
    (tests/test_pallas.py stop_agree_mask, docs/fastpath_accuracy.md); a lax
    BUDGET ray agrees only where the kernel says HORIZON (both render
    Captured). Every other ray disagrees."""
    sat = stop_kernel == 7
    return (stop_kernel == stop_lax) | (sat & (class_lax == 2)) | ((stop_lax == 5) & (stop_kernel == 1))


def render_outcome(stop, klass):
    """What a ray renders, to settle a disputed ray by: -1 where the kernel
    stopped it at an opaque first hit (SATURATED: it renders that hit),
    else its ray class plus 3 if it ends on the sky."""
    import numpy as np

    return np.where(stop == 7, -1, klass + 3 * (stop == 2))


def same_outcome(a, b):
    """render_outcome equality, an opaque first hit (-1) matching any ray
    classified HIT."""
    hit = lambda o: (o == -1) | ((o >= 0) & (o % 3 == 2))
    return (a == b) | (hit(a) & hit(b) & ((a == -1) | (b == -1)))


def lax_reference(ref_scene, rows, cols, disputed, kernel, lax):
    """The rays where the kernel and the float32 lax frame disagree
    (`disputed`, at most LAX_REF_RAYS of them, a seeded sample beyond),
    re-traced through the lax path in float64, the precision of the
    reference behind the kernel-against-lax bar (docs/fastpath_accuracy.md:3).
    `kernel` and `lax` are the frames' (stop codes, ray classes). A ray is
    counted for the lax frame where its float64 render_outcome is the lax
    frame's and not the kernel's, for the kernel the other way round, else
    for neither; counts over the whole frame are the sample's, scaled."""
    import numpy as np
    import torch

    idx = np.nonzero(disputed)[0]
    if idx.size > LAX_REF_RAYS:
        idx = np.sort(np.random.default_rng(LAX_REF_SEED).choice(idx, LAX_REF_RAYS, replace=False))
    r = {"disputed": int(disputed.sum()), "retraced": int(idx.size)}
    if not idx.size:
        return dict(r, for_lax=0.0, for_kernel=0.0, neither=0.0, seconds=0.0)
    scene = ref_scene()
    dev = scene.camera.position.device
    t0 = time.perf_counter()
    _, s = lax_trace(scene, torch.as_tensor(np.asarray(rows)[idx], device=dev, dtype=torch.float64),
                     torch.as_tensor(np.asarray(cols)[idx], device=dev, dtype=torch.float64))
    stop_ref = s.stop_code.cpu().numpy()
    ref = render_outcome(stop_ref, s.ray_class.cpu().numpy())
    k, l = (render_outcome(stop[idx], klass[idx]) for stop, klass in (kernel, lax))
    for_lax = same_outcome(ref, l) & ~same_outcome(ref, k)
    for_kernel = same_outcome(ref, k) & ~same_outcome(ref, l)
    scale = r["disputed"] / idx.size
    return dict(r, for_lax=float(for_lax.sum() * scale), for_kernel=float(for_kernel.sum() * scale),
                neither=float((~for_lax & ~for_kernel).sum() * scale), seconds=time.perf_counter() - t0,
                ref_stop_counts=np.bincount(stop_ref, minlength=8).tolist(),
                lax_stop_counts=np.bincount(lax[0][idx], minlength=8).tolist(),
                kernel_stop_counts=np.bincount(kernel[0][idx], minlength=8).tolist())


def lax_render(scene, what):
    """render_section(..., lax=True) of `scene`, timed: (RenderOutput, its
    summary, ChunkOutputs)."""
    import torch

    from gr_raytracer_tpu_torch.rendering import integrator as integ
    from gr_raytracer_tpu_torch.rendering import raytracer as rt

    integ.loop_stats.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with ChunkOutputs() as chunks:
        t0 = time.perf_counter()
        out = rt.render_section(scene, lax=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    pass1, aa = out.stats["pass1"], out.stats.get("aa")
    rays = pass1.rays + (aa.rays if aa else 0)
    steps = pass1.ray_steps + (aa.ray_steps if aa else 0)
    march = integ.loop_stats.get("march", {})
    stops, classes, lane_steps = chunks.pass1()
    summary = {
        "scene": what, "frame": f"{scene.camera.rows}x{scene.camera.columns}", "route": rt._route(scene, True),
        "seconds": secs, "pass1_s": pass1.seconds, "aa_s": aa.seconds if aa else 0.0,
        "rays": rays, "rays_per_s": rays / secs, "accepted_steps": steps,
        "accepted_steps_per_s": steps / secs, "longest_lane_pass1": int(lane_steps.max()),
        "iterations": march.get("iterations"), "compactions": march.get("blocks"),
        "lane_iterations": march.get("lane_iterations"),
        "ms_per_iteration": 1e3 * march.get("seconds", 0.0) / max(march.get("iterations", 1), 1),
        "raymarch": integ.loop_stats.get("raymarch"),
        "requeue_phases": integ.loop_stats.get("requeue_phases", 0),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "stop_counts_pass1": pass1.stop_counts.tolist(), "overflow": pass1.overflow + (aa.overflow if aa else 0),
    }
    return out, summary, chunks


def kernel_frame(scene):
    """The kernel path's render_section of `scene` and its pass-1 stop
    codes and ray classes."""
    from gr_raytracer_tpu_torch.rendering import raytracer as rt

    with ChunkOutputs() as chunks:
        out = rt.render_section(scene)
    stop, klass, _ = chunks.pass1()
    return out, stop.numpy(), klass.numpy()


def lax_against_kernel(kernel, lax, rows, cols, ref_scene, what):
    """The kernel-against-lax bar on a frame's pass 1: `kernel` and `lax`
    are (stop codes, ray classes, colors) of the same rays at (rows, cols).
    Prints the stop agreement (stop_agreement) and the tone-mapped q99 over
    the rays (and over the rays whose kernel ray does not end on the sky).
    Held: the stop agreement with the disputed rays that the float64 lax
    path settles for the lax frame (lax_reference: what they render), ≥
    99 %: a ray where the float32 lax frame is at fault counts against
    it, the kernel's own errors do not. The tone half of the bar is not held: the two
    integrators reach an object or the sky sphere at points a fixed step
    and an adaptive one place apart, and a bitmap texture's detail (the
    skies of all four frames, schwarzschild.toml's disc and sphere)
    turns that into tone differences above 0.01 at q99 (on an H100: 0.13-0.35
    over the frames, 0.020-0.25 off the sky; the study behind the bar had
    a checker sky, docs/fastpath_accuracy.md)."""
    import numpy as np

    (stop_k, class_k, color_k), (stop_l, class_l, color_l) = kernel, lax
    agree = stop_agreement(stop_k, stop_l, class_l)
    ref = lax_reference(ref_scene, rows, cols, ~agree, (stop_k, class_k), (stop_l, class_l))
    q99, worst = tone_q99(color_l, color_k)
    sky = (stop_k == 2).reshape(np.shape(color_k)[:-1])
    q99_off_sky, _ = tone_q99(color_l[~sky], color_k[~sky])
    n = stop_k.size
    r = {"scene": what, "rays": n, "stop_agreement": float(agree.mean()),
         "stop_agreement_with_reference": float(agree.mean() + ref["for_lax"] / n),
         "lax_budget": int((stop_l == 5).sum()),
         "lax_budget_kernel_codes": np.bincount(stop_k[stop_l == 5], minlength=8).tolist(),
         "f64_reference": ref,
         "tone_q99": q99, "tone_max": worst, "tone_q99_off_sky": q99_off_sky,
         "sky_pixels": int(sky.sum()),
         "bar": {"stop_agreement": F32_STOP_AGREEMENT, "tone_q99": F32_TONE_ATOL}}
    r["ok"] = r["stop_agreement_with_reference"] >= F32_STOP_AGREEMENT
    return r


def frame_against_kernel(kernel, out, chunks, what, ref_scene):
    """lax_against_kernel on a render_section frame: `kernel` the kernel
    frame's (pass-1 stop codes, ray classes, color image), `out` and
    `chunks` the lax frame's RenderOutput and ChunkOutputs."""
    stop_l, class_l, _ = (v.numpy() for v in chunks.pass1())
    first = chunks.passes[0]
    return lax_against_kernel(kernel, (stop_l, class_l, out.color), first["rows"], first["cols"], ref_scene, what)


def lax_compaction_check(scene):
    """The middle LAX_CHECK_SIDE² rays of `scene` through integrate_rays for
    LAX_CHECK_ATTEMPTS iterations, compacted and replayed from CUDA graphs
    against one eager run of the same body over every lane: every result
    must be equal bit for bit."""
    import torch

    from gr_raytracer_tpu_torch.rendering import camera as cam
    from gr_raytracer_tpu_torch.rendering import integrator as integ
    from gr_raytracer_tpu_torch.rendering import scene as scn

    side, mid = LAX_CHECK_SIDE, scene.camera.rows // 2
    r = torch.arange(mid - side // 2, mid + side // 2, device=scene.camera.position.device,
                     dtype=scene.camera.position.dtype)
    rows, cols = torch.meshgrid(r, r, indexing="ij")
    x, p = cam.pixel_rays(scene.camera, rows.reshape(-1), cols.reshape(-1))
    solver = scene.geometry.make_solver(x, p)
    y0 = solver.initial_state(x, p)
    runs, secs = [], []
    for compact in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(integ.integrate_rays(scene.geometry, solver, scene.integration, y0, scn._segment_fn(scene),
                                         scn.EVENT_WIDTH, attempts_budget=LAX_CHECK_ATTEMPTS, finalize=False,
                                         compact=compact))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    equal = {k: bool(torch.equal(a, b)) for (k, a), b in zip(runs[0]._asdict().items(), runs[1])}
    return {"rays": side * side, "attempts": LAX_CHECK_ATTEMPTS, "equal": equal,
            "bit_identical": all(equal.values()), "compacted_s": secs[0], "eager_s": secs[1],
            "running_after": int((runs[0].stop_code == 0).sum()), "events": int(runs[0].ev_count.sum())}


def lax_trace(scene, rows, cols):
    """The RKF45 path on `scene`'s rays at (rows, cols): (IntegrationResult,
    RaySamples) in ray order."""
    from gr_raytracer_tpu_torch.rendering import camera as cam
    from gr_raytracer_tpu_torch.rendering import integrator as integ
    from gr_raytracer_tpu_torch.rendering import scene as scn
    from gr_raytracer_tpu_torch.rendering.redshift import ray_frequency_data

    x, p = cam.pixel_rays(scene.camera, rows, cols)
    solver = scene.geometry.make_solver(x, p)
    freq = ray_frequency_data(scene.geometry, x, p, scene.camera.velocity)
    res = integ.integrate_rays(scene.geometry, solver, scene.integration, solver.initial_state(x, p),
                               scn._segment_fn(scene), scn.EVENT_WIDTH)
    return res, scn.finish_rays(scene, freq, solver, res)


def _lax_cpu_trace(rows, cols, path):
    """Phase 34's CPU side, in a process of its own: kerr.toml's rays at
    (rows, cols) in float64 through the RKF45 path; saves the results."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    torch.set_num_threads(1)
    scene = lax_scene(KERR_TOML, FRAME, KERR_CAMERA_KW, torch.float64, device="cpu")
    t0 = time.perf_counter()
    res, s = lax_trace(scene, torch.as_tensor(rows), torch.as_tensor(cols))
    np.savez(path, y=res.y.numpy(), stop=res.stop_code.numpy(), ev_count=res.ev_count.numpy(),
             ev_data=res.ev_data.numpy(), steps=res.steps.numpy(), color=s.color.numpy(),
             seconds=time.perf_counter() - t0)


def start_lax_cpu_trace(lane_steps, tmp):
    """Picks phase 34's rays from kerr.toml's lax pass 1 (`lane_steps` of its
    1000² pixels in row-major order): the LAX_F64_LONGEST rays with the most
    accepted steps and LAX_F64_RAYS − LAX_F64_LONGEST seeded others. Starts
    their CPU trace in a spawned process; returns (rows, cols, process,
    result path)."""
    import multiprocessing

    import numpy as np

    steps = np.asarray(lane_steps)
    longest = np.argsort(steps, kind="stable")[-LAX_F64_LONGEST:]
    rest = np.setdiff1d(np.arange(steps.size), longest)
    others = np.random.default_rng(LAX_F64_SEED).choice(rest, LAX_F64_RAYS - LAX_F64_LONGEST, replace=False)
    idx = np.concatenate([longest, others])
    rows, cols = (idx // FRAME).astype(np.float64), (idx % FRAME).astype(np.float64)
    path = os.path.join(tmp, "lax_cpu.npz")
    # A daemon: it ends with this process whatever happens.
    proc = multiprocessing.get_context("spawn").Process(target=_lax_cpu_trace, args=(rows, cols, path), daemon=True)
    proc.start()
    return rows, cols, proc, path, steps[longest]


def lax_card_vs_cpu(rows, cols, proc, path, longest_f32):
    """Phase 34: the same rays through the RKF45 path in float64 on the card
    and on the CPU (the spawned process): stop codes and event counts
    equal on ≥ F64_STOP_AGREEMENT of them, event payloads and colors of
    those within F64_RTOL of each lane's scale. Their final states are
    printed, not held at F64_RTOL: the controller's error estimate cancels
    to ~1e-8 of its terms, so an ulp between the card's and the CPU's
    transcendentals moves the step sizes by ~1e-9 and the end of a long
    march by more (on an H100: up to 3.5e-8 of a lane's scale, 84 of 512
    lanes over 1e-9; as the port against the JAX package,
    tests/test_torch_rkf45.py)."""
    import numpy as np
    import torch

    scene = lax_scene(KERR_TOML, FRAME, KERR_CAMERA_KW, torch.float64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, s = lax_trace(scene, torch.as_tensor(rows, device="cuda"), torch.as_tensor(cols, device="cuda"))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc.join()
    wait_s = time.perf_counter() - t0
    if proc.exitcode != 0:
        fail(f"phase 34: the CPU trace exited with {proc.exitcode}")
    cpu = np.load(path)
    stop, count = res.stop_code.cpu().numpy(), res.ev_count.cpu().numpy()
    agree = (stop == cpu["stop"]) & (count == cpu["ev_count"])

    def lane_rel(a, b):
        a, b = np.asarray(a, np.float64).reshape(a.shape[0], -1), np.asarray(b, np.float64).reshape(b.shape[0], -1)
        fin = np.isfinite(a) & np.isfinite(b)
        scale = np.maximum(np.abs(np.where(fin, a, 0.0)).max(axis=1), 1e-300)
        return np.where(fin, np.abs(a - b), 0.0).max(axis=1) / scale

    y_err = lane_rel(res.y.cpu().numpy(), cpu["y"])[agree]
    ev_err = lane_rel(res.ev_data.cpu().numpy(), cpu["ev_data"])[agree]
    c_err = lane_rel(s.color.cpu().numpy(), cpu["color"])[agree]
    r = {"rays": int(stop.size), "longest_f32_steps": [int(longest_f32.min()), int(longest_f32.max())],
         "card_s": card_s, "cpu_s": float(cpu["seconds"]), "cpu_wait_s": wait_s,
         "steps_max_card": int(res.steps.max()), "agreement": float(agree.mean()),
         "state_rel_err_max": float(y_err.max(initial=0.0)), "payload_rel_err_max": float(ev_err.max(initial=0.0)),
         "color_rel_err_max": float(c_err.max(initial=0.0)),
         "state_lanes_over_rtol": int((y_err > F64_RTOL).sum()),
         "stop_counts": np.bincount(stop, minlength=8).tolist(),
         "bar": {"agreement": F64_STOP_AGREEMENT, "rtol": F64_RTOL}}
    r["ok"] = (r["agreement"] >= F64_STOP_AGREEMENT and r["payload_rel_err_max"] <= F64_RTOL
               and r["color_rel_err_max"] <= F64_RTOL)
    return r


def split_scene_objects():
    """kerr-volumetric-streaky.toml's gas disc and kerr-sphere.toml's sphere
    (radius 3 at the origin, inside the disc's 4.05 hole), as loader
    tables."""
    from gr_raytracer_tpu_torch import config as tcfg

    gas = tcfg.load_config(VOL_TOML).objects
    sphere = [o for o in tcfg.load_config(KERR_SPHERE_TOML).objects if o["kind"] == "Sphere"]
    return tuple(gas) + tuple(sphere)


def split_phase(ops):
    """Phase 35: the split path with K5 on it. Renders the gas disc beside
    the sphere at SPLIT_SIZE² in float32 with AA through the kernel
    geometric pass (K1) and K5; holds SPLIT_BATCH lanes of its first K5
    launch against raymarch_plain bit for bit (at VOL_COMPARE_STEPS
    samples, as phase 14); and holds pass 1 against the same rays traced
    with lax=True by the kernel-against-lax bar (lax_against_kernel)."""
    import torch

    from gr_raytracer_tpu_torch.ops import geodesic_march as gm
    from gr_raytracer_tpu_torch.ops import volumetric_march as vm
    from gr_raytracer_tpu_torch.rendering import raytracer as rt

    scene = lax_scene(VOL_TOML, SPLIT_SIZE, VOL_CAMERA_KW, torch.float32, objects=split_scene_objects())
    if rt._route(scene, lax=False) != "split":
        fail(f"phase 35: the scene does not take the split path: {rt._route(scene, lax=False)}")
    captured = []
    inner = vm.raymarch

    def raymarch(spec, *lanes):
        if not captured:
            # SPLIT_BATCH lanes spread over the launch's march lengths.
            n = lanes[0].shape[0]
            idx = torch.linspace(0, n - 1, min(SPLIT_BATCH, n), device=lanes[0].device).long()
            captured.append((spec, tuple(v[idx].contiguous() for v in lanes)))
        return inner(spec, *lanes)

    gm.launches = vm.launches = 0
    vm.launch_timer, gm.launch_timer = [], []
    vm.raymarch = raymarch
    try:
        with RaymarchSamples() as marched, ChunkOutputs() as kchunks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = rt.render_section(scene)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    finally:
        vm.raymarch = inner
    k5_launches, k1_launches = vm.launches, gm.launches
    k5_ms = sum(s.elapsed_time(e) for s, e in vm.launch_timer)
    vm.launch_timer = gm.launch_timer = None
    if k5_launches == 0 or k1_launches == 0 or not captured:
        fail(f"phase 35: the split render launched K1 {k1_launches} and K5 {k5_launches} times")
    pass1, aa = out.stats["pass1"], out.stats["aa"]
    samples = pass1.vol_samples + aa.vol_samples
    spec, lanes = captured[0]
    cut = spec._replace(max_steps=VOL_COMPARE_STEPS)
    got, n_got = vm.raymarch(cut, *lanes)
    ref, n_ref = vm.raymarch_plain(cut, *lanes)
    bit = bool(torch.equal(got, ref) and torch.equal(n_got, n_ref))
    r = {"frame": f"{SPLIT_SIZE}x{SPLIT_SIZE}", "seconds": secs, "k1_launches": k1_launches,
         "k5_launches": k5_launches, "k5_ms": k5_ms, "k5_samples": samples,
         "gas_lanes": pass1.vol_lanes + aa.vol_lanes, "gas_emitting": pass1.vol_emitting + aa.vol_emitting,
         "k5_bound_ms": raymarch_bound_ms(samples, pass1.vol_lanes + aa.vol_lanes, ops, torch.float32)[0],
         "k5_batch_use": marched.batch_use()["frame"], "overflow": pass1.overflow + aa.overflow,
         "batch": {"lanes": int(lanes[0].shape[0]), "samples": VOL_COMPARE_STEPS, "bit_identical": bit,
                   "max_abs_err": float((got - ref).abs().max()) if got.numel() else 0.0},
         "stop_counts_pass1": pass1.stop_counts.tolist()}
    print(json.dumps({"split_kernel_frame": r}), flush=True)
    # Against the lax path on pass 1's rays (the AA pass traces jittered
    # rays through the same driver).
    import numpy as np

    from gr_raytracer_tpu_torch.rendering import integrator as integ

    rr, cc = np.meshgrid(np.arange(SPLIT_SIZE, dtype=np.float64), np.arange(SPLIT_SIZE, dtype=np.float64),
                         indexing="ij")
    rr, cc = rr.ravel(), cc.ravel()
    with ChunkOutputs() as kchunks:
        k_color, _, _, _ = rt.trace_pixels_chunked(scene, rr, cc, rt.CHUNK_SIZE)
    integ.loop_stats.clear()
    with ChunkOutputs() as lchunks:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l_color, _, _, l_stats = rt.trace_pixels_chunked(scene, rr, cc, rt.CHUNK_SIZE, lax=True)
        torch.cuda.synchronize()
        lax_s = time.perf_counter() - t0
    stop_k, class_k, _ = (v.numpy() for v in kchunks.pass1())
    stop_l, class_l, steps_l = (v.numpy() for v in lchunks.pass1())
    against = lax_against_kernel(
        (stop_k, class_k, k_color), (stop_l, class_l, l_color), rr, cc,
        lambda: lax_scene(VOL_TOML, SPLIT_SIZE, VOL_CAMERA_KW, torch.float64, objects=split_scene_objects()),
        "split scene")
    r["against_lax"] = dict(against, lax_seconds=lax_s, lax_vol_lanes=l_stats.vol_lanes,
                            lax_accepted_steps=l_stats.ray_steps, lax_longest_lane=int(steps_l.max()),
                            loops=dict(integ.loop_stats))
    r["ok"] = bit and against["ok"]
    return r


def lax_phases():
    """Phases 33 and 34; returns ({scene: frame summary}, {check: result})."""
    import torch

    from gr_raytracer_tpu_torch.rendering import raytracer as rt

    phase("33. the lax main path: render_section(..., lax=True) of kerr.toml, schwarzschild.toml and kerr-bl.toml")
    frames = {}
    with tempfile.TemporaryDirectory() as tmp:
        scene = lax_scene(KERR_TOML, FRAME, KERR_CAMERA_KW, torch.float32)
        kernel, stop_k, class_k = kernel_frame(scene)
        out, summary, chunks = lax_render(scene, "kerr.toml")
        print(json.dumps({"lax_frame": summary}), flush=True)
        # Phase 34's CPU side runs while the card works on the rest.
        cpu_job = start_lax_cpu_trace(chunks.pass1()[2].numpy(), tmp)
        summary["against_kernel"] = frame_against_kernel(
            (stop_k, class_k, kernel.color), out, chunks, "kerr.toml",
            lambda: lax_scene(KERR_TOML, FRAME, KERR_CAMERA_KW, torch.float64))
        frames["kerr.toml"] = summary
        print(json.dumps({"lax_against_kernel": summary["against_kernel"]}), flush=True)
        if not summary["against_kernel"]["ok"]:
            fail(f"the lax kerr.toml frame misses the kernel-against-lax bar: {summary['against_kernel']}")
        compaction = lax_compaction_check(scene)
        print(json.dumps({"lax_compaction": compaction}), flush=True)
        if not compaction["bit_identical"]:
            fail(f"the compacted lax march differs from one eager run: {compaction}")
        del out, chunks, scene, kernel
        for name, toml, size, camera_kw, why in LAX_FRAMES:
            scene = lax_scene(toml, size, camera_kw, torch.float32)
            kernel, stop_k, class_k = kernel_frame(scene)
            out, summary, chunks = lax_render(scene, name)
            summary["size_why"] = why
            summary["against_kernel"] = frame_against_kernel(
                (stop_k, class_k, kernel.color), out, chunks, name,
                lambda: lax_scene(toml, size, camera_kw, torch.float64))
            frames[name] = summary
            print(json.dumps({"lax_frame": summary}), flush=True)
            if not summary["against_kernel"]["ok"]:
                fail(f"the lax {name} frame misses the kernel-against-lax bar: {summary['against_kernel']}")
            del out, chunks, scene, kernel

        phase("34. the lax path in float64 on the card against the CPU")
        card_vs_cpu = lax_card_vs_cpu(*cpu_job)
        print(json.dumps({"lax_card_vs_cpu": card_vs_cpu}), flush=True)
        if not card_vs_cpu["ok"]:
            fail(f"the lax path on the card disagrees with the CPU: {card_vs_cpu}")
    return frames, {"compaction": compaction, "card_vs_cpu": card_vs_cpu}


# Phases 36-39: reverse mode through the lax path (IntegrationConfig(
# differentiable=True), checkpointed blocks of iterations). Phase 36 is
# scripts/grad_scale_probe.py's grad_step on the port (the flagship preset at
# LAX_GRAD_SIZE², float32, sky radius 40, step 0.05, checkpoint blocks of
# LAX_GRAD_BLOCK, loss mean(log1p(max(c, 0)))) and phase 38 its inverse_fit
# (a from 0.30 toward 0.45, lr 3e-2). Every iteration of the differentiable
# loop is dispatched eagerly: on an H100 at 128² an iteration takes ~48 ms
# forward and ~114 ms backward, the host's (scripts/lax_grad_probe.py,
# PERF.md §6). Every lane of the frame stops within 1,024 iterations, so the
# probe's budgets 20,000 and 2,000 run the same 1,024 (~166 s a value and
# gradient). To keep the run in its limit on a slow host, phases 36 and 37
# run at budget 100 (one block of 256 iterations) and the fit takes 2
# steps at budget 100 in place of 12 at 2,000.
LAX_GRAD_SIZE = 128
LAX_GRAD_BLOCK = 256
LAX_GRAD_RADIUS = 40.0
LAX_GRAD_STEP = 0.05
LAX_GRAD_BUDGET = 100
# Phase 37: a LAX_GRAD_F64_SIDE² sub-grid of phase 36's frame (every
# (LAX_GRAD_SIZE / LAX_GRAD_F64_SIDE)-th row and column) in float64 on the
# card and on the CPU, at LAX_GRAD_F64_BUDGET; the bars: the
# loss within 1e-9, the gradients within 1e-6 relative, the card's ∂a
# against a central difference (step 1e-6) of its own forward at 5e-4.
LAX_GRAD_F64_SIDE = 16
LAX_GRAD_F64_BUDGET = 100
LAX_GRAD_F64_BARS = dict(loss=1e-9, grads=1e-6, fd=5e-4, fd_step=1e-6)
# Phase 38.
LAX_FIT_BUDGET = 100
LAX_FIT_STEPS = 2
LAX_FIT_A = (0.30, 0.45)
LAX_FIT_LR = 3e-2
# Phase 39: schwarzschild.toml at LAX_GRAD_SIZE², float32, at this budget
# (phase 33's sky radius).
LAX_SCENE_BUDGET = 200
# The seven parameter gradients of tests/test_grad.py: (name, component).
LAX_GRAD_NAMES = (("a", None), ("radius", None), ("camera_position", 1), ("camera_theta", None),
                  ("camera_psi", None), ("disc_temperature", None), ("disc_outer", None))


def lax_probe_loss(color):
    """grad_scale_probe.py's loss, mean(log1p(max(c, 0))) over the XYZ
    channels, with jnp.maximum's gradient at 0."""
    import torch

    from gr_raytracer_tpu_torch.geometry.base import maximum

    return torch.mean(torch.log1p(maximum(color[:, :3], 0.0)))


def lax_flagship_render(size, budget, dtype, device, stride=1, block=LAX_GRAD_BLOCK, differentiable=True):
    """render(params) -> the XYZA colors of the flagship preset's camera
    rays through the lax path (scene.trace_rays) at every stride-th row and
    column of a size² frame."""
    import torch

    from gr_raytracer_tpu_torch import presets
    from gr_raytracer_tpu_torch.rendering import camera as cam
    from gr_raytracer_tpu_torch.rendering import scene as scn

    idx = torch.arange(0, size, stride, dtype=dtype, device=device)
    rr, cc = torch.meshgrid(idx, idx, indexing="ij")
    rows, cols = rr.ravel(), cc.ravel()

    def render(params):
        scene = presets.build_kerr_flagship(params, size, size, max_steps=budget, max_radius=LAX_GRAD_RADIUS,
                                            step_size=LAX_GRAD_STEP, differentiable=differentiable)
        scene = dataclasses.replace(scene, integration=dataclasses.replace(scene.integration,
                                                                           checkpoint_block=block))
        x, m = cam.pixel_rays(scene.camera, rows, cols)
        return scn.trace_rays(scene, x, m).color

    return render


def _pick(grads, name, component):
    g = grads[name]
    return float(g if component is None else g[component])


def lax_value_and_grad(render, params, names=LAX_GRAD_NAMES, loss_fn=None):
    """One value and gradient of lax_probe_loss (or loss_fn(color)) through
    render(params): the loss, {name: ∂}, forward and backward seconds (each
    ended by a synchronize on a card), the loop's iterations, blocks,
    lane-iterations and lanes per block (integrator.loop_stats), ms an
    iteration each way, and the peak device memory."""
    import torch

    from gr_raytracer_tpu_torch.rendering import integrator as integ

    loss_fn = loss_fn or lax_probe_loss
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    cuda = next(iter(leaves.values())).is_cuda
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    integ.loop_stats.clear()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    loss = loss_fn(render(leaves))
    sync()
    t1 = time.perf_counter()
    st = {k: (list(v) if isinstance(v, list) else v) for k, v in integ.loop_stats.get("march_diff", {}).items()}
    keys = sorted({n for n, _ in names})
    g = torch.autograd.grad(loss, [leaves[k] for k in keys], allow_unused=True)
    sync()
    t2 = time.perf_counter()
    grads = {k: (torch.zeros_like(leaves[k]) if v is None else v.detach()).cpu() for k, v in zip(keys, g)}
    it = st.get("iterations", 0)
    return {
        "loss": float(loss.detach()), "grads": {f"{n}[{c}]" if c is not None else n: _pick(grads, n, c) for n, c in names},
        "forward_s": t1 - t0, "backward_s": t2 - t1, "iterations": it, "blocks": st.get("blocks", 0),
        "lane_iterations": st.get("lane_iterations", 0), "lanes_per_block": st.get("lanes_per_block", []),
        "ms_per_iteration": {"forward": 1e3 * (t1 - t0) / max(it, 1), "backward": 1e3 * (t2 - t1) / max(it, 1)},
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
    }


def lax_grad_step(budget=LAX_GRAD_BUDGET, size=LAX_GRAD_SIZE, dtype=None, block=LAX_GRAD_BLOCK):
    """Phase 36: one value and gradient of the flagship through the lax path
    (grad_scale_probe.py's grad_step), and beside it the kernel-VJP
    gradient of the same loss (fast_path.trace_rays_fast_diff: K1 and K2)
    with its launches. Held: loss and every gradient finite, ∂a and
    ∂radius nonzero."""
    import math

    import torch

    from gr_raytracer_tpu_torch import presets
    from gr_raytracer_tpu_torch.ops import geodesic_adjoint as gadj
    from gr_raytracer_tpu_torch.ops import geodesic_march as gm
    from gr_raytracer_tpu_torch.rendering import camera as cam
    from gr_raytracer_tpu_torch.rendering import fast_path

    dtype = dtype or torch.float32
    params = presets.kerr_flagship_params(dtype, "cuda")
    r = {"frame": f"{size}x{size}", "dtype": str(dtype).replace("torch.", ""), "budget": budget, "block": block,
         **lax_value_and_grad(lax_flagship_render(size, budget, dtype, "cuda", block=block), params)}
    spec = fast_path.scene_kernel_spec(presets.build_kerr_flagship(params, size, size, max_steps=budget))
    idx = torch.arange(size, dtype=dtype, device="cuda")
    rr, cc = torch.meshgrid(idx, idx, indexing="ij")

    def kernel_render(p):
        scene = presets.build_kerr_flagship(p, size, size, max_steps=budget, max_radius=LAX_GRAD_RADIUS,
                                            step_size=LAX_GRAD_STEP)
        x, m = cam.pixel_rays(scene.camera, rr.ravel(), cc.ravel())
        return fast_path.trace_rays_fast_diff(scene, x, m, spec=spec).color

    gm.launches = gadj.launches = 0
    k = lax_value_and_grad(kernel_render, params)
    r["kernel_vjp"] = {"loss": k["loss"], "grads": k["grads"], "s": k["forward_s"] + k["backward_s"],
                       "k1_launches": gm.launches, "k2_launches": gadj.launches}
    r["ok"] = (math.isfinite(r["loss"]) and all(math.isfinite(v) for v in r["grads"].values())
               and r["grads"]["a"] != 0.0 and r["grads"]["radius"] != 0.0)
    return r


def _lax_grad_cpu(path, size, stride, budget):
    """Phase 37's CPU side, in a process of its own: the flagship's
    sub-grid in float64 through the lax path's reverse mode; saves the
    result as JSON."""
    import torch

    sys.path.insert(0, HERE)
    torch.set_num_threads(1)
    from gr_raytracer_tpu_torch import presets

    r = lax_value_and_grad(lax_flagship_render(size, budget, torch.float64, "cpu", stride=stride),
                           presets.kerr_flagship_params(torch.float64, "cpu"))
    with open(path, "w") as f:
        json.dump(r, f)


def start_lax_grad_cpu(tmp):
    """Starts phase 37's CPU side in a spawned process; returns (process,
    result path)."""
    import multiprocessing

    path = os.path.join(tmp, "lax_grad_cpu.json")
    proc = multiprocessing.get_context("spawn").Process(
        target=_lax_grad_cpu, args=(path, LAX_GRAD_SIZE, LAX_GRAD_SIZE // LAX_GRAD_F64_SIDE, LAX_GRAD_F64_BUDGET),
        daemon=True)
    proc.start()
    return proc, path


def lax_grad_card_vs_cpu(proc, path):
    """Phase 37: the sub-grid's loss and seven gradients in float64 on the
    card against the CPU (the spawned process), and the card's ∂a against a
    central difference of its own float64 forward."""
    import torch

    from gr_raytracer_tpu_torch import presets

    dt, bars = torch.float64, LAX_GRAD_F64_BARS
    stride = LAX_GRAD_SIZE // LAX_GRAD_F64_SIDE
    params = presets.kerr_flagship_params(dt, "cuda")
    render = lax_flagship_render(LAX_GRAD_SIZE, LAX_GRAD_F64_BUDGET, dt, "cuda", stride=stride)
    card = lax_value_and_grad(render, params)
    eps = bars["fd_step"]
    with torch.no_grad():
        up = float(lax_probe_loss(render(dict(params, a=params["a"] + eps))))
        down = float(lax_probe_loss(render(dict(params, a=params["a"] - eps))))
    fd = (up - down) / (2.0 * eps)
    t0 = time.perf_counter()
    proc.join()
    wait_s = time.perf_counter() - t0
    if proc.exitcode != 0:
        fail(f"phase 37: the CPU side exited with {proc.exitcode}")
    with open(path) as f:
        cpu = json.load(f)
    grad_rel = {k: abs(v - cpu["grads"][k]) / max(abs(cpu["grads"][k]), 1e-300) for k, v in card["grads"].items()}
    r = {"rays": LAX_GRAD_F64_SIDE ** 2, "budget": LAX_GRAD_F64_BUDGET, "card": card,
         "cpu": {k: cpu[k] for k in ("loss", "grads", "forward_s", "backward_s", "iterations", "blocks")},
         "cpu_wait_s": wait_s, "loss_rel_err": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
         "grad_rel_err": grad_rel, "da_central_difference": fd,
         "da_fd_rel_err": abs(card["grads"]["a"] - fd) / abs(fd), "bars": bars}
    r["ok"] = (r["loss_rel_err"] <= bars["loss"] and max(grad_rel.values()) <= bars["grads"]
               and r["da_fd_rel_err"] <= bars["fd"])
    return r


def lax_fit_phase(budget=LAX_FIT_BUDGET, steps=LAX_FIT_STEPS, size=LAX_GRAD_SIZE):
    """Phase 38: grad_scale_probe.py's inverse_fit on the port's lax path:
    `steps` (at least 2) steps of inverse.fit on a from LAX_FIT_A[0] toward
    the target's LAX_FIT_A[1] (float32). Prints s a step (host clock
    between the callbacks, after a synchronize; the steps before the last)
    and the device-busy share of the last step (torch.profiler,
    device_busy_share). Held: the loss falls and a ends nearer the target
    than it started."""
    import torch

    from gr_raytracer_tpu_torch import inverse, presets

    dt = torch.float32
    a0, a_true = LAX_FIT_A
    base = presets.kerr_flagship_params(dt, "cuda")
    render = lax_flagship_render(size, budget, dt, "cuda")
    with torch.no_grad():
        target = render(dict(base, a=torch.tensor(a_true, dtype=dt, device="cuda")))
    rows, marks = [], [time.perf_counter()]
    # The last step runs under the profiler, started and stopped from the
    # callbacks around it; the trace records the device alone (a step
    # dispatches every op of every iteration three times, and a trace of
    # its host ops holds millions of events). Its time is taken between
    # two CUDA events.
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def callback(i, loss, p, grads):
        if i == steps - 1:
            stop.record()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if i == steps - 1:
            prof.stop()
        rows.append({"step": i, "loss": loss, "a": float(p["a"].detach()), "da": float(grads["a"]),
                     "s": marks[-1] - marks[-2], "profiled": i == steps - 1})
        print(json.dumps({"lax_fit_step": rows[-1]}), flush=True)
        if i == steps - 2:
            prof.start()
            start.record()
            marks[-1] = time.perf_counter()

    init = dict(base, a=torch.tensor(a0, dtype=dt, device="cuda"))
    fitted, losses = inverse.fit(render, init, target, trainable=("a",), steps=steps, learning_rate=LAX_FIT_LR,
                                 callback=callback)
    t0 = time.perf_counter()
    busy = device_busy_share(prof)
    a_end = float(fitted["a"])
    r = {"frame": f"{size}x{size}", "budget": budget, "steps": steps, "a_init": a0, "a_true": a_true,
         "a_end": a_end, "loss_first": losses[0], "loss_last": losses[-1],
         "s_per_step": sum(x["s"] for x in rows[:-1]) / (len(rows) - 1), "device_busy": busy,
         "profiled_step_s": start.elapsed_time(stop) * 1e-3, "trace_read_s": time.perf_counter() - t0}
    r["ok"] = losses[-1] < losses[0] and abs(a_end - a_true) < abs(a0 - a_true)
    return r


def lax_chords():
    """tests/test_grad.py's 16 chords through a gas annulus and the disc of
    its raymarch test: (ro, rd, obs, p_t, p_phi) as numpy arrays, and
    make_disc(med, dtype, device, differentiable) -> the VolumetricDisc with
    the five medium parameters `med` (LAX_CHORD_NAMES)."""
    import numpy as np

    from gr_raytracer_tpu_torch.objects.volumetric_disc import VolumetricDisc
    from gr_raytracer_tpu_torch.rendering.temperature import ConstantTemperature
    from gr_raytracer_tpu_torch.rendering.texture import BlackBodyMap

    rng = np.random.default_rng(11)
    n = 16
    phi = rng.uniform(0.0, 2 * np.pi, n)
    r0 = rng.uniform(2.6, 4.5, n)
    ro = np.stack([r0 * np.cos(phi), r0 * np.sin(phi), rng.uniform(-0.2, 0.2, n)], -1)
    tang = np.stack([-np.sin(phi), np.cos(phi), 0.1 * rng.standard_normal(n)], -1)
    rd = tang / np.linalg.norm(tang, axis=-1, keepdims=True)

    def make_disc(med, dtype, device, differentiable):
        import torch

        return VolumetricDisc.create(
            inner_radius=2.2, outer_radius=5.0,
            temperature_model=ConstantTemperature(torch.tensor(5000.0, dtype=dtype, device=device)),
            texture=BlackBodyMap.create(0.0, dtype, device), num_octaves=4, max_steps=500, step_size=0.01,
            thickness=0.3, noise_scale=(2.0, 2.0, 2.0), dtype=dtype, device=device,
            differentiable=differentiable, **dict(zip(LAX_CHORD_NAMES, med)))

    return (ro, rd, np.ones(n), np.full(n, 1.0), np.full(n, 0.2)), make_disc


# The chords' disc's five medium parameters, in volumetric_march.MED_NAMES'
# order.
LAX_CHORD_NAMES = ("density_multiplier", "noise_offset", "absorption", "scattering",
                   "brightness_reference_temperature")
LAX_CHORD_MEDIUM = (5.0, 0.4, 0.3, 0.4, 1000.0)


def lax_raymarch_grad(device):
    """The differentiable raymarch on the chords in float64 on `device`:
    (XYZA [16, 4] as numpy, the five medium gradients of Σ c / (1 + c),
    seconds)."""
    import torch

    from gr_raytracer_tpu_torch.geometry.kerr import Kerr

    dt = torch.float64
    lanes, make_disc = lax_chords()
    args = [torch.as_tensor(v, dtype=dt, device=device) for v in lanes] + [
        torch.ones(16, dtype=torch.bool, device=device)]
    geo = Kerr(radius=torch.tensor(1.0, dtype=dt, device=device), a=torch.tensor(0.3, dtype=dt, device=device),
               horizon_epsilon=torch.tensor(1e-3, dtype=dt, device=device))
    med = torch.tensor(LAX_CHORD_MEDIUM, dtype=dt, device=device, requires_grad=True)
    t0 = time.perf_counter()
    out = make_disc(list(med.unbind()), dt, device, True).raymarch(geo, *args)
    c = out[..., :3]
    (g,) = torch.autograd.grad(torch.sum(c / (1.0 + c)), [med])
    if out.is_cuda:
        torch.cuda.synchronize()
    return out.detach().cpu().numpy(), g.cpu().numpy(), time.perf_counter() - t0


def lax_scene_phase(budget=LAX_SCENE_BUDGET, size=LAX_GRAD_SIZE):
    """Phase 39: scenes outside fast_path.supports_diff on the card.
    schwarzschild.toml at size² in float32 (sky radius 40, `budget`): the
    value and gradient of lax_probe_loss in the Schwarzschild radius and
    the sphere's radius, held finite and nonzero, with at least one ray
    that meets the sphere (counted and printed); the differentiable
    raymarch on the 16 chords, float64 on the card against the CPU within
    F64_RTOL (XYZA per lane's scale, the five gradients relative)."""
    import math

    import numpy as np
    import torch

    from gr_raytracer_tpu_torch.objects.sphere import Sphere
    from gr_raytracer_tpu_torch.rendering import camera as cam
    from gr_raytracer_tpu_torch.rendering import fast_path
    from gr_raytracer_tpu_torch.rendering import scene as scn

    scene = lax_scene(SCHWARZSCHILD_TOML, size, BL_CAMERA_KW, torch.float32)
    if fast_path.supports_diff(scene):
        fail("phase 39: schwarzschild.toml is a supports_diff scene")
    scene = dataclasses.replace(scene, integration=dataclasses.replace(
        scene.integration, max_steps=budget, differentiable=True, checkpoint_block=LAX_GRAD_BLOCK))
    sphere = next(i for i, o in enumerate(scene.objects) if isinstance(o, Sphere))
    idx = torch.arange(size, dtype=torch.float32, device="cuda")
    rr, cc = torch.meshgrid(idx, idx, indexing="ij")
    x, m = cam.pixel_rays(scene.camera, rr.ravel(), cc.ravel())

    def render(p):
        objects = list(scene.objects)
        objects[sphere] = dataclasses.replace(objects[sphere], radius=p["sphere_radius"])
        s = dataclasses.replace(scene, geometry=dataclasses.replace(scene.geometry, radius=p["radius"]),
                                objects=tuple(objects))
        # The sphere's events, read where trace_rays hands its march to the
        # shading: the sphere's gradient rests on these rays alone.
        inner = scn.finish_rays

        def finish(scene_, freq, solver, res):
            on = res.ev_kind == sphere
            render.sphere = {"rays": int(on.any(dim=1).sum()), "first_event": int(on[:, 0].sum())}
            return inner(scene_, freq, solver, res)

        scn.finish_rays = finish
        try:
            out = scn.trace_rays(s, x, m)
        finally:
            scn.finish_rays = inner
        render.kinds = torch.bincount(out.ray_class.long(), minlength=3).tolist()
        return out.color

    params = {"radius": scene.geometry.radius, "sphere_radius": scene.objects[sphere].radius}
    r = {"scene": "schwarzschild.toml", "frame": f"{size}x{size}", "budget": budget,
         **lax_value_and_grad(render, params, names=(("radius", None), ("sphere_radius", None)))}
    r["ray_classes"], r["sphere_events"] = render.kinds, render.sphere
    got, g_card, card_s = lax_raymarch_grad("cuda")
    ref, g_cpu, cpu_s = lax_raymarch_grad("cpu")
    scale = np.maximum(np.abs(ref).max(axis=1), 1e-300)
    chords = {"card_s": card_s, "cpu_s": cpu_s, "xyza_rel_err": float((np.abs(got - ref).max(axis=1) / scale).max()),
              "grad_rel_err": float((np.abs(g_card - g_cpu) / np.maximum(np.abs(g_cpu), 1e-300)).max()),
              "grads": dict(zip(LAX_CHORD_NAMES, g_card.tolist())),
              "bar": F64_RTOL}
    r["chords"] = chords
    r["ok"] = (math.isfinite(r["loss"]) and all(math.isfinite(v) and v != 0.0 for v in r["grads"].values())
               and render.sphere["rays"] > 0 and chords["xyza_rel_err"] <= F64_RTOL and chords["grad_rel_err"] <= F64_RTOL)
    return r


def lax_grad_phases(card):
    """Phases 36-39; returns {phase: result}. Each result line carries the
    card's name and power limit."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # Phase 37's CPU side runs while the card works on phase 36.
        cpu_job = start_lax_grad_cpu(tmp)
        phase("36. lax gradient: one value and gradient of the 128² flagship (grad_scale_probe.py's grad_step)")
        out["grad_step"] = lax_grad_step()
        print(json.dumps({"lax_grad_step": out["grad_step"], "card": card}), flush=True)
        if not out["grad_step"]["ok"]:
            fail(f"the lax gradient step is not finite or ∂a, ∂radius vanish: {out['grad_step']}")
        phase("37. lax gradient in float64 on the card against the CPU")
        out["card_vs_cpu"] = lax_grad_card_vs_cpu(*cpu_job)
        print(json.dumps({"lax_grad_card_vs_cpu": out["card_vs_cpu"], "card": card}), flush=True)
        if not out["card_vs_cpu"]["ok"]:
            fail(f"the lax gradient on the card disagrees with the CPU: {out['card_vs_cpu']}")
    phase("38. lax inverse fit: the spin from 0.30 toward 0.45 (grad_scale_probe.py's inverse_fit)")
    out["fit"] = lax_fit_phase()
    print(json.dumps({"lax_fit": out["fit"], "card": card}), flush=True)
    if not out["fit"]["ok"]:
        fail(f"the lax spin fit does not move toward the target: {out['fit']}")
    phase("39. lax gradient outside supports_diff: schwarzschild.toml and the differentiable raymarch")
    out["scenes"] = lax_scene_phase()
    print(json.dumps({"lax_grad_scenes": out["scenes"], "card": card}), flush=True)
    if not out["scenes"]["ok"]:
        fail(f"a lax gradient outside supports_diff fails: {out['scenes']}")
    return out


def main():
    import math

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
    from gr_raytracer_tpu_torch.ops import volumetric_adjoint as va
    from gr_raytracer_tpu_torch.ops import volumetric_march as vm
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
    registers = {}
    for src, (secs, log) in cuda_build.BUILD_LOG.items():
        print(f"  {src}: " + ("cached" if secs is None else f"nvcc {secs:.1f}s"))
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print("   ", line.strip())
        registers[src] = ptxas_summary(log)
    print(json.dumps({"registers": registers}), flush=True)

    phase("3. K1 against its plain version")
    flops_per_step = count_step_flops()
    print(f"flops per ray-step (plain step, counted): {flops_per_step}")
    variants, k1_chunk = {}, {}
    for dtype in (torch.float32, torch.float64):
        for compensated in (False, True):
            main_config = dtype == torch.float32 and not compensated
            r = compare_march(dtype, compensated, flops_per_step, keep=k1_chunk if main_config else None)
            variants[(dtype, compensated)] = r
            print(json.dumps(r), flush=True)
            if not r["ok"]:
                fail(f"K1 disagrees with its plain version: {r}")
    # K1's registers and the instructions of one common-path step (as K3's
    # in phase 8), and its launch table on the three fit frames.
    k1_sass = sass_k3_step("kerr_rk4_march.cu", "march_kernel")
    print(json.dumps({"k1_ptxas": registers.get("kerr_rk4_march.cu"), "k1_sass": k1_sass}), flush=True)
    k1_step = k1_sass.get("f32", {}).get("loop", {}).get("common_path", {}).get("instructions")
    k1_tables = {"fit frames": k1_fit_frame_tables(k1_step)}
    print(json.dumps({"k1_launches": "fit frames", **k1_tables["fit frames"]}), flush=True)

    phase("4. main path: CLI render of kerr.toml")
    gm.launches = 0
    gm.launch_timer = []
    with tempfile.TemporaryDirectory() as tmp, K1Launches() as k1_kerr:
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
    k1_tables["kerr.toml"] = k1_kerr.table(k1_step)
    print(json.dumps({"k1_launches": "kerr.toml", **k1_tables["kerr.toml"]}), flush=True)
    # K1 over the whole of pass 1, refill included, with phase 3's float32
    # chunk in its middle: those lanes must equal its plain results.
    k1_main_shape = {"kerr.toml pass 1": at_main_shape(KERR_TOML, FRAME, KERR_CAMERA_KW, *k1_kerr.passes[0],
                                                       k1_chunk)}
    del k1_chunk
    print(json.dumps({"k1_at_main_shape": k1_main_shape}), flush=True)
    if not k1_main_shape["kerr.toml pass 1"]["bit_identical"]:
        fail(f"K1 at the main path's shape disagrees with its plain version: {k1_main_shape}")
    # The pass-1 rays that stop NAN, for the reference's verdict on them.
    print(json.dumps(nan_lanes_report()), flush=True)

    phase("5. K1 with checkpoints against its plain version")
    marches = {}
    for dtype in (torch.float32, torch.float64):
        r, marches[dtype], fit_spec, _ = compare_march_ckpt(dtype)
        print(json.dumps(r), flush=True)
        if not r["ok"]:
            fail(f"K1 with checkpoints disagrees with its plain version: {r}")

    phase("6. K2 against its plain version")
    sweep_flops = count_sweep_flops()
    print(f"flops per ray of the sweep (re-forward step, reverse step, payload at the stored step; counted): "
          f"{json.dumps(sweep_flops)}")
    k2_sass = sass_sweep_step("kerr_ks_adjoint.cu", "adjoint_kernel", 1)
    print(json.dumps({"k2_ptxas": registers.get("kerr_ks_adjoint.cu"), "k2_sass": k2_sass}), flush=True)
    sweeps = {}
    for dtype in (torch.float64, torch.float32):
        r = compare_adjoint(dtype, marches[dtype], fit_spec, sweep_flops, sass=k2_sass)
        sweeps[dtype] = r
        print(json.dumps(r), flush=True)
        if not r["ok"]:
            fail(f"K2 disagrees with its plain version: {r}")
    del marches

    phase("7. gradient path: 10 steps of the 256² three-parameter fit")
    fit = fit_phase()
    print(json.dumps(fit), flush=True)

    phase("8. K3 against its plain version")
    bl_flops_step = count_bl_step_flops()
    print(f"flops per ray-step of the BL march (plain step, counted): {bl_flops_step}")
    k3_sass = sass_k3_step()
    print(json.dumps({"k3_ptxas": registers.get("kerr_bl_march.cu"), "k3_sass": k3_sass}), flush=True)
    bl_variants, bl_chunk = {}, {}
    for dtype in (torch.float32, torch.float64):
        for compensated in (False, True):
            # The main path's configuration runs its whole budget; the plain
            # march costs milliseconds an iteration whatever the lane count, so the
            # other variants compare their first BL_COMPARE_ATTEMPTS steps.
            full = dtype == torch.float32 and not compensated
            r = compare_march(dtype, compensated, bl_flops_step, bl=True,
                              attempts=None if full else BL_COMPARE_ATTEMPTS, keep=bl_chunk if full else None)
            bl_variants[(dtype, compensated)] = r
            print(json.dumps(r), flush=True)
            if not r["ok"]:
                fail(f"K3 disagrees with its plain version: {r}")
    bl_marches, bl_consts = {}, {}
    for dtype in (torch.float32, torch.float64):
        r, bl_marches[dtype], bl_spec, bl_consts[dtype] = compare_march_ckpt(
            dtype, bl=True, attempts=None if dtype == torch.float32 else BL_COMPARE_ATTEMPTS)
        bl_variants[(dtype, "ckpt")] = r
        print(json.dumps(r), flush=True)
        if not r["ok"]:
            fail(f"K3 with checkpoints disagrees with its plain version: {r}")

    phase("9. BL main path: CLI render of kerr-bl.toml")
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "render-kerr-bl.png")
        with K3Launches() as k3_kerr_bl, HostTime() as host:
            out, total_s, ran = cli_render(KERR_BL_TOML, FRAME, BL_CAMERA, png, (("K3", gm, "bl_launches"),))
        bl_render_launches, k3_ms = ran["K3"]
        if bl_render_launches == 0:
            fail("the BL main path launched K3 no time")
        bl_main = check_frame(out, png, FRAME, (1, 2, 7), "kerr-bl.toml")
    bl_main.update({"max_steps": MAX_STEPS, "mino_budget": 2 * MAX_STEPS, "total_s": total_s,
                    "host_s_by_function": host.seconds,
                    "k3_launches": bl_render_launches, "k3_ms": k3_ms,
                    "k3_bound_ms": (bl_main["pass1_ray_steps"] + bl_main["aa_ray_steps"]) * bl_flops_step
                    / card_peak_flops(torch.float32) * 1e3})
    print(json.dumps(bl_main), flush=True)
    k3_tables = {"kerr-bl.toml": k3_kerr_bl.table()}
    print(json.dumps({"k3_launches": "kerr-bl.toml", **k3_tables["kerr-bl.toml"]}), flush=True)
    f32_step = k3_sass.get("f32", {}).get("loop", {}).get("common_path", {}).get("instructions")
    if f32_step:
        rows = k3_tables["kerr-bl.toml"]["rows"]
        share = issue_share(sum(r[4] for r in rows if r[2] != "1"), sum(r[6] for r in rows), f32_step)
        print(json.dumps({"k3_issue_share": {"kerr-bl.toml": share,
                                             "instructions_per_step": f32_step}}), flush=True)
    k3_main_shape = {"kerr-bl.toml pass 1": at_main_shape(KERR_BL_TOML, FRAME, BL_CAMERA_KW,
                                                          *k3_kerr_bl.passes[0], bl_chunk)}
    del bl_chunk
    print(json.dumps({"k3_at_main_shape": k3_main_shape}), flush=True)
    if not k3_main_shape["kerr-bl.toml pass 1"]["bit_identical"]:
        fail(f"K3 at the main path's shape disagrees with its plain version: {k3_main_shape}")

    phase("10. Schwarzschild through K3 at a = 0")
    with tempfile.TemporaryDirectory() as tmp:
        toml = os.path.join(tmp, "schwarzschild-disc.toml")
        with open(toml, "w") as f:
            f.write(SCHWARZSCHILD_DISC_TOML)
        png = os.path.join(tmp, "render-schwarzschild.png")
        with K3Launches() as k3_sch:
            out, total_s, ran = cli_render(toml, SCHWARZSCHILD_SIZE, BL_CAMERA, png, (("K3", gm, "bl_launches"),))
        sch_launches, sch_ms = ran["K3"]
        if sch_launches == 0:
            fail("the Schwarzschild path launched K3 no time")
        sch = check_frame(out, png, SCHWARZSCHILD_SIZE, (1, 2), "Schwarzschild")
        if sch["hit_pixels"] == 0 or sch["stop_counts_pass1"][7] == 0:
            fail(f"no disc hit in the Schwarzschild frame: {sch}")
    sch.update({"total_s": total_s, "k3_launches": sch_launches, "k3_ms": sch_ms})
    print(json.dumps(sch), flush=True)
    k3_tables["Schwarzschild disc"] = k3_sch.table()
    print(json.dumps({"k3_launches": "Schwarzschild disc", **k3_tables["Schwarzschild disc"]}), flush=True)

    phase("11. K4 against its plain version")
    bl_sweep_flops = count_bl_sweep_flops()
    print(f"flops per ray of the BL sweep (re-forward step, reverse step, payload at the stored step; counted): "
          f"{json.dumps(bl_sweep_flops)}")
    k4_sass = sass_sweep_step("kerr_bl_adjoint.cu", "bl_adjoint_kernel", 1)
    print(json.dumps({"k4_ptxas": registers.get("kerr_bl_adjoint.cu"), "k4_sass": k4_sass}), flush=True)
    bl_sweeps = {}
    for dtype in (torch.float64, torch.float32):
        r = compare_adjoint(dtype, bl_marches[dtype], bl_spec, bl_sweep_flops, bl_consts[dtype], sass=k4_sass)
        bl_sweeps[dtype] = r
        print(json.dumps(r), flush=True)
        if not r["ok"]:
            fail(f"K4 disagrees with its plain version: {r}")
    del bl_marches

    phase("12. BL gradient path: the 12-step spin fit")
    bl_fit = bl_fit_phase()
    print(json.dumps(bl_fit), flush=True)

    phase("13. K1 and K3 with volume events against their plain versions")
    vol_marches, bl_vol_chunk, k1_vol_chunk = {}, {}, {}
    for dtype in (torch.float32, torch.float64):
        for bl in (False, True):
            if bl:
                r = compare_march(dtype, False, bl_flops_step, bl=True, attempts=BL_COMPARE_ATTEMPTS,
                                  toml=BL_VOL_TOML, size=BL_VOL_FRAME, camera=BL_CAMERA_KW,
                                  keep=bl_vol_chunk if dtype == torch.float32 else None)
            else:
                r = compare_march(dtype, False, flops_per_step, toml=VOL_TOML, size=VOL_FRAME,
                                  camera=VOL_CAMERA_KW, keep=k1_vol_chunk if dtype == torch.float32 else None)
            vol_marches[(dtype, bl)] = r
            print(json.dumps(r), flush=True)
            if not (r["ok"] and r["events"] > 0):
                fail(f"{r['kernel']} with volume events disagrees with its plain version: {r}")

    phase("14. K5 against its plain version")
    vol_ops = count_raymarch_ops()
    print(f"operations per raymarch sample (plain sample, counted): {json.dumps(vol_ops)}")
    raymarches = {}
    for dtype in (torch.float32, torch.float64):
        r = compare_raymarch(dtype, vol_ops)
        raymarches[dtype] = r
        print(json.dumps(r), flush=True)
        if not r["ok"]:
            fail(f"K5 disagrees with its plain version: {r}")

    phase("15. volumetric main path: CLI render of kerr-volumetric-streaky")
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "render-volumetric.png")
        with RaymarchSamples() as marched, K1Launches() as k1_vol:
            out, total_s, ran = cli_render(VOL_TOML, VOL_FRAME, CAMERA, png,
                                           (("K1", gm, "launches"), ("K5", vm, "launches")))
        vol_main = vol_frame_summary(out, png, VOL_FRAME, total_s, ran, "kerr-volumetric-streaky", vol_ops,
                                     marched.batch_use())
    print(json.dumps(vol_main), flush=True)
    # K1's launches: a march a pass, and a re-trace launch for a pass whose
    # rays overflowed their event slots (overflow_retraced above).
    k1_tables["kerr-volumetric-streaky"] = k1_vol.table(k1_step)
    print(json.dumps({"k1_launches": "kerr-volumetric-streaky", "overflow_retraced": vol_main["overflow_retraced"],
                      **k1_tables["kerr-volumetric-streaky"]}), flush=True)
    shape = at_main_shape(VOL_TOML, VOL_FRAME, VOL_CAMERA_KW, *k1_vol.passes[1], k1_vol_chunk)
    del k1_vol_chunk
    k1_main_shape["kerr-volumetric-streaky AA pass"] = shape
    print(json.dumps({"k1_at_main_shape": {"kerr-volumetric-streaky AA pass": shape}}), flush=True)
    if not shape["bit_identical"]:
        fail(f"K1 at the main path's shape disagrees with its plain version: {shape}")

    phase("15b. Kerr-Schild frames at two chunk sizes")
    chunks = chunk_size_phase()
    print(json.dumps({"chunk_size": chunks}), flush=True)
    if not chunks["ok"]:
        fail(f"a frame differs between --chunk-size 65536 and 2^20: {chunks}")

    phase("16. BL volumetric path: CLI render of kerr-bl-volumetric-streaky")
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "render-bl-volumetric.png")
        with RaymarchSamples() as marched, K3Launches() as k3_bl_vol:
            out, total_s, ran = cli_render(BL_VOL_TOML, BL_VOL_FRAME, BL_CAMERA, png,
                                           (("K3", gm, "bl_launches"), ("K5", vm, "launches")))
        bl_vol = vol_frame_summary(out, png, BL_VOL_FRAME, total_s, ran, "kerr-bl-volumetric-streaky", vol_ops,
                                   marched.batch_use())
    print(json.dumps(bl_vol), flush=True)
    k3_tables["kerr-bl-volumetric-streaky"] = k3_bl_vol.table()
    print(json.dumps({"k3_launches": "kerr-bl-volumetric-streaky", **k3_tables["kerr-bl-volumetric-streaky"]}),
          flush=True)
    shape = at_main_shape(BL_VOL_TOML, BL_VOL_FRAME, BL_CAMERA_KW, *k3_bl_vol.passes[1], bl_vol_chunk,
                             attempts=BL_COMPARE_ATTEMPTS)
    del bl_vol_chunk
    k3_main_shape["kerr-bl-volumetric-streaky AA pass"] = shape
    print(json.dumps({"k3_at_main_shape": {"kerr-bl-volumetric-streaky AA pass": shape}}), flush=True)
    if not shape["bit_identical"]:
        fail(f"K3 at the main path's shape disagrees with its plain version: {shape}")

    phase("17. K6 against its plain version")
    raw_marches = {}
    for dtype in (torch.float32, torch.float64):
        r = compare_raymarch_raw(dtype, vol_ops)
        raw_marches[dtype] = r
        print(json.dumps(r), flush=True)
        if not r["ok"]:
            fail(f"K6 disagrees with its plain version or with K5: {r}")

    phase("18. K7 against its plain version")
    bwd_ops = count_vol_bwd_ops()
    print(f"operations per sample of the plain backward (forward optics and their VJP, counted): "
          f"{json.dumps(bwd_ops)}")
    vol_sweeps = {}
    for dtype in (torch.float64, torch.float32):
        r = compare_vol_adjoint(dtype, bwd_ops)
        vol_sweeps[dtype] = r
        print(json.dumps(r), flush=True)
        if not r["ok"]:
            fail(f"K7 disagrees with its plain version: {r}")

    phase("18b. K7's medium sums at the full budget against central differences of K6")
    k7_fd = k7_fd_check()
    print(json.dumps(k7_fd), flush=True)
    if not k7_fd["ok"]:
        fail(f"K7's medium sums disagree with central differences of K6: {k7_fd}")

    phase("19. volumetric gradient path: the 256² medium fit")
    vol_fit = vol_fit_phase()
    print(json.dumps(vol_fit), flush=True)

    phase("20. BL volumetric gradient: kerr-bl-volumetric-streaky at 128²")
    scene, spec, x, p = vol_grad_scene(BL_VOL_TOML, BL_VOL_GRAD_SIZE, BL_CAMERA_KW)
    gm.bl_launches = vm.raw_launches = va.launches = 0
    loss, grads, grad_s = vol_value_and_grad(scene, spec, x, p)
    bl_grad = {"frame": f"{BL_VOL_GRAD_SIZE}x{BL_VOL_GRAD_SIZE}", "loss": loss, "grads": grads, "s": grad_s,
               "k3_launches": gm.bl_launches, "k6_launches": vm.raw_launches, "k7_launches": va.launches}
    print(json.dumps(bl_grad), flush=True)
    if not all(math.isfinite(v) and v != 0.0 for v in grads.values()):
        fail(f"a BL volumetric gradient is not finite or is zero: {bl_grad}")
    if 0 in (bl_grad["k3_launches"], bl_grad["k6_launches"], bl_grad["k7_launches"]):
        fail(f"the BL volumetric gradient did not launch K3, K6 and K7: {bl_grad}")

    sphere_marches = sphere_march_phases()
    sphere_renders = sphere_render_phases(k1_step)
    k1_tables["kerr-sphere.toml"] = sphere_renders["kerr-sphere.toml"]["k1_launch_table"]
    print(json.dumps({"k1_launches": "kerr-sphere.toml", **k1_tables["kerr-sphere.toml"]}), flush=True)
    k3_tables.update({name: r["k3_launch_table"] for name, r in sphere_renders.items() if "k3_launch_table" in r})
    f64_gradient_phase(vol_fit)
    sphere_sweeps, sphere_fit = sphere_gradient_phases(k2_sass)
    resumed = resume_phase()


    lax_frames, lax_checks = lax_phases()
    phase("35. the split path with K5: kerr-volumetric-streaky's gas disc beside kerr-sphere.toml's sphere")
    split = split_phase(vol_ops)
    print(json.dumps({"split": split}), flush=True)
    if not split["ok"]:
        fail(f"the split path disagrees: {split}")
    lax_grad_phases(card)

    phase("32. kernels")
    prod = variants[(torch.float32, False)]
    sweep = sweeps[torch.float32]
    bl_prod = bl_variants[(torch.float32, False)]
    bl_sweep = bl_sweeps[torch.float32]
    raymarch = raymarches[torch.float32]

    def sphere_rows(kernel):
        """The sphere comparisons of `kernel`: chunk, type, error, times."""
        keys = ("max_abs_err", "kernel_ms", "plain_ms", "attempts", "bound_ms", "sphere_events", "bit_identical")
        return [{"chunk": label, "dtype": str(dt).replace("torch.", ""), **{k: r[k] for k in keys}}
                for (k, label, dt), r in sphere_marches.items() if k == kernel]

    kernels = [{
        "name": "kerr_rk4_march",
        "route": "cuda",
        "source": "gr_raytracer_tpu_torch/csrc/kerr_rk4_march.cu",
        "replaces": "gr_raytracer_tpu/ops/geodesic_pallas.py:790",
        "launches": (launches + fit["k1_launches"] + vol_main["k1_launches"] + vol_fit["launches"]["k1"]
                     + sphere_renders["kerr-sphere.toml"]["launches"] + sphere_fit["k1_launches"]
                     + split["k1_launches"]),
        "launches_by_path": {"render": launches, "fit": fit["k1_launches"],
                             "render_volumetric": vol_main["k1_launches"],
                             "fit_volumetric": vol_fit["launches"]["k1"],
                             "render_kerr_sphere": sphere_renders["kerr-sphere.toml"]["launches"],
                             "fit_kerr_sphere": sphere_fit["k1_launches"], "render_split": split["k1_launches"]},
        "max_abs_err": max(prod["max_abs_err"], variants[(torch.float32, True)]["max_abs_err"],
                           *(r["max_abs_err"] for (k, _, dt), r in sphere_marches.items()
                             if k == "K1" and dt == torch.float32)),
        "sphere_events": sphere_rows("K1"),
        "resume": resumed["K1"],
        "registers": registers.get("kerr_rk4_march.cu"),
        "sass_common_path_instructions": {k: v["loop"]["common_path"]["instructions"] for k, v in k1_sass.items()
                                          if isinstance(v, dict) and "loop" in v},
        "launches_by_frame": {frame: {k: t.get(k) for k in ("launches", "ms", "issue_share")}
                              for frame, t in k1_tables.items()},
        "at_main_shape": k1_main_shape,
        "critical_path": prod["critical_path"],
        "ms": prod["kernel_ms"],
        "plain_ms": prod["plain_ms"],
        "bound_ms": prod["bound_ms"],
        "bound_by": prod["bound_by"],
        "library_ms": None,
    }, {
        "name": "kerr_ks_adjoint",
        "route": "cuda",
        "source": "gr_raytracer_tpu_torch/csrc/kerr_ks_adjoint.cu",
        "replaces": "gr_raytracer_tpu/ops/geodesic_adjoint.py:370",
        "launches": fit["k2_launches"] + sphere_fit["k2_launches"],
        "launches_by_path": {"fit": fit["k2_launches"], "fit_kerr_sphere": sphere_fit["k2_launches"]},
        "max_abs_err": max(sweep["max_abs_err"], sphere_sweeps[torch.float32]["max_abs_err"]),
        "registers": registers.get("kerr_ks_adjoint.cu"),
        "sass_per_step": {k: {"reforward": v.get("reforward_step"), "reverse": v.get("reverse_step")}
                          for k, v in k2_sass.items() if isinstance(v, dict)},
        "issue_share": {"fit": sweep.get("issue_share"),
                        "disc_sphere": sphere_sweeps[torch.float32].get("issue_share")},
        "critical_path": {"fit": sweep["critical_path"],
                          "disc_sphere": sphere_sweeps[torch.float32]["critical_path"]},
        "sphere_payload": [{"chunk": r["chunk"], "dtype": r["dtype"], **{k: r[k] for k in (
            "max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "lanes_within_tol", "by_slot0_kind",
            "critical_path")}}
            for r in sphere_sweeps.values()],
        "ms": sweep["kernel_ms"],
        "plain_ms": sweep["plain_ms"],
        "bound_ms": sweep["bound_ms"],
        "bound_by": sweep["bound_by"],
        "library_ms": None,
    }, {
        "name": "kerr_bl_rk4_march",
        "route": "cuda",
        "source": "gr_raytracer_tpu_torch/csrc/kerr_bl_march.cu",
        "replaces": "gr_raytracer_tpu/ops/geodesic_pallas.py:1235",
        "launches": (bl_render_launches + sch_launches + bl_fit["k3_launches"] + bl_vol["k3_launches"]
                     + bl_grad["k3_launches"] + sphere_renders["schwarzschild.toml"]["launches"]
                     + sphere_renders["schwarzschild-sphere.toml"]["launches"]),
        "launches_by_path": {"render_kerr_bl": bl_render_launches, "render_schwarzschild": sch_launches,
                             "fit": bl_fit["k3_launches"], "render_bl_volumetric": bl_vol["k3_launches"],
                             "grad_bl_volumetric": bl_grad["k3_launches"],
                             "render_schwarzschild_toml": sphere_renders["schwarzschild.toml"]["launches"],
                             "render_schwarzschild_sphere":
                                 sphere_renders["schwarzschild-sphere.toml"]["launches"]},
        "max_abs_err": max(bl_prod["max_abs_err"], bl_variants[(torch.float32, True)]["max_abs_err"],
                           *(r["max_abs_err"] for (k, _, dt), r in sphere_marches.items()
                             if k == "K3" and dt == torch.float32)),
        "sphere_events": sphere_rows("K3"),
        "resume": resumed["K3"],
        "registers": registers.get("kerr_bl_march.cu"),
        "sass_common_path_instructions": {k: v["loop"]["common_path"]["instructions"] for k, v in k3_sass.items()
                                          if isinstance(v, dict) and "loop" in v},
        "launches_by_frame": {frame: t["summary"] for frame, t in k3_tables.items()},
        "at_main_shape": k3_main_shape,
        "critical_path": bl_prod["critical_path"],
        "ms": bl_prod["kernel_ms"],
        "plain_ms": bl_prod["plain_ms"],
        "bound_ms": bl_prod["bound_ms"],
        "bound_by": bl_prod["bound_by"],
        "library_ms": None,
    }, {
        "name": "kerr_bl_adjoint",
        "route": "cuda",
        "source": "gr_raytracer_tpu_torch/csrc/kerr_bl_adjoint.cu",
        "replaces": "gr_raytracer_tpu/ops/geodesic_adjoint.py:739",
        "launches": bl_fit["k4_launches"],
        "max_abs_err": bl_sweep["max_abs_err"],
        "registers": registers.get("kerr_bl_adjoint.cu"),
        "sass_per_step": {k: {"reforward": v.get("reforward_step"), "reverse": v.get("reverse_step")}
                          for k, v in k4_sass.items() if isinstance(v, dict)},
        "issue_share": bl_sweep.get("issue_share"),
        "critical_path": bl_sweep["critical_path"],
        "ms_f64": bl_sweeps[torch.float64]["kernel_ms"],
        "ms": bl_sweep["kernel_ms"],
        "plain_ms": bl_sweep["plain_ms"],
        "bound_ms": bl_sweep["bound_ms"],
        "bound_by": bl_sweep["bound_by"],
        "library_ms": None,
    }, {
        "name": "vol_raymarch",
        "route": "cuda",
        "source": "gr_raytracer_tpu_torch/csrc/vol_raymarch.cu",
        "replaces": "gr_raytracer_tpu/ops/volumetric_pallas.py:782",
        "launches": vol_main["k5_launches"] + bl_vol["k5_launches"] + split["k5_launches"],
        "launches_by_path": {"render_volumetric": vol_main["k5_launches"],
                             "render_bl_volumetric": bl_vol["k5_launches"],
                             "render_split": split["k5_launches"]},
        "max_abs_err": raymarch["max_abs_err"],
        "ms": raymarch["kernel_ms"],
        "plain_ms": raymarch["plain_ms"],
        "plain_budget": VOL_COMPARE_STEPS,
        "ms_at_plain_budget": raymarch["kernel_ms_compare_budget"],
        "bound_ms": raymarch["bound_ms"],
        "bound_by": raymarch["bound_by"],
        "library_ms": None,
        "ms_f64": raymarches[torch.float64]["kernel_ms"],
        "ms_per_frame": {"frame_500": vol_main["k5_ms"], "bl_256": bl_vol["k5_ms"], "split_256": split["k5_ms"]},
        "launches_per_split_frame": split["k5_launches"],
        "batch_use": {"chunk": raymarch["batch_use"], "frame_500": vol_main["k5_batch_use"]["frame"],
                      "bl_256": bl_vol["k5_batch_use"]["frame"], "fit_256": vol_fit["k5_batch_use"]},
        "critical_path": {"f32": raymarch["critical_path"], "f64": raymarches[torch.float64]["critical_path"]},
        "registers": registers.get("vol_raymarch.cu"),
    }, {
        "name": "vol_raymarch_raw",
        "route": "cuda",
        "source": "gr_raytracer_tpu_torch/csrc/vol_raymarch.cu",
        "replaces": "gr_raytracer_tpu/ops/volumetric_adjoint.py:356",
        "launches": vol_fit["launches"]["k6"] + bl_grad["k6_launches"],
        "launches_by_path": {"fit_volumetric": vol_fit["launches"]["k6"],
                             "grad_bl_volumetric": bl_grad["k6_launches"]},
        "max_abs_err": raw_marches[torch.float32]["max_abs_err"],
        "ms": raw_marches[torch.float32]["kernel_ms"],
        "plain_ms": raw_marches[torch.float32]["plain_ms"],
        "plain_budget": VOL_COMPARE_STEPS,
        "ms_at_plain_budget": raw_marches[torch.float32]["kernel_ms_compare_budget"],
        "bound_ms": raw_marches[torch.float32]["bound_ms"],
        "bound_by": raw_marches[torch.float32]["bound_by"],
        "library_ms": None,
        "ms_f64": raw_marches[torch.float64]["kernel_ms"],
        "ms_per_fit_step": vol_fit["k6_ms_per_step"],
    }, {
        "name": "vol_adjoint",
        "route": "cuda",
        "source": "gr_raytracer_tpu_torch/csrc/vol_adjoint.cu",
        "replaces": "gr_raytracer_tpu/ops/volumetric_adjoint.py:395",
        "launches": vol_fit["launches"]["k7"] + bl_grad["k7_launches"],
        "launches_by_path": {"fit_volumetric": vol_fit["launches"]["k7"],
                             "grad_bl_volumetric": bl_grad["k7_launches"]},
        "max_abs_err": vol_sweeps[torch.float32]["max_abs_err"],
        "ms": vol_sweeps[torch.float32]["kernel_ms"],
        "plain_ms": vol_sweeps[torch.float32]["plain_ms"],
        "plain_budget": VOL_BWD_COMPARE_STEPS,
        "ms_at_plain_budget": vol_sweeps[torch.float32]["kernel_ms_compare_budget"],
        "bound_ms": vol_sweeps[torch.float32]["bound_ms"],
        "bound_by": vol_sweeps[torch.float32]["bound_by"],
        "library_ms": None,
        "ms_f64": vol_sweeps[torch.float64]["kernel_ms"],
        "ms_per_fit_step": vol_fit["k7_ms_per_step"],
        "full_budget_fd_rel_err": k7_fd["rel_err"],
        "registers": registers.get("vol_adjoint.cu"),
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
