"""Batched adaptive RKF45 integration with in-loop events (port of
gr_raytracer_tpu/rendering/integrator.py: its while loop, and its
reverse-mode loop of checkpointed blocks), and the integration types
shared with the kernel path.

Every ray of a batch advances through one loop. Each accepted step tests
the segment (x_prev → x_new) against the scene and folds a hit into a
bounded per-ray event buffer, ordered along the ray, so memory stays
O(1) in the step count. A rejected trial step leaves its lane where it was
for that iteration (rkf45.py); a stopped lane is a no-op in the loop body.

On the card the loop body is plain torch, replayed from a CUDA graph
(`run_lanes`): every block of iterations runs over the lanes still
RUNNING, gathered at the block's start, and the graph of one iteration
over them is captured once and replayed for the block. The host reads the
running count once a block, not once an iteration; extra iterations over
lanes that stopped inside a block are no-ops, and the attempt cap counts
iterations exactly. Events are written through masks, with no host sync.
Since the body is elementwise over lanes, a lane's result does not depend
on the lanes beside it: the compacted, replayed loop equals a one-shot run
of the body over every lane (`compact=False`) bit for bit on the card.

With IntegrationConfig(differentiable=True) the loop runs in blocks of
iterations instead (`run_blocks`), each through torch.utils.checkpoint,
every iteration dispatched eagerly: autograd records no CUDA graph.

Stop-reason priority follows the reference integrator: non-finite position
> horizon > trapped orbit > celestial sphere > non-finite momentum.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from gr_raytracer_tpu_torch.geometry import chart as charts
from gr_raytracer_tpu_torch.rendering import rkf45

# Stop codes (order encodes render semantics, not priority).
RUNNING = 0
HORIZON = 1  # -> opaque black, Captured
CELESTIAL = 2  # -> celestial texture, Escaped
NAN = 3  # -> degenerate ray, Captured
TRAPPED = 4  # closed orbit -> opaque black, Captured
BUDGET = 5  # max_steps exhausted, no stop reason -> Captured
STEP_FAILED = 6  # controller retry overflow or shading failure -> default sample
# The march stopped because an opaque object hit saturated the alpha fold:
# everything behind the first event is invisible, so color and ray class are
# exact; only the stop code cannot tell HORIZON from CELESTIAL.
SATURATED = 7

# Iterations between compactions on the card: the first block, doubled after
# each one up to the last. A compaction costs a host sync, a gather and the
# capture of one iteration's graph.
BLOCK_FIRST = 32
BLOCK_MAX = 512

# Work of run_lanes per loop name ("march", "raymarch"): calls, iterations,
# blocks (compactions on the card), lane-iterations (Σ over iterations of
# the lanes the body ran on) and host seconds (on the card up to a
# synchronize at the loop's end). Host counts, read by measurements.
loop_stats: dict = {}


def _count(name, iterations, blocks, lane_iterations, seconds):
    st = loop_stats.setdefault(name, dict(calls=0, iterations=0, blocks=0, lane_iterations=0, seconds=0.0))
    st["calls"] += 1
    st["iterations"] += iterations
    st["blocks"] += blocks
    st["lane_iterations"] += lane_iterations
    st["seconds"] += seconds


@dataclass(frozen=True)
class IntegrationConfig:
    """Integration budget. step_size and epsilon belong to the adaptive
    RKF45 path; the fixed-step kernel path reads max_radius, max_steps and
    max_events (the event slots of a ray; the render driver re-traces a ray
    that overflows them with more, rendering/raytracer.py). extra_attempts:
    iterations granted beyond max_steps for the controller's rejected
    trials. track_invariants: record the drift of k·k and of the
    geometry's constants of motion. differentiable: the reverse-mode loop
    of integrate_rays, blocks of checkpoint_block iterations, each
    checkpointed (its residuals are recomputed in the backward pass)."""

    max_radius: float
    step_size: float
    epsilon: float
    max_steps: int = 20000
    max_events: int = 8
    extra_attempts: int = 256
    track_invariants: bool = False
    differentiable: bool = False
    checkpoint_block: int = 32


class IntegrationResult(NamedTuple):
    y: torch.Tensor  # [N, 8] final state
    stop_code: torch.Tensor  # [N] int32
    steps: torch.Tensor  # [N] step count
    ev_kind: torch.Tensor  # [N, K] int32 object index, -1 = empty
    ev_data: torch.Tensor  # [N, K, 12] per-event payload
    ev_count: torch.Tensor  # [N]
    ev_overflow: torch.Tensor  # [N] bool — events dropped (buffer full)
    # The RKF45 path's (None from the kernel path):
    affine: Optional[torch.Tensor] = None  # [N] affine parameter reached
    kk_drift: Optional[torch.Tensor] = None  # [N] max |k·k| along the ray (0 if untracked)
    const_drift: Optional[torch.Tensor] = None  # [N, C] max relative drift of the constants
    h: Optional[torch.Tensor] = None  # [N] current step size (for `resume`)
    retries: Optional[torch.Tensor] = None  # [N] consecutive controller rejections


# ---------------------------------------------------------------------------
# The lane loop
# ---------------------------------------------------------------------------


def _tensors(state):
    """The tensors of a loop state: a dict's values in key order, or a
    tuple's (NamedTuple) fields."""
    return list(state.values()) if isinstance(state, dict) else list(state)


def _take_rows(state: dict, idx):
    return {k: v[idx] for k, v in state.items()}


def _put_rows(state: dict, idx, sub: dict):
    for k, v in state.items():
        v[idx] = sub[k]


class IterationGraph:
    """One iteration of `step` over fixed lanes (`state`, `lanes`), captured
    in a CUDA graph: a replay runs the kernels of an eager iteration, so it
    gives the same bits, and writes the next state into the tensors of
    `state` in place. step(state, lanes) -> the next state, of state's
    structure; it may update state's tensors in place and must not
    synchronize with the host."""

    def __init__(self, step, state, lanes):
        self.state = state
        device = _tensors(state)[0].device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            # Warm-up on copies: nothing initializes lazily inside the capture.
            copy = type(state)((k, v.clone()) for k, v in state.items()) if isinstance(state, dict) else \
                type(state)(*(v.clone() for v in state))
            step(copy, lanes)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            out = step(state, lanes)
            for dst, src in zip(_tensors(state), [out[k] for k in state] if isinstance(state, dict) else out):
                if src is not dst:
                    dst.copy_(src)

    def replay(self):
        self.graph.replay()


def run_lanes(step, state, lanes: dict, running, max_iters: int, compact: bool = True, name: str = "march",
              take=_take_rows, put=_put_rows, blocks=(BLOCK_FIRST, BLOCK_MAX), at_block=None):
    """Run `step` on the lanes of `state` for up to max_iters iterations
    while any lane is running; returns the final state. state holds the
    lanes' carried tensors (a dict of [N, ...] tensors, or what take and
    put gather and scatter), `lanes` a dict of read-only per-lane tensors
    [N, ...]; step(state, lanes) -> the next state (it may update state's
    tensors in place); running(state) -> [N] bool. A lane that is not
    running must be a no-op in `step`, so a lane's result does not depend
    on which lanes run beside it.

    compact=True: blocks of iterations (blocks[0], doubling up to
    blocks[1]) each run over the lanes running at the block's start,
    gathered (take(state, idx)) and scattered back at its end (put(state,
    idx, sub)); on CUDA tensors one iteration is captured (IterationGraph)
    and replayed for the block. at_block(it, idx, sub), when given, is
    called at each block's start. compact=False: every iteration runs
    eagerly over every lane, the running test once every blocks[0]
    iterations on CUDA, every iteration on the CPU. `name` keys the work
    counters (loop_stats)."""
    first = running(state)
    n = first.shape[0]
    it = n_blocks = work = 0
    t0 = time.perf_counter()
    if not compact:
        every = blocks[0] if first.is_cuda else 1
        while it < max_iters and bool(running(state).any()):
            n_blocks += 1
            for _ in range(min(every, max_iters - it)):
                state = step(state, lanes)
                it += 1
                work += n
        _count(name, it, n_blocks, work, time.perf_counter() - t0)
        return state
    block = blocks[0]
    while it < max_iters:
        idx = torch.nonzero(running(state)).flatten()
        if idx.numel() == 0:
            break
        sub, sub_lanes = take(state, idx), {k: v[idx] for k, v in lanes.items()}
        if at_block is not None:
            at_block(it, idx, sub)
        n_iter = min(block, max_iters - it)
        if first.is_cuda:
            graph = IterationGraph(step, sub, sub_lanes)
            for _ in range(n_iter):
                graph.replay()
            del graph
        else:
            for _ in range(n_iter):
                sub = step(sub, sub_lanes)
        put(state, idx, sub)
        it += n_iter
        n_blocks += 1
        work += n_iter * idx.numel()
        block = min(2 * block, blocks[1])
    if first.is_cuda:
        torch.cuda.synchronize(first.device)
    _count(name, it, n_blocks, work, time.perf_counter() - t0)
    return state


def run_blocks(block, state: dict, lanes: dict, running, n_blocks: int, iters: int, compact: bool,
               name: str = "march_diff"):
    """The reverse-mode form of run_lanes: n_blocks calls of block(state,
    lanes) -> the next state, each one through torch.utils.checkpoint (the
    block's residuals are dropped in the forward pass and recomputed in the
    backward), skipped from the first block at whose start no lane is
    running (one host read a block). Every tensor is written out of place:
    an in-place write into a block's input would change what its recompute
    reads, without an error. compact=True runs each block over the lanes
    running at its start, gathered and scattered back by index (both
    differentiable). `iters` counts the iterations of one block, for the
    work counters; the counters of `name` also keep the lanes each block
    ran over ("lanes_per_block")."""
    from torch.utils.checkpoint import checkpoint

    first = running(state)
    n = first.shape[0]
    it = n_done = work = 0
    tail = []
    t0 = time.perf_counter()
    for _ in range(n_blocks):
        run = running(state)
        if compact:
            idx = torch.nonzero(run).flatten()
            m = idx.numel()
            if m == 0:
                break
            sub = checkpoint(block, {k: v.index_select(0, idx) for k, v in state.items()},
                             {k: v.index_select(0, idx) for k, v in lanes.items()}, use_reentrant=False)
            state = {k: v.index_copy(0, idx, sub[k]) for k, v in state.items()}
        else:
            if not bool(run.any()):
                break
            m = n
            state = checkpoint(block, state, lanes, use_reentrant=False)
        it += iters
        n_done += 1
        work += iters * m
        tail.append(m)
    if first.is_cuda:
        torch.cuda.synchronize(first.device)
    _count(name, it, n_done, work, time.perf_counter() - t0)
    loop_stats[name].setdefault("lanes_per_block", []).extend(tail)
    return state


def _lane_fields(obj, n) -> dict:
    """The per-lane tensor fields (leading dim n) of a solver dataclass."""
    return {
        f.name: getattr(obj, f.name)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor) and getattr(obj, f.name).ndim >= 1
        and getattr(obj, f.name).shape[0] == n
    }


# ---------------------------------------------------------------------------
# integrate_rays
# ---------------------------------------------------------------------------


def integrate_rays(
    geometry,
    solver,
    cfg: IntegrationConfig,
    y0: torch.Tensor,
    segment_fn: Callable,
    event_width: int,
    resume: Optional[IntegrationResult] = None,
    attempts_budget: Optional[int] = None,
    finalize: bool = True,
    compact: bool = True,
) -> IntegrationResult:
    """Integrate a batch of rays [N, 8], streaming segment events.

    segment_fn(x_prev, cart_prev, p_prev, x_new, cart_new, p_new) ->
    (hit [N] bool, kind [N] int32, data [N, event_width]) is called once per
    iteration with native-chart positions, their Cartesian embeddings and
    contravariant momenta at both ends of each lane's step; only accepted
    steps' hits are stored. It must tolerate NaN input (hit False).

    `attempts_budget` bounds this call's iterations (default max_steps +
    extra_attempts); finalize=False leaves unfinished lanes RUNNING instead
    of BUDGET; `resume`, a previous call's result for the same lanes,
    continues its march (y0 gives only the shape then). compact=False runs
    the body over every lane each iteration, without graphs (run_lanes).

    cfg.differentiable: the reverse-mode loop (run_blocks), ⌈attempts /
    checkpoint_block⌉ whole blocks, skipped once no lane is RUNNING, as the
    JAX package's: its forward equals the loop above wherever no lane
    reaches the attempt cap (past it, the last block runs to its end).
    Its body feeds a stopped or non-finite lane a far-field state, so that
    no NaN reaches a Jacobian, and writes the event buffer through a
    one-hot slot select. On the CPU its lanes keep their places; on the
    card each block runs over the lanes running at its start."""
    chart = solver.chart
    spin = geometry.spin
    n = y0.shape[0]
    dtype, device = y0.dtype, y0.device
    k_ev = cfg.max_events

    if cfg.track_invariants:
        x0, p0 = y0[..., :4], solver.momentum(y0)
        init = geometry.constants_of_motion(x0, p0)
        const_names = sorted(init)
        init_const = (
            torch.stack([init[k] for k in const_names], dim=-1)
            if const_names
            else torch.zeros((n, 0), dtype=dtype, device=device)
        )
    else:
        const_names = []
        init_const = torch.zeros((n, 0), dtype=dtype, device=device)
    n_consts = init_const.shape[-1]

    # cfg.max_radius² in the march's dtype, as the JAX package squares it.
    max_radius_sq = float(torch.tensor(cfg.max_radius, dtype=dtype) ** 2)

    if resume is None:
        y = y0.clone()
        carry = dict(
            y=y,
            t=torch.zeros((n,), dtype=dtype, device=device),
            h=torch.clamp(torch.full((n,), cfg.step_size, dtype=dtype, device=device), rkf45.H_MIN, rkf45.H_MAX),
            steps=torch.zeros((n,), dtype=torch.int32, device=device),
            retries=torch.zeros((n,), dtype=torch.int32, device=device),
            stop=torch.zeros((n,), dtype=torch.int32, device=device),
            ev_kind=torch.full((n, k_ev), -1, dtype=torch.int32, device=device),
            ev_data=torch.zeros((n, k_ev, event_width), dtype=dtype, device=device),
            ev_count=torch.zeros((n,), dtype=torch.int32, device=device),
            ev_overflow=torch.zeros((n,), dtype=torch.bool, device=device),
            kk_drift=torch.zeros((n,), dtype=dtype, device=device),
            const_drift=torch.zeros((n, n_consts), dtype=dtype, device=device),
        )
    else:
        carry = dict(
            y=resume.y.clone(), t=resume.affine.clone(), h=resume.h.clone(), steps=resume.steps.clone(),
            retries=resume.retries.clone(), stop=resume.stop_code.clone(), ev_kind=resume.ev_kind.clone(),
            ev_data=resume.ev_data.clone(), ev_count=resume.ev_count.clone(),
            ev_overflow=resume.ev_overflow.clone(), kk_drift=resume.kk_drift.clone(),
            const_drift=resume.const_drift.clone(),
        )
    # cart_prev and p_prev are functions of the (resumed) state.
    carry["cart_prev"] = charts.to_cartesian(carry["y"][..., :4], chart, spin)
    carry["p_prev"] = solver.momentum(carry["y"])

    lanes = _lane_fields(solver, n)
    lanes["init_const"] = init_const
    max_attempts = attempts_budget if attempts_budget is not None else cfg.max_steps + cfg.extra_attempts

    def step(c, ln):
        s = dataclasses.replace(solver, **{k: v for k, v in ln.items() if k != "init_const"})
        return _body(geometry, s, cfg, segment_fn, k_ev, max_radius_sq, const_names, c, ln["init_const"])

    running = lambda c: c["stop"] == RUNNING  # noqa: E731
    # On the CPU the lanes keep their places: vectorized and scalar-tail
    # transcendentals may differ in the last bit by position.
    if cfg.differentiable:
        block = cfg.checkpoint_block

        def run_block(c, ln):
            for _ in range(block):
                c = step(c, ln)
            return c

        carry = run_blocks(run_block, carry, lanes, running, -(-max_attempts // block), block,
                           compact=compact and y0.is_cuda)
    else:
        carry = run_lanes(step, carry, lanes, running, max_attempts, compact=compact and y0.is_cuda)

    stop = carry["stop"]
    if finalize:
        stop = torch.where(stop == RUNNING, BUDGET, stop)
    return IntegrationResult(
        y=carry["y"], stop_code=stop, steps=carry["steps"], ev_kind=carry["ev_kind"],
        ev_data=carry["ev_data"], ev_count=carry["ev_count"], ev_overflow=carry["ev_overflow"],
        affine=carry["t"], kk_drift=carry["kk_drift"], const_drift=carry["const_drift"], h=carry["h"],
        retries=carry["retries"],
    )


def far_field_state(y, chart):
    """The state [N, 8] the differentiable loop steps a stopped lane from:
    at rest at r = 10 (x = 10 in the Cartesian chart), in the BL and
    spherical charts on the equator. The JAX package's (r = 10, θ = 0)
    lies on their axis, where their right-hand sides divide by sin θ: the
    step's value is NaN there, its VJP in the step size 0·NaN, and its
    reverse-mode gradients come out NaN (ROADMAP Queue 3)."""
    state = torch.zeros_like(y)
    state.narrow(-1, 1, 1).fill_(10.0)
    if chart != charts.CARTESIAN:
        state.narrow(-1, 2, 1).fill_(0.5 * math.pi)
    return state


def _body(geometry, solver, cfg, segment_fn, k_ev, max_radius_sq, const_names, c, init_const):
    """One iteration of integrate_rays over the lanes of carry `c`."""
    active = c["stop"] == RUNNING
    y, h = c["y"], c["h"]
    y_rhs = y
    if cfg.differentiable:
        # A stopped or non-finite lane steps from a far-field state: a NaN
        # in a Jacobian would turn its zero cotangent into NaN. Its step is
        # masked out below, so nothing of it reaches a gradient.
        lane_ok = torch.all(torch.isfinite(y), dim=-1) & active
        y_rhs = torch.where(lane_ok[:, None], y, far_field_state(y, solver.chart))

    y_trial, err = rkf45.rkf45_step(solver.rhs, y_rhs, h)
    accept, h_acc, h_rej = rkf45.controller(h, err, cfg.epsilon)

    retry_overflow = (~accept) & (c["retries"] + 1 >= rkf45.MAX_RETRIES)
    adv = active & accept
    rejected = active & ~accept

    y_new = torch.where(adv[:, None], y_trial, y)
    t_new = torch.where(adv, c["t"] + h, c["t"])
    h_new = torch.where(active, torch.where(accept, h_acc, h_rej), h)
    retries = torch.where(adv, 0, torch.where(rejected, c["retries"] + 1, c["retries"]))
    steps = c["steps"] + adv.to(torch.int32)

    # Stop determination, in priority order.
    xn = y_new[..., :4]
    pos_finite = torch.all(torch.isfinite(xn), dim=-1)
    horizon = geometry.inside_horizon(xn)
    trapped = geometry.closed_orbit(xn, steps, cfg.max_steps)
    cart_new = charts.to_cartesian(xn, solver.chart, geometry.spin)
    rho_sq = cart_new[..., 1] * cart_new[..., 1] + cart_new[..., 2] * cart_new[..., 2] + cart_new[..., 3] * cart_new[..., 3]
    escaped = rho_sq > max_radius_sq
    mom_finite = torch.all(torch.isfinite(y_new[..., 4:8]), dim=-1)

    stop = c["stop"]
    code = torch.full_like(stop, RUNNING)
    code = torch.where(~mom_finite, NAN, code)
    code = torch.where(escaped, CELESTIAL, code)
    code = torch.where(trapped, TRAPPED, code)
    code = torch.where(horizon, HORIZON, code)
    code = torch.where(~pos_finite, NAN, code)
    # Budget exhausted without a stop reason.
    code = torch.where((code == RUNNING) & (steps >= cfg.max_steps - 1), BUDGET, code)
    new_stop = torch.where(adv, code, stop)
    new_stop = torch.where(rejected & retry_overflow, STEP_FAILED, new_stop)

    # Streaming intersection on the accepted segment: the hit goes to slot
    # ev_count of its lane, through masks (no host sync).
    p_new = solver.momentum(y_new)
    hit, kind, data = segment_fn(y[..., :4], c["cart_prev"], c["p_prev"], xn, cart_new, p_new)
    store = hit & adv
    ev_count = c["ev_count"]
    can_store = store & (ev_count < k_ev)
    ev_kind, ev_data = c["ev_kind"], c["ev_data"]
    if cfg.differentiable:
        # Out of place, through a one-hot slot select (a block's input must
        # stay as it was for the block's recompute).
        slots = (torch.arange(k_ev, device=y.device)[None, :] == ev_count[:, None]) & can_store[:, None]
        ev_kind = torch.where(slots, kind[:, None], ev_kind)
        ev_data = torch.where(slots[..., None], data[:, None, :], ev_data)
    else:
        slot = torch.clamp(ev_count, max=k_ev - 1).to(torch.int64)
        rows = torch.arange(y.shape[0], device=y.device)
        ev_kind[rows, slot] = torch.where(can_store, kind, ev_kind[rows, slot])
        ev_data[rows, slot] = torch.where(can_store[:, None], data, ev_data[rows, slot])

    out = dict(
        y=y_new, t=t_new, h=h_new, steps=steps, retries=retries, stop=new_stop,
        cart_prev=torch.where(adv[:, None], cart_new, c["cart_prev"]),
        p_prev=torch.where(adv[:, None], p_new, c["p_prev"]),
        ev_kind=ev_kind, ev_data=ev_data, ev_count=ev_count + can_store.to(torch.int32),
        ev_overflow=c["ev_overflow"] | (store & (ev_count >= k_ev)),
        kk_drift=c["kk_drift"], const_drift=c["const_drift"],
    )
    if cfg.track_invariants:
        kk = torch.abs(geometry.inner_product(xn, p_new, p_new))
        out["kk_drift"] = torch.where(adv, torch.maximum(c["kk_drift"], kk), c["kk_drift"])
        if const_names:
            cur = geometry.constants_of_motion(xn, p_new)
            cur_vec = torch.stack([cur[k] for k in const_names], dim=-1)
            denom = torch.where(torch.abs(init_const) > 1e-12, torch.abs(init_const), 1.0)
            drift = torch.abs(cur_vec - init_const) / denom
            out["const_drift"] = torch.where(adv[:, None], torch.maximum(c["const_drift"], drift), c["const_drift"])
    return out


def no_objects_segment_fn(event_width: int = 1):
    """segment_fn for object-free scenes (tests)."""

    def fn(x_prev, cart_prev, p_prev, x_new, cart_new, p_new):
        n = x_prev.shape[0]
        return (
            torch.zeros((n,), dtype=torch.bool, device=x_prev.device),
            torch.zeros((n,), dtype=torch.int32, device=x_prev.device),
            torch.zeros((n, event_width), dtype=x_prev.dtype, device=x_prev.device),
        )

    return fn
