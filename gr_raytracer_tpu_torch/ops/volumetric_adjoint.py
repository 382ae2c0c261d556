"""Reverse mode through the volumetric raymarch (counterpart of
gr_raytracer_tpu/ops/volumetric_adjoint.py).

  forward   K6 (ops/volumetric_march.raymarch_raw): K5's march with the
            five medium parameters read at run time from a [5] tensor and
            the raw reductions out (acc XYZ, transparency T_f, Σ alpha
            weights Ws, Wt); `combine_alpha` makes XYZA of them outside the
            kernel, where autograd differentiates it.
  backward  K7 (csrc/vol_adjoint.cu): a second march in forward order. The
            reductions are A = Σ w_i e_i with w_i = T_i·att_i²·σ_s·ρ_i·d_s
            and T_{i+1} = T_i·att_i, so every cotangent is a per-sample term
            plus a suffix sum over later weights,
                dL/dρ_i = (ct_A·e_i) ∂w_i/∂ρ_i − d_s σ (G_i + ct_T T_f)
                          + (ct_Ws α_i + ct_Wt) d_s m_i,
                G_i = s_tot − Σ_{j≤i} (ct_A·e_j) w_j,   s_tot = ct_A·A,
            and the march replays the forward's k-grid, hole jump and
            saturation exit exactly, rebuilds T_i, and pushes the
            per-sample cotangents through the optics of the sample. O(1)
            memory: nothing is saved but acc and T_f.

For tensors on the card the backward launches K7; for tensors on the CPU it
runs `vol_march_bwd_plain`, the same replay in plain torch with the
per-sample VJP by torch.autograd.grad of the plain optics
(volumetric_march._sample_optics), the counterpart of the JAX kernel's
in-kernel jax.vjp.

Differentiated: the five medium parameters (MED_NAMES) and the per-lane ray
inputs (ro, rd, obs_e, p_t, p_phi). Locally constant, as in the JAX
package: the march bounds, the hole jump, the saturation step, exit_d and
active (no cotangent).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gr_raytracer_tpu_torch.objects.volumetric_disc import ALPHA_WT_MIN, SATURATION_EPS
from gr_raytracer_tpu_torch.ops import volumetric_march as vm

CT_VARS = 8  # ct_acc xyz | ct_T | ct_Ws | ct_Wt | s_tot | T_f
DIN_VARS = 9  # d_ro xyz | d_rd xyz | d_obs_e | d_p_t | d_p_phi
N_MED = len(vm.MED_NAMES)

# Launches of K7 (the plain version does not count). When launch_timer is a
# list, each launch appends its (start, end) CUDA events.
launches = 0
launch_timer = None


def combine_alpha(acc, t_fin, a_w_sum, a_w_tot):
    """XYZA [N, 4] from the raw reductions: K5's epilogue, op for op. The
    ALPHA_WT_MIN gate keeps d(Ws/Wt)/dWt = −Ws/Wt² finite on lanes whose
    weights underflow (JAX: the f32 NaN that reached dm and off on the
    TPU)."""
    physical_opacity = 1.0 - t_fin
    ok = a_w_tot > ALPHA_WT_MIN
    texture_alpha = torch.where(ok, a_w_sum / torch.where(ok, a_w_tot, 1.0), 1.0)
    alpha = physical_opacity * texture_alpha
    return torch.cat([acc, alpha[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# The backward in plain torch: K7's arithmetic
# ---------------------------------------------------------------------------


class _BwdLanes(NamedTuple):
    """The plain backward's per-lane inputs and carry, [N] each (ro, rd
    [N, 3], cts [N, CT_VARS], d_in [N, DIN_VARS], d_med [N, 5]: ∂dm, ∂off,
    ∂σ, the direct ∂σ_s and ∂br)."""

    ro: torch.Tensor
    rd: torch.Tensor
    obs_e: torch.Tensor
    p_t: torch.Tensor
    p_phi: torch.Tensor
    d_hi: torch.Tensor
    i_lo: torch.Tensor
    i_hi: torch.Tensor
    k_hole_exit: torch.Tensor
    cts: torch.Tensor
    k: torch.Tensor
    trans: torch.Tensor
    s_pref: torch.Tensor
    done: torch.Tensor
    d_in: torch.Tensor
    d_med: torch.Tensor


_BWD_CARRY = ("k", "trans", "s_pref", "done", "d_in", "d_med")


def _bwd_step(spec, c, med: vm.Medium, s: _BwdLanes) -> _BwdLanes:
    """One sample of every lane of `s`, JAX's _bwd_kernel sub_sample op for
    op; done lanes stay frozen. Done lanes of the batch are evaluated at a
    mid-disc position with zero cotangents: every intermediate is finite
    there, so no 0·inf enters the sums."""
    d_s = spec.step_size
    live = ~s.done
    live_f = live.to(s.trans.dtype)
    d_o = s.k * d_s
    p = s.ro + s.rd * d_o[:, None]
    safe_p = 0.5 * (spec.inner + spec.outer)
    pos = (torch.where(live, p[:, 0], safe_p), torch.where(live, p[:, 1], 0.0), torch.where(live, p[:, 2], 0.0))
    n = s.k.shape[0]
    per_lane = lambda v: v.detach().expand(n).clone()
    leaves = [v.detach().requires_grad_(True) for v in (*pos, s.obs_e, s.p_t, s.p_phi)] + [
        per_lane(v).requires_grad_(True) for v in (med.dm, med.off, med.br)
    ]
    with torch.enable_grad():
        optics = vm._sample_optics(spec, c, *leaves[:6], vm.Medium(leaves[6], leaves[7], None, None, leaves[8]))
    density_raw, emit_ok, ex, ey, ez, lalpha = (v.detach() for v in optics)

    rho = torch.where(live, density_raw, 0.0)
    tau = d_s * rho
    # The forward's attenuation, in its op order: the transparency carry,
    # and with it the saturation step, replays bit for bit.
    att = torch.exp(-d_s * rho * med.sigma)
    trans = torch.where(live, s.trans * att, s.trans)
    m = (live & emit_ok).to(rho.dtype)

    ct_ax, ct_ay, ct_az, ct_t, ct_ws, ct_wt, s_tot, t_f = s.cts.unbind(1)
    att2 = att * att
    v = s.trans * att2 * rho * d_s * m  # w / σ_s
    w = med.ss * v
    ce = ct_ax * ex + ct_ay * ey + ct_az * ez
    cw = ce * w
    s_pref = s.s_pref + cw
    g_suf = s_tot - s_pref  # Σ_{j>i} cw_j
    common = g_suf + ct_t * t_f
    alpha_cl_grad = ((lalpha > 0.0) & (lalpha < 1.0)).to(rho.dtype)
    d_rho = (
        ce * med.ss * s.trans * att2 * d_s * m * (1.0 - 2.0 * d_s * med.sigma * rho)
        - d_s * med.sigma * common * live_f
        + (ct_ws * torch.clamp(lalpha, 0.0, 1.0) + ct_wt) * d_s * m
    )
    d_la = ct_ws * rho * d_s * m * alpha_cl_grad
    outs = (optics[0], optics[2], optics[3], optics[4], optics[5])
    cots = (d_rho * live_f, ct_ax * w, ct_ay * w, ct_az * w, d_la)
    keep = [i for i, o in enumerate(outs) if o.requires_grad]
    grads = torch.autograd.grad([outs[i] for i in keep], leaves, [cots[i] for i in keep], allow_unused=True)
    g_px, g_py, g_pz, g_obs, g_pt, g_pp, g_dm, g_off, g_br = (
        torch.zeros_like(leaf) if g is None else g for g, leaf in zip(grads, leaves)
    )

    d_p = torch.stack([g_px, g_py, g_pz], dim=1)
    d_in = s.d_in + torch.cat([d_p, d_p * d_o[:, None], torch.stack([g_obs, g_pt, g_pp], dim=1)], dim=1)
    # σ = σ_a + σ_s structure terms: dL/dσ += −τ_i (G_i + 2 cw_i + ct_T T_f);
    # dL/dσ_s += (ct_A·e_i) v_i.
    d_med = s.d_med + torch.stack([g_dm, g_off, -tau * (common + 2.0 * cw), ce * v, g_br], dim=1)

    k_next = vm._next_k(spec, s, s.k)
    done = s.done | (k_next * d_s >= s.d_hi) | (trans < SATURATION_EPS)
    return s._replace(k=torch.where(live, k_next, s.k), trans=trans, s_pref=s_pref, done=done, d_in=d_in,
                      d_med=d_med)


def _check_cts(cts, ro):
    if cts.shape != (ro.shape[0], CT_VARS) or cts.dtype != ro.dtype or cts.device != ro.device:
        raise ValueError(f"cts must be [N, {CT_VARS}] of ro's dtype and device, got {tuple(cts.shape)} {cts.dtype}")


def vol_march_bwd_plain(spec: vm.VolSpec, med, ro, rd, obs_e, p_t, p_phi, active, exit_d, cts):
    """K7's plain version. The lanes as `raymarch_raw`'s, cts [N, CT_VARS]
    (the cotangents of acc, T_f, Ws and Wt, s_tot = ct_acc·acc and T_f).
    Returns (d_in [N, DIN_VARS]: ∂ro, ∂rd, ∂obs_e, ∂p_t, ∂p_phi; d_med
    [N, 5]: each lane's partials of the MED_NAMES). Lanes are re-gathered
    every few samples, as in the plain forward."""
    vm._check_args(spec, ro, rd, obs_e, p_t, p_phi, active, exit_d, med)
    _check_cts(cts, ro)
    c = vm._constants(spec, ro.dtype, ro.device)
    k0, d_hi, empty, i_lo, i_hi, k_hole_exit = vm._march_bounds(spec, c, ro, rd, exit_d, active)
    n = ro.shape[0]
    zeros = torch.zeros(n, dtype=ro.dtype, device=ro.device)
    lanes = _BwdLanes(
        ro, rd, obs_e, p_t, p_phi, d_hi, i_lo, i_hi, k_hole_exit, cts, k0, torch.ones_like(zeros), zeros,
        empty.clone(), ro.new_zeros((n, DIN_VARS)), ro.new_zeros((n, N_MED)),
    )
    medium = vm._medium(spec, c, med.detach())
    vm.march_compacted(lanes, lambda s: _bwd_step(spec, c, medium, s), _BWD_CARRY, spec.max_steps)
    g = lanes.d_med
    d_med = torch.stack([g[:, 0], g[:, 1], g[:, 2], g[:, 2] + g[:, 3], g[:, 4]], dim=1)
    return lanes.d_in, d_med


# ---------------------------------------------------------------------------
# The CUDA kernel K7
# ---------------------------------------------------------------------------

_bound: dict = {}


def _entry(dtype):
    """K7's C entry point for `dtype`, built on first use."""
    fn = _bound.get(dtype)
    if fn is None:
        from gr_raytracer_tpu_torch.ops import cuda_build

        lib = cuda_build.load("vol_adjoint.cu")
        fn = getattr(lib, "vol_adjoint_f32" if dtype == torch.float32 else "vol_adjoint_f64")
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.POINTER(vm._HostParams)] + [p] * 9 + [ctypes.c_int64, p, p, p]
        fn.restype = ctypes.c_int
        _bound[dtype] = fn
    return fn


def vol_march_bwd(spec: vm.VolSpec, med, ro, rd, obs_e, p_t, p_phi, active, exit_d, cts):
    """The backward: K7 (csrc/vol_adjoint.cu) for tensors on the card,
    `vol_march_bwd_plain` for tensors on the CPU. Same arguments and
    results as `vol_march_bwd_plain`."""
    global launches
    vm._check_args(spec, ro, rd, obs_e, p_t, p_phi, active, exit_d, med)
    _check_cts(cts, ro)
    if ro.device.type == "cpu":
        return vol_march_bwd_plain(spec, med, ro, rd, obs_e, p_t, p_phi, active, exit_d, cts)
    ins = (ro, rd, obs_e, p_t, p_phi, exit_d, active, cts)
    vm._cuda_lanes(ins)
    n = ro.shape[0]
    d_in = ro.new_empty((n, DIN_VARS))
    d_med = ro.new_empty((n, N_MED))
    med = med.detach().contiguous()
    hp = vm._host_params(spec)
    vm._launch("vol_adjoint", _entry(ro.dtype), launch_timer, ro.device, ctypes.byref(hp), med.data_ptr(),
               *(v.data_ptr() for v in ins), n, d_in.data_ptr(), d_med.data_ptr())
    launches += 1
    return d_in, d_med


# ---------------------------------------------------------------------------
# The differentiable march
# ---------------------------------------------------------------------------


class _VolMarchDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, med, ro, rd, obs_e, p_t, p_phi, active, exit_d, spec):
        acc, t_fin, ws, wt = vm.raymarch_raw(spec, med, ro, rd, obs_e, p_t, p_phi, active, exit_d)
        # The committed totals the suffix sums need (JAX's march_fwd).
        ctx.save_for_backward(med, ro, rd, obs_e, p_t, p_phi, active, exit_d, acc, t_fin)
        ctx.spec = spec
        return acc, t_fin, ws, wt

    @staticmethod
    def backward(ctx, ct_acc, ct_t, ct_ws, ct_wt):
        med, ro, rd, obs_e, p_t, p_phi, active, exit_d, acc, t_fin = ctx.saved_tensors
        s_tot = torch.sum(ct_acc * acc, dim=-1)
        cts = torch.stack([*ct_acc.unbind(1), ct_t, ct_ws, ct_wt, s_tot, t_fin], dim=1)
        d_in, d_med = vol_march_bwd(ctx.spec, med, ro, rd, obs_e, p_t, p_phi, active, exit_d, cts)
        return (d_med.sum(dim=0), d_in[:, 0:3], d_in[:, 3:6], d_in[:, 6], d_in[:, 7], d_in[:, 8],
                None, None, None)


def make_vol_march_diff(spec: vm.VolSpec):
    """The differentiable raymarch for a static VolSpec: fn(med, ro, rd,
    obs_e, p_t, p_phi, active, exit_d) → (acc [N, 3], T_f, Ws, Wt [N]) with
    med [5] (MED_NAMES) and the lanes as `raymarch_raw` takes them;
    gradients flow to med and to ro, rd, obs_e, p_t and p_phi. Callers
    combine XYZA with `combine_alpha`."""

    def march(med, ro, rd, obs_e, p_t, p_phi, active, exit_d):
        return _VolMarchDiff.apply(med, ro, rd, obs_e, p_t, p_phi, active, exit_d, spec)

    return march
