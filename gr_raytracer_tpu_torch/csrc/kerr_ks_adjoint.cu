// Checkpointed reverse sweep of the Kerr-Schild march: the adjoint λ and
// the parameter partials ∂L/∂radius, ∂L/∂a for every lane.
//
// Replaces the TPU kernel gr_raytracer_tpu/ops/geodesic_adjoint.py
// make_ks_march_diff (pallas_call body _bwd_kernel). The plain torch
// version is gr_raytracer_tpu_torch/ops/geodesic_adjoint.py::
// ks_march_bwd_plain.
//
// Per lane (one thread, as in the march kernel kerr_rk4_march.cu), the
// segments of K steps run in reverse order. A segment loads its checkpoint
// (the pre-step state the march wrote every K steps), re-forwards its
// k_eff = min(K, steps − seg·K) steps with the march's own arithmetic
// (kerr_ks_common.cuh, the same -fmad=false build), so the trajectory is
// replayed bit for bit, and keeps the pre-step states in a global scratch
// buffer [K, 8, N], lanes fastest so that the accesses coalesce. Then it
// walks those states backwards and applies the VJP of the step map
// G: y ↦ (y_new, slot-0 payload). The TPU kernel gates a segment on its
// block's max(steps); gating per lane on seg·K < steps is equivalent,
// because an inactive step is the identity on λ with zero partials.
//
// The step VJP is written by hand in reverse mode (step_vjp): a forward
// pass keeps the stage slopes k1..k3 in registers (the stage inputs
// y + c·h·k are rebuilt from them, bit for bit), then one backward pass
// takes the RK4 combination δ = h/6·(k1 + 2k2 + 2k3 + k4), each stage's
// y + c·h·k, the right-hand side at each stage (rhs_vjp: rhs's lines, which
// already hold ∂H/∂x, walked in reverse), the far-field lever and the step
// size h(r, r₊(radius, a)). A reverse step so costs about a forward step
// and four right-hand-side VJPs, where the dual-number columns it replaces
// evaluated the whole step ten times. t enters no line of the step, so
// its λ passes through.
//
// What bounds it on the card: the longest lanes. One thread walks a
// lane's whole reverse chain, so a launch lasts as long as its longest
// lane's re-forward and reverse steps; the work of a step is now a few
// forward steps, against a few hundred bytes of scratch traffic.
//
// The payload is evaluated only at the step that stored slot 0 (the lane's
// last, peeled off ahead of the reverse loop), where its cotangent enters:
// the disc payload, or the sphere payload when the slot-0 kind is a
// sphere's (or the scene has no disc). That one step a hit lane keeps the
// forward-mode dual numbers: G is templated on its scalar type and
// evaluated ten times in Dual<T>, seeded with the eight state directions,
// radius and a, and each Jacobian column contracts with the cotangents:
//     λ_new_j = Σ_i λ_i ∂y_new_i/∂y_j + Σ_m ct_m ∂payload_m/∂y_j.
// The sphere payload replays the march's crossing (sphere_events.cuh) with
// the JAX VJP's guards: sqrt(max(disc, 1e-30)), |a| > 1e-30, the + root
// where it lies in [0, 1] (a choice on values), cos θ clipped by a select
// and θ = π/2 − atan(cos θ / sin θ) with sin θ = sqrt(max(1 − cos², 1e-30)),
// whose derivative stays finite at cos θ = 0 (atan2's does not). The
// sphere table's rows come from the host in double as the march's do, so
// the replayed crossing sees the forward's constants.
//
// Conventions of the JAX VJP kept here: masks are selects (the untaken
// branch gets no derivative); r₊'s sqrt and the far-field speed are
// guarded by max(·, 1e-30) in the differentiated step (the march and the
// re-forward use 0 and no guard, the same values on every real lane); a
// tie in nmax/nmin splits the tangent half and half (d_max, d_min); the
// payload guards (|dz| ≥ 1e-12, the sqrt(max(·, 1e-30)) guards, disc
// bounds selected by the slot-0 kind); a lane whose state is not finite
// passes λ through; the payload cotangent enters only at the lane's last
// step on lanes with an event; the trust region on every λ component and
// both per-step partials, and once on the incoming cotangent (the TPU
// kernel applies it also on steps where the lane is inactive). Partials
// are written per lane, without atomics, so the result is deterministic;
// the wrapper sums them.

#include "kerr_ks_common.cuh"
#include "sphere_events.cuh"

namespace {

using namespace ks;

constexpr int kThreads = 128;
constexpr double kLamCap = 1e15;  // LAM_CAP in ops/geodesic_adjoint.py

template <typename T>
struct AdjParams {
  T radius, a;
  StepRule<T> rule;  // h0, h_min_frac, r_ref, r_safe
  T disc_inner[kMaxDiscs];
  T disc_outer[kMaxDiscs];
  int disc_kind[kMaxDiscs];
  int n_discs;
  SphereTable<T> spheres;
  int n_seg;
  int k_ckpt;
};

__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ bool all_finite(const T* y) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 8; ++i) ok = ok && is_finite(y[i]);
  return ok;
}

// The slot-0 disc payload of the step y → y_new (_disc_payload): the
// crossing fraction, the point (px, py, 0) and the disc UV.
template <typename S, typename T>
__device__ __forceinline__ void disc_payload(const AdjParams<T>& P, const S* y, const S* y_new,
                                             int kind0, S& frac, S* point, S& u, S& v) {
  const S den_raw = y[3] - y_new[3];
  const bool ok = abs_(value(den_raw)) >= T(1e-12);
  frac = (ok ? y[3] : S(0)) / (ok ? den_raw : S(1));
  const S px = y[1] + frac * (y_new[1] - y[1]);
  const S py = y[2] + frac * (y_new[2] - y[2]);
  const S rr = sqrt_(nmax(px * px + py * py, S(1e-30)));
  const S phi = atan2_(py, px);
  T inner = P.disc_inner[0], outer = P.disc_outer[0];
  for (int d = 1; d < P.n_discs; ++d) {
    if (kind0 == P.disc_kind[d]) {
      inner = P.disc_inner[d];
      outer = P.disc_outer[d];
    }
  }
  const S r_norm = (rr - S(inner)) / S(outer - inner);
  point[0] = px;
  point[1] = py;
  point[2] = S(0);
  u = S(0.5) + S(0.5) * r_norm * cos_(phi);
  v = S(0.5) + S(0.5) * r_norm * sin_(phi);
}

// The slot-0 payload of sphere i for the step y → y_new (_sphere_payload):
// the crossing fraction t, the world point and the local spherical UV.
template <typename S, typename T>
__device__ __forceinline__ void sphere_payload(const SphereTable<T>& SP, int i, const S* y,
                                               const S* y_new, S& t, S* point, S& u, S& v) {
  const T pi = T(3.141592653589793), two_pi = T(2.0 * 3.141592653589793);
  const S c[3] = {S(SP.cx[i]), S(SP.cy[i]), S(SP.cz[i])};
  S d[3], s_loc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    d[k] = y_new[1 + k] - y[1 + k];
    s_loc[k] = y[1 + k] - c[k];
  }
  const S a_q = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  const S b_q = S(2) * (s_loc[0] * d[0] + s_loc[1] * d[1] + s_loc[2] * d[2]);
  const S c_q = (s_loc[0] * s_loc[0] + s_loc[1] * s_loc[1] + s_loc[2] * s_loc[2]) - S(SP.radius2[i]);
  const S disc = b_q * b_q - S(4) * a_q * c_q;
  const S sq = sqrt_(nmax(disc, S(1e-30)));
  const S safe_a = abs_(value(a_q)) > T(1e-30) ? a_q : S(1);
  const S t1 = (-b_q + sq) / (S(2) * safe_a);
  const S t2 = (-b_q - sq) / (S(2) * safe_a);
  t = (value(t1) >= T(0) && value(t1) <= T(1)) ? t1 : t2;
  S local[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) local[k] = s_loc[k] + t * d[k];
  const S r_loc = sqrt_(nmax(local[0] * local[0] + local[1] * local[1] + local[2] * local[2], S(1e-30)));
  const S cos_th = clip(local[2] / r_loc, S(-1), S(1));
  const S sin_th = sqrt_(nmax(S(1) - cos_th * cos_th, S(1e-30)));
  const S theta = S(T(0.5) * pi) - atan_(cos_th / sin_th);
  const S phi = atan2_(local[1], local[0]);
#pragma unroll
  for (int k = 0; k < 3; ++k) point[k] = local[k] + c[k];
  u = S(1) - (S(pi) + phi) / S(two_pi);
  v = theta / S(pi);
}

// The step map G (ops/geodesic_adjoint.py _step_with_payload): y_new and,
// when `with_payload`, the slot-0 payload [point3 | p_interp4 | uv2 |
// seg3] of the disc or the sphere that the slot-0 kind names.
template <typename S, typename T>
__device__ __forceinline__ void step_map(const AdjParams<T>& P, S radius, S a, const S* y, int kind0,
                                         bool with_payload, S* y_new, S* payload) {
  const S m = S(0.5) * radius;
  const S r_plus = m + sqrt_(nmax(m * m - a * a, S(1e-30)));
  const S r_here = ks_radius(a, y[1], y[2], y[3]);
  S delta[8];
  rk4_delta<true>(P.rule, radius, a, r_plus, r_here, y, delta);
#pragma unroll
  for (int i = 0; i < 8; ++i) y_new[i] = y[i] + delta[i];
  if (!with_payload) return;

  // The sphere the slot-0 kind names; a scene of spheres alone takes the
  // first where it names none, as the JAX payload's select chain does.
  int sphere = -1;
  for (int i = 0; i < P.spheres.n; ++i) {
    if (kind0 == P.spheres.kind[i]) sphere = i;
  }
  if (sphere < 0 && P.n_discs == 0) sphere = 0;
  S frac, u, v;
  if (sphere >= 0) {
    sphere_payload(P.spheres, sphere, y, y_new, frac, payload, u, v);
  } else {
    disc_payload(P, y, y_new, kind0, frac, payload, u, v);
  }
  S p_prev[4], p_new[4];
  momentum_contra(radius, a, y, p_prev);
  momentum_contra(radius, a, y_new, p_new);
#pragma unroll
  for (int i = 0; i < 4; ++i) payload[3 + i] = p_prev[i] + frac * (p_new[i] - p_prev[i]);
  payload[7] = u;
  payload[8] = v;
#pragma unroll
  for (int i = 0; i < 3; ++i) payload[9 + i] = y_new[1 + i] - y[1 + i];
}

// The terms of the differentiated step that depend on the lane alone: r₊
// with its guarded sqrt (its value is the march's on every sub-extremal
// spin) and the pieces its VJP needs.
template <typename T>
struct StepTerms {
  T m, z_rp, s_rp, r_plus;
};

template <typename T>
__device__ __forceinline__ StepTerms<T> step_terms(T radius, T a) {
  StepTerms<T> S;
  S.m = T(0.5) * radius;
  S.z_rp = S.m * S.m - a * a;
  S.s_rp = sqrt_(nmax(S.z_rp, T(1e-30)));
  S.r_plus = S.m + S.s_rp;
  return S;
}

// The VJP of one step y ↦ y_new (rk4_delta<true>, no payload) along λ,
// in reverse mode: out[0..7] = λ_new, out[8] = ∂radius, out[9] = ∂a
// (ops/geodesic_adjoint.py ks_step_vjp, line for line).
template <typename T>
__device__ __forceinline__ void step_vjp(const AdjParams<T>& P, const StepTerms<T>& S, const T* y,
                                         const T* lam, T* out) {
  const T radius = P.radius, a = P.a;
  const StepRule<T>& R = P.rule;
  // Forward: the step with its stage slopes k1..k3 kept.
  const T r_here = ks_radius(a, y[1], y[2], y[3]);
  const T g_raw = (r_here - S.r_plus) / R.r_ref;
  T h = R.h0 * clip(g_raw, R.h_min_frac, T(1));
  T k1[8], k2[8], k3[8], tmp[8], kb[8], tb[8];
  rhs(radius, a, y, k1);
  bool far = false;
  T rho = T(0), speed2 = T(0), speed = T(0), a1 = T(0), a2 = T(0), den = T(1), h_far = T(0), h_base = h;
  if (R.r_safe > T(0)) {
    rho = sqrt_(y[1] * y[1] + y[2] * y[2] + y[3] * y[3]);
    speed2 = k1[1] * k1[1] + k1[2] * k1[2] + k1[3] * k1[3];
    speed = sqrt_(nmax(speed2, T(1e-30)));
    const bool outward = (y[1] * k1[1] + y[2] * k1[2] + y[3] * k1[3]) > T(0);
    a1 = T(0.5) * (rho - R.r_safe);
    a2 = T(0.125) * rho;
    den = nmax(speed, T(1e-12));
    h_far = nmin(a1, a2) / den;
    far = outward && rho > R.r_safe;
    if (far) h = nmax(h, h_far);
  }
  const T half_h = T(0.5) * h;
#pragma unroll
  for (int i = 0; i < 8; ++i) tmp[i] = y[i] + half_h * k1[i];
  rhs(radius, a, tmp, k2);
#pragma unroll
  for (int i = 0; i < 8; ++i) tmp[i] = y[i] + half_h * k2[i];
  rhs(radius, a, tmp, k3);
#pragma unroll
  for (int i = 0; i < 8; ++i) tmp[i] = y[i] + h * k3[i];
  rhs(radius, a, tmp, kb);  // k4
  const T h6 = h / T(6);
  // Backward: δ = h/6·(k1 + 2k2 + 2k3 + k4), y_new = y + δ.
  T h6_b = T(0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    h6_b = h6_b + lam[i] * (k1[i] + T(2) * k2[i] + T(2) * k3[i] + kb[i]);
    out[i] = lam[i];
  }
  T h_b = h6_b / T(6), rb = T(0), ab = T(0);
  // Stage 4 at y + h·k3 (tmp), with k̄4 = h/6·λ.
#pragma unroll
  for (int i = 0; i < 8; ++i) kb[i] = h6 * lam[i];
  rhs_vjp(radius, a, tmp, kb, tb, rb, ab);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    out[i] = out[i] + tb[i];
    h_b = h_b + tb[i] * k3[i];
    kb[i] = T(2) * (h6 * lam[i]) + h * tb[i];
    tmp[i] = y[i] + half_h * k2[i];
  }
  // Stage 3 at y + h/2·k2.
  rhs_vjp(radius, a, tmp, kb, tb, rb, ab);
  T half_b = T(0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    out[i] = out[i] + tb[i];
    half_b = half_b + tb[i] * k2[i];
    kb[i] = T(2) * (h6 * lam[i]) + half_h * tb[i];
    tmp[i] = y[i] + half_h * k1[i];
  }
  // Stage 2 at y + h/2·k1.
  rhs_vjp(radius, a, tmp, kb, tb, rb, ab);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    out[i] = out[i] + tb[i];
    half_b = half_b + tb[i] * k1[i];
    kb[i] = h6 * lam[i] + half_h * tb[i];
  }
  h_b = h_b + T(0.5) * half_b;
  // The far-field lever: h = max(h0·clip(·), h_far) on an outward lane
  // beyond r_safe, h_far = min(½(ρ − r_safe), ρ/8) / max(|v|, 1e-12).
  if (far) {
    const T w = d_max(h_base, h_far);
    const T hf_b = (T(1) - w) * h_b;
    h_b = w * h_b;
    const T num_b = hf_b / den;
    const T den_b = -hf_b * h_far / den;
    const T wm = d_min(a1, a2);
    const T rho_b = T(0.5) * wm * num_b + T(0.125) * (T(1) - wm) * num_b;
    const T speed_b = den_b * d_max(speed, T(1e-12));
    const T speed2_b = speed_b / (T(2) * speed) * d_max(speed2, T(1e-30));
#pragma unroll
    for (int i = 1; i < 4; ++i) {
      kb[i] = kb[i] + T(2) * k1[i] * speed2_b;
      out[i] = out[i] + y[i] / rho * rho_b;
    }
  }
  // Stage 1 at y.
  rhs_vjp(radius, a, y, kb, tb, rb, ab);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = out[i] + tb[i];
  // h0·clip((r − r₊)/r_ref, h_min_frac, 1), r the Kerr-Schild radius of y.
  const T g_b = R.h0 * h_b * d_clip(g_raw, R.h_min_frac, T(1));
  const T rh_b = g_b / R.r_ref;
  ks_radius_vjp(a, y[1], y[2], y[3], rh_b, out + 1, ab);
  // r₊ = m + sqrt(max(m² − a², 1e-30)), m = radius/2.
  const T z_b = -rh_b / (T(2) * S.s_rp) * d_max(S.z_rp, T(1e-30));
  ab = ab - T(2) * a * z_b;
  rb = rb + T(0.5) * (-rh_b + T(2) * S.m * z_b);
  out[8] = rb;
  out[9] = ab;
}

// The VJP of the payload step (the lane's last on a hit lane) from ten
// dual evaluations of G: out as step_vjp's.
template <typename T>
__device__ __forceinline__ void payload_step_vjp(const AdjParams<T>& P, const T* yg, const T* lam,
                                              const T* ct_p, int kind0, T* out) {
  for (int j = 0; j < 10; ++j) {
    Dual<T> yd[8], yn[8], pl[kEventWidth];
#pragma unroll
    for (int i = 0; i < 8; ++i) yd[i] = Dual<T>(yg[i], i == j ? T(1) : T(0));
    const Dual<T> rd(P.radius, j == 8 ? T(1) : T(0));
    const Dual<T> ad(P.a, j == 9 ? T(1) : T(0));
    step_map(P, rd, ad, yd, kind0, true, yn, pl);
    T acc = T(0);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = acc + lam[i] * yn[i].d;
#pragma unroll
    for (int q = 0; q < kEventWidth; ++q) acc = acc + ct_p[q] * pl[q].d;
    out[j] = acc;
  }
}

// A reverse step's result under the trust region: λ and the partials move
// on when every entry of `out` lies inside it; else λ is zeroed and the
// step's partials dropped.
template <typename T>
__device__ __forceinline__ void take_step(const T* out, T* lam, T& dr, T& da, T cap) {
  bool trust = true;
#pragma unroll
  for (int j = 0; j < 10; ++j) trust = trust && abs_(out[j]) < cap;
#pragma unroll
  for (int i = 0; i < 8; ++i) lam[i] = trust ? out[i] : T(0);
  if (trust) {
    dr = dr + out[8];
    da = da + out[9];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adjoint_kernel(const AdjParams<T> P, const T* __restrict__ ckpt, const T* __restrict__ ct_y,
               const T* __restrict__ ct_ev, const int32_t* __restrict__ steps_in,
               const int32_t* __restrict__ grad_ok, const int32_t* __restrict__ has_ev,
               const int32_t* __restrict__ ev_kind0, int64_t n, T* __restrict__ d_y0,
               T* __restrict__ d_radius, T* __restrict__ d_a, T* __restrict__ scratch) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const T cap = T(kLamCap);

  T lam[8];
  bool trusted = true;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    lam[i] = ct_y[lane * 8 + i];
    trusted = trusted && abs_(lam[i]) < cap;
  }
  if (!trusted) {
#pragma unroll
    for (int i = 0; i < 8; ++i) lam[i] = T(0);
  }
  T dr = T(0), da = T(0);
  const int steps = steps_in[lane];
  const int K = P.k_ckpt;

  if (grad_ok[lane] != 0 && steps > 0) {
    const bool hit = has_ev[lane] != 0;
    const int kind0 = ev_kind0[lane];
    // r₊ as the march computes it, for the bit-exact re-forward, and as
    // the differentiated step takes it.
    const T m = T(0.5) * P.radius;
    const T r_plus = m + sqrt_(nmax(m * m - P.a * P.a, T(0)));
    const StepTerms<T> S = step_terms(P.radius, P.a);
    const int n_seg_lane = min((steps + K - 1) / K, P.n_seg);

    for (int seg = n_seg_lane - 1; seg >= 0; --seg) {
      const int start = seg * K;
      const int k_eff = min(K, steps - start);
      T y[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = ckpt[((int64_t)seg * 8 + i) * n + lane];

      // Re-forward, keeping the pre-step states; a non-finite lane stays
      // frozen, as in the march's where-masks.
      for (int k = 0; k < k_eff; ++k) {
#pragma unroll
        for (int i = 0; i < 8; ++i) scratch[((int64_t)k * 8 + i) * n + lane] = y[i];
        if (all_finite(y)) {
          const T r_here = ks_radius(P.a, y[1], y[2], y[3]);
          T delta[8];
          rk4_delta<false>(P.rule, P.radius, P.a, r_plus, r_here, y, delta);
#pragma unroll
          for (int i = 0; i < 8; ++i) y[i] = y[i] + delta[i];
        }
      }

      // Reverse sweep over the segment. A hit lane's last step (the first
      // one met) carries the payload's cotangent; the others take the
      // hand-written VJP.
      int k = k_eff - 1;
      if (hit && start + k == steps - 1) {
        T yg[8], out[10], ct_p[kEventWidth];
#pragma unroll
        for (int i = 0; i < 8; ++i) yg[i] = scratch[((int64_t)k * 8 + i) * n + lane];
#pragma unroll
        for (int q = 0; q < kEventWidth; ++q) ct_p[q] = ct_ev[lane * kEventWidth + q];
        if (all_finite(yg)) {
          payload_step_vjp(P, yg, lam, ct_p, kind0, out);
          take_step(out, lam, dr, da, cap);
        }
        --k;
      }
      for (; k >= 0; --k) {
        T yg[8], out[10];
#pragma unroll
        for (int i = 0; i < 8; ++i) yg[i] = scratch[((int64_t)k * 8 + i) * n + lane];
        if (!all_finite(yg)) continue;  // identity on λ
        step_vjp(P, S, yg, lam, out);
        take_step(out, lam, dr, da, cap);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) d_y0[lane * 8 + i] = lam[i];
  d_radius[lane] = dr;
  d_a[lane] = da;
}

// params: radius, a, h0, h_min_frac, r_ref, r_safe. discs: n_discs rows of
// (inner, outer, kind); spheres: n_spheres rows of (radius, cx, cy, cz,
// radius², |c|, kind), the march's; one disc or sphere at least. ints:
// n_seg, k_ckpt. ckpt [n_seg, 8, n]; ct_y and d_y0 [n, 8]; ct_ev [n, 12];
// steps, grad_ok, has_ev, ev_kind0 i32 [n]; d_radius, d_a [n]; scratch
// [k_ckpt, 8, n].
template <typename T>
int launch(const void* ckpt, const void* ct_y, const void* ct_ev, const void* steps,
           const void* grad_ok, const void* has_ev, const void* ev_kind0, int64_t n, void* d_y0,
           void* d_radius, void* d_a, void* scratch, const double* params, const double* discs,
           int n_discs, const double* spheres, int n_spheres, const int* ints, void* stream) {
  if (n_discs < 0 || n_discs > kMaxDiscs || n_spheres < 0 || n_spheres > kMaxSpheres ||
      n_discs + n_spheres < 1 || ints[0] < 0 || ints[1] < 1) {
    return (int)cudaErrorInvalidValue;
  }
  AdjParams<T> P;
  P.radius = T(params[0]);
  P.a = T(params[1]);
  P.rule.h0 = T(params[2]);
  P.rule.h_min_frac = T(params[3]);
  P.rule.r_ref = T(params[4]);
  P.rule.r_safe = T(params[5]);
  for (int i = 0; i < kMaxDiscs; ++i) {
    const bool on = i < n_discs;
    P.disc_inner[i] = on ? T(discs[3 * i]) : T(0);
    P.disc_outer[i] = on ? T(discs[3 * i + 1]) : T(0);
    P.disc_kind[i] = on ? (int)discs[3 * i + 2] : -1;
  }
  P.n_discs = n_discs;
  fill_sphere_table(P.spheres, spheres, n_spheres);
  P.n_seg = ints[0];
  P.k_ckpt = ints[1];
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    adjoint_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        P, (const T*)ckpt, (const T*)ct_y, (const T*)ct_ev, (const int32_t*)steps,
        (const int32_t*)grad_ok, (const int32_t*)has_ev, (const int32_t*)ev_kind0, n, (T*)d_y0,
        (T*)d_radius, (T*)d_a, (T*)scratch);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int kerr_ks_adjoint_f32(const void* ckpt, const void* ct_y, const void* ct_ev, const void* steps,
                        const void* grad_ok, const void* has_ev, const void* ev_kind0, int64_t n,
                        void* d_y0, void* d_radius, void* d_a, void* scratch,
                        const double* params, const double* discs, int n_discs,
                        const double* spheres, int n_spheres, const int* ints, void* stream) {
  return launch<float>(ckpt, ct_y, ct_ev, steps, grad_ok, has_ev, ev_kind0, n, d_y0, d_radius,
                       d_a, scratch, params, discs, n_discs, spheres, n_spheres, ints, stream);
}

int kerr_ks_adjoint_f64(const void* ckpt, const void* ct_y, const void* ct_ev, const void* steps,
                        const void* grad_ok, const void* has_ev, const void* ev_kind0, int64_t n,
                        void* d_y0, void* d_radius, void* d_a, void* scratch,
                        const double* params, const double* discs, int n_discs,
                        const double* spheres, int n_spheres, const int* ints, void* stream) {
  return launch<double>(ckpt, ct_y, ct_ev, steps, grad_ok, has_ev, ev_kind0, n, d_y0, d_radius,
                        d_a, scratch, params, discs, n_discs, spheres, n_spheres, ints, stream);
}

}  // extern "C"
