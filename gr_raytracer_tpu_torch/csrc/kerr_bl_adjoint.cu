// Checkpointed reverse sweep of the Boyer-Lindquist (Mino-time) march: the
// adjoint λ, the per-lane partials ∂L/∂E, ∂L/∂L_z, ∂L/∂Q, and the
// per-lane parameter partials ∂L/∂radius, ∂L/∂a.
//
// Replaces the TPU kernel gr_raytracer_tpu/ops/geodesic_adjoint.py
// make_bl_march_diff (pallas_call body _bl_bwd_kernel). The plain torch
// version is gr_raytracer_tpu_torch/ops/geodesic_adjoint.py::
// bl_march_bwd_plain.
//
// The design is the Kerr-Schild sweep's (kerr_ks_adjoint.cu): one thread
// per lane walks its segments of K steps in reverse order. A segment loads
// its checkpoint (the pre-step state the march wrote every K steps),
// re-forwards its k_eff = min(K, steps − seg·K) steps with the march's own
// arithmetic (kerr_bl_common.cuh, the same -fmad=false build), so the
// trajectory is replayed bit for bit, and keeps the pre-step states in a
// global scratch buffer [K, 8, N], lanes fastest. Then it walks those
// states backwards and applies the VJP of the step map
// G: (y, radius, a, E, L_z, Q) ↦ (y_new, slot-0 payload). The TPU kernel
// gates a segment on its block's max(steps) and runs a lane's inactive
// steps on a benign substitute state (safe_state); gating per lane on
// seg·K + k < steps, and skipping a step whose state is not finite, is
// equivalent, because such a step is the identity on λ with zero partials.
//
// The step VJP is written by hand in reverse mode (step_vjp). The forward
// pass keeps, for each of the four stages, its r, sin θ, cos θ, v_r, v_θ
// and the slopes of v_r and v_θ; the backward pass then takes the RK4
// combination δ = h/6·(k1 + 2k2 + 2k3 + k4), each stage's y + c·h·k, the
// right-hand side at each stage (mino_rhs_vjp, with its lane terms
// MinoConsts, whose bars are summed over the stages and taken back to a,
// E, L_z and Q once a step) and the step size h(r, r₊(radius, a), 1/|E|).
// t, φ and components 6–7 enter neither mino_rhs nor the step size, so
// their λ passes through. A reverse step so costs about a forward step and
// four right-hand-side VJPs, with no sincos of its own, where the dual
// numbers it replaces evaluated the whole step thirteen times (the eight
// state directions, radius, a, E, L_z and Q).
//
// What bounds it on the card: the longest lanes. One thread walks a
// lane's whole reverse chain, and the BL fit frame's lanes all run
// ~1,000 steps, so a launch lasts about as long as its longest lanes'
// chains; the work of a step is a few forward steps against a few hundred
// bytes of scratch traffic.
//
// The payload step (a hit lane's last, peeled off ahead of the reverse
// loop, once a lane) keeps the dual numbers: G evaluated thirteen times in
// Dual<T>, each Jacobian column contracted with the cotangents,
//     λ_new_j = Σ_i λ_i ∂y_new_i/∂y_j + Σ_m ct_m ∂payload_m/∂y_j,
// and the same contraction along the five scalars for the partials.
//
// Conventions of the JAX VJP kept here: masks are selects (the untaken
// branch gets no derivative); r₊'s sqrt is guarded by max(·, 1e-30) in the
// differentiated step only (the march and the re-forward use 0, the same
// value for every sub-extremal spin); a tie in nmax/nmin splits the
// tangent half and half (d_max, d_min); the payload's division guard is
// |Δθ| ≥ 1e-12 (the march guards exact equality only); the payload
// cotangent enters only at the lane's last step on lanes with an event;
// the trust region on every λ component and all five per-step partials
// (it zeroes λ and drops that step's partials), and once on the incoming
// cotangent. Partials are written per lane, without atomics; the wrapper
// sums ∂radius and ∂a.

#include "kerr_bl_common.cuh"

namespace {

using namespace bl;

constexpr int kThreads = 128;
constexpr int kDirections = 13;  // 8 state components, radius, a, E, L_z, Q
constexpr double kLamCap = 1e15;  // LAM_CAP in ops/geodesic_adjoint.py

template <typename T>
struct AdjParams {
  T radius, a;
  MinoRule<T> rule;  // h0, h_min_frac, r_ref
  T disc_inner[kMaxDiscs];
  T disc_outer[kMaxDiscs];
  int disc_kind[kMaxDiscs];
  int n_discs;
  int n_seg;
  int k_ckpt;
};

// The step map G (ops/geodesic_adjoint.py _bl_step_with_payload): y_new
// and, when `with_payload`, the slot-0 disc payload [point3 | p_interp4 |
// uv2 | seg3] (_bl_disc_payload).
template <typename S, typename T>
__device__ __forceinline__ void step_map(const AdjParams<T>& P, S radius, S a, S e, S l_z, S q,
                                         const S* y, int kind0, bool with_payload, S* y_new,
                                         S* payload) {
  const S m = S(0.5) * radius;
  const S r_plus = m + sqrt_(nmax(m * m - a * a, S(1e-30)));
  S delta[8];
  mino_rk4_delta(P.rule, radius, a, r_plus, e, l_z, q, inv_energy(e), y, delta);
#pragma unroll
  for (int i = 0; i < 8; ++i) y_new[i] = y[i] + delta[i];
  if (!with_payload) return;

  const S half_pi = S(T(1.5707963267948966));
  const S d_prev = y[2] - half_pi;
  const S d_new = y_new[2] - half_pi;
  const S den_raw = d_prev - d_new;
  const bool ok = abs_(value(den_raw)) >= T(1e-12);
  const S frac = (ok ? d_prev : S(0)) / (ok ? den_raw : S(1));
  const S r_c = y[1] + frac * (y_new[1] - y[1]);
  const S phi_c = y[3] + frac * (y_new[3] - y[3]);
  const S sp = sin_(phi_c), cp = cos_(phi_c);
  const S px = r_c * cp - a * sp;
  const S py = r_c * sp + a * cp;
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
  S p_prev[4], p_new[4], s3[3], e3[3];
  bl_momentum(radius, a, e, l_z, y, p_prev);
  bl_momentum(radius, a, e, l_z, y_new, p_new);
  bl_embed3(a, y, s3);
  bl_embed3(a, y_new, e3);
  payload[0] = px;
  payload[1] = py;
  payload[2] = S(0);
#pragma unroll
  for (int i = 0; i < 4; ++i) payload[3 + i] = p_prev[i] + frac * (p_new[i] - p_prev[i]);
  payload[7] = S(0.5) + S(0.5) * r_norm * cos_(phi);
  payload[8] = S(0.5) + S(0.5) * r_norm * sin_(phi);
#pragma unroll
  for (int i = 0; i < 3; ++i) payload[9 + i] = e3[i] - s3[i];
}

// The lane's terms of the differentiated step: r₊ with its guarded sqrt
// (the march's value on every sub-extremal spin) and the pieces its VJP
// needs, 1/|E| as the march takes it, and the right-hand side's
// MinoConsts.
template <typename T>
struct StepTerms {
  T m, z_rp, s_rp, r_plus, inv_e;
  MinoConsts<T> C;
};

template <typename T>
__device__ __forceinline__ StepTerms<T> step_terms(T radius, T a, T e, T l_z, T q) {
  StepTerms<T> S;
  S.m = T(0.5) * radius;
  S.z_rp = S.m * S.m - a * a;
  S.s_rp = sqrt_(nmax(S.z_rp, T(1e-30)));
  S.r_plus = S.m + S.s_rp;
  S.inv_e = inv_energy(e);
  S.C = mino_consts(a, e, l_z, q);
  return S;
}

// The VJP of one step (mino_rk4_delta, no payload) along λ, in reverse
// mode: out[0..7] = λ_new, out[8..12] = the step's ∂radius, ∂a, ∂E, ∂L_z,
// ∂Q (ops/geodesic_adjoint.py bl_step_vjp, line for line).
template <typename T>
__device__ __forceinline__ void step_vjp(const AdjParams<T>& P, const StepTerms<T>& S, T e, T l_z,
                                         const T* y, const T* lam, T* out) {
  const T radius = P.radius, a = P.a;
  const MinoRule<T>& R = P.rule;
  const MinoConsts<T>& C = S.C;
  // Forward: h, then each stage's r, sin θ, cos θ, v_r, v_θ (the slopes
  // of r and θ) and the slopes of v_r and v_θ.
  const T u = y[1] / R.r_ref;
  const T g_raw = (y[1] - S.r_plus) / R.r_ref;
  const T gap = clip(g_raw, R.h_min_frac, T(1));
  const T den = T(1) + u * u;
  const T h1 = R.h0 * S.inv_e / den;
  const T h = h1 * gap;
  const T half_h = T(0.5) * h;
  T sr[4], sst[4], sct[4], svr[4], svt[4], sk4[4], sk5[4];
  T k[6], acc[6], tmp[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) tmp[i] = y[i];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sincos_(tmp[2], sst[j], sct[j]);
    mino_rhs(radius, a, e, l_z, C, tmp, sst[j], sct[j], k);
    sr[j] = tmp[1];
    svr[j] = tmp[4];
    svt[j] = tmp[5];
    sk4[j] = k[4];
    sk5[j] = k[5];
    const T coef = j == 2 ? h : half_h;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      if (j < 3) {
        acc[i] = j == 0 ? k[i] : acc[i] + T(2) * k[i];
        tmp[i] = y[i] + coef * k[i];
      } else {
        acc[i] = acc[i] + k[i];
      }
    }
  }
  const T h6 = h / T(6);
  // Backward: δ = h/6·(k1 + 2k2 + 2k3 + k4), y_new = y + δ.
  T h6_b = T(0);
#pragma unroll
  for (int i = 0; i < 6; ++i) h6_b = h6_b + lam[i] * acc[i];
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = lam[i];
  T h_b = h6_b / T(6), half_b = T(0);
  T rs_b = T(0), a_b = T(0), e_b = T(0), lz_b = T(0);
  MinoConsts<T> Cb = {T(0), T(0), T(0), T(0), T(0), T(0)};
  T kb[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) kb[i] = h6 * lam[i];
#pragma unroll
  for (int j = 3; j >= 0; --j) {
    T r_b, st_b, ct_b;
    mino_rhs_vjp(radius, a, e, l_z, C, sr[j], sst[j], sct[j], kb[0], kb[3], kb[4], kb[5], r_b, st_b, ct_b,
                 rs_b, a_b, e_b, lz_b, Cb);
    // The stage input's cotangent: r, θ, v_r, v_θ.
    const T t1 = r_b, t2 = st_b * sct[j] - ct_b * sst[j], t4 = kb[1], t5 = kb[2];
    out[1] = out[1] + t1;
    out[2] = out[2] + t2;
    out[4] = out[4] + t4;
    out[5] = out[5] + t5;
    if (j > 0) {
      // Stage j's input is y + c·k_{j-1}: c = h for stage 4, h/2 before.
      const T s = t1 * svr[j - 1] + t2 * svt[j - 1] + t4 * sk4[j - 1] + t5 * sk5[j - 1];
      const T coef = j == 3 ? h : half_h;
      if (j == 3) {
        h_b = h_b + s;
      } else {
        half_b = half_b + s;
      }
      const T w = j == 1 ? T(1) : T(2);
#pragma unroll
      for (int i = 0; i < 6; ++i) kb[i] = w * (h6 * lam[i]);
      kb[1] = kb[1] + coef * t1;
      kb[2] = kb[2] + coef * t2;
      kb[4] = kb[4] + coef * t4;
      kb[5] = kb[5] + coef * t5;
    }
  }
  h_b = h_b + T(0.5) * half_b;
  // h = (h0/|E|)/(1 + u²)·clip((r − r₊)/r_ref, h_min_frac, 1), u = r/r_ref.
  const T h1_b = h_b * gap;
  const T gap_b = h_b * h1;
  const T num_b = h1_b / den;
  const T den_b = -h1_b * h1 / den;
  const T g_b = gap_b * d_clip(g_raw, R.h_min_frac, T(1));
  out[1] = out[1] + (T(2) * u * den_b + g_b) / R.r_ref;
  const T rp_b = -g_b / R.r_ref;
  const T inv_e_b = R.h0 * num_b;
  const T s_e = e > T(0) ? T(1) : (e < T(0) ? T(-1) : T(0));
  e_b = e_b - inv_e_b * S.inv_e * S.inv_e * s_e * d_max(abs_(e), T(1e-12));
  // r₊ = m + sqrt(max(m² − a², 1e-30)), m = radius/2.
  const T z_b = rp_b / (T(2) * S.s_rp) * d_max(S.z_rp, T(1e-30));
  rs_b = rs_b + T(0.5) * (rp_b + T(2) * S.m * z_b);
  a_b = a_b - T(2) * a * z_b;
  // The lane terms: a², a·L_z, a·E, (L_z − a·E)² + Q, −2a²E², 2L_z².
  const T lae = l_z - C.a_e;
  const T lae_b = T(2) * lae * Cb.carter;
  const T a_e_b = Cb.a_e - lae_b;
  lz_b = lz_b + lae_b + a * Cb.a_lz + T(4) * l_z * Cb.th_l;
  a_b = a_b + T(2) * a * Cb.a2 + l_z * Cb.a_lz + e * a_e_b - T(4) * a * e * e * Cb.th_a;
  e_b = e_b + a * a_e_b - T(4) * a * a * e * Cb.th_a;
  out[8] = rs_b;
  out[9] = a_b;
  out[10] = e_b;
  out[11] = lz_b;
  out[12] = Cb.carter;  // ∂Q
}

// The VJP of the payload step (the lane's last on a hit lane) from
// thirteen dual evaluations of G: out as step_vjp's.
template <typename T>
__device__ __forceinline__ void payload_step_vjp(const AdjParams<T>& P, T e, T l_z, T q, const T* yg,
                                                 const T* lam, const T* ct_p, int kind0, T* out) {
  for (int j = 0; j < kDirections; ++j) {
    Dual<T> yd[8], yn[8], pl[kEventWidth];
#pragma unroll
    for (int i = 0; i < 8; ++i) yd[i] = Dual<T>(yg[i], i == j ? T(1) : T(0));
    const Dual<T> rd(P.radius, j == 8 ? T(1) : T(0));
    const Dual<T> ad(P.a, j == 9 ? T(1) : T(0));
    const Dual<T> ed(e, j == 10 ? T(1) : T(0));
    const Dual<T> lzd(l_z, j == 11 ? T(1) : T(0));
    const Dual<T> qd(q, j == 12 ? T(1) : T(0));
    step_map(P, rd, ad, ed, lzd, qd, yd, kind0, true, yn, pl);
    T acc = T(0);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = acc + lam[i] * yn[i].d;
#pragma unroll
    for (int c = 0; c < kEventWidth; ++c) acc = acc + ct_p[c] * pl[c].d;
    out[j] = acc;
  }
}

// A reverse step's result under the trust region: λ and the partials move
// on when every entry of `out` lies inside it; else λ is zeroed and the
// step's partials dropped.
template <typename T>
__device__ __forceinline__ void take_step(const T* out, T* lam, T* part, T cap) {
  bool trust = true;
#pragma unroll
  for (int j = 0; j < kDirections; ++j) trust = trust && abs_(out[j]) < cap;
#pragma unroll
  for (int i = 0; i < 8; ++i) lam[i] = trust ? out[i] : T(0);
  if (trust) {
#pragma unroll
    for (int i = 0; i < 5; ++i) part[i] = part[i] + out[8 + i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bl_adjoint_kernel(const AdjParams<T> P, const T* __restrict__ ckpt, const T* __restrict__ ct_y,
                  const T* __restrict__ ct_ev, const int32_t* __restrict__ steps_in,
                  const int32_t* __restrict__ grad_ok, const int32_t* __restrict__ has_ev,
                  const int32_t* __restrict__ ev_kind0, const T* __restrict__ e_in,
                  const T* __restrict__ lz_in, const T* __restrict__ q_in, int64_t n,
                  T* __restrict__ d_y0, T* __restrict__ d_e, T* __restrict__ d_lz,
                  T* __restrict__ d_q, T* __restrict__ d_radius, T* __restrict__ d_a,
                  T* __restrict__ scratch) {
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
  // Per-lane partials: radius, a, E, L_z, Q.
  T part[5] = {T(0), T(0), T(0), T(0), T(0)};
  const int steps = steps_in[lane];
  const int K = P.k_ckpt;

  if (grad_ok[lane] != 0 && steps > 0) {
    const bool hit = has_ev[lane] != 0;
    const int kind0 = ev_kind0[lane];
    const T e = e_in[lane], l_z = lz_in[lane], q = q_in[lane];
    // r₊ and 1/|E| as the march computes them, for the bit-exact re-forward.
    const T m = T(0.5) * P.radius;
    const T r_plus = m + sqrt_(nmax(m * m - P.a * P.a, T(0)));
    const StepTerms<T> S = step_terms(P.radius, P.a, e, l_z, q);
    const int n_seg_lane = min((steps + K - 1) / K, P.n_seg);

    for (int seg = n_seg_lane - 1; seg >= 0; --seg) {
      const int start = seg * K;
      const int k_eff = min(K, steps - start);
      T y[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = ckpt[((int64_t)seg * 8 + i) * n + lane];

      // Re-forward, keeping the pre-step states; a lane whose state is not
      // finite stays frozen, as in the march's where-masks.
      for (int k = 0; k < k_eff; ++k) {
#pragma unroll
        for (int i = 0; i < 8; ++i) scratch[((int64_t)k * 8 + i) * n + lane] = y[i];
        if (state_finite(y)) {
          T delta[8], st, ct;
          sincos_(y[2], st, ct);
          mino_rk4_delta(P.rule, P.radius, P.a, r_plus, e, l_z, S.C, S.inv_e, y, st, ct, delta);
#pragma unroll
          for (int i = 0; i < 8; ++i) y[i] = y[i] + delta[i];
        }
      }

      // Reverse sweep over the segment. A hit lane's last step (the first
      // one met) carries the payload's cotangent; the others take the
      // hand-written VJP.
      int k = k_eff - 1;
      if (hit && start + k == steps - 1) {
        T yg[8], out[kDirections], ct_p[kEventWidth];
#pragma unroll
        for (int i = 0; i < 8; ++i) yg[i] = scratch[((int64_t)k * 8 + i) * n + lane];
#pragma unroll
        for (int c = 0; c < kEventWidth; ++c) ct_p[c] = ct_ev[lane * kEventWidth + c];
        if (state_finite(yg)) {
          payload_step_vjp(P, e, l_z, q, yg, lam, ct_p, kind0, out);
          take_step(out, lam, part, cap);
        }
        --k;
      }
      for (; k >= 0; --k) {
        T yg[8], out[kDirections];
#pragma unroll
        for (int i = 0; i < 8; ++i) yg[i] = scratch[((int64_t)k * 8 + i) * n + lane];
        if (!state_finite(yg)) continue;  // identity on λ
        step_vjp(P, S, e, l_z, yg, lam, out);
        take_step(out, lam, part, cap);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) d_y0[lane * 8 + i] = lam[i];
  d_radius[lane] = part[0];
  d_a[lane] = part[1];
  d_e[lane] = part[2];
  d_lz[lane] = part[3];
  d_q[lane] = part[4];
}

// params: radius, a, h0, h_min_frac, r_ref. discs: n_discs rows of (inner,
// outer, kind). ints: n_seg, k_ckpt. ckpt [n_seg, 8, n]; ct_y and d_y0
// [n, 8]; ct_ev [n, 12]; steps, grad_ok, has_ev, ev_kind0 i32 [n]; e, l_z,
// q, d_e, d_l_z, d_q, d_radius, d_a [n]; scratch [k_ckpt, 8, n].
template <typename T>
int launch(const void* ckpt, const void* ct_y, const void* ct_ev, const void* steps,
           const void* grad_ok, const void* has_ev, const void* ev_kind0, const void* e,
           const void* l_z, const void* q, int64_t n, void* d_y0, void* d_e, void* d_lz,
           void* d_q, void* d_radius, void* d_a, void* scratch, const double* params,
           const double* discs, int n_discs, const int* ints, void* stream) {
  if (n_discs < 1 || n_discs > kMaxDiscs || ints[0] < 0 || ints[1] < 1) {
    return (int)cudaErrorInvalidValue;
  }
  AdjParams<T> P;
  P.radius = T(params[0]);
  P.a = T(params[1]);
  P.rule.h0 = T(params[2]);
  P.rule.h_min_frac = T(params[3]);
  P.rule.r_ref = T(params[4]);
  for (int i = 0; i < kMaxDiscs; ++i) {
    const bool on = i < n_discs;
    P.disc_inner[i] = on ? T(discs[3 * i]) : T(0);
    P.disc_outer[i] = on ? T(discs[3 * i + 1]) : T(0);
    P.disc_kind[i] = on ? (int)discs[3 * i + 2] : -1;
  }
  P.n_discs = n_discs;
  P.n_seg = ints[0];
  P.k_ckpt = ints[1];
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    bl_adjoint_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        P, (const T*)ckpt, (const T*)ct_y, (const T*)ct_ev, (const int32_t*)steps,
        (const int32_t*)grad_ok, (const int32_t*)has_ev, (const int32_t*)ev_kind0, (const T*)e,
        (const T*)l_z, (const T*)q, n, (T*)d_y0, (T*)d_e, (T*)d_lz, (T*)d_q, (T*)d_radius,
        (T*)d_a, (T*)scratch);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int kerr_bl_adjoint_f32(const void* ckpt, const void* ct_y, const void* ct_ev, const void* steps,
                        const void* grad_ok, const void* has_ev, const void* ev_kind0,
                        const void* e, const void* l_z, const void* q, int64_t n, void* d_y0,
                        void* d_e, void* d_lz, void* d_q, void* d_radius, void* d_a,
                        void* scratch, const double* params, const double* discs, int n_discs,
                        const int* ints, void* stream) {
  return launch<float>(ckpt, ct_y, ct_ev, steps, grad_ok, has_ev, ev_kind0, e, l_z, q, n, d_y0,
                       d_e, d_lz, d_q, d_radius, d_a, scratch, params, discs, n_discs, ints,
                       stream);
}

int kerr_bl_adjoint_f64(const void* ckpt, const void* ct_y, const void* ct_ev, const void* steps,
                        const void* grad_ok, const void* has_ev, const void* ev_kind0,
                        const void* e, const void* l_z, const void* q, int64_t n, void* d_y0,
                        void* d_e, void* d_lz, void* d_q, void* d_radius, void* d_a,
                        void* scratch, const double* params, const double* discs, int n_discs,
                        const int* ints, void* stream) {
  return launch<double>(ckpt, ct_y, ct_ev, steps, grad_ok, has_ev, ev_kind0, e, l_z, q, n, d_y0,
                        d_e, d_lz, d_q, d_radius, d_a, scratch, params, discs, n_discs, ints,
                        stream);
}

}  // extern "C"
