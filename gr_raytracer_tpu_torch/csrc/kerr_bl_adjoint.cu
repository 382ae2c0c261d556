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
// The step VJP comes from forward-mode dual numbers: each reverse step
// evaluates G thirteen times in Dual<T>, seeded with the eight state
// directions, radius, a, E, L_z and Q, and contracts each Jacobian column
// with the cotangents:
//     λ_new_j = Σ_i λ_i ∂y_new_i/∂y_j + Σ_m ct_m ∂payload_m/∂y_j,
// and the same contraction along the five scalars gives the per-step
// partials. Exact to rounding; a hand-written reverse-mode step is the
// lever for later.
//
// What bounds it on the card: operations (thirteen dual step evaluations
// per reverse step against a few hundred bytes of scratch traffic).
//
// Conventions of the JAX VJP kept here: masks are selects (the untaken
// branch gets no derivative); r₊'s sqrt is guarded by max(·, 1e-30) in the
// differentiated step only (the march and the re-forward use 0, the same
// value for every sub-extremal spin); the payload's division guard is
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
constexpr int kDirections = 13;   // 8 state components, radius, a, E, L_z, Q
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
    T ct_p[kEventWidth];
#pragma unroll
    for (int c = 0; c < kEventWidth; ++c) ct_p[c] = hit ? ct_ev[lane * kEventWidth + c] : T(0);
    // r₊ and 1/|E| as the march computes them, for the bit-exact re-forward.
    const T m = T(0.5) * P.radius;
    const T r_plus = m + sqrt_(nmax(m * m - P.a * P.a, T(0)));
    const T inv_e = inv_energy(e);
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
          T delta[8];
          mino_rk4_delta(P.rule, P.radius, P.a, r_plus, e, l_z, q, inv_e, y, delta);
#pragma unroll
          for (int i = 0; i < 8; ++i) y[i] = y[i] + delta[i];
        }
      }

      // Reverse sweep over the segment.
      for (int k = k_eff - 1; k >= 0; --k) {
        T yg[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) yg[i] = scratch[((int64_t)k * 8 + i) * n + lane];
        if (!state_finite(yg)) continue;  // identity on λ
        const bool stored = hit && (start + k == steps - 1);
        T out[kDirections];
        for (int j = 0; j < kDirections; ++j) {
          Dual<T> yd[8], yn[8], pl[kEventWidth];
#pragma unroll
          for (int i = 0; i < 8; ++i) yd[i] = Dual<T>(yg[i], i == j ? T(1) : T(0));
          const Dual<T> rd(P.radius, j == 8 ? T(1) : T(0));
          const Dual<T> ad(P.a, j == 9 ? T(1) : T(0));
          const Dual<T> ed(e, j == 10 ? T(1) : T(0));
          const Dual<T> lzd(l_z, j == 11 ? T(1) : T(0));
          const Dual<T> qd(q, j == 12 ? T(1) : T(0));
          step_map(P, rd, ad, ed, lzd, qd, yd, kind0, stored, yn, pl);
          T acc = T(0);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc = acc + lam[i] * yn[i].d;
          if (stored) {
#pragma unroll
            for (int c = 0; c < kEventWidth; ++c) acc = acc + ct_p[c] * pl[c].d;
          }
          out[j] = acc;
        }
        bool trust = true;
#pragma unroll
        for (int j = 0; j < kDirections; ++j) trust = trust && abs_(out[j]) < cap;
        if (trust) {
#pragma unroll
          for (int i = 0; i < 8; ++i) lam[i] = out[i];
#pragma unroll
          for (int i = 0; i < 5; ++i) part[i] = part[i] + out[8 + i];
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) lam[i] = T(0);
        }
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
