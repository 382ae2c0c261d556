// Carter-separated Mino-time RK4 march in Boyer-Lindquist coordinates, with
// in-loop disc, sphere and volume events.
//
// Replaces the TPU kernel gr_raytracer_tpu/ops/geodesic_pallas.py
// kerr_bl_rk4_march (pallas_call body _bl_march_kernel). Same arithmetic,
// stop priority and event payload; the plain torch version of the same
// march is gr_raytracer_tpu_torch/ops/geodesic_march.py::march_bl_plain.
// Kerr-Schild scenes go through kerr_rk4_march.cu instead; Schwarzschild
// scenes come here with a = 0.
//
// What bounds it on the card: operations. A ray reads its 8-float state and
// its E, L_z, Q once and writes about 100 B of results plus its 8x12 event
// slots, while every step costs four evaluations of the Mino-time
// right-hand side (about 40 flops and a sin/cos pair each; chip_smoke.py
// counts the plain step), for tens to thousands of steps. So, as K1, one
// thread per ray keeps its state, its conserved scalars and 1/max(|E|,
// 1e-12) in registers and marches until its own lane stops or `attempts`
// is reached. The TPU kernel's (8,128) tiles and its block-wide event gate
// (a lax.cond that skips the stores when no lane of the block crosses
// θ = π/2) become a per-thread branch on the crossing.
//
// Built with -fmad=false (ops/cuda_build.py), so the kernel rounds every
// operation as the plain version's separate torch ops do. The device
// functions live in kerr_bl_common.cuh, shared with the reverse sweep
// kerr_bl_adjoint.cu, whose re-forward replays this march bit for bit.
//
// Options ported: disc events, sphere events (sphere_events.cuh) and the
// bounding-volume events of z-axis volumetric discs (vol_events.cuh), both
// on the step's Kerr-Schild embedded chord, in that order within a step;
// the opaque stop, the Kahan-compensated update, `attempts`, `finalize`,
// the reverse-sweep checkpoints and `resume` (as K1's). A pole
// hit (sin θ = 0) gives a non-finite right-hand side and stops the lane
// NAN, the documented classification.

#include "kerr_bl_common.cuh"
#include "sphere_events.cuh"
#include "vol_events.cuh"

namespace {

using namespace bl;

constexpr int kThreads = 128;

template <typename T>
struct Params {
  T radius, a, horizon_eps, max_radius;
  MinoRule<T> rule;  // h0, h_min_frac, r_ref
  T disc_inner[kMaxDiscs];
  T disc_outer[kMaxDiscs];
  int disc_kind[kMaxDiscs];
  int n_discs;
  SphereTable<T> spheres;
  VolTable<T> vols;
  int attempts;
  int budget_steps;
  int opaque_stop;
  int finalize;
  int compensated;
  int ckpt_every;  // 0: no checkpoints
  int max_events;  // event slots per lane
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
bl_march_kernel(const Params<T> P, const T* __restrict__ y0, const T* __restrict__ e_in,
                const T* __restrict__ lz_in, const T* __restrict__ q_in, int64_t n,
                T* __restrict__ y_out, int32_t* __restrict__ stop_out,
                int32_t* __restrict__ steps_out, int32_t* __restrict__ ev_kind,
                T* __restrict__ ev_data, int32_t* __restrict__ ev_count_out,
                uint8_t* __restrict__ ev_ovf_out, T* __restrict__ ckpt, const ResumeIn<T> R) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  int32_t* my_kind = ev_kind + lane * P.max_events;
  T* my_data = ev_data + lane * P.max_events * kEventWidth;
  int stop, steps, ev_count;
  bool ev_ovf;
  start_lane(R, lane, P.max_events, my_kind, my_data, stop, steps, ev_count, ev_ovf);

  T y[8], comp[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    y[i] = y0[lane * 8 + i];
    comp[i] = T(0);
  }
  const T e = e_in[lane], l_z = lz_in[lane], q = q_in[lane];
  const T inv_e = inv_energy(e);
  const T m = T(0.5) * P.radius;
  const T r_plus = m + sqrt_(nmax(m * m - P.a * P.a, T(0)));
  const T max_radius_sq = P.max_radius * P.max_radius;
  const T half_pi = T(1.5707963267948966);

  for (int it = 0; it < P.attempts && stop == kRunning; ++it) {
    if (P.ckpt_every > 0 && it % P.ckpt_every == 0) {
      // Reverse-sweep checkpoint: the pre-step state, [S, 8, N] with lanes
      // fastest, rows by this call's iteration (on a resumed leg a lane's
      // step count runs ahead of it).
      T* row = ckpt + (int64_t)(it / P.ckpt_every) * 8 * n + lane;
#pragma unroll
      for (int i = 0; i < 8; ++i) row[(int64_t)i * n] = y[i];
    }
    T delta[8];
    mino_rk4_delta(P.rule, P.radius, P.a, r_plus, e, l_z, q, inv_e, y, delta);
    T y_new[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (P.compensated) {
        // Kahan accumulation of y += delta.
        const T adj = delta[i] - comp[i];
        const T t_sum = y[i] + adj;
        comp[i] = (t_sum - y[i]) - adj;
        y_new[i] = t_sum;
      } else {
        y_new[i] = y[i] + delta[i];
      }
    }

    // Stop determination; the where-chain order sets the priority.
    const bool pos_finite = is_finite(y_new[0]) && is_finite(y_new[1]) && is_finite(y_new[2]) &&
                            is_finite(y_new[3]);
    const bool mom_finite = is_finite(y_new[4]) && is_finite(y_new[5]);
    const T r_new = y_new[1];
    const bool horizon = r_new <= r_plus + P.horizon_eps;
    const bool escaped = r_new * r_new > max_radius_sq;
    const int steps_new = steps + 1;
    const bool budget = steps_new >= P.budget_steps - 1;
    const bool trapped = budget && (r_new < T(5) * P.radius);
    int code = kRunning;
    if (!mom_finite) code = kNaN;
    if (escaped) code = kCelestial;
    if (trapped) code = kTrapped;
    if (horizon) code = kHorizon;
    if (!pos_finite) code = kNaN;
    if (code == kRunning && budget) code = kBudget;

    // Thin-disc crossings: θ passes π/2 over the step.
    const T d_prev = y[2] - half_pi, d_new = y_new[2] - half_pi;
    if (P.n_discs > 0 && d_prev * d_new < T(0)) {
      T p_prev[4], p_new[4], s3[3], e3[3];
      bl_momentum(P.radius, P.a, e, l_z, y, p_prev);
      bl_momentum(P.radius, P.a, e, l_z, y_new, p_new);
      bl_embed3(P.a, y, s3);
      bl_embed3(P.a, y_new, e3);
      const T frac = d_prev / (d_prev - d_new + (d_prev == d_new ? T(1) : T(0)));
      const T r_c = y[1] + frac * (y_new[1] - y[1]);
      const T phi_c = y[3] + frac * (y_new[3] - y[3]);
      const T sp = sin_(phi_c), cp = cos_(phi_c);
      const T px = r_c * cp - P.a * sp;  // the KS embedding at θ = π/2
      const T py = r_c * sp + P.a * cp;
      const T rr = sqrt_(px * px + py * py);
      const T phi = atan2_(py, px);
      const T cphi = cos_(phi), sphi = sin_(phi);
      for (int dsc = 0; dsc < P.n_discs; ++dsc) {
        if (!(rr >= P.disc_inner[dsc] && rr <= P.disc_outer[dsc])) continue;
        if (ev_count >= P.max_events) {
          ev_ovf = true;
          continue;
        }
        const T r_norm = (rr - P.disc_inner[dsc]) / (P.disc_outer[dsc] - P.disc_inner[dsc]);
        T* slot = my_data + ev_count * kEventWidth;
        slot[0] = px;
        slot[1] = py;
        slot[2] = T(0);
#pragma unroll
        for (int i = 0; i < 4; ++i) slot[3 + i] = p_prev[i] + frac * (p_new[i] - p_prev[i]);
        slot[7] = T(0.5) + T(0.5) * r_norm * cphi;
        slot[8] = T(0.5) + T(0.5) * r_norm * sphi;
#pragma unroll
        for (int i = 0; i < 3; ++i) slot[9 + i] = e3[i] - s3[i];
        my_kind[ev_count] = P.disc_kind[dsc];
        ++ev_count;
      }
    }
    // Sphere events: gated on the near test in BL, then found on the
    // embedded chord.
    if (P.spheres.n > 0) {
      const T st0 = sin_(y[2]), st1 = sin_(y_new[2]);
      const T n0 = sqrt_(y[1] * y[1] + P.a * P.a * (st0 * st0));
      const T n1 = sqrt_(y_new[1] * y_new[1] + P.a * P.a * (st1 * st1));
      if (sphere_candidate_bl(P.spheres, n0, n1)) {
        T p_prev[4], p_new[4], s3[3], e3[3];
        bl_momentum(P.radius, P.a, e, l_z, y, p_prev);
        bl_momentum(P.radius, P.a, e, l_z, y_new, p_new);
        bl_embed3(P.a, y, s3);
        bl_embed3(P.a, y_new, e3);
        store_sphere_events(P.spheres, s3, e3, p_prev, p_new, P.max_events, my_kind, my_data,
                            ev_count, ev_ovf);
      }
    }
    // Volume events: gated on the embedded chord's z = r cos θ meeting a
    // volume's band (z is linear between the chord's ends).
    if (P.vols.n > 0 && vol_candidate(P.vols, y[1] * cos_(y[2]), y_new[1] * cos_(y_new[2]),
                                      false, T(0))) {
      T p_prev[4], p_new[4], s3[3], e3[3];
      bl_momentum(P.radius, P.a, e, l_z, y, p_prev);
      bl_momentum(P.radius, P.a, e, l_z, y_new, p_new);
      bl_embed3(P.a, y, s3);
      bl_embed3(P.a, y_new, e3);
      store_vol_events(P.vols, s3, e3, p_prev, p_new, P.max_events, my_kind, my_data, ev_count,
                       ev_ovf);
    }
    // Opaque stop: the first disc or sphere event saturates the fold
    // (after the stores).
    if (P.opaque_stop && (P.n_discs > 0 || P.spheres.n > 0) && code == kRunning && ev_count > 0) {
      code = kSaturated;
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = y_new[i];
    steps = steps_new;
    stop = code;
  }
  if (P.finalize && stop == kRunning) stop = kBudget;

#pragma unroll
  for (int i = 0; i < 8; ++i) y_out[lane * 8 + i] = y[i];
  stop_out[lane] = stop;
  steps_out[lane] = steps;
  ev_count_out[lane] = ev_count;
  ev_ovf_out[lane] = ev_ovf ? 1 : 0;
}

// params: radius, a, horizon_eps, h0, max_radius, h_min_frac, r_ref.
// discs: n_discs rows of (inner, outer, kind); spheres: n_spheres rows of
// (radius, cx, cy, cz, radius², |c|, kind); vols: n_vols rows of (inner,
// outer, cap_h, kind). ints: attempts, budget_steps, opaque_stop,
// finalize, compensated, ckpt_every, max_events (the event slots of a lane:
// ev_kind is [n, max_events], ev_data [n, max_events, 12]). e, l_z, q:
// [n]. ckpt: [S, 8, n] with S = ceil(attempts / ckpt_every), or null when
// ckpt_every is 0. resume: null, or the six per-lane inputs (stop, steps,
// ev_kind, ev_data, ev_count, ev_ovf) of a resumed march, y0 being its
// state.
template <typename T>
int launch(const void* y0, const void* e, const void* l_z, const void* q, int64_t n, void* y_out,
           void* stop, void* steps, void* ev_kind, void* ev_data, void* ev_count, void* ev_ovf,
           void* ckpt, const void* const* resume, const double* params, const double* discs,
           int n_discs, const double* spheres, int n_spheres, const double* vols, int n_vols,
           const int* ints, void* stream) {
  if (n_discs < 0 || n_discs > kMaxDiscs) return (int)cudaErrorInvalidValue;
  if (n_spheres < 0 || n_spheres > kMaxSpheres) return (int)cudaErrorInvalidValue;
  if (n_vols < 0 || n_vols > kMaxVols) return (int)cudaErrorInvalidValue;
  if (ints[5] < 0 || (ints[5] > 0 && ckpt == nullptr)) return (int)cudaErrorInvalidValue;
  if (ints[6] < 1) return (int)cudaErrorInvalidValue;
  Params<T> P;
  P.radius = T(params[0]);
  P.a = T(params[1]);
  P.horizon_eps = T(params[2]);
  P.rule.h0 = T(params[3]);
  P.max_radius = T(params[4]);
  P.rule.h_min_frac = T(params[5]);
  P.rule.r_ref = T(params[6]);
  for (int i = 0; i < kMaxDiscs; ++i) {
    const bool on = i < n_discs;
    P.disc_inner[i] = on ? T(discs[3 * i]) : T(0);
    P.disc_outer[i] = on ? T(discs[3 * i + 1]) : T(0);
    P.disc_kind[i] = on ? (int)discs[3 * i + 2] : -1;
  }
  P.n_discs = n_discs;
  fill_sphere_table(P.spheres, spheres, n_spheres);
  fill_vol_table(P.vols, vols, n_vols);
  P.attempts = ints[0];
  P.budget_steps = ints[1];
  P.opaque_stop = ints[2];
  P.finalize = ints[3];
  P.compensated = ints[4];
  P.ckpt_every = ints[5];
  P.max_events = ints[6];
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    bl_march_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        P, (const T*)y0, (const T*)e, (const T*)l_z, (const T*)q, n, (T*)y_out, (int32_t*)stop,
        (int32_t*)steps, (int32_t*)ev_kind, (T*)ev_data, (int32_t*)ev_count, (uint8_t*)ev_ovf,
        (T*)ckpt, resume_in<T>(resume));
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int kerr_bl_rk4_march_f32(const void* y0, const void* e, const void* l_z, const void* q,
                          int64_t n, void* y_out, void* stop, void* steps, void* ev_kind,
                          void* ev_data, void* ev_count, void* ev_ovf, void* ckpt,
                          const void* const* resume, const double* params, const double* discs,
                          int n_discs,
                          const double* spheres, int n_spheres, const double* vols, int n_vols,
                          const int* ints, void* stream) {
  return launch<float>(y0, e, l_z, q, n, y_out, stop, steps, ev_kind, ev_data, ev_count, ev_ovf,
                       ckpt, resume, params, discs, n_discs, spheres, n_spheres, vols, n_vols, ints,
                       stream);
}

int kerr_bl_rk4_march_f64(const void* y0, const void* e, const void* l_z, const void* q,
                          int64_t n, void* y_out, void* stop, void* steps, void* ev_kind,
                          void* ev_data, void* ev_count, void* ev_ovf, void* ckpt,
                          const void* const* resume, const double* params, const double* discs,
                          int n_discs,
                          const double* spheres, int n_spheres, const double* vols, int n_vols,
                          const int* ints, void* stream) {
  return launch<double>(y0, e, l_z, q, n, y_out, stop, steps, ev_kind, ev_data, ev_count, ev_ovf,
                        ckpt, resume, params, discs, n_discs, spheres, n_spheres, vols, n_vols, ints,
                        stream);
}

}  // extern "C"
