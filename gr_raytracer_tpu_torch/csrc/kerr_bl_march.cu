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
// counts the plain step), for tens to tens of thousands of steps. So a
// thread keeps one lane's state, its conserved scalars and their terms of
// the right-hand side in registers and marches it until it stops or
// `attempts` is reached. Lanes' lengths differ by orders of magnitude
// (most hit a disc within a hundred steps, escaping ones take ~15,000), so
// a launch holds only the threads the card keeps resident, each taking
// the next lane when its own stops (lane refill): a warp stays full while
// a long lane of it runs on, and a launch of a million lanes is held by its
// work, not by a lone lane at its end. The step carries sin θ, cos θ (and
// the sphere test's norm) of the new state into the next step, which
// would compute them again. The TPU kernel's (8,128) tiles and its
// block-wide event gate (a lax.cond that skips the stores when no lane of
// the block crosses θ = π/2) become a per-thread branch on the crossing.
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
  int ckpt_every;  // 0: no checkpoints
  int max_events;  // event slots per lane
};

// One lane's march state in registers: its state (with the Kahan
// compensation only in the compensated build), conserved scalars and the
// right-hand side's terms of them (mino_consts), sin θ and cos θ of its
// state (which the next step's first stage and its volume test read) and,
// with spheres, its state's embedded norm (the sphere near test's), its
// counters and its event slots.
template <typename T, bool kComp>
struct Lane {
  T y[8];
  T comp[kComp ? 8 : 1];
  T e, l_z, inv_e;
  MinoConsts<T> C;
  T st, ct, norm;
  int stop, steps, ev_count, it;
  bool ev_ovf;
  int32_t* kind;
  T* data;
};

// The sphere near test's embedded norm of a BL point, √(r² + a² sin²θ).
template <typename T>
__device__ __forceinline__ T embedded_norm(const Params<T>& P, T r, T st) {
  return sqrt_(r * r + P.a * P.a * (st * st));
}

// Load lane `lane`'s inputs and start it (fresh or resumed).
template <typename T, bool kComp>
__device__ __forceinline__ void begin_lane(const Params<T>& P, Lane<T, kComp>& L, int64_t lane,
                                           const T* y0, const T* e_in, const T* lz_in,
                                           const T* q_in, int32_t* ev_kind, T* ev_data,
                                           const ResumeIn<T>& R) {
  L.kind = ev_kind + lane * P.max_events;
  L.data = ev_data + lane * P.max_events * kEventWidth;
  start_lane(R, lane, P.max_events, L.kind, L.data, L.stop, L.steps, L.ev_count, L.ev_ovf);
#pragma unroll
  for (int i = 0; i < 8; ++i) L.y[i] = y0[lane * 8 + i];
#pragma unroll
  for (int i = 0; i < (kComp ? 8 : 1); ++i) L.comp[i] = T(0);
  L.e = e_in[lane];
  L.l_z = lz_in[lane];
  L.inv_e = inv_energy(L.e);
  L.C = mino_consts(P.a, L.e, L.l_z, q_in[lane]);
  sincos_(L.y[2], L.st, L.ct);
  L.norm = P.spheres.n > 0 ? embedded_norm(P, L.y[1], L.st) : T(0);
  L.it = 0;
}

// One iteration of the march: the RK4 step, the stop code, the events.
// Every value is the plain step's, computed in its order of operations
// (_bl_plain_step); sin θ, cos θ and the norm of the new state are computed
// once and carried to the next step, whose first stage and tests read them.
template <typename T, bool kComp>
__device__ __forceinline__ void march_step(const Params<T>& P, Lane<T, kComp>& L, T r_plus,
                                           T max_radius_sq, T* ckpt, int64_t n, int64_t lane) {
  const T half_pi = T(1.5707963267948966);
  if (P.ckpt_every > 0 && L.it % P.ckpt_every == 0) {
    // Reverse-sweep checkpoint: the pre-step state, [S, 8, N] with lanes
    // fastest, rows by this call's iteration (on a resumed leg a lane's
    // step count runs ahead of it).
    T* row = ckpt + (int64_t)(L.it / P.ckpt_every) * 8 * n + lane;
#pragma unroll
    for (int i = 0; i < 8; ++i) row[(int64_t)i * n] = L.y[i];
  }
  const T* y = L.y;
  T delta[8];
  mino_rk4_delta(P.rule, P.radius, P.a, r_plus, L.e, L.l_z, L.C, L.inv_e, y, L.st, L.ct, delta);
  T y_new[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if constexpr (kComp) {
      // Kahan accumulation of y += delta.
      const T adj = delta[i] - L.comp[i];
      const T t_sum = y[i] + adj;
      L.comp[i] = (t_sum - y[i]) - adj;
      y_new[i] = t_sum;
    } else {
      y_new[i] = y[i] + delta[i];
    }
  }
  T st_new, ct_new;
  sincos_(y_new[2], st_new, ct_new);

  // Stop determination; the where-chain order sets the priority.
  const bool pos_finite = is_finite(y_new[0]) && is_finite(y_new[1]) && is_finite(y_new[2]) &&
                          is_finite(y_new[3]);
  const bool mom_finite = is_finite(y_new[4]) && is_finite(y_new[5]);
  const T r_new = y_new[1];
  const bool horizon = r_new <= r_plus + P.horizon_eps;
  const bool escaped = r_new * r_new > max_radius_sq;
  const int steps_new = L.steps + 1;
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
    bl_momentum(P.radius, P.a, L.e, L.l_z, y, p_prev);
    bl_momentum(P.radius, P.a, L.e, L.l_z, y_new, p_new);
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
      if (L.ev_count >= P.max_events) {
        L.ev_ovf = true;
        continue;
      }
      const T r_norm = (rr - P.disc_inner[dsc]) / (P.disc_outer[dsc] - P.disc_inner[dsc]);
      T* slot = L.data + L.ev_count * kEventWidth;
      slot[0] = px;
      slot[1] = py;
      slot[2] = T(0);
#pragma unroll
      for (int i = 0; i < 4; ++i) slot[3 + i] = p_prev[i] + frac * (p_new[i] - p_prev[i]);
      slot[7] = T(0.5) + T(0.5) * r_norm * cphi;
      slot[8] = T(0.5) + T(0.5) * r_norm * sphi;
#pragma unroll
      for (int i = 0; i < 3; ++i) slot[9 + i] = e3[i] - s3[i];
      L.kind[L.ev_count] = P.disc_kind[dsc];
      ++L.ev_count;
    }
  }
  // Sphere events: gated on the near test in BL (the embedded norms of the
  // step's ends), then found on the embedded chord.
  if (P.spheres.n > 0) {
    const T n1 = embedded_norm(P, y_new[1], st_new);
    if (sphere_candidate_bl(P.spheres, L.norm, n1)) {
      T p_prev[4], p_new[4], s3[3], e3[3];
      bl_momentum(P.radius, P.a, L.e, L.l_z, y, p_prev);
      bl_momentum(P.radius, P.a, L.e, L.l_z, y_new, p_new);
      bl_embed3(P.a, y, s3);
      bl_embed3(P.a, y_new, e3);
      store_sphere_events(P.spheres, s3, e3, p_prev, p_new, P.max_events, L.kind, L.data,
                          L.ev_count, L.ev_ovf);
    }
    L.norm = n1;
  }
  // Volume events: gated on the embedded chord's z = r cos θ meeting a
  // volume's band (z is linear between the chord's ends).
  if (P.vols.n > 0 && vol_candidate(P.vols, y[1] * L.ct, y_new[1] * ct_new, false, T(0))) {
    T p_prev[4], p_new[4], s3[3], e3[3];
    bl_momentum(P.radius, P.a, L.e, L.l_z, y, p_prev);
    bl_momentum(P.radius, P.a, L.e, L.l_z, y_new, p_new);
    bl_embed3(P.a, y, s3);
    bl_embed3(P.a, y_new, e3);
    store_vol_events(P.vols, s3, e3, p_prev, p_new, P.max_events, L.kind, L.data, L.ev_count,
                     L.ev_ovf);
  }
  // Opaque stop: the first disc or sphere event saturates the fold
  // (after the stores).
  if (P.opaque_stop && (P.n_discs > 0 || P.spheres.n > 0) && code == kRunning && L.ev_count > 0) {
    code = kSaturated;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) L.y[i] = y_new[i];
  L.st = st_new;
  L.ct = ct_new;
  L.steps = steps_new;
  L.stop = code;
  ++L.it;
}

// Write a lane's results.
template <typename T, bool kComp>
__device__ __forceinline__ void end_lane(const Params<T>& P, const Lane<T, kComp>& L, int64_t lane,
                                         T* y_out, int32_t* stop_out, int32_t* steps_out,
                                         int32_t* ev_count_out, uint8_t* ev_ovf_out) {
#pragma unroll
  for (int i = 0; i < 8; ++i) y_out[lane * 8 + i] = L.y[i];
  stop_out[lane] = (P.finalize && L.stop == kRunning) ? kBudget : L.stop;
  steps_out[lane] = L.steps;
  ev_count_out[lane] = L.ev_count;
  ev_ovf_out[lane] = L.ev_ovf ? 1 : 0;
}

// The march with lane refill. The grid holds only the threads the card
// keeps resident; each starts with its own lane and, when that lane stops
// or has used its `attempts`, writes it out and takes the next unmarched
// lane from the counter `next` (in index order: the caller puts the lanes
// it expects to march longest first). A warp's threads then keep marching
// fresh lanes beside a long one, and a launch ends with its last lanes.
template <typename T, bool kComp>
__global__ void __launch_bounds__(kThreads)
bl_march_kernel(const Params<T> P, const T* __restrict__ y0, const T* __restrict__ e_in,
                const T* __restrict__ lz_in, const T* __restrict__ q_in, int64_t n,
                T* __restrict__ y_out, int32_t* __restrict__ stop_out,
                int32_t* __restrict__ steps_out, int32_t* __restrict__ ev_kind,
                T* __restrict__ ev_data, int32_t* __restrict__ ev_count_out,
                uint8_t* __restrict__ ev_ovf_out, T* __restrict__ ckpt, const ResumeIn<T> R,
                int32_t* __restrict__ next) {
  const T m = T(0.5) * P.radius;
  const T r_plus = m + sqrt_(nmax(m * m - P.a * P.a, T(0)));
  const T max_radius_sq = P.max_radius * P.max_radius;
  const int64_t resident = (int64_t)gridDim.x * blockDim.x;
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  Lane<T, kComp> L;
  bool live = lane < n;
  if (live) begin_lane(P, L, lane, y0, e_in, lz_in, q_in, ev_kind, ev_data, R);
  while (true) {
    while (live && !(L.it < P.attempts && L.stop == kRunning)) {
      end_lane(P, L, lane, y_out, stop_out, steps_out, ev_count_out, ev_ovf_out);
      lane = resident + atomicAdd(next, 1);
      live = lane < n;
      if (live) begin_lane(P, L, lane, y0, e_in, lz_in, q_in, ev_kind, ev_data, R);
    }
    if (!live) break;
    march_step(P, L, r_plus, max_radius_sq, ckpt, n, lane);
  }
}

// One launch of the build with or without Kahan compensation (a template
// flag, so the default path holds no compensation registers): as many
// blocks as the card keeps resident at once, or fewer for fewer lanes.
template <typename T, bool kComp>
void start(const Params<T>& P, const void* y0, const void* e, const void* l_z, const void* q,
           int64_t n, void* y_out, void* stop, void* steps, void* ev_kind, void* ev_data,
           void* ev_count, void* ev_ovf, void* ckpt, const ResumeIn<T>& R, void* next,
           cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bl_march_kernel<T, kComp>, kThreads, 0);
  const int64_t blocks = (n + kThreads - 1) / kThreads, resident = (int64_t)sms * per_sm;
  bl_march_kernel<T, kComp><<<(unsigned)(blocks < resident ? blocks : resident), kThreads, 0, stream>>>(
      P, (const T*)y0, (const T*)e, (const T*)l_z, (const T*)q, n, (T*)y_out, (int32_t*)stop,
      (int32_t*)steps, (int32_t*)ev_kind, (T*)ev_data, (int32_t*)ev_count, (uint8_t*)ev_ovf,
      (T*)ckpt, R, (int32_t*)next);
}

// params: radius, a, horizon_eps, h0, max_radius, h_min_frac, r_ref.
// discs: n_discs rows of (inner, outer, kind); spheres: n_spheres rows of
// (radius, cx, cy, cz, radius², |c|, kind); vols: n_vols rows of (inner,
// outer, cap_h, kind). ints: attempts, budget_steps, opaque_stop,
// finalize, compensated, ckpt_every, max_events (the event slots of a lane:
// ev_kind is [n, max_events], ev_data [n, max_events, 12]). e, l_z, q: [n].
// ckpt: [S, 8, n] with S = ceil(attempts / ckpt_every), or null when
// ckpt_every is 0. resume: null, or the six per-lane inputs (stop, steps,
// ev_kind, ev_data, ev_count, ev_ovf) of a resumed march, y0 being its
// state. next: one int32 on the card, 0 at the launch (the refill counter).
template <typename T>
int launch(const void* y0, const void* e, const void* l_z, const void* q, int64_t n, void* y_out,
           void* stop, void* steps, void* ev_kind, void* ev_data, void* ev_count, void* ev_ovf,
           void* ckpt, const void* const* resume, void* next, const double* params,
           const double* discs, int n_discs, const double* spheres, int n_spheres,
           const double* vols, int n_vols, const int* ints, void* stream) {
  if (n_discs < 0 || n_discs > kMaxDiscs) return (int)cudaErrorInvalidValue;
  if (n_spheres < 0 || n_spheres > kMaxSpheres) return (int)cudaErrorInvalidValue;
  if (n_vols < 0 || n_vols > kMaxVols) return (int)cudaErrorInvalidValue;
  if (ints[5] < 0 || (ints[5] > 0 && ckpt == nullptr)) return (int)cudaErrorInvalidValue;
  if (ints[6] < 1 || next == nullptr) return (int)cudaErrorInvalidValue;
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
  P.ckpt_every = ints[5];
  P.max_events = ints[6];
  if (n > 0) {
    const ResumeIn<T> R = resume_in<T>(resume);
    const cudaStream_t s = (cudaStream_t)stream;
    if (ints[4]) {
      start<T, true>(P, y0, e, l_z, q, n, y_out, stop, steps, ev_kind, ev_data, ev_count, ev_ovf, ckpt,
                     R, next, s);
    } else {
      start<T, false>(P, y0, e, l_z, q, n, y_out, stop, steps, ev_kind, ev_data, ev_count, ev_ovf,
                      ckpt, R, next, s);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int kerr_bl_rk4_march_f32(const void* y0, const void* e, const void* l_z, const void* q,
                          int64_t n, void* y_out, void* stop, void* steps, void* ev_kind,
                          void* ev_data, void* ev_count, void* ev_ovf, void* ckpt,
                          const void* const* resume, void* next, const double* params,
                          const double* discs, int n_discs, const double* spheres, int n_spheres,
                          const double* vols, int n_vols, const int* ints, void* stream) {
  return launch<float>(y0, e, l_z, q, n, y_out, stop, steps, ev_kind, ev_data, ev_count, ev_ovf,
                       ckpt, resume, next, params, discs, n_discs, spheres, n_spheres, vols, n_vols, ints,
                       stream);
}

int kerr_bl_rk4_march_f64(const void* y0, const void* e, const void* l_z, const void* q,
                          int64_t n, void* y_out, void* stop, void* steps, void* ev_kind,
                          void* ev_data, void* ev_count, void* ev_ovf, void* ckpt,
                          const void* const* resume, void* next, const double* params,
                          const double* discs, int n_discs, const double* spheres, int n_spheres,
                          const double* vols, int n_vols, const int* ints, void* stream) {
  return launch<double>(y0, e, l_z, q, n, y_out, stop, steps, ev_kind, ev_data, ev_count, ev_ovf,
                        ckpt, resume, next, params, discs, n_discs, spheres, n_spheres, vols, n_vols, ints,
                        stream);
}

}  // extern "C"
