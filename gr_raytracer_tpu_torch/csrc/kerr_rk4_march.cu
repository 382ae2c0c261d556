// Fixed-step RK4 Kerr-Schild geodesic march with in-loop disc, sphere and
// volume events.
//
// Replaces the TPU kernel gr_raytracer_tpu/ops/geodesic_pallas.py
// kerr_rk4_march (pallas_call body _march_kernel). Same arithmetic, stop
// priority and event payload; the plain torch version of the same march is
// gr_raytracer_tpu_torch/ops/geodesic_march.py::march_plain.
//
// What bounds it on the card: operations, and the chain of a launch's
// longest lane. A ray reads its 8-float state once and writes about 100 B
// of results plus its 8x12 event slots, while every step costs four
// evaluations of the analytic right-hand side, about 800 flops per ray-step
// in all (chip_smoke.py counts the plain step; ~900 SASS instructions a
// step in f32), for tens to twenty thousand steps. So a thread keeps one
// lane's state in registers and marches it until it stops or `attempts` is
// reached. Lanes' lengths differ by orders of magnitude (the kerr.toml
// frame's median lane takes 20 steps, its longest 402; the 500² volumetric
// frame's AA pass has a lane that runs to its 20,000-step budget), so a
// launch holds only the threads the card keeps resident, each taking the
// next lane when its own stops (lane refill, as in K3): a warp stays full
// beside a long lane, and a launch of a million lanes ends with its last
// lanes instead of with its fullest warps. What refill cannot shorten is one
// lane's own chain: a lone warp takes ~1.5 µs a step, so a lane near its
// budget holds a launch for its whole length. A stopped lane is frozen in
// the TPU kernel, so marching each lane to its end is equivalent to its
// block loop. The step carries the new state's Kerr-Schild r (the next step
// rule's) and |x|² (the next far-field lever's and first stage's).
//
// The build turns FMA contraction off (-fmad=false, ops/cuda_build.py): the
// kernel then rounds every operation as the plain version's separate torch
// ops do, and the two agree to the last bit on the card. Contraction is a
// speed lever left for later.
//
// Events are rare, so they are written straight into the output slots at
// the lane's event count. The TPU-only machinery (the (8,128) tiles, the
// metadata packing, the polynomial atan2) is not needed: atan2 comes from
// the CUDA math library.
//
// Options ported: disc events, sphere events (sphere_events.cuh), the
// bounding-volume events of z-axis volumetric discs (vol_events.cuh), in
// that order within a step, the opaque stop, the far-field lever, the
// Kahan-compensated update, `attempts`, `finalize`, the reverse-sweep
// checkpoints (`ckpt_every`) and `resume`: a lane starts from a previous
// call's stop code, step count and events (kerr_ks_common.cuh start_lane),
// so legs of `attempts` iterations continue one march bit for bit.
//
// The device functions (right-hand side, step rule, p^μ) live in
// kerr_ks_common.cuh, shared with the reverse sweep kerr_ks_adjoint.cu, so
// that its re-forward replays this march bit for bit.

#include "kerr_ks_common.cuh"
#include "sphere_events.cuh"
#include "vol_events.cuh"

namespace {

using namespace ks;

constexpr int kThreads = 128;

template <typename T>
struct Params {
  T radius, a, horizon_eps, max_radius;
  StepRule<T> rule;  // h0, h_min_frac, r_ref, r_safe
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
  int compensated;  // the Kahan update
};

// One lane's march state in registers: its state and Kahan compensation,
// its Kerr-Schild r and |x|² (carried from the step that made the state),
// its counters and its event slots. The compensation is a run-time flag:
// a build without its registers (a template flag, as K3's) schedules the
// step into fewer registers and takes a lone warp ~4 % longer a step
// (PERF.md §6), and a lone lane is what holds a launch's end.
template <typename T>
struct Lane {
  T y[8];
  T comp[8];
  T r_here, rho_sq;
  int stop, steps, ev_count, it;
  bool ev_ovf;
  int32_t* kind;
  T* data;
};

// Load lane `lane`'s state and start it (fresh or resumed).
template <typename T>
__device__ __forceinline__ void begin_lane(const Params<T>& P, Lane<T>& L, int64_t lane,
                                           const T* y0, int32_t* ev_kind, T* ev_data,
                                           const ResumeIn<T>& R) {
  L.kind = ev_kind + lane * P.max_events;
  L.data = ev_data + lane * P.max_events * kEventWidth;
  start_lane(R, lane, P.max_events, L.kind, L.data, L.stop, L.steps, L.ev_count, L.ev_ovf);
#pragma unroll
  for (int i = 0; i < 8; ++i) L.y[i] = y0[lane * 8 + i];
#pragma unroll
  for (int i = 0; i < 8; ++i) L.comp[i] = T(0);
  L.rho_sq = position_sq(L.y);
  L.r_here = ks_radius_at(P.a, L.rho_sq, L.y[3]);
  L.it = 0;
}

// One iteration of the march: the RK4 step, the stop code, the events.
// Every value is the plain step's, computed in its order of operations
// (_plain_step).
template <typename T>
__device__ __forceinline__ void march_step(const Params<T>& P, Lane<T>& L, T r_plus,
                                           T max_radius_sq, T* ckpt, int64_t n, int64_t lane) {
  if (P.ckpt_every > 0 && L.it % P.ckpt_every == 0) {
    // Reverse-sweep checkpoint: the pre-step state, [S, 8, N] with lanes
    // fastest, rows by this call's iteration (on a resumed leg a lane's
    // step count runs ahead of it).
    T* row = ckpt + (int64_t)(L.it / P.ckpt_every) * 8 * n + lane;
#pragma unroll
    for (int i = 0; i < 8; ++i) row[(int64_t)i * n] = L.y[i];
  }
  const T* y = L.y;
  // Step rule, far-field lever and RK4 (kerr_ks_common.cuh).
  T delta[8];
  rk4_delta_at<false>(P.rule, P.radius, P.a, r_plus, L.r_here, L.rho_sq, y, delta);
  T y_new[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (P.compensated) {
      // Kahan accumulation of y += delta.
      const T adj = delta[i] - L.comp[i];
      const T t_sum = y[i] + adj;
      L.comp[i] = (t_sum - y[i]) - adj;
      y_new[i] = t_sum;
    } else {
      y_new[i] = y[i] + delta[i];
    }
  }

  // Stop determination; the where-chain order sets the priority.
  const bool pos_finite = is_finite(y_new[0]) && is_finite(y_new[1]) && is_finite(y_new[2]) &&
                          is_finite(y_new[3]);
  const bool mom_finite = is_finite(y_new[4]) && is_finite(y_new[5]) && is_finite(y_new[6]) &&
                          is_finite(y_new[7]);
  const T rho_sq = position_sq(y_new);
  const T r_new = ks_radius_at(P.a, rho_sq, y_new[3]);
  const bool horizon = r_new <= r_plus + P.horizon_eps;
  const bool escaped = rho_sq > max_radius_sq;
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

  // Thin-disc crossings: z changes sign over the step.
  const T z_prev = y[3], z_new = y_new[3];
  if (P.n_discs > 0 && z_prev * z_new < T(0)) {
    T p_prev[4], p_new[4];
    momentum_contra(P.radius, P.a, y, p_prev);
    momentum_contra(P.radius, P.a, y_new, p_new);
    const T frac = z_prev / (z_prev - z_new + (z_prev == z_new ? T(1) : T(0)));
    const T px = y[1] + frac * (y_new[1] - y[1]);
    const T py = y[2] + frac * (y_new[2] - y[2]);
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
      slot[9] = y_new[1] - y[1];
      slot[10] = y_new[2] - y[2];
      slot[11] = y_new[3] - y[3];
      L.kind[L.ev_count] = P.disc_kind[dsc];
      ++L.ev_count;
    }
  }
  // Sphere events: gated on some sphere's surface lying between the
  // chord's endpoint radii.
  if (P.spheres.n > 0 && sphere_candidate_ks(P.spheres, y + 1, y_new + 1)) {
    T p_prev[4], p_new[4];
    momentum_contra(P.radius, P.a, y, p_prev);
    momentum_contra(P.radius, P.a, y_new, p_new);
    store_sphere_events(P.spheres, y + 1, y_new + 1, p_prev, p_new, P.max_events, L.kind, L.data,
                        L.ev_count, L.ev_ovf);
  }
  // Volume events: gated on the chord's z range meeting a volume's band
  // and its closest approach to the axis (in xy) lying inside the outer
  // cylinder.
  if (P.vols.n > 0) {
    const T dx = y_new[1] - y[1], dy = y_new[2] - y[2];
    const T a_c = dx * dx + dy * dy;
    const T b_h = y[1] * dx + y[2] * dy;
    const T rho0 = y[1] * y[1] + y[2] * y[2];
    const T t_star = clip(-b_h / nmax(a_c, T(1e-20)), T(0), T(1));
    const T rho_min2 = rho0 + (T(2) * b_h + a_c * t_star) * t_star;
    if (vol_candidate(P.vols, z_prev, z_new, true, rho_min2)) {
      T p_prev[4], p_new[4];
      momentum_contra(P.radius, P.a, y, p_prev);
      momentum_contra(P.radius, P.a, y_new, p_new);
      store_vol_events(P.vols, y + 1, y_new + 1, p_prev, p_new, P.max_events, L.kind, L.data,
                       L.ev_count, L.ev_ovf);
    }
  }
  // Opaque stop: the first disc or sphere event saturates the fold
  // (after the stores).
  if (P.opaque_stop && (P.n_discs > 0 || P.spheres.n > 0) && code == kRunning && L.ev_count > 0) {
    code = kSaturated;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) L.y[i] = y_new[i];
  L.r_here = r_new;
  L.rho_sq = rho_sq;
  L.steps = steps_new;
  L.stop = code;
  ++L.it;
}

// Write a lane's results.
template <typename T>
__device__ __forceinline__ void end_lane(const Params<T>& P, const Lane<T>& L, int64_t lane,
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
// lane from the counter `next`, in index order (the render's cost sort).
// A warp's threads then keep marching fresh lanes beside a long one, and a
// launch ends with its last lanes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
march_kernel(const Params<T> P, const T* __restrict__ y0, int64_t n, T* __restrict__ y_out,
             int32_t* __restrict__ stop_out, int32_t* __restrict__ steps_out,
             int32_t* __restrict__ ev_kind, T* __restrict__ ev_data,
             int32_t* __restrict__ ev_count_out, uint8_t* __restrict__ ev_ovf_out,
             T* __restrict__ ckpt, const ResumeIn<T> R, int32_t* __restrict__ next) {
  const T m = T(0.5) * P.radius;
  const T r_plus = m + sqrt_(nmax(m * m - P.a * P.a, T(0)));
  const T max_radius_sq = P.max_radius * P.max_radius;
  const int64_t resident = (int64_t)gridDim.x * blockDim.x;
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  Lane<T> L;
  bool live = lane < n;
  if (live) begin_lane(P, L, lane, y0, ev_kind, ev_data, R);
  while (true) {
    while (live && !(L.it < P.attempts && L.stop == kRunning)) {
      end_lane(P, L, lane, y_out, stop_out, steps_out, ev_count_out, ev_ovf_out);
      lane = resident + atomicAdd(next, 1);
      live = lane < n;
      if (live) begin_lane(P, L, lane, y0, ev_kind, ev_data, R);
    }
    if (!live) break;
    march_step(P, L, r_plus, max_radius_sq, ckpt, n, lane);
  }
}

// One launch: as many blocks as the card keeps resident at once, or fewer
// for fewer lanes.
template <typename T>
void start(const Params<T>& P, const void* y0, int64_t n, void* y_out, void* stop, void* steps,
           void* ev_kind, void* ev_data, void* ev_count, void* ev_ovf, void* ckpt,
           const ResumeIn<T>& R, void* next, cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, march_kernel<T>, kThreads, 0);
  const int64_t blocks = (n + kThreads - 1) / kThreads, resident = (int64_t)sms * per_sm;
  march_kernel<T><<<(unsigned)(blocks < resident ? blocks : resident), kThreads, 0, stream>>>(
      P, (const T*)y0, n, (T*)y_out, (int32_t*)stop, (int32_t*)steps, (int32_t*)ev_kind, (T*)ev_data,
      (int32_t*)ev_count, (uint8_t*)ev_ovf, (T*)ckpt, R, (int32_t*)next);
}

// params: radius, a, horizon_eps, h0, max_radius, h_min_frac, r_ref, r_safe.
// discs: n_discs rows of (inner, outer, kind); spheres: n_spheres rows of
// (radius, cx, cy, cz, radius², |c|, kind); vols: n_vols rows of (inner,
// outer, cap_h, kind). ints: attempts, budget_steps, opaque_stop,
// finalize, compensated, ckpt_every, max_events (the event slots of a lane:
// ev_kind is [n, max_events], ev_data [n, max_events, 12]). ckpt:
// [S, 8, n] with S = ceil(attempts / ckpt_every), or null when ckpt_every
// is 0. resume: null, or the six per-lane inputs (stop, steps, ev_kind,
// ev_data, ev_count, ev_ovf) of a resumed march, y0 being its state. next:
// one int32 on the card, 0 at the launch (the refill counter).
template <typename T>
int launch(const void* y0, int64_t n, void* y_out, void* stop, void* steps, void* ev_kind,
           void* ev_data, void* ev_count, void* ev_ovf, void* ckpt, const void* const* resume,
           void* next, const double* params, const double* discs, int n_discs, const double* spheres,
           int n_spheres, const double* vols, int n_vols, const int* ints, void* stream) {
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
  P.rule.r_safe = T(params[7]);
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
  P.compensated = ints[4];
  if (n > 0) {
    const ResumeIn<T> R = resume_in<T>(resume);
    const cudaStream_t s = (cudaStream_t)stream;
    start<T>(P, y0, n, y_out, stop, steps, ev_kind, ev_data, ev_count, ev_ovf, ckpt, R, next, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int kerr_rk4_march_f32(const void* y0, int64_t n, void* y_out, void* stop, void* steps,
                       void* ev_kind, void* ev_data, void* ev_count, void* ev_ovf, void* ckpt,
                       const void* const* resume, void* next, const double* params, const double* discs,
                       int n_discs, const double* spheres, int n_spheres, const double* vols, int n_vols,
                       const int* ints, void* stream) {
  return launch<float>(y0, n, y_out, stop, steps, ev_kind, ev_data, ev_count, ev_ovf, ckpt, resume, next,
                       params, discs, n_discs, spheres, n_spheres, vols, n_vols, ints, stream);
}

int kerr_rk4_march_f64(const void* y0, int64_t n, void* y_out, void* stop, void* steps,
                       void* ev_kind, void* ev_data, void* ev_count, void* ev_ovf, void* ckpt,
                       const void* const* resume, void* next, const double* params, const double* discs,
                       int n_discs, const double* spheres, int n_spheres, const double* vols, int n_vols,
                       const int* ints, void* stream) {
  return launch<double>(y0, n, y_out, stop, steps, ev_kind, ev_data, ev_count, ev_ovf, ckpt, resume, next,
                        params, discs, n_discs, spheres, n_spheres, vols, n_vols, ints, stream);
}

}  // extern "C"
