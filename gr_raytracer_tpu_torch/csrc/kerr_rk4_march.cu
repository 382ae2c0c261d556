// Fixed-step RK4 Kerr-Schild geodesic march with in-loop thin-disc events.
//
// Replaces the TPU kernel gr_raytracer_tpu/ops/geodesic_pallas.py
// kerr_rk4_march (pallas_call body _march_kernel). Same arithmetic, stop
// priority and event payload; the plain torch version of the same march is
// gr_raytracer_tpu_torch/ops/geodesic_march.py::march_plain.
//
// What bounds it on the card: operations. A ray reads its 8-float state
// once and writes about 100 B of results plus its 8x12 event slots, while
// every step costs four evaluations of the analytic right-hand side, about
// 800 flops per ray-step in all (chip_smoke.py counts the plain step), for
// tens to thousands of steps. So the
// design keeps everything in registers: one thread per ray, which marches
// until its own lane stops or `attempts` is reached. A stopped lane is
// frozen in the TPU kernel, so this is equivalent to its block loop. The
// driver's cost sort (rendering/fast_path.py) puts rays of similar length
// next to each other, so the lanes of a warp retire together.
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
// Options ported: disc events, the opaque stop, the far-field lever, the
// Kahan-compensated update, `attempts` and `finalize`. Sphere and volume
// events, resume and checkpoints are rejected by the Python wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxEvents = 8;
constexpr int kEventWidth = 12;
constexpr int kMaxDiscs = 8;
constexpr int kThreads = 128;

// Stop codes, as in rendering/integrator.py.
constexpr int kRunning = 0;
constexpr int kHorizon = 1;
constexpr int kCelestial = 2;
constexpr int kNaN = 3;
constexpr int kTrapped = 4;
constexpr int kBudget = 5;
constexpr int kSaturated = 7;

template <typename T>
struct Params {
  T radius, a, horizon_eps, h0, max_radius, h_min_frac, r_ref, r_safe;
  T disc_inner[kMaxDiscs];
  T disc_outer[kMaxDiscs];
  int disc_kind[kMaxDiscs];
  int n_discs;
  int attempts;
  int budget_steps;
  int opaque_stop;
  int finalize;
  int compensated;
};

// NaN-propagating max / min / clip, the semantics of jnp.maximum & co.
template <typename T>
__device__ __forceinline__ T nmax(T x, T y) {
  return (x != x) ? x : ((y != y) ? y : (x > y ? x : y));
}
template <typename T>
__device__ __forceinline__ T nmin(T x, T y) {
  return (x != x) ? x : ((y != y) ? y : (x < y ? x : y));
}
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return nmin(nmax(x, lo), hi);
}

__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }

template <typename T>
__device__ __forceinline__ bool finite(T x) { return isfinite(x); }

// Kerr-Schild r alone.
template <typename T>
__device__ __forceinline__ T ks_radius(T a, T x, T y, T z) {
  T rho_sq = x * x + y * y + z * z;
  T d = rho_sq - a * a;
  T s = sqrt(d * d + T(4) * a * a * z * z);
  return sqrt(T(0.5) * (d + s));
}

// dy/dλ for y = [x4 | p_cov4] with the hand-derived ∂H/∂x (_rhs).
template <typename T>
__device__ __forceinline__ void rhs(const Params<T>& P, const T* y, T* out) {
  const T radius = P.radius, a = P.a;
  const T x = y[1], yy = y[2], z = y[3];
  const T p0 = y[4], p1 = y[5], p2 = y[6], p3 = y[7];
  const T a2 = a * a;
  const T rho_sq = x * x + yy * yy + z * z;
  const T d = rho_sq - a2;
  const T dd4 = d * d + T(4) * a2 * z * z;
  const T inv_s = rsqrt_(dd4);
  const T r_sq = T(0.5) * (d + dd4 * inv_s);
  const T inv_r = rsqrt_(r_sq);
  const T r = r_sq * inv_r;
  const T D = r_sq * r_sq + a2 * z * z;
  const T denom = r_sq + a2;
  const T inv_Dd = T(1) / (D * denom);
  const T inv_D = inv_Dd * denom;
  const T inv_denom = inv_Dd * D;
  const T f = radius * r * r_sq * inv_D;
  const T kx = (r * x + a * yy) * inv_denom;
  const T ky = (r * yy - a * x) * inv_denom;
  const T kz = z * inv_r;

  const T k_dot_p = -p0 + kx * p1 + ky * p2 + kz * p3;
  out[0] = -p0 + f * k_dot_p;
  out[1] = p1 - f * kx * k_dot_p;
  out[2] = p2 - f * ky * k_dot_p;
  out[3] = p3 - f * kz * k_dot_p;
  out[4] = T(0);  // p_t conserved (stationary metric)

  const T common = T(1) + d * inv_s;
  const T dr2_x = x * common;
  const T dr2_y = yy * common;
  const T dr2_z = z * common + T(2) * a2 * z * inv_s;
  const T half_inv_r = T(0.5) * inv_r;
  const T dr_x = dr2_x * half_inv_r;
  const T dr_y = dr2_y * half_inv_r;
  const T dr_z = dr2_z * half_inv_r;

  const T cf = radius * r_sq * inv_D * inv_D;
  const T t1 = T(3) * a2 * z * z - r_sq * r_sq;
  const T df_x = cf * t1 * dr_x;
  const T df_y = cf * t1 * dr_y;
  const T df_z = cf * (t1 * dr_z - T(2) * a2 * z * r);

  const T dkx_x = (dr_x * x + r - kx * dr2_x) * inv_denom;
  const T dkx_y = (dr_y * x + a - kx * dr2_y) * inv_denom;
  const T dkx_z = (dr_z * x - kx * dr2_z) * inv_denom;
  const T dky_x = (dr_x * yy - a - ky * dr2_x) * inv_denom;
  const T dky_y = (dr_y * yy + r - ky * dr2_y) * inv_denom;
  const T dky_z = (dr_z * yy - ky * dr2_z) * inv_denom;
  const T zir2 = z * inv_r * inv_r;
  const T dkz_x = -zir2 * dr_x;
  const T dkz_y = -zir2 * dr_y;
  const T dkz_z = inv_r - zir2 * dr_z;

  const T dkp_x = p1 * dkx_x + p2 * dky_x + p3 * dkz_x;
  const T dkp_y = p1 * dkx_y + p2 * dky_y + p3 * dkz_y;
  const T dkp_z = p1 * dkx_z + p2 * dky_z + p3 * dkz_z;

  const T kp2 = k_dot_p * k_dot_p;
  const T fkp = f * k_dot_p;
  out[5] = T(0.5) * df_x * kp2 + fkp * dkp_x;
  out[6] = T(0.5) * df_y * kp2 + fkp * dkp_y;
  out[7] = T(0.5) * df_z * kp2 + fkp * dkp_z;
}

// p^μ from the covariant state (_momentum_contra via _ks_scalars).
template <typename T>
__device__ __forceinline__ void momentum_contra(const Params<T>& P, const T* y, T* p) {
  const T a = P.a, x = y[1], yy = y[2], z = y[3];
  const T rho_sq = x * x + yy * yy + z * z;
  const T d = rho_sq - a * a;
  const T r_sq = T(0.5) * (d + sqrt(d * d + T(4) * a * a * z * z));
  const T r = sqrt(r_sq);
  const T f = (r * r_sq * P.radius) / (r_sq * r_sq + a * a * z * z);
  const T denom = r_sq + a * a;
  const T kx = (r * x + a * yy) / denom;
  const T ky = (r * yy - a * x) / denom;
  const T kz = z / nmax(r, T(1e-30));
  const T k_dot_p = -y[4] + kx * y[5] + ky * y[6] + kz * y[7];
  p[0] = -y[4] + f * k_dot_p;
  p[1] = y[5] - f * kx * k_dot_p;
  p[2] = y[6] - f * ky * k_dot_p;
  p[3] = y[7] - f * kz * k_dot_p;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
march_kernel(const Params<T> P, const T* __restrict__ y0, int64_t n, T* __restrict__ y_out,
             int32_t* __restrict__ stop_out, int32_t* __restrict__ steps_out,
             int32_t* __restrict__ ev_kind, T* __restrict__ ev_data,
             int32_t* __restrict__ ev_count_out, uint8_t* __restrict__ ev_ovf_out) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  int32_t* my_kind = ev_kind + lane * kMaxEvents;
  T* my_data = ev_data + lane * kMaxEvents * kEventWidth;
  for (int k = 0; k < kMaxEvents; ++k) my_kind[k] = -1;
  for (int k = 0; k < kMaxEvents * kEventWidth; ++k) my_data[k] = T(0);

  T y[8], comp[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    y[i] = y0[lane * 8 + i];
    comp[i] = T(0);
  }
  const T m = T(0.5) * P.radius;
  const T r_plus = m + sqrt(nmax(m * m - P.a * P.a, T(0)));
  const T max_radius_sq = P.max_radius * P.max_radius;
  T r_here = ks_radius(P.a, y[1], y[2], y[3]);
  int stop = kRunning, steps = 0, ev_count = 0;
  bool ev_ovf = false;

  for (int it = 0; it < P.attempts && stop == kRunning; ++it) {
    // Step rule: distance-above-horizon scaling, capped at h0.
    T h = P.h0 * clip((r_here - r_plus) / P.r_ref, P.h_min_frac, T(1));
    T k[8], acc[8], tmp[8];
    rhs(P, y, k);
    if (P.r_safe > T(0)) {
      // Far-field lever: an outward lane beyond r_safe takes a step of half
      // its remaining gap (capped at rho/8), sized from k1.
      const T rho = sqrt(y[1] * y[1] + y[2] * y[2] + y[3] * y[3]);
      const T speed = sqrt(k[1] * k[1] + k[2] * k[2] + k[3] * k[3]);
      const bool outward = (y[1] * k[1] + y[2] * k[2] + y[3] * k[3]) > T(0);
      const T h_far = nmin(T(0.5) * (rho - P.r_safe), T(0.125) * rho) / nmax(speed, T(1e-12));
      if (outward && rho > P.r_safe) h = nmax(h, h_far);
    }
    const T half_h = T(0.5) * h;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[i] = k[i];
      tmp[i] = y[i] + half_h * k[i];
    }
    rhs(P, tmp, k);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[i] = acc[i] + T(2) * k[i];
      tmp[i] = y[i] + half_h * k[i];
    }
    rhs(P, tmp, k);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[i] = acc[i] + T(2) * k[i];
      tmp[i] = y[i] + h * k[i];
    }
    rhs(P, tmp, k);
    const T h6 = h / T(6);
    T y_new[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const T delta = h6 * (acc[i] + k[i]);
      if (P.compensated) {
        // Kahan accumulation of y += delta.
        const T adj = delta - comp[i];
        const T t_sum = y[i] + adj;
        comp[i] = (t_sum - y[i]) - adj;
        y_new[i] = t_sum;
      } else {
        y_new[i] = y[i] + delta;
      }
    }

    // Stop determination; the where-chain order sets the priority.
    const bool pos_finite = finite(y_new[0]) && finite(y_new[1]) && finite(y_new[2]) &&
                            finite(y_new[3]);
    const bool mom_finite = finite(y_new[4]) && finite(y_new[5]) && finite(y_new[6]) &&
                            finite(y_new[7]);
    const T r_new = ks_radius(P.a, y_new[1], y_new[2], y_new[3]);
    const bool horizon = r_new <= r_plus + P.horizon_eps;
    const T rho_sq = y_new[1] * y_new[1] + y_new[2] * y_new[2] + y_new[3] * y_new[3];
    const bool escaped = rho_sq > max_radius_sq;
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

    // Thin-disc crossings: z changes sign over the step.
    const T z_prev = y[3], z_new = y_new[3];
    if (P.n_discs > 0 && z_prev * z_new < T(0)) {
      T p_prev[4], p_new[4];
      momentum_contra(P, y, p_prev);
      momentum_contra(P, y_new, p_new);
      const T frac = z_prev / (z_prev - z_new + (z_prev == z_new ? T(1) : T(0)));
      const T px = y[1] + frac * (y_new[1] - y[1]);
      const T py = y[2] + frac * (y_new[2] - y[2]);
      const T rr = sqrt(px * px + py * py);
      const T phi = atan2(py, px);
      const T cphi = cos(phi), sphi = sin(phi);
      for (int dsc = 0; dsc < P.n_discs; ++dsc) {
        if (!(rr >= P.disc_inner[dsc] && rr <= P.disc_outer[dsc])) continue;
        if (ev_count >= kMaxEvents) {
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
        slot[9] = y_new[1] - y[1];
        slot[10] = y_new[2] - y[2];
        slot[11] = y_new[3] - y[3];
        my_kind[ev_count] = P.disc_kind[dsc];
        ++ev_count;
      }
    }
    // Opaque stop: the first event saturates the fold (after the store).
    if (P.opaque_stop && code == kRunning && ev_count > 0) code = kSaturated;

#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = y_new[i];
    r_here = r_new;
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

// params: radius, a, horizon_eps, h0, max_radius, h_min_frac, r_ref, r_safe.
// discs: n_discs rows of (inner, outer, kind). ints: attempts, budget_steps,
// opaque_stop, finalize, compensated.
template <typename T>
int launch(const void* y0, int64_t n, void* y_out, void* stop, void* steps, void* ev_kind,
           void* ev_data, void* ev_count, void* ev_ovf, const double* params,
           const double* discs, int n_discs, const int* ints, void* stream) {
  if (n_discs < 0 || n_discs > kMaxDiscs) return (int)cudaErrorInvalidValue;
  Params<T> P;
  P.radius = T(params[0]);
  P.a = T(params[1]);
  P.horizon_eps = T(params[2]);
  P.h0 = T(params[3]);
  P.max_radius = T(params[4]);
  P.h_min_frac = T(params[5]);
  P.r_ref = T(params[6]);
  P.r_safe = T(params[7]);
  for (int i = 0; i < kMaxDiscs; ++i) {
    const bool on = i < n_discs;
    P.disc_inner[i] = on ? T(discs[3 * i]) : T(0);
    P.disc_outer[i] = on ? T(discs[3 * i + 1]) : T(0);
    P.disc_kind[i] = on ? (int)discs[3 * i + 2] : -1;
  }
  P.n_discs = n_discs;
  P.attempts = ints[0];
  P.budget_steps = ints[1];
  P.opaque_stop = ints[2];
  P.finalize = ints[3];
  P.compensated = ints[4];
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    march_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        P, (const T*)y0, n, (T*)y_out, (int32_t*)stop, (int32_t*)steps, (int32_t*)ev_kind,
        (T*)ev_data, (int32_t*)ev_count, (uint8_t*)ev_ovf);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int kerr_rk4_march_f32(const void* y0, int64_t n, void* y_out, void* stop, void* steps,
                       void* ev_kind, void* ev_data, void* ev_count, void* ev_ovf,
                       const double* params, const double* discs, int n_discs, const int* ints,
                       void* stream) {
  return launch<float>(y0, n, y_out, stop, steps, ev_kind, ev_data, ev_count, ev_ovf, params,
                       discs, n_discs, ints, stream);
}

int kerr_rk4_march_f64(const void* y0, int64_t n, void* y_out, void* stop, void* steps,
                       void* ev_kind, void* ev_data, void* ev_count, void* ev_ovf,
                       const double* params, const double* discs, int n_discs, const int* ints,
                       void* stream) {
  return launch<double>(y0, n, y_out, stop, steps, ev_kind, ev_data, ev_count, ev_ovf, params,
                        discs, n_discs, ints, stream);
}

}  // extern "C"
