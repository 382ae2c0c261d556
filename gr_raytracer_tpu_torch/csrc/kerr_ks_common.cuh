// Device code shared by the Kerr-Schild march (kerr_rk4_march.cu, K1) and
// its reverse sweep (kerr_ks_adjoint.cu, K2); the dual numbers and the
// start of a march (fresh or resumed) serve the Boyer-Lindquist kernels K3
// and K4 too.
//
// Everything here is templated on the scalar type S: float or double for
// the march, Dual<float> or Dual<double> (a value and one forward-mode
// tangent) for the step Jacobian of the reverse sweep. The value part of a
// Dual computes exactly the arithmetic of the plain type, so the reverse
// sweep's re-forward and its derivatives see the march's trajectory bit
// for bit. Both kernels are built with -fmad=false (ops/cuda_build.py).
//
// The plain torch versions of these functions are in
// ops/geodesic_march.py (_ks_radius, _rhs, _momentum_contra) and
// ops/geodesic_adjoint.py (_masked_step, _disc_payload).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ks {

constexpr int kMaxEvents = 8;
constexpr int kEventWidth = 12;
constexpr int kMaxDiscs = 8;

// Stop codes, as in rendering/integrator.py.
constexpr int kRunning = 0;
constexpr int kHorizon = 1;
constexpr int kCelestial = 2;
constexpr int kNaN = 3;
constexpr int kTrapped = 4;
constexpr int kBudget = 5;
constexpr int kSaturated = 7;

// ---------------------------------------------------------------------------
// Forward-mode dual numbers: v + d·ε with ε² = 0.
// ---------------------------------------------------------------------------

template <typename T>
struct Dual {
  T v, d;
  __device__ __forceinline__ Dual() : v(T(0)), d(T(0)) {}
  __device__ __forceinline__ Dual(T v_) : v(v_), d(T(0)) {}
  __device__ __forceinline__ Dual(T v_, T d_) : v(v_), d(d_) {}
};

template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> x, Dual<T> y) {
  return Dual<T>(x.v + y.v, x.d + y.d);
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> x, Dual<T> y) {
  return Dual<T>(x.v - y.v, x.d - y.d);
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> x) {
  return Dual<T>(-x.v, -x.d);
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> x, Dual<T> y) {
  return Dual<T>(x.v * y.v, x.v * y.d + x.d * y.v);
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> x, Dual<T> y) {
  const T q = x.v / y.v;
  return Dual<T>(q, (x.d - q * y.d) / y.v);
}
template <typename T>
__device__ __forceinline__ bool operator<(Dual<T> x, Dual<T> y) { return x.v < y.v; }
template <typename T>
__device__ __forceinline__ bool operator>(Dual<T> x, Dual<T> y) { return x.v > y.v; }
template <typename T>
__device__ __forceinline__ bool operator<=(Dual<T> x, Dual<T> y) { return x.v <= y.v; }
template <typename T>
__device__ __forceinline__ bool operator>=(Dual<T> x, Dual<T> y) { return x.v >= y.v; }
template <typename T>
__device__ __forceinline__ bool operator==(Dual<T> x, Dual<T> y) { return x.v == y.v; }
template <typename T>
__device__ __forceinline__ bool operator!=(Dual<T> x, Dual<T> y) { return x.v != y.v; }

__device__ __forceinline__ float value(float x) { return x; }
__device__ __forceinline__ double value(double x) { return x; }
template <typename T>
__device__ __forceinline__ T value(Dual<T> x) { return x.v; }

__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float atan2_(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double atan2_(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ float fabs_(float x) { return fabsf(x); }
__device__ __forceinline__ double fabs_(double x) { return fabs(x); }
__device__ __forceinline__ float atan_(float x) { return atanf(x); }
__device__ __forceinline__ double atan_(double x) { return atan(x); }

template <typename T>
__device__ __forceinline__ Dual<T> sqrt_(Dual<T> x) {
  const T s = sqrt_(x.v);
  return Dual<T>(s, x.d / (T(2) * s));
}
template <typename T>
__device__ __forceinline__ Dual<T> rsqrt_(Dual<T> x) {
  const T r = rsqrt_(x.v);
  return Dual<T>(r, T(-0.5) * r * r * r * x.d);
}
// The exact derivative of atan2 (the JAX kernels differentiate a
// polynomial atan2 instead; the two derivatives agree to ~1e-9).
template <typename T>
__device__ __forceinline__ Dual<T> atan2_(Dual<T> y, Dual<T> x) {
  return Dual<T>(atan2_(y.v, x.v), (x.v * y.d - y.v * x.d) / (x.v * x.v + y.v * y.v));
}
template <typename T>
__device__ __forceinline__ Dual<T> atan_(Dual<T> x) {
  return Dual<T>(atan_(x.v), x.d / (T(1) + x.v * x.v));
}
template <typename T>
__device__ __forceinline__ Dual<T> cos_(Dual<T> x) {
  return Dual<T>(cos_(x.v), -sin_(x.v) * x.d);
}
template <typename T>
__device__ __forceinline__ Dual<T> sin_(Dual<T> x) {
  return Dual<T>(sin_(x.v), cos_(x.v) * x.d);
}
// sin and cos of one angle from one range reduction: the same values as
// sin_ and cos_ (the library's sincos shares their reduction and
// polynomials), and for duals the same tangents.
__device__ __forceinline__ void sincos_(float x, float& s, float& c) { sincosf(x, &s, &c); }
__device__ __forceinline__ void sincos_(double x, double& s, double& c) { sincos(x, &s, &c); }
template <typename T>
__device__ __forceinline__ void sincos_(Dual<T> x, Dual<T>& s, Dual<T>& c) {
  T sv, cv;
  sincos_(x.v, sv, cv);
  s = Dual<T>(sv, cv * x.d);
  c = Dual<T>(cv, -sv * x.d);
}

// NaN-propagating max / min / clip, the semantics of jnp.maximum & co. For
// duals a tie splits the tangent half and half, as jnp.maximum's VJP does
// (ties are exact equalities and never met on a real lane). `clip` is a
// select on the value: a clipped dual takes the bound's zero tangent.
template <typename T>
__device__ __forceinline__ T nmax(T x, T y) {
  return (x != x) ? x : ((y != y) ? y : (x > y ? x : y));
}
template <typename T>
__device__ __forceinline__ T nmin(T x, T y) {
  return (x != x) ? x : ((y != y) ? y : (x < y ? x : y));
}
template <typename T>
__device__ __forceinline__ Dual<T> nmax(Dual<T> x, Dual<T> y) {
  if (x.v != x.v || x.v > y.v) return x;
  if (y.v != y.v || y.v > x.v) return y;
  return Dual<T>(x.v, T(0.5) * (x.d + y.d));
}
template <typename T>
__device__ __forceinline__ Dual<T> nmin(Dual<T> x, Dual<T> y) {
  if (x.v != x.v || x.v < y.v) return x;
  if (y.v != y.v || y.v < x.v) return y;
  return Dual<T>(x.v, T(0.5) * (x.d + y.d));
}
template <typename S>
__device__ __forceinline__ S clip(S x, S lo, S hi) {
  return nmin(nmax(x, lo), hi);
}

template <typename T>
__device__ __forceinline__ bool is_finite(T x) { return isfinite(x); }

// ---------------------------------------------------------------------------
// The per-lane start of a march (K1 and K3): fresh, or a previous call's
// results (resume). A resumed lane keeps its stop code, step count, events
// and overflow flag; a lane that is not RUNNING stays frozen.
// ---------------------------------------------------------------------------

template <typename T>
struct ResumeIn {
  const int32_t* stop;  // null: a fresh march
  const int32_t* steps;
  const int32_t* ev_kind;  // [n, max_events]
  const T* ev_data;        // [n, max_events, 12]
  const int32_t* ev_count;
  const uint8_t* ev_ovf;
};

// rows: null, or the six pointers (stop, steps, ev_kind, ev_data, ev_count,
// ev_ovf) of a previous call's results on the card.
template <typename T>
__host__ ResumeIn<T> resume_in(const void* const* rows) {
  ResumeIn<T> R;
  R.stop = rows ? (const int32_t*)rows[0] : nullptr;
  R.steps = rows ? (const int32_t*)rows[1] : nullptr;
  R.ev_kind = rows ? (const int32_t*)rows[2] : nullptr;
  R.ev_data = rows ? (const T*)rows[3] : nullptr;
  R.ev_count = rows ? (const int32_t*)rows[4] : nullptr;
  R.ev_ovf = rows ? (const uint8_t*)rows[5] : nullptr;
  return R;
}

// Fill the lane's output event slots and its counters from R. Each input
// of the lane is read before the same lane's output is written, so the
// outputs may alias the inputs.
template <typename T>
__device__ __forceinline__ void start_lane(const ResumeIn<T>& R, int64_t lane, int max_events,
                                           int32_t* my_kind, T* my_data, int& stop, int& steps,
                                           int& ev_count, bool& ev_ovf) {
  if (R.stop == nullptr) {
    for (int k = 0; k < max_events; ++k) my_kind[k] = -1;
    for (int k = 0; k < max_events * kEventWidth; ++k) my_data[k] = T(0);
    stop = kRunning;
    steps = 0;
    ev_count = 0;
    ev_ovf = false;
    return;
  }
  const int32_t* kind_in = R.ev_kind + lane * max_events;
  const T* data_in = R.ev_data + lane * max_events * kEventWidth;
  for (int k = 0; k < max_events; ++k) my_kind[k] = kind_in[k];
  for (int k = 0; k < max_events * kEventWidth; ++k) my_data[k] = data_in[k];
  stop = R.stop[lane];
  steps = R.steps[lane];
  ev_count = R.ev_count[lane];
  ev_ovf = R.ev_ovf[lane] != 0;
}

// ---------------------------------------------------------------------------
// Kerr-Schild geometry
// ---------------------------------------------------------------------------

// Kerr-Schild r alone.
template <typename S>
__device__ __forceinline__ S ks_radius(S a, S x, S y, S z) {
  S rho_sq = x * x + y * y + z * z;
  S d = rho_sq - a * a;
  S s = sqrt_(d * d + S(4) * a * a * z * z);
  return sqrt_(S(0.5) * (d + s));
}

// dy/dλ for y = [x4 | p_cov4] with the hand-derived ∂H/∂x (_rhs).
template <typename S>
__device__ __forceinline__ void rhs(S radius, S a, const S* y, S* out) {
  const S x = y[1], yy = y[2], z = y[3];
  const S p0 = y[4], p1 = y[5], p2 = y[6], p3 = y[7];
  const S a2 = a * a;
  const S rho_sq = x * x + yy * yy + z * z;
  const S d = rho_sq - a2;
  const S dd4 = d * d + S(4) * a2 * z * z;
  const S inv_s = rsqrt_(dd4);
  const S r_sq = S(0.5) * (d + dd4 * inv_s);
  const S inv_r = rsqrt_(r_sq);
  const S r = r_sq * inv_r;
  const S D = r_sq * r_sq + a2 * z * z;
  const S denom = r_sq + a2;
  const S inv_Dd = S(1) / (D * denom);
  const S inv_D = inv_Dd * denom;
  const S inv_denom = inv_Dd * D;
  const S f = radius * r * r_sq * inv_D;
  const S kx = (r * x + a * yy) * inv_denom;
  const S ky = (r * yy - a * x) * inv_denom;
  const S kz = z * inv_r;

  const S k_dot_p = -p0 + kx * p1 + ky * p2 + kz * p3;
  out[0] = -p0 + f * k_dot_p;
  out[1] = p1 - f * kx * k_dot_p;
  out[2] = p2 - f * ky * k_dot_p;
  out[3] = p3 - f * kz * k_dot_p;
  out[4] = S(0);  // p_t conserved (stationary metric)

  const S common = S(1) + d * inv_s;
  const S dr2_x = x * common;
  const S dr2_y = yy * common;
  const S dr2_z = z * common + S(2) * a2 * z * inv_s;
  const S half_inv_r = S(0.5) * inv_r;
  const S dr_x = dr2_x * half_inv_r;
  const S dr_y = dr2_y * half_inv_r;
  const S dr_z = dr2_z * half_inv_r;

  const S cf = radius * r_sq * inv_D * inv_D;
  const S t1 = S(3) * a2 * z * z - r_sq * r_sq;
  const S df_x = cf * t1 * dr_x;
  const S df_y = cf * t1 * dr_y;
  const S df_z = cf * (t1 * dr_z - S(2) * a2 * z * r);

  const S dkx_x = (dr_x * x + r - kx * dr2_x) * inv_denom;
  const S dkx_y = (dr_y * x + a - kx * dr2_y) * inv_denom;
  const S dkx_z = (dr_z * x - kx * dr2_z) * inv_denom;
  const S dky_x = (dr_x * yy - a - ky * dr2_x) * inv_denom;
  const S dky_y = (dr_y * yy + r - ky * dr2_y) * inv_denom;
  const S dky_z = (dr_z * yy - ky * dr2_z) * inv_denom;
  const S zir2 = z * inv_r * inv_r;
  const S dkz_x = -zir2 * dr_x;
  const S dkz_y = -zir2 * dr_y;
  const S dkz_z = inv_r - zir2 * dr_z;

  const S dkp_x = p1 * dkx_x + p2 * dky_x + p3 * dkz_x;
  const S dkp_y = p1 * dkx_y + p2 * dky_y + p3 * dkz_y;
  const S dkp_z = p1 * dkx_z + p2 * dky_z + p3 * dkz_z;

  const S kp2 = k_dot_p * k_dot_p;
  const S fkp = f * k_dot_p;
  out[5] = S(0.5) * df_x * kp2 + fkp * dkp_x;
  out[6] = S(0.5) * df_y * kp2 + fkp * dkp_y;
  out[7] = S(0.5) * df_z * kp2 + fkp * dkp_z;
}

// p^μ from the covariant state (_momentum_contra via _ks_scalars).
template <typename S>
__device__ __forceinline__ void momentum_contra(S radius, S a, const S* y, S* p) {
  const S x = y[1], yy = y[2], z = y[3];
  const S rho_sq = x * x + yy * yy + z * z;
  const S d = rho_sq - a * a;
  const S r_sq = S(0.5) * (d + sqrt_(d * d + S(4) * a * a * z * z));
  const S r = sqrt_(r_sq);
  const S f = (r * r_sq * radius) / (r_sq * r_sq + a * a * z * z);
  const S denom = r_sq + a * a;
  const S kx = (r * x + a * yy) / denom;
  const S ky = (r * yy - a * x) / denom;
  const S kz = z / nmax(r, S(1e-30));
  const S k_dot_p = -y[4] + kx * y[5] + ky * y[6] + kz * y[7];
  p[0] = -y[4] + f * k_dot_p;
  p[1] = y[5] - f * kx * k_dot_p;
  p[2] = y[6] - f * ky * k_dot_p;
  p[3] = y[7] - f * kz * k_dot_p;
}

// Step-rule constants of the march (host floats rounded to T).
template <typename T>
struct StepRule {
  T h0, h_min_frac, r_ref, r_safe;
};

// One RK4 increment y_new − y of the march from state y with carried radius
// r_here: h = h0·clip((r − r₊)/r_ref, h_min_frac, 1), widened by the
// far-field lever (half the remaining gap beyond r_safe, capped at ρ/8, for
// an outward lane). `Guarded` selects the reverse sweep's variant, whose
// far-field speed is sqrt(max(|v|², 1e-30)) so that its derivative stays
// finite: the value is the same on every real lane.
template <bool Guarded, typename S, typename T>
__device__ __forceinline__ void rk4_delta(const StepRule<T>& R, S radius, S a, S r_plus, S r_here,
                                          const S* y, S* delta) {
  S h = S(R.h0) * clip((r_here - r_plus) / S(R.r_ref), S(R.h_min_frac), S(1));
  S k[8], acc[8], tmp[8];
  rhs(radius, a, y, k);
  if (R.r_safe > T(0)) {
    const S rho = sqrt_(y[1] * y[1] + y[2] * y[2] + y[3] * y[3]);
    const S speed2 = k[1] * k[1] + k[2] * k[2] + k[3] * k[3];
    const S speed = Guarded ? sqrt_(nmax(speed2, S(1e-30))) : sqrt_(speed2);
    const bool outward = (y[1] * k[1] + y[2] * k[2] + y[3] * k[3]) > S(0);
    const S r_safe = S(R.r_safe);
    const S h_far = nmin(S(0.5) * (rho - r_safe), S(0.125) * rho) / nmax(speed, S(1e-12));
    if (outward && rho > r_safe) h = nmax(h, h_far);
  }
  const S half_h = S(0.5) * h;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[i] = k[i];
    tmp[i] = y[i] + half_h * k[i];
  }
  rhs(radius, a, tmp, k);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[i] = acc[i] + S(2) * k[i];
    tmp[i] = y[i] + half_h * k[i];
  }
  rhs(radius, a, tmp, k);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[i] = acc[i] + S(2) * k[i];
    tmp[i] = y[i] + h * k[i];
  }
  rhs(radius, a, tmp, k);
  const S h6 = h / S(6);
#pragma unroll
  for (int i = 0; i < 8; ++i) delta[i] = h6 * (acc[i] + k[i]);
}

}  // namespace ks
