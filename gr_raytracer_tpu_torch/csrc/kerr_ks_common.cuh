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

// The partials of nmax, nmin and clip as their dual versions take them:
// ∂max(x, y)/∂x is 1 where x is taken, 0 where y is, ½ at a tie; clip's is
// max's then min's.
template <typename T>
__device__ __forceinline__ T d_max(T x, T y) {
  return (x != x || x > y) ? T(1) : ((y != y || y > x) ? T(0) : T(0.5));
}
template <typename T>
__device__ __forceinline__ T d_min(T x, T y) {
  return (x != x || x < y) ? T(1) : ((y != y || y < x) ? T(0) : T(0.5));
}
template <typename T>
__device__ __forceinline__ T d_clip(T x, T lo, T hi) {
  return d_max(x, lo) * d_min(nmax(x, lo), hi);
}

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

// Kerr-Schild r alone, given rho_sq = x² + y² + z² (in that order).
template <typename S>
__device__ __forceinline__ S ks_radius_at(S a, S rho_sq, S z) {
  S d = rho_sq - a * a;
  S s = sqrt_(d * d + S(4) * a * a * z * z);
  return sqrt_(S(0.5) * (d + s));
}

template <typename S>
__device__ __forceinline__ S ks_radius(S a, S x, S y, S z) {
  return ks_radius_at(a, x * x + y * y + z * z, z);
}

// |x|² of a state's position, x² + y² + z² in that order (the right-hand
// side's, the far-field lever's and the escape test's).
template <typename S>
__device__ __forceinline__ S position_sq(const S* y) {
  return y[1] * y[1] + y[2] * y[2] + y[3] * y[3];
}

// dy/dλ for y = [x4 | p_cov4] with the hand-derived ∂H/∂x (_rhs), given
// rho_sq = position_sq(y).
template <typename S>
__device__ __forceinline__ void rhs_at(S radius, S a, const S* y, S rho_sq, S* out) {
  const S x = y[1], yy = y[2], z = y[3];
  const S p0 = y[4], p1 = y[5], p2 = y[6], p3 = y[7];
  const S a2 = a * a;
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

template <typename S>
__device__ __forceinline__ void rhs(S radius, S a, const S* y, S* out) {
  rhs_at(radius, a, y, position_sq(y), out);
}

// The VJP of ks_radius: adds (x̄, ȳ, z̄) to xb[0..2] and ā to a_b.
template <typename T>
__device__ __forceinline__ void ks_radius_vjp(T a, T x, T y, T z, T r_bar, T* xb, T& a_b) {
  const T rho_sq = x * x + y * y + z * z;
  const T d = rho_sq - a * a;
  const T s = sqrt_(d * d + T(4) * a * a * z * z);
  const T r = sqrt_(T(0.5) * (d + s));
  const T w_bar = r_bar / (T(2) * r);
  const T v_bar = T(0.5) * w_bar / (T(2) * s);
  const T d_bar = T(0.5) * w_bar + T(2) * d * v_bar;
  a_b = a_b + (T(8) * a * z * z * v_bar - T(2) * a * d_bar);
  xb[0] = xb[0] + T(2) * x * d_bar;
  xb[1] = xb[1] + T(2) * y * d_bar;
  xb[2] = xb[2] + (T(8) * a * a * z * v_bar + T(2) * z * d_bar);
}

// The VJP of rhs at y along ob (ob[4], the cotangent of ṗ_t = 0, takes
// none): writes ȳ to yb[0..7] (ȳ_t = 0) and adds radius̄ and ā to rb, ab.
// The forward lines are rhs's; the backward walks them in reverse
// (ops/geodesic_adjoint.py _ks_rhs_vjp, line for line).
template <typename T>
__device__ __forceinline__ void rhs_vjp(T radius, T a, const T* y, const T* ob, T* yb, T& rb, T& ab) {
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
  const T n_xx = dr_x * x + r - kx * dr2_x;
  const T n_xy = dr_y * x + a - kx * dr2_y;
  const T n_xz = dr_z * x - kx * dr2_z;
  const T n_yx = dr_x * yy - a - ky * dr2_x;
  const T n_yy = dr_y * yy + r - ky * dr2_y;
  const T n_yz = dr_z * yy - ky * dr2_z;
  const T dkx_x = n_xx * inv_denom, dkx_y = n_xy * inv_denom, dkx_z = n_xz * inv_denom;
  const T dky_x = n_yx * inv_denom, dky_y = n_yy * inv_denom, dky_z = n_yz * inv_denom;
  const T zir2 = z * inv_r * inv_r;
  const T dkz_x = -zir2 * dr_x;
  const T dkz_y = -zir2 * dr_y;
  const T dkz_z = inv_r - zir2 * dr_z;
  const T dkp_x = p1 * dkx_x + p2 * dky_x + p3 * dkz_x;
  const T dkp_y = p1 * dkx_y + p2 * dky_y + p3 * dkz_y;
  const T dkp_z = p1 * dkx_z + p2 * dky_z + p3 * dkz_z;
  const T kp2 = k_dot_p * k_dot_p;
  const T fkp = f * k_dot_p;

  // Backward. ṗ_i = ½ ∂f_i (k·p)² + f (k·p) ∂(k·p)_i.
  const T o0 = ob[0], o1 = ob[1], o2 = ob[2], o3 = ob[3], o5 = ob[5], o6 = ob[6], o7 = ob[7];
  const T df_x_b = T(0.5) * kp2 * o5, df_y_b = T(0.5) * kp2 * o6, df_z_b = T(0.5) * kp2 * o7;
  const T kp2_b = T(0.5) * (df_x * o5 + df_y * o6 + df_z * o7);
  const T fkp_b = dkp_x * o5 + dkp_y * o6 + dkp_z * o7;
  const T dkp_x_b = fkp * o5, dkp_y_b = fkp * o6, dkp_z_b = fkp * o7;
  T f_b = k_dot_p * fkp_b;
  T kdp_b = f * fkp_b + T(2) * k_dot_p * kp2_b;
  // ∂(k·p)_i = Σ_j p_j ∂k_j/∂x_i.
  T p1_b = dkx_x * dkp_x_b + dkx_y * dkp_y_b + dkx_z * dkp_z_b;
  T p2_b = dky_x * dkp_x_b + dky_y * dkp_y_b + dky_z * dkp_z_b;
  T p3_b = dkz_x * dkp_x_b + dkz_y * dkp_y_b + dkz_z * dkp_z_b;
  const T dkx_x_b = p1 * dkp_x_b, dkx_y_b = p1 * dkp_y_b, dkx_z_b = p1 * dkp_z_b;
  const T dky_x_b = p2 * dkp_x_b, dky_y_b = p2 * dkp_y_b, dky_z_b = p2 * dkp_z_b;
  const T dkz_x_b = p3 * dkp_x_b, dkz_y_b = p3 * dkp_y_b, dkz_z_b = p3 * dkp_z_b;
  // ∂k_z.
  T inv_r_b = dkz_z_b;
  const T zir2_b = -(dr_x * dkz_x_b + dr_y * dkz_y_b + dr_z * dkz_z_b);
  T dr_x_b = -zir2 * dkz_x_b;
  T dr_y_b = -zir2 * dkz_y_b;
  T dr_z_b = -zir2 * dkz_z_b;
  T z_b = inv_r * inv_r * zir2_b;
  inv_r_b = inv_r_b + T(2) * z * inv_r * zir2_b;
  // ∂k_x, ∂k_y: n_ji · 1/(r² + a²).
  T inv_denom_b = (n_xx * dkx_x_b + n_xy * dkx_y_b + n_xz * dkx_z_b
                   + n_yx * dky_x_b + n_yy * dky_y_b + n_yz * dky_z_b);
  const T nxx_b = dkx_x_b * inv_denom, nxy_b = dkx_y_b * inv_denom, nxz_b = dkx_z_b * inv_denom;
  const T nyx_b = dky_x_b * inv_denom, nyy_b = dky_y_b * inv_denom, nyz_b = dky_z_b * inv_denom;
  dr_x_b = dr_x_b + x * nxx_b + yy * nyx_b;
  dr_y_b = dr_y_b + x * nxy_b + yy * nyy_b;
  dr_z_b = dr_z_b + x * nxz_b + yy * nyz_b;
  T x_b = dr_x * nxx_b + dr_y * nxy_b + dr_z * nxz_b;
  T yy_b = dr_x * nyx_b + dr_y * nyy_b + dr_z * nyz_b;
  T r_b = nxx_b + nyy_b;
  T a_b = nxy_b - nyx_b;
  T kx_b = -(dr2_x * nxx_b + dr2_y * nxy_b + dr2_z * nxz_b);
  T ky_b = -(dr2_x * nyx_b + dr2_y * nyy_b + dr2_z * nyz_b);
  T dr2_x_b = -(kx * nxx_b + ky * nyx_b);
  T dr2_y_b = -(kx * nxy_b + ky * nyy_b);
  T dr2_z_b = -(kx * nxz_b + ky * nyz_b);
  // ∂f.
  const T m_z = t1 * dr_z - T(2) * a2 * z * r;
  const T cft1_b = dr_x * df_x_b + dr_y * df_y_b;
  const T cf_b = t1 * cft1_b + m_z * df_z_b;
  const T mz_b = cf * df_z_b;
  const T t1_b = cf * cft1_b + dr_z * mz_b;
  dr_x_b = dr_x_b + cf * t1 * df_x_b;
  dr_y_b = dr_y_b + cf * t1 * df_y_b;
  dr_z_b = dr_z_b + t1 * mz_b;
  T a2_b = T(-2) * z * r * mz_b;
  z_b = z_b - T(2) * a2 * r * mz_b;
  r_b = r_b - T(2) * a2 * z * mz_b;
  a2_b = a2_b + T(3) * z * z * t1_b;
  z_b = z_b + T(6) * a2 * z * t1_b;
  T r_sq_b = T(-2) * r_sq * t1_b;
  T radius_b = r_sq * inv_D * inv_D * cf_b;
  r_sq_b = r_sq_b + radius * inv_D * inv_D * cf_b;
  T inv_D_b = T(2) * radius * r_sq * inv_D * cf_b;
  // ∂r_i = ∂r²_i / (2r).
  dr2_x_b = dr2_x_b + half_inv_r * dr_x_b;
  dr2_y_b = dr2_y_b + half_inv_r * dr_y_b;
  dr2_z_b = dr2_z_b + half_inv_r * dr_z_b;
  inv_r_b = inv_r_b + T(0.5) * (dr2_x * dr_x_b + dr2_y * dr_y_b + dr2_z * dr_z_b);
  const T common_b = x * dr2_x_b + yy * dr2_y_b + z * dr2_z_b;
  x_b = x_b + common * dr2_x_b;
  yy_b = yy_b + common * dr2_y_b;
  z_b = z_b + (common + T(2) * a2 * inv_s) * dr2_z_b;
  a2_b = a2_b + T(2) * z * inv_s * dr2_z_b;
  T inv_s_b = T(2) * a2 * z * dr2_z_b + d * common_b;
  T d_b = inv_s * common_b;
  // ẋ = ∂H/∂p.
  const T fk_dot = f * k_dot_p;
  const T out_b = o0 - kx * o1 - ky * o2 - kz * o3;
  p1_b = p1_b + o1;
  p2_b = p2_b + o2;
  p3_b = p3_b + o3;
  T p0_b = -o0;
  f_b = f_b + k_dot_p * out_b;
  kx_b = kx_b - fk_dot * o1;
  ky_b = ky_b - fk_dot * o2;
  T kz_b = -fk_dot * o3;
  kdp_b = kdp_b + f * out_b;
  // k·p = −p_0 + k_x p_1 + k_y p_2 + k_z p_3.
  p0_b = p0_b - kdp_b;
  p1_b = p1_b + kx * kdp_b;
  p2_b = p2_b + ky * kdp_b;
  p3_b = p3_b + kz * kdp_b;
  kx_b = kx_b + p1 * kdp_b;
  ky_b = ky_b + p2 * kdp_b;
  kz_b = kz_b + p3 * kdp_b;
  // k and f.
  z_b = z_b + inv_r * kz_b;
  inv_r_b = inv_r_b + z * kz_b;
  inv_denom_b = inv_denom_b + (r * x + a * yy) * kx_b + (r * yy - a * x) * ky_b;
  const T nkx_b = kx_b * inv_denom, nky_b = ky_b * inv_denom;
  r_b = r_b + x * nkx_b + yy * nky_b;
  x_b = x_b + r * nkx_b - a * nky_b;
  yy_b = yy_b + a * nkx_b + r * nky_b;
  a_b = a_b + yy * nkx_b - x * nky_b;
  radius_b = radius_b + r * r_sq * inv_D * f_b;
  r_b = r_b + radius * r_sq * inv_D * f_b;
  r_sq_b = r_sq_b + radius * r * inv_D * f_b;
  inv_D_b = inv_D_b + radius * r * r_sq * f_b;
  // The shared divide 1/(D·(r² + a²)).
  const T inv_Dd_b = D * inv_denom_b + denom * inv_D_b;
  const T prod_b = -inv_Dd * inv_Dd * inv_Dd_b;
  const T D_b = inv_Dd * inv_denom_b + denom * prod_b;
  const T denom_b = inv_Dd * inv_D_b + D * prod_b;
  r_sq_b = r_sq_b + denom_b + T(2) * r_sq * D_b;
  a2_b = a2_b + denom_b + z * z * D_b;
  z_b = z_b + T(2) * a2 * z * D_b;
  // r = r²·r⁻¹, r⁻¹ = rsqrt(r²), r² = ½(d + s), s⁻¹ = rsqrt(dd4).
  r_sq_b = r_sq_b + inv_r * r_b;
  inv_r_b = inv_r_b + r_sq * r_b;
  r_sq_b = r_sq_b - T(0.5) * inv_r * inv_r * inv_r * inv_r_b;
  d_b = d_b + T(0.5) * r_sq_b;
  T dd4_b = T(0.5) * inv_s * r_sq_b;
  inv_s_b = inv_s_b + T(0.5) * dd4 * r_sq_b;
  dd4_b = dd4_b - T(0.5) * inv_s * inv_s * inv_s * inv_s_b;
  d_b = d_b + T(2) * d * dd4_b;
  a2_b = a2_b + T(4) * z * z * dd4_b - d_b;
  z_b = z_b + T(8) * a2 * z * dd4_b;
  yb[0] = T(0);
  yb[1] = x_b + T(2) * x * d_b;
  yb[2] = yy_b + T(2) * yy * d_b;
  yb[3] = z_b + T(2) * z * d_b;
  yb[4] = p0_b;
  yb[5] = p1_b;
  yb[6] = p2_b;
  yb[7] = p3_b;
  rb = rb + radius_b;
  ab = ab + a_b + T(2) * a * a2_b;
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
// r_here and carried rho_sq = position_sq(y): h = h0·clip((r − r₊)/r_ref,
// h_min_frac, 1), widened by the far-field lever (half the remaining gap
// beyond r_safe, capped at ρ/8, for an outward lane). `Guarded` selects the
// reverse sweep's variant, whose far-field speed is sqrt(max(|v|², 1e-30))
// so that its derivative stays finite: the value is the same on every real
// lane.
template <bool Guarded, typename S, typename T>
__device__ __forceinline__ void rk4_delta_at(const StepRule<T>& R, S radius, S a, S r_plus, S r_here,
                                             S rho_sq, const S* y, S* delta) {
  S h = S(R.h0) * clip((r_here - r_plus) / S(R.r_ref), S(R.h_min_frac), S(1));
  S k[8], acc[8], tmp[8];
  rhs_at(radius, a, y, rho_sq, k);
  if (R.r_safe > T(0)) {
    const S rho = sqrt_(rho_sq);
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

// rk4_delta_at with rho_sq computed from y.
template <bool Guarded, typename S, typename T>
__device__ __forceinline__ void rk4_delta(const StepRule<T>& R, S radius, S a, S r_plus, S r_here,
                                          const S* y, S* delta) {
  rk4_delta_at<Guarded>(R, radius, a, r_plus, r_here, position_sq(y), y, delta);
}

}  // namespace ks
