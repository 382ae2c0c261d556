// Device code shared by the Boyer-Lindquist march (kerr_bl_march.cu, K3)
// and its reverse sweep (kerr_bl_adjoint.cu, K4).
//
// The state is (t, r, θ, φ, v_r, v_θ, 0, 0) in Mino time λ; E, L_z and Q
// are per-lane constants. As in kerr_ks_common.cuh (whose Dual type and
// math wrappers this header uses), every function is templated on the
// scalar type S: float or double for the march, Dual<float> or
// Dual<double> for the step Jacobian of the reverse sweep, whose value part
// computes exactly the march's arithmetic. Both kernels are built with
// -fmad=false (ops/cuda_build.py).
//
// The plain torch versions of these functions are in
// ops/geodesic_march.py (_bl_rhs, _bl_momentum, _bl_embed3, _bl_step_size,
// _bl_rk4_delta) and ops/geodesic_adjoint.py (_bl_masked_step,
// _bl_disc_payload, _bl_rhs_vjp); the order of every operation is theirs.

#pragma once

#include "kerr_ks_common.cuh"

namespace bl {

using namespace ks;

__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
// The derivative of |x| is sign(x), 0 at 0 (as jnp.abs's).
template <typename T>
__device__ __forceinline__ Dual<T> abs_(Dual<T> x) {
  const T s = x.v > T(0) ? T(1) : (x.v < T(0) ? T(-1) : T(0));
  return Dual<T>(abs_(x.v), s * x.d);
}

// The terms of mino_rhs that depend on the lane alone, each rounded as
// mino_rhs's expression rounds it (its products are taken left to right),
// so that a march computes them once.
template <typename S>
struct MinoConsts {
  S a2;      // a·a
  S a_lz;    // a·L_z
  S a_e;     // a·E
  S carter;  // (L_z − a·E)² + Q
  S th_a;    // −2·a·a·E·E
  S th_l;    // 2·L_z·L_z
};

template <typename S>
__device__ __forceinline__ MinoConsts<S> mino_consts(S a, S e, S l_z, S q) {
  MinoConsts<S> C;
  C.a2 = a * a;
  C.a_lz = a * l_z;
  C.a_e = a * e;
  const S lae = l_z - C.a_e;
  C.carter = lae * lae + q;
  C.th_a = S(-2) * a * a * e * e;
  C.th_l = S(2) * l_z * l_z;
  return C;
}

// Mino-time dy/dλ for components 0..5 (6 and 7 are 0), given st, ct =
// sin θ, cos θ of y (its reverse mode is mino_rhs_vjp below). The
// reciprocals 1/Δ, 1/sin²θ and 1/sin³θ share one divide, 1/(Δ·sin²θ). At
// a pole the result is not finite, and the march stops the lane NAN
// (_bl_rhs, whose products −2·a·a·E·E·cosθ·sinθ and 2·L_z·L_z·cosθ/sin³θ
// begin with C.th_a and C.th_l).
template <typename S>
__device__ __forceinline__ void mino_rhs(S r_s, S a, S e, S l_z, const MinoConsts<S>& C, const S* y,
                                         S st, S ct, S* out) {
  const S r = y[1];
  const S delta = r * r - r_s * r + C.a2;
  const S p_r = (r * r + C.a2) * e - C.a_lz;
  const S sin2 = st * st;
  const S inv_ds = S(1) / (delta * sin2);
  const S inv_delta = inv_ds * sin2;
  const S inv_sin2 = inv_ds * delta;
  out[0] = (r * r + C.a2) * inv_delta * p_r + a * (l_z - C.a_e * sin2);
  out[1] = y[4];
  out[2] = y[5];
  out[3] = a * inv_delta * p_r + l_z * inv_sin2 - C.a_e;
  out[4] = S(0.5) * (S(4) * r * e * p_r - (S(2) * r - r_s) * C.carter);
  const S inv_st3 = st * inv_sin2 * inv_sin2;
  out[5] = S(0.5) * (C.th_a * ct * st + C.th_l * ct * inv_st3);
}

// The VJP of mino_rhs along the cotangents ob0, ob3, ob4, ob5 of its
// components 0, 3, 4, 5 (1 and 2 are v_r and v_θ, whose cotangents pass
// to them unchanged): returns r̄, sin θ̄ and cos θ̄ of the stage, and adds
// the stage's r̄_s, ā, Ē, L̄_z and the bars of the lane terms to the
// accumulators (ops/geodesic_adjoint.py _bl_rhs_vjp, line for line).
template <typename T>
__device__ __forceinline__ void mino_rhs_vjp(T r_s, T a, T e, T l_z, const MinoConsts<T>& C, T r, T st,
                                             T ct, T ob0, T ob3, T ob4, T ob5, T& r_b, T& st_b, T& ct_b,
                                             T& rs_acc, T& a_acc, T& e_acc, T& lz_acc,
                                             MinoConsts<T>& Cb) {
  // Forward.
  const T delta = r * r - r_s * r + C.a2;
  const T big_a = r * r + C.a2;
  const T p_r = big_a * e - C.a_lz;
  const T sin2 = st * st;
  const T inv_ds = T(1) / (delta * sin2);
  const T inv_delta = inv_ds * sin2;
  const T inv_sin2 = inv_ds * delta;
  const T b0 = big_a * inv_delta;
  const T w = l_z - C.a_e * sin2;
  const T ai = a * inv_delta;
  const T inv_st3 = st * inv_sin2 * inv_sin2;
  const T four_re = T(4) * r * e;
  // Backward.
  const T b0_b = ob0 * p_r;
  T p_r_b = ob0 * b0 + ob3 * ai;
  const T w_b = ob0 * a;
  const T ai_b = ob3 * p_r;
  a_acc = a_acc + (ob0 * w + ai_b * inv_delta);
  const T inv_delta_b = ai_b * a + b0_b * big_a;
  T big_a_b = b0_b * inv_delta;
  lz_acc = lz_acc + (w_b + ob3 * inv_sin2);
  T inv_sin2_b = ob3 * l_z;
  Cb.a_e = Cb.a_e + (-ob3 - w_b * sin2);
  T sin2_b = -w_b * C.a_e;
  const T x4 = T(0.5) * ob4;
  p_r_b = p_r_b + x4 * four_re;
  const T four_re_b = x4 * p_r;
  r_b = T(4) * e * four_re_b - T(2) * x4 * C.carter;
  T e_b = T(4) * r * four_re_b;
  rs_acc = rs_acc + x4 * C.carter;
  Cb.carter = Cb.carter - x4 * (T(2) * r - r_s);
  const T x5 = T(0.5) * ob5;
  Cb.th_a = Cb.th_a + x5 * ct * st;
  Cb.th_l = Cb.th_l + x5 * ct * inv_st3;
  ct_b = x5 * (C.th_a * st + C.th_l * inv_st3);
  st_b = x5 * C.th_a * ct;
  const T inv_st3_b = x5 * C.th_l * ct;
  st_b = st_b + inv_st3_b * inv_sin2 * inv_sin2;
  inv_sin2_b = inv_sin2_b + T(2) * inv_st3_b * st * inv_sin2;
  const T inv_ds_b = inv_sin2_b * delta + inv_delta_b * sin2;
  T delta_b = inv_sin2_b * inv_ds;
  sin2_b = sin2_b + inv_delta_b * inv_ds;
  const T prod_b = -inv_ds * inv_ds * inv_ds_b;
  delta_b = delta_b + prod_b * sin2;
  sin2_b = sin2_b + prod_b * delta;
  st_b = st_b + T(2) * st * sin2_b;
  big_a_b = big_a_b + p_r_b * e;
  e_acc = e_acc + (e_b + p_r_b * big_a);
  Cb.a_lz = Cb.a_lz - p_r_b;
  r_b = r_b + T(2) * r * big_a_b + delta_b * (T(2) * r - r_s);
  rs_acc = rs_acc - delta_b * r;
  Cb.a2 = Cb.a2 + (big_a_b + delta_b);
}

// p^μ = (1/Σ)(dt/dλ, v_r, v_θ, dφ/dλ); each reciprocal is its own divide
// (_bl_momentum).
template <typename S>
__device__ __forceinline__ void bl_momentum(S r_s, S a, S e, S l_z, const S* y, S* p) {
  const S r = y[1], theta = y[2];
  const S ct = cos_(theta);
  const S sig = r * r + a * a * (ct * ct);
  const S delta = r * r - r_s * r + a * a;
  const S p_r = (r * r + a * a) * e - a * l_z;
  const S st = sin_(theta);
  const S sin2 = st * st;
  const S dt = (r * r + a * a) / delta * p_r + a * (l_z - a * e * sin2);
  const S dphi = a / delta * p_r + l_z / sin2 - a * e;
  p[0] = dt / sig;
  p[1] = y[4] / sig;
  p[2] = y[5] / sig;
  p[3] = dphi / sig;
}

// The Kerr-Schild Cartesian embedding of a BL position (_bl_embed3).
template <typename S>
__device__ __forceinline__ void bl_embed3(S a, const S* y, S* out) {
  const S sp = sin_(y[3]), cp = cos_(y[3]);
  const S st = sin_(y[2]), ct = cos_(y[2]);
  out[0] = (y[1] * cp - a * sp) * st;
  out[1] = (y[1] * sp + a * cp) * st;
  out[2] = y[1] * ct;
}

// Step-rule constants of the march (host floats rounded to T).
template <typename T>
struct MinoRule {
  T h0, h_min_frac, r_ref;
};

// mino_rhs with sin θ and cos θ of y from one sincos.
template <typename S>
__device__ __forceinline__ void mino_rhs(S r_s, S a, S e, S l_z, const MinoConsts<S>& C, const S* y,
                                         S* out) {
  S st, ct;
  sincos_(y[2], st, ct);
  mino_rhs(r_s, a, e, l_z, C, y, st, ct, out);
}

// One Mino-time RK4 increment y_new − y from state y, with
// h = h0/|E| / (1 + (r/r_ref)²) · clip((r − r₊)/r_ref, h_min_frac, 1)
// (_bl_step_size, _bl_rk4_delta). No far-field lever. C: the lane's
// mino_consts; st0, ct0: sin θ and cos θ of y, which the march carries
// from the step before (they are the values stage 1 would compute).
template <typename S, typename T>
__device__ __forceinline__ void mino_rk4_delta(const MinoRule<T>& R, S radius, S a, S r_plus, S e,
                                          S l_z, const MinoConsts<S>& C, S inv_e, const S* y, S st0,
                                          S ct0, S* delta) {
  const S r_here = y[1];
  const S u = r_here / S(R.r_ref);
  const S gap = clip((r_here - r_plus) / S(R.r_ref), S(R.h_min_frac), S(1));
  const S h = S(R.h0) * inv_e / (S(1) + u * u) * gap;
  const S half_h = S(0.5) * h;
  S k[6], acc[6], tmp[8];
  tmp[6] = y[6];
  tmp[7] = y[7];
  mino_rhs(radius, a, e, l_z, C, y, st0, ct0, k);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    acc[i] = k[i];
    tmp[i] = y[i] + half_h * k[i];
  }
  mino_rhs(radius, a, e, l_z, C, tmp, k);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    acc[i] = acc[i] + S(2) * k[i];
    tmp[i] = y[i] + half_h * k[i];
  }
  mino_rhs(radius, a, e, l_z, C, tmp, k);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    acc[i] = acc[i] + S(2) * k[i];
    tmp[i] = y[i] + h * k[i];
  }
  mino_rhs(radius, a, e, l_z, C, tmp, k);
  const S h6 = h / S(6);
#pragma unroll
  for (int i = 0; i < 6; ++i) delta[i] = h6 * (acc[i] + k[i]);
  delta[6] = h6 * S(0);
  delta[7] = h6 * S(0);
}

// mino_rk4_delta with the lane's terms and stage 1's sin θ and cos θ
// computed here.
template <typename S, typename T>
__device__ __forceinline__ void mino_rk4_delta(const MinoRule<T>& R, S radius, S a, S r_plus, S e,
                                          S l_z, S q, S inv_e, const S* y, S* delta) {
  S st, ct;
  sincos_(y[2], st, ct);
  mino_rk4_delta(R, radius, a, r_plus, e, l_z, mino_consts(a, e, l_z, q), inv_e, y, st, ct, delta);
}

// 1/max(|E|, 1e-12), the march's per-lane step scale.
template <typename S>
__device__ __forceinline__ S inv_energy(S e) {
  return S(1) / nmax(abs_(e), S(1e-12));
}

// The state is usable when components 0..5 are finite.
template <typename T>
__device__ __forceinline__ bool state_finite(const T* y) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) ok = ok && is_finite(y[i]);
  return ok;
}

}  // namespace bl
