// Device code shared by the volumetric raymarch (vol_raymarch.cu: K5, and
// K6, its raw-output form with the medium read at run time) and its
// backward (vol_adjoint.cu, K7): the parameter struct, the hash-Perlin
// noise, the optics of one sample and the march bounds.
//
// The sample optics are templated on T, the march type (float or double),
// and on S, the type of the sample position: T in the marches, ks::Dual<T>
// (kerr_ks_common.cuh: a value and one forward-mode tangent) in K7, which
// takes the derivatives along px, py and pz from three dual evaluations.
// The value part of a Dual computes exactly the arithmetic of T, so K7's
// replay of the march sees K6's samples bit for bit. Through the noise the
// lattice index (floor) and the hash act on the value and carry no
// tangent. Every kernel is built with -fmad=false (ops/cuda_build.py).
//
// The plain torch versions of these functions are in
// ops/volumetric_march.py (_march_bounds, _density, _killing_coefficients,
// _temperature, _texture_color, _sample_optics, _next_k), which set the
// order of every operation here.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "kerr_ks_common.cuh"

// The parameters as the host sends them (volumetric_march._HostParams,
// field for field), all in double; the array sizes are kTempCoeffs,
// kBBCoeffs and kMaxOctaves. Outside the namespace, since the C entry
// points take it.
struct HostParams {
  double inner, outer, thickness, dm, br, sca, noise_off, d_s, sigma;
  double ns0, ns1, ns2, h_cut, outer2, hole_q, d_budget, width, r_floor;
  double r_s, a2, four_a2, sqrt_m, a_sqrt_m, neg_a_rs, a2_rs;
  double temp_lo, temp_hi, temp_sum, temp_width;
  double beaming, tex_lo, tex_hi, tex_split, sum_lo, w_lo, sum_hi, w_hi;
  double chk_w, chk_h;
  double axis[3], e1[3], e2[3];
  double c1[4], c2[4];
  double temp_c[33];
  double bb_lo[3][17], bb_hi[3][17];
  double amp[16];
  int max_steps, octaves, checker;
  uint32_t key;
};

namespace vol {

using ks::Dual;
using ks::nmax;
using ks::nmin;
using ks::sqrt_;
using ks::value;

constexpr int kThreads = 128;
constexpr int kMaxOctaves = 16;
constexpr int kTempCoeffs = 33;  // TEMP_DEG + 1
constexpr int kBBCoeffs = 17;    // max(BB_DEG_LO, BB_DEG_HI) + 1, zero-padded
constexpr int kNMed = 5;         // dm, off, sa, ss, br (volumetric_march.MED_NAMES)
constexpr double kSaturationEps = 1e-7;
constexpr double kAlphaWtMin = 1e-18;
constexpr double kVerticalCutoff = 1e-3;
constexpr double kLn10 = 2.302585092994046;

// The same, rounded to the march type once.
template <typename T>
struct Params {
  T inner, outer, thickness, dm, br, sca, noise_off, d_s, sigma;
  T ns0, ns1, ns2, h_cut, outer2, hole_q, d_budget, width, r_floor;
  T r_s, a2, four_a2, sqrt_m, a_sqrt_m, neg_a_rs, a2_rs;
  T temp_lo, temp_hi, temp_sum, temp_width;
  T beaming, tex_lo, tex_hi, tex_split, sum_lo, w_lo, sum_hi, w_hi;
  T chk_w, chk_h;
  T axis[3], e1[3], e2[3];
  T c1[4], c2[4];
  T temp_c[kTempCoeffs];
  T bb_lo[3][kBBCoeffs], bb_hi[3][kBBCoeffs];
  T amp[kMaxOctaves];
  int max_steps, octaves, checker, has_beaming;
  uint32_t key;
};

static_assert(sizeof(HostParams::temp_c) == kTempCoeffs * sizeof(double), "temp_c size");
static_assert(sizeof(HostParams::bb_lo) == 3 * kBBCoeffs * sizeof(double), "bb size");
static_assert(sizeof(HostParams::amp) == kMaxOctaves * sizeof(double), "amp size");

// HostParams rounded to T (on the host, before a launch).
template <typename T>
inline Params<T> to_params(const HostParams* hp) {
  Params<T> P;
  // The leading scalar fields, inner .. chk_h, in declaration order.
  constexpr int kScalars = 39;
  static_assert(offsetof(HostParams, axis) == kScalars * sizeof(double), "HostParams layout");
  static_assert(offsetof(Params<T>, axis) == kScalars * sizeof(T), "Params layout");
  const double* scal_in = &hp->inner;
  T* scal_out = &P.inner;
  for (int i = 0; i < kScalars; ++i) scal_out[i] = T(scal_in[i]);
  for (int i = 0; i < 3; ++i) {
    P.axis[i] = T(hp->axis[i]);
    P.e1[i] = T(hp->e1[i]);
    P.e2[i] = T(hp->e2[i]);
  }
  for (int i = 0; i < 4; ++i) {
    P.c1[i] = T(hp->c1[i]);
    P.c2[i] = T(hp->c2[i]);
  }
  for (int i = 0; i < kTempCoeffs; ++i) P.temp_c[i] = T(hp->temp_c[i]);
  for (int c = 0; c < 3; ++c) {
    for (int i = 0; i < kBBCoeffs; ++i) {
      P.bb_lo[c][i] = T(hp->bb_lo[c][i]);
      P.bb_hi[c][i] = T(hp->bb_hi[c][i]);
    }
  }
  for (int i = 0; i < kMaxOctaves; ++i) P.amp[i] = T(hp->amp[i]);
  P.max_steps = hp->max_steps;
  P.octaves = hp->octaves;
  P.checker = hp->checker;
  P.has_beaming = hp->beaming != 0.0;
  P.key = hp->key;
  return P;
}

// ---------------------------------------------------------------------------
// Math on T and on Dual<T>
// ---------------------------------------------------------------------------

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }
__device__ __forceinline__ float floor_(float x) { return floorf(x); }
__device__ __forceinline__ double floor_(double x) { return floor(x); }
__device__ __forceinline__ float ceil_(float x) { return ceilf(x); }
__device__ __forceinline__ double ceil_(double x) { return ceil(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ Dual<T> exp_(Dual<T> x) {
  const T e = exp_(x.v);
  return Dual<T>(e, e * x.d);
}
template <typename T>
__device__ __forceinline__ Dual<T> log_(Dual<T> x) {
  return Dual<T>(log_(x.v), x.d / x.v);
}
// d|x| = sign(x)·dx, 0 at 0 (the derivative torch and JAX take).
template <typename T>
__device__ __forceinline__ Dual<T> abs_(Dual<T> x) {
  return Dual<T>(abs_(x.v), x.v > T(0) ? x.d : (x.v < T(0) ? -x.d : T(0)));
}

// A Dual with a constant of its value type: the constant has no tangent,
// and the value part rounds exactly as the T expression does.
template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> x, T y) { return Dual<T>(x.v + y, x.d); }
template <typename T>
__device__ __forceinline__ Dual<T> operator+(T x, Dual<T> y) { return Dual<T>(x + y.v, y.d); }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> x, T y) { return Dual<T>(x.v - y, x.d); }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(T x, Dual<T> y) { return Dual<T>(x - y.v, -y.d); }
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> x, T y) { return Dual<T>(x.v * y, x.d * y); }
template <typename T>
__device__ __forceinline__ Dual<T> operator*(T x, Dual<T> y) { return Dual<T>(x * y.v, x * y.d); }
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> x, T y) { return Dual<T>(x.v / y, x.d / y); }
template <typename T>
__device__ __forceinline__ Dual<T> operator/(T x, Dual<T> y) {
  const T q = x / y.v;
  return Dual<T>(q, (T(0) - q * y.d) / y.v);
}
template <typename T>
__device__ __forceinline__ Dual<T> nmax(Dual<T> x, T y) { return nmax(x, Dual<T>(y)); }
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) { return nmin(nmax(x, lo), hi); }
template <typename T>
__device__ __forceinline__ Dual<T> clip(Dual<T> x, T lo, T hi) {
  return nmin(nmax(x, Dual<T>(lo)), Dual<T>(hi));
}

// ---------------------------------------------------------------------------
// Hash-Perlin noise (ops/noise.py)
// ---------------------------------------------------------------------------

constexpr uint32_t kAX = 0x8DA6B343u;
constexpr uint32_t kAY = 0xD8163841u;
constexpr uint32_t kAZ = 0xCB1AB31Fu;

__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h = h ^ (h >> 16);
  h = h * 0x7FEB352Du;
  h = h ^ (h >> 15);
  h = h * 0x846CA68Bu;
  return h ^ (h >> 16);
}

template <typename S>
__device__ __forceinline__ S grad(uint32_t hash, S x, S y, S z) {
  const uint32_t h = hash & 15u;
  const S u = h < 8u ? x : y;
  const S v = h < 4u ? y : ((h == 12u || h == 14u) ? x : z);
  return ((h & 1u) == 0u ? u : -u) + ((h & 2u) == 0u ? v : -v);
}

template <typename T, typename S>
__device__ __forceinline__ S fade(S t) {
  return t * t * t * (t * (t * T(6) - T(15)) + T(10));
}

template <typename T, typename S>
__device__ __forceinline__ S perlin3(uint32_t key, S x, S y, S z) {
  const T xi0 = floor_(value(x)), yi0 = floor_(value(y)), zi0 = floor_(value(z));
  const S xf = x - xi0, yf = y - yi0, zf = z - zi0;
  // The int32 lattice index, then its two's-complement uint32 value.
  const uint32_t xi = (uint32_t)(int32_t)xi0;
  const uint32_t yi = (uint32_t)(int32_t)yi0;
  const uint32_t zi = (uint32_t)(int32_t)zi0;
  const S u = fade<T>(xf), v = fade<T>(yf), w = fade<T>(zf);

  // Corner hashes: (i+1)·A = i·A + A in wrapping uint32; the key is folded
  // into x after the add.
  const uint32_t hx = xi * kAX;
  const uint32_t hx1 = (hx + kAX) ^ key;
  const uint32_t hx0 = hx ^ key;
  const uint32_t hy0 = yi * kAY;
  const uint32_t hy1 = hy0 + kAY;
  const uint32_t hz0 = zi * kAZ;
  const uint32_t hz1 = hz0 + kAZ;
  const uint32_t h00 = hx0 ^ hy0, h10 = hx1 ^ hy0, h01 = hx0 ^ hy1, h11 = hx1 ^ hy1;

  const S xm = xf - T(1), ym = yf - T(1), zm = zf - T(1);
  const S x000 = grad(mix(h00 ^ hz0), xf, yf, zf);
  const S x100 = grad(mix(h10 ^ hz0), xm, yf, zf);
  const S x010 = grad(mix(h01 ^ hz0), xf, ym, zf);
  const S x110 = grad(mix(h11 ^ hz0), xm, ym, zf);
  const S x001 = grad(mix(h00 ^ hz1), xf, yf, zm);
  const S x101 = grad(mix(h10 ^ hz1), xm, yf, zm);
  const S x011 = grad(mix(h01 ^ hz1), xf, ym, zm);
  const S x111 = grad(mix(h11 ^ hz1), xm, ym, zm);

  const S y00 = x000 + u * (x100 - x000);
  const S y10 = x010 + u * (x110 - x010);
  const S y01 = x001 + u * (x101 - x001);
  const S y11 = x011 + u * (x111 - x011);
  const S z0 = y00 + v * (y10 - y00);
  const S z1 = y01 + v * (y11 - y01);
  return z0 + w * (z1 - z0);
}

// ---------------------------------------------------------------------------
// One sample (volumetric_march._sample_optics)
// ---------------------------------------------------------------------------

// The medium parameters the optics read (the march reads σ and σ_s too).
template <typename T>
struct Medium {
  T dm, off, br;
};

template <typename S>
struct Optics {
  S density, ex, ey, ez, lalpha;
  bool emit_ok;
  // What K7's closed-form directions read (the marches drop them):
  // density = inside ? (max(n_off, 0)·dm)·radial_base·vertical·boundary : 0,
  // e = intensity·l with intensity = tr⁴, tr = temperature/br, and l the
  // texture color at (temperature, redshift); redshift = obs_e/energy with
  // energy = u_t·p_t + u_phi·p_phi when emit_ok.
  bool inside;
  S n_off, radial_base, vertical, boundary;
  S temp, redshift, u_t, u_phi, energy, u_uv, v_uv, lx, ly, lz, intensity;
};

// Clenshaw over the temperature fit.
template <typename T, typename S>
__device__ __forceinline__ S temperature(const Params<T>& P, S r_dist) {
  const S r = clip(r_dist, P.temp_lo, P.temp_hi);
  const S t = (T(2) * r - P.temp_sum) / P.temp_width;
  const S t2 = T(2) * t;
  S b1 = S(T(0)), b2 = S(T(0));
#pragma unroll
  for (int j = kTempCoeffs - 1; j >= 1; --j) {
    const S b = t2 * b1 - b2 + P.temp_c[j];
    b2 = b1;
    b1 = b;
  }
  const S t4 = nmax(t * b1 - b2 + P.temp_c[0], T(0));
  return sqrt_(sqrt_(t4));
}

// Split-domain Clenshaw over the selected blackbody fit of channel C. The
// loops unroll, so every coefficient is a constant-offset parameter load.
template <int C, typename T, typename S>
__device__ __forceinline__ S bb_channel(const Params<T>& P, bool in_hi, S t, S t2) {
  S b1 = S(T(0)), b2 = S(T(0));
#pragma unroll
  for (int j = kBBCoeffs - 1; j >= 1; --j) {
    const S b = t2 * b1 - b2 + (in_hi ? P.bb_hi[C][j] : P.bb_lo[C][j]);
    b2 = b1;
    b1 = b;
  }
  return exp_((t * b1 - b2 + (in_hi ? P.bb_hi[C][0] : P.bb_lo[C][0])) * T(kLn10));
}

// The texture's XYZ and alpha at (u, v, temperature, redshift), beaming
// included (volumetric_march._texture_color).
template <typename T, typename S>
__device__ __forceinline__ void texture_color(const Params<T>& P, T u_uv, T v_uv, S temp, S redshift,
                                              S& lx, S& ly, S& lz, S& lalpha) {
  if (P.checker) {
    const int32_t ut = (int32_t)floor_(u_uv * P.chk_w);
    const int32_t vt = (int32_t)floor_(v_uv * P.chk_h);
    const bool even = ((ut + vt) & 1) == 0;
    lx = S(even ? P.c1[0] : P.c2[0]);
    ly = S(even ? P.c1[1] : P.c2[1]);
    lz = S(even ? P.c1[2] : P.c2[2]);
    lalpha = S(even ? P.c1[3] : P.c2[3]);
  } else {
    const S t_shift = nmax(temp * redshift, T(1e-10));
    const S l = log_(t_shift) / T(kLn10);
    const bool in_dom = value(l) >= P.tex_lo;
    const S lc = clip(l, P.tex_lo, P.tex_hi);
    const bool in_hi = value(lc) >= P.tex_split;
    const S t = in_hi ? (T(2) * lc - P.sum_hi) / P.w_hi : (T(2) * lc - P.sum_lo) / P.w_lo;
    const S t2 = T(2) * t;
    lx = in_dom ? bb_channel<0>(P, in_hi, t, t2) : S(T(0));
    ly = in_dom ? bb_channel<1>(P, in_hi, t, t2) : S(T(0));
    lz = in_dom ? bb_channel<2>(P, in_hi, t, t2) : S(T(0));
    lalpha = S(T(1));
  }
  if (P.has_beaming) {
    const S factor = exp_(P.beaming * log_(nmax(redshift, T(1e-30))));
    lx = lx * factor;
    ly = ly * factor;
    lz = lz * factor;
  }
}

template <typename T, typename S>
__device__ __forceinline__ Optics<S> sample_optics(const Params<T>& P, const Medium<T>& M, S px, S py, S pz,
                                                   T obs_e, T p_t, T p_phi) {
  Optics<S> o;
  // Density (volumetric_march._density).
  const S h = abs_(px * P.axis[0] + py * P.axis[1] + pz * P.axis[2]);
  const S cx = py * P.axis[2] - pz * P.axis[1];
  const S cy = pz * P.axis[0] - px * P.axis[2];
  const S cz = px * P.axis[1] - py * P.axis[0];
  const S r = sqrt_(nmax(cx * cx + cy * cy + cz * cz, T(1e-30)));
  const S q = h / P.thickness;
  const S vertical = exp_(-(q * q));
  o.inside = (value(r) > P.inner) && (value(r) < P.outer) && (value(vertical) >= T(kVerticalCutoff));
  const S safe_r = nmax(r, P.r_floor);
  const S t_ratio = P.inner / safe_r;
  const S radial_base = t_ratio * sqrt_(t_ratio);
  const S qo = P.outer - safe_r;
  const S qi = safe_r - P.inner;
  const S boundary = exp_(T(-1) / nmax(qo * qo, T(1e-4)) - T(1) / nmax(qi * qi, T(1e-4)));
  const S x_loc = px * P.e1[0] + py * P.e1[1] + pz * P.e1[2];
  const S y_loc = px * P.e2[0] + py * P.e2[1] + pz * P.e2[2];
  const S inv_r = T(1) / safe_r;
  const S cphi = x_loc * inv_r;
  const S sphi = y_loc * inv_r;
  const S nx = r * P.ns0, ny = cphi * P.ns1, nz = sphi * P.ns1;
  S n = S(T(0));
  T freq = T(4);
#pragma unroll
  for (int oc = 0; oc < kMaxOctaves; ++oc) {
    if (oc < P.octaves) {
      n = n + P.amp[oc] * perlin3<T>(P.key, nx * freq, ny * freq, nz * freq);
      freq = freq * T(2);
    }
  }
  n = n + T(0.5) * perlin3<T>(P.key, r * T(0.5), h * P.ns2, cphi);
  o.n_off = n + M.off;
  n = nmax(o.n_off, T(0)) * M.dm;
  o.radial_base = radial_base;
  o.vertical = vertical;
  o.boundary = boundary;

  o.density = o.inside ? n * radial_base * vertical * boundary : S(T(0));
  const bool emitting = value(o.density) > T(0);

  // Killing coefficients at the sample's BL radius.
  const S rho_sq = px * px + py * py + pz * pz;
  const S dd = rho_sq - P.a2;
  const S r_bl = sqrt_(nmax(T(0.5) * (dd + sqrt_(dd * dd + P.four_a2 * pz * pz)), T(1e-30)));
  const S omega = P.sqrt_m / (r_bl * sqrt_(r_bl) + P.a_sqrt_m);
  const S sigma = r_bl * r_bl;
  const S g_tt = -(T(1) - P.r_s * r_bl / sigma);
  const S g_tphi = P.neg_a_rs * r_bl / sigma;
  const S g_phiphi = r_bl * r_bl + P.a2 + P.a2_rs * r_bl / sigma;
  const S ut_pre = g_tt + T(2) * omega * g_tphi + omega * omega * g_phiphi;
  const bool orbit_ok = value(ut_pre) < T(0);
  o.u_t = orbit_ok ? T(1) / sqrt_(-ut_pre) : S(T(0));
  o.u_phi = omega * o.u_t;
  o.energy = o.u_t * p_t + o.u_phi * p_phi;
  o.emit_ok = emitting && orbit_ok && (abs_(value(o.energy)) > T(0));
  o.redshift = o.emit_ok ? obs_e / o.energy : S(T(1));

  o.temp = temperature(P, r);
  const S r_norm = (r - P.inner) / P.width;
  o.u_uv = T(0.5) + T(0.5) * r_norm * cphi;
  o.v_uv = T(0.5) + T(0.5) * r_norm * sphi;
  texture_color(P, value(o.u_uv), value(o.v_uv), o.temp, o.redshift, o.lx, o.ly, o.lz, o.lalpha);
  const S tr = o.temp / M.br;
  const S tr2 = tr * tr;
  o.intensity = tr2 * tr2;
  o.ex = o.intensity * o.lx;
  o.ey = o.intensity * o.ly;
  o.ez = o.intensity * o.lz;
  return o;
}

// ---------------------------------------------------------------------------
// The march bounds and the sample grid (volumetric_march._march_bounds,
// _next_k)
// ---------------------------------------------------------------------------

template <typename T>
struct Bounds {
  T k0, d_hi, i_lo, i_hi, k_hole_exit;
  bool empty;
};

template <typename T>
__device__ __forceinline__ Bounds<T> march_bounds(const Params<T>& P, T rox, T roy, T roz, T rdx, T rdy, T rdz,
                                                  T exit_d, bool active) {
  const T d_s = P.d_s;
  const T big = T(3.4e38);
  const T h0 = rox * P.axis[0] + roy * P.axis[1] + roz * P.axis[2];
  const T dh = rdx * P.axis[0] + rdy * P.axis[1] + rdz * P.axis[2];
  const bool flat = abs_(dh) <= T(1e-12);
  const T safe_dh = flat ? T(1) : dh;
  const T ta = (-P.h_cut - h0) / safe_dh;
  const T tb = (P.h_cut - h0) / safe_dh;
  const bool in_band = abs_(h0) <= P.h_cut;
  const T h_lo = flat ? (in_band ? T(0) : big) : nmin(ta, tb);
  const T h_hi = flat ? (in_band ? big : -big) : nmax(ta, tb);
  const T qa = T(1) - dh * dh;
  const T qb = T(2) * (rox * rdx + roy * rdy + roz * rdz - h0 * dh);
  const T qc = rox * rox + roy * roy + roz * roz - h0 * h0 - P.outer2;
  const T qdisc = qb * qb - T(4) * qa * qc;
  const bool degen = qa <= T(1e-8);
  const T sq = sqrt_(nmax(qdisc, T(0)));
  const T safe_qa = degen ? T(1) : qa;
  const bool miss = !degen && (qdisc < T(0));
  const T r_lo = degen ? T(0) : (miss ? big : (-qb - sq) / (T(2) * safe_qa));
  const T r_hi = degen ? big : (miss ? -big : (-qb + sq) / (T(2) * safe_qa));
  const T d_lo = nmax(nmax(h_lo, r_lo), T(0));
  Bounds<T> b;
  b.d_hi = nmin(nmin(h_hi, r_hi) + d_s, nmin(exit_d, P.d_budget));
  b.k0 = nmax(floor_(d_lo / d_s) - T(1), T(0));
  b.empty = (b.k0 * d_s >= b.d_hi) || !active;
  const T qc_i = qc + P.hole_q;
  const T qd_i = qb * qb - T(4) * qa * qc_i;
  const bool enters = !degen && (qd_i > T(0));
  const T sq_i = sqrt_(nmax(qd_i, T(0)));
  b.i_lo = enters ? (-qb - sq_i) / (T(2) * safe_qa) + d_s : big;
  b.i_hi = enters ? (-qb + sq_i) / (T(2) * safe_qa) - d_s : -big;
  b.k_hole_exit = ceil_(b.i_hi / d_s);
  return b;
}

// The sample after k: a next sample inside the hole interval skips to its
// exit.
template <typename T>
__device__ __forceinline__ T next_k(const Bounds<T>& b, T k, T d_s) {
  T k_next = k + T(1);
  const T d_next = k_next * d_s;
  if (d_next >= b.i_lo && d_next < b.i_hi) k_next = nmax(b.k_hole_exit, k_next);
  return k_next;
}

}  // namespace vol
