// Device code shared by the volumetric raymarch (vol_raymarch.cu: K5, and
// K6, its raw-output form with the medium read at run time) and its
// backward (vol_adjoint.cu, K7): the parameter struct, the hash-Perlin
// noise and its closed-form gradient, the optics of one sample and the
// march bounds.
//
// The sample optics are templated on T, the march type (float or double),
// and on S, the type of the sample position: T in the marches, Jet<T, 3>
// (a value and its three partials along px, py, pz) in K7, which takes the
// position derivatives of the sample from the same single evaluation. The
// value part of a Jet computes exactly the arithmetic of T, so K7's replay
// of the march sees K6's samples bit for bit. Through the noise a jet
// takes the closed-form gradient of perlin3 (perlin3_grad: the value in
// perlin3's op order, the partials from the fade's derivative and the
// corners' gradient vectors), summed over the octaves in noise coordinates
// and chained to the position once; the temperature (a function of r) and
// the texture (of the temperature and the redshift) are evaluated in jets
// of their own one and two inputs and chained. The lattice index (floor)
// and the hash act on the value and carry no partial. Every kernel is
// built with -fmad=false (ops/cuda_build.py).
//
// The plain torch versions of these functions are in
// ops/volumetric_march.py (_march_bounds, _density, _killing_coefficients,
// _temperature, _texture_color, _sample_optics, _next_k), which set the
// order of every operation here; ops/noise.py holds perlin3_grad's plain
// twin (perlin3_lanes_grad).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

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
// Math on T, and jets: a value and N forward-mode partials
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
__device__ __forceinline__ T clip(T x, T lo, T hi) { return nmin(nmax(x, lo), hi); }

// v + Σ d_i·ε_i with ε_i ε_j = 0. Every operation computes its value part
// exactly as the T expression, and its partials by the chain rule.
template <typename T, int N>
struct Jet {
  T v;
  T d[N];
  __device__ __forceinline__ Jet() : v(T(0)) {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = T(0);
  }
  __device__ __forceinline__ Jet(T v_) : v(v_) {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = T(0);
  }
  // The input `i` of the jet's N: value v, partial 1 along itself.
  __device__ __forceinline__ static Jet var(T v_, int i) {
    Jet x(v_);
    x.d[i] = T(1);
    return x;
  }
};

template <typename S>
struct IsJet : std::false_type {};
template <typename T, int N>
struct IsJet<Jet<T, N>> : std::true_type {};

// The value type of S (T itself, or a jet's T).
template <typename S>
struct ValueOf {
  using type = S;
};
template <typename T, int N>
struct ValueOf<Jet<T, N>> {
  using type = T;
};

template <typename T, int N>
__device__ __forceinline__ T value(const Jet<T, N>& x) { return x.v; }

// x with every partial scaled by f: the jet of g(x) from g's value gv and
// its derivative f.
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> scaled(T gv, T f, const Jet<T, N>& x) {
  Jet<T, N> r(gv);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = f * x.d[i];
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator+(const Jet<T, N>& x, const Jet<T, N>& y) {
  Jet<T, N> r(x.v + y.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = x.d[i] + y.d[i];
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator-(const Jet<T, N>& x, const Jet<T, N>& y) {
  Jet<T, N> r(x.v - y.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = x.d[i] - y.d[i];
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator-(const Jet<T, N>& x) {
  Jet<T, N> r(-x.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -x.d[i];
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator*(const Jet<T, N>& x, const Jet<T, N>& y) {
  Jet<T, N> r(x.v * y.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = x.v * y.d[i] + x.d[i] * y.v;
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator/(const Jet<T, N>& x, const Jet<T, N>& y) {
  const T q = x.v / y.v;
  Jet<T, N> r(q);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = (x.d[i] - q * y.d[i]) / y.v;
  return r;
}

// A jet with a constant of its value type: the constant has no partials,
// and the value part rounds exactly as the T expression does.
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator+(const Jet<T, N>& x, T y) { return scaled(x.v + y, T(1), x); }
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator+(T x, const Jet<T, N>& y) { return scaled(x + y.v, T(1), y); }
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator-(const Jet<T, N>& x, T y) { return scaled(x.v - y, T(1), x); }
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator-(T x, const Jet<T, N>& y) {
  Jet<T, N> r(x - y.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -y.d[i];
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator*(const Jet<T, N>& x, T y) { return scaled(x.v * y, y, x); }
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator*(T x, const Jet<T, N>& y) { return scaled(x * y.v, x, y); }
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator/(const Jet<T, N>& x, T y) {
  Jet<T, N> r(x.v / y);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = x.d[i] / y;
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator/(T x, const Jet<T, N>& y) {
  const T q = x / y.v;
  Jet<T, N> r(q);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = (T(0) - q * y.d[i]) / y.v;
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Jet<T, N> exp_(const Jet<T, N>& x) {
  const T e = exp_(x.v);
  return scaled(e, e, x);
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> log_(const Jet<T, N>& x) {
  Jet<T, N> r(log_(x.v));
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = x.d[i] / x.v;
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> sqrt_(const Jet<T, N>& x) {
  const T s = sqrt_(x.v);
  const T two_s = T(2) * s;
  Jet<T, N> r(s);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = x.d[i] / two_s;
  return r;
}
// d|x| = sign(x)·dx, 0 at 0 (the derivative torch and JAX take).
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> abs_(const Jet<T, N>& x) {
  return scaled(abs_(x.v), x.v > T(0) ? T(1) : (x.v < T(0) ? T(-1) : T(0)), x);
}
// NaN-propagating max / min as ks::nmax: a tie splits the partials half and
// half (ties are exact equalities and never met on a real lane).
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> nmax(const Jet<T, N>& x, const Jet<T, N>& y) {
  if (x.v != x.v || x.v > y.v) return x;
  if (y.v != y.v || y.v > x.v) return y;
  Jet<T, N> r(x.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = T(0.5) * (x.d[i] + y.d[i]);
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> nmin(const Jet<T, N>& x, const Jet<T, N>& y) {
  if (x.v != x.v || x.v < y.v) return x;
  if (y.v != y.v || y.v < x.v) return y;
  Jet<T, N> r(x.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = T(0.5) * (x.d[i] + y.d[i]);
  return r;
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> nmax(const Jet<T, N>& x, T y) { return nmax(x, Jet<T, N>(y)); }
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> clip(const Jet<T, N>& x, T lo, T hi) {
  return nmin(nmax(x, Jet<T, N>(lo)), Jet<T, N>(hi));
}

// The jet of f(a, b) along a's and b's inputs, from f's jet over (a, b).
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> chain(const Jet<T, 2>& f, const Jet<T, N>& a, const Jet<T, N>& b) {
  Jet<T, N> r(f.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = f.d[0] * a.d[i] + f.d[1] * b.d[i];
  return r;
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

template <typename T>
__device__ __forceinline__ T grad(uint32_t hash, T x, T y, T z) {
  const uint32_t h = hash & 15u;
  const T u = h < 8u ? x : y;
  const T v = h < 4u ? y : ((h == 12u || h == 14u) ? x : z);
  return ((h & 1u) == 0u ? u : -u) + ((h & 2u) == 0u ? v : -v);
}

// grad's gradient vector: its partials along x, y and z, each 0 or ±1.
template <typename T>
__device__ __forceinline__ void grad_vector(uint32_t hash, T& gx, T& gy, T& gz) {
  const uint32_t h = hash & 15u;
  const bool u_is_x = h < 8u;
  const bool v_is_y = h < 4u;
  const bool v_is_x = !v_is_y && (h == 12u || h == 14u);
  const T su = (h & 1u) == 0u ? T(1) : T(-1);
  const T sv = (h & 2u) == 0u ? T(1) : T(-1);
  gx = (u_is_x ? su : T(0)) + (v_is_x ? sv : T(0));
  gy = (u_is_x ? T(0) : su) + (v_is_y ? sv : T(0));
  gz = (v_is_y || v_is_x) ? T(0) : sv;
}

template <typename T>
__device__ __forceinline__ T fade(T t) {
  return t * t * t * (t * (t * T(6) - T(15)) + T(10));
}

// fade'(t) = 30·t²·(t − 1)².
template <typename T>
__device__ __forceinline__ T fade_slope(T t) {
  const T tm = t - T(1);
  return T(30) * (t * t) * (tm * tm);
}

template <typename T>
__device__ __forceinline__ T lerp(T t, T a, T b) {
  return a + t * (b - a);
}

// perlin3 at (x, y, z) and its gradient (gx, gy, gz). The value is
// perlin3's, op for op. The gradient of the trilinear blend of the corner
// terms x_c = g_c·(p − c) is the same blend of the corners' gradient vectors
// g_c plus, along each axis, the fade's slope times the blend of the corner
// differences along that axis.
template <typename T>
__device__ __forceinline__ T perlin3_grad(uint32_t key, T x, T y, T z, T& gx, T& gy, T& gz) {
  const T xi0 = floor_(x), yi0 = floor_(y), zi0 = floor_(z);
  const T xf = x - xi0, yf = y - yi0, zf = z - zi0;
  // The int32 lattice index, then its two's-complement uint32 value.
  const uint32_t xi = (uint32_t)(int32_t)xi0;
  const uint32_t yi = (uint32_t)(int32_t)yi0;
  const uint32_t zi = (uint32_t)(int32_t)zi0;
  const T u = fade(xf), v = fade(yf), w = fade(zf);

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
  const uint32_t c000 = mix(h00 ^ hz0), c100 = mix(h10 ^ hz0), c010 = mix(h01 ^ hz0), c110 = mix(h11 ^ hz0);
  const uint32_t c001 = mix(h00 ^ hz1), c101 = mix(h10 ^ hz1), c011 = mix(h01 ^ hz1), c111 = mix(h11 ^ hz1);

  const T xm = xf - T(1), ym = yf - T(1), zm = zf - T(1);
  const T x000 = grad(c000, xf, yf, zf);
  const T x100 = grad(c100, xm, yf, zf);
  const T x010 = grad(c010, xf, ym, zf);
  const T x110 = grad(c110, xm, ym, zf);
  const T x001 = grad(c001, xf, yf, zm);
  const T x101 = grad(c101, xm, yf, zm);
  const T x011 = grad(c011, xf, ym, zm);
  const T x111 = grad(c111, xm, ym, zm);

  const T y00 = x000 + u * (x100 - x000);
  const T y10 = x010 + u * (x110 - x010);
  const T y01 = x001 + u * (x101 - x001);
  const T y11 = x011 + u * (x111 - x011);
  const T z0 = y00 + v * (y10 - y00);
  const T z1 = y01 + v * (y11 - y01);
  const T noise = z0 + w * (z1 - z0);

  T g000[3], g100[3], g010[3], g110[3], g001[3], g101[3], g011[3], g111[3];
  grad_vector(c000, g000[0], g000[1], g000[2]);
  grad_vector(c100, g100[0], g100[1], g100[2]);
  grad_vector(c010, g010[0], g010[1], g010[2]);
  grad_vector(c110, g110[0], g110[1], g110[2]);
  grad_vector(c001, g001[0], g001[1], g001[2]);
  grad_vector(c101, g101[0], g101[1], g101[2]);
  grad_vector(c011, g011[0], g011[1], g011[2]);
  grad_vector(c111, g111[0], g111[1], g111[2]);
  T blend[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    blend[a] = lerp(w, lerp(v, lerp(u, g000[a], g100[a]), lerp(u, g010[a], g110[a])),
                    lerp(v, lerp(u, g001[a], g101[a]), lerp(u, g011[a], g111[a])));
  }
  gx = blend[0] + fade_slope(xf) * lerp(w, lerp(v, x100 - x000, x110 - x010), lerp(v, x101 - x001, x111 - x011));
  gy = blend[1] + fade_slope(yf) * lerp(w, y10 - y00, y11 - y01);
  gz = blend[2] + fade_slope(zf) * (z1 - z0);
  return noise;
}

template <typename T>
__device__ __forceinline__ T perlin3(uint32_t key, T x, T y, T z) {
  T gx, gy, gz;  // dead in a caller that reads only the value
  return perlin3_grad(key, x, y, z, gx, gy, gz);
}

// The density's noise at the sample: the fBm octaves at (nx, ny, nz) and
// the vertical warp term at (r/2, h·ns2, cos φ), in sample_optics's order.
template <typename T>
__device__ __forceinline__ T density_noise(const Params<T>& P, T nx, T ny, T nz, T r, T h, T cphi) {
  T n = T(0);
  T freq = T(4);
#pragma unroll
  for (int oc = 0; oc < kMaxOctaves; ++oc) {
    if (oc < P.octaves) {
      n = n + P.amp[oc] * perlin3(P.key, nx * freq, ny * freq, nz * freq);
      freq = freq * T(2);
    }
  }
  return n + T(0.5) * perlin3(P.key, r * T(0.5), h * P.ns2, cphi);
}

// The same for jets: the value in the same op order; the gradient summed
// over the octaves in noise coordinates (∂/∂(nx, ny, nz), each octave's
// weighted by amp·freq) and the warp term's ∂/∂(r/2, h·ns2, cos φ), then
// chained to the jet's inputs once.
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> density_noise(const Params<T>& P, const Jet<T, N>& nx, const Jet<T, N>& ny,
                                                   const Jet<T, N>& nz, const Jet<T, N>& r, const Jet<T, N>& h,
                                                   const Jet<T, N>& cphi) {
  T n = T(0), gx = T(0), gy = T(0), gz = T(0);
  T freq = T(4);
#pragma unroll
  for (int oc = 0; oc < kMaxOctaves; ++oc) {
    if (oc < P.octaves) {
      T ox, oy, oz;
      n = n + P.amp[oc] * perlin3_grad(P.key, nx.v * freq, ny.v * freq, nz.v * freq, ox, oy, oz);
      const T weight = P.amp[oc] * freq;
      gx = gx + weight * ox;
      gy = gy + weight * oy;
      gz = gz + weight * oz;
      freq = freq * T(2);
    }
  }
  T wx, wy, wz;
  Jet<T, N> out(n + T(0.5) * perlin3_grad(P.key, r.v * T(0.5), h.v * P.ns2, cphi.v, wx, wy, wz));
  const T wr = T(0.25) * wx, wh = T(0.5) * P.ns2 * wy, wc = T(0.5) * wz;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    out.d[i] = gx * nx.d[i] + gy * ny.d[i] + gz * nz.d[i] + wr * r.d[i] + wh * h.d[i] + wc * cphi.d[i];
  }
  return out;
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
  // For a jet S only: ∂(lx, ly, lz)/∂redshift at a fixed temperature.
  typename ValueOf<S>::type lx_z, ly_z, lz_z;
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
  S n = density_noise(P, nx, ny, nz, r, h, cphi);
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

  if constexpr (IsJet<S>::value) {
    // A function of r alone: its own one-input jet, chained.
    const Jet<T, 1> temp = temperature(P, Jet<T, 1>::var(r.v, 0));
    o.temp = scaled(temp.v, temp.d[0], r);
  } else {
    o.temp = temperature(P, r);
  }
  const S r_norm = (r - P.inner) / P.width;
  o.u_uv = T(0.5) + T(0.5) * r_norm * cphi;
  o.v_uv = T(0.5) + T(0.5) * r_norm * sphi;
  if constexpr (IsJet<S>::value) {
    // A function of (temperature, redshift): its own two-input jet, chained.
    using J2 = Jet<T, 2>;
    J2 lx, ly, lz, lalpha;
    texture_color(P, o.u_uv.v, o.v_uv.v, J2::var(o.temp.v, 0), J2::var(o.redshift.v, 1), lx, ly, lz, lalpha);
    o.lx = chain(lx, o.temp, o.redshift);
    o.ly = chain(ly, o.temp, o.redshift);
    o.lz = chain(lz, o.temp, o.redshift);
    o.lalpha = S(lalpha.v);
    o.lx_z = lx.d[1];
    o.ly_z = ly.d[1];
    o.lz_z = lz.d[1];
  } else {
    texture_color(P, o.u_uv, o.v_uv, o.temp, o.redshift, o.lx, o.ly, o.lz, o.lalpha);
  }
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
