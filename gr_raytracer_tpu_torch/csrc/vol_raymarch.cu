// Constant-step volumetric raymarch (hash-Perlin fBm density, Killing
// redshift, Chebyshev T⁴ and blackbody log-XYZ fits, Beer-Lambert, hole
// jump, saturation exit).
//
// Replaces the TPU kernel gr_raytracer_tpu/ops/volumetric_pallas.py
// raymarch (pallas_call body _march_kernel). Same arithmetic, sample grid
// and exits; the plain torch version of the same march is
// gr_raytracer_tpu_torch/ops/volumetric_march.py::raymarch_plain, whose
// functions (_march_bounds, _density, _killing_coefficients, _temperature,
// _texture_color, _sample_optics, _march_step) set the order of every
// operation here.
//
// What bounds it on the card: operations. A lane reads 11 values and writes
// 4 (and its sample count), while every sample costs nine Perlin
// evaluations of eight hashed corners each (about a thousand integer and a
// thousand float operations, with a few exp and log), for hundreds to
// ~16,000 samples. So, as the march kernels K1 and K3, one thread per lane
// keeps its inputs and carry in registers and marches until its own lane is
// done; a done lane of the TPU kernel is frozen, so this is its block loop.
// The render driver sorts the lanes by their clipped march length
// (volumetric_march.march_length), so the lanes of a warp end together.
//
// The TPU-only parts are dropped: the (8,128) tiles; the Chebyshev
// coefficients unrolled as static floats (they arrive here in the parameter
// struct, rounded once to the march type as torch rounds a Python scalar);
// the unroll, which is bit-equivalent to the rolled loop. The hash is
// native uint32 arithmetic (the plain version carries it in int64 with a
// mask). The per-lane loop keeps the JAX kernel's cap of max_steps
// iterations; since d_hi <= max_steps·d_s it never binds before the
// lane's own exit.
//
// Built with -fmad=false (ops/cuda_build.py): the kernel rounds every
// operation as the plain version's separate torch ops do.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// The parameters as the host sends them (volumetric_march._HostParams,
// field for field), all in double; the array sizes are kTempCoeffs,
// kBBCoeffs and kMaxOctaves. Outside the anonymous namespace, since the C
// entry points take it.
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

namespace {

constexpr int kThreads = 128;
constexpr int kMaxOctaves = 16;
constexpr int kTempCoeffs = 33;  // TEMP_DEG + 1
constexpr int kBBCoeffs = 17;    // max(BB_DEG_LO, BB_DEG_HI) + 1, zero-padded
constexpr double kSaturationEps = 1e-7;
constexpr double kAlphaWtMin = 1e-18;
constexpr double kVerticalCutoff = 1e-3;

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

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float floor_(float x) { return floorf(x); }
__device__ __forceinline__ double floor_(double x) { return floor(x); }
__device__ __forceinline__ float ceil_(float x) { return ceilf(x); }
__device__ __forceinline__ double ceil_(double x) { return ceil(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }

// NaN-propagating max / min / clip, the semantics of torch.maximum & co.
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

template <typename T>
__device__ __forceinline__ T fade(T t) {
  return t * t * t * (t * (t * T(6) - T(15)) + T(10));
}

template <typename T>
__device__ __forceinline__ T perlin3(uint32_t key, T x, T y, T z) {
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

  const T xm = xf - T(1), ym = yf - T(1), zm = zf - T(1);
  const T x000 = grad(mix(h00 ^ hz0), xf, yf, zf);
  const T x100 = grad(mix(h10 ^ hz0), xm, yf, zf);
  const T x010 = grad(mix(h01 ^ hz0), xf, ym, zf);
  const T x110 = grad(mix(h11 ^ hz0), xm, ym, zf);
  const T x001 = grad(mix(h00 ^ hz1), xf, yf, zm);
  const T x101 = grad(mix(h10 ^ hz1), xm, yf, zm);
  const T x011 = grad(mix(h01 ^ hz1), xf, ym, zm);
  const T x111 = grad(mix(h11 ^ hz1), xm, ym, zm);

  const T y00 = x000 + u * (x100 - x000);
  const T y10 = x010 + u * (x110 - x010);
  const T y01 = x001 + u * (x101 - x001);
  const T y11 = x011 + u * (x111 - x011);
  const T z0 = y00 + v * (y10 - y00);
  const T z1 = y01 + v * (y11 - y01);
  return z0 + w * (z1 - z0);
}

// ---------------------------------------------------------------------------
// One sample (volumetric_march._sample_optics)
// ---------------------------------------------------------------------------

template <typename T>
struct Optics {
  T density, ex, ey, ez, lalpha;
  bool emit_ok;
};

// Clenshaw over the temperature fit.
template <typename T>
__device__ __forceinline__ T temperature(const Params<T>& P, T r_dist) {
  const T r = clip(r_dist, P.temp_lo, P.temp_hi);
  const T t = (T(2) * r - P.temp_sum) / P.temp_width;
  const T t2 = T(2) * t;
  T b1 = T(0), b2 = T(0);
#pragma unroll
  for (int j = kTempCoeffs - 1; j >= 1; --j) {
    const T b = t2 * b1 - b2 + P.temp_c[j];
    b2 = b1;
    b1 = b;
  }
  const T t4 = nmax(t * b1 - b2 + P.temp_c[0], T(0));
  return sqrt_(sqrt_(t4));
}

// Split-domain Clenshaw over the selected blackbody fit of channel C. The
// loops unroll, so every coefficient is a constant-offset parameter load.
template <int C, typename T>
__device__ __forceinline__ T bb_channel(const Params<T>& P, bool in_hi, T t, T t2) {
  T b1 = T(0), b2 = T(0);
#pragma unroll
  for (int j = kBBCoeffs - 1; j >= 1; --j) {
    const T b = t2 * b1 - b2 + (in_hi ? P.bb_hi[C][j] : P.bb_lo[C][j]);
    b2 = b1;
    b1 = b;
  }
  return exp_((t * b1 - b2 + (in_hi ? P.bb_hi[C][0] : P.bb_lo[C][0])) * T(2.302585092994046));
}

template <typename T>
__device__ __forceinline__ Optics<T> sample_optics(const Params<T>& P, T px, T py, T pz, T obs_e,
                                                  T p_t, T p_phi) {
  // Density (volumetric_march._density).
  const T h = abs_(px * P.axis[0] + py * P.axis[1] + pz * P.axis[2]);
  const T cx = py * P.axis[2] - pz * P.axis[1];
  const T cy = pz * P.axis[0] - px * P.axis[2];
  const T cz = px * P.axis[1] - py * P.axis[0];
  const T r = sqrt_(nmax(cx * cx + cy * cy + cz * cz, T(1e-30)));
  const T q = h / P.thickness;
  const T vertical = exp_(-(q * q));
  const bool inside = (r > P.inner) && (r < P.outer) && (vertical >= T(kVerticalCutoff));
  const T safe_r = nmax(r, P.r_floor);
  const T t_ratio = P.inner / safe_r;
  const T radial_base = t_ratio * sqrt_(t_ratio);
  const T qo = P.outer - safe_r;
  const T qi = safe_r - P.inner;
  const T boundary = exp_(T(-1) / nmax(qo * qo, T(1e-4)) - T(1) / nmax(qi * qi, T(1e-4)));
  const T x_loc = px * P.e1[0] + py * P.e1[1] + pz * P.e1[2];
  const T y_loc = px * P.e2[0] + py * P.e2[1] + pz * P.e2[2];
  const T inv_r = T(1) / safe_r;
  const T cphi = x_loc * inv_r;
  const T sphi = y_loc * inv_r;
  const T nx = r * P.ns0, ny = cphi * P.ns1, nz = sphi * P.ns1;
  T n = T(0), freq = T(4);
#pragma unroll
  for (int o = 0; o < kMaxOctaves; ++o) {
    if (o < P.octaves) {
      n = n + P.amp[o] * perlin3(P.key, nx * freq, ny * freq, nz * freq);
      freq = freq * T(2);
    }
  }
  n = n + T(0.5) * perlin3(P.key, r * T(0.5), h * P.ns2, cphi);
  n = nmax(n + P.noise_off, T(0)) * P.dm;

  Optics<T> o;
  o.density = inside ? n * radial_base * vertical * boundary : T(0);
  const bool emitting = o.density > T(0);

  // Killing coefficients at the sample's BL radius.
  const T rho_sq = px * px + py * py + pz * pz;
  const T dd = rho_sq - P.a2;
  const T r_bl = sqrt_(nmax(T(0.5) * (dd + sqrt_(dd * dd + P.four_a2 * pz * pz)), T(1e-30)));
  const T omega = P.sqrt_m / (r_bl * sqrt_(r_bl) + P.a_sqrt_m);
  const T sigma = r_bl * r_bl;
  const T g_tt = -(T(1) - P.r_s * r_bl / sigma);
  const T g_tphi = P.neg_a_rs * r_bl / sigma;
  const T g_phiphi = r_bl * r_bl + P.a2 + P.a2_rs * r_bl / sigma;
  const T ut_pre = g_tt + T(2) * omega * g_tphi + omega * omega * g_phiphi;
  const bool orbit_ok = ut_pre < T(0);
  const T u_t = orbit_ok ? T(1) / sqrt_(-ut_pre) : T(0);
  const T u_phi = omega * u_t;
  const T emitter_energy = u_t * p_t + u_phi * p_phi;
  o.emit_ok = emitting && orbit_ok && (abs_(emitter_energy) > T(0));
  const T redshift = o.emit_ok ? obs_e / emitter_energy : T(1);

  const T temp = temperature(P, r);
  const T r_norm = (r - P.inner) / P.width;
  const T u_uv = T(0.5) + T(0.5) * r_norm * cphi;
  const T v_uv = T(0.5) + T(0.5) * r_norm * sphi;
  T lx, ly, lz;
  if (P.checker) {
    const int32_t ut = (int32_t)floor_(u_uv * P.chk_w);
    const int32_t vt = (int32_t)floor_(v_uv * P.chk_h);
    const bool even = ((ut + vt) & 1) == 0;
    lx = even ? P.c1[0] : P.c2[0];
    ly = even ? P.c1[1] : P.c2[1];
    lz = even ? P.c1[2] : P.c2[2];
    o.lalpha = even ? P.c1[3] : P.c2[3];
  } else {
    const T t_shift = nmax(temp * redshift, T(1e-10));
    const T l = log_(t_shift) / T(2.302585092994046);
    const bool in_dom = l >= P.tex_lo;
    const T lc = clip(l, P.tex_lo, P.tex_hi);
    const bool in_hi = lc >= P.tex_split;
    const T t = in_hi ? (T(2) * lc - P.sum_hi) / P.w_hi : (T(2) * lc - P.sum_lo) / P.w_lo;
    const T t2 = T(2) * t;
    lx = in_dom ? bb_channel<0>(P, in_hi, t, t2) : T(0);
    ly = in_dom ? bb_channel<1>(P, in_hi, t, t2) : T(0);
    lz = in_dom ? bb_channel<2>(P, in_hi, t, t2) : T(0);
    o.lalpha = T(1);
  }
  if (P.has_beaming) {
    const T factor = exp_(P.beaming * log_(nmax(redshift, T(1e-30))));
    lx = lx * factor;
    ly = ly * factor;
    lz = lz * factor;
  }
  const T tr = temp / P.br;
  const T tr2 = tr * tr;
  const T intensity = tr2 * tr2;
  o.ex = intensity * lx;
  o.ey = intensity * ly;
  o.ez = intensity * lz;
  return o;
}

// ---------------------------------------------------------------------------
// The march
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
raymarch_kernel(const __grid_constant__ Params<T> P, const T* __restrict__ ro,
                const T* __restrict__ rd, const T* __restrict__ obs_e_in, const T* __restrict__ p_t_in,
                const T* __restrict__ p_phi_in, const T* __restrict__ exit_d_in,
                const bool* __restrict__ active_in, int64_t n, T* __restrict__ out,
                int32_t* __restrict__ samples_out) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const T rox = ro[lane * 3], roy = ro[lane * 3 + 1], roz = ro[lane * 3 + 2];
  const T rdx = rd[lane * 3], rdy = rd[lane * 3 + 1], rdz = rd[lane * 3 + 2];
  const T obs_e = obs_e_in[lane], p_t = p_t_in[lane], p_phi = p_phi_in[lane];
  const T exit_d = exit_d_in[lane];
  const T d_s = P.d_s;

  // The march bounds (volumetric_march._march_bounds).
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
  const T d_hi = nmin(nmin(h_hi, r_hi) + d_s, nmin(exit_d, P.d_budget));
  T k = nmax(floor_(d_lo / d_s) - T(1), T(0));
  bool done = (k * d_s >= d_hi) || !active_in[lane];
  const T qc_i = qc + P.hole_q;
  const T qd_i = qb * qb - T(4) * qa * qc_i;
  const bool enters = !degen && (qd_i > T(0));
  const T sq_i = sqrt_(nmax(qd_i, T(0)));
  const T i_lo = enters ? (-qb - sq_i) / (T(2) * safe_qa) + d_s : big;
  const T i_hi = enters ? (-qb + sq_i) / (T(2) * safe_qa) - d_s : -big;
  const T k_hole_exit = ceil_(i_hi / d_s);

  // The carry (volumetric_march._march_step).
  T trans = T(1), acc_x = T(0), acc_y = T(0), acc_z = T(0), ws = T(0), wt = T(0);
  int samples = 0;
  for (int it = 0; it < P.max_steps && !done; ++it) {
    const T d_o = k * d_s;
    const T px = rox + rdx * d_o;
    const T py = roy + rdy * d_o;
    const T pz = roz + rdz * d_o;
    const Optics<T> o = sample_optics(P, px, py, pz, obs_e, p_t, p_phi);
    const T attenuation = exp_(-d_s * o.density * P.sigma);
    trans = trans * attenuation;
    const T weight = trans * attenuation * P.sca * o.density * d_s;
    const T wscale = weight * (o.emit_ok ? T(1) : T(0));
    acc_x = acc_x + wscale * o.ex;
    acc_y = acc_y + wscale * o.ey;
    acc_z = acc_z + wscale * o.ez;
    const T alpha_w = o.emit_ok ? o.density * d_s : T(0);
    ws = ws + clip(o.lalpha, T(0), T(1)) * alpha_w;
    wt = wt + alpha_w;
    // Hole jump: a next sample inside the hole interval skips to its exit.
    T k_next = k + T(1);
    const T d_next = k_next * d_s;
    if (d_next >= i_lo && d_next < i_hi) k_next = nmax(k_hole_exit, k_next);
    done = (k_next * d_s >= d_hi) || (trans < T(kSaturationEps));
    k = k_next;
    ++samples;
  }
  const bool ok = wt > T(kAlphaWtMin);
  const T texture_alpha = ok ? ws / wt : T(1);
  out[lane * 4] = acc_x;
  out[lane * 4 + 1] = acc_y;
  out[lane * 4 + 2] = acc_z;
  out[lane * 4 + 3] = (T(1) - trans) * texture_alpha;
  samples_out[lane] = samples;
}

static_assert(sizeof(HostParams::temp_c) == kTempCoeffs * sizeof(double), "temp_c size");
static_assert(sizeof(HostParams::bb_lo) == 3 * kBBCoeffs * sizeof(double), "bb size");
static_assert(sizeof(HostParams::amp) == kMaxOctaves * sizeof(double), "amp size");

template <typename T>
int launch(const HostParams* hp, const void* ro, const void* rd, const void* obs_e,
           const void* p_t, const void* p_phi, const void* exit_d, const void* active,
           int64_t n, void* out, void* samples, void* stream) {
  if (hp->octaves < 1 || hp->octaves > kMaxOctaves) return (int)cudaErrorInvalidValue;
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
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    raymarch_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        P, (const T*)ro, (const T*)rd, (const T*)obs_e, (const T*)p_t, (const T*)p_phi,
        (const T*)exit_d, (const bool*)active, n, (T*)out, (int32_t*)samples);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// hp: the march's parameters; ro, rd [n, 3]; obs_e, p_t, p_phi, exit_d [n];
// active [n] bool; out [n, 4] XYZA; samples [n] int32.
int vol_raymarch_f32(const HostParams* hp, const void* ro, const void* rd, const void* obs_e,
                     const void* p_t, const void* p_phi, const void* exit_d, const void* active,
                     int64_t n, void* out, void* samples, void* stream) {
  return launch<float>(hp, ro, rd, obs_e, p_t, p_phi, exit_d, active, n, out, samples, stream);
}

int vol_raymarch_f64(const HostParams* hp, const void* ro, const void* rd, const void* obs_e,
                     const void* p_t, const void* p_phi, const void* exit_d, const void* active,
                     int64_t n, void* out, void* samples, void* stream) {
  return launch<double>(hp, ro, rd, obs_e, p_t, p_phi, exit_d, active, n, out, samples, stream);
}

}  // extern "C"
