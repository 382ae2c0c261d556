// Constant-step volumetric raymarch (hash-Perlin fBm density, Killing
// redshift, Chebyshev T⁴ and blackbody log-XYZ fits, Beer-Lambert, hole
// jump, saturation exit), in two forms of one kernel:
//
//   K5 replaces the TPU kernel gr_raytracer_tpu/ops/volumetric_pallas.py
//      raymarch (pallas_call body _march_kernel): the medium from the
//      parameter struct, XYZA and the sample count out.
//   K6 replaces gr_raytracer_tpu/ops/volumetric_adjoint.py
//      make_vol_march_diff._forward (pallas_call body _fwd_kernel): the
//      five medium parameters read at run time from a device array [5] of
//      the march type (dm, off, σ_a, σ_s, br; σ = σ_a + σ_s summed in that
//      type, as _fwd_kernel sums it), so a fit step never rebuilds the
//      parameter struct; the raw reductions out (acc XYZ, transparency,
//      Σ alpha weights), combined into XYZA outside, where autograd sees it.
//
// Same arithmetic, sample grid and exits as the JAX kernels; the plain
// torch versions are gr_raytracer_tpu_torch/ops/volumetric_march.py
// raymarch_plain and raymarch_raw_plain, whose functions set the order of
// every operation here (through csrc/vol_common.cuh, shared with K7).
//
// What bounds it on the card: operations. A lane reads 11 values and writes
// 4 and its sample count (K6: 6), while every sample costs nine Perlin
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
// operation as the plain version's separate torch ops do. With the same
// medium values K6's raw results, combined, are K5's XYZA bit for bit in
// float64; in float32 σ_a + σ_s rounded in float32 can differ by an ulp
// from the host's float64 sum rounded once, which K5 uses.

#include "vol_common.cuh"

namespace {

using namespace vol;

template <typename T, bool kRaw>
__global__ void __launch_bounds__(kThreads)
raymarch_kernel(const __grid_constant__ Params<T> P, const T* __restrict__ med, const T* __restrict__ ro,
                const T* __restrict__ rd, const T* __restrict__ obs_e_in, const T* __restrict__ p_t_in,
                const T* __restrict__ p_phi_in, const T* __restrict__ exit_d_in,
                const bool* __restrict__ active_in, int64_t n, T* __restrict__ out,
                int32_t* __restrict__ samples_out) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const T rox = ro[lane * 3], roy = ro[lane * 3 + 1], roz = ro[lane * 3 + 2];
  const T rdx = rd[lane * 3], rdy = rd[lane * 3 + 1], rdz = rd[lane * 3 + 2];
  const T obs_e = obs_e_in[lane], p_t = p_t_in[lane], p_phi = p_phi_in[lane];
  const T d_s = P.d_s;
  Medium<T> M;
  T sigma, sca;
  if (kRaw) {
    M = Medium<T>{med[0], med[1], med[4]};
    sigma = med[2] + med[3];
    sca = med[3];
  } else {
    M = Medium<T>{P.dm, P.noise_off, P.br};
    sigma = P.sigma;
    sca = P.sca;
  }

  const Bounds<T> b = march_bounds(P, rox, roy, roz, rdx, rdy, rdz, exit_d_in[lane], active_in[lane]);
  T k = b.k0;
  bool done = b.empty;

  // The carry (volumetric_march._march_step).
  T trans = T(1), acc_x = T(0), acc_y = T(0), acc_z = T(0), ws = T(0), wt = T(0);
  int samples = 0;
  for (int it = 0; it < P.max_steps && !done; ++it) {
    const T d_o = k * d_s;
    const T px = rox + rdx * d_o;
    const T py = roy + rdy * d_o;
    const T pz = roz + rdz * d_o;
    const Optics<T> o = sample_optics(P, M, px, py, pz, obs_e, p_t, p_phi);
    const T attenuation = exp_(-d_s * o.density * sigma);
    trans = trans * attenuation;
    const T weight = trans * attenuation * sca * o.density * d_s;
    const T wscale = weight * (o.emit_ok ? T(1) : T(0));
    acc_x = acc_x + wscale * o.ex;
    acc_y = acc_y + wscale * o.ey;
    acc_z = acc_z + wscale * o.ez;
    const T alpha_w = o.emit_ok ? o.density * d_s : T(0);
    ws = ws + clip(o.lalpha, T(0), T(1)) * alpha_w;
    wt = wt + alpha_w;
    const T k_next = next_k(b, k, d_s);
    done = (k_next * d_s >= b.d_hi) || (trans < T(kSaturationEps));
    k = k_next;
    ++samples;
  }
  if (kRaw) {
    out[lane * 6] = acc_x;
    out[lane * 6 + 1] = acc_y;
    out[lane * 6 + 2] = acc_z;
    out[lane * 6 + 3] = trans;
    out[lane * 6 + 4] = ws;
    out[lane * 6 + 5] = wt;
  } else {
    const bool ok = wt > T(kAlphaWtMin);
    const T texture_alpha = ok ? ws / wt : T(1);
    out[lane * 4] = acc_x;
    out[lane * 4 + 1] = acc_y;
    out[lane * 4 + 2] = acc_z;
    out[lane * 4 + 3] = (T(1) - trans) * texture_alpha;
    samples_out[lane] = samples;
  }
}

template <typename T, bool kRaw>
int launch(const HostParams* hp, const void* med, const void* ro, const void* rd, const void* obs_e,
           const void* p_t, const void* p_phi, const void* exit_d, const void* active, int64_t n, void* out,
           void* samples, void* stream) {
  if (hp->octaves < 1 || hp->octaves > kMaxOctaves) return (int)cudaErrorInvalidValue;
  const Params<T> P = to_params<T>(hp);
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    raymarch_kernel<T, kRaw><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        P, (const T*)med, (const T*)ro, (const T*)rd, (const T*)obs_e, (const T*)p_t, (const T*)p_phi,
        (const T*)exit_d, (const bool*)active, n, (T*)out, (int32_t*)samples);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K5. hp: the march's parameters; ro, rd [n, 3]; obs_e, p_t, p_phi, exit_d
// [n]; active [n] bool; out [n, 4] XYZA; samples [n] int32.
int vol_raymarch_f32(const HostParams* hp, const void* ro, const void* rd, const void* obs_e,
                     const void* p_t, const void* p_phi, const void* exit_d, const void* active,
                     int64_t n, void* out, void* samples, void* stream) {
  return launch<float, false>(hp, nullptr, ro, rd, obs_e, p_t, p_phi, exit_d, active, n, out, samples,
                              stream);
}

int vol_raymarch_f64(const HostParams* hp, const void* ro, const void* rd, const void* obs_e,
                     const void* p_t, const void* p_phi, const void* exit_d, const void* active,
                     int64_t n, void* out, void* samples, void* stream) {
  return launch<double, false>(hp, nullptr, ro, rd, obs_e, p_t, p_phi, exit_d, active, n, out, samples,
                               stream);
}

// K6. med [5] on the card (dm, off, σ_a, σ_s, br); the lanes as K5's; out
// [n, 6]: acc XYZ, transparency, alpha_w_sum, alpha_w_tot.
int vol_raymarch_raw_f32(const HostParams* hp, const void* med, const void* ro, const void* rd,
                         const void* obs_e, const void* p_t, const void* p_phi, const void* exit_d,
                         const void* active, int64_t n, void* out, void* stream) {
  return launch<float, true>(hp, med, ro, rd, obs_e, p_t, p_phi, exit_d, active, n, out, nullptr, stream);
}

int vol_raymarch_raw_f64(const HostParams* hp, const void* med, const void* ro, const void* rd,
                         const void* obs_e, const void* p_t, const void* p_phi, const void* exit_d,
                         const void* active, int64_t n, void* out, void* stream) {
  return launch<double, true>(hp, med, ro, rd, obs_e, p_t, p_phi, exit_d, active, n, out, nullptr, stream);
}

}  // extern "C"
