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
// 50,000 samples. One thread per lane would march each lane's samples one
// after another, so a launch would last as long as its longest lane's
// chain of dependent instructions (on an H100, the 128 longest lanes of
// the 500² frame's middle chunk took 0.89 of the chunk's time alone;
// chip_smoke.py's critical path). So each lane gets a warp, and the warp
// takes its samples 32 at a time:
//   * warp w of the grid takes lane n − 1 − w: the render path sorts the
//     lanes by their clipped march length, ascending
//     (volumetric_march.march_length), so the longest lanes start first and
//     the short ones fill in behind them. The warp's thread 0 reads the
//     lane's inputs and computes its march bounds into shared memory, where
//     the warp reads them: a value the same in all 32 threads holds no
//     register (in float64, 96 registers and no spill, against 128 and a
//     spill with these values in every thread's registers);
//   * in a batch, thread t evaluates the sample t places after the batch's
//     first on the sample grid (next_k walked t times; k + t when no
//     candidate of the batch lies in the hole interval, which a warp vote
//     tells) and its attenuation. The optics read the sample's position
//     and nothing of the carry, so this is nearly all of a sample's work;
//   * the fold then runs in sample order with the plain version's
//     expressions, so every rounding is the serial march's: the
//     transparency chain trans·att over the batch (each thread keeps its
//     own sample's product), each sample's weights from its own
//     transparency, and the five sums (acc XYZ, Σ alpha weights), one
//     chain per thread 0–4 over the batch's terms in shared memory. The
//     fold stops at the batch's first sample whose exit holds (the step
//     past d_hi, or the transparency below the saturation threshold, as
//     the serial loop tests them) or at the max_steps cap; the at most 31
//     samples evaluated past it are dropped. Counted from the source, the
//     fold costs about 270 warp instructions a batch in float32 (350 in
//     float64: two-word shuffles and selects): the hole vote, the chain's
//     32 shuffles, products and selects, the exit ballot, the terms and
//     their stores, the sums' 32 loads and adds; against about 2,500 for
//     the 32 samples' optics, some 10 % of a batch.
// A block holds 4 lanes (128 threads), and in shared memory their inputs
// and bounds and 4 × 32 × 5 terms.
//
// The TPU-only parts are dropped: the (8,128) tiles; the Chebyshev
// coefficients unrolled as static floats (they arrive here in the parameter
// struct, rounded once to the march type as torch rounds a Python scalar);
// the unroll, which is bit-equivalent to the rolled loop. The hash is
// native uint32 arithmetic (the plain version carries it in int64 with a
// mask). The lane keeps the JAX kernel's cap of max_steps samples; since
// d_hi <= max_steps·d_s it never binds before the lane's own exit.
//
// Built with -fmad=false (ops/cuda_build.py): the kernel rounds every
// operation as the plain version's separate torch ops do. With the same
// medium values K6's raw results, combined, are K5's XYZA bit for bit in
// float64; in float32 σ_a + σ_s rounded in float32 can differ by an ulp
// from the host's float64 sum rounded once, which K5 uses.

#include "vol_common.cuh"

namespace {

using namespace vol;

constexpr int kBatch = 32;                 // samples a warp evaluates at once: one a thread
constexpr int kLanesPerBlock = kThreads / kBatch;
constexpr int kSums = 5;                   // acc x, y, z, alpha_w_sum, alpha_w_tot
constexpr unsigned kWarp = 0xffffffffu;

// A lane's inputs, medium and march bounds: the same in its whole warp.
template <typename T>
struct Lane {
  T rox, roy, roz, rdx, rdy, rdz, obs_e, p_t, p_phi, sigma, sca;
  Medium<T> M;
  Bounds<T> b;
};

template <typename T, bool kRaw>
__global__ void __launch_bounds__(kThreads)
raymarch_kernel(const __grid_constant__ Params<T> P, const T* __restrict__ med, const T* __restrict__ ro,
                const T* __restrict__ rd, const T* __restrict__ obs_e_in, const T* __restrict__ p_t_in,
                const T* __restrict__ p_phi_in, const T* __restrict__ exit_d_in,
                const bool* __restrict__ active_in, int64_t n, T* __restrict__ out,
                int32_t* __restrict__ samples_out) {
  // Each sample's five terms of the sums, for the chains of threads 0-4.
  __shared__ T terms[kLanesPerBlock][kBatch][kSums];
  __shared__ Lane<T> lanes[kLanesPerBlock];
  const int t = threadIdx.x % kBatch, w = threadIdx.x / kBatch;
  T(*const batch)[kSums] = terms[w];
  Lane<T>& L = lanes[w];
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kBatch;
  if (warp >= n) return;  // the whole warp
  const int64_t lane = n - 1 - warp;
  if (t == 0) {
    L.rox = ro[lane * 3], L.roy = ro[lane * 3 + 1], L.roz = ro[lane * 3 + 2];
    L.rdx = rd[lane * 3], L.rdy = rd[lane * 3 + 1], L.rdz = rd[lane * 3 + 2];
    L.obs_e = obs_e_in[lane], L.p_t = p_t_in[lane], L.p_phi = p_phi_in[lane];
    if (kRaw) {
      L.M = Medium<T>{med[0], med[1], med[4]};
      L.sigma = med[2] + med[3];
      L.sca = med[3];
    } else {
      L.M = Medium<T>{P.dm, P.noise_off, P.br};
      L.sigma = P.sigma;
      L.sca = P.sca;
    }
    L.b = march_bounds(P, L.rox, L.roy, L.roz, L.rdx, L.rdy, L.rdz, exit_d_in[lane], active_in[lane]);
  }
  __syncwarp();
  const T d_s = P.d_s;
  // The carry (volumetric_march._march_step): k, trans and samples in every
  // thread; thread j < kSums holds the j-th sum.
  T k = L.b.k0;
  bool done = L.b.empty;
  T trans = T(1), sum = T(0);
  int samples = 0;
  while (!done && samples < P.max_steps) {
    // This thread's sample: next_k walked t times from k.
    T k_t = k + T(t);
    const T d_t = k_t * d_s;
    if (__any_sync(kWarp, t > 0 && d_t >= L.b.i_lo && d_t < L.b.i_hi)) {
      k_t = k;
      for (int j = 1; j < kBatch; ++j) {
        const T k_j = next_k(L.b, k_t, d_s);
        k_t = j <= t ? k_j : k_t;
      }
    }
    const T d_o = k_t * d_s;
    const T px = L.rox + L.rdx * d_o;
    const T py = L.roy + L.rdy * d_o;
    const T pz = L.roz + L.rdz * d_o;
    const Optics<T> o = sample_optics(P, L.M, px, py, pz, L.obs_e, L.p_t, L.p_phi);
    const T attenuation = exp_(-d_s * o.density * L.sigma);

    // The transparency chain in sample order; thread t keeps its sample's.
    T chain = trans, trans_t = trans;
#pragma unroll 8
    for (int s = 0; s < kBatch; ++s) {
      chain = chain * __shfl_sync(kWarp, attenuation, s);
      trans_t = s == t ? chain : trans_t;
    }
    // The samples folded: up to the batch's first exit, tested as the
    // serial loop tests it after each sample, or to the max_steps cap.
    const T k_next = next_k(L.b, k_t, d_s);
    const unsigned exits = __ballot_sync(kWarp, (k_next * d_s >= L.b.d_hi) || (trans_t < T(kSaturationEps)));
    const int used = min(exits ? __ffs(exits) : kBatch, P.max_steps - samples);

    const T weight = trans_t * attenuation * L.sca * o.density * d_s;
    const T wscale = weight * (o.emit_ok ? T(1) : T(0));
    const T alpha_w = o.emit_ok ? o.density * d_s : T(0);
    batch[t][0] = wscale * o.ex;
    batch[t][1] = wscale * o.ey;
    batch[t][2] = wscale * o.ez;
    batch[t][3] = clip(o.lalpha, T(0), T(1)) * alpha_w;
    batch[t][4] = alpha_w;
    __syncwarp();
    const int j = min(t, kSums - 1);
    for (int s = 0; s < used; ++s) sum = sum + batch[s][j];
    __syncwarp();

    trans = __shfl_sync(kWarp, trans_t, used - 1);
    k = __shfl_sync(kWarp, k_next, used - 1);
    samples += used;
    done = exits != 0;
  }
  const T acc_x = __shfl_sync(kWarp, sum, 0);
  const T acc_y = __shfl_sync(kWarp, sum, 1);
  const T acc_z = __shfl_sync(kWarp, sum, 2);
  const T ws = __shfl_sync(kWarp, sum, 3);
  const T wt = __shfl_sync(kWarp, sum, 4);
  if (t != 0) return;
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
    const int64_t blocks = (n + kLanesPerBlock - 1) / kLanesPerBlock;  // a warp per lane
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
