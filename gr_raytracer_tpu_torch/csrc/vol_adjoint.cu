// Backward of the volumetric raymarch K6 (K7): forward-order replay with
// suffix sums.
//
// Replaces the TPU kernel gr_raytracer_tpu/ops/volumetric_adjoint.py
// make_vol_march_diff.march_bwd (pallas_call body _bwd_kernel). The plain
// torch version is gr_raytracer_tpu_torch/ops/volumetric_adjoint.py
// vol_march_bwd_plain (per sample: _bwd_step).
//
// The march's reductions are A = Σ w_i e_i with w_i = T_i·att_i²·σ_s·ρ_i·d_s
// and T_{i+1} = T_i·att_i, so every cotangent is a per-sample term plus a
// suffix sum over later weights, G_i = s_tot − Σ_{j≤i} (ct_A·e_j) w_j, where
// s_tot = ct_A·A is the forward's committed total. So the backward is a
// second march in forward order: it replays K6's k-grid, hole jump and
// saturation exit exactly (csrc/vol_common.cuh: the same march_bounds,
// next_k and sample_optics, the same transparency product; the exit step
// decides every suffix sum), and at each sample pushes the cotangents of
// (ρ, e_x, e_y, e_z) through the optics:
//   * along px, py, pz by the partials of the sample's one jet evaluation
//     of sample_optics (below);
//   * along the directions that never reach the noise in closed form:
//     density_multiplier and noise_offset (ρ = (max(n + off, 0)·dm)·
//     envelopes; the gradient passes at n + off = 0, as torch's clamp
//     passes it), brightness_ref (e = (T/br)⁴·l: ∂e/∂br = −4e/br) and
//     obs_e, p_t, p_phi (through redshift = obs_e/(u_t p_t + u_φ p_φ) and
//     the texture's partial along the redshift);
// then adds the σ = σ_a + σ_s structure terms: dL/dσ += −τ_i (G_i + 2 cw_i
// + ct_T T_f), dL/dσ_s += (ct_A·e_i) w_i/σ_s.
//
// What bounds it on the card: operations, as K6 (inputs 11 + 8 a lane,
// outputs 14); the yardstick is the plain sample's forward and VJP, 3,276
// float and 972 integer operations (chip_smoke.py count_vol_bwd_ops), over
// the samples K6 marched. The design does the sample's work once:
//   * one evaluation of the optics a sample, in Jet<T, 3> along (px, py,
//     pz) (csrc/vol_common.cuh). Its value part is K6's arithmetic in K6's
//     op order, so the replayed transparency, saturation step and hole
//     jump are K6's bit for bit; its partials are ∂(ρ, e_x, e_y, e_z)/∂p,
//     contracted here with the sample's cotangents;
//   * through the noise, the closed-form gradient of perlin3: each corner
//     hash and fade is computed once per corner, octave and sample, and
//     the octave loop carries six running sums (the gradient in noise
//     coordinates). The temperature and the texture are evaluated in jets
//     of their own inputs (r; temperature and redshift), which also gives
//     the redshift partials the closed forms above read;
//   * one thread per lane, at most 128 registers a thread in float32
//     (__launch_bounds__ with 4 blocks an SM: 16 resident warps, no
//     spills). The render path sorts the lanes by march length
//     (fast_path.volumetric_lanes), so a warp's lanes end close together;
//     but a lane's samples run one after another on its thread, so the
//     longest lanes' chains set a launch's time (K6 spreads each lane's
//     samples over a warp instead: csrc/vol_raymarch.cu).
// The outputs stay per lane: the [n, 5] medium partials are summed by the
// caller, with no atomics on results, so the sums are deterministic. A
// lane's loop ends when the lane is done, so a dead lane is never
// evaluated (the TPU kernel evaluates its dead lanes at a mid-disc
// position with zero cotangents; the plain version does too). Built
// with -fmad=false (ops/cuda_build.py) like K6.

#include "vol_common.cuh"

namespace {

using namespace vol;

constexpr int kCt = 8;   // ct_acc xyz, ct_T, ct_Ws, ct_Wt, s_tot, T_f
constexpr int kDin = 9;  // d_ro xyz, d_rd xyz, d_obs_e, d_p_t, d_p_phi

// Blocks an SM must hold at once: 4 in float32 (at most 128 registers a
// thread), any number in float64.
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 4 : 1;

// Σ cotangent · ∂/∂p_i over (ρ, e_x, e_y, e_z).
template <typename T>
__device__ __forceinline__ T contract(const Optics<Jet<T, 3>>& o, int i, T d_rho, T d_ex, T d_ey, T d_ez) {
  return d_rho * o.density.d[i] + d_ex * o.ex.d[i] + d_ey * o.ey.d[i] + d_ez * o.ez.d[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
vol_adjoint_kernel(const __grid_constant__ Params<T> P, const T* __restrict__ med, const T* __restrict__ ro,
                   const T* __restrict__ rd, const T* __restrict__ obs_e_in, const T* __restrict__ p_t_in,
                   const T* __restrict__ p_phi_in, const T* __restrict__ exit_d_in,
                   const bool* __restrict__ active_in, const T* __restrict__ cts, int64_t n,
                   T* __restrict__ d_in, T* __restrict__ d_med) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const T rox = ro[lane * 3], roy = ro[lane * 3 + 1], roz = ro[lane * 3 + 2];
  const T rdx = rd[lane * 3], rdy = rd[lane * 3 + 1], rdz = rd[lane * 3 + 2];
  const T obs_e = obs_e_in[lane], p_t = p_t_in[lane], p_phi = p_phi_in[lane];
  const T* ct = cts + lane * kCt;
  const T ct_ax = ct[0], ct_ay = ct[1], ct_az = ct[2];
  const T ct_t = ct[3], ct_ws = ct[4], ct_wt = ct[5];
  const T s_tot = ct[6], t_f = ct[7];
  const T d_s = P.d_s;
  const T dm = med[0], br = med[4];
  const Medium<T> M{dm, med[1], br};
  const T sigma = med[2] + med[3];
  const T ss = med[3];

  const Bounds<T> b = march_bounds(P, rox, roy, roz, rdx, rdy, rdz, exit_d_in[lane], active_in[lane]);
  T k = b.k0;
  bool done = b.empty;

  T trans = T(1), s_pref = T(0);
  T d_rox = T(0), d_roy = T(0), d_roz = T(0), d_rdx = T(0), d_rdy = T(0), d_rdz = T(0);
  T d_obs = T(0), d_pt = T(0), d_pp = T(0);
  T g_dm = T(0), g_off = T(0), g_sig = T(0), g_ssd = T(0), g_br = T(0);
  for (int it = 0; it < P.max_steps && !done; ++it) {
    const T d_o = k * d_s;
    const T px = rox + rdx * d_o;
    const T py = roy + rdy * d_o;
    const T pz = roz + rdz * d_o;
    using J3 = Jet<T, 3>;
    const Optics<J3> o = sample_optics(P, M, J3::var(px, 0), J3::var(py, 1), J3::var(pz, 2), obs_e, p_t, p_phi);

    // The replay: K6's attenuation, in its op order.
    const T rho = o.density.v;
    const T tau = d_s * rho;
    const T att = exp_(-d_s * rho * sigma);
    const T trans0 = trans;
    trans = trans0 * att;
    const T m = o.emit_ok ? T(1) : T(0);

    // The cotangents of this sample's (ρ, e).
    const T att2 = att * att;
    const T v = trans0 * att2 * rho * d_s * m;  // w / σ_s
    const T w = ss * v;
    const T ce = ct_ax * o.ex.v + ct_ay * o.ey.v + ct_az * o.ez.v;
    const T cw = ce * w;
    s_pref = s_pref + cw;
    const T g_suf = s_tot - s_pref;  // Σ_{j>i} cw_j
    const T common = g_suf + ct_t * t_f;
    const T d_rho = ce * ss * trans0 * att2 * d_s * m * (T(1) - T(2) * d_s * sigma * rho)
                    - d_s * sigma * common
                    + (ct_ws * clip(o.lalpha.v, T(0), T(1)) + ct_wt) * d_s * m;
    const T d_ex = ct_ax * w, d_ey = ct_ay * w, d_ez = ct_az * w;

    // Along the position.
    const T g_px = contract(o, 0, d_rho, d_ex, d_ey, d_ez);
    const T g_py = contract(o, 1, d_rho, d_ex, d_ey, d_ez);
    const T g_pz = contract(o, 2, d_rho, d_ex, d_ey, d_ez);

    // density_multiplier and noise_offset.
    if (o.inside) {
      const T env = o.radial_base.v * o.vertical.v * o.boundary.v;
      g_dm = g_dm + d_rho * (nmax(o.n_off.v, T(0)) * env);
      if (o.n_off.v >= T(0)) g_off = g_off + d_rho * (dm * env);
    }
    // brightness_ref: e = (T/br)⁴·l.
    const Jet<T, 1> tr = Jet<T, 1>(o.temp.v) / Jet<T, 1>::var(br, 0);
    const Jet<T, 1> tr2 = tr * tr;
    const Jet<T, 1> inten = tr2 * tr2;
    g_br = g_br + (d_ex * o.lx.v + d_ey * o.ly.v + d_ez * o.lz.v) * inten.d[0];
    // obs_e, p_t, p_phi through the redshift (the texture's partial along
    // it at a fixed temperature, from the sample's evaluation).
    if (o.emit_ok) {
      const T ct_z = o.intensity.v * (d_ex * o.lx_z + d_ey * o.ly_z + d_ez * o.lz_z);
      const T ct_e = -(ct_z * o.redshift.v) / o.energy.v;
      d_obs = d_obs + ct_z / o.energy.v;
      d_pt = d_pt + ct_e * o.u_t.v;
      d_pp = d_pp + ct_e * o.u_phi.v;
    }

    // The σ = σ_a + σ_s structure terms.
    g_sig = g_sig + -tau * (common + T(2) * cw);
    g_ssd = g_ssd + ce * v;

    // p = ro + rd·d_o with the k-grid locally constant.
    d_rox = d_rox + g_px;
    d_roy = d_roy + g_py;
    d_roz = d_roz + g_pz;
    d_rdx = d_rdx + g_px * d_o;
    d_rdy = d_rdy + g_py * d_o;
    d_rdz = d_rdz + g_pz * d_o;

    const T k_next = next_k(b, k, d_s);
    done = (k_next * d_s >= b.d_hi) || (trans < T(kSaturationEps));
    k = k_next;
  }
  T* di = d_in + lane * kDin;
  di[0] = d_rox;
  di[1] = d_roy;
  di[2] = d_roz;
  di[3] = d_rdx;
  di[4] = d_rdy;
  di[5] = d_rdz;
  di[6] = d_obs;
  di[7] = d_pt;
  di[8] = d_pp;
  T* dmd = d_med + lane * kNMed;
  dmd[0] = g_dm;
  dmd[1] = g_off;
  dmd[2] = g_sig;          // absorption: dσ
  dmd[3] = g_sig + g_ssd;  // scattering: dσ + its direct term
  dmd[4] = g_br;
}

template <typename T>
int launch(const HostParams* hp, const void* med, const void* ro, const void* rd, const void* obs_e,
           const void* p_t, const void* p_phi, const void* exit_d, const void* active, const void* cts,
           int64_t n, void* d_in, void* d_med, void* stream) {
  if (hp->octaves < 1 || hp->octaves > kMaxOctaves) return (int)cudaErrorInvalidValue;
  const Params<T> P = to_params<T>(hp);
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    vol_adjoint_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        P, (const T*)med, (const T*)ro, (const T*)rd, (const T*)obs_e, (const T*)p_t, (const T*)p_phi,
        (const T*)exit_d, (const bool*)active, (const T*)cts, n, (T*)d_in, (T*)d_med);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// hp: the march's parameters; med [5] (dm, off, σ_a, σ_s, br); ro, rd
// [n, 3]; obs_e, p_t, p_phi, exit_d [n]; active [n] bool; cts [n, 8]
// (ct_acc xyz, ct_T, ct_Ws, ct_Wt, s_tot, T_f); d_in [n, 9] (d_ro, d_rd,
// d_obs_e, d_p_t, d_p_phi); d_med [n, 5] per-lane medium partials.
int vol_adjoint_f32(const HostParams* hp, const void* med, const void* ro, const void* rd, const void* obs_e,
                    const void* p_t, const void* p_phi, const void* exit_d, const void* active, const void* cts,
                    int64_t n, void* d_in, void* d_med, void* stream) {
  return launch<float>(hp, med, ro, rd, obs_e, p_t, p_phi, exit_d, active, cts, n, d_in, d_med, stream);
}

int vol_adjoint_f64(const HostParams* hp, const void* med, const void* ro, const void* rd, const void* obs_e,
                    const void* p_t, const void* p_phi, const void* exit_d, const void* active, const void* cts,
                    int64_t n, void* d_in, void* d_med, void* stream) {
  return launch<double>(hp, med, ro, rd, obs_e, p_t, p_phi, exit_d, active, cts, n, d_in, d_med, stream);
}

}  // extern "C"
