// Bounding-volume events of z-axis volumetric discs, shared by the march
// kernels K1 (kerr_rk4_march.cu) and K3 (kerr_bl_march.cu).
//
// The bounding volume is the inner and outer cylinder clipped to the caps at
// ±cap_h. A step's Cartesian chord s3 → e3 records, per volume, its first
// crossing: the smallest of six candidate roots in (1e-9, 1] (two per
// cylinder within the caps, one per cap within the annulus). Root finding
// cannot tunnel: a chord that crosses the boundary has a root whatever its
// length. The payload is point3 | p_interp4 | uv2 | chord3; the volumetric
// raymarch (vol_raymarch.cu) starts at the point along the chord.
//
// The plain torch versions are ops/geodesic_march.py::_vol_candidates and
// _store_vol_events; the order of every operation is theirs. The reverse
// sweeps K2 and K4 do not include this header.

#pragma once

#include <math.h>

#include "kerr_ks_common.cuh"

namespace ks {

constexpr int kMaxVols = 8;

// The volumes of a march, rounded to T. The squares are taken in double on
// the host, as the plain version's Python-float products are.
template <typename T>
struct VolTable {
  T inner[kMaxVols], outer[kMaxVols], cap_h[kMaxVols];
  T inner2[kMaxVols], outer2[kMaxVols];
  int kind[kMaxVols];
  int n;
};

template <typename T>
__host__ void fill_vol_table(VolTable<T>& V, const double* rows, int n) {
  for (int i = 0; i < kMaxVols; ++i) {
    const bool on = i < n;
    const double inner = on ? rows[4 * i] : 0.0, outer = on ? rows[4 * i + 1] : 0.0;
    V.inner[i] = T(inner);
    V.outer[i] = T(outer);
    V.cap_h[i] = on ? T(rows[4 * i + 2]) : T(0);
    V.inner2[i] = T(inner * inner);
    V.outer2[i] = T(outer * outer);
    V.kind[i] = on ? (int)rows[4 * i + 3] : -1;
  }
  V.n = n;
}

// Does the chord's z range [min(z0, z1), max(z0, z1)] meet some volume's
// band, and (with check_rho) its closest squared distance to the axis lie
// inside that volume's outer cylinder? Necessary for every root.
template <typename T>
__device__ __forceinline__ bool vol_candidate(const VolTable<T>& V, T z0, T z1, bool check_rho,
                                              T rho_min2) {
  const T zmin = nmin(z0, z1), zmax = nmax(z0, z1);
  bool cand = false;
  for (int i = 0; i < V.n; ++i) {
    bool near = (zmin <= V.cap_h[i]) && (zmax >= -V.cap_h[i]);
    if (check_rho) near = near && (rho_min2 <= V.outer2[i]);
    cand = cand || near;
  }
  return cand;
}

// Append each volume's first crossing of s3 → e3 into the lane's
// max_events slots.
template <typename T>
__device__ __forceinline__ void store_vol_events(const VolTable<T>& V, const T* s3, const T* e3,
                                                 const T* p_prev, const T* p_new, int max_events,
                                                 int32_t* my_kind, T* my_data, int& ev_count,
                                                 bool& ev_ovf) {
  const T d[3] = {e3[0] - s3[0], e3[1] - s3[1], e3[2] - s3[2]};
  const T d_dot = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  const T a_cyl = d[0] * d[0] + d[1] * d[1];
  const T b_half = s3[0] * d[0] + s3[1] * d[1];
  const T ss_xy = s3[0] * s3[0] + s3[1] * s3[1];
  const T inf = T(INFINITY);
  for (int i = 0; i < V.n; ++i) {
    T best_t = inf;
    for (int cyl = 0; cyl < 2; ++cyl) {
      const T c = ss_xy - (cyl == 0 ? V.outer2[i] : V.inner2[i]);
      const T disc = b_half * b_half - a_cyl * c;
      const bool ok_base = (a_cyl >= T(1e-10) * d_dot) && (disc >= T(0));
      const T sq = sqrt_(nmax(disc, T(0)));
      const T safe_a = a_cyl > T(0) ? a_cyl : T(1);
      for (int sgn = 0; sgn < 2; ++sgn) {
        const T tt = (sgn == 0 ? -b_half - sq : -b_half + sq) / safe_a;
        const T z_at = s3[2] + tt * d[2];
        const bool ok = ok_base && (tt > T(1e-9)) && (tt <= T(1)) && (fabs_(z_at) <= V.cap_h[i]);
        if (ok && tt < best_t) best_t = tt;
      }
    }
    const bool dz_ok = fabs_(d[2]) > T(1e-10);
    const T safe_dz = dz_ok ? d[2] : T(1);
    for (int cap = 0; cap < 2; ++cap) {
      const T zc = cap == 0 ? V.cap_h[i] : -V.cap_h[i];
      const T tt = (zc - s3[2]) / safe_dz;
      const T px = s3[0] + tt * d[0];
      const T py = s3[1] + tt * d[1];
      const T r2 = px * px + py * py;
      const bool ok = dz_ok && (tt > T(1e-9)) && (tt <= T(1)) && (r2 <= V.outer2[i]) &&
                      (r2 >= V.inner2[i]);
      if (ok && tt < best_t) best_t = tt;
    }
    if (!(best_t < inf)) continue;
    if (ev_count >= max_events) {
      ev_ovf = true;
      continue;
    }
    T point[3];
    for (int k = 0; k < 3; ++k) point[k] = s3[k] + best_t * d[k];
    const T rr = sqrt_(point[0] * point[0] + point[1] * point[1]);
    const T phi = atan2_(point[1], point[0]);
    const T r_norm = (rr - V.inner[i]) / (V.outer[i] - V.inner[i]);
    T* slot = my_data + ev_count * kEventWidth;
    for (int k = 0; k < 3; ++k) slot[k] = point[k];
    for (int k = 0; k < 4; ++k) slot[3 + k] = p_prev[k] + best_t * (p_new[k] - p_prev[k]);
    slot[7] = T(0.5) + T(0.5) * r_norm * cos_(phi);
    slot[8] = T(0.5) + T(0.5) * r_norm * sin_(phi);
    for (int k = 0; k < 3; ++k) slot[9 + k] = d[k];
    my_kind[ev_count] = V.kind[i];
    ++ev_count;
  }
}

}  // namespace ks
