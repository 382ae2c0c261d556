// Sphere surface-crossing events, shared by the march kernels K1
// (kerr_rk4_march.cu) and K3 (kerr_bl_march.cu).
//
// Replaces _store_sphere_events and the sphere candidate tests of the TPU
// kernels (gr_raytracer_tpu/ops/geodesic_pallas.py `:396`, `:651-661` and
// `:1112-1123`). A step's Cartesian chord s3 → e3 records, per sphere, the
// reference's surface crossing: the endpoint radii straddle the surface (a
// chord that passes fully through the sphere is a miss), the + root of the
// quadratic is preferred, and the payload is world point3 | p_interp4 |
// uv2 | chord3 with the local spherical UV, θ = atan2(√max(1 − c², 0), c).
// K1 gates the store on the straddle test itself; K3 gates it on a near
// test in Boyer-Lindquist coordinates, ||p| − |c|| ≤ R at either endpoint
// with |p|² = r² + a² sin²θ, before it computes the embedding.
//
// The plain torch versions are ops/geodesic_march.py::_store_sphere_events,
// _sphere_candidates_ks and _sphere_candidates_bl; the order of every
// operation is theirs. What bounds it: nothing of its own. The store runs
// on the few steps whose chord meets a sphere; the candidate test is ~10
// float operations a sphere and step. The Kerr-Schild reverse sweep K2
// (kerr_ks_adjoint.cu) takes the same sphere table, filled from the same
// rows, and replays the store's crossing in its sphere payload; the BL
// sweep K4 has no sphere payload.

#pragma once

#include <math.h>

#include "kerr_ks_common.cuh"

namespace ks {

constexpr int kMaxSpheres = 8;

// The spheres of a march, rounded to T. R² and |c| come from the host in
// double, as the plain version's Python-float products are.
template <typename T>
struct SphereTable {
  T radius[kMaxSpheres], cx[kMaxSpheres], cy[kMaxSpheres], cz[kMaxSpheres];
  T radius2[kMaxSpheres], c_norm[kMaxSpheres];
  int kind[kMaxSpheres];
  int n;
};

// rows: n rows of (radius, cx, cy, cz, radius², |c|, kind).
template <typename T>
__host__ void fill_sphere_table(SphereTable<T>& S, const double* rows, int n) {
  for (int i = 0; i < kMaxSpheres; ++i) {
    const bool on = i < n;
    const double* row = rows + 7 * i;
    S.radius[i] = on ? T(row[0]) : T(0);
    S.cx[i] = on ? T(row[1]) : T(0);
    S.cy[i] = on ? T(row[2]) : T(0);
    S.cz[i] = on ? T(row[3]) : T(0);
    S.radius2[i] = on ? T(row[4]) : T(0);
    S.c_norm[i] = on ? T(row[5]) : T(0);
    S.kind[i] = on ? (int)row[6] : -1;
  }
  S.n = n;
}

// |p − c|² of sphere i, summed as the plain version sums it.
template <typename T>
__device__ __forceinline__ T dist2(const SphereTable<T>& S, int i, const T* p) {
  const T x = p[0] - S.cx[i], y = p[1] - S.cy[i], z = p[2] - S.cz[i];
  return x * x + y * y + z * z;
}

// K1's gate: does some sphere's surface lie between the chord's endpoint
// radii? It holds wherever the store's straddle test does.
template <typename T>
__device__ __forceinline__ bool sphere_candidate_ks(const SphereTable<T>& S, const T* s3,
                                                    const T* e3) {
  bool cand = false;
  for (int i = 0; i < S.n; ++i) {
    const T r2 = S.radius2[i];
    cand = cand || ((dist2(S, i, s3) - r2) * (dist2(S, i, e3) - r2) <= T(0));
  }
  return cand;
}

// K3's gate on the BL endpoints' embedded norms n0 and n1.
template <typename T>
__device__ __forceinline__ bool sphere_candidate_bl(const SphereTable<T>& S, T n0, T n1) {
  bool cand = false;
  for (int i = 0; i < S.n; ++i) {
    cand = cand || (fabs_(n0 - S.c_norm[i]) <= S.radius[i]) ||
           (fabs_(n1 - S.c_norm[i]) <= S.radius[i]);
  }
  return cand;
}

// Append each sphere's crossing of s3 → e3 into the lane's max_events
// slots.
template <typename T>
__device__ __forceinline__ void store_sphere_events(const SphereTable<T>& S, const T* s3,
                                                    const T* e3, const T* p_prev,
                                                    const T* p_new, int max_events,
                                                    int32_t* my_kind, T* my_data, int& ev_count,
                                                    bool& ev_ovf) {
  const T d[3] = {e3[0] - s3[0], e3[1] - s3[1], e3[2] - s3[2]};
  const T pi = T(3.141592653589793), two_pi = T(2.0 * 3.141592653589793);
  for (int i = 0; i < S.n; ++i) {
    const T r2 = S.radius2[i];
    const T rs = dist2(S, i, s3), re = dist2(S, i, e3);
    const bool crossing = (rs >= r2 && re <= r2) || (rs <= r2 && re >= r2);
    if (!crossing) continue;
    const T s_loc[3] = {s3[0] - S.cx[i], s3[1] - S.cy[i], s3[2] - S.cz[i]};
    const T a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    const T b = T(2) * (s_loc[0] * d[0] + s_loc[1] * d[1] + s_loc[2] * d[2]);
    const T c = rs - r2;
    const T disc = b * b - T(4) * a * c;
    const T sq = sqrt_(nmax(disc, T(0)));
    const T safe_a = a != T(0) ? a : T(1);
    const T t1 = (-b + sq) / (T(2) * safe_a);
    const T t2 = (-b - sq) / (T(2) * safe_a);
    const bool t1_ok = t1 >= T(0) && t1 <= T(1);
    const bool t2_ok = t2 >= T(0) && t2 <= T(1);
    if (!(disc >= T(0) && (t1_ok || t2_ok) && a != T(0))) continue;
    if (ev_count >= max_events) {
      ev_ovf = true;
      continue;
    }
    const T t = t1_ok ? t1 : t2;
    T local[3];
    for (int k = 0; k < 3; ++k) local[k] = s_loc[k] + t * d[k];
    const T r_loc =
        sqrt_(nmax(local[0] * local[0] + local[1] * local[1] + local[2] * local[2], T(1e-30)));
    const T cos_th = clip(local[2] / r_loc, T(-1), T(1));
    const T theta = atan2_(sqrt_(nmax(T(1) - cos_th * cos_th, T(0))), cos_th);
    const T phi = atan2_(local[1], local[0]);
    T* slot = my_data + ev_count * kEventWidth;
    slot[0] = local[0] + S.cx[i];
    slot[1] = local[1] + S.cy[i];
    slot[2] = local[2] + S.cz[i];
    for (int k = 0; k < 4; ++k) slot[3 + k] = p_prev[k] + t * (p_new[k] - p_prev[k]);
    slot[7] = T(1) - (pi + phi) / two_pi;
    slot[8] = theta / pi;
    for (int k = 0; k < 3; ++k) slot[9 + k] = d[k];
    my_kind[ev_count] = S.kind[i];
    ++ev_count;
  }
}

}  // namespace ks
