// The per-pixel arithmetic of the 8-neighbour coupled-flow red-black sweep
// (llin8), shared by the global kernels (flow_llin4_sor.cu) and the resident
// kernel (resident8_sor.cu), so that both round alike. The update spells
// out each multiply-add it fuses (__fmaf_rn) and rounds every other
// operation alone: left to the compiler, the contraction of a mul and an
// add into one fma depended on the surrounding kernel, and the two kernels
// differed in the last bit. Every expression is in the order of the plain
// version, pde_tpu_torch/solvers/sor.py::flow_coefficients and
// flow_half_sweep with eight weights (which rounds every operation, so the
// kernels meet it to a few ulps):
//   * the weights edge-zeroed (a diagonal one wherever its neighbour is off
//     the image), their sum in the order W, NW, N, NE, E, SE, S, SW;
//   * the neighbours in the order W, E, N, S, NW, NE, SW, SE;
//   * u first, then v from the refreshed u; a NaN Cu (Cv) drops the data
//     term, a NaN Du (Dv) drops it from the divisor.

#pragma once

#include <cstdint>

#include "flow_update.cuh"

namespace flow_sor8 {

using flow_sor::nan_to_num;

// What the update of one pixel reads besides the fields: the eight
// edge-zeroed weights in the plain sum order W, NW, N, NE, E, SE, S, SW,
// their sum, 1/(sum + Du), 1/(sum + Dv), the NaN-folded M, Cu, Cv and the
// NaN flags of Cu (bit 0) and Cv (bit 1).
struct Coef {
  float c[8];
  float wsum, inv_u, inv_v, m0, cu0, cv0;
  uint8_t flags;
};

// The weight order of Coef::c: W, NW, N, NE, E, SE, S, SW.
enum Weight { kW = 0, kNW, kN, kNE, kE, kSE, kS, kSW };

// Coef::c's index of the k-th neighbour of the plain order W, E, N, S, NW,
// NE, SW, SE.
__device__ __forceinline__ int weight_of(int k) {
  constexpr int kOrder[8] = {kW, kE, kN, kS, kNW, kNE, kSW, kSE};
  return kOrder[k];
}

// The k-th neighbour of (i, j) in the plain order W, E, N, S, NW, NE, SW,
// SE, clamped at the image edge (its weight is zero there): row offset and
// column offset.
__device__ __forceinline__ void neighbour(int k, int i, int j, int h, int w, int* ni, int* nj) {
  constexpr int kDi[8] = {0, 0, -1, 1, -1, -1, 1, 1};
  constexpr int kDj[8] = {-1, 1, 0, 0, -1, 1, -1, 1};
  *ni = min(max(i + kDi[k], 0), h - 1);
  *nj = min(max(j + kDj[k], 0), w - 1);
}

// The coefficients at pixel (i, j) of an h x w image.
__device__ __forceinline__ Coef prepare(int i, int j, int h, int w, float ww, float wnw, float wn,
                                        float wne, float we, float wse, float ws, float wsw,
                                        float m, float cu, float cv, float duc, float dvc) {
  const bool top = i == 0, bottom = i == h - 1, left = j == 0, right = j == w - 1;
  Coef k;
  k.c[kW] = left ? 0.0f : ww;
  k.c[kNW] = (top || left) ? 0.0f : wnw;
  k.c[kN] = top ? 0.0f : wn;
  k.c[kNE] = (top || right) ? 0.0f : wne;
  k.c[kE] = right ? 0.0f : we;
  k.c[kSE] = (bottom || right) ? 0.0f : wse;
  k.c[kS] = bottom ? 0.0f : ws;
  k.c[kSW] = (bottom || left) ? 0.0f : wsw;
  float wsum = k.c[0];
#pragma unroll
  for (int q = 1; q < 8; ++q) wsum += k.c[q];
  k.wsum = wsum;
  k.inv_u = 1.0f / (wsum + nan_to_num(duc));
  k.inv_v = 1.0f / (wsum + nan_to_num(dvc));
  k.m0 = nan_to_num(m);
  k.cu0 = nan_to_num(cu);
  k.cv0 = nan_to_num(cv);
  k.flags = static_cast<uint8_t>((isnan(cu) ? 1 : 0) | (isnan(cv) ? 2 : 0));
  return k;
}

// The new (dU, dV) of a pixel from its neighbours' pre-added sums: `sum(k)`
// gives (fl(dU_k + U_k), fl(dV_k + V_k)) of the k-th neighbour as a float2
// and `weight(k)` its weight, in the order W, E, N, S, NW, NE, SW, SE; (fu,
// fv) are the pixel's own increments, (uc, vc) its frozen flow. The
// diffusion term is sum_k w_k (dU_k + U_k) - U_c sum w, each term added by
// one fma. The tile kernel (tiled_sor.cu) keeps the sums in shared memory.
template <class Sum, class Wt>
__device__ __forceinline__ float2 update_sums(Sum sum, Wt weight, float fu, float fv, float uc,
                                              float vc, float wsum, uint32_t flags, float m0,
                                              float cu0, float cv0, float inv_u, float inv_v,
                                              float omega, float one_minus_omega) {
  float su = 0.0f, sv = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float c = weight(k);
    const float2 f = sum(k);
    su = k == 0 ? __fmul_rn(f.x, c) : __fmaf_rn(f.x, c, su);
    sv = k == 0 ? __fmul_rn(f.y, c) : __fmaf_rn(f.y, c, sv);
  }
  su = __fmaf_rn(-uc, wsum, su);
  sv = __fmaf_rn(-vc, wsum, sv);
  const float num_u = (flags & 1) ? su : __fmaf_rn(-m0, fv, __fadd_rn(su, cu0));
  const float nu = __fmaf_rn(one_minus_omega, fu, __fmul_rn(__fmul_rn(omega, num_u), inv_u));
  const float num_v = (flags & 2) ? sv : __fmaf_rn(-m0, nu, __fadd_rn(sv, cv0));
  const float nv = __fmaf_rn(one_minus_omega, fv, __fmul_rn(__fmul_rn(omega, num_v), inv_v));
  return make_float2(nu, nv);
}

// The same from the neighbours' fields: `nbr(k)` gives the k-th neighbour's
// (dU, dV, U, V) as a float4, added here (fl(dU_k + U_k), fl(dV_k + V_k)).
template <class Nbr, class Wt>
__device__ __forceinline__ float2 update(Nbr nbr, Wt weight, float fu, float fv, float uc,
                                         float vc, float wsum, uint32_t flags, float m0,
                                         float cu0, float cv0, float inv_u, float inv_v,
                                         float omega, float one_minus_omega) {
  return update_sums(
      [&](int k) {
        const float4 n = nbr(k);
        return make_float2(__fadd_rn(n.x, n.z), __fadd_rn(n.y, n.w));
      },
      weight, fu, fv, uc, vc, wsum, flags, m0, cu0, cv0, inv_u, inv_v, omega, one_minus_omega);
}

}  // namespace flow_sor8
