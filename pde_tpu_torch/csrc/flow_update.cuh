// The per-pixel arithmetic of the coupled-flow red-black sweeps (llin4 and
// elin4), shared by the global kernels (flow_llin4_sor.cu) and the tile
// kernel (tiled_sor.cu), so that both round alike. Every expression is in
// the order of the plain version, pde_tpu_torch/solvers/sor.py::
// flow_coefficients and flow_half_sweep.

#pragma once

#include <cfloat>
#include <cstdint>

namespace flow_sor {

// torch.nan_to_num: NaN -> 0, +-inf -> +-FLT_MAX
__device__ __forceinline__ float nan_to_num(float x) {
  if (isnan(x)) return 0.0f;
  if (isinf(x)) return x > 0.0f ? FLT_MAX : -FLT_MAX;
  return x;
}

// What the update of one pixel reads besides the fields: the edge-zeroed
// weights W, N, E, S, their sum, 1/(sum + Du), 1/(sum + Dv), the NaN-folded
// M, Cu, Cv, and the NaN flags of Cu (bit 0) and Cv (bit 1).
struct Coef {
  float a, b, c, d, wsum, inv_u, inv_v, m0, cu0, cv0;
  uint8_t flags;
};

// The coefficients at pixel (i, j) of an h x w image. Border-solving
// convention: the out-facing weights are zeroed at the image edge.
__device__ __forceinline__ Coef prepare(int i, int j, int h, int w, float ww, float wn, float we,
                                        float ws, float m, float cu, float cv, float duc,
                                        float dvc) {
  Coef k;
  k.a = (j == 0) ? 0.0f : ww;
  k.b = (i == 0) ? 0.0f : wn;
  k.c = (j == w - 1) ? 0.0f : we;
  k.d = (i == h - 1) ? 0.0f : ws;
  k.wsum = ((k.a + k.b) + k.c) + k.d;
  k.inv_u = 1.0f / (k.wsum + nan_to_num(duc));
  k.inv_v = 1.0f / (k.wsum + nan_to_num(dvc));
  k.m0 = nan_to_num(m);
  k.cu0 = nan_to_num(cu);
  k.cv0 = nan_to_num(cv);
  k.flags = static_cast<uint8_t>((isnan(cu) ? 1 : 0) | (isnan(cv) ? 2 : 0));
  return k;
}

// The four neighbours of a pixel, W, E, N, S (clamped at the image edge,
// where their weights are zero).
struct Nbr {
  float w, e, n, s;
};

// The diffusion term, summed W, E, N, S. Late (kLate): Σ w_k (f_k + g_k) -
// g_c Σw, f the increment and g the frozen flow; early: Σ w_k f_k, g unused.
template <bool kLate>
__device__ __forceinline__ float diffusion(const Nbr& f, const Nbr& g, float g_c, float a, float b,
                                           float c, float d, float wsum) {
  if (kLate) {
    return ((((f.w + g.w) * a + (f.e + g.e) * c) + (f.n + g.n) * b) + (f.s + g.s) * d) -
           g_c * wsum;
  }
  return ((f.w * a + f.e * c) + f.n * b) + f.s * d;
}

// The update of one pixel from its diffusion terms su, sv: u first, then v
// from the refreshed u. A NaN Cu (Cv) drops the data term.
__device__ __forceinline__ float2 update(float fu, float fv, float su, float sv, uint8_t flags,
                                         float m0, float cu0, float cv0, float inv_u, float inv_v,
                                         float omega, float one_minus_omega) {
  const float num_u = (flags & 1) ? su : (su + cu0) - m0 * fv;
  const float nu = one_minus_omega * fu + omega * num_u * inv_u;
  const float num_v = (flags & 2) ? sv : (sv + cv0) - m0 * nu;
  const float nv = one_minus_omega * fv + omega * num_v * inv_v;
  return make_float2(nu, nv);
}

}  // namespace flow_sor
