// The per-pixel arithmetic of the 8-neighbour diagonal-form red-black sweep
// (pde8), shared by the global colour kernel (interior_sor.cu) and the
// resident kernel (resident8_sor.cu), so that both round alike. Every
// operation is rounded on its own in the order of the plain version,
// pde_tpu_torch/solvers/sor.py::sor_pde8, so both kernels give the plain
// version's floats:
//   X+ = (1-w) X + w (B + sum_k w_k X_k) / TRACE,
// the weights summed W, NW, N, NE, E, SE, S, SW, the neighbours W, E, N,
// S, NW, NE, SW, SE; where TRACE is NaN the pixel diffuses purely,
// 1/TRACE -> 1/sum w and B -> 0.

#pragma once

#include "disp_update.cuh"

namespace pde8_sor {

using disp_sor::add_rn;
using disp_sor::div_rn;
using disp_sor::mul_rn;
using disp_sor::nan_to_num;

// The eight weights of a pixel in the plain sum order W, NW, N, NE, E, SE,
// S, SW.
struct Weights {
  float w, nw, n, ne, e, se, s, sw;
};

__device__ __forceinline__ float weight_sum(const Weights& k) {
  float wsum = add_rn(add_rn(add_rn(k.w, k.nw), k.n), k.ne);
  return add_rn(add_rn(add_rn(add_rn(wsum, k.e), k.se), k.s), k.sw);
}

// 1/TRACE (1/sum w where TRACE is NaN) and the B that enters (0 there).
__device__ __forceinline__ float2 diagonal(float trace, float b, float wsum) {
  const bool t_nan = isnan(trace);
  return make_float2(div_rn(1.0f, t_nan ? wsum : nan_to_num(trace)), t_nan ? 0.0f : b);
}

// The neighbours' X of a pixel.
struct Nbr {
  float w, e, n, s, nw, ne, sw, se;
};

// The new X of a pixel from its own, its neighbours' and (1/TRACE, B).
__device__ __forceinline__ float update(float xc, const Nbr& x, const Weights& k, float2 inv_b,
                                        float omega, float one_minus_omega) {
  // sum_k w_k X_k in the order W, E, N, S, NW, NE, SW, SE
  float nbr = mul_rn(x.w, k.w);
  nbr = add_rn(nbr, mul_rn(x.e, k.e));
  nbr = add_rn(nbr, mul_rn(x.n, k.n));
  nbr = add_rn(nbr, mul_rn(x.s, k.s));
  nbr = add_rn(nbr, mul_rn(x.nw, k.nw));
  nbr = add_rn(nbr, mul_rn(x.ne, k.ne));
  nbr = add_rn(nbr, mul_rn(x.sw, k.sw));
  nbr = add_rn(nbr, mul_rn(x.se, k.se));
  const float nx = mul_rn(add_rn(inv_b.y, nbr), inv_b.x);
  return add_rn(mul_rn(one_minus_omega, xc), mul_rn(omega, nx));
}

}  // namespace pde8_sor
