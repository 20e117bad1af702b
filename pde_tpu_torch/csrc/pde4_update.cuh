// The per-pixel arithmetic of the 4-neighbour diagonal-form red-black sweep
// (pde4), shared by the global colour kernel (interior_sor.cu) and the
// resident kernel (resident_sor.cu), so that both round alike. Every
// operation is rounded on its own in the order of the plain version,
// pde_tpu_torch/solvers/sor.py::sor_pde4, so both kernels give the plain
// version's floats:
//   X+ = (1-w) X + w (B + sum_k w_k X_k) / TRACE,
// the weights summed W, N, E, S, the neighbours W, E, N, S; where TRACE is
// NaN the pixel diffuses purely, 1/TRACE -> 1/sum w and B -> 0.

#pragma once

#include "disp_update.cuh"

namespace pde4_sor {

using disp_sor::add_rn;
using disp_sor::div_rn;
using disp_sor::mul_rn;
using disp_sor::nan_to_num;

// The four weights of a pixel.
struct Weights {
  float w, n, e, s;
};

// sum w in the plain order W, N, E, S
__device__ __forceinline__ float weight_sum(const Weights& k) {
  return add_rn(add_rn(add_rn(k.w, k.n), k.e), k.s);
}

// 1/TRACE (1/sum w where TRACE is NaN) and the B that enters (0 there).
__device__ __forceinline__ float2 diagonal(float trace, float b, float wsum) {
  const bool t_nan = isnan(trace);
  return make_float2(div_rn(1.0f, t_nan ? wsum : nan_to_num(trace)), t_nan ? 0.0f : b);
}

// The new X of a pixel from its own, its neighbours' (W, E, N, S) and
// (1/TRACE, B).
__device__ __forceinline__ float update(float xc, float xw, float xe, float xn, float xs,
                                        const Weights& k, float2 inv_b, float omega,
                                        float one_minus_omega) {
  float nbr = mul_rn(xw, k.w);
  nbr = add_rn(nbr, mul_rn(xe, k.e));
  nbr = add_rn(nbr, mul_rn(xn, k.n));
  nbr = add_rn(nbr, mul_rn(xs, k.s));
  const float nx = mul_rn(add_rn(inv_b.y, nbr), inv_b.x);
  return add_rn(mul_rn(one_minus_omega, xc), mul_rn(omega, nx));
}

}  // namespace pde4_sor
