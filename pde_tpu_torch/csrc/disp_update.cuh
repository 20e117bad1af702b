// The per-pixel arithmetic of the disparity llin4 red-black sweep, shared by
// the global colour kernel (interior_sor.cu) and the resident kernel
// (resident_sor.cu), so that both round alike. Every operation is rounded on
// its own in the order of the plain version, pde_tpu_torch/solvers/sor.py::
// sor_disp_llin4, so both kernels give the plain version's floats:
//   dU+ = (1-w) dU + w (sum_k w_k (dU_k + U_k) - U_c sum w + Cu) / (sum w + Du)
// NaN in Cu drops Cu (pure diffusion); NaN in Du drops it from the divisor.

#pragma once

#include <cfloat>

namespace disp_sor {

// No FMA contraction: each operation rounded alone, as the plain version's.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

// torch.nan_to_num: NaN -> 0, +-inf -> +-FLT_MAX
__device__ __forceinline__ float nan_to_num(float x) {
  if (isnan(x)) return 0.0f;
  if (isinf(x)) return x > 0.0f ? FLT_MAX : -FLT_MAX;
  return x;
}

// What the update of one pixel reads besides dU and U: the weights W, N, E,
// S, U_c sum w, the NaN-folded Cu with its NaN flag, and 1/(sum w + Du).
struct Coef {
  float a, b, c, d, uw, cu0, inv;
  bool cu_nan;
};

__device__ __forceinline__ Coef prepare(float ww, float wn, float we, float ws, float u_c,
                                        float cu, float duc) {
  Coef k;
  k.a = ww;
  k.b = wn;
  k.c = we;
  k.d = ws;
  const float wsum = add_rn(add_rn(add_rn(ww, wn), we), ws);
  k.uw = mul_rn(u_c, wsum);
  k.cu_nan = isnan(cu);
  k.cu0 = nan_to_num(cu);
  k.inv = div_rn(1.0f, add_rn(wsum, nan_to_num(duc)));
  return k;
}

// The new dU of a pixel from its own dU and its neighbours' dU and U, in the
// order W, E, N, S.
__device__ __forceinline__ float update(float du_c, float du_w, float u_w, float du_e, float u_e,
                                        float du_n, float u_n, float du_s, float u_s,
                                        const Coef& k, float omega, float one_minus_omega) {
  float s = mul_rn(add_rn(du_w, u_w), k.a);
  s = add_rn(s, mul_rn(add_rn(du_e, u_e), k.c));
  s = add_rn(s, mul_rn(add_rn(du_n, u_n), k.b));
  s = add_rn(s, mul_rn(add_rn(du_s, u_s), k.d));
  s = sub_rn(s, k.uw);
  const float num = k.cu_nan ? s : add_rn(s, k.cu0);
  return add_rn(mul_rn(one_minus_omega, du_c), mul_rn(mul_rn(omega, num), k.inv));
}

}  // namespace disp_sor
