// Red-black SOR sweeps of the coupled flow pair, 4-neighbour weights, in two
// linearisations:
//   * late (llin4): the increments (dU, dV) against the frozen flow (U, V),
//     the solve of every inner iteration of the warping flow
//     (models/flow_nd.py);
//   * early (elin4): (U, V) themselves, the solve of every pyramid level of
//     Horn-Schunck flow with solver=1 (models/flow_hs.py). It drops the
//     frozen-flow loads and the - U_c Σw term; all else is shared.
//
// Replaces the TPU kernels that compute these functions:
//   * pde_tpu/kernels/sor_pallas.py::_kernel (pallas_sor_flow_llin4), the
//     VMEM-resident llin4 kernel for levels that fit in VMEM;
//   * pde_tpu/kernels/tiled.py::_stripe_kernel driving
//     pde_tpu/kernels/sweeps.py::flow_llin4_sweep, the row-stripe engine
//     for larger levels, and driving sweeps.py::flow_elin4_sweep, the elin4
//     sweep (through kernels/dispatch.py::sor_flow_elin4).
// The card has no VMEM budget to split on, so one kernel takes every level.
// Its plain PyTorch versions are pde_tpu_torch/solvers/sor.py::
// sor_flow_llin4 and sor_flow_elin4.
//
// Design (simple and exact first):
//   * one prepare launch per call writes the edge-zeroed weights, their sum,
//     1/(sum + Du) and 1/(sum + Dv), the NaN-folded M, Cu and Cv with the NaN
//     flags of Cu and Cv, and copies the input increments to the outputs;
//   * then two launches per sweep, one per colour. One thread takes one
//     pixel of that colour, updates u, then v from the refreshed u, and sums
//     the neighbours in the JAX order W, E, N, S. A pixel's neighbours are all
//     of the other colour, so the in-place update has no race.
// What bounds it: about 13 float32 fields are read per pixel per sweep (the
// increments and the frozen flow at five points, ten coefficient fields)
// for ~30 flops, so it is bound by device-memory bandwidth, and each colour
// launch reads every other float of a row. Later work: temporal blocking,
// k sweeps per pass over a tile and its 2k halo held in shared memory (the
// tiled.py scheme), which reads the coefficients once per k sweeps.
//
// The kernels run on the caller's stream and allocate nothing. The C entry
// points return cudaGetLastError() of the launches.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Scratch { kWW, kWN, kWE, kWS, kWSUM, kINVU, kINVV, kM0, kCU0, kCV0, kNumScratch };

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ float nan_to_num(float x) {
  if (isnan(x)) return 0.0f;
  if (isinf(x)) return x > 0.0f ? FLT_MAX : -FLT_MAX;
  return x;
}

__global__ void prepare_kernel(const float* __restrict__ du_in, const float* __restrict__ dv_in,
                               const float* __restrict__ m, const float* __restrict__ cu,
                               const float* __restrict__ cv, const float* __restrict__ duc,
                               const float* __restrict__ dvc, const float* __restrict__ ww,
                               const float* __restrict__ wn, const float* __restrict__ we,
                               const float* __restrict__ ws, float* __restrict__ du,
                               float* __restrict__ dv, float* __restrict__ scratch,
                               uint8_t* __restrict__ flags, int h, int w) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= h || j >= w) return;
  const size_t n = static_cast<size_t>(h) * w;
  const size_t p = static_cast<size_t>(i) * w + j;

  // border-solving convention: out-facing weights zeroed at the image edge
  const float a = (j == 0) ? 0.0f : ww[p];
  const float b = (i == 0) ? 0.0f : wn[p];
  const float c = (j == w - 1) ? 0.0f : we[p];
  const float d = (i == h - 1) ? 0.0f : ws[p];
  const float wsum = ((a + b) + c) + d;
  const float cu_p = cu[p];
  const float cv_p = cv[p];

  scratch[kWW * n + p] = a;
  scratch[kWN * n + p] = b;
  scratch[kWE * n + p] = c;
  scratch[kWS * n + p] = d;
  scratch[kWSUM * n + p] = wsum;
  scratch[kINVU * n + p] = 1.0f / (wsum + nan_to_num(duc[p]));
  scratch[kINVV * n + p] = 1.0f / (wsum + nan_to_num(dvc[p]));
  scratch[kM0 * n + p] = nan_to_num(m[p]);
  scratch[kCU0 * n + p] = nan_to_num(cu_p);
  scratch[kCV0 * n + p] = nan_to_num(cv_p);
  flags[p] = static_cast<uint8_t>((isnan(cu_p) ? 1 : 0) | (isnan(cv_p) ? 2 : 0));
  du[p] = du_in[p];
  dv[p] = dv_in[p];
}

// kLate: llin4 (u, v are the frozen flow); else elin4 (u, v unused, du, dv
// are the flow itself).
template <bool kLate>
__global__ void sweep_kernel(const float* __restrict__ u, const float* __restrict__ v,
                             float* du, float* dv, const float* __restrict__ scratch,
                             const uint8_t* __restrict__ flags, int h, int w, int color,
                             float omega, float one_minus_omega) {
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int j = 2 * (blockIdx.x * blockDim.x + threadIdx.x) + ((i + color) & 1);
  if (i >= h || j >= w) return;
  const size_t n = static_cast<size_t>(h) * w;
  const size_t row = static_cast<size_t>(i) * w;
  const size_t p = row + j;
  // neighbour indices clamp at the edge (their weights are zero there)
  const size_t pw = row + (j > 0 ? j - 1 : 0);
  const size_t pe = row + (j < w - 1 ? j + 1 : w - 1);
  const size_t pn = static_cast<size_t>(i > 0 ? i - 1 : 0) * w + j;
  const size_t ps = static_cast<size_t>(i < h - 1 ? i + 1 : h - 1) * w + j;

  const float a = scratch[kWW * n + p];
  const float b = scratch[kWN * n + p];
  const float c = scratch[kWE * n + p];
  const float d = scratch[kWS * n + p];

  // late: Σ w_k (f_k + U_k) - U_c Σw; early: Σ w_k f_k; in the order W, E, N, S
  float su, sv;
  if (kLate) {
    const float wsum = scratch[kWSUM * n + p];
    su = ((((du[pw] + u[pw]) * a + (du[pe] + u[pe]) * c) + (du[pn] + u[pn]) * b) +
          (du[ps] + u[ps]) * d) - u[p] * wsum;
    sv = ((((dv[pw] + v[pw]) * a + (dv[pe] + v[pe]) * c) + (dv[pn] + v[pn]) * b) +
          (dv[ps] + v[ps]) * d) - v[p] * wsum;
  } else {
    su = ((du[pw] * a + du[pe] * c) + du[pn] * b) + du[ps] * d;
    sv = ((dv[pw] * a + dv[pe] * c) + dv[pn] * b) + dv[ps] * d;
  }

  const uint8_t f = flags[p];
  const float m0 = scratch[kM0 * n + p];
  const float fu = du[p];
  const float fv = dv[p];
  const float num_u = (f & 1) ? su : (su + scratch[kCU0 * n + p]) - m0 * fv;
  const float nu = one_minus_omega * fu + omega * num_u * scratch[kINVU * n + p];
  const float num_v = (f & 2) ? sv : (sv + scratch[kCV0 * n + p]) - m0 * nu;
  const float nv = one_minus_omega * fv + omega * num_v * scratch[kINVV * n + p];
  du[p] = nu;
  dv[p] = nv;
}

// The prepare launch and 2 * iters colour launches on `stream`; u, v are
// read by the late form only.
template <bool kLate>
int run_sor(const void* u, const void* v, const void* du, const void* dv, const void* m,
            const void* cu, const void* cv, const void* duc, const void* dvc, const void* ww,
            const void* wn, const void* we, const void* ws, void* du_out, void* dv_out,
            void* scratch, void* flags, int h, int w, int iters, float omega,
            float one_minus_omega, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid_all((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  const int half_w = (w + 1) / 2;
  const dim3 grid_half((half_w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);

  auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  float* dU = static_cast<float*>(du_out);
  float* dV = static_cast<float*>(dv_out);
  float* sc = static_cast<float*>(scratch);
  uint8_t* fl = static_cast<uint8_t*>(flags);

  prepare_kernel<<<grid_all, block, 0, s>>>(f(du), f(dv), f(m), f(cu), f(cv), f(duc), f(dvc),
                                            f(ww), f(wn), f(we), f(ws), dU, dV, sc, fl, h, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int it = 0; it < iters; ++it) {
    for (int color = 0; color < 2; ++color) {
      sweep_kernel<kLate><<<grid_half, block, 0, s>>>(f(u), f(v), dU, dV, sc, fl, h, w, color,
                                                      omega, one_minus_omega);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

extern "C" {

// Number of float32 (H, W) planes the caller allocates as `scratch`.
int flow_llin4_sor_scratch_planes() { return kNumScratch; }

// All pointers are contiguous (H, W) arrays on the current device: float32,
// except `flags`, uint8. du_out/dv_out receive du/dv after `iters` sweeps.
// Launches 1 + 2 * iters kernels on `stream`.
int flow_llin4_sor(const void* u, const void* v, const void* du, const void* dv, const void* m,
                   const void* cu, const void* cv, const void* duc, const void* dvc,
                   const void* ww, const void* wn, const void* we, const void* ws,
                   void* du_out, void* dv_out, void* scratch, void* flags, int h, int w,
                   int iters, float omega, float one_minus_omega, void* stream) {
  return run_sor<true>(u, v, du, dv, m, cu, cv, duc, dvc, ww, wn, we, ws, du_out, dv_out,
                       scratch, flags, h, w, iters, omega, one_minus_omega, stream);
}

// The early form: u, v are the flow, relaxed into u_out/v_out. The same
// pointers and launches as flow_llin4_sor, without the frozen flow.
int flow_elin4_sor(const void* u, const void* v, const void* m, const void* cu, const void* cv,
                   const void* duc, const void* dvc, const void* ww, const void* wn,
                   const void* we, const void* ws, void* u_out, void* v_out, void* scratch,
                   void* flags, int h, int w, int iters, float omega, float one_minus_omega,
                   void* stream) {
  return run_sor<false>(nullptr, nullptr, u, v, m, cu, cv, duc, dvc, ww, wn, we, ws, u_out,
                        v_out, scratch, flags, h, w, iters, omega, one_minus_omega, stream);
}

const char* flow_llin4_sor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
