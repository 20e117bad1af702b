// Red-black SOR sweeps of the coupled flow pair, in three forms:
//   * late (llin4): the increments (dU, dV) against the frozen flow (U, V),
//     4-neighbour weights, the solve of every inner iteration of the
//     warping flow (models/flow_nd.py);
//   * early (elin4): (U, V) themselves, the solve of every pyramid level of
//     Horn-Schunck flow with solver=1 (models/flow_hs.py). It drops the
//     frozen-flow loads and the - U_c Σw term; all else is shared;
//   * late with the 8-neighbour anisotropic tensor stencil (llin8), the
//     solve of models/flow_ad.py: weights W, NW, N, NE, E, SE, S, SW, the
//     diagonal ones negative where the image gradient is oblique. Since the
//     resident kernel (resident8_sor.cu) takes every llin8 solve whose shape
//     has a resident plan, these kernels serve only the shapes without one
//     (a level above one band an SM, such as 1024x1024).
//
// Replaces the TPU kernels that compute these functions:
//   * pde_tpu/kernels/sor_pallas.py::_kernel (pallas_sor_flow_llin4), the
//     VMEM-resident llin4 kernel for levels that fit in VMEM;
//   * pde_tpu/kernels/tiled.py::_stripe_kernel driving
//     pde_tpu/kernels/sweeps.py::flow_llin4_sweep, the row-stripe engine
//     for larger levels, driving sweeps.py::flow_elin4_sweep, the elin4
//     sweep (through kernels/dispatch.py::sor_flow_elin4), and driving
//     sweeps.py::flow_llin8_sweep (through dispatch.py::sor_flow_llin8).
// The llin4 and elin4 solves of a shape with a resident plan run on
// resident_sor.cu, the llin8 ones on resident8_sor.cu, and those of a
// larger shape on the tile kernel (tiled_sor.cu); these kernels take the
// shapes neither plans (a batch, which the flow solvers never hand over).
// Its plain PyTorch versions are pde_tpu_torch/solvers/sor.py::
// sor_flow_llin4, sor_flow_elin4 and sor_flow_llin8.
//
// Design (simple and exact first):
//   * one prepare launch per call writes the edge-zeroed weights, their sum,
//     1/(sum + Du) and 1/(sum + Dv), the NaN-folded M, Cu and Cv with the NaN
//     flags of Cu and Cv, and copies the input increments to the outputs;
//   * then two launches per sweep, one per colour. One thread takes one
//     pixel of that colour, updates u, then v from the refreshed u, and sums
//     the neighbours in the JAX order W, E, N, S. A pixel's neighbours are all
//     of the other colour, so the in-place update has no race.
//
// llin8 (the second half of this file): a diagonal neighbour (i±1, j±1) has
// the pixel's own colour, and the plain version computes a whole colour
// from the state before that half-sweep (Jacobi within a colour). An
// in-place update would read a mix of old and new diagonal values, which
// differs from the plain version and from run to run. So each colour launch
// reads one buffer pair (dU, dV) and writes every pixel of the other: the
// pixels of its colour updated, the rest copied. The two colour launches of
// a sweep go out -> tmp -> out, so after each sweep the state is back in
// the output; no thread writes what another reads. The v-update still uses
// the refreshed u of its own pixel only. The prepare launch writes the
// eight edge-zeroed weights (a diagonal one zeroed where its neighbour is
// off the image), their sum in the plain order W, NW, N, NE, E, SE, S, SW,
// 1/(sum + Du), 1/(sum + Dv), M0, Cu0, Cv0 and the NaN flags: 14 planes,
// plus the two of tmp. Launches: 1 + 2 * iters, as llin4. The per-pixel
// arithmetic is flow8_update.cuh's, shared with the resident kernel, so the
// two give the same bits.
//
// What bounds it: about 13 float32 fields are read per pixel per sweep (the
// increments and the frozen flow at five points, ten coefficient fields)
// for ~30 flops, so it is bound by device-memory bandwidth, and each colour
// launch reads every other float of a row. llin8 reads ~17 fields per pixel
// per colour launch (the increments and frozen flow at nine points, mostly
// from cache, 14 coefficient planes and the flags) for ~64 flops a relaxed
// pixel and writes every pixel: bytes again, about twice llin4's per sweep.
// Temporal blocking, k sweeps per pass over a tile and its 2k halo held in
// shared memory, is csrc/tiled_sor.cu, which shares this file's llin4 and
// elin4 arithmetic (flow_update.cuh).
//
// The kernels run on the caller's stream and allocate nothing. The C entry
// points return cudaGetLastError() of the launches.

#include <cstdint>
#include <cuda_runtime.h>

#include "flow8_update.cuh"
#include "flow_update.cuh"

namespace {

enum Scratch { kWW, kWN, kWE, kWS, kWSUM, kINVU, kINVV, kM0, kCU0, kCV0, kNumScratch };
// llin8: the coefficient planes, then the two planes of the (dU, dV) buffer
// the colour launches alternate with
enum Scratch8 {
  k8WW, k8WNW, k8WN, k8WNE, k8WE, k8WSE, k8WS, k8WSW, k8WSUM, k8INVU, k8INVV, k8M0, k8CU0,
  k8CV0, k8TMPU, k8TMPV, kNumScratch8
};

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

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

  const flow_sor::Coef k = flow_sor::prepare(i, j, h, w, ww[p], wn[p], we[p], ws[p], m[p], cu[p],
                                             cv[p], duc[p], dvc[p]);
  scratch[kWW * n + p] = k.a;
  scratch[kWN * n + p] = k.b;
  scratch[kWE * n + p] = k.c;
  scratch[kWS * n + p] = k.d;
  scratch[kWSUM * n + p] = k.wsum;
  scratch[kINVU * n + p] = k.inv_u;
  scratch[kINVV * n + p] = k.inv_v;
  scratch[kM0 * n + p] = k.m0;
  scratch[kCU0 * n + p] = k.cu0;
  scratch[kCV0 * n + p] = k.cv0;
  flags[p] = k.flags;
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

  const flow_sor::Nbr fu_n{du[pw], du[pe], du[pn], du[ps]};
  const flow_sor::Nbr fv_n{dv[pw], dv[pe], dv[pn], dv[ps]};
  float su, sv;
  if (kLate) {
    const float wsum = scratch[kWSUM * n + p];
    su = flow_sor::diffusion<true>(fu_n, {u[pw], u[pe], u[pn], u[ps]}, u[p], a, b, c, d, wsum);
    sv = flow_sor::diffusion<true>(fv_n, {v[pw], v[pe], v[pn], v[ps]}, v[p], a, b, c, d, wsum);
  } else {
    su = flow_sor::diffusion<false>(fu_n, fu_n, 0.0f, a, b, c, d, 0.0f);
    sv = flow_sor::diffusion<false>(fv_n, fv_n, 0.0f, a, b, c, d, 0.0f);
  }
  const float2 r = flow_sor::update(du[p], dv[p], su, sv, flags[p], scratch[kM0 * n + p],
                                    scratch[kCU0 * n + p], scratch[kCV0 * n + p],
                                    scratch[kINVU * n + p], scratch[kINVV * n + p], omega,
                                    one_minus_omega);
  du[p] = r.x;
  dv[p] = r.y;
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

// ---- llin8 ----------------------------------------------------------------

struct Weights8 {
  const float *ww, *wnw, *wn, *wne, *we, *wse, *ws, *wsw;
};

__global__ void prepare8_kernel(const float* __restrict__ du_in, const float* __restrict__ dv_in,
                                const float* __restrict__ m, const float* __restrict__ cu,
                                const float* __restrict__ cv, const float* __restrict__ duc,
                                const float* __restrict__ dvc, Weights8 wt,
                                float* __restrict__ du, float* __restrict__ dv,
                                float* __restrict__ scratch, uint8_t* __restrict__ flags, int h,
                                int w) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= h || j >= w) return;
  const size_t n = static_cast<size_t>(h) * w;
  const size_t p = static_cast<size_t>(i) * w + j;
  const flow_sor8::Coef k =
      flow_sor8::prepare(i, j, h, w, wt.ww[p], wt.wnw[p], wt.wn[p], wt.wne[p], wt.we[p],
                         wt.wse[p], wt.ws[p], wt.wsw[p], m[p], cu[p], cv[p], duc[p], dvc[p]);
#pragma unroll
  for (int q = 0; q < 8; ++q) scratch[(k8WW + q) * n + p] = k.c[q];
  scratch[k8WSUM * n + p] = k.wsum;
  scratch[k8INVU * n + p] = k.inv_u;
  scratch[k8INVV * n + p] = k.inv_v;
  scratch[k8M0 * n + p] = k.m0;
  scratch[k8CU0 * n + p] = k.cu0;
  scratch[k8CV0 * n + p] = k.cv0;
  flags[p] = k.flags;
  du[p] = du_in[p];
  dv[p] = dv_in[p];
}

// One colour of one sweep: reads (du_a, dv_a), writes every pixel of
// (du_b, dv_b). One thread per pixel; a pixel of the other colour is copied.
__global__ void sweep8_kernel(const float* __restrict__ u, const float* __restrict__ v,
                              const float* __restrict__ du_a, const float* __restrict__ dv_a,
                              float* __restrict__ du_b, float* __restrict__ dv_b,
                              const float* __restrict__ scratch,
                              const uint8_t* __restrict__ flags, int h, int w, int color,
                              float omega, float one_minus_omega) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= h || j >= w) return;
  const size_t n = static_cast<size_t>(h) * w;
  const size_t p = static_cast<size_t>(i) * w + j;
  const float fu = du_a[p];
  const float fv = dv_a[p];
  if (((i + j) & 1) != color) {
    du_b[p] = fu;
    dv_b[p] = fv;
    return;
  }
  auto nbr = [&](int k) {
    int ni, nj;
    flow_sor8::neighbour(k, i, j, h, w, &ni, &nj);
    const size_t q = static_cast<size_t>(ni) * w + nj;
    return make_float4(du_a[q], dv_a[q], u[q], v[q]);
  };
  auto weight = [&](int k) { return scratch[(k8WW + flow_sor8::weight_of(k)) * n + p]; };
  const float2 r = flow_sor8::update(nbr, weight, fu, fv, u[p], v[p], scratch[k8WSUM * n + p],
                                     flags[p], scratch[k8M0 * n + p], scratch[k8CU0 * n + p],
                                     scratch[k8CV0 * n + p], scratch[k8INVU * n + p],
                                     scratch[k8INVV * n + p], omega, one_minus_omega);
  du_b[p] = r.x;
  dv_b[p] = r.y;
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

// Number of float32 (H, W) planes the caller allocates as flow_llin8_sor's
// `scratch`.
int flow_llin8_sor_scratch_planes() { return kNumScratch8; }

// The 8-neighbour form: as flow_llin4_sor with the weights W, NW, N, NE, E,
// SE, S, SW. Launches 1 + 2 * iters kernels on `stream`.
int flow_llin8_sor(const void* u, const void* v, const void* du, const void* dv, const void* m,
                   const void* cu, const void* cv, const void* duc, const void* dvc,
                   const void* ww, const void* wnw, const void* wn, const void* wne,
                   const void* we, const void* wse, const void* ws, const void* wsw,
                   void* du_out, void* dv_out, void* scratch, void* flags, int h, int w,
                   int iters, float omega, float one_minus_omega, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  const size_t n = static_cast<size_t>(h) * w;
  float* sc = static_cast<float*>(scratch);
  uint8_t* fl = static_cast<uint8_t*>(flags);
  float* out_u = static_cast<float*>(du_out);
  float* out_v = static_cast<float*>(dv_out);
  float* tmp_u = sc + k8TMPU * n;
  float* tmp_v = sc + k8TMPV * n;
  const Weights8 wt{f(ww), f(wnw), f(wn), f(wne), f(we), f(wse), f(ws), f(wsw)};

  prepare8_kernel<<<grid, block, 0, s>>>(f(du), f(dv), f(m), f(cu), f(cv), f(duc), f(dvc), wt,
                                         out_u, out_v, sc, fl, h, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int it = 0; it < iters; ++it) {
    // colour 0: out -> tmp; colour 1: tmp -> out
    sweep8_kernel<<<grid, block, 0, s>>>(f(u), f(v), out_u, out_v, tmp_u, tmp_v, sc, fl, h, w,
                                         0, omega, one_minus_omega);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sweep8_kernel<<<grid, block, 0, s>>>(f(u), f(v), tmp_u, tmp_v, out_u, out_v, sc, fl, h, w,
                                         1, omega, one_minus_omega);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

const char* flow_llin4_sor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
