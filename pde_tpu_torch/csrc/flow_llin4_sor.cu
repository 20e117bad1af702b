// Red-black SOR sweeps of the coupled flow pair, in three forms:
//   * late (llin4): the increments (dU, dV) against the frozen flow (U, V),
//     4-neighbour weights, the solve of every inner iteration of the
//     warping flow (models/flow_nd.py);
//   * early (elin4): (U, V) themselves, the solve of every pyramid level of
//     Horn-Schunck flow with solver=1 (models/flow_hs.py). It drops the
//     frozen-flow loads and the - U_c Σw term; all else is shared;
//   * late with the 8-neighbour anisotropic tensor stencil (llin8), the
//     solve of models/flow_ad.py: weights W, NW, N, NE, E, SE, S, SW, the
//     diagonal ones negative where the image gradient is oblique.
//
// Replaces the TPU kernels that compute these functions:
//   * pde_tpu/kernels/sor_pallas.py::_kernel (pallas_sor_flow_llin4), the
//     VMEM-resident llin4 kernel for levels that fit in VMEM;
//   * pde_tpu/kernels/tiled.py::_stripe_kernel driving
//     pde_tpu/kernels/sweeps.py::flow_llin4_sweep, the row-stripe engine
//     for larger levels, driving sweeps.py::flow_elin4_sweep, the elin4
//     sweep (through kernels/dispatch.py::sor_flow_elin4), and driving
//     sweeps.py::flow_llin8_sweep (through dispatch.py::sor_flow_llin8).
// The card has no VMEM budget to split on, so one kernel takes every level.
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
// plus the two of tmp. Launches: 1 + 2 * iters, as llin4.
//
// What bounds it: about 13 float32 fields are read per pixel per sweep (the
// increments and the frozen flow at five points, ten coefficient fields)
// for ~30 flops, so it is bound by device-memory bandwidth, and each colour
// launch reads every other float of a row. llin8 reads ~17 fields per pixel
// per colour launch (the increments and frozen flow at nine points, mostly
// from cache, 14 coefficient planes and the flags) for ~64 flops a relaxed
// pixel and writes every pixel: bytes again, about twice llin4's per sweep.
// Later work: temporal blocking, k sweeps per pass over a tile and its 2k
// halo held in shared memory (the tiled.py scheme), which reads the
// coefficients once per k sweeps.
//
// The kernels run on the caller's stream and allocate nothing. The C entry
// points return cudaGetLastError() of the launches.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

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
  const bool top = i == 0, bottom = i == h - 1, left = j == 0, right = j == w - 1;

  // a weight is zeroed where its neighbour is off the image
  float c[8];
  c[0] = left ? 0.0f : wt.ww[p];
  c[1] = (top || left) ? 0.0f : wt.wnw[p];
  c[2] = top ? 0.0f : wt.wn[p];
  c[3] = (top || right) ? 0.0f : wt.wne[p];
  c[4] = right ? 0.0f : wt.we[p];
  c[5] = (bottom || right) ? 0.0f : wt.wse[p];
  c[6] = bottom ? 0.0f : wt.ws[p];
  c[7] = (bottom || left) ? 0.0f : wt.wsw[p];
  float wsum = c[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) wsum += c[k];  // the plain order W, NW, N, NE, E, SE, S, SW
#pragma unroll
  for (int k = 0; k < 8; ++k) scratch[(k8WW + k) * n + p] = c[k];
  const float cu_p = cu[p];
  const float cv_p = cv[p];
  scratch[k8WSUM * n + p] = wsum;
  scratch[k8INVU * n + p] = 1.0f / (wsum + nan_to_num(duc[p]));
  scratch[k8INVV * n + p] = 1.0f / (wsum + nan_to_num(dvc[p]));
  scratch[k8M0 * n + p] = nan_to_num(m[p]);
  scratch[k8CU0 * n + p] = nan_to_num(cu_p);
  scratch[k8CV0 * n + p] = nan_to_num(cv_p);
  flags[p] = static_cast<uint8_t>((isnan(cu_p) ? 1 : 0) | (isnan(cv_p) ? 2 : 0));
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
  // neighbour indices clamp at the edge (their weights are zero there)
  const size_t rn = static_cast<size_t>(i > 0 ? i - 1 : 0) * w;
  const size_t rc = static_cast<size_t>(i) * w;
  const size_t rs = static_cast<size_t>(i < h - 1 ? i + 1 : h - 1) * w;
  const int jw = j > 0 ? j - 1 : 0;
  const int je = j < w - 1 ? j + 1 : w - 1;
  // the plain neighbour order W, E, N, S, NW, NE, SW, SE with their weights
  const size_t q[8] = {rc + jw, rc + je, rn + j, rs + j, rn + jw, rn + je, rs + jw, rs + je};
  const int wk[8] = {k8WW, k8WE, k8WN, k8WS, k8WNW, k8WNE, k8WSW, k8WSE};

  // Σ w_k (df_k + f_k) - f_c Σw
  float su = 0.0f, sv = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float c = scratch[wk[k] * n + p];
    const float tu = (du_a[q[k]] + u[q[k]]) * c;
    const float tv = (dv_a[q[k]] + v[q[k]]) * c;
    su = k == 0 ? tu : su + tu;
    sv = k == 0 ? tv : sv + tv;
  }
  const float wsum = scratch[k8WSUM * n + p];
  su -= u[p] * wsum;
  sv -= v[p] * wsum;

  const uint8_t f = flags[p];
  const float m0 = scratch[k8M0 * n + p];
  const float num_u = (f & 1) ? su : (su + scratch[k8CU0 * n + p]) - m0 * fv;
  const float nu = one_minus_omega * fu + omega * num_u * scratch[k8INVU * n + p];
  const float num_v = (f & 2) ? sv : (sv + scratch[k8CV0 * n + p]) - m0 * nu;
  const float nv = one_minus_omega * fv + omega * num_v * scratch[k8INVV * n + p];
  du_b[p] = nu;
  dv_b[p] = nv;
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
