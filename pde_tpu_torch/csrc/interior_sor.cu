// Red-black SOR sweeps of the interior-update family: only interior pixels
// are relaxed, colour 0 then colour 1, and the 1-px border is replicated
// after every sweep. Three systems share the source:
//   * disp llin4: the scalar late-linearised disparity increment dU
//     against the frozen U (models/disparity.py, and the symmetric pair of
//     models/disparity_sym.py as one batch of 2);
//       dU+ = (1-w) dU + w (sum_k w_k (dU_k + U_k) - U_c sum w + Cu) / (sum w + Du)
//     NaN in Cu drops Cu (pure diffusion); NaN in Du drops it from the divisor.
//   * pde4: the diagonal form X+ = (1-w) X + w (B + sum_k w_k X_k) / TRACE
//     over a batch of channels (models/tv_denoise.py); where TRACE is NaN
//     the pixel diffuses purely, 1/TRACE -> 1/sum w and B -> 0;
//   * pde8: the same diagonal form with the 8-neighbour anisotropic tensor
//     stencil W, NW, N, NE, E, SE, S, SW (tv_denoise8); the diagonal
//     weights are negative where the image gradient is oblique.
//
// Replaces the TPU kernel pde_tpu/kernels/tiled.py::_stripe_kernel
// (tiled.py:113) driving pde_tpu/kernels/sweeps.py::disp_llin4_sweep,
// ::pde4_sweep and ::pde8_sweep. Plain PyTorch versions:
// pde_tpu_torch/solvers/sor.py ::sor_disp_llin4, ::sor_disp_llin_sym4,
// ::sor_pde4 and ::sor_pde8.
//
// Design (simple and exact first):
//   * the wrapper copies the unknown into the output (cudaMemcpyAsync);
//   * each sweep is three launches on the caller's stream, in Gauss-Seidel
//     order: colour 0, colour 1, border fill. In disp and pde4 one thread
//     takes one interior pixel of the colour and sums its neighbours in the
//     order of the plain version, W, E, N, S. A pixel's four neighbours are
//     all of the other colour or on the border, so the in-place update has
//     no race (pde8, whose diagonal neighbours share the colour, below). The border
//     fill has its own launch: in the colour-1 launch it would race with
//     the writes to rows and columns 1 and H-2 / W-2 that it copies.
//   * no prepare launch and no scratch: sum w, 1/(sum w + Du) and the NaN
//     tests are recomputed in each colour launch from the inputs
//     themselves. A folded plane (1/divisor, NaN-free Cu) would replace
//     exactly one input plane read per sweep, so folding would save no
//     byte; recomputing gives the same floats as folding once.
//     Cu's NaN flag is read from Cu itself, one test per pixel.
//   * a batch dimension (blockIdx.z) takes independent systems: the
//     symmetric disparity pair is one call with B = 2, and pde4 takes C
//     channels. A coefficient plane with batch stride 0 is shared by the
//     whole batch (tv_denoise4's (H, W) weights).
// What bounds it: bytes. A disp sweep reads 8 float32 planes (U, dU, Cu,
// Du, four weights) and writes dU, about 36 B/px, for ~25 flops; pde4
// reads X, TRACE, B and the weights, pde8 eight weights and writes every
// pixel of a colour launch. Each 4-neighbour colour launch reads every other
// float of a row, so it moves whole sectors for half their use. The disp and
// pde4 solves of every shape with a resident plan run on the resident kernel
// instead (resident_sor.cu: one launch a call, the level on chip, the border
// filled once at the end, since a filled border neighbour of an interior
// pixel holds that pixel's own value; the per-pixel arithmetic is
// disp_update.cuh's and pde4_update.cuh's, so the two give the same bits).
// These launches serve only the shapes without a plan: H or W of 2, a batch
// of more than 2 (disp) or 3 (pde4) systems, pde4 weights per channel, or a
// level above one band an SM (such as 1024x1024).
//
// pde8: a diagonal neighbour (i±1, j±1) has the pixel's own colour, and
// the plain version computes a whole colour from the state before that
// half-sweep (Jacobi within a colour), so an in-place update would race.
// Each colour launch reads one buffer and writes every pixel of the other:
// interior pixels of its colour updated, all others copied. Colour 0 goes
// out -> tmp, colour 1 tmp -> out, and the border fill runs on out, so the
// launches stay 3 per sweep and the state is back in the output after
// each; the caller gives the tmp buffer. The weights' sum is taken in the
// plain order W, NW, N, NE, E, SE, S, SW, the neighbours W, E, N, S, NW,
// NE, SW, SE; the per-pixel arithmetic is pde8_update.cuh's, shared with
// the resident kernel (resident8_sor.cu), which takes every pde8 solve whose
// shape has a resident plan, and the tile kernel (tiled_sor.cu) every
// larger one it plans: these launches serve only the shapes neither takes
// (H or W of 2, a batch of more than 3 channels, weights per channel).
//
// The kernels allocate nothing. The C entry points return
// cudaGetLastError() after the copy and each launch.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "disp_update.cuh"
#include "pde4_update.cuh"
#include "pde8_update.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kBorderThreads = 256;

// Each operation rounded on its own, in the plain version's order: no FMA
// contraction, so on the card the kernels give the plain version's floats.
// tv_denoise4 needs that: where u == f its PsiData is ~6.7e7, and over its
// outer iterations an ulp of difference grows into a visible one. The
// per-pixel updates live in disp_update.cuh, pde4_update.cuh and
// pde8_update.cuh, which the resident kernels (resident_sor.cu,
// resident8_sor.cu) share.

// The interior pixel of colour `color` this thread takes, or false. Threads
// map to (row, every other column) so that a warp covers 64 columns.
__device__ __forceinline__ bool interior_pixel(int h, int w, int color, int* i, int* j) {
  *i = blockIdx.y * blockDim.y + threadIdx.y;
  *j = 2 * (blockIdx.x * blockDim.x + threadIdx.x) + ((*i + color) & 1);
  return *i >= 1 && *i <= h - 2 && *j >= 1 && *j <= w - 2;
}

__global__ void disp_color_kernel(const float* __restrict__ u, float* du,
                                  const float* __restrict__ cu,
                                  const float* __restrict__ duc,
                                  const float* __restrict__ ww,
                                  const float* __restrict__ wn,
                                  const float* __restrict__ we,
                                  const float* __restrict__ ws, int h, int w, int color,
                                  float omega, float one_minus_omega) {
  int i, j;
  if (!interior_pixel(h, w, color, &i, &j)) return;
  const size_t base = static_cast<size_t>(blockIdx.z) * h * w;
  const size_t p = base + static_cast<size_t>(i) * w + j;
  const size_t pw = p - 1, pe = p + 1, pn = p - w, ps = p + w;

  const disp_sor::Coef k = disp_sor::prepare(ww[p], wn[p], we[p], ws[p], u[p], cu[p], duc[p]);
  du[p] = disp_sor::update(du[p], du[pw], u[pw], du[pe], u[pe], du[pn], u[pn], du[ps], u[ps], k,
                           omega, one_minus_omega);
}

__global__ void pde4_color_kernel(float* x, const float* __restrict__ trace,
                                  const float* __restrict__ bb,
                                  const float* __restrict__ ww,
                                  const float* __restrict__ wn,
                                  const float* __restrict__ we,
                                  const float* __restrict__ ws, int64_t trace_stride,
                                  int64_t b_stride, int64_t w_stride, int h, int w,
                                  int color, float omega, float one_minus_omega) {
  int i, j;
  if (!interior_pixel(h, w, color, &i, &j)) return;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t q = static_cast<size_t>(i) * w + j;  // offset inside a plane
  const size_t bz = blockIdx.z;
  const float* xb = x + bz * plane;
  const size_t pw_ = bz * w_stride + q;

  const pde4_sor::Weights k{ww[pw_], wn[pw_], we[pw_], ws[pw_]};
  const float2 inv_b = pde4_sor::diagonal(trace[bz * trace_stride + q], bb[bz * b_stride + q],
                                          pde4_sor::weight_sum(k));
  x[bz * plane + q] = pde4_sor::update(xb[q], xb[q - 1], xb[q + 1], xb[q - w], xb[q + w], k,
                                       inv_b, omega, one_minus_omega);
}

struct Weights8 {
  const float *ww, *wnw, *wn, *wne, *we, *wse, *ws, *wsw;
};

// One colour of one pde8 sweep: reads xa, writes every pixel of xb.
__global__ void pde8_color_kernel(const float* __restrict__ xa, float* __restrict__ xb,
                                  const float* __restrict__ trace,
                                  const float* __restrict__ bb, Weights8 wt,
                                  int64_t trace_stride, int64_t b_stride, int64_t w_stride,
                                  int h, int w, int color, float omega, float one_minus_omega) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= h || j >= w) return;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t q = static_cast<size_t>(i) * w + j;  // offset inside a plane
  const size_t bz = blockIdx.z;
  const float* xs = xa + bz * plane;
  const float xc = xs[q];
  if (i < 1 || i > h - 2 || j < 1 || j > w - 2 || ((i + j) & 1) != color) {
    xb[bz * plane + q] = xc;
    return;
  }
  const size_t pw_ = bz * w_stride + q;
  const pde8_sor::Weights k{wt.ww[pw_], wt.wnw[pw_], wt.wn[pw_], wt.wne[pw_],
                            wt.we[pw_], wt.wse[pw_], wt.ws[pw_], wt.wsw[pw_]};
  const float2 inv_b = pde8_sor::diagonal(trace[bz * trace_stride + q], bb[bz * b_stride + q],
                                          pde8_sor::weight_sum(k));
  const pde8_sor::Nbr x{xs[q - 1],     xs[q + 1],     xs[q - w],     xs[q + w],
                        xs[q - w - 1], xs[q - w + 1], xs[q + w - 1], xs[q + w + 1]};
  xb[bz * plane + q] = pde8_sor::update(xc, x, k, inv_b, omega, one_minus_omega);
}

// Border fill for H, W >= 3: pixel (i, j) of the border takes the value at
// (clamp(i, 1, H-2), clamp(j, 1, W-2)), which is what the rows-then-columns
// fill of the plain version leaves there (the corners come from the column
// pass). Every source is interior, so no thread reads what another writes.
__global__ void border_kernel(float* x, int h, int w) {
  const int n_edge_rows = 2 * w;
  const int n = n_edge_rows + 2 * (h - 2);
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  int i, j;
  if (k < n_edge_rows) {
    i = k < w ? 0 : h - 1;
    j = k < w ? k : k - w;
  } else {
    k -= n_edge_rows;
    i = 1 + (k >> 1);
    j = (k & 1) ? w - 1 : 0;
  }
  float* xb = x + static_cast<size_t>(blockIdx.y) * h * w;
  const int si = min(max(i, 1), h - 2);
  const int sj = min(max(j, 1), w - 2);
  xb[static_cast<size_t>(i) * w + j] = xb[static_cast<size_t>(si) * w + sj];
}

// Border fill when H or W is 2: no interior pixel exists and the fill reads
// border pixels it also writes (H = 2 swaps the two rows), so one block per
// plane runs the rows pass, synchronises, then runs the columns pass. Each
// thread owns whole columns (then whole rows), reading before it writes.
__global__ void border_small_kernel(float* x, int h, int w) {
  float* xb = x + static_cast<size_t>(blockIdx.y) * h * w;
  for (int j = threadIdx.x; j < w; j += blockDim.x) {
    const float top = xb[static_cast<size_t>(1) * w + j];
    const float bot = xb[static_cast<size_t>(h - 2) * w + j];
    xb[j] = top;
    xb[static_cast<size_t>(h - 1) * w + j] = bot;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    float* row = xb + static_cast<size_t>(i) * w;
    const float left = row[1];
    const float right = row[w - 2];
    row[0] = left;
    row[w - 1] = right;
  }
}

struct Launch {
  dim3 block, grid_color, grid_full, grid_border;
  int border_threads;
  bool small;
};

Launch plan(int batch, int h, int w) {
  Launch l;
  l.block = dim3(kBlockX, kBlockY);
  const int half_w = (w + 1) / 2;
  l.grid_color = dim3((half_w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, batch);
  l.grid_full = dim3((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, batch);
  l.small = h < 3 || w < 3;
  const int n_border = l.small ? 1 : 2 * w + 2 * (h - 2);
  l.grid_border = dim3(l.small ? 1 : (n_border + kBorderThreads - 1) / kBorderThreads, batch);
  l.border_threads = kBorderThreads;
  return l;
}

cudaError_t fill_border(const Launch& l, float* x, int h, int w, cudaStream_t s) {
  if (l.small) {
    border_small_kernel<<<l.grid_border, l.border_threads, 0, s>>>(x, h, w);
  } else {
    border_kernel<<<l.grid_border, l.border_threads, 0, s>>>(x, h, w);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are contiguous (B, H, W) float32 arrays on the current
// device, H, W >= 2. du_out receives dU after `iters` sweeps. Launches
// 3 * iters kernels on `stream`, after one device-to-device copy.
int interior_disp_llin4(const void* u, const void* du, const void* cu, const void* duc,
                        const void* ww, const void* wn, const void* we, const void* ws,
                        void* du_out, int batch, int h, int w, int iters, float omega,
                        float one_minus_omega, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  float* out = static_cast<float*>(du_out);
  const size_t bytes = static_cast<size_t>(batch) * h * w * sizeof(float);
  cudaError_t err = cudaMemcpyAsync(out, du, bytes, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Launch l = plan(batch, h, w);
  for (int it = 0; it < iters; ++it) {
    for (int color = 0; color < 2; ++color) {
      disp_color_kernel<<<l.grid_color, l.block, 0, s>>>(f(u), out, f(cu), f(duc), f(ww), f(wn),
                                                         f(we), f(ws), h, w, color, omega,
                                                         one_minus_omega);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    err = fill_border(l, out, h, w, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// x and x_out are contiguous (B, H, W) float32, H, W >= 2. trace, b and the
// four weights are contiguous float32 planes with the given batch strides in
// elements: H*W for one plane per batch entry, 0 for one shared (H, W)
// plane. Launches 3 * iters kernels on `stream`, after one copy.
int interior_pde4(const void* x, const void* trace, const void* b, const void* ww,
                  const void* wn, const void* we, const void* ws, void* x_out,
                  int64_t trace_stride, int64_t b_stride, int64_t w_stride, int batch, int h,
                  int w, int iters, float omega, float one_minus_omega, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  float* out = static_cast<float*>(x_out);
  const size_t bytes = static_cast<size_t>(batch) * h * w * sizeof(float);
  cudaError_t err = cudaMemcpyAsync(out, x, bytes, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Launch l = plan(batch, h, w);
  for (int it = 0; it < iters; ++it) {
    for (int color = 0; color < 2; ++color) {
      pde4_color_kernel<<<l.grid_color, l.block, 0, s>>>(out, f(trace), f(b), f(ww), f(wn),
                                                         f(we), f(ws), trace_stride, b_stride,
                                                         w_stride, h, w, color, omega,
                                                         one_minus_omega);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    err = fill_border(l, out, h, w, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// As interior_pde4 with the eight weights W, NW, N, NE, E, SE, S, SW (all
// shared or all per batch entry, w_stride) and `tmp`, a contiguous
// (B, H, W) float32 buffer the colour launches alternate with. Launches
// 3 * iters kernels on `stream`, after one copy.
int interior_pde8(const void* x, const void* trace, const void* b, const void* ww,
                  const void* wnw, const void* wn, const void* wne, const void* we,
                  const void* wse, const void* ws, const void* wsw, void* x_out, void* tmp,
                  int64_t trace_stride, int64_t b_stride, int64_t w_stride, int batch, int h,
                  int w, int iters, float omega, float one_minus_omega, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  float* out = static_cast<float*>(x_out);
  float* other = static_cast<float*>(tmp);
  const Weights8 wt{f(ww), f(wnw), f(wn), f(wne), f(we), f(wse), f(ws), f(wsw)};
  const size_t bytes = static_cast<size_t>(batch) * h * w * sizeof(float);
  cudaError_t err = cudaMemcpyAsync(out, x, bytes, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Launch l = plan(batch, h, w);
  for (int it = 0; it < iters; ++it) {
    // colour 0: out -> tmp; colour 1: tmp -> out
    pde8_color_kernel<<<l.grid_full, l.block, 0, s>>>(out, other, f(trace), f(b), wt,
                                                      trace_stride, b_stride, w_stride, h, w,
                                                      0, omega, one_minus_omega);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    pde8_color_kernel<<<l.grid_full, l.block, 0, s>>>(other, out, f(trace), f(b), wt,
                                                      trace_stride, b_stride, w_stride, h, w,
                                                      1, omega, one_minus_omega);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = fill_border(l, out, h, w, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

const char* interior_sor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
