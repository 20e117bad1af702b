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
// float of a row, so it moves whole sectors for half their use. Later
// work: temporal blocking, k sweeps per pass over a tile and its halo in
// shared memory; and dropping the border launch after the first sweep,
// since a filled border neighbour of an interior pixel holds that pixel's
// own value.
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
// NE, SW, SE.
//
// The kernels allocate nothing. The C entry points return
// cudaGetLastError() after the copy and each launch.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kBorderThreads = 256;

// Each operation rounded on its own, in the plain version's order: no FMA
// contraction, so on the card the kernel gives the plain version's floats.
// tv_denoise4 needs that: where u == f its PsiData is ~6.7e7, and over its
// outer iterations an ulp of difference grows into a visible one.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float nan_to_num(float x) {
  if (isnan(x)) return 0.0f;
  if (isinf(x)) return x > 0.0f ? FLT_MAX : -FLT_MAX;
  return x;
}

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

  const float a = ww[p];
  const float b = wn[p];
  const float c = we[p];
  const float d = ws[p];
  const float wsum = add_rn(add_rn(add_rn(a, b), c), d);
  // sum_k w_k (dU_k + U_k) - U_c sum w, in the order W, E, N, S
  float s = mul_rn(add_rn(du[pw], u[pw]), a);
  s = add_rn(s, mul_rn(add_rn(du[pe], u[pe]), c));
  s = add_rn(s, mul_rn(add_rn(du[pn], u[pn]), b));
  s = add_rn(s, mul_rn(add_rn(du[ps], u[ps]), d));
  s = sub_rn(s, mul_rn(u[p], wsum));
  const float cu_p = cu[p];
  const float num = isnan(cu_p) ? s : add_rn(s, nan_to_num(cu_p));
  const float inv = div_rn(1.0f, add_rn(wsum, nan_to_num(duc[p])));
  du[p] = add_rn(mul_rn(one_minus_omega, du[p]), mul_rn(mul_rn(omega, num), inv));
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

  const float a = ww[pw_];
  const float b = wn[pw_];
  const float c = we[pw_];
  const float d = ws[pw_];
  const float wsum = add_rn(add_rn(add_rn(a, b), c), d);
  const float t = trace[bz * trace_stride + q];
  const bool t_nan = isnan(t);
  const float inv = div_rn(1.0f, t_nan ? wsum : nan_to_num(t));
  const float b_eff = t_nan ? 0.0f : bb[bz * b_stride + q];
  // sum_k w_k X_k in the order W, E, N, S
  float nbr = mul_rn(xb[q - 1], a);
  nbr = add_rn(nbr, mul_rn(xb[q + 1], c));
  nbr = add_rn(nbr, mul_rn(xb[q - w], b));
  nbr = add_rn(nbr, mul_rn(xb[q + w], d));
  const float nx = mul_rn(add_rn(b_eff, nbr), inv);
  x[bz * plane + q] = add_rn(mul_rn(one_minus_omega, xb[q]), mul_rn(omega, nx));
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
  // weights in the plain sum order W, NW, N, NE, E, SE, S, SW
  const float a = wt.ww[pw_], anw = wt.wnw[pw_], b = wt.wn[pw_], ane = wt.wne[pw_];
  const float c = wt.we[pw_], ase = wt.wse[pw_], d = wt.ws[pw_], asw = wt.wsw[pw_];
  float wsum = add_rn(add_rn(add_rn(a, anw), b), ane);
  wsum = add_rn(add_rn(add_rn(add_rn(wsum, c), ase), d), asw);
  const float t = trace[bz * trace_stride + q];
  const bool t_nan = isnan(t);
  const float inv = div_rn(1.0f, t_nan ? wsum : nan_to_num(t));
  const float b_eff = t_nan ? 0.0f : bb[bz * b_stride + q];
  // sum_k w_k X_k in the order W, E, N, S, NW, NE, SW, SE
  float nbr = mul_rn(xs[q - 1], a);
  nbr = add_rn(nbr, mul_rn(xs[q + 1], c));
  nbr = add_rn(nbr, mul_rn(xs[q - w], b));
  nbr = add_rn(nbr, mul_rn(xs[q + w], d));
  nbr = add_rn(nbr, mul_rn(xs[q - w - 1], anw));
  nbr = add_rn(nbr, mul_rn(xs[q - w + 1], ane));
  nbr = add_rn(nbr, mul_rn(xs[q + w - 1], asw));
  nbr = add_rn(nbr, mul_rn(xs[q + w + 1], ase));
  const float nx = mul_rn(add_rn(b_eff, nbr), inv);
  xb[bz * plane + q] = add_rn(mul_rn(one_minus_omega, xc), mul_rn(omega, nx));
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
