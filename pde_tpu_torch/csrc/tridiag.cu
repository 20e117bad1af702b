// Batched tridiagonal line solves (Thomas elimination): the line solve under
// the zebra-ADI preconditioner of every PCG solver (solvers/krylov.py), the
// zebra ALR relaxations (solvers/tdma.py::alr_*) and diffusion4
// (models/diffusion.py).
//
// Replaces pde_tpu/kernels/tdma_pallas.py::_cr_kernel (tridiag_cr_pallas),
// the VMEM-resident cyclic-reduction solve along axis -2, and the XLA cyclic
// reduction and Thomas scans the JAX package reaches the same solves by.
// Its plain PyTorch versions are pde_tpu_torch/solvers/tdma.py::
// thomas_solve, tridiag_factor/tridiag_solve and line_factors/line_solve.
//
// Systems: for each line, a[k] x[k-1] + b[k] x[k] + c[k] x[k+1] = d[k],
// k = 0..L-1, with a[0] and c[L-1] ignored (taken as zero, as
// tridiag_factor zeroes them). Fields are (B, H, W) float32 planes. A line
// runs along axis -2 (vertical: a column, element stride W; adjacent threads
// take adjacent columns, so loads coalesce) or along axis -1 (horizontal: a
// row, element stride 1; adjacent threads are W floats apart). A coefficient
// may be one (H, W) plane shared by the batch (batch stride 0).
//
// Design: one thread per line, Thomas elimination. The TPU kernel used
// cyclic reduction because its vector lanes needed log2(L) parallel levels;
// here the lines themselves fill the threads, and Thomas does half the flops
// of cyclic reduction. Every float operation is rounded alone
// (__fmul_rn, __fsub_rn, __fdiv_rn) in the plain scan's order, so the kernel
// gives the plain version's floats exactly:
//   denom = 1 / (b - cp' a),  cp = c denom,  dp = (d - dp' a) denom,
//   x     = dp - cp x_next.
// Three entry points:
//   * tridiag_thomas: the whole solve in one launch; cp goes to a scratch
//     plane, dp to x, and the backward pass runs in place over x;
//   * tridiag_factor: cp and 1/denominator of every line of the field, once
//     per solver call (the coefficients are fixed for its whole loop);
//   * tridiag_solve: the RHS pass with a factor, on every line or on the lines
//     of one zebra parity (columns or rows parity::2), reading the full RHS
//     and writing the parity lines compactly, as the plain line_solve returns
//     them. One full-field factor serves both parities: the per-line
//     arithmetic is the same as factoring each parity's lines apart.
// What bounds it: a solve reads d (and a, cp, denom) once and writes x, but
// each thread walks a chain of 2 L dependent steps, and at the finest zebra
// levels there are few lines (320 columns of one parity at 480x640: ten warps
// for 132 SMs), so it is bound by latency, not by bytes. The redesign for
// occupancy (parallel cyclic reduction of a line per warp in shared memory)
// is later work.
//
// The kernels run on the caller's stream and allocate nothing. The C entry
// points return cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// Where a thread's line lies. Lines are numbered t = 0..n_sel-1 per batch
// item; line t is column / row q = t (every line) or parity + 2 t.
struct Line {
  int64_t full;      // offset of element 0 in a full (H, W) plane
  int64_t out;       // offset of element 0 in the output plane
  int64_t kstride;   // element stride in a full plane
  int64_t ostride;   // element stride in the output plane
  int64_t plane;     // H * W
  int64_t oplane;    // floats per output plane
  int len;           // L
  int bt;            // batch item
};

__device__ __forceinline__ bool locate(int batch, int h, int w, int vertical, int parity,
                                       Line* ln) {
  const int n_all = vertical ? w : h;
  const int n_sel = parity < 0 ? n_all : (n_all - parity + 1) / 2;
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= static_cast<int64_t>(batch) * n_sel) return false;
  const int bt = static_cast<int>(gid / n_sel);
  const int t = static_cast<int>(gid % n_sel);
  const int q = parity < 0 ? t : parity + 2 * t;
  ln->bt = bt;
  ln->plane = static_cast<int64_t>(h) * w;
  if (vertical) {
    ln->len = h;
    ln->full = q;
    ln->kstride = w;
    ln->out = t;
    ln->ostride = n_sel;
    ln->oplane = static_cast<int64_t>(h) * n_sel;
  } else {
    ln->len = w;
    ln->full = static_cast<int64_t>(q) * w;
    ln->kstride = 1;
    ln->out = static_cast<int64_t>(t) * w;
    ln->ostride = 1;
    ln->oplane = static_cast<int64_t>(n_sel) * w;
  }
  return true;
}

__global__ void thomas_kernel(const float* __restrict__ a, const float* __restrict__ b,
                              const float* __restrict__ c, const float* __restrict__ d,
                              float* __restrict__ cp, float* __restrict__ x, int64_t sa,
                              int64_t sb, int64_t sc, int batch, int h, int w, int vertical) {
  Line ln;
  if (!locate(batch, h, w, vertical, -1, &ln)) return;
  const float* al = a + ln.bt * sa + ln.full;
  const float* bl = b + ln.bt * sb + ln.full;
  const float* cl = c + ln.bt * sc + ln.full;
  const int64_t base = ln.bt * ln.plane + ln.full;
  float cp_prev = 0.0f, dp_prev = 0.0f;
  for (int k = 0; k < ln.len; ++k) {
    const int64_t o = k * ln.kstride;
    const float ak = k == 0 ? 0.0f : al[o];
    const float ck = k == ln.len - 1 ? 0.0f : cl[o];
    const float denom = __fdiv_rn(1.0f, __fsub_rn(bl[o], __fmul_rn(cp_prev, ak)));
    cp_prev = __fmul_rn(ck, denom);
    dp_prev = __fmul_rn(__fsub_rn(d[base + o], __fmul_rn(dp_prev, ak)), denom);
    cp[base + o] = cp_prev;
    x[base + o] = dp_prev;
  }
  float x_next = 0.0f;
  for (int k = ln.len - 1; k >= 0; --k) {
    const int64_t o = base + k * ln.kstride;
    x_next = __fsub_rn(x[o], __fmul_rn(cp[o], x_next));
    x[o] = x_next;
  }
}

__global__ void factor_kernel(const float* __restrict__ a, const float* __restrict__ b,
                              const float* __restrict__ c, float* __restrict__ cp,
                              float* __restrict__ denom, int64_t sa, int64_t sb, int64_t sc,
                              int batch, int h, int w, int vertical) {
  Line ln;
  if (!locate(batch, h, w, vertical, -1, &ln)) return;
  const float* al = a + ln.bt * sa + ln.full;
  const float* bl = b + ln.bt * sb + ln.full;
  const float* cl = c + ln.bt * sc + ln.full;
  const int64_t base = ln.bt * ln.plane + ln.full;
  float cp_prev = 0.0f;
  for (int k = 0; k < ln.len; ++k) {
    const int64_t o = k * ln.kstride;
    const float ak = k == 0 ? 0.0f : al[o];
    const float ck = k == ln.len - 1 ? 0.0f : cl[o];
    const float dn = __fdiv_rn(1.0f, __fsub_rn(bl[o], __fmul_rn(cp_prev, ak)));
    cp_prev = __fmul_rn(ck, dn);
    cp[base + o] = cp_prev;
    denom[base + o] = dn;
  }
}

__global__ void solve_kernel(const float* __restrict__ a, const float* __restrict__ cp,
                             const float* __restrict__ denom, const float* __restrict__ d,
                             float* __restrict__ x, int64_t sa, int64_t sf, int batch, int h,
                             int w, int vertical, int parity) {
  Line ln;
  if (!locate(batch, h, w, vertical, parity, &ln)) return;
  const float* al = a + ln.bt * sa + ln.full;
  const float* cpl = cp + ln.bt * sf + ln.full;
  const float* dnl = denom + ln.bt * sf + ln.full;
  const float* dl = d + ln.bt * ln.plane + ln.full;
  float* xl = x + ln.bt * ln.oplane + ln.out;
  float dp_prev = 0.0f;
  for (int k = 0; k < ln.len; ++k) {
    const int64_t o = k * ln.kstride;
    const float ak = k == 0 ? 0.0f : al[o];
    dp_prev = __fmul_rn(__fsub_rn(dl[o], __fmul_rn(dp_prev, ak)), dnl[o]);
    xl[k * ln.ostride] = dp_prev;
  }
  float x_next = 0.0f;
  for (int k = ln.len - 1; k >= 0; --k) {
    x_next = __fsub_rn(xl[k * ln.ostride], __fmul_rn(cpl[k * ln.kstride], x_next));
    xl[k * ln.ostride] = x_next;
  }
}

unsigned blocks_for(int batch, int h, int w, int vertical, int parity) {
  const int n_all = vertical ? w : h;
  const int n_sel = parity < 0 ? n_all : (n_all - parity + 1) / 2;
  const int64_t lines = static_cast<int64_t>(batch) * n_sel;
  return static_cast<unsigned>((lines + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Every pointer is a contiguous float32 array on the current device. a, b, c
// are (H, W) planes with batch strides sa, sb, sc (0: one plane shared by the
// batch; H * W: one plane per batch item); d, cp_scratch and x are
// (batch, H, W). vertical = 1 solves along axis -2, 0 along axis -1.
int tridiag_thomas(const void* a, const void* b, const void* c, const void* d,
                   void* cp_scratch, void* x, long long sa, long long sb, long long sc,
                   int batch, int h, int w, int vertical, void* stream) {
  const unsigned blocks = blocks_for(batch, h, w, vertical, -1);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  thomas_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(d), static_cast<float*>(cp_scratch), static_cast<float*>(x), sa,
      sb, sc, batch, h, w, vertical);
  return static_cast<int>(cudaGetLastError());
}

// cp and denom receive the (batch, H, W) factor of the field's lines.
int tridiag_factor(const void* a, const void* b, const void* c, void* cp, void* denom,
                   long long sa, long long sb, long long sc, int batch, int h, int w,
                   int vertical, void* stream) {
  const unsigned blocks = blocks_for(batch, h, w, vertical, -1);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  factor_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<float*>(cp), static_cast<float*>(denom), sa, sb, sc, batch, h, w, vertical);
  return static_cast<int>(cudaGetLastError());
}

// d is (batch, H, W); a has batch stride sa, cp and denom sf. parity < 0
// solves every line into a (batch, H, W) x; parity 0 or 1 solves the columns
// (vertical) or rows (horizontal) parity::2 into a compact x of shape
// (batch, H, ceil((W - parity) / 2)) or (batch, ceil((H - parity) / 2), W).
int tridiag_solve(const void* a, const void* cp, const void* denom, const void* d, void* x,
                  long long sa, long long sf, int batch, int h, int w, int vertical, int parity,
                  void* stream) {
  const unsigned blocks = blocks_for(batch, h, w, vertical, parity);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  solve_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(cp),
      static_cast<const float*>(denom), static_cast<const float*>(d), static_cast<float*>(x), sa,
      sf, batch, h, w, vertical, parity);
  return static_cast<int>(cudaGetLastError());
}

const char* tridiag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
