// Temporally blocked red-black SOR of the coupled flow pair, k sweeps per
// pass over a 2-D tile held in shared memory:
//   * late (llin4): the increments (dU, dV) against the frozen flow (U, V);
//   * early (elin4): (U, V) themselves (template flag kLate = false).
//
// Replaces the TPU kernels pde_tpu/kernels/tiled.py::_stripe_kernel
// (tiled.py:113, serial) and ::_stripe_kernel_db (tiled.py:172, the next
// stripe's DMA under the current one's sweeps) driving pde_tpu/kernels/
// sweeps.py::flow_llin4_sweep (:66) and flow_elin4_sweep (:234). It computes
// the same function as the global kernels of flow_llin4_sor.cu and their
// plain versions pde_tpu_torch/solvers/sor.py::sor_flow_llin4 and
// sor_flow_elin4; its own plain version is the tile schedule in torch ops,
// pde_tpu_torch/kernels/tiled.py::plain_tiled_relax.
//
// Design (simple and exact first):
//   * iters sweeps run as iters / k chunks of k and one of the remainder,
//     one launch a chunk. A chunk reads one (dU, dV) pair and writes another
//     (ping-pong, the last chunk writing the output): a tile's halo must see
//     the state at the start of the chunk, not a neighbour's result.
//   * A block takes a tile (tiled.py::plan_tiles sizes it) plus a halo of 2k
//     on every side, clamped at the image edge: every field, one float plane
//     each, and a flag byte a pixel, in one slot of shared memory. The prepare
//     runs there in place (edge-zeroed weights at the GLOBAL edge, NaN
//     folding), so there is no prepare launch and no scratch.
//   * Then k sweeps, a __syncthreads() after each colour. In sweep s colour 1
//     updates the tile grown by 2 (k - 1 - s) and colour 0 one pixel more,
//     which is all the kept interior depends on. A neighbour off the slot is
//     clamped inside it, as the global kernel clamps at the image: a pixel on
//     the slot's edge that is updated lies on the image edge, where that
//     weight is zero (and an inf there still meets the zero, as in plain).
//   * The per-pixel arithmetic is flow_update.cuh's, shared with the global
//     kernels, so both round alike.
//   * Serial: one block of 512 threads per tile; the plan gives a slot most
//     of an SM's shared memory, so one block an SM at a time.
//     Double-buffered (the port of _stripe_kernel_db): persistent blocks of
//     1024 threads, one an SM (two slots take its shared memory), walk the
//     tiles with two slots; while a block sweeps tile t in slot s, cp.async
//     copies its next tile into slot 1 - s (one commit group a tile, waited on
//     before its prepare). A __syncthreads() after each tile drains the slot
//     before it is refilled, and the block waits for every group before it
//     ends. Serial and double-buffered give the same bits.
//   * Copies are 4-byte cp.async, one warp per row of a plane: no alignment
//     condition on a tile's origin.
//   * The windowed variant (the `_win` entry points) runs one chunk over part
//     of an image: the arrays are the rectangle [r0, r0 + h) x [c0, c0 + w) of
//     a gh x gw image (a shard of pde_tpu_torch/parallel/tiled.py with the
//     2k halo exchanged from its neighbours, clipped to the image), and only
//     the tiles covering a box of the arrays run, writing the box alone into
//     a box-sized output. Colours are (gi + gj) & 1 and the image edges
//     gi, gj = 0, gh - 1, gw - 1 in the image's coordinates; a slot is
//     clamped at the array's edge, which the kept box never reaches. The
//     whole-image kernel is the window (0, 0, h, w) with the box the whole
//     array: one code path, the same bits. It replaces pde_tpu/parallel/
//     tiled.py::tiled_relax_sharded's shard bodies (:301-327, XLA ops under
//     shard_map there) for llin4 and elin4; its plain version is
//     kernels/tiled.py::plain_tiled_relax with a Window.
//
// What bounds it. Bytes by design: a chunk reads every field of a slot once
// (13 planes for llin4, 11 for elin4) and writes the two relaxed fields of
// the interior, the halo read again by the neighbouring tiles: ~26 B a
// pixel-iteration for llin4's 32x64 tile at k = 4, against the global
// kernels' ~130 (each colour launch reading every plane). The halo's pixels
// are relaxed too (~1.4x the interior's arithmetic at that tile; the
// shrinking regions keep it down). On the H100 the bytes do not bound it (a
// third of the memory rate or less, PERF.md): the per-tile work does, the
// halo, the prepare and a barrier per colour, which is why the plan takes the
// largest tiles (kernels/tiled.py, measured by scripts/tiled_plan_sweep.py).
// A slot layout without the colours' 2-way bank conflicts measured 5% slower.
// Later work: coefficients in registers, so that a slot holds only the four
// fields neighbours read and tiles grow, and fewer barriers.
//
// The kernels run on the caller's stream and allocate nothing. The C entry
// points return the first failing CUDA call's error, cudaGetLastError()
// after every launch included.

#include <algorithm>
#include <cstdint>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include "flow_update.cuh"

namespace {

// double-buffered: one persistent block an SM, so twice the threads to hide
// the latency of shared memory
template <bool kDouble>
constexpr int kThreads = kDouble ? 1024 : 512;
constexpr int kMaxPlanes = 13;

// the fields, in the order of the C entry points: the two relaxed first
struct Planes {
  const float* p[kMaxPlanes];
};

struct Geometry {
  int h, w;              // the arrays
  int r0, c0, gh, gw;    // the arrays' origin in the image, and the image
  int bi0, bj0, bh, bw;  // the box whose tiles run, in the arrays; the output is bh x bw
  int tile_h, tile_w;    // a tile's interior
  int tiles_w, n_tiles;  // tiles a row of the box, in all
  int k, halo;           // this chunk's sweeps and halo (2k)
  int rows, pitch;       // a slot's plane: rows x pitch floats (tile + 2 halo)
  int slot_bytes;        // one slot: the planes, then a flag byte a pixel
};

// a tile's interior and its slot (the interior and halo), clipped to the
// arrays, in the arrays' coordinates
struct Box {
  int r0, r1, c0, c1;
  int gr0, gr1, gc0, gc1;
};

__host__ __device__ int slot_bytes(int planes, int k, int tile_h, int tile_w) {
  const int px = (tile_h + 4 * k) * (tile_w + 4 * k);
  return (planes * 4 * px + px + 15) / 16 * 16;
}

// q / d for 0 <= q < 2^16 and 1 <= d <= 2^16 (a slot holds fewer than 2^16
// pixels) by a multiply with m = ceil(2^32 / d), 2^32 for d = 1: the error of
// q * m / 2^32 is below q / 2^32 < 1 / d, so the floor is exact
__device__ __forceinline__ unsigned long long magic(int d) { return 0xFFFFFFFFull / d + 1; }
__device__ __forceinline__ int div_by(int q, unsigned long long m) {
  return static_cast<int>((static_cast<unsigned long long>(q) * m) >> 32);
}

__device__ __forceinline__ Box tile_box(const Geometry& g, int t) {
  Box b;
  const int ty = t / g.tiles_w;
  b.r0 = g.bi0 + ty * g.tile_h;
  b.c0 = g.bj0 + (t - ty * g.tiles_w) * g.tile_w;
  b.r1 = min(b.r0 + g.tile_h, g.bi0 + g.bh);
  b.c1 = min(b.c0 + g.tile_w, g.bj0 + g.bw);
  b.gr0 = max(b.r0 - g.halo, 0);
  b.gr1 = min(b.r1 + g.halo, g.h);
  b.gc0 = max(b.c0 - g.halo, 0);
  b.gc1 = min(b.c1 + g.halo, g.w);
  return b;
}

// Issues the copies of every plane of tile b into `slot`; the caller
// commits them as one group.
template <int kPlanes>
__device__ __forceinline__ void load_tile(float* slot, const Planes& in, const Box& b,
                                          const Geometry& g) {
  const int rows = b.gr1 - b.gr0, cols = b.gc1 - b.gc0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (int pr = warp; pr < kPlanes * rows; pr += n_warps) {
    const int p = pr / rows, r = pr - p * rows;
    const float* src = in.p[p] + static_cast<size_t>(b.gr0 + r) * g.w + b.gc0;
    float* dst = slot + (p * g.rows + r) * g.pitch;
    for (int c = lane; c < cols; c += 32) __pipeline_memcpy_async(dst + c, src + c, sizeof(float));
  }
}

// The prepare, in place: M, Cu, Cv, Du, Dv, W, N, E, S become M0, Cu0, Cv0,
// 1/(Σw + Du), 1/(Σw + Dv) and the edge-zeroed weights; the flags follow the
// planes.
template <bool kLate>
__device__ __forceinline__ void prepare_tile(float* slot, const Box& b, const Geometry& g) {
  constexpr int kC = kLate ? 4 : 2;  // the plane of M
  const int plane = g.rows * g.pitch;
  uint8_t* flags = reinterpret_cast<uint8_t*>(slot + (kC + 9) * plane);
  const int cols = b.gc1 - b.gc0, n = (b.gr1 - b.gr0) * cols;
  const unsigned long long m_cols = magic(cols);
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int li = div_by(q, m_cols), lj = q - li * cols;
    const int x = li * g.pitch + lj;
    float* f = slot + kC * plane + x;  // f[i * plane]: the i-th plane from M on
    // edges in the image's coordinates
    const flow_sor::Coef k = flow_sor::prepare(
        g.r0 + b.gr0 + li, g.c0 + b.gc0 + lj, g.gh, g.gw, f[5 * plane], f[6 * plane], f[7 * plane],
        f[8 * plane], f[0], f[plane], f[2 * plane], f[3 * plane], f[4 * plane]);
    f[0] = k.m0;
    f[plane] = k.cu0;
    f[2 * plane] = k.cv0;
    f[3 * plane] = k.inv_u;
    f[4 * plane] = k.inv_v;
    f[5 * plane] = k.a;
    f[6 * plane] = k.b;
    f[7 * plane] = k.c;
    f[8 * plane] = k.d;
    flags[x] = k.flags;
  }
}

// g.k red-black sweeps over the prepared slot, each colour over the region
// the kept interior depends on.
template <bool kLate>
__device__ __forceinline__ void sweep_tile(float* slot, const Box& tb, const Geometry& g,
                                           float omega, float one_minus_omega) {
  constexpr int kC = kLate ? 4 : 2;
  const int plane = g.rows * g.pitch;
  float* fu = slot;
  float* fv = slot + plane;
  const float* u = slot + 2 * plane;  // the frozen flow: late only
  const float* v = slot + 3 * plane;
  const float* co = slot + kC * plane;
  const uint8_t* flags = reinterpret_cast<const uint8_t*>(slot + (kC + 9) * plane);
  const int rows = tb.gr1 - tb.gr0, cols = tb.gc1 - tb.gc0;
  const int origin = g.r0 + g.c0;  // the colour is the image's
  for (int s = 0; s < g.k; ++s) {
    for (int color = 0; color < 2; ++color) {
      const int reach = 2 * (g.k - 1 - s) + 1 - color;
      const int i0 = max(tb.r0 - reach, tb.gr0), i1 = min(tb.r1 + reach, tb.gr1);
      const int j0 = max(tb.c0 - reach, tb.gc0), j1 = min(tb.c1 + reach, tb.gc1);
      const int half = (j1 - j0 + 1) / 2;
      const int n = (i1 - i0) * half;
      const unsigned long long m_half = magic(half);
      for (int q = threadIdx.x; q < n; q += blockDim.x) {
        const int qi = div_by(q, m_half);
        const int gi = i0 + qi;
        // the pixel of this colour ((gi + gj) & 1 == color in the image) in its pair
        const int gj = j0 + 2 * (q - qi * half) + ((origin + gi + j0 + color) & 1);
        if (gj >= j1) continue;
        const int li = gi - tb.gr0, lj = gj - tb.gc0;
        const int x = li * g.pitch + lj;
        const int xw = lj > 0 ? x - 1 : x;
        const int xe = lj < cols - 1 ? x + 1 : x;
        const int xn = li > 0 ? x - g.pitch : x;
        const int xs = li < rows - 1 ? x + g.pitch : x;
        const float a = co[x + 5 * plane], b = co[x + 6 * plane];
        const float c = co[x + 7 * plane], d = co[x + 8 * plane];
        const flow_sor::Nbr fu_n{fu[xw], fu[xe], fu[xn], fu[xs]};
        const flow_sor::Nbr fv_n{fv[xw], fv[xe], fv[xn], fv[xs]};
        float su, sv;
        if (kLate) {
          const float wsum = ((a + b) + c) + d;  // as the prepare sums it
          su = flow_sor::diffusion<true>(fu_n, {u[xw], u[xe], u[xn], u[xs]}, u[x], a, b, c, d,
                                         wsum);
          sv = flow_sor::diffusion<true>(fv_n, {v[xw], v[xe], v[xn], v[xs]}, v[x], a, b, c, d,
                                         wsum);
        } else {
          su = flow_sor::diffusion<false>(fu_n, fu_n, 0.0f, a, b, c, d, 0.0f);
          sv = flow_sor::diffusion<false>(fv_n, fv_n, 0.0f, a, b, c, d, 0.0f);
        }
        const float2 r =
            flow_sor::update(fu[x], fv[x], su, sv, flags[x], co[x], co[x + plane],
                             co[x + 2 * plane], co[x + 3 * plane], co[x + 4 * plane], omega,
                             one_minus_omega);
        fu[x] = r.x;
        fv[x] = r.y;
      }
      __syncthreads();
    }
  }
}

// The interior of the two relaxed planes to the chunk's box-sized output.
__device__ __forceinline__ void store_tile(const float* slot, float* out_u, float* out_v,
                                           const Box& b, const Geometry& g) {
  const int plane = g.rows * g.pitch;
  const int rows = b.r1 - b.r0, cols = b.c1 - b.c0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (int pr = warp; pr < 2 * rows; pr += n_warps) {
    const int p = pr / rows, r = pr - p * rows;
    const float* src = slot + p * plane + (b.r0 - b.gr0 + r) * g.pitch + (b.c0 - b.gc0);
    float* dst =
        (p ? out_v : out_u) + static_cast<size_t>(b.r0 - g.bi0 + r) * g.bw + (b.c0 - g.bj0);
    for (int c = lane; c < cols; c += 32) dst[c] = src[c];
  }
}

template <bool kLate, bool kDouble>
__global__ void __launch_bounds__(kThreads<kDouble>, kDouble ? 1 : 2)
    tiled_sweep_kernel(Planes in, float* __restrict__ out_u, float* __restrict__ out_v, Geometry g,
                       float omega, float one_minus_omega) {
  constexpr int kPlanes = kLate ? 13 : 11;
  extern __shared__ __align__(16) unsigned char smem[];
  int s = 0;  // the slot of the current tile
  auto slot = [&](int i) { return reinterpret_cast<float*>(smem + i * g.slot_bytes); };
  int t = blockIdx.x;
  if (kDouble) {
    if (t < g.n_tiles) load_tile<kPlanes>(slot(0), in, tile_box(g, t), g);
    __pipeline_commit();
  }
  for (; t < g.n_tiles; t += gridDim.x) {
    const Box tb = tile_box(g, t);
    if (kDouble) {
      // the block's next tile into the other slot, then wait for this one's
      // group (all but the newest)
      const int next = t + gridDim.x;
      if (next < g.n_tiles) load_tile<kPlanes>(slot(s ^ 1), in, tile_box(g, next), g);
      __pipeline_commit();
      __pipeline_wait_prior(1);
    } else {
      load_tile<kPlanes>(slot(0), in, tb, g);
      __pipeline_commit();
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    prepare_tile<kLate>(slot(s), tb, g);
    __syncthreads();
    sweep_tile<kLate>(slot(s), tb, g, omega, one_minus_omega);
    store_tile(slot(s), out_u, out_v, tb, g);
    // drain: every thread is done with this slot before a prefetch refills it
    __syncthreads();
    if (kDouble) s ^= 1;
  }
  __pipeline_wait_prior(0);
}

template <bool kLate, bool kDouble>
cudaError_t launch_chunk(const Planes& in, float* out_u, float* out_v, const Geometry& g,
                         float omega, float one_minus_omega, cudaStream_t stream) {
  const auto kernel = tiled_sweep_kernel<kLate, kDouble>;
  const int smem = (kDouble ? 2 : 1) * g.slot_bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int blocks = g.n_tiles;
  if (kDouble) {
    // persistent: as many blocks as the card holds at once
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads<kDouble>,
                                                        smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    blocks = std::min(blocks, sms * per_sm);
  }
  kernel<<<blocks, kThreads<kDouble>, smem, stream>>>(in, out_u, out_v, g, omega, one_minus_omega);
  return cudaGetLastError();
}

// A chunk of k sweeps over the tiles of the box (bi0, bj0, bh, bw) of h x w
// arrays lying at (r0, c0) in a gh x gw image.
template <int kPlanes>
Geometry geometry(int h, int w, int r0, int c0, int gh, int gw, int bi0, int bj0, int bh, int bw,
                  int k, int tile_h, int tile_w) {
  const int tiles_w = (bw + tile_w - 1) / tile_w;
  return Geometry{h,       w,   r0,          c0,          gh,          gw,
                  bi0,     bj0, bh,          bw,          tile_h,      tile_w,
                  tiles_w, tiles_w * ((bh + tile_h - 1) / tile_h),
                  k,       2 * k, tile_h + 4 * k, tile_w + 4 * k,
                  slot_bytes(kPlanes, k, tile_h, tile_w)};
}

// One launch a chunk: iters / k chunks of k sweeps, then one of the
// remainder; chunk c reads the previous chunk's output (the caller's fields
// for c = 0) and writes out or tmp so that the last one writes out.
template <bool kLate>
int run_tiled(const void* const* fields, void* out_u, void* out_v, void* tmp_u, void* tmp_v, int h,
              int w, int iters, int k, int tile_h, int tile_w, int double_buffer, float omega,
              float one_minus_omega, void* stream) {
  constexpr int kPlanes = kLate ? 13 : 11;
  if (h < 1 || w < 1 || k < 1 || tile_h < 1 || tile_w < 1) return cudaErrorInvalidValue;
  Planes in{};
  for (int p = 0; p < kPlanes; ++p) in.p[p] = static_cast<const float*>(fields[p]);
  const int n_full = iters / k, rem = iters % k, n_chunks = n_full + (rem > 0 ? 1 : 0);
  float* const dst[2][2] = {{static_cast<float*>(out_u), static_cast<float*>(out_v)},
                            {static_cast<float*>(tmp_u), static_cast<float*>(tmp_v)}};
  for (int c = 0; c < n_chunks; ++c) {
    const int kc = c < n_full ? k : rem;
    const Geometry g = geometry<kPlanes>(h, w, 0, 0, h, w, 0, 0, h, w, kc, tile_h, tile_w);
    float* const* to = dst[(n_chunks - 1 - c) % 2];
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        double_buffer ? launch_chunk<kLate, true>(in, to[0], to[1], g, omega, one_minus_omega, s)
                      : launch_chunk<kLate, false>(in, to[0], to[1], g, omega, one_minus_omega, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    in.p[0] = to[0];
    in.p[1] = to[1];
  }
  return static_cast<int>(cudaSuccess);
}

// The windowed variant: one launch, k sweeps over the box's tiles, the box
// written to out (bh x bw). Geometry the caller has not checked is refused.
template <bool kLate>
int run_window(const void* const* fields, void* out_u, void* out_v, int h, int w, int r0, int c0,
               int gh, int gw, int bi0, int bj0, int bh, int bw, int k, int tile_h, int tile_w,
               int double_buffer, float omega, float one_minus_omega, void* stream) {
  constexpr int kPlanes = kLate ? 13 : 11;
  if (h < 1 || w < 1 || k < 1 || tile_h < 1 || tile_w < 1 || r0 < 0 || c0 < 0 ||
      r0 + h > gh || c0 + w > gw || bi0 < 0 || bj0 < 0 || bh < 1 || bw < 1 || bi0 + bh > h ||
      bj0 + bw > w)
    return cudaErrorInvalidValue;
  Planes in{};
  for (int p = 0; p < kPlanes; ++p) in.p[p] = static_cast<const float*>(fields[p]);
  const Geometry g =
      geometry<kPlanes>(h, w, r0, c0, gh, gw, bi0, bj0, bh, bw, k, tile_h, tile_w);
  float* const ou = static_cast<float*>(out_u);
  float* const ov = static_cast<float*>(out_v);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      double_buffer ? launch_chunk<kLate, true>(in, ou, ov, g, omega, one_minus_omega, s)
                    : launch_chunk<kLate, false>(in, ou, ov, g, omega, one_minus_omega, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Shared memory of one slot for `planes` fields (13 for llin4, 11 for
// elin4), the plan's `k` and tile; tiled.py::slot_bytes computes the same.
int tiled_sor_slot_bytes(int planes, int k, int tile_h, int tile_w) {
  return slot_bytes(planes, k, tile_h, tile_w);
}

// All pointers are contiguous float32 (H, W) arrays on the current device.
// du_out/dv_out receive du/dv after `iters` sweeps; tmp_u/tmp_v are a second
// pair the chunks alternate with (unused, and may be null, when iters <= k).
// Launches ceil(iters / k) kernels on `stream`, double-buffered if
// `double_buffer` is not 0.
int tiled_flow_llin4(const void* du, const void* dv, const void* u, const void* v, const void* m,
                     const void* cu, const void* cv, const void* duc, const void* dvc,
                     const void* ww, const void* wn, const void* we, const void* ws,
                     void* du_out, void* dv_out, void* tmp_u, void* tmp_v, int h, int w,
                     int iters, int k, int tile_h, int tile_w, int double_buffer, float omega,
                     float one_minus_omega, void* stream) {
  const void* fields[13] = {du, dv, u, v, m, cu, cv, duc, dvc, ww, wn, we, ws};
  return run_tiled<true>(fields, du_out, dv_out, tmp_u, tmp_v, h, w, iters, k, tile_h, tile_w,
                         double_buffer, omega, one_minus_omega, stream);
}

// The early form: u, v are the flow, relaxed into u_out/v_out.
int tiled_flow_elin4(const void* u, const void* v, const void* m, const void* cu, const void* cv,
                     const void* duc, const void* dvc, const void* ww, const void* wn,
                     const void* we, const void* ws, void* u_out, void* v_out, void* tmp_u,
                     void* tmp_v, int h, int w, int iters, int k, int tile_h, int tile_w,
                     int double_buffer, float omega, float one_minus_omega, void* stream) {
  const void* fields[11] = {u, v, m, cu, cv, duc, dvc, ww, wn, we, ws};
  return run_tiled<false>(fields, u_out, v_out, tmp_u, tmp_v, h, w, iters, k, tile_h, tile_w,
                          double_buffer, omega, one_minus_omega, stream);
}

// The windowed variant: the fields are h x w arrays at (r0, c0) of a gh x gw
// image; one launch of k sweeps over the tiles of the box (bi0, bj0) + bh x bw
// writes the box into out_u/out_v (bh x bw). The caller keeps 2k pixels of
// the arrays, or the image's edge, around the box.
int tiled_flow_llin4_win(const void* du, const void* dv, const void* u, const void* v,
                         const void* m, const void* cu, const void* cv, const void* duc,
                         const void* dvc, const void* ww, const void* wn, const void* we,
                         const void* ws, void* du_out, void* dv_out, int h, int w, int r0, int c0,
                         int gh, int gw, int bi0, int bj0, int bh, int bw, int k, int tile_h,
                         int tile_w, int double_buffer, float omega, float one_minus_omega,
                         void* stream) {
  const void* fields[13] = {du, dv, u, v, m, cu, cv, duc, dvc, ww, wn, we, ws};
  return run_window<true>(fields, du_out, dv_out, h, w, r0, c0, gh, gw, bi0, bj0, bh, bw, k,
                          tile_h, tile_w, double_buffer, omega, one_minus_omega, stream);
}

int tiled_flow_elin4_win(const void* u, const void* v, const void* m, const void* cu,
                         const void* cv, const void* duc, const void* dvc, const void* ww,
                         const void* wn, const void* we, const void* ws, void* u_out, void* v_out,
                         int h, int w, int r0, int c0, int gh, int gw, int bi0, int bj0, int bh,
                         int bw, int k, int tile_h, int tile_w, int double_buffer, float omega,
                         float one_minus_omega, void* stream) {
  const void* fields[11] = {u, v, m, cu, cv, duc, dvc, ww, wn, we, ws};
  return run_window<false>(fields, u_out, v_out, h, w, r0, c0, gh, gw, bi0, bj0, bh, bw, k,
                           tile_h, tile_w, double_buffer, omega, one_minus_omega, stream);
}

const char* tiled_sor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
