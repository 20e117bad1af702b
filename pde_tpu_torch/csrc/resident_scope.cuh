// The machinery the resident SOR kernels share (resident_sor.cu: llin4 and
// disp llin4; resident8_sor.cu: llin8 and pde8): the barrier that ends a
// colour phase over the plan's scope, the shared-memory layout of a band
// split by colour, the reads of a neighbouring block's rows (distributed
// shared memory in a cluster, L2 on the grid), the map of threads to pixels,
// the co-residency checks and the launch through cudaLaunchKernelEx.
//
// A block owns a band of whole rows; slot k of colour c of thread t is
// pixel (r0 + q / hw, 2 (q % hw) + parity) with q = t + k * threads,
// hw = ceil(W/2). The scope follows the plan
// (kernels/resident_cuda.py::plan_resident): one block (__syncthreads), a
// thread block cluster of up to 16 blocks (cluster.sync()), or a cooperative
// grid of co-resident blocks (grid.sync()). Before a launch the C entry
// checks that a cluster fits the card and that a grid is co-resident, and
// returns an error otherwise; the wrapper raises.

#pragma once

#include <cooperative_groups.h>

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace resident {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 16;
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 16;

enum Scope { kBlock = 0, kCluster = 1, kGrid = 2 };

__device__ __forceinline__ void scope_sync(int scope) {
  if (scope == kGrid) {
    cg::this_grid().sync();
  } else if (scope == kCluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// Where a field's pixel lies in a block's shared memory: the band's rows and
// a halo row above and below (`rows + 2` local rows, local row 0 the halo
// above, `rows` the plan's rows a band), split by colour, each colour in
// `nbuf` buffers (two where a phase reads a colour's old values while it
// writes its new ones). Pixel (gi, j) lies in buffer `buf` of the planes of
// its colour (gi + j) & 1, at local row gi - r0 + 1, column j / 2. A colour
// phase reads each plane at consecutive addresses across a warp: no bank
// conflicts.
struct Layout {
  int r0, rows, hw, nbuf = 1;
  __device__ __forceinline__ int at(int gi, int j, int buf = 0) const {
    return ((((gi + j) & 1) * nbuf + buf) * (rows + 2) + (gi - r0 + 1)) * hw + (j >> 1);
  }
};

// The value at (gi, j), a row of the band just above (gi < r0) or below the
// block's, from the shared memory `s` of the neighbouring block of the
// cluster (whose band starts `rows` rows earlier or later).
__device__ __forceinline__ float cluster_at(const float* s, int gi, int j, Layout lay,
                                            int buf = 0) {
  cg::cluster_group cl = cg::this_cluster();
  const bool above = gi < lay.r0;
  const float* remote = cl.map_shared_rank(s, cl.block_rank() + (above ? -1 : 1));
  lay.r0 += above ? -lay.rows : lay.rows;
  return remote[lay.at(gi, j, buf)];
}

// `x` as a value the compiler cannot see through: a phase recomputes its
// slots' indices from it rather than keep them live across the sweeps, which
// would take registers from the coefficients.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// The pixel (gi, j) of a slot of colour kC; false if the slot has none.
template <int kC>
__device__ __forceinline__ bool slot_pixel(uint32_t pos, int r0, int w, int* gi, int* j) {
  if (pos == ~0u) return false;
  *gi = r0 + static_cast<int>(pos >> 16);
  *j = 2 * static_cast<int>(pos & 0xffffu) + ((*gi + kC) & 1);
  return *j < w;
}

// The pixel of a slot recomputed from its opaque position (the slot holds
// one: its bit is set).
template <int kC>
__device__ __forceinline__ void slot_at(uint32_t pos, int r0, int* gi, int* j) {
  const uint32_t pk = opaque(pos);
  *gi = r0 + static_cast<int>(pk >> 16);
  *j = 2 * static_cast<int>(pk & 0xffffu) + ((*gi + kC) & 1);
}

// Where this thread's slots lie in the band: (local row << 16) | half column,
// or ~0u past the band.
template <int kSlots>
__device__ __forceinline__ void slot_positions(uint32_t (&pos)[kSlots], int rows, int hw) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int q = threadIdx.x + k * blockDim.x;
    const int li = q / hw;
    pos[k] = li < rows ? (static_cast<uint32_t>(li) << 16) | static_cast<uint32_t>(q - li * hw)
                       : ~0u;
  }
}

// Stage the halo rows of the frozen field(s) U (and V): the row above the
// band and the row below, where the image has them. (A thread stages its own
// pixels of every field with their coefficients, in the prepare.)
__device__ __forceinline__ void stage_halo(float* s0, const float* src0, float* s1,
                                           const float* src1, Layout lay, int rows, int h,
                                           int w) {
  for (int idx = threadIdx.x; idx < 2 * w; idx += blockDim.x) {
    const bool below = idx >= w;
    const int gi = below ? lay.r0 + rows : lay.r0 - 1;
    const int j = below ? idx - w : idx;
    if (gi < 0 || gi >= h) continue;
    const size_t p = static_cast<size_t>(gi) * w + j;
    const int q = lay.at(gi, j);
    s0[q] = src0[p];
    if (s1 != nullptr) s1[q] = src1[p];
  }
}

// The plan's common rules: threads, bands of at least two rows (and the last
// one too where `last_two`), every pixel of a colour a slot, shared memory
// within a block's, and a scope that spans the bands.
inline bool bands_ok(int h, int w, int scope, int blocks, int rows, int threads, int slots,
                     int64_t smem, bool last_two) {
  if (h < 1 || w < 1 || w > 0xffff) return false;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) return false;
  if (rows < 1 || blocks != (h + rows - 1) / rows) return false;
  if (blocks > 1 && (rows < 2 || (last_two && h - (blocks - 1) * rows < 2))) return false;
  if (static_cast<int64_t>(rows) * ((w + 1) / 2) > static_cast<int64_t>(threads) * slots)
    return false;
  if (smem > kMaxSmem) return false;
  if (scope == kBlock) return blocks == 1;
  if (scope == kCluster) return blocks >= 2 && blocks <= kMaxCluster;
  return scope == kGrid;
}

// Whether a launch of `kernel` with this shape can run: a cluster must fit
// the card, a cooperative grid must be co-resident. Cached by shape (the
// queries cost host time on every call otherwise).
struct Fit {
  const void* kernel;
  int device, scope, blocks, batch, threads, smem;
  bool ok;
};

inline cudaError_t fits(const void* kernel, int device, int scope, int blocks, int batch,
                        int threads, int smem, cudaLaunchConfig_t* cfg, bool* ok) {
  static std::mutex mu;
  static Fit cache[256];
  static int n_cache = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_cache; ++i) {
    const Fit& f = cache[i];
    if (f.kernel == kernel && f.device == device && f.scope == scope && f.blocks == blocks &&
        f.batch == batch && f.threads == threads && f.smem == smem) {
      *ok = f.ok;
      return cudaSuccess;
    }
  }
  cudaError_t err = cudaSuccess;
  if (scope == kCluster) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, cfg);
    *ok = clusters >= 1;
  } else if (scope == kGrid) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    *ok = static_cast<int64_t>(per_sm) * sms >= static_cast<int64_t>(blocks) * batch;
  } else {
    *ok = true;
  }
  if (err != cudaSuccess) return err;
  if (n_cache < 256) cache[n_cache++] = {kernel, device, scope, blocks, batch, threads, smem, *ok};
  return cudaSuccess;
}

// Once per kernel and device: the dynamic shared memory past 48 KB, and
// clusters past the portable 8 blocks.
inline cudaError_t configure(const void* kernel, int device) {
  static std::mutex mu;
  static const void* done[kMaxDevices][64];
  static int n_done[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_done[device]; ++i)
    if (done[device][i] == kernel) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && n_done[device] < 64) done[device][n_done[device]++] = kernel;
  return err;
}

// One launch of `kernel` with the argument `prm` on `stream`: `blocks` bands
// by `batch` (gridDim.y), the cluster dimension or the cooperative attribute
// of the scope. Returns a cudaError_t as an int.
template <class Params>
int launch(const void* kernel, const Params& prm, int scope, int blocks, int batch, int threads,
           int smem, void* stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = configure(kernel, device);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(blocks, batch, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 0;
  if (scope == kCluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.numAttrs = 1;
  } else if (scope == kGrid) {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.numAttrs = 1;
  }
  bool ok = false;
  err = fits(kernel, device, scope, blocks, batch, threads, smem, &cfg, &ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!ok) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {const_cast<Params*>(&prm)};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace resident
