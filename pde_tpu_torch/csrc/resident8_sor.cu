// Resident red-black SOR of the 8-neighbour stencils: one launch runs a whole
// solver call, the prepare and all `iters` sweeps, with the level held on
// chip between colours. Two families:
//   * llin8: the increments (dU, dV) of the anisotropic-tensor warping flow
//     against the frozen flow (U, V), weights W, NW, N, NE, E, SE, S, SW,
//     every pixel relaxed (models/flow_ad.py); the per-pixel arithmetic is
//     flow8_update.cuh's, so the result equals the global kernel
//     (flow_llin4_sor.cu, sweep8_kernel) bit for bit;
//   * pde8: the diagonal form X+ = (1-w) X + w (B + sum_k w_k X_k) / TRACE
//     over up to 3 channels with shared weights (models/tv_denoise.py,
//     tv_denoise8), interior pixels relaxed, the 1-px border replicated after
//     every sweep; the arithmetic is pde8_update.cuh's, every operation
//     rounded alone, so the result equals both the global kernel
//     (interior_sor.cu, pde8_color_kernel) and the plain version bit for bit.
//
// Replaces the TPU kernel pde_tpu/kernels/tiled.py:113 _stripe_kernel
// driving pde_tpu/kernels/sweeps.py:107 flow_llin8_sweep and sweeps.py:204
// pde8_sweep (one launch a call on the TPU: k_max = iters there). Plain
// PyTorch versions: pde_tpu_torch/solvers/sor.py::sor_flow_llin8 and
// ::sor_pde8.
//
// Design. The layout of resident_sor.cu (resident_scope.cuh): a block owns
// a band of whole rows, each thread `slots` pixels of each colour, the
// fields that neighbours read in shared memory, one plane per colour, and
// one barrier (block, cluster or grid, as the plan says) ends each colour
// phase. What is new is that a diagonal neighbour (i+-1, j+-1) has the
// pixel's own colour, and the plain version computes a whole colour from
// the state before the half-sweep (Jacobi within a colour). So each colour
// plane of a relaxed field has two buffers (ping-pong): the phase of colour
// c in sweep s reads colour c from buffer s & 1 and writes it to buffer
// (s + 1) & 1, and reads the other colour from the buffer of its own count
// of relaxations, (s + (colour < c)) & 1. No thread writes what another
// reads in the same phase, and one barrier a phase is enough (a second one,
// after computing into registers, would double the barriers, which
// dominate on the grid).
//   * Band edges. At the start of every phase the block mirrors into its
//     halo rows (the rows just above and below its band) the other colour's
//     buffer that the previous phase wrote (before the first phase, buffer 0
//     of both colours): in a cluster from the neighbouring block's shared
//     memory (distributed shared memory), on the grid from `edge`, a scratch
//     from the caller with the first and last rows of every band in two
//     buffers by the same parity, which the owning block writes when it
//     relaxes them (and fills in the prepare), read through L2
//     (ld.global.cg). The halo then holds both buffers of the neighbouring
//     rows as of the barrier, one __syncthreads later every neighbour is
//     read from the block's own shared memory, and no read waits on L2 or a
//     remote block inside a phase. The output is written only at the end.
//   * pde8's border. The plain version replicates the border after every
//     sweep, so in sweep s >= 1 a border neighbour (bi, bj) of an interior
//     pixel holds the value the pixel (clamp(bi, 1, H-2), clamp(bj, 1, W-2))
//     had at the end of sweep s - 1: its count of relaxations is s, which is
//     buffer s & 1 of its colour in either phase (for a colour-1 pixel
//     beside the border that is the colour-0 pixel's value from before this
//     sweep, not its current one); in sweep 0 it is the border pixel's own
//     input value (buffer 0). So the border costs no barrier and is filled
//     once, when the band is written out. That needs H, W >= 3 and bands of
//     two rows at least, the last one too (the fill's source lies in the
//     band); other shapes stay with the global kernel.
//   * Registers. A llin8 pixel has 14 coefficients and a pde8 pixel 8
//     weights and two floats a channel; at 480x640 a thread owns 3 pixels of
//     each colour. So the weights (llin8: and their sum) sit in shared memory,
//     one plane per weight and colour of the band, and a slot keeps in
//     registers only 1/(sum + Du), 1/(sum + Dv), M0, Cu0, Cv0 and its flags
//     (llin8) or 1/TRACE and B of each channel (pde8). pde8 relaxes all
//     channels of a pixel in the thread that owns it, so its weights are
//     read once a phase.
//
// What bounds it: as resident_sor.cu, the latency of its phases and their
// barriers, not bytes (76 B/px llin8, 80 B/px pde8 at C = 3, read once and
// written once). A phase reads ~45 (llin8) or ~27 a channel (pde8) floats
// a slot from shared memory.
//
// The launch goes through resident_scope.cuh's cudaLaunchKernelEx with the
// cluster dimension or the cooperative attribute, after checking the plan
// and co-residency; otherwise the C entry returns an error and the wrapper
// raises. The kernels run on the caller's stream and allocate nothing; the C
// entry points return cudaGetLastError() of the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "flow8_update.cuh"
#include "pde8_update.cuh"
#include "resident_scope.cuh"

namespace {

using resident::kBlock;
using resident::kCluster;
using resident::kGrid;
using resident::Layout;
using resident::scope_sync;
using resident::slot_at;
using resident::slot_pixel;
using resident::slot_positions;

constexpr int kMaxThreads = resident::kMaxThreads;
constexpr int kMaxChannels = 3;

enum Family { kLlin8 = 0, kPde8 = 1 };

struct Params {
  // llin8: u v du dv m cu cv duc dvc ww wnw wn wne we wse ws wsw;
  // pde8: ww wnw wn wne we wse ws wsw
  const float* in[17];
  // pde8, a channel each (a shared TRACE or B repeats its pointer)
  const float* x[kMaxChannels];
  const float* trace[kMaxChannels];
  const float* b[kMaxChannels];
  float* out[kMaxChannels];  // llin8: dU, dV; pde8: X of each channel
  float* edge;               // the grid's band-edge rows, two buffers
  int h, w, rows, blocks, iters, scope;
  float omega, one_minus_omega;
};

// The buffer that holds colour `colour` in the phase of colour kC of sweep
// `it`: its count of relaxations so far, modulo 2.
template <int kC>
__device__ __forceinline__ int buf_of(int colour, int it) {
  return (it + (colour < kC ? 1 : 0)) & 1;
}

// Where column j of edge row e (2 band + 0 for a band's first row, + 1 for
// its last) lies in `edge`: buffer `buf` of field `f` of `nf`.
__device__ __forceinline__ size_t edge_at(const Params& prm, int nf, int buf, int f, int e,
                                          int j) {
  return ((static_cast<size_t>(buf) * nf + f) * (2 * prm.blocks) + e) * prm.w + j;
}

// The edge row of row gi, the first (r0) or last row of this block's band.
__device__ __forceinline__ int own_edge(int gi, int r0) {
  return 2 * static_cast<int>(blockIdx.x) + (gi == r0 ? 0 : 1);
}

// The last barrier of a call: the block's own, unless a cluster's blocks may
// still read its shared memory.
__device__ __forceinline__ void end_sync(int scope) {
  if (scope == kCluster) {
    resident::cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// Mirror into the block's halo rows (the rows just above and below its
// band) the pixels of colour `colour` in buffer `buf` of the `nf` relaxed
// fields (`fstride` floats apart in shared memory `s`), as the blocks that
// own those rows left them: from their shared memory in a cluster, from the
// edge rows on the grid. A phase then reads every neighbour from its own
// shared memory.
// Each thread takes whole pixels, all fields' loads issued before their
// stores, so that a round trip to L2 or a remote block is paid about once
// per pixel a thread rather than once per value.
__device__ __forceinline__ void refresh_halo(const Params& prm, float* s, int nf, int fstride,
                                             int colour, int buf, Layout lay, int r1) {
  const int hw = lay.hw, b = static_cast<int>(blockIdx.x);
  const bool grid = prm.scope == kGrid;
  const float* above = nullptr;
  const float* below = nullptr;
  if (!grid) {
    resident::cg::cluster_group cl = resident::cg::this_cluster();
    if (lay.r0 > 0) above = cl.map_shared_rank(s, cl.block_rank() - 1);
    if (r1 < prm.h) below = cl.map_shared_rank(s, cl.block_rank() + 1);
  }
  for (int idx = threadIdx.x; idx < 2 * hw; idx += blockDim.x) {
    const bool low = idx >= hw;
    const int gi = low ? r1 : lay.r0 - 1;
    const int j = 2 * (low ? idx - hw : idx) + ((gi + colour) & 1);
    if (gi < 0 || gi >= prm.h || j >= prm.w) continue;
    const int q = lay.at(gi, j, buf);
    float v[kMaxChannels];
    if (grid) {
      // the last row of the band above, or the first of the band below
      const int e = low ? 2 * (b + 1) : 2 * b - 1;
#pragma unroll
      for (int f = 0; f < kMaxChannels; ++f)
        if (f < nf) v[f] = __ldcg(prm.edge + edge_at(prm, nf, buf, f, e, j));
    } else {
      // in that block the pixel lies `rows` local rows further up (down)
      const float* remote = low ? below : above;
      const int rq = q + (low ? -lay.rows : lay.rows) * hw;
#pragma unroll
      for (int f = 0; f < kMaxChannels; ++f)
        if (f < nf) v[f] = remote[f * fstride + rq];
    }
#pragma unroll
    for (int f = 0; f < kMaxChannels; ++f)
      if (f < nf) s[f * fstride + q] = v[f];
  }
}

// The phases of a call in order, each ended by the scope's barrier (the last
// by end_sync). Before a phase of colour c the halo rows take the other
// colour's buffer that the previous phase wrote (before the first, buffer 0
// of both colours), so they hold the neighbouring bands' state.
template <class Phase>
__device__ __forceinline__ void run_phases(const Params& prm, float* s, int nf, int fstride,
                                           Layout lay, int r1, Phase phase) {
  const bool banded = prm.scope != kBlock;
  scope_sync(prm.scope);  // the prepare of every band
  if (banded) {
    refresh_halo(prm, s, nf, fstride, 0, 0, lay, r1);
    refresh_halo(prm, s, nf, fstride, 1, 0, lay, r1);
    __syncthreads();
  }
  for (int it = 0; it < prm.iters; ++it) {
    phase(0, it);
    scope_sync(prm.scope);
    if (banded) {
      refresh_halo(prm, s, nf, fstride, 0, (it + 1) & 1, lay, r1);
      __syncthreads();
    }
    phase(1, it);
    if (it + 1 < prm.iters) {
      scope_sync(prm.scope);
      if (banded) {
        refresh_halo(prm, s, nf, fstride, 1, (it + 1) & 1, lay, r1);
        __syncthreads();
      }
    }
  }
  end_sync(prm.scope);
}

// The weights' planes: one per weight and colour of the band (no halo).
__device__ __forceinline__ int weight_at(int gi, int j, int r0, int rows, int hw) {
  return ((((gi + j) & 1) * rows) + (gi - r0)) * hw + (j >> 1);
}

// ---- llin8 -----------------------------------------------------------------

// What a llin8 pixel keeps in registers; its weights and their sum are in
// shared memory, its NaN flags in a bit word.
struct Llin8Slot {
  float inv_u, inv_v, m0, cu0, cv0;
};

// A block's shared memory: dU and dV (two buffers a colour), U and V (one),
// the nine weight planes (eight weights and their sum, per colour).
struct Llin8Smem {
  float *du, *dv, *u, *v, *wt;
  int wplane;
};

template <int kC, int kSlots>
__device__ __forceinline__ void llin8_prepare(const Params& prm, const uint32_t (&pos)[kSlots],
                                              Llin8Slot (&sl)[2][kSlots], uint32_t* bits,
                                              Llin8Smem sm, Layout lay, Layout lay2, int r1) {
  const float* const* in = prm.in;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    int gi, j;
    if (!slot_pixel<kC>(pos[k], lay.r0, prm.w, &gi, &j)) continue;
    const size_t p = static_cast<size_t>(gi) * prm.w + j;
    const float du = in[2][p], dv = in[3][p];
    const flow_sor8::Coef f = flow_sor8::prepare(
        gi, j, prm.h, prm.w, in[9][p], in[10][p], in[11][p], in[12][p], in[13][p], in[14][p],
        in[15][p], in[16][p], in[4][p], in[5][p], in[6][p], in[7][p], in[8][p]);
    const int q2 = lay2.at(gi, j, 0);
    sm.du[q2] = du;
    sm.dv[q2] = dv;
    const int q = lay.at(gi, j);
    sm.u[q] = in[0][p];
    sm.v[q] = in[1][p];
    const int wq = weight_at(gi, j, lay.r0, lay.rows, lay.hw);
#pragma unroll
    for (int c = 0; c < 8; ++c) sm.wt[c * sm.wplane + wq] = f.c[c];
    sm.wt[8 * sm.wplane + wq] = f.wsum;
    if (prm.scope == kGrid && (gi == lay.r0 || gi == r1 - 1)) {  // for the neighbours
      prm.edge[edge_at(prm, 2, 0, 0, own_edge(gi, lay.r0), j)] = du;
      prm.edge[edge_at(prm, 2, 0, 1, own_edge(gi, lay.r0), j)] = dv;
    }
    sl[kC][k] = {f.inv_u, f.inv_v, f.m0, f.cu0, f.cv0};
    const int s = kC * kSlots + k;
    *bits |= (1u << s) | (static_cast<uint32_t>(f.flags) << (16 + 2 * s));
  }
}

// One colour phase of llin8 in sweep `it`: every slot of colour kC relaxed
// from the buffers of the rule above into its colour's other buffer.
template <int kC, int kSlots>
__device__ __forceinline__ void llin8_phase(const Params& prm, const uint32_t (&pos)[kSlots],
                                            const Llin8Slot (&sl)[2][kSlots], uint32_t bits,
                                            Llin8Smem sm, Layout lay, Layout lay2, int r1,
                                            int it) {
  const int h = prm.h, w = prm.w, r0 = lay.r0;
  const int old_buf = it & 1, new_buf = (it + 1) & 1;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int s = kC * kSlots + k;
    if (!((bits >> s) & 1u)) continue;
    int gi, j;
    slot_at<kC>(pos[k], r0, &gi, &j);
    const int wq = weight_at(gi, j, r0, lay.rows, lay.hw);
    auto nbr = [&](int n) {
      int ni, nj;
      flow_sor8::neighbour(n, gi, j, h, w, &ni, &nj);
      const int q2 = lay2.at(ni, nj, buf_of<kC>((ni + nj) & 1, it));
      const int qf = lay.at(ni, nj);
      return make_float4(sm.du[q2], sm.dv[q2], sm.u[qf], sm.v[qf]);
    };
    auto weight = [&](int n) { return sm.wt[flow_sor8::weight_of(n) * sm.wplane + wq]; };
    const int q_old = lay2.at(gi, j, old_buf);
    const int q = lay.at(gi, j);
    const Llin8Slot& c = sl[kC][k];
    const float2 r = flow_sor8::update(nbr, weight, sm.du[q_old], sm.dv[q_old], sm.u[q], sm.v[q],
                                       sm.wt[8 * sm.wplane + wq], (bits >> (16 + 2 * s)) & 3u,
                                       c.m0, c.cu0, c.cv0, c.inv_u, c.inv_v, prm.omega,
                                       prm.one_minus_omega);
    const int q_new = lay2.at(gi, j, new_buf);
    sm.du[q_new] = r.x;
    sm.dv[q_new] = r.y;
    if (prm.scope == kGrid && (gi == r0 || gi == r1 - 1)) {
      prm.edge[edge_at(prm, 2, new_buf, 0, own_edge(gi, r0), j)] = r.x;
      prm.edge[edge_at(prm, 2, new_buf, 1, own_edge(gi, r0), j)] = r.y;
    }
  }
}

template <int kSlots>
__global__ void __launch_bounds__(kMaxThreads, 1)
    resident_llin8_kernel(const __grid_constant__ Params prm) {
  extern __shared__ float smem[];
  const int h = prm.h, w = prm.w, hw = (w + 1) >> 1;
  const int r0 = static_cast<int>(blockIdx.x) * prm.rows;
  const Layout lay{r0, prm.rows, hw, 1};
  const Layout lay2{r0, prm.rows, hw, 2};
  const int r1 = min(r0 + prm.rows, h);
  const int rows = r1 - r0;
  const int plane = 2 * (prm.rows + 2) * hw;  // both colours of a one-buffer field
  const Llin8Smem sm{smem, smem + 2 * plane, smem + 4 * plane, smem + 5 * plane,
                     smem + 6 * plane, 2 * prm.rows * hw};

  uint32_t pos[kSlots];
  slot_positions<kSlots>(pos, rows, hw);
  Llin8Slot sl[2][kSlots];
  uint32_t bits = 0;
  llin8_prepare<0, kSlots>(prm, pos, sl, &bits, sm, lay, lay2, r1);
  llin8_prepare<1, kSlots>(prm, pos, sl, &bits, sm, lay, lay2, r1);
  resident::stage_halo(sm.u, prm.in[0], sm.v, prm.in[1], lay, rows, h, w);
  run_phases(prm, sm.du, 2, 2 * plane, lay2, r1, [&](int c, int it) {
    if (c == 0) {
      llin8_phase<0, kSlots>(prm, pos, sl, bits, sm, lay, lay2, r1, it);
    } else {
      llin8_phase<1, kSlots>(prm, pos, sl, bits, sm, lay, lay2, r1, it);
    }
  });

  // each thread writes its own pixels out, both colours relaxed iters times
  const int out_buf = prm.iters & 1;
#pragma unroll
  for (int k = 0; k < 2 * kSlots; ++k) {
    int gi, j;
    if (!(k < kSlots ? slot_pixel<0>(pos[k], r0, w, &gi, &j)
                     : slot_pixel<1>(pos[k - kSlots], r0, w, &gi, &j)))
      continue;
    const int q = lay2.at(gi, j, out_buf);
    const size_t p = static_cast<size_t>(gi) * w + j;
    prm.out[0][p] = sm.du[q];
    prm.out[1][p] = sm.dv[q];
  }
}

// ---- pde8 ------------------------------------------------------------------

// Where a pixel's neighbour (ni, nj) lies in a channel's shared memory as
// the pixel reads it in the phase of colour kC of sweep `it`: a border
// pixel by the border rule above.
template <int kC>
__device__ __forceinline__ int pde8_nbr(int h, int w, int ni, int nj, int it, Layout lay2) {
  int b;
  if (ni == 0 || ni == h - 1 || nj == 0 || nj == w - 1) {
    if (it == 0) {
      b = 0;  // the input's own border
    } else {
      ni = min(max(ni, 1), h - 2);
      nj = min(max(nj, 1), w - 2);
      b = it & 1;  // the fill of the end of sweep it - 1
    }
  } else {
    b = buf_of<kC>((ni + nj) & 1, it);
  }
  return lay2.at(ni, nj, b);
}

template <int kC, int kSlots, int kCh>
__device__ __forceinline__ void pde8_prepare(const Params& prm, const uint32_t (&pos)[kSlots],
                                             float2 (&sl)[2][kSlots][kCh], uint32_t* bits,
                                             float* sx, int xstride, float* swt, int wplane,
                                             Layout lay2, int r1) {
  const int h = prm.h, w = prm.w;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    int gi, j;
    if (!slot_pixel<kC>(pos[k], lay2.r0, w, &gi, &j)) continue;
    const size_t p = static_cast<size_t>(gi) * w + j;
    const int q = lay2.at(gi, j, 0);
    const bool edge = prm.scope == kGrid && (gi == lay2.r0 || gi == r1 - 1);
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const float x = prm.x[c][p];
      sx[c * xstride + q] = x;
      if (edge)  // for the neighbours
        prm.edge[edge_at(prm, kCh, 0, c, own_edge(gi, lay2.r0), j)] = x;
    }
    if (gi < 1 || gi > h - 2 || j < 1 || j > w - 2) continue;  // interior only
    const pde8_sor::Weights wk{prm.in[0][p], prm.in[1][p], prm.in[2][p], prm.in[3][p],
                               prm.in[4][p], prm.in[5][p], prm.in[6][p], prm.in[7][p]};
    const int wq = weight_at(gi, j, lay2.r0, lay2.rows, lay2.hw);
    swt[0 * wplane + wq] = wk.w;
    swt[1 * wplane + wq] = wk.nw;
    swt[2 * wplane + wq] = wk.n;
    swt[3 * wplane + wq] = wk.ne;
    swt[4 * wplane + wq] = wk.e;
    swt[5 * wplane + wq] = wk.se;
    swt[6 * wplane + wq] = wk.s;
    swt[7 * wplane + wq] = wk.sw;
    const float wsum = pde8_sor::weight_sum(wk);
#pragma unroll
    for (int c = 0; c < kCh; ++c) sl[kC][k][c] = pde8_sor::diagonal(prm.trace[c][p], prm.b[c][p], wsum);
    *bits |= 1u << (kC * kSlots + k);
  }
}

// One colour phase of pde8 in sweep `it`: every interior slot of colour kC,
// all its channels, relaxed into its colour's other buffer.
template <int kC, int kSlots, int kCh>
__device__ __forceinline__ void pde8_phase(const Params& prm, const uint32_t (&pos)[kSlots],
                                           const float2 (&sl)[2][kSlots][kCh], uint32_t bits,
                                           float* sx, int xstride, const float* swt, int wplane,
                                           Layout lay2, int r1, int it) {
  const int r0 = lay2.r0;
  const int old_buf = it & 1, new_buf = (it + 1) & 1;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (!((bits >> (kC * kSlots + k)) & 1u)) continue;
    int gi, j;
    slot_at<kC>(pos[k], r0, &gi, &j);
    const int wq = weight_at(gi, j, r0, lay2.rows, lay2.hw);
    const pde8_sor::Weights wk{swt[0 * wplane + wq], swt[1 * wplane + wq], swt[2 * wplane + wq],
                               swt[3 * wplane + wq], swt[4 * wplane + wq], swt[5 * wplane + wq],
                               swt[6 * wplane + wq], swt[7 * wplane + wq]};
    const bool edge = prm.scope == kGrid && (gi == r0 || gi == r1 - 1);
    // the neighbours' places, W, E, N, S, NW, NE, SW, SE, shared by the channels
    constexpr int kDi[8] = {0, 0, -1, 1, -1, -1, 1, 1};
    constexpr int kDj[8] = {-1, 1, 0, 0, -1, 1, -1, 1};
    int q[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) q[n] = pde8_nbr<kC>(prm.h, prm.w, gi + kDi[n], j + kDj[n], it, lay2);
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      float* xs = sx + c * xstride;
      const pde8_sor::Nbr x{xs[q[0]], xs[q[1]], xs[q[2]], xs[q[3]],
                            xs[q[4]], xs[q[5]], xs[q[6]], xs[q[7]]};
      const float r = pde8_sor::update(xs[lay2.at(gi, j, old_buf)], x, wk, sl[kC][k][c],
                                       prm.omega, prm.one_minus_omega);
      xs[lay2.at(gi, j, new_buf)] = r;
      if (edge) prm.edge[edge_at(prm, kCh, new_buf, c, own_edge(gi, r0), j)] = r;
    }
  }
}

template <int kSlots, int kCh>
__global__ void __launch_bounds__(kMaxThreads, 1)
    resident_pde8_kernel(const __grid_constant__ Params prm) {
  extern __shared__ float smem[];
  const int h = prm.h, w = prm.w, hw = (w + 1) >> 1;
  const int r0 = static_cast<int>(blockIdx.x) * prm.rows;
  const Layout lay2{r0, prm.rows, hw, 2};
  const int r1 = min(r0 + prm.rows, h);
  const int rows = r1 - r0;
  const int xstride = 4 * (prm.rows + 2) * hw;  // a channel: two colours, two buffers
  const int wplane = 2 * prm.rows * hw;
  float* sx = smem;
  float* swt = smem + kCh * xstride;

  uint32_t pos[kSlots];
  slot_positions<kSlots>(pos, rows, hw);
  float2 sl[2][kSlots][kCh];
  uint32_t bits = 0;
  pde8_prepare<0, kSlots, kCh>(prm, pos, sl, &bits, sx, xstride, swt, wplane, lay2, r1);
  pde8_prepare<1, kSlots, kCh>(prm, pos, sl, &bits, sx, xstride, swt, wplane, lay2, r1);
  run_phases(prm, sx, kCh, xstride, lay2, r1, [&](int c, int it) {
    if (c == 0) {
      pde8_phase<0, kSlots, kCh>(prm, pos, sl, bits, sx, xstride, swt, wplane, lay2, r1, it);
    } else {
      pde8_phase<1, kSlots, kCh>(prm, pos, sl, bits, sx, xstride, swt, wplane, lay2, r1, it);
    }
  });

  // each thread writes its own pixels out; after a sweep the border takes
  // the value at (clamp(i, 1, H-2), clamp(j, 1, W-2)), which lies in the band
  // (the plan gives every band, the last one too, two rows at least)
  const int out_buf = prm.iters & 1;
#pragma unroll
  for (int k = 0; k < 2 * kSlots; ++k) {
    int gi, j;
    if (!(k < kSlots ? slot_pixel<0>(pos[k], r0, w, &gi, &j)
                     : slot_pixel<1>(pos[k - kSlots], r0, w, &gi, &j)))
      continue;
    int si = gi, sj = j;
    if (prm.iters > 0) {
      si = min(max(gi, 1), h - 2);
      sj = min(max(j, 1), w - 2);
    }
    const int q = lay2.at(si, sj, out_buf);
    const size_t p = static_cast<size_t>(gi) * w + j;
#pragma unroll
    for (int c = 0; c < kCh; ++c) prm.out[c][p] = sx[c * xstride + q];
  }
}

using Kernel = void (*)(const Params);

// the instantiated slots a thread (per colour) and channels
Kernel pick(int family, int slots, int channels) {
  if (family == kLlin8) {
    if (channels != 1) return nullptr;
    switch (slots) {
      case 1: return resident_llin8_kernel<1>;
      case 2: return resident_llin8_kernel<2>;
      case 3: return resident_llin8_kernel<3>;
      case 4: return resident_llin8_kernel<4>;
      default: return nullptr;
    }
  }
#define PDE8_SLOTS(C)                                  \
  switch (slots) {                                     \
    case 1: return resident_pde8_kernel<1, C>;         \
    case 2: return resident_pde8_kernel<2, C>;         \
    case 3: return resident_pde8_kernel<3, C>;         \
    case 4: return resident_pde8_kernel<4, C>;         \
    case 5: return resident_pde8_kernel<5, C>;         \
    default: return nullptr;                           \
  }
  switch (channels) {
    case 1: PDE8_SLOTS(1)
    case 2: PDE8_SLOTS(2)
    case 3: PDE8_SLOTS(3)
    default: return nullptr;
  }
#undef PDE8_SLOTS
}

// llin8: dU, dV in two buffers and U, V in one, both colours of the band and
// its two halo rows, and nine weight planes of both colours of the band;
// pde8: each channel's X in two buffers, and eight weight planes
int64_t smem_bytes_of(int family, int64_t channels, int64_t rows, int64_t w) {
  const int64_t hw = (w + 1) / 2, halo_planes = 2 * (rows + 2) * hw, band_planes = 2 * rows * hw;
  const int64_t floats = family == kLlin8 ? 6 * halo_planes + 9 * band_planes
                                          : 2 * channels * halo_planes + 8 * band_planes;
  return floats * static_cast<int64_t>(sizeof(float));
}

// The plan's rules (kernels/resident_cuda.py::plan_resident makes only plans
// that keep them).
bool plan_ok(int family, int channels, int h, int w, int iters, int scope, int blocks, int rows,
             int threads, int slots) {
  if (family != kLlin8 && family != kPde8) return false;
  if (iters < 0 || pick(family, slots, channels) == nullptr) return false;
  if (family == kPde8 && (h < 3 || w < 3)) return false;
  return resident::bands_ok(h, w, scope, blocks, rows, threads, slots,
                            smem_bytes_of(family, channels, rows, w), family == kPde8);
}

int launch(int family, int channels, const Params& prm, int threads, int slots, void* stream) {
  if (!plan_ok(family, channels, prm.h, prm.w, prm.iters, prm.scope, prm.blocks, prm.rows,
               threads, slots) ||
      (prm.scope == kGrid && prm.edge == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return resident::launch(reinterpret_cast<const void*>(pick(family, slots, channels)), prm,
                          prm.scope, prm.blocks, 1, threads,
                          static_cast<int>(smem_bytes_of(family, channels, prm.rows, prm.w)),
                          stream);
}

}  // namespace

extern "C" {

// ptrs: the 17 contiguous (H, W) float32 planes u v du dv m cu cv duc dvc ww
// wnw wn wne we wse ws wsw on the current device; du_out, dv_out receive
// (dU, dV) after `iters` sweeps; edge: resident8_edge_floats(0, 1, blocks,
// w) floats of scratch on the grid (scope 2), else unused. One launch on
// `stream` with the plan (scope 0 one block, 1 a cluster, 2 a cooperative
// grid; `blocks` bands of `rows` rows, `threads` threads, `slots` pixels of
// each colour a thread).
int resident_flow_llin8(const void* const* ptrs, void* du_out, void* dv_out, void* edge, int h,
                        int w, int iters, float omega, float one_minus_omega, int scope,
                        int blocks, int rows, int threads, int slots, void* stream) {
  Params prm = {};
  for (int f = 0; f < 17; ++f) prm.in[f] = static_cast<const float*>(ptrs[f]);
  prm.out[0] = static_cast<float*>(du_out);
  prm.out[1] = static_cast<float*>(dv_out);
  prm.edge = static_cast<float*>(edge);
  prm.h = h;
  prm.w = w;
  prm.rows = rows;
  prm.blocks = blocks;
  prm.iters = iters;
  prm.scope = scope;
  prm.omega = omega;
  prm.one_minus_omega = one_minus_omega;
  return launch(kLlin8, 1, prm, threads, slots, stream);
}

// x, trace, b, outs: `channels` (H, W) float32 planes each (a TRACE or B
// shared by the channels repeats its pointer); weights: the 8 (H, W) planes
// ww wnw wn wne we wse ws wsw shared by the channels. H, W >= 3, channels
// 1 to 3. edge as resident_flow_llin8's, resident8_edge_floats(1, channels,
// blocks, w) floats. One launch, as resident_flow_llin8.
int resident_pde8(const void* const* x, const void* const* trace, const void* const* b,
                  const void* const* weights, void* const* outs, void* edge, int channels, int h,
                  int w, int iters, float omega, float one_minus_omega, int scope, int blocks,
                  int rows, int threads, int slots, void* stream) {
  if (channels < 1 || channels > kMaxChannels) return static_cast<int>(cudaErrorInvalidValue);
  Params prm = {};
  for (int f = 0; f < 8; ++f) prm.in[f] = static_cast<const float*>(weights[f]);
  for (int c = 0; c < channels; ++c) {
    prm.x[c] = static_cast<const float*>(x[c]);
    prm.trace[c] = static_cast<const float*>(trace[c]);
    prm.b[c] = static_cast<const float*>(b[c]);
    prm.out[c] = static_cast<float*>(outs[c]);
  }
  prm.edge = static_cast<float*>(edge);
  prm.h = h;
  prm.w = w;
  prm.rows = rows;
  prm.blocks = blocks;
  prm.iters = iters;
  prm.scope = scope;
  prm.omega = omega;
  prm.one_minus_omega = one_minus_omega;
  return launch(kPde8, channels, prm, threads, slots, stream);
}

// A block's shared memory for a band of `rows` rows of width w (family 0
// llin8, 1 pde8 with `channels` channels), as the plan counts it.
int resident8_smem_bytes(int family, int channels, int rows, int w) {
  return static_cast<int>(smem_bytes_of(family, channels, rows, w));
}

// Floats of the grid's band-edge scratch: two buffers of the first and last
// row of each of `blocks` bands, for each relaxed field (llin8: dU, dV;
// pde8: a channel each).
int64_t resident8_edge_floats(int family, int channels, int blocks, int w) {
  return static_cast<int64_t>(2) * (family == kLlin8 ? 2 : channels) * 2 * blocks * w;
}

const char* resident8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
