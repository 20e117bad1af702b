// Resident red-black SOR: one launch runs a whole solver call, the prepare and
// all `iters` sweeps, with the level held on chip between colours. Four
// families, all 4-neighbour:
//   * llin4: the increments (dU, dV) of the warping flow against the frozen
//     flow (U, V), every pixel relaxed (models/flow_nd.py);
//   * elin4: the flow (U, V) itself, early-linearised, every pixel relaxed,
//     no frozen flow (models/flow_hs.py with solver=1). It is llin4's kernel
//     without the frozen fields and the - U_c sum w term; the per-pixel
//     arithmetic of both is flow_update.cuh's, so each equals the global
//     kernel flow_llin4_sor.cu bit for bit;
//   * disp llin4: the scalar disparity increment dU against the frozen U,
//     interior pixels relaxed, the 1-px border replicated after every sweep
//     (models/disparity.py; models/disparity_sym.py's pair as a batch of 2,
//     each entry its own set of pointers, so the pair is never stacked);
//   * pde4: the diagonal form X+ = (1-w) X + w (B + sum_k w_k X_k) / TRACE
//     over up to 3 channels with shared (H, W) weights (models/tv_denoise.py,
//     tv_denoise4), interior pixels relaxed, the border replicated after every
//     sweep. A thread relaxes every channel of the pixels it owns, so a
//     pixel's weights and their sum are read once for all channels.
// The disp and pde4 arithmetic is disp_update.cuh's and pde4_update.cuh's,
// every operation rounded alone, so the result equals both the global kernel
// (interior_sor.cu) and the plain version bit for bit.
//
// Replaces the TPU kernels:
//   * pde_tpu/kernels/sor_pallas.py:71 _kernel, the VMEM-resident llin4
//     kernel (the whole level loaded once, all sweeps in VMEM, dU and dV
//     written back);
//   * pde_tpu/kernels/tiled.py:113 _stripe_kernel and :172
//     _stripe_kernel_db driving pde_tpu/kernels/sweeps.py:66
//     flow_llin4_sweep, sweeps.py:234 flow_elin4_sweep, sweeps.py:145
//     disp_llin4_sweep and sweeps.py:174 pde4_sweep (one launch a call on the
//     TPU: k_max = iters there).
// Plain PyTorch versions: pde_tpu_torch/solvers/sor.py::sor_flow_llin4,
// ::sor_flow_elin4, ::sor_disp_llin4 and ::sor_pde4.
//
// Design. A block owns a band of whole rows; each thread owns fixed pixels of
// it, `slots` of each colour: slot k of colour c of thread t is pixel
// (r0 + q / hw, 2 (q % hw) + parity) with q = t + k * threads, hw = ceil(W/2),
// so every lane of a warp relaxes a pixel in every colour phase. A pixel's
// coefficients are read from device memory once a call and kept in registers
// (llin4, elin4: the edge-zeroed weights, their sum, 1/(sum + Du),
// 1/(sum + Dv), the NaN-folded M, Cu, Cv; disp: the weights, U_c sum w, Cu,
// 1/(sum + Du); pde4: the weights and 1/TRACE and B of each channel; the NaN
// flags as bits of one word). Only what neighbours read sits in shared
// memory: dU, dV, U, V (llin4), U, V (elin4), dU, U (disp) or each channel's
// X (pde4), for the band and one halo row above and below, each field split
// into a plane per colour, so that a colour phase reads the other plane at
// consecutive addresses across a warp (no bank conflicts; interleaved
// colours gave every load a 2-way conflict). A 4-neighbour pixel reads only
// the other colour, so one buffer a field is enough. A barrier after every
// colour keeps the global red-black order, so the result does not depend on
// how pixels are split among blocks. The barrier's scope follows the level's
// size (the plan, kernels/resident_cuda.py::plan_resident):
//   * one block (__syncthreads) for the levels one SM holds;
//   * a thread block cluster of up to 16 blocks (cluster.sync()); a block
//     reads the edge rows of the relaxed fields of the blocks above and below
//     from their shared memory (distributed shared memory);
//   * the whole card, a cooperative grid of co-resident blocks (grid.sync());
//     a block writes the pixels of its first and last rows that it relaxed to
//     the output as well, and its neighbours read them from there through L2
//     (ld.global.cg), so no scratch is needed. The outputs are new tensors:
//     they never alias the inputs, which elin4 and pde4 read in the prepare.
// The frozen U and V (U) never change: their halo rows are staged once.
//
// The disp and pde4 border: the plain version replicates the border after
// every sweep. After the first sweep a filled border neighbour of an interior
// pixel holds that pixel's own value (border (0, j) takes (1, j), and so on;
// for pde4 each channel's its own), so from the second sweep on an interior
// pixel reads its own value where its neighbour is on the border, and the
// border itself is filled once, when the band is written out. That needs no
// barrier of its own and gives the same bits. It holds for H, W >= 3;
// smaller fields (no interior, or a fill that swaps rows) stay with the
// global kernel.
//
// What bounds it: not bytes but the latency of its phases. A call reads each
// input once and writes the outputs once (60 B/px llin4, 52 B/px elin4, 36
// B/px disp, 64 B/px pde4 at C = 3: a few microseconds at 480x640), but runs
// 2 iters colour phases, each a pass of dependent shared-memory loads and
// ~16-40 flops a slot (and channel), ended by a barrier; the global kernels
// paid a launch (~2 us of device time even for a small level) and a round
// trip through device memory for each phase instead. On an H100 a sweep
// costs ~0.8 us in one block, ~2.2 us in a cluster and ~3-5 us on the grid,
// where the barrier dominates (PERF.md, row 1). So the design keeps one
// launch, no device-memory traffic between phases, the cheapest barrier that
// spans the level, and few slots a thread (the slots run one after another
// within a phase); the plan weighs slots against the barrier's cost. A slot's
// indices are recomputed each phase (`opaque`) rather than kept live across
// the sweeps: held, they took the registers the coefficients need and
// spilled at 3 and 4 slots.
//
// The scope's machinery (the barrier, the layout, the cluster's reads, the
// co-residency checks and the launch) is resident_scope.cuh, shared with the
// 8-neighbour families of resident8_sor.cu. The launch goes through
// cudaLaunchKernelEx with the cluster dimension or the cooperative attribute.
// Before launching, the C entry checks that the plan is one the kernel takes
// and that the grid can be co-resident
// (cudaOccupancyMaxActiveClusters / cudaOccupancyMaxActiveBlocksPerMultiprocessor);
// otherwise it returns an error, and the wrapper raises. The kernels run on
// the caller's stream and allocate nothing; the C entry points return
// cudaGetLastError() of the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "disp_update.cuh"
#include "flow_update.cuh"
#include "pde4_update.cuh"
#include "resident_scope.cuh"

namespace {

using resident::kGrid;
using resident::Layout;
using resident::opaque;
using resident::scope_sync;
using resident::slot_at;
using resident::slot_pixel;
using resident::slot_positions;
using resident::stage_halo;

constexpr int kMaxThreads = resident::kMaxThreads;
constexpr int kMaxBatch = 3;  // disp's pair, pde4's channels

enum Family { kLlin4 = 0, kDisp = 1, kPde4 = 2, kElin4 = 3 };

// the input planes a batch entry: llin4 u v du dv m cu cv duc dvc ww wn we
// ws; elin4 u v m cu cv duc dvc ww wn we ws; disp u du cu duc ww wn we ws;
// pde4 x trace b of each channel, and ww wn we ws with channel 0's
constexpr int kMaxIn = 13;

struct Params {
  const float* in[kMaxBatch][kMaxIn];
  float* out[kMaxBatch][2];
  int h, w, rows, iters, scope;
  float omega, one_minus_omega;
};

// the (H, W) planes a band keeps in shared memory, each with its halo rows
int fields_in_smem(int family, int batch) {
  switch (family) {
    case kLlin4: return 4;
    case kPde4: return batch;
    default: return 2;
  }
}

// The value at row gi of the halo, just above (gi = r0 - 1) or below
// (gi = r1) the band, of a relaxed field: in the cluster, from the shared
// memory `s` of the neighbouring block; on the grid, from the output, where
// the block that owns the row wrote it.
__device__ __forceinline__ float halo_at(const float* s, const float* out, int gi, int j,
                                         Layout lay, int w, int scope) {
  if (scope == kGrid) return __ldcg(out + static_cast<size_t>(gi) * w + j);
  return resident::cluster_at(s, gi, j, lay);
}

// ---- llin4, elin4 ----------------------------------------------------------

// What a flow pixel keeps in registers (flow_sor::Coef without its flags,
// which go to a bit word; elin4 never reads wsum).
struct FlowSlot {
  float a, b, c, d, wsum, inv_u, inv_v, m0, cu0, cv0;
};

// A block's shared fields: the relaxed pair (dU, dV for llin4, U, V for
// elin4) and llin4's frozen U, V.
struct Fields {
  float *du, *dv, *u, *v;
};

// Stage the slots' pixels of every field and keep their coefficients. kLate:
// llin4, whose relaxed pair is inputs 2, 3 and coefficients start at 4;
// else elin4: the pair is inputs 0, 1, the coefficients start at 2.
template <bool kLate, int kC, int kSlots>
__device__ __forceinline__ void flow_prepare(const Params& prm, const uint32_t (&pos)[kSlots],
                                             FlowSlot (&sl)[2][kSlots], uint32_t* bits,
                                             Fields smem, Layout lay, int r1) {
  constexpr int kF = kLate ? 2 : 0, kK = kLate ? 4 : 2;
  const float* const* in = prm.in[0];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    int gi, j;
    if (!slot_pixel<kC>(pos[k], lay.r0, prm.w, &gi, &j)) continue;
    const size_t p = static_cast<size_t>(gi) * prm.w + j;
    const float du = in[kF][p], dv = in[kF + 1][p];
    const flow_sor::Coef f = flow_sor::prepare(
        gi, j, prm.h, prm.w, in[kK + 5][p], in[kK + 6][p], in[kK + 7][p], in[kK + 8][p],
        in[kK][p], in[kK + 1][p], in[kK + 2][p], in[kK + 3][p], in[kK + 4][p]);
    const int q = lay.at(gi, j);
    if (kLate) {
      smem.u[q] = in[0][p];
      smem.v[q] = in[1][p];
    }
    smem.du[q] = du;
    smem.dv[q] = dv;
    if (prm.scope == kGrid && (gi == lay.r0 || gi == r1 - 1)) {  // for the neighbours
      prm.out[0][0][p] = du;
      prm.out[0][1][p] = dv;
    }
    sl[kC][k] = {f.a, f.b, f.c, f.d, f.wsum, f.inv_u, f.inv_v, f.m0, f.cu0, f.cv0};
    const int s = kC * kSlots + k;
    *bits |= (1u << s) | (static_cast<uint32_t>(f.flags) << (16 + 2 * s));
  }
}

// One colour phase of llin4 (kLate) or elin4: every slot of colour kC
// relaxed in place.
template <bool kLate, int kC, int kSlots>
__device__ __forceinline__ void flow_phase(const Params& prm, const uint32_t (&pos)[kSlots],
                                           const FlowSlot (&sl)[2][kSlots], uint32_t bits,
                                           Fields f, Layout lay, int r1) {
  const int h = prm.h, w = prm.w, r0 = lay.r0;
  const bool grid = prm.scope == kGrid;
  float* out_du = prm.out[0][0];
  float* out_dv = prm.out[0][1];
  float *sdu = f.du, *sdv = f.dv;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int s = kC * kSlots + k;
    if (!((bits >> s) & 1u)) continue;
    int gi, j;
    slot_at<kC>(pos[k], r0, &gi, &j);
    const int q = lay.at(gi, j);
    // neighbours clamp at the edge to the pixel itself (their weights are
    // zero there), as the global kernel's do
    const int qw = j > 0 ? lay.at(gi, j - 1) : q;
    const int qe = j < w - 1 ? lay.at(gi, j + 1) : q;
    const int qn = gi > 0 ? lay.at(gi - 1, j) : q;
    const int qs = gi < h - 1 ? lay.at(gi + 1, j) : q;
    float dun, dvn, dus, dvs;
    if (gi > r0 || gi == 0) {
      dun = sdu[qn];
      dvn = sdv[qn];
    } else {
      dun = halo_at(sdu, out_du, gi - 1, j, lay, w, prm.scope);
      dvn = halo_at(sdv, out_dv, gi - 1, j, lay, w, prm.scope);
    }
    if (gi < r1 - 1 || gi == h - 1) {
      dus = sdu[qs];
      dvs = sdv[qs];
    } else {
      dus = halo_at(sdu, out_du, gi + 1, j, lay, w, prm.scope);
      dvs = halo_at(sdv, out_dv, gi + 1, j, lay, w, prm.scope);
    }
    const FlowSlot& c = sl[kC][k];
    const flow_sor::Nbr fu_n{sdu[qw], sdu[qe], dun, dus};
    const flow_sor::Nbr fv_n{sdv[qw], sdv[qe], dvn, dvs};
    float su_, sv_;
    if (kLate) {
      const float* su = f.u;
      const float* sv = f.v;
      su_ = flow_sor::diffusion<true>(fu_n, {su[qw], su[qe], su[qn], su[qs]}, su[q], c.a, c.b,
                                      c.c, c.d, c.wsum);
      sv_ = flow_sor::diffusion<true>(fv_n, {sv[qw], sv[qe], sv[qn], sv[qs]}, sv[q], c.a, c.b,
                                      c.c, c.d, c.wsum);
    } else {
      su_ = flow_sor::diffusion<false>(fu_n, fu_n, 0.0f, c.a, c.b, c.c, c.d, 0.0f);
      sv_ = flow_sor::diffusion<false>(fv_n, fv_n, 0.0f, c.a, c.b, c.c, c.d, 0.0f);
    }
    const uint8_t flags = static_cast<uint8_t>((bits >> (16 + 2 * s)) & 3u);
    const float2 r = flow_sor::update(sdu[q], sdv[q], su_, sv_, flags, c.m0, c.cu0, c.cv0,
                                      c.inv_u, c.inv_v, prm.omega, prm.one_minus_omega);
    sdu[q] = r.x;
    sdv[q] = r.y;
    if (grid && (gi == r0 || gi == r1 - 1)) {
      const size_t p = static_cast<size_t>(gi) * w + j;
      out_du[p] = r.x;
      out_dv[p] = r.y;
    }
  }
}

template <bool kLate, int kSlots>
__global__ void __launch_bounds__(kMaxThreads, 1)
    resident_flow4_kernel(const __grid_constant__ Params prm) {
  extern __shared__ float smem[];
  const int h = prm.h, w = prm.w, hw = (w + 1) >> 1;
  const Layout lay{static_cast<int>(blockIdx.x) * prm.rows, prm.rows, hw};
  const int r0 = lay.r0;
  const int r1 = min(r0 + prm.rows, h);
  const int rows = r1 - r0;
  const int plane = 2 * (prm.rows + 2) * hw;
  // llin4 also keeps the frozen U, V (elin4 has only the first two planes)
  const Fields f{smem, smem + plane, smem + 2 * plane, smem + 3 * plane};

  // every own pixel with its coefficients (on the grid the band's edge rows
  // of the relaxed pair also into the output for the neighbours), and
  // llin4's halo rows of U, V
  uint32_t pos[kSlots];
  slot_positions<kSlots>(pos, rows, hw);
  FlowSlot sl[2][kSlots];
  uint32_t bits = 0;
  flow_prepare<kLate, 0, kSlots>(prm, pos, sl, &bits, f, lay, r1);
  flow_prepare<kLate, 1, kSlots>(prm, pos, sl, &bits, f, lay, r1);
  if (kLate) stage_halo(f.u, prm.in[0][0], f.v, prm.in[0][1], lay, rows, h, w);
  scope_sync(prm.scope);

  for (int it = 0; it < prm.iters; ++it) {
    flow_phase<kLate, 0, kSlots>(prm, pos, sl, bits, f, lay, r1);
    scope_sync(prm.scope);
    flow_phase<kLate, 1, kSlots>(prm, pos, sl, bits, f, lay, r1);
    scope_sync(prm.scope);
  }

  // each thread writes its own pixels out
#pragma unroll
  for (int k = 0; k < 2 * kSlots; ++k) {
    int gi, j;
    if (!(k < kSlots ? slot_pixel<0>(pos[k], r0, w, &gi, &j)
                     : slot_pixel<1>(pos[k - kSlots], r0, w, &gi, &j)))
      continue;
    const int q = lay.at(gi, j);
    const size_t p = static_cast<size_t>(gi) * w + j;
    prm.out[0][0][p] = f.du[q];
    prm.out[0][1][p] = f.dv[q];
  }
}

// ---- disp ------------------------------------------------------------------

// What a disp pixel keeps in registers (disp_sor::Coef without its NaN flag,
// which goes to a bit word).
struct DispSlot {
  float a, b, c, d, uw, cu0, inv;
};

// Stage the slots' pixels of dU and U and keep the coefficients of the
// interior ones.
template <int kC, int kSlots>
__device__ __forceinline__ void disp_prepare(const Params& prm, const uint32_t (&pos)[kSlots],
                                             DispSlot (&sl)[2][kSlots], uint32_t* bits,
                                             float* sdu, float* su, Layout lay, int r1) {
  const float* const* in = prm.in[blockIdx.y];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    int gi, j;
    if (!slot_pixel<kC>(pos[k], lay.r0, prm.w, &gi, &j)) continue;
    const size_t p = static_cast<size_t>(gi) * prm.w + j;
    const float u = in[0][p], du = in[1][p];
    const int q = lay.at(gi, j);
    su[q] = u;
    sdu[q] = du;
    if (prm.scope == kGrid && (gi == lay.r0 || gi == r1 - 1))  // for the neighbours
      prm.out[blockIdx.y][0][p] = du;
    if (gi < 1 || gi > prm.h - 2 || j < 1 || j > prm.w - 2) continue;  // interior only
    const disp_sor::Coef f =
        disp_sor::prepare(in[4][p], in[5][p], in[6][p], in[7][p], u, in[2][p], in[3][p]);
    sl[kC][k] = {f.a, f.b, f.c, f.d, f.uw, f.cu0, f.inv};
    const int s = kC * kSlots + k;
    *bits |= (1u << s) | ((f.cu_nan ? 1u : 0u) << (16 + s));
  }
}

// One colour phase of disp: every interior slot of colour kC relaxed in
// place. From the second sweep on (`filled`) a border neighbour reads as the
// pixel's own dU (the border shortcut above).
template <int kC, int kSlots>
__device__ __forceinline__ void disp_phase(const Params& prm, const uint32_t (&pos)[kSlots],
                                           const DispSlot (&sl)[2][kSlots], uint32_t bits,
                                           float* sdu, const float* su, Layout lay, int r1,
                                           bool filled) {
  const int h = prm.h, w = prm.w, r0 = lay.r0;
  const bool grid = prm.scope == kGrid;
  float* out = prm.out[blockIdx.y][0];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int s = kC * kSlots + k;
    if (!((bits >> s) & 1u)) continue;
    const uint32_t pk = opaque(pos[k]);
    const int gi = r0 + static_cast<int>(pk >> 16);
    const int j = 2 * static_cast<int>(pk & 0xffffu) + ((gi + kC) & 1);
    const int q = lay.at(gi, j);
    const int qw = lay.at(gi, j - 1), qe = lay.at(gi, j + 1);
    const int qn = lay.at(gi - 1, j), qs = lay.at(gi + 1, j);
    const float du_c = sdu[q];
    const float du_w = (filled && j == 1) ? du_c : sdu[qw];
    const float du_e = (filled && j == w - 2) ? du_c : sdu[qe];
    float du_n, du_s;
    if (filled && gi == 1) {
      du_n = du_c;
    } else if (gi > r0) {
      du_n = sdu[qn];
    } else {
      du_n = halo_at(sdu, out, gi - 1, j, lay, w, prm.scope);
    }
    if (filled && gi == h - 2) {
      du_s = du_c;
    } else if (gi < r1 - 1) {
      du_s = sdu[qs];
    } else {
      du_s = halo_at(sdu, out, gi + 1, j, lay, w, prm.scope);
    }
    const DispSlot& c = sl[kC][k];
    const disp_sor::Coef coef{c.a, c.b, c.c, c.d, c.uw, c.cu0, c.inv,
                              ((bits >> (16 + s)) & 1u) != 0};
    const float r = disp_sor::update(du_c, du_w, su[qw], du_e, su[qe], du_n, su[qn], du_s,
                                     su[qs], coef, prm.omega, prm.one_minus_omega);
    sdu[q] = r;
    if (grid && (gi == r0 || gi == r1 - 1)) out[static_cast<size_t>(gi) * w + j] = r;
  }
}

template <int kSlots>
__global__ void __launch_bounds__(kMaxThreads, 1)
    resident_disp_kernel(const __grid_constant__ Params prm) {
  extern __shared__ float smem[];
  const int h = prm.h, w = prm.w, hw = (w + 1) >> 1;
  const Layout lay{static_cast<int>(blockIdx.x) * prm.rows, prm.rows, hw};
  const int r0 = lay.r0;
  const int r1 = min(r0 + prm.rows, h);
  const int rows = r1 - r0;
  float* sdu = smem;
  float* su = smem + 2 * (prm.rows + 2) * hw;
  const float* const* in = prm.in[blockIdx.y];
  float* out = prm.out[blockIdx.y][0];

  uint32_t pos[kSlots];
  slot_positions<kSlots>(pos, rows, hw);
  DispSlot sl[2][kSlots];
  uint32_t bits = 0;
  disp_prepare<0, kSlots>(prm, pos, sl, &bits, sdu, su, lay, r1);
  disp_prepare<1, kSlots>(prm, pos, sl, &bits, sdu, su, lay, r1);
  stage_halo(su, in[0], nullptr, nullptr, lay, rows, h, w);
  scope_sync(prm.scope);

  for (int it = 0; it < prm.iters; ++it) {
    disp_phase<0, kSlots>(prm, pos, sl, bits, sdu, su, lay, r1, it > 0);
    scope_sync(prm.scope);
    disp_phase<1, kSlots>(prm, pos, sl, bits, sdu, su, lay, r1, it > 0);
    scope_sync(prm.scope);
  }

  // each thread writes its own pixels out; after a sweep the border takes
  // the value at (clamp(i, 1, H-2), clamp(j, 1, W-2)), which lies in the band
  // (the plan gives every band, the last one too, two rows at least)
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
    out[static_cast<size_t>(gi) * w + j] = sdu[lay.at(si, sj)];
  }
}

// ---- pde4 ------------------------------------------------------------------

// Load the slots' pixels of every channel (into `xv`) and keep the
// coefficients of the interior ones: the four weights, and 1/TRACE and B of
// each channel. Loads only: the stores follow once both colours are loaded
// (pde4_stage), so that no load waits behind a store to an output that the
// compiler cannot tell from the inputs.
template <int kC, int kSlots, int kCh>
__device__ __forceinline__ void pde4_load(const Params& prm, const uint32_t (&pos)[kSlots],
                                          pde4_sor::Weights (&wt)[2][kSlots],
                                          float2 (&sl)[2][kSlots][kCh],
                                          float (&xv)[2][kSlots][kCh], uint32_t* bits, int r0) {
  const int h = prm.h, w = prm.w;
  const float* const* in = prm.in[0];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    int gi, j;
    if (!slot_pixel<kC>(pos[k], r0, w, &gi, &j)) continue;
    const size_t p = static_cast<size_t>(gi) * w + j;
#pragma unroll
    for (int c = 0; c < kCh; ++c) xv[kC][k][c] = prm.in[c][0][p];
    if (gi < 1 || gi > h - 2 || j < 1 || j > w - 2) continue;  // interior only
    const pde4_sor::Weights k4{in[3][p], in[4][p], in[5][p], in[6][p]};
    wt[kC][k] = k4;
    const float wsum = pde4_sor::weight_sum(k4);
#pragma unroll
    for (int c = 0; c < kCh; ++c)
      sl[kC][k][c] = pde4_sor::diagonal(prm.in[c][1][p], prm.in[c][2][p], wsum);
    *bits |= 1u << (kC * kSlots + k);
  }
}

// Stage the slots' pixels of every channel in shared memory (on the grid a
// band's edge rows also in the output, for the neighbours).
template <int kC, int kSlots, int kCh>
__device__ __forceinline__ void pde4_stage(const Params& prm, const uint32_t (&pos)[kSlots],
                                           const float (&xv)[2][kSlots][kCh], float* sx,
                                           int xstride, Layout lay, int r1) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    int gi, j;
    if (!slot_pixel<kC>(pos[k], lay.r0, prm.w, &gi, &j)) continue;
    const int q = lay.at(gi, j);
    const bool edge = prm.scope == kGrid && (gi == lay.r0 || gi == r1 - 1);
    const size_t p = static_cast<size_t>(gi) * prm.w + j;
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      sx[c * xstride + q] = xv[kC][k][c];
      if (edge) prm.out[c][0][p] = xv[kC][k][c];
    }
  }
}

// One colour phase of pde4: every interior slot of colour kC, all its
// channels, relaxed in place. From the second sweep on (`filled`) a border
// neighbour reads as the pixel's own X of that channel (the border
// shortcut). A slot on a band's edge row loads the neighbouring band's value
// of every channel before it stores any: a store to one channel's output (on
// the grid) would otherwise hold back the next channel's load from L2 (the
// compiler cannot tell the channels' planes apart), one round trip a
// channel.
template <int kC, int kSlots, int kCh>
__device__ __forceinline__ void pde4_phase(const Params& prm, const uint32_t (&pos)[kSlots],
                                           const pde4_sor::Weights (&wt)[2][kSlots],
                                           const float2 (&sl)[2][kSlots][kCh], uint32_t bits,
                                           float* sx, int xstride, Layout lay, int r1,
                                           bool filled) {
  const int h = prm.h, w = prm.w, r0 = lay.r0;
  const bool grid = prm.scope == kGrid;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (!((bits >> (kC * kSlots + k)) & 1u)) continue;
    int gi, j;
    slot_at<kC>(pos[k], r0, &gi, &j);
    const int q = lay.at(gi, j);
    const int qw = lay.at(gi, j - 1), qe = lay.at(gi, j + 1);
    const int qn = lay.at(gi - 1, j), qs = lay.at(gi + 1, j);
    const bool own_w = filled && j == 1, own_e = filled && j == w - 2;
    const bool own_n = filled && gi == 1, own_s = filled && gi == h - 2;
    // a band has two rows at least, so at most one of these
    const bool halo_n = !own_n && gi == r0 && r0 > 0;
    const bool halo_s = !own_s && gi == r1 - 1 && r1 < h;
    float hal[kCh];
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      if (halo_n || halo_s)
        hal[c] = halo_at(sx + c * xstride, prm.out[c][0], halo_n ? gi - 1 : gi + 1, j, lay, w,
                         prm.scope);
    }
    const bool edge = grid && (gi == r0 || gi == r1 - 1);
    const size_t p = static_cast<size_t>(gi) * w + j;
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      float* xs = sx + c * xstride;
      const float xc = xs[q];
      const float xw = own_w ? xc : xs[qw];
      const float xe = own_e ? xc : xs[qe];
      const float xn = own_n ? xc : halo_n ? hal[c] : xs[qn];
      const float xs_ = own_s ? xc : halo_s ? hal[c] : xs[qs];
      const float r = pde4_sor::update(xc, xw, xe, xn, xs_, wt[kC][k], sl[kC][k][c], prm.omega,
                                       prm.one_minus_omega);
      xs[q] = r;
      if (edge) prm.out[c][0][p] = r;
    }
  }
}

// Each thread writes its own pixels of every channel (`stride` floats apart
// in shared memory `s`) out; after a sweep the border takes the value at
// (clamp(i, 1, H-2), clamp(j, 1, W-2)), which lies in the band (the plan
// gives every band, the last one too, two rows at least).
template <int kSlots, int kCh>
__device__ __forceinline__ void pde4_write(const Params& prm, const uint32_t (&pos)[kSlots],
                                           const float* s, int stride, Layout lay) {
  const int h = prm.h, w = prm.w;
#pragma unroll
  for (int k = 0; k < 2 * kSlots; ++k) {
    int gi, j;
    if (!(k < kSlots ? slot_pixel<0>(pos[k], lay.r0, w, &gi, &j)
                     : slot_pixel<1>(pos[k - kSlots], lay.r0, w, &gi, &j)))
      continue;
    int si = gi, sj = j;
    if (prm.iters > 0) {
      si = min(max(gi, 1), h - 2);
      sj = min(max(j, 1), w - 2);
    }
    const int q = lay.at(si, sj);
    const size_t p = static_cast<size_t>(gi) * w + j;
#pragma unroll
    for (int c = 0; c < kCh; ++c) prm.out[c][0][p] = s[c * stride + q];
  }
}

template <int kSlots, int kCh>
__global__ void __launch_bounds__(kMaxThreads, 1)
    resident_pde4_kernel(const __grid_constant__ Params prm) {
  extern __shared__ float smem[];
  const int hw = (prm.w + 1) >> 1;
  const Layout lay{static_cast<int>(blockIdx.x) * prm.rows, prm.rows, hw};
  const int r1 = min(lay.r0 + prm.rows, prm.h);
  const int xstride = 2 * (prm.rows + 2) * hw;  // a channel: both colours and the halo

  uint32_t pos[kSlots];
  slot_positions<kSlots>(pos, r1 - lay.r0, hw);
  pde4_sor::Weights wt[2][kSlots];
  float2 sl[2][kSlots][kCh];
  uint32_t bits = 0;
  {
    float xv[2][kSlots][kCh];
    pde4_load<0, kSlots, kCh>(prm, pos, wt, sl, xv, &bits, lay.r0);
    pde4_load<1, kSlots, kCh>(prm, pos, wt, sl, xv, &bits, lay.r0);
    pde4_stage<0, kSlots, kCh>(prm, pos, xv, smem, xstride, lay, r1);
    pde4_stage<1, kSlots, kCh>(prm, pos, xv, smem, xstride, lay, r1);
  }
  scope_sync(prm.scope);

  for (int it = 0; it < prm.iters; ++it) {
    pde4_phase<0, kSlots, kCh>(prm, pos, wt, sl, bits, smem, xstride, lay, r1, it > 0);
    scope_sync(prm.scope);
    pde4_phase<1, kSlots, kCh>(prm, pos, wt, sl, bits, smem, xstride, lay, r1, it > 0);
    scope_sync(prm.scope);
  }
  pde4_write<kSlots, kCh>(prm, pos, smem, xstride, lay);
}

// ---- plans and launches ----------------------------------------------------

using Kernel = void (*)(const Params);

// the instantiated slots a thread (per colour)
template <bool kLate>
Kernel pick_flow4(int slots) {
  switch (slots) {
    case 1: return resident_flow4_kernel<kLate, 1>;
    case 2: return resident_flow4_kernel<kLate, 2>;
    case 3: return resident_flow4_kernel<kLate, 3>;
    case 4: return resident_flow4_kernel<kLate, 4>;
    default: return nullptr;
  }
}

// pde4: at most 6 - C slots a thread; past that the coefficients (4 + 2 C
// floats a slot) spill
template <int kCh>
Kernel pick_pde4(int slots) {
  if (slots > 6 - kCh) return nullptr;
  switch (slots) {
    case 1: return resident_pde4_kernel<1, kCh>;
    case 2: return resident_pde4_kernel<2, kCh>;
    case 3: return resident_pde4_kernel<3, kCh>;
    case 4:
      if constexpr (kCh <= 2) return resident_pde4_kernel<4, kCh>;
      return nullptr;
    case 5:
      if constexpr (kCh == 1) return resident_pde4_kernel<5, 1>;
      return nullptr;
    default: return nullptr;
  }
}

// the kernel of a family at `slots` slots a thread (pde4: and `channels`)
Kernel pick(int family, int slots, int channels) {
  if (family != kPde4 && channels != 1) return nullptr;
  switch (family) {
    case kLlin4: return pick_flow4<true>(slots);
    case kElin4: return pick_flow4<false>(slots);
    case kDisp:
      switch (slots) {
        case 1: return resident_disp_kernel<1>;
        case 2: return resident_disp_kernel<2>;
        case 3: return resident_disp_kernel<3>;
        case 4: return resident_disp_kernel<4>;
        case 6: return resident_disp_kernel<6>;
        default: return nullptr;
      }
    case kPde4:
      switch (channels) {
        case 1: return pick_pde4<1>(slots);
        case 2: return pick_pde4<2>(slots);
        case 3: return pick_pde4<3>(slots);
        default: return nullptr;
      }
    default: return nullptr;
  }
}

// the fields' planes of both colours, the band and its two halo rows
int64_t smem_bytes_of(int family, int64_t batch, int64_t rows, int64_t w) {
  return fields_in_smem(family, static_cast<int>(batch)) * 2 * (rows + 2) * ((w + 1) / 2) *
         static_cast<int64_t>(sizeof(float));
}

// The plan's rules (kernels/resident_cuda.py::plan_resident makes only plans
// that keep them). `batch`: disp's systems (blocks of a second grid row) or
// pde4's channels (in the thread that owns a pixel).
bool plan_ok(int family, int batch, int h, int w, int iters, int scope, int blocks, int rows,
             int threads, int slots) {
  if (family < kLlin4 || family > kElin4) return false;
  const int max_batch = family == kDisp ? 2 : family == kPde4 ? kMaxBatch : 1;
  if (batch < 1 || batch > max_batch) return false;
  const bool interior = family == kDisp || family == kPde4;  // and a border fill
  if (iters < 0 || (interior && (h < 3 || w < 3))) return false;
  if (pick(family, slots, family == kPde4 ? batch : 1) == nullptr) return false;
  return resident::bands_ok(h, w, scope, blocks, rows, threads, slots,
                            smem_bytes_of(family, batch, rows, w), interior);
}

int launch(int family, const Params& prm, int batch, int blocks, int threads, int slots,
           void* stream) {
  if (!plan_ok(family, batch, prm.h, prm.w, prm.iters, prm.scope, blocks, prm.rows, threads,
               slots))
    return static_cast<int>(cudaErrorInvalidValue);
  const int channels = family == kPde4 ? batch : 1;
  return resident::launch(reinterpret_cast<const void*>(pick(family, slots, channels)), prm,
                          prm.scope, blocks, family == kDisp ? batch : 1, threads,
                          static_cast<int>(smem_bytes_of(family, batch, prm.rows, prm.w)),
                          stream);
}

// Params without its planes.
Params shape_params(int h, int w, int iters, float omega, float one_minus_omega, int scope,
                    int rows) {
  Params prm = {};
  prm.h = h;
  prm.w = w;
  prm.rows = rows;
  prm.iters = iters;
  prm.scope = scope;
  prm.omega = omega;
  prm.one_minus_omega = one_minus_omega;
  return prm;
}

}  // namespace

extern "C" {

// ptrs: the 13 contiguous (H, W) float32 planes u v du dv m cu cv duc dvc ww
// wn we ws on the current device; du_out, dv_out receive (dU, dV) after
// `iters` sweeps. One launch on `stream` with the plan (scope 0 one block,
// 1 a cluster, 2 a cooperative grid; `blocks` bands of `rows` rows, `threads`
// threads, `slots` pixels of each colour a thread).
int resident_flow_llin4(const void* const* ptrs, void* du_out, void* dv_out, int h, int w,
                        int iters, float omega, float one_minus_omega, int scope, int blocks,
                        int rows, int threads, int slots, void* stream) {
  Params prm = shape_params(h, w, iters, omega, one_minus_omega, scope, rows);
  for (int f = 0; f < 13; ++f) prm.in[0][f] = static_cast<const float*>(ptrs[f]);
  prm.out[0][0] = static_cast<float*>(du_out);
  prm.out[0][1] = static_cast<float*>(dv_out);
  return launch(kLlin4, prm, 1, blocks, threads, slots, stream);
}

// ptrs: the 11 contiguous (H, W) float32 planes u v m cu cv duc dvc ww wn we
// ws; u_out, v_out (new planes, not u, v) receive (U, V) after `iters`
// sweeps. One launch, as resident_flow_llin4.
int resident_flow_elin4(const void* const* ptrs, void* u_out, void* v_out, int h, int w,
                        int iters, float omega, float one_minus_omega, int scope, int blocks,
                        int rows, int threads, int slots, void* stream) {
  Params prm = shape_params(h, w, iters, omega, one_minus_omega, scope, rows);
  for (int f = 0; f < 11; ++f) prm.in[0][f] = static_cast<const float*>(ptrs[f]);
  prm.out[0][0] = static_cast<float*>(u_out);
  prm.out[0][1] = static_cast<float*>(v_out);
  return launch(kElin4, prm, 1, blocks, threads, slots, stream);
}

// ptrs: `batch` sets of 8 contiguous (H, W) float32 planes u du cu duc ww wn
// we ws, one set after the other; outs: `batch` (H, W) planes for dU. H, W
// >= 3. One launch, as resident_flow_llin4.
int resident_disp_llin4(const void* const* ptrs, void* const* outs, int batch, int h, int w,
                        int iters, float omega, float one_minus_omega, int scope, int blocks,
                        int rows, int threads, int slots, void* stream) {
  if (batch < 1 || batch > 2) return static_cast<int>(cudaErrorInvalidValue);
  Params prm = shape_params(h, w, iters, omega, one_minus_omega, scope, rows);
  for (int b = 0; b < batch; ++b) {
    for (int f = 0; f < 8; ++f) prm.in[b][f] = static_cast<const float*>(ptrs[8 * b + f]);
    prm.out[b][0] = static_cast<float*>(outs[b]);
  }
  return launch(kDisp, prm, batch, blocks, threads, slots, stream);
}

// x, trace, b, outs: `channels` (H, W) float32 planes each (a TRACE or B
// shared by the channels repeats its pointer); weights: the 4 (H, W) planes
// ww wn we ws shared by the channels. H, W >= 3, channels 1 to 3. One
// launch, as resident_flow_llin4.
int resident_pde4(const void* const* x, const void* const* trace, const void* const* b,
                  const void* const* weights, void* const* outs, int channels, int h, int w,
                  int iters, float omega, float one_minus_omega, int scope, int blocks,
                  int rows, int threads, int slots, void* stream) {
  if (channels < 1 || channels > kMaxBatch) return static_cast<int>(cudaErrorInvalidValue);
  Params prm = shape_params(h, w, iters, omega, one_minus_omega, scope, rows);
  for (int c = 0; c < channels; ++c) {
    prm.in[c][0] = static_cast<const float*>(x[c]);
    prm.in[c][1] = static_cast<const float*>(trace[c]);
    prm.in[c][2] = static_cast<const float*>(b[c]);
    prm.out[c][0] = static_cast<float*>(outs[c]);
  }
  for (int f = 0; f < 4; ++f) prm.in[0][3 + f] = static_cast<const float*>(weights[f]);
  return launch(kPde4, prm, channels, blocks, threads, slots, stream);
}

// A block's shared memory for a band of `rows` rows of width w (family 0
// llin4, 1 disp, 2 pde4 with `batch` channels, 3 elin4), as the plan counts
// it.
int resident_sor_smem_bytes(int family, int batch, int rows, int w) {
  return static_cast<int>(smem_bytes_of(family, batch, rows, w));
}

const char* resident_sor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
