// Resident red-black SOR: one launch runs a whole solver call, the prepare and
// all `iters` sweeps, with the level held on chip between colours. Two
// families:
//   * llin4: the increments (dU, dV) of the warping flow against the frozen
//     flow (U, V), 4-neighbour weights, every pixel relaxed
//     (models/flow_nd.py); the per-pixel arithmetic is flow_update.cuh's,
//     so the result equals the global kernel flow_llin4_sor.cu bit for bit;
//   * disp llin4: the scalar disparity increment dU against the frozen U,
//     interior pixels relaxed, the 1-px border replicated after every sweep
//     (models/disparity.py; models/disparity_sym.py's pair as a batch of 2,
//     each entry its own set of pointers, so the pair is never stacked); the
//     arithmetic is disp_update.cuh's, every operation rounded alone, so the
//     result equals both the global kernel (interior_sor.cu) and the plain
//     version bit for bit.
//
// Replaces the TPU kernels:
//   * pde_tpu/kernels/sor_pallas.py:71 _kernel, the VMEM-resident llin4
//     kernel (the whole level loaded once, all sweeps in VMEM, dU and dV
//     written back);
//   * pde_tpu/kernels/tiled.py:113 _stripe_kernel and :172
//     _stripe_kernel_db driving pde_tpu/kernels/sweeps.py:66
//     flow_llin4_sweep and sweeps.py:145 disp_llin4_sweep (one launch a
//     call on the TPU: k_max = iters there).
// Plain PyTorch versions: pde_tpu_torch/solvers/sor.py::sor_flow_llin4 and
// ::sor_disp_llin4.
//
// Design. A block owns a band of whole rows; each thread owns fixed pixels of
// it, `slots` of each colour: slot k of colour c of thread t is pixel
// (r0 + q / hw, 2 (q % hw) + parity) with q = t + k * threads, hw = ceil(W/2),
// so every lane of a warp relaxes a pixel in every colour phase. A pixel's
// coefficients are read from device memory once a call and kept in registers
// (llin4: the edge-zeroed weights, their sum, 1/(sum + Du), 1/(sum + Dv), the
// NaN-folded M, Cu, Cv; disp: the weights, U_c sum w, Cu, 1/(sum + Du); the
// NaN flags as bits of one word). Only what neighbours read sits in shared
// memory: dU, dV, U, V (llin4) or dU, U (disp), for the band and one halo row
// above and below, each field split into a plane per colour, so that a
// colour phase reads the other plane at consecutive addresses across a warp
// (no bank conflicts; interleaved colours gave every load a 2-way conflict).
// A barrier after every colour keeps the global red-black
// order, so the result does not depend on how pixels are split among blocks.
// The barrier's scope follows the level's size (the plan,
// kernels/resident_cuda.py::plan_resident):
//   * one block (__syncthreads) for the levels one SM holds;
//   * a thread block cluster of up to 16 blocks (cluster.sync()); a block
//     reads the edge rows of dU (dV) of the blocks above and below from their
//     shared memory (distributed shared memory);
//   * the whole card, a cooperative grid of co-resident blocks (grid.sync());
//     a block writes the pixels of its first and last rows that it relaxed to
//     the output as well, and its neighbours read them from there through L2
//     (ld.global.cg), so no scratch is needed.
// U and V (U) never change: their halo rows are staged once.
//
// The disp border: the plain version replicates the border after every sweep.
// After the first sweep a filled border neighbour of an interior pixel holds
// that pixel's own value (border (0, j) takes (1, j), and so on), so from the
// second sweep on an interior pixel reads its own dU where its neighbour is on
// the border, and the border itself is filled once, when the band is written
// out. That needs no barrier of its own and gives the same bits. It holds for
// H, W >= 3; smaller fields (no interior, or a fill that swaps rows) stay with
// the global kernel.
//
// What bounds it: not bytes but the latency of its phases. A call reads each
// input once and writes the outputs once (60 B/px llin4, 36 B/px disp, a few
// microseconds at 480x640), but runs 2 iters colour phases, each a pass of
// dependent shared-memory loads and ~40 flops a slot, ended by a barrier;
// the global kernels paid a launch (~2 us of device time even for a small
// level) and a round trip through device memory for each phase instead. On
// an H100 a sweep costs ~0.8 us in one block, ~2.2 us in a cluster and
// ~3-5 us on the grid, where the barrier dominates (PERF.md, row 1). So the
// design keeps one launch, no device-memory traffic between phases, the
// cheapest barrier that spans the level, and few slots a thread (the
// slots run one after another within a phase); the plan weighs slots
// against the barrier's cost. A slot's indices are recomputed each phase
// (`opaque`) rather than kept live across the sweeps: held, they took the
// registers the coefficients need and spilled at 3 and 4 slots.
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
#include "resident_scope.cuh"

namespace {

using resident::kGrid;
using resident::Layout;
using resident::opaque;
using resident::scope_sync;
using resident::slot_pixel;
using resident::slot_positions;
using resident::stage_halo;

constexpr int kMaxThreads = resident::kMaxThreads;
constexpr int kMaxBatch = 2;

enum Family { kLlin4 = 0, kDisp = 1 };

// the input planes a batch entry: llin4 u v du dv m cu cv duc dvc ww wn we ws;
// disp u du cu duc ww wn we ws
constexpr int kMaxIn = 13;

struct Params {
  const float* in[kMaxBatch][kMaxIn];
  float* out[kMaxBatch][2];
  int h, w, rows, iters, scope;
  float omega, one_minus_omega;
};

int fields_in_smem(int family) { return family == kLlin4 ? 4 : 2; }

// dU (or dV) at row gi of the halo, just above (gi = r0 - 1) or below
// (gi = r1) the band: in the cluster, from the shared memory `s` of the
// neighbouring block; on the grid, from the output, where the block that
// owns the row wrote it.
__device__ __forceinline__ float halo_at(const float* s, const float* out, int gi, int j,
                                         Layout lay, int w, int scope) {
  if (scope == kGrid) return __ldcg(out + static_cast<size_t>(gi) * w + j);
  return resident::cluster_at(s, gi, j, lay);
}

// What a llin4 pixel keeps in registers (flow_sor::Coef without its flags,
// which go to a bit word).
struct LlinSlot {
  float a, b, c, d, wsum, inv_u, inv_v, m0, cu0, cv0;
};

// A block's shared fields.
struct Fields {
  float *du, *dv, *u, *v;
};

// Stage the slots' pixels of every field and keep their coefficients.
template <int kC, int kSlots>
__device__ __forceinline__ void llin4_prepare(const Params& prm, const uint32_t (&pos)[kSlots],
                                              LlinSlot (&sl)[2][kSlots], uint32_t* bits,
                                              Fields smem, Layout lay, int r1) {
  const float* const* in = prm.in[0];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    int gi, j;
    if (!slot_pixel<kC>(pos[k], lay.r0, prm.w, &gi, &j)) continue;
    const size_t p = static_cast<size_t>(gi) * prm.w + j;
    const float u = in[0][p], v = in[1][p], du = in[2][p], dv = in[3][p];
    const flow_sor::Coef f = flow_sor::prepare(gi, j, prm.h, prm.w, in[9][p], in[10][p],
                                               in[11][p], in[12][p], in[4][p], in[5][p],
                                               in[6][p], in[7][p], in[8][p]);
    const int q = lay.at(gi, j);
    smem.u[q] = u;
    smem.v[q] = v;
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

// One colour phase of llin4: every slot of colour kC relaxed in place.
template <int kC, int kSlots>
__device__ __forceinline__ void llin4_phase(const Params& prm, const uint32_t (&pos)[kSlots],
                                            const LlinSlot (&sl)[2][kSlots], uint32_t bits,
                                            float* sdu, float* sdv, const float* su,
                                            const float* sv, Layout lay, int r1) {
  const int h = prm.h, w = prm.w, r0 = lay.r0;
  const bool grid = prm.scope == kGrid;
  float* out_du = prm.out[0][0];
  float* out_dv = prm.out[0][1];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int s = kC * kSlots + k;
    if (!((bits >> s) & 1u)) continue;
    const uint32_t pk = opaque(pos[k]);
    const int gi = r0 + static_cast<int>(pk >> 16);
    const int j = 2 * static_cast<int>(pk & 0xffffu) + ((gi + kC) & 1);
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
    const LlinSlot& c = sl[kC][k];
    const flow_sor::Nbr fu_n{sdu[qw], sdu[qe], dun, dus};
    const flow_sor::Nbr fv_n{sdv[qw], sdv[qe], dvn, dvs};
    const float su_ = flow_sor::diffusion<true>(fu_n, {su[qw], su[qe], su[qn], su[qs]}, su[q], c.a,
                                                c.b, c.c, c.d, c.wsum);
    const float sv_ = flow_sor::diffusion<true>(fv_n, {sv[qw], sv[qe], sv[qn], sv[qs]}, sv[q], c.a,
                                                c.b, c.c, c.d, c.wsum);
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

template <int kSlots>
__global__ void __launch_bounds__(kMaxThreads, 1)
    resident_llin4_kernel(const __grid_constant__ Params prm) {
  extern __shared__ float smem[];
  const int h = prm.h, w = prm.w, hw = (w + 1) >> 1;
  const Layout lay{static_cast<int>(blockIdx.x) * prm.rows, prm.rows, hw};
  const int r0 = lay.r0;
  const int r1 = min(r0 + prm.rows, h);
  const int rows = r1 - r0;
  const int plane = 2 * (prm.rows + 2) * hw;
  const Fields f{smem, smem + plane, smem + 2 * plane, smem + 3 * plane};
  float *sdu = f.du, *sdv = f.dv, *su = f.u, *sv = f.v;
  const float* const* in = prm.in[0];

  // every own pixel with its coefficients (on the grid the band's edge rows
  // of dU, dV also into the output for the neighbours), and the halo rows of
  // U, V
  uint32_t pos[kSlots];
  slot_positions<kSlots>(pos, rows, hw);
  LlinSlot sl[2][kSlots];
  uint32_t bits = 0;
  llin4_prepare<0, kSlots>(prm, pos, sl, &bits, f, lay, r1);
  llin4_prepare<1, kSlots>(prm, pos, sl, &bits, f, lay, r1);
  stage_halo(su, in[0], sv, in[1], lay, rows, h, w);
  scope_sync(prm.scope);

  for (int it = 0; it < prm.iters; ++it) {
    llin4_phase<0, kSlots>(prm, pos, sl, bits, sdu, sdv, su, sv, lay, r1);
    scope_sync(prm.scope);
    llin4_phase<1, kSlots>(prm, pos, sl, bits, sdu, sdv, su, sv, lay, r1);
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
    prm.out[0][0][p] = sdu[q];
    prm.out[0][1][p] = sdv[q];
  }
}

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

using Kernel = void (*)(const Params);

// the instantiated slots a thread (per colour)
Kernel pick(int family, int slots) {
  if (family == kLlin4) {
    switch (slots) {
      case 1: return resident_llin4_kernel<1>;
      case 2: return resident_llin4_kernel<2>;
      case 3: return resident_llin4_kernel<3>;
      case 4: return resident_llin4_kernel<4>;
      default: return nullptr;
    }
  }
  switch (slots) {
    case 1: return resident_disp_kernel<1>;
    case 2: return resident_disp_kernel<2>;
    case 3: return resident_disp_kernel<3>;
    case 4: return resident_disp_kernel<4>;
    case 6: return resident_disp_kernel<6>;
    default: return nullptr;
  }
}

// the fields' planes of both colours, the band and its two halo rows
int64_t smem_bytes_of(int family, int64_t rows, int64_t w) {
  return fields_in_smem(family) * 2 * (rows + 2) * ((w + 1) / 2) *
         static_cast<int64_t>(sizeof(float));
}

// The plan's rules (kernels/resident_cuda.py::plan_resident makes only plans
// that keep them).
bool plan_ok(int family, int batch, int h, int w, int iters, int scope, int blocks, int rows,
             int threads, int slots) {
  if (family != kLlin4 && family != kDisp) return false;
  if (batch < 1 || batch > (family == kLlin4 ? 1 : kMaxBatch)) return false;
  if (iters < 0 || (family == kDisp && (h < 3 || w < 3))) return false;
  if (pick(family, slots) == nullptr) return false;
  return resident::bands_ok(h, w, scope, blocks, rows, threads, slots,
                            smem_bytes_of(family, rows, w), family == kDisp);
}

int launch(int family, const Params& prm, int batch, int blocks, int threads, int slots,
           void* stream) {
  if (!plan_ok(family, batch, prm.h, prm.w, prm.iters, prm.scope, blocks, prm.rows, threads,
               slots))
    return static_cast<int>(cudaErrorInvalidValue);
  return resident::launch(reinterpret_cast<const void*>(pick(family, slots)), prm, prm.scope,
                          blocks, batch, threads,
                          static_cast<int>(smem_bytes_of(family, prm.rows, prm.w)), stream);
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
  Params prm = {};
  for (int f = 0; f < kMaxIn; ++f) prm.in[0][f] = static_cast<const float*>(ptrs[f]);
  prm.out[0][0] = static_cast<float*>(du_out);
  prm.out[0][1] = static_cast<float*>(dv_out);
  prm.h = h;
  prm.w = w;
  prm.rows = rows;
  prm.iters = iters;
  prm.scope = scope;
  prm.omega = omega;
  prm.one_minus_omega = one_minus_omega;
  return launch(kLlin4, prm, 1, blocks, threads, slots, stream);
}

// ptrs: `batch` sets of 8 contiguous (H, W) float32 planes u du cu duc ww wn
// we ws, one set after the other; outs: `batch` (H, W) planes for dU. H, W
// >= 3. One launch, as resident_flow_llin4.
int resident_disp_llin4(const void* const* ptrs, void* const* outs, int batch, int h, int w,
                        int iters, float omega, float one_minus_omega, int scope, int blocks,
                        int rows, int threads, int slots, void* stream) {
  if (batch < 1 || batch > kMaxBatch) return static_cast<int>(cudaErrorInvalidValue);
  Params prm = {};
  for (int b = 0; b < batch; ++b) {
    for (int f = 0; f < 8; ++f) prm.in[b][f] = static_cast<const float*>(ptrs[8 * b + f]);
    prm.out[b][0] = static_cast<float*>(outs[b]);
  }
  prm.h = h;
  prm.w = w;
  prm.rows = rows;
  prm.iters = iters;
  prm.scope = scope;
  prm.omega = omega;
  prm.one_minus_omega = one_minus_omega;
  return launch(kDisp, prm, batch, blocks, threads, slots, stream);
}

// A block's shared memory for a band of `rows` rows of width w (family 0
// llin4, 1 disp), as the plan counts it.
int resident_sor_smem_bytes(int family, int rows, int w) {
  return static_cast<int>(smem_bytes_of(family, rows, w));
}

const char* resident_sor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
