// Temporally blocked red-black SOR, k sweeps per pass over a 2-D tile and
// its halo, for the six families of pde_tpu_torch/kernels/sweeps.py:
//   * flow_llin4: the increments (dU, dV) against the frozen flow (U, V);
//   * flow_elin4: (U, V) themselves (template flag kLate = false);
//   * disp_llin4: the disparity increment dU against the frozen U, a batch
//     of 1 or 2 systems (disparity_sym's pair, each its own planes);
//   * pde4: the diagonal form X+ = (B + sum w X) / TRACE, up to 3 channels;
//   * flow_llin8: the 8-neighbour (dU, dV) pair (anisotropic tensor);
//   * pde8: the 8-neighbour diagonal form, up to 3 channels.
//
// Replaces the TPU kernels pde_tpu/kernels/tiled.py::_stripe_kernel
// (tiled.py:113, serial) and ::_stripe_kernel_db (tiled.py:172, the next
// stripe's DMA under the current one's sweeps) driving
// pde_tpu/kernels/sweeps.py::flow_llin4_sweep (:66), flow_elin4_sweep
// (:234), disp_llin4_sweep (:145), pde4_sweep (:174), flow_llin8_sweep
// (:107) and pde8_sweep (:204). It computes the same function as the global
// kernels (flow_llin4_sor.cu, interior_sor.cu) and their plain versions
// pde_tpu_torch/solvers/sor.py::sor_*; its own plain version is the tile
// schedule in torch ops, pde_tpu_torch/kernels/tiled.py::plain_tiled_relax.
// kernels/dispatch.py sends it every solve whose shape has no resident plan
// (resident_sor.cu, resident8_sor.cu) and that a tile plan takes, as
// pde_tpu sends a grid too large for VMEM to _stripe_kernel with k <= 4.
//
// Design (after resident_sor.cu):
//   * iters sweeps run as iters / k chunks of k and one of the remainder,
//     one launch a chunk. A chunk reads one state and writes another
//     (ping-pong, the last chunk writing the output): a tile's halo must see
//     the state at the start of the chunk, not a neighbour's result.
//   * A block takes a tile (kernels/tiled.py::plan_tiles sizes it) plus a
//     halo of 2k on every side (2k + 1 for the families that fill the
//     border, below), clamped at the arrays' edge: its slot; blockIdx.y is
//     disp's system. A pde4 or pde8 block relaxes every channel (C <= 3) of
//     its tile: the channels share the weights, which its threads read once
//     a tile, as resident_sor.cu's pde4 does. Each thread owns fixed
//     pixels of the slot, `slots` pairs of horizontally neighbouring pixels
//     (one of each colour): pair j of thread t is pair p = t + j * threads,
//     local row p / hc, columns 2 (p % hc) and 2 (p % hc) + 1, hc = the
//     slot's half-columns. The map is fixed for the launch.
//   * A pixel's coefficients (the family's prepare of the shared headers,
//     with the image's edges; pde4 and pde8: the weights and their sum once,
//     then each channel's 1/TRACE and B, TRACE and B read once where the
//     channels share them) are read from device memory straight into the
//     owning thread's registers, 8 bytes a pair where the row allows it,
//     with the NaN flags, the edge bits and a live bit packed in one word a
//     pair. They stay there for the chunk's k sweeps and never touch shared
//     memory. A pair's indices are recomputed each colour phase from the
//     word (kept live, they took the registers the coefficients need).
//   * Shared memory holds only what neighbours read, each field split into
//     a plane per colour: dU, dV, U, V (llin4), U, V (elin4), dU, U (disp),
//     X (pde4, pde8: a set of planes a channel); llin8 keeps dU, dV, U, V
//     for the pixel itself and, for its neighbours, each relaxed field
//     pre-added to its frozen field, Wu = fl(dU + U), Wv = fl(dV + V): the
//     float each neighbour term of the plain version starts from
//     (sweeps.py's fl(df + u) before the neighbours are taken), so the bits
//     stay those of the global kernels. A llin8 pixel reads 16 neighbour
//     values a phase, not 32, adds nothing before the fma chain, and writes
//     its new fields and their sums. (The same sums measured 3-4% slower
//     for disp, whose pixel reads only 8 values: PERF.md.) A colour phase of
//     pde4 or pde8 reads every channel's neighbours of a
//     pixel first, then updates and stores each channel: the reads overlap,
//     and one barrier serves all channels. A pixel of colour c sits in plane
//     c at row * hc + column / 2; a neighbour (di, dj) of the pixel in
//     column 2x + e is at row + di, half-column x + ((e + dj) >> 1), in the
//     other plane when di + dj is odd. A colour phase reads the other plane
//     at consecutive addresses across a warp: no bank conflicts.
//   * The 8-neighbour families: a diagonal neighbour has the pixel's own
//     colour and the plain version computes a colour from the state before
//     its half-sweep, so what neighbours read of a relaxed field (pde8's X,
//     llin8's sums) keeps two buffers a colour, as resident8_sor.cu: the
//     phase of image colour C in sweep s reads its own colour from buffer
//     s & 1, writes buffer (s + 1) & 1, and reads the other colour from
//     buffer (s + C) & 1, its count of relaxations. llin8's dU and dV, which
//     only the pixel itself reads, are relaxed in place.
//   * Edges. llin4, elin4 and llin8 relax every pixel with the out-facing
//     weights zeroed; a neighbour off the image is clamped to the image, row
//     and column alone (the weight is zero there; an inf still meets the
//     zero, as in the plain version). disp, pde4 and pde8 relax the image's
//     interior and fill the 1-px border after every sweep, rows first, then
//     columns (core/grid.replicate_border): for H, W >= 3 a border pixel
//     then holds the pixel (clamp(i, 1, H-2), clamp(j, 1, W-2)), its fill
//     source, as of the sweep's end. The kernel never writes the border:
//     in sweep 0 a border neighbour reads its input value, from sweep 1 on
//     its fill source's value of s relaxations (the pixel's own for a
//     4-neighbour, buffer s & 1 for pde8), and the tile's border pixels are
//     written from their sources. A source lies one pixel inward, so these
//     families' halo is 2k + 1 and every colour phase reaches one pixel
//     further (without it a tile one pixel wide at the image's edge would
//     fill its border from a stale source).
//   * A llin8 or disp pixel with no edge bit (all but the image's outer ring
//     for llin8, the ring inside the border for disp) reads its neighbours
//     at offsets fixed for the phase; only a pixel with one runs the clamp
//     and fill logic (relax_pixel<kEdge>). llin8's double-buffered form runs
//     every pixel on that path, which measured faster there (PERF.md).
//   * The neighbour planes are copied in with 4-byte cp.async, each thread
//     its own pixels: a pixel's destination plane differs from its
//     horizontal neighbour's, so a wider copy could not land it without a
//     raw staging area and a second pass through shared memory. llin8's sums
//     are then formed by the thread that copied the pixel, from its own
//     copies once it has waited for them (fill_sums), before the barrier
//     the sweeps need anyway: the copies still overlap the coefficient
//     loads, and no barrier is added. Such a
//     staging of the coefficient planes (16-byte cp.async, then 8-byte reads
//     into registers) measured 1.4-1.7x slower than the 8-byte loads
//     straight into registers on the H100 (PERF.md).
//   * Then k sweeps, a __syncthreads() after each colour. In sweep s colour
//     1 relaxes the tile grown by 2 (k - 1 - s) (+ 1 with a border fill) and
//     colour 0 one pixel more, which is all the kept interior depends on; a
//     pair outside the region is predicated off. Colours are (gi + gj) & 1
//     in the image's coordinates; in the slot they are local colours,
//     flipped by the parity of the slot's origin.
//   * The per-pixel arithmetic is the shared headers' (flow_update.cuh,
//     disp_update.cuh, pde4_update.cuh, flow8_update.cuh, pde8_update.cuh),
//     which the global and resident kernels use too, so all round alike
//     (bit for bit).
//   * Serial: one block a tile (and disp system). Double-buffered (the port
//     of _stripe_kernel_db, every family): persistent blocks, as many as the
//     card holds at once, walk the tiles (the (tile, system) items of disp,
//     the system fastest; pde4's and pde8's every channel of a tile) with
//     two slots; while a block sweeps item t in slot s, cp.async copies the
//     neighbour planes of its next item into slot 1 - s (one commit group an
//     item, waited on before the item's sweeps), and the item's coefficients
//     are read into registers after that copy is issued. A barrier after the
//     store drains the slot before a prefetch refills it. Serial and
//     double-buffered give the same bits.
//   * The windowed variant (the `_win` entry points) runs one chunk over part
//     of an image: the arrays are the rectangle [r0, r0 + h) x [c0, c0 + w) of
//     a gh x gw image (a shard of pde_tpu_torch/parallel/tiled.py with its
//     halo exchanged from its neighbours, clipped to the image), and only
//     the tiles covering a box of the arrays run, writing the box alone into
//     a box-sized output. Colours and the image edges are the image's; a slot
//     is clamped at the array's edge, which the kept box never reaches. The
//     whole-image kernel is the window (0, 0, h, w) with the box the whole
//     array: one code path, the same bits. It replaces pde_tpu/parallel/
//     tiled.py::tiled_relax_sharded's shard bodies (:301-327, XLA ops under
//     shard_map there); its plain version is kernels/tiled.py::
//     plain_tiled_relax with a Window.
//
// What bounds it. By bytes, a chunk reads each input plane once and writes
// the relaxed fields once, but a tile reads its halo again from L2, so a
// slot moves slot / interior times the planes (about 2x at the plans'
// tiles). Registers bound the slot: a llin4 pixel keeps 9 coefficients, a
// llin8 pixel 14, disp 7, pde4 4 + 2C and pde8 8 + 2C (C channels), plus
// the pair's word. On the H100 neither bytes nor flops bound it but the
// latency of a tile's serial steps: the coefficient loads, the prepare
// (divisions) and the 2k colour phases with a barrier each; in a phase, the
// integer work of the neighbours' addresses more than the arithmetic
// (scripts/tiled_phase_clocks.py splits a launch's cycles and counts a
// phase's instructions). So a pde4 or pde8 block takes all C channels of its
// tile: one set of weight loads and sums, and 2k barriered phases, for C
// channels, where a block a channel would pay C of each; llin8 reads one
// sum a neighbour, and llin8 and disp read at fixed offsets. llin4 and elin4 at 2 pairs a thread
// are held to 64 registers, two blocks of up to 512 threads an SM, and one
// block's loads and prepare overlap the other's phases (measured 7-17%
// faster at 1024x1024 than one larger block an SM; PERF.md); disp is held
// to two blocks an SM at 2 to 4 pairs (80 registers within 384 threads at 3
// and 4). The other families keep more coefficients and are compiled for
// one block an SM.
// The plan (kernels/tiled.py, measured by scripts/tiled_plan_sweep.py)
// trades tile size against blocks enough to fill the card's 132 SMs.
// PERF.md has the times beside the byte bound.
//
// The kernels run on the caller's stream and allocate nothing. The C entry
// points return the first failing CUDA call's error, cudaGetLastError()
// after every launch included.

#include <algorithm>
#include <cstdint>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include "disp_update.cuh"
#include "flow8_update.cuh"
#include "flow_update.cuh"
#include "pde4_update.cuh"
#include "pde8_update.cuh"

namespace {

// the families, in the order of kernels/tiled.py::LAYOUTS
enum Family { kLlin4 = 0, kElin4 = 1, kDisp = 2, kPde4 = 3, kLlin8 = 4, kPde8 = 5 };
constexpr int kFamilies = 6;

constexpr int kMaxPlanes = 13;
constexpr int kCoefPlanes = 9;  // M, Cu, Cv, Du, Dv, W, N, E, S
constexpr int kMaxSlots = 4;
constexpr int kMaxBatch = 3;    // systems (disp) or channels (pde4, pde8) a launch
constexpr int kMaxFields = 17;  // llin8's
// a slot's rows and half-columns: 8 bits each in a pair's word, 255 the
// row of a pair past the slot
constexpr int kMaxRows = 254;
constexpr int kMaxHalfCols = 255;

// threads a block at most, by family and slots a thread: the register
// budget of a thread (65,536 / threads) has to hold ~20 registers a slot.
// Where a family's kernel is compiled for two blocks an SM (llin4 and elin4
// at 2 slots, 64 registers a thread; disp at 2 slots, and at 3 and 4 with
// at most 384 threads, 80 registers), one block's loads and prepare overlap
// the other's colour phases.
__host__ __device__ constexpr int max_threads(int f, int slots) {
  return f == kDisp && slots >= 3 ? 384
                                  : slots == 1 ? 768 : slots == 2 ? 512 : slots == 3 ? 512 : 384;
}
__host__ __device__ constexpr int min_blocks(int f, int slots) {
  return f == kDisp ? (slots >= 2 ? 2 : 1) : f == kLlin4 || f == kElin4 ? (slots == 2 ? 2 : 1) : 1;
}

// A family's shared-memory planes of one slot (two colours of each field
// neighbours read, two buffers a colour of the 8-neighbour families' relaxed
// fields; llin8: two colours of each field and two buffers a colour of its
// pre-added sums), its fields, relaxed fields and systems a launch at most,
// and the halo's extra pixel of the families that fill the border.
__host__ __device__ constexpr int smem_planes(int f) {
  return f == kLlin4 ? 8 : f == kElin4 ? 4 : f == kDisp ? 4 : f == kPde4 ? 2 : f == kLlin8 ? 16 : 4;
}
__host__ __device__ constexpr int fill_of(int f) {
  return f == kDisp || f == kPde4 || f == kPde8 ? 1 : 0;
}
__host__ __device__ constexpr int fields_of(int f) {
  return f == kLlin4 ? 13 : f == kElin4 ? 11 : f == kDisp ? 8 : f == kPde4 ? 7 : f == kLlin8 ? 17
                                                                                           : 11;
}
__host__ __device__ constexpr int mut_of(int f) { return f == kDisp || f == kPde4 || f == kPde8 ? 1 : 2; }
__host__ __device__ constexpr int max_batch(int f) {
  return f == kDisp ? 2 : f == kPde4 || f == kPde8 ? 3 : 1;
}
__host__ __device__ constexpr int halo_of(int f, int k) { return 2 * k + fill_of(f); }
// the diagonal form (pde4, pde8): a block holds every channel of its tile
// over weights the channels share
__host__ __device__ constexpr bool diag_of(int f) { return f == kPde4 || f == kPde8; }
// the planes' sets a slot holds: a channel's each for pde4 and pde8, one
// system's for the others
__host__ __device__ constexpr int slot_sets(int f, int batch) { return diag_of(f) ? batch : 1; }

// the fields, in the order of the C entry points: the two relaxed first,
// then (llin4) the frozen flow, then the nine coefficient planes
struct Planes {
  const float* p[kMaxPlanes];
};

struct Geometry {
  int h, w;              // the arrays
  int r0, c0, gh, gw;    // the arrays' origin in the image, and the image
  int bi0, bj0, bh, bw;  // the box whose tiles run, in the arrays; the output is bh x bw
  int tile_h, tile_w;    // a tile's interior
  int tiles_w, n_tiles;  // tiles a row of the box, in all
  int k, fill, halo;     // this chunk's sweeps, the border fill's pixel, halo (2k + fill)
  int hc;                // a slot's half-columns: ceil((tile_w + 2 halo) / 2)
  int plane;             // one colour plane of one field: (tile_h + 2 halo) x hc floats
  int slot_floats;       // one slot: the family's planes (a set a channel), rounded to 16 bytes
  int vec2;              // every input is 8-byte aligned: pairs load as float2
  int shared;            // pde4, pde8: TRACE and B one plane the channels share
};

// a tile's interior and its slot (the interior and halo), clipped to the
// arrays, in the arrays' coordinates
struct Box {
  int r0, r1, c0, c1;
  int gr0, gr1, gc0, gc1;
};

// What a thread keeps of a pixel it owns for the chunk: its coefficients
// (its relaxed pair lives in the slot, where its neighbours read it).
struct Px {
  float a, b, c, d, inv_u, inv_v, m0, cu0, cv0;
};

// A pair's word: bits 0-7 the local row, 8-15 the half-column, then 8 bits
// for the pixel of each local colour (16-23 colour 0, 24-31 colour 1): bit 0
// live (relaxed in this chunk), bits 1-2 the NaN flags of Cu and Cv, bits
// 3-6 the W, E, N, S neighbour clamped to the pixel itself.
constexpr uint32_t kLive = 1, kClampW = 8, kClampE = 16, kClampN = 32, kClampS = 64;

__device__ __forceinline__ int pair_row(uint32_t wd) { return wd & 0xff; }
__device__ __forceinline__ int pair_col(uint32_t wd) { return (wd >> 8) & 0xff; }

__host__ __device__ int slot_rows(int halo, int tile_h) { return tile_h + 2 * halo; }
__host__ __device__ int slot_half_cols(int halo, int tile_w) { return (tile_w + 2 * halo + 1) / 2; }

__host__ __device__ int slot_floats(int family, int k, int tile_h, int tile_w, int batch) {
  const int halo = halo_of(family, k);
  return (smem_planes(family) * slot_sets(family, batch) * slot_rows(halo, tile_h) *
              slot_half_cols(halo, tile_w) +
          3) /
         4 * 4;
}

__host__ __device__ int block_threads(int family, int k, int tile_h, int tile_w, int slots) {
  const int halo = halo_of(family, k);
  const int pairs = slot_rows(halo, tile_h) * slot_half_cols(halo, tile_w);
  return ((pairs + slots - 1) / slots + 31) / 32 * 32;
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

// The pairs this thread owns: (local row, half-column), the row 255 past
// the slot. Fixed for the launch.
template <int kSlots>
__device__ __forceinline__ void pair_positions(uint32_t (&pos)[kSlots], const Geometry& g) {
  const int rows = slot_rows(g.halo, g.tile_h);
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int p = threadIdx.x + j * blockDim.x;
    const int li = p / g.hc;
    pos[j] = li < rows ? static_cast<uint32_t>(li) | (static_cast<uint32_t>(p - li * g.hc) << 8)
                       : 0xffu;
  }
}

// Issues the 4-byte copies of this thread's pixels of the neighbour fields
// (planes 0 .. kNbr - 1 of `in`) of tile b into `slot`, by colour; the
// caller commits them as one group.
template <int kNbr, int kSlots>
__device__ __forceinline__ void copy_tile(float* slot, const Planes& in, const Box& b,
                                          const Geometry& g, const uint32_t (&pos)[kSlots]) {
  const int rows = b.gr1 - b.gr0, cols = b.gc1 - b.gc0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int li = pair_row(pos[j]), x = pair_col(pos[j]);
    if (li >= rows) continue;
    const size_t src = static_cast<size_t>(b.gr0 + li) * g.w + b.gc0 + 2 * x;
    const int q = li * g.hc + x;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (2 * x + e >= cols) break;
      const int lc = (li + e) & 1;
#pragma unroll
      for (int f = 0; f < kNbr; ++f)
        __pipeline_memcpy_async(slot + (2 * f + lc) * g.plane + q, in.p[f] + src + e,
                                sizeof(float));
    }
  }
}

__device__ __forceinline__ Px pick(bool first, const Px& x, const Px& y) {
  return first ? x : y;
}

// The coefficients of this thread's live pixels of tile b, from device
// memory into registers (flow_update.cuh's prepare, with the image's edges),
// and the pairs' words. A pixel is live if colour 0 of the first sweep
// reaches it (2k - 1 around the tile, within the slot).
template <bool kLate, int kSlots>
__device__ __forceinline__ void load_coefficients(const Planes& in, const Box& b,
                                                  const Geometry& g,
                                                  const uint32_t (&pos)[kSlots],
                                                  Px (&px)[2][kSlots], uint32_t (&word)[kSlots]) {
  constexpr int kC = kLate ? 4 : 2;  // the plane of M
  const int rows = b.gr1 - b.gr0, cols = b.gc1 - b.gc0;
  const int reach = 2 * g.k - 1 + g.fill;
  const int i0 = max(b.r0 - reach, b.gr0) - b.gr0, i1 = min(b.r1 + reach, b.gr1) - b.gr0;
  const int j0 = max(b.c0 - reach, b.gc0) - b.gc0, j1 = min(b.c1 + reach, b.gc1) - b.gc0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int li = pair_row(pos[j]), x = pair_col(pos[j]);
    uint32_t wd = pos[j];
    const bool row_live = li >= i0 && li < i1;
    const bool live0 = row_live && 2 * x >= j0 && 2 * x < j1;
    const bool live1 = row_live && 2 * x + 1 >= j0 && 2 * x + 1 < j1;
    if (live0 || live1) {
      const size_t src = static_cast<size_t>(b.gr0 + li) * g.w + b.gc0 + 2 * x;
      const bool vec = live0 && live1 && g.vec2 && (src & 1) == 0;
      float v[kCoefPlanes][2];
#pragma unroll
      for (int f = 0; f < kCoefPlanes; ++f) {
        const float* p = in.p[kC + f] + src;
        if (vec) {
          const float2 t = __ldg(reinterpret_cast<const float2*>(p));
          v[f][0] = t.x;
          v[f][1] = t.y;
        } else {
          v[f][0] = live0 ? __ldg(p) : 0.0f;
          v[f][1] = live1 ? __ldg(p + 1) : 0.0f;
        }
      }
      Px two[2];
      uint32_t bits[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int lj = 2 * x + e;
        // edges in the image's coordinates
        const flow_sor::Coef c = flow_sor::prepare(
            g.r0 + b.gr0 + li, g.c0 + b.gc0 + lj, g.gh, g.gw, v[5][e], v[6][e], v[7][e], v[8][e],
            v[0][e], v[1][e], v[2][e], v[3][e], v[4][e]);
        two[e] = {c.a, c.b, c.c, c.d, c.inv_u, c.inv_v, c.m0, c.cu0, c.cv0};
        bits[e] = ((e ? live1 : live0) ? kLive : 0u) | (static_cast<uint32_t>(c.flags) << 1) |
                  (lj == 0 ? kClampW : 0u) | (lj == cols - 1 ? kClampE : 0u) |
                  (li == 0 ? kClampN : 0u) | (li == rows - 1 ? kClampS : 0u);
      }
      // the pixel at column 2x has local colour li & 1
      const bool odd = li & 1;
      px[0][j] = pick(odd, two[1], two[0]);
      px[1][j] = pick(odd, two[0], two[1]);
      wd |= (odd ? bits[1] : bits[0]) << 16;
      wd |= (odd ? bits[0] : bits[1]) << 24;
    }
    word[j] = wd;
  }
}

// One colour phase: every live pixel of local colour kLc whose position
// lies in [i0, i1) x [j0, j1) of the slot relaxed in place. A pair's
// indices are recomputed from its opaque word each phase rather than kept
// live across the sweeps, which would take the registers the coefficients
// need (the resident kernels' lesson).
template <bool kLate, int kLc, int kSlots>
__device__ __forceinline__ void relax_phase(float* slot, const Geometry& g,
                                            const uint32_t (&word)[kSlots],
                                            const Px (&px)[2][kSlots],
                                            int i0, int i1, int j0, int j1, float omega,
                                            float one_minus_omega) {
  float* fu = slot;                     // plane lc of field f at (2 f + lc) * plane
  float* fv = slot + 2 * g.plane;
  const float* u = slot + 4 * g.plane;  // the frozen flow: late only
  const float* v = slot + 6 * g.plane;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    uint32_t wd = word[j];
    asm volatile("" : "+r"(wd));
    const uint32_t bits = wd >> (16 + 8 * kLc);
    const int li = pair_row(wd), x = pair_col(wd);
    const int e = (li + kLc) & 1;  // the pixel's column in its pair
    const int lj = 2 * x + e;
    if (!(bits & kLive) || li < i0 || li >= i1 || lj < j0 || lj >= j1) continue;
    const int q = li * g.hc + x;
    const int self = kLc * g.plane + q, o = (1 - kLc) * g.plane + q;
    const int xw = (bits & kClampW) ? self : o - 1 + e;
    const int xe = (bits & kClampE) ? self : o + e;
    const int xn = (bits & kClampN) ? self : o - g.hc;
    const int xs = (bits & kClampS) ? self : o + g.hc;
    const Px& c = px[kLc][j];
    const flow_sor::Nbr fu_n{fu[xw], fu[xe], fu[xn], fu[xs]};
    const flow_sor::Nbr fv_n{fv[xw], fv[xe], fv[xn], fv[xs]};
    float su, sv;
    if (kLate) {
      const float wsum = ((c.a + c.b) + c.c) + c.d;  // as the prepare sums it
      su = flow_sor::diffusion<true>(fu_n, {u[xw], u[xe], u[xn], u[xs]}, u[self], c.a, c.b, c.c,
                                     c.d, wsum);
      sv = flow_sor::diffusion<true>(fv_n, {v[xw], v[xe], v[xn], v[xs]}, v[self], c.a, c.b, c.c,
                                     c.d, wsum);
    } else {
      su = flow_sor::diffusion<false>(fu_n, fu_n, 0.0f, c.a, c.b, c.c, c.d, 0.0f);
      sv = flow_sor::diffusion<false>(fv_n, fv_n, 0.0f, c.a, c.b, c.c, c.d, 0.0f);
    }
    const float2 r = flow_sor::update(fu[self], fv[self], su, sv, (bits >> 1) & 3, c.m0, c.cu0,
                                      c.cv0, c.inv_u, c.inv_v, omega, one_minus_omega);
    fu[self] = r.x;
    fv[self] = r.y;
  }
}

// g.k red-black sweeps over the slot, each colour over the region the kept
// interior depends on.
template <bool kLate, int kSlots>
__device__ __forceinline__ void sweep_tile(float* slot, const Box& b, const Geometry& g,
                                           const uint32_t (&word)[kSlots],
                                           const Px (&px)[2][kSlots],
                                           float omega, float one_minus_omega) {
  const int rows = b.gr1 - b.gr0, cols = b.gc1 - b.gc0;
  const int tr0 = b.r0 - b.gr0, tr1 = b.r1 - b.gr0, tc0 = b.c0 - b.gc0, tc1 = b.c1 - b.gc0;
  // the image colour of local colour 0
  const int par = (g.r0 + g.c0 + b.gr0 + b.gc0) & 1;
  for (int s = 0; s < g.k; ++s) {
    for (int color = 0; color < 2; ++color) {
      const int reach = 2 * (g.k - 1 - s) + 1 - color + g.fill;
      const int i0 = max(tr0 - reach, 0), i1 = min(tr1 + reach, rows);
      const int j0 = max(tc0 - reach, 0), j1 = min(tc1 + reach, cols);
      if ((color ^ par) == 0)
        relax_phase<kLate, 0>(slot, g, word, px, i0, i1, j0, j1, omega, one_minus_omega);
      else
        relax_phase<kLate, 1>(slot, g, word, px, i0, i1, j0, j1, omega, one_minus_omega);
      __syncthreads();
    }
  }
}

// This thread's pixels of the tile's interior, from the slot, to the
// chunk's box-sized output.
template <int kSlots>
__device__ __forceinline__ void store_tile(float* out_u, float* out_v, const float* slot,
                                           const Box& b, const Geometry& g,
                                           const uint32_t (&word)[kSlots]) {
  const int tr0 = b.r0 - b.gr0, tr1 = b.r1 - b.gr0, tc0 = b.c0 - b.gc0, tc1 = b.c1 - b.gc0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int li = pair_row(word[j]), x = pair_col(word[j]);
    if (li < tr0 || li >= tr1) continue;
    const size_t row = static_cast<size_t>(b.gr0 + li - g.bi0) * g.bw + (b.gc0 - g.bj0);
#pragma unroll
    for (int lc = 0; lc < 2; ++lc) {
      const int lj = 2 * x + ((li + lc) & 1);
      if (lj < tc0 || lj >= tc1) continue;
      out_u[row + lj] = slot[lc * g.plane + li * g.hc + x];
      out_v[row + lj] = slot[(2 + lc) * g.plane + li * g.hc + x];
    }
  }
}

template <bool kLate, bool kDouble, int kSlots>
__global__ void __launch_bounds__(max_threads(kLate ? kLlin4 : kElin4, kSlots),
                                  min_blocks(kLate ? kLlin4 : kElin4, kSlots))
    tiled_sweep_kernel(Planes in, float* __restrict__ out_u, float* __restrict__ out_v, Geometry g,
                       float omega, float one_minus_omega) {
  constexpr int kNbr = kLate ? 4 : 2;
  extern __shared__ __align__(16) float smem[];
  uint32_t pos[kSlots], word[kSlots];
  Px px[2][kSlots];
  pair_positions(pos, g);
  int s = 0;  // the slot of the current tile
  int t = blockIdx.x;
  if (kDouble) {
    if (t < g.n_tiles) copy_tile<kNbr>(smem, in, tile_box(g, t), g, pos);
    __pipeline_commit();
  }
  for (; t < g.n_tiles; t += gridDim.x) {
    const Box b = tile_box(g, t);
    float* slot = smem + s * g.slot_floats;
    if (kDouble) {
      // the neighbour planes of the block's next tile into the other slot
      const int next = t + gridDim.x;
      if (next < g.n_tiles)
        copy_tile<kNbr>(smem + (s ^ 1) * g.slot_floats, in, tile_box(g, next), g, pos);
    } else {
      copy_tile<kNbr>(slot, in, b, g, pos);
    }
    __pipeline_commit();
    // the coefficients while the copies are in flight
    load_coefficients<kLate>(in, b, g, pos, px, word);
    // this tile's group: all but the newest when double-buffered
    if (kDouble)
      __pipeline_wait_prior(1);
    else
      __pipeline_wait_prior(0);
    __syncthreads();
    sweep_tile<kLate>(slot, b, g, word, px, omega, one_minus_omega);
    store_tile(out_u, out_v, slot, b, g, word);
    if (kDouble) {
      // drain: every thread has stored from this slot before the next
      // tile's prefetch refills it
      __syncthreads();
      s ^= 1;
    }
  }
  __pipeline_wait_prior(0);
}

// The blocks of a persistent launch of `kernel`: as many as the card holds
// at once, and no more than its `items`.
template <class Kernel>
cudaError_t persistent_blocks(Kernel kernel, int threads, int smem, int items, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = std::min(items, sms * per_sm);
  return cudaSuccess;
}

template <bool kLate, bool kDouble, int kSlots>
cudaError_t launch_chunk(const Planes& in, float* out_u, float* out_v, const Geometry& g,
                         int threads, float omega, float one_minus_omega, cudaStream_t stream) {
  const auto kernel = tiled_sweep_kernel<kLate, kDouble, kSlots>;
  const int smem = (kDouble ? 2 : 1) * g.slot_floats * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int blocks = g.n_tiles;
  if (kDouble &&
      (err = persistent_blocks(kernel, threads, smem, g.n_tiles, &blocks)) != cudaSuccess)
    return err;
  kernel<<<blocks, threads, smem, stream>>>(in, out_u, out_v, g, omega, one_minus_omega);
  return cudaGetLastError();
}

template <bool kLate, bool kDouble>
cudaError_t launch_slots(int slots, const Planes& in, float* out_u, float* out_v,
                         const Geometry& g, int threads, float omega, float one_minus_omega,
                         cudaStream_t stream) {
  switch (slots) {
    case 1:
      return launch_chunk<kLate, kDouble, 1>(in, out_u, out_v, g, threads, omega,
                                             one_minus_omega, stream);
    case 2:
      return launch_chunk<kLate, kDouble, 2>(in, out_u, out_v, g, threads, omega,
                                             one_minus_omega, stream);
    case 3:
      return launch_chunk<kLate, kDouble, 3>(in, out_u, out_v, g, threads, omega,
                                             one_minus_omega, stream);
    case 4:
      return launch_chunk<kLate, kDouble, 4>(in, out_u, out_v, g, threads, omega,
                                             one_minus_omega, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// A chunk of k sweeps of `family` over the tiles of the box (bi0, bj0, bh,
// bw) of h x w arrays lying at (r0, c0) in a gh x gw image, `batch` systems
// or channels; vec2 and shared are left to the caller, which knows the
// pointers.
Geometry geometry(int family, int h, int w, int r0, int c0, int gh, int gw, int bi0, int bj0,
                  int bh, int bw, int k, int tile_h, int tile_w, int batch = 1) {
  Geometry g{};
  g.h = h;
  g.w = w;
  g.r0 = r0;
  g.c0 = c0;
  g.gh = gh;
  g.gw = gw;
  g.bi0 = bi0;
  g.bj0 = bj0;
  g.bh = bh;
  g.bw = bw;
  g.tile_h = tile_h;
  g.tile_w = tile_w;
  g.tiles_w = (bw + tile_w - 1) / tile_w;
  g.n_tiles = g.tiles_w * ((bh + tile_h - 1) / tile_h);
  g.k = k;
  g.fill = fill_of(family);
  g.halo = halo_of(family, k);
  g.hc = slot_half_cols(g.halo, tile_w);
  g.plane = slot_rows(g.halo, tile_h) * g.hc;
  g.slot_floats = slot_floats(family, k, tile_h, tile_w, batch);
  g.vec2 = 1;
  return g;
}

// 0 unless every pointer is 8-byte aligned
int aligned8(const float* const* p, int n) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(p[i]) % 8 != 0) return 0;
  return 1;
}

// Refuses a plan the kernel does not take: the slots, the slot's rows and
// half-columns (8 bits each in a pair's word), the threads and the shared
// memory of one slot (two when double-buffered).
cudaError_t check_plan(int family, const Geometry& g, int slots, int double_buffer) {
  if (slots < 1 || slots > kMaxSlots || slot_rows(g.halo, g.tile_h) > kMaxRows ||
      g.hc > kMaxHalfCols)
    return cudaErrorInvalidValue;
  if (block_threads(family, g.k, g.tile_h, g.tile_w, slots) > max_threads(family, slots) ||
      static_cast<size_t>((double_buffer ? 2 : 1) * g.slot_floats) * sizeof(float) > 232448)
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

// One launch of a chunk; refuses a plan the kernel does not take.
template <bool kLate>
cudaError_t run_chunk(const Planes& in, float* out_u, float* out_v, const Geometry& g, int slots,
                      int double_buffer, float omega, float one_minus_omega, void* stream) {
  constexpr int kFam = kLate ? kLlin4 : kElin4;
  const cudaError_t bad = check_plan(kFam, g, slots, double_buffer);
  if (bad != cudaSuccess) return bad;
  const int threads = block_threads(kFam, g.k, g.tile_h, g.tile_w, slots);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return double_buffer
             ? launch_slots<kLate, true>(slots, in, out_u, out_v, g, threads, omega,
                                         one_minus_omega, s)
             : launch_slots<kLate, false>(slots, in, out_u, out_v, g, threads, omega,
                                          one_minus_omega, s);
}

// One launch a chunk: iters / k chunks of k sweeps, then one of the
// remainder; chunk c reads the previous chunk's output (the caller's fields
// for c = 0) and writes out or tmp so that the last one writes out.
template <bool kLate>
int run_tiled(const void* const* fields, void* out_u, void* out_v, void* tmp_u, void* tmp_v, int h,
              int w, int iters, int k, int tile_h, int tile_w, int slots, int double_buffer,
              float omega, float one_minus_omega, void* stream) {
  constexpr int kPlanes = kLate ? 13 : 11;
  if (h < 1 || w < 1 || k < 1 || tile_h < 1 || tile_w < 1) return cudaErrorInvalidValue;
  Planes in{};
  for (int p = 0; p < kPlanes; ++p) in.p[p] = static_cast<const float*>(fields[p]);
  const int n_full = iters / k, rem = iters % k, n_chunks = n_full + (rem > 0 ? 1 : 0);
  float* const dst[2][2] = {{static_cast<float*>(out_u), static_cast<float*>(out_v)},
                            {static_cast<float*>(tmp_u), static_cast<float*>(tmp_v)}};
  for (int c = 0; c < n_chunks; ++c) {
    const int kc = c < n_full ? k : rem;
    Geometry g = geometry(kLate ? kLlin4 : kElin4, h, w, 0, 0, h, w, 0, 0, h, w, kc, tile_h,
                          tile_w);
    g.vec2 = aligned8(in.p, kPlanes);
    float* const* to = dst[(n_chunks - 1 - c) % 2];
    const cudaError_t err = run_chunk<kLate>(in, to[0], to[1], g, slots, double_buffer, omega,
                                             one_minus_omega, stream);
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
               int slots, int double_buffer, float omega, float one_minus_omega, void* stream) {
  constexpr int kPlanes = kLate ? 13 : 11;
  if (h < 1 || w < 1 || k < 1 || tile_h < 1 || tile_w < 1 || r0 < 0 || c0 < 0 ||
      r0 + h > gh || c0 + w > gw || bi0 < 0 || bj0 < 0 || bh < 1 || bw < 1 || bi0 + bh > h ||
      bj0 + bw > w)
    return cudaErrorInvalidValue;
  Planes in{};
  for (int p = 0; p < kPlanes; ++p) in.p[p] = static_cast<const float*>(fields[p]);
  Geometry g = geometry(kLate ? kLlin4 : kElin4, h, w, r0, c0, gh, gw, bi0, bj0, bh, bw, k,
                        tile_h, tile_w);
  g.vec2 = aligned8(in.p, kPlanes);
  return static_cast<int>(run_chunk<kLate>(in, static_cast<float*>(out_u),
                                           static_cast<float*>(out_v), g, slots, double_buffer,
                                           omega, one_minus_omega, stream));
}

// ---------------------------------------------------------------------------
// disp llin4, pde4, llin8 and pde8: one relaxed field (disp, pde) or two
// (llin8), each system its own planes (a shared plane repeats its pointer);
// serial or double-buffered, as llin4 and elin4. disp's systems lie along
// the grid (blockIdx.y, or the items of the double-buffered form); a block
// of pde4 or pde8 holds every channel of its tile over weights read once.
// ---------------------------------------------------------------------------

// The pointers of a launch: the family's fields and relaxed outputs, by
// system.
struct Systems {
  const float* in[kMaxBatch][kMaxFields];
  float* out[kMaxBatch][2];
};

// The pointer of field f of system b (a select, so that the parameter
// space is indexed by constants only).
__device__ __forceinline__ const float* in_ptr(const Systems& sys, int b, int f) {
  return b == 0 ? sys.in[0][f] : b == 1 ? sys.in[1][f] : sys.in[2][f];
}
__device__ __forceinline__ float* out_ptr(const Systems& sys, int b, int f) {
  return b == 0 ? sys.out[0][f] : b == 1 ? sys.out[1][f] : sys.out[2][f];
}

// What a family keeps of a pixel in registers and how it reads a pair's
// coefficients (the fields [kCoef0, kFields)) into them; kFill: the border
// is filled after each sweep (fill_of), not relaxed; kDiag: the diagonal
// form (pde4, pde8), whose kCh channels share a block and the weights (the
// others: one system a block); kPre: neighbours read each relaxed field
// pre-added to its frozen field, fl(dU + U) (llin8; the float each neighbour
// term of the plain version starts from); kPlanes shared-memory planes a
// channel (smem_planes).
template <int kFam, int kCh = 1>
struct Fam;

// A pair of pixels of a plane: one 8-byte load where `vec`, else each live
// pixel alone (0 for one that is not).
__device__ __forceinline__ float2 load_pair(const float* p, bool vec, bool live0, bool live1) {
  if (vec) return __ldg(reinterpret_cast<const float2*>(p));
  return make_float2(live0 ? __ldg(p) : 0.0f, live1 ? __ldg(p + 1) : 0.0f);
}

// disp and llin8: the coefficient planes of system sb at src, then the
// family's prepare of each pixel (gi, gj + e) and its NaN flags.
template <class F>
__device__ __forceinline__ void read_coefficients(const Systems& sys, int sb, size_t src,
                                                  bool vec, bool live0, bool live1, int gi, int gj,
                                                  const Geometry& g, typename F::Px (&two)[2],
                                                  uint32_t (&nan)[2]) {
  constexpr int kCoefs = F::kFields - F::kCoef0;
  float v[2][kCoefs];
#pragma unroll
  for (int f = 0; f < kCoefs; ++f) {
    const float2 t = load_pair(in_ptr(sys, sb, F::kCoef0 + f) + src, vec, live0, live1);
    v[0][f] = t.x;
    v[1][f] = t.y;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) two[e] = F::prepare(v[e], gi, gj + e, g.gh, g.gw, nan[e]);
}

template <>
struct Fam<kDisp, 1> {
  // du | u, cu, duc, ww, wn, we, ws; neighbours read du and u
  static constexpr int kFields = 8, kMut = 1, kNbr = 2, kBufs = 1, kCoef0 = 1, kCh = 1;
  static constexpr int kPlanes = smem_planes(kDisp);
  static constexpr bool kFill = true, kDiag = false, kPre = false;
  struct Px {
    float a, b, c, d, uw, cu0, inv;
  };
  __device__ static __forceinline__ Px prepare(const float* v, int, int, int, int, uint32_t& nan) {
    const disp_sor::Coef k = disp_sor::prepare(v[3], v[4], v[5], v[6], v[0], v[1], v[2]);
    nan = k.cu_nan ? 1u : 0u;
    return {k.a, k.b, k.c, k.d, k.uw, k.cu0, k.inv};
  }
};

template <>
struct Fam<kLlin8, 1> {
  // du, dv | u, v, m, cu, cv, duc, dvc, ww, wnw, wn, wne, we, wse, ws, wsw;
  // neighbours read fl(du + u), fl(dv + v)
  static constexpr int kFields = 17, kMut = 2, kNbr = 4, kBufs = 2, kCoef0 = 4, kCh = 1;
  static constexpr int kPlanes = smem_planes(kLlin8);
  static constexpr bool kFill = false, kDiag = false, kPre = true;
  struct Px {
    float c[8];
    float wsum, inv_u, inv_v, m0, cu0, cv0;
  };
  __device__ static __forceinline__ Px prepare(const float* v, int gi, int gj, int gh, int gw,
                                               uint32_t& nan) {
    const flow_sor8::Coef k = flow_sor8::prepare(gi, gj, gh, gw, v[5], v[6], v[7], v[8], v[9],
                                                 v[10], v[11], v[12], v[0], v[1], v[2], v[3],
                                                 v[4]);
    nan = k.flags;
    Px p;
#pragma unroll
    for (int q = 0; q < 8; ++q) p.c[q] = k.c[q];
    p.wsum = k.wsum;
    p.inv_u = k.inv_u;
    p.inv_v = k.inv_v;
    p.m0 = k.m0;
    p.cu0 = k.cu0;
    p.cv0 = k.cv0;
    return p;
  }
};

// pde4 and pde8: a pixel's weights (shared by the channels) and each
// channel's (1/TRACE, B) from pde*_sor::diagonal over the weights' sum, as
// resident_sor.cu's pde4_load keeps them.
template <int kCh_>
struct Fam<kPde4, kCh_> {
  // x | trace, b, ww, wn, we, ws
  static constexpr int kFields = 7, kMut = 1, kNbr = 1, kBufs = 1, kCoef0 = 1, kCh = kCh_;
  static constexpr int kPlanes = smem_planes(kPde4);
  static constexpr bool kFill = true, kDiag = true, kPre = false;
  using Weights = pde4_sor::Weights;
  struct Px {
    Weights wt;
    float2 inv_b[kCh];
  };
  __device__ static __forceinline__ Weights weights(const float* v) {
    return {v[0], v[1], v[2], v[3]};
  }
  __device__ static __forceinline__ float weight_sum(const Weights& k) {
    return pde4_sor::weight_sum(k);
  }
  __device__ static __forceinline__ float2 diagonal(float trace, float b, float wsum) {
    return pde4_sor::diagonal(trace, b, wsum);
  }
};

template <int kCh_>
struct Fam<kPde8, kCh_> {
  // x | trace, b, ww, wnw, wn, wne, we, wse, ws, wsw
  static constexpr int kFields = 11, kMut = 1, kNbr = 1, kBufs = 2, kCoef0 = 1, kCh = kCh_;
  static constexpr int kPlanes = smem_planes(kPde8);
  static constexpr bool kFill = true, kDiag = true, kPre = false;
  using Weights = pde8_sor::Weights;
  struct Px {
    Weights wt;
    float2 inv_b[kCh];
  };
  __device__ static __forceinline__ Weights weights(const float* v) {
    return {v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7]};
  }
  __device__ static __forceinline__ float weight_sum(const Weights& k) {
    return pde8_sor::weight_sum(k);
  }
  __device__ static __forceinline__ float2 diagonal(float trace, float b, float wsum) {
    return pde8_sor::diagonal(trace, b, wsum);
  }
};

// pde4 and pde8: the weights of the pair at src, read once (channel 0's
// planes: the channels share them), their sum, and each channel's
// (1/TRACE, B); TRACE and B read once where the channels share them (the
// same bits: a shared plane gives every channel the same diagonal).
template <class F>
__device__ __forceinline__ void read_diagonal(const Systems& sys, size_t src, bool vec, bool live0,
                                              bool live1, int shared, typename F::Px (&two)[2]) {
  constexpr int kW = F::kFields - 3;  // the weights follow x, trace, b
  float v[2][kW];
#pragma unroll
  for (int f = 0; f < kW; ++f) {
    const float2 t = load_pair(sys.in[0][3 + f] + src, vec, live0, live1);
    v[0][f] = t.x;
    v[1][f] = t.y;
  }
  float wsum[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    two[e].wt = F::weights(v[e]);
    wsum[e] = F::weight_sum(two[e].wt);
  }
#pragma unroll
  for (int c = 0; c < F::kCh; ++c) {
    if (c > 0 && shared) {
      two[0].inv_b[c] = two[0].inv_b[0];
      two[1].inv_b[c] = two[1].inv_b[0];
      continue;
    }
    const float2 tr = load_pair(in_ptr(sys, c, 1) + src, vec, live0, live1);
    const float2 b = load_pair(in_ptr(sys, c, 2) + src, vec, live0, live1);
    two[0].inv_b[c] = F::diagonal(tr.x, b.x, wsum[0]);
    two[1].inv_b[c] = F::diagonal(tr.y, b.y, wsum[1]);
  }
}

// The plane of field f, local colour lc and buffer buf of channel ch in a
// slot: a channel's planes together (kPlanes of them), in it a relaxed
// field's buffers of a colour side by side, then the frozen fields' colours.
template <class F>
__device__ __forceinline__ int plane_of(int f, int lc, int buf, int ch = 0) {
  return ch * F::kPlanes + (f < F::kMut ? (2 * f + lc) * F::kBufs + buf
                                        : 2 * F::kMut * F::kBufs + 2 * (f - F::kMut) + lc);
}

// llin8 (kPre): the pre-added sum of relaxed field f (its buffers of a
// colour side by side), then every field one plane a colour.
template <class F>
__device__ __forceinline__ int sum_plane(int f, int lc, int buf) {
  return (2 * f + lc) * F::kBufs + buf;
}

// The plane the slot fill copies field f of local colour lc into, and the
// store reads a relaxed field from (buffer 0 where it has two).
template <class F>
__device__ __forceinline__ int value_plane(int f, int lc, int ch = 0) {
  if constexpr (F::kPre)
    return 2 * F::kMut * F::kBufs + 2 * f + lc;
  else
    return plane_of<F>(f, lc, 0, ch);
}

// The 4-byte copies of this thread's pixels of the neighbour fields of tile
// b into the slot (buffer 0 of a relaxed field): system sb's, or every
// channel's where a block holds them (sb = 0).
template <class F, int kSlots>
__device__ __forceinline__ void copy_family(float* slot, const Systems& sys, int sb, const Box& b,
                                            const Geometry& g, const uint32_t (&pos)[kSlots]) {
  const int rows = b.gr1 - b.gr0, cols = b.gc1 - b.gc0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int li = pair_row(pos[j]), x = pair_col(pos[j]);
    if (li >= rows) continue;
    const size_t src = static_cast<size_t>(b.gr0 + li) * g.w + b.gc0 + 2 * x;
    const int q = li * g.hc + x;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (2 * x + e >= cols) break;
      const int lc = (li + e) & 1;
#pragma unroll
      for (int ch = 0; ch < F::kCh; ++ch)
#pragma unroll
        for (int f = 0; f < F::kNbr; ++f)
          __pipeline_memcpy_async(slot + value_plane<F>(f, lc, ch) * g.plane + q,
                                  in_ptr(sys, sb + ch, f) + src + e, sizeof(float));
    }
  }
}

// llin8: the pre-added sums fl(dU + U) and fl(dV + V) of this thread's
// pixels of the slot, into buffer 0, from the planes it copied in (its own
// copies, which it has waited for, so no barrier comes first).
template <class F, int kSlots>
__device__ __forceinline__ void fill_sums(float* slot, const Box& b, const Geometry& g,
                                          const uint32_t (&pos)[kSlots]) {
  if constexpr (F::kPre) {
    const int rows = b.gr1 - b.gr0, cols = b.gc1 - b.gc0;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int li = pair_row(pos[j]), x = pair_col(pos[j]);
      if (li >= rows) continue;
      const int q = li * g.hc + x;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (2 * x + e >= cols) break;
        const int lc = (li + e) & 1;
#pragma unroll
        for (int f = 0; f < F::kMut; ++f)
          slot[sum_plane<F>(f, lc, 0) * g.plane + q] =
              __fadd_rn(slot[value_plane<F>(f, lc) * g.plane + q],
                        slot[value_plane<F>(F::kMut + f, lc) * g.plane + q]);
      }
    }
  }
}

// The coefficients of this thread's live pixels of tile b (system sb's, or
// for pde4 and pde8 the weights and every channel's diagonal), from device
// memory into registers, and the pairs' words. A pixel is live if colour 0
// of the first sweep reaches it (2k - 1 + fill around the tile, within the
// slot) and, for the families that fill the border, it lies in the image's
// interior.
template <class F, int kSlots>
__device__ __forceinline__ void load_family(const Systems& sys, int sb, const Box& b,
                                            const Geometry& g, const uint32_t (&pos)[kSlots],
                                            typename F::Px (&px)[2][kSlots],
                                            uint32_t (&word)[kSlots]) {
  const int reach = 2 * g.k - 1 + g.fill;
  const int i0 = max(b.r0 - reach, b.gr0) - b.gr0, i1 = min(b.r1 + reach, b.gr1) - b.gr0;
  const int j0 = max(b.c0 - reach, b.gc0) - b.gc0, j1 = min(b.c1 + reach, b.gc1) - b.gc0;
  // the image's rows and columns a relaxed pixel may lie in
  const int lo = g.fill, hi_i = g.gh - 1 - g.fill, hi_j = g.gw - 1 - g.fill;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int li = pair_row(pos[j]), x = pair_col(pos[j]);
    uint32_t wd = pos[j];
    const int gi = g.r0 + b.gr0 + li, gj = g.c0 + b.gc0 + 2 * x;
    const bool row_live = li >= i0 && li < i1 && gi >= lo && gi <= hi_i;
    const bool live0 = row_live && 2 * x >= j0 && 2 * x < j1 && gj >= lo && gj <= hi_j;
    const bool live1 =
        row_live && 2 * x + 1 >= j0 && 2 * x + 1 < j1 && gj + 1 >= lo && gj + 1 <= hi_j;
    if (live0 || live1) {
      const size_t src = static_cast<size_t>(b.gr0 + li) * g.w + b.gc0 + 2 * x;
      const bool vec = live0 && live1 && g.vec2 && (src & 1) == 0;
      typename F::Px two[2];
      uint32_t nan[2] = {0, 0};
      if constexpr (F::kDiag)
        read_diagonal<F>(sys, src, vec, live0, live1, g.shared, two);
      else
        read_coefficients<F>(sys, sb, src, vec, live0, live1, gi, gj, g, two, nan);
      uint32_t bits[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pj = gj + e;
        // the edge bits (kClampW ... kClampS): llin8, the neighbour is off
        // the image and clamped; the others, it lies on the image's border
        // and is filled
        const int f = g.fill;
        bits[e] = ((e ? live1 : live0) ? kLive : 0u) | (nan[e] << 1) |
                  (pj - f == 0 ? kClampW : 0u) | (pj + f == g.gw - 1 ? kClampE : 0u) |
                  (gi - f == 0 ? kClampN : 0u) | (gi + f == g.gh - 1 ? kClampS : 0u);
      }
      const bool odd = li & 1;
      px[0][j] = odd ? two[1] : two[0];
      px[1][j] = odd ? two[0] : two[1];
      wd |= (odd ? bits[1] : bits[0]) << 16;
      wd |= (odd ? bits[0] : bits[1]) << 24;
    }
    word[j] = wd;
  }
}

// Where the neighbour (di, dj) of a pixel is read, as (row offset, column
// offset, buffer) in the slot: ``edge`` says whether its row (bit 0) or
// column (bit 1) lies past the pixel's edge bits. llin8 clamps such a
// neighbour to the image; the border families read it as it was filled:
// its input value in sweep 0 (buffer 0), its fill source's of s
// relaxations after (buffer s & 1).
struct At {
  int di, dj, buf;
};

constexpr uint32_t kEdges = kClampW | kClampE | kClampN | kClampS;

__device__ __forceinline__ bool past_row(int di, uint32_t bits) {
  return (di < 0 && (bits & kClampN)) || (di > 0 && (bits & kClampS));
}
__device__ __forceinline__ bool past_col(int dj, uint32_t bits) {
  return (dj < 0 && (bits & kClampW)) || (dj > 0 && (bits & kClampE));
}

template <class F>
__device__ __forceinline__ At neighbour_at(int di, int dj, uint32_t bits, int s, int own_buf,
                                           int other_buf) {
  const bool row = past_row(di, bits), col = past_col(dj, bits);
  At a{di, dj, 0};
  if (!F::kFill || ((row || col) && s > 0)) {
    if (row) a.di = 0;
    if (col) a.dj = 0;
  }
  if (F::kFill && (row || col))
    a.buf = s > 0 ? (s & 1) : 0;
  else
    a.buf = ((a.di + a.dj) & 1) ? other_buf : own_buf;
  return a;
}

// One pixel of llin8 or disp relaxed: local colour kLc, column e of its
// pair, at q of its colour's planes, in sweep s (buffers as family_phase
// says). llin8 reads its neighbours' pre-added sums, one value a neighbour
// and field (16, where the fields would take 32), and writes its new fields
// and their sums; disp reads dU and U of its 4 neighbours. kEdge: the pixel
// has an edge bit, and its neighbours are read as neighbour_at says (llin8:
// clamped to the image, the clamped pixel's sum; disp: a border neighbour
// after sweep 0 holds this pixel's dU, its fill source, beside the border's
// own U); else at fixed offsets, which is every pixel but the image's outer
// ring (llin8) or the ring inside the border (disp).
template <class F, int kLc, bool kEdge>
__device__ __forceinline__ void relax_pixel(float* slot, const Geometry& g,
                                            const typename F::Px& c, uint32_t bits, int q, int e,
                                            int s, int rb, int wb, int ob, float omega,
                                            float one_minus_omega) {
  // field f's value at the pixel itself
  auto own = [&](int f) -> float& { return slot[value_plane<F>(f, kLc) * g.plane + q]; };
  if constexpr (F::kMut == 1) {  // disp
    const float du = own(0);
    // field f of the neighbour (di, dj), which has the other colour
    auto at = [&](int f, int di, int dj) {
      return slot[value_plane<F>(f, kLc ^ 1) * g.plane + q + di * g.hc + ((e + dj) >> 1)];
    };
    // its dU: this pixel's own where it lies on the border, after sweep 0
    auto dn = [&](int di, int dj) {
      return kEdge && s > 0 && (past_row(di, bits) || past_col(dj, bits)) ? du : at(0, di, dj);
    };
    const disp_sor::Coef k{c.a, c.b, c.c, c.d, c.uw, c.cu0, c.inv, (bits & 2) != 0};
    own(0) = disp_sor::update(du, dn(0, -1), at(1, 0, -1), dn(0, 1), at(1, 0, 1), dn(-1, 0),
                              at(1, -1, 0), dn(1, 0), at(1, 1, 0), k, omega, one_minus_omega);
  } else {  // llin8
    constexpr int kDi[8] = {0, 0, -1, 1, -1, -1, 1, 1};
    constexpr int kDj[8] = {-1, 1, 0, 0, -1, 1, -1, 1};
    // relaxed field f's sum at the neighbour (di, dj)
    auto sum = [&](int f, int di, int dj) {
      const At a = neighbour_at<F>(di, dj, kEdge ? bits : 0u, s, rb, ob);
      const int lc = kLc ^ ((a.di + a.dj) & 1);
      return slot[sum_plane<F>(f, lc, a.buf) * g.plane + q + a.di * g.hc + ((e + a.dj) >> 1)];
    };
    float2 nb[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) nb[n] = make_float2(sum(0, kDi[n], kDj[n]), sum(1, kDi[n], kDj[n]));
    const float fu = own(0), fv = own(1), uc = own(2), vc = own(3);
    const float2 r = flow_sor8::update_sums(
        [&](int n) { return nb[n]; }, [&](int n) { return c.c[flow_sor8::weight_of(n)]; }, fu, fv,
        uc, vc, c.wsum, (bits >> 1) & 3, c.m0, c.cu0, c.cv0, c.inv_u, c.inv_v, omega,
        one_minus_omega);
    own(0) = r.x;
    own(1) = r.y;
    slot[sum_plane<F>(0, kLc, wb) * g.plane + q] = __fadd_rn(r.x, uc);
    slot[sum_plane<F>(1, kLc, wb) * g.plane + q] = __fadd_rn(r.y, vc);
  }
}

// One colour phase of image colour `color` in sweep s: every live pixel of
// local colour kLc whose position lies in [i0, i1) x [j0, j1) relaxed
// (llin8 and disp by relax_pixel, a pixel without an edge bit at fixed
// offsets where kFast), pde4 and pde8 every channel of it: first every
// channel's reads (independent of each other, so that they overlap), then
// each channel's update and store.
template <class F, int kLc, bool kFast, int kSlots>
__device__ __forceinline__ void family_phase(float* slot, const Geometry& g,
                                             const uint32_t (&word)[kSlots],
                                             const typename F::Px (&px)[2][kSlots], int i0,
                                             int i1, int j0, int j1, int s, int color, float omega,
                                             float one_minus_omega) {
  // a relaxed field's buffers: its own colour's state before the phase, where
  // the phase writes, and the other colour's (its count of relaxations)
  const int rb = F::kBufs == 2 ? s & 1 : 0, wb = F::kBufs == 2 ? (s + 1) & 1 : 0;
  const int ob = F::kBufs == 2 ? (s + color) & 1 : 0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    uint32_t wd = word[j];
    asm volatile("" : "+r"(wd));
    const uint32_t bits = wd >> (16 + 8 * kLc);
    const int li = pair_row(wd), x = pair_col(wd);
    const int e = (li + kLc) & 1;  // the pixel's column in its pair
    const int lj = 2 * x + e;
    if (!(bits & kLive) || li < i0 || li >= i1 || lj < j0 || lj >= j1) continue;
    const int q = li * g.hc + x;
    const typename F::Px& c = px[kLc][j];
    if constexpr (!F::kDiag) {
      if (kFast && !(bits & kEdges))
        relax_pixel<F, kLc, false>(slot, g, c, bits, q, e, s, rb, wb, ob, omega, one_minus_omega);
      else
        relax_pixel<F, kLc, true>(slot, g, c, bits, q, e, s, rb, wb, ob, omega, one_minus_omega);
    } else {
      // field f of channel ch at the neighbour (di, dj), read as neighbour_at
      // says
      auto nbr = [&](int f, int di, int dj, int ch = 0) {
        const At a = neighbour_at<F>(di, dj, bits, s, rb, ob);
        const int lc = kLc ^ ((a.di + a.dj) & 1);
        const int buf = f < F::kMut && F::kBufs == 2 ? a.buf : 0;
        return slot[plane_of<F>(f, lc, buf, ch) * g.plane + q + a.di * g.hc +
                    ((e + a.dj) >> 1)];
      };
      if constexpr (F::kBufs == 1) {  // pde4
        float xc[F::kCh], xw[F::kCh], xe[F::kCh], xn[F::kCh], xs[F::kCh];
#pragma unroll
        for (int ch = 0; ch < F::kCh; ++ch) {
          xc[ch] = slot[plane_of<F>(0, kLc, 0, ch) * g.plane + q];
          xw[ch] = nbr(0, 0, -1, ch);
          xe[ch] = nbr(0, 0, 1, ch);
          xn[ch] = nbr(0, -1, 0, ch);
          xs[ch] = nbr(0, 1, 0, ch);
        }
#pragma unroll
        for (int ch = 0; ch < F::kCh; ++ch)
          slot[plane_of<F>(0, kLc, 0, ch) * g.plane + q] =
              pde4_sor::update(xc[ch], xw[ch], xe[ch], xn[ch], xs[ch], c.wt, c.inv_b[ch], omega,
                               one_minus_omega);
      } else {  // pde8
        float xc[F::kCh];
        pde8_sor::Nbr n[F::kCh];
#pragma unroll
        for (int ch = 0; ch < F::kCh; ++ch) {
          xc[ch] = slot[plane_of<F>(0, kLc, rb, ch) * g.plane + q];
          n[ch] = {nbr(0, 0, -1, ch),  nbr(0, 0, 1, ch),  nbr(0, -1, 0, ch), nbr(0, 1, 0, ch),
                   nbr(0, -1, -1, ch), nbr(0, -1, 1, ch), nbr(0, 1, -1, ch), nbr(0, 1, 1, ch)};
        }
#pragma unroll
        for (int ch = 0; ch < F::kCh; ++ch)
          slot[plane_of<F>(0, kLc, wb, ch) * g.plane + q] =
              pde8_sor::update(xc[ch], n[ch], c.wt, c.inv_b[ch], omega, one_minus_omega);
      }
    }
  }
}

// g.k red-black sweeps over the slot, each colour over the region the kept
// interior (and, for the border families, its fill sources) depends on.
template <class F, bool kFast, int kSlots>
__device__ __forceinline__ void sweep_family(float* slot, const Box& b, const Geometry& g,
                                             const uint32_t (&word)[kSlots],
                                             const typename F::Px (&px)[2][kSlots],
                                             float omega, float one_minus_omega) {
  const int rows = b.gr1 - b.gr0, cols = b.gc1 - b.gc0;
  const int tr0 = b.r0 - b.gr0, tr1 = b.r1 - b.gr0, tc0 = b.c0 - b.gc0, tc1 = b.c1 - b.gc0;
  const int par = (g.r0 + g.c0 + b.gr0 + b.gc0) & 1;  // the image colour of local colour 0
  for (int s = 0; s < g.k; ++s) {
    for (int color = 0; color < 2; ++color) {
      const int reach = 2 * (g.k - 1 - s) + 1 - color + g.fill;
      const int i0 = max(tr0 - reach, 0), i1 = min(tr1 + reach, rows);
      const int j0 = max(tc0 - reach, 0), j1 = min(tc1 + reach, cols);
      if ((color ^ par) == 0)
        family_phase<F, 0, kFast>(slot, g, word, px, i0, i1, j0, j1, s, color, omega,
                                  one_minus_omega);
      else
        family_phase<F, 1, kFast>(slot, g, word, px, i0, i1, j0, j1, s, color, omega,
                                  one_minus_omega);
      __syncthreads();
    }
  }
}

// This thread's pixels of the tile's interior, from the slot, to the
// box-sized outputs of system sb (every channel where a block holds them);
// a pixel on the image's border (the border families) takes its fill
// source's value.
template <class F, int kSlots>
__device__ __forceinline__ void store_family(const Systems& sys, int sb, const float* slot,
                                             const Box& b, const Geometry& g,
                                             const uint32_t (&word)[kSlots]) {
  const int tr0 = b.r0 - b.gr0, tr1 = b.r1 - b.gr0, tc0 = b.c0 - b.gc0, tc1 = b.c1 - b.gc0;
  const int buf = F::kBufs == 2 ? g.k & 1 : 0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int li = pair_row(word[j]), x = pair_col(word[j]);
    if (li < tr0 || li >= tr1) continue;
    const size_t row = static_cast<size_t>(b.gr0 + li - g.bi0) * g.bw + (b.gc0 - g.bj0);
    const int gi = g.r0 + b.gr0 + li;
    const int si = li + (g.fill && gi == 0 ? 1 : 0) - (g.fill && gi == g.gh - 1 ? 1 : 0);
#pragma unroll
    for (int lc = 0; lc < 2; ++lc) {
      const int lj = 2 * x + ((li + lc) & 1);
      if (lj < tc0 || lj >= tc1) continue;
      const int gj = g.c0 + b.gc0 + lj;
      const int sj = lj + (g.fill && gj == 0 ? 1 : 0) - (g.fill && gj == g.gw - 1 ? 1 : 0);
      const int at = si * g.hc + (sj >> 1);
#pragma unroll
      for (int ch = 0; ch < F::kCh; ++ch)
#pragma unroll
        for (int f = 0; f < F::kMut; ++f)
          out_ptr(sys, sb + ch, f)[row + lj] =
              slot[(F::kPre ? value_plane<F>(f, (si + sj) & 1)
                            : plane_of<F>(f, (si + sj) & 1, buf, ch)) *
                       g.plane +
                   at];
    }
  }
}

// Serial: a block a tile (blockIdx.x) and, for disp, system (blockIdx.y);
// a pde4 or pde8 block relaxes all kCh channels of its tile.
// Double-buffered: persistent blocks walk the items t * batch + sb (tile t,
// system sb of the `batch` along the grid: disp's; pde4's and pde8's items
// are their tiles) in steps of gridDim.x, the system fastest, so that the
// blocks running at once read the same tile of the planes the systems share
// and L2 serves it once. The prefetch copies what copy_family copies
// serially (buffer 0 of a relaxed field, every channel's, the border
// families' halo pixel included). Buffer 1 of llin8's and pde8's relaxed
// fields is not copied: a recycled slot still holds an earlier item's
// values there, and no phase reads a pixel of buffer 1 before this item's
// sweeps wrote it (the serial kernel's slot starts undefined too), so both
// forms give the same bits.
template <int kFam, int kCh, bool kDouble, int kSlots>
__global__ void __launch_bounds__(max_threads(kFam, kSlots), min_blocks(kFam, kSlots))
    tiled_family_kernel(Systems sys, Geometry g, int batch, float omega, float one_minus_omega) {
  using F = Fam<kFam, kCh>;
  // llin8's double-buffered form runs every pixel on the edge path: the
  // fixed-offset path measured 13% slower there at 1024x1024 (PERF.md)
  constexpr bool kFast = !(kDouble && kFam == kLlin8);
  extern __shared__ __align__(16) float smem[];
  uint32_t pos[kSlots], word[kSlots];
  typename F::Px px[2][kSlots];
  pair_positions(pos, g);
  if constexpr (!kDouble) {
    // the serial form apart: the item loop's live state would cost it
    // registers, and with them its second block an SM
    const int sb = F::kDiag ? 0 : blockIdx.y;
    const Box b = tile_box(g, blockIdx.x);
    copy_family<F>(smem, sys, sb, b, g, pos);
    __pipeline_commit();
    // the coefficients while the copies are in flight
    load_family<F>(sys, sb, b, g, pos, px, word);
    __pipeline_wait_prior(0);
    fill_sums<F>(smem, b, g, pos);
    __syncthreads();
    sweep_family<F, kFast>(smem, b, g, word, px, omega, one_minus_omega);
    store_family<F>(sys, sb, smem, b, g, word);
  } else {
    batch = F::kDiag ? 1 : batch;  // a constant where the block holds the channels
    const int n_items = g.n_tiles * batch;
    int item = blockIdx.x;
    int s = 0;  // the slot of the current item
    if (item < n_items) copy_family<F>(smem, sys, item % batch, tile_box(g, item / batch), g, pos);
    __pipeline_commit();
    for (; item < n_items; item += gridDim.x) {
      const int sb = item % batch;
      const Box b = tile_box(g, item / batch);
      float* slot = smem + s * g.slot_floats;
      // the neighbour planes of the block's next item into the other slot
      const int next = item + gridDim.x;
      if (next < n_items)
        copy_family<F>(smem + (s ^ 1) * g.slot_floats, sys, next % batch,
                       tile_box(g, next / batch), g, pos);
      __pipeline_commit();
      // this item's coefficients while the copies are in flight
      load_family<F>(sys, sb, b, g, pos, px, word);
      // this item's group: all but the newest
      __pipeline_wait_prior(1);
      fill_sums<F>(slot, b, g, pos);
      __syncthreads();
      sweep_family<F, kFast>(slot, b, g, word, px, omega, one_minus_omega);
      store_family<F>(sys, sb, slot, b, g, word);
      // drain: every thread has stored from this slot before the next
      // item's prefetch refills it
      __syncthreads();
      s ^= 1;
    }
    __pipeline_wait_prior(0);
  }
}

// `batch` the systems along the grid: disp's, 1 for the families whose
// block holds its channels.
template <int kFam, int kCh, bool kDouble, int kSlots>
cudaError_t launch_family(const Systems& sys, int batch, const Geometry& g, int threads,
                          float omega, float one_minus_omega, cudaStream_t stream) {
  const auto kernel = tiled_family_kernel<kFam, kCh, kDouble, kSlots>;
  const int smem = (kDouble ? 2 : 1) * g.slot_floats * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(g.n_tiles, batch);
  if (kDouble) {
    // persistent, over every (tile, system) item
    int blocks = 0;
    if ((err = persistent_blocks(kernel, threads, smem, g.n_tiles * batch, &blocks)) !=
        cudaSuccess)
      return err;
    grid = dim3(blocks, 1);
  }
  kernel<<<grid, threads, smem, stream>>>(sys, g, batch, omega, one_minus_omega);
  return cudaGetLastError();
}

template <int kFam, int kCh, bool kDouble>
cudaError_t family_slots(int slots, const Systems& sys, int batch, const Geometry& g,
                         float omega, float one_minus_omega, cudaStream_t stream) {
  const int threads = block_threads(kFam, g.k, g.tile_h, g.tile_w, slots);
  switch (slots) {
    case 1:
      return launch_family<kFam, kCh, kDouble, 1>(sys, batch, g, threads, omega,
                                                  one_minus_omega, stream);
    case 2:
      return launch_family<kFam, kCh, kDouble, 2>(sys, batch, g, threads, omega,
                                                  one_minus_omega, stream);
    case 3:
      return launch_family<kFam, kCh, kDouble, 3>(sys, batch, g, threads, omega,
                                                  one_minus_omega, stream);
    default:
      return launch_family<kFam, kCh, kDouble, 4>(sys, batch, g, threads, omega,
                                                  one_minus_omega, stream);
  }
}

// One family's launch, serial or double-buffered, kCh channels a block;
// refuses a plan the kernel does not take.
template <int kFam, int kCh = 1>
cudaError_t family_form(int slots, int double_buffer, const Systems& sys, int batch,
                        const Geometry& g, float omega, float one_minus_omega,
                        cudaStream_t stream) {
  const cudaError_t bad = check_plan(kFam, g, slots, double_buffer);
  if (bad != cudaSuccess) return bad;
  return double_buffer
             ? family_slots<kFam, kCh, true>(slots, sys, batch, g, omega, one_minus_omega, stream)
             : family_slots<kFam, kCh, false>(slots, sys, batch, g, omega, one_minus_omega,
                                              stream);
}

// pde4 or pde8 over its `batch` channels, all in a block.
template <int kFam>
cudaError_t diag_form(int slots, int double_buffer, const Systems& sys, int batch,
                      const Geometry& g, float omega, float one_minus_omega, cudaStream_t stream) {
  switch (batch) {
    case 1:
      return family_form<kFam, 1>(slots, double_buffer, sys, 1, g, omega, one_minus_omega,
                                  stream);
    case 2:
      return family_form<kFam, 2>(slots, double_buffer, sys, 1, g, omega, one_minus_omega,
                                  stream);
    default:
      return family_form<kFam, 3>(slots, double_buffer, sys, 1, g, omega, one_minus_omega,
                                  stream);
  }
}

// One launch of a chunk of `family` (disp, pde4, llin8 or pde8).
cudaError_t family_chunk(int family, const Systems& sys, int batch, Geometry g, int slots,
                         int double_buffer, float omega, float one_minus_omega, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = fields_of(family);
  g.vec2 = 1;
  g.shared = 1;
  for (int b = 0; b < batch; ++b) {
    g.vec2 &= aligned8(sys.in[b], n);
    // pde4, pde8: TRACE and B one plane the channels share
    g.shared &= sys.in[b][1] == sys.in[0][1] && sys.in[b][2] == sys.in[0][2];
  }
  switch (family) {
    case kDisp:
      return family_form<kDisp>(slots, double_buffer, sys, batch, g, omega, one_minus_omega, s);
    case kPde4:
      return diag_form<kPde4>(slots, double_buffer, sys, batch, g, omega, one_minus_omega, s);
    case kLlin8:
      return family_form<kLlin8>(slots, double_buffer, sys, batch, g, omega, one_minus_omega, s);
    case kPde8:
      return diag_form<kPde8>(slots, double_buffer, sys, batch, g, omega, one_minus_omega, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The systems of a launch from the caller's arrays: `fields` batch x
// fields_of(family) pointers, `out` batch x mut_of(family); false for what
// the kernel does not take, pde4's and pde8's weights not one plane the
// channels share among it.
bool family_systems(int family, const void* const* fields, void* const* out, int batch,
                    Systems* sys) {
  if (family < kDisp || family >= kFamilies || batch < 1 || batch > max_batch(family))
    return false;
  *sys = Systems{};
  const int n = fields_of(family), m = mut_of(family);
  for (int b = 0; b < batch; ++b) {
    for (int f = 0; f < n; ++f) sys->in[b][f] = static_cast<const float*>(fields[b * n + f]);
    for (int f = 0; f < m; ++f) sys->out[b][f] = static_cast<float*>(out[b * m + f]);
    if (diag_of(family))
      for (int f = 3; f < n; ++f)
        if (sys->in[b][f] != sys->in[0][f]) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// Shared memory of one slot of `family` (0 llin4, 1 elin4, 2 disp llin4,
// 3 pde4, 4 llin8, 5 pde8: kernels/tiled.py::LAYOUTS' order) for the plan's
// `k` and tile and a launch of `batch` systems or channels;
// tiled.py::slot_bytes computes the same.
int tiled_sor_slot_bytes(int family, int k, int tile_h, int tile_w, int batch) {
  if (family < 0 || family >= kFamilies || batch < 1 || batch > max_batch(family)) return -1;
  return slot_floats(family, k, tile_h, tile_w, batch) * static_cast<int>(sizeof(float));
}

// Threads a block of `family` for the plan's k, tile and slots a thread;
// tiled.py::block_threads computes the same.
int tiled_sor_threads(int family, int k, int tile_h, int tile_w, int slots) {
  if (family < 0 || family >= kFamilies) return -1;
  return block_threads(family, k, tile_h, tile_w, slots);
}

// All pointers are contiguous float32 (H, W) arrays on the current device.
// du_out/dv_out receive du/dv after `iters` sweeps; tmp_u/tmp_v are a second
// pair the chunks alternate with (unused, and may be null, when iters <= k).
// Launches ceil(iters / k) kernels on `stream`, double-buffered if
// `double_buffer` is not 0; `slots` pairs of pixels a thread (1 to 4).
int tiled_flow_llin4(const void* du, const void* dv, const void* u, const void* v, const void* m,
                     const void* cu, const void* cv, const void* duc, const void* dvc,
                     const void* ww, const void* wn, const void* we, const void* ws,
                     void* du_out, void* dv_out, void* tmp_u, void* tmp_v, int h, int w,
                     int iters, int k, int tile_h, int tile_w, int slots, int double_buffer,
                     float omega, float one_minus_omega, void* stream) {
  const void* fields[13] = {du, dv, u, v, m, cu, cv, duc, dvc, ww, wn, we, ws};
  return run_tiled<true>(fields, du_out, dv_out, tmp_u, tmp_v, h, w, iters, k, tile_h, tile_w,
                         slots, double_buffer, omega, one_minus_omega, stream);
}

// The early form: u, v are the flow, relaxed into u_out/v_out.
int tiled_flow_elin4(const void* u, const void* v, const void* m, const void* cu, const void* cv,
                     const void* duc, const void* dvc, const void* ww, const void* wn,
                     const void* we, const void* ws, void* u_out, void* v_out, void* tmp_u,
                     void* tmp_v, int h, int w, int iters, int k, int tile_h, int tile_w,
                     int slots, int double_buffer, float omega, float one_minus_omega,
                     void* stream) {
  const void* fields[11] = {u, v, m, cu, cv, duc, dvc, ww, wn, we, ws};
  return run_tiled<false>(fields, u_out, v_out, tmp_u, tmp_v, h, w, iters, k, tile_h, tile_w,
                          slots, double_buffer, omega, one_minus_omega, stream);
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
                         int tile_w, int slots, int double_buffer, float omega,
                         float one_minus_omega, void* stream) {
  const void* fields[13] = {du, dv, u, v, m, cu, cv, duc, dvc, ww, wn, we, ws};
  return run_window<true>(fields, du_out, dv_out, h, w, r0, c0, gh, gw, bi0, bj0, bh, bw, k,
                          tile_h, tile_w, slots, double_buffer, omega, one_minus_omega, stream);
}

int tiled_flow_elin4_win(const void* u, const void* v, const void* m, const void* cu,
                         const void* cv, const void* duc, const void* dvc, const void* ww,
                         const void* wn, const void* we, const void* ws, void* u_out, void* v_out,
                         int h, int w, int r0, int c0, int gh, int gw, int bi0, int bj0, int bh,
                         int bw, int k, int tile_h, int tile_w, int slots, int double_buffer,
                         float omega, float one_minus_omega, void* stream) {
  const void* fields[11] = {u, v, m, cu, cv, duc, dvc, ww, wn, we, ws};
  return run_window<false>(fields, u_out, v_out, h, w, r0, c0, gh, gw, bi0, bj0, bh, bw, k,
                           tile_h, tile_w, slots, double_buffer, omega, one_minus_omega, stream);
}

// disp llin4 (2), pde4 (3), llin8 (4) or pde8 (5): `fields` holds
// batch x fields_of(family) pointers (each system's fields in the order of
// kernels/tiled_cuda.py::FIELD_NAMES; a plane shared by the systems repeats
// its pointer; pde4's and pde8's weights must be one plane the channels
// share), `out` and `tmp` batch x the relaxed fields (tmp unused, and may
// hold nulls, when iters <= k). All are contiguous float32 (H, W) arrays on
// the current device, H, W >= 3 for the families that fill the border.
// Launches ceil(iters / k) kernels on `stream`, a block a tile (and disp
// system; a pde4 or pde8 block takes every channel), or persistent blocks if
// `double_buffer` is not 0; `slots` pairs of pixels a thread (1 to 4).
int tiled_sor_family(int family, const void* const* fields, void* const* out, void* const* tmp,
                     int batch, int h, int w, int iters, int k, int tile_h, int tile_w, int slots,
                     int double_buffer, float omega, float one_minus_omega, void* stream) {
  Systems sys, next;
  if (!family_systems(family, fields, out, batch, &sys) || h < 1 || w < 1 || k < 1 ||
      tile_h < 1 || tile_w < 1 || (fill_of(family) && (h < 3 || w < 3)))
    return cudaErrorInvalidValue;
  if (!family_systems(family, fields, tmp, batch, &next)) return cudaErrorInvalidValue;
  const int m = mut_of(family);
  const int n_full = iters / k, rem = iters % k, n_chunks = n_full + (rem > 0 ? 1 : 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int kc = c < n_full ? k : rem;
    const Geometry g =
        geometry(family, h, w, 0, 0, h, w, 0, 0, h, w, kc, tile_h, tile_w, batch);
    // chunk c writes out or tmp so that the last one writes out
    Systems run = sys;
    for (int b = 0; b < batch; ++b)
      for (int f = 0; f < m; ++f)
        run.out[b][f] = (n_chunks - 1 - c) % 2 == 0 ? sys.out[b][f] : next.out[b][f];
    const cudaError_t err = family_chunk(family, run, batch, g, slots, double_buffer, omega,
                                         one_minus_omega, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    for (int b = 0; b < batch; ++b)
      for (int f = 0; f < m; ++f) sys.in[b][f] = run.out[b][f];
  }
  return static_cast<int>(cudaSuccess);
}

// The windowed variant of disp llin4, pde4 and llin8 (and pde8): the fields
// are h x w arrays at (r0, c0) of a gh x gw image; one launch of k sweeps
// over the tiles of the box (bi0, bj0) + bh x bw writes the box into `out`
// (bh x bw arrays), double-buffered if `double_buffer` is not 0. The caller
// keeps 2k pixels of the arrays (2k + 1 for the families that fill the
// border), or the image's edge, around the box.
int tiled_sor_family_win(int family, const void* const* fields, void* const* out, int batch,
                         int h, int w, int r0, int c0, int gh, int gw, int bi0, int bj0, int bh,
                         int bw, int k, int tile_h, int tile_w, int slots, int double_buffer,
                         float omega, float one_minus_omega, void* stream) {
  Systems sys;
  if (!family_systems(family, fields, out, batch, &sys) || h < 1 || w < 1 || k < 1 ||
      tile_h < 1 || tile_w < 1 || r0 < 0 || c0 < 0 || r0 + h > gh || c0 + w > gw || bi0 < 0 ||
      bj0 < 0 || bh < 1 || bw < 1 || bi0 + bh > h || bj0 + bw > w ||
      (fill_of(family) && (gh < 3 || gw < 3)))
    return cudaErrorInvalidValue;
  const Geometry g =
      geometry(family, h, w, r0, c0, gh, gw, bi0, bj0, bh, bw, k, tile_h, tile_w, batch);
  return static_cast<int>(family_chunk(family, sys, batch, g, slots, double_buffer, omega,
                                       one_minus_omega, stream));
}

const char* tiled_sor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
