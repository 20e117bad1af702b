// Batched tridiagonal line solves (Thomas elimination): the line solve under
// the zebra-ADI preconditioner of every PCG solver (solvers/krylov.py), the
// zebra ALR relaxations (solvers/tdma.py::alr_*) and diffusion4
// (models/diffusion.py), and the preconditioner's whole zebra parity pass
// fused into one launch.
//
// Replaces pde_tpu/kernels/tdma_pallas.py::_cr_kernel (tridiag_cr_pallas),
// the VMEM-resident cyclic-reduction solve along axis -2, and the XLA cyclic
// reduction and Thomas scans the JAX package reaches the same solves by.
// Its plain PyTorch versions are pde_tpu_torch/solvers/tdma.py::
// thomas_solve, tridiag_factor/tridiag_solve, line_factors/line_solve and
// zebra_pass.
//
// Systems: for each line, a[k] x[k-1] + b[k] x[k] + c[k] x[k+1] = d[k],
// k = 0..L-1, with a[0] and c[L-1] ignored (taken as zero, as
// tridiag_factor zeroes them). Fields are (B, H, W) float32 planes. A line
// runs along axis -2 (vertical: a column) or along axis -1 (horizontal: a
// row). A coefficient may be one (H, W) plane shared by the batch (batch
// stride 0).
//
// Arithmetic: one thread eliminates one line, in the plain scan's order,
// with every float operation rounded alone (__fmul_rn, __fsub_rn,
// __fdiv_rn, __fadd_rn), so every entry gives the plain version's floats:
//   denom = 1 / (b - cp' a),  cp = c denom,  dp = (d - dp' a) denom,
//   x     = dp - cp x_next.
// The TPU kernel used cyclic reduction for its vector lanes; Thomas does
// half the flops and keeps the plain version's rounding.
//
// Layout (what this design is for): a block takes a group of G lines (G a
// power of two, at most 32) of one zebra parity or of every line. Its 128
// threads copy the group's elements into shared memory with cp.async, R
// elements of each line a chunk (R rows of the group's columns for vertical
// lines, the group's rows times R contiguous columns for horizontal ones),
// into a ring of S stages: chunk i + S - 1 is in flight while thread t of
// warp 0 walks chunk i of line t, reading every operand from shared memory.
// A line's forward results (cp and dp, or cp and denom) stay in shared
// memory for the whole line (2 G L floats), so the backward pass reads no
// device memory either, and x leaves in one coalesced copy at the end.
// Rows are padded so that a walking thread moves 8 steps as two 16-byte
// accesses and the walking threads, which read across rows, hit distinct
// banks. G, R and S come from kernels/tdma_cuda.py::plan_lines (the plan
// scripts/tridiag_plan_sweep.py measured fastest: small G, so that even a
// parity's few lines give every SM a block); tridiag_smem_bytes gives the
// same bytes as the plan does.
//
// Lines of any length (the global-rows variant): where one line's resident
// rows do not fit in a block's shared memory even at G = 1 (a line of more
// than ~28,000 elements), plan_lines chooses, from the shape and before any
// launch, the variant whose forward results go to a scratch in device memory
// (2 rows of L a line, padded as the resident rows, from torch's allocator)
// instead: the same staged ring and the same arithmetic, so the same floats.
// The walker stores its forward results there (for solve and zebra it also
// copies cp there, staged as one more tile), walks back with its loads four
// batches ahead of the chain, and the copy-out reads them from there. The
// batch is folded into blockIdx.x, so a launch takes any batch.
//
// Entry points:
//   * tridiag_thomas: the whole solve of every line in one launch;
//   * tridiag_factor: cp and 1/denominator of every line, once per solver
//     call (the coefficients are fixed for its whole loop);
//   * tridiag_solve: the RHS pass with a factor, on every line or on the
//     lines of one zebra parity (columns or rows parity::2), reading the full
//     RHS and writing the parity lines compactly, as the plain line_solve
//     returns them. One full-field factor serves both parities: the per-line
//     arithmetic is the same as factoring each parity's lines apart;
//   * tridiag_zebra_pass: one pass of the zebra-ADI preconditioner on the
//     lines p::2 of field z (solvers/krylov.py::_zebra_adi): the RHS
//       d = ((rhs [- m z_o]) + w_lo z[lo]) + w_hi z[hi] [+ diagonal flux]
//     assembled from a staged window of z around the group (the neighbours
//     replicate at the image edge, as core/grid.py's shifts do), solved with
//     the factor, and written into z's lines p::2 in place. In place is
//     race-free: a block reads z on the lines p::2 of its own group (its own
//     lines, where a shift replicates at the edge) and on lines of the other
//     parity, and writes only its own lines, after it has read all it reads;
//     z_o is another field. One launch does what ~11 eager operations did
//     (~27 with the 8-neighbour diagonal flux).
// What bounds it: a solve reads d (and a, cp, denom) once and writes x,
// a few microseconds of device memory at the main path's sizes, but each line
// is a chain of 2 L dependent steps (3 rounded operations forward, 2 back),
// so a launch takes at least one chain: latency-bound. With every line of a
// launch in flight at once (small G), the walking thread's steps set the
// time; the forward walk shares the shared-memory pipe with the copy warps'
// cp.async, and a whole solve adds an IEEE division to each forward step.
// PERF.md has the measured cycles a step (scripts/tridiag_phase_clocks.py)
// and the times against the chain's floor.
//
// The kernels run on the caller's stream and allocate nothing. The C entry
// points return cudaGetLastError() of the launch (cudaErrorInvalidValue for
// a plan the kernel does not take).

#include <cstdint>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100
constexpr int kMaxTiles = 12;     // the zebra pass, coupled, 8 neighbours, cp staged

enum Mode { kThomas = 0, kFactor = 1, kSolve = 2, kZebra = 3 };

struct Src {
  const float* p;
  long long bstride;  // floats between batch items (0: one shared plane)
};

// The staged tiles in a fixed order per mode:
//   thomas a, b, c, d; factor a, b, c; solve a, denom, d;
//   zebra a, denom, rhs, w_lo, w_hi [, m, z_o] [, wnw, wne, wse, wsw].
// cp (solve, zebra) is copied straight into its resident row (the global-rows
// variant stages it as one more tile, last); z (zebra) is staged as a window
// around the group.
struct Srcs {
  Src f[kMaxTiles];
  Src cp;
  const float* z;
};

struct Out {
  float* p0;  // factor: cp
  float* p1;  // x (thomas, solve), denom (factor), z (zebra)
  long long bstride, base, tstride, kstride;  // element (b, t, k) of the launch
  float* rows;  // the global-rows variant's forward results: 2 rows of lp a line
};

struct Geo {
  int len;        // L
  int n_lines;    // lines solved per batch item
  int n_perp;     // lines in a plane (W vertical, H horizontal)
  int vertical;
  long long plane;                   // H * W
  long long ibase, itstride;         // offset of line t in a plane: ibase + t itstride
  long long qstride, kstride;        // plane offsets of a line index q and an element k
  int g, lg_g, stages, lp, n_tiles;  // the plan; lp: the resident rows' pitch
  int coupled, diag;
  int n_groups;  // blocks a batch item: block x takes group x % n_groups of item x / n_groups
};

// Row pitches in floats: an odd number of 16-byte units (R + 4 for the
// tiles, R a multiple of 8; L rounded up to 4 mod 8 for the resident rows),
// so that a walking thread reads and writes 8 steps of its row as two
// 16-byte accesses and 8 walking threads, reading across rows, hit
// distinct banks.
__host__ __device__ constexpr int tile_pitch(int r) { return r + 4; }
__host__ __device__ constexpr int window_pitch(int r) { return r + 4; }
__host__ __device__ constexpr int resident_pitch(int len) { return len + (((4 - len) % 8) + 8) % 8; }

int n_tiles_of(int mode, int coupled, int diag) {
  switch (mode) {
    case kThomas: return 4;
    case kFactor: return 3;
    case kSolve: return 3;
    default: return 5 + 2 * coupled + 4 * diag;
  }
}

// The global-rows variant stages cp (solve, zebra) as one more tile and keeps
// no resident rows in shared memory.
int staged_tiles(int mode, int coupled, int diag, int global_rows) {
  return n_tiles_of(mode, coupled, diag) + (global_rows && (mode == kSolve || mode == kZebra));
}

long long smem_bytes_of(int mode, int coupled, int diag, int len, int g, int r, int stages,
                        int global_rows) {
  const long long lp = resident_pitch(len);
  const long long stage = static_cast<long long>(staged_tiles(mode, coupled, diag, global_rows)) *
                              g * tile_pitch(r) +
                          (mode == kZebra ? (2LL * g + 1) * window_pitch(r) : 0);
  return 4 * ((global_rows ? 0 : 2 * g * lp) + stages * stage);
}

__device__ __forceinline__ void wait_prior(int n) {
  switch (n) {
    case 1: __pipeline_wait_prior(1); break;
    case 2: __pipeline_wait_prior(2); break;
    case 3: __pipeline_wait_prior(3); break;
    default: __pipeline_wait_prior(0); break;
  }
}

constexpr int kBatch = 8;  // steps a walking thread loads before it runs their chain

__device__ __forceinline__ void load8(const float* p, float (&v)[kBatch]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  const float4 y = *reinterpret_cast<const float4*>(p + 4);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w, v[4] = y.x, v[5] = y.y, v[6] = y.z, v[7] = y.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kBatch]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// Line t's forward pass over steps [k, k + n) of a staged chunk whose first
// element is k0, n = kBatch from a multiple of 8 (16-byte accesses) or 1:
// every operand of the n steps into registers (the zebra RHS assembled
// from the window), then their chain, carried in cp_prev and dp_prev, then
// the stores into the resident rows r0 and r1 (at k0). st is the line's
// row of the stage's first tile (the tiles lie tile_f apart), zw its
// centre line of the z window at k0. With kGlobalRows the rows lie in device
// memory, and solve and zebra also copy cp (the last staged tile) into r0.
template <int kMode, int kR, bool kCoupled, bool kDiag, bool kGlobalRows, int n>
__device__ __forceinline__ void walk_steps(const float* st, const float* zw, float* r0,
                                           float* r1, int tile_f, int k0, int k, int len,
                                           int ne_at, int sw_at, float& cp_prev,
                                           float& dp_prev) {
  constexpr int kWp = window_pitch(kR);
  float av[kBatch], bv[kBatch], cv[kBatch], dv[kBatch];
  auto load = [&](int field, float (&v)[kBatch]) {
    if (n == kBatch) {
      load8(st + field * tile_f + k, v);
    } else {
      v[0] = st[field * tile_f + k];
    }
  };
  load(0, av);
  if (k0 + k == 0) av[0] = 0.0f;
  load(1, bv);  // b, or the factor's denominator
  if (kMode == kThomas || kMode == kFactor) {
    load(2, cv);
#pragma unroll
    for (int u = 0; u < n; ++u)
      if (k0 + k + u == len - 1) cv[u] = 0.0f;
  }
  if (kMode == kThomas) load(3, dv);
  if (kMode == kSolve) load(2, dv);
  constexpr bool kCopyCp = kGlobalRows && (kMode == kSolve || kMode == kZebra);
  if (kCopyCp) load(kMode == kSolve ? 3 : 5 + 2 * kCoupled + 4 * kDiag, cv);
  if (kMode == kZebra) {
    float lo[kBatch], hi[kBatch];
    load(2, dv);  // rhs
    if (kCoupled) {
      load(5, lo);
      load(6, hi);
#pragma unroll
      for (int u = 0; u < n; ++u) dv[u] = __fsub_rn(dv[u], __fmul_rn(lo[u], hi[u]));
    }
    load(3, lo);
    load(4, hi);
    // z's lines 2t (lo) and 2t + 2 (hi) of the window, at element k + u
#pragma unroll
    for (int u = 0; u < n; ++u)
      dv[u] = __fadd_rn(__fadd_rn(dv[u], __fmul_rn(lo[u], zw[k + u])),
                        __fmul_rn(hi[u], zw[2 * kWp + k + u]));
    if (kDiag) {
      // ((wnw z_nw + wne z_ne) + wse z_se) + wsw z_sw
      const int wd = kCoupled ? 7 : 5;
      float w0[kBatch], w1[kBatch];
      load(wd, w0);
      load(wd + 1, w1);
#pragma unroll
      for (int u = 0; u < n; ++u)
        lo[u] = __fadd_rn(__fmul_rn(w0[u], zw[k + u - 1]), __fmul_rn(w1[u], zw[ne_at + k + u]));
      load(wd + 2, w0);
      load(wd + 3, w1);
#pragma unroll
      for (int u = 0; u < n; ++u)
        dv[u] = __fadd_rn(dv[u], __fadd_rn(__fadd_rn(lo[u], __fmul_rn(w0[u], zw[2 * kWp + 1 + k + u])),
                                           __fmul_rn(w1[u], zw[sw_at + k + u])));
    }
  }
#pragma unroll
  for (int u = 0; u < n; ++u) {
    if (kMode == kThomas || kMode == kFactor) {
      const float dn = __fdiv_rn(1.0f, __fsub_rn(bv[u], __fmul_rn(cp_prev, av[u])));
      cp_prev = __fmul_rn(cv[u], dn);
      cv[u] = cp_prev;
      if (kMode == kThomas) dp_prev = __fmul_rn(__fsub_rn(dv[u], __fmul_rn(dp_prev, av[u])), dn);
      dv[u] = kMode == kThomas ? dp_prev : dn;
    } else {
      dp_prev = __fmul_rn(__fsub_rn(dv[u], __fmul_rn(dp_prev, av[u])), bv[u]);
      dv[u] = dp_prev;
    }
  }
  if (n == kBatch) {
    if (kMode == kThomas || kMode == kFactor || kCopyCp) store8(r0 + k, cv);
    store8(r1 + k, dv);
  } else {
    if (kMode == kThomas || kMode == kFactor || kCopyCp) r0[k] = cv[0];
    r1[k] = dv[0];
  }
}

// Line t's forward pass over one staged chunk [k0, k0 + nk).
template <int kMode, int kR, bool kCoupled, bool kDiag, bool kGlobalRows>
__device__ __forceinline__ void walk_chunk(const float* st, const float* zw, float* r0, float* r1,
                                           int tile_f, int k0, int nk, int len, int ne_at,
                                           int sw_at, float& cp_prev, float& dp_prev) {
  int k = 0;
  for (; k + kBatch <= nk; k += kBatch)
    walk_steps<kMode, kR, kCoupled, kDiag, kGlobalRows, kBatch>(
        st, zw, r0, r1, tile_f, k0, k, len, ne_at, sw_at, cp_prev, dp_prev);
  for (; k < nk; ++k)
    walk_steps<kMode, kR, kCoupled, kDiag, kGlobalRows, 1>(st, zw, r0, r1, tile_f, k0, k, len,
                                                           ne_at, sw_at, cp_prev, dp_prev);
}

// One batch of the backward chain, x = dp - cp x_next, in place in xv.
__device__ __forceinline__ void back_batch(const float (&cv)[kBatch], float (&xv)[kBatch],
                                           float& x_next) {
#pragma unroll
  for (int u = kBatch - 1; u >= 0; --u) {
    x_next = __fsub_rn(xv[u], __fmul_rn(cv[u], x_next));
    xv[u] = x_next;
  }
}

// Line t's backward pass over the resident rows: x = dp - cp x_next, in
// place; the elements above the last multiple of 8 one by one, then 8 at
// a time with 16-byte accesses, their loads ahead of their chain. Rows in
// device memory (kGlobalRows) are loaded kAhead batches ahead, so that the
// chain does not wait a memory latency a batch.
template <bool kGlobalRows>
__device__ __forceinline__ void walk_back(const float* r0, float* r1, int len) {
  float x_next = 0.0f;
  const int top = len & ~(kBatch - 1);
  for (int k = len - 1; k >= top; --k) {
    x_next = __fsub_rn(r1[k], __fmul_rn(r0[k], x_next));
    r1[k] = x_next;
  }
  if (!kGlobalRows) {
    for (int kb = top - kBatch; kb >= 0; kb -= kBatch) {
      float cv[kBatch], xv[kBatch];
      load8(r0 + kb, cv);
      load8(r1 + kb, xv);
      back_batch(cv, xv, x_next);
      store8(r1 + kb, xv);
    }
    return;
  }
  constexpr int kAhead = 4;
  float cv[kAhead][kBatch], xv[kAhead][kBatch];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const int kb = top - (j + 1) * kBatch;
    if (kb >= 0) {
      load8(r0 + kb, cv[j]);
      load8(r1 + kb, xv[j]);
    }
  }
  for (int base = top; base > 0; base -= kAhead * kBatch) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int kb = base - (j + 1) * kBatch;
      if (kb >= 0) {
        back_batch(cv[j], xv[j], x_next);
        store8(r1 + kb, xv[j]);
        const int next = kb - kAhead * kBatch;
        if (next >= 0) {
          load8(r0 + next, cv[j]);
          load8(r1 + next, xv[j]);
        }
      }
    }
  }
}

// Warp 0 walks (thread t: line t of the group); warps 1.. copy. Chunk ch
// lives in stage ch % S. Each round: the copiers wait for chunk ch, one
// barrier (chunk ch visible to the walkers, and chunk ch - 1's stage
// walked), then the copiers issue chunk ch + S - 1 into that freed stage
// while the walkers walk chunk ch. kGlobalRows: the forward results of line
// t in out.rows (rows apart by row_f floats) instead of shared memory.
template <int kMode, int kR, bool kGlobalRows>
__global__ void __launch_bounds__(kThreads) lines_kernel(Srcs src, Out out, Geo g) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kRp = tile_pitch(kR);
  constexpr int kWp = window_pitch(kR);
  constexpr int kCopiers = kThreads - 32;
  const int b = blockIdx.x / g.n_groups;
  const int t0 = (blockIdx.x % g.n_groups) * g.g;
  const int n_g = min(g.g, g.n_lines - t0);
  // res0: cp; res1: dp, then x (denom for the factor); line t's at t row_f
  const long long row_f = kGlobalRows ? 2LL * g.lp : g.lp;
  float* res0 = kGlobalRows ? out.rows + (static_cast<long long>(b) * g.n_lines + t0) * row_f
                            : smem;
  float* res1 = kGlobalRows ? res0 + g.lp : smem + g.g * g.lp;
  float* ring = kGlobalRows ? smem : res1 + g.g * g.lp;
  const int tile_f = g.g * kRp;
  const int stage_f = g.n_tiles * tile_f + (kMode == kZebra ? (2 * g.g + 1) * kWp : 0);
  const int n_chunks = (g.len + kR - 1) / kR;
  const long long group = g.ibase + t0 * g.itstride;
  const int walker = threadIdx.x < 32;
  const int ct = threadIdx.x - 32;  // copier index

  // chunk ch into its stage as one commit group (empty past the last
  // chunk): element (t, k) of every staged field, adjacent copiers on the
  // group's adjacent columns (vertical) or along a row (horizontal); the
  // offsets are worked out once an element and serve every field
  auto issue = [&](int ch) {
    if (ch < n_chunks) {
      float* st = ring + (ch % g.stages) * stage_f;
      const int k0 = ch * kR, nk = min(kR, g.len - k0);
      const long long at = group + k0 * g.kstride;
      for (int e = ct; e < g.g * kR; e += kCopiers) {
        const int t = g.vertical ? e & (g.g - 1) : e / kR;
        const int k = g.vertical ? e >> g.lg_g : e % kR;
        if (t >= n_g || k >= nk) continue;
        const long long off = at + t * g.itstride + k * g.kstride;
        float* dst = st + t * kRp + k;
#pragma unroll
        for (int i = 0; i < kMaxTiles; ++i)
          if (i < g.n_tiles)
            __pipeline_memcpy_async(dst + i * tile_f, src.f[i].p + b * src.f[i].bstride + off,
                                    sizeof(float));
        // cp straight into its resident rows
        if ((kMode == kSolve || kMode == kZebra) && !kGlobalRows)
          __pipeline_memcpy_async(res0 + t * g.lp + k0 + k, src.cp.p + b * src.cp.bstride + off,
                                  sizeof(float));
      }
      if (kMode == kZebra) {
        // z on the lines q0 - 1 .. q0 + 2 G - 1 around the group and the
        // elements k0 - 1 .. k0 + R, replicated at the image edge
        const int q0 = static_cast<int>(group / g.qstride);
        const int nc = 2 * g.g + 1;
        const float* zb = src.z + b * g.plane;
        float* dst = st + g.n_tiles * tile_f;
        for (int e = ct; e < nc * (kR + 2); e += kCopiers) {
          const int c = g.vertical ? e % nc : e / (kR + 2);
          const int r = g.vertical ? e / nc : e % (kR + 2);
          const int q = min(max(q0 - 1 + c, 0), g.n_perp - 1);
          const int k = min(max(k0 - 1 + r, 0), g.len - 1);
          __pipeline_memcpy_async(dst + c * kWp + r, zb + q * g.qstride + k * g.kstride,
                                  sizeof(float));
        }
      }
    }
    __pipeline_commit();
  };

  if (!walker)
    for (int ch = 0; ch < g.stages - 1; ++ch) issue(ch);
  const int t = threadIdx.x;
  // the window's NE and SW neighbours of element k (NW is k - 1, SE 2 Wp + 1)
  const int ne_at = g.vertical ? 2 * kWp - 1 : 1;
  const int sw_at = g.vertical ? 1 : 2 * kWp - 1;
  float cp_prev = 0.0f, dp_prev = 0.0f;
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (!walker) wait_prior(g.stages - 2);
    __syncthreads();
    if (!walker) {
      issue(ch + g.stages - 1);
    } else if (t < n_g) {
      const float* st = ring + (ch % g.stages) * stage_f + t * kRp;
      const float* zw = ring + (ch % g.stages) * stage_f + g.n_tiles * tile_f + 2 * t * kWp + 1;
      const int k0 = ch * kR, nk = min(kR, g.len - k0);
      float* r0 = res0 + t * row_f + k0;
      float* r1 = res1 + t * row_f + k0;
      // the zebra pass's form as compile-time flags
      auto walk = [&](auto coupled, auto diag) {
        walk_chunk<kMode, kR, decltype(coupled)::value, decltype(diag)::value, kGlobalRows>(
            st, zw, r0, r1, tile_f, k0, nk, g.len, ne_at, sw_at, cp_prev, dp_prev);
      };
      using yes = std::true_type;
      using no = std::false_type;
      if (kMode != kZebra || (!g.coupled && !g.diag)) walk(no(), no());
      else if (!g.diag) walk(yes(), no());
      else if (!g.coupled) walk(no(), yes());
      else walk(yes(), yes());
    }
  }
  if (!walker) __pipeline_wait_prior(0);
  if (kMode != kFactor && walker && t < n_g)
    walk_back<kGlobalRows>(res0 + t * row_f, res1 + t * row_f, g.len);
  __syncthreads();

  // the group's lines out, adjacent threads on adjacent addresses
  const long long ob = b * out.bstride + out.base + t0 * out.tstride;
  for (int which = kMode == kFactor ? 0 : 1; which < 2; ++which) {
    float* o = (which ? out.p1 : out.p0) + ob;
    const float* res = which ? res1 : res0;
    if (g.vertical) {
      for (int e = threadIdx.x; e < g.g * g.len; e += kThreads) {
        const int tt = e & (g.g - 1), k = e >> g.lg_g;
        if (tt < n_g) o[tt * out.tstride + k * out.kstride] = res[tt * row_f + k];
      }
    } else {
      for (int tt = 0; tt < n_g; ++tt)
        for (int k = threadIdx.x; k < g.len; k += kThreads)
          o[tt * out.tstride + k * out.kstride] = res[tt * row_f + k];
    }
  }
}

template <int kMode, int kR>
cudaError_t launch_r(const Srcs& s, const Out& o, const Geo& g, int batch, int smem,
                     cudaStream_t stream) {
  const auto kernel = o.rows ? lines_kernel<kMode, kR, true> : lines_kernel<kMode, kR, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = static_cast<long long>(g.n_groups) * batch;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(s, o, g);
  return cudaGetLastError();
}

int lg2(int g) {
  int l = 0;
  while ((1 << l) < g) ++l;
  return (1 << l) == g ? l : -1;
}

// Fills the geometry of a launch over the lines parity::2 (parity < 0: every
// line) and launches it with the plan (g, r, stages), the global-rows variant
// where rows is not null; refuses a plan the kernel does not take.
template <int kMode>
int launch(Srcs& s, Out& o, int batch, int h, int w, int vertical, int parity, int coupled,
           int diag, int g_lines, int r, int stages, void* rows, cudaStream_t stream) {
  const int global_rows = rows != nullptr;
  o.rows = static_cast<float*>(rows);
  Geo g{};
  g.len = vertical ? h : w;
  g.n_perp = vertical ? w : h;
  g.n_lines = parity < 0 ? g.n_perp : (g.n_perp - parity + 1) / 2;
  g.vertical = vertical;
  g.plane = static_cast<long long>(h) * w;
  g.qstride = vertical ? 1 : w;
  g.kstride = vertical ? w : 1;
  g.ibase = (parity < 0 ? 0 : parity) * g.qstride;
  g.itstride = (parity < 0 ? 1 : 2) * g.qstride;
  g.g = g_lines;
  g.lg_g = lg2(g_lines);
  g.stages = stages;
  g.lp = resident_pitch(g.len);
  g.n_tiles = staged_tiles(kMode, coupled, diag, global_rows);
  // the global-rows variant stages cp last
  if (global_rows && (kMode == kSolve || kMode == kZebra)) s.f[g.n_tiles - 1] = s.cp;
  g.coupled = coupled;
  g.diag = diag;
  g.n_groups = (g.n_lines + g_lines - 1) / max(g_lines, 1);
  const long long smem = smem_bytes_of(kMode, coupled, diag, g.len, g_lines, r, stages,
                                       global_rows);
  if (g.lg_g < 0 || g_lines > 32 || stages < 2 || stages > 4 || smem > kMaxSmem ||
      (kMode == kZebra && parity < 0) ||
      static_cast<long long>(g.n_groups) * batch > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || g.n_lines == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err;
  switch (r) {
    case 32: err = launch_r<kMode, 32>(s, o, g, batch, static_cast<int>(smem), stream); break;
    case 64: err = launch_r<kMode, 64>(s, o, g, batch, static_cast<int>(smem), stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const float* f(const void* p) { return static_cast<const float*>(p); }

// Output of every line, in full (b, q, k) planes.
Out full_out(void* p0, void* p1, int h, int w, int vertical, int parity) {
  const long long qstride = vertical ? 1 : w;
  return Out{static_cast<float*>(p0), static_cast<float*>(p1), static_cast<long long>(h) * w,
             (parity < 0 ? 0 : parity) * qstride, (parity < 0 ? 1 : 2) * qstride,
             vertical ? w : 1, nullptr};
}

}  // namespace

extern "C" {

// Every pointer is a contiguous float32 array on the current device. a, b, c
// are (H, W) planes with batch strides sa, sb, sc (0: one plane shared by the
// batch; H * W: one plane per batch item); d and x are (batch, H, W).
// vertical = 1 solves along axis -2, 0 along axis -1. (g, r, stages) is the
// plan: G lines a block, R elements a chunk, S stages in the ring. rows is
// null, or the global-rows variant's scratch of batch x (lines solved) x 2
// rows of resident_pitch(L) floats.
int tridiag_thomas(const void* a, const void* b, const void* c, const void* d, void* x,
                   long long sa, long long sb, long long sc, int batch, int h, int w,
                   int vertical, int g, int r, int stages, void* rows, void* stream) {
  const long long plane = static_cast<long long>(h) * w;
  Srcs s{};
  s.f[0] = Src{f(a), sa};
  s.f[1] = Src{f(b), sb};
  s.f[2] = Src{f(c), sc};
  s.f[3] = Src{f(d), plane};
  Out o = full_out(nullptr, x, h, w, vertical, -1);
  return launch<kThomas>(s, o, batch, h, w, vertical, -1, 0, 0, g, r, stages, rows,
                         static_cast<cudaStream_t>(stream));
}

// cp and denom receive the (batch, H, W) factor of the field's lines.
int tridiag_factor(const void* a, const void* b, const void* c, void* cp, void* denom,
                   long long sa, long long sb, long long sc, int batch, int h, int w,
                   int vertical, int g, int r, int stages, void* rows, void* stream) {
  Srcs s{};
  s.f[0] = Src{f(a), sa};
  s.f[1] = Src{f(b), sb};
  s.f[2] = Src{f(c), sc};
  Out o = full_out(cp, denom, h, w, vertical, -1);
  return launch<kFactor>(s, o, batch, h, w, vertical, -1, 0, 0, g, r, stages, rows,
                         static_cast<cudaStream_t>(stream));
}

// d is (batch, H, W); a has batch stride sa, cp and denom sf. parity < 0
// solves every line into a (batch, H, W) x; parity 0 or 1 solves the columns
// (vertical) or rows (horizontal) parity::2 into a compact x of shape
// (batch, H, ceil((W - parity) / 2)) or (batch, ceil((H - parity) / 2), W).
int tridiag_solve(const void* a, const void* cp, const void* denom, const void* d, void* x,
                  long long sa, long long sf, int batch, int h, int w, int vertical, int parity,
                  int g, int r, int stages, void* rows, void* stream) {
  const long long plane = static_cast<long long>(h) * w;
  Srcs s{};
  s.f[0] = Src{f(a), sa};
  s.f[1] = Src{f(denom), sf};
  s.f[2] = Src{f(d), plane};
  s.cp = Src{f(cp), sf};
  Out o;
  if (parity < 0) {
    o = full_out(nullptr, x, h, w, vertical, -1);
  } else {
    const long long n_sel = ((vertical ? w : h) - parity + 1) / 2;
    o = Out{nullptr, static_cast<float*>(x), n_sel * (vertical ? h : w), 0,
            vertical ? 1 : w, vertical ? n_sel : 1, nullptr};
  }
  return launch<kSolve>(s, o, batch, h, w, vertical, parity, 0, 0, g, r, stages, rows,
                        static_cast<cudaStream_t>(stream));
}

// One zebra-ADI pass on the lines parity::2 of z (batch, H, W), in place:
// d = ((rhs - m z_o) + w_lo z[lo]) + w_hi z[hi] (+ the diagonal flux
// ((wnw z_nw + wne z_ne) + wse z_se) + wsw z_sw when diag), then the RHS pass
// of the factor (a, cp, denom). rhs and z_o are (batch, H, W); m (coupled
// only) has batch stride sm, the weights sw, a sa, cp and denom sf. lo and
// hi are the W and E neighbours (vertical) or N and S (horizontal).
int tridiag_zebra_pass(const void* a, const void* cp, const void* denom, const void* rhs,
                       const void* w_lo, const void* w_hi, const void* m, const void* z_o,
                       const void* wnw, const void* wne, const void* wse, const void* wsw,
                       void* z, long long sa, long long sf, long long sw, long long sm,
                       int batch, int h, int w, int vertical, int parity, int coupled,
                       int diag, int g, int r, int stages, void* rows, void* stream) {
  const long long plane = static_cast<long long>(h) * w;
  Srcs s{};
  s.f[0] = Src{f(a), sa};
  s.f[1] = Src{f(denom), sf};
  s.f[2] = Src{f(rhs), plane};
  s.f[3] = Src{f(w_lo), sw};
  s.f[4] = Src{f(w_hi), sw};
  int i = 5;
  if (coupled) {
    s.f[i++] = Src{f(m), sm};
    s.f[i++] = Src{f(z_o), plane};
  }
  if (diag) {
    s.f[i++] = Src{f(wnw), sw};
    s.f[i++] = Src{f(wne), sw};
    s.f[i++] = Src{f(wse), sw};
    s.f[i++] = Src{f(wsw), sw};
  }
  s.cp = Src{f(cp), sf};
  s.z = f(z);
  Out o = full_out(nullptr, z, h, w, vertical, parity);
  return launch<kZebra>(s, o, batch, h, w, vertical, parity, coupled, diag, g, r, stages,
                        rows, static_cast<cudaStream_t>(stream));
}

// Shared memory of a block for mode (0 thomas, 1 factor, 2 solve, 3 zebra)
// and variant (global_rows), as kernels/tdma_cuda.py::plan_lines counts it.
long long tridiag_smem_bytes(int mode, int coupled, int diag, int len, int g, int r,
                             int stages, int global_rows) {
  return smem_bytes_of(mode, coupled, diag, len, g, r, stages, global_rows);
}

const char* tridiag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
