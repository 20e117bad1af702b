// The reweighting step of the warping models: one launch for the robust
// data terms and one for the isotropic diffusion weights, each in place of
// the chain of PyTorch elementwise and reduction kernels that the plain
// version runs.
//   * robust flow (models/flow_nd.py, models/flow_ad.py; plain version
//     ops/robust.py::robust_terms_flow): each constancy term's tensors
//     (M, Cu, Cv, Du, Dv) under its robust weight
//       gD = b / (alpha * sqrt(residual^2 + 1e-5))
//     at the current increments (dU, dV), summed over the channels with
//     nansum (a NaN channel counts 0), plus the spatial priors' terms;
//     writes the five planes the SOR solve reads.
//   * robust disp (models/disparity.py; ops/robust.py::robust_terms_disp):
//     the u-components (Cu, Du) alone, a plain channel sum (NaN
//     propagates) and the prior gS = gamma/alpha * exp(-APnorm/ASdiff^2).
//   * weights4 (ops/weights.py::diffusion_weights_4): the Brox 6-point
//     weights (wW, wN, wE, wS) of C field planes, each with an optional
//     increment plane added in the kernel (U + dU), from the 3x3
//     neighbourhood: replicate borders for the central differences,
//     wrap-around (circshift) for the neighbour; the channels combined by
//     sum or max, then 1/sqrt(w + eps) and the optional zeroed borders.
//
// The TPU package runs these chains as XLA fusions inside its jitted
// frame; there is no Pallas kernel to port. What bounds them: bytes (flow's
// robust terms read 37 planes and write 5 at the finest level), so one
// thread a pixel, pointwise, the channel loop in registers, nothing staged
// in shared memory; the 3x3 reads of weights4 hit L1.
//
// The numbers are the plain version's, bit for bit, on the card: every
// operation is rounded alone in the plain expressions' order (no FMA
// contraction: __fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), with
// PyTorch's forms of the Python expressions:
//   * x ** 2 is x * x;
//   * a Python scalar over a tensor, s / t, is t.reciprocal() * s;
//   * a tensor over a Python scalar, t / s, is t * float(1 / s) on the
//     card, the reciprocal taken in double (the wrapper passes it);
//   * Python's sum(...) starts from 0 (it turns -0 into +0);
//   * a reduction over the channel axis of a (C, H, W) tensor runs one
//     output a thread with 4 accumulators, channel c into accumulator c % 4,
//     combined as ((a0 + a1) + a2) + a3, as PyTorch's reduce kernel does
//     for C below 64 (Reduce.cuh, vt0 = 4, one thread an output).
//
// The kernels allocate nothing; the C entry points launch on the caller's
// stream and return cudaGetLastError().

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFields = 8;  // weights4's channels

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// b / (alpha * sqrt(op + 1e-5)) as PyTorch runs it: the reciprocal of the
// tensor, then the product with the scalar
__device__ __forceinline__ float robust_weight(float op, float alpha, float b) {
  return mul(__fdiv_rn(1.0f, mul(__fsqrt_rn(add(op, 1e-5f)), alpha)), b);
}

// One channel reduction as PyTorch's reduce kernel runs it (header comment)
struct NanSum {
  __device__ __forceinline__ static float reduce(float acc, float x) {
    return add(acc, isnan(x) ? 0.0f : x);
  }
};
struct Sum {
  __device__ __forceinline__ static float reduce(float acc, float x) { return add(acc, x); }
};

template <typename Op>
struct Acc {
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  __device__ __forceinline__ void put(int k, float x) { a[k] = Op::reduce(a[k], x); }
  __device__ __forceinline__ float total() const { return add(add(add(a[0], a[1]), a[2]), a[3]); }
};

// the second constancy term's kind
enum Snd { kNone = 0, kFirst = 1, kGradmag = 2 };

struct FlowArgs {
  const float* __restrict__ dt1;  // (C1, H, W) first term: dt, dx, dy
  const float* __restrict__ dx1;
  const float* __restrict__ dy1;
  // (C2, H, W) second term: gradmag dxt, dyt, dxx, dyy, dxy; first-order
  // dt, dx, dy in s0..s2
  const float* __restrict__ s0;
  const float* __restrict__ s1;
  const float* __restrict__ s2;
  const float* __restrict__ s3;
  const float* __restrict__ s4;
  const float* __restrict__ u;  // (H, W); u, v, us, vs read only with a prior
  const float* __restrict__ v;
  const float* __restrict__ du;
  const float* __restrict__ dv;
  const float* __restrict__ us;  // null: no prior on U
  const float* __restrict__ vs;  // null: no prior on V
  float* __restrict__ m;
  float* __restrict__ cu;
  float* __restrict__ cv;
  float* __restrict__ du_out;
  float* __restrict__ dv_out;
  int64_t n;  // H * W
  int c1, c2;
  float alpha, b1, b2, gamma, inv_as2;
};

// gS of a prior on the flow: gamma / (alpha * (1 + APnorm / ASdiff^2))
__device__ __forceinline__ float flow_prior_weight(float ap, float alpha, float gamma,
                                                   float inv_as2) {
  const float t = mul(alpha, add(mul(mul(ap, ap), inv_as2), 1.0f));
  return mul(__fdiv_rn(1.0f, t), gamma);
}

// kC1, kC2: the terms' channel counts compiled in (0: read from the
// arguments); compiled in, the channel loops unroll and every load of a
// pixel can be in flight at once
template <int kSnd, int kC1, int kC2>
__global__ void __launch_bounds__(kThreads) reweight_flow_kernel(const FlowArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int c1 = kC1 > 0 ? kC1 : a.c1, c2 = kC2 > 0 ? kC2 : a.c2;
  const float du = a.du[i], dv = a.dv[i];
  Acc<NanSum> m1, cu1, cv1, du1, dv1;
#pragma unroll(kC1 > 0 ? (kC1 + 3) / 4 : 1)
  for (int c0 = 0; c0 < c1; c0 += 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + k >= c1) continue;
      const int64_t o = (c0 + k) * a.n + i;
      const float dt = a.dt1[o], dx = a.dx1[o], dy = a.dy1[o];
      const float r = sub(sub(dt, mul(dx, du)), mul(dy, dv));
      const float g = robust_weight(mul(r, r), a.alpha, a.b1);
      m1.put(k, mul(mul(dy, dx), g));
      cu1.put(k, mul(mul(dt, dx), g));
      cv1.put(k, mul(mul(dt, dy), g));
      du1.put(k, mul(mul(dx, dx), g));
      dv1.put(k, mul(mul(dy, dy), g));
    }
  }
  // Python's sum over the parts: 0 + term 1 + term 2 + prior
  float m = add(0.0f, m1.total()), cu = add(0.0f, cu1.total()), cv = add(0.0f, cv1.total());
  float duo = add(0.0f, du1.total()), dvo = add(0.0f, dv1.total());
  if (kSnd != kNone) {
    Acc<NanSum> m2, cu2, cv2, du2, dv2;
#pragma unroll(kC2 > 0 ? (kC2 + 3) / 4 : 1)
    for (int c0 = 0; c0 < c2; c0 += 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (c0 + k >= c2) continue;
        const int64_t o = (c0 + k) * a.n + i;
        if (kSnd == kGradmag) {
          const float dxt = a.s0[o], dyt = a.s1[o], dxx = a.s2[o], dyy = a.s3[o], dxy = a.s4[o];
          const float rx = sub(sub(dxt, mul(dxx, du)), mul(dxy, dv));
          const float ry = sub(sub(dyt, mul(dxy, du)), mul(dyy, dv));
          const float g = robust_weight(add(mul(rx, rx), mul(ry, ry)), a.alpha, a.b2);
          m2.put(k, mul(mul(dxy, add(dxx, dyy)), g));
          cu2.put(k, mul(add(mul(dxt, dxx), mul(dyt, dxy)), g));
          cv2.put(k, mul(add(mul(dxt, dxy), mul(dyt, dyy)), g));
          du2.put(k, mul(add(mul(dxx, dxx), mul(dxy, dxy)), g));
          dv2.put(k, mul(add(mul(dxy, dxy), mul(dyy, dyy)), g));
        } else {
          const float dt = a.s0[o], dx = a.s1[o], dy = a.s2[o];
          const float r = sub(sub(dt, mul(dx, du)), mul(dy, dv));
          const float g = robust_weight(mul(r, r), a.alpha, a.b2);
          m2.put(k, mul(mul(dy, dx), g));
          cu2.put(k, mul(mul(dt, dx), g));
          cv2.put(k, mul(mul(dt, dy), g));
          du2.put(k, mul(mul(dx, dx), g));
          dv2.put(k, mul(mul(dy, dy), g));
        }
      }
    }
    m = add(m, m2.total());
    cu = add(cu, cu2.total());
    cv = add(cv, cv2.total());
    duo = add(duo, du2.total());
    dvo = add(dvo, dv2.total());
  }
  if (a.us != nullptr) {
    const float us = a.us[i], u = a.u[i];
    const float gs = flow_prior_weight(sub(sub(us, u), du), a.alpha, a.gamma, a.inv_as2);
    Acc<NanSum> pc, pd;  // the prior's nansum over its one channel
    pc.put(0, mul(sub(us, u), gs));
    pd.put(0, gs);
    cu = add(cu, pc.total());
    duo = add(duo, pd.total());
  }
  if (a.vs != nullptr) {
    const float vs = a.vs[i], v = a.v[i];
    const float gs = flow_prior_weight(sub(sub(vs, v), dv), a.alpha, a.gamma, a.inv_as2);
    Acc<NanSum> pc, pd;
    pc.put(0, mul(sub(vs, v), gs));
    pd.put(0, gs);
    cv = add(cv, pc.total());
    dvo = add(dvo, pd.total());
  }
  a.m[i] = m;
  a.cu[i] = cu;
  a.cv[i] = cv;
  a.du_out[i] = duo;
  a.dv_out[i] = dvo;
}

struct DispArgs {
  const float* __restrict__ dt1;  // (C1, H, W) first term: dt, dx
  const float* __restrict__ dx1;
  // (C2, H, W) second term: gradmag dxt, dyt, dxx, dxy; first-order dt, dx
  // in s0, s1
  const float* __restrict__ s0;
  const float* __restrict__ s1;
  const float* __restrict__ s2;
  const float* __restrict__ s3;
  const float* __restrict__ u;  // (H, W), read only with the prior
  const float* __restrict__ du;
  const float* __restrict__ us;  // null: no prior
  float* __restrict__ cu;
  float* __restrict__ du_out;
  int64_t n;
  int c1, c2;
  float alpha, b1, b2, gs_scale, inv_as2;  // gs_scale: float(gamma / alpha)
};

template <int kSnd, int kC1, int kC2>
__global__ void __launch_bounds__(kThreads) reweight_disp_kernel(const DispArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int c1 = kC1 > 0 ? kC1 : a.c1, c2 = kC2 > 0 ? kC2 : a.c2;
  const float du = a.du[i];
  Acc<Sum> cu1, du1;
#pragma unroll(kC1 > 0 ? (kC1 + 3) / 4 : 1)
  for (int c0 = 0; c0 < c1; c0 += 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + k >= c1) continue;
      const int64_t o = (c0 + k) * a.n + i;
      const float dt = a.dt1[o], dx = a.dx1[o];
      const float r = sub(dt, mul(dx, du));
      const float g = robust_weight(mul(r, r), a.alpha, a.b1);
      cu1.put(k, mul(mul(dt, dx), g));
      du1.put(k, mul(mul(dx, dx), g));
    }
  }
  float cu = add(0.0f, cu1.total()), duo = add(0.0f, du1.total());
  if (kSnd != kNone) {
    Acc<Sum> cu2, du2;
#pragma unroll(kC2 > 0 ? (kC2 + 3) / 4 : 1)
    for (int c0 = 0; c0 < c2; c0 += 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (c0 + k >= c2) continue;
        const int64_t o = (c0 + k) * a.n + i;
        if (kSnd == kGradmag) {
          const float dxt = a.s0[o], dyt = a.s1[o], dxx = a.s2[o], dxy = a.s3[o];
          const float rx = sub(dxt, mul(dxx, du));
          const float ry = sub(dyt, mul(dxy, du));
          const float g = robust_weight(add(mul(rx, rx), mul(ry, ry)), a.alpha, a.b2);
          cu2.put(k, mul(add(mul(dxt, dxx), mul(dyt, dxy)), g));
          du2.put(k, mul(add(mul(dxx, dxx), mul(dxy, dxy)), g));
        } else {
          const float dt = a.s0[o], dx = a.s1[o];
          const float r = sub(dt, mul(dx, du));
          const float g = robust_weight(mul(r, r), a.alpha, a.b2);
          cu2.put(k, mul(mul(dt, dx), g));
          du2.put(k, mul(mul(dx, dx), g));
        }
      }
    }
    cu = add(cu, cu2.total());
    duo = add(duo, du2.total());
  }
  if (a.us != nullptr) {
    const float us = a.us[i], u = a.u[i];
    const float ap = sub(sub(us, u), du);
    const float gs = mul(a.gs_scale, expf(mul(-mul(ap, ap), a.inv_as2)));
    Acc<Sum> pc, pd;
    pc.put(0, mul(sub(us, u), gs));
    pd.put(0, gs);
    cu = add(cu, pc.total());
    duo = add(duo, pd.total());
  }
  a.cu[i] = cu;
  a.du_out[i] = duo;
}

struct WeightArgs {
  const float* f[kMaxFields];  // (H, W) field planes
  const float* d[kMaxFields];  // their increments, or null
  float* ww;
  float* wn;
  float* we;
  float* ws;
  int c, h, w;
  float eps;
  bool zero_borders;
};

struct MaxNan {  // PyTorch's amax: NaN wins, else the larger
  __device__ __forceinline__ static float reduce(float acc, float x) {
    return (isnan(acc) || acc > x) ? acc : x;
  }
};

template <typename Op>
struct AccFrom {
  float a[4];
  __device__ __forceinline__ explicit AccFrom(float ident) { a[0] = a[1] = a[2] = a[3] = ident; }
  __device__ __forceinline__ void put(int k, float x) { a[k] = Op::reduce(a[k], x); }
  __device__ __forceinline__ float total() const {
    return Op::reduce(Op::reduce(Op::reduce(a[0], a[1]), a[2]), a[3]);
  }
};

__device__ __forceinline__ float sq2(float d, float g) { return add(mul(d, d), mul(g, g)); }

template <typename Op>
__global__ void __launch_bounds__(kThreads) weights4_kernel(const WeightArgs a, float ident) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const int w = a.w, h = a.h;
  // replicate (clamped) and wrap-around neighbours
  const int ym = y > 0 ? y - 1 : 0, yp = y < h - 1 ? y + 1 : h - 1;
  const int xm = x > 0 ? x - 1 : 0, xp = x < w - 1 ? x + 1 : w - 1;
  const int ymw = y > 0 ? y - 1 : h - 1, ypw = y < h - 1 ? y + 1 : 0;
  const int xmw = x > 0 ? x - 1 : w - 1, xpw = x < w - 1 ? x + 1 : 0;
  AccFrom<Op> aw(ident), an(ident), ae(ident), as(ident);
  for (int c0 = 0; c0 < a.c; c0 += 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + k >= a.c) continue;
      const float* __restrict__ f = a.f[c0 + k];
      const float* __restrict__ d = a.d[c0 + k];
      auto at = [&](int r, int q) {
        const int64_t o = static_cast<int64_t>(r) * w + q;
        return d != nullptr ? add(__ldg(f + o), __ldg(d + o)) : __ldg(f + o);
      };
      // 0.25 * (previous - next): the taps 0.25 and -0.25, each product
      // rounded, added in the filter's order
      auto fver = [&](int q) { return add(mul(at(ym, q), 0.25f), mul(at(yp, q), -0.25f)); };
      auto fhor = [&](int r) { return add(mul(at(r, xm), 0.25f), mul(at(r, xp), -0.25f)); };
      const float f0 = at(y, x);
      const float fv = fver(x), fh = fhor(y);
      aw.put(k, sq2(sub(at(y, xmw), f0), add(fv, fver(xmw))));
      ae.put(k, sq2(sub(at(y, xpw), f0), add(fv, fver(xpw))));
      an.put(k, sq2(sub(at(ymw, x), f0), add(fh, fhor(ymw))));
      as.put(k, sq2(sub(at(ypw, x), f0), add(fh, fhor(ypw))));
    }
  }
  const int64_t o = static_cast<int64_t>(y) * w + x;
  // 1.0 / sqrt(w + eps): the reciprocal, times 1
  auto weight = [&](float s) { return __fdiv_rn(1.0f, __fsqrt_rn(add(s, a.eps))); };
  const bool zb = a.zero_borders;
  a.ww[o] = zb && x == 0 ? 0.0f : weight(aw.total());
  a.wn[o] = zb && y == 0 ? 0.0f : weight(an.total());
  a.we[o] = zb && x == w - 1 ? 0.0f : weight(ae.total());
  a.ws[o] = zb && y == h - 1 ? 0.0f : weight(as.total());
}

int blocks_for(int64_t n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

// One launch of a robust kernel: `rgb`, the form with an RGB pair's
// channels compiled in (the "grad" first term 6, the "gradmag" second term
// 3, as the benchmark cells run them), where the call has them, else `any`,
// which reads the counts from the arguments. Only the gradient-magnitude
// kind has an RGB form: the other kinds, which no cell runs, compile once.
template <typename Args>
void launch_robust(void (*rgb)(Args), void (*any)(Args), const Args& a, cudaStream_t s) {
  const bool is_rgb = rgb != nullptr && a.c1 == 6 && a.c2 == 3;
  (is_rgb ? rgb : any)<<<blocks_for(a.n), kThreads, 0, s>>>(a);
}

template <int kSnd>
void launch_flow(const FlowArgs& a, cudaStream_t s) {
  void (*rgb)(FlowArgs) = nullptr;
  if constexpr (kSnd == kGradmag) rgb = reweight_flow_kernel<kGradmag, 6, 3>;
  launch_robust(rgb, reweight_flow_kernel<kSnd, 0, 0>, a, s);
}

template <int kSnd>
void launch_disp(const DispArgs& a, cudaStream_t s) {
  void (*rgb)(DispArgs) = nullptr;
  if constexpr (kSnd == kGradmag) rgb = reweight_disp_kernel<kGradmag, 6, 3>;
  launch_robust(rgb, reweight_disp_kernel<kSnd, 0, 0>, a, s);
}

}  // namespace

extern "C" {

// Every pointer is a contiguous float32 array on the current device: the
// first term's dt, dx, dy and the second's s0..s4 (C1, H, W) and (C2, H, W)
// (snd 0: none, s* unread; 1: first-order dt, dx, dy in s0..s2; 2: gradmag
// dxt, dyt, dxx, dyy, dxy), u, v, du, dv, us, vs and the five outputs
// (H, W), n = H * W. us or vs null: no prior on that component (u, v are
// read only with one). inv_as2 is float(1 / ASdiff^2). One launch
// on `stream`, none where n is 0.
int reweight_flow(const void* dt1, const void* dx1, const void* dy1, int c1, int snd,
                  const void* s0, const void* s1, const void* s2, const void* s3, const void* s4,
                  int c2, const void* u, const void* v, const void* du, const void* dv,
                  const void* us, const void* vs, long long n, float alpha, float b1, float b2,
                  float gamma, float inv_as2, void* m, void* cu, void* cv, void* du_out,
                  void* dv_out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  FlowArgs a{cf(dt1), cf(dx1), cf(dy1), cf(s0), cf(s1), cf(s2), cf(s3), cf(s4), cf(u), cf(v),
             cf(du), cf(dv), cf(us), cf(vs), static_cast<float*>(m), static_cast<float*>(cu),
             static_cast<float*>(cv), static_cast<float*>(du_out), static_cast<float*>(dv_out),
             n, c1, c2, alpha, b1, b2, gamma, inv_as2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (snd == kGradmag) {
    launch_flow<kGradmag>(a, s);
  } else if (snd == kFirst) {
    launch_flow<kFirst>(a, s);
  } else {
    launch_flow<kNone>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// As reweight_flow for the disparity's u-components: the first term's dt,
// dx (C1, H, W); the second's s0..s3 (C2, H, W) (snd 1: dt, dx in s0, s1;
// 2: dxt, dyt, dxx, dxy); u, du, us (H, W), us null without a prior;
// gs_scale is float(gamma / alpha). Writes Cu and Du.
int reweight_disp(const void* dt1, const void* dx1, int c1, int snd, const void* s0,
                  const void* s1, const void* s2, const void* s3, int c2, const void* u,
                  const void* du, const void* us, long long n, float alpha, float b1, float b2,
                  float gs_scale, float inv_as2, void* cu, void* du_out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  DispArgs a{cf(dt1), cf(dx1), cf(s0), cf(s1), cf(s2), cf(s3), cf(u), cf(du), cf(us),
             static_cast<float*>(cu), static_cast<float*>(du_out), n, c1, c2, alpha, b1, b2,
             gs_scale, inv_as2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (snd == kGradmag) {
    launch_disp<kGradmag>(a, s);
  } else if (snd == kFirst) {
    launch_disp<kFirst>(a, s);
  } else {
    launch_disp<kNone>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// fields[k], incs[k] for k < c (1 <= c <= 8): contiguous (H, W) float32
// planes on the current device, incs null or any entry null where a field
// has no increment. Writes the four (H, W) weights; combine_max: amax over
// the channels, else their sum. One launch on `stream`.
int reweight_weights4(const void* const* fields, const void* const* incs, int c, int h, int w,
                      int combine_max, int zero_borders, float eps, void* ww, void* wn,
                      void* we, void* ws, void* stream) {
  if (c < 1 || c > kMaxFields) return static_cast<int>(cudaErrorInvalidValue);
  if (h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  WeightArgs a{};
  for (int k = 0; k < c; ++k) {
    a.f[k] = static_cast<const float*>(fields[k]);
    a.d[k] = incs != nullptr ? static_cast<const float*>(incs[k]) : nullptr;
  }
  a.ww = static_cast<float*>(ww);
  a.wn = static_cast<float*>(wn);
  a.we = static_cast<float*>(we);
  a.ws = static_cast<float*>(ws);
  a.c = c;
  a.h = h;
  a.w = w;
  a.eps = eps;
  a.zero_borders = zero_borders != 0;
  const dim3 block(32, kThreads / 32);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (combine_max) {
    weights4_kernel<MaxNan><<<grid, block, 0, s>>>(a, -INFINITY);
  } else {
    weights4_kernel<Sum><<<grid, block, 0, s>>>(a, 0.0f);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* reweight_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
