// Gated spike max-pool, VALID windows with stride = window, read from the
// layer's spikes where they lie and written batch-major:
//   out[b*T + t, ho, wo, c] = max over (di, dj) of
//       x[t, b, ho*win + di, wo*win + dj, c],
// x an array of T x B images [H, W, C], image (t, b) at image offset
// t * img_t + b * img_b (img_t = B, img_b = 1 for spikes contiguous in
// [T, B] order; img_t = 1, img_b = T for a batch-major fold; T = 1 for a
// plain [N, H, W, C]) -> out [B*T, H/win, W/win, C] (a ragged tail is
// dropped).  The order of images does not enter a max, so reading the
// [T, B] spikes in place gives the bits of a pool of their batch-major
// copy, and that copy (the layer's fold) is gone from the path.
//
// Replaces the TPU kernel max_pool_pallas (src/repro/kernels/
// backbone_fuse.py): there one program holds a whole frame and, gated,
// writes zeros for an all-silent frame without the reduction.  A Hopper
// block is far smaller than a frame, so here the gate is per block and
// pass: each thread loads its window, the block votes (__syncthreads_or)
// on whether any of its inputs is non-zero, and an all-zero pass writes
// zeros.  A max of zeros is zero, so the gate changes no value (only the
// sign of a zero: -0 inputs give +0).
//
// What bounds it on the H100: bytes (win^2 reads and one write per output,
// no arithmetic to speak of).  One block per (output image, output row) on
// gridDim.x; its threads walk the row's Wo x C outputs V channels at a
// time (V = 4: 16-byte loads and stores where C % 4 == 0 and both
// pointers are 16-byte aligned; else V = 1), channels fastest, so a warp
// reads and writes whole lines.  The block, image and lane decode is a
// multiply and a shift by host-made magic numbers (no runtime division).
//
// The max is taken in the plain version's (di, dj) order and propagates
// NaN as torch.maximum does; max has no rounding, so the result equals the
// plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_slab.cuh"

namespace {

using repro::FastDiv;

constexpr int kMaxThreads = 512;

struct PoolArgs {
  const float* x;
  float* out;
  int T, H, W, C, Ho, Wo;
  int64_t img_t, img_b;   // image strides of the t and b dims, in images
  int lanes;              // V-wide lanes of one output row: Wo * C / V
  FastDiv rows;           // Ho: block -> (output image, output row)
  FastDiv steps;          // T: output image b*T + t -> (b, t)
  FastDiv groups;         // C / V: lane -> (wo, channel group)
};

__device__ __forceinline__ float nan_max(float m, float v) {
  return (v > m || v != v) && m == m ? v : m;
}

template <int V>
__device__ __forceinline__ void load_v(float* d, const float* p) {
  if constexpr (V == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  } else {
    d[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float* d) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  else
    p[0] = d[0];
}

template <int kWin, int V, bool kGated>
__global__ void __launch_bounds__(kMaxThreads)
max_pool_kernel(const PoolArgs a) {
  const int blk = blockIdx.x;
  const int n = a.rows.div(blk);           // output image b*T + t
  const int ho = blk - n * a.Ho;
  const int b = a.steps.div(n);
  const int t = n - b * a.T;
  const int64_t row = (int64_t)a.W * a.C;  // floats of one input row
  const float* src = a.x + ((int64_t)t * a.img_t + (int64_t)b * a.img_b) *
                               a.H * row + (int64_t)ho * kWin * row;
  float* dst = a.out + ((int64_t)n * a.Ho + ho) * a.Wo * a.C;
  const int cg = a.C / V;
  // every thread runs every pass (the trip count is the block's), so the
  // vote below is reached by all of them
  for (int l0 = 0; l0 < a.lanes; l0 += blockDim.x) {
    const int l = l0 + threadIdx.x;
    const bool live = l < a.lanes;
    float v[kWin * kWin][V];
    int nonzero = 0;
    int off = 0;                          // the lane's offset in the row
    if (live) {
      const int wo = a.groups.div(l);
      const int c = (l - wo * cg) * V;
      off = wo * a.C + c;
      const float* p = src + (int64_t)wo * kWin * a.C + c;
#pragma unroll
      for (int di = 0; di < kWin; ++di)
#pragma unroll
        for (int dj = 0; dj < kWin; ++dj) {
          load_v<V>(v[di * kWin + dj], p + di * row + dj * a.C);
#pragma unroll
          for (int e = 0; e < V; ++e)
            nonzero |= (v[di * kWin + dj][e] != 0.f);
        }
    }
    if (kGated) {
      if (!__syncthreads_or(nonzero)) {
        if (live) {
          const float z[V] = {};
          store_v<V>(dst + off, z);
        }
        continue;
      }
    }
    if (!live) continue;
    float m[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      m[e] = v[0][e];
#pragma unroll
      for (int k = 1; k < kWin * kWin; ++k) m[e] = nan_max(m[e], v[k][e]);
    }
    store_v<V>(dst + off, m);
  }
}

template <int kWin, int V>
void launch(const PoolArgs& a, unsigned blocks, int threads, bool gated,
            cudaStream_t s) {
  if (gated)
    max_pool_kernel<kWin, V, true><<<blocks, threads, 0, s>>>(a);
  else
    max_pool_kernel<kWin, V, false><<<blocks, threads, 0, s>>>(a);
}

template <int kWin>
void launch_win(const PoolArgs& a, int vec, unsigned blocks, int threads,
                bool gated, cudaStream_t s) {
  if (vec == 4)
    launch<kWin, 4>(a, blocks, threads, gated, s);
  else
    launch<kWin, 1>(a, blocks, threads, gated, s);
}

}  // namespace

// x: T x B images [H, W, C], image (t, b) at t * img_t + b * img_b images
// from x; out [B*T, H/window, W/window, C].  Refuses (cudaErrorInvalidValue)
// a window outside [1, 4], a grid past 2^31 - 1 blocks or a row too long
// for 32-bit lane offsets.
extern "C" int max_pool_launch(const float* x, float* out, int T, int B,
                               int H, int W, int C, int64_t img_t,
                               int64_t img_b, int window, int gated,
                               void* stream) {
  if (window < 1 || window > 4 || T < 1 || B < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = H / window, Wo = W / window;
  const int64_t blocks = (int64_t)B * T * Ho;
  if (blocks < 1 || blocks > 0x7fffffff ||
      (int64_t)window * W * C >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int vec = (C % 4 == 0 && aligned) ? 4 : 1;
  PoolArgs a;
  a.x = x;
  a.out = out;
  a.T = T;
  a.H = H;
  a.W = W;
  a.C = C;
  a.Ho = Ho;
  a.Wo = Wo;
  a.img_t = img_t;
  a.img_b = img_b;
  a.lanes = Wo * (C / vec);
  a.rows = FastDiv(Ho);
  a.steps = FastDiv(T);
  a.groups = FastDiv(C / vec);
  int threads = (a.lanes + 31) / 32 * 32;
  threads = threads > kMaxThreads ? kMaxThreads : threads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned b = static_cast<unsigned>(blocks);
  switch (window) {
    case 1: launch_win<1>(a, vec, b, threads, gated, s); break;
    case 2: launch_win<2>(a, vec, b, threads, gated, s); break;
    case 3: launch_win<3>(a, vec, b, threads, gated, s); break;
    default: launch_win<4>(a, vec, b, threads, gated, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
