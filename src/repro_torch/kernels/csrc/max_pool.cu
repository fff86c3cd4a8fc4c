// Gated spike max-pool, VALID windows with stride = window:
// out[n, ho, wo, c] = max over (di, dj) of x[n, ho*win + di, wo*win + dj, c],
// x [N, H, W, C] -> out [N, H/win, W/win, C] (a ragged tail is dropped).
//
// Replaces the TPU kernel max_pool_pallas (src/repro/kernels/
// backbone_fuse.py): there one program holds a whole frame and, gated,
// writes zeros for an all-silent frame without the reduction.  A Hopper
// block is far smaller than a frame, so here the gate is per block: each
// thread loads its window, the block votes (__syncthreads_or) on whether
// any of its inputs is non-zero, and an all-zero block writes zeros.  A
// max of zeros is zero, so the gate changes no value (only the sign of a
// zero: -0 inputs give +0).
//
// What bounds it on the H100: bytes (win^2 reads and one write per output,
// no arithmetic to speak of).  One thread per output element, channels
// fastest, so a warp reads and writes 128-byte lines.
//
// The max is taken in the plain version's (di, dj) order and propagates
// NaN as torch.maximum does; max has no rounding, so the result equals the
// plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float nan_max(float m, float v) {
  return (v > m || v != v) && m == m ? v : m;
}

template <int kWin, bool kGated>
__global__ void __launch_bounds__(kThreads)
max_pool_kernel(const float* __restrict__ x, float* __restrict__ out, int N,
                int H, int W, int C, int Ho, int Wo) {
  const int64_t total = (int64_t)N * Ho * Wo * C;
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = idx < total;
  float v[kWin * kWin];
  int live_inputs = 0;
  if (live) {
    const int c = (int)(idx % C);
    int64_t r = idx / C;
    const int wo = (int)(r % Wo);
    r /= Wo;
    const int ho = (int)(r % Ho);
    const int n = (int)(r / Ho);
    const float* base =
        x + (((int64_t)n * H + (int64_t)ho * kWin) * W + (int64_t)wo * kWin) *
                C + c;
#pragma unroll
    for (int di = 0; di < kWin; ++di)
#pragma unroll
      for (int dj = 0; dj < kWin; ++dj) {
        const float a = base[((int64_t)di * W + dj) * C];
        v[di * kWin + dj] = a;
        live_inputs |= (a != 0.f);
      }
  }
  if (kGated) {
    // every thread of the block reaches the vote, in range or not
    if (!__syncthreads_or(live_inputs)) {
      if (live) out[idx] = 0.f;
      return;
    }
  }
  if (!live) return;
  float m = v[0];
#pragma unroll
  for (int k = 1; k < kWin * kWin; ++k) m = nan_max(m, v[k]);
  out[idx] = m;
}

template <int kWin>
void launch(const float* x, float* out, int N, int H, int W, int C, int Ho,
            int Wo, unsigned blocks, bool gated, cudaStream_t s) {
  if (gated)
    max_pool_kernel<kWin, true><<<blocks, kThreads, 0, s>>>(x, out, N, H, W,
                                                            C, Ho, Wo);
  else
    max_pool_kernel<kWin, false><<<blocks, kThreads, 0, s>>>(x, out, N, H, W,
                                                             C, Ho, Wo);
}

}  // namespace

extern "C" int max_pool_launch(const float* x, float* out, int N, int H,
                               int W, int C, int window, int gated,
                               void* stream) {
  const int Ho = H / window, Wo = W / window;
  const int64_t total = (int64_t)N * Ho * Wo * C;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned b = static_cast<unsigned>(blocks);
  switch (window) {
    case 1: launch<1>(x, out, N, H, W, C, Ho, Wo, b, gated, s); break;
    case 2: launch<2>(x, out, N, H, W, C, Ho, Wo, b, gated, s); break;
    case 3: launch<3>(x, out, N, H, W, C, Ho, Wo, b, gated, s); break;
    case 4: launch<4>(x, out, N, H, W, C, Ho, Wo, b, gated, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
