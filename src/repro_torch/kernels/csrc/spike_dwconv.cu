// Activity-gated depthwise spiking conv, SAME padding:
// out[n, ho, wo, c] = sum over taps t = i*kw + j of
//                     x[n, ho*s + i - pad_h, wo*s + j - pad_w, c] * w[t, c].
//
// Replaces the TPU kernel spike_dwconv_pallas (src/repro/kernels/
// spike_conv.py): there a program takes a block of rows of the
// materialised [M, taps, C] patch tensor (nine copies of the activation)
// and skips a whole tap slab whose occupancy bit is clear.  Here the
// kernel reads the folded activation [N, H, W, C] itself and indexes the
// taps with the reference's SAME padding (pad_* is the low side,
// total // 2: for stride 2 on an even extent that is 0 low, 1 high), so
// no patch tensor is built.
//
// What bounds it on the H100: bytes.  At full MobileNet width dw0 reads
// [40, 64, 64, 32] f32 (21 MB) and writes a quarter of that, for ~2
// operations per byte.  One thread per (output pixel, channel), channels
// fastest: the 32 threads of a warp read 32 neighbouring channels of one
// input pixel (one 128-byte line per tap) and write one line.  The nine
// taps of neighbouring outputs overlap, and those re-reads hit L1/L2.
//
// Gate: a tap whose input is zero adds nothing; it is skipped, weight load
// and multiply-add both.  A skipped contribution is an exact zero (for
// finite weights), so the bits never change.
//
// Rounding: taps accumulate in order t = i*kw + j from +0.0, one
// round-to-nearest multiply and one add each (__fmul_rn/__fadd_rn, no FMA
// contraction; spike_mac.cuh dw_tap), as the plain tap loop does: equal
// bits on any input.
#include <cuda_runtime.h>
#include <stdint.h>

#include "spike_mac.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
spike_dwconv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, int N, int H, int W, int C,
                    int Ho, int Wo, int kh, int kw, int stride, int pad_h,
                    int pad_w) {
  const int64_t total = (int64_t)N * Ho * Wo * C;
  for (int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * kThreads) {
    const int c = (int)(idx % C);
    int64_t r = idx / C;
    const int wo = (int)(r % Wo);
    r /= Wo;
    const int ho = (int)(r % Ho);
    const int n = (int)(r / Ho);
    const float* xn = x + (int64_t)n * H * W * C + c;
    float acc = 0.f;
    for (int i = 0; i < kh; ++i) {
      const int hi = ho * stride + i - pad_h;
      if (hi < 0 || hi >= H) continue;
      for (int j = 0; j < kw; ++j) {
        const int wi = wo * stride + j - pad_w;
        if (wi < 0 || wi >= W) continue;
        const float v = xn[((int64_t)hi * W + wi) * C];
        if (v != 0.f)
          acc = repro::dw_tap(acc, v, w[(i * kw + j) * C + c]);
      }
    }
    out[idx] = acc;
  }
}

}  // namespace

extern "C" int spike_dwconv_launch(const float* x, const float* w, float* out,
                                   int N, int H, int W, int C, int Ho, int Wo,
                                   int kh, int kw, int stride, int pad_h,
                                   int pad_w, void* stream) {
  const int64_t total = (int64_t)N * Ho * Wo * C;
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < (1 << 20) ? want : (1 << 20));
  spike_dwconv_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, w, out, N, H, W, C, Ho, Wo, kh, kw, stride, pad_h, pad_w);
  return static_cast<int>(cudaGetLastError());
}
