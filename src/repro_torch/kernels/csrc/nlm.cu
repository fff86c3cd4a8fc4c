// Non-local means, FPGA-adapted: 7x7 search window, 3x3 box-filtered
// patch distances on luminance, cyclic boundaries.  img [B, H, W, C]
// (C <= 4) with its luminance lum [B, H, W] and the per-image filter
// bandwidth h [B] -> out [B, H, W, C].
//
// Replaces the TPU kernel nlm_pallas (src/repro/kernels/nlm.py), which
// reads wrap-padded 128x128 tiles with a halo of 4 from VMEM, evaluates
// the 49 shifts as shifted-difference + separable box-filter algebra,
// and runs once per channel (recomputing the weights each time).  Here
// one thread computes one pixel: for each shift it forms the 9 squared
// luminance differences of its 3x3 patch, box-filters them, and applies
// the one weight to every channel, so the 49 weights are computed once
// and shared by the channels.  Indices wrap mod H and W, so any frame
// size works (no tile divisibility).  Like the TPU kernel it takes the
// luminance plane as an input: the wrapper computes it with torch's
// mean, the plain version's own op, and h = 1e-3 + 0.2 * strength
// likewise.
//
// What bounds it on the H100: operations -- about 49 x (9 differences,
// 9 squares, 6 box adds, exp, 2C+1 weight ops) per pixel against
// 2 x C x 4 bytes of image traffic; at [8, 64, 64, 3] the work is tens
// of MFLOP, so one launch's latency and the exp throughput dominate.
// The neighbourhood re-reads hit L1/L2; shared-memory tiling is later
// work.
//
// Rounding: the plain version's order, each step a round-to-nearest
// intrinsic so nvcc cannot contract FMAs (isp::nlm_pixel in
// isp_common.cuh, shared with the fused NLM segment of isp_fused.cu).
#include <cuda_runtime.h>
#include <stdint.h>

#include "isp_common.cuh"

namespace {

constexpr int kMaxC = isp::kNlmMaxC;

__global__ void nlm_kernel(const float* __restrict__ img,
                           const float* __restrict__ lum,
                           const float* __restrict__ h,
                           float* __restrict__ out, int64_t total, int H,
                           int W, int C) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int x = (int)(i % W);
  const int y = (int)((i / W) % H);
  const int64_t b = i / ((int64_t)H * W);
  const float* L = lum + b * H * W;
  const float* I = img + b * H * W * C;
  const float hb = h[b];
  const float hh = __fmul_rn(hb, hb);

  // rows[k] / cols[k]: wrapped index of y + k - 4 / x + k - 4
  int rows[9], cols[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    rows[k] = isp::wrap(y + k - 4, H) * W;
    cols[k] = isp::wrap(x + k - 4, W);
  }
  auto lum_at = [&](int ry, int cx) { return L[rows[ry] + cols[cx]]; };
  auto pix = [&](int ry, int cx) {
    return I + ((int64_t)rows[ry] + cols[cx]) * C;
  };
  isp::nlm_pixel(lum_at, pix, hh, C, out + i * C);
}

}  // namespace

extern "C" int nlm_launch(const float* img, const float* lum, const float* h,
                          float* out, int B, int H, int W, int C,
                          void* stream) {
  if (C < 1 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  const int64_t total = (int64_t)B * H * W;
  const int64_t blocks = (total + threads - 1) / threads;
  nlm_kernel<<<(unsigned)blocks, threads, 0,
               static_cast<cudaStream_t>(stream)>>>(img, lum, h, out, total,
                                                    H, W, C);
  return static_cast<int>(cudaGetLastError());
}
