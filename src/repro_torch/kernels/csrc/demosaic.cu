// Malvar-He-Cutler 5x5 demosaic of RGGB mosaics: raw [B, H, W] ->
// RGB [B, H, W, 3], clipped to [0, 1].
//
// Replaces the TPU kernel demosaic_pallas (src/repro/kernels/demosaic.py),
// which keeps the zero-padded mosaic in VMEM and emits 128x128 RGB tiles
// (padding the frame to whole tiles).  Here one thread computes one
// pixel: it reads its 5x5 neighbourhood (zero outside the frame, the
// reference's SAME zero halo) and evaluates only the filters its Bayer
// phase needs (two of the four), so no padded copy and no tile padding.
//
// What bounds it on the H100: bytes -- each mosaic value read once from
// device memory (the neighbourhood re-reads hit L1/L2) and three floats
// written per pixel: 0.5 MB at [8, 64, 64], which is one launch's
// latency.
//
// Exactness: the filter taps are exact in float32 (multiples of 1/16).
// Each filter is a sum from 0 over its non-zero taps in (dy, dx) order,
// every product and sum a separate round-to-nearest intrinsic, so nvcc
// cannot contract them into FMAs: the result is bit-identical to the
// plain tap accumulation (repro_torch.isp.demosaic.demosaic_mhc).  The
// filter maths lives in isp_common.cuh, shared with the fused demosaic
// segment of isp_fused.cu.
#include <cuda_runtime.h>
#include <stdint.h>

#include "isp_common.cuh"

namespace {

__global__ void demosaic_kernel(const float* __restrict__ raw,
                                float* __restrict__ out, int64_t total,
                                int H, int W) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int x = (int)(i % W);
  const int y = (int)((i / W) % H);
  const float* img = raw + (i / ((int64_t)H * W)) * H * W;
  // the mosaic at (y + dy - 2, x + dx - 2), zero outside the frame
  auto at = [&](int dy, int dx) {
    const int yy = y + dy - 2, xx = x + dx - 2;
    return (yy >= 0 && yy < H && xx >= 0 && xx < W) ? img[yy * W + xx]
                                                     : 0.f;
  };
  isp::mhc_rgb((y % 2) == 0, (x % 2) == 0, img[y * W + x], at, out + i * 3);
}

}  // namespace

extern "C" int demosaic_launch(const float* raw, float* out, int B, int H,
                               int W, void* stream) {
  const int threads = 256;
  const int64_t total = (int64_t)B * H * W;
  const int64_t blocks = (total + threads - 1) / threads;
  demosaic_kernel<<<(unsigned)blocks, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(raw, out, total, H,
                                                         W);
  return static_cast<int>(cudaGetLastError());
}
