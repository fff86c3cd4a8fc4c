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
// plain tap accumulation (repro_torch.isp.demosaic.demosaic_mhc).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The MHC filter bank, row-major 5x5, scaled by 1/8 (copied from
// repro_torch/isp/demosaic.py).
__constant__ float kG[25] = {
    0, 0, -1.f / 8, 0, 0,
    0, 0, 2.f / 8, 0, 0,
    -1.f / 8, 2.f / 8, 4.f / 8, 2.f / 8, -1.f / 8,
    0, 0, 2.f / 8, 0, 0,
    0, 0, -1.f / 8, 0, 0};
// R at G in an R row (and B at G in a B row)
__constant__ float kRow[25] = {
    0, 0, 0.5f / 8, 0, 0,
    0, -1.f / 8, 0, -1.f / 8, 0,
    -1.f / 8, 4.f / 8, 5.f / 8, 4.f / 8, -1.f / 8,
    0, -1.f / 8, 0, -1.f / 8, 0,
    0, 0, 0.5f / 8, 0, 0};
// R at G in a B row (and B at G in an R row): the transpose of kRow
__constant__ float kCol[25] = {
    0, 0, -1.f / 8, 0, 0,
    0, -1.f / 8, 4.f / 8, -1.f / 8, 0,
    0.5f / 8, 0, 5.f / 8, 0, 0.5f / 8,
    0, -1.f / 8, 4.f / 8, -1.f / 8, 0,
    0, 0, -1.f / 8, 0, 0};
// R at B (and B at R)
__constant__ float kDiag[25] = {
    0, 0, -1.5f / 8, 0, 0,
    0, 2.f / 8, 0, 2.f / 8, 0,
    -1.5f / 8, 0, 6.f / 8, 0, -1.5f / 8,
    0, 2.f / 8, 0, 2.f / 8, 0,
    0, 0, -1.5f / 8, 0, 0};

// SAME 5x5 filter at (y, x) of one mosaic, zero outside the frame.
__device__ __forceinline__ float conv5(const float* __restrict__ img,
                                       const float* k, int H, int W, int y,
                                       int x) {
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < 5; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 5; ++dx) {
      const float kv = k[dy * 5 + dx];
      if (kv == 0.f) continue;
      const int yy = y + dy - 2, xx = x + dx - 2;
      const float v =
          (yy >= 0 && yy < H && xx >= 0 && xx < W) ? img[yy * W + xx] : 0.f;
      acc = __fadd_rn(acc, __fmul_rn(kv, v));
    }
  }
  return acc;
}

// torch.clamp(v, 0, 1): NaN passes through
__device__ __forceinline__ float clip01(float v) {
  if (isnan(v)) return v;
  v = v < 0.f ? 0.f : v;
  return v > 1.f ? 1.f : v;
}

__global__ void demosaic_kernel(const float* __restrict__ raw,
                                float* __restrict__ out, int64_t total,
                                int H, int W) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int x = (int)(i % W);
  const int y = (int)((i / W) % H);
  const float* img = raw + (i / ((int64_t)H * W)) * H * W;
  const float c = img[y * W + x];
  const bool ey = (y % 2) == 0, ex = (x % 2) == 0;
  float r, g, b;
  if (ey && ex) {            // R site
    r = c;
    g = conv5(img, kG, H, W, y, x);
    b = conv5(img, kDiag, H, W, y, x);
  } else if (ey) {           // G in an R row
    r = conv5(img, kRow, H, W, y, x);
    g = c;
    b = conv5(img, kCol, H, W, y, x);
  } else if (ex) {           // G in a B row
    r = conv5(img, kCol, H, W, y, x);
    g = c;
    b = conv5(img, kRow, H, W, y, x);
  } else {                   // B site
    r = conv5(img, kDiag, H, W, y, x);
    g = conv5(img, kG, H, W, y, x);
    b = c;
  }
  float* o = out + i * 3;
  o[0] = clip01(r);
  o[1] = clip01(g);
  o[2] = clip01(b);
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
