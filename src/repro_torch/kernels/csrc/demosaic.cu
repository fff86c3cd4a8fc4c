// Malvar-He-Cutler 5x5 demosaic of RGGB mosaics: raw [B, H, W] ->
// RGB [B, H, W, 3], clipped to [0, 1].
//
// Replaces the TPU kernel demosaic_pallas (src/repro/kernels/demosaic.py),
// which keeps the zero-padded mosaic in VMEM and emits 128x128 RGB tiles
// (padding the frame to whole tiles).  Here one block computes one output
// tile (TH x TW, the host plan's: stencil_plan("demosaic", ...) in
// kernels/isp_fused.py, 8 x 32 with one thread a pixel) on the demosaic
// tile of demosaic_tile.cuh, the design of the fused stencil segment's
// demosaic instance:
//   - its threads read the tile's (TH + 4) x (TW + 4) mosaic window row
// by row, consecutive threads on consecutive pixels, zero outside the
// frame (the reference's SAME zero halo), into shared memory: no padded
// copy and no tile padding;
//   - then one thread a pixel, grouped by Bayer phase, runs its phase's
// two filters with the zero taps dropped at compile time, each tap a
// shared-memory read, and stores three clipped floats.
// One block per (frame, tile row, tile column), the column fastest, all
// on gridDim.x (any batch up to 2^31 - 1 blocks in all), decoded by
// host-made magic numbers: no 64-bit division.  Frames of any size: the
// ragged edge is guarded per pixel.  The wrapper adds no device op: the
// call is this one launch.
//
// What bounds it on the H100: bytes -- one read of the mosaic and three
// floats written a pixel (16 bytes; the halo re-reads hit L1/L2) against
// ~44 fp32 operations a pixel.  At [8, 64, 64] that is 0.5 MB, ~0.2 us
// at the HBM rate, so the launch and the block's load-compute-store
// sequence set the time; at [8, 512, 512] and on a VGA batch the bytes do.
//
// Exactness: the filter taps are exact in float32 (multiples of 1/16).
// Each filter is a sum from 0 over its non-zero taps in (dy, dx) order,
// every product and sum a separate round-to-nearest intrinsic, so nvcc
// cannot contract them into FMAs: the result is bit-identical to the
// plain tap accumulation (repro_torch.isp.demosaic.demosaic_mhc) and to
// the fused [demosaic] stencil segment, which runs the same tile.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_slab.cuh"
#include "demosaic_tile.cuh"

namespace {

using repro::FastDiv;

struct DemosaicArgs {
  const float* raw;
  float* out;
  int H, W;
  int tiles_x, tiles_y;
  FastDiv fx, fy;          // tiles_x, tiles_y
};

template <int TH, int TW>
__global__ void __launch_bounds__(TH * TW)
demosaic_kernel(const DemosaicArgs a) {
  using Tile = isp::DemosaicTile<TH, TW>;
  constexpr int R = isp::kDemosaicR, WX = Tile::WX;
  extern __shared__ float win[];
  // (frame, tile row, tile column) on gridDim.x, the column fastest
  const int blk = blockIdx.x;
  const int rest = a.fx.div(blk);
  const int b = a.fy.div(rest);
  const int y0 = (rest - b * a.tiles_y) * TH;
  const int x0 = (blk - rest * a.tiles_x) * TW;
  const int H = a.H, W = a.W;
  const float* img = a.raw + (int64_t)b * H * W;

  for (int k = threadIdx.x; k < Tile::kPix; k += blockDim.x) {
    const int wy = k / WX, wx = k % WX;
    const int yy = y0 - R + wy, xx = x0 - R + wx;
    const bool inside =
        static_cast<unsigned>(yy) < static_cast<unsigned>(H) &&
        static_cast<unsigned>(xx) < static_cast<unsigned>(W);
    win[k] = inside ? __ldg(img + (int64_t)yy * W + xx) : 0.f;
  }
  __syncthreads();
  isp::demosaic_tile<TH, TW>(win, y0, x0, H, W,
                             a.out + (int64_t)b * H * W * 3);
}

// One instance's launch: the plan's threads and shared bytes must be the
// instance's.
template <int TH, int TW>
int launch(const DemosaicArgs& a, int64_t blocks, int threads, int smem,
           cudaStream_t s) {
  using Tile = isp::DemosaicTile<TH, TW>;
  const int want = Tile::kFloats * static_cast<int>(sizeof(float));
  if (threads != Tile::kThreads || smem != want)
    return static_cast<int>(cudaErrorInvalidValue);
  demosaic_kernel<TH, TW><<<static_cast<unsigned>(blocks), threads, want,
                            s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// th, tw, threads, smem: the plan's (kernels/isp_fused.py stencil_plan
// and demosaic_tile_smem); the tiles here are its LIGHT_TILES.
extern "C" int demosaic_launch(const float* raw, float* out, int B, int H,
                               int W, int th, int tw, int threads, int smem,
                               void* stream) {
  if (B < 1 || H < 1 || W < 1 || th < 1 || tw < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  DemosaicArgs a;
  a.tiles_x = (W + tw - 1) / tw;
  a.tiles_y = (H + th - 1) / th;
  const int64_t blocks = (int64_t)a.tiles_x * a.tiles_y * B;
  if (blocks >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  a.raw = raw;
  a.out = out;
  a.H = H;
  a.W = W;
  a.fx = FastDiv(a.tiles_x);
  a.fy = FastDiv(a.tiles_y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (th == 8 && tw == 32) return launch<8, 32>(a, blocks, threads, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
