// The demosaic tile: the Malvar-He-Cutler RGB of one TH x TW output tile
// whose mosaic window (the tile and a halo of 2) is staged in shared
// memory.  Shared by the standalone demosaic kernel (demosaic.cu) and the
// demosaic instance of the fused stencil segment (isp_fused.cu), so the
// design and its bits exist once.
//
// A block stages the window, [WY][WX] floats (one a pixel: a mosaic has
// one channel), the mosaic at (y0 - 2 + wy, x0 - 2 + wx), then
// demosaic_tile computes the tile's pixels, one thread a pixel:
//   - the threads are grouped by Bayer phase, a quarter of the tile each
// (the R sites, G in R rows, G in B rows, B sites), so a warp takes one
// phase and runs its two filters, not all four;
//   - the tile's corner is even (TH and TW even; y0 and x0 multiples of
// them), so a pixel's phase in the tile is its phase in the frame;
//   - each phase's filters have their zero taps dropped when the kernel
// compiles (isp::mhc_rgb_c), every tap a read of the staged window;
//   - each pixel stores its three clipped floats; pixels past the
// frame's ragged edge are skipped.
// Every op is the plain tap accumulation's in its order (isp::mhc_rgb_c),
// so a tile keeps the bits of repro_torch.isp.demosaic.demosaic_mhc.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "isp_common.cuh"

namespace isp {

constexpr int kDemosaicR = 2;     // the 5x5 filters' halo

// The shared-memory window of a TH x TW tile, in floats
// (kernels/isp_fused.py demosaic_tile_smem counts the same), and the
// threads of a block: one a pixel.
template <int TH, int TW>
struct DemosaicTile {
  static_assert(TH % 2 == 0 && TW % 2 == 0,
                "a demosaic tile has an even corner: even TH and TW");
  static constexpr int WY = TH + 2 * kDemosaicR, WX = TW + 2 * kDemosaicR;
  static constexpr int kPix = WY * WX;
  static constexpr int kFloats = kPix;
  static constexpr int kThreads = TH * TW;
};

// The RGB [H, W, 3] of the tile at (y0, x0) from its staged window win,
// into dst (the frame's output).
template <int TH, int TW>
__device__ __forceinline__ void demosaic_tile(const float* win, int y0,
                                              int x0, int H, int W,
                                              float* dst) {
  constexpr int WX = DemosaicTile<TH, TW>::WX;
  constexpr int kQ = TH * TW / 4, kHalfW = TW / 2;
  for (int p = threadIdx.x; p < TH * TW; p += blockDim.x) {
    const int phase = p / kQ, k = p % kQ;
    const int ty = 2 * (k / kHalfW) + (phase >> 1);
    const int tx = 2 * (k % kHalfW) + (phase & 1);
    const int y = y0 + ty, x = x0 + tx;
    if (y >= H || x >= W) continue;
    const int cidx = (ty + kDemosaicR) * WX + tx + kDemosaicR;
    // the mosaic at offset (dy - 2, dx - 2) from the pixel
    auto at = [&](int dy, int dx) {
      return win[cidx + (dy - kDemosaicR) * WX + dx - kDemosaicR];
    };
    const float c = win[cidx];
    float o[3];
    switch (phase) {
      case 0: mhc_rgb_c<true, true>(c, at, o); break;
      case 1: mhc_rgb_c<true, false>(c, at, o); break;
      case 2: mhc_rgb_c<false, true>(c, at, o); break;
      default: mhc_rgb_c<false, false>(c, at, o); break;
    }
    float* out = dst + ((int64_t)y * W + x) * 3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out[ch] = o[ch];
  }
}

}  // namespace isp
