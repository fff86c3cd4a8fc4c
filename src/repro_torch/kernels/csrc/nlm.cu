// Non-local means, FPGA-adapted: 7x7 search window, 3x3 box-filtered
// patch distances on luminance, cyclic boundaries.  img [B, H, W, C]
// (1 <= C <= 4) and the strength (a [B] tensor read in place at a
// stride, or one value for every frame) -> out [B, H, W, C].
//
// Replaces the TPU kernel nlm_pallas (src/repro/kernels/nlm.py), which
// reads wrap-padded 128x128 tiles with a halo of 4 from VMEM, evaluates
// the 49 shifts as shifted-difference + separable box-filter algebra,
// and runs once per channel (recomputing the weights each time).  Here
// one block computes one output tile (TH x TW, the host plan's:
// stencil_plan("nlm", ...) in kernels/isp_fused.py, the largest of
// 16x16, 8x16 and 8x8 whose grid puts two blocks on every SM; 8x8 and
// 512 blocks at [8, 64, 64]) on the NLM tile of nlm_tile.cuh, the design
// of the fused stencil segment's NLM instance:
//   - its threads read the tile's (TH + 8) x (TW + 8) window row by row,
//     each index wrapped by a compare and an add (pad "wrap", the
//     reference's cyclic roll; a frame narrower than the halo by %), and
//     compute each window pixel's luminance in luminance()'s order,
//     ((c0 + c1) + c2) x float32(1/C) (torch turns the plain version's
//     "/ C" on a CUDA tensor into a multiply by the reciprocal; C = 1
//     takes the channel as it is);
//   - h = 1e-3 + 0.2 * strength with nlm_bandwidth's two rounded ops;
//   - the 49 weights of a pixel over 7 threads, one a shift row, with
//     the box columns shared along a walk; then one thread a pixel sums
//     the weights and the weighted values in nlm_pixel's shift order.
// One block per (frame, tile row, tile column), the column fastest, all
// on gridDim.x (any batch up to 2^31 - 1 blocks in all), decoded by
// host-made magic numbers.  The wrapper adds no device op: the call is
// this one launch.
//
// What bounds it on the H100: operations -- about 49 x (9 differences'
// worth of box work shared along the walk, an exp and a divide, 2C + 1
// weight ops) per pixel against 2 x C x 4 bytes of image traffic.
//
// Rounding: every op is isp::nlm_pixel's (isp_common.cuh) in its order,
// each a round-to-nearest intrinsic so nvcc cannot contract FMAs, so the
// kernel keeps the bits of a pixel-per-thread nlm_pixel on the plain
// version's luminance and bandwidth; expf is held to torch's exp at
// 1e-6.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_slab.cuh"
#include "nlm_tile.cuh"

namespace {

using repro::FastDiv;

struct NlmArgs {
  const float* img;
  float* out;
  const float* strength;   // [B] at stride sstride, or null: sval
  int64_t sstride;
  float sval;
  int H, W;
  int tiles_x, tiles_y;
  FastDiv fx, fy;          // tiles_x, tiles_y
};

template <int kC, int TH, int TW>
__global__ void __launch_bounds__(isp::kNlmThreads, 4)
nlm_kernel(const NlmArgs a) {
  using Tile = isp::NlmTile<kC, TH, TW>;
  constexpr int R = isp::kNlmR, WX = Tile::WX, LP = Tile::LumPitch;
  extern __shared__ float smem[];
  float* win = smem + Tile::kWin;
  float* lum = smem + Tile::kLum;
  // (frame, tile row, tile column) on gridDim.x, the column fastest
  const int blk = blockIdx.x;
  const int rest = a.fx.div(blk);
  const int b = a.fy.div(rest);
  const int y0 = (rest - b * a.tiles_y) * TH;
  const int x0 = (blk - rest * a.tiles_x) * TW;
  const int H = a.H, W = a.W;
  const float* img = a.img + (int64_t)b * H * W * kC;

  for (int k = threadIdx.x; k < Tile::kPix; k += blockDim.x) {
    const int wy = k / WX, wx = k % WX;
    const int yy = isp::wrap_near(y0 - R + wy, H);
    const int xx = isp::wrap_near(x0 - R + wx, W);
    const float* src = img + ((int64_t)yy * W + xx) * kC;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < kC; ++c) v[c] = src[c];
    if constexpr (Tile::kWinC == 4) {
      reinterpret_cast<float4*>(win)[k] = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (kC == 2) {
      reinterpret_cast<float2*>(win)[k] = make_float2(v[0], v[1]);
    } else {
      win[k] = v[0];
    }
    // luminance: the channels summed left to right, times float32(1/C)
    float l = v[0];
    if constexpr (kC > 1) {
#pragma unroll
      for (int c = 1; c < kC; ++c) l = __fadd_rn(l, v[c]);
      l = __fmul_rn(l, 1.f / static_cast<float>(kC));
    }
    lum[wy * LP + wx] = l;
  }
  // nlm_bandwidth: 1e-3 + 0.2 * strength, then h * h
  const float s = a.strength ? a.strength[(int64_t)b * a.sstride] : a.sval;
  const float h = __fadd_rn(__fmul_rn(0.2f, s), 1e-3f);
  __syncthreads();
  isp::nlm_weights<TH, TW, LP, Tile::WPitch>(lum, smem + Tile::kWts,
                                             __fmul_rn(h, h));
  __syncthreads();
  isp::nlm_sums<kC, TH, TW, Tile::WPitch>(win, smem + Tile::kWts, y0, x0, H,
                                          W, a.out + (int64_t)b * H * W * kC);
}

// One instance's launch: the plan's threads and shared bytes must be the
// instance's; above 48 KB the kernel opts in once per device.
template <int kC, int TH, int TW>
int launch(const NlmArgs& a, int64_t blocks, int threads, int smem,
           cudaStream_t s) {
  using Tile = isp::NlmTile<kC, TH, TW>;
  const int want = Tile::kFloats * static_cast<int>(sizeof(float));
  if (threads != isp::kNlmThreads || smem != want)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = nlm_kernel<kC, TH, TW>;
  if (want > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    static bool opted[64] = {};
    if (dev >= 64) return static_cast<int>(cudaErrorInvalidValue);
    if (!opted[dev]) {
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, want);
      if (e != cudaSuccess) return static_cast<int>(e);
      opted[dev] = true;
    }
  }
  kern<<<static_cast<unsigned>(blocks), threads, want, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The instance on kC channels for the plan's tile (kernels/isp_fused.py
// NLM_TILES).
template <int kC>
int launch_tile(const NlmArgs& a, int th, int tw, int64_t blocks,
                int threads, int smem, cudaStream_t s) {
  if (th == 16 && tw == 16)
    return launch<kC, 16, 16>(a, blocks, threads, smem, s);
  if (th == 8 && tw == 16)
    return launch<kC, 8, 16>(a, blocks, threads, smem, s);
  if (th == 8 && tw == 8)
    return launch<kC, 8, 8>(a, blocks, threads, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// strength: a [B] float32 tensor read at stride sstride (0: one value
// for all), or null to use sval for every frame.
extern "C" int nlm_launch(const float* img, const float* strength,
                          int64_t sstride, float sval, float* out, int B,
                          int H, int W, int C, int th, int tw, int threads,
                          int smem, void* stream) {
  if (C < 1 || C > isp::kNlmMaxC || B < 1 || H < 1 || W < 1 || th < 1 ||
      tw < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  NlmArgs a;
  a.tiles_x = (W + tw - 1) / tw;
  a.tiles_y = (H + th - 1) / th;
  const int64_t blocks = (int64_t)a.tiles_x * a.tiles_y * B;
  if (blocks >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  a.img = img;
  a.out = out;
  a.strength = strength;
  a.sstride = sstride;
  a.sval = sval;
  a.H = H;
  a.W = W;
  a.fx = FastDiv(a.tiles_x);
  a.fy = FastDiv(a.tiles_y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch_tile<1>(a, th, tw, blocks, threads, smem, s);
    case 2: return launch_tile<2>(a, th, tw, blocks, threads, smem, s);
    case 3: return launch_tile<3>(a, th, tw, blocks, threads, smem, s);
    default: return launch_tile<4>(a, th, tw, blocks, threads, smem, s);
  }
}
