// The NLM tile: non-local means over one output tile whose window (the
// tile and a halo of 4) is staged in shared memory with its luminance
// plane.  Shared by the standalone NLM kernel (nlm.cu) and the NLM
// instance of the fused stencil segment (isp_fused.cu), so the design
// and its bits exist once.
//
// A block stages the window ([WY][WX] pixels, the C channels of a pixel
// together: a float4 for C = 3 and 4, so the sums read a pixel at once)
// and the window's luminance plane (row pitch lum_pitch(WX)), then:
//   nlm_weights: the 49 weights of a pixel over 7 threads, one a shift
// row.  A thread walks nlm_walk(TW) pixels along a tile row and computes
// its 7 shifts at each, so the squared differences and box columns of a
// shift are shared between neighbouring pixels (one column a step, not
// nine differences a pixel) and the shifted luminances slide through a
// register ring (six loads a step for seven weights).  The weights go to
// shared memory, [shift][pixel], a shift's row one float longer than the
// tile (WPitch) so the seven shifts a thread stores at once fall on
// distinct banks.
//   nlm_sums: one thread a pixel sums the weights and the weighted
// values in nlm_pixel's shift order and divides.
// Every op is isp::nlm_pixel's in its order (nlm_sq, nlm_col,
// nlm_weight), so a tile keeps the bits of a pixel-per-thread nlm_pixel.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "isp_common.cuh"

namespace isp {

constexpr int kNlmR = 4;          // 3 (search radius) + 1 (patch radius)
constexpr int kNlmShifts = 49;    // the 7 x 7 search
constexpr int kNlmThreads = 256;  // kernels/isp_fused.py NLM_THREADS

// pixels a weight thread walks along a tile row (kernels/isp_fused.py
// nlm_walk): 2 on 8-wide tiles (more threads), 8 on wider ones
__host__ __device__ constexpr int nlm_walk(int tw) { return tw == 8 ? 2 : 8; }

// a luminance plane's row pitch for a window wx pixels wide: a 16-float
// (mod 32) pitch puts two shift rows on one bank; +4 spreads them
__host__ __device__ constexpr int lum_pitch(int wx) {
  return wx % 16 == 0 ? wx + 4 : wx;
}

// floats a window pixel takes: C = 3 is padded to a float4
__host__ __device__ constexpr int nlm_win_c(int c) { return c == 3 ? 4 : c; }

// The shared-memory planes of a TH x TW tile on kC channels, in floats:
// the window, the luminance plane and the weights (kernels/isp_fused.py
// nlm_tile_smem counts the same).
template <int kC, int TH, int TW>
struct NlmTile {
  static constexpr int WY = TH + 2 * kNlmR, WX = TW + 2 * kNlmR;
  static constexpr int kPix = WY * WX;
  static constexpr int LumPitch = lum_pitch(WX);
  static constexpr int kWinC = nlm_win_c(kC);
  static constexpr int kWin = 0;
  static constexpr int kLum = kPix * kWinC;
  static constexpr int kWts = kLum + WY * LumPitch;
  static constexpr int WPitch = TH * TW + 1;
  static constexpr int kFloats = kWts + kNlmShifts * WPitch;
};

// The weights of a TH x TW tile into wts [shift][pixel] (row pitch WP);
// lum is the window's luminance plane (row pitch LP), hh = h * h.
//
// Item i = (tile row ty, walker g, shift row dy), dy fastest: the thread
// walks kWalk pixels of row ty and computes all 7 shifts (dx) of its row
// at each, each shift's box columns kept in registers from the pixel
// before.  The box column at window column X is the squared differences
// at rows ty, ty - 1, ty + 1 (window rows Yc, Yc - 1, Yc + 1) against the
// pixels (dy, dx) away; those shifted pixels slide one column a step, so
// a step loads the three centre and three new shifted luminances into a
// ring of 7 columns.
template <int TH, int TW, int LP, int WP>
__device__ __forceinline__ void nlm_weights(const float* lum, float* wts,
                                            float hh) {
  constexpr int R = kNlmR;
  constexpr int kWalk = nlm_walk(TW), kWalkers = TW / kWalk;
  static_assert(TW % kWalk == 0, "a tile row is whole walks");
  for (int i = threadIdx.x; i < 7 * TH * kWalkers; i += blockDim.x) {
    const int row = i % 7, r = i / 7;
    const int g = r % kWalkers, ty = r / kWalkers;
    const int dy = row - 3;
    const int X0 = g * kWalk + R;              // the run's first column
    const float* cen = lum + (ty + R) * LP;    // window row Yc
    const float* shf = cen - dy * LP;          // window row Yc - dy
    // ring[k][rr]: shifted luminance at column X - 3 + k, row rr - 1
    float ring[7][3];
#pragma unroll
    for (int k = 0; k < 7; ++k)
#pragma unroll
      for (int rr = 0; rr < 3; ++rr)
        ring[k][rr] = shf[(rr - 1) * LP + X0 - 1 - 3 + k];
    // shift dx = d - 3's box column at X, whose centre luminances are
    // c[0..2] (rows Yc - 1, Yc, Yc + 1): it reads ring column X - dx
    auto col = [&](const float* c, int d) {
      const float* sv = ring[6 - d];
      return nlm_col(nlm_sq(c[1], sv[1]), nlm_sq(c[0], sv[0]),
                     nlm_sq(c[2], sv[2]));
    };
    auto centre = [&](int X, float* c) {
      c[0] = cen[X - LP];
      c[1] = cen[X];
      c[2] = cen[X + LP];
    };
    auto slide = [&](int X) {   // the ring from column X's to X + 1's
#pragma unroll
      for (int k = 0; k < 6; ++k)
#pragma unroll
        for (int rr = 0; rr < 3; ++rr) ring[k][rr] = ring[k + 1][rr];
#pragma unroll
      for (int rr = 0; rr < 3; ++rr) ring[6][rr] = shf[(rr - 1) * LP + X + 4];
    };
    float left[7], mid[7], c[3];
    centre(X0 - 1, c);
#pragma unroll
    for (int d = 0; d < 7; ++d) left[d] = col(c, d);
    slide(X0 - 1);
    centre(X0, c);
#pragma unroll
    for (int d = 0; d < 7; ++d) mid[d] = col(c, d);
    float* wp = wts + row * 7 * WP + ty * TW + X0 - R;
#pragma unroll
    for (int j = 0; j < kWalk; ++j) {
      slide(X0 + j);
      centre(X0 + j + 1, c);
#pragma unroll
      for (int d = 0; d < 7; ++d) {
        const float right = col(c, d);
        wp[d * WP + j] = nlm_weight(mid[d], left[d], right, hh);
        left[d] = mid[d];
        mid[d] = right;
      }
    }
  }
}

// The sums of a tile whose first pixel is (y0, x0) in an H x W frame:
// one thread a pixel, wsum and the kC channels' weighted values in
// nlm_pixel's shift order; shift (dy, dx) reads the window pixel at
// (y - dy, x - dx).  win holds nlm_win_c(kC) floats a pixel, [WY][WX];
// dst is the frame's output [H, W, kC].  Pixels outside the frame are
// not written.
template <int kC, int TH, int TW, int WP>
__device__ __forceinline__ void nlm_sums(const float* win, const float* wts,
                                         int y0, int x0, int H, int W,
                                         float* dst) {
  constexpr int R = kNlmR, WX = TW + 2 * R;
  for (int p = threadIdx.x; p < TH * TW; p += blockDim.x) {
    const int ty = p / TW, tx = p % TW;
    const int y = y0 + ty, x = x0 + tx;
    if (y >= H || x >= W) continue;
    const int ctr = (ty + R) * WX + tx + R;    // the pixel in the window
    float wsum = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < kNlmShifts; ++s) {
      const int dy = s / 7 - 3, dx = s % 7 - 3;
      const int at = ctr - dy * WX - dx;
      const float w = wts[s * WP + p];
      wsum = __fadd_rn(wsum, w);
      if constexpr (nlm_win_c(kC) == 4) {
        const float4 v = reinterpret_cast<const float4*>(win)[at];
        const float vc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int c = 0; c < kC; ++c)
          acc[c] = __fadd_rn(acc[c], __fmul_rn(w, vc[c]));
      } else if constexpr (kC == 2) {
        const float2 v = reinterpret_cast<const float2*>(win)[at];
        acc[0] = __fadd_rn(acc[0], __fmul_rn(w, v.x));
        acc[1] = __fadd_rn(acc[1], __fmul_rn(w, v.y));
      } else {
        acc[0] = __fadd_rn(acc[0], __fmul_rn(w, win[at]));
      }
    }
    // torch.clamp(wsum, min=1e-9): NaN passes through
    const float den = (!isnan(wsum) && wsum < 1e-9f) ? 1e-9f : wsum;
    float* o = dst + ((int64_t)y * W + x) * kC;
#pragma unroll
    for (int c = 0; c < kC; ++c) o[c] = __fdiv_rn(acc[c], den);
  }
}

}  // namespace isp
