// Window maths shared by the ISP kernels (demosaic_tile.cuh, nlm.cu and
// the fused segments of isp_fused.cu), so the per-stage kernels and the
// fused ones compute each pixel with the same operations in the same
// order.  Every product and sum is a round-to-nearest intrinsic, so nvcc
// cannot contract them into FMAs: the order is the plain PyTorch
// version's, and the bits with it.
#pragma once

#include <cuda_runtime.h>

namespace isp {

// torch.clamp(v, 0, 1): NaN passes through
__device__ __forceinline__ float clip01(float v) {
  if (isnan(v)) return v;
  v = v < 0.f ? 0.f : v;
  return v > 1.f ? 1.f : v;
}

// v mod n in [0, n): the cyclic index of jnp.roll / torch.roll
__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// v mod n in [0, n) for an index at most one period outside [0, n) by a
// compare and an add; farther out (a frame narrower than the halo) by %
__device__ __forceinline__ int wrap_near(int v, int n) {
  if (v < 0) v += n;
  else if (v >= n) v -= n;
  return static_cast<unsigned>(v) < static_cast<unsigned>(n) ? v
                                                             : wrap(v, n);
}

// ---------------------------------------------------------------------------
// Malvar-He-Cutler 5x5 demosaic of an RGGB mosaic
// ---------------------------------------------------------------------------

// The MHC filter bank as compile-time taps, row-major 5x5, scaled by 1/8
// (copied from repro_torch/isp/demosaic.py; exact in float32).  Filter
// F: 0 G at R/B sites, 1 R at G in an R row (and B at G in a B row), 2
// its transpose (R at G in a B row, B at G in an R row), 3 R at B (and B
// at R).  A kernel knows a pixel's phase when it compiles, so the zero
// taps are skipped by the compiler, not per pixel.  mhc_filter_c sums
// from 0 over the non-zero taps in (dy, dx) order, as the plain tap
// accumulation does (demosaic.py _conv5_taps), each product and sum
// rounded once: the plain version's bits.
template <int F>
__device__ __forceinline__ float mhc_tap(int i) {
  constexpr float k[4][25] = {
      {0, 0, -1.f / 8, 0, 0, 0, 0, 2.f / 8, 0, 0, -1.f / 8, 2.f / 8, 4.f / 8,
       2.f / 8, -1.f / 8, 0, 0, 2.f / 8, 0, 0, 0, 0, -1.f / 8, 0, 0},
      {0, 0, 0.5f / 8, 0, 0, 0, -1.f / 8, 0, -1.f / 8, 0, -1.f / 8, 4.f / 8,
       5.f / 8, 4.f / 8, -1.f / 8, 0, -1.f / 8, 0, -1.f / 8, 0, 0, 0,
       0.5f / 8, 0, 0},
      {0, 0, -1.f / 8, 0, 0, 0, -1.f / 8, 4.f / 8, -1.f / 8, 0, 0.5f / 8, 0,
       5.f / 8, 0, 0.5f / 8, 0, -1.f / 8, 4.f / 8, -1.f / 8, 0, 0, 0,
       -1.f / 8, 0, 0},
      {0, 0, -1.5f / 8, 0, 0, 0, 2.f / 8, 0, 2.f / 8, 0, -1.5f / 8, 0,
       6.f / 8, 0, -1.5f / 8, 0, 2.f / 8, 0, 2.f / 8, 0, 0, 0, -1.5f / 8, 0,
       0}};
  return k[F][i];
}

template <int F, class At>
__device__ __forceinline__ float mhc_filter_c(At at) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 25; ++i) {
    const float kv = mhc_tap<F>(i);
    if (kv == 0.f) continue;
    acc = __fadd_rn(acc, __fmul_rn(kv, at(i / 5, i % 5)));
  }
  return acc;
}

// The clipped RGB of one mosaic pixel of value c at an even (kEy) or odd
// row and an even (kEx) or odd column: only the two filters its phase
// needs; at(dy, dx) is the mosaic at offset (dy - 2, dx - 2).
template <bool kEy, bool kEx, class At>
__device__ __forceinline__ void mhc_rgb_c(float c, At at, float* rgb) {
  float r, g, b;
  if constexpr (kEy && kEx) {           // R site
    r = c;
    g = mhc_filter_c<0>(at);
    b = mhc_filter_c<3>(at);
  } else if constexpr (kEy) {           // G in an R row
    r = mhc_filter_c<1>(at);
    g = c;
    b = mhc_filter_c<2>(at);
  } else if constexpr (kEx) {           // G in a B row
    r = mhc_filter_c<2>(at);
    g = c;
    b = mhc_filter_c<1>(at);
  } else {                              // B site
    r = mhc_filter_c<3>(at);
    g = mhc_filter_c<0>(at);
    b = c;
  }
  rgb[0] = clip01(r);
  rgb[1] = clip01(g);
  rgb[2] = clip01(b);
}

// ---------------------------------------------------------------------------
// Non-local means: 7x7 search, 3x3 box-filtered patch distances on
// luminance
// ---------------------------------------------------------------------------

constexpr int kNlmMaxC = 4;

// One output pixel at (y, x).  lum(ry, cx) is the luminance and img(ry,
// cx) a pointer to the C channels of the pixel at (y + ry - 4, x + cx - 4),
// ry and cx in [0, 9); hh is h * h.  The plain version's order:
//   d2 = ((s(y,x) + s(y-1,x)) + s(y+1,x)) per column, then
//        ((c(x) + c(x-1)) + c(x+1)), times float32(1/9)  [torch turns
//        the plain version's "/ 9.0" on a CUDA tensor into a multiply by
//        the reciprocal]
//   w = expf(-d2 / hh); wsum and acc summed in (dy, dx) order;
//   out = acc / max(wsum, 1e-9),
// with roll(a, (dy, dx))[y, x] == a[y - dy, x - dx].
template <class Lum, class Img>
__device__ __forceinline__ void nlm_pixel(Lum lum, Img img, float hh, int C,
                                          float* out) {
  // centre luminances of the 3x3 patch
  float lc[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) lc[a][c] = lum(a + 3, c + 3);

  float wsum = 0.f;
  float acc[kNlmMaxC] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int dy = -3; dy <= 3; ++dy) {
#pragma unroll
    for (int dx = -3; dx <= 3; ++dx) {
      // squared differences s[a][c] at (y + a - 1, x + c - 1)
      float s[3][3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float d = __fsub_rn(lc[a][c], lum(a + 3 - dy, c + 3 - dx));
          s[a][c] = __fmul_rn(d, d);
        }
      float col[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        col[c] = __fadd_rn(__fadd_rn(s[1][c], s[0][c]), s[2][c]);
      const float box = __fadd_rn(__fadd_rn(col[1], col[0]), col[2]);
      const float d2 = __fmul_rn(box, 1.0f / 9.0f);
      const float w = expf(__fdiv_rn(-d2, hh));
      wsum = __fadd_rn(wsum, w);
      const float* v = img(4 - dy, 4 - dx);
#pragma unroll
      for (int ch = 0; ch < kNlmMaxC; ++ch)
        if (ch < C) acc[ch] = __fadd_rn(acc[ch], __fmul_rn(w, v[ch]));
    }
  }
  // torch.clamp(wsum, min=1e-9): NaN passes through
  const float den = (!isnan(wsum) && wsum < 1e-9f) ? 1e-9f : wsum;
#pragma unroll
  for (int ch = 0; ch < kNlmMaxC; ++ch)
    if (ch < C) out[ch] = __fdiv_rn(acc[ch], den);
}

// nlm_pixel's steps, one at a time, for a kernel that shares them between
// neighbouring pixels (the fused NLM segment of isp_fused.cu): the squared
// luminance difference at one patch position, a column of the 3x3 box
// (rows y, y - 1, then y + 1), the box (columns x, x - 1, then x + 1) and
// the weight.  Each is the op of nlm_pixel in its order, so the weights
// and the sums over them keep its bits.
__device__ __forceinline__ float nlm_sq(float centre, float shifted) {
  const float d = __fsub_rn(centre, shifted);
  return __fmul_rn(d, d);
}
__device__ __forceinline__ float nlm_col(float s_y, float s_up,
                                         float s_down) {
  return __fadd_rn(__fadd_rn(s_y, s_up), s_down);
}
__device__ __forceinline__ float nlm_weight(float col_x, float col_left,
                                            float col_right, float hh) {
  const float box = __fadd_rn(__fadd_rn(col_x, col_left), col_right);
  const float d2 = __fmul_rn(box, 1.0f / 9.0f);
  return expf(__fdiv_rn(-d2, hh));
}

}  // namespace isp
