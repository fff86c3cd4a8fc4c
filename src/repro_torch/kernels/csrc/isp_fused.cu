// Fused ISP segments: a chain of pointwise stages over a frame, or the
// same chain as the prologue of a stencil stage, in one pass.
//
//   isp_pointwise_launch: x [B, H, W, C] -> out [B, H, W, C]
//   isp_stencil_launch:   x [B, H, W, Cin] -> out [B, H, W, Cout]
// (C = 1 for a Bayer mosaic, 3 for RGB), with pvec [B, P] (the planner's
// packed stage parameters, one row per frame), stats [B, S] (a reduce
// stage's global statistics) and consts (the stages' array constants,
// flattened).  The gamma stage's per-frame LUT: every block builds its
// frame's in shared memory from the gamma parameter at gamma_off in the
// frame's pvec row (-1: none) with gamma_lut's ops (gamma_lut_block: a
// clamp, an IEEE reciprocal, i * float32(1/255), powf), so a segment of
// either kind is one device op.
//
// Replaces the TPU kernels pointwise_segment_pallas and
// stencil_segment_pallas (src/repro/kernels/isp_fused.py), which run a
// chain of Python stage functions per 128x128 VMEM tile, the stencil
// kernel over a frame halo-padded once outside the kernel.  A CUDA
// kernel cannot call the stages' Python forms, so it interprets a
// descriptor: one op code per chain step (enum Op, the order of
// DEVICE_OPS in repro_torch/kernels/isp_fused.py) with the offset of its
// parameters in a pvec row and of its constants in consts, plus the
// window op of a stencil segment.
//
// pointwise: one block per (frame, tile of the frame's flat H*W*C span),
// all on gridDim.x (any batch up to 2^31 - 1 blocks in all), decoded by
// a host-made magic number; the tile (256, 512 or 1024 pixels, 256
// threads) comes from the host plan (pointwise_plan in
// kernels/isp_fused.py, cached per shape), which this launcher checks.
// The block copies its frame's pvec and stats rows to shared memory
// once, loads its span into a shared stage with 16-byte loads (4-byte
// lanes at the unaligned head and the ragged tail; the stage is offset
// so the 16-byte loads land aligned in it), builds the frame's LUT
// while those loads are in flight, applies the chain to whole pixels
// (AWB and CCM mix a pixel's channels) in place and stores the span the
// same way.  Frames of any size: a tile past the frame's end is cut.
//
// stencil: one instance per window op (dpc r = 2, C 1 -> 1; demosaic
// r = 2, C 1 -> 3; nlm r = 4, C 1 or 3; sharpen r = 1, C 3) and output
// tile (TH x TW), so the window side, the halo indexing and the loops are
// compile-time.  The host plan (stencil_plan in kernels/isp_fused.py,
// cached per shape) picks the tile and this launcher checks its threads
// and shared bytes against the instance's: dpc, demosaic and sharpen take
// an 8 x 32 tile, one thread a pixel (on the H100 as fast as any of 8x8
// to 16x32 at [8, 64, 64], where a launch's latency sets the time, and
// at [4, 480, 640]); NLM the largest of 16x16, 8x16 and 8x8 whose grid
// puts two blocks on every SM (8x8 on the tick: 512 blocks).
// One block per (frame, tile row, tile column), the column fastest, all
// on gridDim.x (any batch up to 2^31 - 1 blocks in all), decoded by
// host-made magic numbers.  Its threads read the tile's (TH+2r) x (TW+2r)
// window row by row (consecutive threads on consecutive pixels), wrapping
// an index by a compare and an add (pad "wrap", the reference's cyclic
// roll) or reading zero outside the frame (pad "zero", the reference's
// SAME padding, applied after the prologue as the per-stage path pads
// the prologue's output): no padded copy.  Each window pixel gets the
// prologue chain once, with its own frame's parameters, into shared
// memory, plus a luminance plane for NLM and sharpen.  Frames of any
// size: the ragged edge is guarded per pixel.
//   dpc, sharpen: one thread per output pixel.
//   demosaic: the demosaic tile of demosaic_tile.cuh (shared with
// demosaic.cu): one thread a pixel, the threads grouped by Bayer phase,
// each phase's two filters with the zero taps dropped when the kernel
// compiles (isp::mhc_rgb_c).
//   nlm: the NLM tile of nlm_tile.cuh (shared with nlm.cu): the 49
// weights of a pixel over 7 threads, one a shift row, walking a run of
// pixels with the box columns shared and the shifted luminances in a
// register ring, the weights [shift][pixel] in shared memory; then one
// thread a pixel sums them in nlm_pixel's shift order.  Every op is
// nlm_pixel's in its order, so the segment keeps the bits of a
// pixel-per-thread nlm_pixel.
//
// What bounds it on the H100: bytes for the pointwise chains, dpc,
// demosaic and sharpen (one read of the input, one write of the output;
// the halo re-reads hit L1/L2); operations for NLM (49 weights with an
// exp and a divide each per pixel).  At [8, 64, 64] every segment moves
// under 1 MB, so a launch's latency dominates all but NLM: a segment is
// one device op (the LUT built in the block, the flattened constants
// cached by the wrapper).  At a VGA batch and above the pointwise kernel
// is held by its bytes: 16-byte accesses, and blocks enough to fill the
// card (1200 at [4, 480, 640]).
//
// Rounding: every step is a round-to-nearest intrinsic in the plain
// PyTorch version's op order, so nvcc cannot contract FMAs; torch's
// division of a CUDA tensor by a Python scalar is a multiply by the
// float32 reciprocal, and the kernels do the same ("/ 6.0" in dpc,
// "/ 5.0" in sharpen, "/ 3" in NLM's luminance).  Every op gives the
// plain version's bits but two: sharpen's colour matrices are einsums on
// the plain side (a library GEMM, summed in its own order), and expf is
// held to torch's exp at 1e-6.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_slab.cuh"
#include "demosaic_tile.cuh"
#include "isp_common.cuh"
#include "nlm_tile.cuh"

namespace {

using repro::FastDiv;

constexpr int kMaxSteps = 8;      // kernels/isp_fused.py MAX_STEPS
constexpr int kLut = 256;
constexpr int kMaxThreads = 256;  // the largest stencil block (8 x 32)

enum Op {
  kExposure = 1, kAwb, kGamma, kTonemap, kCcm,   // pointwise
  kDpc, kDemosaic, kNlm, kSharpen                // window
};

struct Chain {
  int n;
  int op[kMaxSteps];
  int p[kMaxSteps];   // offset of the step's first parameter in a pvec row
  int c[kMaxSteps];   // offset of the step's first constant in consts
};

// apply_gamma: the linear-interpolated LUT lookup
__device__ __forceinline__ float lut_interp(const float* lut, float v) {
  const float scaled = __fmul_rn(v, (float)(kLut - 1));
  int idx = (int)scaled;                  // .to(torch.int32): truncation
  idx = idx < 0 ? 0 : (idx > kLut - 1 ? kLut - 1 : idx);
  const float frac = __fsub_rn(scaled, (float)idx);
  const float lo = lut[idx];
  const float hi = lut[idx + 1 > kLut - 1 ? kLut - 1 : idx + 1];
  return __fadd_rn(lo, __fmul_rn(frac, __fsub_rn(hi, lo)));
}

// v . m[0:3], summed left to right
__device__ __forceinline__ float dot3(const float* v, const float* m) {
  return __fadd_rn(__fadd_rn(__fmul_rn(v[0], m[0]), __fmul_rn(v[1], m[1])),
                   __fmul_rn(v[2], m[2]));
}

// The chain on one pixel's C channels v, with its frame's parameter row
// pv, stats row st and LUT row lut.
__device__ __forceinline__ void apply_chain(const Chain& ch, const float* pv,
                                            const float* st,
                                            const float* consts,
                                            const float* lut, float* v,
                                            int C) {
  for (int s = 0; s < ch.n; ++s) {
    const float* p = pv + ch.p[s];
    switch (ch.op[s]) {
      case kExposure:       // clamp(x * gain, 0, 1)
        for (int c = 0; c < C; ++c)
          v[c] = isp::clip01(__fmul_rn(v[c], p[0]));
        break;
      case kAwb: {          // awb_apply_stats: enable, bias_r, bias_b
        const float e = p[0];
        const float rest = __fmul_rn(__fsub_rn(1.f, e), 1.f);
        const float bias[3] = {p[1], 1.f, p[2]};
        for (int c = 0; c < 3; ++c) {
          const float g = __fmul_rn(
              __fadd_rn(__fmul_rn(e, st[c]), rest), bias[c]);
          v[c] = isp::clip01(__fmul_rn(v[c], g));
        }
        break;
      }
      case kGamma:
        for (int c = 0; c < C; ++c) v[c] = lut_interp(lut, v[c]);
        break;
      case kTonemap: {      // x (1+k) / (x+k), k = 1 / (1e-3 + 4 strength)
        const float k = __frcp_rn(__fadd_rn(__fmul_rn(4.f, p[0]), 1e-3f));
        const float k1 = __fadd_rn(k, 1.f);
        for (int c = 0; c < C; ++c)
          v[c] = isp::clip01(
              __fdiv_rn(__fmul_rn(v[c], k1), __fadd_rn(v[c], k)));
        break;
      }
      case kCcm: {          // lum + saturation (x - lum), luma row in consts
        const float lum = dot3(v, consts + ch.c[s]);
        for (int c = 0; c < 3; ++c)
          v[c] = isp::clip01(
              __fadd_rn(lum, __fmul_rn(p[0], __fsub_rn(v[c], lum))));
        break;
      }
      default:
        break;
    }
  }
}

// gamma_lut's ops on the frame's gamma g, into lut[0:256] by the block's
// threads (the caller synchronises): axis ** (1 / clamp(g, 1e-3)), axis
// the reference's linspace as XLA evaluates it, i * float32(1/255) with
// the endpoint 1.  Both kernels build their LUT here: one bit contract.
__device__ __forceinline__ void gamma_lut_block(float* lut, float g) {
  const float gc = isnan(g) ? g : (g < 1e-3f ? 1e-3f : g);
  const float inv = __fdiv_rn(1.f, gc);
  const float step = static_cast<float>(1.0 / (kLut - 1));
  for (int i = threadIdx.x; i < kLut; i += blockDim.x)
    lut[i] = powf(i < kLut - 1 ? __fmul_rn(static_cast<float>(i), step)
                               : 1.f,
                  inv);
}

// ---------------------------------------------------------------------------
// pointwise segments
// ---------------------------------------------------------------------------

constexpr int kPointwiseThreads = 256;   // kernels/isp_fused.py POINTWISE_*

// floats past the last 16-byte boundary at p
__device__ __forceinline__ int phase16(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// dst[0:n] = src[0:n] by the block's threads, where dst has src's 16-byte
// phase: 4-byte lanes up to src's first 16-byte boundary, then 16-byte
// accesses, then 4-byte lanes at the tail.
__device__ __forceinline__ void copy_span(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int n) {
  const int lead = (4 - phase16(src)) & 3;
  const int head = lead < n ? lead : n;
  const int body = (n - head) >> 2;
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int i = threadIdx.x; i < body; i += blockDim.x) d4[i] = s4[i];
  for (int i = head + 4 * body + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = src[i];
}

struct PointwiseArgs {
  const float* x;
  float* out;
  const float* pvec;
  const float* stats;
  const float* consts;
  int gamma_off;                // the gamma step's param in a pvec row, or -1
  int P, S;
  int tile;                     // pixels a block
  int tiles;                    // tiles a frame
  int64_t span;                 // floats a frame: H * W * C
  FastDiv ft;                   // tiles
  Chain ch;
};

// Shared floats of a block: the stage (a tile's floats and a 16-byte
// phase's slack), the LUT, the frame's pvec and stats rows.
__host__ __device__ constexpr int pointwise_floats(int tile, int C, int P,
                                                   int S) {
  return tile * C + 4 + kLut + P + S;
}

template <int kC>
__global__ void __launch_bounds__(kPointwiseThreads)
pointwise_kernel(const PointwiseArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // (frame, tile) on gridDim.x, the tile fastest
  const int blk = blockIdx.x;
  const int b = a.ft.div(blk);
  const int t = blk - b * a.tiles;
  const int64_t first = static_cast<int64_t>(t) * a.tile * kC;
  const int64_t left = a.span - first;   // the frame's last tile is cut
  const int n = static_cast<int>(left < a.tile * kC ? left : a.tile * kC);
  const float* src = a.x + static_cast<int64_t>(b) * a.span + first;
  float* dst = a.out + static_cast<int64_t>(b) * a.span + first;
  float* stage = smem + phase16(src);     // src's 16-byte phase
  float* lut = smem + a.tile * kC + 4;
  float* pv = lut + kLut;
  float* st = pv + a.P;
  const float* pv_g = a.pvec + static_cast<int64_t>(b) * a.P;
  const float* st_g = a.stats + static_cast<int64_t>(b) * a.S;
  copy_span(stage, src, n);
  for (int i = threadIdx.x; i < a.P; i += blockDim.x) pv[i] = pv_g[i];
  for (int i = threadIdx.x; i < a.S; i += blockDim.x) st[i] = st_g[i];
  // the LUT's powf while the span's loads are in flight
  if (a.gamma_off >= 0) gamma_lut_block(lut, pv_g[a.gamma_off]);
  __syncthreads();
  for (int p = threadIdx.x; p < n / kC; p += blockDim.x) {
    float v[3];
#pragma unroll
    for (int c = 0; c < kC; ++c) v[c] = stage[p * kC + c];
    apply_chain(a.ch, pv, st, a.consts, lut, v, kC);
#pragma unroll
    for (int c = 0; c < kC; ++c) stage[p * kC + c] = v[c];
  }
  __syncthreads();
  if (phase16(dst) == phase16(src)) {
    copy_span(dst, stage, n);
  } else {                      // out off x's phase: 4-byte lanes
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = stage[i];
  }
}

// The descriptor from the host arrays; false if a step is not a
// pointwise op the C channels allow.
bool make_chain(int n, const int* ops, const int* poffs, const int* coffs,
                int C, Chain* ch) {
  if (n < 0 || n > kMaxSteps) return false;
  ch->n = n;
  for (int s = 0; s < kMaxSteps; ++s) {
    ch->op[s] = s < n ? ops[s] : 0;
    ch->p[s] = s < n ? poffs[s] : 0;
    ch->c[s] = s < n ? coffs[s] : 0;
    if (s >= n) continue;
    if (ops[s] < kExposure || ops[s] > kCcm) return false;
    if ((ops[s] == kAwb || ops[s] == kCcm) && C != 3) return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// stencil segments
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int op_radius(int op) {
  return op == kNlm ? 4 : op == kSharpen ? 1 : 2;
}

// The shared-memory plane layout of one instance, in floats: the window
// (C channels a pixel; nlm on RGB: a float4 a pixel, so the sums read a
// pixel at once), a luminance plane (nlm, sharpen) with row pitch
// LumPitch, and for nlm the weights [shift][pixel]: NLM's planes are the
// NLM tile's (isp::NlmTile in nlm_tile.cuh); then the gamma LUT.
template <int kOp, int kC, int TH, int TW>
struct Layout {
  static constexpr int R = op_radius(kOp);
  static constexpr int WY = TH + 2 * R, WX = TW + 2 * R;   // window side
  static constexpr int kPix = WY * WX;
  static constexpr int LumPitch = isp::lum_pitch(WX);
  static constexpr bool kLum = kOp == kNlm || kOp == kSharpen;
  static constexpr int kWinC = kOp == kNlm ? isp::nlm_win_c(kC) : kC;
  static constexpr int kWin = 0;
  static constexpr int kAux = kPix * kWinC;
  static constexpr int kWts = kAux + (kLum ? WY * LumPitch : 0);
  static constexpr int WPitch = TH * TW + 1;
  static constexpr int kLutAt =
      kWts + (kOp == kNlm ? isp::kNlmShifts * WPitch : 0);
  static constexpr int kFloats = kLutAt + kLut;     // the gamma LUT
  static constexpr int kThreads = kOp == kNlm ? isp::kNlmThreads : TH * TW;
  static constexpr int kCout = kOp == kDemosaic ? 3 : kC;
};

struct StencilArgs {
  const float* x;
  float* out;
  const float* pvec;
  const float* stats;
  const float* consts;
  int gamma_off;                // the gamma step's param in a pvec row, or -1
  int H, W, P, S, wpoff, wcoff, zero_pad;
  int tiles_x, tiles_y;
  FastDiv fx, fy;               // tiles_x, tiles_y
  Chain ch;
};

template <int kOp, int kC, int TH, int TW>
__global__ void __launch_bounds__(kMaxThreads, 4)
stencil_kernel(const StencilArgs a) {
  using Lay = Layout<kOp, kC, TH, TW>;
  constexpr int R = Lay::R, WX = Lay::WX, LP = Lay::LumPitch;
  extern __shared__ float smem[];
  float* win = smem + Lay::kWin;      // the prologue's output
  float* aux = smem + Lay::kAux;      // luminance (nlm) or Y (sharpen)
  // (frame, tile row, tile column) on gridDim.x, the column fastest
  const int blk = blockIdx.x;
  const int rest = a.fx.div(blk);
  const int b = a.fy.div(rest);
  const int y0 = (rest - b * a.tiles_y) * TH;
  const int x0 = (blk - rest * a.tiles_x) * TW;
  const int H = a.H, W = a.W;
  const float* pv = a.pvec + (int64_t)b * a.P;
  const float* st = a.stats + (int64_t)b * a.S;
  const float* img = a.x + (int64_t)b * H * W * kC;
  const float* wc = a.consts + a.wcoff;          // the window op's consts
  float* lb = nullptr;
  if (a.gamma_off >= 0) {
    lb = smem + Lay::kLutAt;
    gamma_lut_block(lb, pv[a.gamma_off]);
    __syncthreads();
  }

  for (int k = threadIdx.x; k < Lay::kPix; k += blockDim.x) {
    const int wy = k / WX, wx = k % WX;
    int yy = y0 - R + wy, xx = x0 - R + wx;
    float v[3] = {0.f, 0.f, 0.f};
    const bool inside =
        static_cast<unsigned>(yy) < static_cast<unsigned>(H) &&
        static_cast<unsigned>(xx) < static_cast<unsigned>(W);
    if (inside || !a.zero_pad) {
      if (!inside) {
        yy = isp::wrap_near(yy, H);
        xx = isp::wrap_near(xx, W);
      }
      const float* src = img + ((int64_t)yy * W + xx) * kC;
#pragma unroll
      for (int c = 0; c < kC; ++c) v[c] = src[c];
      apply_chain(a.ch, pv, st, a.consts, lb, v, kC);
    }
    if constexpr (Lay::kWinC == 4) {
      reinterpret_cast<float4*>(win)[k] = make_float4(v[0], v[1], v[2], 0.f);
    } else {
#pragma unroll
      for (int c = 0; c < kC; ++c) win[k * kC + c] = v[c];
    }
    if constexpr (kOp == kNlm) {   // luminance: ((c0 + c1) + c2) x 1/3f
      aux[wy * LP + wx] =
          kC == 1 ? v[0]
                  : __fmul_rn(__fadd_rn(__fadd_rn(v[0], v[1]), v[2]),
                              1.f / 3.f);
    } else if constexpr (kOp == kSharpen) {   // Y of YCbCr: matrix row 0
      aux[wy * LP + wx] = __fadd_rn(dot3(v, wc), wc[9]);
    }
  }
  __syncthreads();

  float* dst = a.out + (int64_t)b * H * W * Lay::kCout;
  if constexpr (kOp == kNlm) {
    // the NLM tile's weight and sum passes over the staged window
    using Tile = isp::NlmTile<kC, TH, TW>;
    static_assert(Tile::kLum == Lay::kAux && Tile::kWts == Lay::kWts &&
                      Tile::LumPitch == LP && Tile::WPitch == Lay::WPitch &&
                      Tile::kFloats == Lay::kLutAt,
                  "the stencil's NLM planes are the NLM tile's");
    const float h = __fadd_rn(__fmul_rn(0.2f, pv[a.wpoff]), 1e-3f);
    isp::nlm_weights<TH, TW, LP, Lay::WPitch>(aux, smem + Lay::kWts,
                                              __fmul_rn(h, h));
    __syncthreads();
    isp::nlm_sums<kC, TH, TW, Lay::WPitch>(win, smem + Lay::kWts, y0, x0, H,
                                           W, dst);
    return;
  } else if constexpr (kOp == kDemosaic) {
    // the demosaic tile's pass over the staged window
    using Tile = isp::DemosaicTile<TH, TW>;
    static_assert(Tile::WX == WX && Tile::kPix == Lay::kPix &&
                      Lay::kWin == 0 && Lay::kThreads == Tile::kThreads,
                  "the stencil's demosaic window is the demosaic tile's");
    isp::demosaic_tile<TH, TW>(win, y0, x0, H, W, dst);
  } else {
    for (int p = threadIdx.x; p < TH * TW; p += blockDim.x) {
      const int ty = p / TW, tx = p % TW;
      const int y = y0 + ty, xo = x0 + tx;
      if (y >= H || xo >= W) continue;
      const int cidx = (ty + R) * WX + tx + R;   // the pixel in the window
      float o[3];
      if constexpr (kOp == kDpc) {   // 8 same-colour neighbours at distance 2
        const float t = pv[a.wpoff];
        const float nt = -t;
        const float c = win[cidx];
        float nb[8];
        int k = 0;
#pragma unroll
        for (int dy = -2; dy <= 2; dy += 2)
#pragma unroll
          for (int dx = -2; dx <= 2; dx += 2)
            if (dy != 0 || dx != 0) nb[k++] = win[cidx - dy * WX - dx];
        bool hot = true, dead = true;
        float sum = nb[0], mn = nb[0], mx = nb[0];
#pragma unroll
        for (k = 0; k < 8; ++k) {
          const float d = __fsub_rn(c, nb[k]);
          hot = hot && d > t;
          dead = dead && d < nt;
          if (k > 0) sum = __fadd_rn(sum, nb[k]);
          mn = nb[k] < mn ? nb[k] : mn;
          mx = nb[k] > mx ? nb[k] : mx;
        }
        const float med =
            __fmul_rn(__fsub_rn(__fsub_rn(sum, mn), mx), 1.f / 6.f);
        o[0] = (hot || dead) ? med : c;
      } else {                        // sharpen: matrix, offset, inverse
        const float* off = wc + 9;
        const float* inv = wc + 12;
        const int lidx = (ty + R) * LP + tx + R;
        const float yc = aux[lidx];
        const float blur = __fmul_rn(
            __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(yc, aux[lidx - LP]),
                                          aux[lidx + LP]),
                                aux[lidx - 1]),
                      aux[lidx + 1]),
            1.f / 5.f);
        const float* v = win + cidx * 3;
        float e[3];
        const float y2 = isp::clip01(
            __fadd_rn(yc, __fmul_rn(pv[a.wpoff], __fsub_rn(yc, blur))));
        e[0] = __fsub_rn(y2, off[0]);
        e[1] = __fsub_rn(__fadd_rn(dot3(v, wc + 3), off[1]), off[1]);
        e[2] = __fsub_rn(__fadd_rn(dot3(v, wc + 6), off[2]), off[2]);
#pragma unroll
        for (int d = 0; d < 3; ++d) o[d] = isp::clip01(dot3(e, inv + 3 * d));
      }
      float* out = dst + ((int64_t)y * W + xo) * Lay::kCout;
#pragma unroll
      for (int c = 0; c < Lay::kCout; ++c) out[c] = o[c];
    }
  }
}

// One instance's launch: the plan's threads and shared bytes must be the
// instance's; above 48 KB the kernel opts in once per device.
template <int kOp, int kC, int TH, int TW>
int launch_stencil(const StencilArgs& a, int64_t blocks, int threads,
                   int smem, cudaStream_t s) {
  using Lay = Layout<kOp, kC, TH, TW>;
  const int want = Lay::kFloats * static_cast<int>(sizeof(float));
  if (threads != Lay::kThreads || smem != want)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = stencil_kernel<kOp, kC, TH, TW>;
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

// The instance of window op kOp on C channels for the plan's tile; the
// tiles here are kernels/isp_fused.py's LIGHT_TILES and NLM_TILES.
template <int kOp, int kC>
int launch_tile(const StencilArgs& a, int th, int tw, int64_t blocks,
                int threads, int smem, cudaStream_t s) {
  if constexpr (kOp == kNlm) {
    if (th == 16 && tw == 16)
      return launch_stencil<kOp, kC, 16, 16>(a, blocks, threads, smem, s);
    if (th == 8 && tw == 16)
      return launch_stencil<kOp, kC, 8, 16>(a, blocks, threads, smem, s);
    if (th == 8 && tw == 8)
      return launch_stencil<kOp, kC, 8, 8>(a, blocks, threads, smem, s);
  } else {
    if (th == 8 && tw == 32)
      return launch_stencil<kOp, kC, 8, 32>(a, blocks, threads, smem, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int isp_pointwise_launch(const float* x, float* out,
                                    const float* pvec, const float* stats,
                                    const float* consts, int gamma_off,
                                    int B, int H, int W, int C, int P, int S,
                                    int n, const int* ops, const int* poffs,
                                    const int* coffs, int tile, int threads,
                                    int smem, void* stream) {
  PointwiseArgs a;
  if ((C != 1 && C != 3) || !make_chain(n, ops, poffs, coffs, C, &a.ch))
    return static_cast<int>(cudaErrorInvalidValue);
  // the plan's tile, threads and shared bytes (pointwise_plan)
  const int want = pointwise_floats(tile, C, P, S) *
                   static_cast<int>(sizeof(float));
  if (B < 1 || H < 1 || W < 1 || P < 0 || S < 0 || gamma_off >= P ||
      (tile != 256 && tile != 512 && tile != 1024) ||
      threads != kPointwiseThreads || smem != want || want > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = ((int64_t)H * W + tile - 1) / tile;
  const int64_t blocks = tiles * B;
  if (blocks >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = x;
  a.out = out;
  a.pvec = pvec;
  a.stats = stats;
  a.consts = consts;
  a.gamma_off = gamma_off;
  a.P = P;
  a.S = S;
  a.tile = tile;
  a.tiles = static_cast<int>(tiles);
  a.span = (int64_t)H * W * C;
  a.ft = FastDiv(static_cast<uint32_t>(tiles));
  auto kern = C == 1 ? pointwise_kernel<1> : pointwise_kernel<3>;
  kern<<<static_cast<unsigned>(blocks), threads, want,
         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int isp_stencil_launch(const float* x, float* out,
                                  const float* pvec, const float* stats,
                                  const float* consts, int gamma_off,
                                  int B, int H, int W, int Cin, int Cout,
                                  int P, int S, int n, const int* ops,
                                  const int* poffs, const int* coffs,
                                  int wop, int wpoff, int wcoff, int r,
                                  int zero_pad, int th, int tw, int threads,
                                  int smem, void* stream) {
  StencilArgs a;
  bool ok = (Cin == 1 || Cin == 3) && make_chain(n, ops, poffs, coffs, Cin,
                                                 &a.ch);
  switch (wop) {
    case kDpc: ok = ok && r == 2 && Cin == 1 && Cout == 1; break;
    case kDemosaic: ok = ok && r == 2 && Cin == 1 && Cout == 3; break;
    case kNlm: ok = ok && r == 4 && Cout == Cin; break;
    case kSharpen: ok = ok && r == 1 && Cin == 3 && Cout == 3; break;
    default: ok = false;
  }
  if (!ok || B < 1 || H < 1 || W < 1 || th < 1 || tw < 1 ||
      gamma_off >= P)
    return static_cast<int>(cudaErrorInvalidValue);
  a.tiles_x = (W + tw - 1) / tw;
  a.tiles_y = (H + th - 1) / th;
  const int64_t blocks = (int64_t)a.tiles_x * a.tiles_y * B;
  if (blocks >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = x;
  a.out = out;
  a.pvec = pvec;
  a.stats = stats;
  a.consts = consts;
  a.gamma_off = gamma_off;
  a.H = H;
  a.W = W;
  a.P = P;
  a.S = S;
  a.wpoff = wpoff;
  a.wcoff = wcoff;
  a.zero_pad = zero_pad;
  a.fx = FastDiv(a.tiles_x);
  a.fy = FastDiv(a.tiles_y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (wop) {
    case kDpc:
      return launch_tile<kDpc, 1>(a, th, tw, blocks, threads, smem, s);
    case kDemosaic:
      return launch_tile<kDemosaic, 1>(a, th, tw, blocks, threads, smem, s);
    case kSharpen:
      return launch_tile<kSharpen, 3>(a, th, tw, blocks, threads, smem, s);
    default:
      return Cin == 1
                 ? launch_tile<kNlm, 1>(a, th, tw, blocks, threads, smem, s)
                 : launch_tile<kNlm, 3>(a, th, tw, blocks, threads, smem, s);
  }
}
