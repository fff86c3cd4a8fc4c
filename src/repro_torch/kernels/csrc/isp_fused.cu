// Fused ISP segments: a chain of pointwise stages over a frame, or the
// same chain as the prologue of a stencil stage, in one pass.
//
//   isp_pointwise_launch: x [B, H, W, C] -> out [B, H, W, C]
//   isp_stencil_launch:   x [B, H, W, Cin] -> out [B, H, W, Cout]
// (C = 1 for a Bayer mosaic, 3 for RGB), with pvec [B, P] (the planner's
// packed stage parameters, one row per frame), stats [B, S] (a reduce
// stage's global statistics), consts (the stages' array constants,
// flattened) and lut [B, 256] (the gamma stage's per-frame LUT, built by
// the plain gamma_lut on the device, or null).
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
// pointwise: one thread per pixel, all channels.
// stencil: one block per (16x16 output tile, frame), all on gridDim.x
// (any batch up to 2^31 - 1 blocks in all).  Its threads read
// the tile's (16+2r)^2 window straight from the frame, wrapping the
// indices (pad "wrap", the reference's cyclic roll) or reading zero
// outside the frame (pad "zero", the reference's SAME padding, applied
// after the prologue as the per-stage path pads the prologue's output):
// no padded copy.  Each window pixel gets the prologue chain once, with
// its own frame's parameters, into shared memory (at r = 4 and 3
// channels 6.9 KB, plus a luminance plane for NLM and sharpen); then
// each thread computes its output pixel's window op from shared memory.
// Frames of any size: the ragged edge is guarded per pixel.
//
// What bounds it on the H100: bytes for the pointwise chains, dpc,
// demosaic and sharpen (one read of the input, one write of the output;
// the halo re-reads hit L1/L2); operations for NLM (49 weights with an
// exp each per pixel).  At [8, 64, 64] every segment moves under 1 MB,
// so a launch's latency dominates.
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

#include "isp_common.cuh"

namespace {

constexpr int kMaxSteps = 8;      // kernels/isp_fused.py MAX_STEPS
constexpr int kTile = 16;         // output tile side of a stencil block
constexpr int kMaxR = 4;          // the widest halo (NLM)
constexpr int kWinMax = kTile + 2 * kMaxR;
constexpr int kThreads = kTile * kTile;
constexpr int kLut = 256;

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

__global__ void pointwise_kernel(const float* __restrict__ x,
                                 float* __restrict__ out,
                                 const float* __restrict__ pvec,
                                 const float* __restrict__ stats,
                                 const float* __restrict__ consts,
                                 const float* __restrict__ lut, int64_t total,
                                 int HW, int C, int P, int S, Chain ch) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t b = i / HW;
  float v[3];
  for (int c = 0; c < C; ++c) v[c] = x[i * C + c];
  apply_chain(ch, pvec + b * P, stats + b * S, consts,
              lut ? lut + b * kLut : nullptr, v, C);
  for (int c = 0; c < C; ++c) out[i * C + c] = v[c];
}

__global__ void __launch_bounds__(kThreads)
stencil_kernel(const float* __restrict__ x, float* __restrict__ out,
               const float* __restrict__ pvec,
               const float* __restrict__ stats,
               const float* __restrict__ consts,
               const float* __restrict__ lut, int H, int W, int Cin,
               int Cout, int P, int S, Chain ch, int wop, int wpoff,
               int wcoff, int r, int zero_pad) {
  __shared__ float win[kWinMax * kWinMax * 3];   // the prologue's output
  __shared__ float aux[kWinMax * kWinMax];       // luminance (nlm, sharpen)
  // (frame, tile row, tile column) on gridDim.x, the column fastest
  const int tiles_x = (W + kTile - 1) / kTile;
  const int tiles_y = (H + kTile - 1) / kTile;
  const int rest = (int)(blockIdx.x / tiles_x);
  const int b = rest / tiles_y;
  const int y0 = (rest - b * tiles_y) * kTile;
  const int x0 = (int)(blockIdx.x - rest * tiles_x) * kTile;
  const int ws = kTile + 2 * r;                  // window side
  const float* pv = pvec + (int64_t)b * P;
  const float* st = stats + (int64_t)b * S;
  const float* lb = lut ? lut + (int64_t)b * kLut : nullptr;
  const float* img = x + (int64_t)b * H * W * Cin;
  const float* wc = consts + wcoff;              // the window op's consts

  for (int k = threadIdx.x; k < ws * ws; k += blockDim.x) {
    int yy = y0 - r + k / ws, xx = x0 - r + k % ws;
    float v[3] = {0.f, 0.f, 0.f};
    const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
    if (inside || !zero_pad) {
      yy = isp::wrap(yy, H);
      xx = isp::wrap(xx, W);
      const float* src = img + ((int64_t)yy * W + xx) * Cin;
      for (int c = 0; c < Cin; ++c) v[c] = src[c];
      apply_chain(ch, pv, st, consts, lb, v, Cin);
    }
    for (int c = 0; c < Cin; ++c) win[k * Cin + c] = v[c];
    if (wop == kNlm) {      // luminance(): ((c0 + c1) + c2) x float32(1/3)
      aux[k] = Cin == 1 ? v[0]
                        : __fmul_rn(__fadd_rn(__fadd_rn(v[0], v[1]), v[2]),
                                    1.f / 3.f);
    } else if (wop == kSharpen) {   // Y of YCbCr: the matrix's first row
      aux[k] = __fadd_rn(dot3(v, wc), wc[9]);
    }
  }
  __syncthreads();

  const int ty = threadIdx.x / kTile, tx = threadIdx.x % kTile;
  const int y = y0 + ty, xo = x0 + tx;
  if (y >= H || xo >= W) return;
  const int cidx = (ty + r) * ws + tx + r;       // the pixel in the window
  float o[3];
  switch (wop) {
    case kDpc: {            // 8 same-colour neighbours at distance 2
      const float t = pv[wpoff];
      const float nt = -t;
      const float c = win[cidx];
      float nb[8];
      int k = 0;
      for (int dy = -2; dy <= 2; dy += 2)
        for (int dx = -2; dx <= 2; dx += 2)
          if (dy != 0 || dx != 0) nb[k++] = win[cidx - dy * ws - dx];
      bool hot = true, dead = true;
      float sum = nb[0], mn = nb[0], mx = nb[0];
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
      break;
    }
    case kDemosaic: {       // the Bayer phase of the absolute coordinates
      auto at = [&](int dy, int dx) {
        return win[cidx + (dy - 2) * ws + dx - 2];
      };
      isp::mhc_rgb((y % 2) == 0, (xo % 2) == 0, win[cidx], at, o);
      break;
    }
    case kNlm: {            // h = 1e-3 + 0.2 strength
      const float h = __fadd_rn(__fmul_rn(0.2f, pv[wpoff]), 1e-3f);
      const int base = ty * ws + tx;             // the pixel at (-4, -4)
      auto lum = [&](int ry, int cx) { return aux[base + ry * ws + cx]; };
      auto pix = [&](int ry, int cx) {
        return win + (base + ry * ws + cx) * Cin;
      };
      isp::nlm_pixel(lum, pix, __fmul_rn(h, h), Cin, o);
      break;
    }
    case kSharpen: {        // luma sharpening: matrix, offset, inverse
      const float* off = wc + 9;
      const float* inv = wc + 12;
      const float yc = aux[cidx];
      const float blur = __fmul_rn(
          __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(yc, aux[cidx - ws]),
                                        aux[cidx + ws]),
                              aux[cidx - 1]),
                    aux[cidx + 1]),
          1.f / 5.f);
      const float* v = win + cidx * 3;
      float e[3];
      const float y2 = isp::clip01(
          __fadd_rn(yc, __fmul_rn(pv[wpoff], __fsub_rn(yc, blur))));
      e[0] = __fsub_rn(y2, off[0]);
      e[1] = __fsub_rn(__fadd_rn(dot3(v, wc + 3), off[1]), off[1]);
      e[2] = __fsub_rn(__fadd_rn(dot3(v, wc + 6), off[2]), off[2]);
      for (int d = 0; d < 3; ++d) o[d] = isp::clip01(dot3(e, inv + 3 * d));
      break;
    }
    default:
      return;
  }
  float* dst = out + (((int64_t)b * H + y) * W + xo) * Cout;
  for (int c = 0; c < Cout; ++c) dst[c] = o[c];
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

}  // namespace

extern "C" int isp_pointwise_launch(const float* x, float* out,
                                    const float* pvec, const float* stats,
                                    const float* consts, const float* lut,
                                    int B, int H, int W, int C, int P, int S,
                                    int n, const int* ops, const int* poffs,
                                    const int* coffs, void* stream) {
  Chain ch;
  if ((C != 1 && C != 3) || !make_chain(n, ops, poffs, coffs, C, &ch))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int64_t total = (int64_t)B * H * W;
  const int64_t blocks = (total + threads - 1) / threads;
  pointwise_kernel<<<(unsigned)blocks, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      x, out, pvec, stats, consts, lut, total, H * W, C, P, S, ch);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int isp_stencil_launch(const float* x, float* out,
                                  const float* pvec, const float* stats,
                                  const float* consts, const float* lut,
                                  int B, int H, int W, int Cin, int Cout,
                                  int P, int S, int n, const int* ops,
                                  const int* poffs, const int* coffs,
                                  int wop, int wpoff, int wcoff, int r,
                                  int zero_pad, void* stream) {
  Chain ch;
  bool ok = (Cin == 1 || Cin == 3) && make_chain(n, ops, poffs, coffs, Cin,
                                                 &ch);
  switch (wop) {
    case kDpc: ok = ok && r == 2 && Cin == 1 && Cout == 1; break;
    case kDemosaic: ok = ok && r == 2 && Cin == 1 && Cout == 3; break;
    case kNlm: ok = ok && r == 4 && Cout == Cin; break;
    case kSharpen: ok = ok && r == 1 && Cin == 3 && Cout == 3; break;
    default: ok = false;
  }
  const int64_t blocks = (int64_t)((W + kTile - 1) / kTile) *
                         ((H + kTile - 1) / kTile) * B;
  if (!ok || B < 1 || blocks >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  stencil_kernel<<<(unsigned)blocks, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      x, out, pvec, stats, consts, lut, H, W, Cin, Cout, P, S, ch, wop, wpoff,
      wcoff, r, zero_pad);
  return static_cast<int>(cudaGetLastError());
}
