// Activity-gated depthwise spiking conv, SAME padding:
// out[n, ho, wo, c] = sum over taps t = i*kw + j of
//                     x[n, ho*s + i - pad_h, wo*s + j - pad_w, c] * w[t, c].
//
// Replaces the TPU kernel spike_dwconv_pallas (src/repro/kernels/
// spike_conv.py): there a program takes a block of rows of the
// materialised [M, taps, C] patch tensor (nine copies of the activation)
// and skips a whole tap slab whose occupancy bit is clear.  Here the
// kernel reads the folded activation [N, H, W, C] itself and indexes the
// taps with the reference's SAME padding (pad_* is the low side,
// total // 2: for stride 2 on an even extent that is 0 low, 1 high), so
// no patch tensor is built.
//
// What bounds it on the H100: bytes, and at MobileNet's sizes the fixed
// time of a launch.  At full width (batch 8, T = 5) the four stride-2
// layers read 30.1 MB and write 7.5 MB, dw0 [40, 64, 64, 32] alone
// 21 MB + 5.2 MB, for ~2 operations per byte; dw1-dw3 move 1.6-6.5 MB,
// a few microseconds at 3.35 TB/s.
//
// Design: shared-memory halo tiles.  A block owns one frame, a band of bh
// output rows, a band of bw output columns and a group of cg channels
// (spike_dwconv.py dw_tiles); all four are folded onto gridDim.x, decoded
// once a block by multiply-and-shift division in 32 bits (any frame count
// the int range holds), offsets in size_t.  The band's input rows with
// their halo, zero outside the image, are staged once into shared memory
// by cp.async (16 bytes a copy where C % 4 == 0 and x, w, out are 16-byte
// aligned, else 4), one commit group per output row, so the block
// computes row r while the rows of r + 1.. are still in flight.  The
// threads are cg / vec lanes (threadIdx.x: a channel quad, or a channel)
// by col_threads columns (threadIdx.y); a thread stages and computes
// every col_threads-th column of its lane, so a warp's copies, tap reads
// and stores are whole 128-byte lines of neighbouring channels, and it
// holds its lane's nine weights in registers.  A block reads each input
// pixel of its tile from global memory once; only the halo rows and
// columns are read again by the neighbouring band.  Other kernel sizes
// take the same tile with their weights read per tap.
//
// Rounding: taps accumulate in order t = i*kw + j from +0.0, one
// round-to-nearest multiply and one add each (__fmul_rn/__fadd_rn, no FMA
// contraction; spike_mac.cuh dw_tap), as the plain tap loop does: equal
// bits on any input.  Every tap is added, the zero padding too, as the
// plain loop does.
#include <cuda_runtime.h>
#include <stdint.h>

#include "spike_mac.cuh"

namespace {

constexpr int kMaxThreads = 256;     // threads a block at most
constexpr int kMaxBand = 8;          // output rows a block at most
constexpr int kMaxSmem = 48 * 1024;  // shared memory a block, bytes

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int V>
struct Lane;                         // V channels of one pixel
template <>
struct Lane<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static T lds(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  // 16 bytes global -> shared, zero-filled where !ok
  __device__ static void stage(float* dst, const float* src, bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
  }
  __device__ static T tap(T acc, T v, T w) {
    return make_float4(repro::dw_tap(acc.x, v.x, w.x),
                       repro::dw_tap(acc.y, v.y, w.y),
                       repro::dw_tap(acc.z, v.z, w.z),
                       repro::dw_tap(acc.w, v.w, w.w));
  }
};
template <>
struct Lane<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static T load(const float* p) { return __ldg(p); }
  __device__ static T lds(const float* p) { return *p; }
  __device__ static void stage(float* dst, const float* src, bool ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0));
  }
  __device__ static T tap(T acc, T v, T w) { return repro::dw_tap(acc, v, w); }
};

// wait until at most `pending` of this thread's commit groups are in
// flight (the immediate of cp.async.wait_group, pending < kMaxBand)
__device__ __forceinline__ void wait_groups(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}

// x / d for 0 <= x < 2^31 by a multiply and a shift (the divisor's magic
// number made on the host), for the block's coordinates
struct FastDiv {
  uint32_t d, m, s;
  FastDiv() = default;
  explicit FastDiv(uint32_t div) : d(div), s(0) {
    while ((uint64_t(1) << s) < d) ++s;
    m = static_cast<uint32_t>(
        ((uint64_t(1) << 32) * ((uint64_t(1) << s) - d)) / d + 1);
  }
  __device__ __forceinline__ int div(int x) const {
    return static_cast<int>((__umulhi(static_cast<uint32_t>(x), m) +
                             static_cast<uint32_t>(x)) >> s);
  }
};

struct DwArgs {
  const float* x;
  const float* w;
  float* out;
  int H, W, C, Ho, Wo, kh, kw, stride, pad_h, pad_w;
  int cg, bh, bw;                    // channels, output rows, columns a block
  FastDiv groups, col_bands, blocks_per_frame;
};

// K: the kernel size (square) when known at compile time, 0 for runtime
template <int V, int K>
__global__ void __launch_bounds__(kMaxThreads)
dwconv_halo_kernel(const DwArgs a) {
  using L = Lane<V>;
  using T = typename L::T;
  extern __shared__ __align__(16) float tile[];
  // block -> (frame, row band, column band, channel group), groups fastest
  const int n = a.blocks_per_frame.div(blockIdx.x);
  int r = blockIdx.x - n * static_cast<int>(a.blocks_per_frame.d);
  const int rg = a.groups.div(r);
  const int g = r - rg * static_cast<int>(a.groups.d);
  const int band = a.col_bands.div(rg);
  const int cb = rg - band * static_cast<int>(a.col_bands.d);
  const int c0 = g * a.cg, cw = min(a.cg, a.C - c0);   // this group's C
  const int ho0 = band * a.bh, wo0 = cb * a.bw;
  const int bh = min(a.bh, a.Ho - ho0), bw = min(a.bw, a.Wo - wo0);
  const int kh = K ? K : a.kh, kw = K ? K : a.kw, s = a.stride;
  const int hi0 = ho0 * s - a.pad_h, wi0 = wo0 * s - a.pad_w;
  const int cols = (bw - 1) * s + kw;          // the tile's input columns
  // thread (lane q, first column col0); columns go by `step`, and the
  // lanes past a ragged last group's only take part in the barriers
  const int q = threadIdx.x, col0 = threadIdx.y, step = blockDim.y;
  const bool active = q < cw / V;
  const float* xn =
      a.x + static_cast<size_t>(n) * a.H * a.W * a.C + c0 + q * V;
  float* tq = tile + q * V;                    // tile [rows][cols][cw]

  // stage: output row o's new input rows as commit group o
  for (int o = 0; o < bh; ++o) {
    const int lo = o == 0 ? 0 : (o - 1) * s + kh, hi = o * s + kh;
    for (int ri = lo; active && ri < hi; ++ri) {
      const int h = hi0 + ri;
      const bool row_ok = h >= 0 && h < a.H;
      const float* xr =
          xn + static_cast<size_t>(row_ok ? h : 0) * a.W * a.C;
      for (int c = col0; c < cols; c += step) {
        const int wi = wi0 + c;
        const bool ok = row_ok && wi >= 0 && wi < a.W;
        L::stage(tq + (ri * cols + c) * cw,
                 ok ? xr + static_cast<size_t>(wi) * a.C : a.x, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  const float* wq = a.w + c0 + q * V;
  T wt[K > 0 ? K * K : 1];
  if constexpr (K > 0) {
#pragma unroll
    for (int t = 0; t < K * K; ++t) wt[t] = L::load(wq + t * a.C);
  }
  T* dst = reinterpret_cast<T*>(
      a.out + ((static_cast<size_t>(n) * a.Ho + ho0) * a.Wo + wo0) * a.C +
      c0 + q * V);
  for (int o = 0; o < bh; ++o) {
    wait_groups(bh - 1 - o);
    __syncthreads();
    for (int wo = col0; active && wo < bw; wo += step) {
      const float* px = tq + (o * s * cols + wo * s) * cw;
      T acc = L::zero();
      if constexpr (K > 0) {
#pragma unroll
        for (int i = 0; i < K; ++i)
#pragma unroll
          for (int j = 0; j < K; ++j)
            acc = L::tap(acc, L::lds(px + (i * cols + j) * cw), wt[i * K + j]);
      } else {
        for (int i = 0; i < kh; ++i)
          for (int j = 0; j < kw; ++j)
            acc = L::tap(acc, L::lds(px + (i * cols + j) * cw),
                         L::load(wq + (i * kw + j) * a.C));
      }
      dst[(static_cast<size_t>(o) * a.Wo + wo) * a.C / V] = acc;
    }
  }
}

}  // namespace

// x [N, H, W, C], w [kh, kw, 1, C], out [N, Ho, Wo, C]; the tile from
// spike_dwconv.py dw_tiles: vec floats a lane (4 or 1), cg channels, bh
// output rows and bw output columns a block, cg / vec x col_threads
// threads a block.
extern "C" int spike_dwconv_launch(const float* x, const float* w, float* out,
                                   int N, int H, int W, int C, int Ho, int Wo,
                                   int kh, int kw, int stride, int pad_h,
                                   int pad_w, int vec, int cg, int bh, int bw,
                                   int col_threads, void* stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if ((vec != 4 && vec != 1) || (vec == 4 && (C % 4 != 0 || !aligned)) ||
      cg < vec || cg % vec != 0 || col_threads < 1 ||
      cg / vec * col_threads > kMaxThreads || bh < 1 ||
      bh > kMaxBand || bw < 1 || stride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  DwArgs a;
  a.x = x;
  a.w = w;
  a.out = out;
  a.H = H;
  a.W = W;
  a.C = C;
  a.Ho = Ho;
  a.Wo = Wo;
  a.kh = kh;
  a.kw = kw;
  a.stride = stride;
  a.pad_h = pad_h;
  a.pad_w = pad_w;
  a.cg = cg;
  a.bh = bh;
  a.bw = bw;
  const int groups = (C + cg - 1) / cg, col_bands = (Wo + bw - 1) / bw;
  const int64_t per_frame =
      (int64_t)groups * col_bands * ((Ho + bh - 1) / bh);
  const int64_t smem = (int64_t)((bh - 1) * stride + kh) *
                       ((bw - 1) * stride + kw) * (C < cg ? C : cg) * 4;
  if (N * per_frame >= (int64_t(1) << 31) || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  a.groups = FastDiv(groups);
  a.col_bands = FastDiv(col_bands);
  a.blocks_per_frame = FastDiv((uint32_t)per_frame);
  const int blocks = (int)(N * per_frame);
  const dim3 threads(cg / vec, col_threads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool k3 = kh == 3 && kw == 3;
  if (vec == 4 && k3)
    dwconv_halo_kernel<4, 3><<<blocks, threads, smem, s>>>(a);
  else if (vec == 4)
    dwconv_halo_kernel<4, 0><<<blocks, threads, smem, s>>>(a);
  else if (k3)
    dwconv_halo_kernel<1, 3><<<blocks, threads, smem, s>>>(a);
  else
    dwconv_halo_kernel<1, 0><<<blocks, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
