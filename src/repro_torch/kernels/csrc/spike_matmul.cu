// Tile-skip spike matmul: y[M, N] = x[M, K] @ w[K, N] for 0/1 spike x.
//
// Replaces the TPU kernel spike_matmul_pallas
// (src/repro/kernels/spike_matmul.py): there an all-zero (bm, bk) tile of x
// skips its MXU pass after an in-kernel jnp.any.  Here two paths, chosen by
// shape in spike_matmul.py (matmul_path), give the same bits:
//
//   * "small" (M * N <= 4096, N <= 64; on the main path the control head's
//     ctrl_out, [5B, 64] @ [64, 8]): one block holds up to 64 rows and
//     1024 outputs whole, one thread per output.  Per canonical 128-wide K
//     block it stages x's rows (16-byte loads where K % 4 == 0 and x is
//     16-byte aligned; rows padded to 129 floats, so a warp's reads of
//     different rows hit different banks) and w's rows into shared memory,
//     notes which rows hold a spike, and a warp whose rows hold none skips
//     the block whole (a ballot).  At the head's shape the work is a few
//     kilobytes: one launch of one block is bounded by its latency, which
//     this path keeps to one staging pass and one K chain a thread.
//   * "tiled" (every other shape): gated_gemm.cuh's 64x64-tile GEMM with its
//     inline gate (each block checks its 64-row x 128-K slice of x with
//     __syncthreads_or).  It is also the bit oracle of spike_conv.cu on
//     materialised patches.
//
// Both sum each output in the canonical chain of spike_mac.cuh: per K
// block an fmaf chain from +0 over k in order (kblock_fma), then added to
// a sum that starts at +0 (kblock_add).  A skipped block or row adds an
// exact zero (finite weights), so the gates' granularity changes no bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gated_gemm.cuh"

namespace {

using repro::kCanonicalK;

constexpr int kSmallRows = 64;             // rows of x a block holds
constexpr int kSmallOutputs = 1024;        // outputs (threads) a block
constexpr int kSmallN = 64;                // columns at most
constexpr int kXStride = kCanonicalK + 1;  // padded row of the x slice
constexpr int kQuads = kCanonicalK / 4;    // 16-byte chunks of a K block

__global__ void __launch_bounds__(kSmallOutputs)
small_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int M, int K, int N, int rows,
                  int xvec, int wvec) {
  extern __shared__ float4 smem[];
  float* ws = reinterpret_cast<float*>(smem);  // [kCanonicalK][N]
  float* xs = ws + kCanonicalK * N;            // [rows][kXStride]
  __shared__ int live[2][kSmallRows];        // rows with a spike, by parity
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * rows;
  const int rl = min(rows, M - m0);          // this block's rows
  const int r = tid / N, n = tid - r * N;
  const bool valid = r < rl;
  const int rr = valid ? r : 0;
  if (tid < rows) live[0][tid] = 0;

  float acc = 0.f;
  for (int k0 = 0, it = 0; k0 < K; k0 += kCanonicalK, ++it) {
    const int kb = min(kCanonicalK, K - k0);
    int* now = live[it & 1];
    __syncthreads();  // the last K block's reads of xs, ws, flags done
    if (tid < rows) live[(it + 1) & 1][tid] = 0;
    if (xvec) {
      for (int e = tid; e < rl * kQuads; e += blockDim.x) {
        const int row = e / kQuads, c = (e % kQuads) * 4;
        if (c >= kb) continue;
        const float4 v = *reinterpret_cast<const float4*>(
            x + static_cast<size_t>(m0 + row) * K + k0 + c);
        float* d = xs + row * kXStride + c;
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
        if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
          now[row] = 1;
      }
    } else {
      for (int e = tid; e < rl * kCanonicalK; e += blockDim.x) {
        const int row = e / kCanonicalK, c = e % kCanonicalK;
        if (c >= kb) continue;
        const float v = x[static_cast<size_t>(m0 + row) * K + k0 + c];
        xs[row * kXStride + c] = v;
        if (v != 0.f) now[row] = 1;
      }
    }
    const float* wk = w + static_cast<size_t>(k0) * N;
    const int wn = kb * N;                   // w's rows k0..k0+kb, whole
    const int wn4 = wvec ? wn / 4 : 0;
    for (int e = tid; e < wn4; e += blockDim.x)
      reinterpret_cast<float4*>(ws)[e] =
          reinterpret_cast<const float4*>(wk)[e];
    for (int e = wn4 * 4 + tid; e < wn; e += blockDim.x) ws[e] = wk[e];
    __syncthreads();

    // gate: a warp skips the block when none of its rows holds a spike
    if (__any_sync(0xffffffffu, valid && now[rr] != 0)) {
      const float* xr = xs + rr * kXStride;
      float part = 0.f;
      for (int k = 0; k < kb; ++k)
        part = repro::kblock_fma(xr[k], ws[k * N + n], part);
      acc = repro::kblock_add(acc, part);
    }
  }
  if (valid) out[static_cast<size_t>(m0 + r) * N + n] = acc;
}

}  // namespace

// x [M, K], w [K, N], out [M, N].  rows > 0: the "small" path with that
// many rows a block (spike_matmul.py small_rows; rows <= 64, N <= 64,
// rows * N <= 1024); rows == 0: the "tiled" path.
extern "C" int spike_matmul_launch(const float* x, const float* w, float* out,
                                   int M, int K, int N, int rows,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0)
    return repro::launch_gated_gemm<repro::kGateInline>(x, w, nullptr, 0, out,
                                                        M, K, N, s);
  if (rows < 0 || rows > kSmallRows || N <= 0 || N > kSmallN ||
      rows * N > kSmallOutputs)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (rows * N + 31) / 32 * 32;
  const int blocks = (M + rows - 1) / rows;
  const size_t smem = sizeof(float) * (rows * kXStride + kCanonicalK * N);
  const int xvec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int wvec = reinterpret_cast<uintptr_t>(w) % 16 == 0;
  small_gemm_kernel<<<blocks, threads, smem, s>>>(x, w, out, M, K, N, rows,
                                                   xvec, wvec);
  return static_cast<int>(cudaGetLastError());
}
