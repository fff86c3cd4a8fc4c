// Tiled fp32 GEMM on CUDA cores with a per-tile activity gate: the
// spike-matmul kernel (in-kernel all-zero check), and on materialised
// patches the oracle of the spike-conv kernel (spike_conv.cu reads the
// folded spikes with the same accumulation order, as does the fused
// conv->LIF kernel, spike_conv_lif.cu).
//
//   C[M, N] = A[M, K] @ B[K, N]     row-major, fp32 in, fp32 out
//
// Accumulation follows the canonical-block contract of the plain version
// (repro_torch.core.layers.blocked_matmul): K is walked in 128-wide
// blocks, in order; each block's partial product is summed in its own
// registers and then added to the running sum.  A block whose gate is
// clear is skipped whole (no load, no multiply-add): its contribution is
// exact zeros, so gating never changes the result.
//
// Design: a 64x64 output tile per block of 256 threads, each thread
// owning a 4x4 register tile; A and B stream through shared memory in
// 16-deep K slices.  Ragged M, N and K edges are masked on load and
// store.  This is the simple, right first version: no tensor cores
// (parity is fp32, TF32 would round the weights), no wgmma/TMA, no
// implicit im2col.
//
// Grid: the 64-row tiles on gridDim.x (up to 2^31 - 1 of them, so any
// row count the int arguments hold), the 64-column tiles on gridDim.y
// (up to 65535, N <= 4,194,240).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "spike_mac.cuh"

namespace repro {

constexpr int kBM = 64;          // output rows per block
constexpr int kBN = 64;          // output cols per block
constexpr int kBKS = 16;         // K slice staged in shared memory
constexpr int kKBlock = kCanonicalK;  // canonical accumulation block
constexpr int kMaskBM = 128;     // occupancy-mask row granularity
constexpr int kThreads = 256;    // 16 x 16 threads, 4x4 outputs each

// activity gate of a (row tile, K block): a precomputed occupancy bit,
// an in-kernel any() over the tile, or none (every tile computed)
enum GateMode { kGateMask = 0, kGateInline = 1, kGateNone = 2 };

template <int GATE>
__global__ void __launch_bounds__(kThreads)
gated_gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  const int32_t* __restrict__ occ, int occ_cols,
                  float* __restrict__ C, int M, int K, int N) {
  __shared__ float As[kBKS][kBM + 4];   // A slice, transposed: As[k][m]
  __shared__ float Bs[kBKS][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int kblocks = (K + kKBlock - 1) / kKBlock;
  for (int kb = 0; kb < kblocks; ++kb) {
    const int k0 = kb * kKBlock;
    const int k1 = min(k0 + kKBlock, K);
    bool live;
    if (GATE == kGateMask) {
      // a 64-row tile lies inside one 128-row mask block
      live = occ[(m0 / kMaskBM) * occ_cols + kb] != 0;
    } else {
      // inline gate: any non-zero activation in A[m0:m0+64, k0:k1]
      int any = 0;
      for (int i = tid; i < kBM * kKBlock; i += kThreads) {
        const int r = i / kKBlock, c = i % kKBlock;
        const int m = m0 + r, k = k0 + c;
        if (m < M && k < k1 && A[(size_t)m * K + k] != 0.f) any = 1;
      }
      live = __syncthreads_or(any) != 0;
    }
    if (!live) continue;  // uniform across the block

    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;

    for (int ks = k0; ks < k1; ks += kBKS) {
      for (int i = tid; i < kBM * kBKS; i += kThreads) {
        const int kk = i % kBKS, mm = i / kBKS;
        const int m = m0 + mm, k = ks + kk;
        As[kk][mm] = (m < M && k < k1) ? A[(size_t)m * K + k] : 0.f;
      }
      for (int i = tid; i < kBKS * kBN; i += kThreads) {
        const int nn = i % kBN, kk = i / kBN;
        const int n = n0 + nn, k = ks + kk;
        Bs[kk][nn] = (n < N && k < k1) ? B[(size_t)k * N + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBKS; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            part[i][j] = kblock_fma(a[i], b[j], part[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = kblock_add(acc[i][j], part[i][j]);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) C[(size_t)m * N + n] = acc[i][j];
    }
  }
}

template <int GATE>
inline int launch_gated_gemm(const float* A, const float* B,
                             const int32_t* occ, int occ_cols, float* C,
                             int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  gated_gemm_kernel<GATE><<<grid, kThreads, 0, stream>>>(A, B, occ, occ_cols,
                                                          C, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro
