// Tile-skip spike matmul: y[M, N] = x[M, K] @ w[K, N] for 0/1 spike x.
//
// Replaces the TPU kernel spike_matmul_pallas
// (src/repro/kernels/spike_matmul.py): there an all-zero (bm, bk) tile of x
// skips its MXU pass after an in-kernel jnp.any; here each block checks its
// own 64-row x 128-K slice of x with __syncthreads_or and skips the slice's
// loads and multiply-adds when it holds no spike (the "inline" gate).
//
// What bounds it on the H100: on the main path (ctrl_out, [5B, 64] @ [64, 8])
// the work is a few kilobytes, so one launch is bounded by launch latency,
// not by bytes or operations; the design keeps it to one launch with no
// host-side mask pass.  At large shapes it is the GEMM of spike_conv.cu
// plus one extra read of each gated x tile.
#include "gated_gemm.cuh"

extern "C" int spike_matmul_launch(const float* x, const float* w, float* out,
                                   int M, int K, int N, void* stream) {
  return repro::launch_gated_gemm<repro::kGateInline>(
      x, w, nullptr, 0, out, M, K, N, static_cast<cudaStream_t>(stream));
}
