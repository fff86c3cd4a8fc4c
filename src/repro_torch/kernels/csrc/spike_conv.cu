// Activity-gated spike convolution as a GEMM over the spike-im2col patch
// matrix: out[M, N] = patches[M, K] @ wmat[K, N].
//
// Replaces the TPU kernel spike_conv_pallas (src/repro/kernels/spike_conv.py):
// under the "mask" gate the per-(128-row, 128-K) occupancy mask is computed
// once per call by a plain torch reduction (occupancy_mask) and read here,
// one int per tile; a tile whose bit is 0 skips its loads and multiply-adds.
// The "inline" gate checks each (64-row, 128-K) tile in the kernel instead;
// "none" is the mask gate on an all-ones mask.
//
// What bounds it on the H100: the patch matrix.  At the main path's widths
// the ten convs of a tick read ~118 MB of materialised patches at B=8 for
// ~2.5 GMAC, ~21 fp32 operations per byte against the card's ~20 for fp32
// CUDA cores (67 TFLOP/s over 3.35 TB/s): close to balanced, bytes first.
// The design streams each patch element once per 64-column output tile
// (once in all for N <= 64) and skips silent tiles' bytes, not just their
// arithmetic.  Implicit im2col and tensor cores are later work.
#include "gated_gemm.cuh"

// gate: kGateMask reads occ (an all-ones occ is the "none" gate),
// kGateInline checks each tile in the kernel and ignores occ
extern "C" int spike_conv_launch(const float* patches, const float* wmat,
                                 const int32_t* occ, int occ_cols,
                                 float* out, int M, int K, int N, int gate,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gate == repro::kGateInline)
    return repro::launch_gated_gemm<repro::kGateInline>(
        patches, wmat, occ, occ_cols, out, M, K, N, s);
  if (gate != repro::kGateMask)
    return static_cast<int>(cudaErrorInvalidValue);
  return repro::launch_gated_gemm<repro::kGateMask>(
      patches, wmat, occ, occ_cols, out, M, K, N, s);
}
