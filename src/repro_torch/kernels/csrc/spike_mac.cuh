// The multiply-add steps of the spiking convs, shared by the per-layer
// kernels (spike_conv.cu, gated_gemm.cuh, spike_conv_lif.cu,
// spike_dwconv.cu) and the fused backbone segment (backbone_segment.cu),
// so the routes give the same conv values bit for bit.
//
//   GEMM conv: K in canonical 128-wide blocks, in order; a block's
//   partial is an fmaf chain from +0 over its k in order (kblock_fma),
//   then added to the running sum (kblock_add).  A zero activation adds
//   an exact zero to the chain (finite weights), so skipping it -- one
//   element, a tile or a whole block -- never changes the sum.
//   Depthwise conv: taps in (kh, kw) order from +0, one round-to-nearest
//   multiply and one add each (dw_tap), no FMA contraction.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int kCanonicalK = 128;   // canonical accumulation block

__device__ __forceinline__ float kblock_fma(float a, float w, float part) {
  return fmaf(a, w, part);
}

__device__ __forceinline__ float kblock_add(float acc, float part) {
  return __fadd_rn(acc, part);
}

__device__ __forceinline__ float dw_tap(float acc, float v, float w) {
  return __fadd_rn(acc, __fmul_rn(v, w));
}

}  // namespace repro
