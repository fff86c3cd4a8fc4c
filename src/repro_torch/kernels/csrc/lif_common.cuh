// The instance-norm statistics and the normalise + affine + LIF step,
// shared by the per-op epilogue (norm_affine_lif.cu), the fused
// conv->LIF kernel (spike_conv_lif.cu) and the fused backbone segment
// (backbone_segment.cu), so all three give the same spikes from the same
// conv output.
//
// Statistics of one (b, c) over its rows i = t*HW + hw: each of
// kRowClasses classes (i mod kRowClasses) sums its rows in increasing i
// in double, then the classes are summed in class order and the total
// rounds once to float.  Normalise, affine and the LIF use
// round-to-nearest intrinsics in the plain version's order (no FMA
// contraction).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kRowClasses = 32;

// sum of the kRowClasses class sums cls[0], cls[stride], ..., in order
__device__ __forceinline__ double class_total(const double* cls,
                                              int stride) {
  double s = 0.0;
  for (int r = 0; r < kRowClasses; ++r) s += cls[r * stride];
  return s;
}

// the same total of class sums that other blocks of a thread-block
// cluster wrote to global memory: read from L2 (__ldcg), past an SM's L1
__device__ __forceinline__ double class_total_l2(const double* cls,
                                                 int stride) {
  double s = 0.0;
  for (int r = 0; r < kRowClasses; ++r) s += __ldcg(cls + r * stride);
  return s;
}

__device__ __forceinline__ float mean_of(double total, int64_t rows) {
  return (float)(total / (double)rows);
}

// one variance term, (y - mu)^2 in float, widened for the double sum
__device__ __forceinline__ double sq_dev(float y, float mu) {
  const float d = __fsub_rn(y, mu);
  return (double)__fmul_rn(d, d);
}

// 1 / sqrt(var + eps) from the variance's class total
__device__ __forceinline__ float inv_std(double total, int64_t rows,
                                         float eps) {
  const float var = (float)(total / (double)rows);
  return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
}

// one time step of one neuron: normalise y, affine, leak and integrate
// into u, fire, hard reset; returns the spike
__device__ __forceinline__ float norm_lif_step(float y, float mu, float r,
                                               float sc, float bi,
                                               float decay, float v_th,
                                               float v_reset, float& u) {
  float z = __fmul_rn(__fsub_rn(y, mu), r);
  z = __fadd_rn(__fmul_rn(z, sc), bi);
  u = __fadd_rn(__fadd_rn(__fmul_rn(decay, __fsub_rn(u, v_reset)), v_reset),
                z);
  const float s = (__fsub_rn(u, v_th) >= 0.f) ? 1.f : 0.f;
  u = __fadd_rn(__fmul_rn(u, __fsub_rn(1.f, s)), __fmul_rn(v_reset, s));
  return s;
}

}  // namespace repro
