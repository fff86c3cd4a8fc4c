// Spiking-conv epilogue: per-(b, c) instance norm over (T, HW), affine,
// then the T-step LIF with hard reset.  y[T, B, HW, C] -> spikes, same shape.
//
// Replaces the TPU kernel norm_affine_lif_pallas (src/repro/kernels/
// lif_scan.py, body norm_affine_lif_epilogue): there one program holds a
// batch element's whole [T, HW, C] slab in VMEM and reduces it in one pass.
// At full spiking-YOLO width that slab is [5, 1024, 32] f32 = 655 KB, far
// over the 227 KB of shared memory a Hopper block can have, so the slab is
// not kept on chip.  Instead one block owns (b, a group of 32 channels) and
// makes three passes over its slice:
//   1. the mean over (T, HW), per channel;
//   2. the variance of (y - mean), two-pass like the plain version's;
//   3. one thread per (hw, c) neuron runs normalise, affine and fire over T
//      with u in a register.
// The second and third reads hit L2 (a batch element's slice is <= 655 KB;
// the whole tensor at B=8 is 5.2 MB of the 50 MB L2).
//
// What bounds it on the H100: bytes -- y read once and spikes written once
// is the floor; the two re-reads come from L2.  Threads of a warp take 32
// consecutive channels of one row, so every load and store is one 128-byte
// line.
//
// Rounding (lif_common.cuh, shared with the fused spike_conv_lif.cu): the
// sums accumulate in double, then round once to float, so the statistics
// are at least as accurate as the plain version's float reductions;
// normalise, affine and LIF use round-to-nearest intrinsics in the plain
// version's order (no FMA contraction).  Spikes can therefore
// differ from the plain version only where its membrane lies within a few
// ulp of the threshold.
#include "lif_common.cuh"

namespace {

using repro::kRowClasses;
constexpr int kLanes = 32;   // channels per block (threadIdx.x)
constexpr int kRows = kRowClasses;   // row strides per block (threadIdx.y)

__global__ void __launch_bounds__(kLanes * kRows)
norm_affine_lif_kernel(const float* __restrict__ y,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       float* __restrict__ out, int T, int B, int HW, int C,
                       float decay, float v_th, float v_reset, float eps) {
  __shared__ double red[kRows][kLanes + 1];
  __shared__ float s_mu[kLanes], s_r[kLanes];
  const int lane = threadIdx.x, row = threadIdx.y;
  const int c = blockIdx.x * kLanes + lane;
  const int b = blockIdx.y;
  const bool live = c < C;
  const int64_t rows = (int64_t)T * HW;
  // element (t, b, hw, c) of the [T, B, HW, C] tensor
  auto at = [&](int64_t i) {
    const int64_t t = i / HW, hw = i % HW;
    return ((t * B + b) * HW + hw) * C + c;
  };

  // pass 1: mean
  double acc = 0.0;
  if (live)
    for (int64_t i = row; i < rows; i += kRows) acc += (double)y[at(i)];
  red[row][lane] = acc;
  __syncthreads();
  if (row == 0) s_mu[lane] = repro::mean_of(
      repro::class_total(&red[0][lane], kLanes + 1), rows);
  __syncthreads();
  const float mu = s_mu[lane];

  // pass 2: variance of the centred values
  acc = 0.0;
  if (live)
    for (int64_t i = row; i < rows; i += kRows)
      acc += repro::sq_dev(y[at(i)], mu);
  red[row][lane] = acc;
  __syncthreads();
  if (row == 0) s_r[lane] = repro::inv_std(
      repro::class_total(&red[0][lane], kLanes + 1), rows, eps);
  __syncthreads();
  if (!live) return;
  const float r = s_r[lane], sc = scale[c], bi = bias[c];

  // pass 3: normalise + affine + LIF, one thread per (hw, c) neuron
  for (int hw = row; hw < HW; hw += kRows) {
    float u = v_reset;
    for (int t = 0; t < T; ++t) {
      const int64_t idx = (((int64_t)t * B + b) * HW + hw) * C + c;
      out[idx] = repro::norm_lif_step(y[idx], mu, r, sc, bi, decay, v_th,
                                      v_reset, u);
    }
  }
}

}  // namespace

extern "C" int norm_affine_lif_launch(const float* y, const float* scale,
                                      const float* bias, float* out, int T,
                                      int B, int HW, int C, float decay,
                                      float v_th, float v_reset, float eps,
                                      void* stream) {
  const dim3 grid((C + kLanes - 1) / kLanes, B);
  const dim3 block(kLanes, kRows);
  norm_affine_lif_kernel<<<grid, block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      y, scale, bias, out, T, B, HW, C, decay, v_th, v_reset, eps);
  return static_cast<int>(cudaGetLastError());
}
