// The fused spiking-conv layer: conv (patches @ wmat) -> instance norm over
// (T, HW) per (b, c) -> affine -> T-step LIF with hard reset, in one launch.
//   patches [B*T*HW, K] (batch-major rows, as spike_im2col gives them),
//   wmat [K, N], scale/bias [N] -> spikes [T, B, HW, N].
//
// Replaces the TPU kernel spike_conv_lif_pallas (src/repro/kernels/
// spike_conv.py), where one program per batch element keeps the whole
// [T*HW, N] conv accumulator in VMEM and runs the norm+LIF epilogue on it.
// A Hopper block has at most 227 KB of shared memory; spiking-YOLO's
// d0/f0 slab is [5120, 32] f32 = 655 KB and DenseNet's 64x64 layers'
// [20480, 24] = 1.97 MB, so the statistics set the fusion boundary.
//
// Design (a), channel slices: one block of 256 threads per (batch element
// b, slice of NC channels), both on gridDim.x (any batch up to 2^31 - 1
// blocks in all), NC a power of two (1..64) chosen by the caller
// so that the block's [T*HW, NC] accumulator fits in dynamic shared memory
// (spike_conv_lif.py's smem_bytes mirrors the layout below).  The block
//   1. computes its slab tile by tile (BM rows x NC channels, each thread
//      TM rows of one channel; K staged 64 deep per barrier pair through
//      registers, the next slice's loads issued before this slice's
//      multiply-adds), K in canonical 128-wide blocks in order:
//      each block's partial is an fmaf chain from +0 over its k in order,
//      then added to the running sum with __fadd_rn -- the accumulation of
//      gated_gemm.cuh, so the conv values equal spike_conv's bit for bit.
//      A (row tile, K block) is skipped whole when its gate is clear
//      ("mask": the per-(b, 128-row chunk, K block) occupancy bits of
//      slab_occupancy_mask; "inline": an in-kernel any(); "none": never);
//      a skipped tile's contribution is exact zeros;
//   2. reduces the per-channel mean and variance from shared memory in
//      norm_affine_lif.cu's order (lif_common.cuh: 32 row classes summed
//      in double, classes in order), so the statistics are the per-op
//      pair's bits too;
//   3. runs normalise + affine + LIF per (hw, c) neuron over T from shared
//      memory and writes the spikes once.
// The spikes therefore equal the per-op pair's (spike_conv then
// norm_affine_lif) on any input with finite weights.
//
// What bounds it on the H100: bytes.  The function must move the patches,
// wmat and the spikes once (spiking-YOLO at batch 8: ~118 MB of patches
// for ~2.5 GMAC, near the card's fp32 balance of 20 FLOP/byte).  This
// design reads each batch element's patch slab once per channel slice,
// N/NC times (4x at YOLO's 32-channel 32x32 layers, 12x at DenseNet's
// 24-channel 64x64 layers, from L2 where the slab fits its 50 MB), runs
// only B*N/NC blocks (32 at YOLO f0, batch 8) on 132 SMs, one block an SM
// (the slab's shared memory), so each thread keeps a whole K slice's
// loads in flight (16 at NC >= 4) to cover L2 latency; against that it
// saves the per-op pair's conv-output round trips (written once, copied
// into [T, B, HW, N] order, read three times by the epilogue).  A thread-
// block cluster sharing the statistics through distributed shared memory
// (one patch read) is later work.
#include "gated_gemm.cuh"
#include "lif_common.cuh"

namespace {

using repro::kKBlock;
using repro::kMaskBM;
using repro::kRowClasses;

constexpr int kThreads = 256;
// K staged per barrier pair: half a canonical block, so a slice never
// crosses a block boundary; deep enough that each thread has 16 loads
// in flight per step at NC >= 4
constexpr int kSliceK = 64;

// GEMM tile of a slice NC wide: BM rows, TM of them per thread
template <int NC>
struct Tile {
  static constexpr int BM = kThreads / NC > 64 ? kThreads / NC : 64;
  static constexpr int TM = BM * NC / kThreads;
  static constexpr int LDA = BM + 4;     // padded row of the A slice
};

// loads per thread per K slice: of the A tile, and of the weights
template <int NC>
constexpr int kLoadsA = Tile<NC>::BM * kSliceK / kThreads;
template <int NC>
constexpr int kLoadsB = (kSliceK * NC + kThreads - 1) / kThreads;

// dynamic shared memory: [red: 32*NC doubles][mu: NC][r: NC]
//                        [As: kSliceK*LDA][Bs: kSliceK*NC][acc: rows*NC]
template <int NC>
size_t smem_bytes(int rows) {
  return sizeof(double) * kRowClasses * NC
         + sizeof(float) * (2 * NC + kSliceK * Tile<NC>::LDA + kSliceK * NC
                            + (size_t)rows * NC);
}

template <int NC, int GATE>
__global__ void __launch_bounds__(kThreads)
spike_conv_lif_kernel(const float* __restrict__ P,
                      const float* __restrict__ Wm,
                      const int32_t* __restrict__ occ,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      float* __restrict__ out, int T, int B, int HW, int K,
                      int N, float decay, float v_th, float v_reset,
                      float eps) {
  constexpr int BM = Tile<NC>::BM, TM = Tile<NC>::TM, LDA = Tile<NC>::LDA;
  constexpr int kLoadA = kLoadsA<NC>, kLoadB = kLoadsB<NC>;
  extern __shared__ double smem[];
  double* red = smem;                                  // [32][NC]
  float* s_mu = reinterpret_cast<float*>(red + kRowClasses * NC);
  float* s_r = s_mu + NC;
  float* As = s_r + NC;                                // [kSliceK][LDA]
  float* Bs = As + kSliceK * LDA;                      // [kSliceK][NC]
  float* acc = Bs + kSliceK * NC;                      // [rows][NC]

  const int tid = threadIdx.x;
  const int n = tid % NC;             // this thread's channel in the slice
  const int g = tid / NC;             // its row group in a tile
  // (batch element, channel slice) on gridDim.x, the slice fastest
  const int slices = (N + NC - 1) / NC;
  const int b = (int)(blockIdx.x / slices);
  const int c0 = ((int)blockIdx.x - b * slices) * NC;
  const int R = T * HW;
  const int kblocks = (K + kKBlock - 1) / kKBlock;
  const int n_rc = (R + kMaskBM - 1) / kMaskBM;
  const float* Pb = P + (size_t)b * R * K;

  // 1. the conv slab, tile by tile
  for (int r0 = 0; r0 < R; r0 += BM) {
    const int rows = min(BM, R - r0);
    float cur[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) cur[i] = 0.f;
    for (int kb = 0; kb < kblocks; ++kb) {
      const int k0 = kb * kKBlock;
      const int k1 = min(k0 + kKBlock, K);
      bool live = true;
      if (GATE == repro::kGateMask) {
        int any = 0;
        for (int q = r0 / kMaskBM; q <= (r0 + rows - 1) / kMaskBM; ++q)
          any |= occ[((size_t)b * n_rc + q) * kblocks + kb];
        live = any != 0;
      } else if (GATE == repro::kGateInline) {
        const int w = k1 - k0;
        int any = 0;
#pragma unroll 4
        for (int i = tid; i < rows * w; i += kThreads)
          any |= Pb[(size_t)(r0 + i / w) * K + k0 + i % w] != 0.f;
        live = __syncthreads_or(any) != 0;
      }
      if (!live) continue;  // uniform across the block

      float part[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) part[i] = 0.f;
      // the block's K slices in order, staged through registers: the
      // next slice's loads are in flight while this one multiplies
      float ra[kLoadA], rb[kLoadB];
      auto fetch = [&](int ks) {
        const int kn = min(kSliceK, k1 - ks);
#pragma unroll
        for (int j = 0; j < kLoadA; ++j) {
          const int i = tid + j * kThreads;
          const int kk = i % kSliceK, mm = i / kSliceK;
          ra[j] = (kk < kn && mm < rows)
                      ? Pb[(size_t)(r0 + mm) * K + ks + kk] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kLoadB; ++j) {
          const int i = tid + j * kThreads;
          const int nn = i % NC, kk = i / NC;
          rb[j] = (i < kSliceK * NC && kk < kn && c0 + nn < N)
                      ? Wm[(size_t)(ks + kk) * N + c0 + nn] : 0.f;
        }
      };
      fetch(k0);
      for (int ks = k0; ks < k1; ks += kSliceK) {
        // k beyond K only ever meets zero weights: the chain stops at kn
        const int kn = min(kSliceK, k1 - ks);
#pragma unroll
        for (int j = 0; j < kLoadA; ++j) {
          const int i = tid + j * kThreads;
          As[(i % kSliceK) * LDA + i / kSliceK] = ra[j];
        }
#pragma unroll
        for (int j = 0; j < kLoadB; ++j) {
          const int i = tid + j * kThreads;
          if (i < kSliceK * NC) Bs[i] = rb[j];
        }
        __syncthreads();
        if (ks + kSliceK < k1) fetch(ks + kSliceK);
#pragma unroll 8
        for (int kk = 0; kk < kn; ++kk) {
          const float w = Bs[kk * NC + n];
#pragma unroll
          for (int i = 0; i < TM; ++i)
            part[i] = repro::kblock_fma(As[kk * LDA + g * TM + i], w, part[i]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) cur[i] = repro::kblock_add(cur[i], part[i]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int rr = g * TM + i;
      if (rr < rows) acc[(size_t)(r0 + rr) * NC + n] = cur[i];
    }
  }
  __syncthreads();

  // 2. per-channel mean, then variance, in norm_affine_lif.cu's order
  for (int p = tid; p < kRowClasses * NC; p += kThreads) {
    const int cls = p / NC, nn = p % NC;
    double s = 0.0;
    for (int i = cls; i < R; i += kRowClasses)
      s += (double)acc[(size_t)i * NC + nn];
    red[p] = s;
  }
  __syncthreads();
  if (tid < NC) s_mu[tid] = repro::mean_of(repro::class_total(red + tid, NC),
                                           R);
  __syncthreads();
  for (int p = tid; p < kRowClasses * NC; p += kThreads) {
    const int cls = p / NC, nn = p % NC;
    const float mu = s_mu[nn];
    double s = 0.0;
    for (int i = cls; i < R; i += kRowClasses)
      s += repro::sq_dev(acc[(size_t)i * NC + nn], mu);
    red[p] = s;
  }
  __syncthreads();
  if (tid < NC)
    s_r[tid] = repro::inv_std(repro::class_total(red + tid, NC), R, eps);
  __syncthreads();

  // 3. normalise + affine + LIF, one thread per (hw, c) neuron at a time
  for (int p = tid; p < HW * NC; p += kThreads) {
    const int hw = p / NC, nn = p % NC;
    const int c = c0 + nn;
    if (c >= N) continue;
    const float mu = s_mu[nn], r = s_r[nn], sc = scale[c], bi = bias[c];
    float u = v_reset;
    for (int t = 0; t < T; ++t)
      out[(((size_t)t * B + b) * HW + hw) * N + c] = repro::norm_lif_step(
          acc[((size_t)t * HW + hw) * NC + nn], mu, r, sc, bi, decay, v_th,
          v_reset, u);
  }
}

template <int NC, int GATE>
int launch(const float* P, const float* Wm, const int32_t* occ,
           const float* scale, const float* bias, float* out, int T, int B,
           int HW, int K, int N, float decay, float v_th, float v_reset,
           float eps, cudaStream_t stream) {
  const size_t smem = smem_bytes<NC>(T * HW);
  const int64_t blocks = (int64_t)((N + NC - 1) / NC) * B;
  if (B < 1 || blocks >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = spike_conv_lif_kernel<NC, GATE>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(P, Wm, occ, scale, bias, out, T, B,
                                         HW, K, N, decay, v_th, v_reset, eps);
  return static_cast<int>(cudaGetLastError());
}

template <int NC>
int launch_gate(int gate, const float* P, const float* Wm,
                const int32_t* occ, const float* scale, const float* bias,
                float* out, int T, int B, int HW, int K, int N, float decay,
                float v_th, float v_reset, float eps, cudaStream_t s) {
  switch (gate) {
    case repro::kGateMask:
      return launch<NC, repro::kGateMask>(P, Wm, occ, scale, bias, out, T, B,
                                          HW, K, N, decay, v_th, v_reset,
                                          eps, s);
    case repro::kGateInline:
      return launch<NC, repro::kGateInline>(P, Wm, occ, scale, bias, out, T,
                                            B, HW, K, N, decay, v_th,
                                            v_reset, eps, s);
    case repro::kGateNone:
      return launch<NC, repro::kGateNone>(P, Wm, occ, scale, bias, out, T, B,
                                          HW, K, N, decay, v_th, v_reset,
                                          eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// nc: channels per block (1, 2, 4, 8, 16, 32 or 64); gate: GateMode
extern "C" int spike_conv_lif_launch(const float* patches, const float* wmat,
                                     const int32_t* occ, const float* scale,
                                     const float* bias, float* out, int T,
                                     int B, int HW, int K, int N, int nc,
                                     int gate, float decay, float v_th,
                                     float v_reset, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_NC(W)                                                        \
  case W:                                                                  \
    return launch_gate<W>(gate, patches, wmat, occ, scale, bias, out, T, B, \
                          HW, K, N, decay, v_th, v_reset, eps, s);
  switch (nc) {
    REPRO_NC(1)
    REPRO_NC(2)
    REPRO_NC(4)
    REPRO_NC(8)
    REPRO_NC(16)
    REPRO_NC(32)
    REPRO_NC(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_NC
}
