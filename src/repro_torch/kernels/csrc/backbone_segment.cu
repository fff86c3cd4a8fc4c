// A planned backbone segment -- a run of spiking conv layers, each conv ->
// instance norm over (T, HW) -> affine -> T-step LIF -> optional max-pool
// -- in ONE launch, the interior activations never leaving the cluster's
// scratch in L2.
//   x [T, B, H, W, C]; per layer w ([Kp, N] canonical-padded, or the
//   depthwise [taps, C]), scale [N], bias [N] -> out [T, B, Hf, Wf, Cf].
//
// Replaces the TPU kernel backbone_segment_pallas (src/repro/kernels/
// backbone_fuse.py), where one program per batch element holds each
// layer's patch matrix, accumulator and spikes in 16 MiB of VMEM.  A
// Hopper block has 227 KB of shared memory, and spiking-YOLO's f1 output
// alone is 5*256*64 floats = 320 KB per element; each layer's norm also
// needs statistics over the whole (T, HW) before any neuron fires.
//
// Design: one thread-block cluster per batch element (grid: cluster size
// x B on gridDim.x, so any batch up to 2^31 - 1 blocks in all;
// cudaLaunchKernelEx with cudaLaunchAttributeClusterDimension).  The
// cluster's blocks share a per-element global scratch -- a ping-pong pair
// of activation buffers, the f32 conv output and the statistics' class
// sums -- which the planner's budget (roofline.SEGMENT_BUDGET_BYTES, an
// eighth of the 50 MB L2) keeps in L2 for a batch of 8.  Per layer, four
// phases, each ended by a cluster barrier:
//   1. the conv, implicit im2col (no patch matrix): 64x64 output tiles
//      spread over the cluster's blocks, each thread a 4x4 register
//      tile, K staged 16 deep through shared memory -- the A slice
//      gathered from the activations, the next slice's loads in flight
//      while this one multiplies.  K runs in canonical 128-wide blocks in
//      order, each block's fmaf chain from +0 added to the sum
//      (spike_mac.cuh), so the conv values equal spike_conv's and
//      spike_conv_lif's bit for bit.  Under the "inline" gate a slice
//      whose 64x16 activations are all zero is skipped: it adds exact
//      zeros.
//      A depthwise layer runs the tap loop of spike_dwconv.cu per
//      (row, channel);
//   2. the mean: each (row class, channel) pair of lif_common.cuh summed
//      in increasing row order in double by one thread, never split;
//   3. the variance, the same way around each block's copy of the mean;
//   4. normalise + affine + LIF per neuron over T (lif_common.cuh), the
//      max of each pool window taken as its neurons fire, the spikes
//      written to the other activation buffer (the output after the
//      last layer).
// Data one block reads that another wrote goes through L2 (__ldcg /
// __stcg), past the SM's L1, behind a fence and the cluster barrier.
//
// What bounds it on the H100: neither HBM bytes (a segment moves its
// input, weights and output once: ~1-3 MB at batch 8) nor fp32
// operations at 67 TFLOP/s (0.02-0.2 ms of MACs dense), but parallelism
// and latency: one cluster of 8-16 blocks per batch element (at most 128
// of the 132 SMs at batch 8), a deep layer's few output tiles (8-20 per
// element), four cluster barriers per layer and the L2 round trips of
// the implicit im2col.  Tensor cores, TMA and activations kept in
// distributed shared memory are later work.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gated_gemm.cuh"
#include "lif_common.cuh"
#include "spike_mac.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::kCanonicalK;
using repro::kRowClasses;

constexpr int kThreads = 256;       // 16 x 16 threads, 4x4 outputs each
constexpr int kBM = 64;             // conv output tile: rows
constexpr int kBN = 64;             //   and channels
constexpr int kBK = 16;             // K slice staged in shared memory
constexpr int kRowsA = kBM * kBK / kThreads;   // A rows a thread stages
constexpr int kRowsB = kBK * kBN / kThreads;   // B rows a thread stages
constexpr int kMaxLayers = 16;
constexpr int kMaxPool = 4;
constexpr int kMaxCluster = 16;
// the cluster could not be scheduled on this card (returned as an error)
constexpr int kErrClusterUnschedulable = -1;

struct LayerDesc {
  const float* w;       // [Kp, N] normal, [taps, C] depthwise
  const float* scale;   // [N]
  const float* bias;    // [N]
  int H, W, C;          // input extent and channels
  int Ho, Wo, N;        // conv output extent and channels
  int kernel, stride, pad_h, pad_w;
  int depthwise, pool;  // pool: window, 0 for none
};

struct SegmentDesc {
  LayerDesc layer[kMaxLayers];
  int L, T, B, gate;
  float decay, v_th, v_reset, eps;
};

struct Scratch {
  float* act[2];        // [B][act_stride] each: a layer's spikes
  int64_t act_stride;
  float* acc;           // [B][acc_stride]: a layer's conv output
  int64_t acc_stride;
  double* red;          // [B][2][kRowClasses][max_n]: class sums
  int max_n;
};

__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cl) {
  __threadfence();
  cl.sync();
}

// 1. the conv of a normal layer into acc [R][N], R = T*Ho*Wo: 64x64
// output tiles spread over the cluster's blocks, each thread a 4x4
// register tile; K staged 16 deep through shared memory, the A slice
// gathered from the activations (implicit im2col) and the next slice's
// loads in flight while this one multiplies
__device__ void conv_gemm(const LayerDesc& ly, const float* in,
                          int64_t in_t, float* acc, int T, bool inline_gate,
                          int rank, int cs) {
  __shared__ __align__(16) float As[kBK][kBM + 4];   // A slice, As[k][m]
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int HoWo = ly.Ho * ly.Wo, R = T * HoWo, N = ly.N, C = ly.C;
  const int K = ly.kernel * ly.kernel * C;
  const int n_ct = (N + kBN - 1) / kBN;
  const int n_tiles = (R + kBM - 1) / kBM * n_ct;
  // staging: this thread's k of the A slice and its rows
  // tid/kBK + (kThreads/kBK)*j; its column of the B slice and its rows
  // tid/kBN + (kThreads/kBN)*j
  constexpr int kStepA = kThreads / kBK, kStepB = kThreads / kBN;
  const int a_k = tid % kBK, b_n = tid % kBN, b_k = tid / kBN;
  for (int tile = rank; tile < n_tiles; tile += cs) {
    const int m0 = tile / n_ct * kBM, n0 = tile % n_ct * kBN;
    const float* base[kRowsA];
    int h0[kRowsA], w0[kRowsA];
#pragma unroll
    for (int j = 0; j < kRowsA; ++j) {
      const int r = m0 + tid / kBK + kStepA * j;
      const int t = r / HoWo, hw = r - t * HoWo;
      const int ho = hw / ly.Wo, wo = hw - ho * ly.Wo;
      base[j] = in + (int64_t)t * in_t;
      // a row past R reads nothing: its taps all fall outside
      h0[j] = r < R ? ho * ly.stride - ly.pad_h : -(1 << 20);
      w0[j] = wo * ly.stride - ly.pad_w;
    }
    float ra[kRowsA], rb[kRowsB];
    auto fetch = [&](int ks) {
      const int k = ks + a_k;
      const int tap = k / C, c = k - tap * C;
      const int di = tap / ly.kernel, dj = tap - di * ly.kernel;
#pragma unroll
      for (int j = 0; j < kRowsA; ++j) {
        const int hi = h0[j] + di, wi = w0[j] + dj;
        ra[j] = (k < K && hi >= 0 && hi < ly.H && wi >= 0 && wi < ly.W)
                    ? __ldcg(base[j] + ((int64_t)hi * ly.W + wi) * C + c)
                    : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kRowsB; ++j) {
        const int kb = ks + b_k + kStepB * j, n = n0 + b_n;
        rb[j] = (kb < K && n < N) ? __ldg(ly.w + (int64_t)kb * N + n) : 0.f;
      }
    };
    float total[4][4], part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) total[i][j] = part[i][j] = 0.f;
    fetch(0);
    for (int ks = 0; ks < K; ks += kBK) {
      if (ks != 0 && ks % kCanonicalK == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            total[i][j] = repro::kblock_add(total[i][j], part[i][j]);
            part[i][j] = 0.f;
          }
      }
      int live = !inline_gate;
#pragma unroll
      for (int j = 0; j < kRowsA; ++j) {
        As[a_k][tid / kBK + kStepA * j] = ra[j];
        live |= ra[j] != 0.f;
      }
#pragma unroll
      for (int j = 0; j < kRowsB; ++j) Bs[b_k + kStepB * j][b_n] = rb[j];
      // "inline": a slice whose 64x16 activations are all zero adds
      // exact zeros, and is skipped
      live = __syncthreads_or(live);
      if (ks + kBK < K) fetch(ks + kBK);
      if (live) {
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
          const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
          const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
          const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              part[i][j] = repro::kblock_fma(a[i], b[j], part[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        const float v = repro::kblock_add(total[i][j], part[i][j]);
        if (r < R && n < N) __stcg(acc + (int64_t)r * N + n, v);
      }
    }
  }
}

// 1. the conv of a depthwise layer into acc [R][C]
__device__ void conv_depthwise(const LayerDesc& ly, const float* in,
                               int64_t in_t, float* acc, int T,
                               bool inline_gate, int gt, int nt) {
  const int HoWo = ly.Ho * ly.Wo, C = ly.C;
  const int64_t total = (int64_t)T * HoWo * C;
  for (int64_t idx = gt; idx < total; idx += nt) {
    const int c = (int)(idx % C);
    const int r = (int)(idx / C);
    const int t = r / HoWo, hw = r - t * HoWo;
    const int ho = hw / ly.Wo, wo = hw - ho * ly.Wo;
    const float* xt = in + (int64_t)t * in_t + c;
    float s = 0.f;
    for (int i = 0; i < ly.kernel; ++i) {
      const int hi = ho * ly.stride + i - ly.pad_h;
      if (hi < 0 || hi >= ly.H) continue;
      for (int j = 0; j < ly.kernel; ++j) {
        const int wi = wo * ly.stride + j - ly.pad_w;
        if (wi < 0 || wi >= ly.W) continue;
        const float v = __ldcg(xt + ((int64_t)hi * ly.W + wi) * C);
        if (!inline_gate || v != 0.f)
          s = repro::dw_tap(s, v, __ldg(ly.w + (i * ly.kernel + j) * C + c));
      }
    }
    __stcg(acc + idx, s);
  }
}

__global__ void __launch_bounds__(kThreads)
backbone_segment_kernel(const __grid_constant__ SegmentDesc d,
                        const float* __restrict__ x, float* out,
                        const __grid_constant__ Scratch s) {
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), cs = (int)cl.num_blocks();
  const int b = (int)(blockIdx.x / cs), tid = threadIdx.x;
  const int gt = rank * kThreads + tid, nt = cs * kThreads;
  const bool inline_gate = d.gate == repro::kGateInline;
  const int T = d.T;
  extern __shared__ float smem[];
  float* s_mu = smem;
  float* s_r = smem + s.max_n;
  float* acc = s.acc + (int64_t)b * s.acc_stride;
  double* red_mu = s.red + (int64_t)b * 2 * kRowClasses * s.max_n;
  double* red_var = red_mu + kRowClasses * s.max_n;

  for (int l = 0; l < d.L; ++l) {
    const LayerDesc& ly = d.layer[l];
    const int N = ly.N, HoWo = ly.Ho * ly.Wo, R = T * HoWo;
    // this layer's input: x, or the previous layer's spikes
    const float* in;
    int64_t in_t;
    if (l == 0) {
      in = x + (int64_t)b * ly.H * ly.W * ly.C;
      in_t = (int64_t)d.B * ly.H * ly.W * ly.C;
    } else {
      in = s.act[(l - 1) & 1] + (int64_t)b * s.act_stride;
      in_t = (int64_t)ly.H * ly.W * ly.C;
    }

    // 1. the conv
    if (ly.depthwise)
      conv_depthwise(ly, in, in_t, acc, T, inline_gate, gt, nt);
    else
      conv_gemm(ly, in, in_t, acc, T, inline_gate, rank, cs);
    cluster_barrier(cl);

    // 2. the mean's class sums, then each block's copy of the mean
    for (int p = gt; p < kRowClasses * N; p += nt) {
      const int cls = p / N, n = p - cls * N;
      double sum = 0.0;
      for (int i = cls; i < R; i += kRowClasses)
        sum += (double)__ldcg(acc + (int64_t)i * N + n);
      __stcg(red_mu + p, sum);
    }
    cluster_barrier(cl);
    for (int n = tid; n < N; n += kThreads)
      s_mu[n] = repro::mean_of(repro::class_total_l2(red_mu + n, N), R);
    __syncthreads();

    // 3. the variance's class sums, then each block's 1/std
    for (int p = gt; p < kRowClasses * N; p += nt) {
      const int cls = p / N, n = p - cls * N;
      const float mu = s_mu[n];
      double sum = 0.0;
      for (int i = cls; i < R; i += kRowClasses)
        sum += repro::sq_dev(__ldcg(acc + (int64_t)i * N + n), mu);
      __stcg(red_var + p, sum);
    }
    cluster_barrier(cl);
    for (int n = tid; n < N; n += kThreads)
      s_r[n] = repro::inv_std(repro::class_total_l2(red_var + n, N), R,
                              d.eps);
    __syncthreads();

    // 4. normalise + affine + LIF, the pool window's max as it fires
    const int p = ly.pool > 0 ? ly.pool : 1;
    const int hp = ly.Ho / p, wp = ly.Wo / p;
    float* dst;
    int64_t dst_t;
    if (l == d.L - 1) {
      dst = out + (int64_t)b * hp * wp * N;
      dst_t = (int64_t)d.B * hp * wp * N;
    } else {
      dst = s.act[l & 1] + (int64_t)b * s.act_stride;
      dst_t = (int64_t)hp * wp * N;
    }
    for (int q = gt; q < hp * wp * N; q += nt) {
      const int n = q % N, pix = q / N;
      const int ph = pix / wp, pw = pix - ph * wp;
      const float mu = s_mu[n], r = s_r[n];
      const float sc = __ldg(ly.scale + n), bi = __ldg(ly.bias + n);
      float u[kMaxPool * kMaxPool];
#pragma unroll
      for (int j = 0; j < kMaxPool * kMaxPool; ++j) u[j] = d.v_reset;
      for (int t = 0; t < T; ++t) {
        float mx = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxPool * kMaxPool; ++j) {
          if (j >= p * p) break;
          const int ho = ph * p + j / p, wo = pw * p + j % p;
          const float y =
              __ldcg(acc + ((int64_t)t * HoWo + ho * ly.Wo + wo) * N + n);
          const float spk = repro::norm_lif_step(y, mu, r, sc, bi, d.decay,
                                                 d.v_th, d.v_reset, u[j]);
          mx = j == 0 ? spk : fmaxf(mx, spk);
        }
        __stcg(dst + (int64_t)t * dst_t + (int64_t)pix * N + n, mx);
      }
    }
    if (l + 1 < d.L) cluster_barrier(cl);
  }
}

}  // namespace

// dims: per layer H, W, C, Ho, Wo, N, kernel, stride, pad_h, pad_w,
// depthwise, pool (12 ints); ptrs: per layer w, scale, bias.  gate is
// GateMode (kGateInline or kGateNone); cluster the blocks per batch
// element (1, 2, 4, 8 or 16).  Returns a cudaError_t, or -1 when the
// card cannot schedule a cluster of that size with this kernel.
extern "C" int backbone_segment_launch(
    const int* dims, const void* const* ptrs, int L, int T, int B, int gate,
    float decay, float v_th, float v_reset, float eps, const float* x,
    float* out, float* act0, float* act1, int64_t act_stride, float* acc,
    int64_t acc_stride, double* red, int max_n, int cluster, void* stream) {
  if (L < 1 || L > kMaxLayers || B < 1 || T < 1 ||
      (int64_t)B * cluster >= (int64_t(1) << 31) ||
      (gate != repro::kGateInline && gate != repro::kGateNone) ||
      cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  SegmentDesc d{};
  d.L = L;
  d.T = T;
  d.B = B;
  d.gate = gate;
  d.decay = decay;
  d.v_th = v_th;
  d.v_reset = v_reset;
  d.eps = eps;
  for (int l = 0; l < L; ++l) {
    const int* v = dims + 12 * l;
    LayerDesc& ly = d.layer[l];
    ly.H = v[0];
    ly.W = v[1];
    ly.C = v[2];
    ly.Ho = v[3];
    ly.Wo = v[4];
    ly.N = v[5];
    ly.kernel = v[6];
    ly.stride = v[7];
    ly.pad_h = v[8];
    ly.pad_w = v[9];
    ly.depthwise = v[10];
    ly.pool = v[11];
    ly.w = static_cast<const float*>(ptrs[3 * l]);
    ly.scale = static_cast<const float*>(ptrs[3 * l + 1]);
    ly.bias = static_cast<const float*>(ptrs[3 * l + 2]);
    if (ly.N > max_n || ly.stride < 1 || ly.stride > 2 || ly.pool < 0 ||
        ly.pool > kMaxPool || ly.kernel < 1)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  Scratch s;
  s.act[0] = act0;
  s.act[1] = act1;
  s.act_stride = act_stride;
  s.acc = acc;
  s.acc_stride = acc_stride;
  s.red = red;
  s.max_n = max_n;

  auto kern = backbone_segment_kernel;
  const size_t smem = 2 * sizeof(float) * (size_t)max_n;
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (cluster > 8) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * B, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (clusters < 1) return kErrClusterUnschedulable;
  e = cudaLaunchKernelEx(&cfg, kern, d, x, out, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
