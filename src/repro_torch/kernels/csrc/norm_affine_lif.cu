// Spiking-conv epilogue: per-(b, c) instance norm over (T, HW), affine,
// then the T-step LIF with hard reset.  y[T, B, HW, C] -> spikes, same shape.
//
// Replaces the TPU kernel norm_affine_lif_pallas (src/repro/kernels/
// lif_scan.py, body norm_affine_lif_epilogue): there one program holds a
// batch element's whole [T, HW, C] slab in VMEM and reads it once.  One
// Hopper block cannot hold that slab (655 KB to 3.9 MB at the served
// shapes); a thread-block cluster's shared memory can.
//
// The statistics contract (lif_common.cuh), which fixes the bits: per
// (b, c) the rows i = t*HW + hw fall into 32 classes, i mod 32; each class
// is summed in increasing i in double by ONE thread; the 32 class sums are
// added in class order (repro::class_total).  spike_conv_lif.cu and
// backbone_segment.cu replay the same order, so their spikes equal this
// kernel's, and the kernel's spikes equal the first port's design (three
// passes over L2 in one block of (32 channels x 32 classes)) at every shape.
//
// Design: one cluster of `cluster` blocks (1..16, the non-portable 16
// where the plan asks for it) per (batch element, tile of <= 32 channels),
// all on gridDim.x (cluster, tile and batch element decoded by a shift and
// a host-made magic number, so any batch the int arguments hold).  Block
// k of the cluster owns the 32/cluster row classes [k*cpb, (k+1)*cpb):
//   0. it copies its rows of the slab -- every (t, hw) whose row falls in
//      its classes, the tile's channels -- into shared memory once, by
//      cp.async (16 bytes a copy where C and the tile are multiples of 4
//      and y and out are 16-byte aligned, else 4), in kStages commit
//      groups where a class has kStagedRows rows or more, else in one;
//   1. one thread per (class, channel) sums its class in row order in
//      double, stage by stage as the copies land, the next kChainAhead
//      terms loaded and widened while the current ones are added
//      (cluster_slab.cuh chain_sum, shared with spike_conv_lif.cu);
//      the block publishes its class sums, and after a cluster barrier
//      every block gathers all 32 through distributed shared memory and
//      adds them in class order (repro::class_total), so every block
//      holds the same mean;
//   2. the same for the variance about that mean, then 1/std;
//   3. one thread per (hw, 4 or 1 channels) fires over T: the block
//      fires the neurons whose t = 0 row is in its classes.  Where
//      HW % 32 == 0 all T rows of a neuron are in the same class, so in
//      the block; otherwise the later rows are read from the block that
//      holds them through distributed shared memory.  Each spike is
//      written once.
// Each block arrives at a last cluster barrier once no peer needs its
// shared memory and waits on it at the end.  A cluster of one block
// (short chains: 16x16 and 8x8 frames at T = 5) is a plain launch with
// block barriers only.  Where the slab's rows do not fit a block
// (larger frames; the plan's `staged` = 0), the same ownership reads y
// from global memory (L2) in each pass instead.  The launch plan (cluster
// size, channel tile, threads, staged) is made in Python, kernels/
// lif_scan.py norm_lif_plan, and checked here.
//
// What bounds it on the H100: bytes -- y read once and spikes written
// once (the staged path reads y from HBM exactly once) -- and the
// contract's chains: each class is T*HW/32 dependent double adds (640
// at 64x64, T = 5), twice, whatever the grid.  On an H100 80GB HBM3 at
// 700 W a 24-channel 64x64 launch takes ~32 us against a 9.4 us bytes
// bound, a 4x4 launch ~9.3 us, most of it fixed device time (three
// barriers, two gathers, the copy's wait; PERF.md).  Tensor cores do
// not apply: the work is adds in a fixed order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_slab.cuh"
#include "lif_common.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::chain_sum;
using repro::cluster_arrive;
using repro::cluster_wait;
using repro::FastDiv;
using repro::kRowClasses;
using repro::Lane;

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;
constexpr int kStages = 4;            // commit groups of the slab's copy...
constexpr int kStagedRows = 128;      // ...where a class has this many rows
constexpr int kMaxSmem = 232448;      // a block's shared memory, bytes
constexpr int kMaxTile = 32;          // channels a cluster at most

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// V floats global -> shared
template <int V>
__device__ __forceinline__ void stage(float* dst, const float* src);
template <>
__device__ __forceinline__ void stage<4>(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}
template <>
__device__ __forceinline__ void stage<1>(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `pending` (< kStages) of this thread's commit groups
// are in flight
__device__ __forceinline__ void wait_groups(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

struct NormArgs {
  const float* y;
  const float* scale;
  const float* bias;
  float* out;
  int T, B, HW, C;
  int R, J;             // rows T*HW; rows a class at most, ceil(R / 32)
  int ct;               // channels a tile (the last tile may be narrower)
  int cs_log, cpb_log;  // log2 of the cluster size, of the classes a block
  int cpr;              // copies a row: ct / V
  int qstep;            // rows a copy or fire sweep: threads / cpr
  int stages;           // commit groups of the copy: kStages or 1
  int slab_off;         // bytes before the slab in shared memory
  FastDiv hw, tiles, ct_div, cpr_div;
  float decay, v_th, v_reset, eps;
};

// shared memory: [red: 2][cpb][ct] doubles (this block's class sums of
// the mean and of the variance) [all: 32][ct] doubles (the cluster's,
// gathered) [mu: ct][r: ct] floats, then at slab_off the slab
// [cpb * J rows][ct] floats, local row q = j * cpb + (class - cls0)
// holding row i = 32 j + class
size_t slab_offset(int cpb, int ct) {
  const size_t head = sizeof(double) * (2 * cpb + kRowClasses) * ct +
                      sizeof(float) * 2 * ct;
  return (head + 15) / 16 * 16;
}

template <int V, bool STAGED>
__global__ void __launch_bounds__(kMaxThreads)
norm_affine_lif_kernel(const __grid_constant__ NormArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int cpb = 1 << a.cpb_log, ct = a.ct;
  const int rank = static_cast<int>(cl.block_rank());
  const int cid = static_cast<int>(blockIdx.x >> a.cs_log);
  const int b = a.tiles.div(cid);
  const int c0 = (cid - b * static_cast<int>(a.tiles.d)) * ct;
  const int width = min(ct, a.C - c0);
  const int cls0 = rank * cpb;
  const int tid = threadIdx.x, nt = blockDim.x;
  // a cluster of one block (a plain launch) needs only block barriers
  const bool single = a.cs_log == 0;
  auto sync_cluster = [&]() {
    if (single)
      __syncthreads();
    else
      cl.sync();
  };
  double* red = reinterpret_cast<double*>(smem);
  double* all = red + 2 * cpb * ct;
  float* s_mu = reinterpret_cast<float*>(all + kRowClasses * ct);
  float* s_r = s_mu + ct;
  float* slab = reinterpret_cast<float*>(smem + a.slab_off);
  // element (t, b, hw, c0) of the [T, B, HW, C] tensor
  auto at = [&](int t, int hw) {
    return ((static_cast<size_t>(t) * a.B + b) * a.HW + hw) * a.C + c0;
  };
  const int jspan = (a.J + a.stages - 1) / a.stages;   // class rows a stage

  // 0. the block's rows of the slab into shared memory, stage by stage
  if constexpr (STAGED) {
    const int rows = cpb * a.J;
    const int q0 = a.cpr_div.div(tid), x = tid - q0 * a.cpr;
    const bool copier = q0 < a.qstep && x * V < width;
    for (int s = 0; s < a.stages; ++s) {
      const int qe = min(rows, (s + 1) * jspan * cpb);
      if (copier)
        for (int q = s * jspan * cpb + q0; q < qe; q += a.qstep) {
          const int i = ((q >> a.cpb_log) << 5) + cls0 + (q & (cpb - 1));
          if (i < a.R) {
            const int t = a.hw.div(i), hw = i - t * a.HW;
            stage<V>(slab + q * ct + x * V, a.y + at(t, hw) + x * V);
          }
        }
      commit();
    }
  }

  // chain threads: one (class, channel) each
  const int lc = a.ct_div.div(tid), ch = tid - lc * ct;
  const int cls = cls0 + lc;
  const bool chain = lc < cpb && ch < width;
  // rows of this thread's class: i = cls + 32 j, j < n_cls
  const int n_cls = cls < a.R ? (a.R - cls + 31) >> 5 : 0;
  auto value = [&](int j) -> float {
    if constexpr (STAGED) {
      return slab[(j * cpb + lc) * ct + ch];
    } else {
      const int i = (j << 5) + cls;
      const int t = a.hw.div(i), hw = i - t * a.HW;
      return __ldg(a.y + at(t, hw) + ch);
    }
  };
  // all 32 class sums of the cluster (red + off in each block) into
  // `all`, in class order
  auto gather = [&](int off) {
    for (int e = tid; e < kRowClasses * ct; e += nt) {
      const int k = a.ct_div.div(e), c = e - k * ct;
      const double* src = cl.map_shared_rank(red + off, k >> a.cpb_log);
      all[e] = src[(k & (cpb - 1)) * ct + c];
    }
  };

  // 1. the mean: each class in row order, stage by stage
  double acc = 0.0;
  for (int s = 0; s < a.stages; ++s) {
    if constexpr (STAGED) {
      wait_groups(a.stages - 1 - s);
      __syncthreads();
    }
    if (chain)
      acc = chain_sum(acc, s * jspan, min(n_cls, (s + 1) * jspan),
                      [&](int j) { return (double)value(j); });
  }
  if (lc < cpb) red[lc * ct + ch] = acc;
  sync_cluster();
  gather(0);
  __syncthreads();
  if (tid < width)
    s_mu[tid] = repro::mean_of(repro::class_total(all + tid, ct), a.R);
  __syncthreads();

  // 2. the variance of the centred values, then 1/std
  acc = 0.0;
  if (chain) {
    const float mu = s_mu[ch];
    acc = chain_sum(acc, 0, n_cls,
                    [&](int j) { return repro::sq_dev(value(j), mu); });
  }
  if (lc < cpb) red[(cpb + lc) * ct + ch] = acc;
  sync_cluster();
  gather(cpb * ct);
  __syncthreads();
  if (tid < width)
    s_r[tid] = repro::inv_std(repro::class_total(all + tid, ct), a.R, a.eps);
  __syncthreads();
  // no block leaves while a peer may still read its shared memory: each
  // arrives once its peers are done with it -- after the gather where
  // every neuron's rows are local (HW % 32 == 0) or read from y, after
  // the fire pass otherwise -- and waits for all at the end
  const bool local = !STAGED || (a.HW & 31) == 0;
  if (local && !single) cluster_arrive();

  // 3. normalise + affine + LIF, one thread per (hw, V channels) over T:
  // the neurons hw = 32 (n >> cpb_log) + cls0 + (n & (cpb - 1)), whose
  // t = 0 row is local row n; where HW % 32 == 0 row t of the neuron is
  // local row n + t * (HW / 32) * cpb
  const int fl = a.cpr_div.div(tid), c = (tid - fl * a.cpr) * V;
  if (fl < a.qstep && c < width) {
    float mu[V], r[V], sc[V], bi[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      mu[v] = s_mu[c + v];
      r[v] = s_r[c + v];
      sc[v] = __ldg(a.scale + c0 + c + v);
      bi[v] = __ldg(a.bias + c0 + c + v);
    }
    const size_t t_step = static_cast<size_t>(a.B) * a.HW * a.C;
    const int q_step = (a.HW >> 5) << a.cpb_log;
    const int neurons = cpb * ((a.HW + 31) >> 5);
    for (int n = fl; n < neurons; n += a.qstep) {
      const int hw = ((n >> a.cpb_log) << 5) + cls0 + (n & (cpb - 1));
      if (hw >= a.HW) continue;
      float u[V];
#pragma unroll
      for (int v = 0; v < V; ++v) u[v] = a.v_reset;
      size_t off = at(0, hw) + c;
      int i = hw, q = n;
      for (int t = 0; t < a.T; ++t, i += a.HW, q += q_step, off += t_step) {
        float y[V], s[V];
        if constexpr (STAGED) {
          const float* src = slab;
          if (!local) {
            const int k = i & 31, owner = k >> a.cpb_log;
            q = ((i >> 5) << a.cpb_log) + (k & (cpb - 1));
            if (owner != rank) src = cl.map_shared_rank(slab, owner);
          }
          Lane<V>::load(y, src + q * ct + c);
        } else {
          Lane<V>::load(y, a.y + off);
        }
#pragma unroll
        for (int v = 0; v < V; ++v)
          s[v] = repro::norm_lif_step(y[v], mu[v], r[v], sc[v], bi[v],
                                      a.decay, a.v_th, a.v_reset, u[v]);
        Lane<V>::store(a.out + off, s);
      }
    }
  }
  if (!single) {
    if (!local) cluster_arrive();
    cluster_wait();
  }
}

template <int V, bool STAGED>
int launch(const NormArgs& a, int blocks, int cluster, int threads,
           size_t smem, cudaStream_t stream) {
  return repro::launch_cluster(norm_affine_lif_kernel<V, STAGED>, a, blocks,
                               cluster, threads, smem, kMaxSmem, stream);
}

}  // namespace

// The plan's parameters (kernels/lif_scan.py NormLifPlan): ct channels a
// tile, cluster blocks a (batch element, tile), vec floats a copy (4 or
// 1), staged 1 to hold the slab in shared memory, threads a block.
// Returns a cudaError_t, or -1 when the card cannot schedule the cluster.
extern "C" int norm_affine_lif_launch(const float* y, const float* scale,
                                      const float* bias, float* out, int T,
                                      int B, int HW, int C, int ct,
                                      int cluster, int vec, int staged,
                                      int threads, float decay, float v_th,
                                      float v_reset, float eps,
                                      void* stream) {
  const int cs_log = repro::log2_exact(cluster);
  const int64_t R = (int64_t)T * HW;
  if (T < 1 || B < 1 || HW < 1 || C < 1 || R >= (int64_t(1) << 31) ||
      ct < 1 || ct > kMaxTile || cs_log < 0 || cluster > kMaxCluster ||
      (vec != 4 && vec != 1) ||
      (vec == 4 && (C % 4 != 0 || ct % 4 != 0 ||
                    reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
                    reinterpret_cast<uintptr_t>(out) % 16 != 0)) ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cpb = kRowClasses / cluster;
  const int tiles = (C + ct - 1) / ct;
  const int64_t blocks = (int64_t)B * tiles * cluster;
  const int cpr = ct / vec;
  if (threads < cpb * ct || blocks >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  NormArgs a;
  a.y = y;
  a.scale = scale;
  a.bias = bias;
  a.out = out;
  a.T = T;
  a.B = B;
  a.HW = HW;
  a.C = C;
  a.R = (int)R;
  a.J = (int)((R + kRowClasses - 1) / kRowClasses);
  a.ct = ct;
  a.cs_log = cs_log;
  a.cpb_log = repro::log2_exact(cpb);
  a.cpr = cpr;
  a.qstep = threads / cpr;
  a.stages = a.J >= kStagedRows ? kStages : 1;
  a.slab_off = (int)slab_offset(cpb, ct);
  a.hw = FastDiv(HW);
  a.tiles = FastDiv(tiles);
  a.ct_div = FastDiv(ct);
  a.cpr_div = FastDiv(cpr);
  a.decay = decay;
  a.v_th = v_th;
  a.v_reset = v_reset;
  a.eps = eps;
  const size_t smem =
      a.slab_off + (staged ? sizeof(float) * (size_t)cpb * a.J * ct : 0);
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = (int)blocks;
  if (vec == 4)
    return staged ? launch<4, true>(a, n, cluster, threads, smem, s)
                  : launch<4, false>(a, n, cluster, threads, smem, s);
  return staged ? launch<1, true>(a, n, cluster, threads, smem, s)
                : launch<1, false>(a, n, cluster, threads, smem, s);
}
