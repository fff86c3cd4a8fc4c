// The fused spiking-conv layer: a SAME conv at stride 1 or 2 read straight
// from the folded spikes (implicit im2col) -> instance norm over (T, HW)
// per (b, c) -> affine -> T-step LIF with hard reset, in one launch.
//   x [B*T, H, W, C] (batch-major fold), w [kh*kw*C, N] (HWIO reshaped),
//   scale/bias [N] -> spikes [T, B, Ho*Wo, N].
// No patch matrix and no occupancy mask exist anywhere.
//
// Replaces the TPU kernel spike_conv_lif_pallas (src/repro/kernels/
// spike_conv.py), where one program per batch element keeps the whole
// [T*HW, N] conv accumulator in VMEM and runs the norm+LIF epilogue on it.
// A Hopper block has at most 227 KB of shared memory; DenseNet's 64x64
// layers' slab is [20480, 24] f32 = 1.97 MB, so the slab lives in a
// thread-block cluster, as norm_affine_lif.cu holds its input.
//
// The bits: the conv is the canonical-block fmaf chain of spike_mac.cuh
// (K in 128-wide blocks in order, a block's partial an fmaf chain from +0
// over its k in order, partials added with __fadd_rn; an all-zero block,
// slice or element adds nothing), so each conv value equals spike_conv's;
// the statistics keep the contract of lif_common.cuh (32 row classes
// i mod 32, each summed in increasing i in double by one thread, class
// sums added in class order) and the LIF is repro::norm_lif_step, so the
// spikes equal the per-op pair's (spike_conv, then norm_affine_lif) under
// every gate.
//
// Design: one cluster of `cluster` blocks (1..16) per (batch element b,
// tile of <= 32 channels), all on gridDim.x (cluster, tile and batch
// element decoded by a shift and host-made magic numbers, so any batch
// the int arguments hold).  Block k of the cluster owns the row classes
// [k*cpb, (k+1)*cpb), cpb = 32/cluster -- norm_affine_lif.cu's ownership
// -- and computes exactly the conv rows of its classes, local row
// q = j*cpb + (class - k*cpb) holding slab row i = 32 j + class:
//   1. the conv, BM local rows at a time (BM = 32 * TM, TM = 8, 4, 2 or
//      1 rows a thread): the tile's rows are decoded (i -> t, hw -> ho,
//      wo) into row windows, the K slices staged by the shared
//      implicit-im2col code (patch_stage.cuh, as spike_conv.cu: a 2- or
//      3-stage cp.async ring of 32-deep slices, 16/8/4-byte channel
//      chunks, src-size-0 zero fill for padding taps) and multiplied on a
//      32-column register tile (TM x 4 a thread, 256 threads; a tile
//      narrower than 32 channels multiplies zero weights in the rest),
//      the tile's values written to the block's slab in shared memory.
//      Gates per (row tile, K block): "mask" checks the block's patch
//      elements in x before any copy (a K block is done at its first
//      non-zero chunk) and never copies or multiplies a dead block;
//      "inline" ORs each staged slice and skips an all-zero one's
//      multiply-adds; "none" computes every block;
//   2. one thread per (class, channel) chain sums its class in row order
//      in double (cluster_slab.cuh chain_sum); after a cluster barrier
//      every block gathers the 32 class sums through distributed shared
//      memory and adds them in class order: the mean; the same for the
//      variance, then 1/std;
//   3. one thread per (hw, 4 or 1 channels) fires over T the neurons whose
//      t = 0 row is in its classes, reading later rows from the peer that
//      holds them where HW % 32 != 0, and writes each spike once, straight
//      into [T, B, HW, N]: no [T, B] copy exists.
// The launch plan (cluster, channel tile, row tile, ring depth, vector
// width) is made in Python (kernels/spike_conv_lif.py conv_lif_plan,
// cached per shape) and checked here; a shape whose slab fits no cluster
// is refused there.  The other ownership -- blocks computing contiguous
// row tiles, the class chains reading their later terms from peers -- was
// not built: on the card, giving a block's tiles contiguous image rows
// left the conv's time as it was (PERF.md).
//
// What bounds it on the H100: fp32 operations (the conv's multiply-adds
// on live K blocks, at 67 TFLOP/s) on the large layers, the fixed cost of
// a launch and its barriers on the small ones; the bytes (x, w and the
// spikes once) are far below either.  Against the per-op pair it saves
// the conv output's round trips (written, copied to [T, B] order, read
// by the epilogue) and two device operations per layer; it pays for them
// with one block per (b, tile, class share) -- B * tiles * cluster blocks,
// one an SM where the slab is large, so fewer warps hide the staging's
// latency than spike_conv's several blocks an SM do -- and with the
// columns a tile narrower than 32 leaves idle.  The thread tile sets the
// conv's rate: a larger TM reads shared memory less per multiply-add,
// so the plan takes the widest tile that wastes few rows
// (chip_smoke.py --conv-lif-phase times the others beside it).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_slab.cuh"
#include "lif_common.cuh"
#include "patch_stage.cuh"
#include "spike_mac.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::chain_sum;
using repro::cluster_arrive;
using repro::cluster_wait;
using repro::cp_async;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::FastDiv;
using repro::kblock_add;
using repro::kblock_fma;
using repro::kRowClasses;
using repro::Lane;

constexpr int kThreads = 256;
constexpr int kBN = 32;                  // GEMM columns: the channel tile
constexpr int kTN = 4;                   // columns a thread
constexpr int kTX = kBN / kTN;           // threads across the columns
constexpr int kTY = kThreads / kTX;      // thread rows of a block
constexpr int kBK = repro::kPatchBK;
constexpr int kLDA = repro::kPatchLDA;
constexpr int kSPB = repro::kSlicesPerBlock;
constexpr int kMaxCluster = 16;
constexpr int kMaxTile = kBN;            // channels a cluster at most
constexpr int kMaxSmem = 232448;         // a block's shared memory, bytes
static_assert(kBK * kBN / 4 == kThreads, "one 16-byte B chunk a thread");

enum Gate { kGateMask = 0, kGateInline = 1, kGateNone = 2 };

struct ConvLifArgs {
  const float* x;
  const float* w;
  const float* scale;
  const float* bias;
  float* out;
  int H, W, C, kw, stride, pad_h, pad_w, Wo, K;
  int T, B, HW, N;
  int R, rows;          // slab rows T*HW; local rows a block, cpb * J
  int ct;               // channels a tile (the last tile may be narrower)
  int cs_log, cpb_log;  // log2 of the cluster size, of the classes a block
  int kblocks, gate, stages, bvec;
  int cpr, qstep;       // fire: lanes a row (ct / FV), rows a sweep
  int slab_off, ring_off, tab_off;   // bytes into shared memory
  FastDiv hw, wo, tiles, ct_div, cpr_div;
  float decay, v_th, v_reset, eps;
};

// shared memory: [red: 2][cpb][ct] doubles (this block's class sums of the
// mean and of the variance) [all: 32][ct] doubles (the cluster's, gathered)
// [mu: ct][r: ct] floats | slab_off: the slab [rows][ct] floats |
// ring_off: stages x (A [BM][kLDA] then B [kBK][kBN]) floats, the A
// stages first | tab_off: row windows rpix [BM] (8 bytes), rh, rw [BM],
// live [kblocks] (4 bytes)
size_t align16(size_t v) { return (v + 15) / 16 * 16; }

size_t head_bytes(int cpb, int ct) {
  return align16(sizeof(double) * (2 * cpb + kRowClasses) * ct +
                 sizeof(float) * 2 * ct);
}

size_t ring_bytes(int bm, int stages) {
  return sizeof(float) * stages * ((size_t)bm * kLDA + kBK * kBN);
}

template <int V, int TM, int FV>
__global__ void __launch_bounds__(kThreads)
spike_conv_lif_kernel(const __grid_constant__ ConvLifArgs a) {
  constexpr int BM = kTY * TM;
  constexpr int kAStage = BM * kLDA;
  constexpr int kBStage = kBK * kBN;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int cpb = 1 << a.cpb_log, ct = a.ct;
  const int rank = static_cast<int>(cl.block_rank());
  const int cid = static_cast<int>(blockIdx.x >> a.cs_log);
  const int b = a.tiles.div(cid);
  const int c0 = (cid - b * static_cast<int>(a.tiles.d)) * ct;
  const int width = min(ct, a.N - c0);
  const int cls0 = rank * cpb;
  const int tid = threadIdx.x;
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
  float* As = reinterpret_cast<float*>(smem + a.ring_off);
  float* Bs = As + a.stages * kAStage;
  long long* rpix = reinterpret_cast<long long*>(smem + a.tab_off);
  int* rh = reinterpret_cast<int*>(rpix + BM);
  int* rw = rh + BM;
  int* live = rw + BM;

  // 1. the conv rows of this block's classes, BM local rows at a time
  const repro::PatchSrc g{a.x, a.H, a.W, a.C, a.kw, a.K};
  const int n_slices = (a.K + kBK - 1) / kBK;
  const int tx = tid % kTX, ty = tid / kTX;
  // the first slice at or after s inside a live K block
  auto live_from = [&](int s) {
    while (s < n_slices && !live[s / kSPB]) s = (s / kSPB + 1) * kSPB;
    return s;
  };
  // A: the implicit patches of the tile's rows; B: the weights' rows of
  // the slice at the tile's channels, zeros past its width
  auto load_slice = [&](int s, int st) {
    repro::load_patch_slice<V, BM, kThreads>(g, rpix, rh, rw,
                                             As + st * kAStage, s, tid);
    float* bs = Bs + st * kBStage;
    if (a.bvec) {
      const int kr = tid / (kBN / 4), n = (tid % (kBN / 4)) * 4;
      const int kk = s * kBK + kr;
      const bool ok = kk < a.K && n < width;
      cp_async<4>(bs + kr * kBN + n,
                  ok ? a.w + static_cast<size_t>(kk) * a.N + c0 + n : a.w,
                  ok);
    } else {
#pragma unroll
      for (int j = 0; j < kBK * kBN / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int kr = i / kBN, n = i % kBN;
        const int kk = s * kBK + kr;
        const bool ok = kk < a.K && n < width;
        cp_async<1>(bs + kr * kBN + n,
                    ok ? a.w + static_cast<size_t>(kk) * a.N + c0 + n : a.w,
                    ok);
      }
    }
  };
  float acc[TM][kTN], part[TM][kTN];
  auto compute = [&](int st) {
    const float* as = As + st * kAStage;
    const float* bs = Bs + st * kBStage;
#pragma unroll
    for (int k4 = 0; k4 < kBK; k4 += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + (ty + kTY * i) * kLDA +
                                                 k4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(bs + (k4 + q) * kBN + tx * 4);
        const float bq[kTN] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float ai = q == 0 ? av[i].x : q == 1 ? av[i].y
                         : q == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            part[i][j] = kblock_fma(ai, bq[j], part[i][j]);
        }
      }
    }
  };

  for (int q0 = 0; q0 < a.rows; q0 += BM) {
    // each local row's window: slab row i = t*HW + hw of image b*T + t;
    // a row past the slab gets no window (zero-filled loads)
    for (int r = tid; r < BM; r += kThreads) {
      const int q = q0 + r;
      const int i = ((q >> a.cpb_log) << 5) + cls0 + (q & (cpb - 1));
      if (q < a.rows && i < a.R) {
        const int t = a.hw.div(i), hw = i - t * a.HW;
        const int ho = a.wo.div(hw), wo = hw - ho * a.Wo;
        repro::set_patch_row(rpix, rh, rw, r,
                             static_cast<long long>(b) * a.T + t, a.H, a.W,
                             ho, wo, a.stride, a.pad_h, a.pad_w);
      } else {
        repro::clear_patch_row(rpix, rh, rw, r);
      }
    }
    for (int k = tid; k < a.kblocks; k += kThreads)
      live[k] = a.gate == kGateMask ? 0 : 1;
    __syncthreads();
    if (a.gate == kGateMask) {
      repro::mark_live_blocks<V, BM, kThreads>(g, rpix, rh, rw, live, 0,
                                               a.kblocks, tid);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = part[i][j] = 0.f;

    // the ring: stages - 1 slices in flight before the first FMA
    int ps = live_from(0);
    for (int st = 0; st < a.stages - 1; ++st) {
      if (ps < n_slices) {
        load_slice(ps, st);
        ps = live_from(ps + 1);
      }
      cp_async_commit();
    }
    int cs = live_from(0), stage = 0, wstage = a.stages - 1;
    bool blive = false;
    while (cs < n_slices) {
      // the oldest of the stages - 1 slices in flight has landed
      if (a.stages == 3)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      int slive = 1;
      if (a.gate == kGateInline)
        slive = __syncthreads_or(repro::patch_slice_any<V, BM, kThreads>(
            As + stage * kAStage, tid));
      else
        __syncthreads();
      // refill the stage every thread finished with last iteration
      if (ps < n_slices) {
        load_slice(ps, wstage);
        ps = live_from(ps + 1);
      }
      cp_async_commit();
      if (slive) {
        compute(stage);
        blive = true;
      }
      const int next = live_from(cs + 1);
      if ((next >= n_slices || next / kSPB != cs / kSPB) && blive) {
        // the canonical block ends with a live slice: add its partial
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) {
            acc[i][j] = kblock_add(acc[i][j], part[i][j]);
            part[i][j] = 0.f;
          }
        blive = false;
      }
      cs = next;
      stage = stage + 1 == a.stages ? 0 : stage + 1;
      wstage = wstage + 1 == a.stages ? 0 : wstage + 1;
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int q = q0 + ty + kTY * i;
      if (q >= a.rows) continue;
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        if (tx * 4 + j < width)
          slab[static_cast<size_t>(q) * ct + tx * 4 + j] = acc[i][j];
    }
    // the next tile rewrites the windows, the live flags and the ring
    __syncthreads();
  }

  // 2. the statistics: one thread a (class, channel) chain, in row order
  const int chains = cpb * ct;
  auto class_sums = [&](double* dst, auto term) {
    for (int p = tid; p < chains; p += kThreads) {
      const int lc = a.ct_div.div(p), ch = p - lc * ct;
      const int cls = cls0 + lc;
      const int n_cls = ch < width && cls < a.R ? (a.R - cls + 31) >> 5 : 0;
      dst[p] = chain_sum(0.0, 0, n_cls, [&](int j) {
        return term(slab[(j * cpb + lc) * ct + ch], ch);
      });
    }
  };
  // all 32 class sums of the cluster (red + off in each block) into `all`,
  // in class order
  auto gather = [&](int off) {
    for (int e = tid; e < kRowClasses * ct; e += kThreads) {
      const int k = a.ct_div.div(e), c = e - k * ct;
      const double* src = cl.map_shared_rank(red + off, k >> a.cpb_log);
      all[e] = src[(k & (cpb - 1)) * ct + c];
    }
  };
  class_sums(red, [](float y, int) { return static_cast<double>(y); });
  sync_cluster();
  gather(0);
  __syncthreads();
  if (tid < width)
    s_mu[tid] = repro::mean_of(repro::class_total(all + tid, ct), a.R);
  __syncthreads();
  class_sums(red + chains,
             [&](float y, int ch) { return repro::sq_dev(y, s_mu[ch]); });
  sync_cluster();
  gather(chains);
  __syncthreads();
  if (tid < width)
    s_r[tid] = repro::inv_std(repro::class_total(all + tid, ct), a.R, a.eps);
  __syncthreads();
  // no block leaves while a peer may still read its shared memory: each
  // arrives once its peers are done with it -- after the gather where
  // every neuron's rows are local (HW % 32 == 0), after the fire pass
  // otherwise -- and waits for all at the end
  const bool local = (a.HW & 31) == 0;
  if (local && !single) cluster_arrive();

  // 3. normalise + affine + LIF, one thread per (hw, FV channels) over T:
  // the neurons hw = 32 (n >> cpb_log) + cls0 + (n & (cpb - 1)), whose
  // t = 0 row is local row n; where HW % 32 == 0 row t of the neuron is
  // local row n + t * (HW / 32) * cpb
  const int fl = a.cpr_div.div(tid), c = (tid - fl * a.cpr) * FV;
  if (fl < a.qstep && c < width) {
    float mu[FV], r[FV], sc[FV], bi[FV];
#pragma unroll
    for (int v = 0; v < FV; ++v) {
      mu[v] = s_mu[c + v];
      r[v] = s_r[c + v];
      sc[v] = __ldg(a.scale + c0 + c + v);
      bi[v] = __ldg(a.bias + c0 + c + v);
    }
    const size_t t_step = static_cast<size_t>(a.B) * a.HW * a.N;
    const int q_step = (a.HW >> 5) << a.cpb_log;
    const int neurons = cpb * ((a.HW + 31) >> 5);
    for (int n = fl; n < neurons; n += a.qstep) {
      const int hw = ((n >> a.cpb_log) << 5) + cls0 + (n & (cpb - 1));
      if (hw >= a.HW) continue;
      float u[FV];
#pragma unroll
      for (int v = 0; v < FV; ++v) u[v] = a.v_reset;
      size_t off = (static_cast<size_t>(b) * a.HW + hw) * a.N + c0 + c;
      int i = hw, q = n;
      for (int t = 0; t < a.T; ++t, i += a.HW, q += q_step, off += t_step) {
        const float* src = slab;
        if (!local) {
          const int k = i & 31, owner = k >> a.cpb_log;
          q = ((i >> 5) << a.cpb_log) + (k & (cpb - 1));
          if (owner != rank) src = cl.map_shared_rank(slab, owner);
        }
        float y[FV], s[FV];
        Lane<FV>::load(y, src + static_cast<size_t>(q) * ct + c);
#pragma unroll
        for (int v = 0; v < FV; ++v)
          s[v] = repro::norm_lif_step(y[v], mu[v], r[v], sc[v], bi[v],
                                      a.decay, a.v_th, a.v_reset, u[v]);
        Lane<FV>::store(a.out + off, s);
      }
    }
  }
  if (!single) {
    if (!local) cluster_arrive();
    cluster_wait();
  }
}

template <int V, int TM, int FV>
int launch(const ConvLifArgs& a, int blocks, int cluster, size_t smem,
           cudaStream_t s) {
  return repro::launch_cluster(spike_conv_lif_kernel<V, TM, FV>, a, blocks,
                               cluster, kThreads, smem, kMaxSmem, s);
}

template <int V, int TM>
int launch_vec(const ConvLifArgs& a, int vec, int blocks, int cluster,
               size_t smem, cudaStream_t s) {
  return vec == 4 ? launch<V, TM, 4>(a, blocks, cluster, smem, s)
                  : launch<V, TM, 1>(a, blocks, cluster, smem, s);
}

template <int V>
int launch_rows(const ConvLifArgs& a, int bm, int vec, int blocks,
                int cluster, size_t smem, cudaStream_t s) {
  if (bm == 256) return launch_vec<V, 8>(a, vec, blocks, cluster, smem, s);
  if (bm == 128) return launch_vec<V, 4>(a, vec, blocks, cluster, smem, s);
  if (bm == 64) return launch_vec<V, 2>(a, vec, blocks, cluster, smem, s);
  return launch_vec<V, 1>(a, vec, blocks, cluster, smem, s);
}

}  // namespace

// The plan's parameters (kernels/spike_conv_lif.py ConvLifPlan): ct
// channels a tile, cluster blocks a (batch element, tile), bm local rows a
// GEMM tile (256, 128, 64 or 32: 8, 4, 2 or 1 rows a thread), stages of
// the cp.async ring (2 or 3), vec floats a fire lane (4 or 1); gate 0
// "mask", 1 "inline", 2 "none".
// Returns a cudaError_t, or -1 when the card cannot schedule the cluster.
extern "C" int spike_conv_lif_launch(const float* x, const float* w,
                                     const float* scale, const float* bias,
                                     float* out, int T, int B, int H, int W,
                                     int C, int Ho, int Wo, int kh, int kw,
                                     int stride, int pad_h, int pad_w, int N,
                                     int ct, int cluster, int bm, int stages,
                                     int vec, int gate, float decay,
                                     float v_th, float v_reset, float eps,
                                     void* stream) {
  const int cs_log = repro::log2_exact(cluster);
  const int64_t R = (int64_t)T * Ho * Wo;
  const int64_t K = (int64_t)kh * kw * C;
  if (T < 1 || B < 1 || H < 1 || W < 1 || C < 1 || Ho < 1 || Wo < 1 ||
      N < 1 || stride < 1 || R >= (int64_t(1) << 31) ||
      K >= (int64_t(1) << 31) || ct < 1 || ct > kMaxTile || cs_log < 0 ||
      cluster > kMaxCluster ||
      (bm != 256 && bm != 128 && bm != 64 && bm != 32) ||
      (stages != 2 && stages != 3) ||
      (gate != kGateMask && gate != kGateInline && gate != kGateNone) ||
      (vec != 4 && vec != 1) ||
      (vec == 4 && (N % 4 != 0 || ct % 4 != 0 ||
                    reinterpret_cast<uintptr_t>(out) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cpb = kRowClasses / cluster;
  const int J = (int)((R + kRowClasses - 1) / kRowClasses);
  const int tiles = (N + ct - 1) / ct;
  const int64_t blocks = (int64_t)B * tiles * cluster;
  if (blocks >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvLifArgs a;
  a.x = x;
  a.w = w;
  a.scale = scale;
  a.bias = bias;
  a.out = out;
  a.H = H;
  a.W = W;
  a.C = C;
  a.kw = kw;
  a.stride = stride;
  a.pad_h = pad_h;
  a.pad_w = pad_w;
  a.Wo = Wo;
  a.K = (int)K;
  a.T = T;
  a.B = B;
  a.HW = Ho * Wo;
  a.N = N;
  a.R = (int)R;
  a.rows = cpb * J;
  a.ct = ct;
  a.cs_log = cs_log;
  a.cpb_log = repro::log2_exact(cpb);
  a.kblocks = (int)((K + repro::kCanonicalK - 1) / repro::kCanonicalK);
  a.gate = gate;
  a.stages = stages;
  a.bvec = N % 4 == 0 && ct % 4 == 0 &&
           reinterpret_cast<uintptr_t>(w) % 16 == 0;
  a.cpr = ct / vec;
  a.qstep = kThreads / a.cpr;
  const size_t slab_off = head_bytes(cpb, ct);
  const size_t ring_off = slab_off + align16(sizeof(float) * a.rows * ct);
  const size_t tab_off = ring_off + ring_bytes(bm, stages);
  const size_t smem = tab_off + (sizeof(long long) + 2 * sizeof(int)) * bm +
                      sizeof(int) * a.kblocks;
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  a.slab_off = (int)slab_off;
  a.ring_off = (int)ring_off;
  a.tab_off = (int)tab_off;
  a.hw = FastDiv(a.HW);
  a.wo = FastDiv(Wo);
  a.tiles = FastDiv(tiles);
  a.ct_div = FastDiv(ct);
  a.cpr_div = FastDiv(a.cpr);
  a.decay = decay;
  a.v_th = v_th;
  a.v_reset = v_reset;
  a.eps = eps;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const int V = (C % 4 == 0 && xa % 16 == 0) ? 4
              : (C % 2 == 0 && xa % 8 == 0) ? 2 : 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = (int)blocks;
  if (V == 4) return launch_rows<4>(a, bm, vec, n, cluster, smem, s);
  if (V == 2) return launch_rows<2>(a, bm, vec, n, cluster, smem, s);
  return launch_rows<1>(a, bm, vec, n, cluster, smem, s);
}
