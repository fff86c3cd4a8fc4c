// A planned backbone segment -- a run of spiking conv layers, each conv ->
// instance norm over (T, HW) -> affine -> T-step LIF -> optional max-pool
// -- in ONE launch, each layer's conv output held in the shared memory of
// a thread-block cluster.
//   x [T, B, H, W, C]; per layer w ([K, N]: the HWIO weight viewed as a
//   matrix, or the depthwise [taps, C]), scale [N], bias [N]
//   -> out [T, B, Hf, Wf, Cf].
//
// Replaces the TPU kernel backbone_segment_pallas (src/repro/kernels/
// backbone_fuse.py; its body _segment_kernel), where one program per batch
// element holds each layer's patch matrix, accumulator and spikes in VMEM.
// A Hopper block has 227 KB of shared memory; a layer's conv output per
// element (T*Ho*Wo*N floats) is 80-640 KB on the four backbones, and the
// norm needs statistics over the whole (T, HW) before any neuron fires.
//
// The bits: each normal conv value is the canonical-block fmaf chain of
// spike_mac.cuh (K in 128-wide blocks in order, a block's partial an fmaf
// chain from +0 over its k in order, partials added with __fadd_rn; an
// all-zero slice adds nothing), a depthwise value the tap loop of
// spike_dwconv.cu (dw_tap, taps in (kh, kw) order); the statistics keep
// the contract of lif_common.cuh (32 row classes i mod 32, each summed in
// increasing i in double by one thread, class sums added in class order)
// and the LIF is repro::norm_lif_step.  So the spikes equal the per-layer
// kernel route's (spike_conv_lif or spike_conv + norm_affine_lif,
// spike_dwconv, max_pool) under either gate.
//
// Design: one cluster of `cluster` blocks (1..16) per batch element, all
// on gridDim.x.  Block k owns the row classes [k*cpb, (k+1)*cpb), cpb =
// 32/cluster (norm_affine_lif.cu's and spike_conv_lif.cu's ownership),
// and holds their rows of every layer's [T*Ho*Wo, N] conv output -- local
// row q = j*cpb + (class - k*cpb) holds slab row i = 32 j + class, all N
// channels -- in its shared memory.  Per layer:
//   1. the conv.  A normal layer's conv is a GEMM from the layer's input
//      spikes by implicit im2col (patch_stage.cuh: a 2- or 3-stage
//      cp.async ring of 32-deep K slices, src-size-0 zero fill; 16-byte
//      chunks through PatchCursor, which keeps each thread's rows and
//      tap in registers) on tiles of bm cluster rows x 32 channels (TM x
//      4 a thread, bm = 32 TM, TM = 1..8).  The plan
//      (kernels/backbone_segment.py segment_plan) picks bm per layer and
//      whether a block computes only its own rows ("own") or the
//      cluster's rows are cut into tiles dealt round the blocks
//      ("spread": a layer with few rows a block then fills the cluster,
//      and each tile stores its outputs into the owning block's slab
//      through distributed shared memory).  Cluster rows run owner by
//      owner (g = owner * rows + q), so a tile never holds more padding
//      than the last class's.  A depthwise layer runs the tap loop per
//      (own row, channel), a thread keeping its channels and loading an
//      output's taps together;
//   2. the statistics: one thread per (own class, channel) chain sums its
//      class in row order in double (cluster_slab.cuh chain_sum, terms
//      loaded ahead); after a cluster barrier every block reads the 32
//      class sums of each channel from its peers' shared memory at once
//      and adds them in class order: the mean; then the same for the
//      variance and 1/std;
//   3. normalise + affine + LIF, one thread per (output pixel, 4 or 1
//      channels) over T, the pool window's max taken as its neurons fire;
//      a row another block holds is read through distributed shared
//      memory.  The spikes go to a per-element ping-pong buffer in global
//      memory (L2-resident: 40-640 KB an element) or, after the last
//      layer, to out.
// A cluster barrier ends each layer (the spikes are visible to every block
// of the cluster, and no block rewrites a slab a peer still reads), and a
// spread layer's conv has one more: three barriers a layer, four where
// the conv is spread, and one split barrier at the start (no block
// touches a peer's shared memory before every block runs).  The spike
// buffers are rewritten every second layer, so a layer reads them past
// L1 (cp.async.cg, __ldcg).  The kernel comes in two register budgets:
// one block an SM (TM up to 8), or two (128 registers a thread, TM up to
// 4), which the plan takes where B clusters of its size only fit the
// card two blocks an SM.
//
// What bounds it on the H100: fp32 operations (the convs' multiply-adds,
// at 67 TFLOP/s) on the 3x3 segments, the latency of a layer's phases
// and barriers on the small ones; the bytes (x, the weights and the
// output once) are far below either.  Against the per-layer route it
// saves every conv output's round trips through device memory and all
// but one of the route's device operations; it pays with one cluster
// per batch element: at batch 8, 64 blocks of 8, as eight 16-block
// clusters do not fit the card one block an SM, against the route's
// 132 SMs (chip_smoke.py --segment-phase).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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
constexpr int kBN = 32;                  // GEMM columns: a channel tile
constexpr int kTN = 4;                   // columns a thread
constexpr int kTX = kBN / kTN;           // threads across the columns
constexpr int kTY = kThreads / kTX;      // thread rows of a block
constexpr int kBK = repro::kPatchBK;
constexpr int kLDA = repro::kPatchLDA;
constexpr int kSPB = repro::kSlicesPerBlock;
constexpr int kMaxLayers = 16;
constexpr int kMaxPool = 4;
constexpr int kMaxCluster = 16;
constexpr int kMaxSmem = 232448;         // a block's shared memory, bytes
constexpr int kTapGroup = 9;             // depthwise taps loaded together
static_assert(kBK * kBN / 4 == kThreads, "one 16-byte B chunk a thread");

enum Gate { kGateInline = 1, kGateNone = 2 };

struct LayerDesc {
  const float* w;       // [K, N] normal, [taps, C] depthwise
  const float* scale;   // [N]
  const float* bias;    // [N]
  int H, W, C;          // input extent and channels
  int Ho, Wo, N;        // conv output extent and channels
  int kw, stride, pad_h, pad_w, depthwise, pool;   // pool: window, 0: none
  int K, R, rows;       // kw*kw*C; slab rows T*Ho*Wo; local rows a block
  int bm, spread, ct, tiles_n;   // conv plan: rows and channels a tile
  int v, bvec, fv;      // patch chunk floats, 16-byte weight copies, fire
  FastDiv howo, wo, wp; // / Ho*Wo, / Wo, / (Wo / pool)
};

struct SegArgs {
  LayerDesc layer[kMaxLayers];
  const float* x;
  float* out;
  float* act[2];        // [B][act_stride] each: a layer's spikes
  long long act_stride;
  int L, T, B, gate, stages, cs_log, cpb_log, max_n;
  int slab_off, ring_off, tab_off;   // bytes into shared memory
  float decay, v_th, v_reset, eps;
};

// shared memory: [red: 2][cpb][max_n] doubles (this block's class sums of
// the mean and of the variance) [mu, r, scale, bias: max_n each] floats |
// slab_off: the slab [rows][N] floats (the largest layer's) | ring_off:
// stages x (A [bm][kLDA] then B [kBK][kBN]) floats, the A stages first
// (the largest bm's) | tab_off: row windows rpix [bm] (8 bytes), rh, rw
// [bm]
size_t align16(size_t v) { return (v + 15) / 16 * 16; }

struct Ctx {
  cg::cluster_group& cl;
  unsigned char* smem;
  float* slab;
  int rank, cs, cpb, cpb_log, b, tid;
};

// the slab row held in local row q of block o
__device__ __forceinline__ int slab_row(const Ctx& c, int o, int q) {
  return ((q >> c.cpb_log) << 5) + o * c.cpb + (q & (c.cpb - 1));
}

// block o's slab, local or through distributed shared memory
__device__ __forceinline__ float* slab_of(const Ctx& c, int o) {
  return o == c.rank ? c.slab : c.cl.map_shared_rank(c.slab, o);
}

// 1. the conv of a normal layer: its tiles of BM cluster rows x kBN
// channels, each tile's values stored into the owners' slabs.  in: the
// layer's input, image t at pixel pix0 + t * img_px
template <int V, int TM>
__device__ void conv_tiles(const SegArgs& a, const LayerDesc& ly, Ctx& c,
                           const float* in, long long pix0,
                           long long img_px) {
  constexpr int BM = kTY * TM;
  constexpr int kAStage = BM * kLDA;
  constexpr int kBStage = kBK * kBN;
  const int tid = c.tid;
  float* As = reinterpret_cast<float*>(c.smem + a.ring_off);
  float* Bs = As + a.stages * kAStage;
  long long* rpix = reinterpret_cast<long long*>(c.smem + a.tab_off);
  int* rh = reinterpret_cast<int*>(rpix + BM);
  int* rw = rh + BM;
  const bool inline_gate = a.gate == kGateInline;
  const int HoWo = ly.Ho * ly.Wo, N = ly.N;
  // the cluster rows this block's tiles cover: all of them (spread, the
  // tiles dealt round the blocks) or its own
  const int g_lo = ly.spread ? 0 : c.rank * ly.rows;
  const int g_hi = ly.spread ? c.cs * ly.rows : g_lo + ly.rows;
  const int n_tiles = (g_hi - g_lo + BM - 1) / BM * ly.tiles_n;
  const int t0 = ly.spread ? c.rank : 0, t_step = ly.spread ? c.cs : 1;
  const repro::PatchSrc g{in, ly.H, ly.W, ly.C, ly.kw, ly.K};
  const int n_slices = (ly.K + kBK - 1) / kBK;
  const int tx = tid % kTX, ty = tid / kTX;

  for (int tile = t0; tile < n_tiles; tile += t_step) {
    const int g0 = g_lo + tile / ly.tiles_n * BM;
    const int c0 = tile % ly.tiles_n * ly.ct;
    const int width = min(ly.ct, N - c0);
    // each tile row's window; a row past the cluster rows or the slab
    // gets none (zero-filled loads)
    for (int r = tid; r < BM; r += kThreads) {
      const int gr = g0 + r;
      const int o = gr / ly.rows;
      const int i = slab_row(c, o, gr - o * ly.rows);
      if (gr < g_hi && i < ly.R) {
        const int t = ly.howo.div(i), hw = i - t * HoWo;
        const int ho = ly.wo.div(hw), wo = hw - ho * ly.Wo;
        rpix[r] = pix0 + t * img_px;
        rh[r] = ho * ly.stride - ly.pad_h;
        rw[r] = wo * ly.stride - ly.pad_w;
      } else {
        repro::clear_patch_row(rpix, rh, rw, r);
      }
    }
    __syncthreads();
    // A: the implicit patches of the tile's rows, past L1 (16-byte chunks
    // through the cursor, slice after slice); B: the weights' rows of the
    // slice at the tile's channels, zeros past its width and past K
    repro::PatchCursor<BM, kThreads, true> cursor(g, rpix, rh, rw, tid);
    auto load_slice = [&](int s, int st) {
      if constexpr (V == 4)
        cursor.load(As + st * kAStage);
      else
        repro::load_patch_slice<V, BM, kThreads, true>(g, rpix, rh, rw,
                                                       As + st * kAStage, s,
                                                       tid);
      float* bs = Bs + st * kBStage;
      if (ly.bvec) {
        const int kr = tid / (kBN / 4), n = (tid % (kBN / 4)) * 4;
        const int kk = s * kBK + kr;
        const bool ok = kk < ly.K && n < width;
        cp_async<4>(bs + kr * kBN + n,
                    ok ? ly.w + static_cast<size_t>(kk) * N + c0 + n : ly.w,
                    ok);
      } else {
#pragma unroll
        for (int j = 0; j < kBK * kBN / kThreads; ++j) {
          const int e = tid + j * kThreads;
          const int kr = e / kBN, n = e % kBN;
          const int kk = s * kBK + kr;
          const bool ok = kk < ly.K && n < width;
          cp_async<1>(bs + kr * kBN + n,
                      ok ? ly.w + static_cast<size_t>(kk) * N + c0 + n
                         : ly.w,
                      ok);
        }
      }
    };
    float acc[TM][kTN], part[TM][kTN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = part[i][j] = 0.f;

    // the ring: stages - 1 slices in flight before the first FMA
    for (int st = 0; st < a.stages - 1; ++st) {
      if (st < n_slices) load_slice(st, st);
      cp_async_commit();
    }
    int stage = 0, wstage = a.stages - 1;
    bool blive = false;
    for (int s = 0; s < n_slices; ++s) {
      // the oldest of the stages - 1 slices in flight has landed
      if (a.stages == 3)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      // "inline": a slice whose staged activations are all zero adds
      // exact zeros, and is skipped
      int slive = 1;
      if (inline_gate)
        slive = __syncthreads_or(repro::patch_slice_any<V, BM, kThreads>(
            As + stage * kAStage, tid));
      else
        __syncthreads();
      // refill the stage every thread finished with last iteration
      if (s + a.stages - 1 < n_slices) load_slice(s + a.stages - 1, wstage);
      cp_async_commit();
      if (slive) {
        const float* as = As + stage * kAStage;
        const float* bs = Bs + stage * kBStage;
#pragma unroll
        for (int k4 = 0; k4 < kBK; k4 += 4) {
          float4 av[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i)
            av[i] = *reinterpret_cast<const float4*>(
                as + (ty + kTY * i) * kLDA + k4);
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
        blive = true;
      }
      if (((s + 1) % kSPB == 0 || s + 1 == n_slices) && blive) {
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
      stage = stage + 1 == a.stages ? 0 : stage + 1;
      wstage = wstage + 1 == a.stages ? 0 : wstage + 1;
    }
    cp_async_wait<0>();
    // each row's values into its owner's slab (4 channels a store where
    // N % 4 == 0)
    const int n0 = tx * kTN;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gr = g0 + ty + kTY * i;
      if (gr >= g_hi || n0 >= width) continue;
      const int o = gr / ly.rows, q = gr - o * ly.rows;
      float* dst = slab_of(c, o) + static_cast<size_t>(q) * N + c0 + n0;
      if (ly.fv == 4) {
        Lane<4>::store(dst, acc[i]);
      } else {
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          if (n0 + j < width) dst[j] = acc[i][j];
      }
    }
    // the next tile rewrites the windows and the ring
    __syncthreads();
  }
}

// 1. the conv of a depthwise layer: each own (row, channel), the taps in
// (kh, kw) order from +0.  A thread keeps its channels for the layer and
// walks the rows; an output's taps are loaded together, then added in
// order (the loads overlap; the sum is the tap loop's).  KW: the kernel
// size, unrolled (0: any, read from the layer)
template <int KW>
__device__ void conv_depthwise(const SegArgs& a, const LayerDesc& ly,
                               Ctx& c, const float* in, long long pix0,
                               long long img_px) {
  constexpr int G = KW > 0 ? KW * KW : kTapGroup;
  const bool inline_gate = a.gate == kGateInline;
  const int HoWo = ly.Ho * ly.Wo, C = ly.C;
  const int kw = KW > 0 ? KW : ly.kw, taps = kw * kw;
  const int lanes = min(C, kThreads), rstep = kThreads / lanes;
  const int n0 = c.tid % lanes, r0 = c.tid / lanes;
  if (r0 >= rstep) return;
  for (int q = r0; q < ly.rows; q += rstep) {
    const int i = slab_row(c, c.rank, q);
    const bool real = i < ly.R;
    int h0 = 0, w0 = 0;
    const float* xrow = in;
    if (real) {
      const int t = ly.howo.div(i), hw = i - t * HoWo;
      const int ho = ly.wo.div(hw), wo = hw - ho * ly.Wo;
      h0 = ho * ly.stride - ly.pad_h;
      w0 = wo * ly.stride - ly.pad_w;
      xrow = in + (pix0 + t * img_px) * C;
    }
    for (int n = n0; n < C; n += lanes) {
      float s = 0.f;
      for (int t0 = 0; real && t0 < taps; t0 += G) {
        float v[G], wt[G];
        unsigned ok = 0;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int tap = t0 + j;
          const int di = KW > 0 ? j / KW : tap / kw;
          const int dj = KW > 0 ? j % KW : tap - di * kw;
          const int hi = h0 + di, wi = w0 + dj;
          const bool in_img = tap < taps && hi >= 0 && hi < ly.H &&
                              wi >= 0 && wi < ly.W;
          // every load issued, from a clamped address: no branch
          const int hc = min(max(hi, 0), ly.H - 1);
          const int wc = min(max(wi, 0), ly.W - 1);
          v[j] = __ldcg(xrow + (hc * ly.W + wc) * C + n);
          wt[j] = __ldg(ly.w + min(tap, taps - 1) * C + n);
          ok |= static_cast<unsigned>(in_img) << j;
        }
#pragma unroll
        for (int j = 0; j < G; ++j)
          if (((ok >> j) & 1) && (!inline_gate || v[j] != 0.f))
            s = repro::dw_tap(s, v[j], wt[j]);
      }
      c.slab[q * C + n] = s;
    }
  }
}

// 3. normalise + affine + LIF of the output pixels this block fires (the
// pooled pixels whose index's class it owns), FV channels a lane; a
// thread keeps its lanes for the layer and walks the pixels, the pool
// window's max taken as its neurons fire.  P: the window unrolled (1, 2,
// or up to kMaxPool, the layer's read at run time)
template <int FV, int P>
__device__ void fire(const SegArgs& a, const LayerDesc& ly, Ctx& c,
                     const float* s_mu, const float* s_r, const float* s_sc,
                     const float* s_bi, float* dst, long long dst_t) {
  const int N = ly.N, HoWo = ly.Ho * ly.Wo;
  const int p = P < kMaxPool ? P : ly.pool;
  const int wp = ly.Wo / p, npix = ly.Ho / p * wp;
  const int cpr = N / FV;                          // lanes a pixel
  const int lanes = min(cpr, kThreads), mstep = kThreads / lanes;
  const int l0 = c.tid % lanes, m0 = c.tid / lanes;
  const int mine = c.cpb * ((npix + 31) >> 5);     // pixels a block
  const int cls0 = c.rank * c.cpb;
  if (m0 >= mstep) return;
  for (int m = m0; m < mine; m += mstep) {
    const int pix = ((m >> c.cpb_log) << 5) + cls0 + (m & (c.cpb - 1));
    if (pix >= npix) continue;
    const int ph = ly.wp.div(pix), pw = pix - ph * wp;
    const int row0 = ph * p * ly.Wo + pw * p;      // the window's first
    for (int ch = l0 * FV; ch < N; ch += lanes * FV) {
      float mu[FV], r[FV], sc[FV], bi[FV];
#pragma unroll
      for (int v = 0; v < FV; ++v) {
        mu[v] = s_mu[ch + v];
        r[v] = s_r[ch + v];
        sc[v] = s_sc[ch + v];
        bi[v] = s_bi[ch + v];
      }
      float u[P][P][FV];
#pragma unroll
      for (int dy = 0; dy < P; ++dy)
#pragma unroll
        for (int dx = 0; dx < P; ++dx)
#pragma unroll
          for (int v = 0; v < FV; ++v) u[dy][dx][v] = a.v_reset;
      for (int t = 0; t < a.T; ++t) {
        float mx[FV];
#pragma unroll
        for (int dy = 0; dy < P; ++dy) {
          if (dy >= p) break;
#pragma unroll
          for (int dx = 0; dx < P; ++dx) {
            if (dx >= p) break;
            const int i = t * HoWo + row0 + dy * ly.Wo + dx;
            const int k = i & 31, o = k >> c.cpb_log;
            const int q = ((i >> 5) << c.cpb_log) + (k & (c.cpb - 1));
            float y[FV];
            Lane<FV>::load(y, slab_of(c, o) + static_cast<size_t>(q) * N +
                                  ch);
#pragma unroll
            for (int v = 0; v < FV; ++v) {
              const float spk = repro::norm_lif_step(
                  y[v], mu[v], r[v], sc[v], bi[v], a.decay, a.v_th,
                  a.v_reset, u[dy][dx][v]);
              mx[v] = dy == 0 && dx == 0 ? spk : fmaxf(mx[v], spk);
            }
          }
        }
        Lane<FV>::store(
            dst + t * dst_t + static_cast<long long>(pix) * N + ch, mx);
      }
    }
  }
}

template <int FV>
__device__ void fire_pooled(const SegArgs& a, const LayerDesc& ly, Ctx& c,
                            const float* s_mu, const float* s_r,
                            const float* s_sc, const float* s_bi, float* dst,
                            long long dst_t) {
  if (ly.pool <= 1)
    fire<FV, 1>(a, ly, c, s_mu, s_r, s_sc, s_bi, dst, dst_t);
  else if (ly.pool == 2)
    fire<FV, 2>(a, ly, c, s_mu, s_r, s_sc, s_bi, dst, dst_t);
  else
    fire<FV, kMaxPool>(a, ly, c, s_mu, s_r, s_sc, s_bi, dst, dst_t);
}

// the conv at the layer's row tile (32 * TM rows, TM = 1..8); two blocks
// an SM (MINB = 2, 128 registers a thread) take TM <= 4
template <int V, int MINB>
__device__ void conv_rows(const SegArgs& a, const LayerDesc& ly, Ctx& c,
                          const float* in, long long pix0, long long img_px) {
  if constexpr (MINB == 1) {
    switch (ly.bm / kTY) {
      case 8: conv_tiles<V, 8>(a, ly, c, in, pix0, img_px); return;
      case 7: conv_tiles<V, 7>(a, ly, c, in, pix0, img_px); return;
      case 6: conv_tiles<V, 6>(a, ly, c, in, pix0, img_px); return;
      case 5: conv_tiles<V, 5>(a, ly, c, in, pix0, img_px); return;
      default: break;
    }
  }
  switch (ly.bm / kTY) {
    case 4: conv_tiles<V, 4>(a, ly, c, in, pix0, img_px); break;
    case 3: conv_tiles<V, 3>(a, ly, c, in, pix0, img_px); break;
    case 2: conv_tiles<V, 2>(a, ly, c, in, pix0, img_px); break;
    default: conv_tiles<V, 1>(a, ly, c, in, pix0, img_px); break;
  }
}

// MINB: the blocks an SM the registers leave room for (1 or 2)
template <int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
backbone_segment_kernel(const __grid_constant__ SegArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = 1 << a.cs_log, cpb = 1 << a.cpb_log;
  Ctx c{cl, smem, reinterpret_cast<float*>(smem + a.slab_off),
        static_cast<int>(cl.block_rank()), cs, cpb, a.cpb_log,
        static_cast<int>(blockIdx.x >> a.cs_log), static_cast<int>(threadIdx.x)};
  const int tid = c.tid, cls0 = c.rank * cpb;
  double* red = reinterpret_cast<double*>(smem);
  double* red_var = red + cpb * a.max_n;
  float* s_mu = reinterpret_cast<float*>(red_var + cpb * a.max_n);
  float* s_r = s_mu + a.max_n;
  float* s_sc = s_r + a.max_n;
  float* s_bi = s_sc + a.max_n;
  // a cluster of one block (a plain launch) needs only block barriers
  auto arrive = [&]() {
    if (cs == 1)
      __syncthreads();
    else
      cluster_arrive();
  };
  auto wait = [&]() {
    if (cs > 1) cluster_wait();
  };
  // no block touches a peer's shared memory before every block of the
  // cluster runs: the first barrier is arrived at here and waited on
  // before the first spread conv's stores or after the first conv
  if (cs > 1) cluster_arrive();

  for (int l = 0; l < a.L; ++l) {
    const LayerDesc& ly = a.layer[l];
    const int N = ly.N, R = ly.R;
    // this layer's input: x (image t at pixel t*B*H*W + b*H*W), or the
    // previous layer's spikes (the element's buffer, image t at t*H*W)
    const float* in = l == 0 ? a.x : a.act[(l - 1) & 1] + c.b * a.act_stride;
    const long long hw_in = static_cast<long long>(ly.H) * ly.W;
    const long long pix0 = l == 0 ? c.b * hw_in : 0;
    const long long img_px = l == 0 ? a.B * hw_in : hw_in;

    // the layer's affine, read while the conv runs
    for (int n = tid; n < N; n += kThreads) {
      s_sc[n] = __ldg(ly.scale + n);
      s_bi[n] = __ldg(ly.bias + n);
    }
    // 1. the conv into the slabs
    if (l == 0 && ly.spread) wait();
    if (ly.depthwise && ly.kw == 3)
      conv_depthwise<3>(a, ly, c, in, pix0, img_px);
    else if (ly.depthwise)
      conv_depthwise<0>(a, ly, c, in, pix0, img_px);
    else if (ly.v == 4)
      conv_rows<4, MINB>(a, ly, c, in, pix0, img_px);
    else
      conv_rows<1, MINB>(a, ly, c, in, pix0, img_px);
    if (l == 0 && !ly.spread) wait();
    // a spread conv stored into its peers' slabs
    if (ly.spread) {
      arrive();
      wait();
    } else {
      __syncthreads();
    }

    // 2. the statistics: one thread a (class, channel) chain, in row
    // order; the 32 class sums of a channel gathered from the cluster in
    // class order
    const int chains = cpb * N;
    auto class_sums = [&](double* dst, auto term) {
      for (int p = tid; p < chains; p += kThreads) {
        const int lc = p / N, ch = p - lc * N;
        const int cls = cls0 + lc;
        const int n_cls = cls < R ? (R - cls + 31) >> 5 : 0;
        dst[p] = chain_sum(0.0, 0, n_cls, [&](int j) {
          return term(c.slab[(j * cpb + lc) * N + ch], ch);
        });
      }
    };
    auto total = [&](const double* src, int n) {
      double v[kRowClasses];
#pragma unroll
      for (int k = 0; k < kRowClasses; ++k) {
        const int o = k >> a.cpb_log;
        const double* p = o == c.rank ? src : cl.map_shared_rank(src, o);
        v[k] = p[(k & (cpb - 1)) * N + n];
      }
      double s = 0.0;
#pragma unroll
      for (int k = 0; k < kRowClasses; ++k) s += v[k];
      return s;
    };
    class_sums(red, [](float y, int) { return static_cast<double>(y); });
    arrive();
    wait();
    for (int n = tid; n < N; n += kThreads)
      s_mu[n] = repro::mean_of(total(red, n), R);
    __syncthreads();
    class_sums(red_var,
               [&](float y, int ch) { return repro::sq_dev(y, s_mu[ch]); });
    arrive();
    wait();
    for (int n = tid; n < N; n += kThreads)
      s_r[n] = repro::inv_std(total(red_var, n), R, a.eps);
    __syncthreads();

    // 3. normalise + affine + LIF (+ pool) into the next layer's input or
    // the output
    const int p = ly.pool > 0 ? ly.pool : 1;
    const long long npix = static_cast<long long>(ly.Ho / p) * (ly.Wo / p);
    float* dst;
    long long dst_t;
    if (l == a.L - 1) {
      dst = a.out + c.b * npix * N;
      dst_t = a.B * npix * N;
    } else {
      dst = a.act[l & 1] + c.b * a.act_stride;
      dst_t = npix * N;
    }
    if (ly.fv == 4)
      fire_pooled<4>(a, ly, c, s_mu, s_r, s_sc, s_bi, dst, dst_t);
    else
      fire_pooled<1>(a, ly, c, s_mu, s_r, s_sc, s_bi, dst, dst_t);
    // the spikes visible to the cluster; no block leaves or rewrites its
    // slab while a peer may still read it
    __threadfence();
    arrive();
    wait();
  }
}

}  // namespace

// dims: per layer H, W, C, Ho, Wo, N, kernel, stride, pad_h, pad_w,
// depthwise, pool, then the plan's bm (32 to 256 cluster rows a tile, a
// multiple of 32), spread (0: own rows, 1: the cluster's tiles dealt round) and ct
// (channels a tile, <= 32): 15 ints; ptrs: per layer w, scale, bias.  gate
// 1 "inline" or 2 "none"; cluster the blocks per batch element (1, 2, 4, 8
// or 16); stages the cp.async ring's depth (2 or 3); occupancy the blocks
// an SM the kernel's registers leave room for (1, or 2: tiles of at most
// 128 rows);
// act0/act1 the spike
// buffers, act_stride floats per batch element (a multiple of 4).  The
// plan is made in Python (kernels/backbone_segment.py segment_plan) and
// checked here.  Returns a cudaError_t, or -1 when the card cannot
// schedule the cluster.
extern "C" int backbone_segment_launch(
    const int* dims, const void* const* ptrs, int L, int T, int B, int gate,
    float decay, float v_th, float v_reset, float eps, const float* x,
    float* out, float* act0, float* act1, int64_t act_stride, int cluster,
    int stages, int occupancy, void* stream) {
  const int cs_log = repro::log2_exact(cluster);
  if (L < 1 || L > kMaxLayers || B < 1 || T < 1 || cs_log < 0 ||
      cluster > kMaxCluster || (int64_t)B * cluster >= (int64_t(1) << 31) ||
      (gate != kGateInline && gate != kGateNone) ||
      (stages != 2 && stages != 3) || act_stride % 4 != 0 ||
      (occupancy != 1 && occupancy != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cpb = kRowClasses / cluster;
  SegArgs a{};
  int max_n = 1, max_bm = kTY;
  size_t max_slab = 0;
  for (int l = 0; l < L; ++l) {
    const int* v = dims + 15 * l;
    LayerDesc& ly = a.layer[l];
    ly.H = v[0];
    ly.W = v[1];
    ly.C = v[2];
    ly.Ho = v[3];
    ly.Wo = v[4];
    ly.N = v[5];
    ly.kw = v[6];
    ly.stride = v[7];
    ly.pad_h = v[8];
    ly.pad_w = v[9];
    ly.depthwise = v[10];
    ly.pool = v[11];
    ly.bm = v[12];
    ly.spread = v[13];
    ly.ct = v[14];
    ly.w = static_cast<const float*>(ptrs[3 * l]);
    ly.scale = static_cast<const float*>(ptrs[3 * l + 1]);
    ly.bias = static_cast<const float*>(ptrs[3 * l + 2]);
    const int64_t R = (int64_t)T * ly.Ho * ly.Wo;
    const int64_t K = (int64_t)ly.kw * ly.kw * ly.C;
    if (ly.H < 1 || ly.W < 1 || ly.C < 1 || ly.Ho < 1 || ly.Wo < 1 ||
        ly.N < 1 || ly.kw < 1 || ly.stride < 1 || ly.stride > 2 ||
        ly.pool < 0 || ly.pool > kMaxPool ||
        (ly.depthwise && ly.N != ly.C) || R >= (int64_t(1) << 31) ||
        K >= (int64_t(1) << 31) ||
        ly.bm % kTY != 0 || ly.bm < kTY || ly.bm > 8 * kTY ||
        (occupancy == 2 && ly.bm > 4 * kTY) ||
        (ly.spread != 0 && ly.spread != 1) || ly.ct < 1 || ly.ct > kBN)
      return static_cast<int>(cudaErrorInvalidValue);
    // an interior layer's spikes fit a batch element's buffer
    const int p = ly.pool ? ly.pool : 1;
    if (l < L - 1 && (int64_t)T * (ly.Ho / p) * (ly.Wo / p) * ly.N > act_stride)
      return static_cast<int>(cudaErrorInvalidValue);
    ly.K = (int)K;
    ly.R = (int)R;
    ly.rows = cpb * (int)((R + kRowClasses - 1) / kRowClasses);
    ly.tiles_n = (ly.N + ly.ct - 1) / ly.ct;
    const uintptr_t in = l == 0 ? reinterpret_cast<uintptr_t>(x)
                                : reinterpret_cast<uintptr_t>(act0) |
                                      reinterpret_cast<uintptr_t>(act1);
    ly.v = ly.C % 4 == 0 && in % 16 == 0 ? 4 : 1;
    ly.bvec = ly.N % 4 == 0 && ly.ct % 4 == 0 &&
              reinterpret_cast<uintptr_t>(ly.w) % 16 == 0;
    const uintptr_t dst = l == L - 1 ? reinterpret_cast<uintptr_t>(out)
                                     : reinterpret_cast<uintptr_t>(act0) |
                                           reinterpret_cast<uintptr_t>(act1);
    ly.fv = ly.N % 4 == 0 && dst % 16 == 0 ? 4 : 1;
    ly.howo = FastDiv(ly.Ho * ly.Wo);
    ly.wo = FastDiv(ly.Wo);
    ly.wp = FastDiv(std::max(ly.Wo / p, 1));
    max_n = std::max(max_n, ly.N);
    if (!ly.depthwise) max_bm = std::max(max_bm, ly.bm);
    max_slab = std::max(max_slab, sizeof(float) * ly.rows * ly.N);
  }
  const size_t slab_off = align16((2 * sizeof(double) * cpb +
                                   4 * sizeof(float)) * max_n);
  const size_t ring_off = slab_off + align16(max_slab);
  const size_t tab_off =
      ring_off + sizeof(float) * stages * ((size_t)max_bm * kLDA + kBK * kBN);
  const size_t smem = tab_off + (sizeof(long long) + 2 * sizeof(int)) * max_bm;
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  a.x = x;
  a.out = out;
  a.act[0] = act0;
  a.act[1] = act1;
  a.act_stride = act_stride;
  a.L = L;
  a.T = T;
  a.B = B;
  a.gate = gate;
  a.stages = stages;
  a.cs_log = cs_log;
  a.cpb_log = repro::log2_exact(cpb);
  a.max_n = max_n;
  a.slab_off = (int)slab_off;
  a.ring_off = (int)ring_off;
  a.tab_off = (int)tab_off;
  a.decay = decay;
  a.v_th = v_th;
  a.v_reset = v_reset;
  a.eps = eps;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (occupancy == 2)
    return repro::launch_cluster(backbone_segment_kernel<2>, a, B * cluster,
                                 cluster, kThreads, smem, kMaxSmem, st);
  return repro::launch_cluster(backbone_segment_kernel<1>, a, B * cluster,
                               cluster, kThreads, smem, kMaxSmem, st);
}
