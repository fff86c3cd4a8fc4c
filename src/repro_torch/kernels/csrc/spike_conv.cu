// Activity-gated spike convolution read straight from the folded spikes
// (implicit im2col): out[M, N] = patches(x)[M, K] @ wmat[K, N], with
//   x [Nimg, H, W, C] fp32 NHWC, wmat [kh*kw*C, N] (HWIO reshaped),
//   row m = (n, ho, wo), column k = tap*C + c, tap = dy*kw + dx,
// exactly the order of spike_im2col; SAME pads come in as ints, and a tap
// outside the image reads zero.  No patch matrix exists anywhere.
//
// Replaces the TPU kernel spike_conv_pallas (src/repro/kernels/spike_conv.py)
// on the per-op route.  Its arithmetic is the canonical-block contract of
// spike_mac.cuh, bit for bit the gated_gemm.cuh GEMM on materialised
// patches: K in 128-wide blocks, in order; a block's partial an fmaf chain
// from +0 over its k in order; partials added with __fadd_rn; an all-zero
// block (or slice, or element) adds nothing, so skipping it changes no bit.
//
// What bounds it on the H100: fp32 operations.  The ten convs of a YOLO
// tick at batch 8 need ~5.4 GFLOP on live tiles (0.08 ms at 67 TFLOP/s)
// against ~21 MB of activations, weights and outputs (6 us at 3.35 TB/s);
// the tensor cores are out of reach because TF32 rounds the weights and
// an mma's internal order of summation is not the fmaf chain.  So the
// limits are the FMA issue rate and what feeds it: shared-memory reads
// per FMA, the L2 -> SM stream of the implicit patches (each tap re-reads
// its pixels), and SM fill on the small-M layers.  The design:
//   * 128-row output tiles, 32/64/128 columns from cout (spike_conv.py
//     conv_tiles); each thread owns an 8 x 4 register tile (8 x 8 at 128
//     columns), so 128 threads at 32 columns and 256 otherwise; each
//     16-byte shared read of A feeds 4 k-steps, of B 8 rows;
//   * a 3-stage cp.async ring of 32-deep K slices (a slice never straddles
//     a canonical block) in dynamic shared memory: the next slices' copies
//     are in flight during this slice's FMAs.  A is fetched as 16-, 8- or
//     4-byte channel chunks (C % 4, C % 2, else) with src-size 0 zero-fill
//     for padding taps and ragged edges (patch_stage.cuh, shared with the
//     fused conv->LIF kernel), B as 16-byte rows (4-byte when
//     cout % 4 != 0);
//   * split-K at canonical-block granularity where the output tiles alone
//     are fewer than the SMs: a block takes kgroup consecutive K blocks of
//     its tile (as many groups as fill one wave), writes each K block's
//     partial to an fp32 workspace [kblocks, M, N] with a live flag beside
//     it, and a second kernel adds the live partials in block order with
//     __fadd_rn -- the serial loop's bits;
//   * gates: "inline" ORs the staged A slices and skips an all-zero
//     slice's FMAs (a K block with no live slice is not added and, under
//     split-K, clears its live flag); "mask" first checks, per K block of
//     its range, that block's patch elements at its rows in x (the 128 x
//     128 occupancy tiles of the patch matrix; no pass of its own, and a
//     K block is done at its first non-zero chunk), then never copies or
//     multiplies the dead blocks; "none" computes every block.
// Grid: row tiles on gridDim.x (up to 2^31 - 1), column tiles on gridDim.y,
// K blocks on gridDim.z under split-K.  Offsets are size_t.
#include <cuda_runtime.h>
#include <stdint.h>

#include "patch_stage.cuh"
#include "spike_mac.cuh"

namespace {

using repro::cp_async;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::kCanonicalK;
using repro::kblock_add;
using repro::kblock_fma;

constexpr int kBM = 128;                 // output rows per block
constexpr int kBK = repro::kPatchBK;     // K slice per ring stage
constexpr int kSPB = repro::kSlicesPerBlock;  // slices per canonical block
constexpr int kStages = 3;
constexpr int kTM = 8;                   // output rows per thread
constexpr int kTY = kBM / kTM;           // thread rows of a block
constexpr int kLDA = repro::kPatchLDA;   // padded A row (floats)

// columns per thread, threads across the columns, threads of a block
template <int BN>
__host__ __device__ constexpr int tile_n() { return BN == 128 ? 8 : 4; }
template <int BN>
__host__ __device__ constexpr int tile_x() { return BN / tile_n<BN>(); }
template <int BN>
__host__ __device__ constexpr int threads() { return kTY * tile_x<BN>(); }

enum Gate { kGateMask = 0, kGateInline = 1, kGateNone = 2 };

struct ConvArgs {
  const float* x;
  const float* w;
  float* out;
  float* ws;               // split-K: partials [kblocks, M, N]
  int* flags;              // split-K: live [kblocks, row_tiles, col_tiles]
  int H, W, C, Wo, HWo, kw, stride, pad_h, pad_w;
  int M, K, N, kblocks, row_tiles, col_tiles;
  int gate, kgroup, bvec;  // kgroup > 0: split-K, K blocks per block
};

// column of a thread's j-th output within the tile: groups of 4 adjacent
// columns, 4 * tile_x apart, so a warp's shared reads of B are
// conflict-free
template <int BN>
__device__ __forceinline__ int tile_col(int tx, int j) {
  return (j / 4) * (4 * tile_x<BN>()) + tx * 4 + j % 4;
}

template <int V, int BN>
__global__ void __launch_bounds__(threads<BN>())
spike_conv_kernel(const ConvArgs a) {
  constexpr int TN = tile_n<BN>();
  constexpr int TX = tile_x<BN>();
  constexpr int kThreads = threads<BN>();
  constexpr int kAStage = kBM * kLDA;
  constexpr int kBStage = kBK * BN;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + kStages * kAStage;
  long long* rpix = reinterpret_cast<long long*>(Bs + kStages * kBStage);
  int* rh = reinterpret_cast<int*>(rpix + kBM);
  int* rw = rh + kBM;
  int* live = rw + kBM;                  // per K block of this block's range

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * BN;
  const bool split = a.kgroup > 0;
  const int kb0 = split ? blockIdx.z * a.kgroup : 0;
  const int kb1 = split ? min(kb0 + a.kgroup, a.kblocks) : a.kblocks;
  const int s_begin = kb0 * kSPB;
  const int s_end = min(kb1 * kSPB, (a.K + kBK - 1) / kBK);

  // each row's image base and the top-left input pixel of its window;
  // a row past M gets an out-of-image window (zero-filled loads)
  for (int r = tid; r < kBM; r += kThreads) {
    const long long m = m0 + r;
    if (m < a.M) {
      const long long n = m / a.HWo;
      const int rem = static_cast<int>(m - n * a.HWo);
      const int ho = rem / a.Wo, wo = rem - ho * a.Wo;
      repro::set_patch_row(rpix, rh, rw, r, n, a.H, a.W, ho, wo, a.stride,
                           a.pad_h, a.pad_w);
    } else {
      repro::clear_patch_row(rpix, rh, rw, r);
    }
  }
  for (int i = tid; i < kb1 - kb0; i += kThreads)
    live[i] = a.gate == kGateMask ? 0 : 1;
  // split-K: every K block of the range starts not live; tid 0 sets the
  // flag of each K block it adds (program order keeps the last write)
  size_t flag0 = 0;
  if (split) {
    flag0 = (static_cast<size_t>(kb0) * a.row_tiles + blockIdx.x) *
                a.col_tiles + blockIdx.y;
    if (tid == 0)
      for (int kb = kb0; kb < kb1; ++kb)
        a.flags[flag0 + static_cast<size_t>(kb - kb0) * a.row_tiles *
                            a.col_tiles] = 0;
  }
  __syncthreads();
  const repro::PatchSrc g{a.x, a.H, a.W, a.C, a.kw, a.K};
  if (a.gate == kGateMask) {
    // a K block is live if a patch element of it at one of this block's
    // rows is non-zero (the 128 x 128 occupancy tiles of the patch matrix)
    repro::mark_live_blocks<V, kBM, kThreads>(g, rpix, rh, rw, live, kb0,
                                              kb1 - kb0, tid);
    __syncthreads();
  }
  // the first slice at or after s inside a live K block
  auto live_from = [&](int s) {
    while (s < s_end && !live[s / kSPB - kb0]) s = (s / kSPB + 1) * kSPB;
    return s;
  };

  // A: the implicit patches; B: the weights' rows of the slice
  auto load_slice = [&](int s, int st) {
    repro::load_patch_slice<V, kBM, kThreads>(g, rpix, rh, rw,
                                              As + st * kAStage, s, tid);
    float* bs = Bs + st * kBStage;
    if (a.bvec) {
      constexpr int BCH = BN / 4;
#pragma unroll
      for (int j = 0; j < kBK * BCH / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int kr = i / BCH, nc = i % BCH;
        const int kk = s * kBK + kr, n = n0 + nc * 4;
        const bool ok = kk < a.K && n < a.N;
        cp_async<4>(bs + kr * BN + nc * 4,
                    ok ? a.w + static_cast<size_t>(kk) * a.N + n : a.w, ok);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kBK * BN / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int kr = i / BN, nn = i % BN;
        const int kk = s * kBK + kr, n = n0 + nn;
        const bool ok = kk < a.K && n < a.N;
        cp_async<1>(bs + kr * BN + nn,
                    ok ? a.w + static_cast<size_t>(kk) * a.N + n : a.w, ok);
      }
    }
  };
  const int tx = tid % TX, ty = tid / TX;
  float acc[kTM][TN], part[kTM][TN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = part[i][j] = 0.f;

  auto compute = [&](int st) {
    const float* as = As + st * kAStage;
    const float* bs = Bs + st * kBStage;
#pragma unroll 2
    for (int k4 = 0; k4 < kBK; k4 += 4) {
      float4 av[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + (ty + kTY * i) * kLDA +
                                                 k4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* brow = bs + (k4 + q) * BN;
        float b[TN];
#pragma unroll
        for (int g = 0; g < TN / 4; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(
              brow + tile_col<BN>(tx, 4 * g));
          b[4 * g] = v.x;
          b[4 * g + 1] = v.y;
          b[4 * g + 2] = v.z;
          b[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float ai = q == 0 ? av[i].x : q == 1 ? av[i].y
                         : q == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j)
            part[i][j] = kblock_fma(ai, b[j], part[i][j]);
        }
      }
    }
  };

  // this thread's outputs of the tile into dst [M, N]
  auto store_tile = [&](float* dst, const float (&v)[kTM][TN]) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const long long m = m0 + ty + kTY * i;
      if (m >= a.M) continue;
      float* row = dst + static_cast<size_t>(m) * a.N;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tile_col<BN>(tx, j);
        if (n < a.N) row[n] = v[i][j];
      }
    }
  };

  // the ring: STAGES-1 slices in flight before the first FMA
  int ps = live_from(s_begin);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (ps < s_end) {
      load_slice(ps, st);
      ps = live_from(ps + 1);
    }
    cp_async_commit();
  }
  int cs = live_from(s_begin), stage = 0, wstage = kStages - 1;
  bool blive = false;
  while (cs < s_end) {
    cp_async_wait<kStages - 2>();
    int slive = 1;
    if (a.gate == kGateInline)
      slive = __syncthreads_or(repro::patch_slice_any<V, kBM, kThreads>(
          As + stage * kAStage, tid));
    else
      __syncthreads();
    // refill the stage every thread finished with last iteration
    if (ps < s_end) {
      load_slice(ps, wstage);
      ps = live_from(ps + 1);
    }
    cp_async_commit();
    if (slive) {
      compute(stage);
      blive = true;
    }
    const int next = live_from(cs + 1);
    if ((next >= s_end || next / kSPB != cs / kSPB) && blive) {
      // the canonical block ends with a live slice: add its partial, or
      // under split-K write it out for the ordered reduce
      const int kb = cs / kSPB;
      if (split) {
        if (tid == 0)
          a.flags[flag0 + static_cast<size_t>(kb - kb0) * a.row_tiles *
                              a.col_tiles] = 1;
        store_tile(a.ws + static_cast<size_t>(kb) * a.M * a.N, part);
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          if (!split) acc[i][j] = kblock_add(acc[i][j], part[i][j]);
          part[i][j] = 0.f;
        }
      blive = false;
    }
    cs = next;
    stage = stage + 1 == kStages ? 0 : stage + 1;
    wstage = wstage + 1 == kStages ? 0 : wstage + 1;
  }
  cp_async_wait<0>();
  if (!split) store_tile(a.out, acc);
}

// split-K: out = the live K blocks' partials added in block order from +0
__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     const int* __restrict__ flags,
                                     float* __restrict__ out, int M, int N,
                                     int kblocks, int row_tiles,
                                     int col_tiles, int bn) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long mn = static_cast<long long>(M) * N;
  if (i >= mn) return;
  const int m = static_cast<int>(i / N), n = static_cast<int>(i % N);
  const int rt = m / kBM, ct = n / bn;
  float acc = 0.f;
  for (int kb = 0; kb < kblocks; ++kb)
    if (flags[(static_cast<size_t>(kb) * row_tiles + rt) * col_tiles + ct])
      acc = kblock_add(acc, ws[static_cast<size_t>(kb) * mn + i]);
  out[i] = acc;
}

template <int V, int BN>
cudaError_t launch_conv(const ConvArgs& a, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * kStages * (kBM * kLDA + kBK * BN) +
      kBM * (sizeof(long long) + 2 * sizeof(int)) +
      sizeof(int) * (a.kgroup > 0 ? a.kgroup : a.kblocks);
  const cudaError_t e = cudaFuncSetAttribute(
      spike_conv_kernel<V, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(a.row_tiles, a.col_tiles,
                  a.kgroup > 0 ? (a.kblocks + a.kgroup - 1) / a.kgroup : 1);
  spike_conv_kernel<V, BN><<<grid, threads<BN>(), smem, s>>>(a);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_width(const ConvArgs& a, int bn, cudaStream_t s) {
  if (bn == 32) return launch_conv<V, 32>(a, s);
  if (bn == 64) return launch_conv<V, 64>(a, s);
  return launch_conv<V, 128>(a, s);
}

}  // namespace

// x [Nimg, H, W, C], w [kh*kw*C, N], out [Nimg*Ho*Wo, N]; bn the column
// tile (32, 64 or 128) and kgroup the K blocks per split-K block (0: no
// split) of spike_conv.py conv_tiles; gate 0 "mask", 1 "inline", 2
// "none"; under split-K, ws holds kblocks*M*N floats and flags
// kblocks*row_tiles*col_tiles ints.
extern "C" int spike_conv_launch(const float* x, const float* w, float* out,
                                 float* ws, int* flags, int Nimg, int H,
                                 int W, int C, int Ho, int Wo, int kh, int kw,
                                 int stride, int pad_h, int pad_w, int N,
                                 int bn, int kgroup, int gate, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((gate != kGateMask && gate != kGateInline && gate != kGateNone) ||
      (bn != 32 && bn != 64 && bn != 128) || C <= 0 || N <= 0 ||
      kgroup < 0 || (kgroup > 0 && (ws == nullptr || flags == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a;
  a.x = x;
  a.w = w;
  a.out = out;
  a.ws = ws;
  a.flags = flags;
  a.H = H;
  a.W = W;
  a.C = C;
  a.Wo = Wo;
  a.HWo = Ho * Wo;
  a.kw = kw;
  a.stride = stride;
  a.pad_h = pad_h;
  a.pad_w = pad_w;
  a.M = Nimg * Ho * Wo;
  a.K = kh * kw * C;
  a.N = N;
  a.kblocks = (a.K + kCanonicalK - 1) / kCanonicalK;
  a.row_tiles = (a.M + kBM - 1) / kBM;
  a.col_tiles = (N + bn - 1) / bn;
  a.gate = gate;
  a.kgroup = kgroup;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  a.bvec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int V = (C % 4 == 0 && xa % 16 == 0) ? 4
              : (C % 2 == 0 && xa % 8 == 0) ? 2 : 1;
  const cudaError_t e = V == 4 ? launch_width<4>(a, bn, s)
                      : V == 2 ? launch_width<2>(a, bn, s)
                               : launch_width<1>(a, bn, s);
  if (e != cudaSuccess || kgroup == 0) return static_cast<int>(e);
  const long long mn = static_cast<long long>(a.M) * N;
  splitk_reduce_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0,
                         s>>>(ws, flags, out, a.M, N, a.kblocks, a.row_tiles,
                              a.col_tiles, bn);
  return static_cast<int>(cudaGetLastError());
}
