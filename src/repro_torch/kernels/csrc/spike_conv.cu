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
//     for padding taps and ragged edges, B as 16-byte rows (4-byte when
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

#include "spike_mac.cuh"

namespace {

using repro::kCanonicalK;
using repro::kblock_add;
using repro::kblock_fma;

constexpr int kBM = 128;                 // output rows per block
constexpr int kBK = 32;                  // K slice per ring stage
constexpr int kSPB = kCanonicalK / kBK;  // slices per canonical block
constexpr int kStages = 3;
constexpr int kTM = 8;                   // output rows per thread
constexpr int kTY = kBM / kTM;           // thread rows of a block
constexpr int kLDA = kBK + 4;            // padded A row (floats)
static_assert(kCanonicalK % kBK == 0, "a slice must not straddle a block");

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

// any non-zero among the V floats at p (aligned to V floats)
template <int V>
__device__ __forceinline__ bool chunk_nonzero(const float* p) {
  if (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    return v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
  }
  if (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    return v.x != 0.f || v.y != 0.f;
  }
  return *p != 0.f;
}

template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 4 * V : 0;          // src-size 0: zero-fill
  if (V == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else if (V == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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
  constexpr int ACH = kBK / V;           // A chunks per row of a slice
  constexpr int AROWS = kThreads / ACH;  // rows per pass of the threads
  constexpr int APASS = kBM / AROWS;
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
      rpix[r] = n * a.H * a.W;
      rh[r] = ho * a.stride - a.pad_h;
      rw[r] = wo * a.stride - a.pad_w;
    } else {
      rpix[r] = 0;
      rh[r] = -(1 << 29);
      rw[r] = 0;
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
  if (a.gate == kGateMask) {
    // a K block is live if a patch element of it at one of this block's
    // rows is non-zero.  One item is 4 chunks of V consecutive k at one
    // row, its 4 loads in flight together; items run K block fastest, then
    // k, then row, so the first pass of the threads looks at every K block
    // and the later items mostly find theirs marked already
    constexpr int SEG = 4 * V;
    constexpr int NSEG = kCanonicalK / SEG;
    const int nkb = kb1 - kb0;
    for (int i = tid; i < kBM * nkb * NSEG; i += kThreads) {
      const int b = i % nkb, rest = i / nkb;
      const int r = rest / NSEG;
      if (live[b]) continue;
      const int k0 = (kb0 + b) * kCanonicalK + (rest % NSEG) * SEG;
      bool any = false;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + j * V;
        const int t = k / a.C, c = k - t * a.C;
        const int dy = t / a.kw, dx = t - dy * a.kw;
        const int h = rh[r] + dy, w = rw[r] + dx;
        if (k < a.K && h >= 0 && h < a.H && w >= 0 && w < a.W)
          any |= chunk_nonzero<V>(
              a.x + static_cast<size_t>(rpix[r] +
                                        static_cast<long long>(h) * a.W + w) *
                        a.C + c);
      }
      if (any) live[b] = 1;
    }
    __syncthreads();
  }
  // the first slice at or after s inside a live K block
  auto live_from = [&](int s) {
    while (s < s_end && !live[s / kSPB - kb0]) s = (s / kSPB + 1) * kSPB;
    return s;
  };

  // A loader: each thread copies one fixed chunk column of APASS rows
  const int a_kc = tid % ACH, a_r0 = tid / ACH;
  auto load_slice = [&](int s, int st) {
    float* as = As + st * kAStage;
    const int k = s * kBK + a_kc * V;
    const bool kin = k < a.K;
    int c = 0, dy = 0, dx = 0;
    if (kin) {
      const int tap = k / a.C;
      c = k - tap * a.C;
      dy = tap / a.kw;
      dx = tap - dy * a.kw;
    }
#pragma unroll
    for (int p = 0; p < APASS; ++p) {
      const int r = a_r0 + p * AROWS;
      const int h = rh[r] + dy, w = rw[r] + dx;
      const bool ok = kin && h >= 0 && h < a.H && w >= 0 && w < a.W;
      const float* src =
          ok ? a.x + (static_cast<size_t>(rpix[r] +
                                          static_cast<long long>(h) * a.W +
                                          w) * a.C + c)
             : a.x;
      cp_async<V>(as + r * kLDA + a_kc * V, src, ok);
    }
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
  // "inline": any non-zero among the chunks this thread copied
  auto own_any = [&](int st) {
    const float* as = As + st * kAStage;
    int any = 0;
#pragma unroll
    for (int p = 0; p < APASS; ++p) {
      const float* q = as + (a_r0 + p * AROWS) * kLDA + a_kc * V;
#pragma unroll
      for (int v = 0; v < V; ++v) any |= q[v] != 0.f;
    }
    return any;
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
      slive = __syncthreads_or(own_any(stage));
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
