// Blocked flash attention with an online softmax, GQA by index.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// `flash_attention_pallas` (its pl.pallas_call), and computes the
// function of its jnp twin, src/repro/models/attention.py
// `flash_attention`, on the model's layout:
//
//   q [B, Sq, Hq, D], k [B, Sk, Hkv, D], v [B, Sk, Hkv, DV] -> o [B, Sq, Hq, DV]
//
// query head h reads KV head h / (Hq / Hkv) (what the reference's
// jnp.repeat of k and v gives, with no copy); s = (q . k) * scale, scale
// = D^-0.5; key j is visible to query row i (absolute position
// p = i + q_offset) when j < Sk, and j <= p if causal, and j > p - window
// if window > 0; the running max m, running sum l and an f32 accumulator
// per row; o = acc / max(l, 1e-30), in q's type.  A masked key adds an
// exact 0 to l and acc (the reference's exp(-1e30 - m) is 0 once a row
// has seen a visible key, and a row's earlier all-masked blocks are
// wiped by its correction exp(-1e30 - m) = 0), so the kernels skip every
// key tile that no row of their query tile can see: the causal future,
// the keys behind the window, the padding past Sk.  A row that sees no
// key at all (only with a window and q_offset past Sk + window) gives 0
// here, where the reference's scan gives a mean of v over its padded
// blocks; no caller of the model makes such a row.
//
// Bound on an H100 SXM at the prefill shape (B 2, S 4096, causal, Hq 28,
// Hkv 4, D = DV = 128, bf16): 8.39 M visible (q, k) pairs per (batch,
// head), 4 D flops each, ~240 GFLOP a layer = 0.24 ms at the 989 TFLOP/s
// bf16 dense tensor-core peak, against ~134 MB of q, k, v and o = 0.04
// ms at 3.35 TB/s: bound by operations, so the design is about keeping
// the tensor cores fed.  Three designs, chosen by the caller
// (kernels/flash_attention.py `kernel_design`) from the type and (D, DV)
// alone:
//
// "wgmma" (bf16, (D, DV) = (128, 128) or (64, 64); every full-width LM
// config's head): only wgmma reaches the tensor cores' full rate on
// Hopper.  A persistent grid of one 384-thread block per SM walks a
// work list of (128-row query tile, batch, query head) items, causal
// tiles longest first and the G query heads of one KV head adjacent (so
// their K/V tiles are read from L2), the blocks taking the list in
// zigzag rounds (block x takes item x of even rounds and grid-1-x of
// odd ones), which evens out the causal tiles' unequal lengths.  One
// producer thread issues TMA loads (cp.async.bulk.tensor, 128-byte
// swizzle, boxes of 64 head columns): Q into one of two buffers, so the
// next item's Q arrives while this one runs, and K and V per 128-key
// tile into a 2-stage ring, each stage with a full and an empty
// mbarrier for K and for V; keys past Sk and rows past Sq arrive as
// zeros.  Two consumer warpgroups (setmaxnreg: 240 registers each, the
// producer's 24) own 64 query rows each: S = Q K^T by wgmma m64n128k16
// from shared memory (both K-major), the softmax in the log2 domain on
// ex2 (the mask only on tiles that straddle the diagonal, the window's
// edge or the ragged end), then O += P V by wgmma with P from registers
// (the S accumulators packed to bf16 pairs: the accumulator layout is
// the A-operand layout) and V read MN-major through the transpose bit,
// no copy of V.  Tile t's S product is issued before tile t-1's P V, and
// the two consumers take turns issuing them (named barriers), so the
// softmax of one runs on the SMs' ALUs and SFUs while the tensor cores
// run the other's products; a stage is released only after the wgmma
// that reads it has completed.  Every branch around the wgmmas is
// warp-uniform (the warpgroup index comes through a shuffle, mbarrier
// arrivals are predicated, the first tile is peeled so that every wgmma
// wait is unconditional): otherwise ptxas serialises all of a kernel's
// wgmmas (its warning C7518), at about 0.75x the speed.
//
// "mma_sync" (bf16, every other (D, DV); the first design, also
// callable at (128, 128) for timing): mma.sync m16n8k16 (about a third
// of wgmma's rate on Hopper), one 128-thread block per (64-row query
// tile, query head, batch element), all on gridDim.x (block_work: any
// batch the int arguments hold), each warp owning 16 query rows; K
// and V tiles of 64 keys in two cp.async stages; B fragments by
// ldmatrix (V's transposing).  It is MLA's prefill kernel: deepseek-v3
// attends at (D, DV) = (192, 128), where a block stages 2 x 64 x (200 +
// 136) bf16 = 84 KB (two blocks an SM) and a thread holds 48 registers
// of Q fragments and 64 of O accumulators.  "wgmma" at (192, 128) would
// need 256 KB as its shared memory is laid out (two 48 KB Q buffers,
// two 48 KB K and two 32 KB V stages), past a block's 227 KB.
//
// In both bf16 designs P is rounded to bf16 for the P.V product, once,
// as tensor-core flash attention does, l sums the f32 p, and a masked
// key's p is set to exactly 0 before ex2 is reached.
//
// "f32" (float32 inputs): a CUDA-core kernel (fmaf, f32 throughout,
// within 1e-5 of the plain version): the same tiles and skips as
// "mma_sync", a 16 x 8 thread grid over each 64 x 64 score tile, scores
// through shared memory.  TF32 tensor cores would round q and k to 10
// mantissa bits.

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the reference's NEG_INF
constexpr int kBR = 64;             // query rows per block
constexpr int kBC = 64;             // keys per tile
constexpr int kThreads = 128;

struct Shape {
  int Sq, Sk, Hq, G;
  int causal, q_offset, window;
  float scale;
};

__device__ __forceinline__ bool visible(const Shape& s, int row, int key) {
  const int p = row + s.q_offset;
  return key < s.Sk && (!s.causal || key <= p) &&
         (s.window <= 0 || key > p - s.window);
}

// the keys [lo, hi) some row of [q0, q1) can see
__device__ __forceinline__ void key_range(const Shape& s, int q0, int q1,
                                          int& lo, int& hi) {
  hi = s.Sk;
  if (s.causal) hi = min(hi, q1 + s.q_offset);   // key <= (q1 - 1) + q_offset
  lo = 0;
  if (s.window > 0) lo = max(lo, q0 + s.q_offset - s.window + 1);
  if (hi < lo) hi = lo;
}

// the (64-row query tile, query head, batch element) of this block of
// the "mma_sync" and "f32" grids: blockIdx.x runs the query head fastest,
// then the batch element, then the query tile -- causal tiles with more
// rows see more keys, so the last tile comes first
struct BlockWork {
  int q_tile, h, b;
};

__device__ __forceinline__ BlockWork block_work(const Shape& s, int B) {
  const int per_tile = s.Hq * B;
  const int x = static_cast<int>(blockIdx.x);
  const int t = x / per_tile, rest = x - t * per_tile;
  const int tiles = (s.Sq + kBR - 1) / kBR;
  return {s.causal ? tiles - 1 - t : t, rest % s.Hq, rest / s.Hq};
}

// ---------------------------------------------------------------------------
// bf16 "mma_sync": mma.sync tensor cores, a block per query tile
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8 and receives, per matrix, its (row lane / 4, columns
// 2 (lane % 4) + {0, 1}); ".trans": its (rows 2 (lane % 4) + {0, 1},
// column lane / 4)
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 bytes global -> shared, zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group of this thread is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D, int DV>
struct Bf16Tiles {
  static constexpr int KS = D + 8;     // padded rows: conflict-free ldmatrix
  static constexpr int VS = DV + 8;
  static constexpr int STAGE = kBC * (KS + VS);   // one K and one V tile
  static constexpr size_t BYTES = 2 * STAGE * sizeof(__nv_bfloat16);
};

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ Q,
                  const __nv_bfloat16* __restrict__ K,
                  const __nv_bfloat16* __restrict__ V,
                  __nv_bfloat16* __restrict__ O, Shape s, int B) {
  static_assert(D % 16 == 0 && DV % 16 == 0, "D and DV: multiples of 16");
  using T = Bf16Tiles<D, DV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const BlockWork work = block_work(s, B);
  const int q0 = work.q_tile * kBR;
  const int h = work.h, b = work.b, hk = h / s.G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + warp * 16 + g;        // this thread's rows r0, r0 + 8
  const int lm_row = lane & 7, lm_mat = lane >> 3;   // its ldmatrix row

  const size_t q_row = (size_t)s.Hq * D, k_row = (size_t)s.Hq / s.G * D;
  const size_t v_row = (size_t)s.Hq / s.G * DV, o_row = (size_t)s.Hq * DV;
  const __nv_bfloat16* qb = Q + (size_t)b * s.Sq * q_row + (size_t)h * D;
  const __nv_bfloat16* kb = K + (size_t)b * s.Sk * k_row + (size_t)hk * D;
  const __nv_bfloat16* vb = V + (size_t)b * s.Sk * v_row + (size_t)hk * DV;

  // the A fragments of this warp's 16 query rows, for every 16-deep
  // chunk of D, straight from global memory (rows past Sq are zeros)
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + t4 * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + (e & 1) * 8, col = c + (e >> 1) * 8;
      qa[kc][e] = row < s.Sq
          ? *reinterpret_cast<const uint32_t*>(qb + row * q_row + col) : 0u;
    }
  }

  // log2-domain softmax: x = s * scale * log2(e), p = 2^(x - m)
  const float scale2 = s.scale * 1.4426950408889634f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  const int q1 = min(q0 + kBR, s.Sq);
  int lo, hi;
  key_range(s, q0, q1, lo, hi);
  const int n_tiles = (hi - lo + kBC - 1) / kBC;

  // stage a K and a V tile (keys past Sk zero-filled) with cp.async
  auto load_tile = [&](int t) {
    __nv_bfloat16* Ks = tiles + (t & 1) * T::STAGE;
    __nv_bfloat16* Vs = Ks + kBC * T::KS;
    const int kv0 = lo + t * kBC;
    for (int i = tid; i < kBC * (D / 8); i += kThreads) {
      const int j = i / (D / 8), c8 = (i % (D / 8)) * 8, key = kv0 + j;
      cp_async16(&Ks[j * T::KS + c8],
                 key < s.Sk ? kb + key * k_row + c8 : kb, key < s.Sk);
    }
    for (int i = tid; i < kBC * (DV / 8); i += kThreads) {
      const int j = i / (DV / 8), c8 = (i % (DV / 8)) * 8, key = kv0 + j;
      cp_async16(&Vs[j * T::VS + c8],
                 key < s.Sk ? vb + key * v_row + c8 : vb, key < s.Sk);
    }
  };

  if (n_tiles > 0) load_tile(0);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tile(t + 1);   // overlaps this tile's math
    cp_async_commit();
    cp_async_wait_one();                      // tile t has landed
    __syncthreads();
    const __nv_bfloat16* Ks = tiles + (t & 1) * T::STAGE;
    const __nv_bfloat16* Vs = Ks + kBC * T::KS;
    const int kv0 = lo + t * kBC;

    // S = Q K^T for 16 rows x 64 keys: 8 accumulator tiles of 16 x 8;
    // one ldmatrix gives the B fragments of two key tiles
    float sc[kBC / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBC / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBC / 8; nt += 2) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t kf[4];
        ldmatrix_x4(kf, &Ks[((nt + (lm_mat >> 1)) * 8 + lm_row) * T::KS +
                            kc * 16 + (lm_mat & 1) * 8]);
        mma_bf16(sc[nt], qa[kc], kf[0], kf[1]);
        mma_bf16(sc[nt + 1], qa[kc], kf[2], kf[3]);
      }
    }

    // scale, mask where some key of the tile is hidden from some row;
    // element e of tile nt is (row r0 + (e/2)*8, key kv0 + nt*8 + t4*2 + e%2)
    const bool masked =
        kv0 + kBC > s.Sk ||
        (s.causal && kv0 + kBC - 1 > q0 + s.q_offset) ||
        (s.window > 0 && kv0 <= (q1 - 1) + s.q_offset - s.window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kBC / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[nt][e] * scale2;
        if (masked && !visible(s, r0 + (e >> 1) * 8,
                               kv0 + nt * 8 + t4 * 2 + (e & 1)))
          x = kNegInf;
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = fast_exp2(m[i] - m_new);
      m[i] = m_new;
    }
    // a hidden key (x = -1e30) adds 0; a row that has seen no key yet
    // keeps m = -1e30 and corr = 1
#pragma unroll
    for (int nt = 0; nt < kBC / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[nt][e];
        const float p = x == kNegInf ? 0.f : fast_exp2(x - m[e >> 1]);
        sc[nt][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      o[n][0] *= corr[0]; o[n][1] *= corr[0];
      o[n][2] *= corr[1]; o[n][3] *= corr[1];
    }

    // O += P V: the score tiles 2c, 2c+1 are the A fragment of key chunk
    // c; one transposing ldmatrix gives the B fragments of two dv tiles
#pragma unroll
    for (int c = 0; c < kBC / 16; ++c) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * c][0], sc[2 * c][1]),
                              pack_bf16(sc[2 * c][2], sc[2 * c][3]),
                              pack_bf16(sc[2 * c + 1][0], sc[2 * c + 1][1]),
                              pack_bf16(sc[2 * c + 1][2], sc[2 * c + 1][3])};
#pragma unroll
      for (int n = 0; n < DV / 8; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &Vs[(c * 16 + (lm_mat & 1) * 8 + lm_row) *
                                     T::VS + (n + (lm_mat >> 1)) * 8]);
        mma_bf16(o[n], pa, vf[0], vf[1]);
        mma_bf16(o[n + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + i * 8;
    if (row >= s.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* op = O + ((size_t)b * s.Sq + row) * o_row + (size_t)h * DV;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
      *reinterpret_cast<uint32_t*>(op + n * 8 + t4 * 2) =
          pack_bf16(o[n][2 * i] / den, o[n][2 * i + 1] / den);
  }
}

// ---------------------------------------------------------------------------
// bf16 "wgmma": TMA-fed K/V ring, warp-specialised, persistent
// ---------------------------------------------------------------------------

namespace hopper {

constexpr int kBM = 128;           // query rows per work item, 64 a consumer
constexpr int kBN = 128;           // keys per K/V tile
constexpr int kStages = 2;         // K/V ring depth
constexpr int kQBufs = 2;          // Q tiles: the next item's loads early
constexpr int kAtom = 64;          // bf16 per 128-byte swizzled row: a box's width
constexpr int kRow = 128;          // bytes per swizzled row
constexpr int kThreads = 384;      // one producer and two consumer warpgroups
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
// registers a thread gets at launch under __launch_bounds__(384, 1); the
// consumers' setmaxnreg.inc is served from that pool, so it must hold both
constexpr int kRegsAtLaunch = 168;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <=
              kThreads * kRegsAtLaunch, "register split");

// shared memory: the Q buffers (D / 64 boxes of kBM rows each), the K
// and V stages (D / 64 and DV / 64 boxes of kBN rows each), then the
// mbarriers; every box is 1024-byte aligned, as the 128-byte swizzle
// requires
template <int D, int DV>
struct Smem {
  static constexpr int Q = kBM * D * 2;
  static constexpr int K = kBN * D * 2;
  static constexpr int V = kBN * DV * 2;
  static constexpr int K0 = kQBufs * Q;
  static constexpr int V0 = K0 + kStages * K;
  static constexpr int BARS = V0 + kStages * V;
  static constexpr size_t BYTES = 1024 + BARS + 8 * (2 * kQBufs + 4 * kStages);
};
// mbarrier slots
constexpr int kQFull = 0, kQEmpty = kQBufs, kFullK = 2 * kQBufs,
              kEmptyK = kFullK + kStages, kFullV = kEmptyK + kStages,
              kEmptyV = kFullV + kStages;
// arrivals that release a stage or Q: one per consumer warp
constexpr unsigned kConsumerWarps = 8;

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// an arrival by the threads where `pred` holds, predicated in the
// instruction: no branch, so the wgmmas in flight around it stay
// pipelined (ptxas serialises every wgmma of a kernel that must wait for
// them on a divergent path)
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      :: "r"(smem_addr(bar)), "r"((int)pred) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed (try_wait
// suspends the thread for a while before it returns false)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  while (!mbar_try_wait(a, parity)) {
  }
}

// one box of a 4-D tensor map (d, head, row, batch) into shared memory;
// completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d0, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(d0), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// a wgmma shared-memory descriptor for a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t desc(const void* p, unsigned lbo,
                                         unsigned sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// pin registers an asynchronous wgmma reads or writes at this point of
// the program, so the compiler neither reads nor reuses them across it
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B from shared memory,
// both K-major (descriptors a, b); `accumulate` 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A from registers (four bf16
// pairs a thread), B from shared memory, MN-major (descriptor b)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                       const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (four bf16
// pairs a thread), B from shared memory, MN-major (descriptor b)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                       const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// S[64 x kBN] = Q K^T for one consumer's 64 rows: both operands K-major;
// a k16 step moves 32 bytes along the swizzled rows, a new 64-column box
// every four steps; 8 rows (1024 bytes) between core-matrix groups
template <int D>
__device__ __forceinline__ void qk(float (&sc)[kBN / 2],
                                   const unsigned char* q,
                                   const unsigned char* k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = (kk % 4) * 32;
    wgmma_ss_n128(sc, desc(q + (kk / 4) * kBM * kRow + col, 16, 8 * kRow),
                  desc(k + (kk / 4) * kBN * kRow + col, 16, 8 * kRow),
                  kk > 0);
  }
}

// O[64 x DV] += P[64 x kBN] V[kBN x DV]: V MN-major (its rows are keys),
// 16 keys (2048 bytes) a step; the leading offset reaches the next
// 64-column box of V, the stride offset the next 8 keys
template <int DV>
__device__ __forceinline__ void pv(float (&o)[DV / 2],
                                   const uint32_t (&p)[kBN / 16][4],
                                   const unsigned char* v) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t b = desc(v + kk * 16 * kRow, kBN * kRow, 8 * kRow);
    if constexpr (DV == 128) {
      wgmma_rs_n128(o, p[kk], b);
    } else {
      static_assert(DV == 64, "DV: 64 or 128");
      wgmma_rs_n64(o, p[kk], b);
    }
  }
}

// the S accumulators as the A operand of P V: accumulator i of a thread
// is (row g + 8 ((i / 2) % 2), key 8 (i / 4) + 2 t4 + i % 2) of its
// warp's 16 rows, so the eight of key chunk kk, packed in pairs, are
// its A fragment for keys 16 kk .. 16 kk + 15
__device__ __forceinline__ void pack_p(uint32_t (&p)[kBN / 16][4],
                                       const float (&sc)[kBN / 2]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
}

// the keys [lo, hi) query row `row` sees (its `visible` keys)
__device__ __forceinline__ void row_keys(const Shape& s, int row, int& lo,
                                         int& hi) {
  const int p = row + s.q_offset;
  hi = s.causal ? min(s.Sk, p + 1) : s.Sk;
  lo = s.window > 0 ? max(0, p - s.window + 1) : 0;
}

// one tile's online softmax on a thread's two rows r0, r0 + 8: `sc`
// holds the raw scores in and the f32 weights p out; m is the running
// max in the log2 domain, corr the rows' corrections, sum the rows'
// weights on this thread (a quad's four partial sums are added once, at
// the end).  Scaling by scale2 > 0 keeps the max, so the max is taken on
// the raw scores and the scale folds into ex2's fma.  Masked tiles hide
// the columns outside each row's visible keys.
template <bool kMasked>
__device__ __forceinline__ void softmax(float (&sc)[kBN / 2], float (&m)[2],
                                        float (&corr)[2], float (&sum)[2],
                                        const Shape& s, int r0, int kv0,
                                        int t4, float scale2) {
  float mx[2] = {kNegInf, kNegInf};
  int lo[2] = {0, 0}, hi[2] = {0, 0};   // visible columns, less 2 t4
  if (kMasked) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      row_keys(s, r0 + hr * 8, lo[hr], hi[hr]);
      lo[hr] -= kv0 + t4 * 2;
      hi[hr] -= kv0 + t4 * 2;
    }
  }
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    const int hr = (i >> 1) & 1, col = (i >> 2) * 8 + (i & 1);
    if (kMasked && (col < lo[hr] || col >= hi[hr])) sc[i] = kNegInf;
    mx[hr] = fmaxf(mx[hr], sc[i]);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    // a row that sees no key of this tile keeps its max
    const float m_new = fmaxf(
        m[hr], kMasked && mx[hr] == kNegInf ? kNegInf : mx[hr] * scale2);
    corr[hr] = fast_exp2(m[hr] - m_new);
    m[hr] = m_new;
    sum[hr] = 0.f;
  }
  // a hidden key (set to -1e30 above) adds exactly 0
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    const int hr = (i >> 1) & 1;
    const float p = kMasked && sc[i] == kNegInf
                        ? 0.f : fast_exp2(fmaf(sc[i], scale2, -m[hr]));
    sc[i] = p;
    sum[hr] += p;
  }
}

// the work list: query tiles outermost (causal: the last tile, which
// sees the most keys, first), then batch, then query head, so a KV
// head's G query heads are adjacent
__device__ __forceinline__ int n_items(const Shape& s, int B) {
  return (s.Sq + kBM - 1) / kBM * B * s.Hq;
}

// this block's item in round r: blocks take the list in rounds of
// gridDim.x items, in order on even rounds and reversed on odd ones
__device__ __forceinline__ int round_item(int r) {
  const int x = (r & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x
                        : (int)blockIdx.x;
  return r * (int)gridDim.x + x;
}

struct Item {
  int b, h, q0;    // batch, query head, first query row
  int lo, n;       // first visible key, key tiles
};

__device__ __forceinline__ Item decode(const Shape& s, int B, int idx) {
  const int per = B * s.Hq, n_mb = (s.Sq + kBM - 1) / kBM;
  const int mi = idx / per, rest = idx - mi * per;
  Item it;
  it.b = rest / s.Hq;
  it.h = rest - it.b * s.Hq;
  it.q0 = (s.causal ? n_mb - 1 - mi : mi) * kBM;
  int hi;
  key_range(s, it.q0, min(it.q0 + kBM, s.Sq), it.lo, hi);
  it.n = (hi - it.lo + kBN - 1) / kBN;
  return it;
}

// the producer (one thread): per item, Q into one of two buffers (free
// once the item before the last has read it, so it loads while the last
// item still runs), then the K/V tiles into the ring, each stage once
// its consumers have released it
template <int D, int DV>
__device__ __forceinline__ void produce(const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv,
                                        unsigned char* smem, uint64_t* bar,
                                        const Shape& s, int B) {
  using L = Smem<D, DV>;
  const int items = n_items(s, B);
  int ring = 0, nq = 0;   // K/V tiles and Q tiles loaded so far
  for (int r = 0; r * (int)gridDim.x < items; ++r) {
    const int idx = round_item(r);
    if (idx >= items) continue;
    const Item it = decode(s, B, idx);
    const int hk = it.h / s.G;
    for (int t = 0; t < it.n; ++t, ++ring) {
      const int st = ring % kStages;
      const unsigned free_parity = ((ring / kStages) & 1) ^ 1;
      const int kv0 = it.lo + t * kBN;
      if (t == 0) {   // its buffer was released an item ago
        const int qb = nq % kQBufs;
        mbar_wait(&bar[kQEmpty + qb], ((nq / kQBufs) & 1) ^ 1);
        ++nq;
        mbar_expect_tx(&bar[kQFull + qb], L::Q);
#pragma unroll
        for (int a = 0; a < D / kAtom; ++a)
          tma_load(smem + qb * L::Q + a * kBM * kRow, tq, &bar[kQFull + qb],
                   a * kAtom, it.h, it.q0, it.b);
      }
      mbar_wait(&bar[kEmptyK + st], free_parity);
      mbar_expect_tx(&bar[kFullK + st], L::K);
#pragma unroll
      for (int a = 0; a < D / kAtom; ++a)
        tma_load(smem + L::K0 + st * L::K + a * kBN * kRow, tk,
                 &bar[kFullK + st], a * kAtom, hk, kv0, it.b);
      mbar_wait(&bar[kEmptyV + st], free_parity);
      mbar_expect_tx(&bar[kFullV + st], L::V);
#pragma unroll
      for (int a = 0; a < DV / kAtom; ++a)
        tma_load(smem + L::V0 + st * L::V + a * kBN * kRow, tv,
                 &bar[kFullV + st], a * kAtom, hk, kv0, it.b);
    }
  }
}

// the consumers' turns at the tensor cores: named barrier 1 + c is
// consumer c's (barrier 0 is __syncthreads'); each barrier completes on
// the 128 threads that wait at it and the other consumer's 128 that pass
// the turn on
__device__ __forceinline__ void take_turn(int c) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + c) : "memory");
}

__device__ __forceinline__ void pass_turn(int c) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - c) : "memory");
}

// one tile's softmax in a consumer: the mask only where some key of the
// tile is hidden from some row of the consumer's rows [qr0, qr1); l
// takes the tile's correction and its weights
__device__ __forceinline__ void tile_softmax(float (&sc)[kBN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], const Shape& s,
                                             int qr0, int qr1, int r0,
                                             int kv0, int t4, float scale2) {
  const bool masked =
      kv0 + kBN > s.Sk || (s.causal && kv0 + kBN - 1 > qr0 + s.q_offset) ||
      (s.window > 0 && kv0 <= (qr1 - 1) + s.q_offset - s.window);
  float sum[2];
  if (masked)
    softmax<true>(sc, m, corr, sum, s, r0, kv0, t4, scale2);
  else
    softmax<false>(sc, m, corr, sum, s, r0, kv0, t4, scale2);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * corr[hr] + sum[hr];
}

// a consumer warpgroup (c = 0, 1: rows 64 c .. 64 c + 63 of each item).
// Per tile t > 0, in its turn: S_t = Q K_t^T is issued, O takes tile
// t-1's correction, O += P_{t-1} V_{t-1} is issued; then the softmax of
// S_t runs while the P V product, and the other consumer's two products
// in its turn, are on the tensor cores; then S_t becomes P_t.  Tile 0
// (S only) and the last P V are peeled off the loop, so that every wgmma
// wait is unconditional: ptxas then sees that no wgmma is in flight at
// the loop's top, where the mbarrier waits spin.
template <int D, int DV>
__device__ __forceinline__ void consume(int c, unsigned char* smem,
                                        uint64_t* bar,
                                        __nv_bfloat16* __restrict__ O,
                                        const Shape& s, int B) {
  using L = Smem<D, DV>;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const float scale2 = s.scale * 1.4426950408889634f;
  const size_t o_row = (size_t)s.Hq * DV;
  const int items = n_items(s, B);
  int ring = 0, nq = 0;   // K/V tiles and Q tiles consumed so far
  float sc[kBN / 2], o[DV / 2];
  uint32_t p[kBN / 16][4];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
  if (c == 1) pass_turn(c);   // consumer 0 takes the first turn
  for (int r = 0; r * (int)gridDim.x < items; ++r) {
    const int idx = round_item(r);
    if (idx >= items) continue;
    const Item it = decode(s, B, idx);
    const int qr0 = it.q0 + c * 64, qr1 = min(qr0 + 64, s.Sq);
    const int r0 = qr0 + warp * 16 + g;   // this thread's rows r0, r0 + 8
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float corr[2] = {1.f, 1.f};
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    if (it.n > 0) {
      const int qb = nq % kQBufs;
      const unsigned char* qs = smem + qb * L::Q + c * 64 * kRow;   // its rows
      mbar_wait(&bar[kQFull + qb], (nq / kQBufs) & 1);
      ++nq;
      // tile 0: S_0 alone
      int st = ring % kStages;
      mbar_wait(&bar[kFullK + st], (ring / kStages) & 1);
      take_turn(c);
      pin(sc);
      wgmma_fence();
      qk<D>(sc, qs, smem + L::K0 + st * L::K);
      wgmma_commit();
      pass_turn(c);
      wgmma_wait<0>();
      pin(sc);
      mbar_arrive_if(&bar[kEmptyK + st], lane == 0);
      mbar_arrive_if(&bar[kQEmpty + qb], lane == 0 && it.n == 1);
      tile_softmax(sc, m, l, corr, s, qr0, qr1, r0, it.lo, t4, scale2);
      pack_p(p, sc);
      ++ring;
      for (int t = 1; t < it.n; ++t, ++ring) {
        st = ring % kStages;
        const int pst = (ring + kStages - 1) % kStages;   // tile t-1's
        const int kv0 = it.lo + t * kBN;
        mbar_wait(&bar[kFullK + st], (ring / kStages) & 1);
        mbar_wait(&bar[kFullV + pst], ((ring - 1) / kStages) & 1);
        take_turn(c);
        pin(sc);
        pin(o);
        pin(p);
        wgmma_fence();
        qk<D>(sc, qs, smem + L::K0 + st * L::K);
        wgmma_commit();
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) o[i] *= corr[(i >> 1) & 1];
        wgmma_fence();
        pv<DV>(o, p, smem + L::V0 + pst * L::V);
        wgmma_commit();
        pass_turn(c);
        wgmma_wait<1>();
        pin(sc);
        mbar_arrive_if(&bar[kEmptyK + st], lane == 0);
        mbar_arrive_if(&bar[kQEmpty + qb], lane == 0 && t == it.n - 1);
        tile_softmax(sc, m, l, corr, s, qr0, qr1, r0, kv0, t4, scale2);
        wgmma_wait<0>();
        pin(o);
        pin(p);
        mbar_arrive_if(&bar[kEmptyV + pst], lane == 0);
        pack_p(p, sc);
      }
      // O += P V of the last tile
      st = (ring + kStages - 1) % kStages;
      mbar_wait(&bar[kFullV + st], ((ring - 1) / kStages) & 1);
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      pin(o);
      pin(p);
      wgmma_fence();
      pv<DV>(o, p, smem + L::V0 + st * L::V);
      wgmma_commit();
      wgmma_wait<0>();
      pin(o);
      pin(p);
      mbar_arrive_if(&bar[kEmptyV + st], lane == 0);
    }
    // o = acc / max(l, 1e-30): accumulator i is (row r0 + 8 ((i / 2) % 2),
    // column 8 (i / 4) + 2 t4 + i % 2)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float lt = l[hr];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int row = r0 + hr * 8;
      if (row >= s.Sq) continue;
      const float den = fmaxf(lt, 1e-30f);
      __nv_bfloat16* op = O + ((size_t)it.b * s.Sq + row) * o_row +
                          (size_t)it.h * DV;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
        *reinterpret_cast<uint32_t*>(op + n * 8 + t4 * 2) =
            pack_bf16(o[4 * n + 2 * hr] / den, o[4 * n + 2 * hr + 1] / den);
    }
  }
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

__device__ __forceinline__ void init_barriers(uint64_t* bar) {
  for (int i = 0; i < kQBufs; ++i) {
    mbar_init(&bar[kQFull + i], 1);
    mbar_init(&bar[kQEmpty + i], kConsumerWarps);
  }
  for (int i = 0; i < kStages; ++i) {
    mbar_init(&bar[kFullK + i], 1);
    mbar_init(&bar[kEmptyK + i], kConsumerWarps);
    mbar_init(&bar[kFullV + i], 1);
    mbar_init(&bar[kEmptyV + i], kConsumerWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the warpgroup of this thread, through a shuffle so that the compiler
// knows it is uniform across the warp: branches on it (and on what the
// consumers derive from it) are not divergent paths
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
}

// warp specialisation: warpgroup 0 gives up registers and one of its
// threads produces; warpgroups 1 and 2 take registers and consume.  The
// two branches never rejoin.
template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ O, const Shape s, const int B) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + Smem<D, DV>::BARS);
  if (threadIdx.x == 0) init_barriers(bar);
  __syncthreads();
  const int wg = warpgroup();
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == 0) produce<D, DV>(&tq, &tk, &tv, smem, bar, s, B);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    consume<D, DV>(wg - 1, smem, bar, O, s, B);
  }
}

// The two products alone, for the card tests: one block loads q
// [1, 128, 1, D], k [1, 128, 1, D] and v [1, 128, 1, DV] through the
// tensor maps; each consumer writes its 64 rows of S = Q K^T (f32,
// unscaled) to s_out [128, 128], packs S to bf16 as P and writes P V
// (f32) to o_out [128, DV].
template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_probe(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  float* __restrict__ s_out, float* __restrict__ o_out) {
  using L = Smem<D, DV>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BARS);
  if (threadIdx.x == 0) init_barriers(bar);
  __syncthreads();
  const int wg = warpgroup();
  if (wg == 0) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(&bar[kQFull], L::Q);
      for (int a = 0; a < D / kAtom; ++a)
        tma_load(smem + a * kBM * kRow, &tq, &bar[kQFull], a * kAtom, 0, 0,
                 0);
      mbar_expect_tx(&bar[kFullK], L::K);
      for (int a = 0; a < D / kAtom; ++a)
        tma_load(smem + L::K0 + a * kBN * kRow, &tk, &bar[kFullK], a * kAtom,
                 0, 0, 0);
      mbar_expect_tx(&bar[kFullV], L::V);
      for (int a = 0; a < DV / kAtom; ++a)
        tma_load(smem + L::V0 + a * kBN * kRow, &tv, &bar[kFullV], a * kAtom,
                 0, 0, 0);
    }
    return;
  }
  const int c = wg - 1, tid = threadIdx.x % 128;
  const int lane = tid % 32, t4 = lane & 3;
  const int r0 = c * 64 + (tid / 32) * 16 + (lane >> 2);
  float sc[kBN / 2], o[DV / 2];
  uint32_t p[kBN / 16][4];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  mbar_wait(&bar[kQFull], 0);
  mbar_wait(&bar[kFullK], 0);
  pin(sc);
  wgmma_fence();
  qk<D>(sc, smem + c * 64 * kRow, smem + L::K0);
  wgmma_commit();
  wgmma_wait<0>();
  pin(sc);
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i)
    s_out[(r0 + ((i >> 1) & 1) * 8) * kBN + (i >> 2) * 8 + t4 * 2 + (i & 1)] =
        sc[i];
  pack_p(p, sc);
  mbar_wait(&bar[kFullV], 0);
  pin(o);
  pin(p);
  wgmma_fence();
  pv<DV>(o, p, smem + L::V0);
  wgmma_commit();
  wgmma_wait<0>();
  pin(o);
  pin(p);
#pragma unroll
  for (int i = 0; i < DV / 2; ++i)
    o_out[(r0 + ((i >> 1) & 1) * 8) * DV + (i >> 2) * 8 + t4 * 2 + (i & 1)] =
        o[i];
}

// ---- host side ------------------------------------------------------------

// a failed tensor-map encode returns this plus its CUresult
constexpr int kErrTensorMap = 1 << 16;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the encoder in libcuda, which the CUDA runtime has already loaded
// (this library does not link against libcuda)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY);
    return lib == nullptr ? nullptr : reinterpret_cast<EncodeTiled>(
                                          dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// a bf16 [B, S, H, d] tensor as a 4-D map (d, H, S, B) of boxes (64, 1,
// rows, 1): one head's rows, 64 columns, 128-byte swizzled; rows past S
// read as zeros
int encode(CUtensorMap* map, const void* base, int B, int S, int H, int d,
           int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return kErrTensorMap + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)H * d * 2,
                                 (cuuint64_t)S * H * d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kAtom, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(base), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap + static_cast<int>(r);
}

int encode_all(CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv,
               const void* q, const void* k, const void* v, int B,
               const Shape& s, int D, int DV) {
  const int hkv = s.Hq / s.G;
  int err = encode(tq, q, B, s.Sq, s.Hq, D, kBM);
  if (err == 0) err = encode(tk, k, B, s.Sk, hkv, D, kBN);
  if (err == 0) err = encode(tv, v, B, s.Sk, hkv, DV, kBN);
  return err;
}

// the dynamic shared memory, and a refusal (not a hang) where the
// registers given at launch could not serve the consumers' setmaxnreg
template <typename Kernel>
int prepare(Kernel kernel, size_t smem, bool split_registers) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (split_registers && attr.numRegs < kRegsAtLaunch)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           const Shape& s, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = encode_all(&tq, &tk, &tv, q, k, v, B, s, D, DV);
  if (err == 0)
    err = prepare(flash_wgmma_kernel<D, DV>, Smem<D, DV>::BYTES, true);
  if (err != 0) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long items = (long long)((s.Sq + kBM - 1) / kBM) * B * s.Hq;
  if (items > 0x7fffffff || sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = items < sms ? (int)items : sms;   // one block an SM
  flash_wgmma_kernel<D, DV><<<grid, kThreads, Smem<D, DV>::BYTES, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), s, B);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DV>
int probe(const void* q, const void* k, const void* v, float* s_out,
          float* o_out, cudaStream_t stream) {
  const Shape s{kBM, kBN, 1, 1, 0, 0, 0, 1.f};
  CUtensorMap tq, tk, tv;
  int err = encode_all(&tq, &tk, &tv, q, k, v, 1, s, D, DV);
  if (err == 0)
    err = prepare(flash_wgmma_probe<D, DV>, Smem<D, DV>::BYTES, false);
  if (err != 0) return err;
  flash_wgmma_probe<D, DV><<<1, kThreads, Smem<D, DV>::BYTES, stream>>>(
      tq, tk, tv, s_out, o_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

template <int D, int DV>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         ((size_t)kBR * (D + 1) + (size_t)kBC * (D + 1) + (size_t)kBC * DV +
          (size_t)kBR * (kBC + 1));
}

// thread (ty, tx) of a 16 x 8 grid owns rows ty + 16 i (i < 4), keys
// tx + 8 j (j < 8) of the score tile and output columns tx + 8 j
// (j < DV / 8); a row's 8 threads are 8 neighbouring lanes of one warp
template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                 const float* __restrict__ V, float* __restrict__ O, Shape s,
                 int B) {
  static_assert(DV % 8 == 0, "DV: a multiple of 8");
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kBR][D + 1]
  float* Ks = Qs + kBR * (D + 1);         // [kBC][D + 1]
  float* Vs = Ks + kBC * (D + 1);         // [kBC][DV]
  float* Ps = Vs + kBC * DV;              // [kBR][kBC + 1]
  constexpr int NO = DV / 8;

  const BlockWork work = block_work(s, B);
  const int q0 = work.q_tile * kBR;
  const int h = work.h, b = work.b, hk = h / s.G;
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;

  const size_t q_row = (size_t)s.Hq * D, k_row = (size_t)s.Hq / s.G * D;
  const size_t v_row = (size_t)s.Hq / s.G * DV, o_row = (size_t)s.Hq * DV;
  const float* qb = Q + (size_t)b * s.Sq * q_row + (size_t)h * D;
  const float* kb = K + (size_t)b * s.Sk * k_row + (size_t)hk * D;
  const float* vb = V + (size_t)b * s.Sk * v_row + (size_t)hk * DV;

  for (int i = tid; i < kBR * D; i += kThreads) {
    const int r = i / D, c = i % D, row = q0 + r;
    Qs[r * (D + 1) + c] = row < s.Sq ? qb[row * q_row + c] : 0.f;
  }

  float m[4], l[4], acc[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[i][j] = 0.f;
  }

  int lo, hi;
  key_range(s, q0, min(q0 + kBR, s.Sq), lo, hi);
  for (int kv0 = lo; kv0 < hi; kv0 += kBC) {
    __syncthreads();
    for (int i = tid; i < kBC * D; i += kThreads) {
      const int j = i / D, c = i % D, key = kv0 + j;
      Ks[j * (D + 1) + c] = key < s.Sk ? kb[key * k_row + c] : 0.f;
    }
    for (int i = tid; i < kBC * DV; i += kThreads) {
      const int j = i / DV, c = i % DV, key = kv0 + j;
      Vs[j * DV + c] = key < s.Sk ? vb[key * v_row + c] : 0.f;
    }
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tx + 8 * j) * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
      uint32_t vis = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool ok = visible(s, row, kv0 + tx + 8 * j);
        sc[i][j] = ok ? sc[i][j] * s.scale : kNegInf;
        vis |= (uint32_t)ok << j;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 8; w *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = (vis >> j) & 1u ? expf(sc[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * (kBC + 1) + tx + 8 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 1; w < 8; w *= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int j = 0; j < NO; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < kBC; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (kBC + 1) + c];
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const float vv = Vs[c * DV + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* op = O + ((size_t)b * s.Sq + row) * o_row + (size_t)h * DV;
#pragma unroll
    for (int j = 0; j < NO; ++j) op[tx + 8 * j] = acc[i][j] / den;
  }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           const Shape& s, int bf16, cudaStream_t stream) {
  const int64_t blocks = (int64_t)((s.Sq + kBR - 1) / kBR) * s.Hq * B;
  if (blocks >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (bf16) {
    constexpr size_t smem = Bf16Tiles<D, DV>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bf16_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bf16_kernel<D, DV><<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), s, B);
  } else {
    constexpr size_t smem = f32_smem_bytes<D, DV>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_f32_kernel<D, DV><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), s, B);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kernels/flash_attention.py DESIGNS
enum Design { kF32 = 0, kMmaSync = 1, kWgmma = 2 };

// Launches `design` on one call's tensors; a design not built for (d, dv)
// is refused (cudaErrorInvalidValue), never replaced by another.  The
// (D, DV) pairs built: repro_torch.kernels.flash_attention.HEAD_DIMS for
// "f32" and "mma_sync" (MLA's (192, 128) among them), WGMMA_HEAD_DIMS
// for "wgmma".
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int Hq, int Hkv, int d, int dv,
                                      int causal, int q_offset, int window,
                                      float scale, int design, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{Sq, Sk, Hq, Hq / Hkv, causal, q_offset, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == kWgmma) {
    if (d == 128 && dv == 128)
      return hopper::launch<128, 128>(q, k, v, o, B, s, st);
    if (d == 64 && dv == 64) return hopper::launch<64, 64>(q, k, v, o, B, s, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (design != kF32 && design != kMmaSync)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bf16 = design == kMmaSync;
#define REPRO_FLASH_CASE(D_, DV_) \
  if (d == D_ && dv == DV_) return launch<D_, DV_>(q, k, v, o, B, s, bf16, st);
  REPRO_FLASH_CASE(16, 16)
  REPRO_FLASH_CASE(32, 32)
  REPRO_FLASH_CASE(64, 64)
  REPRO_FLASH_CASE(128, 128)
  REPRO_FLASH_CASE(32, 16)
  REPRO_FLASH_CASE(192, 128)
#undef REPRO_FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The "wgmma" design's two products alone (hopper::flash_wgmma_probe),
// for the card tests: q, k [1, 128, 1, d], v [1, 128, 1, dv] bf16 ->
// s_out [128, 128] = q k^T, o_out [128, dv] = bf16(s_out) v, both f32.
extern "C" int flash_attention_probe(const void* q, const void* k,
                                     const void* v, float* s_out,
                                     float* o_out, int d, int dv,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128 && dv == 128)
    return hopper::probe<128, 128>(q, k, v, s_out, o_out, st);
  if (d == 64 && dv == 64)
    return hopper::probe<64, 64>(q, k, v, s_out, o_out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
