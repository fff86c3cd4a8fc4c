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
// wiped by its correction exp(-1e30 - m) = 0), so the kernel skips every
// key tile that no row of its query tile can see: the causal future, the
// keys behind the window, the padding past Sk.  A row that sees no key
// at all (only with a window and q_offset past Sk + window) gives 0
// here, where the reference's scan gives a mean of v over its padded
// blocks; no caller of the model makes such a row.
//
// Bound on an H100 SXM at the prefill shape (B 2, S 4096, causal, Hq 28,
// Hkv 4, D = DV = 128, bf16): 8.39 M visible (q, k) pairs per (batch,
// head), 4 D flops each, ~240 GFLOP a layer = 0.24 ms at the 989 TFLOP/s
// bf16 dense tensor-core peak, against ~134 MB of q, k, v and o = 0.04
// ms at 3.35 TB/s: bound by operations.  What the design does about it:
// both products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate), the S x S scores never leave registers, tiles in the
// causal future or behind the window are skipped, and the causal grid
// runs its longest query tiles first.  One 128-thread block per (64-row
// query tile, query head, batch element), each warp owning 16 query
// rows; K and V tiles of 64 keys in two shared-memory stages, the next
// tile's cp.async copies in flight during this tile's math; B fragments
// by ldmatrix (V's transposing); the mask is evaluated only on tiles
// where some key is hidden from some row (the diagonal, the window's
// edge, the ragged end); the softmax in the log2 domain on the SFU's
// ex2.  P is rounded to bf16 for the PV product, as tensor-core flash
// attention does, and l sums the f32 p.  Not done yet: wgmma, TMA, warp
// specialisation, a persistent grid.
//
// float32 inputs take a CUDA-core kernel instead (fmaf, f32 throughout,
// within 1e-5 of the plain version): the same tiles and skips, a 16 x 8
// thread grid over each 64 x 64 score tile, scores through shared
// memory.  TF32 tensor cores would round q and k to 10 mantissa bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

__device__ __forceinline__ int query_tile(const Shape& s) {
  // causal tiles with more rows see more keys: schedule them first
  const int n = gridDim.x;
  return s.causal ? n - 1 - (int)blockIdx.x : (int)blockIdx.x;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
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
                  __nv_bfloat16* __restrict__ O, Shape s) {
  static_assert(D % 16 == 0 && DV % 16 == 0, "D and DV: multiples of 16");
  using T = Bf16Tiles<D, DV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int q0 = query_tile(s) * kBR;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / s.G;
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
                 const float* __restrict__ V, float* __restrict__ O, Shape s) {
  static_assert(DV % 8 == 0, "DV: a multiple of 8");
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kBR][D + 1]
  float* Ks = Qs + kBR * (D + 1);         // [kBC][D + 1]
  float* Vs = Ks + kBC * (D + 1);         // [kBC][DV]
  float* Ps = Vs + kBC * DV;              // [kBR][kBC + 1]
  constexpr int NO = DV / 8;

  const int q0 = query_tile(s) * kBR;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / s.G;
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
  const dim3 grid((s.Sq + kBR - 1) / kBR, s.Hq, B);
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
        static_cast<__nv_bfloat16*>(o), s);
  } else {
    constexpr size_t smem = f32_smem_bytes<D, DV>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_f32_kernel<D, DV><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The (D, DV) pairs built: repro_torch.kernels.flash_attention.HEAD_DIMS.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int Hq, int Hkv, int d, int dv,
                                      int causal, int q_offset, int window,
                                      float scale, int bf16, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{Sq, Sk, Hq, Hq / Hkv, causal, q_offset, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_CASE(D_, DV_) \
  if (d == D_ && dv == DV_) return launch<D_, DV_>(q, k, v, o, B, s, bf16, st);
  REPRO_FLASH_CASE(16, 16)
  REPRO_FLASH_CASE(32, 32)
  REPRO_FLASH_CASE(64, 64)
  REPRO_FLASH_CASE(128, 128)
  REPRO_FLASH_CASE(32, 16)
#undef REPRO_FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
