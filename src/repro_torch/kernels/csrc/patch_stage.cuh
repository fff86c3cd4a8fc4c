// Implicit im2col: the patch matrix of a SAME conv staged straight from
// the folded spikes into shared memory, shared by the per-op conv
// (spike_conv.cu), the fused conv->LIF layer (spike_conv_lif.cu) and the
// fused backbone segment (backbone_segment.cu), so all read the same
// patch elements in the same order.
//
//   x [Nimg, H, W, C] fp32 NHWC; patch row m = (n, ho, wo), column
//   k = tap*C + c with tap = dy*kw + dx (spike_im2col's order); a tap
//   outside the image reads zero.
//
// A caller keeps, per row r of its tile, the row's image base pixel
// rpix[r] = n*H*W and the top-left input pixel (rh[r], rw[r]) of its
// window (a row past the caller's rows gets rh = -2^29: every tap
// outside, zero-filled).  A K slice of kPatchBK columns is copied by
// cp.async as V-float channel chunks (V = 4, 2 or 1: 16, 8 or 4 bytes;
// the caller picks V from C and x's alignment), src-size 0 zero-filling
// padding taps and k >= K.  The "mask" gate's check (mark_live_blocks)
// reads the same elements in x before any copy.
//
// Copies go through L1 (cp.async.ca) unless the caller asks for L2 only
// (L2 = true): data that another SM wrote during the same launch (the
// fused segment's spike buffers) must not be read from a stale L1 line.
// cp.async.cg takes 16-byte chunks only, so 8- and 4-byte chunks are
// then read by __ldcg and stored to shared memory directly.  The cache
// operator never enters the arithmetic.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "spike_mac.cuh"

namespace repro {

constexpr int kPatchBK = 32;               // K slice per ring stage
constexpr int kPatchLDA = kPatchBK + 4;    // padded A row (floats)
constexpr int kSlicesPerBlock = kCanonicalK / kPatchBK;
static_assert(kCanonicalK % kPatchBK == 0,
              "a slice must not straddle a canonical block");

// the activation a tile's rows read
struct PatchSrc {
  const float* x;
  int H, W, C, kw, K;
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

// V floats global -> shared; ok false: V zeros (src-size 0).  L2: past
// the SM's L1 (see above)
template <int V, bool L2 = false>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 4 * V : 0;
  if (L2 && V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else if (L2) {
#pragma unroll
    for (int v = 0; v < V; ++v) dst[v] = ok ? __ldcg(src + v) : 0.f;
  } else if (V == 4)
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

// the window of patch row (n, ho, wo) into rpix/rh/rw[r]
__device__ __forceinline__ void set_patch_row(long long* rpix, int* rh,
                                              int* rw, int r, long long n,
                                              int H, int W, int ho, int wo,
                                              int stride, int pad_h,
                                              int pad_w) {
  rpix[r] = n * H * W;
  rh[r] = ho * stride - pad_h;
  rw[r] = wo * stride - pad_w;
}

// a row with no window: every tap reads zero
__device__ __forceinline__ void clear_patch_row(long long* rpix, int* rh,
                                                int* rw, int r) {
  rpix[r] = 0;
  rh[r] = -(1 << 29);
  rw[r] = 0;
}

// "mask": live[b] = 1 for each K block kb0 + b (b < nkb) with a non-zero
// patch element at one of the tile's ROWS rows.  One item is 4 chunks of
// V consecutive k at one row, its 4 loads in flight together; items run
// K block fastest, then k, then row, so the first pass of the threads
// looks at every K block and the later items mostly find theirs marked
// already (a K block is done at its first non-zero chunk).  live[] is 0
// on entry; the caller synchronises after.
template <int V, int ROWS, int NT>
__device__ __forceinline__ void mark_live_blocks(const PatchSrc& g,
                                                 const long long* rpix,
                                                 const int* rh, const int* rw,
                                                 int* live, int kb0, int nkb,
                                                 int tid) {
  constexpr int SEG = 4 * V;
  constexpr int NSEG = kCanonicalK / SEG;
  for (int i = tid; i < ROWS * nkb * NSEG; i += NT) {
    const int b = i % nkb, rest = i / nkb;
    const int r = rest / NSEG;
    if (live[b]) continue;
    const int k0 = (kb0 + b) * kCanonicalK + (rest % NSEG) * SEG;
    bool any = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + j * V;
      const int t = k / g.C, c = k - t * g.C;
      const int dy = t / g.kw, dx = t - dy * g.kw;
      const int h = rh[r] + dy, w = rw[r] + dx;
      if (k < g.K && h >= 0 && h < g.H && w >= 0 && w < g.W)
        any |= chunk_nonzero<V>(
            g.x + static_cast<size_t>(rpix[r] +
                                      static_cast<long long>(h) * g.W + w) *
                      g.C + c);
    }
    if (any) live[b] = 1;
  }
}

// A slice s (columns [s*kPatchBK, (s+1)*kPatchBK)) of the tile's ROWS
// rows into as [ROWS][kPatchLDA]: each of the NT threads copies one fixed
// chunk column of ROWS / (NT / (kPatchBK / V)) rows; L2: past L1
template <int V, int ROWS, int NT, bool L2 = false>
__device__ __forceinline__ void load_patch_slice(const PatchSrc& g,
                                                 const long long* rpix,
                                                 const int* rh, const int* rw,
                                                 float* as, int s, int tid) {
  constexpr int ACH = kPatchBK / V;      // chunks per row of a slice
  constexpr int AROWS = NT / ACH;        // rows per pass of the threads
  constexpr int APASS = ROWS / AROWS;
  static_assert(ROWS % AROWS == 0, "the tile's rows: whole passes");
  const int a_kc = tid % ACH, a_r0 = tid / ACH;
  const int k = s * kPatchBK + a_kc * V;
  const bool kin = k < g.K;
  int c = 0, dy = 0, dx = 0;
  if (kin) {
    const int tap = k / g.C;
    c = k - tap * g.C;
    dy = tap / g.kw;
    dx = tap - dy * g.kw;
  }
#pragma unroll
  for (int p = 0; p < APASS; ++p) {
    const int r = a_r0 + p * AROWS;
    const int h = rh[r] + dy, w = rw[r] + dx;
    const bool ok = kin && h >= 0 && h < g.H && w >= 0 && w < g.W;
    const float* src =
        ok ? g.x + (static_cast<size_t>(rpix[r] +
                                        static_cast<long long>(h) * g.W + w) *
                        g.C + c)
           : g.x;
    cp_async<V, L2>(as + r * kPatchLDA + a_kc * V, src, ok);
  }
}

// The copies of one tile's A slices in order, slice 0, 1, 2, ...: each of
// the NT threads keeps its chunk column's channel and tap and its rows'
// windows in registers, so a slice costs its copies and a few adds
// (load_patch_slice re-reads the windows and divides every slice, which
// lets the "mask" gate's callers jump over dead K blocks).  The same
// chunks as load_patch_slice<4, ROWS, NT, L2>, 16-byte chunks only.
template <int ROWS, int NT, bool L2 = false>
struct PatchCursor {
  static constexpr int ACH = kPatchBK / 4;      // chunks per row of a slice
  static constexpr int AROWS = NT / ACH;        // rows per pass
  static constexpr int APASS = ROWS / AROWS;
  static_assert(ROWS % AROWS == 0, "the tile's rows: whole passes");
  const float* base[APASS];   // each row's image, at channel 0
  int h[APASS], w[APASS];     // each row's window, top left
  int H, W, C, kw, K;
  int k, c, dy, dx;           // the next slice's chunk column: k, its tap
  int dst;                    // the chunk's offset into a stage

  // the tile's row windows (set_patch_row / clear_patch_row) -> slice 0
  __device__ __forceinline__ PatchCursor(const PatchSrc& g,
                                         const long long* rpix,
                                         const int* rh, const int* rw,
                                         int tid)
      : H(g.H), W(g.W), C(g.C), kw(g.kw), K(g.K) {
    const int a_kc = tid % ACH, a_r0 = tid / ACH;
#pragma unroll
    for (int p = 0; p < APASS; ++p) {
      const int r = a_r0 + p * AROWS;
      base[p] = g.x + static_cast<size_t>(rpix[r]) * g.C;
      h[p] = rh[r];
      w[p] = rw[r];
    }
    k = a_kc * 4;
    const int tap = k / C;
    c = k - tap * C;
    dy = tap / kw;
    dx = tap - dy * kw;
    dst = a_r0 * kPatchLDA + a_kc * 4;
  }

  // this slice into the stage at as, then on to the next slice
  __device__ __forceinline__ void load(float* as) {
    const bool kin = k < K;
#pragma unroll
    for (int p = 0; p < APASS; ++p) {
      const int hh = h[p] + dy, ww = w[p] + dx;
      const bool ok = kin && hh >= 0 && hh < H && ww >= 0 && ww < W;
      cp_async<4, L2>(as + dst + p * AROWS * kPatchLDA,
                      ok ? base[p] + (hh * W + ww) * C + c : base[0], ok);
    }
    k += kPatchBK;
    for (c += kPatchBK; c >= C; c -= C)
      if (++dx == kw) {
        dx = 0;
        ++dy;
      }
  }
};

// "inline": any non-zero among the chunks this thread copied of a slice
// (after its own copies landed)
template <int V, int ROWS, int NT>
__device__ __forceinline__ int patch_slice_any(const float* as, int tid) {
  constexpr int ACH = kPatchBK / V;
  constexpr int AROWS = NT / ACH;
  constexpr int APASS = ROWS / AROWS;
  const int a_kc = tid % ACH, a_r0 = tid / ACH;
  int any = 0;
#pragma unroll
  for (int p = 0; p < APASS; ++p) {
    const float* q = as + (a_r0 + p * AROWS) * kPatchLDA + a_kc * V;
#pragma unroll
    for (int v = 0; v < V; ++v) any |= q[v] != 0.f;
  }
  return any;
}

}  // namespace repro
