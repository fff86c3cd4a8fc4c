// DVS event voxelization: event buffers [B, N] -> voxel grids
// [B, T, H, W, 2] in the binary, count or signed mode.  For the tick's
// encode a window that was staged as voxels (from_events[b] false) is
// copied from the staged [T, B, H, W, 2] grid instead of binned: the
// encode and its select in one launch (the wrapper returns the [T, B]
// view of the batch-major grid, so the first layer's fold is a view).
//
// Replaces the TPU kernel event_voxel_pallas
// (src/repro/kernels/event_voxel.py), where one program keeps a
// [block_t, H, W, 2] slab in VMEM and streams the window's events past
// it.  Here a thread-block cluster owns a contiguous range of one
// window's flattened (t, y, x, p) cells, `cells` a block in its shared
// memory (the host plan, voxel_plan in kernels/event_voxel.py, cached
// per shape; this launcher checks its arguments against it):
//   - each block reads its share of the window's events once (16-byte
//     loads of t, x, y, p where the rows allow; the first group's loads
//     in flight while it zeroes its cells and arrives at the cluster
//     barrier), bins each event and, after the barrier's wait, adds one
//     to the owning block's integer count through distributed shared
//     memory (an atomic add);
//   - one cluster barrier later, each block converts its counts to
//     float32, runs the mode pass (signed on whole (OFF, ON) pairs) and
//     writes them with 16-byte stores (8-byte where a frame's H * W * 2
//     cells are not a multiple of 4).
// At the tick (64x64, T 5) a window's 40960 cells fit one cluster of 16
// blocks of 10 KB: 128 blocks at batch 8, each event read once.  A larger
// grid (a DAVIS346 frame, 720x1280) takes several clusters a window,
// each reading the window's events and dropping those outside its range.
// Windows, clusters and blocks all sit on gridDim.x, so any batch and
// bin count up to 2^31 - 1 blocks in all.
//
// What bounds it on the H100: bytes -- the grid written once (1.3 MB at
// B=8, T=5, 64x64) and the events read (17 bytes each, 278 KB for
// 8 x 2048); at the tick's size one launch's latency dominates.
//
// Exactness: the plain scatter adds 1.0 in float32, exact in any order
// below 2^24; an integer count below 2^24 converts to that same float, so
// the grid is the plain version's bit for bit (a window would need 2^24
// events in one cell to reach the bound).  The bin is
// floor((t / window) * T), divided first and multiplied second in
// float32 with round-to-nearest intrinsics, then saturated to the int32
// range as the plain version's saturate_int32 (NaN -> 0, +-inf and
// values beyond the range -> its ends, the reference's XLA cast), tested
// explicitly so nothing rests on how cvt treats NaN; invalid events and
// out-of-range x/y/p are dropped before any index is formed; the drop
// policy is applied before the clamp.  A copied window's values are moved
// as they are.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_slab.cuh"

namespace {

namespace cg = cooperative_groups;
using repro::FastDiv;

constexpr int kThreads = 128;     // kernels/event_voxel.py VOXEL_THREADS
constexpr int kMaxCluster = 16;   // MAX_CLUSTER
constexpr int kMaxCells = 6144;   // MAX_CELLS: cells a block at most

enum Mode { kBinary = 0, kCount = 1, kSigned = 2 };

struct VoxelArgs {
  const float* t;
  const int* x;
  const int* y;
  const int* p;
  const unsigned char* valid;
  const unsigned char* from_events;   // [B], or null: bin every window
  const float* vox;                   // the staged [T, B, H, W, 2] grid
  float* out;                         // [B, T, H, W, 2]
  int N, T, H, W;
  float window;
  int mode, drop;
  int cluster, cells, clusters;       // the plan
  int grid;                           // T * H * W * 2 cells a window
  int share;                          // events a block reads (4k)
  int vec;                            // 16-byte event loads
  int B;
  int F;                              // H * W * 2 cells a frame
  FastDiv fF;
};

// The window-relative cell of one event minus cl0, or -1 if the event is
// dead, out of range, dropped by the policy or outside [cl0, cl0 + span).
__device__ __forceinline__ int event_cell(const VoxelArgs& a, float tv,
                                          int xi, int yi, int pi, bool live,
                                          int cl0, int span) {
  if (!live) return -1;
  if (xi < 0 || xi >= a.W || yi < 0 || yi >= a.H || pi < 0 || pi >= 2)
    return -1;
  const float q = floorf(__fmul_rn(__fdiv_rn(tv, a.window), (float)a.T));
  // saturate as XLA's float -> int32 cast: NaN -> 0, beyond the int32
  // range (inf included) -> its ends; no float->int cvt of NaN
  long long bin = isnan(q) ? 0LL
                  : q >= 2147483648.f ? 2147483647LL
                  : q < -2147483648.f ? -2147483648LL
                  : (long long)q;
  if (a.drop && (bin < 0 || bin >= a.T)) return -1;
  bin = bin < 0 ? 0 : (bin > a.T - 1 ? a.T - 1 : bin);
  const long long cell = ((bin * a.H + yi) * a.W + xi) * 2 + pi - cl0;
  return cell >= 0 && cell < span ? static_cast<int>(cell) : -1;
}

// V cells (whole (OFF, ON) pairs) at a time: load, mode, store
template <int V>
struct Cells;
template <>
struct Cells<4> {
  static __device__ void load(float* v, const float* p) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Cells<2> {
  static __device__ void load(float* v, const float* p) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
  static __device__ void store(float* p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};

template <int V>
__device__ __forceinline__ void mode_pass(float* v, int mode) {
#pragma unroll
  for (int k = 0; k < V; k += 2) {
    const float off = v[k], on = v[k + 1];
    if (mode == kBinary) {
      v[k] = off > 0.f ? 1.f : 0.f;
      v[k + 1] = on > 0.f ? 1.f : 0.f;
    } else if (mode == kSigned) {   // (ON - OFF, ON + OFF)
      v[k] = __fsub_rn(on, off);
      v[k + 1] = __fadd_rn(on, off);
    }
  }
}

// The block's n cells of window b from cell c0 on: the staged grid
// copied (copy; its frame (t, b) at (t * B + b) * F) or its counts as
// float32 through the mode pass, written V cells a store.
template <int V>
__device__ __forceinline__ void write_cells(const VoxelArgs& a,
                                            const unsigned* counts, int b,
                                            int c0, int n, bool copy) {
  float* out = a.out + (int64_t)b * a.grid;
  for (int g = threadIdx.x; g < n / V; g += blockDim.x) {
    const int c = c0 + g * V;
    float v[V];
    if (copy) {
      const int t = a.fF.div(c);
      Cells<V>::load(v, a.vox + ((int64_t)t * a.B + b) * a.F + (c - t * a.F));
    } else {
      Cells<V>::load(v, reinterpret_cast<const float*>(counts) + g * V);
#pragma unroll
      for (int k = 0; k < V; ++k)     // exact below 2^24
        v[k] = __uint2float_rn(__float_as_uint(v[k]));
      mode_pass<V>(v, a.mode);
    }
    Cells<V>::store(out + c, v);
  }
}

// Four consecutive events of a window, as loaded
struct Events4 {
  float t[4];
  int x[4], y[4], p[4];
  unsigned char live[4];
};

__global__ void __launch_bounds__(kThreads)
event_voxel_kernel(const VoxelArgs a) {
  // the block's cells as integer counts: an integer add is one native
  // atomic on shared memory and on a peer's (a float add there is a
  // compare-and-swap loop), and a count below 2^24 converts to the float
  // the plain scatter's adds of 1.0 reach
  extern __shared__ uint4 slab4[];
  unsigned* counts = reinterpret_cast<unsigned*>(slab4);
  const int K = a.cluster;
  const int rank = static_cast<int>(blockIdx.x % K);   // rank in the cluster
  const int cid = static_cast<int>(blockIdx.x / K);
  const int b = cid / a.clusters;
  const int cl0 = (cid - b * a.clusters) * K * a.cells;   // cluster's first
  const int span = K * a.cells;
  const int c0 = cl0 + rank * a.cells;                    // block's first
  const int n = max(0, min(a.cells, a.grid - c0));
  const bool vec4 = a.F % 4 == 0;

  if (a.from_events && !a.from_events[b]) {
    // the window was staged as voxels: the whole cluster copies them
    if (vec4) write_cells<4>(a, counts, b, c0, n, true);
    else write_cells<2>(a, counts, b, c0, n, true);
    return;
  }

  // this block's share of the window's events, four a thread at a time
  const int64_t row = (int64_t)b * a.N;
  const int e_lo = rank * a.share;
  const int e_hi = min(a.N, e_lo + a.share);
  Events4 ev;
  auto load4 = [&](int e) {
    if (a.vec && e < e_hi) {
      const float4 tv = *reinterpret_cast<const float4*>(a.t + row + e);
      const int4 xv = *reinterpret_cast<const int4*>(a.x + row + e);
      const int4 yv = *reinterpret_cast<const int4*>(a.y + row + e);
      const int4 pv = *reinterpret_cast<const int4*>(a.p + row + e);
      const uchar4 lv = *reinterpret_cast<const uchar4*>(a.valid + row + e);
      ev = {{tv.x, tv.y, tv.z, tv.w}, {xv.x, xv.y, xv.z, xv.w},
            {yv.x, yv.y, yv.z, yv.w}, {pv.x, pv.y, pv.z, pv.w},
            {lv.x, lv.y, lv.z, lv.w}};
      return;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool in = e + k < e_hi;
      const int64_t i = row + (in ? e + k : 0);
      ev.t[k] = in ? a.t[i] : 0.f;
      ev.x[k] = in ? a.x[i] : 0;
      ev.y[k] = in ? a.y[i] : 0;
      ev.p[k] = in ? a.p[i] : 0;
      ev.live[k] = in ? a.valid[i] : 0;
    }
  };
  int e = e_lo + 4 * static_cast<int>(threadIdx.x);
  load4(e);                      // the first loads overlap the zeroing
  for (int i = threadIdx.x; i < a.cells / 4; i += blockDim.x)
    slab4[i] = make_uint4(0u, 0u, 0u, 0u);
  if (K > 1) repro::cluster_arrive();   // every slab zeroed before an add
  else __syncthreads();
  int cell[4];
  auto bin4 = [&] {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      cell[k] = event_cell(a, ev.t[k], ev.x[k], ev.y[k], ev.p[k],
                           ev.live[k], cl0, span);
  };
  bin4();
  if (K > 1) repro::cluster_wait();
  for (;;) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (cell[k] < 0) continue;
      const int owner = cell[k] / a.cells;
      unsigned* dst = counts + (cell[k] - owner * a.cells);
      if (owner != rank) dst = cg::this_cluster().map_shared_rank(dst, owner);
      atomicAdd(dst, 1u);
    }
    e += 4 * static_cast<int>(blockDim.x);
    if (e >= e_hi) break;
    load4(e);
    bin4();
  }
  // every add landed before a block reads its cells; no block touches a
  // peer's shared memory after this barrier, so each may exit
  if (K > 1) {
    repro::cluster_arrive();
    repro::cluster_wait();
  } else {
    __syncthreads();
  }
  if (vec4) write_cells<4>(a, counts, b, c0, n, false);
  else write_cells<2>(a, counts, b, c0, n, false);
}

}  // namespace

// t [B, N] float32, x, y, p [B, N] int32, valid [B, N] bool -> out
// [B, T, H, W, 2].  With from_events ([B] bool) and vox (the staged
// [T, B, H, W, 2] grid; both or neither), a window whose flag is false is
// copied from vox.  The plan (cluster, cells, clusters, threads, smem) is
// voxel_plan's, share (events a block reads, whole groups of four)
// event_share's; an argument they do not fit returns
// cudaErrorInvalidValue.
extern "C" int event_voxel_launch(const float* t, const int* x, const int* y,
                                  const int* p, const unsigned char* valid,
                                  const unsigned char* from_events,
                                  const float* vox, float* out, int B, int N,
                                  int T, int H, int W, float window, int mode,
                                  int drop, int cluster,
                                  int cells, int clusters, int share,
                                  int threads, int smem, void* stream) {
  const int64_t F = (int64_t)H * W * 2, grid = F * T;
  const int64_t span = (int64_t)cluster * cells;
  const int64_t blocks = (int64_t)B * clusters * cluster;
  // the stores' width: 16 bytes where a frame is whole groups of four
  const uintptr_t store = F % 4 == 0 ? 16 : 8;
  const bool ok =
      B >= 1 && N >= 0 && T >= 1 && H >= 1 && W >= 1 && mode >= kBinary &&
      mode <= kSigned && cluster >= 1 && cluster <= kMaxCluster &&
      cells >= 4 && cells % 4 == 0 && cells <= kMaxCells && clusters >= 1 &&
      share >= 0 && share % 4 == 0 && (int64_t)share * cluster >= N &&
      (int64_t)share * cluster < (int64_t)N + 4 * cluster &&
      threads == kThreads && smem == cells * static_cast<int>(sizeof(float)) &&
      span * clusters >= grid && span * (clusters - 1) < grid &&
      grid + span < (int64_t(1) << 31) && blocks < (int64_t(1) << 31) &&
      (from_events == nullptr) == (vox == nullptr) &&
      reinterpret_cast<uintptr_t>(out) % store == 0 &&
      reinterpret_cast<uintptr_t>(vox) % store == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  VoxelArgs a;
  a.t = t;
  a.x = x;
  a.y = y;
  a.p = p;
  a.valid = valid;
  a.from_events = from_events;
  a.vox = vox;
  a.out = out;
  a.N = N;
  a.T = T;
  a.H = H;
  a.W = W;
  a.window = window;
  a.mode = mode;
  a.drop = drop;
  a.cluster = cluster;
  a.cells = cells;
  a.clusters = clusters;
  a.grid = static_cast<int>(grid);
  a.share = share;
  const uintptr_t rows = reinterpret_cast<uintptr_t>(t) |
                         reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(p);
  a.vec = N % 4 == 0 && rows % 16 == 0 &&
          reinterpret_cast<uintptr_t>(valid) % 4 == 0;
  a.B = B;
  a.F = static_cast<int>(F);
  a.fF = FastDiv(static_cast<uint32_t>(F));
  return repro::launch_cluster(event_voxel_kernel, a,
                               static_cast<int>(blocks), cluster, kThreads,
                               static_cast<size_t>(smem),
                               kMaxCells * static_cast<int>(sizeof(float)),
                               static_cast<cudaStream_t>(stream));
}
