// DVS event voxelization: event buffers [B, N] -> voxel grids
// [B, T, H, W, 2] in the binary, count or signed mode.
//
// Replaces the TPU kernel event_voxel_pallas
// (src/repro/kernels/event_voxel.py), where one program keeps a
// [block_t, H, W, 2] slab in VMEM and streams the window's events past
// it.  Here one block owns one (window b, time bin t, chunk of the
// H*W*2 cells) slab in shared memory (at most kChunk cells, 32 KB; the
// 64x64 path is one chunk); all three sit on gridDim.x, chunk fastest,
// so any batch and bin count up to 2^31 - 1 blocks in all.  The block
// zeroes the slab, its threads walk the
// window's events and atomicAdd 1.0 into the slab for each live event
// of its bin and chunk, then the mode pass runs on the slab and each
// cell is written once, coalesced.  One launch, no memset and no second
// pass over the grid in device memory.
//
// What bounds it on the H100: bytes -- the grid written once (1.3 MB at
// B=8, T=5, 64x64) and the events read (17 bytes each, 278 KB for
// 8 x 2048).  The T x chunks blocks of a window each re-read its events
// from L2; at the path's shape that is 40 blocks, so one launch's
// latency dominates.
//
// Exactness: adding 1.0 to counts below 2^24 is exact in any order, so
// the atomics leave the same counts as the plain scatter.  The bin is
// floor((t / window) * T), divided first and multiplied second in
// float32 with round-to-nearest intrinsics, then saturated to the int32
// range as the plain version's saturate_int32 (NaN -> 0, +-inf and
// values beyond the range -> its ends, the reference's XLA cast), tested
// explicitly so nothing rests on how cvt treats NaN; invalid events and
// out-of-range x/y/p are dropped before any index is formed; the drop
// policy is applied before the clamp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8192;   // cells per block (even: whole polarity pairs)

enum Mode { kBinary = 0, kCount = 1, kSigned = 2 };

__global__ void event_voxel_kernel(const float* __restrict__ t,
                                   const int* __restrict__ x,
                                   const int* __restrict__ y,
                                   const int* __restrict__ p,
                                   const unsigned char* __restrict__ valid,
                                   float* __restrict__ out, int N, int T,
                                   int H, int W, float window, int mode,
                                   int drop, int chunks) {
  extern __shared__ float slab[];
  const int chunk = (int)(blockIdx.x % chunks);
  const int rest = (int)(blockIdx.x / chunks);
  const int tb = rest % T;
  const int b = rest / T;
  const int64_t cells = (int64_t)H * W * 2;
  const int64_t c0 = (int64_t)chunk * kChunk;
  const int n = (int)(cells - c0 < kChunk ? cells - c0 : kChunk);
  for (int i = threadIdx.x; i < n; i += blockDim.x) slab[i] = 0.f;
  __syncthreads();

  const int64_t e0 = (int64_t)b * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int64_t e = e0 + i;
    if (!valid[e]) continue;
    const int xi = x[e], yi = y[e], pi = p[e];
    if (xi < 0 || xi >= W || yi < 0 || yi >= H || pi < 0 || pi >= 2)
      continue;
    const float q = floorf(__fmul_rn(__fdiv_rn(t[e], window), (float)T));
    // saturate as XLA's float -> int32 cast: NaN -> 0, beyond the
    // int32 range (inf included) -> its ends; no float->int cvt of NaN
    long long bin = isnan(q) ? 0LL
                    : q >= 2147483648.f ? 2147483647LL
                    : q < -2147483648.f ? -2147483648LL
                    : (long long)q;
    if (drop && (bin < 0 || bin >= T)) continue;
    bin = bin < 0 ? 0 : (bin > T - 1 ? T - 1 : bin);
    if (bin != tb) continue;
    const int64_t cell = ((int64_t)yi * W + xi) * 2 + pi - c0;
    if (cell < 0 || cell >= n) continue;
    atomicAdd(&slab[cell], 1.f);
  }
  __syncthreads();

  float* o = out + ((int64_t)b * T + tb) * cells + c0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float v = slab[i];
    if (mode == kBinary) {
      v = v > 0.f ? 1.f : 0.f;
    } else if (mode == kSigned) {
      // cells pair up as (OFF, ON); signed writes (ON - OFF, ON + OFF)
      const float off = slab[i & ~1], on = slab[i | 1];
      v = (i & 1) ? __fadd_rn(on, off) : __fsub_rn(on, off);
    }
    o[i] = v;
  }
}

}  // namespace

extern "C" int event_voxel_launch(const float* t, const int* x, const int* y,
                                  const int* p, const unsigned char* valid,
                                  float* out, int B, int N, int T, int H,
                                  int W, float window, int mode, int drop,
                                  void* stream) {
  const int64_t cells = (int64_t)H * W * 2;
  const int64_t chunks = (cells + kChunk - 1) / kChunk;
  const int64_t blocks = chunks * T * B;
  if (B < 1 || T < 1 || blocks >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (cells < kChunk ? cells : kChunk);
  event_voxel_kernel<<<(unsigned)blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      t, x, y, p, valid, out, N, T, H, W, window, mode, drop, (int)chunks);
  return static_cast<int>(cudaGetLastError());
}
