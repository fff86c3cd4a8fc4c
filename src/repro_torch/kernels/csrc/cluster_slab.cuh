// What the kernels that hold a (batch element, channel tile) slab in a
// thread-block cluster share: the norm epilogue (norm_affine_lif.cu) and
// the fused conv->LIF layer (spike_conv_lif.cu).  The statistics chains
// (chain_sum: one class in row order, in double), the split cluster
// barrier, vector lanes that read a peer's shared memory, host-made magic
// division, and the cluster launch (shared memory and the non-portable
// 16-block size opted into once per kernel and device; whether the card
// can hold one such cluster asked once per shape).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kChainAhead = 4;        // a chain's terms loaded ahead
// the cluster could not be scheduled on this card (returned as an error)
constexpr int kErrClusterUnschedulable = -1;

// V consecutive floats: loaded (global, shared or a cluster peer's shared
// memory through a generic pointer) and stored, 16 bytes at a time for 4
template <int V>
struct Lane {
  __device__ static void load(float* d, const float* p) { d[0] = *p; }
  __device__ static void store(float* p, const float* d) { *p = d[0]; }
};
template <>
struct Lane<4> {
  __device__ static void load(float* d, const float* p) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  __device__ static void store(float* p, const float* d) {
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  }
};

// acc + term(j) + term(j + 1) + ... + term(j1 - 1), in that order, one
// double add at a time; the next kChainAhead terms are loaded and widened
// while the current ones are added, so the chain waits on the adds
template <class F>
__device__ __forceinline__ double chain_sum(double acc, int j, int j1,
                                            F term) {
  constexpr int G = kChainAhead;
  if (j + G <= j1) {
    double nxt[G];
#pragma unroll
    for (int g = 0; g < G; ++g) nxt[g] = term(j + g);
    for (j += G; j + G <= j1; j += G) {
      double cur[G];
#pragma unroll
      for (int g = 0; g < G; ++g) cur[g] = nxt[g];
#pragma unroll
      for (int g = 0; g < G; ++g) nxt[g] = term(j + g);
#pragma unroll
      for (int g = 0; g < G; ++g) acc += cur[g];
    }
#pragma unroll
    for (int g = 0; g < G; ++g) acc += nxt[g];
  }
  for (; j < j1; ++j) acc += term(j);
  return acc;
}

// the two halves of a cluster barrier: arrive (release) and wait
// (acquire), so a block can go on working between them; every thread of
// the block executes both (.aligned)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// x / d for 0 <= x < 2^31 by a multiply and a shift (the divisor's magic
// number made on the host)
struct FastDiv {
  uint32_t d, m, s;
  FastDiv() = default;
  explicit FastDiv(uint32_t div) : d(div), s(0) {
    while ((uint64_t(1) << s) < d) ++s;
    m = static_cast<uint32_t>(
        ((uint64_t(1) << 32) * ((uint64_t(1) << s) - d)) / d + 1);
  }
  __device__ __forceinline__ int div(int x) const {
    return static_cast<int>((__umulhi(static_cast<uint32_t>(x), m) +
                             static_cast<uint32_t>(x)) >> s);
  }
};

inline int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

// kern<<<blocks, threads, smem, stream>>>(a) in clusters of `cluster`
// blocks on gridDim.x (a cluster of one: a plain launch).  Returns a
// cudaError_t, or kErrClusterUnschedulable when the card cannot hold one
// such cluster.
template <class Args>
int launch_cluster(void (*kern)(Args), const Args& a, int blocks,
                   int cluster, int threads, size_t smem, int max_smem,
                   cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // once per kernel and device: shared memory up to max_smem, clusters
  // of 16
  struct Ready { const void* kern; int dev; };
  static Ready ready[256];
  static int n_ready = 0;
  bool set = false;
  for (int k = 0; k < n_ready; ++k)
    set |= ready[k].kern == reinterpret_cast<const void*>(kern) &&
           ready[k].dev == dev;
  if (!set) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (n_ready < 256)
      ready[n_ready++] = {reinterpret_cast<const void*>(kern), dev};
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;   // one block: a plain launch
  // whether the card can hold one such cluster, asked once per
  // (kernel, device, cluster, threads, shared memory)
  struct Seen {
    const void* kern;
    int dev, cluster, threads;
    size_t smem;
    int ok;
  };
  static Seen seen[256];
  static int n_seen = 0;
  int ok = cluster == 1 ? 1 : -1;
  for (int k = 0; k < n_seen && ok < 0; ++k)
    if (seen[k].kern == reinterpret_cast<const void*>(kern) &&
        seen[k].dev == dev && seen[k].cluster == cluster &&
        seen[k].threads == threads && seen[k].smem == smem)
      ok = seen[k].ok;
  if (ok < 0) {
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    ok = clusters >= 1;
    if (n_seen < 256)
      seen[n_seen++] = {reinterpret_cast<const void*>(kern), dev, cluster,
                        threads, smem, ok};
  }
  if (!ok) return kErrClusterUnschedulable;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro
