// Flat multi-step LIF recurrence: spikes[T, N] from currents[T, N], with
// an optional bias[C] added to each current first (the currents are
// [T, N / C, C] flattened, C their last dimension: neuron n takes
// bias[n mod C]).  A dense layer's bias add rides in this launch.
//
// Replaces the TPU kernel lif_scan_pallas (src/repro/kernels/lif_scan.py),
// which keeps a neuron block's membrane in VMEM across the T steps.  Here
// one thread owns one neuron and keeps u in a register for the whole
// window: each current is read once and each spike written once, step
// by step (issuing a thread's T loads before the recurrence measured no
// faster on the H100 at the control head's [5, 512], where the launch
// sets the time).  The bias index is a magic-number divide in 32 bits
// (N < 2^31 when a bias is given), never a 64-bit %.
//
// What bounds it on the H100: bytes (8 bytes per neuron-step against
// ~10 flops); on the main path (ctrl_hidden, [5, 64B] with the bias) the
// 2.5 KB move in nanoseconds, so the launch's own latency sets the time.
// Neighbouring threads take neighbouring neurons, so every step's loads
// and stores coalesce.
//
// Rounding: the bias add is one __fadd_rn(current, bias), torch's y +
// bias exactly.  Then every operation is a separate round-to-nearest
// intrinsic in the plain version's order -- u = ((decay * (u - v_reset))
// + v_reset) + i, then the hard reset u = u*(1-s) + v_reset*s -- so nvcc
// cannot contract a multiply-add into an FMA, and the result is bit-exact
// against the plain PyTorch recurrence on (currents + bias).  ``decay`` is
// the float32 exp(-1/tau) the wrapper computed with torch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_slab.cuh"

namespace {

using repro::FastDiv;

constexpr int kThreads = 256;

struct LifArgs {
  const float* cur;
  const float* bias;         // [C], or null
  float* out;
  int64_t N;
  int T, C;
  FastDiv fc;                // C
  float decay, v_th, v_reset;
};

__device__ __forceinline__ float lif_step(float& u, float i_t,
                                          const LifArgs& a) {
  u = __fadd_rn(
      __fadd_rn(__fmul_rn(a.decay, __fsub_rn(u, a.v_reset)), a.v_reset),
      i_t);
  const float s = (__fsub_rn(u, a.v_th) >= 0.f) ? 1.f : 0.f;
  u = __fadd_rn(__fmul_rn(u, __fsub_rn(1.f, s)), __fmul_rn(a.v_reset, s));
  return s;
}

__global__ void __launch_bounds__(kThreads)
lif_scan_kernel(const LifArgs a) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;
  float bi = 0.f;
  if (a.bias) {
    const int n32 = static_cast<int>(n);
    bi = __ldg(a.bias + (n32 - a.fc.div(n32) * a.C));
  }
  float u = a.v_reset;
  for (int t = 0; t < a.T; ++t) {
    const float c = __ldg(a.cur + (int64_t)t * a.N + n);
    const float i_t = a.bias ? __fadd_rn(c, bi) : c;
    a.out[(int64_t)t * a.N + n] = lif_step(u, i_t, a);
  }
}

}  // namespace

// bias: [C] or null (C ignored); with a bias, C must divide N and N be
// below 2^31.
extern "C" int lif_scan_launch(const float* cur, const float* bias,
                               float* out, int T, int64_t N, int C,
                               float decay, float v_th, float v_reset,
                               void* stream) {
  if (T < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bias && (C < 1 || N >= (int64_t(1) << 31) || N % C != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (N + kThreads - 1) / kThreads;
  if (blocks >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  LifArgs a;
  a.cur = cur;
  a.bias = bias;
  a.out = out;
  a.N = N;
  a.T = T;
  a.C = bias ? C : 1;
  a.fc = FastDiv(a.C);
  a.decay = decay;
  a.v_th = v_th;
  a.v_reset = v_reset;
  lif_scan_kernel<<<(unsigned)blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
