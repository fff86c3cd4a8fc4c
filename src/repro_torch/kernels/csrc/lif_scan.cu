// Flat multi-step LIF recurrence: spikes[T, N] from currents[T, N].
//
// Replaces the TPU kernel lif_scan_pallas (src/repro/kernels/lif_scan.py),
// which keeps a neuron block's membrane in VMEM across the T steps.  Here
// one thread owns one neuron and keeps u in a register for the whole
// window: each current is read once and each spike written once.
//
// What bounds it on the H100: bytes (8 bytes per neuron-step against
// ~10 flops); on the main path (ctrl_hidden, [5, 64B]) it is one launch's
// latency.  Neighbouring threads take neighbouring neurons, so every
// step's loads and stores coalesce.
//
// Rounding: every operation is a separate round-to-nearest intrinsic in
// the plain version's order -- u = ((decay * (u - v_reset)) + v_reset) + i,
// then the hard reset u = u*(1-s) + v_reset*s -- so nvcc cannot contract a
// multiply-add into an FMA, and the result is bit-exact against the plain
// PyTorch recurrence.  ``decay`` is the float32 exp(-1/tau) the wrapper
// computed with torch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void lif_scan_kernel(const float* __restrict__ cur,
                                float* __restrict__ out, int T, int64_t N,
                                float decay, float v_th, float v_reset) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float u = v_reset;
  for (int t = 0; t < T; ++t) {
    const float i_t = cur[(int64_t)t * N + n];
    u = __fadd_rn(__fadd_rn(__fmul_rn(decay, __fsub_rn(u, v_reset)), v_reset),
                  i_t);
    const float s = (__fsub_rn(u, v_th) >= 0.f) ? 1.f : 0.f;
    u = __fadd_rn(__fmul_rn(u, __fsub_rn(1.f, s)), __fmul_rn(v_reset, s));
    out[(int64_t)t * N + n] = s;
  }
}

}  // namespace

extern "C" int lif_scan_launch(const float* cur, float* out, int T, int64_t N,
                               float decay, float v_th, float v_reset,
                               void* stream) {
  const int threads = 256;
  const int64_t blocks = (N + threads - 1) / threads;
  lif_scan_kernel<<<(unsigned)blocks, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(cur, out, T, N, decay,
                                                         v_th, v_reset);
  return static_cast<int>(cudaGetLastError());
}
