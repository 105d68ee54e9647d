// Fused dequantize-and-apply of a chain of quantized broadcast deltas.
//
//   acc = w[r, c];  for d in 0..D-1: acc = fma(float(q[d, r, c]), s[d, r], acc)
//   out[r, c] = acc            w: (R, C) f32, q: (D, R, C) int8, s: (D, R) f32
//
// Replaces the Pallas TPU kernel repro/kernels/broadcast.py::
// apply_quantized_broadcast (body _apply_kernel), which cut R into
// (256, 256) VMEM blocks with the whole chain resident and needed R padded
// to that block.  Here any R is taken as it is.
//
// Bit parity: the jitted reference contracts acc + q*s into one fused
// multiply-add per step, so each step is one __fmaf_rn, strictly in chain
// order.  One D-deep call therefore gives the same bits as D calls of
// depth 1 (the master's incremental reference), which a stale worker
// folding its whole gap relies on.  Built without --use_fast_math.
//
// What bounds it on an H100: memory.  A call reads w (4 bytes per
// element) and each delta (1 byte per element plus 4 bytes per row) and
// writes out (4 bytes per element): 8*R*C + D*(R*C + 4*R) bytes for 2*D
// flops per element.  At the main path's R = 27, D = 1 that is 62 KB: the
// launch costs more than the bytes.
//
// What the design does about it: one thread per element with a
// grid-stride loop; neighbouring threads read neighbouring addresses of
// every operand (coalesced at any alignment), the chain loop keeps the
// accumulator in a register, and each byte crosses the bus once.  No
// shared memory, no atomics.
//
// Plain C interface, loaded with ctypes.  The entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller sees a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

__global__ void __launch_bounds__(kThreads)
apply_chain(const float* __restrict__ w, const int8_t* __restrict__ q,
            const float* __restrict__ s, float* __restrict__ out, int64_t D,
            int64_t R, int64_t C) {
  const int64_t n = R * C;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int64_t r = i / C;
    float acc = w[i];
    for (int64_t d = 0; d < D; ++d)
      acc = __fmaf_rn((float)q[d * n + i], __ldg(s + d * R + r), acc);
    out[i] = acc;
  }
}

}  // namespace

extern "C" int apply_quantized_broadcast_f32(const float* w, const int8_t* q,
                                             const float* s, float* out, int64_t D,
                                             int64_t R, int64_t C, void* stream) {
  const int64_t n = R * C;
  if (n <= 0) return (int)cudaGetLastError();
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  apply_chain<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      w, q, s, out, D, R, C);
  return (int)cudaGetLastError();
}
