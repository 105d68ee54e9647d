// Fused FedProx client update: SGD step + proximal term + weight decay.
//
//   out[i] = w[i] - lr * (g[i] + mu * (w[i] - w0[i]) + wd * w[i])
//
// computed in f32 and stored in the type of w (f32 or bf16, rounded to
// nearest even).  Replaces the Pallas TPU kernel repro/kernels/
// fused_update.py::fused_update (body _kernel), which cut L into
// 2048-element VMEM tiles and needed L padded to that tile.  Here any L
// is taken as it is, and out may be w itself (the in-place update).
//
// Bit parity: XLA compiles the reference into t = w - w0 followed by
// three fused multiply-adds, a = fma(mu, t, g), b = fma(wd, w, a),
// out = fma(-lr, b, w).  The kernel writes exactly that with __fsub_rn
// and __fmaf_rn, lr, mu and wd as f32 from the host, and is built
// without --use_fast_math.  At mu = wd = 0 the step is fma(-lr, g, w).
//
// What bounds it on an H100: memory.  A call reads w, g and w0 and writes
// out: L * (3 * s_in + s_out) bytes (16 per element in f32, 8 in bf16)
// for 7 flops per element, far under the card's flop rate at 3.35 TB/s.
// At the main path's leaves (a few thousand elements per worker row) a
// call moves well under a megabyte and the launch costs more.
//
// What the design does about it: each thread moves 16 bytes of every
// operand at a time (4 f32 or 8 bf16) when all four pointers are 16-byte
// aligned, neighbouring threads on neighbouring addresses, in a
// grid-stride loop; a masked scalar loop takes the tail, and the whole
// length when the pointers are not aligned.  Each byte crosses the bus
// once; no shared memory, no atomics.  w and out carry no __restrict__:
// each element is read before it is written, by the same thread.
//
// Plain C interface, loaded with ctypes.  Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller sees a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

struct F32 {
  using S = float;
  __device__ static float load(S x) { return x; }
  __device__ static S store(float f) { return f; }
};

struct BF16 {
  using S = unsigned short;
  __device__ static float load(S x) { return __uint_as_float((unsigned)x << 16); }
  __device__ static S store(float f) { return __bfloat16_as_ushort(__float2bfloat16_rn(f)); }
};

__device__ __forceinline__ float update(float w, float g, float w0, float lr, float mu,
                                        float wd) {
  const float a = __fmaf_rn(mu, __fsub_rn(w, w0), g);
  const float b = __fmaf_rn(wd, w, a);
  return __fmaf_rn(-lr, b, w);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const typename T::S* w, const typename T::S* __restrict__ g,
                    const typename T::S* __restrict__ w0, typename T::S* out, int64_t n,
                    int64_t nvec, float lr, float mu, float wd) {
  using S = typename T::S;
  constexpr int V = 16 / sizeof(S);
  union Vec {
    uint4 u;
    S s[V];
  };
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int64_t i = first; i < nvec; i += stride) {
    Vec vw, vg, v0, vo;
    vw.u = reinterpret_cast<const uint4*>(w)[i];
    vg.u = reinterpret_cast<const uint4*>(g)[i];
    v0.u = reinterpret_cast<const uint4*>(w0)[i];
#pragma unroll
    for (int j = 0; j < V; ++j)
      vo.s[j] = T::store(update(T::load(vw.s[j]), T::load(vg.s[j]), T::load(v0.s[j]), lr, mu, wd));
    reinterpret_cast<uint4*>(out)[i] = vo.u;
  }
  for (int64_t i = nvec * V + first; i < n; i += stride)
    out[i] = T::store(update(T::load(w[i]), T::load(g[i]), T::load(w0[i]), lr, mu, wd));
}

template <typename T>
int launch(const void* w, const void* g, const void* w0, void* out, int64_t n, float lr,
           float mu, float wd, void* stream) {
  using S = typename T::S;
  if (n <= 0) return (int)cudaGetLastError();
  constexpr int V = 16 / sizeof(S);
  const uintptr_t bits = (uintptr_t)w | (uintptr_t)g | (uintptr_t)w0 | (uintptr_t)out;
  const int64_t nvec = (bits % 16 == 0) ? n / V : 0;
  const int64_t tail = n - nvec * V;
  const int64_t units = nvec > tail ? nvec : tail;  // one pass of either loop
  int64_t blocks = (units + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fused_update_kernel<T><<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(w), static_cast<const S*>(g), static_cast<const S*>(w0),
      static_cast<S*>(out), n, nvec, lr, mu, wd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_update_f32(const void* w, const void* g, const void* w0, void* out,
                                int64_t n, float lr, float mu, float wd, void* stream) {
  return launch<F32>(w, g, w0, out, n, lr, mu, wd, stream);
}

extern "C" int fused_update_bf16(const void* w, const void* g, const void* w0, void* out,
                                 int64_t n, float lr, float mu, float wd, void* stream) {
  return launch<BF16>(w, g, w0, out, n, lr, mu, wd, stream);
}
