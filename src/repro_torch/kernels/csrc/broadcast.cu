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
// What the design does about it: the layout of quantize.cu's dequantize.
// A 256-wide row gets two warps (kLanes = 64); lane l owns the 4-element
// vector l: it reads w as a float4, then per delta step one 4-byte int8
// load and the row's scale, does one __fmaf_rn per element, and writes out
// as a float4, so every warp access covers contiguous whole sectors, every
// byte crosses the bus once, and the accumulators stay in registers.  A
// warp a row with two vectors a lane took 3.46 us at D = 3, R = 4096,
// against 2.90 (the two vectors' trips did not overlap); one 8-byte load a
// lane writes half sectors (tools/sweep_port_kernels.py).  kRowsPerBlock rows
// share a block and the row comes from the lane group's index: no element
// divides.  Depths 1-4 are unrolled (the chain cap defaults to 3), so all
// of a lane's loads are in flight before its first fma; deeper chains take
// a loop.  Rows whose width or bases rule out the vectors (a misaligned
// view) take the scalar kernel: one warp a row, any C, any alignment.  No
// shared memory, no atomics.
//
// Plain C interface, loaded with ctypes.  The entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller sees a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBytes = 4;         // int8 lattice points (elements) a lane loads at once
constexpr int kLanes = 64;        // lanes per row: a 256-wide row is one vector a lane
constexpr int kRowsPerBlock = 2;
constexpr int kVecThreads = kLanes * kRowsPerBlock;
constexpr int kThreads = 256;     // the scalar kernel
constexpr int64_t kMaxBlocks = 1 << 20;
static_assert(kBytes % 4 == 0, "float4 accesses of whole int8 vectors");

// kBytes int8 lattice points in one load, widened to f32 (exact).
template <int N>
struct I8Vec;
template <>
struct I8Vec<4> { using Raw = int; };
template <>
struct I8Vec<8> { using Raw = int2; };
template <>
struct I8Vec<16> { using Raw = int4; };

template <int N>
__device__ __forceinline__ void load_i8(const int8_t* p, float (&f)[N]) {
  const typename I8Vec<N>::Raw raw = *reinterpret_cast<const typename I8Vec<N>::Raw*>(p);
#pragma unroll
  for (int k = 0; k < N; ++k) f[k] = (float)reinterpret_cast<const signed char*>(&raw)[k];
}

// Vector path: C a multiple of kBytes, w and out 16-byte aligned, q
// kBytes-aligned.  Lane l of a row owns vectors l, l + kLanes, ...  kD > 0
// is the chain depth, unrolled; kD = 0 loops over D.
template <int kD>
__global__ void __launch_bounds__(kVecThreads)
apply_chain(const float* __restrict__ w, const int8_t* __restrict__ q,
            const float* __restrict__ s, float* __restrict__ out, int64_t D, int64_t R,
            int64_t C) {
  const int lane = threadIdx.x % kLanes;
  const int64_t n = R * C, n_vec = C / kBytes;
  const int64_t depth = kD > 0 ? kD : D;
  for (int64_t r = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes; r < R;
       r += (int64_t)gridDim.x * kRowsPerBlock) {
    for (int64_t v = lane; v < n_vec; v += kLanes) {
      const int64_t off = r * C + v * kBytes;
      float acc[kBytes];
#pragma unroll
      for (int i = 0; i < kBytes / 4; ++i) {
        const float4 wv = reinterpret_cast<const float4*>(w + off)[i];
        acc[4 * i] = wv.x;
        acc[4 * i + 1] = wv.y;
        acc[4 * i + 2] = wv.z;
        acc[4 * i + 3] = wv.w;
      }
#pragma unroll
      for (int64_t d = 0; d < depth; ++d) {  // chain order
        float f[kBytes];
        load_i8<kBytes>(q + d * n + off, f);
        const float sd = __ldg(s + d * R + r);
#pragma unroll
        for (int k = 0; k < kBytes; ++k) acc[k] = __fmaf_rn(f[k], sd, acc[k]);
      }
#pragma unroll
      for (int i = 0; i < kBytes / 4; ++i)
        reinterpret_cast<float4*>(out + off)[i] =
            make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
}

// Any C, any alignment: one warp a row, lane l owning elements l, l+32, ...
__global__ void __launch_bounds__(kThreads)
apply_chain_scalar(const float* __restrict__ w, const int8_t* __restrict__ q,
                   const float* __restrict__ s, float* __restrict__ out, int64_t D, int64_t R,
                   int64_t C) {
  const int lane = threadIdx.x % kWarp;
  const int64_t n = R * C;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / kWarp);
  for (int64_t r = (int64_t)blockIdx.x * (kThreads / kWarp) + threadIdx.x / kWarp; r < R;
       r += warps) {
    for (int64_t c = lane; c < C; c += kWarp) {
      const int64_t i = r * C + c;
      float acc = w[i];
      for (int64_t d = 0; d < D; ++d) acc = __fmaf_rn((float)q[d * n + i], __ldg(s + d * R + r), acc);
      out[i] = acc;
    }
  }
}

unsigned blocks_for(int64_t units, int64_t per_block) {
  const int64_t b = (units + per_block - 1) / per_block;
  return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" int apply_quantized_broadcast_f32(const float* w, const int8_t* q,
                                             const float* s, float* out, int64_t D,
                                             int64_t R, int64_t C, void* stream) {
  if (R <= 0 || C <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = C % kBytes == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % kBytes == 0;
  const unsigned blocks = blocks_for(R, kRowsPerBlock);
  if (!vec) {
    apply_chain_scalar<<<blocks_for(R, kThreads / kWarp), kThreads, 0, st>>>(w, q, s, out, D, R, C);
    return (int)cudaGetLastError();
  }
  switch (D) {  // depths 1-4 unrolled
    case 1: apply_chain<1><<<blocks, kVecThreads, 0, st>>>(w, q, s, out, D, R, C); break;
    case 2: apply_chain<2><<<blocks, kVecThreads, 0, st>>>(w, q, s, out, D, R, C); break;
    case 3: apply_chain<3><<<blocks, kVecThreads, 0, st>>>(w, q, s, out, D, R, C); break;
    case 4: apply_chain<4><<<blocks, kVecThreads, 0, st>>>(w, q, s, out, D, R, C); break;
    default: apply_chain<0><<<blocks, kVecThreads, 0, st>>>(w, q, s, out, D, R, C);
  }
  return (int)cudaGetLastError();
}
