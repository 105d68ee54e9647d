// QSGD int8 stochastic quantization and its inverse, on rows of 256 values.
//
//   scale[r] = max(max_c |x[r, c]| * inv_levels, 1e-12)
//   q[r, c]  = int8(clamp(floor(x[r, c] / scale[r] + u[r, c]), -128, 127))
//   out[r, c] = float(q[r, c]) * scale[r]                    (dequantize)
//
// Replaces the Pallas TPU kernels repro/kernels/quantize.py::qsgd_quantize
// (body _quant_kernel) and ::qsgd_dequantize (body _dequant_kernel), which
// cut R into (256, 256) VMEM blocks and needed R padded to that block.
// Here any R is taken as it is.
//
// Bit parity with the JAX package's compiled path (see ref.py):
//   - the scale is max|x| times the f32 reciprocal of levels, computed on
//     the host (XLA rewrites the division by a constant so), with
//     __fmul_rn; x / scale is a true division, __fdiv_rn, then __fadd_rn;
//   - the lattice value is clamped before the cast, because JAX's
//     f32 -> int8 cast saturates and floor(.) can reach 128;
//   - the file is built without --use_fast_math.
//
// What bounds it on an H100: memory.  Quantize reads x and u (8 bytes per
// element) and writes q (1 byte) and one f32 scale per row: 9*R*256 + 4*R
// bytes for a handful of flops per element.  Dequantize moves 5*R*256 +
// 4*R bytes.  Both are far below the card's flop rate; at the main path's
// R = 27 a call moves 62 KB, so the launch costs more than the bytes.
//
// What the design does about it: quantize gives each row kRowThreads
// threads and packs kRowsPerBlock rows into a block, so that the path's
// R = 27 spreads over 14 SMs, not 4 (64 threads a row, 2 rows a block: the
// best of tools/sweep_port_kernels.py; rows of 32 or 16 threads were
// slower).  Thread t of a row loads its x and its uniforms u in the same
// trip, as 16-byte float4 loads at 4t + k*4*kRowThreads (every warp
// instruction covers 512 contiguous bytes), takes the row max
// with a __shfl_xor_sync butterfly (and, past one warp a row, through shared
// memory), and writes its lattice points as 4-byte char4 stores.  The loop
// over row blocks is uniform across the block, so every thread reaches each
// __syncthreads, the ragged last block included.  Bases that rule out
// 16-byte loads take the scalar kernel: one warp a row, lane l owning
// elements l, l+32, ..., l+224 (coalesced at any alignment).  The row max is
// exact in any order, so the reduction's shape does not change a bit.  No
// atomics: the result is the same on every run.  Dequantize is one thread
// per element with a grid-stride loop.
//
// Plain C interface, loaded with ctypes.  Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller sees a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRow = 256;
constexpr int kWarp = 32;
constexpr int kRowThreads = 64;   // threads per row (16, 32 or 64)
constexpr int kRowsPerBlock = 2;
constexpr int kQuantThreads = kRowThreads * kRowsPerBlock;
constexpr int kVecs = kRow / (4 * kRowThreads);  // float4 loads per thread and operand
constexpr int kRowWarps = (kRowThreads + kWarp - 1) / kWarp;
constexpr int kThreads = 256;     // the scalar quantize and the dequantize kernel
constexpr int kPerLane = kRow / kWarp;
constexpr int64_t kMaxBlocks = 1 << 20;
static_assert(kVecs >= 1 && kRow % (4 * kRowThreads) == 0, "a row is whole float4s per thread");
static_assert(kQuantThreads % kWarp == 0, "the butterfly's full mask needs whole warps");

// floor(v / s + u) saturated into int8, as JAX's cast does (parity rules 1-2).
__device__ __forceinline__ signed char lattice(float v, float u, float s) {
  float f = floorf(__fadd_rn(__fdiv_rn(v, s), u));
  f = fminf(fmaxf(f, -128.0f), 127.0f);
  return (signed char)__float2int_rz(f);
}

__device__ __forceinline__ float absmax4(float m, float4 v) {
  return fmaxf(fmaxf(fmaxf(m, fabsf(v.x)), fmaxf(fabsf(v.y), fabsf(v.z))), fabsf(v.w));
}

// 16-byte path: x and u 16-byte aligned, q 4-byte aligned.
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows(const float* __restrict__ x, const float* __restrict__ u,
              int8_t* __restrict__ q, float* __restrict__ scale, int64_t R,
              float inv_levels) {
  __shared__ float part[kRowsPerBlock][kRowWarps];
  const int t = threadIdx.x % kRowThreads;
  const int row_in_block = threadIdx.x / kRowThreads;
  const int64_t n_blocks = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  for (int64_t b = blockIdx.x; b < n_blocks; b += gridDim.x) {  // uniform over the block
    const int64_t r = b * kRowsPerBlock + row_in_block;
    const bool live = r < R;
    float4 xv[kVecs], uv[kVecs];
    float m = 0.0f;
    if (live) {
      const float4* xr = reinterpret_cast<const float4*>(x + r * kRow);
      const float4* ur = reinterpret_cast<const float4*>(u + r * kRow);
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        xv[k] = xr[t + k * kRowThreads];
        uv[k] = ur[t + k * kRowThreads];
      }
#pragma unroll
      for (int k = 0; k < kVecs; ++k) m = absmax4(m, xv[k]);
    }
#pragma unroll
    for (int off = (kRowThreads < kWarp ? kRowThreads : kWarp) / 2; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if constexpr (kRowWarps > 1) {
      if (threadIdx.x % kWarp == 0) part[row_in_block][t / kWarp] = m;
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kRowWarps; ++i) m = fmaxf(m, part[row_in_block][i]);
      __syncthreads();  // part is rewritten by the next row block
    }
    const float s = fmaxf(__fmul_rn(m, inv_levels), 1e-12f);
    if (live) {
      char4* qr = reinterpret_cast<char4*>(q + r * kRow);
#pragma unroll
      for (int k = 0; k < kVecs; ++k)
        qr[t + k * kRowThreads] = make_char4(lattice(xv[k].x, uv[k].x, s), lattice(xv[k].y, uv[k].y, s),
                                             lattice(xv[k].z, uv[k].z, s), lattice(xv[k].w, uv[k].w, s));
      if (t == 0) scale[r] = s;
    }
  }
}

// Any alignment: one warp a row, 4-byte loads, x and u in the same trip.
__global__ void __launch_bounds__(kThreads)
quantize_rows_scalar(const float* __restrict__ x, const float* __restrict__ u,
                     int8_t* __restrict__ q, float* __restrict__ scale, int64_t R,
                     float inv_levels) {
  const int lane = threadIdx.x % kWarp;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / kWarp);
  for (int64_t r = (int64_t)blockIdx.x * (kThreads / kWarp) + threadIdx.x / kWarp; r < R;
       r += warps) {
    const float* xr = x + r * kRow;
    const float* ur = u + r * kRow;
    float v[kPerLane], ru[kPerLane];
    float m = 0.0f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      v[i] = xr[lane + i * kWarp];
      ru[i] = ur[lane + i * kWarp];
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) m = fmaxf(m, fabsf(v[i]));
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float s = fmaxf(__fmul_rn(m, inv_levels), 1e-12f);
    int8_t* qr = q + r * kRow;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) qr[lane + i * kWarp] = lattice(v[i], ru[i], s);
    if (lane == 0) scale[r] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
dequantize_rows(const int8_t* __restrict__ q, const float* __restrict__ scale,
                float* __restrict__ out, int64_t n, int64_t C) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride)
    out[i] = __fmul_rn((float)q[i], __ldg(scale + i / C));
}

unsigned blocks_for(int64_t units, int64_t per_block) {
  const int64_t b = (units + per_block - 1) / per_block;
  return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" int qsgd_quantize_f32(const float* x, const float* u, int8_t* q, float* scale,
                                 int64_t R, float inv_levels, void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % 4 == 0;
  if (aligned)
    quantize_rows<<<blocks_for(R, kRowsPerBlock), kQuantThreads, 0, st>>>(x, u, q, scale, R,
                                                                        inv_levels);
  else
    quantize_rows_scalar<<<blocks_for(R, kThreads / kWarp), kThreads, 0, st>>>(x, u, q, scale, R,
                                                                              inv_levels);
  return (int)cudaGetLastError();
}

extern "C" int qsgd_dequantize_i8(const int8_t* q, const float* scale, float* out,
                                  int64_t R, int64_t C, void* stream) {
  const int64_t n = R * C;
  if (n <= 0) return (int)cudaGetLastError();
  dequantize_rows<<<blocks_for(n, kThreads), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(q, scale, out, n, C);
  return (int)cudaGetLastError();
}
