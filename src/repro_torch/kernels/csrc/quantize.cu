// QSGD int8 stochastic quantization and its inverse, on rows of values.
//
//   scale[r] = max(max_c |x[r, c]| * inv_levels, 1e-12)
//   q[r, c]  = int8(clamp(floor(x[r, c] / scale[r] + u[r, c]), -128, 127))
//   res[r, c] = x[r, c] - float(q[r, c]) * scale[r]    (optional: the EF residual)
//   out[r, c] = float(q[r, c]) * scale[r]                    (dequantize)
//
// Replaces the Pallas TPU kernels repro/kernels/quantize.py::qsgd_quantize
// (body _quant_kernel) and ::qsgd_dequantize (body _dequant_kernel), which
// cut R into (256, 256) VMEM blocks and needed R padded to that block.
// Here any R is taken as it is.  Quantize takes rows of 256; dequantize any
// (R, C).
//
// Bit parity with the JAX package's compiled path (see ref.py):
//   - the scale is max|x| times the f32 reciprocal of levels, computed on
//     the host (XLA rewrites the division by a constant so), with
//     __fmul_rn; x / scale is a true division, __fdiv_rn, then __fadd_rn;
//   - the lattice value is clamped before the cast, because JAX's
//     f32 -> int8 cast saturates and floor(.) can reach 128;
//   - the residual rounds twice, __fmul_rn then __fsub_rn, no FMA: the
//     reference rounds fl(q * s) in numpy, then subtracts in XLA;
//   - the file is built without --use_fast_math.
//
// What bounds it on an H100: memory.  Quantize reads x and u (8 bytes per
// element) and writes q (1 byte) and one f32 scale per row: 9*R*256 + 4*R
// bytes for a handful of flops per element; with the residual, 13*R*256 +
// 4*R.  Dequantize moves 5*R*C + 4*R bytes.  All are far below the card's
// flop rate; at the main path's R = 27 a call moves 62-90 KB, so the launch
// costs more than the bytes.
//
// What the design does about it:
//   - quantize gives each row kRowThreads threads and packs kRowsPerBlock
//     rows into a block, so that the path's R = 27 spreads over 14 SMs, not
//     4 (64 threads a row, 2 rows a block: the best of
//     tools/sweep_port_kernels.py; rows of 32 or 16 threads were slower).
//     Thread t of a row loads its x and its uniforms u in the same trip, as
//     16-byte float4 loads at 4t + k*4*kRowThreads (every warp instruction
//     covers 512 contiguous bytes), takes the row max with a
//     __shfl_xor_sync butterfly (and, past one warp a row, through shared
//     memory), and writes its lattice points as 4-byte char4 stores.  The
//     loop over row blocks is uniform across the block, so every thread
//     reaches each __syncthreads, the ragged last block included.  Bases
//     that rule out 16-byte loads take the scalar kernel: one warp a row,
//     lane l owning elements l, l+32, ..., l+224 (coalesced at any
//     alignment).  The row max is exact in any order, so the reduction's
//     shape does not change a bit.
//   - the error-feedback residual is a compile-time option of both quantize
//     kernels (kResidual): the launch that holds x, q and s in registers
//     writes x - q*s too (float4 stores), so the async commit needs no
//     dequantize launch after its quantize.  With the option off the
//     kernels are the code they were before it existed.
//   - dequantize gives a 256-wide row two warps (kDqLanes = 64): lane l
//     loads the row's scale once and the 4-byte int8 vector l, and stores
//     it as one float4, so each warp load covers 128 contiguous bytes and
//     each warp store 512 (wider rows loop, 64 vectors apart).  One 8-byte
//     load a lane (a warp a row, lane l owning elements 8l..8l+7) writes
//     two float4s 32 bytes apart, so each store instruction fills half of
//     every sector it touches: at 65,536 rows it took 33.7-38.8 us against
//     30.9-31.2 for 4-byte vectors, and a warp a row with two 4-byte vectors
//     a lane tied with two warps (tools/sweep_port_kernels.py).
//     kDqRowsPerBlock rows share a block, and the row comes from the lane
//     group's index, so no element divides.  Rows whose width or base rules
//     out the vectors take the scalar kernel: one warp a row, any C, any
//     alignment.
//   No atomics: the result is the same on every run.
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
constexpr int kThreads = 256;     // the scalar quantize and dequantize kernels
constexpr int kPerLane = kRow / kWarp;
constexpr int64_t kMaxBlocks = 1 << 20;
constexpr int kDqBytes = 4;       // int8 lattice points a dequantize lane loads at once
constexpr int kDqLanes = 64;      // lanes per row: a 256-wide row is one vector a lane
constexpr int kDqRowsPerBlock = 2;
constexpr int kDqThreads = kDqLanes * kDqRowsPerBlock;
static_assert(kVecs >= 1 && kRow % (4 * kRowThreads) == 0, "a row is whole float4s per thread");
static_assert(kQuantThreads % kWarp == 0, "the butterfly's full mask needs whole warps");
static_assert(kDqBytes % 4 == 0, "float4 stores of whole int8 vectors");

// kBytes int8 lattice points in one load, widened to f32 (exact).
template <int kBytes>
struct I8Vec;
template <>
struct I8Vec<4> { using Raw = int; };
template <>
struct I8Vec<8> { using Raw = int2; };
template <>
struct I8Vec<16> { using Raw = int4; };

template <int kBytes>
__device__ __forceinline__ void load_i8(const int8_t* p, float (&f)[kBytes]) {
  const typename I8Vec<kBytes>::Raw raw = *reinterpret_cast<const typename I8Vec<kBytes>::Raw*>(p);
#pragma unroll
  for (int k = 0; k < kBytes; ++k) f[k] = (float)reinterpret_cast<const signed char*>(&raw)[k];
}

// floor(v / s + u) saturated into int8, as JAX's cast does (parity rules 1-2).
__device__ __forceinline__ signed char lattice(float v, float u, float s) {
  float f = floorf(__fadd_rn(__fdiv_rn(v, s), u));
  f = fminf(fmaxf(f, -128.0f), 127.0f);
  return (signed char)__float2int_rz(f);
}

__device__ __forceinline__ float absmax4(float m, float4 v) {
  return fmaxf(fmaxf(fmaxf(m, fabsf(v.x)), fmaxf(fabsf(v.y), fabsf(v.z))), fabsf(v.w));
}

// The EF residual of one lattice point: fl(x - fl(q * s)), two roundings.
__device__ __forceinline__ float residual(float v, signed char qi, float s) {
  return __fsub_rn(v, __fmul_rn((float)qi, s));
}

// 16-byte path: x, u (and res) 16-byte aligned, q 4-byte aligned.  res is
// written only by the kResidual instance (and is last, so that the other
// instance's parameters sit where they did before the option).
template <bool kResidual>
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows(const float* __restrict__ x, const float* __restrict__ u,
              int8_t* __restrict__ q, float* __restrict__ scale, int64_t R,
              float inv_levels, float* __restrict__ res) {
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
      for (int k = 0; k < kVecs; ++k) {
        const char4 qv = make_char4(lattice(xv[k].x, uv[k].x, s), lattice(xv[k].y, uv[k].y, s),
                                    lattice(xv[k].z, uv[k].z, s), lattice(xv[k].w, uv[k].w, s));
        qr[t + k * kRowThreads] = qv;
        if constexpr (kResidual)
          reinterpret_cast<float4*>(res + r * kRow)[t + k * kRowThreads] =
              make_float4(residual(xv[k].x, qv.x, s), residual(xv[k].y, qv.y, s),
                          residual(xv[k].z, qv.z, s), residual(xv[k].w, qv.w, s));
      }
      if (t == 0) scale[r] = s;
    }
  }
}

// Any alignment: one warp a row, 4-byte loads, x and u in the same trip.
template <bool kResidual>
__global__ void __launch_bounds__(kThreads)
quantize_rows_scalar(const float* __restrict__ x, const float* __restrict__ u,
                     int8_t* __restrict__ q, float* __restrict__ scale, int64_t R,
                     float inv_levels, float* __restrict__ res) {
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
    for (int i = 0; i < kPerLane; ++i) {
      const signed char qi = lattice(v[i], ru[i], s);
      qr[lane + i * kWarp] = qi;
      if constexpr (kResidual) res[r * kRow + lane + i * kWarp] = residual(v[i], qi, s);
    }
    if (lane == 0) scale[r] = s;
  }
}

// Vector path: C a multiple of kDqBytes, q kDqBytes-aligned, out 16-byte
// aligned.  Lane group g of a block owns row blockIdx.x * kDqRowsPerBlock +
// g; lane l loads the kDqBytes lattice points of vectors l, l + kDqLanes,
// ... and stores each as float4s, so every warp store instruction covers
// contiguous whole sectors.
__global__ void __launch_bounds__(kDqThreads)
dequantize_rows(const int8_t* __restrict__ q, const float* __restrict__ scale,
                float* __restrict__ out, int64_t R, int64_t C) {
  const int lane = threadIdx.x % kDqLanes;
  const int64_t n_vec = C / kDqBytes;
  for (int64_t r = (int64_t)blockIdx.x * kDqRowsPerBlock + threadIdx.x / kDqLanes; r < R;
       r += (int64_t)gridDim.x * kDqRowsPerBlock) {
    const float s = __ldg(scale + r);
    const int8_t* qr = q + r * C;
    float4* outr = reinterpret_cast<float4*>(out + r * C);
    for (int64_t v = lane; v < n_vec; v += kDqLanes) {
      float f[kDqBytes];
      load_i8<kDqBytes>(qr + v * kDqBytes, f);
#pragma unroll
      for (int i = 0; i < kDqBytes / 4; ++i)
        outr[v * (kDqBytes / 4) + i] = make_float4(__fmul_rn(f[4 * i], s), __fmul_rn(f[4 * i + 1], s),
                                                   __fmul_rn(f[4 * i + 2], s), __fmul_rn(f[4 * i + 3], s));
    }
  }
}

// Any C, any alignment: one warp a row, lane l owning elements l, l+32, ...
__global__ void __launch_bounds__(kThreads)
dequantize_rows_scalar(const int8_t* __restrict__ q, const float* __restrict__ scale,
                       float* __restrict__ out, int64_t R, int64_t C) {
  const int lane = threadIdx.x % kWarp;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / kWarp);
  for (int64_t r = (int64_t)blockIdx.x * (kThreads / kWarp) + threadIdx.x / kWarp; r < R;
       r += warps) {
    const float s = __ldg(scale + r);
    for (int64_t c = lane; c < C; c += kWarp) out[r * C + c] = __fmul_rn((float)q[r * C + c], s);
  }
}

unsigned blocks_for(int64_t units, int64_t per_block) {
  const int64_t b = (units + per_block - 1) / per_block;
  return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
}

template <bool kResidual>
int quantize(const float* x, const float* u, int8_t* q, float* scale, float* res, int64_t R,
             float inv_levels, void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
                       (!kResidual || reinterpret_cast<uintptr_t>(res) % 16 == 0);
  if (aligned)
    quantize_rows<kResidual><<<blocks_for(R, kRowsPerBlock), kQuantThreads, 0, st>>>(
        x, u, q, scale, R, inv_levels, res);
  else
    quantize_rows_scalar<kResidual><<<blocks_for(R, kThreads / kWarp), kThreads, 0, st>>>(
        x, u, q, scale, R, inv_levels, res);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qsgd_quantize_f32(const float* x, const float* u, int8_t* q, float* scale,
                                 int64_t R, float inv_levels, void* stream) {
  return quantize<false>(x, u, q, scale, nullptr, R, inv_levels, stream);
}

// The same, also writing the EF residual x - q*s into res (R, 256) f32.
extern "C" int qsgd_quantize_residual_f32(const float* x, const float* u, int8_t* q, float* scale,
                                          float* res, int64_t R, float inv_levels, void* stream) {
  return quantize<true>(x, u, q, scale, res, R, inv_levels, stream);
}

extern "C" int qsgd_dequantize_i8(const int8_t* q, const float* scale, float* out,
                                  int64_t R, int64_t C, void* stream) {
  if (R <= 0 || C <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = C % kDqBytes == 0 && reinterpret_cast<uintptr_t>(q) % kDqBytes == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec)
    dequantize_rows<<<blocks_for(R, kDqRowsPerBlock), kDqThreads, 0, st>>>(q, scale, out, R, C);
  else
    dequantize_rows_scalar<<<blocks_for(R, kThreads / kWarp), kThreads, 0, st>>>(q, scale, out, R,
                                                                                C);
  return (int)cudaGetLastError();
}
