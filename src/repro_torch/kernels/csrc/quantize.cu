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
// What the design does about it: quantize gives each row to one warp.
// Lane l owns elements l, l+32, ..., l+224, so every load and store of the
// warp touches 32 neighbouring elements (coalesced, any alignment), the
// row max is a 5-step __shfl_xor_sync butterfly in registers, and each
// input byte crosses the bus once.  No shared memory, no atomics: the
// result is the same on every run.  Dequantize is one thread per element
// with a grid-stride loop.
//
// Plain C interface, loaded with ctypes.  Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller sees a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRow = 256;
constexpr int kWarp = 32;
constexpr int kPerLane = kRow / kWarp;  // 8
constexpr int kThreads = 256;           // 8 warps = 8 rows per block
constexpr int kRowsPerBlock = kThreads / kWarp;
constexpr int64_t kMaxBlocks = 1 << 20;

__global__ void __launch_bounds__(kThreads)
quantize_rows(const float* __restrict__ x, const float* __restrict__ u,
              int8_t* __restrict__ q, float* __restrict__ scale, int64_t R,
              float inv_levels) {
  const int lane = threadIdx.x % kWarp;
  const int64_t warps = (int64_t)gridDim.x * kRowsPerBlock;
  for (int64_t r = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp; r < R;
       r += warps) {
    const float* xr = x + r * kRow;
    float v[kPerLane];
    float m = 0.0f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      v[i] = xr[lane + i * kWarp];
      m = fmaxf(m, fabsf(v[i]));
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float s = fmaxf(__fmul_rn(m, inv_levels), 1e-12f);
    const float* ur = u + r * kRow;
    int8_t* qr = q + r * kRow;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      float f = floorf(__fadd_rn(__fdiv_rn(v[i], s), ur[lane + i * kWarp]));
      f = fminf(fmaxf(f, -128.0f), 127.0f);
      qr[lane + i * kWarp] = (int8_t)__float2int_rz(f);
    }
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
  quantize_rows<<<blocks_for(R, kRowsPerBlock), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, u, q, scale, R, inv_levels);
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
