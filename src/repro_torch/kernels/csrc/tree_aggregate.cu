// Per-group weighted sums of children's flattened updates: one tree level.
//
//   out[g, l] = sum_c w[g, c] * x[g, c, l]      x: (G, C, L) f32, bf16 or int8
//                                               w: (G, C) f32, out: (G, L) f32
//
// Replaces the Pallas TPU kernel repro/kernels/tree_aggregate.py::
// tree_aggregate_groups (body _group_kernel), which cut the arrays into
// (GROUP_BLOCK, C, TILE) VMEM blocks.  Those blocks were sized for the TPU's
// VMEM and its (8, 128) tiling and are not carried over.
//
// What bounds it on an H100: memory.  Every input element is read once and
// used for one multiply-add, so the kernel moves G*C*L*esize + G*C*4 bytes in
// and G*L*4 bytes out at 2 flops per input element -- far below the ~20 flops
// per byte where the card's f32 rate would become the limit.  At 3.35 TB/s a
// bench-sized call (C=16, L=131072, bf16) needs about 1.4 us; one level of
// the quickstart tree (L=6792, G*C in the tens) needs well under 1 us, so
// there the launch costs more than the bytes.
//
// The int8 instantiation serves the compressed async apply
// (buffered_aggregate_quantized): G = rows of 256 QSGD lattice points, C =
// buffered commits, w = staleness weight times row scale.  int8 -> f32 is
// exact, so it gives the same bits as the f32 instantiation on q.float().
//
// What the design does about it: each thread owns VPT consecutive l (16-byte
// loads: 4 f32, 8 bf16 or 16 int8) and walks c = 0..C-1 in order, keeping VPT f32
// accumulators in registers, so each input byte crosses the memory bus once
// and neighbouring threads read neighbouring addresses.  The grid is
// (G, L chunks): G on x, where the grid allows up to 2^31-1 blocks, the L
// chunks on y with a grid-stride loop past 65535.  No shared memory and no
// atomics, so the result is the same on every run.  The kernel masks its
// own ragged edge (no TILE padding): rows whose length or base pointer
// rules out 16-byte loads take the scalar path.  A zero weight with a zero
// or finite input adds an exact zero, which ragged groups rely on.
//
// Plain C interface, loaded with ctypes.  Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller sees a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

template <typename T>
struct Vec;  // VPT elements of T in one 16-byte load

template <>
struct Vec<float> {
  static constexpr int kVPT = 4;
  __device__ static void load(const float* p, float* dst) {
    float4 v = *reinterpret_cast<const float4*>(p);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kVPT = 8;
  __device__ static void load(const __nv_bfloat16* p, float* dst) {
    uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Vec<int8_t> {
  static constexpr int kVPT = 16;
  __device__ static void load(const int8_t* p, float* dst) {
    int4 v = *reinterpret_cast<const int4*>(p);
    const char4* c = reinterpret_cast<const char4*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dst[4 * i] = (float)c[i].x;
      dst[4 * i + 1] = (float)c[i].y;
      dst[4 * i + 2] = (float)c[i].z;
      dst[4 * i + 3] = (float)c[i].w;
    }
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16-byte path: L % VPT == 0 and 16-byte aligned bases, so a thread's VPT
// elements are either all inside the row or all past its end.
template <typename T>
__global__ void __launch_bounds__(kThreads)
group_sum_vec(const T* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ out, int64_t C, int64_t L) {
  constexpr int VPT = Vec<T>::kVPT;
  const int64_t g = blockIdx.x;
  const int64_t chunk = (int64_t)kThreads * VPT;
  const int64_t n_chunks = (L + chunk - 1) / chunk;
  const float* wg = w + g * C;
  for (int64_t ch = blockIdx.y; ch < n_chunks; ch += gridDim.y) {
    const int64_t l0 = ch * chunk + (int64_t)threadIdx.x * VPT;
    if (l0 >= L) continue;
    float acc[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) acc[i] = 0.0f;
    const T* xp = x + g * C * L + l0;
    for (int64_t c = 0; c < C; ++c) {
      const float wc = __ldg(wg + c);
      float v[VPT];
      Vec<T>::load(xp + c * L, v);
#pragma unroll
      for (int i = 0; i < VPT; ++i) acc[i] = fmaf(wc, v[i], acc[i]);
    }
    float4* op = reinterpret_cast<float4*>(out + g * L + l0);
#pragma unroll
    for (int i = 0; i < VPT / 4; ++i)
      op[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// Scalar path for any L and alignment: thread t of a chunk owns elements
// l0 + t + k*kThreads, k < VPT, each masked against L.
template <typename T>
__global__ void __launch_bounds__(kThreads)
group_sum_scalar(const T* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ out, int64_t C, int64_t L) {
  constexpr int VPT = Vec<T>::kVPT;
  const int64_t g = blockIdx.x;
  const int64_t chunk = (int64_t)kThreads * VPT;
  const int64_t n_chunks = (L + chunk - 1) / chunk;
  const float* wg = w + g * C;
  for (int64_t ch = blockIdx.y; ch < n_chunks; ch += gridDim.y) {
    const int64_t l0 = ch * chunk + threadIdx.x;
    float acc[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) acc[i] = 0.0f;
    const T* xp = x + g * C * L;
    for (int64_t c = 0; c < C; ++c) {
      const float wc = __ldg(wg + c);
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int64_t l = l0 + (int64_t)i * kThreads;
        if (l < L) acc[i] = fmaf(wc, to_float(xp[c * L + l]), acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int64_t l = l0 + (int64_t)i * kThreads;
      if (l < L) out[g * L + l] = acc[i];
    }
  }
}

template <typename T>
int launch(const void* x, const float* w, float* out, int64_t G, int64_t C,
           int64_t L, cudaStream_t stream) {
  if (G <= 0 || L <= 0) return (int)cudaGetLastError();
  constexpr int VPT = Vec<T>::kVPT;
  const int64_t chunk = (int64_t)kThreads * VPT;
  const int64_t n_chunks = (L + chunk - 1) / chunk;
  const dim3 grid((unsigned)G, (unsigned)(n_chunks < kMaxGridY ? n_chunks : kMaxGridY));
  const T* xt = static_cast<const T*>(x);
  const bool aligned = (L % VPT == 0) &&
                       (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (aligned)
    group_sum_vec<T><<<grid, kThreads, 0, stream>>>(xt, w, out, C, L);
  else
    group_sum_scalar<T><<<grid, kThreads, 0, stream>>>(xt, w, out, C, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tree_aggregate_groups_f32(const void* x, const float* w, float* out,
                                         int64_t G, int64_t C, int64_t L,
                                         void* stream) {
  return launch<float>(x, w, out, G, C, L, static_cast<cudaStream_t>(stream));
}

extern "C" int tree_aggregate_groups_bf16(const void* x, const float* w, float* out,
                                          int64_t G, int64_t C, int64_t L,
                                          void* stream) {
  return launch<__nv_bfloat16>(x, w, out, G, C, L, static_cast<cudaStream_t>(stream));
}


extern "C" int tree_aggregate_groups_i8(const void* x, const float* w, float* out,
                                        int64_t G, int64_t C, int64_t L,
                                        void* stream) {
  return launch<int8_t>(x, w, out, G, C, L, static_cast<cudaStream_t>(stream));
}
