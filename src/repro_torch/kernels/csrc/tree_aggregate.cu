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
// The sum of each output element is one chain, in c order from zero:
// acc = fmaf(w[g, c], x[g, c, l], acc).  ref.tree_aggregate_groups_chain
// computes the same chain on any device, bit for bit.  No split of C, no
// atomics: the result is the same on every run and for every block shape.
//
// What bounds it on an H100: memory.  Every input element is read once and
// used for one multiply-add, so the kernel moves G*C*L*esize + G*C*4 bytes in
// and G*L*4 bytes out at 2 flops per input element -- far below the ~20 flops
// per byte where the card's f32 rate would become the limit.  At 3.35 TB/s a
// bench-sized call (C=16, L=131072, bf16) needs about 1.4 us; one level of
// the quickstart tree (L=6792, G*C in the tens) needs 0.1-0.3 us, so there
// the latency of a thread's loads and the launch cost more than the bytes.
//
// The int8 instantiation serves the compressed async apply
// (buffered_aggregate_quantized): G = rows of 256 QSGD lattice points, C =
// buffered commits, w = staleness weight times row scale.  int8 -> f32 is
// exact, so it gives the same bits as the f32 instantiation on q.float().
//
// What the design does about it:
//   - a thread owns V consecutive l (one vector load: 4 f32, 8 bf16 or 8
//     int8) and keeps V f32 accumulators in registers; neighbouring threads
//     read neighbouring addresses, and each input byte crosses the bus once;
//   - children go in tiles of kChildTile: a tile's loads are all issued into
//     registers before its first fmaf, so a level of C children waits for
//     ceil(C / kChildTile) memory trips, not C.  4 is the sweep's best
//     (tools/sweep_port_kernels.py): 8 and 16 slowed even C = 1 levels, and
//     a shared-memory slab filled by cp.async, loads issued one tile ahead
//     and unpredicated exact-count tiles did no better;
//   - the block shape follows the level (chosen here, in the entry point):
//     a block is R rows of P lanes, P the smallest power of two that covers
//     a row's vectors (at most the block), so narrow rows (an int8 row of
//     256 is 32 lanes) share a block and no lane idles on them; the threads
//     per block halve from kMaxThreads down to kMinThreads until the level
//     spans kTargetBlocks blocks, so a 7k-80k-output level runs on dozens
//     of SMs, not 7 (two warps a block beat one on 54 SMs);
//   - grid: x = blocks of R groups (up to 2^31-1), y = chunks of P vectors
//     along L with a grid-stride loop past 65535.  The kernel masks its own
//     ragged edge (no TILE padding); rows whose length or base pointer rules
//     out vector loads take the same kernel at V = 1 (scalar loads).
//   - a zero weight with a zero or finite input adds an exact zero, which
//     ragged groups rely on.
//
// Plain C interface, loaded with ctypes.  Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller sees a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMinThreads = 64;
constexpr int kTargetBlocks = 132;  // one per SM of an H100 SXM
constexpr int kChildTile = 4;
constexpr int kMaxGridY = 65535;

// V elements of T in one load (V = 1: a scalar load, any alignment).  The
// f32 and bf16 vectors are 16 bytes; int8 rows take 8-byte vectors, so that
// a compressed apply's 256-element row spans 32 lanes (16-byte vectors left
// it 16 lanes and more time: tools/sweep_port_kernels.py).
template <typename T, int V>
struct Vec {
  static_assert(V == 1, "16-byte vectors are specialised below");
  using Raw = T;
  __device__ static Raw load(const T* p) { return *p; }
  __device__ static float get(const Raw& r, int) { return to_float(r); }
  __device__ static float to_float(float v) { return v; }
  __device__ static float to_float(int8_t v) { return (float)v; }
  __device__ static float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
};

template <>
struct Vec<float, 4> {
  using Raw = float4;
  __device__ static Raw load(const float* p) { return *reinterpret_cast<const float4*>(p); }
  __device__ static float get(const Raw& r, int k) { return reinterpret_cast<const float*>(&r)[k]; }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) { return *reinterpret_cast<const uint4*>(p); }
  __device__ static float get(const Raw& r, int k) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&r)[k]);
  }
};

template <>
struct Vec<int8_t, 8> {
  using Raw = int2;
  __device__ static Raw load(const int8_t* p) { return *reinterpret_cast<const int2*>(p); }
  __device__ static float get(const Raw& r, int k) {
    return (float)reinterpret_cast<const signed char*>(&r)[k];
  }
};

template <int V>
__device__ __forceinline__ void store(float* p, const float (&acc)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = acc[i];
  }
}

// One tile of up to CT children: every load first, then the fmaf chain in c
// order.  xp points at child c0's first element of this thread.
template <typename T, int V, int CT>
__device__ __forceinline__ void tile_sum(float (&acc)[V], const T* __restrict__ xp,
                                         const float* __restrict__ wp, int64_t L, int64_t n) {
  using VT = Vec<T, V>;
  typename VT::Raw raw[CT];
  float wc[CT];
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    if (j < n) {
      raw[j] = VT::load(xp + j * L);
      wc[j] = __ldg(wp + j);
    }
  }
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    if (j < n) {
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = fmaf(wc[j], VT::get(raw[j], k), acc[k]);
    }
  }
}

// The chain over all C children, one tile at a time.
template <typename T, int V, int CT>
__device__ __forceinline__ void chain_sum(float (&acc)[V], const T* __restrict__ xp,
                                          const float* __restrict__ wp, int64_t L, int64_t C) {
  for (int64_t c0 = 0; c0 < C; c0 += CT) tile_sum<T, V, CT>(acc, xp + c0 * L, wp + c0, L, C - c0);
}

// Block = (blockDim.x >> log_p) rows of 1 << log_p lanes; row g of the
// block's group range, lane over the row's V-element vectors.  V > 1
// requires L % V == 0, x aligned to its vectors and out to 16 bytes.
template <typename T, int V, int CT>
__global__ void __launch_bounds__(kMaxThreads)
group_sum(const T* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
          int64_t G, int64_t C, int64_t L, int log_p) {
  const int64_t g = (int64_t)blockIdx.x * (blockDim.x >> log_p) + (threadIdx.x >> log_p);
  if (g >= G) return;  // the ragged last block of packed rows; no barrier follows
  const int64_t P = int64_t(1) << log_p;
  const int64_t n_vec = L / V;
  const T* xg = x + g * C * L;
  const float* wg = w + g * C;
  for (int64_t v = (int64_t)blockIdx.y * P + (threadIdx.x & (P - 1)); v < n_vec;
       v += (int64_t)gridDim.y * P) {
    const int64_t l0 = v * V;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    chain_sum<T, V, CT>(acc, xg + l0, wg, L, C);
    store<V>(out + g * L + l0, acc);
  }
}

struct Layout {
  int threads, log_p;
  int64_t gx, gy;
};

// P = the smallest power of two >= the row's vectors, at most `threads`.
Layout layout(int threads, int64_t G, int64_t n_vec) {
  Layout s{threads, 0, 0, 0};
  while ((1 << s.log_p) < threads && (int64_t(1) << s.log_p) < n_vec) ++s.log_p;
  const int64_t rows = threads >> s.log_p;
  const int64_t chunks = (n_vec + (int64_t(1) << s.log_p) - 1) >> s.log_p;
  s.gx = (G + rows - 1) / rows;
  s.gy = chunks < kMaxGridY ? chunks : kMaxGridY;
  return s;
}

template <typename T, int V>
int launch_v(const T* x, const float* w, float* out, int64_t G, int64_t C, int64_t L,
             cudaStream_t stream) {
  const int64_t n_vec = L / V;
  Layout s = layout(kMaxThreads, G, n_vec);
  while (s.threads > kMinThreads && s.gx * s.gy < kTargetBlocks)
    s = layout(s.threads / 2, G, n_vec);
  group_sum<T, V, kChildTile><<<dim3((unsigned)s.gx, (unsigned)s.gy), s.threads, 0, stream>>>(
      x, w, out, G, C, L, s.log_p);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch(const void* x, const float* w, float* out, int64_t G, int64_t C, int64_t L,
           cudaStream_t stream) {
  if (G <= 0 || L <= 0) return (int)cudaGetLastError();
  const T* xt = static_cast<const T*>(x);
  const bool aligned = (L % V == 0) && (reinterpret_cast<uintptr_t>(x) % (V * sizeof(T)) == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (aligned) return launch_v<T, V>(xt, w, out, G, C, L, stream);
  return launch_v<T, 1>(xt, w, out, G, C, L, stream);
}

}  // namespace

extern "C" int tree_aggregate_groups_f32(const void* x, const float* w, float* out,
                                         int64_t G, int64_t C, int64_t L,
                                         void* stream) {
  return launch<float, 4>(x, w, out, G, C, L, static_cast<cudaStream_t>(stream));
}

extern "C" int tree_aggregate_groups_bf16(const void* x, const float* w, float* out,
                                          int64_t G, int64_t C, int64_t L,
                                          void* stream) {
  return launch<__nv_bfloat16, 8>(x, w, out, G, C, L, static_cast<cudaStream_t>(stream));
}

extern "C" int tree_aggregate_groups_i8(const void* x, const float* w, float* out,
                                        int64_t G, int64_t C, int64_t L,
                                        void* stream) {
  return launch<int8_t, 8>(x, w, out, G, C, L, static_cast<cudaStream_t>(stream));
}

// The children whose loads one thread keeps in flight together.
extern "C" int tree_aggregate_child_tile(void) { return kChildTile; }
