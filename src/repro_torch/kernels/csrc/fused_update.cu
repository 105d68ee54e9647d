// Fused FedProx client update: SGD step + proximal term + weight decay,
// over every leaf of one local step in one launch.
//
//   out[i] = w[i] - lr * (g[i] + mu * (w[i] - w0[i]) + wd * w[i])
//
// computed in f32 and stored in the type of w (f32 or bf16, rounded to
// nearest even).  Replaces the Pallas TPU kernel repro/kernels/
// fused_update.py::fused_update (body _kernel), which updated one flat
// vector cut into 2048-element VMEM tiles and needed L padded to that
// tile.  Here one launch takes a table of up to kMaxLeaves leaves of one
// type, each of any length; the single-tensor update is the one-leaf case.
// out may be w itself (the in-place update).
//
// Bit parity: XLA compiles the reference into t = w - w0 followed by
// three fused multiply-adds, a = fma(mu, t, g), b = fma(wd, w, a),
// out = fma(-lr, b, w).  The kernel writes exactly that with __fsub_rn
// and __fmaf_rn, lr, mu and wd as f32 from the host, and is built
// without --use_fast_math.  At mu = wd = 0 (the f32 values) the wrapper
// picks the kProx = false instantiation, out = fma(-lr, g, w), which never
// reads w0: the same values as the chain wherever w - w0 is finite (a
// signed zero aside), since fma(0, t, g) = g and fma(0, w, g) = g there.
// ref.fused_update_ref takes the same shortcut, so kernel and plain
// version agree on every input (ROADMAP parity rule 8).
//
// What bounds it on an H100: memory.  A leaf of L elements moves
// L * (3 * s_in + s_out) bytes (16 per element in f32, 8 in bf16), or
// L * (2 * s_in + s_out) at mu = wd = 0 (12 in f32), for at most 7 flops
// per element, far under the card's flop rate at 3.35 TB/s.  The main
// path's leaves are small (128 to 73,728 elements), so a launch per leaf
// waited on one memory round trip with a few blocks in flight, and the
// host paid a call per leaf.
//
// What the design does about it: one launch per local step and type.  The
// launcher packs the leaves' pointers and lengths into a by-value kernel
// parameter (__grid_constant__, under the 4 KB classic parameter limit)
// with the prefix sums of each leaf's block count; a block finds its leaf
// by binary search in that prefix, so there is no device allocation and
// no host-to-device copy per step.  A block covers kTile elements: each
// thread makes kUnroll 16-byte loads of every operand (4 f32 or 8 bf16
// each) before it computes, neighbouring threads on neighbouring
// addresses; many small blocks keep the bytes in flight on every SM.  A
// leaf whose four pointers are 16-byte aligned takes that path, its ragged
// tail a masked scalar one; a misaligned leaf takes the masked scalar path
// throughout, still kUnroll * 16 bytes per thread.
// Each byte crosses the bus once; no shared memory, no atomics.  w and
// out carry no __restrict__: each element is read before it is written,
// by the same thread.
//
// Plain C interface, loaded with ctypes.  Each entry point launches once
// on the given stream, does not synchronise, allocates nothing, and
// returns cudaGetLastError() so the caller sees a refused launch; a table
// larger than kMaxLeaves, or one with no element, is refused
// (cudaErrorInvalidValue) without a launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// 16-byte loads of each operand per thread: on the H100, 1 streams faster
// than 2 or 4, at 2^24 elements and on the paths' leaf tables alike
constexpr int kUnroll = 1;
constexpr int kMaxLeaves = 64;

struct Table {
  const void* w[kMaxLeaves];
  const void* g[kMaxLeaves];
  const void* w0[kMaxLeaves];
  void* out[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int32_t first_block[kMaxLeaves + 1];  // prefix sums of the leaves' block counts
  int32_t leaves;
  uint32_t aligned;     // bit j: leaf j (< 32) takes the 16-byte path
  uint32_t aligned_hi;  // bit j: leaf 32 + j takes it
  float lr, mu, wd;
};
static_assert(sizeof(Table) <= 4096, "kernel parameters past the classic 4 KB limit");

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

template <typename T>
constexpr int kVec = 16 / (int)sizeof(typename T::S);  // elements per 16-byte load

template <typename T>
constexpr int64_t kTile = (int64_t)kThreads * kUnroll * kVec<T>;  // elements per block

template <bool kProx>
__device__ __forceinline__ float update(float w, float g, float w0, float lr, float mu,
                                        float wd) {
  if (!kProx) return __fmaf_rn(-lr, g, w);
  const float a = __fmaf_rn(mu, __fsub_rn(w, w0), g);
  const float b = __fmaf_rn(wd, w, a);
  return __fmaf_rn(-lr, b, w);
}

template <typename T, bool kProx>
__global__ void __launch_bounds__(kThreads) fused_update_kernel(const __grid_constant__ Table p) {
  using S = typename T::S;
  constexpr int V = kVec<T>;
  union Vec {
    uint4 u;
    S s[V];
  };
  // the leaf of this block: the last j with first_block[j] <= blockIdx.x
  const int32_t b = (int32_t)blockIdx.x;
  int lo = 0, hi = p.leaves;  // first_block[lo] <= b < first_block[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (p.first_block[mid] <= b) lo = mid; else hi = mid;
  }
  const S* w = static_cast<const S*>(p.w[lo]);
  const S* __restrict__ g = static_cast<const S*>(p.g[lo]);
  const S* __restrict__ w0 = static_cast<const S*>(p.w0[lo]);
  S* out = static_cast<S*>(p.out[lo]);
  const int64_t n = p.n[lo];
  const int64_t base = (int64_t)(b - p.first_block[lo]) * kTile<T>;
  const uint32_t bits = lo < 32 ? p.aligned : p.aligned_hi;
  const bool aligned = (bits >> (lo & 31)) & 1u;
  const float lr = p.lr, mu = p.mu, wd = p.wd;

  if (aligned) {
    const int64_t nvec = n / V;
    const int64_t v0 = base / V + threadIdx.x;
    Vec vw[kUnroll], vg[kUnroll], vz[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = v0 + (int64_t)u * kThreads;
      if (i < nvec) {
        vw[u].u = reinterpret_cast<const uint4*>(w)[i];
        vg[u].u = reinterpret_cast<const uint4*>(g)[i];
        if (kProx) vz[u].u = reinterpret_cast<const uint4*>(w0)[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = v0 + (int64_t)u * kThreads;
      if (i < nvec) {
        Vec vo;
#pragma unroll
        for (int j = 0; j < V; ++j)
          vo.s[j] = T::store(update<kProx>(T::load(vw[u].s[j]), T::load(vg[u].s[j]),
                                           kProx ? T::load(vz[u].s[j]) : 0.0f, lr, mu, wd));
        reinterpret_cast<uint4*>(out)[i] = vo.u;
      }
    }
    // the ragged tail (fewer than V elements) lies in the leaf's last block
    const int64_t t = nvec * V + threadIdx.x;
    if (t < n && t >= base && t < base + kTile<T>)
      out[t] = T::store(update<kProx>(T::load(w[t]), T::load(g[t]),
                                      kProx ? T::load(w0[t]) : 0.0f, lr, mu, wd));
    return;
  }
  constexpr int E = kUnroll * V;  // elements per thread, strided by the block
  float rw[E], rg[E], rz[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int64_t i = base + threadIdx.x + (int64_t)e * kThreads;
    if (i < n) {
      rw[e] = T::load(w[i]);
      rg[e] = T::load(g[i]);
      rz[e] = kProx ? T::load(w0[i]) : 0.0f;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int64_t i = base + threadIdx.x + (int64_t)e * kThreads;
    if (i < n) out[i] = T::store(update<kProx>(rw[e], rg[e], rz[e], lr, mu, wd));
  }
}

template <typename T>
int launch(int leaves, const void* const* w, const void* const* g, const void* const* w0,
           void* const* out, const int64_t* n, float lr, float mu, float wd, int prox,
           void* stream) {
  if (leaves < 1 || leaves > kMaxLeaves) return (int)cudaErrorInvalidValue;
  Table p;
  p.leaves = leaves;
  p.aligned = p.aligned_hi = 0u;
  p.lr = lr;
  p.mu = mu;
  p.wd = wd;
  int64_t blocks = 0;
  for (int j = 0; j < leaves; ++j) {
    if (n[j] < 0) return (int)cudaErrorInvalidValue;
    p.w[j] = w[j];
    p.g[j] = g[j];
    p.w0[j] = w0[j];
    p.out[j] = out[j];
    p.n[j] = n[j];
    p.first_block[j] = (int32_t)blocks;
    const uintptr_t bits = (uintptr_t)w[j] | (uintptr_t)g[j] | (uintptr_t)out[j] |
                           (prox ? (uintptr_t)w0[j] : (uintptr_t)0);
    if (bits % 16 == 0) (j < 32 ? p.aligned : p.aligned_hi) |= 1u << (j & 31);
    blocks += (n[j] + kTile<T> - 1) / kTile<T>;
    if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  }
  p.first_block[leaves] = (int32_t)blocks;
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prox)
    fused_update_kernel<T, true><<<(unsigned)blocks, kThreads, 0, s>>>(p);
  else
    fused_update_kernel<T, false><<<(unsigned)blocks, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_update_max_leaves() { return kMaxLeaves; }

// prox = 0 only when the f32 values of mu and wd are both 0: w0 is then
// never read (its pointers may be anything).
extern "C" int fused_update_f32(int leaves, const void* const* w, const void* const* g,
                                const void* const* w0, void* const* out, const int64_t* n,
                                float lr, float mu, float wd, int prox, void* stream) {
  return launch<F32>(leaves, w, g, w0, out, n, lr, mu, wd, prox, stream);
}

extern "C" int fused_update_bf16(int leaves, const void* const* w, const void* const* g,
                                 const void* const* w0, void* const* out, const int64_t* n,
                                 float lr, float mu, float wd, int prox, void* stream) {
  return launch<BF16>(leaves, w, g, w0, out, n, lr, mu, wd, prox, stream);
}
