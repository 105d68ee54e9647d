// Algorithm-1 episode policy update (lines 5-8): lanes over candidates,
// and line 5 once per mask row.
//
//   candn[m, :] = cand[m, :] * mask / max(sum_k cand[m, k] * mask_k, 1e-12)
//   rho         = candn[argmin_m sum_{k: mask_k} log max(candn[m, k], 1e-12)]   (line 5)
//   grad        = rsum / (tau * max(pi, 1e-12)) * mask                          (line 6)
//   pi~         = candn[argmax_m sum_k candn[m, k] * grad_k]                    (line 7)
//   pi'         = (alpha (pi + beta (pi~ - pi)) + (1 - alpha) rho) * mask,
//                 divided by max(sum_k pi'_k, 1e-12)                            (line 8)
//
// pi (N, K) f32, mask (N, K) bool, cand (M, K) f32, rsum (N, K) f32 ->
// out (N, K) f32, for K <= 64.  Replaces the Pallas TPU kernel
// repro/kernels/policy_update.py::policy_update (body _kernel), which took
// 256-node VMEM blocks with the (NB, M, K) candidate tensor resident and
// needed N padded to that block.  Here any N is taken as it is.
//
// Determinism: every sum over K (row sums, log-determinants, scores, the
// final normalisation) is taken in f64 in one fixed order and rounded to
// f32: ref.py::warp_sum's, where lane l of a warp holds 0 + x[l] +
// x[l + 32] and a butterfly over offsets 16, 8, 4, 2, 1 adds them.  Line 8
// runs that butterfly with __shfl_xor_sync; lines 5 and 7 replay it
// serially in one thread (tree_sum: the same f64 additions on the same
// operands, so the same sums).  Candidates that are permutations of one
// another (candidate_policy_set's corners) then tie exactly, and rho and
// pi~ take the first index of the least log-determinant and of the
// largest score.  Every f32 step is one correctly rounded intrinsic (no
// contraction), the log is logf (not __logf), and the file is built
// without --use_fast_math, so the kernel gives the plain version's bits.
//
// What bounds it on an H100: per node it reads 13 bytes per hop (pi, mask,
// rsum) and writes 4, plus the candidate set once: N*K*13 + 4*M*K bytes,
// 62 us at N = 1e6, K = 16.  A warp per node with lanes over hops spends
// about 100x that: per candidate three f64 butterflies, five dependent
// shuffle-add steps each, and a log per hop, all of it repeated for every
// node although line 5's work depends only on (cand, mask row).
//
// What the design does about it:
// - lanes over candidates: lane l of a node's warp owns candidates l,
//   l + 32, ...; the node's line-6 gradient is staged in shared memory (in
//   f64, converted once) and each lane sums its candidates' rows serially
//   in registers (tree_sum), so no shuffle chain waits per candidate.
//   rho's argmin and pi~'s argmax are two warp reductions (redux.sync) per
//   node, first index on ties;
// - line 5 once per mask row: a block first computes the denominators,
//   candn (stored in f64; its threads over (hop, candidate) pairs) and
//   log-determinants of its first node's mask row, and rho for it, into
//   shared memory.  Each node compares its row with that one by
//   __ballot_sync (two words for K <= 64) and, on a match, reuses them:
//   line 7 is then one f64 dot product per candidate and no log or
//   division.  A node whose row differs computes its own, with the same
//   arithmetic.  The planners' masks are all ones, so every node matches;
//   nothing is tested on the host;
// - the candidate set sits in shared memory transposed (candT[k * M + m]),
//   so the lanes of a warp read consecutive words; line 8 stays lanes over
//   hops, each node's row read once, coalesced.  The grid is one resident
//   wave of blocks, each looping over its nodes (more blocks only repeat
//   the block's line 5); for K <= 16 the registers are capped so that four
//   blocks fit an SM, and below K = 17 a lane's second hop (k + 32) is
//   compiled out.  No atomics: the result is the same on every run.
//
// Plain C interface, loaded with ctypes.  The entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller sees a refused launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kNodesPerBlock = kThreads / kWarp;  // 8 nodes (warps) at a time per block
constexpr int kMaxK = 64;
constexpr unsigned kFull = 0xffffffffu;
// blocks per SM that ptxas must fit for K <= 16 (64 registers a thread):
// the node loop waits on latency, so residency pays more than registers;
// K > 16 keeps its registers (a 32-leaf tree per sum)
constexpr int kMinBlocksNarrow = 4;

// Lane l of ref.warp_sum's tree: x(l) (+ x(l + 32) when K > 32); hops past
// K are exact zeros.  ref.warp_sum starts each lane from 0 + x(l), which
// differs from x(l) only where x(l) is -0: that changes at most the sign of
// a zero sum, and no use of these sums can see it (each is compared, or
// floored at 1e-12).
template <int W, typename F>
__device__ __forceinline__ double tree_leaf(int l, int K, const F& x) {
  if (l >= K) return 0.0;
  return W == kWarp && l + kWarp < K ? __dadd_rn(x(l), x(l + kWarp)) : x(l);
}

// R(w)[l] of the butterfly: R(W)[l] is lane l's value, R(w)[l] = R(2w)[l] +
// R(2w)[l + w], and the sum is R(1)[0].  Evaluated depth first, so a few
// registers hold the partial sums.
template <int W, int w, int l>
struct Tree {
  template <typename F>
  __device__ __forceinline__ static double at(int K, const F& x) {
    if constexpr (w == W)
      return tree_leaf<W>(l, K, x);
    else
      return __dadd_rn(Tree<W, 2 * w, l>::at(K, x), Tree<W, 2 * w, l + w>::at(K, x));
  }
};

// The f64 sum of x(0..K-1) in ref.warp_sum's order, rounded to f32, with W
// the first power of two >= min(K, 32): the butterfly's f64 additions on
// the same operands, so the same value, in one thread.  A narrower tree
// than the warp's 32 lanes only drops additions of exact zeros.
template <int W, typename F>
__device__ __forceinline__ float tree_sum(int K, const F& x) {
  return (float)Tree<W, 1, 0>::at(K, x);
}

__device__ __forceinline__ float hop_mask(uint32_t lo, uint32_t hi, int k) {
  return (((k < kWarp ? lo : hi) >> (k & (kWarp - 1))) & 1u) ? 1.0f : 0.0f;
}

// candidate m re-normalised onto a mask row, one hop
__device__ __forceinline__ float candn_at(const float* candT, int M, int k, int m,
                                          float maskf, float denom) {
  return __fdiv_rn(__fmul_rn(candT[k * M + m], maskf), denom);
}

// line 5 for candidate m on mask row (lo, hi): its denominator, and its
// log-determinant from its re-normalised hops cn(k)
template <int W>
__device__ __forceinline__ float cand_denom(const float* candT, int M, int K, int m, uint32_t lo,
                                            uint32_t hi) {
  return fmaxf(tree_sum<W>(K, [&](int k) {
    return (double)__fmul_rn(candT[k * M + m], hop_mask(lo, hi, k));
  }), 1e-12f);
}

template <int W, typename F>
__device__ __forceinline__ float cand_logdet(int K, uint32_t lo, uint32_t hi, const F& cn) {
  return tree_sum<W>(K, [&](int k) {
    return hop_mask(lo, hi, k) != 0.0f ? (double)logf(fmaxf(cn(k), 1e-12f)) : 0.0;
  });
}

// f32 -> u32, monotone (and -0 mapped as +0, which compares equal to it)
__device__ __forceinline__ unsigned ordered(float v) {
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (value, index) reductions over the warp, where lane l holds the best
// value v of candidates l, l + 32, ... and its index i (the first on
// ties): i becomes the index of the least (argmin) or largest (argmax) v,
// the first on ties, by two warp reductions (redux.sync), and the payload d
// the winner's lane's.  A lane with no candidate holds index M and an
// infinite value, so it never wins.
__device__ __forceinline__ void warp_argmin(float v, int& i, float& d) {
  const unsigned key = ordered(v), best = __reduce_min_sync(kFull, key);
  i = (int)__reduce_min_sync(kFull, key == best ? (unsigned)i : 0xffffffffu);
  d = __shfl_sync(kFull, d, i & (kWarp - 1));
}

__device__ __forceinline__ void warp_argmax(float v, int& i, float& d) {
  const unsigned key = ordered(v), best = __reduce_max_sync(kFull, key);
  i = (int)__reduce_min_sync(kFull, key == best ? (unsigned)i : 0xffffffffu);
  d = __shfl_sync(kFull, d, i & (kWarp - 1));
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = __dadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

template <int W>
__global__ void __launch_bounds__(kThreads, W <= 16 ? kMinBlocksNarrow : 1)
policy_update_kernel(const float* __restrict__ pi, const uint8_t* __restrict__ mask,
                     const float* __restrict__ cand, const float* __restrict__ rsum,
                     float* __restrict__ out, int64_t N, int K, int M, float tau, float alpha,
                     float beta, float one_minus_alpha) {
  extern __shared__ double smem[];
  double* candn0 = smem;                                 // (K, M): candn on the block's first mask row
  double* grad_s = candn0 + K * M;                       // (kNodesPerBlock, kMaxK): line-6 gradients
  float* candT = (float*)(grad_s + kNodesPerBlock * kMaxK);  // (K, M): the candidate set, transposed
  float* ld0 = candT + K * M;                            // (M,): the first row's log-determinants
  __shared__ uint32_t row0[2];
  __shared__ int rho0;

  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int k0 = lane, k1 = lane + kWarp;
  const bool h0 = k0 < K, h1 = W == kWarp && k1 < K;  // a second hop per lane only past K = 32
  const int64_t first = (int64_t)blockIdx.x * kNodesPerBlock;  // < N
  const int64_t warps = (int64_t)gridDim.x * kNodesPerBlock;

  if (warp == 0) {
    const uint32_t lo = __ballot_sync(kFull, h0 && mask[first * K + k0]);
    const uint32_t hi = __ballot_sync(kFull, h1 && mask[first * K + k1]);
    if (lane == 0) {
      row0[0] = lo;
      row0[1] = hi;
    }
  }
  for (int i = threadIdx.x; i < M * K; i += kThreads) candT[(i % K) * M + i / K] = cand[i];
  __syncthreads();
  const uint32_t lo0 = row0[0], hi0 = row0[1];
  // line 5 on the first mask row: the denominators (threads over
  // candidates, held in ld0 for now), candn (threads over (hop, candidate)
  // pairs), then the log-determinants (threads over candidates)
  for (int m = threadIdx.x; m < M; m += kThreads) ld0[m] = cand_denom<W>(candT, M, K, m, lo0, hi0);
  __syncthreads();
  for (int i = threadIdx.x; i < M * K; i += kThreads) {
    const int k = i / M, m = i - k * M;
    candn0[i] = (double)candn_at(candT, M, k, m, hop_mask(lo0, hi0, k), ld0[m]);
  }
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += kThreads)
    ld0[m] = cand_logdet<W>(K, lo0, hi0, [&](int k) { return (float)candn0[k * M + m]; });
  __syncthreads();
  if (warp == 0) {
    float best = INFINITY, unused = 0.0f;
    int idx = M;
    for (int m = lane; m < M; m += kWarp) {
      if (ld0[m] < best || idx == M) {
        best = ld0[m];
        idx = m;
      }
    }
    warp_argmin(best, idx, unused);
    if (lane == 0) rho0 = idx;
  }
  __syncthreads();
  const int rho_shared = rho0;

  double* g_s = grad_s + warp * kMaxK;
  for (int64_t n = first + warp; n < N; n += warps) {
    const int64_t row = n * K;
    const float p0 = h0 ? pi[row + k0] : 0.0f, p1 = h1 ? pi[row + k1] : 0.0f;
    const bool b0 = h0 && mask[row + k0], b1 = h1 && mask[row + k1];
    const float m0 = b0 ? 1.0f : 0.0f, m1 = b1 ? 1.0f : 0.0f;
    const float r0 = h0 ? rsum[row + k0] : 0.0f, r1 = h1 ? rsum[row + k1] : 0.0f;
    // line 6
    const float g0 = __fmul_rn(__fdiv_rn(r0, __fmul_rn(tau, fmaxf(p0, 1e-12f))), m0);
    const float g1 = h1 ? __fmul_rn(__fdiv_rn(r1, __fmul_rn(tau, fmaxf(p1, 1e-12f))), m1) : 0.0f;
    if (h0) g_s[k0] = (double)g0;
    if (h1) g_s[k1] = (double)g1;
    const uint32_t lo = __ballot_sync(kFull, b0), hi = __ballot_sync(kFull, b1);
    __syncwarp();
    const bool reuse = lo == lo0 && hi == hi0;  // the same for every lane

    // lines 5 and 7, lanes over candidates
    float best_ld = INFINITY, best_sc = -INFINITY, d_ld = 1.0f, d_sc = 1.0f;
    int rho_m = M, tilde_m = M;
    if (reuse) {
      for (int m = lane; m < M; m += kWarp) {
        const float sc = tree_sum<W>(K, [&](int k) { return __dmul_rn(candn0[k * M + m], g_s[k]); });
        if (sc > best_sc || tilde_m == M) {
          best_sc = sc;
          tilde_m = m;
        }
      }
      warp_argmax(best_sc, tilde_m, d_sc);
      rho_m = rho_shared;
    } else {
      for (int m = lane; m < M; m += kWarp) {
        const float d = cand_denom<W>(candT, M, K, m, lo, hi);
        const float ld = cand_logdet<W>(K, lo, hi, [&](int k) {
          return candn_at(candT, M, k, m, hop_mask(lo, hi, k), d);
        });
        const float sc = tree_sum<W>(K, [&](int k) {
          return __dmul_rn((double)candn_at(candT, M, k, m, hop_mask(lo, hi, k), d), g_s[k]);
        });
        if (ld < best_ld || rho_m == M) {
          best_ld = ld;
          rho_m = m;
          d_ld = d;
        }
        if (sc > best_sc || tilde_m == M) {
          best_sc = sc;
          tilde_m = m;
          d_sc = d;
        }
      }
      warp_argmin(best_ld, rho_m, d_ld);
      warp_argmax(best_sc, tilde_m, d_sc);
    }
    float rho0v, rho1v, t0, t1;  // rho and pi~ at this lane's hops
    if (reuse) {
      rho0v = h0 ? (float)candn0[k0 * M + rho_m] : 0.0f;  // exact: an f32 value
      rho1v = h1 ? (float)candn0[k1 * M + rho_m] : 0.0f;
      t0 = h0 ? (float)candn0[k0 * M + tilde_m] : 0.0f;
      t1 = h1 ? (float)candn0[k1 * M + tilde_m] : 0.0f;
    } else {
      rho0v = h0 ? candn_at(candT, M, k0, rho_m, m0, d_ld) : 0.0f;
      rho1v = h1 ? candn_at(candT, M, k1, rho_m, m1, d_ld) : 0.0f;
      t0 = h0 ? candn_at(candT, M, k0, tilde_m, m0, d_sc) : 0.0f;
      t1 = h1 ? candn_at(candT, M, k1, tilde_m, m1, d_sc) : 0.0f;
    }

    // line 8, lanes over hops, each step rounded once, in the plain version's order
    float y0 = __fmul_rn(__fadd_rn(p0, __fmul_rn(__fsub_rn(t0, p0), beta)), alpha);
    y0 = __fmul_rn(__fadd_rn(y0, __fmul_rn(rho0v, one_minus_alpha)), m0);
    float y1 = 0.0f;
    if (h1) {
      y1 = __fmul_rn(__fadd_rn(p1, __fmul_rn(__fsub_rn(t1, p1), beta)), alpha);
      y1 = __fmul_rn(__fadd_rn(y1, __fmul_rn(rho1v, one_minus_alpha)), m1);
    }
    const float s = fmaxf((float)warp_sum(__dadd_rn(__dadd_rn(0.0, y0), y1)), 1e-12f);
    if (h0) out[row + k0] = __fdiv_rn(y0, s);
    if (h1) out[row + k1] = __fdiv_rn(y1, s);
    __syncwarp();  // every lane has read g_s before the next node writes it
  }
}

template <int W>
int launch(const float* pi, const uint8_t* mask, const float* cand, const float* rsum,
           float* out, int64_t N, int K, int M, float tau, float alpha, float beta,
           float one_minus_alpha, cudaStream_t stream) {
  const size_t smem = sizeof(double) * ((size_t)M * K + (size_t)kNodesPerBlock * kMaxK) +
                      sizeof(float) * ((size_t)M * K + M);
  auto kernel = policy_update_kernel<W>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // one resident wave of blocks, each looping over its nodes
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  int64_t blocks = (N + kNodesPerBlock - 1) / kNodesPerBlock;
  const int64_t wave = (int64_t)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (blocks > wave) blocks = wave;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(pi, mask, cand, rsum, out, N, K, M, tau,
                                                       alpha, beta, one_minus_alpha);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int policy_update_f32(const float* pi, const uint8_t* mask, const float* cand,
                                 const float* rsum, float* out, int64_t N, int K, int M,
                                 float tau, float alpha, float beta, float one_minus_alpha,
                                 void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  if (K < 1 || K > kMaxK || M < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = K > 16 ? 32 : K > 8 ? 16 : K > 4 ? 8 : K > 2 ? 4 : K > 1 ? 2 : 1;
  switch (w) {
    case 1: return launch<1>(pi, mask, cand, rsum, out, N, K, M, tau, alpha, beta, one_minus_alpha, s);
    case 2: return launch<2>(pi, mask, cand, rsum, out, N, K, M, tau, alpha, beta, one_minus_alpha, s);
    case 4: return launch<4>(pi, mask, cand, rsum, out, N, K, M, tau, alpha, beta, one_minus_alpha, s);
    case 8: return launch<8>(pi, mask, cand, rsum, out, N, K, M, tau, alpha, beta, one_minus_alpha, s);
    case 16: return launch<16>(pi, mask, cand, rsum, out, N, K, M, tau, alpha, beta, one_minus_alpha, s);
    default: return launch<32>(pi, mask, cand, rsum, out, N, K, M, tau, alpha, beta, one_minus_alpha, s);
  }
}
