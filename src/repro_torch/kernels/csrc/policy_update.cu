// Algorithm-1 episode policy update (lines 5-8), one warp per node.
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
// final normalisation) is taken in f64 in one fixed order -- lane l holds
// 0 + x[l] + x[l + 32], then a __shfl_xor_sync butterfly over offsets 16,
// 8, 4, 2, 1 -- and rounded to f32; ref.py::warp_sum repeats that order.
// Candidates that are permutations of one another (candidate_policy_set's
// corners) then tie exactly, and the scans over m keep the first index of
// the least log-determinant and of the largest score.  Every f32 step is
// one correctly rounded intrinsic (no contraction), the log is logf (not
// __logf), and the file is built without --use_fast_math, so the kernel
// gives the plain version's bits.
//
// What bounds it on an H100: per node it reads 13 bytes per hop (pi, mask,
// rsum) and writes 4, plus the candidate set once: N*K*13 + 4*M*K bytes.
// The work is N*M*K logs and about 3*N*M*K multiply-adds, which at the f32
// rate stays under the byte time; the f64 butterflies (3 per candidate per
// node, two shuffles and one f64 add per step) are what this first kernel
// actually spends its time on at large N.
//
// What the design does about it: one warp per node, lanes striding over K
// (so K = 36, multicast's 8-hop subset actions, takes two elements per
// lane), each node's row read once into registers, coalesced; the
// candidate set is loaded once per block into shared memory; a candidate's
// normalised row stays in registers for its log-determinant and score, and
// rho and pi~ are re-derived from their index at the end.  No atomics: the
// result is the same on every run.
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
constexpr int kNodesPerBlock = kThreads / kWarp;  // 8 nodes (warps) per block
constexpr int64_t kMaxBlocks = 132 * 16;          // grid-stride past 16 blocks per SM

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// 0 + a + b in f64, then the butterfly, rounded to f32
__device__ __forceinline__ float lane_sum(double a, double b) {
  return (float)warp_sum(__dadd_rn(__dadd_rn(0.0, a), b));
}

__global__ void __launch_bounds__(kThreads)
policy_update_kernel(const float* __restrict__ pi, const uint8_t* __restrict__ mask,
                     const float* __restrict__ cand, const float* __restrict__ rsum,
                     float* __restrict__ out, int64_t N, int K, int M, float tau, float alpha,
                     float beta, float one_minus_alpha) {
  extern __shared__ float cand_s[];  // (M, K)
  for (int i = threadIdx.x; i < M * K; i += kThreads) cand_s[i] = cand[i];
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const int k0 = lane, k1 = lane + kWarp;
  const bool h0 = k0 < K, h1 = k1 < K;
  const int64_t warps = (int64_t)gridDim.x * kNodesPerBlock;
  for (int64_t n = (int64_t)blockIdx.x * kNodesPerBlock + threadIdx.x / kWarp; n < N;
       n += warps) {
    const int64_t row = n * K;
    const float p0 = h0 ? pi[row + k0] : 0.0f, p1 = h1 ? pi[row + k1] : 0.0f;
    const bool b0 = h0 && mask[row + k0], b1 = h1 && mask[row + k1];
    const float m0 = b0 ? 1.0f : 0.0f, m1 = b1 ? 1.0f : 0.0f;
    const float r0 = h0 ? rsum[row + k0] : 0.0f, r1 = h1 ? rsum[row + k1] : 0.0f;
    // line 6
    const float g0 = __fmul_rn(__fdiv_rn(r0, __fmul_rn(tau, fmaxf(p0, 1e-12f))), m0);
    const float g1 = __fmul_rn(__fdiv_rn(r1, __fmul_rn(tau, fmaxf(p1, 1e-12f))), m1);

    // candidate m re-normalised onto the node's valid hops
    auto candn = [&](int m, float& c0, float& c1) {
      c0 = h0 ? __fmul_rn(cand_s[m * K + k0], m0) : 0.0f;
      c1 = h1 ? __fmul_rn(cand_s[m * K + k1], m1) : 0.0f;
      const float denom = fmaxf(lane_sum(c0, c1), 1e-12f);
      c0 = __fdiv_rn(c0, denom);
      c1 = __fdiv_rn(c1, denom);
    };

    // lines 5 and 7: one scan over the candidates, first index on ties
    float best_ld = INFINITY, best_sc = -INFINITY;
    int rho_m = 0, tilde_m = 0;
    for (int m = 0; m < M; ++m) {
      float c0, c1;
      candn(m, c0, c1);
      const double l0 = b0 ? (double)logf(fmaxf(c0, 1e-12f)) : 0.0;
      const double l1 = b1 ? (double)logf(fmaxf(c1, 1e-12f)) : 0.0;
      const float ld = lane_sum(l0, l1);
      const float sc = lane_sum(__dmul_rn(c0, g0), __dmul_rn(c1, g1));
      if (ld < best_ld) {
        best_ld = ld;
        rho_m = m;
      }
      if (sc > best_sc) {
        best_sc = sc;
        tilde_m = m;
      }
    }
    float rho0, rho1, t0, t1;
    candn(rho_m, rho0, rho1);
    candn(tilde_m, t0, t1);

    // line 8, each step rounded once, in the plain version's order
    float y0 = __fmul_rn(__fadd_rn(p0, __fmul_rn(__fsub_rn(t0, p0), beta)), alpha);
    float y1 = __fmul_rn(__fadd_rn(p1, __fmul_rn(__fsub_rn(t1, p1), beta)), alpha);
    y0 = __fmul_rn(__fadd_rn(y0, __fmul_rn(rho0, one_minus_alpha)), m0);
    y1 = __fmul_rn(__fadd_rn(y1, __fmul_rn(rho1, one_minus_alpha)), m1);
    const float s = fmaxf(lane_sum(y0, y1), 1e-12f);
    if (h0) out[row + k0] = __fdiv_rn(y0, s);
    if (h1) out[row + k1] = __fdiv_rn(y1, s);
  }
}

}  // namespace

extern "C" int policy_update_f32(const float* pi, const uint8_t* mask, const float* cand,
                                 const float* rsum, float* out, int64_t N, int K, int M,
                                 float tau, float alpha, float beta, float one_minus_alpha,
                                 void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  int64_t blocks = (N + kNodesPerBlock - 1) / kNodesPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const size_t smem = sizeof(float) * (size_t)M * (size_t)K;
  policy_update_kernel<<<(unsigned)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pi, mask, cand, rsum, out, N, K, M, tau, alpha, beta, one_minus_alpha);
  return (int)cudaGetLastError();
}
