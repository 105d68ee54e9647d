#!/usr/bin/env python3
"""Build variants of the port's CUDA kernels and time each on one card.

    python3 tools/sweep_port_kernels.py [tree_aggregate] [quantize] [dequantize] [broadcast]
                                        [fused_update] [policy_update] [--sass-against DIR]

(no kernel named: all six).  ``--sass-against DIR`` also builds DIR's
``src/repro_torch/kernels/csrc/quantize.cu`` (an unpacked earlier tree) and
says whether each of its quantize kernels compiles to the same SASS
(``cuobjdump -sass``, addresses and names stripped) as the committed
file's instance without the EF residual.

- ``tree_aggregate_groups`` (``csrc/tree_aggregate.cu``) at (design, child
  tile, most and fewest threads per block, blocks a level should span) in
  VARIANTS_AGG.  Design "a" is the committed one (a tile's loads into
  registers, then its fmaf chain); "b" stages each tile through a shared
  memory slab with ``cp.async`` (DESIGN_B), vector paths only; "c" issues
  the next tile's loads before a tile's chain (DESIGN_C); "d" runs a tile
  of n < CT children as straight-line code for exactly n, chosen by a
  uniform branch, with no predicated loads (DESIGN_D); "e" is "a" with a
  running child pointer that the compiler may not fold back into (c0 +
  j) * L products (DESIGN_E); "f" is "d" with that pointer (DESIGN_F).
  A child tile of 1 with 256 threads always and 16-byte int8 loads is the
  former one-child-at-a-time kernel's schedule.  Each variant is held bit-equal to
  ``ref.tree_aggregate_groups_chain`` at every main-path level and at C
  around its tile, then timed at every main-path f32 level (the sync
  quickstart's and CNN's, the async apply's (1, 4, 6792)), in turns with
  ``torch.einsum`` (a b b a), at the bench's (1, 16, 131072) and (1, 16,
  2^22) f32, and at the compressed apply's int8 (27, 4, 256) and the
  bench's (4096, 4, 256) (groups per block reported; int8 rows also at 16-
  and 4-byte loads, I8_SPEC);
- ``qsgd_quantize`` (``csrc/quantize.cu``) at (threads per row, rows per
  block) in VARIANTS_QUANT, both instances (without and with the EF
  residual) bit-equal at R in (1, 27, 4096, 70001) x levels (127, 3) and
  timed at R in ROWS: the path's 27, the bench's 4096 and 65,536 rows,
  whose bytes do not fit the 50 MB L2;
- ``qsgd_dequantize`` (``csrc/quantize.cu``) at (int8 bytes a lane loads
  at once, lanes per row, rows per block) in VARIANTS_ROWS (a lane of a
  256-wide row owns 256 / (bytes x lanes) vectors, ``lanes`` apart; 8
  bytes at 32 lanes is one 8-byte load and two float4 stores 32 bytes
  apart), and the former design (one thread an
  element with a grid-stride loop and a 64-bit division, FORMER_DQ),
  bit-equal at R in (1, 27, 4096) on 256-wide rows, a width that is not
  whole vectors and a misaligned view, timed at R in ROWS beside
  ``torch.mul``;
- ``apply_quantized_broadcast`` (``csrc/broadcast.cu``) at the same
  (bytes, lanes, rows per block) and its former design (FORMER_APPLY),
  bit-equal at D = 1..5 and on a misaligned view, timed at D = 1 and R in
  ROWS beside ``torch.addcmul``, and at D = 3, R = 4096;
- ``fused_update`` (``csrc/fused_update.cu``) at (threads per block,
  16-byte loads per thread and operand, leaves a launch's parameter table
  holds) in VARIANTS_FUSED: at 2^24 f32
  with mu = wd = 0, timed in turns (a b b a) with ``torch.add(w, g,
  alpha=-lr)``; at 2^24 with mu = 0.01; on one local step of the README
  quickstart's MLP (6 leaves, mu = 0.01) and of the CNN app (3 leaves,
  mu = 0), the latter in turns with ``torch._foreach_add``;
- ``policy_update`` (``csrc/policy_update.cu``) at (blocks per SM that
  ptxas must fit for K <= 16, 1 meaning no register cap; grid cap in
  resident waves, 0 meaning one block per 8 nodes) in VARIANTS_POLICY, at
  the planners' shapes on all-ones and partial masks.

Each variant is the committed source with its constants changed, built
by nvcc with the port's flags into ``build/sweep/`` (all of a kernel's
variants at once), checked bit-equal to the plain version, and called
through the port's own wrapper.  One JSON line per variant; the card's
name and power limit first.  Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

VARIANTS_FUSED = [(256, 1, 64), (256, 1, 8), (128, 1, 64), (512, 1, 64), (128, 2, 64), (256, 2, 64),
                  (128, 4, 64)]
VARIANTS_POLICY = [(4, 1), (1, 1), (4, 2), (4, 0)]
# (design, child tile, max threads, min threads, target blocks, int8 bytes per load);
# the first is the committed one
VARIANTS_AGG = [("a", 4, 256, 64, 132, 8), ("a", 4, 256, 64, 132, 16), ("a", 4, 256, 64, 132, 4),
                ("a", 4, 256, 32, 132, 8), ("a", 4, 256, 256, 1, 8), ("a", 2, 256, 64, 132, 8),
                ("a", 6, 256, 64, 132, 8), ("a", 8, 256, 64, 132, 8), ("a", 1, 256, 256, 1, 16),
                ("b", 4, 256, 64, 132, 8), ("b", 8, 256, 64, 132, 8), ("c", 4, 256, 64, 132, 8),
                ("d", 4, 256, 64, 132, 8), ("d", 12, 256, 64, 132, 8), ("e", 4, 256, 64, 132, 8),
                ("e", 12, 256, 64, 132, 8), ("f", 4, 256, 64, 132, 8), ("f", 12, 256, 64, 132, 8)]
# (threads per row, rows per block); the first is the committed one
VARIANTS_QUANT = [(64, 2), (64, 1), (64, 4), (32, 2), (32, 4)]
# (int8 bytes a lane loads at once, lanes per row, rows per block) of the
# dequantize and the chain apply; the first is the committed one; "former"
# is the per-element design
VARIANTS_ROWS = [(4, 64, 2), (4, 64, 1), (4, 64, 4), (4, 64, 8), (4, 32, 2), (4, 32, 4),
                 (8, 32, 2), (8, 32, 4), (8, 16, 4), (16, 16, 4), (16, 16, 8), "former"]
ROWS = (27, 4096, 65536)
AGG_LEVELS = [(3, 3, 6792), (7, 1, 6792), (9, 3, 6792), (1, 12, 6792), (6, 1, 6792), (5, 1, 8848),
              (7, 2, 8848), (8, 3, 8848), (1, 11, 8848), (1, 4, 6792)]
MLP_STEP = [1024, 1024, 128, 32768, 65536, 8192]
CNN_STEP = [2304, 73728, 65536]
DESIGN_B = """// One tile of up to CT children staged through shared memory (design b):
// cp.async copies each of the thread's vectors into its own slot of
// a (CT, threads) slab, one wait, then the fmaf chain reads them back.
template <typename T, int V, int CT>
__device__ __forceinline__ void tile_sum(float (&acc)[V], const T* __restrict__ xp,
                                         const float* __restrict__ wp, int64_t L, int64_t n) {
  using VT = Vec<T, V>;
  float wc[CT];
  if constexpr (V == 1) {
    typename VT::Raw raw[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j)
      if (j < n) { raw[j] = VT::load(xp + j * L); wc[j] = __ldg(wp + j); }
#pragma unroll
    for (int j = 0; j < CT; ++j)
      if (j < n) {
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = fmaf(wc[j], VT::get(raw[j], k), acc[k]);
      }
  } else {
    __shared__ typename VT::Raw slab[CT][kMaxThreads];
#pragma unroll
    for (int j = 0; j < CT; ++j)
      if (j < n) {
        const unsigned dst = (unsigned)__cvta_generic_to_shared(&slab[j][threadIdx.x]);
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\\n"
                     :: "r"(dst), "l"(xp + j * L), "n"(sizeof(typename VT::Raw)));
        wc[j] = __ldg(wp + j);
      }
    asm volatile("cp.async.commit_group;\\n" ::);
    asm volatile("cp.async.wait_group 0;\\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < CT; ++j)
      if (j < n) {
        const typename VT::Raw r = slab[j][threadIdx.x];
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = fmaf(wc[j], VT::get(r, k), acc[k]);
      }
  }
}

"""

DESIGN_D = """// One tile of up to CT children without predicates (design d): a uniform
// branch on the tile's child count picks straight-line code for exactly n.
template <typename T, int V, int N>
__device__ __forceinline__ void tile_exact(float (&acc)[V], const T* __restrict__ xp,
                                           const float* __restrict__ wp, int64_t L) {
  using VT = Vec<T, V>;
  typename VT::Raw raw[N];
  float wc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    raw[j] = VT::load(xp + j * L);
    wc[j] = __ldg(wp + j);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = fmaf(wc[j], VT::get(raw[j], k), acc[k]);
  }
}

template <typename T, int V, int CT>
__device__ __forceinline__ void tile_sum(float (&acc)[V], const T* __restrict__ xp,
                                         const float* __restrict__ wp, int64_t L, int64_t n) {
  if constexpr (CT > 1) {
    if (n < CT) {
      tile_sum<T, V, CT - 1>(acc, xp, wp, L, n);
      return;
    }
  }
  tile_exact<T, V, CT>(acc, xp, wp, L);
}

"""
DESIGN_E = """// One tile of up to CT children, addressed by a running pointer (design
// e): one 64-bit add a child, kept opaque to the compiler so that it does
// not rebuild each address as a (c0 + j) * L product; read-only loads.
template <typename P>
__device__ __forceinline__ P opaque(P p) {
  uintptr_t u = reinterpret_cast<uintptr_t>(p);
  asm("" : "+l"(u));
  return reinterpret_cast<P>(u);
}

template <typename T, int V, int CT>
__device__ __forceinline__ void tile_sum(float (&acc)[V], const T* __restrict__ xp,
                                         const float* __restrict__ wp, int64_t L, int64_t n) {
  using VT = Vec<T, V>;
  typename VT::Raw raw[CT];
  float wc[CT];
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    if (j < n) {
      raw[j] = __ldg(reinterpret_cast<const typename VT::Raw*>(xp));
      wc[j] = __ldg(wp + j);
    }
    xp = opaque(xp + L);
  }
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    if (j < n) {
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = fmaf(wc[j], VT::get(raw[j], k), acc[k]);
    }
  }
}

"""
DESIGN_F = """// Exact-count tiles (design d) addressed by a running pointer (design e).
template <typename P>
__device__ __forceinline__ P opaque(P p) {
  uintptr_t u = reinterpret_cast<uintptr_t>(p);
  asm("" : "+l"(u));
  return reinterpret_cast<P>(u);
}

template <typename T, int V, int N>
__device__ __forceinline__ void tile_exact(float (&acc)[V], const T* __restrict__ xp,
                                           const float* __restrict__ wp, int64_t L) {
  using VT = Vec<T, V>;
  typename VT::Raw raw[N];
  float wc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    raw[j] = __ldg(reinterpret_cast<const typename VT::Raw*>(xp));
    wc[j] = __ldg(wp + j);
    xp = opaque(xp + L);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = fmaf(wc[j], VT::get(raw[j], k), acc[k]);
  }
}

template <typename T, int V, int CT>
__device__ __forceinline__ void tile_sum(float (&acc)[V], const T* __restrict__ xp,
                                         const float* __restrict__ wp, int64_t L, int64_t n) {
  if constexpr (CT > 1) {
    if (n < CT) {
      tile_sum<T, V, CT - 1>(acc, xp, wp, L, n);
      return;
    }
  }
  tile_exact<T, V, CT>(acc, xp, wp, L);
}

"""
DESIGN_C = """// The chain over all C children, software-pipelined (design c): the next
// tile's loads are issued before this tile's fmaf chain.
template <typename T, int V, int CT>
__device__ __forceinline__ void chain_sum(float (&acc)[V], const T* __restrict__ xp,
                                          const float* __restrict__ wp, int64_t L, int64_t C) {
  using VT = Vec<T, V>;
  typename VT::Raw cur[CT], nxt[CT];
  float wcur[CT], wnxt[CT];
#pragma unroll
  for (int j = 0; j < CT; ++j)
    if (j < C) { cur[j] = VT::load(xp + j * L); wcur[j] = __ldg(wp + j); }
  for (int64_t c0 = 0; c0 < C; c0 += CT) {
    const int64_t n = C - c0;
#pragma unroll
    for (int j = 0; j < CT; ++j)
      if (CT + j < n) { nxt[j] = VT::load(xp + (c0 + CT + j) * L); wnxt[j] = __ldg(wp + c0 + CT + j); }
#pragma unroll
    for (int j = 0; j < CT; ++j)
      if (j < n) {
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = fmaf(wcur[j], VT::get(cur[j], k), acc[k]);
      }
#pragma unroll
    for (int j = 0; j < CT; ++j) { cur[j] = nxt[j]; wcur[j] = wnxt[j]; }
  }
}

"""


FORMER_DQ = """// The former dequantize (design "former"): one thread an element.
__global__ void __launch_bounds__(kThreads)
dequantize_elements(const int8_t* __restrict__ q, const float* __restrict__ scale,
                    float* __restrict__ out, int64_t n, int64_t C) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride)
    out[i] = __fmul_rn((float)q[i], __ldg(scale + i / C));
}

"""
FORMER_DQ_ENTRY = """extern "C" int qsgd_dequantize_i8(const int8_t* q, const float* scale, float* out,
                                  int64_t R, int64_t C, void* stream) {
  const int64_t n = R * C;
  if (n <= 0) return (int)cudaGetLastError();
  dequantize_elements<<<blocks_for(n, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(q, scale, out, n, C);
  return (int)cudaGetLastError();
}
"""
FORMER_APPLY = """// The former chain apply (design "former"): one thread an element.
__global__ void __launch_bounds__(kThreads)
apply_elements(const float* __restrict__ w, const int8_t* __restrict__ q,
               const float* __restrict__ s, float* __restrict__ out, int64_t D,
               int64_t R, int64_t C) {
  const int64_t n = R * C;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int64_t r = i / C;
    float acc = w[i];
    for (int64_t d = 0; d < D; ++d)
      acc = __fmaf_rn((float)q[d * n + i], __ldg(s + d * R + r), acc);
    out[i] = acc;
  }
}

"""
FORMER_APPLY_ENTRY = """extern "C" int apply_quantized_broadcast_f32(const float* w, const int8_t* q,
                                             const float* s, float* out, int64_t D,
                                             int64_t R, int64_t C, void* stream) {
  const int64_t n = R * C;
  if (n <= 0) return (int)cudaGetLastError();
  apply_elements<<<blocks_for(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      w, q, s, out, D, R, C);
  return (int)cudaGetLastError();
}
"""


def edited(name: str, edits: dict) -> str:
    """The committed csrc/<name>.cu with ``edits`` (old -> new) applied."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / f"{name}.cu").read_text()
    for old, new in edits.items():
        if old not in src:
            raise SystemExit(f"{name}.cu no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def build_sources(name: str, sources: dict) -> dict:
    """Each variant source (tag -> text) built into build/sweep/<name>-<tag>.so
    by its own nvcc, all started together; returns tag -> path."""
    from repro_torch.kernels import _build

    out_dir = os.path.join(ROOT, "build", "sweep")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for tag, src in sources.items():
        cu, so = (os.path.join(out_dir, f"{name}-{tag}{ext}") for ext in (".cu", ".so"))
        with open(cu, "w") as f:
            f.write(src)
        procs[tag] = (so, subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu],
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for tag, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}-{tag}: {log}")
    if failed:
        raise SystemExit("nvcc failed on " + "\n".join(failed))
    return {tag: so for tag, (so, _) in procs.items()}


def build(name: str, tag: str, edits: dict) -> str:
    """One variant: ``edited`` source built by ``build_sources``; its path."""
    return build_sources(name, {tag: edited(name, edits)})[tag]


I8_VEC = {4: "int", 16: "int4"}  # int8 vectors the committed source (8 bytes) does not hold
I8_SPEC = """template <>
struct Vec<int8_t, {n}> {{
  using Raw = {raw};
  __device__ static Raw load(const int8_t* p) {{ return *reinterpret_cast<const {raw}*>(p); }}
  __device__ static float get(const Raw& r, int k) {{
    return (float)reinterpret_cast<const signed char*>(&r)[k];
  }}
}};

"""


def agg_source(design: str, tile: int, max_threads: int, min_threads: int, target: int,
               i8_bytes: int) -> str:
    edits = {
        "constexpr int kChildTile = 4;": f"constexpr int kChildTile = {tile};",
        "constexpr int kMaxThreads = 256;": f"constexpr int kMaxThreads = {max_threads};",
        "constexpr int kMinThreads = 64;": f"constexpr int kMinThreads = {min_threads};",
        "constexpr int kTargetBlocks = 132;": f"constexpr int kTargetBlocks = {target};",
    }
    if i8_bytes != 8:  # other int8 loads: other lanes per 256-element row
        store = "template <int V>\n__device__ __forceinline__ void store("
        edits[store] = I8_SPEC.format(n=i8_bytes, raw=I8_VEC[i8_bytes]) + store
        edits["launch<int8_t, 8>("] = f"launch<int8_t, {i8_bytes}>("
    src = edited("tree_aggregate", edits)
    if design == "b":
        a, b = src.index("// One tile of up to CT children"), src.index("// The chain over all C")
        src = src[:a] + DESIGN_B + src[b:]
    if design == "e":
        a, b = src.index("// One tile of up to CT children"), src.index("// The chain over all C")
        src = src[:a] + DESIGN_E + src[b:]
    if design == "f":
        a, b = src.index("// One tile of up to CT children"), src.index("// The chain over all C")
        src = src[:a] + DESIGN_F + src[b:]
    if design == "d":
        a, b = src.index("// One tile of up to CT children"), src.index("// The chain over all C")
        src = src[:a] + DESIGN_D + src[b:]
    if design == "c":
        a, b = src.index("// The chain over all C"), src.index("// Block = (blockDim.x")
        src = src[:a] + DESIGN_C + src[b:]
    return src


def agg_layout(G: int, n_vec: int, max_threads: int, min_threads: int, target: int):
    """The entry point's block choice: (threads, rows per block, blocks)."""
    def shape(threads):
        p = 1
        while p < threads and p < n_vec:
            p *= 2
        rows = threads // p
        return threads, rows, -(-G // rows) * min(-(-n_vec // p), 65535)

    s = shape(max_threads)
    while s[0] > min_threads and s[2] < target:
        s = shape(s[0] // 2)
    return s


def agg_inputs(torch, G, C, L, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if dtype == torch.int8:
        x = torch.randint(-128, 128, (G, C, L), device="cuda", generator=gen, dtype=dtype)
        return x, torch.rand(G, C, device="cuda", generator=gen) * 1e-2
    return (torch.randn(G, C, L, device="cuda", generator=gen).to(dtype),
            torch.rand(G, C, device="cuda", generator=gen))


def agg_variant(torch, ta, ref, cs, so: str, spec: tuple) -> dict:
    design, tile, max_threads, min_threads, target, i8_bytes = spec
    lib = ctypes.CDLL(so)
    for tag in ("f32", "bf16", "i8"):  # every call of this variant goes through the port's wrapper
        fn = getattr(lib, f"tree_aggregate_groups_{tag}")
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ta._fns[tag] = fn
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    checks = ([(*lv, f32) for lv in AGG_LEVELS]
              + [(27, 4, 256, i8), (29, 3, 256, i8), (5, 4, 333, i8), (1, 16, 131072, bf16)]
              + [(G, C, 4096, dt) for C in sorted({max(tile - 1, 1), tile, tile + 1, 2 * tile + 3, 64})
                 for G in (1, 5) for dt in (f32, bf16, i8)])
    for G, C, L, dtype in checks:
        x, w = agg_inputs(torch, G, C, L, dtype, seed=G + C + L)
        out = ta.tree_aggregate_groups(x, w)
        torch.cuda.synchronize()
        if not torch.equal(out, ref.tree_aggregate_groups_chain(x, w)):
            raise SystemExit(f"tree_aggregate_groups variant {spec} differs from its chain at "
                             f"{(G, C, L, dtype)}")
    row = {"kernel": "tree_aggregate_groups", "design": design, "child_tile": tile,
           "max_threads": max_threads, "min_threads": min_threads, "target_blocks": target,
           "int8_bytes_per_load": i8_bytes}
    for G, C, L in AGG_LEVELS + [(1, 16, 131072), (1, 16, 1 << 22)]:
        x, w = agg_inputs(torch, G, C, L, f32, seed=1)
        a, b = cs.abba_ms(torch, lambda: ta.tree_aggregate_groups(x, w),
                          lambda: torch.einsum("gc,gcl->gl", w, x))
        row[f"({G}, {C}, {L})"] = {"us": a * 1e3, "einsum_us": b * 1e3, "ratio": a / b,
                                   "blocks": agg_layout(G, L // 4, max_threads, min_threads, target)}
    for G in (27, 4096):
        x, w = agg_inputs(torch, G, 4, 256, i8, seed=1)
        threads, rows, blocks = agg_layout(G, 256 // i8_bytes, max_threads, min_threads, target)
        row[f"({G}, 4, 256) int8"] = {
            "us": cs.device_ms(torch, lambda: ta.tree_aggregate_groups(x, w)) * 1e3,
            "threads": threads, "groups_per_block": rows, "blocks": blocks}
    return row


def use_quantize_lib(qz, so: str) -> None:
    """Route the port's quantize wrappers to the library at ``so``."""
    lib = ctypes.CDLL(so)
    fq, fr, fd = lib.qsgd_quantize_f32, lib.qsgd_quantize_residual_f32, lib.qsgd_dequantize_i8
    fq.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_float, ctypes.c_void_p]
    fr.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_float, ctypes.c_void_p]
    fd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fq.restype = fr.restype = fd.restype = ctypes.c_int
    qz._fns.update(qsgd_quantize_f32=fq, qsgd_quantize_residual_f32=fr, qsgd_dequantize_i8=fd)


def reps(R: int) -> dict:
    return dict(calls=10, replays=5) if R > 4096 else {}


def quant_variant(torch, qz, ref, cs, so: str, spec: tuple) -> dict:
    use_quantize_lib(qz, so)
    for R in (1, 27, 4096, 70001):
        for levels in (127, 3):
            x, u = cs.qsgd_rows(torch, R, seed=R + levels)
            rq, rs, rr = ref.quantize_residual_ref(x, u, levels=levels)
            q, s = qz.qsgd_quantize(x, u, levels=levels)
            q2, s2, r2 = qz.qsgd_quantize_residual(x, u, levels=levels)
            if not all(map(torch.equal, (q, s, q2, s2, r2), (rq, rs, rq, rs, rr))):
                raise SystemExit(f"qsgd_quantize variant {spec} differs at R={R} levels={levels}")
    row = {"kernel": "qsgd_quantize", "threads_per_row": spec[0], "rows_per_block": spec[1]}
    for R in ROWS:
        x, u = cs.qsgd_rows(torch, R, seed=7)
        row[f"R={R} us"] = cs.device_ms(torch, lambda: qz.qsgd_quantize(x, u), **reps(R)) * 1e3
        row[f"residual R={R} us"] = cs.device_ms(
            torch, lambda: qz.qsgd_quantize_residual(x, u), **reps(R)) * 1e3
    return row


def rows_source(name: str, spec) -> str:
    """A dequantize (``name`` "quantize") or chain-apply ("broadcast")
    variant: (bytes a lane loads, lanes per row, rows per block) or the
    former design."""
    if spec == "former":
        src = edited(name, {})
        kernel, entry = (FORMER_DQ, FORMER_DQ_ENTRY) if name == "quantize" else (
            FORMER_APPLY, FORMER_APPLY_ENTRY)
        head = 'extern "C" int qsgd_dequantize_i8' if name == "quantize" else 'extern "C" int apply_'
        src = src[: src.index(head)] + entry
        return src.replace("unsigned blocks_for(", kernel + "unsigned blocks_for(", 1)
    nbytes, lanes, rows = spec
    tag = "Dq" if name == "quantize" else ""
    return edited(name, {f"constexpr int k{tag}Bytes = 4;": f"constexpr int k{tag}Bytes = {nbytes};",
                         f"constexpr int k{tag}Lanes = 64;": f"constexpr int k{tag}Lanes = {lanes};",
                         f"constexpr int k{tag}RowsPerBlock = 2;":
                             f"constexpr int k{tag}RowsPerBlock = {rows};"})


def spec_tag(spec) -> str:
    return spec if isinstance(spec, str) else "b{}-l{}-r{}".format(*spec)


def dequant_variant(torch, qz, ref, cs, so: str, spec) -> dict:
    use_quantize_lib(qz, so)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for R in (1, 27, 4096):
        for C, shift in ((256, 0), (256, 1), (300, 0)):
            q = torch.randint(-128, 128, (R, C), device="cuda", generator=gen, dtype=torch.int8)
            s = torch.rand(R, 1, device="cuda", generator=gen) * 0.1
            qv = cs.offset_view(torch, q, shift) if shift else q
            if not torch.equal(qz.qsgd_dequantize(qv, s), ref.dequantize_ref(q, s)):
                raise SystemExit(f"qsgd_dequantize variant {spec} differs at R={R} C={C} +{shift}")
    row = {"kernel": "qsgd_dequantize", "design": spec_tag(spec)}
    for R in ROWS:
        q = torch.randint(-128, 128, (R, 256), device="cuda", generator=gen, dtype=torch.int8)
        s = torch.rand(R, 1, device="cuda", generator=gen) * 0.1
        row[f"R={R} us"] = cs.device_ms(torch, lambda: qz.qsgd_dequantize(q, s), **reps(R)) * 1e3
        row[f"R={R} mul us"] = cs.device_ms(torch, lambda: torch.mul(q, s), **reps(R)) * 1e3
    return row


def apply_variant(torch, bc, ref, cs, so: str, spec) -> dict:
    fn = ctypes.CDLL(so).apply_quantized_broadcast_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bc._fn_cache[:] = [fn]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def chain(D, R):
        return (torch.randn(R, 256, device="cuda", generator=gen),
                torch.randint(-127, 128, (D, R, 256), device="cuda", generator=gen, dtype=torch.int8),
                torch.rand(D, R, 1, device="cuda", generator=gen) * 0.05)

    for R in (1, 27, 4096):
        for D in (1, 2, 3, 4, 5):
            w, q, s = chain(D, R)
            want = ref.apply_quantized_ref(w, q, s)
            views = [(w, q)] + ([(cs.offset_view(torch, w, 1), cs.offset_view(torch, q, 3))]
                                if D in (1, 5) else [])
            if not all(torch.equal(bc.apply_quantized_broadcast(wv, qv, s), want) for wv, qv in views):
                raise SystemExit(f"apply_quantized_broadcast variant {spec} differs at R={R} D={D}")
    row = {"kernel": "apply_quantized_broadcast", "design": spec_tag(spec)}
    for R in ROWS:
        w, q, s = chain(1, R)
        row[f"D=1 R={R} us"] = cs.device_ms(
            torch, lambda: bc.apply_quantized_broadcast(w, q, s), **reps(R)) * 1e3
        row[f"D=1 R={R} addcmul us"] = cs.device_ms(
            torch, lambda: torch.addcmul(w, q[0], s[0]), **reps(R)) * 1e3
    w, q, s = chain(3, 4096)
    row["D=3 R=4096 us"] = cs.device_ms(torch, lambda: bc.apply_quantized_broadcast(w, q, s)) * 1e3
    return row


def sass_functions(so: str) -> dict:
    """Mangled name -> SASS instruction lines of each quantize kernel in
    ``so``, addresses, comments and the function's own name stripped."""
    from repro_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            funcs[name] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4}\*/\s*(.*?)\s*;", line)
        if name and ins:
            funcs[name].append(ins.group(1))
    return {k: v for k, v in funcs.items() if "quantize_rows" in k and "dequantize" not in k}


def sass_against(parent: str) -> dict:
    """Whether the committed quantize kernels without the residual compile
    to the SASS of ``parent``'s (an unpacked earlier tree)."""
    with open(os.path.join(parent, "src", "repro_torch", "kernels", "csrc", "quantize.cu")) as f:
        sos = build_sources("quantize", {"committed": edited("quantize", {}), "parent": f.read()})
    ours, theirs = sass_functions(sos["committed"]), sass_functions(sos["parent"])
    row = {"kernel": "qsgd_quantize", "sass_against": parent}
    for pname, pcode in theirs.items():
        scalar = "scalar" in pname
        mname = next(k for k in ours if ("scalar" in k) == scalar and "ILb0E" in k)  # <false>
        row["scalar" if scalar else "vector"] = {
            "parent": pname, "no_residual_instance": mname, "parent_instructions": len(pcode),
            "instructions": len(ours[mname]), "same_sass": ours[mname] == pcode}
    return row


def fused_variant(torch, fu, ref, cs, threads: int, loads: int, leaves: int) -> dict:
    so = build("fused_update", f"t{threads}-u{loads}-l{leaves}", {
        "constexpr int kThreads = 256;": f"constexpr int kThreads = {threads};",
        "constexpr int kUnroll = 1;": f"constexpr int kUnroll = {loads};",
        "constexpr int kMaxLeaves = 64;": f"constexpr int kMaxLeaves = {leaves};",
    })
    fu._fns.clear()
    lib = ctypes.CDLL(so)
    fu._lib = lambda: lib  # every call of this variant goes through the port's wrapper
    gen = torch.Generator(device="cuda").manual_seed(0)
    row = {"kernel": "fused_update", "threads": threads, "loads_per_thread": loads, "max_leaves": leaves}
    for name, lengths, mu in (("2^24 mu=0", [1 << 24], 0.0), ("2^24 mu=0.01", [1 << 24], 0.01),
                              ("mlp-step mu=0.01", MLP_STEP, 0.01), ("cnn-step mu=0", CNN_STEP, 0.0),
                              ("73728 mu=0", [73728], 0.0)):
        ws, gs, w0s = ([torch.randn(L, device="cuda", generator=gen) for L in lengths] for _ in range(3))
        outs = [torch.empty_like(w) for w in ws]
        fu.fused_update_many(ws, gs, w0s, lr=0.2, mu=mu, outs=outs)
        torch.cuda.synchronize()
        if not all(torch.equal(o, ref.fused_update_ref(w, g, w0, 0.2, mu, 0.0))
                   for o, w, g, w0 in zip(outs, ws, gs, w0s)):
            raise SystemExit(f"fused_update variant {threads}x{loads} differs from its plain version")
        kernel = lambda: fu.fused_update_many(ws, gs, w0s, lr=0.2, mu=mu, outs=outs)
        if mu:
            row[name] = {"us": cs.device_ms(torch, kernel) * 1e3}
            continue
        if len(ws) == 1:
            lib_fn = lambda: torch.add(ws[0], gs[0], alpha=-0.2, out=outs[0])
        else:
            lib_fn = lambda: torch._foreach_add(ws, gs, alpha=-0.2)
        a, b = cs.abba_ms(torch, kernel, lib_fn)
        row[name] = {"us": a * 1e3, "library_us": b * 1e3, "ratio": a / b}
    return row


def policy_variant(torch, pu, ref, pathplan, cs, min_blocks: int, waves: int) -> dict:
    cap = "if (blocks > wave) blocks = wave;"
    so = build("policy_update", f"b{min_blocks}-w{waves}", {
        "constexpr int kMinBlocksNarrow = 4;": f"constexpr int kMinBlocksNarrow = {min_blocks};",
        cap: f"if (blocks > {waves} * wave) blocks = {waves} * wave;" if waves else "(void)wave;",
    })
    fn = ctypes.CDLL(so).policy_update_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int] + [
        ctypes.c_float] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    pu._fn_cache[:] = [fn]
    row = {"kernel": "policy_update", "min_blocks_k_le_16": min_blocks, "grid_waves": waves}
    for N, K, masks in ((128, 8, "ones"), (10_000, 16, "ones"), (10_000, 16, "partial"),
                        (1_000_000, 16, "ones"), (1_000_000, 16, "partial"), (128, 36, "ones")):
        args = cs.policy_case(torch, pathplan, N, K, "corners", seed=N, masks=masks)
        if N <= 10_000 and not torch.equal(pu.policy_update(*args, tau=8, alpha=0.9, beta=0.5),
                                           ref.policy_update_ref(*args, 8, 0.9, 0.5)):
            raise SystemExit(f"policy_update variant {min_blocks}, {waves} differs from its plain version")
        reps = dict(calls=3, replays=3) if N >= 100_000 else {}
        row[f"({N}, {K}, {args[2].shape[0]}) {masks}"] = cs.device_ms(
            torch, lambda: pu.policy_update(*args, tau=8, alpha=0.9, beta=0.5), **reps) * 1e3
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_port_kernels: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import pathplan
    from repro_torch.kernels import broadcast as bc
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import policy_update as pu
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ref
    from repro_torch.kernels import tree_aggregate as ta

    args = sys.argv[1:]
    parent = None
    if "--sass-against" in args:
        i = args.index("--sass-against")
        parent = args[i + 1]
        del args[i : i + 2]
    kernels = args or ["tree_aggregate", "quantize", "dequantize", "broadcast", "fused_update",
                       "policy_update"]
    print(cs.nvidia_smi_line(), flush=True)
    if parent is not None:
        print(json.dumps(sass_against(parent)), flush=True)
    if "tree_aggregate" in kernels:
        sos = build_sources("tree_aggregate", {"-".join(map(str, v)): agg_source(*v)
                                               for v in VARIANTS_AGG})
        for v in VARIANTS_AGG:
            print(json.dumps(agg_variant(torch, ta, ref, cs, sos["-".join(map(str, v))], v)), flush=True)
    if "quantize" in kernels:
        sos = build_sources("quantize", {f"r{t}-b{b}": edited("quantize", {
            "constexpr int kRowThreads = 64;": f"constexpr int kRowThreads = {t};",
            "constexpr int kRowsPerBlock = 2;": f"constexpr int kRowsPerBlock = {b};",
        }) for t, b in VARIANTS_QUANT})
        for t, b in VARIANTS_QUANT:
            print(json.dumps(quant_variant(torch, qz, ref, cs, sos[f"r{t}-b{b}"], (t, b))), flush=True)
    if "dequantize" in kernels:
        sos = build_sources("quantize", {f"dq-{spec_tag(v)}": rows_source("quantize", v)
                                         for v in VARIANTS_ROWS})
        for v in VARIANTS_ROWS:
            print(json.dumps(dequant_variant(torch, qz, ref, cs, sos[f"dq-{spec_tag(v)}"], v)),
                  flush=True)
    if "broadcast" in kernels:
        sos = build_sources("broadcast", {spec_tag(v): rows_source("broadcast", v)
                                          for v in VARIANTS_ROWS})
        for v in VARIANTS_ROWS:
            print(json.dumps(apply_variant(torch, bc, ref, cs, sos[spec_tag(v)], v)), flush=True)
    if "fused_update" in kernels:
        for threads, loads, leaves in VARIANTS_FUSED:
            print(json.dumps(fused_variant(torch, fu, ref, cs, threads, loads, leaves)), flush=True)
    if "policy_update" in kernels:
        for b, w in VARIANTS_POLICY:
            print(json.dumps(policy_variant(torch, pu, ref, pathplan, cs, b, w)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
