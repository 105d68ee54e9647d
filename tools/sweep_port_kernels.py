#!/usr/bin/env python3
"""Build variants of two of the port's CUDA kernels and time each on one card.

    python3 tools/sweep_port_kernels.py

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

Each variant is the committed source with one constant changed, built by
nvcc with the port's flags into ``build/sweep/``, checked bit-equal to the
plain version, and called through the port's own wrapper.  One JSON line
per variant; the card's name and power limit first.  Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

VARIANTS_FUSED = [(256, 1, 64), (256, 1, 8), (128, 1, 64), (512, 1, 64), (128, 2, 64), (256, 2, 64),
                  (128, 4, 64)]
VARIANTS_POLICY = [(4, 1), (1, 1), (4, 2), (4, 0)]
MLP_STEP = [1024, 1024, 128, 32768, 65536, 8192]
CNN_STEP = [2304, 73728, 65536]


def build(name: str, tag: str, edits: dict) -> str:
    """The committed csrc/<name>.cu with ``edits`` (old -> new) applied,
    built into build/sweep/lib<name>-<tag>.so; returns its path."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / f"{name}.cu").read_text()
    for old, new in edits.items():
        if old not in src:
            raise SystemExit(f"{name}.cu no longer holds {old!r}")
        src = src.replace(old, new)
    out_dir = os.path.join(ROOT, "build", "sweep")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = (os.path.join(out_dir, f"{name}-{tag}{ext}") for ext in (".cu", ".so"))
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu], check=True,
                   capture_output=True, text=True)
    return so


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
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import policy_update as pu
    from repro_torch.kernels import ref

    print(cs.nvidia_smi_line(), flush=True)
    for threads, loads, leaves in VARIANTS_FUSED:
        print(json.dumps(fused_variant(torch, fu, ref, cs, threads, loads, leaves)), flush=True)
    for b, w in VARIANTS_POLICY:
        print(json.dumps(policy_variant(torch, pu, ref, pathplan, cs, b, w)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
