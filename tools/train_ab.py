#!/usr/bin/env python3
"""Step time of the port's LM training loop from several source trees,
timed in turns on one card.

    python3 tools/train_ab.py --trees OLD_TREE . [--order 0,1,1,0] [--arch tinyllama-1.1b]
                              [--layers N] [--podded] [--out train_ab.json]

Each ``--trees`` entry is a checkout of the repo (``.`` for this one; an
earlier commit unpacked with ``git archive``).  For each index of
``--order`` a fresh process imports ``repro_torch`` from that tree's
``src`` and runs its ``launch/train.train``: the config in bf16, AdamW,
remat as configured, B 8, S 1024, 6 steps, with the settings
``chip_smoke.py`` phase 4e c runs under (TF32 off, bf16 GEMMs
accumulating in f32); with ``--podded``, the podded ``totoro_tree_q8``
step of phase 4e d (2 pods in one process) instead of the plain one.  Each run reports its step times (host clock after a
synchronize), their mean over steps 2-6, its peak memory and one step's
device busy time under ``torch.profiler``; the card's name and power
limit stand beside them.  The JSON goes to ``--out`` and to the standard
output's last line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

STEPS, BATCH, SEQ, PODS = 6, 8, 1024, 2


def child(arch: str, layers: int | None, podded: bool) -> dict:
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.config import RunPlan
    from repro_torch.fl import steps
    from repro_torch.launch import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = configs.get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    plan, pods = (RunPlan(aggregation="totoro_tree_q8"), PODS) if podded else (RunPlan(), 1)
    torch.cuda.reset_peak_memory_stats()
    run = train.train(cfg, plan, steps=STEPS, seq_len=SEQ, global_batch=BATCH,
                      device="cuda", num_pods=pods, log=lambda *a: None)
    out = {"arch": cfg.name, "layers": cfg.num_layers, "pods": pods, "step_ms": run["step_ms"],
           "ms_per_step": float(np.mean(run["step_ms"][1:])), "losses": run["losses"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    step = steps.build_train_step(cfg, plan, num_pods=pods)
    batch = train.make_batch(cfg, train.StreamConfig(cfg.vocab_size, SEQ, BATCH), STEPS, None,
                             "cuda")
    state = run["state"]
    step(state, batch)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    out.update(profiled_step_ms=wall, device_busy_ms=busy, device_idle_share=1 - busy / wall)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", default=[])
    ap.add_argument("--order", default=None, help="tree indices, comma-separated (default a b b a)")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--podded", action="store_true", help="the podded q8 step, 2 pods")
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.arch, args.layers, args.podded)))
        return 0
    if not args.trees:
        ap.error("--trees is required")
    order = ([int(i) for i in args.order.split(",")] if args.order
             else list(range(len(args.trees))) + list(reversed(range(len(args.trees)))))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    runs = []
    for i in order:
        tree = os.path.abspath(args.trees[i])
        env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
        cmd = [sys.executable, os.path.abspath(__file__), "--child", "--arch", args.arch]
        if args.layers:
            cmd += ["--layers", str(args.layers)]
        if args.podded:
            cmd.append("--podded")
        res = subprocess.run(cmd, env=env, cwd=tree, capture_output=True, text=True)
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        run = dict(json.loads(res.stdout.strip().splitlines()[-1]), tree=args.trees[i])
        print(f"[train_ab] {args.trees[i]}: {run['ms_per_step']:.1f} ms/step "
              f"{[round(t, 1) for t in run['step_ms']]}, device busy {run['device_busy_ms']:.1f} of "
              f"{run['profiled_step_ms']:.1f} ms, peak {run['peak_mem_gb']:.2f} GB; card: {smi}",
              flush=True)
        runs.append(run)
    out = {"card": smi, "batch": BATCH, "seq": SEQ, "steps": STEPS, "podded": args.podded,
           "runs": runs}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
