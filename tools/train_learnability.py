#!/usr/bin/env python3
"""What a few bf16 training steps of the port's LM loop learn, on one card.

    python3 tools/train_learnability.py [--out learnability.json]
    python3 tools/train_learnability.py --reduced --device cpu --seq 32   # a CPU dry run

Each run of ``PLAN`` takes the settings of ``chip_smoke.py``'s training
phases (4e c to 4h c: bf16, AdamW, remat on, TF32 off, bf16 GEMMs
accumulating in f32, S = TRAIN_SEQ, B = TRAIN_BATCH or SEAMLESS_BATCH,
TRAIN_STEPS steps of ``launch/train``'s batches) and varies one thing: the
parameters' draw (``host``: ``init_params`` on the CPU generator of the
seed, as ``launch/train.train`` draws seed 0; ``card``: the same under
``chip_smoke.drawn_on_card``), the seed, the learning rate, the number of
steps, or the stream's vocabulary (``stream_vocab``: the learnable stream
``x -> 7 x + 3 mod v`` over the first ``v`` tokens only; the model keeps
its own vocabulary).  Besides each step's loss it reads, with no gradient,
five losses: the initial and the trained parameters on batch 0 (the first
step's, which the run trained on: ``seen``) and on the batch after the
last step's (which no step saw: ``fresh``), and the parameters after the
first step on batch 0 (``first_step_drop``: how far the first update
lowers its own batch's loss, what ``chip_smoke.py``'s training gate
reads).  ``seen`` falling while ``fresh`` stays is what the steps learned
of the batches they saw.

The stream's successor map ``x -> 7 x + 3 mod V`` is one permutation of
the vocabulary, so a token's successor is learnable only for tokens some
step has seen; the cycle through a batch's first token is printed
(``cycle``: its length, at most ``cycle_cap``), since where a cycle is
shorter than a sequence the sequence repeats itself.  The JSON goes to
``--out`` and to the standard output's last line, with the card's name
and power limit.  On the CPU the ``card`` draws are left out, and a
stream vocabulary is cut to the model's.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from contextlib import nullcontext

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402

SEAMLESS, TINY, DEEPSEEK, RWKV = ("seamless-m4t-medium", "tinyllama-1.1b",
                                  "deepseek-v2-lite-16b", "rwkv6-7b")
PLAN = [
    {"arch": SEAMLESS, "draw": "host", "seed": 0},
    *({"arch": SEAMLESS, "draw": "card", "seed": s} for s in range(5)),
    {"arch": SEAMLESS, "draw": "card", "seed": 0, "lr": 1e-3},
    {"arch": SEAMLESS, "draw": "card", "seed": 0, "steps": 12},
    {"arch": SEAMLESS, "draw": "card", "seed": 0, "stream_vocab": 32000},
    *({"arch": TINY, "draw": "card", "seed": s} for s in range(2)),
    *({"arch": DEEPSEEK, "draw": "card", "seed": s} for s in range(2)),
    {"arch": RWKV, "draw": "host", "seed": 0},
    *({"arch": RWKV, "draw": "card", "seed": s} for s in range(3)),
]


def cycle_length(first: int, vocab: int, cap: int) -> int:
    """Steps of ``x -> 7 x + 3 mod vocab`` from ``first`` back to it (at
    most ``cap``)."""
    x, n = (7 * first + 3) % vocab, 1
    while x != first and n < cap:
        x, n = (7 * x + 3) % vocab, n + 1
    return n


def config(spec: dict, reduced: bool):
    from repro_torch import configs

    cfg = (configs.get_reduced if reduced else configs.get_config)(spec["arch"])
    if not reduced and spec["arch"] == DEEPSEEK:
        cfg = cfg.replace(num_layers=cs.MOE_TRAIN_LAYERS)
    if not reduced and spec["arch"] == RWKV:
        cfg = cfg.replace(num_layers=cs.RWKV_TRAIN_LAYERS)
    if "lr" in spec:
        cfg = cfg.replace(learning_rate=spec["lr"])
    return cfg


def one_run(spec: dict, reduced: bool, device: str, seq: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.config import RunPlan
    from repro_torch.fl import steps
    from repro_torch.launch import train
    from repro_torch.models import encdec, lm

    cfg = config(spec, reduced)
    n_steps = spec.get("steps", cs.TRAIN_STEPS)
    batch_size = cs.SEAMLESS_BATCH if cfg.is_encoder_decoder else cs.TRAIN_BATCH
    sc = train.StreamConfig(min(spec.get("stream_vocab", cfg.vocab_size), cfg.vocab_size), seq,
                            batch_size)
    model = encdec if cfg.is_encoder_decoder else lm
    t0 = time.perf_counter()
    with cs.drawn_on_card() if spec["draw"] == "card" else nullcontext():
        params = model.init_params(torch.Generator().manual_seed(spec["seed"]), cfg,
                                   device=device)
    init_s = time.perf_counter() - t0
    seen, fresh = (train.make_batch(cfg, sc, s, None, device) for s in (0, n_steps))

    def loss(state, batch) -> float:
        with torch.no_grad():
            return float(steps._loss(cfg, state["params"], batch)[0])

    state = steps.init_train_state(cfg, params)
    del params
    before = {"seen": loss(state, seen), "fresh": loss(state, fresh)}
    step = steps.build_train_step(cfg, RunPlan())
    losses = []
    for s in range(n_steps):
        state, metrics = step(state, train.make_batch(cfg, sc, s, None, device))
        losses.append(float(metrics["loss"]))
        if s == 0:
            seen_first = loss(state, seen)
    after = {"seen": loss(state, seen), "fresh": loss(state, fresh)}
    first = int(seen["tokens"][0, 0])
    del state
    if device == "cuda":
        torch.cuda.empty_cache()
    return {**spec, "lr": cfg.learning_rate, "steps": n_steps, "layers": cfg.num_layers,
            "batch": batch_size, "seq": seq, "vocab": cfg.vocab_size,
            "ln_vocab": float(np.log(cfg.vocab_size)), "losses": losses,
            "seen_before": before["seen"], "seen_after": after["seen"],
            "fresh_before": before["fresh"], "fresh_after": after["fresh"],
            "seen_after_first": seen_first, "first_step_drop": before["seen"] - seen_first,
            "seen_drop": before["seen"] - after["seen"],
            "fresh_drop": before["fresh"] - after["fresh"],
            "last_minus_first": losses[-1] - losses[0],
            "cycle": cycle_length(first, sc.vocab_size, 4 * seq), "cycle_cap": 4 * seq,
            "init_s": init_s, "wall_s": time.perf_counter() - t0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true", help="reduced configs (a CPU dry run)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seq", type=int, default=cs.TRAIN_SEQ)
    ap.add_argument("--only", default="", help="comma-separated archs of PLAN to run")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    only = set(filter(None, args.only.split(",")))
    runs = []
    for spec in PLAN:
        if (only and spec["arch"] not in only) or (args.device == "cpu" and spec["draw"] == "card"):
            continue
        runs.append(one_run(spec, args.reduced, args.device, args.seq))
        print(json.dumps(runs[-1]), flush=True)
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True).stdout
            .strip() if args.device == "cuda" else "cpu")
    out = {"card": card, "torch": torch.__version__, "runs": runs}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
