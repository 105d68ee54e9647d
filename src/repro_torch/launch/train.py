"""Training entry point: federated LM rounds with checkpoint/restart.

Answers to ``repro/launch/train.py``, with the same flags and ``--device``
(default ``cuda``; with no card present it raises, and the CPU runs only
when asked for):

  python -m repro_torch.launch.train --arch tinyllama-1.1b --reduced \
      --steps 5 [--ckpt-dir DIR [--resume]] [--device cpu]

Fault tolerance: k-replica checkpoints every ``--ckpt-every`` steps and at
the end, and ``--resume`` restarts from the latest intact one (the paper's
master-state replication).  Straggler mitigation: each step drops every
client (batch row) with probability ``--straggler-rate`` by masking its
labels, so dropped examples weigh nothing in the loss.

``train`` is the loop, for callers other than the command line:
parameters from ``lm.init_params`` (``encdec.init_params`` for an
encoder-decoder config) with a seeded CPU generator (seed 0), batches from
``data.learnable_lm_batch`` (shard 0, one per step; an embeds-input config
takes ``data.embeds_batch`` frames in place of the tokens, and an
encoder-decoder config both: source frames, target tokens), the
straggler draws from ``numpy.random.default_rng(0)``, as the reference's
loop.  It also takes a ``RunPlan`` and ``num_pods``, so the podded
``totoro_tree_q8`` step runs through it too (the reference's command line
reaches only the plain step, and so does this one).  With ``mesh=`` (a
``launch/mesh`` ``DeviceMesh`` whose ``pod`` axis spans the ranks) each
rank runs the loop as one pod: every rank initialises the same parameters
from seed 0 (pod-replicated, as the reference's ``totoro_tree`` mode),
builds the same global batches, and the step (``build_train_step(...,
mesh=mesh)``) takes the rank's share of each and aggregates over the
``pod`` group.  With ``xla_auto`` or ``totoro_tree`` on a mesh with any
axis larger than 1 (``steps.runs_sharded``), the step is the sharded one:
every rank draws the same parameters from seed 0 and keeps its shards of
them (``launch/specs.place`` under ``specs.cell_for``'s shardings, no
collective), initialises the optimizer state on them, and places each
global batch ``Shard(0)`` over the batch axes; the losses are read through
``full_tensor()``.  Checkpoints with a mesh are not ported yet and raise.
Step times are taken on the host clock after ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from .. import ckpt
from ..config import RunPlan, ShapeSpec
from ..configs import get_config, get_reduced
from ..data import StreamConfig, embeds_batch, learnable_lm_batch
from ..fl import steps as steps_mod
from ..fl.rounds import resolve_device
from ..models import encdec, lm


def make_config(arch: str, *, reduced: bool = False, width: int = 0, layers: int = 0,
                lr: float | None = None):
    """The reference's config overrides: ``--width`` sets d_model with
    ``num_heads = max(4, width // 32)`` heads of 32; ``--layers`` the depth
    (an encoder-decoder config's decoder depth)."""
    cfg = get_reduced(arch) if reduced else get_config(arch)
    if width:
        cfg = cfg.replace(d_model=width, num_heads=max(4, width // 32), head_dim=32)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    if lr is not None:
        cfg = cfg.replace(learning_rate=lr)
    return cfg


def make_batch(cfg, sc: StreamConfig, step: int, drop: np.ndarray | None, device) -> dict:
    """Step ``step``'s batch of the learnable stream on ``device``; the rows
    where ``drop`` is True get labels -1 (no weight)."""
    batch = learnable_lm_batch(sc, shard=0, step=step)
    if drop is not None:
        batch["labels"] = np.where(drop[:, None], -1, batch["labels"])
    if cfg.embed_inputs or cfg.is_encoder_decoder:
        b = {"embeds": embeds_batch(sc, cfg.d_model, 0, step), "labels": batch["labels"]}
        if cfg.is_encoder_decoder:
            b["tokens"] = batch["tokens"]
    else:
        b = batch
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in b.items()}


def init_placed(model, gen: torch.Generator, cfg, shardings, *, device):
    """``model.init_params`` placed under ``shardings`` (the parameters' of
    a ``Cell``): a decoder's (``lm``) entry by entry as each is drawn, so a
    rank holds its shards and at most one entry of the whole model (a full
    jamba layer is 11 GB; four ranks that share one card cannot each hold
    the 18.7 GB of two); an encoder-decoder's whole, then placed."""
    from . import specs

    def put(tree, path):
        return specs.place(tree, functools.reduce(lambda t, k: t[k], path, shardings))

    if model is lm:
        return model.init_params(gen, cfg, device=device, place=put)
    return specs.place(model.init_params(gen, cfg, device=device), shardings)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A metric read on the host: a DTensor through ``full_tensor()``."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg, plan: RunPlan, *, steps: int, seq_len: int = 128, global_batch: int = 8,
          device="cuda", num_pods: int = 1, ckpt_dir: str | None = None, ckpt_every: int = 10,
          replicas: int = 2, resume: bool = False, straggler_rate: float = 0.0,
          non_iid: float = 0.0, log_every: int = 5, log=print, mesh=None) -> dict:
    """Steps ``start .. steps - 1`` of the training loop (``start`` is 0, or
    the resumed checkpoint's step).  Returns the final state, the start
    step, each step's loss and aux loss (the MoE layers' load-balance
    loss; 0 for a dense model) and each step's time (ms, host clock after
    a synchronize)."""
    if mesh is not None and ckpt_dir:
        raise NotImplementedError("checkpoints with a mesh: ROADMAP §1, checkpoints with a mesh")
    device = resolve_device(device)
    train_step = steps_mod.build_train_step(cfg, plan, mesh=mesh, num_pods=num_pods)
    model = encdec if cfg.is_encoder_decoder else lm
    gen = torch.Generator().manual_seed(0)
    batch_sh = None
    if mesh is not None and steps_mod.runs_sharded(plan, mesh):
        from . import specs

        cell = specs.cell_for(cfg, ShapeSpec("train", "train", seq_len, global_batch), plan, mesh)
        state_sh, batch_sh = cell.in_shardings
        params = init_placed(model, gen, cfg, state_sh["params"], device=device)
        state = specs.place(steps_mod.init_train_state(cfg, params), state_sh)
    else:
        params = model.init_params(gen, cfg, device=device)
        podded = plan.aggregation == "totoro_tree_q8" and num_pods > 1 and mesh is None
        state = steps_mod.init_train_state(cfg, params, num_pods=num_pods, podded=podded)
    del params
    start = 0
    if resume and ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        state, start = ckpt.restore(state, ckpt_dir, device=device)
        log(f"resumed from step {start}")

    sc = StreamConfig(vocab_size=cfg.vocab_size, seq_len=seq_len, batch_per_shard=global_batch,
                      non_iid_alpha=non_iid)
    rng = np.random.default_rng(0)
    losses, auxes, step_ms = [], [], []
    t0 = time.perf_counter()
    for step in range(start, steps):
        # deadline-style straggler mitigation: dropped clients' examples
        # get zero weight by masking their labels (paper §III ch.2)
        drop = rng.random(global_batch) < straggler_rate if straggler_rate > 0 else None
        batch = make_batch(cfg, sc, step, drop, device)
        if batch_sh is not None:
            batch = specs.place(batch, batch_sh)
        _sync(device)
        ts = time.perf_counter()
        state, metrics = train_step(state, batch)
        _sync(device)
        step_ms.append((time.perf_counter() - ts) * 1e3)
        losses.append(float(_whole(metrics["loss"])))
        auxes.append(float(_whole(metrics["aux"])))
        if step % log_every == 0 or step == steps - 1:
            log(f"step {step}: loss={losses[-1]:.4f} "
                f"({(time.perf_counter() - t0) / max(step - start + 1, 1) * 1e3:.0f} ms/step)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt.save(state, ckpt_dir, step=step + 1, replicas=replicas)
    if ckpt_dir:
        ckpt.save(state, ckpt_dir, step=steps, replicas=replicas)
        log(f"final checkpoint at step {steps} ({replicas} replicas)")
    return {"state": state, "start_step": start, "losses": losses, "auxes": auxes,
            "step_ms": step_ms}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--reduced", action="store_true", help="reduced config (CPU-scale)")
    ap.add_argument("--width", type=int, default=0, help="override d_model (reduced)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--straggler-rate", type=float, default=0.0,
                    help="simulated per-round client dropout probability")
    ap.add_argument("--non-iid", type=float, default=0.0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = make_config(args.arch, reduced=args.reduced, width=args.width, layers=args.layers,
                      lr=args.lr)
    print(f"device={device} arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model}")
    train(cfg, RunPlan(grad_accum=args.grad_accum), steps=args.steps, seq_len=args.seq_len,
          global_batch=args.global_batch, device=device, ckpt_dir=args.ckpt_dir,
          ckpt_every=args.ckpt_every, replicas=args.replicas, resume=args.resume,
          straggler_rate=args.straggler_rate, non_iid=args.non_iid, log_every=args.log_every)
    print("done")


if __name__ == "__main__":
    main()
