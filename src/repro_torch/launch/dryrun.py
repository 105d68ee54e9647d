"""Multi-pod dry-run: one rank's step of every (arch x shape x mesh) cell,
on a fake process group, with no card.

Answers to ``repro/launch/dryrun.py``.  For each cell the port's own step
runs once on fake tensors (``launch/specs.lower_cell``) over a CPU
``DeviceMesh`` of the production shape and axis names, 16x16 or 2x16x16,
on a fake process group of 256 or 512 ranks (``init_process_group("fake",
...)``: collectives return at once and move nothing).  The numbers are
rank 0's: after ``fit_spec`` every rank's shards have the same shapes, so
every rank's are the same.  The three roofline terms are reckoned at the
H100's figures (``launch/hlo.py``).

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out results.json]
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k \\
      --mesh-shape 2x2 --layers 4 --seq-len 1024 --global-batch 8 --aggregation totoro_tree

The record keeps the reference's keys wherever the quantity exists in
eager PyTorch: ``arch``, ``shape``, ``mesh``, ``chips``, ``aggregation``,
``grad_accum``, ``params_total``, ``params_active``, ``memory`` (the
reference's five ``*_bytes_per_dev``; ``lower_cell``'s docstring says
what each means here), ``cost`` (``flops_per_dev``, ``bytes_per_dev``),
``collectives`` (``total_bytes_per_dev``, ``bytes_by_kind``,
``count_by_kind``, and ``by_op_axis``: ``CollectiveLog.summary()`` of the
step) and ``roofline`` (``compute_s``, ``memory_s``, ``collective_s``,
``bound``, ``model_flops``, ``useful_flops_ratio``).  The fake run's
``trace_s`` takes the place of ``lower_s`` and ``compile_s``; the
``xla_*_loop_undercounted`` keys and ``loops`` are gone (every loop is
counted as it runs).  A cell that raises (a serving cell, ``totoro_tree_q8``
inside a sharded pod: each names its ROADMAP item) is a failure, listed
under ``FAILURES``, and the command exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import traceback

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def _mesh_name(shape) -> str:
    return "x".join(map(str, shape))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, aggregation=None, quiet=False,
             cfg_overrides=None, grad_accum=None, mesh_shape=None, seq_len=None,
             global_batch=None, calls=False):
    """One cell's record (module docstring).  ``mesh_shape`` replaces the
    production mesh by one of that shape (2 dims: data, model; 3: pod,
    data, model); ``seq_len`` and ``global_batch`` replace the shape's;
    ``calls`` adds the step's collectives in order, (op, mesh axis, bytes)
    each, under ``collectives["calls"]``."""
    import dataclasses

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from .. import configs
    from ..config import SHAPES
    from ..models import encdec, lm
    from . import hlo, specs
    from . import mesh as mesh_mod

    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    mesh_shape = tuple(mesh_shape)
    nchips = 1
    for n in mesh_shape:
        nchips *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=nchips)
    try:
        mesh = mesh_mod._mk(mesh_shape, AXES[len(mesh_shape)], "cpu")
        cfg = configs.get_config(arch)
        if cfg_overrides:
            cfg = cfg.replace(**cfg_overrides)
        spec = SHAPES[shape_name]
        if seq_len or global_batch:
            spec = dataclasses.replace(spec, seq_len=seq_len or spec.seq_len,
                                       global_batch=global_batch or spec.global_batch)
        plan = configs.get_plan(arch, shape_name)
        if aggregation is not None:
            plan = dataclasses.replace(plan, aggregation=aggregation)
        if grad_accum is not None:
            plan = dataclasses.replace(plan, grad_accum=grad_accum)
        cell = specs.cell_for(cfg, spec, plan, mesh)
        low = specs.lower_cell(cell, mesh)
    finally:
        dist.destroy_process_group()

    mod, mem = low["stats"], low["memory"]
    flops, bytes_acc = float(mod.flops), float(mod.hbm_bytes)
    terms = hlo.roofline_terms(flops, bytes_acc, mod.collective_bytes)
    model = encdec if cfg.is_encoder_decoder else lm
    n_total, n_active = model.count_params_analytic(cfg)
    mflops = hlo.model_flops(cfg, spec, n_total, n_active)
    ratio = mflops / (flops * nchips) if flops else 0.0

    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": _mesh_name(mesh_shape),
        "chips": nchips,
        "aggregation": plan.aggregation if spec.kind == "train" else None,
        "grad_accum": plan.grad_accum,
        "layers": cfg.num_layers,
        **({"enc_layers": cfg.enc_layers} if cfg.is_encoder_decoder else {}),
        "seq_len": spec.seq_len,
        "global_batch": spec.global_batch,
        "params_total": n_total,
        "params_active": n_active,
        "trace_s": round(low["trace_s"], 1),
        "memory": {
            "argument_bytes_per_dev": mem["argument"],
            "output_bytes_per_dev": mem["output"],
            "temp_bytes_per_dev": mem["temp"],
            "alias_bytes_per_dev": mem["alias"],
            "peak_bytes_per_dev": mem["peak"],
        },
        "cost": {"flops_per_dev": flops, "bytes_per_dev": bytes_acc},
        "collectives": {
            "total_bytes_per_dev": mod.collective_bytes,
            "bytes_by_kind": {k: round(v) for k, v in mod.coll_bytes_by_kind.items()},
            "count_by_kind": {k: round(v) for k, v in mod.coll_count_by_kind.items()},
            "by_op_axis": mesh_mod.summarize(low["calls"]),
            **({"calls": low["calls"]} if calls else {}),
        },
        "roofline": {
            **terms,
            "device": hlo.DEVICE,
            "model_flops": mflops,
            "useful_flops_ratio": ratio,
        },
    }
    if not quiet:
        print(f"== {arch} x {shape_name} x {result['mesh']} ==")
        print("memory a device:", result["memory"])
        print("flops/bytes a device:", flops, bytes_acc)
        print(
            "collectives:",
            {k: f"{v/1e6:.1f}MB" for k, v in mod.coll_bytes_by_kind.items()},
            {k: round(v) for k, v in mod.coll_count_by_kind.items()},
        )
        print(
            f"roofline ({hlo.DEVICE}): compute={terms['compute_s']*1e3:.2f}ms "
            f"memory={terms['memory_s']*1e3:.2f}ms "
            f"collective={terms['collective_s']*1e3:.2f}ms bound={terms['bound']} "
            f"useful_flops_ratio={ratio:.3f}"
        )
    return result


def depth_overrides(arch: str, layers: int) -> dict | None:
    """``--layers``' config overrides: ``num_layers``, and an
    encoder-decoder's ``enc_layers`` as well (both stacks cut alike);
    None for 0."""
    from .. import configs

    if not layers:
        return None
    enc = {"enc_layers": layers} if configs.get_config(arch).is_encoder_decoder else {}
    return {"num_layers": layers, **enc}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--aggregation", default=None,
                    help="override: xla_auto | totoro_tree | totoro_tree_q8")
    ap.add_argument("--out", default=None, help="append JSON results here")
    ap.add_argument("--mesh-shape", default=None,
                    help="e.g. 2x2 (data, model) or 2x2x2 (pod, data, model) in place of --mesh")
    ap.add_argument("--layers", type=int, default=0,
                    help="override num_layers (an encoder-decoder's enc_layers too)")
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--global-batch", type=int, default=0)
    ap.add_argument("--calls", action="store_true",
                    help="record the step's collectives in order")
    args = ap.parse_args(argv)

    from .. import configs

    if args.all:
        cells = [(a, s) for a in configs.ARCH_IDS for s in configs.runnable_cells(a)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    if args.mesh_shape:
        meshes = [tuple(int(n) for n in args.mesh_shape.split("x"))]
    else:
        meshes = {"single": [(16, 16)], "multi": [(2, 16, 16)],
                  "both": [(16, 16), (2, 16, 16)]}[args.mesh]
    results, failures = [], []
    for arch, shape in cells:
        for ms in meshes:
            try:
                results.append(run_cell(arch, shape, multi_pod=len(ms) == 3,
                                        aggregation=args.aggregation,
                                        cfg_overrides=depth_overrides(arch, args.layers),
                                        mesh_shape=ms,
                                        seq_len=args.seq_len or None,
                                        global_batch=args.global_batch or None,
                                        calls=args.calls))
            except Exception as e:
                traceback.print_exc()
                failures.append({"arch": arch, "shape": shape, "mesh": _mesh_name(ms),
                                 "error": f"{type(e).__name__}: {e}"})
    if args.out:
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        with open(args.out, "w") as f:
            json.dump(existing + results, f, indent=1)
    if failures:
        print("FAILURES:", json.dumps(failures, indent=1))
        raise SystemExit(1)
    print(f"dry-run OK: {len(results)} cells")


if __name__ == "__main__":
    main()
