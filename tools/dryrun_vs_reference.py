"""The port's dry-run beside the JAX package's on the 8-device test meshes.

For each cell of ``CELLS`` (tinyllama-1.1b at full width, ``num_layers``
cut to ``--layers``, on ``make_test_mesh``'s (data 2, model 4) and (pod 2,
data 2, model 2) shapes) it prints one JSON line with both packages'
numbers a device: the reference's ``memory_analysis()`` and
``hlo.analyze_module`` of its compiled step (one subprocess with 8 host
devices, XLA's CPU backend at optimisation level 0 as its ``dryrun.py``
sets it), and the port's ``launch/dryrun.run_cell`` on a fake process
group of 8 ranks.  CPU counts, no card and no time measured.

  PYTHONPATH=src python tools/dryrun_vs_reference.py [--layers 2]

``tests/test_torch_dryrun.py`` runs both sides through ``jax_side`` /
``jax_records`` and ``port_side`` / ``port_records``, all four
subprocesses at once.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "tinyllama-1.1b"
# (multi_pod, shape, aggregation): the reference's small-mesh dry-run cells
# (tests/test_optim_sharding.py) that lower
CELLS = [(False, "train_4k", None), (True, "train_4k", None), (True, "train_4k", "xla_auto")]

JAX_CODE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")
import jax
from repro.launch import hlo, mesh as mesh_mod, specs
from repro.models import lm
layers, cells = int(sys.argv[1]), json.loads(sys.argv[2])
for mp, shape, agg in cells:
    mesh = mesh_mod.make_test_mesh(multi_pod=mp)
    cell = specs.build_cell(%(arch)r, shape, mesh, aggregation=agg,
                            cfg_overrides={"num_layers": layers})
    compiled = specs.lower_cell(cell, mesh).compile()
    mem = compiled.memory_analysis()
    mod = hlo.analyze_module(compiled.as_text())
    n_total, n_active = lm.count_params_analytic(cell.cfg)
    print("JAX_JSON:" + json.dumps({
        "multi_pod": mp, "shape": shape, "aggregation": cell.plan.aggregation,
        "argument_bytes_per_dev": mem.argument_size_in_bytes,
        "output_bytes_per_dev": mem.output_size_in_bytes,
        "temp_bytes_per_dev": mem.temp_size_in_bytes,
        "alias_bytes_per_dev": mem.alias_size_in_bytes,
        "flops_per_dev": mod.flops, "bytes_per_dev": mod.hbm_bytes,
        "collective_bytes_per_dev": mod.collective_bytes,
        "coll_bytes_by_kind": mod.coll_bytes_by_kind,
        "coll_count_by_kind": mod.coll_count_by_kind,
        "params_total": n_total, "params_active": n_active,
        "model_flops": hlo.model_flops(cell.cfg, cell.shape, n_total, n_active),
    }), flush=True)
""" % {"arch": ARCH}


def jax_side(layers: int) -> subprocess.Popen:
    """The reference's subprocess, started; ``jax_records`` reads it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", JAX_CODE, str(layers), json.dumps(CELLS)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def jax_records(proc: subprocess.Popen, timeout: float = 900) -> list[dict]:
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
    if proc.returncode:
        raise RuntimeError(err[-4000:])
    return [json.loads(line[len("JAX_JSON:"):]) for line in out.splitlines()
            if line.startswith("JAX_JSON:")]


def port_side(layers: int, out_dir: str) -> list[subprocess.Popen]:
    """The port's dry-run of each cell (``launch/dryrun``'s command line),
    one subprocess each, started; ``port_records`` reads them."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for i, (mp, shape, agg) in enumerate(CELLS):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH, "--shape", shape,
               "--mesh-shape", "2x2x2" if mp else "2x4", "--layers", str(layers),
               "--out", os.path.join(out_dir, f"cell{i}.json")]
        if agg:
            cmd += ["--aggregation", agg]
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                                      stderr=subprocess.PIPE, text=True))
    return procs


def port_records(procs: list, out_dir: str, timeout: float = 900) -> list[dict]:
    recs = []
    try:
        for i, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode:
                raise RuntimeError(err[-4000:])
            with open(os.path.join(out_dir, f"cell{i}.json")) as f:
                recs.append(json.load(f)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return recs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        proc, procs = jax_side(args.layers), port_side(args.layers, tmp)
        refs, ports = jax_records(proc), port_records(procs, tmp)
    for ref, port in zip(refs, ports):
        print(json.dumps({
            "cell": f"{ARCH} {args.layers} layers {ref['shape']} {port['mesh']} "
                    f"{ref['aggregation']}",
            "argument_bytes_per_dev": [port["memory"]["argument_bytes_per_dev"],
                                       ref["argument_bytes_per_dev"]],
            "output_bytes_per_dev": [port["memory"]["output_bytes_per_dev"],
                                     ref["output_bytes_per_dev"]],
            "peak_bytes_per_dev (port measured, reference summed)": [
                port["memory"]["peak_bytes_per_dev"],
                ref["argument_bytes_per_dev"] + ref["output_bytes_per_dev"]
                + ref["temp_bytes_per_dev"] - ref["alias_bytes_per_dev"]],
            "flops_per_dev": [port["cost"]["flops_per_dev"], ref["flops_per_dev"]],
            "bytes_per_dev": [port["cost"]["bytes_per_dev"], ref["bytes_per_dev"]],
            "collective_bytes_per_dev": [port["collectives"]["total_bytes_per_dev"],
                                         ref["collective_bytes_per_dev"]],
            "coll_bytes_by_kind": [port["collectives"]["bytes_by_kind"],
                                   ref["coll_bytes_by_kind"]],
            "coll_count_by_kind": [port["collectives"]["count_by_kind"],
                                   ref["coll_count_by_kind"]],
        }))


if __name__ == "__main__":
    main()
