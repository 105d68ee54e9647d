"""Crash-safe full dry-run sweep: every (arch x runnable shape x mesh) cell,
one subprocess per cell, JSONL output.

Answers to ``repro/launch/sweep.py``: each cell runs
``launch/dryrun.run_cell`` in a subprocess of its own (a fake process
group of 256 or 512 ranks, no card), and appends its record, or one with
``error`` (the end of the subprocess's output) when it fails, to
``--out`` (default ``build/dryrun/dryrun.jsonl``).  ``--skip-done`` skips
the cells already recorded without an error.

  python -m repro_torch.launch.sweep [--arch tinyllama-1.1b] [--mesh both] [--skip-done]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/dryrun/dryrun.jsonl")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--arch", default=None, help="only this arch")
    args = ap.parse_args(argv)

    from .. import configs

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if args.skip_done and os.path.exists(args.out):
        for line in open(args.out):
            r = json.loads(line)
            if "error" not in r:
                done.add((r["arch"], r["shape"], r["mesh"]))

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    cells = []
    for arch in configs.ARCH_IDS:
        if args.arch and arch != args.arch:
            continue
        for shape in configs.runnable_cells(arch):
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                if (arch, shape, mesh_name) not in done:
                    cells.append((arch, shape, mp))

    print(f"sweep: {len(cells)} cells to run", flush=True)
    env = dict(os.environ, PYTHONPATH=SRC)
    for i, (arch, shape, mp) in enumerate(cells):
        t0 = time.time()
        code = (
            "import json\n"
            "from repro_torch.launch.dryrun import run_cell\n"
            f"r = run_cell({arch!r}, {shape!r}, multi_pod={mp}, quiet=True)\n"
            "print('RESULT_JSON:' + json.dumps(r))\n"
        )
        try:
            p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                               env=env, timeout=3600)
            stdout, stderr = p.stdout, p.stderr
        except subprocess.TimeoutExpired:
            stdout, stderr = "", "timed out after 3600 s"
        rec = None
        for line in stdout.splitlines():
            if line.startswith("RESULT_JSON:"):
                rec = json.loads(line[len("RESULT_JSON:"):])
        if rec is None:
            rec = {
                "arch": arch, "shape": shape,
                "mesh": "2x16x16" if mp else "16x16",
                "error": (stderr or stdout)[-2000:],
            }
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        status = "FAIL" if "error" in rec else rec["roofline"]["bound"]
        print(
            f"[{i+1}/{len(cells)}] {arch} x {shape} x {'multi' if mp else 'single'}: "
            f"{status} ({time.time()-t0:.0f}s)",
            flush=True,
        )


if __name__ == "__main__":
    main()
