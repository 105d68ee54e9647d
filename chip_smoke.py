#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase is caught, nothing falls back to
the CPU):

1. device: the card's name, the device count, and
   ``nvidia-smi --query-gpu=name,power.limit``;
2. build: every CUDA kernel of the port, from ``src/repro_torch/kernels/csrc``,
   one nvcc per source;
3. kernels against their plain versions on the card, at ragged shapes,
   C=1, G=1 and at the kernel bench's C=16, L=131072 in bf16 and f32;
4. the main path at full width: the README quickstart (400-node overlay,
   16 workers, 4,000 samples, MLP 32-64-8, 8 rounds, kill the master,
   1 more round) and 2 rounds of a CNN app (16x16x1, channels 16/32),
   with every launch counter set to 0 just before and read just after;
   then the kernel against its plain version at every tree-level
   (G, C, L) the main path ran, and the same seeds on the CPU through
   the plain versions, compared with the card's run;
5. times: each kernel's device time (a CUDA graph of calls between CUDA
   events) beside its byte bound, its plain version and one PyTorch call
   computing the same function, at every tree-level shape of the main
   path and at the bench shape; the round time on the host clock; and
   the device's busy share of a steady round under torch.profiler.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Exits non-zero, and
prints no result, without a CUDA card or without the repository's
``src/`` beside it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

TOL = {"rtol": 1e-5, "atol": 1e-5}  # the JAX package's own kernel tolerance
# card vs CPU after 36 SGD steps: matmul and conv reduction orders differ
PATH_TOL = {"rtol": 1e-4, "atol": 1e-5}

KERNELS = [
    {
        "name": "tree_aggregate_groups",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tree_aggregate.cu",
        "replaces": "src/repro/kernels/tree_aggregate.py:119",
    },
]


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def check_tree_aggregate(torch, ta, ref, shapes) -> float:
    """Kernel vs plain version at every (G, C, L, dtype); ragged groups
    get zero rows with zero weights in their padding slots."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for G, C, L, dtype in shapes:
        x = torch.randn(G, C, L, device="cuda", generator=gen).to(dtype)
        w = torch.rand(G, C, device="cuda", generator=gen)
        if C > 1:  # ragged: group g keeps C - (g % C) real children
            for g in range(G):
                real = C - (g % C)
                x[g, real:] = 0
                w[g, real:] = 0
        out = ta.tree_aggregate_groups(x, w)
        torch.cuda.synchronize()
        want = ref.tree_aggregate_groups_ref(x, w)
        err = (out - want).abs()
        ok = bool((err <= TOL["atol"] + TOL["rtol"] * want.abs()).all())
        worst = max(worst, float(err.max()))
        log(f"  tree_aggregate_groups G={G} C={C} L={L} {str(dtype)[6:]}: "
            f"max_abs_err={float(err.max()):.3e} (rtol={TOL['rtol']}, atol={TOL['atol']}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("tree_aggregate_groups disagrees with its plain version")
    return worst


# ---------------------------------------------------------------------------
# phase 4: the main path


def drive_main_path(device: str) -> dict:
    """The README quickstart, then 2 rounds of a CNN app, on ``device``."""
    import torch

    from repro_torch import data
    from repro_torch.convert import params_to_numpy
    from repro_torch.core.api import TotoroSystem
    from repro_torch.fl import rounds

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    rec = {"losses": [], "cnn_losses": [], "levels": [], "round_ms": [], "accs": []}
    system = TotoroSystem(zone_bits=2, suffix_bits=24, seed=0)
    rng = np.random.default_rng(0)
    nodes = [
        system.Join("10.0.0.1", 9000 + i, site=i % 4, coord=rng.uniform(0, 100, 2))
        for i in range(400)
    ]
    x, y = data.synthetic_classification(4000, dim=32, num_classes=8, seed=0)
    parts = data.dirichlet_partition(y, num_clients=16, alpha=0.5, seed=1)
    workers = [int(w) for w in rng.choice(nodes, size=16, replace=False)]
    app = rounds.make_app(
        system, "quickstart-classifier", workers=workers,
        data_by_worker={w: (x[parts[i]], y[parts[i]]) for i, w in enumerate(workers)},
        dim=32, num_classes=8, local_steps=4, lr=0.2, mu=0.01, device=device,
    )

    def one_round(a, key):
        sync()
        t0 = time.perf_counter()
        m = rounds.run_round(system, a)
        sync()
        rec["round_ms"].append((time.perf_counter() - t0) * 1e3)
        rec[key].append(m["loss"])
        L = sum(int(v.numel()) for v in a.params.values())
        rec["levels"] += [
            (lv["groups"], lv["children"], L, lv["bytes"], lv["time_ms"])
            for lv in m["agg_levels"]
        ]
        return m

    for _ in range(8):
        one_round(app, "losses")
        rec["accs"].append(rounds.evaluate(app, x[:500], y[:500]))
    old = app.handle.tree.root
    report = system.fail_nodes(app.handle.app_id, [old])
    rec["new_master"] = report.new_master
    one_round(app, "losses")
    rec["params"] = params_to_numpy(app.params)

    xc, yc = data.synthetic_classification(4000, dim=256, num_classes=8, seed=2)
    xc = xc.reshape(-1, 16, 16, 1)
    parts_c = data.dirichlet_partition(yc, num_clients=16, alpha=0.5, seed=3)
    workers_c = [int(w) for w in rng.choice(nodes, size=16, replace=False)]
    cnn = rounds.make_app(
        system, "quickstart-cnn", workers=workers_c, model="cnn",
        data_by_worker={w: (xc[parts_c[i]], yc[parts_c[i]]) for i, w in enumerate(workers_c)},
        num_classes=8, local_steps=4, lr=0.1, seed=1, device=device,
    )
    for _ in range(2):
        one_round(cnn, "cnn_losses")
    rec["cnn_params"] = params_to_numpy(cnn.params)
    rec["live"] = (system, app)  # for the profiled rounds after the comparison
    rec["sizes"] = {
        "mlp": sum(int(v.numel()) for v in app.params.values()),
        "cnn": sum(int(v.numel()) for v in cnn.params.values()),
    }
    return rec


def compare(name, a, b, tol) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = float(np.abs(a - b).max())
    if not np.allclose(a, b, **tol):
        raise SystemExit(f"{name}: card and CPU runs disagree (max abs {err:.3e}, {tol})")
    return err


# ---------------------------------------------------------------------------
# phase 5: times


def device_ms(torch, fn, calls: int = 50, replays: int = 20) -> float:
    """Device time of one call: ``calls`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events.  The graph takes the
    host's per-call cost out, so this is the kernels' own time (inputs
    that fit stay in L2, as a tree level's freshly stacked rows do)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def eager_ms(torch, fn, iters: int = 200, warmup: int = 20) -> float:
    """Time of one call as the main path makes it, host cost included:
    CUDA events around ``iters`` back-to-back eager calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_tree_aggregate(torch, ta, ref, G, C, L, dtype) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(G, C, L, device="cuda", generator=gen).to(dtype)
    w = torch.rand(G, C, device="cuda", generator=gen)
    nbytes = G * C * L * x.element_size() + G * C * 4 + G * L * 4
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = 2 * G * C * L / F32_FLOPS * 1e3
    before = ta.launches
    ms = device_ms(torch, lambda: ta.tree_aggregate_groups(x, w))
    call_ms = eager_ms(torch, lambda: ta.tree_aggregate_groups(x, w))
    ta.launches = before  # timing launches are not main-path launches
    row = {
        "shape": [G, C, L], "dtype": str(dtype)[6:], "ms": ms,
        "plain_ms": device_ms(torch, lambda: ref.tree_aggregate_groups_ref(x, w)),
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "library_ms": None, "eager_call_ms": call_ms, "bytes": nbytes,
        "GBps": nbytes / (ms * 1e-3) / 1e9,
    }
    if dtype == torch.float32:  # one library call: einsum (a batched GEMV via bmm)
        row["library_ms"] = device_ms(torch, lambda: torch.einsum("gc,gcl->gl", w, x))
    else:  # einsum needs one dtype: the bf16 input is widened first (two calls)
        row["einsum_of_widened_ms"] = device_ms(
            torch, lambda: torch.einsum("gc,gcl->gl", w, x.float())
        )
    return row


def profile_rounds(torch, system, app, n: int = 3) -> dict:
    """Steady quickstart rounds under torch.profiler: the device's busy
    and idle share of the round and its costliest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fl import rounds

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            rounds.run_round(system, app)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3 / n
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "round_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "top_device": [
            (e.key[:60], e.count // n, e.self_device_time_total / 1e3 / n) for e in top
        ],
        "tree_aggregate_device_ms": sum(
            e.self_device_time_total for e in dev if "group_sum" in e.key
        ) / 1e3 / n,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import tree_aggregate as ta

    # -- 1. device ------------------------------------------------------------
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"[1 device] {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[1 device] nvidia-smi: {smi}")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    for name in sources:
        _build.load(name)
    log(f"[2 build] {sources} in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # -- 3. kernels against their plain versions -----------------------------
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [
        (3, 5, 333, f32), (3, 5, 333, bf16),      # ragged groups, L % 1024 != 0
        (1, 1, 1, f32), (4, 1, 1029, bf16),       # C = 1
        (1, 7, 4097, f32),                         # G = 1
        (1, 16, 131072, bf16), (1, 16, 131072, f32),  # kernel bench shape
    ]
    max_err = check_tree_aggregate(torch, ta, ref, shapes)
    torch.cuda.synchronize()
    log(f"[3 kernels] tree_aggregate_groups max_abs_err={max_err:.3e} over {len(shapes)} shapes")

    # -- 4. main path at full width ------------------------------------------
    # The CPU comparison below runs in full f32; cuDNN's convolutions would
    # otherwise run the CNN in TF32 (about 3 decimal digits), and matmuls
    # are kept from it too, so the card and the CPU compute the same function.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ta.launches = 0
    t0 = time.perf_counter()
    gpu = drive_main_path("cuda")
    torch.cuda.synchronize()
    launches = ta.launches
    wall = time.perf_counter() - t0
    n_levels = len(gpu["levels"])
    log(f"[4 main path] quickstart losses: {[round(l, 4) for l in gpu['losses']]}")
    log(f"[4 main path] quickstart accuracy after each of 8 rounds: {gpu['accs']}")
    log(f"[4 main path] master failed -> new master {hex(gpu['new_master'])}")
    log(f"[4 main path] CNN losses: {gpu['cnn_losses']}; params L: {gpu['sizes']}")
    log(f"[4 main path] tree levels (G, C, L): {[lv[:3] for lv in gpu['levels']]}")
    log(f"[4 main path] tree_aggregate_groups launches={launches} for {n_levels} levels; "
        f"{wall:.2f} s wall")
    if launches == 0 or launches != n_levels:
        raise SystemExit(f"expected {n_levels} kernel launches on the main path, saw {launches}")
    if not gpu["losses"][-1] < gpu["losses"][0] or not gpu["cnn_losses"][-1] < gpu["cnn_losses"][0]:
        raise SystemExit("loss did not fall")
    level_shapes = sorted({lv[:3] for lv in gpu["levels"]})
    level_err = check_tree_aggregate(torch, ta, ref, [(*s, f32) for s in level_shapes])
    max_err = max(max_err, level_err)
    log(f"[4 main path] tree_aggregate_groups max_abs_err={level_err:.3e} over "
        f"{len(level_shapes)} main-path level shapes")
    cpu = drive_main_path("cpu")
    errs = {
        "quickstart_loss": compare("quickstart loss", gpu["losses"], cpu["losses"], PATH_TOL),
        "cnn_loss": compare("cnn loss", gpu["cnn_losses"], cpu["cnn_losses"], PATH_TOL),
    }
    for k in gpu["params"]:
        errs[f"mlp.{k}"] = compare(f"mlp {k}", gpu["params"][k], cpu["params"][k], PATH_TOL)
    for k in gpu["cnn_params"]:
        errs[f"cnn.{k}"] = compare(f"cnn {k}", gpu["cnn_params"][k], cpu["cnn_params"][k], PATH_TOL)
    if gpu["levels"] != cpu["levels"] or gpu["new_master"] != cpu["new_master"]:
        raise SystemExit("control plane differs between the card and CPU runs")
    log(f"[4 main path] card vs CPU max abs diff {json.dumps(errs)} ({PATH_TOL})")

    # -- 5. times -------------------------------------------------------------
    rows = [time_tree_aggregate(torch, ta, ref, g, c, l, f32) for g, c, l in level_shapes]
    main_row = max(rows, key=lambda r: r["bytes"])  # the main path's largest level
    rows += [  # the kernel bench's shape, then a streaming size far past L2
        time_tree_aggregate(torch, ta, ref, 1, 16, 131072, bf16),
        time_tree_aggregate(torch, ta, ref, 1, 16, 131072, f32),
        time_tree_aggregate(torch, ta, ref, 1, 16, 1 << 22, bf16),
        time_tree_aggregate(torch, ta, ref, 1, 16, 1 << 22, f32),
    ]
    for r in rows:
        log(f"[5 times] tree_aggregate_groups {json.dumps(r)}")
    prof = profile_rounds(torch, *gpu["live"])
    log(f"[5 times] quickstart round under torch.profiler: {json.dumps(prof)}")
    rms = gpu["round_ms"]
    log(f"[5 times] quickstart round ms (host clock to synchronize): first={rms[0]:.3f} "
        f"steady_mean={float(np.mean(rms[1:9])):.3f} all={[round(t, 3) for t in rms]}")
    log(f"[5 times] card: {smi}")

    KERNELS[0].update(
        launches=launches, max_abs_err=max_err, ms=main_row["ms"],
        plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
        bound_by=main_row["bound_by"], library_ms=main_row["library_ms"],
    )
    log(smi)
    log(json.dumps({"kernels": KERNELS}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
