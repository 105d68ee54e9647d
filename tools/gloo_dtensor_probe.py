"""Which of DTensor's redistributions gloo carries on CUDA tensors (card only).

Four ranks share the one card over a gloo group (NCCL takes one rank a
device) with a (2, 2) ("data", "model") mesh.  Each redistribution runs
twice:

- raw: in its own four freshly spawned ranks, the collective going to
  gloo's CUDA path as it is (a refused one may kill its ranks, so each
  gets its own spawn);
- staged: all of them in one spawn, through ``launch/mesh.stage_through_host``
  (pinned host buffers), each result checked against the value the
  redistribution must give.

Prints one JSON object (also written to ``chiprun_out/gloo_probe.json``):
per redistribution, the raw outcome ("ok", "raised: ...", or the signal or
exit code that ended a rank), the staged outcome, and the collectives
``CommDebugMode`` counted.

    python3 tools/gloo_dtensor_probe.py [--staged]

``--staged`` runs the staged half alone.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

WORLD = 4
CASES = ["Partial->Replicate", "Shard(0)->Replicate", "Shard(1)->Replicate",
         "Partial->Shard(0)", "Partial(max)->Replicate", "Shard(1)->Shard(2)"]


def _case(name: str, rank: int, mesh):
    """(the redistributed tensor's local part, the value it must hold)."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    W = torch.arange(48.0, device="cuda").reshape(8, 6)
    R2 = [Replicate(), Replicate()]
    data, model = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    if name == "Partial->Replicate":
        t = DTensor.from_local(torch.full((4, 6), rank + 1.0, device="cuda"), mesh,
                               [Partial(), Partial()])
        return t.redistribute(mesh, R2).to_local(), torch.full((4, 6), 10.0, device="cuda")
    if name == "Shard(0)->Replicate":
        t = distribute_tensor(W, mesh, [Shard(0), Replicate()], src_data_rank=None)
        return t.redistribute(mesh, R2).to_local(), W
    if name == "Shard(1)->Replicate":
        t = distribute_tensor(W, mesh, [Replicate(), Shard(1)], src_data_rank=None)
        return t.redistribute(mesh, R2).to_local(), W
    if name == "Partial->Shard(0)":
        t = DTensor.from_local(W * (rank + 1), mesh, [Partial(), Replicate()])
        want = (W * (1 + model) + W * (3 + model)).chunk(2, 0)[data]
        return t.redistribute(mesh, [Shard(0), Replicate()]).to_local(), want
    if name == "Partial(max)->Replicate":
        t = DTensor.from_local(torch.full((3,), float(rank), device="cuda"), mesh,
                               [Partial("max"), Partial("max")])
        return t.redistribute(mesh, R2).to_local(), torch.full((3,), 3.0, device="cuda")
    if name == "Shard(1)->Shard(2)":
        full = torch.arange(64.0, device="cuda").reshape(2, 4, 8)
        t = distribute_tensor(full, mesh, [Replicate(), Shard(1)], src_data_rank=None)
        return (t.redistribute(mesh, [Replicate(), Shard(2)]).to_local(),
                full.chunk(2, 2)[model])
    raise ValueError(name)


def _rank(rank: int, tmp: str, names: list, staged: bool) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch import mesh as mesh_mod

    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=WORLD)
    torch.cuda.set_device(0)
    try:
        if staged:
            mesh = mesh_mod._mk((2, 2), ("data", "model"))
        else:  # the mesh without the staged wire
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
        out = {}
        for name in names:
            try:
                with CommDebugMode() as cm:
                    got, want = _case(name, rank, mesh)
                torch.cuda.synchronize()
                ok = bool(torch.equal(got, want))
                out[name] = {"outcome": "ok" if ok else "wrong values",
                             "comms": {str(k): v for k, v in cm.get_comm_counts().items()}}
            except Exception as e:  # noqa: BLE001 - the probe records what gloo refuses
                out[name] = {"outcome": f"raised: {type(e).__name__}: {str(e)[:200]}"}
            Path(f"{tmp}/rank{rank}.json").write_text(json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(names: list, staged: bool, timeout_s: float = 120.0) -> dict:
    """Run ``names`` in four spawned ranks; rank 0's results, or how the
    ranks ended."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp()
    ctx = mp.start_processes(_rank, args=(tmp, names, staged), nprocs=WORLD,
                             start_method="spawn", join=False)
    t0, ended = time.time(), None
    try:
        while not ctx.join(timeout=2):
            if time.time() - t0 > timeout_s:
                ended = "timed out"
                break
    except Exception as e:  # noqa: BLE001 - a rank killed by the collective
        ended = f"a rank ended: {str(e)[:200]}"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    path = Path(f"{tmp}/rank0.json")
    got = json.loads(path.read_text()) if path.exists() else {}
    for name in names:
        got.setdefault(name, {"outcome": ended or "no result"})
    return got


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    result = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "card": torch.cuda.get_device_name(0), "world": WORLD, "mesh": [2, 2],
              "raw": {}, "staged": _spawn(CASES, staged=True)}
    if "--staged" not in sys.argv[1:]:
        for name in CASES:
            result["raw"].update(_spawn([name], staged=False))
    line = json.dumps(result)
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    (ROOT / "chiprun_out" / "gloo_probe.json").write_text(line)
    print(line)
    return 0 if all(v["outcome"] == "ok" for v in result["staged"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
