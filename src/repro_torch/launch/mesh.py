"""Production meshes as ``torch.distributed`` ``DeviceMesh``es.

Answers to ``repro/launch/mesh.py``: the same shapes and axis names.
Functions, not module constants, so importing this module touches no
device and no process group.  A mesh needs the default process group of
as many ranks as it has devices (``torch.distributed.init_process_group``
with its address, world size and rank); ``DeviceMesh`` then makes one
process group per mesh axis, and ``mesh.get_group("pod")`` is the
cross-zone group that ``fl/hierarchy`` aggregates over.

The wire on one card.  NCCL takes one rank a device, so ranks that share
one card talk over gloo.  gloo's collectives are the CPU's: on CUDA
tensors its all-reduce runs, but its all-gather into one tensor kills the
process (SIGSEGV on the H100, torch 2.11; PERF.md §6).  A CUDA mesh over a
gloo default group therefore stages every functional collective, the ones
DTensor issues, through pinned host buffers (``stage_through_host``): each
gets a CUDA kernel that copies its input to a pinned host buffer, runs the
same collective there over gloo, and copies the result back to the card.
The compute stays on the card; a functional collective with no staged
form raises.  ``fl/hierarchy`` stages its own all_gather the same way.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

# the functional collectives DTensor issues, staged through the host; the
# namespace's other collectives raise on a CUDA tensor
STAGED = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce", "all_to_all_single")
COLLECTIVES = STAGED + (
    "all_gather_into_tensor_out", "all_gather_into_tensor_coalesced", "reduce_scatter_tensor_out",
    "reduce_scatter_tensor_coalesced", "all_reduce_", "all_reduce_coalesced",
    "all_reduce_coalesced_", "broadcast", "broadcast_", "isend", "irecv", "batch_p2p_ops")
_LIB: list = []  # the torch.library registration, kept alive once made


# host time and bytes of the staged collectives in this process, by op:
# {name: [calls, seconds, bytes in]}; ``wire_stats`` reads, ``reset_wire`` clears
WIRE: dict[str, list] = {}


def wire_stats() -> dict:
    return {k: {"calls": c, "seconds": t, "bytes": b} for k, (c, t, b) in WIRE.items()}


def reset_wire() -> None:
    WIRE.clear()


def _pinned(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _staged(name: str, ns: str = "_c10d_functional"):
    op = getattr(getattr(torch.ops, ns), name).default

    def run(input, *args):
        t0 = time.perf_counter()
        out = torch.ops._c10d_functional.wait_tensor(op(_pinned(input), *args))
        out = out.to(input.device)
        rec = WIRE.setdefault(name, [0, 0.0, 0])
        rec[0] += 1
        rec[1] += time.perf_counter() - t0
        rec[2] += input.numel() * input.element_size()
        return out

    return run


def _refused(name: str):
    def run(*args, **kwargs):
        raise RuntimeError(f"_c10d_functional.{name} on a CUDA tensor over gloo has no staged "
                           f"form (launch/mesh.STAGED)")

    return run


def stage_through_host() -> None:
    """Give each ``_c10d_functional`` collective (``COLLECTIVES``) a CUDA
    kernel: those in ``STAGED`` run on a pinned host copy of their input (the CPU kernel,
    over the group's gloo backend) and copy the result back; the others
    raise; DTensor's ``_dtensor.shard_dim_alltoall`` is staged too.  Their
    own kernels are CompositeExplicitAutograd, so the CUDA key takes
    precedence and the host call reaches the original.  Made once a
    process."""
    if _LIB:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for full in torch._C._dispatch_get_all_op_names():
        ns, _, name = full.partition("::")
        if ns == "_c10d_functional" and name in COLLECTIVES:
            lib.impl(name, _staged(name) if name in STAGED else _refused(name), "CUDA")
    # DTensor's Shard(i) -> Shard(j) all-to-all has an op of its own
    dlib = torch.library.Library("_dtensor", "IMPL")
    dlib.impl("shard_dim_alltoall", _staged("shard_dim_alltoall", "_dtensor"), "CUDA")
    _LIB.extend([lib, dlib])


def _mk(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks 0 .. n - 1
    in row-major order; ``device_type`` "cpu" for a gloo CPU group.  A CUDA
    mesh over a gloo default group stages its collectives through the host
    (``stage_through_host``)."""
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == "cuda" and dist.get_backend() == "gloo":
        stage_through_host()
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 chips/pod; multi_pod: 2 pods = 512 chips."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes)


def make_test_mesh(*, multi_pod: bool = False):
    """Small mesh for integration tests (8 ranks)."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def num_pods(mesh) -> int:
    return mesh_axis_sizes(mesh).get("pod", 1)


class CollectiveLog(TorchDispatchMode):
    """A dispatch mode that logs every functional collective (the ones
    DTensor issues) as (op, mesh axis, bytes in): ``with CollectiveLog(mesh)
    as log: ...``, then ``log.calls`` and ``log.summary()``.  Ops on
    DTensors pass through to DTensor, so the log sees the collectives their
    redistributions issue (as ``CommDebugMode`` counts them), each once; a
    group that is none of ``mesh``'s axes is logged by its name."""

    def __init__(self, mesh):
        super().__init__()
        self.axis = {mesh.get_group(d).group_name: d for d in mesh.mesh_dim_names}
        self.calls: list[tuple] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if ((func.namespace == "_c10d_functional" and func._opname in COLLECTIVES)
                or (func.namespace == "_dtensor" and func._opname == "shard_dim_alltoall")):
            group = args[-1] if isinstance(args[-1], str) else args[-1].group_name
            self.calls.append((func._opname, self.axis.get(group, group),
                               args[0].numel() * args[0].element_size()))
        return func(*args, **(kwargs or {}))

    def summary(self) -> dict:
        """{"op/axis": {"count", "bytes"}} over the logged calls."""
        out: dict = {}
        for op, axis, nbytes in self.calls:
            rec = out.setdefault(f"{op}/{axis}", {"count": 0, "bytes": 0})
            rec["count"] += 1
            rec["bytes"] += nbytes
        return out
