"""Per-device FLOPs, HBM bytes, collective bytes and memory of one step,
and the three roofline terms.

Answers to ``repro/launch/hlo.py``.  The reference parses the compiled
HLO text of a jitted step (``analyze_module``) and multiplies each
``while`` body by its trip count.  Eager PyTorch has no compiled module;
here the step runs once, on fake tensors, under ``StepCounter``, a
``TorchDispatchMode`` that sits below DTensor (as
``launch/mesh.CollectiveLog`` does: an op on DTensors passes through to
DTensor, and the counter sees the ops DTensor runs on one rank's local
shards and the collectives its redistributions issue).  Every op is a
kernel in eager PyTorch, so the reference's fusion-boundary rule becomes
one rule an op, and loops (the layers, the attention chunks, gradient
accumulation, remat's recompute) are counted as they run:

- FLOPs: ``torch.utils.flop_counter``'s formulas on the local shapes, for
  the products and convolutions it knows (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, the convolutions and their backward); the reference counts
  ``dot`` and ``convolution``, 2 numel(result) K each;
- HBM bytes: input plus output tensor bytes of every op that returns a
  tensor, except views, metadata ops (``METADATA``) and collectives;
- collectives: input bytes and counts by the reference's kind names
  (``all-gather``, ``reduce-scatter``, ``all-reduce``, ``all-to-all``),
  recognised as ``CollectiveLog`` recognises them, whose (op, mesh axis,
  bytes) calls the counter keeps as well;
- memory: the bytes of the live local storages, each counted once from
  the op that made it to the moment it is freed (a weakref finalizer on
  the storage), and their peak over the run.

DTensor derives an op's output shape by running the op once on fake
tensors of the global shapes (``ShardingPropagator.
_propagate_tensor_meta_non_cached``, the first time it meets that op and
those shapes); those ops reach the counter too, and it skips them (the
Python stack tells: ``PROPAGATION``).

All numbers are one rank's.  ``ModuleStats`` carries the reference's
fields.

The roofline constants are the NVIDIA H100 SXM's datasheet figures (989
TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink 4 at 450 GB/s a direction), in
place of the reference's TPU v5e ones.  ``roofline_terms`` gives modelled
times from counts, not measurements.
"""
from __future__ import annotations

import sys
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._pytree import tree_leaves

from . import mesh as mesh_mod

# ---------------------------------------------------------------------------
# hardware constants (NVIDIA H100 SXM datasheet) + roofline terms

DEVICE = "NVIDIA H100 SXM"
PEAK_FLOPS = 989e12  # dense bf16 FLOP/s per card
HBM_BW = 3.35e12  # HBM3 bytes/s
ICI_BW = 450e9  # NVLink 4 bytes/s a direction


def roofline_terms(flops_per_dev: float, bytes_per_dev: float, coll_bytes_per_dev: float):
    t_c = flops_per_dev / PEAK_FLOPS
    t_m = bytes_per_dev / HBM_BW
    t_x = coll_bytes_per_dev / ICI_BW
    bound = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))[1]
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x, "bound": bound}


def model_flops(cfg, spec, n_total: int, n_active: int) -> float:
    """6·N·D (train) / 2·N_active·D (inference), whole step over all chips."""
    tokens = spec.global_batch * (spec.seq_len if spec.kind != "decode" else 1)
    n = n_active if cfg.moe_num_experts else n_total
    if spec.kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens


# ---------------------------------------------------------------------------
# the counter

# ops that return a tensor but move no tensor data (besides views; an op
# that returns no tensor, such as ``prim.device`` or ``sym_size``, is a
# query and moves none either)
METADATA = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "wait_tensor",
    "lift_fresh", "resize_", "set_", "_unsafe_view",
})


def kind_of(op: str) -> str:
    """The reference's kind name of a functional collective's op name."""
    for prefix, kind in (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
                         ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
                         ("shard_dim_alltoall", "all-to-all")):
        if op.startswith(prefix):
            return kind
    return op


@dataclass
class ModuleStats:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes_by_kind: dict = field(default_factory=dict)
    coll_count_by_kind: dict = field(default_factory=dict)

    @property
    def collective_bytes(self) -> float:
        return sum(self.coll_bytes_by_kind.values())


# DTensor's functions that run an op on global-shape fake tensors to learn
# its output's shape: ops under them are no rank's work
PROPAGATION = frozenset({"_propagate_tensor_meta_non_cached"})


def _in_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name in PROPAGATION:
            return True
        f = f.f_back
    return False


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _local_tensors(tree):
    """The tensors under ``tree``, a DTensor as its local shard."""
    from torch.distributed.tensor import DTensor

    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            yield t


class StepCounter(mesh_mod.CollectiveLog):
    """``with StepCounter(mesh) as c: step(...)``; then ``c.stats`` (a
    ``ModuleStats``), ``c.calls`` (``CollectiveLog``'s), ``c.live_bytes``
    and ``c.peak_bytes``.  ``track(tree)`` counts the storages of tensors
    made before the run (the step's arguments) among the live ones and
    returns their bytes, each storage once."""

    def __init__(self, mesh):
        super().__init__(mesh)
        self.stats = ModuleStats()
        self._live: dict[int, int] = {}  # id of a live storage -> its bytes
        self.live_bytes = self.peak_bytes = 0

    def track(self, tree) -> int:
        added = sum(self._track(t) for t in _local_tensors(tree))
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return added

    @staticmethod
    def storage_bytes(tree) -> int:
        """The bytes of the distinct local storages under ``tree``."""
        storages = (t.untyped_storage() for t in _local_tensors(tree))
        return sum({id(st): st.nbytes() for st in storages}.values())

    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return 0
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if _in_propagation():
            return func(*args, **kwargs)
        call = self.log(func, args)
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        st = self.stats
        if call is not None:
            kind = kind_of(call[0])
            st.coll_bytes_by_kind[kind] = st.coll_bytes_by_kind.get(kind, 0) + call[2]
            st.coll_count_by_kind[kind] = st.coll_count_by_kind.get(kind, 0) + 1
        else:
            if func._overloadpacket in flop_registry:
                st.flops += flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
            if outs and not func.is_view and func._opname not in METADATA:
                st.hbm_bytes += _nbytes((args, kwargs)) + _nbytes(outs)
        for t in outs:
            self._track(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out
