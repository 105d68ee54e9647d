"""Layer 3: the Totoro+ high-level API (paper Table II), on tensors.

Answers to ``repro/core/api.py``.  ``TotoroSystem`` wires the copied numpy
control plane (multi-ring overlay, pub/sub forest, failure recovery)
behind the paper's verbs: Join / CreateTree / Subscribe / Unsubscribe /
Broadcast / Aggregate + onBroadcast / onAggregate / onTimer callbacks.
Payloads are dicts of tensors; ``Aggregate`` runs the tree's level
schedule through the port's ``tree_aggregate_groups`` kernel, with every
level's state kept on the payload's device.  ``ApplyBuffered`` aggregates
a buffer of ``fl/compression.QuantizedDelta`` commits through the int8
instantiation of the same kernel, dequantizing inside the aggregation.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from . import recovery as recovery_mod
from .forest import DataflowTree, Forest
from .nodeid import IdSpace
from .overlay import MultiRingOverlay
from ..fl.compression import QuantizedDelta
from ..kernels import ops as kops
from ..kernels.tree_aggregate import staleness_weights
from ..pytree import leaves, ravel, tree_map, unravel_like


@dataclass(frozen=True)
class BufferedDelta:
    """One committed worker update waiting in the master's buffer."""

    worker: int
    delta: Any
    weight: float
    staleness: int


@dataclass
class AppHandle:
    app_id: int
    name: str
    tree: DataflowTree
    selection_fn: Callable[[int], bool] | None = None
    compress_fn: Callable | None = None
    decompress_fn: Callable | None = None
    aggregate_fn: Callable | None = None
    privacy_fn: Callable | None = None
    on_broadcast: Callable | None = None
    on_aggregate: Callable | None = None
    on_timer: Callable | None = None
    round_num: int = 0
    traffic_bytes: float = 0.0
    version: int = 0  # bumped by ApplyBuffered (async model version)
    # weighted-fair transport knobs (read by AsyncBufferScheduler):
    # the app's share of a contended uplink is proportional to
    # transfer_weight, and rate_cap_mbps bounds the app's AGGREGATE
    # rate on any single uplink (concurrent same-uplink flows split
    # both the share and the cap); both must be > 0
    transfer_weight: float = 1.0
    rate_cap_mbps: float | None = None
    # commit-direction compression policy (fl/compression.CompressionPolicy
    # or None): the async trainer quantizes delta uploads under it and the
    # scheduler prices commit flows at policy.wire_bytes(model_bytes)
    compression: Any | None = None
    buffer: list[BufferedDelta] = field(default_factory=list)
    # per-apply telemetry appended by ApplyBuffered
    round_records: list[dict] = field(default_factory=list)


class TotoroSystem:
    def __init__(
        self,
        *,
        zone_bits: int = 4,
        suffix_bits: int = 32,
        base_bits: int = 4,
        replicas: int = 2,
        seed: int = 0,
    ):
        self.space = IdSpace(zone_bits, suffix_bits)
        self.overlay = MultiRingOverlay(self.space, base_bits=base_bits, seed=seed)
        self.forest = Forest(self.overlay)
        self.replicas = recovery_mod.ReplicaStore(k=replicas)
        self.apps: dict[int, AppHandle] = {}

    # -- Table II verbs -------------------------------------------------------

    def Join(self, ip: str, port: int, site: int, *, coord=(0.0, 0.0), bandwidth=100.0) -> int:
        """Edge node joins the DHT-based P2P overlay network."""
        del ip, port  # transport is simulated; identity = NodeId
        return self.overlay.join_random(site % self.space.num_zones, coord, bandwidth)

    def CreateTree(self, app_name: str, *, restrict_zone=None, fanout_bits=None, **hooks) -> AppHandle:
        """Application owner creates a dataflow tree (+ configures hooks).
        ``fanout_bits`` is per-tree: it changes only this app's JOIN
        routing (digit base 2^b), never the shared overlay tables."""
        tree = self.forest.create_tree(
            app_name, restrict_zone=restrict_zone, fanout_bits=fanout_bits
        )
        h = AppHandle(app_id=tree.app_id, name=app_name, tree=tree, **hooks)
        self.apps[tree.app_id] = h
        return h

    def Subscribe(self, app_id: int, node: int) -> bool:
        """JOIN a dataflow tree; the owner's selection_fn can reject."""
        h = self.apps[app_id]
        if h.selection_fn is not None and not h.selection_fn(node):
            return False
        self.forest.subscribe(app_id, node)
        return True

    def SubscribeMany(self, app_id: int, nodes) -> list[int]:
        """Bulk JOIN through the owner's selection_fn (tree identical to a
        ``Subscribe`` loop).  Returns the admitted node ids in input order."""
        h = self.apps[app_id]
        accepted = [int(n) for n in nodes]
        if h.selection_fn is not None:
            accepted = [n for n in accepted if h.selection_fn(n)]
        if accepted:
            self.forest.subscribe_many(app_id, accepted)
        return accepted

    def Unsubscribe(self, app_id: int, node: int) -> None:
        self.forest.unsubscribe(app_id, node)

    def UnsubscribeMany(self, app_id: int, nodes) -> None:
        """Bulk LEAVE (tree identical to an ``unsubscribe_one`` loop)."""
        self.forest.unsubscribe_many(app_id, nodes)

    def Regraft(self, app_id: int, moves, *, strict: bool = True) -> list[tuple[int, int]]:
        """Batched re-graft of ``(node, new_parent)`` subtrees; returns the
        applied pairs."""
        return self.forest.regraft_many(app_id, moves, strict=strict)

    def Broadcast(self, app_id: int, obj: Any) -> dict:
        """Master disseminates a model (or AppIds) down the tree."""
        h = self.apps[app_id]
        payload = h.compress_fn(obj) if h.compress_fn else obj
        nbytes = _nbytes(payload)
        tree = h.tree
        n_edges = len(tree.parent)
        h.traffic_bytes += nbytes * n_edges
        time_ms = tree.broadcast_time(self.overlay, payload_ms=0.0)
        if h.on_broadcast:
            received = h.decompress_fn(payload) if h.decompress_fn else payload
            for w in sorted(tree.members):
                h.on_broadcast(app_id, w, received)
        return {"time_ms": time_ms, "bytes": nbytes * n_edges, "edges": n_edges}

    def Aggregate(
        self,
        app_id: int,
        objects: dict[int, Any],
        weights=None,
        *,
        hierarchical: bool = True,
        use_kernel: bool = True,
    ) -> dict:
        """Aggregate worker updates up the tree, level-by-level.

        The default path executes the dataflow tree's aggregation schedule
        bottom-up, each level one ``tree_aggregate_groups`` launch over all
        its (parent, children) groups; the result is the hierarchy's
        weighted mean (float64, divided once at the root).  A custom
        ``aggregate_fn`` hook (or ``hierarchical=False``) takes the flat
        reference reduction.
        """
        h = self.apps[app_id]
        tree = h.tree
        weights = weights or {n: 1.0 for n in objects}
        payload = objects
        if h.privacy_fn:
            payload = {n: h.privacy_fn(v) for n, v in payload.items()}

        if h.aggregate_fn is not None or not hierarchical or not payload:
            agg_fn = h.aggregate_fn or _weighted_mean
            result = agg_fn(list(payload.values()), [weights[n] for n in payload])
            nbytes = sum(_nbytes(v) for v in payload.values())
            time_ms = tree.aggregation_time(self.overlay)
            levels: list[dict] = []
        else:
            result, levels = _aggregate_hierarchical(
                self.overlay, tree, payload, weights, use_kernel=use_kernel
            )
            nbytes = sum(lv["bytes"] for lv in levels)
            time_ms = sum(lv["time_ms"] for lv in levels)
        h.traffic_bytes += nbytes
        if h.on_aggregate:
            h.on_aggregate(app_id, result)
        return {"time_ms": time_ms, "bytes": nbytes, "result": result, "levels": levels}

    # -- async buffered verbs (FedBuff-style execution path) -------------------

    def CommitDelta(self, app_id: int, worker: int, delta: Any, *, weight: float = 1.0, staleness: int = 0) -> dict:
        """A worker commits its local update to the master's buffer.

        The delta travels the worker's tree path hop-by-hop (per-edge
        traffic, store-and-forward latency); privacy/compression hooks
        apply as on ``Aggregate``.  The staleness discount happens at
        apply time.
        """
        h = self.apps[app_id]
        payload = delta
        if h.privacy_fn:
            payload = h.privacy_fn(payload)
        wire = h.compress_fn(payload) if h.compress_fn else payload
        nbytes = _nbytes(wire)
        tree = h.tree
        if worker == tree.root or worker not in tree.parent:
            path = [worker]
        else:
            path = tree.path_to_root(worker)
        n_edges = len(path) - 1
        time_ms = self.overlay.path_latency(path)
        h.traffic_bytes += nbytes * n_edges
        received = h.decompress_fn(wire) if h.decompress_fn else payload
        h.buffer.append(
            BufferedDelta(worker=worker, delta=received, weight=float(weight), staleness=int(staleness))
        )
        return {
            "time_ms": time_ms,
            "bytes": nbytes * n_edges,
            "edges": n_edges,
            "buffered": len(h.buffer),
        }

    def ApplyBuffered(
        self,
        app_id: int,
        *,
        staleness_alpha: float = 0.5,
        min_k: int = 1,
        k: int | None = None,
        selector_scores: dict | None = None,
        transport: dict | None = None,
    ) -> dict:
        """Drain the buffer into one staleness-weighted aggregate.

        Weights ``w_i / (1 + staleness_i)^alpha`` ride the
        ``tree_aggregate_groups`` kernel's weight vector
        (``kernels.ops.buffered_aggregate``); a buffer of quantized
        commits goes through ``buffered_aggregate_quantized``, where each
        row scale composes with the discount in the kernel's weights.
        Returns ``result=None`` when fewer than ``min_k`` commits are
        buffered (buffer untouched).
        ``k``, ``selector_scores`` and ``transport`` are caller telemetry,
        recorded in ``round_records`` with every apply.
        """
        h = self.apps[app_id]
        if len(h.buffer) < max(1, min_k):
            return {"result": None, "arrivals": len(h.buffer), "version": h.version}
        entries, h.buffer = h.buffer, []
        quantized = [isinstance(e.delta, QuantizedDelta) for e in entries]
        if any(quantized) and not all(quantized):
            raise ValueError(
                "ApplyBuffered: mixed quantized and raw deltas in one buffer "
                "— an app's CompressionPolicy must cover every commit"
            )
        if h.aggregate_fn is not None:
            # custom aggregators see plain pytrees: dequantize up front
            deltas = [e.delta.dequantize() if q else e.delta
                      for e, q in zip(entries, quantized)]
            result = h.aggregate_fn(
                deltas,
                list(staleness_weights(
                    np.asarray([e.weight for e in entries], np.float64),
                    np.asarray([e.staleness for e in entries], np.float64),
                    staleness_alpha,
                )),
            )
            combined = None
        elif all(quantized) and entries:
            flat, combined = kops.buffered_aggregate_quantized(
                [e.delta.q for e in entries],
                [e.delta.scale for e in entries],
                [e.weight for e in entries],
                [e.staleness for e in entries],
                alpha=staleness_alpha,
            )
            result = entries[0].delta.unflatten(flat)
        else:
            result, combined = kops.buffered_aggregate(
                [e.delta for e in entries],
                [e.weight for e in entries],
                [e.staleness for e in entries],
                alpha=staleness_alpha,
            )
        h.version += 1
        stal = [e.staleness for e in entries]
        hist = np.bincount(np.asarray(stal, np.int64)).tolist() if entries else []
        stats = {
            "result": result,
            "arrivals": len(entries),
            "workers": [e.worker for e in entries],
            "staleness": stal,
            "staleness_hist": hist,  # hist[s] = commits applied at staleness s
            "weights": None if combined is None else [float(w) for w in combined],
            "version": h.version,
            "k": len(entries) if k is None else int(k),
        }
        h.round_records.append(
            {
                "version": h.version,
                "arrivals": len(entries),
                "k": stats["k"],
                "staleness_hist": hist,
                "selector_scores": selector_scores,
                "transport": transport,
            }
        )
        if h.on_aggregate:
            h.on_aggregate(app_id, result)
        return stats

    def Discover(self, node: int) -> dict[int, dict]:
        """AD-tree application discovery (journal addition, Appendix A)."""
        return self.forest.discover(node)

    def tick(self) -> None:
        """Periodic timer: fires owners' onTimer callbacks."""
        for h in self.apps.values():
            if h.on_timer:
                h.on_timer(h.app_id)

    # -- fault tolerance -------------------------------------------------------

    def replicate_master_state(self, app_id: int, state) -> list[int]:
        h = self.apps[app_id]
        return self.replicas.replicate(self.overlay, app_id, h.tree.root, state)

    def fail_nodes(self, app_id: int, nodes: list[int]):
        h = self.apps[app_id]
        return recovery_mod.fail_and_recover(
            self.overlay, self.forest, h.tree, nodes, replicas=self.replicas
        )


def _leaf_nbytes(x) -> int:
    return x.nbytes if isinstance(x, torch.Tensor) else np.asarray(x).nbytes


def _nbytes(obj) -> float:
    if hasattr(obj, "nbytes"):
        return float(obj.nbytes)
    try:
        return float(sum(_leaf_nbytes(x) for x in leaves(obj)))
    except (TypeError, ValueError):
        return float(len(str(obj)))


def _weighted_mean(values, weights):
    """Flat float64 weighted mean of update pytrees."""
    w = np.asarray(weights, np.float64)
    w = w / w.sum()

    def avg(*ls):
        return sum(float(wi) * torch.as_tensor(l).double() for wi, l in zip(w, ls))

    return tree_map(avg, *values)


def _aggregate_hierarchical(overlay, tree, payload, weights, *, use_kernel=True):
    """Execute the tree's aggregation schedule bottom-up.

    Each node carries a partial *weighted sum* of its subtree's updates
    (plus the subtree weight); every level is one kernel launch over its
    (parent, children) groups stacked as one (G, C, L) tensor on the
    payload's device, and the master divides once, in float64, at the
    root.  ``use_kernel=False`` sums each level in float64 instead.

    Returns (result pytree of float64 tensors, levels) where levels[i]
    records that level's group count, widest group (``children``),
    per-edge traffic and modeled latency.
    """
    first = next(iter(payload.values()))
    # node -> [partial weighted-sum vec, kernel weight, subtree weight]
    state: dict[int, list] = {
        n: [ravel(v), float(weights.get(n, 1.0)), float(weights.get(n, 1.0))]
        for n, v in payload.items()
    }
    some = next(iter(state.values()))[0]
    L, device = some.numel(), some.device
    vec_bytes = 4.0 * L
    levels: list[dict] = []

    def run_level(groups, depth):
        """groups: list of (parent, contributors) where each contributor is
        a node currently in `state`; executes them as one batched call."""
        cmax = max(len(c) for _, c in groups)
        zero = torch.zeros(L, dtype=torch.float32, device=device)
        rows, w = [], []
        for _, contrib in groups:
            rows += [state[c][0].float() for c in contrib] + [zero] * (cmax - len(contrib))
            w += [state[c][1] for c in contrib] + [0.0] * (cmax - len(contrib))
        g = torch.stack(rows).view(len(groups), cmax, L)
        wt = torch.tensor(w, dtype=torch.float32).view(len(groups), cmax).to(device)
        if use_kernel:
            out = kops.tree_aggregate_groups(g, wt)
        else:
            out = (g.double() * wt.double()[..., None]).sum(dim=1)
        lvl_bytes, lvl_ms = 0.0, 0.0
        for i, (parent, contrib) in enumerate(groups):
            subtree_w = sum(state[c][2] for c in contrib)
            for c in contrib:
                if c != parent:
                    lvl_bytes += vec_bytes
                    lvl_ms = max(lvl_ms, overlay.rtt(c, parent))
                del state[c]
            state[parent] = [out[i], 1.0, subtree_w]
        levels.append(
            {"level": depth, "groups": len(groups), "children": cmax,
             "bytes": lvl_bytes, "time_ms": lvl_ms}
        )

    for sched in tree.aggregation_schedule():
        groups = []
        for parent, children in sched:
            contrib = [c for c in children if c in state]
            if parent in state:
                contrib.append(parent)  # parent's own update merges here
            if contrib:
                groups.append((parent, contrib))
        if groups:
            run_level(groups, depth=len(levels))
    # final merge at the root: needed for stragglers outside the tree,
    # and for any still-raw leaf payload (kernel weight not yet applied
    # — e.g. a root-only payload on a childless tree)
    if (
        len(state) != 1
        or tree.root not in state
        or state[tree.root][1] != 1.0
    ):
        run_level([(tree.root, sorted(state))], depth=len(levels))

    vec, _, total_w = state[tree.root]
    mean = vec.double() / max(total_w, 1e-12)
    return unravel_like(mean, first), levels
