"""Failure recovery (paper §IV-D): parallel repair of dataflow trees.

Worker failure: children stop receiving keep-alives, each orphan routes a
JOIN using AppId to find a new parent (repairs happen in parallel — the
modeled recovery time is detection timeout + the *max* re-join latency).
Master failure: state is replicated across k neighborhood-set nodes every
round; the numerically-next node takes over, restores from any replica,
and the tree re-grafts under it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .forest import DataflowTree, Forest
from .nodeid import abs_ring_distance
from .overlay import MultiRingOverlay

KEEPALIVE_TIMEOUT_MS = 500.0


@dataclass
class RecoveryReport:
    failed: list[int]
    orphans_rejoined: int
    master_failed: bool
    new_master: int | None
    recovery_time_ms: float
    hops: int  # max hops any repair took
    restored_from_replica: int | None = None


class ReplicaStore:
    """Master state replication across the k-node neighborhood set."""

    def __init__(self, k: int = 2):
        self.k = k
        self.replicas: dict[int, dict[int, object]] = {}  # app_id -> {holder: state}

    def replicate(self, overlay: MultiRingOverlay, app_id: int, master: int, state) -> list[int]:
        holders = overlay.neighborhood_set(master)[: self.k]
        self.replicas[app_id] = {h: state for h in holders}
        return holders

    def restore(self, overlay: MultiRingOverlay, app_id: int, *, master: int | None = None):
        """Restore from the live holder ring-closest to the failed master.

        Any intact copy suffices for correctness; picking by ring distance
        (ties broken by id) makes the takeover deterministic — the old
        dict-insertion-order scan depended on replication-call history.
        """
        live = [h for h in self.replicas.get(app_id, {}) if h in overlay.alive]
        if not live:
            return None, None
        if master is None:
            holder = min(live)
        else:
            space = overlay.space
            ms = space.suffix_of(master)
            holder = min(
                live,
                key=lambda h: (
                    abs_ring_distance(space.suffix_of(h), ms, space.suffix_space),
                    h,
                ),
            )
        return holder, self.replicas[app_id][holder]


def fail_and_recover(
    overlay: MultiRingOverlay,
    forest: Forest,
    tree: DataflowTree,
    failed: list[int],
    *,
    replicas: ReplicaStore | None = None,
) -> RecoveryReport:
    """Fail `failed` nodes simultaneously; repair the tree in parallel."""
    failed_set = set(failed)
    for n in failed:
        overlay.fail(n)

    master_failed = tree.root in failed_set
    new_master = None
    restored_from = None
    max_hops = 0
    max_latency = 0.0

    if master_failed:
        # the immediate child detects it and routes a JOIN by AppId: the new
        # rendezvous is the live node numerically closest to AppId
        space = overlay.space
        zone = tree.meta.get("restrict_zone")
        if zone is None:
            zone = overlay.nearest_zone(space.zone_of(tree.app_id))
        new_master = overlay._zone_closest(zone, space.suffix_of(tree.app_id))
        detector = next(iter(tree.children.get(tree.root, [])), new_master)
        if detector in failed_set or detector is None:
            detector = new_master
        res = overlay.route(detector, tree.app_id)
        max_hops = max(max_hops, res.hops)
        max_latency = max(max_latency, overlay.path_latency(res.path))
        if replicas is not None:
            restored_from, _state = replicas.restore(overlay, tree.app_id, master=tree.root)
        old_root = tree.root
        tree.root = new_master
        tree.parent.pop(new_master, None)
        for c in tree.children.pop(old_root, []):
            if c not in failed_set and c != new_master:
                tree.parent[c] = new_master
                tree.children.setdefault(new_master, []).append(c)

    # drop failed nodes' edges; collect orphans
    orphans = []
    for n in failed_set:
        for c in tree.children.pop(n, []):
            if c not in failed_set:
                orphans.append(c)
        p = tree.parent.pop(n, None)
        if p is not None and p in tree.children and n in tree.children[p]:
            tree.children[p].remove(n)
        tree.members.discard(n)

    # each orphan re-JOINs by AppId (parallel): new parent = first live tree
    # node on its route (or the root)
    rejoined = 0
    for o in orphans:
        if o in failed_set or o == tree.root:
            continue
        res = overlay.route(o, tree.app_id)
        max_hops = max(max_hops, res.hops)
        max_latency = max(max_latency, overlay.path_latency(res.path))
        # graft o under the first node of the path that is in the tree
        parent = tree.root
        for hop in res.path[1:]:
            if hop == tree.root or hop in tree.parent:
                parent = hop
                break
        if parent == o:
            parent = tree.root
        tree.parent[o] = parent
        tree.children.setdefault(parent, []).append(o)
        rejoined += 1

    return RecoveryReport(
        failed=sorted(failed_set),
        orphans_rejoined=rejoined,
        master_failed=master_failed,
        new_master=new_master,
        recovery_time_ms=KEEPALIVE_TIMEOUT_MS + max_latency,
        hops=max_hops,
        restored_from_replica=restored_from,
    )


def verify_tree(tree: DataflowTree, overlay: MultiRingOverlay) -> bool:
    """Every member reaches the root through live nodes, acyclically."""
    for n in tree.members:
        if n not in overlay.alive:
            return False
        seen = set()
        cur = n
        while cur != tree.root:
            if cur in seen or cur not in tree.parent:
                return False
            seen.add(cur)
            cur = tree.parent[cur]
            if cur not in overlay.alive:
                return False
    return True
