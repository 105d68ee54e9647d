"""Layer 2: publish/subscribe forest abstraction (paper §IV-C).

Each FL application gets a dataflow tree built from the union of JOIN
message routes toward AppId; the rendezvous node (numerically closest to
AppId) is the root = master; internal nodes keep children tables and act
as coordinator/aggregator/selector; leaves are workers.  The masters of
all trees join a shared advertise-discover (AD) tree keyed by
``hash("AD application")`` that carries the application registry.

Storage follows the overlay's array-of-structs pattern: a
``DataflowTree`` keeps its topology in flat numpy arrays (parent
vector, intrusive child lists, lazily rebuilt depth/level slices) while
``parent`` / ``children`` remain zero-copy write-through dict/list
views, so the recovery, API and sim layers mutate trees through the
same idioms as the original dict-of-lists implementation — including
the transient parent/children divergence the repair path relies on.
``Forest.subscribe_many`` grafts a whole JOIN batch at once; the scalar
``subscribe`` loop stays as the exactness oracle.
"""
from __future__ import annotations

from collections.abc import MutableMapping
from typing import Iterator

import numpy as np

from .nodeid import numerically_closest, sha1_id
from .overlay import MultiRingOverlay, RouteResult

AD_TOPIC = "AD application"

_NO_DEFAULT = object()


def _isin_sorted(haystack: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Membership of ``vals`` in a *sorted* int64 ``haystack``."""
    if len(haystack) == 0:
        return np.zeros(len(vals), bool)
    i = np.searchsorted(haystack, vals)
    i[i == len(haystack)] = len(haystack) - 1
    return haystack[i] == vals


# ---------------------------------------------------------------------------
# zero-copy views over the tree arrays (the overlay's PR-6 pattern)


class _ParentView(MutableMapping):
    """``dict[int, int]`` facade (child -> parent) over the tree arrays.

    Iteration follows dict-insertion order (an insertion-seq column), so
    loops over ``tree.parent`` see exactly what the old dict showed.
    Every mutation drops the tree's derived depth/level cache.
    """

    __slots__ = ("_t",)

    def __init__(self, tree: "DataflowTree"):
        self._t = tree

    def __getitem__(self, node: int) -> int:
        t = self._t
        s = t._slot.get(node)
        if s is None or t._par[s] < 0:
            raise KeyError(node)
        return int(t._ids[t._par[s]])

    def __setitem__(self, node: int, parent: int) -> None:
        t = self._t
        s = t._slot_of(node)
        p = t._slot_of(parent)
        if t._par[s] < 0:
            t._pseq[s] = t._next_seq()
            t._par_count += 1
        t._par[s] = p
        t._invalidate()

    def __delitem__(self, node: int) -> None:
        t = self._t
        s = t._slot.get(node)
        if s is None or t._par[s] < 0:
            raise KeyError(node)
        t._par[s] = -1
        t._pseq[s] = -1
        t._par_count -= 1
        t._invalidate()

    def __contains__(self, node) -> bool:
        t = self._t
        s = t._slot.get(node)
        return s is not None and t._par[s] >= 0

    def __iter__(self) -> Iterator[int]:
        t = self._t
        slots = np.flatnonzero(t._par[: t._n] >= 0)
        order = np.argsort(t._pseq[slots], kind="stable")
        return iter(t._ids[slots[order]].tolist())

    def __len__(self) -> int:
        return self._t._par_count

    def __repr__(self) -> str:
        return repr(dict(self))


class _ChildList:
    """Ordered write-through view of one parent's children list.

    Backed by an intrusive doubly-linked list threaded through the tree
    arrays, so ``append`` / ``remove`` are O(1) and preserve exact
    list-append order (graft order matters for trace identity).
    """

    __slots__ = ("_t", "_p")

    def __init__(self, tree: "DataflowTree", pslot: int):
        self._t = tree
        self._p = pslot

    def _slots(self) -> list[int]:
        t = self._t
        out, c = [], int(t._ch_head[self._p])
        while c >= 0:
            out.append(c)
            c = int(t._ch_next[c])
        return out

    def _ids_list(self) -> list[int]:
        t = self._t
        return [int(t._ids[s]) for s in self._slots()]

    def __len__(self) -> int:
        return int(self._t._ch_len[self._p])

    def __bool__(self) -> bool:
        return bool(self._t._ch_len[self._p] > 0)

    def __iter__(self) -> Iterator[int]:
        return iter(self._ids_list())

    def __getitem__(self, i):
        return self._ids_list()[i]

    def __contains__(self, node) -> bool:
        t = self._t
        s = t._slot.get(node)
        return s is not None and t._cl_list[s] == self._p

    def __eq__(self, other) -> bool:
        if isinstance(other, _ChildList):
            other = other._ids_list()
        if isinstance(other, (list, tuple)):
            return self._ids_list() == list(other)
        return NotImplemented

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def append(self, node: int) -> None:
        t = self._t
        s = t._slot_of(node)
        if t._cl_list[s] >= 0:  # a node lives in at most one children list
            t._ch_unlink(s)
        t._ch_append(self._p, s)

    def extend(self, nodes) -> None:
        for n in nodes:
            self.append(n)

    def remove(self, node: int) -> None:
        t = self._t
        s = t._slot.get(node)
        if s is None or t._cl_list[s] != self._p:
            raise ValueError(f"list.remove(x): {node} not in children list")
        t._ch_unlink(s)

    def clear(self) -> None:
        self._t._unlink_all_children(self._p)

    def index(self, node: int) -> int:
        return self._ids_list().index(node)

    def count(self, node: int) -> int:
        return 1 if node in self else 0

    def __repr__(self) -> str:
        return repr(self._ids_list())


class _ChildrenView(MutableMapping):
    """``dict[int, list[int]]`` facade over the children table.

    Key order follows key-creation order (a key-seq column), values are
    live ``_ChildList`` views; ``pop`` materializes a plain list first
    so the recovery path can iterate orphans after the unlink — exactly
    the old ``dict.pop`` contract.
    """

    __slots__ = ("_t",)

    def __init__(self, tree: "DataflowTree"):
        self._t = tree

    def __getitem__(self, parent: int) -> _ChildList:
        t = self._t
        s = t._slot.get(parent)
        if s is None or not t._ch_present[s]:
            raise KeyError(parent)
        return _ChildList(t, s)

    def __setitem__(self, parent: int, value) -> None:
        t = self._t
        s = t._slot_of(parent)
        if not t._ch_present[s]:
            t._mark_ch_present(s)
        else:
            t._unlink_all_children(s)
        lst = _ChildList(t, s)
        for c in value:
            lst.append(c)

    def __delitem__(self, parent: int) -> None:
        self.pop(parent)

    def pop(self, parent: int, default=_NO_DEFAULT):
        t = self._t
        s = t._slot.get(parent)
        if s is None or not t._ch_present[s]:
            if default is _NO_DEFAULT:
                raise KeyError(parent)
            return default
        out = _ChildList(t, s)._ids_list()
        t._unlink_all_children(s)
        t._ch_present[s] = False
        t._ch_kseq[s] = -1
        t._ch_count -= 1
        t._invalidate()
        return out

    def setdefault(self, parent: int, default=None) -> _ChildList:
        t = self._t
        s = t._slot_of(parent)
        if not t._ch_present[s]:
            t._mark_ch_present(s)
            if default:
                lst = _ChildList(t, s)
                for c in default:
                    lst.append(c)
        return _ChildList(t, s)

    def __contains__(self, parent) -> bool:
        t = self._t
        s = t._slot.get(parent)
        return s is not None and bool(t._ch_present[s])

    def __iter__(self) -> Iterator[int]:
        t = self._t
        slots = np.flatnonzero(t._ch_present[: t._n])
        order = np.argsort(t._ch_kseq[slots], kind="stable")
        return iter(t._ids[slots[order]].tolist())

    def __len__(self) -> int:
        return self._t._ch_count

    def __repr__(self) -> str:
        return repr({p: list(self[p]) for p in self})


# ---------------------------------------------------------------------------


class DataflowTree:
    """Array-backed dataflow tree.

    Topology lives in struct-of-arrays over node *slots* (append-only
    rows; ``_slot`` maps node id -> slot): ``_par``/``_pseq`` back the
    ``parent`` mapping, and an intrusive doubly-linked list per parent
    (``_ch_head``/``_ch_tail``/``_ch_next``/``_ch_prev``/``_cl_list``)
    backs the ``children`` table with exact append order.  The two
    stores are updated in tandem by callers — never derived from each
    other — because the recovery path deliberately lets them diverge
    mid-repair (orphans keep stale ``parent`` entries after their failed
    parent's ``children.pop``).

    Derived structure (depth vector, level slices, a parent->children
    CSR) is rebuilt lazily by ``_ensure_cache`` — any mutation through
    the views invalidates it — which turns ``depth_of`` into an O(1)
    lookup and ``levels`` / ``aggregation_schedule`` / ``broadcast_time``
    into array passes instead of per-node parent walks.
    """

    __slots__ = (
        "app_id", "meta", "members", "parent", "children",
        "_root", "_slot", "_ids", "_par", "_pseq",
        "_cl_list", "_ch_next", "_ch_prev", "_ch_head", "_ch_tail",
        "_ch_len", "_ch_present", "_ch_kseq",
        "_n", "_seq", "_par_count", "_ch_count", "_cache",
    )

    def __init__(
        self,
        app_id: int,
        root: int,
        parent: dict[int, int] | None = None,
        children: dict[int, list[int]] | None = None,
        members: set[int] | None = None,
        meta: dict | None = None,
    ):
        self.app_id = app_id
        self.meta = {} if meta is None else meta
        self.members = set() if members is None else set(members)
        cap = 16
        self._ids = np.zeros(cap, np.int64)
        self._par = np.full(cap, -1, np.int64)
        self._pseq = np.full(cap, -1, np.int64)
        self._cl_list = np.full(cap, -1, np.int64)
        self._ch_next = np.full(cap, -1, np.int64)
        self._ch_prev = np.full(cap, -1, np.int64)
        self._ch_head = np.full(cap, -1, np.int64)
        self._ch_tail = np.full(cap, -1, np.int64)
        self._ch_len = np.zeros(cap, np.int64)
        self._ch_present = np.zeros(cap, bool)
        self._ch_kseq = np.full(cap, -1, np.int64)
        self._slot: dict[int, int] = {}
        self._n = 0
        self._seq = 0
        self._par_count = 0
        self._ch_count = 0
        self._cache: dict | None = None
        self._root = int(root)
        self._slot_of(self._root)
        self.parent = _ParentView(self)
        self.children = _ChildrenView(self)
        if parent:
            for c, p in parent.items():
                self.parent[c] = p
        if children:
            for p, kids in children.items():
                self.children[p] = list(kids)

    # -- root (recovery reassigns it on master failover) ---------------------

    @property
    def root(self) -> int:
        return self._root

    @root.setter
    def root(self, value: int) -> None:
        self._root = int(value)
        self._slot_of(self._root)
        self._invalidate()

    def __repr__(self) -> str:
        return (
            f"DataflowTree(app_id={self.app_id}, root={self._root}, "
            f"nodes={len(self.parent) + 1}, members={len(self.members)})"
        )

    # -- slot bookkeeping -----------------------------------------------------

    def _grow(self, need: int) -> None:
        cap = len(self._ids)
        if need <= cap:
            return
        new = max(cap * 2, need)

        def ext(a: np.ndarray, fill) -> np.ndarray:
            b = np.full(new, fill, a.dtype)
            b[: self._n] = a[: self._n]
            return b

        self._ids = ext(self._ids, 0)
        self._par = ext(self._par, -1)
        self._pseq = ext(self._pseq, -1)
        self._cl_list = ext(self._cl_list, -1)
        self._ch_next = ext(self._ch_next, -1)
        self._ch_prev = ext(self._ch_prev, -1)
        self._ch_head = ext(self._ch_head, -1)
        self._ch_tail = ext(self._ch_tail, -1)
        self._ch_len = ext(self._ch_len, 0)
        self._ch_present = ext(self._ch_present, False)
        self._ch_kseq = ext(self._ch_kseq, -1)

    def _slot_of(self, node: int) -> int:
        s = self._slot.get(node)
        if s is None:
            s = self._n
            self._grow(s + 1)
            self._ids[s] = node
            self._slot[node] = s
            self._n = s + 1
        return s

    def _next_seq(self) -> int:
        s = self._seq
        self._seq += 1
        return s

    def _invalidate(self) -> None:
        self._cache = None

    # -- children linked-list primitives --------------------------------------

    def _mark_ch_present(self, s: int) -> None:
        self._ch_present[s] = True
        self._ch_kseq[s] = self._next_seq()
        self._ch_count += 1
        self._invalidate()

    def _ch_append(self, p: int, c: int) -> None:
        tail = int(self._ch_tail[p])
        if tail < 0:
            self._ch_head[p] = c
        else:
            self._ch_next[tail] = c
        self._ch_prev[c] = tail
        self._ch_next[c] = -1
        self._ch_tail[p] = c
        self._cl_list[c] = p
        self._ch_len[p] += 1
        self._invalidate()

    def _ch_unlink(self, c: int) -> None:
        p = int(self._cl_list[c])
        if p < 0:
            return
        nxt, prv = int(self._ch_next[c]), int(self._ch_prev[c])
        if prv >= 0:
            self._ch_next[prv] = nxt
        else:
            self._ch_head[p] = nxt
        if nxt >= 0:
            self._ch_prev[nxt] = prv
        else:
            self._ch_tail[p] = prv
        self._cl_list[c] = -1
        self._ch_next[c] = -1
        self._ch_prev[c] = -1
        self._ch_len[p] -= 1
        self._invalidate()

    def _unlink_all_children(self, p: int) -> None:
        c = int(self._ch_head[p])
        while c >= 0:
            nxt = int(self._ch_next[c])
            self._cl_list[c] = -1
            self._ch_next[c] = -1
            self._ch_prev[c] = -1
            c = nxt
        self._ch_head[p] = -1
        self._ch_tail[p] = -1
        self._ch_len[p] = 0
        self._invalidate()

    # -- derived structure (lazy) ---------------------------------------------

    def _ensure_cache(self) -> dict:
        """Depth vector + level slices via a level-synchronous BFS from
        the root over a searchsorted CSR of the parent vector.  Nodes in
        the parent map but unreachable from the root keep depth -1 (the
        scalar ``depth_of`` replay below reproduces the legacy error for
        them)."""
        if self._cache is not None:
            return self._cache
        n = self._n
        root_s = self._slot[self._root]
        par = self._par[:n]
        active = np.flatnonzero(par >= 0)
        order = np.argsort(par[active], kind="stable")
        kids_sorted = active[order]  # child slots grouped by parent slot
        par_sorted = par[active][order]
        depth = np.full(n, -1, np.int64)
        depth[root_s] = 0
        levels = [np.asarray([root_s], np.int64)]
        frontier = levels[0]
        while True:
            lo = np.searchsorted(par_sorted, frontier, side="left")
            hi = np.searchsorted(par_sorted, frontier, side="right")
            cnt = hi - lo
            total = int(cnt.sum())
            if total == 0:
                break
            starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
            idx = np.arange(total) - np.repeat(starts, cnt) + np.repeat(lo, cnt)
            nxt = kids_sorted[idx]
            nxt = nxt[depth[nxt] < 0]  # cycle guard: stop at seen slots
            if len(nxt) == 0:
                break
            depth[nxt] = len(levels)
            levels.append(nxt)
            frontier = np.sort(nxt)
        ids_order = np.argsort(self._ids[:n], kind="stable")
        self._cache = {
            "depth": depth,
            "levels": levels,
            "root_s": root_s,
            "active": active,
            "ids_sorted": self._ids[:n][ids_order],
            "slots_sorted": ids_order,
        }
        return self._cache

    def _slots_of(self, ids_arr: np.ndarray) -> np.ndarray:
        """Vectorized node-id -> slot lookup; KeyError on unknown ids."""
        cache = self._ensure_cache()
        srt, slots = cache["ids_sorted"], cache["slots_sorted"]
        j = np.searchsorted(srt, ids_arr)
        jj = np.minimum(j, len(srt) - 1)
        bad = (j >= len(srt)) | (srt[jj] != ids_arr)
        if bad.any():
            raise KeyError(int(ids_arr[np.flatnonzero(bad)[0]]))
        return slots[jj]

    def _check_reachable(self, slots: np.ndarray) -> np.ndarray:
        """Depths of the given slots; replay the scalar walk (which
        raises exactly like the legacy code) for any unreached slot."""
        depth = self._ensure_cache()["depth"][slots]
        if (depth < 0).any():
            bad = slots[np.flatnonzero(depth < 0)[0]]
            self._depth_walk(int(self._ids[bad]))
        return depth

    # -- topology queries ------------------------------------------------------

    def nodes(self) -> set[int]:
        mask = self._par[: self._n] >= 0
        out = set(self._ids[: self._n][mask].tolist())
        out.add(self._root)
        return out

    def _depth_walk(self, node: int) -> int:
        """Legacy scalar parent walk — kept as the error-faithful path
        for nodes the BFS cannot reach (detached chains, cycles)."""
        d, cur = 0, node
        while cur != self._root:
            cur = self.parent[cur]
            d += 1
            if d > self._par_count + 1:
                raise RuntimeError("cycle in tree")
        return d

    def depth_of(self, node: int) -> int:
        s = self._slot.get(node)
        if s is None:
            if node == self._root:
                return 0
            raise KeyError(node)
        d = self._ensure_cache()["depth"][s]
        if d >= 0:
            return int(d)
        return self._depth_walk(node)

    def depths_of(self, nodes) -> np.ndarray:
        """Vectorized ``depth_of`` over an id array."""
        arr = np.asarray(nodes, np.int64)
        if len(arr) == 0:
            return np.zeros(0, np.int64)
        return self._check_reachable(self._slots_of(arr)).copy()

    def depth(self) -> int:
        cache = self._ensure_cache()
        self._check_reachable(cache["active"])
        return len(cache["levels"]) - 1

    def levels(self) -> list[list[int]]:
        cache = self._ensure_cache()
        self._check_reachable(cache["active"])
        return [np.sort(self._ids[lv]).tolist() for lv in cache["levels"]]

    def fanout(self) -> int:
        present = self._ch_present[: self._n]
        if not present.any():
            return 0
        return int(self._ch_len[: self._n][present].max())

    def path_to_root(self, node: int) -> list[int]:
        out = [node]
        slot, par, ids, root = self._slot, self._par, self._ids, self._root
        cur = node
        while cur != root:
            s = slot.get(cur)
            if s is None or par[s] < 0:
                raise KeyError(cur)
            cur = int(ids[par[s]])
            out.append(cur)
        return out

    def paths_matrix(self, nodes) -> np.ndarray:
        """Root-ward paths for many nodes at once: row k is
        ``path_to_root(nodes[k])``, padded with -1 past the root.  One
        vectorized parent-gather per tree level instead of a Python walk
        per node."""
        arr = np.asarray(nodes, np.int64)
        if len(arr) == 0:
            return np.zeros((0, 1), np.int64)
        slots = self._slots_of(arr)
        d = self._check_reachable(slots)
        dmax = int(d.max())
        out = np.full((len(arr), dmax + 1), -1, np.int64)
        cur = slots.copy()
        alive = np.ones(len(arr), bool)
        for lev in range(dmax + 1):
            ai = np.flatnonzero(alive)
            out[ai, lev] = self._ids[cur[ai]]
            done = d[ai] == lev  # row reached the root
            alive[ai[done]] = False
            step = ai[~done]
            cur[step] = self._par[cur[step]]
        return out

    # -- bulk graft (used by Forest.subscribe_many) ---------------------------

    def _bulk_attach(self, child_ids: np.ndarray, parent_ids: np.ndarray) -> None:
        """Append many (child -> parent) edges at once, equivalent to
        ``parent[c] = p; children.setdefault(p, []).append(c)`` per pair
        in order.  Children must be new to the parent map (the graft
        merge guarantees it)."""
        k = len(child_ids)
        if k == 0:
            return
        # slot allocation for any unseen ids (children and route tails)
        all_ids = np.concatenate([child_ids, parent_ids])
        uniq = np.unique(all_ids)
        known_sorted = np.sort(self._ids[: self._n])
        fresh = uniq[~_isin_sorted(known_sorted, uniq)]
        base = self._n
        self._grow(base + len(fresh))
        self._ids[base : base + len(fresh)] = fresh
        self._n = base + len(fresh)
        self._slot.update(zip(fresh.tolist(), range(base, base + len(fresh))))
        ids_snap = self._ids[: self._n]
        sort_idx = np.argsort(ids_snap, kind="stable")
        sorted_ids = ids_snap[sort_idx]
        cs = sort_idx[np.searchsorted(sorted_ids, child_ids)]
        ps = sort_idx[np.searchsorted(sorted_ids, parent_ids)]
        assert (self._par[cs] < 0).all(), "bulk graft re-parenting existing nodes"
        # parent store
        self._par[cs] = ps
        self._pseq[cs] = self._seq + np.arange(k)
        self._seq += k
        self._par_count += k
        # children store: group appended children by parent, keeping the
        # sequential append order inside each group (stable sort)
        linked = np.flatnonzero(self._cl_list[cs] >= 0)
        for i in linked.tolist():  # defensive: a child can't be listed twice
            self._ch_unlink(int(cs[i]))
        order2 = np.argsort(ps, kind="stable")
        gp, gc = ps[order2], cs[order2]
        starts = np.flatnonzero(np.r_[True, gp[1:] != gp[:-1]])
        ends = np.r_[starts[1:], k]
        nxt = np.full(k, -1, np.int64)
        prv = np.full(k, -1, np.int64)
        nxt[:-1] = gc[1:]
        prv[1:] = gc[:-1]
        nxt[ends - 1] = -1
        prv[starts] = -1
        self._ch_next[gc] = nxt
        self._ch_prev[gc] = prv
        self._cl_list[gc] = gp
        heads, tails, parents = gc[starts], gc[ends - 1], gp[starts]
        old_tail = self._ch_tail[parents]
        has_old = old_tail >= 0
        self._ch_next[old_tail[has_old]] = heads[has_old]
        self._ch_prev[heads[has_old]] = old_tail[has_old]
        self._ch_head[parents[~has_old]] = heads[~has_old]
        self._ch_tail[parents] = tails
        self._ch_len[parents] += ends - starts
        # new children-table keys get kseq in first-append order
        newk = ~self._ch_present[parents]
        if newk.any():
            korder = np.argsort(order2[starts][newk], kind="stable")
            new_parents = parents[newk][korder]
            self._ch_present[new_parents] = True
            self._ch_kseq[new_parents] = self._seq + np.arange(len(new_parents))
            self._seq += len(new_parents)
            self._ch_count += len(new_parents)
        self._invalidate()

    # -- dataflow schedules (latency model supplied by the overlay) ----------

    def aggregation_schedule(self) -> list[list[tuple[int, list[int]]]]:
        """Per-level batches of (parent, children) groups, deepest level
        first, so partial aggregates flow leaves -> root: every internal
        node appears exactly once as a parent, and each level's groups
        are independent (executable as one batched kernel call)."""
        n = self._n
        kids = np.flatnonzero(self._cl_list[:n] >= 0)
        if len(kids) == 0:
            return []
        par = self._cl_list[kids]
        pd = self._check_reachable(par)
        pid = self._ids[par]
        kid = self._ids[kids]
        order = np.lexsort((kid, pid, -pd))
        pd_l = pd[order].tolist()
        pid_l = pid[order].tolist()
        kid_l = kid[order].tolist()
        out: list[list[tuple[int, list[int]]]] = []
        level: list[tuple[int, list[int]]] = []
        cur_d = None
        i, total = 0, len(kid_l)
        while i < total:
            j = i + 1
            while j < total and pid_l[j] == pid_l[i]:
                j += 1
            if pd_l[i] != cur_d:
                if level:
                    out.append(level)
                level, cur_d = [], pd_l[i]
            level.append((pid_l[i], kid_l[i:j]))
            i = j
        if level:
            out.append(level)
        return out

    def broadcast_schedule(self) -> list[list[tuple[int, list[int]]]]:
        """The same level batches root -> leaves (dissemination order)."""
        return list(reversed(self.aggregation_schedule()))

    def broadcast_time(
        self,
        overlay: MultiRingOverlay,
        payload_ms: float = 0.0,
        *,
        pipelined: bool = False,
        chunks: int = 8,
    ) -> float:
        """Model dissemination root->leaves: max over leaves of path latency.

        ``pipelined=True`` prices each root->leaf path with per-edge
        store-and-forward overlap: the payload is cut into ``chunks``
        pieces so a hop starts forwarding as soon as the first piece
        lands — a D-hop payload costs t*(D+C-1)/C instead of t*D,
        approaching the max single edge as C grows (never slower than
        the synchronous sum).

        Per-node latencies accumulate root-down level by level in the
        same edge order as the per-leaf ``path_latency`` sum, so the
        vectorized result matches the scalar walk
        (``_broadcast_time_walk``, kept as the oracle/fallback).
        """
        cache = self._ensure_cache()
        n = self._n
        depth, levels = cache["depth"], cache["levels"]
        if len(cache["active"]) and (depth[cache["active"]] < 0).any():
            return self._broadcast_time_walk(
                overlay, payload_ms, pipelined=pipelined, chunks=chunks
            )
        tree_slots = np.concatenate(levels)
        rows = overlay._rows_of_many(self._ids[tree_slots])
        if (rows < 0).any():  # a node the overlay no longer knows
            return self._broadcast_time_walk(
                overlay, payload_ms, pipelined=pipelined, chunks=chunks
            )
        row_of = np.full(n, -1, np.int64)
        row_of[tree_slots] = rows
        lat = np.zeros(n, np.float64)
        xy = overlay._xy
        for lev_slots in levels[1:]:
            ps = self._par[lev_slots]
            a, b = xy[row_of[ps]], xy[row_of[lev_slots]]
            dx, dy = a[:, 0] - b[:, 0], a[:, 1] - b[:, 1]
            lat[lev_slots] = lat[ps] + (1.0 + 0.1 * (dx ** 2 + dy ** 2) ** 0.5)
        leaf = ~(self._ch_present[tree_slots] & (self._ch_len[tree_slots] > 0))
        lslots = tree_slots[leaf]
        edges = depth[lslots].astype(np.float64)
        if pipelined:
            c = max(1, int(chunks))
            pay = np.where(
                depth[lslots] > 1,
                payload_ms * (edges + c - 1) / c,
                payload_ms * edges,
            )
        else:
            pay = payload_ms * edges
        if len(lslots) == 0:
            return 0.0
        return float(np.max(lat[lslots] + pay, initial=0.0))

    def _broadcast_time_walk(
        self,
        overlay: MultiRingOverlay,
        payload_ms: float = 0.0,
        *,
        pipelined: bool = False,
        chunks: int = 8,
    ) -> float:
        """Scalar per-leaf walk (the original implementation): oracle for
        the vectorized ``broadcast_time`` and fallback for trees whose
        nodes the vector path cannot resolve."""
        t = 0.0
        for node in self.nodes():
            if node not in self.children or not self.children[node]:  # leaf
                path = list(reversed(self.path_to_root(node)))
                edges = len(path) - 1
                if pipelined and edges > 1:
                    c = max(1, int(chunks))
                    payload_total = payload_ms * (edges + c - 1) / c
                else:
                    payload_total = payload_ms * edges
                t = max(t, overlay.path_latency(path) + payload_total)
        return t

    def aggregation_time(self, overlay: MultiRingOverlay, payload_ms: float = 0.0) -> float:
        return self.broadcast_time(overlay, payload_ms)  # symmetric schedule


# ---------------------------------------------------------------------------
# vectorized union-of-paths graft


def _graft_paths_bulk(tree: DataflowTree, flat: np.ndarray, offsets: np.ndarray) -> bool:
    """Apply ``Forest._graft_path`` for a whole route batch at once,
    exactly.  ``flat``/``offsets`` hold the concatenated per-route paths
    (``RouteBatch.paths_flat``).

    Sequential grafting is a fixpoint.  Route r stops at its *cut* — the
    first scanned position whose node is already in the tree as left by
    routes < r — and every pre-cut position claims its node with parent
    = next hop (plus the root-fixup claim for routes that scan through
    every edge).  A node is owned by the lexicographically first
    (route, pos) claim.  cuts -> claims is monotone and claims -> cuts
    antitone, so the composed update G is antitone: iterates sandwich
    the sequential solution S (even iterates >= S >= odd iterates), and
    any two consecutive equal iterates *are* S.  We start from the
    no-claims cut vector and iterate until stable, then apply surviving
    claims in (route, pos) order — node-for-node the sequential result.
    Returns False if the cap is hit (a 2-cycle; the caller falls back to
    the scalar loop, so exactness never depends on convergence).
    """
    K = len(offsets) - 1
    if K == 0:
        return True
    lens = np.diff(offsets)
    total = int(offsets[-1])
    pos = np.arange(total, dtype=np.int64) - np.repeat(offsets[:-1], lens)
    ridx = np.repeat(np.arange(K, dtype=np.int64), lens)
    scan = pos < (lens[ridx] - 1)  # the scalar loop tests all but the last node
    root = tree._root
    n0 = tree._n
    init_parent_ids = np.sort(tree._ids[:n0][tree._par[:n0] >= 0])
    base_hit = (_isin_sorted(init_parent_ids, flat) | (flat == root)) & scan
    last_node = flat[offsets[1:] - 1]
    last_in_init = _isin_sorted(init_parent_ids, last_node)
    NOHIT = lens - 1  # cut sentinel: route scanned every edge
    BIG = np.iinfo(np.int64).max

    def cuts_from(owned_lt: np.ndarray | None) -> np.ndarray:
        hit = base_hit if owned_lt is None else (base_hit | (owned_lt & scan))
        vals = np.where(hit, pos, BIG)
        return np.minimum(np.minimum.reduceat(vals, offsets[:-1]), NOHIT)

    def claims_from(cut: np.ndarray):
        li = np.flatnonzero(scan & (pos < cut[ridx]))
        c_node, c_route = flat[li], ridx[li]
        c_pos, c_parent = pos[li], flat[li + 1]
        fix = np.flatnonzero((cut == NOHIT) & (last_node != root) & ~last_in_init)
        if len(fix):
            c_node = np.concatenate([c_node, last_node[fix]])
            c_route = np.concatenate([c_route, fix])
            c_pos = np.concatenate([c_pos, NOHIT[fix]])
            c_parent = np.concatenate([c_parent, np.full(len(fix), root, np.int64)])
        order = np.lexsort((c_pos, c_route, c_node))
        sn = c_node[order]
        first = np.ones(len(sn), bool)
        first[1:] = sn[1:] != sn[:-1]
        return (sn[first], c_route[order][first], c_pos[order][first],
                c_parent[order][first])

    def owned_lt_from(own_nodes: np.ndarray, own_route: np.ndarray) -> np.ndarray:
        if len(own_nodes) == 0:
            return np.zeros(total, bool)
        j = np.searchsorted(own_nodes, flat)
        jj = np.minimum(j, len(own_nodes) - 1)
        return (own_nodes[jj] == flat) & (own_route[jj] < ridx)

    cut = cuts_from(None)
    own = claims_from(cut)
    for _ in range(64):
        new_cut = cuts_from(owned_lt_from(own[0], own[1]))
        if np.array_equal(new_cut, cut):
            break
        cut = new_cut
        own = claims_from(cut)
    else:
        return False
    own_nodes, own_route, own_pos, own_parent = own
    if len(own_nodes):
        app_order = np.lexsort((own_pos, own_route))
        tree._bulk_attach(own_nodes[app_order], own_parent[app_order])
    return True


class Forest:
    """All dataflow trees + the AD tree."""

    def __init__(self, overlay: MultiRingOverlay):
        self.overlay = overlay
        self.trees: dict[int, DataflowTree] = {}
        self.app_names: dict[str, int] = {}
        self.ad_tree: DataflowTree | None = None
        self.ad_registry: dict[int, dict] = {}  # app_id -> meta (held at AD root)

    # -- tree construction (union of JOIN paths) ------------------------------

    def app_id_of(self, name: str, salt: str = "") -> int:
        return sha1_id(name, self.overlay.space.total_bits, salt)

    def _rendezvous(self, key: int, restrict_zone: int | None) -> int:
        space = self.overlay.space
        if restrict_zone is not None:
            nid = self.overlay._zone_closest(restrict_zone, space.suffix_of(key))
            assert nid is not None
            return nid
        zone = self.overlay.nearest_zone(space.zone_of(key))
        return self.overlay._zone_closest(zone, space.suffix_of(key))

    def create_tree(
        self,
        name: str,
        *,
        salt: str = "",
        restrict_zone: int | None = None,
        fanout_bits: int | None = None,
        meta=None,
    ) -> DataflowTree:
        app_id = self.app_id_of(name, salt)
        root = self._rendezvous(app_id, restrict_zone)
        tree = DataflowTree(app_id=app_id, root=root, meta=meta or {"name": name})
        tree.meta.setdefault("restrict_zone", restrict_zone)
        tree.meta.setdefault("fanout_bits", fanout_bits)
        self.trees[app_id] = tree
        self.app_names[name] = app_id
        self._advertise(app_id, tree.meta)
        return tree

    @staticmethod
    def _graft_path(tree: DataflowTree, path: list[int]) -> None:
        """Union-of-JOIN-paths rule: register child->parent edges along the
        route until the path meets the existing tree."""
        for a, b in zip(path, path[1:]):
            if a == tree.root or a in tree.parent:
                return
            tree.parent[a] = b
            tree.children.setdefault(b, []).append(a)
        last = path[-1]
        if last != tree.root and last not in tree.parent:
            tree.parent[last] = tree.root
            tree.children.setdefault(tree.root, []).append(last)

    def subscribe(self, app_id: int, node: int) -> RouteResult:
        """JOIN: route toward AppId; graft onto the first tree node hit."""
        tree = self.trees[app_id]
        res = self.overlay.route(
            node,
            app_id,
            restrict_zone=tree.meta.get("restrict_zone"),
            base_bits=tree.meta.get("fanout_bits"),
        )
        tree.members.add(node)
        self._graft_path(tree, res.path)
        return res

    def subscribe_many(self, app_id: int, nodes, *, chunk: int = 1 << 16) -> np.ndarray:
        """Bulk JOIN: resolve every subscriber's route in one
        ``route_many`` batch per chunk and graft the union of paths with
        a vectorized first-hit-wins merge whose tie-break is
        sequential-subscribe order — the resulting tree is node-for-node
        identical to calling ``subscribe`` in a loop (the oracle; gated
        in bench_scale and tests/test_forest.py).  Chunks are processed
        in input order, each grafting against the tree the previous
        chunks left, so chunking cannot change the result.  Returns the
        delivered hop count per subscriber."""
        tree = self.trees[app_id]
        arr = np.asarray(list(nodes) if not isinstance(nodes, np.ndarray) else nodes,
                         np.int64).ravel()
        hops_out = np.zeros(len(arr), np.int64)
        if len(arr) == 0:
            return hops_out
        rz = tree.meta.get("restrict_zone")
        bb = tree.meta.get("fanout_bits")
        for lo in range(0, len(arr), chunk):
            part = arr[lo : lo + chunk]
            batch = self.overlay.route_many(
                part,
                np.full(len(part), tree.app_id, np.int64),
                restrict_zone=rz,
                base_bits=bb,
            )
            tree.members.update(part.tolist())
            flat, offsets = batch.paths_flat()
            if not _graft_paths_bulk(tree, flat, offsets):
                for k in range(len(part)):  # unreachable in practice: cap hit
                    self._graft_path(tree, batch.path(k))
            hops_out[lo : lo + len(part)] = batch.hops
        return hops_out

    def unsubscribe(self, app_id: int, node: int) -> None:
        """LEAVE: prune if the node is a leaf with no subtree members."""
        tree = self.trees[app_id]
        tree.members.discard(node)
        while (
            node != tree.root
            and not tree.children.get(node)
            and node not in tree.members
            and node in tree.parent
        ):
            p = tree.parent.pop(node)
            tree.children[p].remove(node)
            node = p

    # -- placement re-grafts + bulk LEAVE --------------------------------------

    @staticmethod
    def _regraft_edge(tree: DataflowTree, node: int, new_parent: int) -> int:
        """Move one child->parent edge through the O(1) list primitives.
        The parent-map update goes through ``_ParentView.__setitem__`` on
        an existing key, which preserves the node's insertion sequence —
        so re-grafts never reorder ``tree.parent`` iteration."""
        old = tree.parent[node]
        tree.children[old].remove(node)
        tree.parent[node] = new_parent
        tree.children.setdefault(new_parent, []).append(node)
        return old

    @staticmethod
    def _check_regraft(tree: DataflowTree, node: int, new_parent: int) -> None:
        if node == tree.root:
            raise ValueError(f"cannot re-graft the root {node}")
        if node not in tree.parent:
            raise KeyError(node)
        if new_parent != tree.root and new_parent not in tree.parent:
            raise KeyError(new_parent)
        # cycle guard: the new parent must not live in node's subtree
        cur, hops = new_parent, 0
        while cur != tree.root:
            if cur == node:
                raise ValueError(
                    f"regraft cycle: {new_parent} is in the subtree of {node}"
                )
            cur = tree.parent[cur]
            hops += 1
            if hops > len(tree.parent) + 1:
                raise RuntimeError("corrupt tree: parent walk did not terminate")

    def regraft(self, app_id: int, node: int, new_parent: int) -> int:
        """Move ``node`` (with its whole subtree) under ``new_parent``
        after validating reachability and acyclicity.  Scalar oracle for
        :meth:`regraft_many`; returns the old parent."""
        tree = self.trees[app_id]
        self._check_regraft(tree, node, new_parent)
        return self._regraft_edge(tree, node, new_parent)

    def regraft_many(self, app_id: int, moves, *, strict: bool = True) -> list[tuple[int, int]]:
        """Batched placement re-graft: apply ``(node, new_parent)`` moves
        in input order, node-for-node identical to calling :meth:`regraft`
        in a loop (the oracle; tests/test_placement.py).

        Independent batches — the common case, since the placement engine
        only offers attachment points outside every mover's subtree — are
        validated with ONE vectorized ``paths_matrix`` pass: if no mover
        appears on any target's root path, every target's ancestry is
        invariant under the whole batch, so all sequential cycle checks
        are guaranteed to pass and the per-move walks are skipped.
        Interacting batches fall back to sequential validation; with
        ``strict=False`` invalid moves are skipped instead of raising.
        Returns the list of applied ``(node, new_parent)`` pairs."""
        tree = self.trees[app_id]
        pairs = [(int(n), int(p)) for n, p in moves]
        if not pairs:
            return []
        nodes = np.asarray([n for n, _ in pairs], np.int64)
        targets = np.asarray([p for _, p in pairs], np.int64)
        fast = len(np.unique(nodes)) == len(nodes)
        if fast:
            try:
                mat = tree.paths_matrix(targets)
            except (KeyError, RuntimeError):
                fast = False
            else:
                fast = not np.isin(mat, nodes).any() and all(
                    n != tree.root and n in tree.parent for n in nodes.tolist()
                )
        if fast:
            for n, p in pairs:
                self._regraft_edge(tree, n, p)
            return pairs
        applied: list[tuple[int, int]] = []
        for n, p in pairs:
            try:
                self._check_regraft(tree, n, p)
            except (KeyError, ValueError):
                if strict:
                    raise
                continue
            self._regraft_edge(tree, n, p)
            applied.append((n, p))
        return applied

    def unsubscribe_one(self, app_id: int, node: int) -> None:
        """Scalar LEAVE with relay splice — the oracle for
        :meth:`unsubscribe_many`.  A leaving interior node hands its
        children to its parent (in child order, through the shared
        re-graft primitive) and is then pruned exactly like
        :meth:`unsubscribe`; the root only drops membership (masters
        leave through recovery, not LEAVE)."""
        tree = self.trees[app_id]
        tree.members.discard(node)
        if node == tree.root or node not in tree.parent:
            return
        kids = tree.children.get(node)
        if kids:
            p = tree.parent[node]
            for c in list(kids):
                self._regraft_edge(tree, c, p)
        self.unsubscribe(app_id, node)

    def unsubscribe_many(self, app_id: int, nodes) -> None:
        """Bulk LEAVE (mass-leave / zone-outage repair).  Drops all
        memberships, splices each leaving relay's children to its current
        parent in input order (same primitive as :meth:`unsubscribe_one`),
        then prunes the dead chains with a vectorized fixpoint: each round
        is one array mask over the candidate set (attached, childless,
        non-member, non-root), the pruned batch's parents become the next
        candidates.  Splices commute with deferred pruning (a spliced-out
        leaver is never again a splice target, and linked-list removals
        preserve the order of survivors), so the result is node-for-node
        identical to sequential :meth:`unsubscribe_one` calls
        (tests/test_placement.py)."""
        tree = self.trees[app_id]
        leave = [int(n) for n in nodes]
        if not leave:
            return
        for n in leave:
            tree.members.discard(n)
        for n in leave:
            if n == tree.root or n not in tree.parent:
                continue
            kids = tree.children.get(n)
            if kids:
                p = tree.parent[n]
                for c in list(kids):
                    self._regraft_edge(tree, c, p)
        cand = np.unique(np.asarray([n for n in leave if n != tree.root], np.int64))
        while len(cand):
            cache = tree._ensure_cache()
            srt, slots_srt = cache["ids_sorted"], cache["slots_sorted"]
            if len(srt) == 0:
                break
            j = np.searchsorted(srt, cand)
            jj = np.minimum(j, len(srt) - 1)
            known = (j < len(srt)) & (srt[jj] == cand)
            cs = slots_srt[jj[known]]
            ids = cand[known]
            if len(ids) == 0:
                break
            childless = ~(tree._ch_present[cs] & (tree._ch_len[cs] > 0))
            attached = tree._par[cs] >= 0
            marr = (
                np.fromiter(tree.members, np.int64, len(tree.members))
                if tree.members
                else np.empty(0, np.int64)
            )
            mask = childless & attached & (ids != tree.root) & ~np.isin(ids, marr)
            doomed = cs[mask]
            if len(doomed) == 0:
                break
            parents = np.unique(tree._ids[tree._par[doomed]])
            for s in doomed.tolist():
                nid = int(tree._ids[s])
                p = tree.parent.pop(nid)
                tree.children[p].remove(nid)
            cand = parents

    # -- AD tree (advertise / discover) ---------------------------------------

    def _ensure_ad_tree(self) -> DataflowTree:
        if self.ad_tree is None:
            ad_id = self.app_id_of(AD_TOPIC)
            root = self._rendezvous(ad_id, None)
            self.ad_tree = DataflowTree(app_id=ad_id, root=root, meta={"name": AD_TOPIC})
        return self.ad_tree

    def _advertise(self, app_id: int, meta: dict) -> None:
        """The new master JOINs the AD tree and pushes (AppId, meta) to its
        root, which maintains the registry (paper Appendix A)."""
        ad = self._ensure_ad_tree()
        master = self.trees[app_id].root
        if master != ad.root and master not in ad.parent:
            res = self.overlay.route(master, ad.app_id)
            ad.members.add(master)
            self._graft_path(ad, res.path)
        self.ad_registry[app_id] = dict(meta)

    def discover(self, node: int, *, leave_after: bool = True) -> dict[int, dict]:
        """A node subscribes to the AD tree, receives the registry of running
        applications, and (by default) leaves immediately."""
        ad = self._ensure_ad_tree()
        res = self.overlay.route(node, ad.app_id)
        registry = dict(self.ad_registry)
        if not leave_after:
            ad.members.add(node)
            self._graft_path(ad, res.path)
        return registry

    # -- stats ----------------------------------------------------------------

    def masters_per_node(self) -> dict[int, int]:
        out: dict[int, int] = {}
        for t in self.trees.values():
            out[t.root] = out.get(t.root, 0) + 1
        return out
