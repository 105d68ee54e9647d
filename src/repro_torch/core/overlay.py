"""Layer 1: locality-aware P2P multi-ring structure (paper §IV-B).

Edge nodes self-organize into m zone rings via Ratnasamy–Shenker
distributed binning over landmark RTTs.  Each node keeps:
  - a two-level routing table — level 1 fingers across zones at
    (P_x + 2^{i-1}) mod 2^m (scaled by 2^n), level 2 fingers within the
    zone at (S_y + j*2^{b*i}) mod 2^n for digits j in [1, 2^b) — per the
    paper's table definition, generalized to base 2^b so the dataflow-tree
    fanout is configurable (the paper evaluates b = 3, 4, 5);
  - a leaf set (closest ids both sides, for repair + final delivery);
  - a neighborhood set (physically closest nodes, for state replication).

Scaling note: tables are evaluated *by rule* against the live membership
(sorted-array successor lookup) rather than materialized per node, so the
simulator routes on 10^6-node rings while following exactly the hop
sequence a materialized table would produce; ``routing_table_of``
materializes a node's table for inspection/tests.  Routing never uses
global knowledge beyond each hop's own entries.

Array-of-structs layout (the "scale layer", docs/performance.md): node
state lives in flat numpy arrays — append-only id/coord/bandwidth rows
plus an alive mask — and each zone ring is a sorted int64 suffix array
with a parallel row array, grown in place with capacity doubling.  The
public mapping/set attributes (``coords``, ``bandwidth``, ``alive``,
``zone_members``) are thin views over those arrays, so ``forest.py``,
``pathplan.py`` and ``recovery.py`` run unchanged against either layout.
``route_many`` resolves a whole batch of routes in vectorized ring/prefix
arithmetic, hop-for-hop identical to the scalar ``route`` oracle, and
``neighborhood_set`` is backed by an incremental spatial-grid index
instead of a full per-call sort.
"""
from __future__ import annotations

import math
from collections.abc import Mapping, Set
from dataclasses import dataclass

import numpy as np

from .nodeid import IdSpace, abs_ring_distance, ring_distance


@dataclass
class RouteResult:
    path: list[int]  # node ids visited (src first, destination last)
    hops: int
    blocked: bool = False  # administrative isolation block

    @property
    def dest(self) -> int:
        return self.path[-1]


@dataclass
class RouteBatch:
    """Result of ``route_many``: per-route arrays + lazy path recovery.

    ``hops[k]`` / ``dest[k]`` / ``blocked[k]`` / ``latency_ms[k]`` mirror
    the scalar ``RouteResult`` fields of route ``k``; ``path(k)``
    reconstructs the visited node list from the per-iteration snapshots
    (stored as one int64 array per executed hop iteration, not one list
    per route, so a million-route batch stays a handful of arrays).
    """

    hops: np.ndarray  # (K,) int64
    dest: np.ndarray  # (K,) int64 node ids
    blocked: np.ndarray  # (K,) bool
    latency_ms: np.ndarray  # (K,) float64
    _hist: list[np.ndarray]  # per-iteration cur snapshots

    def __len__(self) -> int:
        return len(self.hops)

    def path(self, k: int) -> list[int]:
        """Visited node ids of route ``k`` (src first, destination last)."""
        out = [int(self._hist[0][k])]
        for snap in self._hist[1:]:
            nid = int(snap[k])
            if nid != out[-1]:
                out.append(nid)
        return out

    def result(self, k: int) -> RouteResult:
        return RouteResult(self.path(k), int(self.hops[k]), bool(self.blocked[k]))

    def paths_flat(self) -> tuple[np.ndarray, np.ndarray]:
        """All paths at once as a CSR pair ``(flat, offsets)``:
        ``flat[offsets[k]:offsets[k+1]]`` equals ``path(k)`` (consecutive
        duplicates dropped, src first).  One boolean mask over the
        stacked snapshots instead of K Python reconstructions."""
        H = np.stack(self._hist, axis=1)  # (K, T)
        keep = np.ones(H.shape, bool)
        keep[:, 1:] = H[:, 1:] != H[:, :-1]
        lens = keep.sum(axis=1)
        offsets = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        return H[keep], offsets


# ---------------------------------------------------------------------------
# storage primitives


class _ZoneRing:
    """One zone's membership: sorted suffix array + parallel row array.

    Capacity-managed in place (memmove inside the buffer, doubling on
    overflow) so a single join/leave is O(n_zone) element moves with no
    realloc churn, and the live views are zero-copy slices.
    """

    __slots__ = ("suf", "row", "n")

    def __init__(self, capacity: int = 8):
        self.suf = np.empty(max(8, capacity), np.int64)
        self.row = np.empty(max(8, capacity), np.int64)
        self.n = 0

    def view(self) -> np.ndarray:
        return self.suf[: self.n]

    def rows(self) -> np.ndarray:
        return self.row[: self.n]

    def _grow(self, need: int) -> None:
        cap = len(self.suf)
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        for name in ("suf", "row"):
            old = getattr(self, name)
            new = np.empty(cap, np.int64)
            new[: self.n] = old[: self.n]
            setattr(self, name, new)

    def insert(self, i: int, suffix: int, row: int) -> None:
        self._grow(self.n + 1)
        self.suf[i + 1 : self.n + 1] = self.suf[i : self.n]
        self.row[i + 1 : self.n + 1] = self.row[i : self.n]
        self.suf[i] = suffix
        self.row[i] = row
        self.n += 1

    def pop(self, i: int) -> int:
        row = int(self.row[i])
        self.suf[i : self.n - 1] = self.suf[i + 1 : self.n]
        self.row[i : self.n - 1] = self.row[i + 1 : self.n]
        self.n -= 1
        return row

    def bulk_add(self, sufs: np.ndarray, rows: np.ndarray) -> None:
        """Merge a sorted, collision-free batch into the ring in one pass."""
        k = len(sufs)
        if k == 0:
            return
        self._grow(self.n + k)
        merged_suf = np.empty(self.n + k, np.int64)
        merged_row = np.empty(self.n + k, np.int64)
        pos = np.searchsorted(self.suf[: self.n], sufs) + np.arange(k)
        mask = np.zeros(self.n + k, bool)
        mask[pos] = True
        merged_suf[pos], merged_row[pos] = sufs, rows
        merged_suf[~mask], merged_row[~mask] = self.suf[: self.n], self.row[: self.n]
        self.n += k
        self.suf[: self.n] = merged_suf
        self.row[: self.n] = merged_row


class _SpatialGrid:
    """Incremental uniform-grid index over alive node coordinates.

    Cells are a dict keyed by integer cell coords, holding row lists.
    ``knn`` expands Chebyshev cell rings outward and stops once the
    k-th best candidate provably beats every unscanned cell, so a
    neighborhood query touches O(k) nodes instead of sorting all N.
    Maintained incrementally on join/leave/fail; the overlay rebuilds it
    (lazily) when the population drifts far from the build-time size.
    """

    __slots__ = ("h", "x0", "y0", "cells", "built_n", "cmin", "cmax")

    def __init__(self, xy: np.ndarray, rows: np.ndarray):
        n = max(1, len(rows))
        if len(rows):
            x0, y0 = float(xy[rows, 0].min()), float(xy[rows, 1].min())
            span = max(
                float(xy[rows, 0].max()) - x0, float(xy[rows, 1].max()) - y0
            )
        else:
            x0 = y0 = span = 0.0
        self.x0, self.y0 = x0, y0
        self.h = span / max(4.0, math.sqrt(n))
        if self.h <= 0.0:
            self.h = 1.0
        self.cells: dict[tuple[int, int], list[int]] = {}
        self.built_n = len(rows)
        self.cmin = [0, 0]
        self.cmax = [0, 0]
        for r in rows:
            self.add(int(r), float(xy[r, 0]), float(xy[r, 1]))

    def _cell(self, x: float, y: float) -> tuple[int, int]:
        return (int((x - self.x0) // self.h), int((y - self.y0) // self.h))

    def add(self, row: int, x: float, y: float) -> None:
        c = self._cell(x, y)
        self.cells.setdefault(c, []).append(row)
        self.cmin = [min(self.cmin[0], c[0]), min(self.cmin[1], c[1])]
        self.cmax = [max(self.cmax[0], c[0]), max(self.cmax[1], c[1])]

    def remove(self, row: int, x: float, y: float) -> None:
        c = self._cell(x, y)
        bucket = self.cells.get(c)
        if bucket is not None:
            try:
                bucket.remove(row)
            except ValueError:
                pass
            if not bucket:
                del self.cells[c]

    def knn(self, x: float, y: float, k: int, exclude_row: int,
            xy: np.ndarray) -> np.ndarray:
        """Rows of the k nearest alive nodes, sorted by (dist^2, row order
        resolved by the caller).  Returns candidate rows (>= k when
        available) whose k nearest are guaranteed correct."""
        cx, cy = self._cell(x, y)
        max_r = max(
            cx - self.cmin[0], self.cmax[0] - cx,
            cy - self.cmin[1], self.cmax[1] - cy, 0,
        )
        cand: list[int] = []
        d2 = np.empty(0)
        for r in range(max_r + 1):
            if r == 0:
                coords_iter = [(cx, cy)]
            else:
                coords_iter = (
                    [(i, cy - r) for i in range(cx - r, cx + r + 1)]
                    + [(i, cy + r) for i in range(cx - r, cx + r + 1)]
                    + [(cx - r, j) for j in range(cy - r + 1, cy + r)]
                    + [(cx + r, j) for j in range(cy - r + 1, cy + r)]
                )
            ring_rows: list[int] = []
            for c in coords_iter:
                bucket = self.cells.get(c)
                if bucket:
                    ring_rows.extend(bucket)
            if ring_rows:
                rr = np.asarray(
                    [q for q in ring_rows if q != exclude_row], np.int64
                )
                if len(rr):
                    dd = (xy[rr, 0] - x) ** 2 + (xy[rr, 1] - y) ** 2
                    cand.extend(rr.tolist())
                    d2 = np.concatenate([d2, dd])
            # stop once the k-th best beats anything beyond ring r:
            # every unscanned point is at Chebyshev cell distance > r,
            # hence Euclidean distance >= r*h from the query point.
            if len(cand) >= k:
                kth = np.partition(d2, k - 1)[k - 1]
                if kth <= (r * self.h) ** 2:
                    break
        return np.asarray(cand, np.int64)


# ---------------------------------------------------------------------------
# thin views: the legacy dict/set API over the array layout


class _CoordView(Mapping):
    __slots__ = ("_ov",)

    def __init__(self, ov: "MultiRingOverlay"):
        self._ov = ov

    def __getitem__(self, nid: int) -> tuple[float, float]:
        row = self._ov._row_of(nid)
        if row < 0:
            raise KeyError(nid)
        x, y = self._ov._xy[row]
        return (float(x), float(y))

    def __contains__(self, nid) -> bool:
        return self._ov._row_of(nid) >= 0

    def __iter__(self):
        return iter(self._ov._known_ids())

    def __len__(self) -> int:
        return len(self._ov._known_ids())


class _BandwidthView(Mapping):
    __slots__ = ("_ov",)

    def __init__(self, ov: "MultiRingOverlay"):
        self._ov = ov

    def __getitem__(self, nid: int) -> float:
        row = self._ov._row_of(nid)
        if row < 0:
            raise KeyError(nid)
        return float(self._ov._bw[row])

    def __contains__(self, nid) -> bool:
        return self._ov._row_of(nid) >= 0

    def __iter__(self):
        return iter(self._ov._known_ids())

    def __len__(self) -> int:
        return len(self._ov._known_ids())


class _AliveView(Set):
    __slots__ = ("_ov",)

    def __init__(self, ov: "MultiRingOverlay"):
        self._ov = ov

    @classmethod
    def _from_iterable(cls, it):
        return set(it)  # set algebra on the view yields plain sets

    def __contains__(self, nid) -> bool:
        ring = self._ov._rings.get(self._ov.space.zone_of(nid))
        if ring is None or ring.n == 0:
            return False
        suf = self._ov.space.suffix_of(nid)
        i = int(np.searchsorted(ring.view(), suf))
        return i < ring.n and ring.suf[i] == suf

    def __iter__(self):
        space = self._ov.space
        for z, ring in self._ov._rings.items():
            base = z * space.suffix_space
            for s in ring.view().tolist():
                yield base + s

    def __len__(self) -> int:
        return self._ov._num_alive


class _ZoneMembersView(Mapping):
    """zone -> sorted suffix array (live view; supports len/index/iter)."""

    __slots__ = ("_ov",)
    _EMPTY = np.empty(0, np.int64)

    def __init__(self, ov: "MultiRingOverlay"):
        self._ov = ov

    def __getitem__(self, zone: int) -> np.ndarray:
        ring = self._ov._rings.get(zone)
        if ring is None:
            raise KeyError(zone)
        return ring.view()

    def get(self, zone: int, default=None):
        ring = self._ov._rings.get(zone)
        if ring is None:
            return default
        return ring.view()

    def __contains__(self, zone) -> bool:
        return zone in self._ov._rings

    def __iter__(self):
        return iter(self._ov._rings)

    def __len__(self) -> int:
        return len(self._ov._rings)


# ---------------------------------------------------------------------------


class MultiRingOverlay:
    def __init__(
        self,
        space: IdSpace,
        *,
        base_bits: int = 4,
        leaf_size: int = 24,
        neighborhood_size: int = 8,
        seed: int = 0,
    ):
        self.space = space
        self.b = base_bits
        self.leaf_size = leaf_size
        self.neighborhood_size = neighborhood_size
        self.rng = np.random.default_rng(seed)
        # flat node rows (append-only; alive mask distinguishes the dead)
        cap = 64
        self._ids = np.empty(cap, np.int64)
        self._xy = np.empty((cap, 2), np.float64)
        self._bw = np.empty(cap, np.float64)
        self._alive_mask = np.zeros(cap, bool)
        self._nrows = 0
        self._num_alive = 0
        self._dead_rows: dict[int, int] = {}  # node_id -> row (post-leave attrs)
        # per-zone sorted rings
        self._rings: dict[int, _ZoneRing] = {}
        self._occupancy_epoch = 0  # bumps when a zone flips empty<->nonempty
        self._nearest_cache: tuple[int, np.ndarray] | None = None
        self._grid: _SpatialGrid | None = None
        # legacy mapping/set API as thin views over the arrays
        self.zone_members = _ZoneMembersView(self)
        self.coords = _CoordView(self)
        self.alive = _AliveView(self)
        self.bandwidth = _BandwidthView(self)
        self.physical_group: dict[int, int] = {}  # logical id -> physical id (App. L)

    # -- flat-row plumbing ---------------------------------------------------

    def _grow_rows(self, need: int) -> None:
        cap = len(self._ids)
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        n = self._nrows
        for name, shape in (("_ids", (cap,)), ("_xy", (cap, 2)),
                            ("_bw", (cap,)), ("_alive_mask", (cap,))):
            old = getattr(self, name)
            new = np.zeros(shape, old.dtype)
            new[:n] = old[:n]
            setattr(self, name, new)

    def _append_rows(self, ids, xy, bw) -> np.ndarray:
        k = len(ids)
        self._grow_rows(self._nrows + k)
        rows = np.arange(self._nrows, self._nrows + k, dtype=np.int64)
        self._ids[rows] = ids
        self._xy[rows] = xy
        self._bw[rows] = bw
        self._alive_mask[rows] = True
        self._nrows += k
        return rows

    def _row_of(self, nid: int) -> int:
        """Row of ``nid`` — alive (ring lookup) or dead (retained attrs)."""
        ring = self._rings.get(self.space.zone_of(nid))
        if ring is not None and ring.n:
            suf = self.space.suffix_of(nid)
            i = int(np.searchsorted(ring.view(), suf))
            if i < ring.n and ring.suf[i] == suf:
                return int(ring.row[i])
        return self._dead_rows.get(nid, -1)

    def _known_ids(self) -> list[int]:
        out = self.nodes()
        out.extend(self._dead_rows)
        return out

    # -- membership ---------------------------------------------------------

    def join(self, zone: int, suffix: int, coord=(0.0, 0.0), bandwidth: float = 100.0) -> int:
        nid = self.space.make(zone, suffix)
        ring = self._rings.get(zone)
        if ring is None:
            ring = self._rings[zone] = _ZoneRing()
        i = int(np.searchsorted(ring.view(), suffix))
        if i < ring.n and ring.suf[i] == suffix:
            raise ValueError(f"suffix collision {suffix} in zone {zone}")
        if ring.n == 0:
            self._occupancy_epoch += 1
        x, y = float(coord[0]), float(coord[1])
        row = int(self._append_rows([nid], [(x, y)], [float(bandwidth)])[0])
        ring.insert(i, suffix, row)
        self._dead_rows.pop(nid, None)
        self._num_alive += 1
        if self._grid is not None:
            self._grid.add(row, x, y)
        return int(nid)

    def join_random(self, zone: int, coord=(0.0, 0.0), bandwidth: float = 100.0) -> int:
        while True:
            suffix = int(self.rng.integers(0, self.space.suffix_space))
            try:
                return self.join(zone, suffix, coord, bandwidth)
            except ValueError:
                continue

    def join_weighted(self, zone: int, units: int, coord=(0.0, 0.0), bandwidth: float = 100.0) -> list[int]:
        """Appendix L: heterogeneous resources via LOGICAL nodes — a
        physical node with ``units`` resource units joins as that many
        P2P nodes (more units => proportionally more master assignments);
        the ids are recorded as one physical group for accounting."""
        ids = [self.join_random(zone, coord, bandwidth) for _ in range(max(1, units))]
        group = ids[0]
        for nid in ids:
            self.physical_group[nid] = group
        return ids

    def join_many(
        self,
        zones: np.ndarray,
        coords: np.ndarray | None = None,
        bandwidth: np.ndarray | float = 100.0,
        suffixes: np.ndarray | None = None,
    ) -> np.ndarray:
        """Bulk join: K nodes in one vectorized pass (the million-node
        build path — per-node ``join`` is O(n_zone) moves each, this is
        one sort per zone).  ``suffixes=None`` draws unique random
        suffixes per zone from the overlay rng.  Returns node ids (K,)."""
        zones = np.asarray(zones, np.int64)
        k = len(zones)
        if k == 0:
            return np.empty(0, np.int64)
        coords = (np.zeros((k, 2)) if coords is None
                  else np.asarray(coords, np.float64).reshape(k, 2))
        bw = np.broadcast_to(np.asarray(bandwidth, np.float64), (k,))
        out = np.empty(k, np.int64)
        order = np.argsort(zones, kind="stable")
        zs = zones[order]
        bounds = np.flatnonzero(np.diff(zs)) + 1
        for idx in np.split(order, bounds):
            z = int(zones[idx[0]])
            ring = self._rings.get(z)
            if ring is None:
                ring = self._rings[z] = _ZoneRing()
            if ring.n == 0:
                self._occupancy_epoch += 1
            if suffixes is None:
                sufs = self._draw_unique_suffixes(z, len(idx))
            else:
                sufs = np.asarray(suffixes, np.int64)[idx]
                srt = np.argsort(sufs, kind="stable")
                sufs, idx = sufs[srt], idx[srt]
                if len(np.unique(sufs)) != len(sufs) or (
                    ring.n and np.any(np.isin(sufs, ring.view()))
                ):
                    raise ValueError(f"suffix collision in zone {z}")
            ids = z * self.space.suffix_space + sufs
            rows = self._append_rows(ids, coords[idx], bw[idx])
            ring.bulk_add(sufs, rows)
            out[idx] = ids
            for nid in ids.tolist():
                self._dead_rows.pop(nid, None)
        self._num_alive += k
        self._grid = None  # rebuild lazily at the new population
        return out

    def _draw_unique_suffixes(self, zone: int, k: int) -> np.ndarray:
        """k fresh suffixes for ``zone``: unique and collision-free."""
        ring = self._rings.get(zone)
        existing = ring.view() if ring is not None else np.empty(0, np.int64)
        space = self.space.suffix_space
        if k + len(existing) > space:
            raise ValueError(f"zone {zone} suffix space exhausted")
        picked = np.empty(0, np.int64)
        while len(picked) < k:
            draw = self.rng.integers(0, space, size=int((k - len(picked)) * 1.1) + 16)
            draw = np.unique(draw.astype(np.int64))
            if len(existing):
                draw = draw[~np.isin(draw, existing)]
            if len(picked):
                draw = draw[~np.isin(draw, picked)]
            picked = np.concatenate([picked, draw])
        # keep sorted order (np.unique already sorts; concat of leftovers may not)
        return np.sort(picked[:k])

    def leave(self, node_id: int) -> None:
        zone, suffix = self.space.zone_of(node_id), self.space.suffix_of(node_id)
        ring = self._rings.get(zone)
        if ring is None or ring.n == 0:
            return
        i = int(np.searchsorted(ring.view(), suffix))
        if i >= ring.n or ring.suf[i] != suffix:
            return
        row = ring.pop(i)
        if ring.n == 0:
            self._occupancy_epoch += 1
        self._alive_mask[row] = False
        self._dead_rows[node_id] = row
        self._num_alive -= 1
        if self._grid is not None:
            self._grid.remove(row, float(self._xy[row, 0]), float(self._xy[row, 1]))

    def fail(self, node_id: int) -> None:
        """Crash-fail (no graceful handoff) — same membership effect."""
        self.leave(node_id)

    @property
    def num_nodes(self) -> int:
        return self._num_alive

    def zones(self) -> list[int]:
        return [z for z, ring in self._rings.items() if ring.n]

    def nodes(self) -> list[int]:
        out: list[int] = []
        space = self.space.suffix_space
        for z in sorted(self._rings):
            ring = self._rings[z]
            if ring.n:
                out.extend((z * space + ring.view()).tolist())
        return out

    def node_array(self) -> np.ndarray:
        """All alive node ids, sorted, as one int64 array (no copy loop)."""
        space = self.space.suffix_space
        parts = [
            z * space + self._rings[z].view()
            for z in sorted(self._rings)
            if self._rings[z].n
        ]
        return np.concatenate(parts) if parts else np.empty(0, np.int64)

    # -- successor / closest lookups (the "by-rule" table evaluation) --------

    def _zone_successor(self, zone: int, suffix: int) -> int | None:
        ring = self._rings.get(zone)
        if ring is None or ring.n == 0:
            return None
        i = int(np.searchsorted(ring.view(), suffix)) % ring.n
        return self.space.make(zone, int(ring.suf[i]))

    def _zone_closest(self, zone: int, suffix: int) -> int | None:
        ring = self._rings.get(zone)
        if ring is None or ring.n == 0:
            return None
        i = int(np.searchsorted(ring.view(), suffix))
        succ = int(ring.suf[i % ring.n])
        pred = int(ring.suf[(i - 1) % ring.n])
        space = self.space.suffix_space
        # deterministic tie-break: ties go clockwise (the successor), the
        # same convention as nodeid.numerically_closest — and the same
        # rule the vectorized route_many applies.
        if abs_ring_distance(suffix, succ, space) <= abs_ring_distance(suffix, pred, space):
            return self.space.make(zone, succ)
        return self.space.make(zone, pred)

    def nearest_zone(self, zone: int) -> int | None:
        """Next non-empty zone clockwise from `zone` (incl. itself)."""
        for d in range(self.space.num_zones):
            z = (zone + d) % self.space.num_zones
            ring = self._rings.get(z)
            if ring is not None and ring.n:
                return z
        return None

    def _nearest_zone_arr(self) -> np.ndarray:
        """nearest_zone for every zone as one int64 array (-1 = none),
        cached per occupancy epoch."""
        if self._nearest_cache is not None and self._nearest_cache[0] == self._occupancy_epoch:
            return self._nearest_cache[1]
        occ = np.asarray(sorted(self.zones()), np.int64)
        nz = np.arange(self.space.num_zones, dtype=np.int64)
        if len(occ) == 0:
            arr = np.full(self.space.num_zones, -1, np.int64)
        else:
            arr = occ[np.searchsorted(occ, nz) % len(occ)]
        self._nearest_cache = (self._occupancy_epoch, arr)
        return arr

    # -- leaf / neighborhood sets --------------------------------------------

    def leaf_set(self, node_id: int) -> list[int]:
        zone, suffix = self.space.zone_of(node_id), self.space.suffix_of(node_id)
        ring = self._rings.get(zone)
        if ring is None or ring.n <= 1:
            return []
        members = ring.view()
        i = int(np.searchsorted(members, suffix))
        half = self.leaf_size // 2
        out = []
        for d in range(1, half + 1):
            out.append(self.space.make(zone, int(members[(i + d) % ring.n])))
            out.append(self.space.make(zone, int(members[(i - d) % ring.n])))
        return [x for x in dict.fromkeys(out) if x != node_id]

    def _ensure_grid(self) -> _SpatialGrid:
        g = self._grid
        n = self._num_alive
        if g is None or n > 4 * g.built_n + 8 or n < g.built_n // 4:
            rows = np.flatnonzero(self._alive_mask[: self._nrows])
            g = self._grid = _SpatialGrid(self._xy, rows)
        return g

    def neighborhood_set(self, node_id: int) -> list[int]:
        """Physically closest live nodes (for master state replication).

        Served from the incremental spatial-grid index: O(k) cells
        visited per query instead of a full O(N log N) sort of every
        live node (ties broken by node id, deterministically)."""
        row = self._row_of(node_id)
        if row < 0:
            raise KeyError(node_id)
        x, y = float(self._xy[row, 0]), float(self._xy[row, 1])
        grid = self._ensure_grid()
        cand = grid.knn(x, y, self.neighborhood_size, row, self._xy)
        if len(cand) == 0:
            return []
        ids = self._ids[cand]
        d2 = (self._xy[cand, 0] - x) ** 2 + (self._xy[cand, 1] - y) ** 2
        order = np.lexsort((ids, d2))
        return ids[order[: self.neighborhood_size]].tolist()

    def neighborhood_set_bruteforce(self, node_id: int) -> list[int]:
        """Reference implementation (full sort) — the grid-index oracle."""
        row = self._row_of(node_id)
        if row < 0:
            raise KeyError(node_id)
        x, y = float(self._xy[row, 0]), float(self._xy[row, 1])
        rows = np.flatnonzero(self._alive_mask[: self._nrows])
        rows = rows[rows != row]
        ids = self._ids[rows]
        d2 = (self._xy[rows, 0] - x) ** 2 + (self._xy[rows, 1] - y) ** 2
        order = np.lexsort((ids, d2))
        return ids[order[: self.neighborhood_size]].tolist()

    # -- routing -------------------------------------------------------------

    def _digit_prefix_len(self, a: int, b_: int, b: int | None = None) -> int:
        """Common prefix length in base-2^b digits, MSB first."""
        b = b or self.b
        n = self.space.suffix_bits
        rows = (n + b - 1) // b
        for p in range(rows):
            shift = max(0, n - b * (p + 1))
            if (a >> shift) != (b_ >> shift):
                return p
        return rows

    def _next_hop_in_zone(
        self, cur_suffix: int, key_suffix: int, zone: int, b: int | None = None
    ) -> int | None:
        """Pastry-style digit-fixing hop: jump to the canonical node of the
        range sharing one more base-2^b digit with the key.  Canonical =
        clockwise successor of the range start, so paths from different
        sources CONVERGE (the paper's path-convergence property) and tree
        fanout is bounded by 2^b (+ leaf-set final hops)."""
        b = b or self.b
        n = self.space.suffix_bits
        rows = (n + b - 1) // b
        p = self._digit_prefix_len(cur_suffix, key_suffix, b)
        while p < rows:
            shift = max(0, n - b * (p + 1))
            # Plaxton rule: fix the key's next digit, KEEP the source's
            # remaining digits — paths from different sources spread across
            # the range and converge progressively (bounded tree fanout),
            # instead of all landing on one canonical node per level.
            target = ((key_suffix >> shift) << shift) | (cur_suffix & ((1 << shift) - 1))
            nxt = self._zone_successor(zone, target)
            if nxt is None:
                return None
            ns = self.space.suffix_of(nxt)
            if (ns >> shift) == (key_suffix >> shift) and ns != cur_suffix:
                return nxt
            p += 1  # empty range: try to fix the next digit
        # all populated ranges exhausted: leaf-set final hop
        nxt = self._zone_closest(zone, key_suffix)
        return nxt if nxt is not None and self.space.suffix_of(nxt) != cur_suffix else None

    def route(
        self,
        src: int,
        key: int,
        *,
        restrict_zone: int | None = None,
        base_bits: int | None = None,
        max_hops: int | None = None,
    ) -> RouteResult:
        """Greedy two-level prefix/finger routing to the node numerically
        closest to `key`.  ``restrict_zone`` enforces administrative
        isolation (level-1 entries disabled; cross-zone packets blocked);
        ``base_bits`` overrides the digit base 2^b for this route only
        (per-tree fanout — one app's choice must not leak into others)."""
        space = self.space
        cur = src
        path = [cur]
        key_zone, key_suffix = space.zone_of(key), space.suffix_of(key)
        max_hops = max_hops or (4 * space.total_bits)

        for _ in range(max_hops):
            cur_zone = space.zone_of(cur)
            if restrict_zone is not None and cur_zone != restrict_zone:
                return RouteResult(path, len(path) - 1, blocked=True)

            if cur_zone != key_zone and restrict_zone is None:
                # level 1: finger across zones toward the key's zone
                target_zone = self.nearest_zone(key_zone)
                if target_zone is None:
                    break
                if target_zone == cur_zone:
                    key_zone = cur_zone  # key's zone empty -> deliver here
                    continue
                dz = ring_distance(cur_zone, target_zone, space.num_zones)
                step = 1 << (dz.bit_length() - 1)
                hop_zone = (cur_zone + step) % space.num_zones
                hop_zone = self.nearest_zone(hop_zone)
                # land near the *source's* suffix (spread; suffix digits are
                # fixed by level-2 routing once inside the key's zone)
                nxt = self._zone_closest(hop_zone, space.suffix_of(cur))
                if nxt is None or nxt == cur:
                    break
                cur = nxt
                path.append(cur)
                continue

            if restrict_zone is not None and key_zone != restrict_zone:
                key_zone = restrict_zone  # deliver within the restricted ring

            # destination reached: the numerically closest node in the zone
            if cur == self._zone_closest(cur_zone, key_suffix):
                break

            # level 2: canonical digit-fixing within the zone
            nxt = self._next_hop_in_zone(space.suffix_of(cur), key_suffix, cur_zone, base_bits)
            if nxt is None or nxt == cur or nxt in path[-2:]:
                # no better hop / would cycle: deliver via leaf set
                final = self._zone_closest(cur_zone, key_suffix)
                if final is not None and final != cur and final not in path:
                    path.append(final)
                break
            cur = nxt
            path.append(cur)

        return RouteResult(path, len(path) - 1)

    # -- vectorized routing (the scale layer) ---------------------------------

    def _by_zone(self, zones: np.ndarray):
        """Yield (zone, index-array) groups for a zone array."""
        order = np.argsort(zones, kind="stable")
        zs = zones[order]
        bounds = np.flatnonzero(np.diff(zs)) + 1
        for idx in np.split(order, bounds):
            yield int(zones[idx[0]]), idx

    def _zone_lookup_many(self, zones: np.ndarray, suffixes: np.ndarray,
                          closest: bool):
        """Vectorized `_zone_successor` (closest=False) / `_zone_closest`
        (closest=True): returns (suffix, row) arrays; suffix = -1 where
        the zone is empty."""
        out_suf = np.full(len(zones), -1, np.int64)
        out_row = np.full(len(zones), -1, np.int64)
        space = self.space.suffix_space
        for z, idx in self._by_zone(zones):
            ring = self._rings.get(z)
            if ring is None or ring.n == 0:
                continue
            members, rows = ring.view(), ring.rows()
            i = np.searchsorted(members, suffixes[idx])
            if closest:
                si, pi = i % ring.n, (i - 1) % ring.n
                succ, pred = members[si], members[pi]
                ds = np.abs(succ - suffixes[idx])
                ds = np.minimum(ds % space, (-ds) % space)
                dp = np.abs(pred - suffixes[idx])
                dp = np.minimum(dp % space, (-dp) % space)
                take_succ = ds <= dp  # ties -> clockwise, same as scalar
                pick = np.where(take_succ, si, pi)
            else:
                pick = i % ring.n
            out_suf[idx] = members[pick]
            out_row[idx] = rows[pick]
        return out_suf, out_row

    @staticmethod
    def _bit_length(x: np.ndarray) -> np.ndarray:
        """Vectorized int.bit_length for non-negative int64 < 2**52."""
        return np.frexp(x.astype(np.float64))[1].astype(np.int64)

    def _prefix_len_many(self, a: np.ndarray, b_: np.ndarray, b: int) -> np.ndarray:
        """Vectorized `_digit_prefix_len` over suffix arrays."""
        n = self.space.suffix_bits
        rows = (n + b - 1) // b
        x = a ^ b_
        h = self._bit_length(x) - 1  # highest differing bit (x > 0)
        pl = (n - 1 - h) // b
        return np.where(x == 0, rows, pl)

    def _next_hop_in_zone_many(
        self, cur_suf: np.ndarray, key_suf: np.ndarray, zones: np.ndarray,
        b: int,
    ):
        """Vectorized `_next_hop_in_zone`: (suffix, row) per element,
        suffix = -1 where the scalar oracle returns None."""
        n = self.space.suffix_bits
        rows_total = (n + b - 1) // b
        k = len(cur_suf)
        out_suf = np.full(k, -1, np.int64)
        out_row = np.full(k, -1, np.int64)
        p = self._prefix_len_many(cur_suf, key_suf, b)
        pending = np.flatnonzero(p < rows_total)
        fallback = np.flatnonzero(p >= rows_total)
        while len(pending):
            shift = np.maximum(0, n - b * (p[pending] + 1))
            low_mask = (np.int64(1) << shift) - 1
            target = ((key_suf[pending] >> shift) << shift) | (cur_suf[pending] & low_mask)
            ns, nrow = self._zone_lookup_many(zones[pending], target, closest=False)
            ok = ((ns >> shift) == (key_suf[pending] >> shift)) & (ns != cur_suf[pending])
            hit = pending[ok]
            out_suf[hit] = ns[ok]
            out_row[hit] = nrow[ok]
            miss = pending[~ok]
            p[miss] += 1
            done_mask = p[miss] >= rows_total
            fallback = np.concatenate([fallback, miss[done_mask]])
            pending = miss[~done_mask]
        if len(fallback):
            cs, crow = self._zone_lookup_many(zones[fallback], key_suf[fallback], closest=True)
            ok = (cs >= 0) & (cs != cur_suf[fallback])
            hit = fallback[ok]
            out_suf[hit] = cs[ok]
            out_row[hit] = crow[ok]
        return out_suf, out_row

    def _rows_of_many(self, ids: np.ndarray) -> np.ndarray:
        """Rows of node ids (vectorized; dead nodes resolve via the
        retained-attribute table, -1 where entirely unknown)."""
        zones = ids >> self.space.suffix_bits
        sufs = ids & (self.space.suffix_space - 1)
        # the successor lookup returns the node itself when present
        suf_found, rows = self._zone_lookup_many(zones, sufs, closest=False)
        rows = np.where(suf_found == sufs, rows, -1)
        for i in np.flatnonzero(rows < 0):
            rows[i] = self._dead_rows.get(int(ids[i]), -1)
        return rows

    def route_many(
        self,
        sources: np.ndarray,
        keys: np.ndarray,
        *,
        restrict_zone: int | None = None,
        base_bits: int | None = None,
        max_hops: int | None = None,
    ) -> RouteBatch:
        """Batched ``route``: resolves every (source, key) pair in
        vectorized ring/prefix arithmetic — hop-for-hop identical to the
        scalar oracle (tests/test_scale.py pins path, hops and latency).

        One iteration advances every still-active route by at most one
        hop; per-iteration node snapshots are retained so full paths can
        be reconstructed (``RouteBatch.path``) and the scalar code's
        "final not already in path" delivery check is exact.
        """
        space = self.space
        sources = np.asarray(sources, np.int64)
        keys = np.asarray(keys, np.int64)
        k = len(sources)
        max_hops = max_hops or (4 * space.total_bits)
        cur = sources.copy()
        prev = np.full(k, -1, np.int64)  # path[-2] (cycle guard)
        hops = np.zeros(k, np.int64)
        blocked = np.zeros(k, bool)
        latency = np.zeros(k, np.float64)
        key_zone = keys >> space.suffix_bits
        key_suf = keys & (space.suffix_space - 1)
        active = np.ones(k, bool)
        hist = [cur.copy()]
        b = base_bits or self.b
        Z = space.num_zones
        cur_row = self._rows_of_many(cur) if k else np.empty(0, np.int64)

        def advance(idx: np.ndarray, nxt_id: np.ndarray, nxt_row: np.ndarray,
                    count_hop: bool = True) -> None:
            """Move routes ``idx`` to ``nxt_id`` and accumulate latency."""
            a, bxy = self._xy[cur_row[idx]], self._xy[nxt_row]
            d = np.sqrt(((a - bxy) ** 2).sum(axis=1))
            latency[idx] += 1.0 + 0.1 * d
            prev[idx] = cur[idx]
            cur[idx] = nxt_id
            cur_row[idx] = nxt_row
            if count_hop:
                hops[idx] += 1

        for _ in range(max_hops):
            act = np.flatnonzero(active)
            if len(act) == 0:
                break
            cur_zone = cur[act] >> space.suffix_bits
            cur_suf = cur[act] & (space.suffix_space - 1)

            if restrict_zone is not None:
                bad = cur_zone != restrict_zone
                blocked[act[bad]] = True
                active[act[bad]] = False
                act = act[~bad]
                cur_zone, cur_suf = cur_zone[~bad], cur_suf[~bad]
                # deliver within the restricted ring
                key_zone[act] = restrict_zone
                cross = np.zeros(len(act), bool)
            else:
                cross = cur_zone != key_zone[act]

            moved = False
            # -- level 1: cross-zone finger hop ------------------------------
            xi = act[cross]
            if len(xi):
                nz = self._nearest_zone_arr()
                target_zone = nz[key_zone[xi]]
                dead = target_zone < 0
                active[xi[dead]] = False
                xi, target_zone = xi[~dead], target_zone[~dead]
                cz = cur[xi] >> space.suffix_bits
                same = target_zone == cz
                key_zone[xi[same]] = cz[same]  # empty key zone -> deliver here
                xi, cz, target_zone = xi[~same], cz[~same], target_zone[~same]
                if len(xi):
                    dz = (target_zone - cz) % Z
                    step = np.int64(1) << (self._bit_length(dz) - 1)
                    hop_zone = nz[(cz + step) % Z]
                    nsuf, nrow = self._zone_lookup_many(
                        hop_zone, cur[xi] & (space.suffix_space - 1), closest=True
                    )
                    nxt = hop_zone * space.suffix_space + nsuf
                    stuck = (nsuf < 0) | (nxt == cur[xi])
                    active[xi[stuck]] = False
                    go = xi[~stuck]
                    if len(go):
                        advance(go, nxt[~stuck], nrow[~stuck])
                        moved = True

            # -- level 2: in-zone digit fixing -------------------------------
            ii = act[~cross]
            if len(ii):
                cz = cur[ii] >> space.suffix_bits
                csuf = cur[ii] & (space.suffix_space - 1)
                closest_suf, closest_row = self._zone_lookup_many(
                    cz, key_suf[ii], closest=True
                )
                delivered = closest_suf == csuf
                active[ii[delivered]] = False
                ii, cz, csuf = ii[~delivered], cz[~delivered], csuf[~delivered]
                closest_suf, closest_row = closest_suf[~delivered], closest_row[~delivered]
                if len(ii):
                    nsuf, nrow = self._next_hop_in_zone_many(csuf, key_suf[ii], cz, b)
                    nxt = cz * space.suffix_space + nsuf
                    guard = (nsuf < 0) | (nxt == cur[ii]) | (nxt == prev[ii])
                    # guard-tripped: deliver via leaf set unless the
                    # closest node is cur or already on the path
                    gi = ii[guard]
                    if len(gi):
                        fsuf = closest_suf[guard]
                        frow = closest_row[guard]
                        final = (cur[gi] >> space.suffix_bits) * space.suffix_space + fsuf
                        skip = final == cur[gi]
                        seen = np.zeros(len(gi), bool)
                        for snap in hist:
                            seen |= snap[gi] == final
                        ok = ~(skip | seen)
                        if ok.any():
                            advance(gi[ok], final[ok], frow[ok])
                            moved = True
                        active[gi] = False
                    go = ii[~guard]
                    if len(go):
                        advance(go, nxt[~guard], nrow[~guard])
                        moved = True

            if moved:
                hist.append(cur.copy())

        return RouteBatch(
            hops=hops, dest=cur, blocked=blocked, latency_ms=latency, _hist=hist
        )

    # -- table materialization (inspection / tests) --------------------------

    def routing_table_of(self, node_id: int) -> dict:
        """Materialize the node's two-level routing table per the paper's
        entry rule: L1[i] = (P_x + 2^{i-1}) mod 2^m * 2^n,
        L2 rows of base-2^b digit fingers."""
        space = self.space
        zone, suffix = space.zone_of(node_id), space.suffix_of(node_id)
        l1 = []
        for i in range(1, space.zone_bits + 1):
            tz = (zone + (1 << (i - 1))) % space.num_zones
            tz_live = self.nearest_zone(tz)
            l1.append(
                self._zone_closest(tz_live, suffix) if tz_live is not None else None
            )
        l2 = []
        rows = (space.suffix_bits + self.b - 1) // self.b
        for i in range(rows):
            row = []
            for j in range(1, 1 << self.b):
                t = (suffix + j * (1 << (self.b * i))) % space.suffix_space
                row.append(self._zone_closest(zone, t))
            l2.append(row)
        return {"level1": l1, "level2": l2}

    # -- latency model --------------------------------------------------------

    def rtt(self, a: int, b: int) -> float:
        """Synthetic RTT (ms) from coordinates: 0.1 ms/unit + 1 ms base."""
        (ax, ay), (bx, by) = self.coords[a], self.coords[b]
        return 1.0 + 0.1 * ((ax - bx) ** 2 + (ay - by) ** 2) ** 0.5

    def path_latency(self, path: list[int]) -> float:
        return sum(self.rtt(a, b) for a, b in zip(path, path[1:]))


# ---------------------------------------------------------------------------
# Ratnasamy–Shenker distributed binning (paper §IV-B, [55])


def distributed_binning(
    coords: np.ndarray, num_landmarks: int, *, levels: int = 3, seed: int = 0
) -> np.ndarray:
    """Bin nodes by landmark-RTT ordering (+ RTT-level quantization).

    Returns an integer bin id per node; bins with identical landmark
    orderings and level vectors land in the same zone — nearby nodes get
    the same bin without any coordination beyond landmark pings.
    """
    rng = np.random.default_rng(seed)
    landmarks = coords[rng.choice(len(coords), size=num_landmarks, replace=False)]
    d = np.sqrt(((coords[:, None, :] - landmarks[None, :, :]) ** 2).sum(-1))  # (N, L)
    order = np.argsort(d, axis=1)  # landmark ordering
    dmax = d.max() + 1e-9
    level = np.minimum((d / dmax * levels).astype(int), levels - 1)
    bins: dict[tuple, int] = {}
    out = np.zeros(len(coords), dtype=np.int64)
    for i in range(len(coords)):
        key = (tuple(order[i]), tuple(level[i][order[i]]))
        out[i] = bins.setdefault(key, len(bins))
    return out


def build_overlay_from_coords(
    coords: np.ndarray,
    space: IdSpace,
    *,
    base_bits: int = 4,
    bandwidth_range=(20.0, 100.0),
    seed: int = 0,
) -> tuple[MultiRingOverlay, list[int]]:
    """EUA-style construction: bin nodes into zones, assign random suffixes."""
    overlay = MultiRingOverlay(space, base_bits=base_bits, seed=seed)
    nbins = distributed_binning(coords, min(space.num_zones, max(2, space.num_zones)), seed=seed)
    zones = nbins % space.num_zones
    rng = np.random.default_rng(seed + 1)
    bws = rng.uniform(bandwidth_range[0], bandwidth_range[1], len(zones))
    ids = overlay.join_many(zones, coords=coords, bandwidth=bws)
    return overlay, ids.tolist()
