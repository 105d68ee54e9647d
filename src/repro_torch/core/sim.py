"""Discrete-event execution layer: pluggable schedulers on one clock.

A copy of ``repro/core/sim.py`` (numpy throughout), with two changes:
the ``CongestionEnv`` is the port's numpy dataclass, and the compression
policy, ``jain_fairness`` and the live ``PlacementEngine`` come from the
port's modules.  Event traces and replan logs are identical to the
reference's.

The round engine used to be a monolith: ``MultiAppSimulator`` priced each
app's round as a fixed chain of phases with a hard barrier per round.
This module splits that into an event core plus two schedulers:

- ``EventCore`` owns the shared clock (heap of completion events), the
  congestion-priced transfer model from ``core/congestion.py`` (a node
  uploading to k concurrent flows serves each at capacity/k), and event
  cancellation — everything that is *not* policy.
- ``SyncRoundScheduler`` reproduces the original barrier-per-round
  behavior (paper §VII-D, Table III): broadcast levels down, one compute
  phase, aggregation levels up.  ``MultiAppSimulator`` remains as an
  alias.  New: ``pipelined=True`` prices dissemination with per-edge
  store-and-forward overlap (``pipelined_time``), so a deep tree's
  broadcast cost approaches its max level instead of the level sum.
- ``AsyncBufferScheduler`` is the FedBuff-style async path (ROADMAP):
  every worker runs its own download -> compute -> upload cycle as
  individual clock events, commits land in the master's buffer, and the
  aggregator applies a staleness-weighted buffered update after K
  arrivals.  A ``ChurnModel`` injects fail/rejoin events on the *same*
  clock, driving ``core/recovery.fail_and_recover`` mid-round so repair
  latency lands on the timeline.
- **Weighted-fair transfer pricing** (this PR, the multi-app starvation
  fix): the PR-1/PR-2 transfer model priced a flow once, at start time,
  against whatever else happened to be in flight — so a flow that began
  alone kept its solo ``capacity`` rate even after k contenders arrived,
  and a flow that began against k contenders kept ``capacity/k`` after
  they all drained.  Both directions are wrong, and at M >= 16 apps the
  error compounds into uplink starvation (ROADMAP).  ``EventCore`` now
  carries a fluid-flow engine: each hop of a transfer is an open *flow*
  on its sender's uplink, the uplink is divided by weighted max-min fair
  sharing (``core/congestion.fair_share_rates``), and whenever a flow
  joins or completes every in-flight flow on that uplink is **re-priced
  progress-preservingly** — bytes already delivered at the old rate stay
  delivered, only the remaining bytes reschedule at the new rate (a
  virtual-finish-time update; total delivered bytes are conserved
  exactly across any number of re-prices).  ``AsyncBufferScheduler``
  uses the fair engine by default (``fair=False`` keeps the exact PR-3
  start-time pricing); an uncontended (single-flow) fair trace is
  identical to the legacy trace because one flow's fair share is the
  whole uplink.  Per-app ``transfer_weight`` / ``rate_cap_mbps`` knobs
  bias or bound the share, and a ``RelayAdmission`` policy adds
  staleness-aware admission at shared relays: a contended relay defers
  forwarding commits whose staleness discount ``1/(1+s)^a`` has decayed
  below a threshold, freeing uplink for fresh traffic (deferred commits
  resume FIFO as the uplink frees, or unconditionally at
  ``max_defer_ms``, so no commit is ever dropped).
- ``AdaptiveKController`` closes the loop on K: instead of a
  fixed buffer size, each buffered apply re-sizes K from the observed
  commit inter-arrival rate (EMA of arrivals per simulated millisecond)
  and the staleness distribution (a target percentile), clamped to
  ``[k_min, live membership]`` so churn can neither stall the buffer
  nor let K reference dead workers.  ``adaptive=False`` (the default)
  takes the exact PR-2 fixed-K code path — trace-identical, asserted by
  tests/test_selection.py.  Client admission is equally pluggable: a
  ``fl/selection.ClientSelector`` gates each worker's next cycle
  (utility-based straggler avoidance), with ``selector=None`` /
  ``UniformSelector`` preserving the admit-everyone behavior.

- **Hot-path overhaul** (this PR): transfer pricing and event plumbing
  were the simulator's own bottleneck at M >= 16.  Three exact-semantics
  optimizations, all defaulting on: (1) *incremental repricing* — each
  uplink keeps a ``core/congestion.UplinkState`` (incremental group
  counts + a cap ladder sorted by the group-invariant ``cap/weight``
  ratio) and schedules ONE completion event (the earliest finisher)
  instead of one per flow, so a flow join/complete costs O(F) float
  adds + O(log H) heap work instead of O(F log H) pushes that each left
  a dead heap entry behind; (2) *lazy-deletion heap compaction* —
  cancelled events are counted and the heap is rebuilt once dead
  entries outnumber live ones, bounding heap size under churn; (3)
  *numpy-resident route tables* — ``transfer_ms`` prices phases with
  f32 numpy arithmetic (bit-identical to the jitted lookup it
  replaces) and ``_path_senders`` memoizes per-(app, worker, direction)
  sender arrays between churn events.  ``incremental=False`` restores
  the full-water-filling engine; traces are byte-identical either way
  (gated by benchmarks/bench_hotpath.py).

Units and invariants: the clock is simulated milliseconds (``now``,
every ``*_ms``); transfer sizes are bytes (``model_bytes``), converted
once to megabits for ``CongestionEnv``; staleness is counted in model
*versions* (applies elapsed since the worker's download), not time.
Everything is deterministic: ties on the clock break by event sequence
number, churn and selection draws come from seeded generators owned by
their models, and the congestion pricing has no stochastic terms.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from .congestion import CongestionEnv, UplinkState, fair_share_rates


@dataclass(frozen=True)
class RoundEvent:
    """One completed (app, round): recorded when the root finishes
    aggregating, i.e. the paper's per-app round completion time."""

    app_id: int
    round: int
    start_ms: float
    end_ms: float

    @property
    def duration_ms(self) -> float:
        return self.end_ms - self.start_ms


@dataclass(frozen=True)
class ApplyEvent:
    """One buffered apply at an app's master: the async analogue of a
    round completion (K deltas arrived, staleness-weighted update done).
    ``k`` is the effective buffer threshold that triggered this apply —
    the constructor K (clamped to live membership) in fixed mode, the
    controller's current K in adaptive mode."""

    app_id: int
    apply_index: int
    time_ms: float
    arrivals: int
    mean_staleness: float
    max_staleness: float
    k: int = 0


@dataclass(frozen=True)
class ChurnRecord:
    """A churn event as it landed on the clock (fail or rejoin)."""

    time_ms: float
    kind: str  # "fail" | "rejoin"
    nodes: tuple
    recovery_ms: float = 0.0


@dataclass(frozen=True)
class RelayAdmission:
    """Staleness-aware admission control at shared relay uplinks.

    When a relay already serves ``min_contenders`` or more flows, a
    commit whose staleness discount ``1/(1+s)^alpha`` (s in model
    versions, measured *now* — staleness keeps growing while the commit
    is in flight) has decayed below ``threshold`` is deferred at that
    relay: fresh traffic keeps the uplink, and the stale commit resumes
    FIFO when a flow on the uplink completes, or unconditionally after
    ``max_defer_ms`` — deferral delays, it never drops.  Each deferral
    is reported to the client selector (``on_defer``) so chronic
    deferral feeds the deadline term of utility-based selection.
    """

    threshold: float = 0.5
    alpha: float = 0.5
    min_contenders: int = 1
    max_defer_ms: float = 200.0


@dataclass(frozen=True)
class DeferRecord:
    """One relay-admission deferral as it resolved (telemetry)."""

    start_ms: float
    end_ms: float
    app_idx: int
    worker: int
    relay: int
    forced: bool  # True = resumed by the max_defer_ms deadline

    @property
    def waited_ms(self) -> float:
        return self.end_ms - self.start_ms


@dataclass(frozen=True)
class ReplanRecord:
    """One placement replan as it ran on the clock (telemetry).

    ``trigger`` names what marked the planner dirty (``bootstrap`` /
    ``churn`` / ``defer`` / ``selector`` / ``contention``); ``moves`` is
    the applied re-graft set as ``(app_idx, node, old_parent,
    new_parent)`` tuples; ``cost_ms`` is the total on-clock price of the
    JOIN control traffic (re-grafts are not free)."""

    time_ms: float
    trigger: str
    moves: tuple
    cost_ms: float
    control_bytes: float


class _Flow:
    """One in-flight hop transfer on a sender's uplink (fluid model)."""

    __slots__ = (
        "fid", "sender", "total_mbit", "delivered_mbit", "weight",
        "rate_cap", "on_done", "ev", "rate", "t_last", "group",
    )

    def __init__(self, fid, sender, mbit, weight, rate_cap, on_done, group):
        self.fid = fid
        self.sender = sender
        self.total_mbit = float(mbit)
        self.delivered_mbit = 0.0
        self.weight = float(weight)
        self.rate_cap = rate_cap
        self.on_done = on_done
        self.ev: int | None = None
        self.rate = 0.0
        self.t_last = 0.0
        self.group = group  # flows sharing a group split ONE weight share


def pipelined_time(level_ms, chunks: int = 8) -> float:
    """Store-and-forward pipelining of a phase sequence: the payload is
    cut into ``chunks`` pieces so level i+1 starts forwarding as soon as
    the first piece lands.  total = sum(t)/C + max(t)*(C-1)/C — equal to
    the synchronous sum at C=1, approaching max(t) as C grows, and never
    exceeding the sum (max <= sum)."""
    ts = [float(t) for t in level_ms]
    if not ts:
        return 0.0
    c = max(1, int(chunks))
    return sum(ts) / c + max(ts) * (c - 1) / c


class EventCore:
    """Shared clock + congestion-priced transfers for the schedulers.

    ``handles``: the apps' ``AppHandle``s.  ``model_bytes`` sizes every
    transfer.  Transfers are priced when scheduled, against every flow
    still in flight (``CongestionEnv.latency_ms``), and stay registered
    as active flows until their completion event pops.
    """

    def __init__(
        self, system, handles, *, model_bytes: float, base_ms: float = 5.0,
        incremental: bool = True,
    ):
        self.system = system
        self.handles = list(handles)
        nodes = system.overlay.nodes()
        self._node_idx = {n: i for i, n in enumerate(nodes)}
        # vectorized mirror of _node_idx for sender_indices_many
        self._idx_ids = np.asarray(nodes, np.int64)  # globally ascending
        self._idx_vals = np.arange(len(nodes), dtype=np.int32)
        cap = np.asarray([system.overlay.bandwidth[n] for n in nodes], np.float32)
        self._cap_mbps = cap.astype(np.float64)
        self._cap_f32 = cap  # numpy-resident mirror for transfer_ms
        self.model_bytes = float(model_bytes)
        self.base_ms = float(base_ms)
        self.incremental = bool(incremental)
        self.env = CongestionEnv(
            capacity=cap,
            theta=np.ones(len(nodes), np.float32),
            packet_mbit=float(model_bytes) * 8e-6,
            base_ms=base_ms,
        )
        self.now = 0.0
        self.events_dispatched = 0
        self.heap_max = 0
        self._heap: list[tuple[float, int]] = []
        self._seq = 0
        self._dead = 0  # cancelled-but-unpopped heap entries (lazy deletion)
        self._active: dict[int, np.ndarray] = {}  # event seq -> sender idx array
        self._callbacks: dict[int, Callable | None] = {}
        # fluid fair-share flows (weighted processor sharing per uplink)
        self._flows: dict[int, _Flow] = {}
        self._flows_by_sender: dict[int, list[int]] = {}
        self._flow_seq = 0
        # incremental-repricing state: one allocator + at most one pending
        # completion event per uplink (instead of one event per flow)
        self._uplink_state: dict[int, UplinkState] = {}
        self._uplink_ev: dict[int, int] = {}
        # cohort batching: events sharing a cohort id keep their own
        # (t, seq) completion-time heap; only each cohort's earliest
        # member occupies the global heap (see schedule_cohort)
        self._cohorts: dict = {}  # cohort id -> [(t, seq), ...] heap
        self._cohort_of: dict[int, object] = {}  # member seq -> cohort id
        self._armed: dict[int, object] = {}  # seq in global heap -> cohort id
        # optional per-dispatch hook (event-count-triggered congestion
        # resampling); None keeps the dispatch loop branch nearly free
        self._tick_hook: Callable[[], None] | None = None
        # per-uplink delivered-bytes ledger: credited by schedulers on
        # commit/control completions (only when a placement engine is
        # attached), read by the engine's reward model
        self.uplink_bytes = np.zeros(len(nodes), np.float64)

    def _reset_clock(self) -> None:
        self.now = 0.0
        self.events_dispatched = 0
        self.heap_max = 0
        self._heap.clear()
        self._seq = 0
        self._dead = 0
        self._active.clear()
        self._callbacks.clear()
        self._flows.clear()
        self._flows_by_sender.clear()
        self._flow_seq = 0
        self._uplink_state.clear()
        self._uplink_ev.clear()
        self._cohorts.clear()
        self._cohort_of.clear()
        self._armed.clear()
        self.uplink_bytes[:] = 0.0

    def sender_indices(self, nodes) -> np.ndarray:
        return np.asarray([self._node_idx[n] for n in nodes], np.int32)

    def sender_indices_many(self, ids: np.ndarray) -> np.ndarray:
        """Vectorized ``sender_indices`` over an int64 id array; raises
        KeyError (like the dict lookup) on any id the core never indexed."""
        j = np.searchsorted(self._idx_ids, ids)
        jj = np.minimum(j, len(self._idx_ids) - 1)
        bad = (j >= len(self._idx_ids)) | (self._idx_ids[jj] != ids)
        if bad.any():
            raise KeyError(int(ids[np.flatnonzero(bad)[0]]))
        return self._idx_vals[jj].copy()

    def transfer_ms(
        self, senders: np.ndarray, *, reduce: str = "max", mbit: float | None = None
    ) -> float:
        """Price one phase's flows with every in-flight flow still active:
        per-flow latency = base + bits / (capacity_sender / k) where k is
        the number of concurrent flows sharing that sender's uplink.
        ``reduce="max"`` models parallel flows (phase ends when the
        slowest does); ``"sum"`` models store-and-forward along a path.
        ``mbit`` overrides the payload size (default: the full-model
        ``packet_mbit`` — commit legs under a compression policy pass
        their compressed size; an equal value is bit-identical).

        Runs on numpy-resident route/capacity tables: the old path built
        device arrays and dispatched a jitted lookup per *phase*, which
        recompiled for every distinct in-flight flow count.  The numpy
        arithmetic is f32 elementwise, bit-identical to the jitted
        ``CongestionEnv.latency_ms`` (sync traces are unchanged)."""
        if len(senders) == 0:
            return 0.0
        own = np.asarray(senders)
        if self._active:
            actions = np.concatenate([own] + list(self._active.values()))
        else:
            actions = own
        counts = np.bincount(actions, minlength=len(self._cap_f32)).astype(np.float32)
        rate = self._cap_f32[own] / np.maximum(counts[own], np.float32(1.0))
        lat = np.float32(self.base_ms) + np.float32(
            1e3 * (self.env.packet_mbit if mbit is None else mbit)
        ) / np.maximum(rate, np.float32(1e-6))
        return float(lat.sum() if reduce == "sum" else lat.max())

    def schedule(self, delay_ms: float, callback: Callable, senders: np.ndarray | None = None) -> int:
        """Push a completion event ``delay_ms`` from now; ``senders`` (if
        given) are registered as active flows until the event pops.
        Returns the event seq (usable with ``cancel``)."""
        seq = self._seq
        self._seq += 1
        if senders is not None and len(senders):
            self._active[seq] = senders
        self._callbacks[seq] = callback
        heapq.heappush(self._heap, (self.now + delay_ms, seq))
        if len(self._heap) > self.heap_max:
            self.heap_max = len(self._heap)  # telemetry: peak incl. dead entries
        return seq

    def schedule_cohort(self, cohort, delay_ms: float, callback: Callable,
                        senders: np.ndarray | None = None) -> int:
        """Like ``schedule``, but events sharing ``cohort`` (any hashable
        id — the async scheduler passes the app index) share ONE global
        heap entry: the cohort keeps its own (t, seq) completion-time
        heap, and only its earliest member is "armed" into the global
        heap.  When that member pops, the next one is armed.  Because a
        member always enters the global heap carrying its original
        (t, seq) — and every unarmed member of its cohort sorts after
        it — the dispatch order is exactly the per-event baseline's
        (the M=16 trace-identity gate in tests/test_scale.py), while the
        heap holds O(cohorts) entries instead of O(workers)."""
        seq = self._seq
        self._seq += 1
        if senders is not None and len(senders):
            self._active[seq] = senders
        self._callbacks[seq] = callback
        h = self._cohorts.setdefault(cohort, [])
        heapq.heappush(h, (self.now + delay_ms, seq))
        self._cohort_of[seq] = cohort
        self._arm_cohort(cohort)
        return seq

    def _arm_cohort(self, cohort) -> None:
        """Push the cohort's earliest live, not-yet-armed member into the
        global heap (no-op if the head is already armed)."""
        h = self._cohorts.get(cohort)
        while h:
            t, seq = h[0]
            if seq in self._armed:
                return  # head already in the global heap
            if self._callbacks.get(seq) is None:
                heapq.heappop(h)  # cancelled before ever arming: drop
                self._callbacks.pop(seq, None)
                self._cohort_of.pop(seq, None)
                continue
            self._armed[seq] = cohort
            heapq.heappush(self._heap, (t, seq))
            if len(self._heap) > self.heap_max:
                self.heap_max = len(self._heap)
            return
        self._cohorts.pop(cohort, None)

    def cancel(self, seq: int) -> None:
        """Void a pending event (its flows stop contending immediately).
        Safe on an already-fired seq (the fair path re-cancels the last
        leg event of a cycle wholesale on churn).

        Cancellation is lazy — the heap entry stays until popped — but
        counted: once dead entries outnumber live ones the heap is
        compacted, so churn- and reprice-cancelled events can no longer
        bloat ``run_events`` for the rest of a run (regression:
        tests/test_hotpath.py).  An unarmed cohort member occupies no
        global heap entry; it is only marked dead and dropped lazily
        when it reaches its cohort's head."""
        if seq in self._cohort_of and seq not in self._armed:
            if self._callbacks.get(seq) is not None:
                self._callbacks[seq] = None
            self._active.pop(seq, None)
            return
        if self._callbacks.get(seq) is not None:
            self._callbacks[seq] = None
            self._dead += 1
            if self._dead > 64 and self._dead * 2 > len(self._heap):
                self._compact_heap()
        self._active.pop(seq, None)

    def _compact_heap(self) -> None:
        """Drop every dead (cancelled) entry and re-heapify in O(live)."""
        cbs = self._callbacks
        self._heap = [e for e in self._heap if cbs.get(e[1]) is not None]
        heapq.heapify(self._heap)
        for seq in [s for s, cb in cbs.items() if cb is None]:
            del cbs[seq]
            self._active.pop(seq, None)
            self._cohort_of.pop(seq, None)
        self._dead = 0
        # compaction may have evicted dead ARMED cohort members from the
        # global heap — their cohorts must be re-armed or they stall
        in_heap = {s for _, s in self._heap}
        stale = [s for s in self._armed if s not in in_heap]
        for seq in stale:
            cohort = self._armed.pop(seq)
            h = self._cohorts.get(cohort)
            if h and h[0][1] == seq:
                heapq.heappop(h)
            self._arm_cohort(cohort)

    # -- fluid fair-share flows (weighted-fair transfer pricing) ---------------

    def open_flow(
        self,
        sender: int,
        mbit: float,
        *,
        weight: float = 1.0,
        rate_cap: float | None = None,
        on_done: Callable[[float], None],
        group=None,
    ) -> int:
        """Start one hop transfer of ``mbit`` megabits on ``sender``'s
        uplink.  The uplink is shared by weighted max-min fair sharing;
        opening (and closing) a flow re-prices every in-flight flow on
        that uplink progress-preservingly.  Flows with the same non-None
        ``group`` (the async scheduler passes the app index) split one
        ``weight`` share — and one ``rate_cap`` — between them, so an
        app's aggregate share of a relay is set by its weight, not by
        how many of its workers happen to route through it.
        ``on_done(t)`` fires when the last byte lands."""
        fid = self._flow_seq
        self._flow_seq += 1
        key = ("solo", fid) if group is None else ("grp", group)
        f = _Flow(fid, int(sender), mbit, weight, rate_cap, on_done, key)
        f.t_last = self.now
        self._flows[fid] = f
        self._flows_by_sender.setdefault(f.sender, []).append(fid)
        if self.incremental:
            st = self._uplink_state.get(f.sender)
            if st is None:
                st = self._uplink_state[f.sender] = UplinkState(
                    float(self._cap_mbps[f.sender])
                )
            st.add(fid, f.weight, f.rate_cap, key)
        self._reprice_uplink(f.sender)
        return fid

    def cancel_flow(self, fid: int) -> None:
        """Abort an in-flight flow (sender failed / cycle cancelled); the
        survivors on that uplink immediately speed up."""
        f = self._flows.pop(fid, None)
        if f is None:
            return
        if f.ev is not None:
            self.cancel(f.ev)
        self._drop_from_sender(f)
        self._reprice_uplink(f.sender)
        self._on_uplink_freed(f.sender, self.now)

    def flow_contenders(self, sender: int) -> int:
        """Number of flows currently sharing ``sender``'s uplink."""
        return len(self._flows_by_sender.get(int(sender), ()))

    def _drop_from_sender(self, f: _Flow) -> None:
        fids = self._flows_by_sender.get(f.sender)
        if fids is not None:
            fids.remove(f.fid)
            if not fids:
                del self._flows_by_sender[f.sender]
        if self.incremental:
            self._uplink_state[f.sender].remove(f.fid)

    def _reprice_uplink(self, sender: int) -> None:
        """Progress-preserving re-price of every flow on one uplink:
        credit bytes delivered at the old rates since the last update,
        recompute the weighted-fair rates, reschedule the completion(s)
        at ``remaining / new_rate`` (a virtual-finish-time update).

        Incremental mode (the default) gets the rates from the uplink's
        ``UplinkState`` (group counts and the sorted cap ladder are
        maintained on join/complete, not rebuilt here) and schedules ONE
        completion event — the earliest finisher — instead of one per
        flow: a reprice costs O(F) float work + O(log H) heap work where
        the legacy path paid O(F log H) pushes and left F dead heap
        entries behind.  Completion times are computed with the same
        arithmetic in the same flow order, so event traces are
        byte-identical across both modes (bench_hotpath's gate).
        """
        if self.incremental:
            prev = self._uplink_ev.pop(sender, None)
            if prev is not None:
                self.cancel(prev)
            fids = self._flows_by_sender.get(sender)
            if not fids:
                return
            flows = [self._flows[fid] for fid in fids]
            now = self.now
            for f in flows:
                f.delivered_mbit = min(
                    f.total_mbit, f.delivered_mbit + f.rate * (now - f.t_last) * 1e-3
                )
                f.t_last = now
            rates = self._uplink_state[sender].rates()
            best_fid, best_delay = None, None
            for f, r in zip(flows, rates):
                f.rate = r
                d = 1e3 * (f.total_mbit - f.delivered_mbit) / max(r, 1e-9)
                # strict < keeps the earliest-opened flow on ties, matching
                # the legacy per-flow events' seq-order tie-break
                if best_delay is None or d < best_delay:
                    best_fid, best_delay = f.fid, d
            self._uplink_ev[sender] = self.schedule(
                best_delay, lambda t, fid=best_fid: self._finish_flow(fid, t)
            )
            return
        fids = self._flows_by_sender.get(sender)
        if not fids:
            return
        flows = [self._flows[fid] for fid in fids]
        for f in flows:
            f.delivered_mbit = min(
                f.total_mbit, f.delivered_mbit + f.rate * (self.now - f.t_last) * 1e-3
            )
            f.t_last = self.now
        # per-group (= per-app) fairness: flows in one group split a
        # single weight share and rate cap equally, so an app's slice of
        # a relay is its weight, not its concurrent-flow count
        group_n: dict = {}
        for f in flows:
            group_n[f.group] = group_n.get(f.group, 0) + 1
        rates = fair_share_rates(
            float(self._cap_mbps[sender]),
            [f.weight / group_n[f.group] for f in flows],
            [None if f.rate_cap is None else f.rate_cap / group_n[f.group] for f in flows],
        )
        for f, r in zip(flows, rates):
            f.rate = r
            if f.ev is not None:
                self.cancel(f.ev)
            remaining = f.total_mbit - f.delivered_mbit
            f.ev = self.schedule(
                1e3 * remaining / max(r, 1e-9),
                lambda t, fid=f.fid: self._finish_flow(fid, t),
            )

    def _finish_flow(self, fid: int, t: float) -> None:
        f = self._flows.pop(fid)
        f.delivered_mbit = f.total_mbit  # exact byte conservation
        self._drop_from_sender(f)
        self._reprice_uplink(f.sender)
        f.on_done(t)
        self._on_uplink_freed(f.sender, t)

    def _on_uplink_freed(self, sender: int, t: float) -> None:
        """Hook: a flow left ``sender``'s uplink.  The async scheduler
        overrides this to resume relay-deferred commits."""

    def _progress_summary(self) -> str:
        """Hook: one-line per-app progress for the budget-exhausted
        diagnostic.  Schedulers override this with real progress."""
        return ""

    def run_events(self, *, max_events: int = 1_000_000, stop: Callable[[], bool] | None = None) -> None:
        """Drain the heap in clock order, dispatching callbacks."""
        n = 0
        while self._heap:
            if stop is not None and stop():
                return
            t, seq = heapq.heappop(self._heap)
            cohort = self._armed.pop(seq, None)
            if cohort is not None:
                # this member was its cohort's head: retire it and arm
                # the next earliest (which sorts at or after (t, seq))
                self._cohort_of.pop(seq, None)
                h = self._cohorts.get(cohort)
                if h and h[0][1] == seq:
                    heapq.heappop(h)
                self._arm_cohort(cohort)
            self._active.pop(seq, None)
            cb = self._callbacks.pop(seq, None)
            if cb is None:
                if self._dead:
                    self._dead -= 1
                continue  # cancelled
            self.now = t
            cb(t)
            n += 1
            self.events_dispatched += 1
            if self._tick_hook is not None:
                self._tick_hook()
            if n >= max_events:
                live = len(self._heap) - self._dead
                msg = (
                    f"event budget exhausted ({max_events} events dispatched): "
                    f"clock={self.now:.1f}ms, heap={max(live, 0)} live"
                    f"/{self._dead} dead entries"
                )
                prog = self._progress_summary()
                if prog:
                    msg += f"; {prog}"
                msg += (
                    " — raise max_events (threaded through run()/run_async"
                    "/bench entry points) for longer runs"
                )
                raise RuntimeError(msg)


class SyncRoundScheduler(EventCore):
    """Barrier-per-round scheduling (the original behavior, preserved).

    Each app's round is a chain of phases — broadcast the model
    level-by-level down its dataflow tree, workers compute E local steps,
    partial aggregates flow level-by-level back up — and every phase is
    one event.  ``compute_ms`` is a scalar or ``f(handle, round) -> ms``.
    ``pipelined=True`` collapses the broadcast levels into one phase
    priced by ``pipelined_time`` (per-edge store-and-forward overlap,
    never slower than the synchronous level sum); aggregation keeps the
    level chain either way (partial sums must land before forwarding).
    """

    def __init__(
        self,
        system,
        handles,
        *,
        model_bytes: float,
        compute_ms: float | Callable = 50.0,
        base_ms: float = 5.0,
        pipelined: bool = False,
        pipeline_chunks: int = 8,
    ):
        super().__init__(system, handles, model_bytes=model_bytes, base_ms=base_ms)
        self.compute_ms = compute_ms
        self.pipelined = pipelined
        self.pipeline_chunks = pipeline_chunks
        self._phases = [self._phases_of(h.tree) for h in self.handles]

    def _phases_of(self, tree) -> list[tuple[str, object]]:
        """Round = broadcast levels (sender = parent, one flow per child),
        one compute phase, aggregation levels (sender = each child)."""
        phases: list[tuple[str, object]] = []
        agg = tree.aggregation_schedule()
        bcast_levels = []
        for level in reversed(agg):  # root -> leaves
            senders = [self._node_idx[p] for p, kids in level for _ in kids]
            bcast_levels.append(np.asarray(senders, np.int32))
        if self.pipelined and bcast_levels:
            phases.append(("pbcast", bcast_levels))
        else:
            phases.extend(("bcast", s) for s in bcast_levels)
        phases.append(("compute", None))
        for level in agg:  # leaves -> root
            senders = [self._node_idx[c] for _, kids in level for c in kids]
            phases.append(("agg", np.asarray(senders, np.int32)))
        return phases

    def _compute_ms(self, app_idx: int, round_num: int) -> float:
        if callable(self.compute_ms):
            return float(self.compute_ms(self.handles[app_idx], round_num))
        return float(self.compute_ms)

    def run(self, rounds: int = 1) -> list[RoundEvent]:
        """Interleave every app's ``rounds`` rounds; returns the per-app
        completion records in completion order (deterministic)."""
        self._reset_clock()
        state = [{"phase": 0, "round": 0, "start": 0.0} for _ in self.handles]
        history: list[RoundEvent] = []

        def start_phase(i: int) -> None:
            kind, senders = self._phases[i][state[i]["phase"]]
            if kind == "compute":
                dur, senders = self._compute_ms(i, state[i]["round"]), None
            elif kind == "pbcast":
                # price each level against the current in-flight set, then
                # overlap them: all levels' flows stay active together
                level_ms = [self.transfer_ms(s) for s in senders]
                dur = pipelined_time(level_ms, self.pipeline_chunks)
                senders = np.concatenate(senders)
            elif senders is None or len(senders) == 0:
                dur, senders = 0.0, None
            else:
                dur = self.transfer_ms(senders)
            self.schedule(dur, lambda t, i=i: end_phase(i, t), senders)

        def end_phase(i: int, t: float) -> None:
            st = state[i]
            st["phase"] += 1
            if st["phase"] >= len(self._phases[i]):
                history.append(
                    RoundEvent(self.handles[i].app_id, st["round"], st["start"], t)
                )
                st["round"] += 1
                st["phase"] = 0
                st["start"] = t
                if st["round"] >= rounds:
                    return
            start_phase(i)

        for i in range(len(self._phases)):
            # every app has >= 1 phase: _phases_of always emits compute
            start_phase(i)
        self.run_events()
        return history


# the original name stays importable: the sync scheduler IS the old
# MultiAppSimulator, bit-for-bit on its event trace
MultiAppSimulator = SyncRoundScheduler


class ChurnModel:
    """Deterministic fail/rejoin schedule for the async scheduler.

    Every ``period_ms`` it fails ``group_size`` live workers (drawn from a
    seeded generator over the sorted live-worker pool — never a tree root
    unless ``allow_master_failure``); each failed node rejoins the overlay
    and re-Subscribes ``downtime_ms`` later.  Fail events call
    ``core/recovery.fail_and_recover`` per affected tree, so orphan
    re-grafts and master failover land on the simulation clock and their
    repair latency delays the orphans' next cycle.
    """

    def __init__(
        self,
        *,
        period_ms: float = 500.0,
        downtime_ms: float = 1500.0,
        group_size: int = 1,
        seed: int = 0,
        allow_master_failure: bool = False,
        max_fail_events: int | None = None,
    ):
        self.period_ms = float(period_ms)
        self.downtime_ms = float(downtime_ms)
        self.group_size = int(group_size)
        self.allow_master_failure = allow_master_failure
        self.max_fail_events = max_fail_events
        self.rng = np.random.default_rng(seed)
        self.fired = 0

    def pick_victims(self, pool: list[int]) -> list[int]:
        if not pool:
            return []
        k = min(self.group_size, len(pool))
        idx = self.rng.choice(len(pool), size=k, replace=False)
        return [pool[int(i)] for i in np.sort(idx)]

    def exhausted(self) -> bool:
        return self.max_fail_events is not None and self.fired >= self.max_fail_events


class AdaptiveKController:
    """Per-app feedback controller for the async buffer size K.

    The fixed-K scheduler has a built-in tension: small K applies
    eagerly (fast wall-clock progress, but every apply bumps the model
    version, so in-flight workers land with higher *staleness*), large K
    degenerates toward the barrier (low staleness, straggler-bound).
    This controller re-sizes K after every buffered apply from two
    observations:

    - **staleness feedback**: let ``p`` be the ``percentile``-th
      percentile of the staleness values (in model versions) in the
      buffer just applied.  K moves multiplicatively toward the
      ``target_staleness``: ``K *= 1 + gain * (p - target) / target``,
      with the per-apply multiplier clamped to [0.5, 2.0] — staleness
      above target grows K (fewer version bumps per cycle), below
      target shrinks it (apply more eagerly).
    - **arrival rate**: an EMA of commit arrivals per simulated
      millisecond (``arrivals_per_ms``, smoothed by ``arrival_beta``).
      With ``max_apply_interval_ms`` set, K is capped at
      ``rate * max_apply_interval_ms`` so the expected buffer fill time
      ``K / rate`` never exceeds the interval — under churn the rate
      drops and the cap pulls K down before the buffer can stall.
      Outage handling: the *first* commit gap longer than
      ``rate_gap_ms`` (default ``max_apply_interval_ms``) is treated as
      an outage — every worker failed, then rejoined — and resets the
      inter-arrival tracking instead of folding a near-zero
      instantaneous rate into the EMA (with a large ``arrival_beta``
      that poisoned rate cap would clamp K at ``k_min`` essentially
      forever), so the EMA keeps its pre-outage value and K recovers as
      soon as post-rejoin commits flow.  A *second* consecutive long
      gap is not an outage but a persistently slow arrival regime: it
      folds normally, so the interval cap still pulls K down when the
      system genuinely slows (the PR-3 behavior the cap exists for).

    The result is clamped to ``[k_min, min(k_max, live_workers)]``;
    live membership comes from the scheduler each apply, so failed
    workers can never be counted toward K.  ``history`` records
    ``(t_ms, k, staleness_percentile, arrivals_per_ms)`` per apply for
    telemetry.  Fully deterministic — no random draws.
    """

    def __init__(
        self,
        *,
        k_init: int = 8,
        k_min: int = 1,
        k_max: int | None = None,
        target_staleness: float = 1.5,
        percentile: float = 90.0,
        gain: float = 0.5,
        arrival_beta: float = 0.2,
        max_apply_interval_ms: float | None = None,
        rate_gap_ms: float | None = None,
    ):
        self.k_min = max(1, int(k_min))
        self.k_max = None if k_max is None else int(k_max)
        self.k = float(max(self.k_min, int(k_init)))
        self.target_staleness = float(target_staleness)
        self.percentile = float(percentile)
        self.gain = float(gain)
        self.arrival_beta = float(arrival_beta)
        self.max_apply_interval_ms = max_apply_interval_ms
        self.rate_gap_ms = rate_gap_ms if rate_gap_ms is not None else max_apply_interval_ms
        self.arrivals_per_ms = 0.0
        self._last_commit_ms: float | None = None
        self._tied_arrivals = 0
        self._gap_skipped = False
        self.history: list[tuple[float, int, float, float]] = []

    @property
    def current_k(self) -> int:
        return max(self.k_min, int(round(self.k)))

    def on_commit(self, t_ms: float) -> None:
        """One commit landed: fold its inter-arrival into the rate EMA.
        Commits tied on the clock (same event timestamp) are folded into
        one batch so a tie can never masquerade as an infinite rate."""
        if self._last_commit_ms is None:
            self._last_commit_ms = t_ms
            self._tied_arrivals = 1
            return
        dt = t_ms - self._last_commit_ms
        if dt <= 1e-9:
            self._tied_arrivals += 1
            return
        if self.rate_gap_ms is not None and dt > self.rate_gap_ms and not self._gap_skipped:
            # full-window outage (all workers down, now rejoined): restart
            # the inter-arrival tracking rather than folding a near-zero
            # instantaneous rate into the EMA — the pre-outage rate stands
            # until real post-rejoin arrivals update it, so K recovers.
            # Only one consecutive gap is forgiven: a second long gap is a
            # persistently slow regime and folds below, keeping the cap live
            self._gap_skipped = True
            self._last_commit_ms = t_ms
            self._tied_arrivals = 1
            return
        self._gap_skipped = False
        inst = self._tied_arrivals / dt
        if self.arrivals_per_ms == 0.0:
            self.arrivals_per_ms = inst
        else:
            self.arrivals_per_ms = (
                self.arrival_beta * inst + (1.0 - self.arrival_beta) * self.arrivals_per_ms
            )
        self._last_commit_ms = t_ms
        self._tied_arrivals = 1

    def on_apply(self, t_ms: float, staleness: list[int], live_workers: int) -> int:
        """One buffered apply finished: update K and return the new value."""
        p = float(np.percentile(staleness, self.percentile)) if staleness else 0.0
        err = (p - self.target_staleness) / max(self.target_staleness, 1e-6)
        mult = float(np.clip(1.0 + self.gain * err, 0.5, 2.0))
        k = self.k * mult
        if self.max_apply_interval_ms is not None and self.arrivals_per_ms > 0.0:
            k = min(k, self.arrivals_per_ms * float(self.max_apply_interval_ms))
        hi = float(live_workers) if live_workers > 0 else k
        if self.k_max is not None:
            hi = min(hi, float(self.k_max))
        self.k = float(np.clip(k, float(self.k_min), max(float(self.k_min), hi)))
        self.history.append((t_ms, self.current_k, p, self.arrivals_per_ms))
        return self.current_k


class AsyncBufferScheduler(EventCore):
    """FedBuff-style buffered-asynchronous execution on the event clock.

    Every (app, worker) runs an independent cycle: *download* the current
    model along its tree path (store-and-forward, congestion-priced),
    *compute* its E local steps (``compute_ms`` scalar or
    ``f(handle, worker, cycle) -> ms`` for heterogeneous edges), *upload*
    its delta along the path back to the master.  Each completed upload
    is a commit; after K commits the master applies a staleness-weighted
    buffered update and bumps the global model version.  No barrier:
    workers immediately begin their next cycle, so fast edges lap slow
    ones and arrive with staleness > 0.  ``barrier=True`` makes workers
    wait for the next apply before re-downloading — with K = W that is
    exactly the synchronous FedAvg round on per-worker events (every
    buffer holds one commit per worker at uniform staleness), which is
    the equivalence anchor tests/test_async.py checks against the
    synchronous engine.

    The data plane is delegated to an optional ``trainer``
    (``fl/async_engine.AsyncTrainer``): ``begin_download`` snapshots the
    version a worker trains from, ``commit``/``apply`` run the real
    batched training and the ``CommitDelta``/``ApplyBuffered`` verbs.
    Without a trainer the scheduler is a pure timing model.

    ``churn`` (a ``ChurnModel``) injects mid-round fail/rejoin events:
    failed workers' in-flight events are cancelled, affected trees are
    repaired through ``core/recovery.fail_and_recover`` on the same
    clock, and re-grafted orphans stall for the repair latency.

    Transfer pricing (this PR): ``fair=True`` (the default) runs every
    hop of every download/upload as a fluid flow on its sender's uplink
    through the ``EventCore`` fair-share engine — weighted max-min
    sharing, re-priced progress-preservingly whenever a flow joins or
    completes, so no app keeps a stale solo (or stale congested) rate.
    Per-app ``app_weights`` / ``app_rate_caps`` (falling back to the
    handles' ``transfer_weight`` / ``rate_cap_mbps``) bias or bound each
    app's share, and ``relay_admission`` (a ``RelayAdmission``) defers
    stale commits at contended relays.  ``fair=False`` restores the
    PR-3 start-time-only pricing bit for bit; a single-flow (never
    contended) trace is identical in both modes.  Per-app uplink bytes
    are accounted per delivered commit leg; ``transport_stats()`` and the
    per-apply ``fairness_log`` expose throughput and Jain's index.

    Compressed transport (docs/performance.md "compressed transport"):
    ``app_compression`` (an ``fl/compression.CompressionPolicy``, kind
    string, or per-app list; falling back to the handles'
    ``compression`` fields) prices every COMMIT leg at
    ``policy.wire_bytes(model_bytes)`` — through the fair-share flows,
    the legacy start-time pricing, and the sampled cold-cycle legs
    alike — and credits the uplink ledger at the same compressed size.
    Downloads stay full-model-sized.  ``None`` / ``kind="none"``
    reproduces the uncompressed trace byte-identically
    (tests/test_compression.py).

    Two control knobs are pluggable (both default OFF, preserving the
    PR-2 trace exactly):

    - ``adaptive=True`` replaces the fixed ``buffer_k`` with one
      ``AdaptiveKController`` per app (``buffer_k`` becomes K's initial
      value; ``adaptive_kwargs`` forwards controller config).  The live
      controllers are exposed as ``self.controllers`` after ``run()``.
    - ``selector`` (an ``fl/selection.ClientSelector``) gates every
      would-be worker cycle: declined workers are *parked* and
      re-offered at their app's next apply.  A liveness guard force-
      admits when fewer than K workers are in flight, so selection can
      never deadlock the buffer.

    Scale layer (docs/performance.md "scale layer"):

    - ``cohort=True`` (default) batches per-worker cycle events into one
      global heap entry per app cohort (``EventCore.schedule_cohort``):
      the heap holds O(apps + uplinks) entries instead of O(workers),
      and the dispatch order — hence the ApplyEvent/ChurnRecord trace —
      is byte-identical to the per-event baseline (``cohort=False``).
    - ``congestion_mode="exact"`` (default) prices every transfer leg
      through the fluid fair-share engine.  ``"sampled"`` prices COLD
      cycles statistically: the whole download+compute+upload cycle is
      priced once at start against the current uplink loads and runs as
      a single cohort event, while any cycle whose path crosses a hot
      uplink (>= ``hot_threshold`` concurrent flows + cold cycles) still
      runs exact leg-by-leg.  ``hot_threshold=0`` therefore degenerates
      sampled mode to exact mode (a tested invariant).  Cold cycles skip
      relay admission (their hops never individually materialize).
    """

    def __init__(
        self,
        system,
        handles,
        *,
        model_bytes: float,
        compute_ms: float | Callable = 50.0,
        base_ms: float = 5.0,
        buffer_k: int | list[int] = 8,
        churn: ChurnModel | None = None,
        trainer=None,
        barrier: bool = False,
        adaptive: bool = False,
        adaptive_kwargs: dict | None = None,
        selector=None,
        fair: bool = True,
        app_weights: float | list[float] | None = None,
        app_rate_caps: float | list[float] | None = None,
        relay_admission: RelayAdmission | None = None,
        incremental: bool = True,
        cohort: bool = True,
        congestion_mode: str = "exact",
        hot_threshold: int = 4,
        resample_every: float | None = None,
        resample_events: int | None = None,
        resample_target_error: float | None = None,
        app_compression=None,
        placement=None,
    ):
        super().__init__(
            system, handles, model_bytes=model_bytes, base_ms=base_ms,
            incremental=incremental,
        )
        if congestion_mode not in ("exact", "sampled"):
            raise ValueError(
                f"congestion_mode must be 'exact' or 'sampled', got {congestion_mode!r}"
            )
        if (resample_every is not None or resample_events is not None) and (
            congestion_mode != "sampled"
        ):
            raise ValueError(
                "resample_every/resample_events refresh frozen cold-cycle "
                "loads and only apply to congestion_mode='sampled'"
            )
        if resample_every is not None and not resample_every > 0:
            raise ValueError(f"resample_every must be > 0 ms, got {resample_every!r}")
        if resample_events is not None and not resample_events > 0:
            raise ValueError(f"resample_events must be > 0, got {resample_events!r}")
        if resample_target_error is not None:
            if resample_every is None and resample_events is None:
                raise ValueError(
                    "resample_target_error adapts the resample cadence and "
                    "needs resample_every and/or resample_events as the base"
                )
            if not resample_target_error > 0:
                raise ValueError(
                    f"resample_target_error must be > 0, got {resample_target_error!r}"
                )
        self.cohort = bool(cohort)
        self.congestion_mode = congestion_mode
        self.hot_threshold = int(hot_threshold)
        self.resample_every = None if resample_every is None else float(resample_every)
        self.resample_events = None if resample_events is None else int(resample_events)
        self.resample_target_error = (
            None if resample_target_error is None else float(resample_target_error)
        )
        # constructor-time cadence, restored at each run() so adaptation
        # never leaks across runs
        self._resample_every0 = self.resample_every
        self._resample_events0 = self.resample_events
        # live placement engine (docs/architecture.md "placement layer");
        # None keeps every hook dormant and the event trace byte-identical
        from .pathplan import PlacementEngine

        if placement is True:
            placement = PlacementEngine()
        if placement is not None and not isinstance(placement, PlacementEngine):
            raise TypeError(
                f"placement must be None or a PlacementEngine, got {placement!r}"
            )
        self.placement = placement
        self.compute_ms = compute_ms
        self.trainer = trainer
        self.barrier = barrier
        if isinstance(buffer_k, int):
            self.buffer_k = [buffer_k] * len(self.handles)
        else:
            self.buffer_k = list(buffer_k)
        assert len(self.buffer_k) == len(self.handles)
        self.churn = churn
        self.adaptive = bool(adaptive)
        self.adaptive_kwargs = dict(adaptive_kwargs or {})
        self.selector = selector
        self.fair = bool(fair)
        self.relay_admission = relay_admission
        self._weight = self._per_app(app_weights, "transfer_weight", 1.0)
        self._cap = self._per_app(app_rate_caps, "rate_cap_mbps", None)
        if any(w <= 0 for w in self._weight) or any(
            c is not None and c <= 0 for c in self._cap
        ):
            raise ValueError(
                "app transfer weights must be > 0 and rate caps > 0 Mbps "
                f"(got weights={self._weight}, caps={self._cap}): a zero "
                "share would price the app's transfers at rate 0 and its "
                "cycles would never complete"
            )
        # compression (docs/performance.md "compressed transport" /
        # "compressed downlink"): a per-app CompressionPolicy shrinks the
        # COMMIT payload, and — when its downlink axis is on — the
        # BROADCAST payload too; the compressed byte counts are what
        # every pricing path sees: fair-share flows (open_flow mbit),
        # the legacy start-time pricing, and sampled cold-cycle legs.
        # Download legs are priced per worker (_download_mbit): a
        # delta-qsgd worker pays its version-gap chain, a rejoiner or
        # over-cap straggler the full f32 fallback.  policy None /
        # kind="none" / downlink="none" reproduces model_bytes through
        # the same float expressions, so disabled traces stay
        # byte-identical.
        from ..fl.compression import CompressionPolicy, as_policy

        if isinstance(app_compression, (str, CompressionPolicy)):
            app_compression = [app_compression] * len(handles)
        self._compression = [
            as_policy(p) for p in self._per_app(app_compression, "compression", None)
        ]
        self._commit_bytes = [
            float(model_bytes) if p is None else p.wire_bytes(model_bytes)
            for p in self._compression
        ]
        self._commit_mbit = [b * 8e-6 for b in self._commit_bytes]
        # steady-state broadcast size for the placement planner: one
        # version delta for delta-qsgd, the quantized model for
        # downlink qsgd-int8, env.packet_mbit (the same float object)
        # when the downlink is uncompressed
        self._downlink_mbit_plan = [
            self.env.packet_mbit
            if (p is None or not p.downlink_enabled)
            else p.downlink_wire_bytes(model_bytes, chain=1) * 8e-6
            for p in self._compression
        ]
        self.controllers: list[AdaptiveKController | None] = []
        self.history: list[ApplyEvent] = []
        self.churn_log: list[ChurnRecord] = []
        self.defer_log: list[DeferRecord] = []
        self.fairness_log: list[dict] = []
        # per-app run state (filled by run())
        self._version: list[int] = []
        self._buffer: list[list[tuple[int, int]]] = []  # (worker, version)
        self._done: list[bool] = []
        self._cycle: dict[tuple[int, int], int] = {}
        self._version_at_start: dict[tuple[int, int], int] = {}
        self._pending_ev: dict[tuple[int, int], int] = {}
        self._pending_flow: dict[tuple[int, int], int] = {}
        self._delay_until: dict[tuple[int, int], float] = {}
        self._cycle_start: dict[tuple[int, int], float] = {}
        self._parked: list[set[int]] = []
        self._failed: set[int] = set()
        self._orig_workers: list[set[int]] = []
        self._applies_target = 1
        # weighted-fair transport state
        self._uplink_bytes: list[float] = []
        # downlink ledger + per-worker delta-chain state (compressed
        # downlink): which version each worker last downloaded, and the
        # byte credit stashed at cycle start until the cycle completes
        self._downlink_bytes: list[float] = []
        self._worker_base: dict[tuple[int, int], int] = {}
        self._pending_down_bytes: dict[tuple[int, int], float] = {}
        self.downlink_log: list[tuple] = []  # (t, ai, w, chain|None, bytes)
        self._done_ms: list[float] = []
        self._defer_count: list[int] = []
        self._deferred: dict[int, list[dict]] = {}  # relay -> FIFO of records
        self._deferred_by_key: dict[tuple[int, int], dict] = {}
        self._path_cache: dict[tuple[int, int, bool], np.ndarray] = {}
        # sampled-congestion state: cold cycles occupy their uplinks
        # statistically (a load counter) instead of as fluid flows
        self._cold_load = np.zeros(len(self._cap_f32), np.int64)
        self._cold_hops: dict[tuple[int, int], np.ndarray] = {}
        # resampling state: in-flight cold-cycle spans for re-pricing
        # key -> (t_priced, t_end, down_idx, up_idx, compute_ms)
        self._cold_span: dict[tuple[int, int], tuple] = {}
        self._resample_count = 0
        # adaptive-cadence controller state (resample_target_error)
        self.resample_log: list[tuple] = []  # (t, err_ema, every, events)
        self._resample_err: float | None = None
        # placement replan state (the lazy-invalidation pattern: triggers
        # only mark dirty; the replan itself runs at the next apply/churn
        # boundary once min_interval_ms has passed)
        self.replan_log: list[ReplanRecord] = []
        self._replan_dirty: str | None = None
        self._last_replan_ms = float("-inf")
        self.control_bytes = 0.0

    def _per_app(self, value, handle_attr: str, default):
        """Resolve a per-app knob: explicit arg (scalar broadcast or
        list) beats the handle attribute beats the default."""
        n = len(self.handles)
        if value is None:
            return [getattr(h, handle_attr, default) for h in self.handles]
        if isinstance(value, (int, float)):
            return [value] * n
        vals = list(value)
        assert len(vals) == n
        return vals

    # -- worker membership ----------------------------------------------------

    def _workers(self, ai: int) -> list[int]:
        if self.trainer is not None:
            return self.trainer.workers(ai)
        return sorted(self.handles[ai].tree.members)

    def _live_workers(self, ai: int) -> list[int]:
        return [w for w in self._workers(ai) if w not in self._failed]

    def _effective_k(self, ai: int) -> int:
        """Clamp K to the live membership so churn can't stall the buffer.
        In adaptive mode the base K comes from the app's controller."""
        ctrl = self.controllers[ai] if self.controllers else None
        k = ctrl.current_k if ctrl is not None else self.buffer_k[ai]
        live = len(self._live_workers(ai))
        return max(1, min(k, live)) if live else k

    # -- per-worker cycle ------------------------------------------------------

    def _path_senders(self, ai: int, w: int, *, up: bool) -> np.ndarray:
        """Sender index array for one leg, memoized on a numpy-resident
        route table: trees only change on churn (fail/repair/rejoin), so
        the per-cycle ``path_to_root`` walks + dict lookups are paid once
        per (app, worker, direction) between churn events — churn
        handlers clear the cache wholesale after repairs."""
        key = (ai, w, up)
        cached = self._path_cache.get(key)
        if cached is None:
            if ("warm", ai) not in self._path_cache:
                # first miss after a cache clear: bulk-fill both legs for
                # every tree member in two vectorized passes (paths_matrix
                # + sender_indices_many) instead of per-worker walks; the
                # marker key rides in the cache so any wholesale clear
                # (churn repair) automatically re-arms the warm.
                self._path_cache[("warm", ai)] = np.asarray([], np.int32)
                self._warm_path_cache(ai)
                cached = self._path_cache.get(key)
        if cached is None:
            tree = self.handles[ai].tree
            if w == tree.root:
                cached = np.asarray([], np.int32)
            else:
                path = tree.path_to_root(w)  # w -> root
                hops = path if up else list(reversed(path))
                cached = self.sender_indices(hops[:-1])
            self._path_cache[key] = cached
        return cached

    def _warm_path_cache(self, ai: int) -> None:
        """Vectorized route-table fill for one app's tree members.  Only
        members the tree can resolve are warmed — anything else falls
        through to the scalar path, which raises exactly where the
        legacy per-worker walk would."""
        tree = self.handles[ai].tree
        root = tree.root
        members = [w for w in tree.members if w == root or w in tree.parent]
        if not members:
            return
        arr = np.asarray(members, np.int64)
        try:
            mat = tree.paths_matrix(arr)
            d = tree.depths_of(arr)
            valid = mat >= 0
            idx = np.full(mat.shape, -1, np.int32)
            idx[valid] = self.sender_indices_many(mat[valid])
        except (KeyError, RuntimeError):
            return  # mid-repair transient: scalar path reports the error
        for i in range(len(arr)):
            w, di = int(arr[i]), int(d[i])
            row = idx[i]
            self._path_cache[(ai, w, True)] = row[:di].copy()
            self._path_cache[(ai, w, False)] = row[1 : di + 1][::-1].copy()

    def _sched_worker(self, ai: int, delay_ms: float, callback: Callable,
                      senders: np.ndarray | None = None) -> int:
        """Schedule one per-worker cycle event — cohort-batched per app
        when ``cohort`` is on, a plain heap entry otherwise."""
        if self.cohort:
            return self.schedule_cohort(ai, delay_ms, callback, senders)
        return self.schedule(delay_ms, callback, senders)

    # -- sampled/statistical congestion (cold-path cycles) ---------------------

    def _uplink_load(self, sender: int) -> int:
        """Concurrent occupancy of one uplink: fluid flows + cold cycles."""
        return len(self._flows_by_sender.get(int(sender), ())) + int(
            self._cold_load[int(sender)]
        )

    def _is_hot(self, hops: np.ndarray) -> bool:
        if self.hot_threshold <= 0:
            return True
        return any(self._uplink_load(int(s)) >= self.hot_threshold for s in hops)

    def _sampled_leg_ms(self, senders: np.ndarray, mbit: float | None = None) -> float:
        """Statistical store-and-forward price of one leg: each hop at its
        *current* load (fluid flows + cold cycles + this one), frozen for
        the cycle's whole duration.  Same f32 arithmetic as the legacy
        ``transfer_ms`` pricing, with the cold-cycle load folded in.
        ``mbit`` overrides the payload size (compressed commit legs)."""
        if len(senders) == 0:
            return 0.0
        own = np.asarray(senders)
        counts = np.asarray(
            [1 + self._uplink_load(int(s)) for s in own], np.float32
        )
        rate = self._cap_f32[own] / np.maximum(counts, np.float32(1.0))
        lat = np.float32(self.base_ms) + np.float32(
            1e3 * (self.env.packet_mbit if mbit is None else mbit)
        ) / np.maximum(rate, np.float32(1e-6))
        return float(lat.sum())

    def _start_cycle_cold(
        self, ai: int, w: int, delay: float, down_mbit: float | None = None
    ) -> None:
        """Sampled-mode cold path: price the whole cycle now, occupy its
        uplinks statistically, and complete in ONE cohort event.
        ``down_mbit`` carries the compressed broadcast size (None keeps
        the legacy full-model price, bit for bit)."""
        key = (ai, w)
        down = self._path_senders(ai, w, up=False)
        up = self._path_senders(ai, w, up=True)
        cyc = self._cycle.get(key, 0)
        if callable(self.compute_ms):
            comp = float(self.compute_ms(self.handles[ai], w, cyc))
        else:
            comp = float(self.compute_ms)
        dur = (
            delay + self._sampled_leg_ms(down, down_mbit) + comp
            + self._sampled_leg_ms(up, self._commit_mbit[ai])
        )
        hops = np.concatenate([down, up]).astype(np.int64)
        if len(hops):
            np.add.at(self._cold_load, hops, 1)
            self._cold_hops[key] = hops
            self._cold_span[key] = (
                self.now, self.now + dur, down, up, comp + delay, dur, down_mbit
            )
        self._pending_ev[key] = self._sched_worker(
            ai, dur, lambda t, ai=ai, w=w: self._finish_cold_cycle(ai, w, t)
        )

    def _release_cold(self, key: tuple[int, int]) -> None:
        hops = self._cold_hops.pop(key, None)
        self._cold_span.pop(key, None)
        if hops is not None:
            np.subtract.at(self._cold_load, hops, 1)

    def _finish_cold_cycle(self, ai: int, w: int, t: float) -> None:
        self._release_cold((ai, w))
        self._on_uploaded(ai, w, t)

    def _resample_cold(self, t: float) -> None:
        """Re-price every in-flight cold cycle against *current* loads.

        A cold cycle freezes its transfer price at start; under bursty
        contention that estimate drifts.  This refresh treats the cycle
        as a fluid job: the fraction of work left is (t_end - t) /
        (t_end - t_priced), and finishing that fraction at today's
        prices takes frac * new_total — the same progress-preserving
        rule the exact engine uses when a fair-share rate changes.  Each
        cycle's own uplink occupancy is subtracted while re-pricing (the
        start-time price also excluded it, counting itself via the +1 in
        ``_sampled_leg_ms``), and unchanged prices are detected by exact
        f32 equality (identical loads reproduce the identical sum), so a
        cycle whose congestion did not move keeps its scheduled event —
        with no cold cycles in flight (e.g. ``hot_threshold=0``) a
        resample is a pure no-op and the apply/churn trace stays
        identical to exact mode."""
        self._resample_count += 1
        drift_sum, drift_n = 0.0, 0
        for key in list(self._cold_span):
            span = self._cold_span.get(key)
            hops = self._cold_hops.get(key)
            if span is None or hops is None:
                continue
            t0, t1, down, up, fixed, total, down_mbit = span
            if t1 <= t or t1 <= t0:
                continue  # completing at this very instant
            np.subtract.at(self._cold_load, hops, 1)
            new_total = (
                self._sampled_leg_ms(down, down_mbit) + fixed
                + self._sampled_leg_ms(up, self._commit_mbit[key[0]])
            )
            np.add.at(self._cold_load, hops, 1)
            drift_n += 1
            if new_total == total:
                continue  # unchanged price: keep the event (no seq churn)
            drift_sum += abs(new_total - total) / total
            new_end = t + (t1 - t) / (t1 - t0) * new_total
            old_ev = self._pending_ev.get(key)
            if old_ev is not None:
                self.cancel(old_ev)
            ai, w = key
            self._pending_ev[key] = self._sched_worker(
                ai, new_end - t, lambda tt, ai=ai, w=w: self._finish_cold_cycle(ai, w, tt)
            )
            self._cold_span[key] = (t, new_end, down, up, fixed, new_total, down_mbit)
        if self.resample_target_error is not None and drift_n:
            self._adapt_resample_cadence(t, drift_sum / drift_n)

    def _adapt_resample_cadence(self, t: float, err: float) -> None:
        """Adaptive cadence: the measured relative price drift per
        resample IS the apply-time error the fixed cadence only measured
        — so control it.  Drift above ``resample_target_error`` halves
        the interval (more refreshes), drift below half the target
        relaxes it by 1.25x; both knobs stay within [base/8, 4*base] of
        their constructor values.  A 50/50 EMA smooths bursts.  Off
        (target None) never touches the cadence, keeping traces
        identical."""
        ema = err if self._resample_err is None else 0.5 * err + 0.5 * self._resample_err
        self._resample_err = ema
        tgt = self.resample_target_error
        scale = 0.5 if ema > tgt else (1.25 if ema < 0.5 * tgt else 1.0)
        if scale != 1.0:
            if self.resample_every is not None:
                base = self._resample_every0
                self.resample_every = float(
                    min(4.0 * base, max(base / 8.0, self.resample_every * scale))
                )
            if self.resample_events is not None:
                base = self._resample_events0
                self.resample_events = int(
                    round(min(4 * base, max(max(1, base // 8), self.resample_events * scale)))
                )
        self.resample_log.append((t, ema, self.resample_every, self.resample_events))

    def _on_resample_timer(self, t: float) -> None:
        self._resample_cold(t)
        self.schedule(self.resample_every, self._on_resample_timer)

    def _offer_cycle(self, ai: int, w: int) -> None:
        """Gate a worker's next cycle through the selector (if any).

        Declined workers are parked until the app's next apply.  The
        liveness guard admits whenever fewer than K workers are in
        flight — otherwise selection could park everyone and the buffer
        would never fill.  The guard runs *before* the selector is
        consulted, so a forced admission is not an offer: it neither
        burns blocklist decay nor counts as a parked decline.
        """
        if self._done[ai] or w in self._failed:
            return
        if self.selector is None:
            self._start_cycle(ai, w)
            return
        active = sum(1 for (a, _) in self._pending_ev if a == ai)
        if active < self._effective_k(ai):
            # liveness guard: fewer than K cycles in flight — this worker
            # is needed regardless of utility.  Drain its blocklist too
            # (satellite fix): when adaptive K exceeds the live
            # non-blocklisted pool, forced admissions must spend the
            # block, or the blocklist pins workers the buffer depends on.
            drain = getattr(self.selector, "on_force_admit", None)
            if drain is not None:
                drain(ai, w)
            self._parked[ai].discard(w)
            self._start_cycle(ai, w)
        elif self.selector.admit(ai, w, self.now):
            self._parked[ai].discard(w)
            self._start_cycle(ai, w)
        else:
            self._parked[ai].add(w)

    def _download_mbit(self, ai: int, w: int, senders) -> float | None:
        """Price one broadcast (download) leg for this worker's cycle.

        ``None`` means the downlink is uncompressed — callers fall
        through to the exact legacy expressions (``env.packet_mbit``),
        keeping disabled traces byte-identical.  Otherwise the size is
        ``downlink_wire_bytes``: for delta-qsgd, the worker's version
        gap as a delta chain when its cached base is within
        ``chain_cap`` (a gap of 0 is a free version check), the full
        f32 state when it has no base (first download, churn rejoin —
        ``_worker_base`` is dropped on fail) or the gap exceeds the
        cap.  The byte credit (size x path legs) is stashed and lands
        on the per-app downlink ledger when the cycle commits — the
        same cycle-completion granularity the uplink ledger uses in
        every pricing mode."""
        p = self._compression[ai]
        if p is None or not p.downlink_enabled:
            return None
        key = (ai, w)
        cur = self._version[ai]
        chain = None
        if p.downlink == "delta-qsgd":
            base = self._worker_base.get(key)
            if base is not None and 0 <= cur - base <= p.chain_cap:
                chain = cur - base
        self._worker_base[key] = cur
        down_bytes = p.downlink_wire_bytes(self.model_bytes, chain=chain)
        self._pending_down_bytes[key] = down_bytes * len(senders)
        self.downlink_log.append((self.now, ai, w, chain, down_bytes))
        return down_bytes * 8e-6

    def _start_cycle(self, ai: int, w: int) -> None:
        if self._done[ai] or w in self._failed:
            return
        key = (ai, w)
        delay = max(0.0, self._delay_until.pop(key, self.now) - self.now)
        self._version_at_start[key] = self._version[ai]
        self._cycle_start[key] = self.now
        if self.trainer is not None:
            self.trainer.begin_download(ai, w)
        senders = self._path_senders(ai, w, up=False)
        down_mbit = self._download_mbit(ai, w, senders)
        if self.congestion_mode == "sampled" and not (
            self._is_hot(senders) or self._is_hot(self._path_senders(ai, w, up=True))
        ):
            self._start_cycle_cold(ai, w, delay, down_mbit)
            return
        if self.fair:
            self._begin_leg(
                ai, w, senders, delay, commit=False, mbit=down_mbit,
                done=lambda t, ai=ai, w=w: self._on_downloaded(ai, w, t),
            )
            return
        dur = delay + self.transfer_ms(senders, reduce="sum", mbit=down_mbit)
        self._pending_ev[key] = self._sched_worker(
            ai, dur, lambda t, ai=ai, w=w: self._on_downloaded(ai, w, t), senders
        )

    def _on_downloaded(self, ai: int, w: int, t: float) -> None:
        if self._done[ai] or w in self._failed:
            return
        cyc = self._cycle.get((ai, w), 0)
        if callable(self.compute_ms):
            dur = float(self.compute_ms(self.handles[ai], w, cyc))
        else:
            dur = float(self.compute_ms)
        self._pending_ev[(ai, w)] = self._sched_worker(
            ai, dur, lambda t, ai=ai, w=w: self._on_computed(ai, w, t)
        )

    def _on_computed(self, ai: int, w: int, t: float) -> None:
        if self._done[ai] or w in self._failed:
            return
        senders = self._path_senders(ai, w, up=True)
        if self.fair:
            self._begin_leg(
                ai, w, senders, 0.0, commit=True,
                done=lambda t, ai=ai, w=w: self._on_uploaded(ai, w, t),
            )
            return
        dur = self.transfer_ms(senders, reduce="sum", mbit=self._commit_mbit[ai])
        self._pending_ev[(ai, w)] = self._sched_worker(
            ai, dur, lambda t, ai=ai, w=w: self._on_uploaded(ai, w, t), senders
        )

    # -- fair-share leg execution (hop-by-hop fluid flows) ---------------------

    def _begin_leg(
        self, ai: int, w: int, senders, delay: float, *, commit: bool, done,
        mbit: float | None = None,
    ) -> None:
        """Run one transfer leg (download or upload) as sequential per-hop
        flows on the fair-share engine.  The leg's store-and-forward total
        for an uncontended path equals the legacy ``reduce="sum"`` price
        exactly: sum over hops of ``base_ms + mbit / capacity``.  Commit
        legs pass relay admission at every intermediate hop.  ``(ai, w)``
        stays in
        ``_pending_ev`` for the whole leg (cycle liveness/barrier checks
        key off membership, not the stored seq)."""
        key = (ai, w)
        hops = [int(s) for s in senders]
        if not hops:
            self._pending_ev[key] = self._sched_worker(ai, delay, lambda t: done(t))
            return

        def start_hop(j: int, extra: float) -> None:
            if self._done[ai] or w in self._failed:
                return
            relay = hops[j]
            if commit and j > 0 and self._admission_defers(ai, w, relay):
                # resume bypasses the admission re-check: a deadline-forced
                # resume must forward unconditionally (no re-deferral, so
                # max_defer_ms is a hard bound, not a livelock)
                self._defer_hop(ai, w, relay, lambda j=j, extra=extra: launch_hop(j, extra))
                return
            launch_hop(j, extra)

        def launch_hop(j: int, extra: float) -> None:
            if self._done[ai] or w in self._failed:
                return
            self._pending_ev[key] = self._sched_worker(
                ai, self.base_ms + extra,
                lambda t, j=j, relay=hops[j]: open_hop(j, relay),
            )

        if mbit is not None:
            leg_mbit = mbit  # compressed broadcast size from _download_mbit
        else:
            leg_mbit = self._commit_mbit[ai] if commit else self.env.packet_mbit

        def open_hop(j: int, relay: int) -> None:
            if self._done[ai] or w in self._failed:
                return
            self._pending_flow[key] = self.open_flow(
                relay, leg_mbit,
                weight=self._weight[ai], rate_cap=self._cap[ai],
                on_done=lambda t, j=j: hop_done(j, t), group=ai,
            )

        def hop_done(j: int, t: float) -> None:
            self._pending_flow.pop(key, None)
            if j + 1 < len(hops):
                start_hop(j + 1, 0.0)
            else:
                done(t)

        start_hop(0, delay)

    def _admission_defers(self, ai: int, w: int, relay: int) -> bool:
        adm = self.relay_admission
        if adm is None or self.flow_contenders(relay) < adm.min_contenders:
            return False
        staleness = self._version[ai] - self._version_at_start[(ai, w)]
        return (1.0 + staleness) ** (-adm.alpha) < adm.threshold

    def _defer_hop(self, ai: int, w: int, relay: int, resume: Callable[[], None]) -> None:
        """Park a stale commit's hop at a contended relay.  It resumes
        FIFO when a flow on the relay's uplink completes (and admission
        passes again), or unconditionally at ``max_defer_ms``."""
        key = (ai, w)
        t0 = self.now

        def fire(t: float, forced: bool) -> None:
            rec = self._deferred_by_key.pop(key, None)
            if rec is None:
                return  # already resumed or cancelled by churn
            queue = self._deferred.get(relay)
            if queue is not None:
                queue.remove(rec)
                if not queue:
                    del self._deferred[relay]
            if not forced:
                self.cancel(rec["deadline_ev"])
            self.defer_log.append(DeferRecord(t0, t, ai, w, relay, forced))
            self._defer_count[ai] += 1
            if self.placement is not None:
                # transport deferral observed: flag the worker for
                # re-placement and mark the planner dirty (lazy — the
                # replan runs at the next apply/churn boundary)
                self.placement.flag(ai, w, t - t0)
                if self._replan_dirty is None:
                    self._replan_dirty = "defer"
            if self.selector is not None:
                on_defer = getattr(self.selector, "on_defer", None)
                if on_defer is not None:
                    on_defer(ai, w, t, t - t0)
            resume()

        rec = {"key": key, "relay": relay, "fire": fire}
        rec["deadline_ev"] = self.schedule(
            self.relay_admission.max_defer_ms, lambda t: fire(t, True)
        )
        # the deadline event keeps (ai, w) cancellable through churn
        self._pending_ev[key] = rec["deadline_ev"]
        self._deferred.setdefault(relay, []).append(rec)
        self._deferred_by_key[key] = rec

    def _on_uplink_freed(self, sender: int, t: float) -> None:
        """A flow left ``sender``'s uplink: re-offer the oldest deferred
        commit parked there (one per freed flow — FIFO, no stampede)."""
        queue = self._deferred.get(sender)
        if not queue:
            return
        for rec in list(queue):
            ai, w = rec["key"]
            if not self._admission_defers(ai, w, sender):
                rec["fire"](t, False)
                return

    def _drop_deferred(self, key: tuple[int, int]) -> None:
        rec = self._deferred_by_key.pop(key, None)
        if rec is None:
            return
        self.cancel(rec["deadline_ev"])
        queue = self._deferred.get(rec["relay"])
        if queue is not None:
            queue.remove(rec)
            if not queue:
                del self._deferred[rec["relay"]]

    def _on_uploaded(self, ai: int, w: int, t: float) -> None:
        if self._done[ai] or w in self._failed:
            return
        key = (ai, w)
        # uplink bytes are credited at commit (leg) granularity in BOTH
        # pricing modes, so fairness comparisons across modes never
        # measure accounting granularity at a horizon cut; flow-level
        # byte conservation across re-prices is asserted separately
        # (tests/test_fairness.py on _Flow.delivered_mbit)
        up_path = self._path_senders(ai, w, up=True)
        self._uplink_bytes[ai] += self._commit_bytes[ai] * len(up_path)
        # the matching downlink credit: stashed by _download_mbit when a
        # compression policy prices the broadcast, else the legacy
        # full-model size over the download path — same cycle-commit
        # granularity as the uplink ledger in every pricing mode
        down_credit = self._pending_down_bytes.pop(key, None)
        if down_credit is None:
            down_credit = self.model_bytes * len(self._path_senders(ai, w, up=False))
        self._downlink_bytes[ai] += down_credit
        if self.placement is not None and len(up_path):
            # per-uplink ledger for the placement engine's reward model
            np.add.at(self.uplink_bytes, up_path, self._commit_bytes[ai])
        self._pending_ev.pop(key, None)
        self._cycle[key] = self._cycle.get(key, 0) + 1
        self._buffer[ai].append((w, self._version_at_start.pop(key)))
        cyc_start = self._cycle_start.pop(key, None)
        if self.selector is not None and cyc_start is not None:
            self.selector.on_commit(ai, w, t, t - cyc_start)
        if self.controllers and self.controllers[ai] is not None:
            self.controllers[ai].on_commit(t)
        if self.trainer is not None:
            self.trainer.commit(ai, w, t)
        full = len(self._buffer[ai]) >= self._effective_k(ai)
        if full:
            self._apply(ai, t)
        if not self.barrier:
            self._offer_cycle(ai, w)  # next cycle begins immediately
        elif full:
            # release only workers idling at the barrier — anyone still
            # mid-flight (K < W) finishes its current cycle first; parked
            # workers were already re-offered by _apply
            for lw in self._live_workers(ai):
                if (ai, lw) not in self._pending_ev and lw not in self._parked[ai]:
                    self._offer_cycle(ai, lw)

    def _apply(self, ai: int, t: float) -> None:
        arrivals = self._buffer[ai]
        self._buffer[ai] = []
        k_used = self._effective_k(ai)
        cur = self._version[ai]
        stal = [cur - v for _, v in arrivals]
        transport = self._transport_record(ai, t)
        self.fairness_log.append(transport)
        if self.trainer is not None:
            scores = self.selector.scores(ai) if self.selector is not None else None
            self.trainer.apply(ai, t, k=k_used, selector_scores=scores, transport=transport)
        self._version[ai] = cur + 1
        if self.controllers and self.controllers[ai] is not None:
            self.controllers[ai].on_apply(t, stal, len(self._live_workers(ai)))
        self.history.append(
            ApplyEvent(
                app_id=self.handles[ai].tree.app_id,
                apply_index=cur,
                time_ms=t,
                arrivals=len(arrivals),
                mean_staleness=float(np.mean(stal)) if stal else 0.0,
                max_staleness=float(max(stal)) if stal else 0.0,
                k=k_used,
            )
        )
        if self._version[ai] >= self._applies_target:
            self._done[ai] = True
            self._done_ms[ai] = t
        elif self.selector is not None and self._parked[ai]:
            # re-offer parked workers against the post-apply utilities
            parked, self._parked[ai] = sorted(self._parked[ai]), set()
            for w in parked:
                self._offer_cycle(ai, w)
        if self.placement is not None:
            self._check_contention(transport)
            self._maybe_replan(t)

    # -- fairness telemetry ----------------------------------------------------

    def _uplink_throughputs(self) -> list[float]:
        """Per-app uplink throughput (Mbps) over each app's active
        window [0, done-or-now]."""
        out = []
        for ai in range(len(self.handles)):
            t_end = self._done_ms[ai] if self._done[ai] else self.now
            out.append(self._uplink_bytes[ai] * 8e-6 / max(t_end * 1e-3, 1e-9))
        return out

    def _transport_record(self, ai: int, t: float) -> dict:
        from ..kernels.ops import jain_fairness

        tp = self._uplink_throughputs()
        return {
            "t_ms": t,
            "app_id": self.handles[ai].tree.app_id,
            "uplink_bytes": self._uplink_bytes[ai],
            "downlink_bytes": self._downlink_bytes[ai],
            "uplink_mbps": tp[ai],
            "jain_uplink": jain_fairness(tp),
            "deferred_commits": self._defer_count[ai],
        }

    def transport_stats(self) -> dict:
        """End-of-run fairness summary: per-app uplink bytes/throughput,
        per-app completion time, Jain's index over the throughputs."""
        from ..kernels.ops import jain_fairness

        tp = self._uplink_throughputs()
        return {
            "uplink_bytes": list(self._uplink_bytes),
            "downlink_bytes": list(self._downlink_bytes),
            "uplink_mbps": tp,
            "done_ms": [
                self._done_ms[ai] if self._done[ai] else self.now
                for ai in range(len(self.handles))
            ],
            "jain_uplink": jain_fairness(tp),
            "deferred_commits": len(self.defer_log),
        }

    # -- live placement (docs/architecture.md "placement layer") ---------------

    def uplink_occupancy(self) -> np.ndarray:
        """Per-uplink concurrent occupancy (fluid flows + cold cycles) —
        the congestion ledger the placement engine plans against."""
        occ = self._cold_load.astype(np.float64)
        for s, fids in self._flows_by_sender.items():
            occ[s] += len(fids)
        return occ

    def _placement_feedback(self, ai: int, w: int, kind: str, magnitude: float) -> None:
        """Selector -> planner feedback: a transport-hurt worker is
        flagged for re-placement (``UtilitySelector.placement_hook``)."""
        self.placement.flag(ai, w, max(float(magnitude), 1.0))
        if self._replan_dirty is None:
            self._replan_dirty = "selector"

    def _check_contention(self, transport: dict) -> None:
        """Apply-time contention-spike trigger: fairness collapse or a
        pile-up on any single uplink marks the planner dirty."""
        eng = self.placement
        if self._replan_dirty is not None:
            return
        if transport["jain_uplink"] < eng.spike_jain:
            self._replan_dirty = "contention"
            return
        if self._flows_by_sender or self._cold_load.any():
            if self.uplink_occupancy().max() >= eng.spike_occupancy:
                self._replan_dirty = "contention"

    def _maybe_replan(self, t: float) -> None:
        """The lazy-invalidation pattern: triggers only mark dirty;
        the replan itself runs here, rate-limited by the engine's
        ``min_interval_ms`` so a churn storm costs one replan."""
        eng = self.placement
        if eng is None or self._replan_dirty is None:
            return
        if t - self._last_replan_ms < eng.min_interval_ms:
            return
        trigger, self._replan_dirty = self._replan_dirty, None
        self._last_replan_ms = t
        self._replan(t, trigger)

    def _replan(self, t: float, trigger: str) -> None:
        """One placement episode: plan every live app's tree against the
        measured occupancy, apply the moves through the forest's batched
        re-graft, and price the JOIN control traffic on the clock —
        moved members stall (``_delay_until``) until their JOIN lands,
        and the control bytes hit the same per-uplink ledger commits do."""
        eng = self.placement
        occ = self.uplink_occupancy()
        all_moves: list[tuple[int, int, int, int]] = []
        cost_total = 0.0
        bytes_total = 0.0
        for ai, h in enumerate(self.handles):
            if self._done[ai]:
                continue
            tree = h.tree
            try:
                rows = self.sender_indices_many(tree._ids[: tree._n])
            except KeyError:
                continue  # mid-repair transient: a tree node left the overlay
            moves = eng.plan_tree(
                tree,
                rows=rows,
                cap=self._cap_mbps,
                occ=occ,
                base_ms=self.base_ms,
                down_mbit=self._downlink_mbit_plan[ai],
                up_mbit=self._commit_mbit[ai],
                flagged=eng.consume_flags(ai),
                blocked=self._failed,
                app_idx=ai,
                now_ms=t,
            )
            if not moves:
                continue
            applied = self.system.forest.regraft_many(
                tree.app_id, [(m.node, m.new_parent) for m in moves], strict=False
            )
            if not applied:
                continue
            self._path_cache.clear()  # moved subtrees invalidate memoized routes
            applied_set = set(applied)
            for m in moves:
                if (m.node, m.new_parent) not in applied_set:
                    continue
                try:
                    senders = self._path_senders(ai, m.node, up=True)
                except KeyError:
                    senders = np.empty(0, np.int32)
                join_ms = self.transfer_ms(senders, reduce="sum", mbit=eng.join_mbit)
                cost_total += join_ms
                if len(senders):
                    np.add.at(self.uplink_bytes, senders, eng.join_bytes)
                    bytes_total += eng.join_bytes * len(senders)
                if m.node in tree.members and m.node not in self._failed:
                    key = (ai, m.node)
                    self._delay_until[key] = max(
                        self._delay_until.get(key, 0.0), t + join_ms
                    )
                all_moves.append((ai, m.node, m.old_parent, m.new_parent))
        self.control_bytes += bytes_total
        eng.replans += 1
        eng.moves_applied += len(all_moves)
        self.replan_log.append(
            ReplanRecord(t, trigger, tuple(all_moves), cost_total, bytes_total)
        )

    # -- churn -----------------------------------------------------------------

    def _schedule_churn(self) -> None:
        if self.churn is None or self.churn.exhausted():
            return
        self.schedule(self.churn.period_ms, self._on_churn_fail)

    def _victim_pool(self) -> list[int]:
        roots = {h.tree.root for h in self.handles}
        pool = set()
        for ai in range(len(self.handles)):
            if not self._done[ai]:
                pool.update(self._live_workers(ai))
        if not self.churn.allow_master_failure:
            pool -= roots
        return sorted(pool)

    def _on_churn_fail(self, t: float) -> None:
        victims = self.churn.pick_victims(self._victim_pool())
        self.churn.fired += 1
        if victims:
            self._path_cache.clear()  # repairs re-graft arbitrary subtrees
            overlay = self.system.overlay
            rejoin_info = {
                n: (overlay.space.zone_of(n), overlay.space.suffix_of(n),
                    overlay.coords[n], overlay.bandwidth[n])
                for n in victims
            }
            recovery_ms = 0.0
            for ai, h in enumerate(self.handles):
                tree = h.tree
                in_tree = [n for n in victims if n in tree.nodes() or n in tree.members]
                if not in_tree:
                    continue
                orphans = [
                    c for n in in_tree for c in tree.children.get(n, [])
                    if c not in victims
                ]
                report = self.system.fail_nodes(tree.app_id, in_tree)
                recovery_ms = max(recovery_ms, report.recovery_time_ms)
                for o in orphans:  # re-grafted subtrees stall for the repair
                    self._delay_until[(ai, o)] = t + report.recovery_time_ms
            for n in victims:
                self._failed.add(n)
                for ai in range(len(self.handles)):
                    key = (ai, n)
                    ev = self._pending_ev.pop(key, None)
                    if ev is not None:
                        self.cancel(ev)
                    fid = self._pending_flow.pop(key, None)
                    if fid is not None:
                        self.cancel_flow(fid)
                    self._release_cold(key)
                    self._drop_deferred(key)
                    self._version_at_start.pop(key, None)
                    self._cycle_start.pop(key, None)
                    # a failed worker loses its cached broadcast base:
                    # on rejoin its first download is priced full-state
                    self._worker_base.pop(key, None)
                    self._pending_down_bytes.pop(key, None)
                    self._parked[ai].discard(n)
                    if self.trainer is not None:
                        self.trainer.drop(ai, n)
            self.churn_log.append(
                ChurnRecord(t, "fail", tuple(victims), recovery_ms=recovery_ms)
            )
            # a fail can strand an app in three ways, all fixed by _kick:
            # the live pool shrank so the buffer already meets the clamped
            # K but no commit event will re-check it; live workers sit
            # parked while fewer than K cycles are in flight; or barrier
            # idlers lost the commit that would have released them
            for ai in range(len(self.handles)):
                self._kick(ai, t)
            if self.placement is not None:
                if self._replan_dirty is None:
                    self._replan_dirty = "churn"
                self._maybe_replan(t)
            self.schedule(
                self.churn.downtime_ms,
                lambda tt, victims=victims, info=rejoin_info: self._on_churn_rejoin(
                    tt, victims, info
                ),
            )
        self._schedule_churn()

    def _kick(self, ai: int, t: float) -> None:
        """Liveness after a membership change: apply if the buffer already
        meets the (possibly shrunk) effective K — commits only re-check
        fullness as they land, so a fail that clamps K below the current
        fill would otherwise stall the app forever (regression:
        tests/test_fairness.py) — then re-offer parked workers (the
        force-admit guard drains blocklists).  Barrier idlers are
        restarted ONLY when the apply fired here: the normal release in
        ``_on_uploaded`` never runs for a churn-triggered apply, but an
        unconditional re-offer would hand committed idlers a second
        cycle inside the same barrier round (duplicate commits) whenever
        any unrelated node failed."""
        if self._done[ai]:
            return
        applied = False
        if self._buffer[ai] and len(self._buffer[ai]) >= self._effective_k(ai):
            self._apply(ai, t)
            applied = True
            if self._done[ai]:
                return
        if self.selector is not None and self._parked[ai]:
            parked, self._parked[ai] = sorted(self._parked[ai]), set()
            for w in parked:
                self._offer_cycle(ai, w)
        if self.barrier and applied:
            for lw in self._live_workers(ai):
                if (ai, lw) not in self._pending_ev and lw not in self._parked[ai]:
                    self._offer_cycle(ai, lw)

    def _on_churn_rejoin(self, t: float, victims: list[int], info: dict) -> None:
        self._path_cache.clear()  # re-Subscribes re-graft the rejoiners
        overlay = self.system.overlay
        rejoined = []
        for n in victims:
            if n in overlay.alive:
                continue
            zone, suffix, coord, bw = info[n]
            try:
                overlay.join(zone, suffix, coord, bw)
            except ValueError:
                continue  # its id got reused while it was away
            rejoined.append(n)
            self._failed.discard(n)
            for ai, h in enumerate(self.handles):
                if n in self._orig_workers[ai]:
                    self.system.Subscribe(h.tree.app_id, n)
                    self._offer_cycle(ai, n)
        if rejoined:
            self.churn_log.append(ChurnRecord(t, "rejoin", tuple(rejoined)))
            if self.placement is not None:
                if self._replan_dirty is None:
                    self._replan_dirty = "churn"
                self._maybe_replan(t)

    # -- run loop --------------------------------------------------------------

    def _progress_summary(self) -> str:
        """Per-app progress for the budget-exhaustion diagnostic."""
        target = getattr(self, "_applies_target", None)
        if target is None or not self._version:
            return ""
        done = sum(1 for d in self._done if d)
        lagging = ", ".join(
            f"app{ai}={v}/{target}"
            for ai, v in enumerate(self._version)
            if not self._done[ai]
        )
        head = f"apps done {done}/{len(self._done)}"
        return head + (f" (pending: {lagging})" if lagging else "")

    def run(
        self,
        applies: int = 1,
        *,
        max_events: int = 1_000_000,
        horizon_ms: float | None = None,
    ) -> list[ApplyEvent]:
        """Run every app until it has performed ``applies`` buffered
        updates; returns the ``ApplyEvent`` history in clock order.
        ``horizon_ms`` additionally stops the clock at a fixed simulated
        time — the fairness bench uses it to compare per-app uplink
        delivery over one common contended window."""
        self._reset_clock()
        self._applies_target = applies
        n = len(self.handles)
        self._version = [0] * n
        self._buffer = [[] for _ in range(n)]
        self._done = [False] * n
        self._cycle.clear()
        self._version_at_start.clear()
        self._pending_ev.clear()
        self._pending_flow.clear()
        self._cold_load[:] = 0
        self._cold_hops.clear()
        self._cold_span.clear()
        self._resample_count = 0
        self._delay_until.clear()
        self._cycle_start.clear()
        self._parked = [set() for _ in range(n)]
        self._failed.clear()
        self._uplink_bytes = [0.0] * n
        self._downlink_bytes = [0.0] * n
        self._worker_base = {}
        self._pending_down_bytes = {}
        self.downlink_log = []
        self._done_ms = [0.0] * n
        self._defer_count = [0] * n
        self._deferred = {}
        self._deferred_by_key = {}
        self._path_cache = {}
        self.history = []
        self.churn_log = []
        self.defer_log = []
        self.fairness_log = []
        self.replan_log = []
        self.resample_log = []
        self._replan_dirty = None
        self._last_replan_ms = float("-inf")
        self.control_bytes = 0.0
        self._resample_err = None
        self.resample_every = self._resample_every0
        self.resample_events = self._resample_events0
        if self.placement is not None:
            self.placement.reset()
            self._replan_dirty = "bootstrap"
            if self.selector is not None and hasattr(self.selector, "placement_hook"):
                # close the selection loop: transport-deferred workers
                # are handed to the planner instead of blocklisted
                self.selector.placement_hook = self._placement_feedback
        self.controllers = [
            AdaptiveKController(**{"k_init": self.buffer_k[ai], **self.adaptive_kwargs})
            if self.adaptive
            else None
            for ai in range(n)
        ]
        self._orig_workers = [set(self._workers(ai)) for ai in range(n)]
        for ai in range(n):
            if not self._workers(ai):
                self._done[ai] = True
            for w in self._workers(ai):
                self._offer_cycle(ai, w)
        self._schedule_churn()
        self._tick_hook = None
        if self.resample_events is not None:
            # reads the attribute each tick: the adaptive-cadence
            # controller mutates it mid-run (a fixed cadence reads the
            # same value every time, so this stays behavior-identical)
            def _tick() -> None:
                if self.events_dispatched % self.resample_events == 0:
                    self._resample_cold(self.now)

            self._tick_hook = _tick
        if self.resample_every is not None:
            self.schedule(self.resample_every, self._on_resample_timer)
        if horizon_ms is None:
            stop = lambda: all(self._done)
        else:
            stop = lambda: all(self._done) or self.now >= horizon_ms
        self.run_events(max_events=max_events, stop=stop)
        return list(self.history)


def per_app_round_ms(history: list[RoundEvent]) -> dict[int, list[float]]:
    """app_id -> round durations (ms), in round order."""
    out: dict[int, list[float]] = {}
    for ev in sorted(history, key=lambda e: (e.app_id, e.round)):
        out.setdefault(ev.app_id, []).append(ev.duration_ms)
    return out


def per_app_apply_ms(history: list[ApplyEvent]) -> dict[int, list[float]]:
    """app_id -> apply completion times (ms), in apply order."""
    out: dict[int, list[float]] = {}
    for ev in sorted(history, key=lambda e: (e.app_id, e.apply_index)):
        out.setdefault(ev.app_id, []).append(ev.time_ms)
    return out
