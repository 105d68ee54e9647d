"""Utility-based client selection for the async buffered scheduler.

The PR-2 ``AsyncBufferScheduler`` admits every live worker into every
cycle, so chronic stragglers keep feeding stale, slow commits into the
buffer and bound time-to-accuracy (FedBuff's warning; see PAPERS.md,
"Practical Federated Learning without a Server" / "EdgeFL").  This
module makes selection pluggable: the scheduler *offers* each would-be
cycle to a ``ClientSelector`` and only starts it if the selector admits
the worker; parked workers are re-offered at the app's next buffered
apply.

Two selectors ship:

- ``UniformSelector`` — admits everyone.  It is the default oracle: a
  run with a ``UniformSelector`` is trace-identical to a run with no
  selector at all (asserted by tests/test_selection.py).
- ``UtilitySelector`` — Oort-style per-client utility
  ``U(w) = stat(w) * sys(w)``:

  * statistical term ``stat``: EMA of the client's recent training
    signal (local loss when the data plane reports it, delta-norm as a
    fallback, 1.0 cold-start) — clients whose data still moves the
    model score high;
  * system term ``sys``: 1 while the client's observed cycle time
    (download + compute + upload, in simulator milliseconds) stays
    within ``deadline_ms``, and ``(deadline / cycle)^penalty`` beyond it
    — chronic stragglers decay toward 0;
  * admission: a worker is admitted when its utility reaches the
    ``admit_quantile`` of the app's current utilities, with an
    ``epsilon`` exploration floor (a seeded draw that admits *any*
    worker, blocked or not, with probability epsilon — the liveness
    lower bound: no client starves forever);
  * blocklist decay: ``blocklist_after`` consecutive deadline misses
    park the worker for ``blocklist_rounds * misses`` offers; each
    declined offer burns one, so the block decays and repeat offenders
    are parked longer, while a within-deadline commit walks the miss
    count back down.

All randomness comes from one seeded generator and every hook fires in
deterministic event order, so selection is reproducible run-to-run.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class ClientSelector(Protocol):
    """What ``AsyncBufferScheduler`` needs from a selection policy.

    ``admit`` gates a worker's next cycle (called once per offer, in
    deterministic event order).  ``on_commit`` reports the system term's
    raw signal (observed cycle wall-clock, ms).  ``on_train`` reports
    the statistical term's signal when a data plane exists (the trainer
    calls it at apply time with the client's fresh local loss and delta
    norm).  ``on_defer`` reports that one of the worker's commits was
    held back at a contended relay (``core/sim.RelayAdmission``); the
    hold time is already inside the cycle wall-clock ``on_commit``
    reports (the deadline term sees it automatically), so ``on_defer``
    is attribution: it lets a policy distinguish transport-deferred
    workers from genuinely slow ones.
    ``on_force_admit`` fires when the scheduler's liveness guard admits
    a worker without consulting ``admit`` (fewer than K cycles in
    flight): a blocklist must drain then, or selection could pin the
    very workers the buffer needs.  ``scores`` exposes the current
    utilities for telemetry.
    """

    def admit(self, app_idx: int, worker: int, now_ms: float) -> bool: ...

    def on_commit(self, app_idx: int, worker: int, now_ms: float, cycle_ms: float) -> None: ...

    def on_train(self, app_idx: int, worker: int, loss: float, delta_norm: float) -> None: ...

    def on_defer(self, app_idx: int, worker: int, now_ms: float, waited_ms: float) -> None: ...

    def on_force_admit(self, app_idx: int, worker: int) -> None: ...

    def scores(self, app_idx: int) -> dict[int, float]: ...


class UniformSelector:
    """Admit every worker, always — the PR-2 behavior as a selector.

    Kept as the default oracle: ``selector=None`` and
    ``selector=UniformSelector()`` must produce identical event traces.
    """

    def admit(self, app_idx: int, worker: int, now_ms: float) -> bool:
        return True

    def on_commit(self, app_idx: int, worker: int, now_ms: float, cycle_ms: float) -> None:
        pass

    def on_train(self, app_idx: int, worker: int, loss: float, delta_norm: float) -> None:
        pass

    def on_defer(self, app_idx: int, worker: int, now_ms: float, waited_ms: float) -> None:
        pass

    def on_force_admit(self, app_idx: int, worker: int) -> None:
        pass

    def scores(self, app_idx: int) -> dict[int, float]:
        return {}


class _ClientStats:
    __slots__ = (
        "stat", "cycle_ms", "defer_ms", "misses", "block_offers",
        "commits", "offers", "admitted", "defers", "force_admits",
    )

    def __init__(self):
        self.stat = None  # EMA of loss (preferred) or delta norm
        self.cycle_ms = None  # EMA of observed cycle time
        self.defer_ms = 0.0  # EMA of relay-admission hold time per cycle
        self.misses = 0  # consecutive deadline misses
        self.block_offers = 0  # offers left to decline (blocklist decay)
        self.commits = 0
        self.offers = 0
        self.admitted = 0
        self.defers = 0
        self.force_admits = 0


class UtilitySelector:
    """Oort-style utility gate: ``U = stat * sys`` with ε-exploration.

    Parameters
    ----------
    deadline_ms: round deadline for the system term; cycles beyond it
        are penalized by ``(deadline / cycle)^penalty``.
    epsilon: exploration floor — every offer is admitted with this
        probability regardless of utility or blocklist, so no client is
        starved forever (tests/test_selection.py asserts the bound).
    admit_quantile: utility quantile a worker must reach among its
        app's currently-known utilities (0.5 = top half admitted).
    blocklist_after / blocklist_rounds: ``blocklist_after`` consecutive
        deadline misses block the worker for ``blocklist_rounds * misses``
        offers; the block decays one offer at a time.
    ema: smoothing for both the statistical and system EMAs.
    """

    def __init__(
        self,
        *,
        deadline_ms: float = 250.0,
        epsilon: float = 0.1,
        penalty: float = 2.0,
        admit_quantile: float = 0.5,
        blocklist_after: int = 3,
        blocklist_rounds: int = 8,
        ema: float = 0.3,
        seed: int = 0,
    ):
        self.deadline_ms = float(deadline_ms)
        self.epsilon = float(epsilon)
        self.penalty = float(penalty)
        self.admit_quantile = float(admit_quantile)
        self.blocklist_after = int(blocklist_after)
        self.blocklist_rounds = int(blocklist_rounds)
        self.ema = float(ema)
        self.rng = np.random.default_rng(seed)
        self._stats: dict[tuple[int, int], _ClientStats] = {}
        self.parked_total = 0  # declined offers (telemetry)
        # placement loop (set by AsyncBufferScheduler when a
        # PlacementEngine is attached): called as hook(app_idx, worker,
        # kind, magnitude_ms).  With a hook present, a blocklist-bound
        # worker whose slowness is transport-attributed (defer EMA
        # dominates its cycle) is handed to the planner for re-placement
        # INSTEAD of being blocklisted — moving it beats benching it.
        # hook=None keeps the legacy policy bit-for-bit.
        self.placement_hook = None
        self.replaced_total = 0  # blocklists converted to re-placements
        # defer share of the cycle EMA above which a miss is considered
        # transport-caused rather than compute-caused
        self.defer_fraction = 0.5

    # -- internals -------------------------------------------------------------

    def _s(self, ai: int, w: int) -> _ClientStats:
        return self._stats.setdefault((ai, w), _ClientStats())

    def _utility(self, st: _ClientStats) -> float:
        stat = 1.0 if st.stat is None else max(float(st.stat), 1e-6)
        # relay-admission hold time already lands in the deadline term:
        # the scheduler reports end-to-end cycle wall-clock, deferral
        # included — defer_ms is kept separately only as attribution
        # (transport-deferred vs genuinely slow), never added on top
        if st.cycle_ms is None or st.cycle_ms <= self.deadline_ms:
            sys_term = 1.0
        else:
            sys_term = (self.deadline_ms / float(st.cycle_ms)) ** self.penalty
        return stat * sys_term

    # -- ClientSelector hooks --------------------------------------------------

    def admit(self, app_idx: int, worker: int, now_ms: float) -> bool:
        st = self._s(app_idx, worker)
        st.offers += 1
        explore = float(self.rng.random()) < self.epsilon
        if explore:  # liveness floor: blocklist and utility both bypassed
            st.admitted += 1
            return True
        if st.block_offers > 0:
            st.block_offers -= 1
            self.parked_total += 1
            return False
        if st.cycle_ms is None and st.stat is None:
            st.admitted += 1  # cold start: nothing observed yet
            return True
        utils = [self._utility(s) for (ai, _), s in self._stats.items() if ai == app_idx]
        bar = float(np.quantile(utils, self.admit_quantile)) if utils else 0.0
        if self._utility(st) >= bar:
            st.admitted += 1
            return True
        self.parked_total += 1
        return False

    def on_commit(self, app_idx: int, worker: int, now_ms: float, cycle_ms: float) -> None:
        st = self._s(app_idx, worker)
        st.commits += 1
        # defer attribution decays with each landed commit, mirroring the
        # cycle EMA (a commit that was not deferred walks it toward zero)
        st.defer_ms *= 1.0 - self.ema
        st.cycle_ms = (
            float(cycle_ms)
            if st.cycle_ms is None
            else self.ema * float(cycle_ms) + (1.0 - self.ema) * st.cycle_ms
        )
        if cycle_ms > self.deadline_ms:
            st.misses += 1
            if st.misses >= self.blocklist_after:
                if (
                    self.placement_hook is not None
                    and st.defer_ms >= self.defer_fraction * float(st.cycle_ms)
                ):
                    # transport-deferred, not slow: re-place instead of
                    # blocklisting; misses reset so the worker re-earns
                    # a block only if it stays late AFTER the move
                    self.placement_hook(app_idx, worker, "transport", float(st.defer_ms))
                    self.replaced_total += 1
                    st.misses = 0
                else:
                    st.block_offers = self.blocklist_rounds * st.misses
                    if self.placement_hook is not None:
                        # deadline-attributed block: still tell the
                        # planner, a better path may yet shorten cycles
                        self.placement_hook(app_idx, worker, "deadline", float(cycle_ms))
        else:
            st.misses = max(0, st.misses - 1)

    def on_train(self, app_idx: int, worker: int, loss: float, delta_norm: float) -> None:
        signal = float(loss) if np.isfinite(loss) else float(delta_norm)
        st = self._s(app_idx, worker)
        st.stat = signal if st.stat is None else self.ema * signal + (1.0 - self.ema) * st.stat

    def on_defer(self, app_idx: int, worker: int, now_ms: float, waited_ms: float) -> None:
        st = self._s(app_idx, worker)
        st.defers += 1
        st.defer_ms = self.ema * float(waited_ms) + (1.0 - self.ema) * st.defer_ms

    def on_force_admit(self, app_idx: int, worker: int) -> None:
        """Liveness-guard admission: drain the blocklist (satellite fix).
        The scheduler needs this worker to keep the buffer filling, so a
        standing block would only re-park it the moment pressure drops —
        misses are kept, so a still-slow worker can re-earn its block."""
        st = self._s(app_idx, worker)
        st.force_admits += 1
        st.block_offers = 0

    def scores(self, app_idx: int) -> dict[int, float]:
        return {
            w: self._utility(st) for (ai, w), st in sorted(self._stats.items()) if ai == app_idx
        }

    # -- telemetry -------------------------------------------------------------

    def commit_counts(self, app_idx: int) -> dict[int, int]:
        return {w: st.commits for (ai, w), st in sorted(self._stats.items()) if ai == app_idx}
