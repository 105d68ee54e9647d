"""Async buffered FL data plane: real training under the event clock.

Answers to ``repro/fl/async_engine.py``.  ``AsyncTrainer`` is the
data-plane counterpart of ``core/sim.AsyncBufferScheduler``: the
scheduler decides *when* a worker's download / compute / upload events
fire; the trainer decides *what* those events mean for the model.  It
threads per-worker model versions through the system -- a worker trains
from the (possibly stale) global version it downloaded, and the master
keeps every version that still has in-flight workers.

When an apply fires, the buffered commits are grouped by model version
and every group trains in one ``engine.fused_local_training`` dispatch
(per-worker start params).  Deltas then flow through the Table-II async
verbs -- ``CommitDelta`` per worker and one ``ApplyBuffered`` -- so with
a full buffer of staleness-0 commits and alpha = 0 the applied update
equals the synchronous round's aggregate to fp tolerance.

Under an enabled ``CompressionPolicy`` each commit is quantized on the
app's device (``quantize_delta``: the ``qsgd_quantize`` kernel); error
feedback takes the residual from that same launch under qsgd-int8 at
256-value chunks (``quantize_delta_with_residual``), and through
``QuantizedDelta.dequantize`` otherwise; ``ApplyBuffered`` aggregates the int8
lattices (the int8 ``tree_aggregate_groups``), and a delta-qsgd downlink
folds each version delta into the reference reconstruction with the
``apply_quantized_broadcast`` kernel.

Units and invariants: times are simulated milliseconds from the
scheduler's clock (``t_ms``); payload sizes are bytes; staleness is
counted in model versions.  A snapshot is kept exactly as long as some
in-flight worker may still commit against it (``_gc_snapshots``), and
weight normalization happens once, inside ``ApplyBuffered``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import engine
from .compression import (
    BROADCAST_LANE,
    COMMIT_LANE,
    CompressionPolicy,
    apply_delta_chain,
    as_policy,
    quantize_broadcast_delta,
    quantize_delta,
    quantize_delta_with_residual,
)
from ..pytree import leaves, tree_map


class AsyncTrainer:
    """Per-app version store + buffered-apply data plane.

    ``apps``: ``fl/rounds.FLApp`` instances (params, shards, hyperparams).
    ``staleness_alpha``: exponent of the 1/(1+s)^a weight discount.
    ``selector``: optional ``fl/selection.ClientSelector`` -- fed each
    client's local loss + delta norm at apply time.
    ``compression``: per-app ``CompressionPolicy`` (scalar broadcast or
    list; ``None`` takes each ``AppHandle.compression``).  An enabled
    policy quantizes every commit under its own rounding draw (lane
    ``COMMIT_LANE``, the commit's sequence number); with
    ``error_feedback`` each worker's residual ``x - deq(q(x))`` is carried
    into its next commit, and a failed worker loses it.  A policy with
    ``downlink != "none"`` also compresses the broadcast direction: the
    per-version snapshot the workers train from becomes the broadcast
    state (``_broadcast_state``); the master always aggregates into the
    exact f32 params.
    """

    def __init__(
        self, system, apps, *, staleness_alpha: float = 0.5, replicate: bool = True,
        selector=None, megabatch: bool = True, compression=None,
    ):
        self.system = system
        self.apps = list(apps)
        self.staleness_alpha = float(staleness_alpha)
        self.replicate = replicate
        self.selector = selector
        self.megabatch = bool(megabatch)
        n = len(self.apps)
        if isinstance(compression, (str, CompressionPolicy)):
            compression = [compression] * n
        if compression is None:
            compression = [getattr(a.handle, "compression", None) for a in self.apps]
        if len(compression) != n:
            raise ValueError(f"{len(compression)} compression policies for {n} apps")
        self._compression = [as_policy(p) for p in compression]
        # monotone per-app commit counter: keys each commit's rounding draw
        self._commit_seq = [0] * n
        self.version = [0] * n
        self._snapshots = [{0: a.params} for a in self.apps]  # version -> params
        self._refs = [{0: 0} for _ in range(n)]  # version -> in-flight users
        self._worker_version = [dict() for _ in range(n)]  # worker -> version
        self._pending = [[] for _ in range(n)]  # committed (worker, version, seq)
        self._ef = [dict() for _ in range(n)]  # EF-SGD residual per worker
        # downlink delta-qsgd state: the reference reconstruction the
        # workers hold (== _snapshots[ai][version]) and the bounded
        # version-delta cache, keyed by the version each delta produces
        self._recon = [a.params for a in self.apps]
        self._delta_cache = [dict() for _ in range(n)]  # version -> QuantizedDelta
        self.history: list[dict] = []

    # -- scheduler hooks -------------------------------------------------------

    def workers(self, ai: int) -> list[int]:
        app = self.apps[ai]
        return [w for w in sorted(app.handle.tree.members) if w in app.data]

    def begin_download(self, ai: int, w: int) -> None:
        """The master transmits the current version to ``w``: pin it."""
        v = self.version[ai]
        self._worker_version[ai][w] = v
        self._refs[ai][v] = self._refs[ai].get(v, 0) + 1

    def commit(self, ai: int, w: int, t: float) -> None:
        """``w``'s upload landed: queue it for the next apply (its delta is
        trained lazily, batched with its version peers).  The commit's
        sequence number is pinned here, in delivery order."""
        v = self._worker_version[ai].pop(w)
        seq = self._commit_seq[ai]
        self._commit_seq[ai] += 1
        self._pending[ai].append((w, v, seq))

    def drop(self, ai: int, w: int) -> None:
        """``w`` failed mid-cycle: release its version pin.  Commits it
        already delivered stay buffered; its EF residual dies with it."""
        v = self._worker_version[ai].pop(w, None)
        if v is not None:
            self._refs[ai][v] -= 1
        self._ef[ai].pop(w, None)

    def delta_chain(self, ai: int, base: int, target: int) -> list:
        """The cached broadcast deltas reconstructing ``base -> target``.
        Raises ``KeyError`` past the cache window -- the gap the scheduler
        prices as a full f32 fallback download."""
        return [self._delta_cache[ai][v] for v in range(base + 1, target + 1)]

    def _broadcast_state(self, ai: int, params, version: int, policy) -> object:
        """What a worker downloading ``version`` actually receives.

        ``downlink="qsgd-int8"``: the dequantized full-model broadcast.
        ``"delta-qsgd"``: the previous reference reconstruction plus this
        version's quantized delta, folded in by one fused
        ``apply_delta_chain`` step (error feedback on the downlink)."""
        key = (BROADCAST_LANE, ai, version)
        if policy.downlink == "qsgd-int8":
            deq = quantize_broadcast_delta(params, policy, key).dequantize()
            return tree_map(lambda p, v: v.to(p.dtype), params, deq)
        delta = tree_map(lambda p, r: p.float() - r.float(), params, self._recon[ai])
        qd = quantize_broadcast_delta(delta, policy, key)
        cache = self._delta_cache[ai]
        cache[version] = qd
        for v in [v for v in cache if v <= version - int(policy.chain_cap)]:
            del cache[v]
        self._recon[ai] = apply_delta_chain(self._recon[ai], [qd])
        return self._recon[ai]

    def _commit_payload(self, ai: int, w: int, seq: int, d, policy):
        """The wire payload of one commit: the delta itself, or its
        quantization (EF residual folded in first, and carried after).

        Under qsgd-int8 at 256-value chunks the residual comes from the
        quantize launch itself (``quantize_delta_with_residual``); other
        kinds and chunk widths dequantize the payload and subtract, as the
        reference does (topk's residual is of the dense target, not of the
        sparsified grid it quantizes)."""
        if policy is None or not policy.enabled:
            return d
        key = (COMMIT_LANE, ai, seq)
        if not policy.error_feedback:
            return quantize_delta(d, policy, key)
        r = self._ef[ai].get(w)
        target = d if r is None else tree_map(lambda a, b: a.float() + b, d, r)
        if policy.kind == "qsgd-int8" and int(policy.chunk) == 256:
            payload, self._ef[ai][w] = quantize_delta_with_residual(target, policy, key)
            return payload
        payload = quantize_delta(target, policy, key)
        self._ef[ai][w] = tree_map(lambda a, b: a.float() - b, target, payload.dequantize())
        return payload

    def apply(
        self, ai: int, t: float, *, k: int | None = None, selector_scores=None,
        transport: dict | None = None,
    ) -> dict | None:
        """Buffer is full: train each version group, commit the deltas,
        apply the staleness-weighted update, bump the global version.

        ``k``, ``selector_scores`` and ``transport`` are the scheduler's
        telemetry; they ride into the app handle's ``round_records``.
        """
        app = self.apps[ai]
        pending, self._pending[ai] = self._pending[ai], []
        if not pending:  # commit batch drained (e.g. by churn)
            return None
        cur = self.version[ai]
        groups: dict[int, list[tuple[int, int]]] = {}
        for w, v, seq in pending:
            groups.setdefault(v, []).append((w, seq))
        versions = sorted(groups)
        if self.megabatch:
            trained = engine.fused_local_training(
                [(app, [w for w, _ in groups[v]], self._snapshots[ai][v]) for v in versions]
            )
        else:  # one dispatch per version group
            trained = [
                engine.local_training(app, [w for w, _ in groups[v]], params=self._snapshots[ai][v])
                for v in versions
            ]
        policy = self._compression[ai]
        losses, loss_weights = [], []
        for v, (deltas, weights, group_losses) in zip(versions, trained):
            ws = groups[v]
            for (w, seq), d, wt, l in zip(ws, deltas, weights, group_losses):
                payload = self._commit_payload(ai, w, seq, d, policy)
                self.system.CommitDelta(
                    app.handle.app_id, w, payload, weight=wt, staleness=cur - v
                )
                losses.append(l)
                loss_weights.append(wt)
                if self.selector is not None:
                    loss_val = float(l)
                    dnorm = 0.0  # the loss is the statistical signal when finite
                    if not np.isfinite(loss_val):
                        dnorm = float(torch.sqrt(sum(
                            torch.sum(torch.square(x.double())) for x in leaves(d)
                        )))
                    self.selector.on_train(ai, w, loss_val, dnorm)
            self._refs[ai][v] -= len(ws)
        stats = self.system.ApplyBuffered(
            app.handle.app_id, staleness_alpha=self.staleness_alpha,
            k=k, selector_scores=selector_scores, transport=transport,
        )
        agg = stats["result"]
        app.params = tree_map(lambda p, d: (p + d).to(p.dtype), app.params, agg)
        app.round_num += 1
        self.version[ai] = cur + 1
        # the snapshot is what workers RECEIVE for this version: the exact
        # params, or the compressed broadcast state when the downlink is on
        held = app.params
        if policy is not None and policy.downlink_enabled:
            held = self._broadcast_state(ai, app.params, cur + 1, policy)
        self._snapshots[ai][cur + 1] = held
        self._refs[ai][cur + 1] = self._refs[ai].get(cur + 1, 0)
        self._gc_snapshots(ai)
        if self.replicate:
            self.system.replicate_master_state(
                app.handle.app_id, {"round": app.round_num, "version": cur + 1}
            )
        record = {
            "app_id": app.handle.app_id,
            "t_ms": t,
            "version": cur + 1,
            "arrivals": len(pending),
            "k": k,
            "loss": float(np.average(losses, weights=loss_weights)),
            "mean_staleness": float(np.mean([cur - v for _, v, _ in pending])),
        }
        self.history.append(record)
        app.history.append(record)
        return record

    def _gc_snapshots(self, ai: int) -> None:
        """Drop param versions no in-flight worker can still reference."""
        cur = self.version[ai]
        for v in [v for v, r in self._refs[ai].items() if r <= 0 and v != cur]:
            self._refs[ai].pop(v)
            self._snapshots[ai].pop(v, None)


def run_async(
    system,
    apps,
    *,
    applies: int,
    buffer_k: int | list[int],
    staleness_alpha: float = 0.5,
    model_bytes: float,
    compute_ms=50.0,
    base_ms: float = 5.0,
    churn=None,
    barrier: bool = False,
    adaptive: bool = False,
    adaptive_kwargs: dict | None = None,
    selector=None,
    fair: bool = True,
    app_weights=None,
    app_rate_caps=None,
    relay_admission=None,
    compression=None,
    megabatch: bool = True,
    incremental: bool = True,
    cohort: bool = True,
    congestion_mode: str = "exact",
    hot_threshold: int = 4,
    resample_every: float | None = None,
    resample_events: int | None = None,
    resample_target_error: float | None = None,
    placement=None,
    max_events: int = 1_000_000,
) -> dict:
    """Wire an ``AsyncTrainer`` under an ``AsyncBufferScheduler`` and run
    every app to ``applies`` buffered updates.  Returns the scheduler
    apply events, churn log, and the trainer's loss-vs-simtime history.

    The arguments are the reference's (``repro/fl/async_engine.py::
    run_async``): ``compression`` (a ``CompressionPolicy``, kind string,
    per-app list, or ``None`` for the handles' fields) turns on
    compressed commits and, through its ``downlink`` axis, compressed
    broadcasts; the scheduler prices both at their wire sizes.
    ``placement`` (``None``, ``True`` or a ``core.pathplan.PlacementEngine``)
    turns on live re-placement of the apps' trees."""
    from ..core.sim import AsyncBufferScheduler

    trainer = AsyncTrainer(
        system, apps, staleness_alpha=staleness_alpha, selector=selector,
        megabatch=megabatch, compression=compression,
    )
    sched = AsyncBufferScheduler(
        system,
        [a.handle for a in apps],
        model_bytes=model_bytes,
        compute_ms=compute_ms,
        base_ms=base_ms,
        buffer_k=buffer_k,
        churn=churn,
        trainer=trainer,
        barrier=barrier,
        adaptive=adaptive,
        adaptive_kwargs=adaptive_kwargs,
        selector=selector,
        fair=fair,
        app_weights=app_weights,
        app_rate_caps=app_rate_caps,
        relay_admission=relay_admission,
        app_compression=compression,
        incremental=incremental,
        cohort=cohort,
        congestion_mode=congestion_mode,
        hot_threshold=hot_threshold,
        resample_every=resample_every,
        resample_events=resample_events,
        resample_target_error=resample_target_error,
        placement=placement,
    )
    events = sched.run(applies, max_events=max_events)
    return {
        "events": events,
        "churn": list(sched.churn_log),
        "history": list(trainer.history),
        "trainer": trainer,
        "scheduler": sched,
    }


def worker_compute_fn(base_ms: float = 40.0, spread: float = 6.0, seed: int = 0):
    """Deterministic heterogeneous edge-compute model: each (app, worker)
    draws a fixed slowdown in [1, spread] from a seeded hash -- the same
    worker is always the same straggler, for sync and async alike.  The
    draw is memoized per (app, worker)."""

    cache: dict[tuple[int, int], float] = {}

    def per_worker(handle, worker, cycle: int = 0):
        key = (handle.app_id, worker)
        ms = cache.get(key)
        if ms is None:
            rng = np.random.default_rng([seed, handle.app_id, worker])
            ms = cache[key] = base_ms * (1.0 + (spread - 1.0) * float(rng.random()))
        return ms

    return per_worker


def sync_barrier_compute_fn(per_worker):
    """Sync counterpart of a per-worker compute model: the barrier round
    waits for the slowest subscribed worker."""

    def f(handle, round_num):
        members = sorted(handle.tree.members)
        return max((per_worker(handle, w) for w in members), default=0.0)

    return f
