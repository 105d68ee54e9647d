"""The port's async buffered round against the JAX package (CPU).

- ``core/sim`` is a copy of the reference's numpy scheduler: its
  ApplyEvent / ChurnRecord traces and fairness log are identical to
  ``repro.core.sim``'s under churn, in exact, legacy and sampled pricing,
  with cohort batching on and off.
- ``run_async`` without compression trains to the reference's losses and
  parameters at rtol 1e-4 / atol 1e-5 (f32 training in another reduction
  order), with identical traces; K = W with a barrier equals the
  synchronous round.
- ``run_async`` with QSGD commits (EF on) and delta-QSGD broadcasts: the
  reference run's recorded commit targets and broadcast states are
  replayed through the port's ``quantize_delta`` and
  ``_broadcast_state``; every lattice, scale and reconstruction is
  bit-equal.  The reference's commits (raw deltas, uniforms, worker
  drops) replayed through the port's trainer leave the reference's
  payloads and carried EF residuals after every commit, bit for bit
  (signSGD within rtol 1e-6 of its scale, rule 4), the fused residual
  route taken exactly under qsgd-int8 at 256-value chunks.  Run end to end
  under the reference's uniforms, the traces are identical and the losses
  agree to rtol 1e-4 / atol 1e-5.

Small sizes: 150-node overlay, 4 workers per app, at most 6 applies.
"""
from dataclasses import astuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro.core import sim as jsim
from repro.core.api import TotoroSystem as JSystem
from repro.fl import async_engine as jae
from repro.fl import compression as jc
from repro.fl import rounds as jrounds
from repro.fl import selection as jsel
from repro_torch.core import sim as tsim
from repro_torch.core.api import TotoroSystem as TSystem
from repro_torch.fl import async_engine as tae
from repro_torch.fl import compression as tc
from repro_torch.fl import rounds as trounds
from repro_torch.fl import selection as tsel
from repro_torch.pytree import leaves as tleaves

TRAIN = dict(rtol=1e-4, atol=1e-5)
POLICY = dict(kind="qsgd-int8", error_feedback=True, downlink="delta-qsgd",
              downlink_levels=3, chain_cap=3)


def _trace(events):
    return [astuple(e) for e in events]


def _system(S, seed=0, n_nodes=150):
    sys_ = S(zone_bits=2, suffix_bits=20, seed=seed)
    rng = np.random.default_rng(seed)
    nodes = [sys_.Join("n", i, site=i % 4, coord=rng.uniform(0, 50, 2)) for i in range(n_nodes)]
    return sys_, nodes, rng


def _apps(S, R, *, m=1, workers=4, seed=0, params=None, **kw):
    """``m`` apps of ``workers`` workers each (tests/test_async.py's shape)."""
    sys_, nodes, rng = _system(S, seed)
    apps = []
    for a in range(m):
        x, y = jdata.synthetic_classification(workers * 150, 16, 4, seed=seed + a)
        parts = jdata.dirichlet_partition(y, workers, alpha=1.0, seed=seed + a + 1)
        parts = [p if len(p) else np.arange(3) for p in parts]
        ws = [int(w) for w in rng.choice(nodes, size=workers, replace=False)]
        extra = {} if params is None else dict(params=params[a])
        apps.append(R.make_app(
            sys_, f"async-{a}", workers=ws,
            data_by_worker={w: (x[parts[i]], y[parts[i]]) for i, w in enumerate(ws)},
            dim=16, num_classes=4, local_steps=3, lr=0.2, seed=a, **extra, **kw,
        ))
    return sys_, apps


def _pair(m=1, **kw):
    js, japps = _apps(JSystem, jrounds, m=m, **kw)
    p0 = [jax.tree.map(np.asarray, a.params) for a in japps]
    ts, tapps = _apps(TSystem, trounds, m=m, params=p0, device="cpu", **kw)
    return (js, japps), (ts, tapps)


def _run(AE, SIM, system, apps, *, applies=5, **kw):
    return AE.run_async(
        system, apps, applies=applies, buffer_k=2, staleness_alpha=0.5,
        model_bytes=4.0 * 1316, compute_ms=AE.worker_compute_fn(40.0, 6.0, seed=1),
        churn=SIM.ChurnModel(period_ms=150.0, downtime_ms=300.0, seed=3, max_fail_events=2),
        **kw,
    )


def _assert_params_close(ja, ta, tol):
    for k in ja.params:
        np.testing.assert_allclose(ta.params[k].numpy(), np.asarray(ja.params[k]), **tol)


# -- the scheduler: a copy with identical traces -------------------------------------


def _handles(S, m, seed=0, **hk):
    """Timing-only fixture: M trees of 4 workers over one overlay of
    heterogeneous uplinks (tests/test_compression.py's shape)."""
    sys_ = S(zone_bits=2, suffix_bits=22, seed=seed)
    rng = np.random.default_rng(seed)
    nodes = [sys_.Join("n", i, site=i % 4, coord=rng.uniform(0, 50, 2),
                       bandwidth=float(rng.uniform(20, 100))) for i in range(160)]
    handles = []
    for a in range(m):
        h = sys_.CreateTree(f"sched-{a}", **hk)
        for w in rng.choice(nodes, size=4, replace=False):
            sys_.Subscribe(h.app_id, int(w))
        handles.append(h)
    return sys_, handles


def _churn(SIM):
    return SIM.ChurnModel(period_ms=400.0, downtime_ms=600.0, group_size=2, seed=9,
                          max_fail_events=4)


@pytest.mark.parametrize("cohort", [True, False])
@pytest.mark.parametrize(
    "pricing",
    [dict(), dict(fair=False), dict(congestion_mode="sampled", resample_every=80.0)],
    ids=["exact", "legacy", "sampled"],
)
def test_scheduler_traces_identical_to_reference(pricing, cohort):
    out = []
    for S, SIM, AE in ((JSystem, jsim, jae), (TSystem, tsim, tae)):
        sys_, handles = _handles(S, 2)
        sched = SIM.AsyncBufferScheduler(
            sys_, handles, model_bytes=1.5e5,
            compute_ms=AE.worker_compute_fn(40.0, 6.0, seed=1), buffer_k=3,
            churn=_churn(SIM), cohort=cohort, **pricing,
        )
        events = sched.run(6, max_events=100_000)
        out.append((_trace(events), _trace(sched.churn_log), sched.fairness_log,
                    sched.transport_stats(), sched.events_dispatched))
    assert out[0][0] and out[0][1]  # applies and churn both happened
    assert out[0] == out[1]


@pytest.mark.parametrize("downlink", ["delta-qsgd", "qsgd-int8"])
def test_compressed_pricing_traces_identical_to_reference(downlink):
    """Commit and per-worker download legs priced at the policies' wire
    sizes: the copy prices them exactly as the reference does."""
    out = []
    for S, SIM, C in ((JSystem, jsim, jc), (TSystem, tsim, tc)):
        pol = C.CompressionPolicy(kind="qsgd-int8", downlink=downlink, downlink_levels=3)
        sys_, handles = _handles(S, 2, compression=pol)
        sched = SIM.AsyncBufferScheduler(
            sys_, handles, model_bytes=2e5, compute_ms=25.0, buffer_k=3, churn=_churn(SIM),
        )
        events = sched.run(4, max_events=100_000)
        out.append((_trace(events), _trace(sched.churn_log), sched.fairness_log,
                    list(sched.downlink_log)))
    assert out[0] == out[1]


def test_placement_waits_for_the_planner_slice():
    """The planner slice has landed: ``placement=True`` builds the port's
    ``PlacementEngine`` (its traces are held to the reference's in
    tests/test_torch_pathplan.py), anything else but ``None`` raises."""
    from repro_torch.core.pathplan import PlacementEngine

    sys_, handles = _handles(TSystem, 1)
    sched = tsim.AsyncBufferScheduler(sys_, handles, model_bytes=1e5, placement=True)
    assert isinstance(sched.placement, PlacementEngine)
    with pytest.raises(TypeError, match="PlacementEngine"):
        tsim.AsyncBufferScheduler(sys_, handles, model_bytes=1e5, placement="yes")


def test_compute_models_match_reference():
    _, jh = _handles(JSystem, 2)
    _, th = _handles(TSystem, 2)
    jf, tf = jae.worker_compute_fn(40.0, 6.0, seed=5), tae.worker_compute_fn(40.0, 6.0, seed=5)
    for a, b in zip(jh, th):
        for w in sorted(a.tree.members):
            assert jf(a, w) == tf(b, w)
        assert jae.sync_barrier_compute_fn(jf)(a, 0) == tae.sync_barrier_compute_fn(tf)(b, 0)


# -- training under the event clock -----------------------------------------------------


def test_run_async_uncompressed_matches_reference():
    (js, japps), (ts, tapps) = _pair(m=2)
    jres = _run(jae, jsim, js, japps)
    tres = _run(tae, tsim, ts, tapps)
    assert _trace(tres["events"]) == _trace(jres["events"])
    assert _trace(tres["churn"]) == _trace(jres["churn"])
    assert max(e.max_staleness for e in tres["events"]) > 0  # staleness was real
    np.testing.assert_allclose([h["loss"] for h in tres["history"]],
                               [h["loss"] for h in jres["history"]], **TRAIN)
    for ja, ta in zip(japps, tapps):
        _assert_params_close(ja, ta, TRAIN)


def test_run_async_barrier_k_equals_w_is_the_sync_round():
    """K = W with a barrier reproduces the synchronous engine round for
    round, in the port and against the reference."""
    _, (ta_sys, [ta]) = _pair()
    (js, [ja]), (ts, [ts_app]) = _pair()
    W = len([w for w in sorted(ta.handle.tree.members) if w in ta.data])
    res = trounds.run_async(ta_sys, [ta], applies=3, buffer_k=W, staleness_alpha=0.7,
                            model_bytes=1e5, compute_ms=25.0, barrier=True)
    assert [e.arrivals for e in res["events"]] == [W, W, W]
    for _ in range(3):
        trounds.run_round(ts, ts_app)
    _assert_params_close(ts_app, ta, dict(rtol=1e-4, atol=1e-6))
    jres = jrounds.run_async(js, [ja], applies=3, buffer_k=W, staleness_alpha=0.7,
                             model_bytes=1e5, compute_ms=25.0, barrier=True)
    assert _trace(res["events"]) == _trace(jres["events"])
    _assert_params_close(ja, ta, TRAIN)


def test_run_async_with_selector_matches_reference():
    """The copied utility selector admits the same clients on the same
    clock (its loss feedback comes from fp-tight training)."""
    (js, japps), (ts, tapps) = _pair()
    jres = _run(jae, jsim, js, japps, applies=4, selector=jsel.UtilitySelector(seed=0))
    tres = _run(tae, tsim, ts, tapps, applies=4, selector=tsel.UtilitySelector(seed=0))
    assert _trace(tres["events"]) == _trace(jres["events"])
    np.testing.assert_allclose([h["loss"] for h in tres["history"]],
                               [h["loss"] for h in jres["history"]], **TRAIN)


# -- compressed transport --------------------------------------------------------------


def _record_reference(monkeypatch):
    """Run the reference's compressed async round, recording every commit's
    pre-quantization target with its uniforms and payload, and every
    broadcast state's input and output."""
    commits, broadcasts = [], []
    real_q, real_bs = jae.quantize_delta, jae.AsyncTrainer._broadcast_state

    def quantize(target, policy, key=None):
        qd = real_q(target, policy, key)
        u = np.array(jax.random.uniform(key, qd.q.shape, jnp.float32))
        commits.append((jax.tree.map(np.array, target), u, qd))
        return qd

    def broadcast_state(self, ai, params, version, policy):
        held = real_bs(self, ai, params, version, policy)
        broadcasts.append((ai, jax.tree.map(np.array, params), version,
                           jax.tree.map(np.array, held), self._delta_cache[ai][version]))
        return held

    monkeypatch.setattr(jae, "quantize_delta", quantize)
    monkeypatch.setattr(jae.AsyncTrainer, "_broadcast_state", broadcast_state)
    (js, japps), (ts, tapps) = _pair()
    res = _run(jae, jsim, js, japps, compression=jc.CompressionPolicy(**POLICY))
    return commits, broadcasts, res, (ts, tapps)


def test_compressed_round_replayed_through_the_port_is_bit_equal(monkeypatch):
    commits, broadcasts, jres, (ts, tapps) = _record_reference(monkeypatch)
    assert len(broadcasts) == len(jres["history"]) and len(commits) == sum(
        h["arrivals"] for h in jres["history"])
    policy = tc.CompressionPolicy(**POLICY)
    rand = {}
    monkeypatch.setattr(tc, "rounding_uniforms", lambda *a: torch.from_numpy(rand["u"]))
    for target, u, jq in commits:
        rand["u"] = u
        tq = tc.quantize_delta(jax.tree.map(torch.from_numpy, target), policy, (0, 0, 0))
        np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
        np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
        deq, jdeq = tq.dequantize(), jq.dequantize()
        for k in deq:
            np.testing.assert_array_equal(deq[k].numpy(), np.asarray(jdeq[k]))
    trainer = tae.AsyncTrainer(ts, tapps, compression=policy)
    for ai, params, version, held, jqd in broadcasts:
        rand["u"] = np.array(jax.random.uniform(
            jc.broadcast_key(jc.CompressionPolicy(**POLICY), ai, version), jqd.q.shape, jnp.float32))
        got = trainer._broadcast_state(ai, jax.tree.map(torch.from_numpy, params), version, policy)
        tqd = trainer._delta_cache[ai][version]
        np.testing.assert_array_equal(tqd.q.numpy(), np.asarray(jqd.q))
        np.testing.assert_array_equal(tqd.scale.numpy(), np.asarray(jqd.scale))
        for k in held:
            np.testing.assert_array_equal(got[k].numpy(), held[k])
    assert sorted(trainer._delta_cache[0]) == sorted(
        v for _, _, v, _, _ in broadcasts)[-POLICY["chain_cap"]:]


def _record_reference_ef(monkeypatch, policy_kw):
    """Run the reference's compressed async round under ``policy_kw``,
    logging in order what its trainer did to the EF state: ("commit",
    worker, raw delta, uniforms, payload, residual after) and ("drop",
    worker)."""
    log, raw, trainer = [], [], []
    real_train = jae.engine.fused_local_training
    real_q, real_apply, real_drop = jae.quantize_delta, jae.AsyncTrainer.apply, jae.AsyncTrainer.drop
    pending = {}

    def train(groups):
        out = real_train(groups)
        raw.extend(jax.tree.map(np.array, d) for deltas, _, _ in out for d in deltas)
        return out

    def quantize(target, policy, key=None):
        qd = real_q(target, policy, key)
        pending["u"] = np.array(jax.random.uniform(key, qd.q.shape, jnp.float32))
        pending["qd"] = qd
        return qd

    def apply(self, *a, **kw):
        trainer[:] = [self]
        return real_apply(self, *a, **kw)

    def drop(self, ai, w):
        log.append(("drop", w))
        return real_drop(self, ai, w)

    (js, japps), (ts, tapps) = _pair()
    real_commit = js.CommitDelta

    def commit(app_id, w, payload, **kw):
        ef = jax.tree.map(np.array, trainer[0]._ef[0][w])
        log.append(("commit", w, raw.pop(0), pending["u"], pending["qd"], ef))
        return real_commit(app_id, w, payload, **kw)

    monkeypatch.setattr(jae.engine, "fused_local_training", train)
    monkeypatch.setattr(jae, "quantize_delta", quantize)
    monkeypatch.setattr(jae.AsyncTrainer, "apply", apply)
    monkeypatch.setattr(jae.AsyncTrainer, "drop", drop)
    monkeypatch.setattr(js, "CommitDelta", commit)
    res = _run(jae, jsim, js, japps, compression=jc.CompressionPolicy(**policy_kw))
    assert not raw
    return log, res["trainer"], (ts, tapps)


@pytest.mark.parametrize("kind,fused", [
    (dict(kind="qsgd-int8"), True),
    (dict(kind="qsgd-int8", chunk=100, levels=7), False),
    (dict(kind="topk", topk_frac=0.05), False),
    (dict(kind="signsgd", chunk=64), False),
])
def test_ef_residuals_carried_bit_equal_after_every_commit(monkeypatch, kind, fused):
    """The reference's commits replayed through the port's trainer in the
    same order (raw deltas, uniforms and drops): after every commit the
    payload and the carried residual are the reference's bits.  qsgd-int8 at
    256-value chunks takes its residual from the quantize launch, the other
    grids dequantize and subtract.  signSGD's scale is a 256-term sum in
    XLA's own order (ROADMAP §3 rule 4): its signs are exact, its scale and
    residuals within rtol 1e-6 of the scale."""
    policy_kw = dict(POLICY, **kind)
    log, jtrainer, (ts, tapps) = _record_reference_ef(monkeypatch, policy_kw)
    policy = tc.CompressionPolicy(**policy_kw)
    rand, routes = {}, []
    monkeypatch.setattr(tc, "rounding_uniforms", lambda *a: torch.from_numpy(rand["u"]))
    real_fused = tae.quantize_delta_with_residual
    monkeypatch.setattr(tae, "quantize_delta_with_residual",
                        lambda *a: routes.append(1) or real_fused(*a))
    trainer = tae.AsyncTrainer(ts, tapps, compression=policy)
    commits = [e for e in log if e[0] == "commit"]
    assert len(commits) >= 6 and any(e[0] == "drop" for e in log)
    for entry in log:
        if entry[0] == "drop":
            trainer.drop(0, entry[1])
            continue
        _, w, d, u, jqd, jef = entry
        rand["u"] = u
        payload = trainer._commit_payload(0, w, 0, jax.tree.map(torch.from_numpy, d), policy)
        np.testing.assert_array_equal(payload.q.numpy(), np.asarray(jqd.q))
        got, want = tleaves(trainer._ef[0][w]), jax.tree.leaves(jef)
        assert len(got) == len(want) > 0
        if kind["kind"] == "signsgd":
            s_max = float(np.abs(np.asarray(jqd.scale)).max())
            np.testing.assert_allclose(payload.scale.numpy(), np.asarray(jqd.scale), rtol=1e-6, atol=0)
            for g, x in zip(got, want):
                np.testing.assert_allclose(g.numpy(), x, rtol=0, atol=1e-6 * s_max)
            continue
        np.testing.assert_array_equal(payload.scale.numpy(), np.asarray(jqd.scale))
        for g, x in zip(got, want):
            assert g.dtype == torch.float32 and tuple(g.shape) == x.shape
            np.testing.assert_array_equal(g.numpy().view(np.int32), x.view(np.int32))
    assert len(routes) == (len(commits) if fused else 0)
    assert sorted(trainer._ef[0]) == sorted(jtrainer._ef[0])


def test_run_async_compressed_matches_reference(monkeypatch):
    """End to end under the reference's uniforms: identical traces and
    losses; the port's kernels of the path each ran (plain versions here)."""
    def draws(policy, lane, app_idx, n, shape, device):
        jp = jc.CompressionPolicy(**vars(policy))
        key = (jc.commit_key(jp, app_idx, n) if lane == tc.COMMIT_LANE
               else jc.broadcast_key(jp, app_idx, n))
        return torch.from_numpy(np.array(jax.random.uniform(key, tuple(shape), jnp.float32)))

    monkeypatch.setattr(tc, "rounding_uniforms", draws)
    (js, japps), (ts, tapps) = _pair()
    jres = _run(jae, jsim, js, japps, applies=6, compression=jc.CompressionPolicy(**POLICY))
    tres = _run(tae, tsim, ts, tapps, applies=6, compression=tc.CompressionPolicy(**POLICY))
    assert _trace(tres["events"]) == _trace(jres["events"])
    assert _trace(tres["churn"]) == _trace(jres["churn"])
    assert tres["scheduler"].downlink_log == jres["scheduler"].downlink_log
    np.testing.assert_allclose([h["loss"] for h in tres["history"]],
                               [h["loss"] for h in jres["history"]], **TRAIN)
    _assert_params_close(japps[0], tapps[0], TRAIN)
    tr, jr = tres["trainer"], jres["trainer"]
    assert sorted(tr._ef[0]) == sorted(jr._ef[0])  # failed workers lost their residual
    assert tapps[0].handle.traffic_bytes == japps[0].handle.traffic_bytes
