"""The port's Table-II API and FL rounds against the JAX package (CPU).

The control plane (overlay, forest, recovery) is a copy of the JAX
package's numpy code, so with the same seeds everything it decides is
*identical*: node ids, tree members, the aggregation schedule, per-level
groups / bytes / modeled time, Broadcast bytes, the new master after a
failure.  Aggregates, losses and parameters are f32 arithmetic in
another reduction order: they agree to rtol 1e-4, atol 1e-5 (rtol 1e-5,
atol 1e-6 for a single aggregation).
"""
import jax
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro.core.api import TotoroSystem as JSystem
from repro.fl import rounds as jrounds
from repro_torch.convert import params_to_numpy
from repro_torch.core.api import TotoroSystem as TSystem
from repro_torch.fl import rounds as trounds

TRAIN = dict(rtol=1e-4, atol=1e-5)
AGG = dict(rtol=1e-5, atol=1e-6)


def _build(S, R, *, n_nodes=150, workers=8, seed=0, **kw):
    """The setup of tests/test_fl.py's full-round test, for either package."""
    sys_ = S(zone_bits=2, suffix_bits=20, seed=seed)
    rng = np.random.default_rng(seed)
    nodes = [sys_.Join("n", i, site=i % 4, coord=rng.uniform(0, 50, 2)) for i in range(n_nodes)]
    x, y = jdata.synthetic_classification(1200, 16, 4, seed=seed)
    parts = jdata.dirichlet_partition(y, workers, alpha=1.0, seed=seed + 1)
    ws = [int(w) for w in rng.choice(nodes, size=workers, replace=False)]
    app = R.make_app(
        sys_, "test", workers=ws,
        data_by_worker={w: (x[parts[i]], y[parts[i]]) for i, w in enumerate(ws)},
        dim=16, num_classes=4, local_steps=4, lr=0.3, **kw,
    )
    return sys_, app, nodes, (x, y)


def _pair(seed=0, **kw):
    js, ja, jn, xy = _build(JSystem, jrounds, seed=seed, **kw)
    p0 = jax.tree.map(np.asarray, ja.params)
    ts, ta, tn, _ = _build(TSystem, trounds, seed=seed, params=p0, device="cpu", **kw)
    return (js, ja, jn), (ts, ta, tn), xy


def _levels(m):
    return [(lv["level"], lv["groups"], lv["bytes"], lv["time_ms"]) for lv in m["agg_levels"]]


def test_control_plane_identical():
    (js, ja, jn), (ts, ta, tn), _ = _pair(seed=2)
    assert jn == tn
    jt, tt = ja.handle.tree, ta.handle.tree
    assert jt.root == tt.root and sorted(jt.members) == sorted(tt.members)
    assert dict(jt.parent) == dict(tt.parent)
    assert jt.aggregation_schedule() == tt.aggregation_schedule()
    jb = js.Broadcast(ja.handle.app_id, ja.params)
    tb = ts.Broadcast(ta.handle.app_id, ta.params)
    assert jb == tb
    assert js.Discover(jn[-1]).keys() == ts.Discover(tn[-1]).keys()
    jr = js.fail_nodes(ja.handle.app_id, [jt.root])
    tr = ts.fail_nodes(ta.handle.app_id, [tt.root])
    assert jr.new_master == tr.new_master and jr.master_failed == tr.master_failed
    assert sorted(jt.members) == sorted(tt.members)
    assert jt.aggregation_schedule() == tt.aggregation_schedule()


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("mode", ["hierarchical", "flat"])
def test_aggregate_matches_jax(use_kernel, mode):
    (js, ja, _), (ts, ta, _), _ = _pair(seed=1)
    rng = np.random.default_rng(0)
    members = sorted(ja.handle.tree.members)
    ups = {n: {"w": rng.standard_normal((6, 5)).astype(np.float32),
               "b": rng.standard_normal(5).astype(np.float32)} for n in members}
    wts = {n: float(rng.uniform(1, 20)) for n in members}
    kw = dict(hierarchical=mode == "hierarchical", use_kernel=use_kernel)
    jres = js.Aggregate(ja.handle.app_id, ups, weights=wts, **kw)
    tres = ts.Aggregate(
        ta.handle.app_id,
        {n: {k: torch.from_numpy(v) for k, v in u.items()} for n, u in ups.items()},
        weights=wts, **kw,
    )
    assert [(lv["level"], lv["groups"], lv["bytes"], lv["time_ms"]) for lv in jres["levels"]] == [
        (lv["level"], lv["groups"], lv["bytes"], lv["time_ms"]) for lv in tres["levels"]
    ]
    assert (jres["bytes"], jres["time_ms"]) == (tres["bytes"], tres["time_ms"])
    for k in ("w", "b"):
        assert tres["result"][k].dtype == torch.float64
        np.testing.assert_allclose(tres["result"][k].numpy(), np.asarray(jres["result"][k]), **AGG)


def test_aggregate_hook_and_straggler_paths():
    """A custom aggregate_fn sees the raw updates; a payload from a node
    outside the tree merges at the root."""
    (js, ja, jn), (ts, ta, tn), _ = _pair(seed=4)
    outsider = next(n for n in jn if n not in ja.handle.tree.members and n != ja.handle.tree.root)
    ups = {n: {"v": np.full(3, float(i + 1), np.float32)}
           for i, n in enumerate(sorted(ja.handle.tree.members) + [outsider])}
    jres = js.Aggregate(ja.handle.app_id, ups)
    tres = ts.Aggregate(ta.handle.app_id, {n: {"v": torch.from_numpy(u["v"])} for n, u in ups.items()})
    np.testing.assert_allclose(tres["result"]["v"].numpy(), np.asarray(jres["result"]["v"]), **AGG)
    assert len(tres["levels"]) == len(jres["levels"])
    seen = []
    ts.apps[ta.handle.app_id].aggregate_fn = lambda vals, w: seen.append((len(vals), w)) or "custom"
    out = ts.Aggregate(ta.handle.app_id, {n: {"v": torch.ones(2)} for n in tn[:3]})
    assert out["result"] == "custom" and seen == [(3, [1.0, 1.0, 1.0])]


@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_commit_and_apply_buffered_match_jax(alpha):
    (js, ja, _), (ts, ta, _), _ = _pair(seed=5)
    rng = np.random.default_rng(1)
    members = sorted(ja.handle.tree.members)
    for i, w in enumerate(members[:5]):
        d = {"a": rng.standard_normal((4, 3)).astype(np.float32)}
        jc = js.CommitDelta(ja.handle.app_id, w, d, weight=10.0 + i, staleness=i % 3)
        tc = ts.CommitDelta(ta.handle.app_id, w, {"a": torch.from_numpy(d["a"])},
                            weight=10.0 + i, staleness=i % 3)
        assert jc == tc
    jr = js.ApplyBuffered(ja.handle.app_id, staleness_alpha=alpha, k=5)
    tr = ts.ApplyBuffered(ta.handle.app_id, staleness_alpha=alpha, k=5)
    for key in ("arrivals", "workers", "staleness", "staleness_hist", "version", "k"):
        assert jr[key] == tr[key], key
    np.testing.assert_allclose(tr["weights"], jr["weights"], **AGG)
    np.testing.assert_allclose(tr["result"]["a"].numpy(), np.asarray(jr["result"]["a"]), **AGG)
    assert ts.apps[ta.handle.app_id].round_records == js.apps[ja.handle.app_id].round_records
    assert ts.ApplyBuffered(ta.handle.app_id)["result"] is None  # drained


def test_apply_buffered_raises_on_quantized_commits():
    """Quantized commits mixed with raw ones in one buffer raise in both
    packages (an app's policy must cover every commit), and both drain
    the buffer before raising."""
    from repro.fl import compression as jcomp
    from repro_torch.fl import compression as tcomp

    (js, ja, jn), (ts, ta, tn), _ = _pair(seed=6)
    d = {"a": np.random.default_rng(6).standard_normal((4, 3)).astype(np.float32)}
    td = {"a": torch.from_numpy(d["a"])}
    js.CommitDelta(ja.handle.app_id, jn[0], jcomp.quantize_delta(d, jcomp.CompressionPolicy(kind="qsgd-int8")))
    js.CommitDelta(ja.handle.app_id, jn[1], d)
    ts.CommitDelta(ta.handle.app_id, tn[0], tcomp.quantize_delta(td, tcomp.CompressionPolicy(kind="qsgd-int8")))
    ts.CommitDelta(ta.handle.app_id, tn[1], td)
    for s, a in ((js, ja), (ts, ta)):
        with pytest.raises(ValueError, match="mixed quantized and raw"):
            s.ApplyBuffered(a.handle.app_id)
        assert s.apps[a.handle.app_id].buffer == []


def test_quickstart_shaped_rounds_match_jax():
    """Five rounds of the test_fl.py setup: identical control plane, loss
    and parameter trajectory fp-tight, and the same accuracy bar."""
    (js, ja, _), (ts, ta, _), (x, y) = _pair(seed=0)
    accs = []
    for _ in range(5):
        mj = jrounds.run_round(js, ja)
        mt = trounds.run_round(ts, ta)
        assert _levels(mj) == _levels(mt)
        assert (mj["time_ms"], mj["traffic_bytes"], mj["round"]) == (mt["time_ms"], mt["traffic_bytes"], mt["round"])
        np.testing.assert_allclose(mt["loss"], mj["loss"], **TRAIN)
        got = params_to_numpy(ta.params)
        for k, v in jax.tree.map(np.asarray, ja.params).items():
            assert got[k].dtype == np.float32
            np.testing.assert_allclose(got[k], v, **TRAIN)
        accs.append(trounds.evaluate(ta, x[:300], y[:300]))
    assert accs[-1] > 0.8, accs
    assert abs(accs[-1] - jrounds.evaluate(ja, x[:300], y[:300])) < 1e-6


def test_reference_loop_round_and_fused_round_match_jax():
    (js, ja, _), (ts, ta, _), _ = _pair(seed=3)
    mj = jrounds.run_round(js, ja, vectorized=False, use_kernel=False)
    mt = trounds.run_round(ts, ta, vectorized=False, use_kernel=False)
    np.testing.assert_allclose(mt["loss"], mj["loss"], **TRAIN)
    fj = jrounds.run_round_fused(js, [ja])
    ft = trounds.run_round_fused(ts, [ta])
    np.testing.assert_allclose(ft[0]["loss"], fj[0]["loss"], **TRAIN)
    assert _levels(fj[0]) == _levels(ft[0])
    got = params_to_numpy(ta.params)
    for k, v in jax.tree.map(np.asarray, ja.params).items():
        np.testing.assert_allclose(got[k], v, **TRAIN)


def test_seeded_init_trains_and_baseline_matches():
    ts, ta, _, (x, y) = _build(TSystem, trounds, seed=0, device="cpu")
    first = trounds.run_round(ts, ta)["loss"]
    for _ in range(3):
        last = trounds.run_round(ts, ta)["loss"]
    assert last < first
    js, ja, _, _ = _build(JSystem, jrounds, seed=0)
    assert trounds.CentralizedBaseline().round_time_ms([ta], 5.0, 1e6) == \
        jrounds.CentralizedBaseline().round_time_ms([ja], 5.0, 1e6)
