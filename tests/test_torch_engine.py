"""The port's round engine against ``repro.fl.engine`` (CPU).

The same shards (numpy, from a seed) and the same start parameters (the
JAX package's init, carried over by ``convert``) go through both
engines.  ``pack_shards`` must agree exactly; trained deltas and losses
agree to rtol 1e-4, atol 1e-5 (XLA and PyTorch reduce matmuls in other
orders), and the port's batched path agrees with its own per-worker loop
to the JAX package's tolerance for that pair (tests/test_engine.py).
Every local SGD step is one ``fused_update_leaves`` call over all the
leaves (the FedProx client update, one launch per dtype on the card); the
reported loss keeps the proximal term, as the reference's.
"""
import jax
import numpy as np
import pytest

from repro import data as jdata
from repro.core.api import TotoroSystem as JSystem
from repro.fl import engine as jeng
from repro.fl import rounds as jrounds
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.api import TotoroSystem as TSystem
from repro_torch.fl import engine as teng
from repro_torch.fl import rounds as trounds
from repro_torch.kernels import ops as tops

TOL = dict(rtol=1e-4, atol=1e-5)
LOOP_TOL = dict(rtol=5e-4, atol=5e-6)


def _shards(workers, *, one_sample, model, seed=0):
    dim = 16 if model == "mlp" else 256
    x, y = jdata.synthetic_classification(workers * 40, dim, 4, seed=seed)
    if model == "cnn":
        x = x.reshape(-1, 16, 16, 1)
    parts = jdata.dirichlet_partition(y, workers, alpha=0.5, seed=seed + 1)
    if one_sample:
        parts[0] = parts[0][:1]
    return {100 + i: (x[p], y[p]) for i, p in enumerate(parts)}


def _system(cls):
    sys_ = cls(zone_bits=2, suffix_bits=20, seed=0)
    rng = np.random.default_rng(0)
    for i in range(20):
        sys_.Join("n", i, site=i % 4, coord=rng.uniform(0, 50, 2))
    return sys_


def _apps(model="mlp", workers=5, one_sample=True, mu=0.0, seed=0):
    """A JAX app and a port app with the same shards and start params."""
    shards = _shards(workers, one_sample=one_sample, model=model, seed=seed)
    ws = sorted(shards)
    kw = dict(workers=[], data_by_worker=shards, model=model, dim=16, num_classes=4,
              local_steps=3, lr=0.2, mu=mu, seed=seed)
    japp = jrounds.make_app(_system(JSystem), "e", **kw)
    p0 = jax.tree.map(np.asarray, japp.params)
    tapp = trounds.make_app(_system(TSystem), "e", params=p0, device="cpu", **kw)
    return japp, tapp, ws


def test_pack_shards_array_equal():
    shards = _shards(6, one_sample=True, model="mlp")
    ws = sorted(shards)[::-1]
    jx, jy, jm = jeng.pack_shards(shards, ws)
    tx, ty, tm = teng.pack_shards(shards, ws)
    for a, b in ((jx, tx), (jy, ty), (jm, tm)):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    empty = teng.pack_shards(shards, [])
    assert all(t.shape == (0, 0) for t in empty)


@pytest.mark.parametrize("model", ["mlp", "cnn"])
@pytest.mark.parametrize("mu", [0.0, 0.05])
def test_local_training_matches_jax(model, mu):
    japp, tapp, ws = _apps(model=model, mu=mu)
    dj, wj, lj = jeng.local_training(japp, ws, vectorized=True)
    dt, wt, lt = teng.local_training(tapp, ws, vectorized=True)
    assert wj == wt
    np.testing.assert_allclose(lt, lj, **TOL)
    for a, b in zip(dj, dt):
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), **TOL)


@pytest.mark.parametrize("model", ["mlp", "cnn"])
def test_megabatched_matches_jax(model):
    """Per-worker start params: each row trains from its own model."""
    japp, tapp, ws = _apps(model=model, workers=4)
    W = len(ws)
    rng = np.random.default_rng(1)
    p0 = jax.tree.map(np.asarray, japp.params)
    stack = {k: np.stack([v * (1.0 + 0.1 * i) for i in range(W)]).astype(np.float32)
             for k, v in p0.items()}
    stack = {k: v + 0.01 * rng.standard_normal(v.shape).astype(np.float32) for k, v in stack.items()}
    x, y, m = jeng.pack_shards(japp.data, ws)
    jnew, jl = jeng.megabatched_local_train(
        stack, x, y, m, logits_fn=jeng.sm.LOGITS[model], steps=3, lr=0.2, mu=0.05
    )
    tx, ty, tm = teng.pack_shards(tapp.data, ws)
    tnew, tl = teng.megabatched_local_train(
        params_from_numpy(stack, "cpu"), tx, ty, tm,
        logits_fn=teng.sm.LOGITS_STACKED[model], steps=3, lr=0.2, mu=0.05,
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k, v in params_to_numpy(tnew).items():
        np.testing.assert_allclose(v, np.asarray(jnew[k]), **TOL)


@pytest.mark.parametrize("model", ["mlp", "cnn"])
@pytest.mark.parametrize("mu", [0.0, 0.1])
def test_vectorized_matches_own_per_worker_loop(model, mu):
    _, tapp, ws = _apps(model=model, mu=mu, seed=3)
    dv, wv, lv = teng.local_training(tapp, ws, vectorized=True)
    dr, wr, lr = teng.local_training(tapp, ws, vectorized=False)
    assert wv == wr
    np.testing.assert_allclose(lv, lr, rtol=1e-4, atol=1e-6)
    for a, b in zip(dv, dr):
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), **LOOP_TOL)


def test_fused_local_training_matches_per_app():
    """Two same-config apps and one of another config: one megabatch for
    the pair, and every job's results equal its own local_training."""
    _, a1, ws1 = _apps(workers=3, seed=0)
    _, a2, ws2 = _apps(workers=4, seed=1)
    _, a3, ws3 = _apps(workers=2, seed=2, mu=0.1)
    teng.DISPATCH.reset()
    fused = teng.fused_local_training([(a1, ws1, None), (a2, ws2, a2.params), (a3, ws3, None), (a1, [], None)])
    assert teng.DISPATCH.dispatches == 2
    assert fused[3] == ([], [], [])
    for (app, ws), (d, w, l) in zip([(a1, ws1), (a2, ws2), (a3, ws3)], fused):
        d0, w0, l0 = teng.local_training(app, ws)
        assert w == w0
        np.testing.assert_allclose(l, l0, rtol=1e-5, atol=1e-6)
        for a, b in zip(d, d0):
            for k in a:
                np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-5, atol=1e-6)


def test_dispatch_stats_count_distinct_keys():
    st = teng.DispatchStats()
    for key in ["a", "b", "a", "a"]:
        st.record(key)
    assert (st.dispatches, st.compiles) == (4, 2)
    st.reset()
    assert (st.dispatches, st.compiles) == (0, 0)


def _round_pair(mu):
    """The quickstart's shape at test size: 60-node overlay, 6 workers."""
    out = []
    p0 = None
    for S, R in ((JSystem, jrounds), (TSystem, trounds)):
        sys_ = S(zone_bits=2, suffix_bits=20, seed=0)
        rng = np.random.default_rng(0)
        nodes = [sys_.Join("n", i, site=i % 4, coord=rng.uniform(0, 50, 2)) for i in range(60)]
        x, y = jdata.synthetic_classification(600, 16, 4, seed=0)
        parts = jdata.dirichlet_partition(y, 6, alpha=0.5, seed=1)
        ws = [int(w) for w in rng.choice(nodes, size=6, replace=False)]
        extra = {} if p0 is None else dict(params=p0, device="cpu")
        app = R.make_app(sys_, "prox", workers=ws,
                         data_by_worker={w: (x[parts[i]], y[parts[i]]) for i, w in enumerate(ws)},
                         dim=16, num_classes=4, local_steps=4, lr=0.2, mu=mu, **extra)
        p0 = jax.tree.map(np.asarray, app.params)
        out.append((sys_, app))
    return out


@pytest.mark.parametrize("mu", [0.0, 0.01])
def test_fedprox_rounds_match_jax(mu):
    """Three rounds through run_round: losses (proximal term included) and
    parameters fp-tight against the reference."""
    (js, ja), (ts, ta) = _round_pair(mu)
    for _ in range(3):
        lj = jrounds.run_round(js, ja)["loss"]
        lt = trounds.run_round(ts, ta)["loss"]
        np.testing.assert_allclose(lt, lj, **TOL)
    for k, v in params_to_numpy(ta.params).items():
        np.testing.assert_allclose(v, np.asarray(ja.params[k]), **TOL)


def test_every_local_step_is_one_fused_update_per_leaf(monkeypatch):
    """Each local step is one ``fused_update_leaves`` call that updates
    every leaf once (one kernel launch per dtype on the card), with the
    app's lr and mu and no weight decay, in place: steps calls of leaves
    leaves per training dispatch."""
    calls = []
    orig = tops.fused_update_leaves

    def counting(ws, gs, w0s, **kw):
        calls.append((len(ws), len(gs), len(w0s), kw))
        return orig(ws, gs, w0s, **kw)

    monkeypatch.setattr(tops, "fused_update_leaves", counting)
    _, tapp, ws = _apps(model="cnn", mu=0.05, workers=4)
    teng.local_training(tapp, ws, vectorized=True)
    leaves = len(tapp.params)
    assert calls == [(leaves, leaves, leaves, dict(lr=tapp.lr, mu=0.05, donate=True))] * tapp.local_steps
    calls.clear()
    teng.local_training(tapp, ws[:2], vectorized=False)
    assert len(calls) == 2 * tapp.local_steps and all(c[0] == leaves for c in calls)


@pytest.mark.parametrize("model", ["mlp", "cnn"])
def test_small_models_and_async_steps_are_one_fused_call_each(monkeypatch, model):
    """``small_models.local_train`` and the async path's
    ``fused_local_training`` (two jobs of one app, megabatched) make one
    ``fused_update_leaves`` call per local step, over every leaf."""
    from repro_torch.fl import small_models as tsm

    calls = []
    orig = tops.fused_update_leaves

    def counting(ws, gs, w0s, **kw):
        calls.append(len(ws))
        return orig(ws, gs, w0s, **kw)

    monkeypatch.setattr(tops, "fused_update_leaves", counting)
    _, tapp, ws = _apps(model=model, mu=0.01, workers=4)
    leaves = len(tapp.params)
    x, y = (params_from_numpy(a, "cpu") for a in tapp.data[ws[1]])
    tsm.local_train(tapp.params, tapp.params, x.float(), y, logits_fn=tsm.LOGITS[model],
                    steps=5, lr=0.1, mu=0.01)
    assert calls == [leaves] * 5
    calls.clear()
    teng.fused_local_training([(tapp, ws[:2], None), (tapp, ws[2:], tapp.params)])
    assert calls == [leaves] * tapp.local_steps


def test_reported_loss_keeps_the_proximal_term():
    """With the anchor away from the start params the proximal term is
    large; the loss reported is cross-entropy plus 0.5 mu ||w - w0||^2,
    taken before each step, as ``repro.fl.small_models.local_train``."""
    from repro.fl import small_models as jsm
    from repro_torch.fl import small_models as tsm

    japp, tapp, ws = _apps(model="mlp", workers=2)
    x, y = tapp.data[ws[1]]
    p0 = jax.tree.map(np.asarray, japp.params)
    far = {k: (v + 0.3).astype(np.float32) for k, v in p0.items()}
    jp, jl = jsm.local_train(p0, far, x, y, logits_fn=jsm.mlp_logits, steps=3, lr=0.1, mu=0.5)
    tp, tl = tsm.local_train(params_from_numpy(p0, "cpu"), params_from_numpy(far, "cpu"),
                             params_from_numpy(x, "cpu"), params_from_numpy(y, "cpu"),
                             logits_fn=tsm.mlp_logits, steps=3, lr=0.1, mu=0.5)
    assert float(jl) > 1.0  # the proximal term dominates
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    for k, v in params_to_numpy(tp).items():
        np.testing.assert_allclose(v, np.asarray(jp[k]), **TOL)
