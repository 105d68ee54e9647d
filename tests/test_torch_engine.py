"""The port's round engine against ``repro.fl.engine`` (CPU).

The same shards (numpy, from a seed) and the same start parameters (the
JAX package's init, carried over by ``convert``) go through both
engines.  ``pack_shards`` must agree exactly; trained deltas and losses
agree to rtol 1e-4, atol 1e-5 (XLA and PyTorch reduce matmuls in other
orders), and the port's batched path agrees with its own per-worker loop
to the JAX package's tolerance for that pair (tests/test_engine.py).
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
