"""The port's path planner, congestion game and live placement against the
JAX package (CPU).

- ``algorithm1_episode`` (through the ``policy_update`` plain version) is
  held to the reference within atol 1e-5, the reference's own kernel
  tolerance (tests/test_kernels.py), on candidate sets without ties, with
  partial masks and zero-reward rows; the Appendix-E example is exact.
- Ties in line 5 are rounding artifacts in the reference (XLA's reduction
  order).  The port sums exactly in f64: on ``candidate_policy_set`` its
  rho is the first minimiser of the exact determinant, and the
  reference's rho lies in the same tie set.
- ``latency_ms`` / ``rewards`` equal the reference's on injected draws.
- Planner trajectories: the reference's per-episode actions, link-success
  uniforms and ``policy_values`` draws are injected into the port by
  replacing ``pathplan.categorical`` / ``pathplan.uniforms``; each
  episode's policy agrees within atol 1e-5 and the series within 1e-5.
- ``tree_path_costs`` equals its scalar oracle and the reference float for
  float; scheduler traces and replan logs under a ``PlacementEngine``
  equal ``repro.core.sim``'s at M = 2.

Small sizes: N <= 64 nodes, K <= 16 hops, <= 10 episodes.
"""
from dataclasses import astuple
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import congestion as jcg
from repro.core import multicast as jmc
from repro.core import pathplan as jpp
from repro.core import sim as jsim
from repro.core.api import TotoroSystem as JSystem
from repro.core.forest import Forest as JForest
from repro.core.nodeid import IdSpace as JIdSpace
from repro.core.overlay import MultiRingOverlay as JOverlay
from repro.fl import async_engine as jae
from repro_torch.convert import planner_state_from_numpy
from repro_torch.core import congestion as tcg
from repro_torch.core import multicast as tmc
from repro_torch.core import pathplan as tpp
from repro_torch.core import sim as tsim
from repro_torch.core.api import TotoroSystem as TSystem
from repro_torch.core.forest import Forest as TForest
from repro_torch.core.nodeid import IdSpace as TIdSpace
from repro_torch.core.overlay import MultiRingOverlay as TOverlay
from repro_torch.fl import async_engine as tae

ATOL = 1e-5


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _no_tie_cand(M, K, seed):
    """M distinct Dirichlet candidates over K hops: no two tie in line 5
    or line 7 (unlike candidate_policy_set's permuted corners)."""
    c = np.random.default_rng(seed).dirichlet(np.ones(K), M) * 0.9 + 0.1 / K
    return (c / c.sum(-1, keepdims=True)).astype(np.float32)


def _episode_inputs(N, K, tau, seed, *, partial_mask=True):
    rng = np.random.default_rng(seed)
    mask = rng.random((N, K)) < (0.6 if partial_mask else 2.0)
    mask[:, rng.integers(0, K)] = True
    pi = rng.dirichlet(np.ones(K), N) * mask
    pi = (pi / pi.sum(-1, keepdims=True)).astype(np.float32)
    # actions drawn on each node's valid hops; rows 0 and 1 earn nothing
    actions = np.stack([rng.choice(np.flatnonzero(m), tau) for m in mask])
    rewards = rng.uniform(0, 1, (N, tau)).astype(np.float32)
    rewards[:2] = 0.0
    return pi, mask, actions, rewards


# -- Algorithm 1, one episode -------------------------------------------------------------


@pytest.mark.parametrize("N,K,tau,alpha,beta", [(64, 8, 16, 0.98, 0.5), (33, 16, 8, 0.9, 0.5),
                                                (17, 3, 4, 0.6, 0.3), (5, 12, 1, 0.5, 0.95)])
def test_algorithm1_episode_matches_jax(N, K, tau, alpha, beta):
    pi, mask, actions, rewards = _episode_inputs(N, K, tau, seed=N * K)
    cand = _no_tie_cand(K + 9, K, seed=K)
    want = jpp.algorithm1_episode(jnp.asarray(pi), jnp.asarray(mask), jnp.asarray(cand),
                                  jnp.asarray(actions), jnp.asarray(rewards),
                                  tau=tau, alpha=alpha, beta=beta)
    got = tpp.algorithm1_episode(_t(pi), _t(mask), _t(cand), _t(actions), _t(rewards),
                                 tau=tau, alpha=alpha, beta=beta)
    assert got.dtype == torch.float32 and got.shape == (N, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert bool((got[~_t(mask)] == 0).all())  # masked hops get no mass
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)


def test_appendix_e_example():
    """pi=[0.5,0.5], tau=2, rewards (m1: 0.4, m2: 0.8), Delta = {[.6,.4],
    [.5,.5],[.3,.7],[.1,.9]}, alpha = beta = 0.5 -> [0.2, 0.8]."""
    cand = np.array([[0.6, 0.4], [0.5, 0.5], [0.3, 0.7], [0.1, 0.9]], np.float32)
    args = (np.array([[0.5, 0.5]], np.float32), np.ones((1, 2), bool), cand,
            np.array([[0, 1]]), np.array([[0.4, 0.8]], np.float32))
    got = tpp.algorithm1_episode(*map(_t, args), tau=2, alpha=0.5, beta=0.5)
    want = jpp.algorithm1_episode(*map(jnp.asarray, args), tau=2, alpha=0.5, beta=0.5)
    np.testing.assert_allclose(got.numpy()[0], [0.2, 0.8], atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)


def _rho_index(out_row, cand):
    """The candidate that alpha = 0 returns (the exploratory policy)."""
    cn = cand / cand.sum(-1, keepdims=True)
    return int(np.abs(cn - out_row[None]).sum(-1).argmin())


@pytest.mark.parametrize("K", [4, 8, 16])
def test_tie_rule_on_candidate_policy_set(K):
    """candidate_policy_set's corners are permutations of one another: in
    exact arithmetic they tie in line 5.  The port's rho is the first exact
    minimiser; the reference's (an artifact of XLA's f32 sums) is one of
    the tied set."""
    cand = tpp.candidate_policy_set(K, seed=0)
    c = cand.numpy()
    np.testing.assert_array_equal(c, np.asarray(jpp.candidate_policy_set(K, seed=0)))
    dets = []
    for row in c:
        fr = [Fraction(float(v)) for v in row]
        s = sum(fr)
        det = Fraction(1)
        for v in fr:
            det *= v / s
        dets.append(det)
    ties = [m for m, d in enumerate(dets) if d == min(dets)]
    assert len(ties) == K  # the K corners
    args = (np.full((3, K), 1.0 / K, np.float32), np.ones((3, K), bool), c,
            np.zeros((3, 2), np.int64), np.zeros((3, 2), np.float32))
    got = tpp.algorithm1_episode(*map(_t, args), tau=2, alpha=0.0, beta=0.5).numpy()
    want = np.asarray(jpp.algorithm1_episode(*map(jnp.asarray, args), tau=2, alpha=0.0, beta=0.5))
    assert {_rho_index(r, c) for r in got} == {ties[0]}
    assert {_rho_index(r, c) for r in want} <= set(ties)


def test_zero_reward_rows_pick_the_uniform_candidate():
    """All-zero rewards give all-zero scores: line 7 takes index 0."""
    K, N = 6, 4
    cand = _no_tie_cand(10, K, seed=3)
    cand[0] = 1.0 / K
    args = (np.full((N, K), 1.0 / K, np.float32), np.ones((N, K), bool), cand,
            np.zeros((N, 3), np.int64), np.zeros((N, 3), np.float32))
    # alpha = 1, beta = 1: pi' = pi~
    got = tpp.algorithm1_episode(*map(_t, args), tau=3, alpha=1.0, beta=1.0).numpy()
    want = np.asarray(jpp.algorithm1_episode(*map(jnp.asarray, args), tau=3, alpha=1.0, beta=1.0))
    np.testing.assert_allclose(got, 1.0 / K, atol=1e-7)
    np.testing.assert_allclose(got, want, atol=1e-7)


# -- the congestion game on injected draws -------------------------------------------------


def _envs(P=8, seed=7, packet_mbit=2.0):
    j = jcg.make_env(P, seed=seed, bw_range=(20.0, 100.0))
    t = tcg.make_env(P, seed=seed, bw_range=(20.0, 100.0))
    return (jcg.CongestionEnv(capacity=j.capacity, theta=j.theta, packet_mbit=packet_mbit),
            tcg.CongestionEnv(capacity=t.capacity, theta=t.theta, packet_mbit=packet_mbit))


@pytest.mark.parametrize("N,P", [(64, 8), (7, 3)])
def test_latency_and_rewards_equal_reference_on_injected_draws(N, P):
    jenv, tenv = _envs(P)
    np.testing.assert_array_equal(tenv.capacity, np.asarray(jenv.capacity))
    rng = np.random.default_rng(N)
    a = rng.integers(0, P, N)
    a[: N // 2] = 0  # a congested hop
    key = jax.random.key(N)
    u = np.asarray(jax.random.uniform(key, (N,), jnp.float32))  # bernoulli's draw
    np.testing.assert_array_equal(tenv.latency_ms(_t(a)).numpy(),
                                  np.asarray(jenv.latency_ms(jnp.asarray(a))))
    np.testing.assert_array_equal(tenv.rewards(_t(a), _t(u)).numpy(),
                                  np.asarray(jenv.rewards(jnp.asarray(a), key)))


class _Inject:
    """Replaces the port's two draw functions with queues of the
    reference's draws, taken in the order the port asks for them."""

    def __init__(self, monkeypatch, draws):
        self.draws = list(draws)
        monkeypatch.setattr(tpp, "categorical", self._next("categorical"))
        monkeypatch.setattr(tpp, "uniforms", self._next("uniforms"))

    def _next(self, kind):
        def fn(*args, **kw):
            got_kind, value = self.draws.pop(0)
            assert got_kind == kind, (got_kind, kind)
            return torch.tensor(value)

        return fn


def _reference_run(planner, env, episodes, *, seed=1, eval_samples=64):
    """``repro.core.pathplan.run_planner`` step by step, recording every draw
    (in the port's call order) and the policy after each update."""
    key = jax.random.key(seed)
    draws, pis = [], []
    for _ in range(episodes):
        key, k1, k2, k3 = jax.random.split(key, 4)
        actions = planner.sample_actions(k1)
        if not isinstance(planner, jpp.OptPlanner):
            draws.append(("categorical", np.asarray(actions)))
        u = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(k2, t), (actions.shape[0],)))
                      for t in range(actions.shape[1])], 1)
        draws.append(("uniforms", u))
        rewards = jnp.stack([env.rewards(actions[:, t], jax.random.fold_in(k2, t))
                             for t in range(actions.shape[1])], 1)
        planner.update(actions, rewards)
        pis.append(np.asarray(planner.pi))
        logits = jnp.log(jnp.maximum(planner.pi, 1e-12))
        joint = [jax.random.categorical(k, logits) for k in jax.random.split(k3, eval_samples)]
        draws.append(("categorical", np.stack([np.asarray(a) for a in joint], 1)))
    if not isinstance(planner, jpp.OptPlanner):
        draws.append(("categorical", np.asarray(planner.sample_actions(jax.random.key(99)))))
    return draws, pis


def _planners(kind, N, K, jenv, tenv):
    if kind == "totoro":
        cand = _no_tie_cand(K + 9, K, seed=11)
        j = jpp.GameTheoreticPlanner(N, K, tau=8, alpha=0.9, beta=0.5, seed=0)
        j.cand = jnp.asarray(cand)
        t = tpp.GameTheoreticPlanner(N, K, tau=8, alpha=0.9, beta=0.5, seed=0, device="cpu")
        planner_state_from_numpy(t, cand=cand)
        return j, t
    if kind == "bandit":
        return jpp.BanditPlanner(N, K, tau=8), tpp.BanditPlanner(N, K, tau=8, device="cpu")
    return jpp.OptPlanner(jenv, N, tau=8), tpp.OptPlanner(tenv, N, tau=8, device="cpu")


@pytest.mark.parametrize("kind", ["totoro", "bandit", "opt"])
def test_planner_trajectories_match_reference(monkeypatch, kind):
    N, K, episodes = 48, 6, 8
    jenv, tenv = _envs(K, seed=3, packet_mbit=8.0)
    jp, tp = _planners(kind, N, K, jenv, tenv)
    want = jpp.run_planner(_planners(kind, N, K, jenv, tenv)[0], jenv, episodes)
    draws, pis = _reference_run(jp, jenv, episodes)
    got_pis = []
    update = tp.update

    def recording_update(actions, rewards):
        update(actions, rewards)
        got_pis.append(tp.pi.numpy().copy())

    monkeypatch.setattr(tp, "update", recording_update)
    inject = _Inject(monkeypatch, draws)
    got = tpp.run_planner(tp, tenv, episodes)
    assert inject.draws == []  # every reference draw was used, in order
    for g, w in zip(got_pis, pis):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    for name in ("nash_regret", "mean_reward"):
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got["cum_latency_ms"], want["cum_latency_ms"], rtol=1e-6)
    np.testing.assert_allclose(got["selection_freq"], want["selection_freq"], atol=1e-7)


def test_policy_values_match_reference_on_injected_draws(monkeypatch):
    N, K, S = 40, 6, 16
    jenv, tenv = _envs(K, seed=5)
    pi = np.random.default_rng(0).dirichlet(np.ones(K), N).astype(np.float32)
    key = jax.random.key(4)
    logits = jnp.log(jnp.maximum(jnp.asarray(pi), 1e-12))
    joint = np.stack([np.asarray(jax.random.categorical(k, logits))
                      for k in jax.random.split(key, S)], 1)
    _Inject(monkeypatch, [("categorical", joint)])
    monkeypatch.setattr(tpp, "CHUNK_ELEMS", N * K * 5)  # 4 chunks of samples
    v, br = tpp.policy_values(tenv, _t(pi), None, S)
    jv, jbr = jpp.policy_values(jenv, jnp.asarray(pi), key, S)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    np.testing.assert_allclose(br.numpy(), np.asarray(jbr), rtol=0, atol=1e-6)


def test_multicast_trajectory_matches_reference():
    N, P, episodes = 24, 5, 6
    jenv, tenv = _envs(P, seed=2, packet_mbit=8.0)
    jp = jmc.MulticastPlanner(num_nodes=N, num_paths=P, max_subset=2, tau=8, seed=0)
    tp = tmc.MulticastPlanner(num_nodes=N, num_paths=P, max_subset=2, tau=8, seed=0, device="cpu")
    np.testing.assert_array_equal(tp.subsets.numpy(), np.asarray(jp.subsets))
    M = tp.subsets.shape[0]
    cand = _no_tie_cand(M + 9, M, seed=8)
    jp.cand = jnp.asarray(cand)
    planner_state_from_numpy(tp, cand=cand)
    key = jax.random.key(0)
    for _ in range(episodes):
        key, k1, k2 = jax.random.split(key, 3)
        actions = jp.sample_actions(k1)
        rewards = jp.rewards(jenv, actions, k2)
        u = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(k2, t), (N, P)))
                      for t in range(actions.shape[1])])
        got_r = tp.rewards(tenv, _t(actions), _t(u))
        np.testing.assert_array_equal(got_r.numpy(), np.asarray(rewards))
        jp.update(actions, rewards)
        tp.update(_t(actions), got_r)
        np.testing.assert_allclose(tp.pi.numpy(), np.asarray(jp.pi), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tp.subset_usage(), jp.subset_usage(), atol=ATOL)


def test_planners_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    jenv, tenv = _envs(4)
    for make in (lambda: tpp.GameTheoreticPlanner(4, 4), lambda: tpp.BanditPlanner(4, 4),
                 lambda: tpp.OptPlanner(tenv, 4), lambda: tmc.MulticastPlanner(4, 4)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()


def test_sampling_is_an_inverse_cdf_of_the_policy():
    """The port's own draws (not the reference's): frequencies follow pi,
    masked hops are never drawn, and one seed gives one sequence."""
    pi = torch.tensor([[0.5, 0.25, 0.25, 0.0], [0.0, 0.0, 1.0, 0.0]])
    a = tpp.categorical(pi, 20000, torch.Generator().manual_seed(0))
    assert a.shape == (2, 20000) and a.dtype == torch.int64
    freq = torch.stack([torch.bincount(r, minlength=4) for r in a]).double() / 20000
    np.testing.assert_allclose(freq.numpy(), pi.numpy(), atol=0.015)
    assert not bool((a == 3).any())
    again = tpp.categorical(pi, 20000, torch.Generator().manual_seed(0))
    assert torch.equal(a, again)


# -- live placement --------------------------------------------------------------------------


def _forest(Overlay, IdSpace, Forest, n=600, seed=0, subs=200):
    space = IdSpace(zone_bits=3, suffix_bits=24)
    ov = Overlay(space, base_bits=4, seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(n):
        ov.join_random(int(rng.integers(0, 8)), coord=rng.uniform(0, 100, 2))
    f = Forest(ov)
    tree = f.create_tree("plc-app")
    f.subscribe_many(tree.app_id, rng.choice(ov.nodes(), size=subs, replace=False))
    return tree, rng


@pytest.mark.parametrize("seed", [0, 3])
def test_tree_path_costs_equal_oracle_and_reference(seed):
    out = []
    for mod, parts in ((jpp, (JOverlay, JIdSpace, JForest)), (tpp, (TOverlay, TIdSpace, TForest))):
        tree, rng = _forest(*parts, seed=seed)
        rows = rng.integers(0, 50, tree._n)
        cap = rng.uniform(20, 100, 50)
        occ = rng.integers(0, 5, 50).astype(np.float64)
        kw = dict(base_ms=5.0, down_mbit=0.8, up_mbit=0.4)
        full = mod.tree_path_costs(tree, rows, cap, occ, **kw)
        nodes = sorted(tree.members)
        up, down = mod.tree_path_costs_scalar(tree, rows, cap, occ, nodes=nodes, **kw)
        slots = [tree._slot[w] for w in nodes]
        np.testing.assert_array_equal(full[0][slots], up)  # float for float
        np.testing.assert_array_equal(full[1][slots], down)
        out.append(full)
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def _placement_run(S, SIM, AE, engine):
    sys_ = S(zone_bits=2, suffix_bits=22, seed=0)
    rng = np.random.default_rng(0)
    nodes = [sys_.Join("n", i, site=i % 4, coord=rng.uniform(0, 50, 2),
                       bandwidth=float(rng.uniform(20, 100))) for i in range(160)]
    handles = []
    for a in range(2):
        h = sys_.CreateTree(f"plc-{a}")
        for w in rng.choice(nodes, size=6, replace=False):
            sys_.Subscribe(h.app_id, int(w))
        handles.append(h)
    sched = SIM.AsyncBufferScheduler(
        sys_, handles, model_bytes=2e5, compute_ms=AE.worker_compute_fn(30.0, 4.0, seed=0),
        buffer_k=3, placement=engine,
        churn=SIM.ChurnModel(period_ms=180.0, downtime_ms=360.0, group_size=2, seed=1),
    )
    events = sched.run(3, max_events=200_000)
    return ([astuple(e) for e in events], [astuple(c) for c in sched.churn_log],
            sched.fairness_log, [astuple(r) for r in sched.replan_log], sched.control_bytes,
            (sched.placement.replans, sched.placement.moves_applied))


@pytest.mark.parametrize("engine", [dict(), dict(cooldown_ms=5000.0, max_moves=2)])
def test_scheduler_with_placement_engine_identical_to_reference(engine):
    j = _placement_run(JSystem, jsim, jae, jpp.PlacementEngine(**engine))
    t = _placement_run(TSystem, tsim, tae, tpp.PlacementEngine(**engine))
    assert j[3]  # replans happened
    assert t == j


def test_placement_knob_validated_like_reference():
    sys_ = TSystem(zone_bits=2, suffix_bits=20, seed=0)
    for i in range(8):
        sys_.Join("n", i, site=i % 4)
    h = sys_.CreateTree("v")
    with pytest.raises(TypeError, match="PlacementEngine"):
        tsim.AsyncBufferScheduler(sys_, [h], model_bytes=1e5, placement=object())
    sched = tsim.AsyncBufferScheduler(sys_, [h], model_bytes=1e5, placement=True)
    assert isinstance(sched.placement, tpp.PlacementEngine)
