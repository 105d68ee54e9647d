"""Game-theoretic path planning — Algorithm 1 (paper §V-B), on tensors.

Answers to ``repro/core/pathplan.py``.  Per episode, every node: (line 3)
samples tau next hops from its policy and observes bandit rewards;
(line 5) picks the exploratory policy rho = argmin_det M(lambda) over
its candidate policy set Delta(P_n); (line 6) estimates the potential
gradient by importance-weighted linear regression — with one-hot psi
this is sum_t 1[p_t=p] r_t / pi(p); (line 7) takes the candidate
maximizing <lambda, grad>; (line 8) Frank–Wolfe mixes with exploration:
pi' = alpha[pi + beta(pi~ - pi)] + (1-alpha) rho.

``algorithm1_episode`` forms each node's per-hop reward sums and runs
lines 5-8 for all nodes in one launch of the ``policy_update`` kernel
(the reference's ``vmap`` + ``jit``).  Ties in line 5 follow the
kernel's rule: exact f64 sums rounded to f32, first index
(``kernels/ref.py``).

Randomness: the reference draws with ``jax.random`` (categorical,
bernoulli, split, fold_in), which PyTorch cannot reproduce.  The port
draws uniforms from a CPU ``torch.Generator`` (``uniforms``) and moves
them to the device; ``categorical`` samples by inverse CDF on the
device.  A run on the card and one on the CPU therefore see the same
draws, and tests inject the reference's actions and link-success draws
by replacing these two functions.

Baselines (paper §VII-E): the EuroSys'24 Totoro bandit planner (UCB on
per-hop delay, congestion-blind) and OPT (knows capacities; greedy
balanced assignment).  ``nash_regret_step`` evaluates a joint policy
per Definition 2.  Planners live on the CUDA card unless the caller
passes ``device="cpu"``.

Live placement (``PlacementEngine``, ``tree_path_costs`` and the scalar
oracle) is numpy and copied verbatim: the same congestion game played
against the event core's measured state instead of bandit samples.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .congestion import CongestionEnv
from ..fl.rounds import resolve_device
from ..kernels import ops as kops

def candidate_policy_set(K: int, num_random: int = 8, *, seed: int = 0) -> torch.Tensor:
    """Delta(P_n): a finite candidate set over K hops — the uniform policy,
    per-hop skewed corners (0.9 mass), and a few Dirichlet samples.
    All entries strictly positive (Theorem 1's no-zero-element condition).
    Returns an (M, K) f32 tensor on the CPU, M = K + 1 + num_random."""
    rng = np.random.default_rng(seed)
    cands = [np.full(K, 1.0 / K)]
    for k in range(K):
        v = np.full(K, 0.1 / max(K - 1, 1))
        v[k] = 0.9
        cands.append(v)
    for _ in range(num_random):
        cands.append(rng.dirichlet(np.ones(K)) * 0.9 + 0.1 / K)
    M = np.stack(cands)
    return torch.tensor(M / M.sum(-1, keepdims=True), dtype=torch.float32)


# ---------------------------------------------------------------------------
# draws: the port's only sources of randomness (tests replace them)


def uniforms(gen: torch.Generator, shape, device, dtype=torch.float32) -> torch.Tensor:
    """Uniforms in [0, 1) from the CPU generator ``gen``, moved to ``device``."""
    return torch.rand(shape, generator=gen, dtype=dtype).to(device)


def categorical(pi: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    """(N, n) i.i.d. draws from each row of ``pi`` (weights
    ``max(pi, 1e-12)``, as the reference's ``categorical(log max(pi,
    1e-12))``), by inverse CDF on ``pi``'s device: a draw is the number of
    cumulative weights at or below its uniform."""
    cdf = torch.cumsum(torch.clamp_min(pi, 1e-12).double(), dim=1)
    cdf = (cdf / cdf[:, -1:]).contiguous()
    u = uniforms(gen, (pi.shape[0], n), pi.device, torch.float64)
    return torch.searchsorted(cdf, u, right=True).clamp_max_(pi.shape[1] - 1)


def algorithm1_episode(pi, mask, cand, actions, rewards, *, tau: int, alpha: float, beta: float):
    """One Algorithm-1 policy update, batched over nodes.

    pi: (N, K) current policies;  mask: (N, K) valid-hop mask;
    cand: (M, K) candidate policy set Delta(P_n) (shared, re-masked per node);
    actions: (N, tau) sampled hop indices;  rewards: (N, tau).
    Returns pi^{k+1}: (N, K) f32.
    """
    N, K = pi.shape
    rsum = torch.zeros((N, K), dtype=torch.float64, device=pi.device)
    rsum = rsum.scatter_add_(1, actions.long(), rewards.double()).float()  # exact: few terms
    return kops.policy_update(
        pi, mask.bool(), cand, rsum, tau=tau, alpha=alpha, beta=beta,
    )


@dataclass
class GameTheoreticPlanner:
    """Totoro+ planner (Algorithm 1)."""

    num_nodes: int
    num_paths: int
    tau: int = 8
    alpha: float = 0.9
    beta: float = 0.5
    mask: torch.Tensor | None = None  # (N, K) valid hops
    seed: int = 0
    device: str | torch.device | None = None  # None: the CUDA card

    def __post_init__(self):
        K = self.num_paths
        self.device = resolve_device(self.device)
        self.mask = (
            torch.ones((self.num_nodes, K), dtype=torch.bool, device=self.device)
            if self.mask is None else torch.as_tensor(self.mask, device=self.device).bool()
        )
        pi = self.mask.float()
        self.pi = pi / pi.sum(-1, keepdim=True)
        self.cand = candidate_policy_set(K, seed=self.seed).to(self.device)

    def sample_actions(self, gen: torch.Generator) -> torch.Tensor:
        """(N, tau) packets per node, i.i.d. from the current policies."""
        return categorical(self.pi, self.tau, gen)

    def update(self, actions, rewards) -> None:
        self.pi = algorithm1_episode(
            self.pi, self.mask, self.cand, actions, rewards,
            tau=self.tau, alpha=self.alpha, beta=self.beta,
        )


@dataclass
class BanditPlanner:
    """EuroSys'24 Totoro baseline: per-hop UCB on observed reward,
    congestion-blind (Appendix B's bandit model)."""

    num_nodes: int
    num_paths: int
    tau: int = 8
    explore_c: float = 0.5
    epsilon: float = 0.05
    device: str | torch.device | None = None  # None: the CUDA card

    def __post_init__(self):
        N, K = self.num_nodes, self.num_paths
        self.device = resolve_device(self.device)
        self.counts = torch.ones((N, K), dtype=torch.float32, device=self.device)
        self.means = torch.zeros((N, K), dtype=torch.float32, device=self.device)
        self.t = 1

    @property
    def pi(self) -> torch.Tensor:
        """Greedy-UCB induced (nearly deterministic) policy."""
        log_t = torch.tensor(np.log(np.float32(self.t + 1.0)), device=self.device)  # f32, on the host
        ucb = self.means + self.explore_c * torch.sqrt(log_t / self.counts)
        eye = torch.nn.functional.one_hot(torch.argmax(ucb, dim=1), self.num_paths).float()
        return (1 - self.epsilon) * eye + self.epsilon / self.num_paths

    def sample_actions(self, gen: torch.Generator) -> torch.Tensor:
        return categorical(self.pi, self.tau, gen)

    def update(self, actions, rewards) -> None:
        onehot = torch.nn.functional.one_hot(actions.long(), self.num_paths).float()
        cnt = onehot.sum(1)
        # tau rewards in [0, 1]: the f64 sum is exact, the same in any order
        s = (onehot * rewards[..., None].float()).double().sum(1).float()
        new_counts = self.counts + cnt
        self.means = (self.means * self.counts + s) / new_counts
        self.counts = new_counts
        self.t += self.tau


@dataclass
class OptPlanner:
    """OPT oracle: knows capacities/thetas; greedy balanced assignment
    maximizing marginal mean reward given current congestion."""

    env: CongestionEnv
    num_nodes: int
    tau: int = 8
    device: str | torch.device | None = None  # None: the CUDA card

    def __post_init__(self):
        self.device = resolve_device(self.device)
        P = self.env.num_paths
        counts = np.zeros(P, np.int64)
        assign = np.zeros(self.num_nodes, np.int64)
        for n in range(self.num_nodes):
            best, best_r = 0, -1.0
            for p in range(P):
                r = self.env.mean_reward(p, int(counts[p]) + 1)
                if r > best_r:
                    best, best_r = p, r
            assign[n] = best
            counts[best] += 1
        self.assign = torch.as_tensor(assign, device=self.device)

    @property
    def pi(self) -> torch.Tensor:
        return torch.nn.functional.one_hot(self.assign, self.env.num_paths).float()

    def sample_actions(self, gen: torch.Generator) -> torch.Tensor:
        return self.assign[:, None].expand(self.num_nodes, self.tau)

    def update(self, actions, rewards) -> None:
        pass


# ---------------------------------------------------------------------------
# evaluation: Nash regret + cumulative latency


def _hop_reward(env: CongestionEnv, users: torch.Tensor, device) -> torch.Tensor:
    """Mean reward of each hop (last axis, P wide) with ``users`` nodes on
    it: ``clip(1 - latency / l_max, 0, 1) * theta``."""
    cap, theta, bits, l_max = env.on(device)
    rate = cap / torch.clamp_min(users, 1.0)
    lat = env.base_ms + bits / torch.clamp_min(rate, 1e-6)
    return torch.clamp(1.0 - lat / l_max, 0.0, 1.0) * theta


CHUNK_ELEMS = 1 << 24  # policy_values' (samples, N, K) temporaries stay under this


def policy_values(env: CongestionEnv, pi: torch.Tensor, gen: torch.Generator, samples: int = 64):
    """Monte-Carlo V_n(pi) and best-response values V_n(a, pi_{-n}).

    Returns (values (N,), best_response (N,)) f32 from ``samples`` joint
    draws, taken as one batched computation, in chunks of samples that
    keep each (samples, N, K) temporary under ``CHUNK_ELEMS``; the sums
    over samples are f64, exact for these terms, so chunking changes
    nothing.
    """
    N, K = pi.shape
    dev = pi.device
    draws = categorical(pi, samples, gen).long().t()  # (S, N) joint actions
    v = torch.zeros(N, dtype=torch.float64, device=dev)
    v_dev = torch.zeros((N, K), dtype=torch.float64, device=dev)
    step = max(1, CHUNK_ELEMS // max(1, N * K))
    for s0 in range(0, samples, step):
        a = draws[s0 : s0 + step]  # (S', N)
        onehot = torch.nn.functional.one_hot(a, K)  # (S', N, K)
        counts = onehot.sum(1).float()  # (S', K) users per hop
        r_all = _hop_reward(env, counts, dev)  # every hop at its load
        v += r_all.gather(1, a).double().sum(0)  # on-policy reward per node
        # node n switches to pure action p (others fixed): p's load is
        # counts[p] if n already uses p, counts[p] + 1 otherwise
        r_join = _hop_reward(env, counts + 1.0, dev)
        v_dev += torch.where(onehot.bool(), r_all[:, None, :], r_join[:, None, :]).double().sum(0)
    v = (v / samples).float()
    v_dev = (v_dev / samples).float()
    return v, torch.max(v_dev, dim=1).values


def nash_regret_step(env, pi, gen: torch.Generator, samples: int = 64) -> float:
    v, br = policy_values(env, pi, gen, samples)
    return float(torch.max(br - v))


def run_planner(planner, env: CongestionEnv, episodes: int, *, seed: int = 1, eval_samples: int = 64):
    """Drive a planner; returns dict of per-episode series.

    Each episode draws the planner's actions, then the link-success
    uniforms of its tau packets, then ``policy_values``' joint actions,
    all from one CPU generator seeded with ``seed``.
    """
    gen = torch.Generator().manual_seed(seed)
    lat_total = 0.0
    series = {"nash_regret": [], "cum_latency_ms": [], "mean_reward": []}
    for _ in range(episodes):
        actions = planner.sample_actions(gen)  # (N, tau)
        u = uniforms(gen, tuple(actions.shape), actions.device)
        rws, lats = [], []
        for t in range(actions.shape[1]):
            a_t = actions[:, t]
            rws.append(env.rewards(a_t, u[:, t]))
            lats.append(env.latency_ms(a_t))
        rewards = torch.stack(rws, 1)
        lat_total += float(torch.stack(lats).double().sum()) / actions.shape[0]
        planner.update(actions, rewards)
        series["nash_regret"].append(nash_regret_step(env, planner.pi, gen, eval_samples))
        series["cum_latency_ms"].append(lat_total)
        series["mean_reward"].append(float(rewards.double().mean()))
    last = planner.sample_actions(torch.Generator().manual_seed(99)).reshape(-1)
    series["selection_freq"] = (
        torch.bincount(last, minlength=env.num_paths).double() / last.numel()
    ).float().cpu().numpy()
    return series


# ---------------------------------------------------------------------------
# live placement: measured-telemetry best response over the actual trees


def tree_path_costs(tree, rows, cap, occ, *, base_ms, down_mbit, up_mbit):
    """Vectorized commit/download path costs over an array-backed tree.

    ``rows[s]`` maps tree slot ``s`` to its core uplink row; ``cap``/``occ``
    are the per-uplink capacity (Mbps) and measured occupancy arrays from
    the event core's congestion ledger.  A node's prospective fair share on
    its own uplink is ``cap / (1 + occ)`` (its flow joins whatever is
    already there), so the per-slot hop costs are

        hc_up[s]   = base_ms + 1e3 * up_mbit   / max(share[s], eps)
        hc_down[s] = base_ms + 1e3 * down_mbit / max(share[s], eps)

    and the path costs accumulate root-down over the cached BFS levels —
    one array pass per level, no per-node Python (the replan hot path):

        up[s]   = hc_up[s] + up[parent]        (commit: s -> root)
        down[s] = down[parent] + hc_down[parent]  (broadcast: root -> s)

    Returns ``(up, down, hc_up, hc_down)`` as float64 arrays of length
    ``tree._n``; detached slots keep ``+inf`` path costs.  The retained
    per-node oracle is :func:`tree_path_costs_scalar`; the two-operand
    accumulation order above is chosen so parity is EXACT float equality.
    """
    cache = tree._ensure_cache()
    n = tree._n
    r = np.asarray(rows)
    share = np.asarray(cap, np.float64)[r] / np.maximum(1.0 + np.asarray(occ, np.float64)[r], 1.0)
    hc_up = base_ms + 1e3 * up_mbit / np.maximum(share, 1e-9)
    hc_down = base_ms + 1e3 * down_mbit / np.maximum(share, 1e-9)
    up = np.full(n, np.inf)
    down = np.full(n, np.inf)
    rs = cache["root_s"]
    up[rs] = 0.0
    down[rs] = 0.0
    for lev in cache["levels"][1:]:
        ps = tree._par[lev]
        up[lev] = hc_up[lev] + up[ps]
        down[lev] = down[ps] + hc_down[ps]
    return up, down, hc_up, hc_down


def tree_path_costs_scalar(tree, rows, cap, occ, *, base_ms, down_mbit, up_mbit, nodes):
    """Per-node Python cost sweep — the pre-refactor model, retained as the
    exactness oracle for :func:`tree_path_costs` (tests/test_placement.py
    asserts float-for-float equality).  Walks each node's ``path_to_root``
    and accumulates hop costs top-down in the same two-operand order as the
    vectorized level pass."""
    cap = np.asarray(cap, np.float64)
    occ = np.asarray(occ, np.float64)
    out_up, out_down = [], []
    for node in nodes:
        path = tree.path_to_root(int(node))  # node .. root
        u = 0.0
        dn = 0.0
        for child, par in zip(reversed(path[:-1]), reversed(path[1:])):
            cs = tree._slot[child]
            ps = tree._slot[par]
            sc = cap[rows[cs]] / max(1.0 + occ[rows[cs]], 1.0)
            sp = cap[rows[ps]] / max(1.0 + occ[rows[ps]], 1.0)
            u = (base_ms + 1e3 * up_mbit / max(sc, 1e-9)) + u
            dn = dn + (base_ms + 1e3 * down_mbit / max(sp, 1e-9))
        out_up.append(u)
        out_down.append(dn)
    return np.asarray(out_up, np.float64), np.asarray(out_down, np.float64)


@dataclass(frozen=True)
class Move:
    """One planned re-graft: ``node`` (with its subtree) leaves
    ``old_parent`` for ``new_parent``; costs are the measured commit+
    download path cost before the move and the engine's estimate after."""

    node: int
    old_parent: int
    new_parent: int
    cost_before: float
    cost_est: float


class PlacementEngine:
    """Live utility-aware placement: Algorithm 1's congestion game played
    against measured state instead of bandit samples.

    Each ``plan_tree`` call is one ε-best-response step of the OPT
    planner's greedy marginal-reward rule: the costliest (or
    selector-flagged) members are offered the lowest-cost attachment
    points, and a move is emitted only when the estimated cost drops
    below ``improve`` × the measured cost (the hysteresis playing ε, so
    the greedy dynamics settle instead of oscillating).  The estimate
    for re-grafting ``w`` under ``p`` decomposes as

        cost(w under p) = hc_up[w] + (up[p] + down[p] + hc_down[p])

    whose second term is mover-independent — so candidate scoring is one
    vectorized pass and each mover takes the first admissible candidate.

    The engine is pure policy: the scheduler feeds it telemetry
    (occupancy, uplink bytes, defer/deadline flags via :meth:`flag`) and
    applies its moves through ``Forest.regraft_many``, pricing the JOIN
    control traffic on the simulation clock.  ``spike_jain`` /
    ``spike_occupancy`` / ``min_interval_ms`` configure the scheduler's
    replan triggers (docs/architecture.md "placement layer").
    """

    def __init__(
        self,
        *,
        max_moves: int = 4,
        improve: float = 0.9,
        candidate_k: int = 8,
        straggler_factor: float = 1.25,
        per_parent: int = 2,
        max_fanout: int = 6,
        min_interval_ms: float = 250.0,
        cooldown_ms: float = 1000.0,
        join_bytes: float = 4096.0,
        spike_occupancy: float = 6.0,
        spike_jain: float = 0.7,
    ):
        if max_moves < 0 or candidate_k < 1 or per_parent < 1 or max_fanout < 1:
            raise ValueError(
                "max_moves >= 0, candidate_k >= 1, per_parent >= 1, max_fanout >= 1 required"
            )
        if not 0.0 < improve <= 1.0:
            raise ValueError("improve must be in (0, 1]")
        self.max_moves = int(max_moves)
        self.improve = float(improve)
        self.candidate_k = int(candidate_k)
        self.straggler_factor = float(straggler_factor)
        self.per_parent = int(per_parent)
        self.max_fanout = int(max_fanout)
        self.min_interval_ms = float(min_interval_ms)
        self.cooldown_ms = float(cooldown_ms)
        self.join_bytes = float(join_bytes)
        self.join_mbit = float(join_bytes) * 8e-6
        self.spike_occupancy = float(spike_occupancy)
        self.spike_jain = float(spike_jain)
        self.flagged: dict[tuple[int, int], float] = {}
        self._last_move: dict[tuple[int, int], float] = {}
        self.replans = 0
        self.moves_applied = 0

    def reset(self) -> None:
        self.flagged.clear()
        self._last_move.clear()
        self.replans = 0
        self.moves_applied = 0

    def flag(self, app_idx: int, worker: int, weight: float = 1.0) -> None:
        """Telemetry feed: mark ``worker`` as transport-hurt (deferred past
        deadline, blocklist-bound, …).  Flagged workers move first."""
        key = (int(app_idx), int(worker))
        self.flagged[key] = self.flagged.get(key, 0.0) + float(weight)

    def consume_flags(self, app_idx: int) -> dict[int, float]:
        out = {w: v for (a, w), v in self.flagged.items() if a == app_idx}
        for w in out:
            del self.flagged[(app_idx, w)]
        return out

    def plan_tree(
        self,
        tree,
        *,
        rows,
        cap,
        occ,
        base_ms: float,
        down_mbit: float,
        up_mbit: float,
        flagged=None,
        blocked=frozenset(),
        app_idx: int = 0,
        now_ms: float = 0.0,
    ) -> list[Move]:
        """One best-response step over ``tree``; returns validated moves
        (cycle-free against the current tree, deterministic order).
        ``now_ms`` drives the per-node move cooldown: a node re-grafted
        within the last ``cooldown_ms`` is not moved again, so a churn
        repair reverting a placement cannot thrash the same worker back
        and forth every replan."""
        if self.max_moves == 0 or tree._n <= 1:
            return []
        up, down, hc_up, hc_down = tree_path_costs(
            tree, rows, cap, occ, base_ms=base_ms, down_mbit=down_mbit, up_mbit=up_mbit
        )
        cache = tree._ensure_cache()
        srt, slots_srt = cache["ids_sorted"], cache["slots_sorted"]
        if len(srt) == 0:
            return []
        blocked_arr = (
            np.asarray(sorted(blocked), np.int64) if blocked else np.empty(0, np.int64)
        )

        # member slots (vectorized id -> slot over the sorted cache)
        marr = np.asarray(sorted(tree.members), np.int64)
        j = np.searchsorted(srt, marr)
        jj = np.minimum(j, len(srt) - 1)
        known = (j < len(srt)) & (srt[jj] == marr)
        mslots = slots_srt[jj[known]]
        mids = marr[known]
        good = np.isfinite(up[mslots]) & (mids != tree.root)
        if len(blocked_arr):
            good &= ~np.isin(mids, blocked_arr)
        mslots, mids = mslots[good], mids[good]
        if len(mids) == 0:
            return []

        total = up[mslots] + down[mslots]
        med = float(np.median(total))
        fl = flagged or {}
        fw = np.asarray([fl.get(int(w), 0.0) for w in mids], np.float64)
        cooled = np.asarray(
            [
                now_ms - self._last_move.get((app_idx, int(w)), float("-inf"))
                >= self.cooldown_ms
                for w in mids
            ],
            bool,
        )
        eligible = cooled & ((fw > 0.0) | (total >= self.straggler_factor * med))
        # flagged first, then costliest, id ascending for determinism
        order = np.lexsort((mids, -total, -(fw > 0.0).astype(np.int64)))
        movers = [int(i) for i in order if eligible[i]][: self.max_moves]
        if not movers:
            return []
        mover_ids = mids[movers]

        # candidate attachment points: reachable, not blocked, not a mover,
        # scored by the mover-independent term — one vectorized pass
        all_slots = np.concatenate(cache["levels"]) if cache["levels"] else np.empty(0, np.int64)
        score = up[all_slots] + down[all_slots] + hc_down[all_slots]
        cids = tree._ids[all_slots]
        ok = ~np.isin(cids, mover_ids)
        if len(blocked_arr):
            ok &= ~np.isin(cids, blocked_arr)
        all_slots, score, cids = all_slots[ok], score[ok], cids[ok]
        if len(cids) == 0:
            return []
        pick = np.lexsort((cids, score))[: self.candidate_k]
        cand_slots = all_slots[pick]
        cand_ids = cids[pick]
        cand_score = score[pick]
        # current child counts: a hub cap — piling movers onto one parent
        # both re-creates the contention being planned away and makes
        # that parent a single point of failure under churn
        cand_kids = np.where(
            tree._ch_present[cand_slots], tree._ch_len[cand_slots], 0
        ).astype(np.int64)

        moves: list[Move] = []
        assigned: dict[int, int] = {}
        parent = tree.parent
        root = tree.root
        for mi in movers:
            w = int(mids[mi])
            ws = int(mslots[mi])
            base_cost = float(total[mi])
            chosen = None
            for ci, (cid, sc) in enumerate(zip(cand_ids.tolist(), cand_score.tolist())):
                cid = int(cid)
                if assigned.get(cid, 0) >= self.per_parent:
                    continue
                if int(cand_kids[ci]) + assigned.get(cid, 0) >= self.max_fanout:
                    continue
                est = float(hc_up[ws]) + float(sc)
                if est > self.improve * base_cost:
                    continue
                # cycle guard: the candidate must not sit in w's subtree
                cur, inside = cid, False
                while cur != root:
                    if cur == w:
                        inside = True
                        break
                    cur = parent[cur]
                if inside:
                    continue
                chosen = (cid, est)
                break  # candidates are score-sorted: first admissible wins
            if chosen is None:
                continue
            cid, est = chosen
            old_parent = int(parent[w])
            if cid == old_parent:
                continue
            moves.append(Move(w, old_parent, cid, base_cost, est))
            assigned[cid] = assigned.get(cid, 0) + 1
            self._last_move[(app_idx, w)] = float(now_ms)
        return moves
