"""Algorithm 2: multicast-enabled distributed hop-by-hop routing
(paper Appendix N-B), on tensors.

Answers to ``repro/core/multicast.py``.  Actions become hop SUBSETS (send
to multiple next hops simultaneously); rewards live in [0, F] where F is
the max subset size.  The policy-update math is unchanged — Algorithm 1
over the enumerated subset action space (the paper: "each policy in
Delta(P_n) becomes a |subsets|-dimensional vector") — so
``algorithm1_episode`` and its ``policy_update`` kernel are reused
verbatim (at 8 hops and subsets of up to 2: K = 36 actions, 45
candidates).  The Nash-regret bound for this variant is open (the paper
leaves it to future work).

``rewards`` takes the link-success uniforms of every packet from the
caller (``pathplan.uniforms``), so card and CPU runs see the same draws
and tests can inject the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations

import numpy as np
import torch

from .congestion import CongestionEnv
from .pathplan import _hop_reward, algorithm1_episode, candidate_policy_set, categorical
from ..fl.rounds import resolve_device


def enumerate_subsets(K: int, max_size: int = 2) -> np.ndarray:
    """All non-empty hop subsets up to ``max_size`` as a (M, K) 0/1 matrix."""
    rows = []
    for size in range(1, max_size + 1):
        for combo in combinations(range(K), size):
            v = np.zeros(K)
            v[list(combo)] = 1.0
            rows.append(v)
    return np.stack(rows)


@dataclass
class MulticastPlanner:
    """Totoro+ Algorithm 2: policies over subset actions."""

    num_nodes: int
    num_paths: int
    max_subset: int = 2
    tau: int = 8
    alpha: float = 0.95
    beta: float = 0.5
    seed: int = 0
    device: str | torch.device | None = None  # None: the CUDA card

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.subsets = torch.tensor(
            enumerate_subsets(self.num_paths, self.max_subset), dtype=torch.float32, device=self.device
        )
        M = self.subsets.shape[0]
        self.pi = torch.full((self.num_nodes, M), 1.0 / M, dtype=torch.float32, device=self.device)
        self.mask = torch.ones((self.num_nodes, M), dtype=torch.bool, device=self.device)
        self.cand = candidate_policy_set(M, seed=self.seed).to(self.device)

    def sample_actions(self, gen: torch.Generator) -> torch.Tensor:
        """(N, tau) subset-action indices."""
        return categorical(self.pi, self.tau, gen)

    def rewards(self, env: CongestionEnv, actions: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
        """Reward of a subset = sum of member-hop rewards under the joint
        congestion produced by ALL selected hops of all nodes (in [0, F]).

        ``uniforms``: (tau, N, P) in [0, 1); hop p of node n's packet t
        gets through when ``uniforms[t, n, p] < theta[p]``.  Returns
        (N, tau) f32.
        """
        sel = self.subsets[actions]  # (N, tau, P) 0/1
        r = _hop_reward(env, sel.sum(0), sel.device)  # (tau, P): users per hop per packet
        _, theta, _, _ = env.on(sel.device)
        ok = (uniforms.to(theta.dtype) < theta).permute(1, 0, 2)  # (N, tau, P)
        # at most F terms of [0, 1] per packet: the f64 sum is exact
        return (sel * r[None] * ok).double().sum(-1).float()

    def update(self, actions, rewards) -> None:
        self.pi = algorithm1_episode(
            self.pi, self.mask, self.cand, actions, rewards,
            tau=self.tau, alpha=self.alpha, beta=self.beta,
        )

    def subset_usage(self) -> np.ndarray:
        """Mean policy mass per subset size (diagnostics)."""
        sizes = self.subsets.sum(-1).cpu().numpy()
        mass = self.pi.mean(0).cpu().numpy()
        return np.asarray([mass[sizes == s].sum() for s in range(1, self.max_subset + 1)])
