"""Congestion-game environment (paper §V-A, Appendix C), in numpy.

Answers to ``repro/core/congestion.py``.  Facilities = next-hop nodes with
bandwidth capacities; when k nodes pick the same hop, its rate drops to
capacity/k (the paper's bandwidth-sharing model, §VII-E): latency =
packet_bits / (capacity/k) + propagation; reward = 1 - latency / l_max in
[0, 1] (Appendix G), times a link-success draw with mean theta_p.  The
async scheduler reads ``CongestionEnv.packet_mbit`` and the fair-share
allocators below on the host; the path planner's ``latency_ms`` /
``rewards`` run on the device of the actions they are given, with
``capacity`` and ``theta`` copied there once.  ``rewards`` takes its
link-success uniforms from the caller (``bernoulli(theta)`` is
``u < theta``), so a run on the card and one on the CPU see the same draws.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass(frozen=True)
class CongestionEnv:
    capacity: np.ndarray  # (P,) f32 Mbps per hop
    theta: np.ndarray  # (P,) f32 link success rate
    packet_mbit: float = 8.0
    base_ms: float = 5.0
    l_max_ms: float = 2000.0

    # device -> (capacity, theta, 1e3 * packet_mbit, l_max_ms) as f32 tensors
    _on: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def num_paths(self) -> int:
        return int(self.capacity.shape[0])

    def on(self, device: torch.device):
        """(capacity, theta, 1e3 * packet_mbit, l_max_ms) on ``device``.
        The two constants are tensors so that every division is a true
        f32 division (PyTorch's CUDA division by a Python scalar multiplies
        by its reciprocal instead), as the reference's eager ops divide."""
        dev = torch.device(device)
        got = self._on.get(dev)
        if got is None:
            f32 = torch.float32
            got = (
                torch.as_tensor(np.asarray(self.capacity, np.float32), device=dev),
                torch.as_tensor(np.asarray(self.theta, np.float32), device=dev),
                torch.tensor(1e3 * self.packet_mbit, dtype=f32, device=dev),
                torch.tensor(self.l_max_ms, dtype=f32, device=dev),
            )
            self._on[dev] = got
        return got

    def latency_ms(self, actions: torch.Tensor) -> torch.Tensor:
        """actions: (N,) hop index per node -> per-node latency (ms), f32,
        on the actions' device."""
        cap, _, bits, _ = self.on(actions.device)
        counts = torch.bincount(actions, minlength=self.num_paths).to(torch.float32)
        n_p = counts[actions]  # the congestion each node sees
        rate = cap[actions] / torch.clamp_min(n_p, 1.0)  # Mbps
        return self.base_ms + bits / torch.clamp_min(rate, 1e-6)

    def rewards(self, actions: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
        """``clip(1 - latency / l_max, 0, 1)`` times the link-success draw
        ``uniforms < theta[actions]`` (uniforms in [0, 1), one per node)."""
        _, theta, _, l_max = self.on(actions.device)
        r = torch.clamp(1.0 - self.latency_ms(actions) / l_max, 0.0, 1.0)
        p = theta[actions]
        return r * (uniforms.to(p.dtype) < p)

    def mean_reward(self, path: int, k: int) -> float:
        """r^p(k, theta_p): closed-form mean reward with k users on path."""
        rate = float(self.capacity[path]) / max(k, 1)
        lat = self.base_ms + 1e3 * self.packet_mbit / rate
        # f32 product, as the reference's jax.Array theta makes it
        return float(np.float32(np.clip(1.0 - lat / self.l_max_ms, 0.0, 1.0)) * self.theta[path])


def fair_share_rates(
    capacity: float, weights, caps=None, *, eps: float = 1e-9
) -> list[float]:
    """Weighted max-min fair allocation of one uplink across its flows.

    Each flow i asks for the weighted share ``capacity * w_i / sum(w)``;
    a flow whose ``caps[i]`` (Mbps rate cap, ``None`` = uncapped) binds
    is frozen at its cap and the freed capacity is re-divided among the
    uncapped flows (progressive water-filling).  With no caps this is
    plain weighted processor sharing; with one flow it returns
    ``[capacity]`` — the uncontended solo rate, unchanged from the
    legacy ``capacity / k`` pricing at k = 1.

    Deterministic, pure host-side numpy-free arithmetic.
    """
    n = len(weights)
    if n == 0:
        return []
    cap_of = [float("inf") if c is None else float(c) for c in (caps or [None] * n)]
    rates = [0.0] * n
    active = list(range(n))
    avail = float(capacity)
    while active and avail > eps:
        wsum = sum(weights[i] for i in active)
        if wsum <= eps:
            break
        share = {i: avail * weights[i] / wsum for i in active}
        bound = [i for i in active if cap_of[i] <= share[i] + eps]
        if not bound:
            for i in active:
                rates[i] = share[i]
            return rates
        for i in bound:
            rates[i] = cap_of[i]
            avail -= cap_of[i]
            active.remove(i)
        avail = max(0.0, avail)
    return rates


class UplinkState:
    """Incremental weighted max-min fair allocator for ONE uplink.

    The legacy path rebuilt everything per flow join/complete: a group-
    count dict, weight/cap lists, then ``fair_share_rates``'s progressive
    relaxation — O(F) dict churn plus O(F x rounds) water-filling (worst
    case O(F^2) when caps bind one at a time).  This structure makes the
    per-event update cheap:

    - membership and per-group flow counts are maintained incrementally
      (``add``/``remove`` are O(log F): a dict insert plus one bisect
      into the capped-flow ladder);
    - capped flows sit in a ladder sorted by their cap-to-weight ratio
      ``cap_i / w_i`` — invariant under group-count changes, since group
      splitting divides cap and weight alike — so ``rates()`` resolves
      the water-filling level with ONE ascending walk over the ladder
      (O(#capped)) instead of progressive relaxation over all flows;
    - the uncapped fast path (no ladder entries — the common case) is a
      single pass, **bit-for-bit identical** to ``fair_share_rates``:
      same sequential weight sum in flow-insertion order, same
      ``capacity * w_i / wsum`` division.  That exactness is what lets
      the incremental event engine keep byte-identical traces
      (bench_hotpath's gate).  The weight sum is deliberately re-summed
      per call (O(F) float adds on a list walk — cheap) rather than
      maintained by +=/-=: float addition is not associative, and an
      incrementally drifted sum would break trace identity.

    Flows in one ``group`` split a single weight share and cap equally
    (per-app fairness), exactly as the legacy engine computed it.
    """

    __slots__ = ("capacity", "_flows", "_group_n", "_ladder")

    def __init__(self, capacity: float):
        self.capacity = float(capacity)
        # fid -> (weight, cap, group); dict preserves insertion order,
        # which IS the legacy flow order (list append order)
        self._flows: dict[int, tuple[float, float | None, object]] = {}
        self._group_n: dict = {}
        self._ladder: list[tuple[float, int]] = []  # (cap/weight, fid) ascending

    def __len__(self) -> int:
        return len(self._flows)

    def add(self, fid: int, weight: float, cap: float | None, group) -> None:
        self._flows[fid] = (float(weight), cap, group)
        self._group_n[group] = self._group_n.get(group, 0) + 1
        if cap is not None:
            bisect.insort(self._ladder, (float(cap) / float(weight), fid))

    def remove(self, fid: int) -> None:
        weight, cap, group = self._flows.pop(fid)
        n = self._group_n[group] - 1
        if n:
            self._group_n[group] = n
        else:
            del self._group_n[group]
        if cap is not None:
            i = bisect.bisect_left(self._ladder, (cap / weight, fid))
            while self._ladder[i][1] != fid:  # equal ratios: scan the tie run
                i += 1
            self._ladder.pop(i)

    def rates(self, *, eps: float = 1e-9) -> list[float]:
        """Fair rates for every flow, in insertion (fid-arrival) order."""
        if not self._flows:
            return []
        gn = self._group_n
        if not self._ladder:
            # uncapped fast path: identical arithmetic to fair_share_rates
            weights = [w / gn[g] for w, _, g in self._flows.values()]
            wsum = sum(weights)
            if wsum <= eps:
                return [0.0] * len(weights)
            return [self.capacity * w / wsum for w in weights]
        # capped path: walk the ladder ascending to find the binding set.
        # A flow is capped iff its ratio cap_i/w_i (group-invariant) lies
        # at or below the final water level avail/wsum_uncapped; walking
        # in ascending ratio order caps flows exactly in the order the
        # progressive relaxation would freeze them.
        weights = {fid: w / gn[g] for fid, (w, _, g) in self._flows.items()}
        wsum = sum(weights.values())
        avail = self.capacity
        capped: dict[int, float] = {}
        for ratio, fid in self._ladder:
            if wsum <= eps or avail <= eps:
                break
            w, cap, g = self._flows[fid]
            cap_eff = cap / gn[g]
            if cap_eff <= avail * weights[fid] / wsum + eps:
                capped[fid] = cap_eff
                avail = max(0.0, avail - cap_eff)
                wsum -= weights[fid]
            else:
                break  # ladder is sorted: no later flow can bind either
        out = []
        for fid, (w, _, g) in self._flows.items():
            if fid in capped:
                out.append(capped[fid])
            elif wsum <= eps or avail <= eps:
                out.append(0.0)
            else:
                out.append(avail * weights[fid] / wsum)
        return out


def make_env(num_paths: int, *, seed: int = 0, bw_range=(20.0, 100.0), theta_range=(0.9, 1.0)) -> CongestionEnv:
    rng = np.random.default_rng(seed)
    return CongestionEnv(
        capacity=rng.uniform(*bw_range, size=num_paths).astype(np.float32),
        theta=rng.uniform(*theta_range, size=num_paths).astype(np.float32),
    )
