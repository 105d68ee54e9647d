"""FedAvg / FedProx aggregation and client weighting.

Answers to ``repro/fl/aggregation.py``.  Pytrees are dicts of tensors
(``repro_torch.pytree``).  The reference runs these eagerly, one XLA op
per array operation with no fusion into FMAs, so the port does the same
f32 operations in the same order and gives the same bits: each weighted
sum starts from Python's ``sum`` at 0 and adds ``w_i * delta_i`` in
client order.  The one reduction is the sum of the client weights, which
XLA's CPU backend adds in sequence up to 32 weights and in an order of
its own beyond (parity rule 4); the port adds them in sequence in f32 on
the host, so the normalised weights are bit-equal for up to 32 clients
and within an ulp of the weight sum above.

Two call sites in the reference's design:
  - the mesh data plane (LM-scale): weights enter at the loss level
    (per-example weights), stragglers as zero-weight masks;
  - the overlay simulation (paper-scale small models in ``fl/rounds.py``):
    explicit weighted model-delta averaging along the dataflow tree,
    including FedProx's proximal term during local training.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..pytree import leaves, tree_map


def _normalised(weights) -> torch.Tensor:
    """``w / max(sum(w), 1e-12)`` in f32 on the host, the sum taken in
    client order."""
    w = torch.as_tensor(weights, dtype=torch.float32).cpu().numpy().reshape(-1)
    total = np.add.accumulate(w, dtype=np.float32)[-1] if w.size else np.float32(0)
    return torch.from_numpy(w / np.maximum(total, np.float32(1e-12)))


def fedavg(deltas: Sequence, weights: Sequence[float]):
    """Weighted average of client model deltas (pytrees)."""
    w = _normalised(weights).to(leaves(deltas[0])[0].device)

    def avg(*ls):
        return sum(wi * l.float() for wi, l in zip(w, ls))

    return tree_map(avg, *deltas)


def pairwise_accumulate(acc, delta, weight: float):
    """Streaming form used by internal tree nodes: acc += w * delta.

    This is what the ``tree_aggregate`` kernel computes on flattened rows
    at an aggregator node.
    """
    if acc is None:
        return tree_map(lambda d: weight * d.float(), delta)
    return tree_map(lambda a, d: a + weight * d.float(), acc, delta)


def fedprox_grad(grads, params, round_start, mu: float):
    """Add the FedProx proximal gradient mu * (w - w_global)."""
    if mu == 0.0:
        return grads
    return tree_map(lambda g, p, w0: g + mu * (p.float() - w0.float()), grads, params, round_start)


def straggler_mask(weights: Sequence[float], completed: Sequence[bool]):
    """Deadline-style straggler mitigation: drop late clients, renormalize.

    The mask is a host tensor; a caller moves it to its deltas' device."""
    w = np.asarray(weights, np.float32) * np.asarray(completed, np.float32)
    return _normalised(w)


def server_update(global_params, agg_delta, server_lr: float = 1.0):
    """FedOpt-style server step (plain SGD on the aggregated delta)."""
    return tree_map(
        lambda p, d: (p.float() + server_lr * d).to(p.dtype), global_params, agg_delta
    )
