"""Plain PyTorch versions of the ported kernels (the correctness contract).

Each function computes what its CUDA kernel computes, in the same
arithmetic type, with ordinary tensor operations.  The wrappers use them
for tensors that lie on the CPU; ``chip_smoke.py`` and the card-only
tests hold each kernel against them on the card.  Only the oracles of the
kernels ported so far are here (``repro/kernels/ref.py`` has the rest).
"""
from __future__ import annotations

import torch


def tree_aggregate_ref(grads: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted sum of C children's flattened updates.

    grads: (C, L) any float dtype; weights: (C,) -> (L,) f32, accumulated
    in f32 (``repro/kernels/ref.py::tree_aggregate_ref``).
    """
    return (grads.float() * weights.float()[:, None]).sum(dim=0)


def tree_aggregate_groups_ref(grads: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(G, C, L) x (G, C) -> (G, L) f32: one tree level's per-group sums."""
    return (grads.float() * weights.float()[:, :, None]).sum(dim=1)
