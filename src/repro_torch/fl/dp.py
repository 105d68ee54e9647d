"""Differential-privacy hook (per-application customization, Table II).

Answers to ``repro/fl/dp.py``: clip-then-Gaussian-noise on gradient
pytrees, the mechanism application owners can specify in
``Aggregate(app_id, object)`` per the paper §IV-E.

Where the reference takes a PRNG key, the port takes ``noise``: a CPU
``torch.Generator`` (one standard-normal draw per leaf, in sorted-key leaf
order), so a card run and a CPU run of one seed add the same noise; or
the standard-normal draws themselves, one tensor per leaf, which is how
the tests give the port the reference's ``jax.random.normal`` draws.
The global norm's sum of squares is summed in PyTorch's order, not
XLA's, so it agrees with the reference to f32 rounding, not bit for bit.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..pytree import leaves, tree_map, unflatten_like


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    n = global_norm(tree)
    # a tensor numerator: ``float / tensor`` would multiply by a reciprocal
    num = torch.as_tensor(max_norm, dtype=torch.float32, device=n.device)
    scale = torch.clamp(num / torch.clamp(n, min=1e-12), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), n


def gaussianize(tree, noise: torch.Generator | Sequence[torch.Tensor], sigma: float):
    """Add ``sigma`` times a standard-normal draw to every leaf.

    ``noise`` is a CPU generator (the draws are made on the CPU in f32 and
    moved to each leaf's device) or the draws themselves, one tensor per
    leaf in sorted-key leaf order, each of its leaf's shape.
    """
    ls = leaves(tree)
    if isinstance(noise, torch.Generator):
        noise = [torch.randn(tuple(x.shape), generator=noise, dtype=torch.float32) for x in ls]
    if len(noise) != len(ls):
        raise ValueError(f"{len(noise)} draws for {len(ls)} leaves")
    noised = []
    for x, z in zip(ls, noise):
        z = torch.as_tensor(z, dtype=torch.float32, device=x.device)
        if tuple(z.shape) != tuple(x.shape):
            raise ValueError(f"a draw of shape {tuple(z.shape)} for a leaf of {tuple(x.shape)}")
        noised.append(x + (sigma * z).to(x.dtype))
    return unflatten_like(tree, noised)


def dp_sanitize(grads, noise: torch.Generator | Sequence[torch.Tensor], *, clip: float, sigma: float):
    """Clip to ``clip`` then add N(0, (sigma*clip)^2) noise (per-round DP-SGD)."""
    clipped, _ = clip_by_global_norm(grads, clip)
    return gaussianize(clipped, noise, sigma * clip)
