"""Flatten and unflatten nested dicts of tensors.

Parameters and model updates are plain (possibly nested) dicts whose
leaves are tensors.  Keys are visited in **sorted order**, the order
``jax.tree.leaves`` gives a dict, so a flat parameter vector built here
lines up element for element with the JAX package's
``kernels.ops._stack_pytrees`` and ``core.api._aggregate_hierarchical``.
Anything that is not a dict is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def unflatten_like(like: Any, flat_leaves: list) -> Any:
    """Rebuild ``like``'s structure from leaves in sorted-key order."""
    it = iter(flat_leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def ravel(tree: Any) -> torch.Tensor:
    """One flat f32 vector of every leaf, in sorted-key order."""
    return torch.cat([torch.as_tensor(l).reshape(-1).float() for l in leaves(tree)])


def unravel_like(vec: torch.Tensor, like: Any) -> Any:
    """Split a flat vector back into ``like``'s leaf shapes (views of ``vec``)."""
    out, off = [], 0
    for l in leaves(like):
        shape = tuple(l.shape)
        n = int(torch.Size(shape).numel())
        out.append(vec[off : off + n].reshape(shape))
        off += n
    if off != vec.numel():
        raise ValueError(f"vector of {vec.numel()} elements for a tree of {off}")
    return unflatten_like(like, out)
