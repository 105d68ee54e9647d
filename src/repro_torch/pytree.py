"""Flatten and unflatten nested dicts and lists of tensors.

Parameters and model updates are plain nested dicts whose leaves are
tensors; a list may stand for a node too (a config's leading dense
layers are ``params["first"]``, a list of layer dicts).  Dict keys are
visited in **sorted order** and list items in index order, the order
``jax.tree.leaves`` gives, so a flat parameter vector built here lines up
element for element with the JAX package's ``kernels.ops._stack_pytrees``
and ``core.api._aggregate_hierarchical``.  Anything that is neither a
dict nor a list is a leaf (a tuple too).
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def _children(tree: Any) -> list | None:
    """(key, child) pairs of an interior node in leaf order; None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, list):
        return list(enumerate(tree))
    return None


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in sorted-key, then index, order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for _, c in kids for leaf in leaves(c)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over trees of one structure."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    out = [tree_map(fn, c, *(r[k] for r in rest)) for k, c in kids]
    return out if isinstance(tree, list) else {k: v for (k, _), v in zip(kids, out)}


def key_paths(tree: Any, prefix: str = "") -> list[str]:
    """Each leaf's ``/``-joined keys and list indices, in leaf order (the
    paths the JAX package's checkpoints write: ``first/0/ffn/wg``)."""
    kids = _children(tree)
    if kids is None:
        return [prefix[:-1]]
    return [p for k, c in kids for p in key_paths(c, f"{prefix}{k}/")]


def unflatten_like(like: Any, flat_leaves: list) -> Any:
    """Rebuild ``like``'s structure from leaves in leaf order."""
    it = iter(flat_leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def ravel(tree: Any) -> torch.Tensor:
    """One flat f32 vector of every leaf, in leaf order."""
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
