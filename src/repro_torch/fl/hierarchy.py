"""Tree aggregation across pods: Totoro+'s cross-zone hop as collectives.

Answers to ``repro/fl/hierarchy.py``.  One pod is one edge zone, and here
one rank of the ``pod`` process group (``mesh.get_group("pod")``,
``launch/mesh.py``): the reduction inside a pod is the rank's own local
pass, and the cross-zone hop is an explicit collective over ``pod``, so
it can be compressed where the paper compresses.  Each function takes
that group as ``group=``, or the mesh whose ``pod`` group it is as
``mesh=`` (the reference's run inside a ``shard_map`` over ``pod``).

- ``cross_pod_psum``: FedAvg across zones, an f32 all-reduce of every
  leaf divided by the pod count.
- ``cross_pod_q8``: for each leaf, its rows (flattened, zero-padded to
  256-wide rows: ``steps.pod_rows``) go through one ``ops.qsgd_quantize``
  launch at the reference's rounding of 0.5 (it passes no uniforms; a
  buffer from ``steps.rounding_halves``); the int8 rows and the f32
  scales are all-gathered in rank order (the wire: int8 plus one f32 a
  row, about 4x less than f32); one ``ops.qsgd_dequantize`` launch runs
  over the gathered (P * R, 256) rows, and ``torch.mean`` over the pod
  axis gives the leaf back in its shape.  Both halves are ``steps.
  q8_mean_over_pods``' own (``steps.quantize_pods`` on the one pod,
  ``steps.dequantize_mean``), so given the same gradients the result
  equals it bit for bit on every rank; its mean is fp-tight to the
  reference's (ROADMAP §3 rule 10), the lattice and scales bit-equal.
  Deterministic rounding keeps the pods in lockstep.

On a gloo group, CUDA tensors cross the wire through pinned host buffers
(``all_gather_pods``, ``_wire``): gloo's collectives are the CPU's, and
the copy is what the cross-zone hop is.  On any other backend the tensors
go as they are.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..pytree import tree_map
from . import steps
from .steps import dequantize_mean


def _pod_group(group=None, mesh=None):
    """``group``, else ``mesh``'s ``pod`` process group."""
    if group is not None:
        return group
    if mesh is None:
        raise ValueError("cross-pod aggregation needs the pod group (group=) or a mesh (mesh=)")
    return mesh.get_group("pod")


def _wire(t: torch.Tensor, group, *, copy: bool = False) -> torch.Tensor:
    """``t`` as it goes on the wire: a pinned host copy for CUDA tensors
    on a gloo group, else ``t`` itself (contiguous; a copy if ``copy``)."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    return t.clone(memory_format=torch.contiguous_format) if copy else t.contiguous()


def all_gather_pods(t: torch.Tensor, group) -> torch.Tensor:
    """(P, *t.shape): every rank's ``t`` in rank order, on ``t``'s device."""
    src = _wire(t, group)
    P = dist.get_world_size(group)
    out = torch.empty((P, *t.shape), dtype=t.dtype, device=src.device,
                      pin_memory=src.device != t.device)
    dist.all_gather(list(out.unbind(0)), src, group=group)
    return out.to(t.device)


def _pods(num_pods: int, group) -> None:
    if dist.get_world_size(group) != num_pods:
        raise ValueError(f"num_pods {num_pods}, but the pod group has "
                         f"{dist.get_world_size(group)} ranks")


def cross_pod_psum(grads, num_pods: int, *, group=None, mesh=None):
    """FedAvg across zones: the sum over the ``pod`` group over num_pods."""
    group = _pod_group(group, mesh)
    _pods(num_pods, group)

    def agg(g):
        buf = _wire(g.float(), group, copy=True)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        return buf.to(g.device) / num_pods

    return tree_map(agg, grads)


def quantize_leaf(g: torch.Tensor, halves: torch.Tensor):
    """This rank's leaf as one pod of ``steps.quantize_pods``: (int8
    lattice (R, 256), f32 scales (R, 1))."""
    return steps.quantize_pods(g[None], halves)


def cross_pod_q8(grads, num_pods: int, *, group=None, mesh=None, halves=None):
    """Compressed cross-zone aggregation: QSGD int8, all_gather over the
    ``pod`` group, dequantize and mean (module docstring).  ``halves``: a
    buffer of 0.5s with at least the largest leaf's rows (made here when
    None)."""
    group = _pod_group(group, mesh)
    _pods(num_pods, group)
    if halves is None:
        halves = steps.rounding_halves(tree_map(lambda g: g[None], grads))

    def agg(g):
        q, s = quantize_leaf(g, halves)
        return dequantize_mean(all_gather_pods(q, group), all_gather_pods(s, group), g.shape)

    return tree_map(agg, grads)


AGGREGATORS = {
    "totoro_tree": cross_pod_psum,
    "totoro_tree_q8": cross_pod_q8,
}
