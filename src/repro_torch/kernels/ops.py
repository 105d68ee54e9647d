"""Public wrappers around the port's kernels.

Answers to ``repro/kernels/ops.py``.  The reference padded and bucketed
its inputs for reasons the port does not share:

- the TILE padding of L existed for the TPU's BlockSpecs; the CUDA kernel
  masks its own ragged edge, so L is taken as it is;
- the power-of-two bucketing of G and C existed to bound XLA recompiles;
  PyTorch runs eagerly and the kernel takes any (G, C), so it is gone.
  ``bucket_size`` stays as the shared next-power-of-two helper;
- the ROWS_PER_BLOCK padding of the quantize and broadcast kernels'
  row count existed for the TPU's blocks; their CUDA kernels take any R;
- the NODE_BLOCK padding of the policy update's N (with uniform rows)
  and the TILE padding of the fused update's L existed for the TPU's
  BlockSpecs; their CUDA kernels take any N and any L.

There is no kernel mode: every wrapper dispatches by the device of its
tensors (CPU: plain version; CUDA: the hand-written kernel or an error).
All seven of the reference's kernels are ported: tree aggregation (and
its G = 1 case), QSGD quantize and dequantize, the broadcast chain apply,
the fused FedProx update and the Algorithm-1 policy update.
"""
from __future__ import annotations

import numpy as np
import torch

from . import broadcast as _bc
from . import fused_update as _fu
from . import policy_update as _pu
from . import quantize as _q
from . import tree_aggregate as _ta
from ..pytree import leaves, ravel, unflatten_like, unravel_like


def bucket_size(n: int) -> int:
    """Next power of two >= n (>= 1)."""
    return 1 << (max(1, int(n)) - 1).bit_length()


def tree_aggregate_groups(grads: torch.Tensor, weights) -> torch.Tensor:
    """(G, C, L) x (G, C) -> (G, L) f32: one tree level as G groups.

    Ragged groups carry zero weights (and zero rows) in their padding slots.
    """
    w = torch.as_tensor(weights, dtype=torch.float32, device=grads.device)
    return _ta.tree_aggregate_groups(grads.contiguous(), w.contiguous())


def tree_aggregate(grads: torch.Tensor, weights) -> torch.Tensor:
    """(C, L) x (C,) -> (L,) f32 weighted sum: the G = 1 case of the kernel."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=grads.device)
    return _ta.tree_aggregate(grads.contiguous(), w.contiguous())


def _stack_pytrees(updates: list) -> torch.Tensor:
    """(C, L) f32 stack of flattened update pytrees (sorted-key leaf order)."""
    return torch.stack([ravel(u) for u in updates])


def tree_aggregate_pytree(updates: list, weights):
    """Aggregate a list of model-update pytrees with the kernel."""
    return unravel_like(tree_aggregate(_stack_pytrees(updates), weights), updates[0])


def buffered_aggregate(updates: list, weights, staleness, *, alpha: float = 0.5):
    """Staleness-weighted buffered aggregate (async FedBuff apply).

    The K buffered deltas form ONE (1, K, L) group through
    ``tree_aggregate_groups`` with the discount ``w_i / (1+s_i)^alpha``
    folded into its weights; the sum is normalised by the combined weight,
    so a full uniform-staleness buffer at alpha = 0 is the synchronous
    FedAvg mean.  Returns (aggregate pytree, combined weights (K,) f32).
    """
    stacked = _stack_pytrees(updates)[None]  # (1, K, L)
    w = _ta.staleness_weights(weights, staleness, alpha, device=stacked.device)
    agg = tree_aggregate_groups(stacked, w[None])[0] / torch.clamp(w.sum(), min=1e-12)
    return unravel_like(agg, updates[0]), w


def buffered_aggregate_quantized(qs, scales, weights, staleness, *, alpha: float = 0.5):
    """Staleness-weighted aggregate of K *quantized* deltas, dequantized
    inside the aggregation (the compressed-transport apply path).

    ``qs``: K int8 (R, C) lattices; ``scales``: K f32 (R, 1) row scales.
    The row scale composes with the staleness discount into one weight
    per (row, commit), formed before the kernel as the reference does:

        agg[r, :] = sum_k (w_k * s_{k,r}) * q_k[r, :] / sum_k w_k

    The R rows form the group axis of the int8 ``tree_aggregate_groups``
    launch; the (K, R, C) stack is permuted to (R, K, C) as int8.
    Returns (flat (R*C,) f32 aggregate, combined weights (K,) f32).
    """
    q = torch.stack(list(qs))  # (K, R, C) int8
    w = _ta.staleness_weights(weights, staleness, alpha, device=q.device)  # (K,)
    s = torch.stack([x.reshape(-1) for x in scales])  # (K, R)
    g = q.permute(1, 0, 2).contiguous()  # (R, K, C) int8
    gw = (w[:, None] * s).t().contiguous()  # (R, K): staleness x row scale
    agg = tree_aggregate_groups(g, gw) / torch.clamp(w.sum(), min=1e-12)
    return agg.reshape(-1), w


def qsgd_quantize(x: torch.Tensor, rand: torch.Tensor, *, levels: int = 127):
    """(R, 256) f32 + uniforms -> (int8 (R, 256), f32 scales (R, 1))."""
    return _q.qsgd_quantize(x.contiguous(), rand.contiguous(), levels=levels)


def qsgd_quantize_residual(x: torch.Tensor, rand: torch.Tensor, *, levels: int = 127):
    """``qsgd_quantize`` that also returns the EF residual ``x - q * scale``
    (R, 256) f32, written by the same launch."""
    return _q.qsgd_quantize_residual(x.contiguous(), rand.contiguous(), levels=levels)


def qsgd_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 (R, C) x f32 (R, 1) -> f32 (R, C)."""
    return _q.qsgd_dequantize(q.contiguous(), scale.contiguous())


def apply_quantized_broadcast(w: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Fused dequantize-and-apply of a broadcast delta chain: (R, 256) f32
    held params + (D, R, 256) int8 lattice points * (D, R, 1) f32 row
    scales -> (R, 256) f32, the chain accumulated strictly in order."""
    return _bc.apply_quantized_broadcast(w.contiguous(), q.contiguous(), scale.contiguous())


def policy_update(pi, mask, cand, reward_sums, *, tau: int, alpha: float, beta: float):
    """(N, K) policies -> updated (N, K) policies: Algorithm 1, lines 5-8."""
    return _pu.policy_update(
        pi.contiguous(), mask.contiguous(), cand.contiguous(), reward_sums.contiguous(),
        tau=tau, alpha=alpha, beta=beta,
    )


def fused_update(w, g, w0, *, lr: float, mu: float = 0.0, wd: float = 0.0, donate: bool = False):
    """``w - lr * (g + mu*(w - w0) + wd*w)`` over any shape, in ``w.dtype``
    (the FedProx client update): the one-leaf case of ``fused_update_leaves``.

    ``donate=True`` writes the result into ``w`` and returns it (``w`` must
    then be contiguous and must not alias ``w0``); the default leaves
    ``w`` as it was, the reference semantics.
    """
    return fused_update_leaves([w], [g], [w0], lr=lr, mu=mu, wd=wd, donate=donate)[0]


def fused_update_leaves(ws, gs, w0s, *, lr: float, mu: float = 0.0, wd: float = 0.0,
                        donate: bool = False) -> list:
    """``fused_update`` over lists of matching leaves of any shapes, in one
    kernel call (one launch per dtype present): one local step's update.

    ``donate=True`` writes each result into its ``w`` (every ``w`` then
    contiguous, none aliasing a ``w0``); returns the updated leaves.
    """
    ws = list(ws)
    if donate and not all(w.is_contiguous() for w in ws):
        raise ValueError("donate=True updates w in place: w must be contiguous")
    flat = [w.reshape(-1) if donate else w.contiguous().reshape(-1) for w in ws]
    outs = _fu.fused_update_many(
        flat, [g.contiguous().reshape(-1) for g in gs], [a.contiguous().reshape(-1) for a in w0s],
        lr=lr, mu=mu, wd=wd, outs=flat if donate else None,
    )
    return ws if donate else [o.reshape(w.shape) for o, w in zip(outs, ws)]


def fused_update_pytree(params, grads, round_start, *, lr, mu=0.0, wd=0.0, donate=False):
    """``fused_update`` over matching dict pytrees of tensors, every leaf
    in one ``fused_update_leaves`` call."""
    new = fused_update_leaves(leaves(params), leaves(grads), leaves(round_start),
                              lr=lr, mu=mu, wd=wd, donate=donate)
    return unflatten_like(params, new)


def jain_fairness(x) -> float:
    """Jain's fairness index ``(sum x)^2 / (n * sum x^2)`` in (0, 1].

    1.0 means a perfectly even split, ``1/n`` that one party holds
    everything; an empty or all-zero vector scores 1.0.
    """
    v = np.asarray(x, np.float64)
    if v.size == 0:
        return 1.0
    q = float(np.sum(v * v))
    if q <= 0.0:
        return 1.0
    s = float(np.sum(v))
    return (s * s) / (v.size * q)
