"""Mixture-of-Experts: GShard-style dense dispatch with token dropping.

Answers to ``repro/models/moe.py``: tokens are cut into groups of
``moe_group_size``; each group routes its tokens to their top-k experts
through one-hot (G, T, E, C) dispatch and combine tensors, each expert
taking at most C tokens a group (the rest are dropped); the experts run
as batched products over their (E, C·G, d) inputs; a Switch load-balance
loss comes back beside the output; optional shared experts (deepseek-v2)
run on every token through ``nn.swiglu``.  The router is f32 in every
config (its logits are ``x.float() @ router``); dispatch and combine are
cast to the activations' dtype where the reference casts them.

Parity points with the reference (ROADMAP §3, rules 11 and 12):

- ``jax.lax.top_k`` puts the lower index first among equal values, and
  equal gates are real (a zero token or a zero router row gives a uniform
  softmax); ``torch.topk`` does not promise any order on ties.  The port
  takes the first k of a stable descending ``torch.sort``, which keeps
  equal values in index order;
- the reference drops an overflowing token by ``one_hot(capacity,
  capacity)``, an all-zero row in JAX; ``torch.nn.functional.one_hot``
  raises on it.  The port compares the position with ``arange(C)``,
  which is the same one-hot, zero past the range.

The k passes run in the reference's order, each pass's positions
continuing from the counts of the passes before it, so the same tokens
are dropped.  Nothing here adds with atomics (no ``index_add_`` or
``scatter_add_``): remat recomputes the routing in the backward and must
route the same way.

On a mesh (a DTensor input, the sharded train step of ``fl/steps``)
``moe_forward`` runs the reference's constraints: the groups over
``dp``, each rank routing its own (``route`` through ``nn.per_rank``; the aux
loss the mean over every group), the experts over ``tp``, the expert
tokens over ``dp`` by an all-to-all (``nn.constrain``'s ``_AllToAll``) and
back, and the combine a partial sum over ``tp``.

``moe_specs`` is the sharding twin of ``init_moe``: the expert stacks
sharded over ``model`` by expert and over the FSDP axes by their input or
output width, the router replicated.
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from . import nn
from .nn import FSDP, TP, P, dense_init


def init_moe(gen: torch.Generator, cfg) -> nn.Params:
    d, E, ff = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff
    ks = nn.split_keys(gen, 5)
    dt = cfg.pdtype
    p = {
        "router": dense_init(ks[0], d, (E,), torch.float32),
        "wi": _expert_init(ks[1], E, d, ff, dt),
        "wg": _expert_init(ks[2], E, d, ff, dt),
        "wo": _expert_init(ks[3], E, ff, d, dt),
    }
    if cfg.moe_num_shared:
        sff = cfg.moe_num_shared * ff
        kk = nn.split_keys(ks[4], 3)
        p["shared"] = {
            "wi": dense_init(kk[0], d, (sff,), dt),
            "wg": dense_init(kk[1], d, (sff,), dt),
            "wo": dense_init(kk[2], sff, (d,), dt),
        }
    return p


def moe_specs(cfg) -> nn.Specs:
    s = {
        "router": P(None, None),
        "wi": P(TP, FSDP, None),
        "wg": P(TP, FSDP, None),
        "wo": P(TP, None, FSDP),
    }
    if cfg.moe_num_shared:
        s["shared"] = {"wi": P(FSDP, TP), "wg": P(FSDP, TP), "wo": P(TP, FSDP)}
    return s


def _expert_init(gen: torch.Generator, E: int, din: int, dout: int, dt) -> torch.Tensor:
    return nn.truncated_normal_init(gen, (E, din, dout), dt, 1.0 / math.sqrt(din))


def _capacity(cfg, tokens_per_group: int) -> int:
    c = int(cfg.moe_top_k * tokens_per_group * cfg.capacity_factor / cfg.moe_num_experts)
    return max(8, (c + 7) // 8 * 8)


def top_k(gates: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values, the
    lower index first among equal ones."""
    w, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return w[..., :k], idx[..., :k]


def _route(gates: torch.Tensor, k: int, capacity: int):
    """``route`` with the load-balance loss's per-group terms, (G,)
    ``sum_e(frac_tokens_e * mean_prob_e)``, in place of ``E`` times their
    mean: each group routes on its own, so a rank holding some of the
    groups routes them alone (``moe_forward`` on a mesh)."""
    G, T, E = gates.shape
    w, idx = top_k(gates, k)  # (G, T, k)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)

    # aux load-balance loss (Switch): E * mean_e(frac_tokens_e * mean_prob_e)
    me = torch.mean(gates, dim=1)  # (G, E)
    ce = torch.mean(F.one_hot(idx[..., 0], E).to(gates.dtype), dim=1)  # (G, E)
    balance = torch.sum(me * ce, dim=-1)  # (G,)

    slots = torch.arange(capacity, device=gates.device)
    dispatch = torch.zeros((G, T, E, capacity), dtype=gates.dtype, device=gates.device)
    combine = torch.zeros((G, T, E, capacity), dtype=gates.dtype, device=gates.device)
    counts = torch.zeros((G, E), dtype=torch.int64, device=gates.device)
    for j in range(k):
        onehot = F.one_hot(idx[..., j], E)  # (G, T, E) int64
        pos = torch.cumsum(onehot, dim=1) - 1 + counts[:, None, :]
        keep = (pos < capacity) & (onehot > 0)
        counts = counts + torch.sum(onehot, dim=1)
        # one_hot(where(keep, pos, C), C): a position of C is a zero row
        d_j = (torch.where(keep, pos, capacity)[..., None] == slots).to(gates.dtype)
        dispatch = dispatch + d_j
        combine = combine + d_j * w[..., j][..., None, None]
    return dispatch, combine, balance


def route(gates: torch.Tensor, k: int, capacity: int):
    """gates: (G, T, E) probabilities.  Returns (dispatch, combine, aux_loss).

    dispatch/combine: (G, T, E, C) in the gates' dtype.  GShard-style
    cumulative-position routing with per-group capacity and token dropping.
    On DTensor gates (groups over ``dp``) each rank routes its own groups
    (``nn.per_rank``) and the aux loss is ``E`` times the mean of every
    group's term, gathered: the mean over all G groups, replicated.
    """
    dispatch, combine, balance = nn.per_rank(
        partial(_route, k=k, capacity=capacity), gates,
        out=lambda g: (g.placements, g.placements, nn.layout(g.device_mesh, ("dp",), g.shape[:1])))
    return dispatch, combine, gates.shape[-1] * torch.mean(nn.replicated(balance))


def _dispatch_tokens(dispatch: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    """(G, T, E, C) x (G, T, d) -> (E, C, G, d) expert inputs.  On a mesh
    each rank's groups and experts (``nn.per_rank``: DTensor's sharding
    search over this einsum takes minutes on a 3-D mesh): the output
    sharded as the dispatch's g (dim 0) and e (dim 2), and the tokens'
    gradient a partial sum over the mesh dims that split the experts."""
    def out(d, x):
        to_out = {0: Shard(2), 2: Shard(0)}
        return (tuple(to_out[pl.dim] if isinstance(pl, Shard) else Replicate()
                      for pl in d.placements),)

    def grad(d, x):
        return (d.placements, tuple(Partial() if isinstance(dp, Shard) and dp.dim == 2 else pl
                                    for dp, pl in zip(d.placements, x.placements)))

    return nn.per_rank(partial(torch.einsum, "gtec,gtd->ecgd"), dispatch, xg, out=out, grad=grad)


def _combine_tokens(combine: torch.Tensor, expert_out: torch.Tensor) -> torch.Tensor:
    """(G, T, E, C) x (E, C, G, d) -> (G, T, d).  On a mesh each rank's
    groups and experts (``nn.per_rank``): the output sharded as the
    combine's g and a partial sum over the mesh dims that split the
    experts."""
    def out(c, e):
        return (tuple(Shard(0) if isinstance(pl, Shard) and pl.dim == 0
                      else Partial() if isinstance(pl, Shard) else Replicate()
                      for pl in c.placements),)

    return nn.per_rank(partial(torch.einsum, "gtec,ecgd->gtd"), combine, expert_out, out=out)


def moe_forward(p, cfg, x: torch.Tensor):
    """x: (B, S, d) -> (out, aux_loss).

    On a mesh (a DTensor ``x``): the sequence gathered and the groups over
    ``dp``, each rank routing its own; each rank's experts (``tp``) take
    their dispatch slice; one all-to-all over ``dp`` moves the expert
    inputs from groups to capacity slots, (E, C, G, d) constrained to
    ``("tp", "dp", None, None)`` before the flatten, as the reference's
    (E, C·G, d) under ``("tp", "dp", None)`` (C the outer dim); the expert
    stacks gathered over their FSDP axes; a second all-to-all brings the
    outputs back to groups for the combine, whose output is a partial sum
    over ``tp`` for the caller to reduce, as the dense FFN's.  Where ``dp``
    does not divide C (jamba's 80 slots on 2x16x16's 32 ranks), the slots
    cannot be split over ``dp`` and unsplit after the experts: each rank
    keeps its own groups' tokens, flattened (E, G·C, d) with G the outer
    dim, and no all-to-all moves them (the expert products are row by row,
    so the values are the same)."""
    B, S, d = x.shape
    T_all = B * S
    gsz = min(cfg.moe_group_size, T_all)
    G = T_all // gsz
    assert G * gsz == T_all, (B, S, gsz)
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    C = _capacity(cfg, gsz)

    x = nn.constrain(x, ("dp", None, None))  # Megatron-SP: the sequence gathered
    if G % nn.axis_size("dp"):  # fewer groups than dp ranks: every rank routes them all
        x = nn.replicated(x)
    xg = nn.constrain(x.reshape(G, gsz, d), ("dp", None, None))
    logits = torch.einsum("gtd,de->gte", xg.float(), p["router"])
    gates = torch.softmax(logits, dim=-1)
    dispatch, combine, aux = route(gates, k, C)
    experts = ("dp", None, "tp", None)  # each rank's experts of its groups
    dispatch = nn.constrain(dispatch.to(x.dtype), experts)

    expert_in = _dispatch_tokens(dispatch, xg)
    slots_over_dp = C % nn.axis_size("dp") == 0

    def tokens(t):  # the reference's constraint on (E, C·G, ...), where the slots split
        return nn.constrain(t, ("tp", "dp", None)) if slots_over_dp else t

    if slots_over_dp:  # EP x DP: experts over tp, expert tokens over dp (the all-to-all)
        expert_in = nn.constrain(expert_in, ("tp", "dp", None, None)).reshape(E, C * G, d)
    else:  # each rank's own groups, G the outer dim
        expert_in = expert_in.transpose(1, 2).reshape(E, G * C, d)
    h = tokens(torch.bmm(expert_in, nn.gather_fsdp(p["wi"]).to(x.dtype)))
    g = tokens(torch.bmm(expert_in, nn.gather_fsdp(p["wg"]).to(x.dtype)))
    h = F.silu(g) * h
    expert_out = tokens(torch.bmm(h, nn.gather_fsdp(p["wo"]).to(x.dtype)))
    expert_out = (expert_out.reshape(E, C, G, d) if slots_over_dp
                  else expert_out.reshape(E, G, C, d).transpose(1, 2))
    expert_out = nn.constrain(expert_out, ("tp", None, "dp", None))  # back to groups
    combine = nn.constrain(combine.to(x.dtype), experts)
    # on a mesh a partial sum over tp (each rank's experts), for the caller to reduce
    out = _combine_tokens(combine, expert_out).reshape(B, S, d)

    if cfg.moe_num_shared:
        s = p["shared"]
        out = out + nn.swiglu(x, s["wi"], s["wg"], s["wo"])
    return out, aux
