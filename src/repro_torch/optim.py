"""Optimizers: sgd/momentum, adamw (+f32 master), adafactor (factored).

Answers to ``repro/optim.py`` in its pure-function style, on pytrees of
tensors (``repro_torch.pytree``): ``opt.init(params) -> state``;
``opt.update(grads, state, params) -> (new_params, new_state)``.  Each
update returns new tensors and leaves its inputs as they were.

``state["step"]`` is an int32 0-d tensor, as JAX's is, so a checkpoint's
manifest records the reference's dtype.  adamw keeps f32 master weights
and f32 (m, v): parameters may be stored in bf16 for compute; the update
happens on the master and the bf16 copy is re-derived.  adafactor keeps
factored second moments (row and column) for the largest two dims of
each leaf of at least two dims.

Arithmetic follows the reference's expression by expression, in f32 with
Python scalars rounded to f32 (as JAX's weak types are).  XLA may fuse
or contract some of them (``b1 * m + (1 - b1) * g``) where eager
PyTorch rounds each step, and the bias correction ``b1 ** step`` is an
f32 ``pow`` whose last bit may differ between libms: the port agrees
with the JAX package to rtol 1e-6 (``tests/test_torch_optim.py``), not
bit for bit.  ``opt.state_specs(pspecs, pshapes)`` gives the state's
sharding specs (``models.nn.P``) from the parameters' specs and shapes
(anything with ``.shape``, meta tensors in ``launch/specs.py``): the
moments take their parameter's spec, the step is replicated, and
adafactor's factored ``vr`` / ``vc`` drop the factored axis.
``update_in_place`` runs ``opt.update`` one leaf at a time into the
state's own tensors (the update of ``fl/steps``' podded steps).

On DTensor leaves (``fl/steps``' sharded step) the same expressions run
on each rank's shards: the moments, the master weights and the step take
their parameter's placements (``opt.init`` makes them so, the step
replicated), and adafactor's means over a sharded dim reduce over its
mesh axis, as the reference's jitted update does under its shardings.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from .models.nn import P
from .pytree import leaves, tree_map, unflatten_like


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]
    state_specs: Callable[[Any, Any], Any]


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    if isinstance(p, DTensor):  # on the parameter's mesh, under its placements
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params) -> torch.Tensor:
    """The int32 0-d step: a DTensor replicated on the parameters' mesh
    when they are DTensors."""
    p = leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=p.device)
    if isinstance(p, DTensor):
        from torch.distributed.tensor import Replicate, distribute_tensor

        mesh = p.device_mesh
        return distribute_tensor(step, mesh, [Replicate()] * mesh.ndim, src_data_rank=None)
    return step


# ---------------------------------------------------------------------------
# SGD (+momentum)


def sgd(lr: float, momentum: float = 0.0, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        st: dict = {"step": _step0(params)}
        if momentum:
            st["mu"] = tree_map(_zeros_f32, params)
        return st

    def update(grads, state, params):
        step = state["step"] + 1
        if momentum:
            mu = tree_map(
                lambda m, g, p: momentum * m + g.float() + weight_decay * p.float(),
                state["mu"], grads, params,
            )
            newp = tree_map(lambda p, m: (p.float() - lr * m).to(p.dtype), params, mu)
            return newp, {"step": step, "mu": mu}
        newp = tree_map(
            lambda p, g: (p.float() - lr * (g.float() + weight_decay * p.float())).to(p.dtype),
            params, grads,
        )
        return newp, {"step": step}

    def state_specs(pspecs, pshapes):
        st = {"step": P()}
        if momentum:
            st["mu"] = pspecs
        return st

    return Optimizer(init, update, state_specs)


# ---------------------------------------------------------------------------
# AdamW with f32 master weights


def adamw(
    lr: float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    keep_master: bool = True,
) -> Optimizer:
    def init(params):
        st = {
            "step": _step0(params),
            "m": tree_map(_zeros_f32, params),
            "v": tree_map(_zeros_f32, params),
        }
        if keep_master:  # a copy, also where the params are f32 already
            st["master"] = tree_map(lambda p: p.to(torch.float32, copy=True), params)
        return st

    def update(grads, state, params):
        step = state["step"] + 1
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()

        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()), state["v"], grads)
        base = state["master"] if keep_master else tree_map(lambda p: p.float(), params)
        new_master = tree_map(
            lambda b, mm, vv: b - lr * (mm / c1 / (torch.sqrt(vv / c2) + eps) + weight_decay * b),
            base, m, v,
        )
        newp = tree_map(lambda p, b: b.to(p.dtype), params, new_master)
        newst = {"step": step, "m": m, "v": v}
        if keep_master:
            newst["master"] = new_master
        return newp, newst

    def state_specs(pspecs, pshapes):
        st = {"step": P(), "m": pspecs, "v": pspecs}
        if keep_master:
            st["master"] = pspecs
        return st

    return Optimizer(init, update, state_specs)


# ---------------------------------------------------------------------------
# Adafactor


def _factored_dims(shape, min_size):
    if len(shape) < 2:
        return None
    dims = sorted(range(len(shape)), key=lambda i: shape[i])[-2:]
    r, c = sorted(dims)
    if shape[r] < min_size or shape[c] < min_size:
        return None
    return r, c


def adafactor(
    lr: float = 1e-2,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
    min_dim_size_to_factor: int = 128,
) -> Optimizer:
    def init(params):
        def per_param(p):
            f = _factored_dims(tuple(p.shape), min_dim_size_to_factor)
            if f is None:
                return {"v": _zeros_f32(p)}
            r, c = f
            shape = tuple(p.shape)
            vr = torch.zeros(shape[:c] + shape[c + 1:], dtype=torch.float32, device=p.device)
            vc = torch.zeros(shape[:r] + shape[r + 1:], dtype=torch.float32, device=p.device)
            if isinstance(p, DTensor):
                vr, vc = _without_dim(vr, p, c), _without_dim(vc, p, r)
            return {"vr": vr, "vc": vc}

        return {"step": _step0(params), "v": tree_map(per_param, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        beta = 1.0 - step.float() ** (-decay)

        def upd(p, g, v):
            g = g.float()
            f = _factored_dims(tuple(p.shape), min_dim_size_to_factor)
            g2 = torch.square(g) + eps
            if f is None:
                vn = beta * v["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(torch.clamp_min(vn, eps))
                v_new = {"v": vn}
            else:
                r, c = f  # r < c
                vr = beta * v["vr"] + (1 - beta) * placed_like(torch.mean(g2, dim=c), v["vr"])
                vc = beta * v["vc"] + (1 - beta) * placed_like(torch.mean(g2, dim=r), v["vc"])
                v_new = {"vr": vr, "vc": vc}
                red = torch.mean(vr, dim=r, keepdim=True)  # vr still has axis r at index r
                vr_n = vr / torch.clamp_min(red, eps)
                vhat = vr_n.unsqueeze(c) * vc.unsqueeze(r)
                u = g * torch.rsqrt(torch.clamp_min(vhat, eps))
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            p32 = p.float()
            if weight_decay:
                u = u + weight_decay * p32
            return (p32 - lr * u).to(p.dtype), v_new

        # state["v"] holds a dict per leaf, so walk the params' leaves
        out = [upd(p, g, v) for p, g, v in zip(leaves(params), leaves(grads),
                                               _per_leaf(state["v"], params))]
        newp = unflatten_like(params, [o[0] for o in out])
        newv = unflatten_like(params, [o[1] for o in out])
        return newp, {"step": step, "v": newv}

    def state_specs(pspecs, pshapes):
        def per_param(spec, shp):
            f = _factored_dims(tuple(shp.shape), min_dim_size_to_factor)
            parts = list(spec) + [None] * (len(shp.shape) - len(spec))
            if f is None:
                return {"v": P(*parts)}
            r, c = f
            return {
                "vr": P(*(x for i, x in enumerate(parts) if i != c)),
                "vc": P(*(x for i, x in enumerate(parts) if i != r)),
            }

        return {"step": P(), "v": tree_map(per_param, pspecs, pshapes)}

    return Optimizer(init, update, state_specs)


def placed_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A DTensor ``t`` redistributed to ``like``'s placements (partial sums
    or means reduced over the mesh axes ``like`` is replicated on);
    anything else as it is."""
    if isinstance(t, DTensor) and tuple(t.placements) != tuple(like.placements):
        return t.redistribute(like.device_mesh, like.placements)
    return t


def _without_dim(t: torch.Tensor, p: DTensor, dim: int) -> DTensor:
    """``t``, a factored moment of ``p`` without ``p``'s dim ``dim``, placed
    as ``state_specs`` places it: ``p``'s placements with that dim's shard
    replicated and the later dims' shifted down."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    pls = [Replicate() if isinstance(pl, Shard) and pl.dim == dim
           else Shard(pl.dim - 1) if isinstance(pl, Shard) and pl.dim > dim else pl
           for pl in p.placements]
    return distribute_tensor(t, p.device_mesh, pls, src_data_rank=None)


def _per_leaf(tree, like) -> list:
    """The subtrees of ``tree`` at ``like``'s leaf positions, in leaf order."""
    out = []
    tree_map(lambda _, sub: out.append(sub), like, tree)
    return out


def update_in_place(opt: Optimizer, grads, state, params) -> None:
    """``opt.update`` one parameter leaf at a time, each leaf's new values
    copied into ``params``' and ``state``'s own tensors (``state["step"]``
    too, at the end): the same arithmetic, since every optimizer here maps
    leaf by leaf around one shared step count, while a second copy of the
    whole state never exists, only one leaf's new values.  ``params`` and
    ``state`` may be views into larger tensors (one pod's of a podded
    state)."""
    keys = [k for k in state if k != "step"]
    per = {k: _per_leaf(state[k], params) for k in keys}
    step = state["step"]
    for i, (p, g) in enumerate(zip(leaves(params), leaves(grads))):
        new_p, new_st = opt.update(g, {"step": state["step"], **{k: per[k][i] for k in keys}}, p)
        p.copy_(new_p)
        for k in keys:
            tree_map(lambda dst, src: dst.copy_(src), per[k][i], new_st[k])
        step = new_st["step"]
    state["step"].copy_(step)


def make_optimizer(cfg) -> Optimizer:
    if cfg.optimizer == "adamw":
        return adamw(cfg.learning_rate, weight_decay=cfg.weight_decay)
    if cfg.optimizer == "adafactor":
        return adafactor(lr=cfg.learning_rate, weight_decay=cfg.weight_decay)
    if cfg.optimizer == "sgd":
        return sgd(cfg.learning_rate, momentum=0.9, weight_decay=cfg.weight_decay)
    raise ValueError(cfg.optimizer)
