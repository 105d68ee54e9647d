"""Parameter initialisers and primitive layers of the decoders.

Answers to ``repro/models/nn.py``, for the primitives the decoders use:
``rms_norm``, ``swiglu`` and RoPE, and ``layer_norm`` and ``group_norm``
(RWKV's per-head output norm).  Parameters are plain nested dicts of
tensors in the JAX layout (dense weights ``(in, out)``), so the JAX
package's parameters carry over through ``convert.params_from_numpy``.

Where the reference takes a PRNG key, the port takes a CPU
``torch.Generator``; ``split_keys`` derives child generators from one, so
each submodule's draws depend only on its own generator, as each JAX key
does.  The port's draws are its own: tests that compare with the JAX
package pass the reference's parameters in.

The sharding half: every ``init_*`` function of the model modules has a
``*_specs`` twin returning a tree of the same structure whose leaves are
``P`` partition specs, written with the logical placeholders ``FSDP``,
``TP`` and ``DP``; ``resolve_specs`` turns those into mesh axis names,
and ``shardings_for`` into ``torch.distributed`` DTensor placements on a
``DeviceMesh`` (``launch/mesh.py``).  ``P`` is a tuple, so a spec equals
the reference's ``PartitionSpec`` read as a tuple (a one-axis tuple part
is that axis, as JAX normalises it).  A tensor dim sharded over several
mesh axes (``("pod", "data")``) is ``Shard(d)`` on each of them; DTensor
splits in mesh-dim order, which is JAX's major-to-minor order only for a
tuple in mesh order, so ``placements`` refuses any other.

``constrain`` redistributes a DTensor and hands a plain tensor back
unchanged (the reference's is a no-op without a mesh).  The dense forward
calls it where the reference does (``swiglu`` here; the attention heads,
the residual's sequence-parallel boundaries, the embedding and the logits
in ``attention`` and ``lm``), so on DTensors placed by
``launch/specs.build_cell`` (a train step sharded over a mesh's ``pod``,
``data`` and ``model`` axes, ``fl/steps``) every collective is one of
these redistributions: DTensor's sharding propagation then finds the
layout of each op's inputs already agreed and issues none of its own.
A shard that moves from one tensor dim to another (the MoE dispatch's
groups to capacity slots and back) moves by functional all-to-alls of
its own (``_AllToAll``), the same collective on a CPU, a CUDA and a fake
mesh.
``gather_fsdp`` is the parameters' counterpart: a weight with its FSDP
shards (the batch axes) gathered and its ``tp`` split kept, the gather
XLA makes for each use of an FSDP weight; its backward reduce-scatters
the weight's gradient back over those axes.  On plain tensors every one
of these is the identity, so one code path serves one device and a mesh.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor

from ..pytree import leaves, tree_map

Params = Any  # nested dict of tensors
Specs = Any  # same-structure tree of P

# Logical axis names used inside spec trees; ``resolve_specs`` substitutes
# the concrete mesh axis names.
FSDP = "__fsdp__"
TP = "__tp__"
DP = "__dp__"


class P(tuple):
    """A partition spec: one part per tensor dim, each None (replicated), a
    mesh axis name or a tuple of them (a one-name tuple is that name)."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            (p[0] if len(p) == 1 else (p or None)) if isinstance(p, tuple) else p
            for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def resolve_specs(tree: Specs, *, multi_pod: bool) -> Specs:
    """Replace logical axis placeholders with concrete mesh axis names."""
    fsdp = ("pod", "data") if multi_pod else ("data",)
    dp = ("pod", "data") if multi_pod else ("data",)

    def fix(spec):
        out = []
        for part in spec:
            if part == FSDP:
                out.append(fsdp)
            elif part == DP:
                out.append(dp)
            elif part == TP:
                out.append("model")
            elif isinstance(part, tuple):
                sub: list = []
                for q in part:
                    if q == FSDP:
                        sub.extend(fsdp)
                    elif q == TP:
                        sub.append("model")
                    else:
                        sub.append(q)
                out.append(tuple(sub))
            else:
                out.append(part)
        return P(*out)

    return tree_map(fix, tree)


def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` its name shards, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = [Replicate() for _ in names]
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: the axes {axes} of dim {d} are not in mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


class NamedSharding(NamedTuple):
    """A spec on a mesh with its DTensor placements (the reference's
    ``jax.sharding.NamedSharding``); ``named_sharding`` makes one."""

    mesh: Any
    spec: P
    placements: tuple


def named_sharding(mesh, spec: P) -> NamedSharding:
    return NamedSharding(mesh, spec, placements(spec, mesh))


def shardings_for(tree_specs: Specs, mesh) -> Any:
    return tree_map(lambda s: named_sharding(mesh, s), tree_specs)

# the standard normal's CDF at -2 and 2, as 2 * Phi(x) - 1 = erf(x / sqrt 2)
_ERF_LO, _ERF_HI = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))


# ---------------------------------------------------------------------------
# initializers


def split_keys(gen: torch.Generator, n: int) -> list[torch.Generator]:
    """``n`` CPU generators seeded from ``gen``'s next draws."""
    seeds = torch.randint(0, 2**62, (n,), generator=gen, dtype=torch.int64, device="cpu")
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


def truncated_normal_init(gen: torch.Generator, shape, dtype, stddev: float) -> torch.Tensor:
    """``stddev`` times a standard normal truncated to [-2, 2], drawn in
    f32 on the CPU by the inverse CDF, then cast to ``dtype``.

    Under ``torch.device("meta")`` it allocates and draws nothing, which is
    how ``lm.count_params_analytic`` reads shapes.
    """
    t = torch.empty(tuple(shape), dtype=torch.float32)
    if t.is_meta:
        return t.to(dtype)
    t.uniform_(_ERF_LO, _ERF_HI, generator=gen).erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return t.mul_(stddev).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_shape, dtype) -> torch.Tensor:
    """Fan-in scaled init for a matmul with contraction dim ``in_dim``."""
    out = tuple(out_shape) if isinstance(out_shape, (tuple, list)) else (out_shape,)
    return truncated_normal_init(gen, (in_dim,) + out, dtype, 1.0 / math.sqrt(in_dim))


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype) -> torch.Tensor:
    return truncated_normal_init(gen, (vocab, dim), dtype, 1.0)


# ---------------------------------------------------------------------------
# primitive layers (pure functions over param dicts)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 RMS norm times ``1 + scale`` (scale starts at zeros), cast back."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """f32 layer norm over the last dim (biased variance), cast back."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """f32 group norm over the last dim cut into ``groups`` equal parts
    (biased variance per group), then a per-channel scale and bias."""
    dt = x.dtype
    *lead, d = x.shape
    xg = x.float().reshape(*lead, groups, d // groups)
    mu = torch.mean(xg, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xg - mu), dim=-1, keepdim=True)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (y * scale.float() + bias.float()).to(dt)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``: it misses ``jax.nn.silu``'s bits on under 1 % of
    f32 values, ``F.silu`` on far more."""
    return x * torch.sigmoid(x)


def chunk_len(cfg, S: int) -> int:
    """A recurrent layer's scan chunk: ``ssm_chunk``, or its gcd with S when
    it does not divide S (as the reference's)."""
    chunk = min(cfg.ssm_chunk, S)
    return math.gcd(S, chunk) if S % chunk else chunk


def remat(fn, *args):
    """``fn(*args)``, through ``torch.utils.checkpoint`` (non-reentrant) when
    grad mode is on: the backward recomputes ``fn`` from its inputs instead
    of keeping its intermediates, as the reference's
    ``jax.checkpoint(nothing_saveable)`` does for a scan's chunk body.  The
    arguments need not require grad (data embeddings do not): the
    parameters ``fn`` closes over get their gradients all the same.  Under
    ``no_grad`` ``fn`` runs plainly.  Inside a block that ``lm``
    checkpoints too, the two nest."""
    if torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def swiglu(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``(silu(x wg) * (x wi)) wo`` in ``x``'s dtype.  On a mesh: the
    sequence gathered (the Megatron-SP boundary), the FF dim over ``tp``
    and the batch over ``dp`` (the reference's constraints); the output is
    then a partial sum over ``tp``, which the caller reduces."""
    x = constrain(x, ("dp",) + (None,) * (x.ndim - 1))
    h = x @ gather_fsdp(wi).to(x.dtype)
    g = x @ gather_fsdp(wg).to(x.dtype)
    dims = ("dp",) + (None,) * (h.ndim - 2) + ("tp",)
    h = constrain(h, dims)
    g = constrain(g, dims)
    return (F.silu(g) * h) @ gather_fsdp(wo).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding in f32.  x: (..., seq, heads, head_dim);
    positions: broadcastable to (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (hd/2,)
    angles = positions[..., :, None, None].float() * freqs  # (..., s, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# misc


def count_params(params: Params) -> int:
    return sum(int(x.numel()) for x in leaves(params))


def cast_tree(params: Params, dtype) -> Params:
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, params)


# ---------------------------------------------------------------------------
# activation sharding hook: configured by the launcher (``launch/specs.py``);
# without it, and on a plain tensor, ``constrain`` changes nothing.

_ACT_AXES: dict[str, Any] = {"dp": None, "tp": None, "sp": None, "sizes": {}}


def set_activation_axes(dp=None, tp=None, sp=None, sizes: dict | None = None) -> None:
    """dp: batch axes; tp: tensor axis; sp: sequence-parallel axis (saved
    residuals between blocks are sharded over it, Megatron-SP style)."""
    _ACT_AXES["dp"] = dp
    _ACT_AXES["tp"] = tp
    _ACT_AXES["sp"] = sp
    _ACT_AXES["sizes"] = sizes or {}


def mesh_activation_axes(sizes: dict, *, podded: bool = False) -> dict:
    """``set_activation_axes``' arguments for a mesh of axis ``sizes``:
    batch dims over ``("pod", "data")`` where there is a ``pod`` axis
    (zones process disjoint clients, also where the parameters are
    pod-replicated), over ``data`` alone in the podded (q8) mode, whose
    pod axis is outside each pod's view; ``tp`` and ``sp`` over
    ``model``."""
    dp = ("pod", "data") if "pod" in sizes and not podded else "data"
    return dict(dp=dp, tp="model", sp="model", sizes=sizes)


def tp_axis() -> str | None:
    """The mesh axis name behind the logical ``tp`` (None without a mesh)."""
    return _ACT_AXES["tp"]


def axis_size(name: str) -> int:
    """The mesh size behind a logical axis name ("dp", "tp", "sp"): 1
    without a mesh."""
    return _axis_size(_ACT_AXES.get(name))


def _axis_size(axis) -> int:
    sizes = _ACT_AXES["sizes"]
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes.get(a, 1)
        return n
    return sizes.get(axis, 1)


def _resolve(dims, shape) -> list:
    """The mesh axes of ``dims`` (logical names, ``set_activation_axes``),
    each dropped where it does not evenly divide its dim of ``shape``."""
    axes = []
    for i, d in enumerate(dims):
        a = _ACT_AXES.get(d) if isinstance(d, str) else None
        if a is not None and _ACT_AXES["sizes"]:
            if i >= len(shape) or shape[i] % _axis_size(a) != 0:
                a = None
        axes.append(a)
    return axes


def constrain(x: torch.Tensor, dims) -> torch.Tensor:
    """dims: a tuple like ('dp', None, 'tp'), resolved through
    ``set_activation_axes``.  Axes that do not evenly divide their dim are
    dropped (batch-1 decode, a sequence shorter than the model axis).  A
    DTensor is redistributed to the resulting placements on its own mesh
    (a partial sum is reduced on the way, a mesh dim left out of ``dims``
    replicated); a plain tensor comes back unchanged, and so does a DTensor
    when every dim resolves to None (as the reference's)."""
    axes = _resolve(dims, tuple(x.shape))
    if all(a is None for a in axes) or not isinstance(x, DTensor):
        return x
    want = placements(P(*axes), x.device_mesh)
    return x if tuple(x.placements) == want else _redistribute(x, want)


def _redistribute(x: DTensor, want: tuple) -> DTensor:
    """``x.redistribute`` to ``want``, except that a shard moving from one
    tensor dim to another (``Shard(i)`` -> ``Shard(j)`` on the mesh dims
    that shard dim i, the MoE dispatch) moves by all-to-alls
    (``_AllToAll``), after the other mesh dims' slices (``Replicate`` ->
    ``Shard``, no collective) so that it carries only this rank's part.
    DTensor's own move is an all-to-all on a CUDA mesh but an all-gather
    and a slice on a CPU one; this is the same all-to-all on both, and on
    the dry-run's fake process group.  A mesh dim of one rank is relabelled
    first, with no collective (on a (data 1, model 4) mesh the MoE dispatch
    moved its groups over one rank through the host)."""
    from torch.distributed.tensor import Shard

    mesh, cur = x.device_mesh, list(x.placements)
    if any(mesh.size(m) == 1 and c != w for m, (c, w) in enumerate(zip(cur, want))):
        # a mesh dim of one rank moves nothing (DTensor's own redistribute
        # skips it too): relabelled, with no collective
        cur = [w if mesh.size(m) == 1 else c for m, (c, w) in enumerate(zip(cur, want))]
        x = DTensor.from_local(x.to_local(), mesh, cur, shape=x.shape, stride=x.stride())
        if tuple(cur) == tuple(want):
            return x
    moves = [m for m, (c, w) in enumerate(zip(cur, want))
             if isinstance(c, Shard) and isinstance(w, Shard) and c.dim != w.dim]
    src = {cur[m].dim for m in moves}
    dst = {want[m].dim for m in moves}
    nested = (len(src) == len(dst) == 1
              and moves == [m for m, c in enumerate(cur) if isinstance(c, Shard) and c.dim in src]
              and moves == [m for m, w in enumerate(want) if isinstance(w, Shard) and w.dim in dst])
    if not moves or not nested:
        return x.redistribute(mesh, want)
    sliced = [w if c.is_replicate() and isinstance(w, Shard) else c for c, w in zip(cur, want)]
    if sliced != cur:
        x = x.redistribute(mesh, sliced)
    x = _AllToAll.apply(x, tuple(moves), src.pop(), dst.pop())
    return x if tuple(x.placements) == tuple(want) else x.redistribute(mesh, want)


def _all_to_all_local(t: torch.Tensor, groups, sizes, src: int, dst: int) -> torch.Tensor:
    """One rank's part of a shard's move from tensor dim ``src`` to ``dst``
    over mesh dims of ``sizes`` (outer to inner, their process ``groups``):
    ``t``, this rank's nested shard of ``src``, cut along ``dst`` into
    prod(sizes) pieces in the same nested order, each piece sent to the
    rank it belongs to by one functional all-to-all a mesh dim, the pieces
    received joined along ``src`` in nested rank order.

    On ("pod", "data") that is two exchanges of the whole local tensor
    where one over the flattened group would do.  The nested form is kept
    because a flattened group (``DeviceMesh._flatten``) registers itself on
    the mesh, and from then on DTensor's own redistributions over those
    axes switch to it: the step's schedule would change after the first
    MoE layer had run (a traced step and the ranks' next steps disagree),
    and every family's schedule on a mesh with pods with it.  Flattening
    the batch axes when the mesh is made is ROADMAP §2's item."""
    from torch.distributed import _functional_collectives as funcol

    K, N = len(sizes), math.prod(sizes)
    nd = t.dim()
    x = t.movedim(dst, 0)
    x = x.reshape(*sizes, x.shape[0] // N, *x.shape[1:])  # the destinations' coords first
    for k in range(K):  # coord k of the destination becomes coord k of the source
        y = x.movedim(k, 0).contiguous()
        y = funcol.wait_tensor(funcol.all_to_all_single(y.flatten(), None, None, groups[k]))
        x = y.view(x.movedim(k, 0).shape).movedim(0, k)
    at = K + 1 + (src if src < dst else src - 1)  # src's axis after the coords and the piece
    x = x.movedim(at, K).flatten(0, K)  # (src whole, piece of dst, the others)
    order = [src, dst] + [i for i in range(nd) if i not in (src, dst)]
    return x.permute([order.index(i) for i in range(nd)]).contiguous()


class _AllToAll(torch.autograd.Function):
    """A DTensor's shard over mesh dims ``dims`` moved from tensor dim
    ``src`` to ``dst`` by functional all-to-alls (``_all_to_all_local``);
    the backward moves the gradient back the same way."""

    @staticmethod
    def forward(ctx, x, dims: tuple, src: int, dst: int):
        from torch.distributed.tensor import Shard

        mesh = x.device_mesh
        groups, sizes = [mesh.get_group(m) for m in dims], [mesh.size(m) for m in dims]
        pls = [Shard(dst) if m in dims else pl for m, pl in enumerate(x.placements)]
        ctx.args = (mesh, groups, sizes, src, dst, tuple(x.placements), tuple(pls), x.shape)
        local = _all_to_all_local(x.to_local(), groups, sizes, src, dst)
        return DTensor.from_local(local, mesh, pls, shape=x.shape,
                                  stride=_contiguous_stride(x.shape))

    @staticmethod
    def backward(ctx, g):
        mesh, groups, sizes, src, dst, pls_in, pls_out, shape = ctx.args
        if tuple(g.placements) != pls_out:
            g = g.redistribute(mesh, pls_out)
        local = _all_to_all_local(g.to_local(), groups, sizes, dst, src)
        return (DTensor.from_local(local, mesh, pls_in, shape=shape,
                                   stride=_contiguous_stride(shape)), None, None, None)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def per_rank(fn, *args, out, grad=None):
    """``fn(*args)`` on plain tensors.  Where an argument is a DTensor,
    ``fn`` on each rank's local shards (``local_map``): every input as it
    is placed, the outputs placed as ``out(*args)`` says and the inputs'
    gradients as ``grad(*args)`` says (by default as the inputs).  The
    two rules are called on DTensors only."""
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)), None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=out(*args),
                     in_placements=tuple(a.placements if isinstance(a, DTensor) else None
                                         for a in args),
                     in_grad_placements=grad(*args) if grad else None, device_mesh=mesh)(*args)


def split_dims(t: DTensor, dim: int) -> set:
    """The mesh dims on which DTensor ``t`` is sharded along its ``dim``."""
    from torch.distributed.tensor import Shard

    return {i for i, pl in enumerate(t.placements) if isinstance(pl, Shard) and pl.dim == dim}


def partial_on(pls, dims) -> tuple:
    """Placements ``pls`` with partial sums on the mesh dims ``dims``: the
    gradient of an input that each rank used on its own share of a split
    it does not carry."""
    from torch.distributed.tensor import Partial

    return tuple(Partial() if i in dims else pl for i, pl in enumerate(pls))


class _GradPlaced(torch.autograd.Function):
    """A DTensor as it is; its gradient redistributed to its own placements
    (a partial sum reduced) on the way back."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g if tuple(g.placements) == ctx.placements else g.redistribute(g.device_mesh,
                                                                              ctx.placements)


def grad_placed(x: torch.Tensor) -> torch.Tensor:
    """``x``; on a DTensor, its gradient reduced to ``x``'s placements before
    the op that made ``x`` sees it.  Pieces of one tensor whose gradients
    come back under different placements (a split's) then meet at one
    placement, and DTensor has no choice of schedule to make (torch 2.11
    and 2.13 chose differently)."""
    return _GradPlaced.apply(x) if isinstance(x, DTensor) else x


def channel_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in ``x``'s dtype, contracting ``x``'s last dim, the
    channels; on DTensors each rank's channels against its rows of ``w``
    (``per_rank``): a partial sum over the mesh dims that split the
    channels, ``w``'s gradient a partial sum over those that split ``x``'s
    batch."""
    def out(x, w):
        return (partial_on(x.placements, split_dims(x, x.ndim - 1)),)

    def grad(x, w):
        return (x.placements, partial_on(w.placements, split_dims(x, 0)))

    return per_rank(lambda x, w: x @ w.to(x.dtype), x, w, out=out, grad=grad)


def serving_on_a_mesh(x: torch.Tensor, mode: str) -> None:
    """A recurrent mixer's prefill or decode on a DTensor raises, before it
    reads a parameter (ROADMAP §1, serving on a sharded mesh)."""
    if isinstance(x, DTensor) and mode != "train":
        raise NotImplementedError(f"{mode} on a sharded mesh: ROADMAP §1, serving on a sharded "
                                  f"mesh")


def replicated(x: torch.Tensor) -> torch.Tensor:
    """A DTensor replicated on every mesh dim (partial sums reduced,
    shards gathered); a plain tensor unchanged."""
    if not isinstance(x, DTensor):
        return x
    want = placements(P(), x.device_mesh)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def layout(mesh, dims, shape) -> tuple:
    """The placements ``constrain(x, dims)`` gives a tensor of ``shape`` on
    ``mesh``."""
    return placements(P(*_resolve(dims, tuple(shape))), mesh)


def partial_over(pls, mesh, name: str) -> tuple:
    """Placements ``pls`` on ``mesh`` with the mesh dims of the logical axis
    ``name`` partial sums: a ``local_map`` output summed over them, or the
    gradient of an input each of their ranks used on its own rows."""
    from torch.distributed.tensor import Partial

    axis = _ACT_AXES.get(name)
    axes = axis if isinstance(axis, tuple) else (axis,)
    return tuple(Partial() if n in axes else pl for n, pl in zip(mesh.mesh_dim_names, pls))


def gather_fsdp(w: torch.Tensor) -> torch.Tensor:
    """A parameter as a layer uses it: a DTensor's shards on every mesh dim
    but the ``tp`` axis gathered (the FSDP axes: ``("pod", "data")`` under
    ``xla_auto``, ``data`` under ``totoro_tree``), its ``tp`` split kept.
    The gather's backward reduce-scatters the gradient over those axes (and
    all-reduces it over an axis the parameter is replicated on).  A plain
    tensor comes back unchanged."""
    if not isinstance(w, DTensor):
        return w
    from torch.distributed.tensor import Replicate

    tp = _ACT_AXES["tp"]
    want = tuple(pl if name == tp else Replicate()
                 for name, pl in zip(w.device_mesh.mesh_dim_names, w.placements))
    return w if tuple(w.placements) == want else w.redistribute(w.device_mesh, want)


def distribute_like(t: torch.Tensor | None, like: torch.Tensor, dims) -> torch.Tensor | None:
    """``t``, a tensor every rank holds whole (a mask, positions), placed on
    ``like``'s mesh by ``dims`` as ``constrain`` resolves them, each rank
    keeping its own slice (no collective); ``t`` itself when ``like`` is a
    plain tensor or ``t`` is None."""
    if t is None or not isinstance(like, DTensor):
        return t
    from torch.distributed.tensor import distribute_tensor

    mesh = like.device_mesh
    return distribute_tensor(t, mesh, placements(P(*_resolve(dims, tuple(t.shape))), mesh),
                             src_data_rank=None)
