"""Step builders: one Totoro+ FL round (train) and the serving steps.

Answers to ``repro/fl/steps.py``.  ``build_train_step`` composes
microbatch gradient accumulation (the client's local pass), a cross-zone
(``pod``) aggregation stage and the optimizer update:

- ``xla_auto`` and ``totoro_tree`` differ in the reference only in the
  parameter shardings that ``launch/specs.py`` picks; on one device both
  are the plain step: gradients, then ``opt.update``;
- ``totoro_tree_q8`` with ``num_pods > 1`` is the *podded* step: every
  state leaf has a leading ``(num_pods,)`` axis, each pod (an edge zone)
  runs its local pass on its contiguous share of the batch (the
  reference's ``podify``; its ``vmap`` over pods is a loop here), and the
  cross-zone hop is explicit: ``q8_mean_over_pods`` quantizes every pod's
  gradients to QSGD int8 and takes the mean of their dequantized values,
  which every pod then applies.

With a ``mesh`` (``launch/mesh.py``) whose ``pod`` axis has P > 1 ranks,
``totoro_tree_q8`` runs as the reference's runs on a multi-pod mesh: one
pod per rank.  Each rank holds one pod's unpodded state, its shard of the
podded state under ``train_state_specs(podded=True)``, whose leading dim
is ``P("pod", ...)``; the step takes the rank's contiguous share of the
global batch (the reference's ``podify``), runs ``grads_and_metrics`` on
it, aggregates through ``hierarchy.cross_pod_q8`` over the ``pod`` process
group, applies ``opt.update`` (leaf by leaf, in place), and returns the
pods' mean loss and aux.
Given the same inputs each rank's state is ``state[p]`` of the
single-process podded step bit for bit.  ``totoro_tree_q8`` on a mesh
whose ``data`` or ``model`` axis is larger than 1 raises
``NotImplementedError`` (ROADMAP §1, the q8 hop inside a sharded pod).

``xla_auto`` and ``totoro_tree`` on a mesh with any axis larger than 1
give the sharded step (``_sharded_step``), for every family: GQA or MLA
layers with a dense or an MoE FFN, ``first_dense`` layers or not; RWKV-6
time and channel mixing; jamba's pattern of attention and Mamba layers
with dense and MoE FFNs; and the encoder-decoder, whose stacks are GQA
self-attention, cross-attention and dense SwiGLU.  Its state and batch
are DTensors placed by ``launch/specs.build_cell``'s shardings
(``specs.place``): the
parameters FSDP over ``("pod", "data")`` and TP over ``model`` under
``xla_auto``, replicated across pods and FSDP over ``data`` under
``totoro_tree``; the batch over ``("pod", "data")``.  The forward runs on
DTensors with ``nn.constrain`` wired in where the reference calls it
(``models/nn``, ``attention``, ``moe``, ``rwkv``, ``ssm``, ``lm``,
``encdec``), so each collective is one of its redistributions: every
weight gathered over its FSDP axes where it is used (``nn.gather_fsdp``),
the attention core, the wkv and the Mamba chunk loops and the
vocab-parallel loss on each rank's shards (``local_map``), Mamba's
``in_proj`` halves made alike over ``tp`` by an all-to-all of its stored
shard, an MoE layer's tokens routed by the rank that holds their group
and moved to and from the experts over ``tp`` by all-to-alls over the
batch axes.  Each
gradient comes back under its parameter's placements
(``optim.placed_like``), and so the two aggregations' schedules differ
as the paper's do: ``totoro_tree`` reduce-scatters a weight's gradient
over ``data`` inside a zone and all-reduces it over ``pod`` across zones,
gathering nothing across pods; ``xla_auto`` gathers every weight over
``("pod", "data")`` at every use.  The update runs on the shards; the
new state keeps the old one's placements (the reference's donated in/out
shardings), the metrics come back replicated (the MoE aux loss the mean
over every group).  Against the single-process step it is fp-tight, and
routes every token alike.  With P = 1 and no other axis, a mesh gives
the plain step.

``q8_mean_over_pods`` runs through ``kernels.ops``' ``qsgd_quantize`` and
``qsgd_dequantize`` (the CUDA kernels on the card, their plain versions on
the CPU): all pods' rows of a leaf in one launch of each.  The jitted
reference forms ``scale = max|x| * fl32(1/127)`` (ROADMAP §3 rule 2),
which is the kernel's arithmetic, not ``fl/compression.qsgd_quantize``'s
eager division.  The reference passes no uniforms, so its rounding
uniforms are a constant 0.5: the podded step fills one buffer of 0.5s,
sized to its largest leaf, once, and passes row prefixes of it.

The loss and the serving steps take ``models/encdec.py`` for an
encoder-decoder config and ``models/lm.py`` otherwise, as the reference's.
The serving steps (``build_prefill_step``, ``build_decode_step``) return
the next greedy token per row, ``argmax`` of the last position's logits
(the first index on ties) as int32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import optim as optim_mod
from ..kernels import ops
from ..models import encdec, lm, nn
from ..models.nn import P
from ..pytree import leaves, tree_map, unflatten_like

ROW = 256  # values per quantized row: one f32 scale each


def _loss(cfg, params, batch):
    if cfg.is_encoder_decoder:
        return encdec.forward_train(params, cfg, batch)
    return lm.train_loss(params, cfg, batch)


# ---------------------------------------------------------------------------
# training


def _split_microbatches(batch: dict, accum: int) -> list[dict]:
    """(B, ...) -> ``accum`` microbatches of B // accum rows, *strided*:
    microbatch j holds rows j, j + accum, j + 2 accum, ... (the reference
    strides them so that each spans every (pod, data) shard).  A
    batch-sharded DTensor takes the reference's reshape, swapaxes and
    constrain, which keep each rank's rows where they are."""
    def split(x):
        assert x.shape[0] % accum == 0, (x.shape[0], accum)
        if isinstance(x, nn.DTensor):
            y = x.reshape(x.shape[0] // accum, accum, *x.shape[1:]).swapaxes(0, 1)
            return list(nn.constrain(y, (None, "dp") + (None,) * (y.ndim - 2)).unbind(0))
        return [x[j::accum] for j in range(accum)]

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[j] for k, v in parts.items()} for j in range(accum)]


def _value_and_grad(cfg, params, batch):
    """(cross-entropy, aux, gradients of the loss's total in the
    parameters' dtypes: ``lm.train_loss``'s, or ``encdec.forward_train``'s);
    the inputs are left as they were."""
    ps = tree_map(lambda t: t.detach().requires_grad_(True), params)
    total, (ce, aux) = _loss(cfg, ps, batch)
    g = torch.autograd.grad(total, leaves(ps), allow_unused=True, materialize_grads=True)
    g = [optim_mod.placed_like(x, p) for x, p in zip(g, leaves(params))]
    return ce.detach(), aux.detach(), unflatten_like(params, g)


def grads_and_metrics(cfg, plan, params, batch):
    """Gradient accumulation over ``plan.grad_accum`` microbatches: each
    microbatch's gradients widened to f32 after its backward and summed
    from zero in microbatch order, divided by ``grad_accum`` at the end.
    On DTensor parameters each gradient comes back under its parameter's
    placements (reduced over the batch axes), and so do the zero buffers."""
    accum = plan.grad_accum
    if accum == 1:
        ce, aux, g = _value_and_grad(cfg, params, batch)
        return tree_map(lambda x: x.float(), g), {"loss": ce, "aux": aux}

    gsum = tree_map(optim_mod._zeros_f32, params)
    lsum = asum = None
    for mb in _split_microbatches(batch, accum):
        ce, aux, g = _value_and_grad(cfg, params, mb)
        gsum = tree_map(lambda a, b: a + b.float(), gsum, g)
        # from zero in microbatch order (0 + ce is ce)
        lsum, asum = (ce, aux) if lsum is None else (lsum + ce, asum + aux)
        del g
    g = tree_map(lambda x: x / accum, gsum)
    return g, {"loss": lsum / accum, "aux": asum / accum}


def pod_grads(cfg, plan, params_pod, batch, num_pods: int):
    """Each pod's local pass: pod p takes rows [p B/P, (p + 1) B/P) of the
    (B, ...) batch (the reference's ``podify``) and the parameters
    ``t[p]`` of every (P, ...) leaf.  Returns the (P, ...) f32 gradients
    and the per-pod losses and auxes (lists of 0-d tensors)."""
    P = num_pods
    pods = {k: v.reshape(P, v.shape[0] // P, *v.shape[1:]) for k, v in batch.items()}
    grads_pod = tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32, device=t.device),
                         params_pod)
    losses, auxes = [], []
    for p in range(P):
        g, m = grads_and_metrics(cfg, plan, tree_map(lambda t: t[p], params_pod),
                                 {k: v[p] for k, v in pods.items()})
        tree_map(lambda buf, x: buf[p].copy_(x), grads_pod, g)
        del g
        losses.append(m["loss"])
        auxes.append(m["aux"])
    return grads_pod, losses, auxes


def pod_rows(g: torch.Tensor) -> torch.Tensor:
    """(P, ...) f32 -> (P * R, 256): each pod's leaf flattened, zero-padded
    to a multiple of 256, its R rows after the previous pod's (a view when
    no padding is needed)."""
    flat = g.reshape(g.shape[0], -1)
    pad = (-flat.shape[1]) % ROW
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, ROW)


def pod_rows_count(g: torch.Tensor) -> int:
    """The rows of ``pod_rows(g)``."""
    return g.shape[0] * -(-g[0].numel() // ROW)


def rounding_halves(grads_pod) -> torch.Tensor:
    """One (rows, 256) f32 buffer of 0.5s for the largest leaf's rows: the
    reference's rounding uniforms (it passes none)."""
    rows = max(pod_rows_count(g) for g in leaves(grads_pod))
    return torch.full((rows, ROW), 0.5, dtype=torch.float32, device=leaves(grads_pod)[0].device)


def quantize_pods(g: torch.Tensor, halves: torch.Tensor):
    """(P, ...) -> one ``qsgd_quantize`` launch over its P * R f32 rows
    (``pod_rows``) at the rounding ``halves`` gives: (int8 lattice
    (P * R, 256), f32 scales (P * R, 1)), pod p's rows after pod p - 1's."""
    x = pod_rows(g.float())
    return ops.qsgd_quantize(x, halves[: x.shape[0]])


def dequantize_mean(qs: torch.Tensor, ss: torch.Tensor, shape) -> torch.Tensor:
    """qs (P, R, 256) int8 and ss (P, R, 1) f32, the pods' rows in pod
    order: one ``qsgd_dequantize`` launch over all P * R rows, the mean
    over the pods, cut to ``shape``."""
    deq = ops.qsgd_dequantize(qs.reshape(-1, ROW), ss.reshape(-1, 1)).view(qs.shape[0], -1)
    return torch.mean(deq, dim=0)[: math.prod(shape)].view(shape)


def q8_mean_over_pods(grads_pod, halves: torch.Tensor | None = None):
    """Cross-zone compressed aggregation.

    grads_pod leaves: (P, ...) f32.  Each leaf's P pods' rows go through
    one ``qsgd_quantize`` launch (int8 per 256-wide row, one f32 scale a
    row: the wire format) and one ``qsgd_dequantize`` launch; the mean of
    the P dequantized copies comes back in the leaf's shape without the
    pod axis (``quantize_pods``, ``dequantize_mean``: ``fl/hierarchy``'s
    hop runs the same two).  ``halves``: a buffer from ``rounding_halves``
    with at least the largest leaf's rows (made here when None).
    """
    if halves is None:
        halves = rounding_halves(grads_pod)

    def agg(g):
        q, scale = quantize_pods(g, halves)
        pods = g.shape[0]
        return dequantize_mean(q.view(pods, -1, ROW), scale.view(pods, -1, 1), g.shape[1:])

    return tree_map(agg, grads_pod)


def build_train_step(cfg, plan, *, mesh=None, num_pods: int = 1):
    """Returns train_step(state, batch) -> (state, metrics).

    The plain step returns a new state and leaves the old one as it was.
    The podded step (``totoro_tree_q8``, ``num_pods > 1``) writes each
    pod's update into the state's own tensors, one pod at a time and leaf
    by leaf (``optim.update_in_place``), and returns that state (the
    reference's launcher donates the state to the step to the same end):
    the update needs one leaf's new values beside the state, not a second
    copy of it.  With a ``mesh``, ``num_pods`` is its ``pod`` axis and the
    podded step runs one pod per rank (module docstring), updating the
    rank's state the same way.
    """
    opt = optim_mod.make_optimizer(cfg)
    if mesh is not None:
        sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        inside = {a: n for a, n in sizes.items() if a != "pod" and n > 1}
        if num_pods not in (1, sizes.get("pod", 1)):
            raise ValueError(f"num_pods {num_pods} on a mesh of {sizes}")
        num_pods = sizes.get("pod", 1)
        if plan.aggregation == "totoro_tree_q8":
            if inside:
                raise NotImplementedError(
                    f"totoro_tree_q8 on a pod sharded over {inside}: ROADMAP §1, the q8 hop "
                    f"inside a sharded pod")
            if num_pods > 1:
                return _pod_per_rank_step(cfg, plan, opt, mesh, num_pods)
        elif runs_sharded(plan, mesh):
            return _sharded_step(cfg, plan, opt, mesh)
    podded = plan.aggregation == "totoro_tree_q8" and num_pods > 1

    if not podded:
        def train_step(state, batch):
            grads, metrics = grads_and_metrics(cfg, plan, state["params"], batch)
            new_params, new_opt = opt.update(grads, state["opt"], state["params"])
            return {"params": new_params, "opt": new_opt}, metrics

        return train_step

    halves = None  # the step function's one buffer of 0.5s, made at its first call

    def train_step(state, batch):
        nonlocal halves
        grads_pod, losses, auxes = pod_grads(cfg, plan, state["params"], batch, num_pods)
        if halves is None:
            halves = rounding_halves(grads_pod)
        agg = q8_mean_over_pods(grads_pod, halves)
        del grads_pod
        for p in range(num_pods):
            mine = tree_map(lambda t: t[p], state)
            optim_mod.update_in_place(opt, agg, mine["opt"], mine["params"])
        return state, {"loss": torch.mean(torch.stack(losses)),
                       "aux": torch.mean(torch.stack(auxes))}

    return train_step


def runs_sharded(plan, mesh) -> bool:
    """Whether ``build_train_step(mesh=mesh)`` gives the sharded step:
    ``xla_auto`` or ``totoro_tree`` on a mesh with an axis larger than 1."""
    return plan.aggregation != "totoro_tree_q8" and any(n > 1 for n in mesh.mesh.shape)


def _sharded_step(cfg, plan, opt, mesh):
    """The step over DTensors on ``mesh`` (module docstring): the state and
    the batch placed by ``launch/specs.build_cell``'s shardings, the
    gradients reduced to the parameters' placements, the new state under
    the old one's placements, the metrics replicated."""
    axes = nn.mesh_activation_axes(dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)))

    def train_step(state, batch):
        nn.set_activation_axes(**axes)
        grads, metrics = grads_and_metrics(cfg, plan, state["params"], batch)
        new_params, new_opt = opt.update(grads, state["opt"], state["params"])
        new = tree_map(optim_mod.placed_like, {"params": new_params, "opt": new_opt}, state)
        loss = metrics["loss"]  # replicated: the vocab-parallel loss reduces it
        # the MoE layers' sum (a dense model's zeros), kept on the mesh by lm.forward
        # (an encoder-decoder's zero, by encdec.forward_train)
        return new, {"loss": loss, "aux": nn.replicated(metrics["aux"])}

    return train_step


def _pod_per_rank_step(cfg, plan, opt, mesh, P: int):
    """The podded step with this rank as pod ``mesh.get_local_rank("pod")``
    of the mesh's P (module docstring)."""
    from . import hierarchy

    group, pod = mesh.get_group("pod"), mesh.get_local_rank("pod")
    halves = None  # the step function's one buffer of 0.5s, made at its first call

    def train_step(state, batch):
        nonlocal halves
        share = {k: v.reshape(P, v.shape[0] // P, *v.shape[1:])[pod] for k, v in batch.items()}
        grads, metrics = grads_and_metrics(cfg, plan, state["params"], share)
        if halves is None:
            halves = rounding_halves(tree_map(lambda g: g[None], grads))
        agg = hierarchy.cross_pod_q8(grads, P, group=group, halves=halves)
        del grads
        optim_mod.update_in_place(opt, agg, state["opt"], state["params"])
        return state, {k: torch.mean(hierarchy.all_gather_pods(v, group))
                       for k, v in metrics.items()}

    return train_step


def init_train_state(cfg, params, *, num_pods: int = 1, podded: bool = False):
    """{"params", "opt"}; podded: every leaf copied to a leading (num_pods,) axis."""
    opt = optim_mod.make_optimizer(cfg)
    state = {"params": params, "opt": opt.init(params)}
    if podded:
        state = tree_map(lambda x: torch.stack([x] * num_pods), state)
    return state


def train_state_specs(cfg, pspecs, pshapes, *, podded: bool = False):
    """The specs of ``init_train_state``'s tree from the parameters' specs
    and shapes; podded: every leaf's with a leading ``"pod"``."""
    opt = optim_mod.make_optimizer(cfg)
    specs = {"params": pspecs, "opt": opt.state_specs(pspecs, pshapes)}
    if podded:
        specs = tree_map(lambda s: P("pod", *s), specs)
    return specs


# ---------------------------------------------------------------------------
# serving steps


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def build_prefill_step(cfg):
    @torch.no_grad()
    def prefill_step(params, batch):
        if cfg.is_encoder_decoder:
            cache, logits = encdec.prefill(params, cfg, batch)
            return cache, _greedy(logits)
        logits, cache, _ = lm.forward(
            params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"), mode="prefill",
        )
        return cache, _greedy(logits)

    return prefill_step


def build_decode_step(cfg):
    """The step writes the token's key and value into ``cache`` in place."""
    @torch.no_grad()
    def decode_step(params, cache, token, cache_index):
        if cfg.is_encoder_decoder:
            new_cache, logits = encdec.decode_step(params, cfg, cache, token, cache_index)
        else:
            logits, new_cache, _ = lm.forward(
                params, cfg, tokens=token, mode="decode", cache=cache, cache_index=cache_index,
            )
        return new_cache, _greedy(logits)

    return decode_step
