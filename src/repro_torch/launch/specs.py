"""Step inputs and their sharding for every (arch x shape x mesh) cell.

Answers to ``repro/launch/specs.py``.  ``build_cell`` returns meta-tensor
stand-ins for every input of a cell's step (``torch.device("meta")``: the
shapes and dtypes, no memory and no draws, as ``jax.eval_shape``; a 398B
config touches no host memory), the partition-spec trees (``models.nn.P``)
resolved to the mesh's axes and fitted to the shapes, and the DTensor
placements of each leaf (``nn.shardings_for``: ``nn.NamedSharding``s);
``cell_for`` does the same for a config, shape and plan in hand, and
``place`` puts a state or a batch on a mesh under those shardings (the
inputs of ``fl/steps``' sharded step).  ``lower_cell`` runs a train
cell's sharded step once on fake tensors and counts one rank's FLOPs,
bytes, collectives and memory (``launch/hlo.StepCounter``); the dry-run
tools read it (``dryrun.py``, ``sweep.py``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple

import torch

from .. import configs
from ..config import SHAPES, ModelConfig, RunPlan, ShapeSpec
from ..fl import steps as steps_mod
from ..models import encdec, lm, nn
from ..models.nn import P
from ..pytree import tree_map
from . import mesh as mesh_mod


def fit_spec(spec: P, shape: tuple[int, ...], sizes: dict[str, int]) -> P:
    """Drop mesh axes from dims they don't divide (e.g. batch=1 decode)."""
    out = []
    for i, part in enumerate(spec):
        if part is None:
            out.append(None)
            continue
        axes = part if isinstance(part, tuple) else (part,)
        total = 1
        for a in axes:
            total *= sizes.get(a, 1)
        if i < len(shape) and shape[i] % total == 0:
            out.append(part)
        else:
            out.append(None)
    return P(*out)


def fit_specs_tree(specs, shapes, sizes):
    return tree_map(lambda s, x: fit_spec(s, tuple(x.shape), sizes), specs, shapes)


class Cell(NamedTuple):
    """Everything needed to run or lower one (arch x shape x mesh) cell."""

    cfg: ModelConfig
    shape: ShapeSpec
    plan: RunPlan
    step_fn: Any
    args: tuple  # meta-tensor trees
    in_shardings: tuple  # nn.NamedSharding trees
    out_shardings: Any
    donate_argnums: tuple


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_specs(cfg: ModelConfig, spec: ShapeSpec, *, with_labels: bool) -> tuple[dict, dict]:
    B, S = spec.global_batch, spec.seq_len
    batch, bspecs = {}, {}
    dp = nn.DP
    if cfg.is_encoder_decoder:
        batch["embeds"] = _sds((B, S, cfg.d_model), cfg.adtype)  # frontend stub
        bspecs["embeds"] = P(dp, None, None)
        batch["tokens"] = _sds((B, S), torch.int32)
        bspecs["tokens"] = P(dp, None)
    elif cfg.embed_inputs and spec.kind in ("train", "prefill"):
        batch["embeds"] = _sds((B, S, cfg.d_model), cfg.adtype)  # patch embeds stub
        bspecs["embeds"] = P(dp, None, None)
    else:
        batch["tokens"] = _sds((B, S), torch.int32)
        bspecs["tokens"] = P(dp, None)
    if with_labels:
        batch["labels"] = _sds((B, S), torch.int32)
        bspecs["labels"] = P(dp, None)
    return batch, bspecs


def resolve(tree, *, multi_pod: bool, pod_replicated: bool):
    """Resolve logical placeholders; pod_replicated forces fsdp=('data',)."""
    return nn.resolve_specs(tree, multi_pod=multi_pod and not pod_replicated)


def build_cell(arch: str, shape_name: str, mesh, *, aggregation: str | None = None,
               cfg_overrides: dict | None = None, grad_accum: int | None = None) -> Cell:
    cfg = configs.get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    spec = SHAPES[shape_name]
    plan = configs.get_plan(arch, shape_name)
    if aggregation is not None:
        plan = dataclasses.replace(plan, aggregation=aggregation)
    if grad_accum is not None:
        plan = dataclasses.replace(plan, grad_accum=grad_accum)
    return cell_for(cfg, spec, plan, mesh)


def cell_for(cfg: ModelConfig, spec: ShapeSpec, plan: RunPlan, mesh) -> Cell:
    """``build_cell`` of a config, shape and plan in hand (a reduced config,
    ``launch/train``'s batch and sequence)."""
    sizes = mesh_mod.mesh_axis_sizes(mesh)
    multi_pod = "pod" in sizes
    npods = sizes.get("pod", 1)
    # Totoro tree mode: params replicated across pods (zone replicas)
    pod_replicated = plan.aggregation.startswith("totoro_tree") and multi_pod and spec.kind == "train"

    def rs(tree):
        """Param/state resolution (pod-replicated in totoro_tree mode)."""
        return resolve(tree, multi_pod=multi_pod, pod_replicated=pod_replicated)

    def rs_batch(tree):
        """Batch/cache resolution: always sharded across pods when present."""
        return resolve(tree, multi_pod=multi_pod, pod_replicated=False)

    def shardings(tree):
        return nn.shardings_for(tree, mesh)

    replicated = nn.named_sharding(mesh, P())

    # activation sharding axes for ``nn.constrain``.  Batch dims are sharded
    # over ('pod', 'data') even when params are pod-replicated (zones process
    # disjoint clients); in the podded (q8) mode the pod dim is outside each
    # pod's view, so 'data' only.
    podded_mode = plan.aggregation == "totoro_tree_q8" and multi_pod and spec.kind == "train"
    nn.set_activation_axes(**nn.mesh_activation_axes(sizes, podded=podded_mode))

    model = encdec if cfg.is_encoder_decoder else lm
    with torch.device("meta"):
        params_shapes = model.init_params(torch.Generator(), cfg, device="meta")
    pspecs = fit_specs_tree(rs(model.param_specs(cfg)), params_shapes, sizes)

    if spec.kind == "train":
        podded = plan.aggregation == "totoro_tree_q8" and multi_pod
        with torch.device("meta"):
            state_shapes = steps_mod.init_train_state(cfg, params_shapes, num_pods=npods,
                                                      podded=podded)
        sspecs = steps_mod.train_state_specs(cfg, pspecs, params_shapes, podded=podded)
        sspecs = fit_specs_tree(sspecs, state_shapes, sizes)
        batch, bspecs = _batch_specs(cfg, spec, with_labels=True)
        bspecs = fit_specs_tree(rs_batch(bspecs), batch, sizes)
        step = steps_mod.build_train_step(cfg, plan, num_pods=npods)
        in_sh = (shardings(sspecs), shardings(bspecs))
        out_sh = (in_sh[0], replicated)
        return Cell(cfg, spec, plan, step, (state_shapes, batch), in_sh, out_sh, (0,))

    B, S = spec.global_batch, spec.seq_len
    if cfg.is_encoder_decoder:
        cache_shp, cache_specs = encdec.cache_shapes(cfg, B, S, S), encdec.cache_specs(cfg)
    else:
        cache_shp, cache_specs = lm.cache_shapes(cfg, B, S), lm.cache_specs(cfg)
    cache_specs = fit_specs_tree(rs_batch(cache_specs), cache_shp, sizes)

    if spec.kind == "prefill":
        batch, bspecs = _batch_specs(cfg, spec, with_labels=False)
        bspecs = fit_specs_tree(rs_batch(bspecs), batch, sizes)
        step = steps_mod.build_prefill_step(cfg)
        in_sh = (shardings(pspecs), shardings(bspecs))
        out_sh = (shardings(cache_specs), replicated)
        return Cell(cfg, spec, plan, step, (params_shapes, batch), in_sh, out_sh, ())

    assert spec.kind == "decode"
    token = _sds((B, 1), torch.int32)
    dp_part = ("pod", "data") if multi_pod else ("data",)
    tok_sh = nn.named_sharding(mesh, fit_spec(P(dp_part, None), token.shape, sizes))
    idx = _sds((), torch.int32)
    step = steps_mod.build_decode_step(cfg)
    cache_sh = shardings(cache_specs)
    in_sh = (shardings(pspecs), cache_sh, tok_sh, replicated)
    out_sh = (cache_sh, nn.named_sharding(mesh, fit_spec(P(dp_part), (B,), sizes)))
    return Cell(cfg, spec, plan, step, (params_shapes, cache_shp, token, idx), in_sh, out_sh, (1,))


def place(tree, shardings):
    """Each leaf of ``tree`` as a DTensor under its ``nn.NamedSharding``
    of ``shardings`` (a tree of the same structure, a ``Cell``'s
    ``in_shardings[i]``).  A plain tensor, which every rank holds whole and
    alike (parameters drawn from one seed, a global batch), is cut into
    this rank's shard with no collective (``distribute_tensor`` with
    ``src_data_rank=None``); a DTensor is redistributed where its
    placements differ."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(t, sh):
        if isinstance(t, DTensor):
            if tuple(t.placements) == tuple(sh.placements):
                return t
            return t.redistribute(sh.mesh, sh.placements)
        return distribute_tensor(t, sh.mesh, sh.placements, src_data_rank=None)

    return tree_map(one, tree, shardings)


def lower_cell(cell: Cell, mesh) -> dict:
    """The reference's ``lower_cell`` and ``compile`` in one: the cell's
    step (``steps.build_train_step(cfg, plan, mesh=mesh)``; ``Cell.step_fn``
    stays the plain step) run once under ``FakeTensorMode`` on fake CPU
    tensors of ``cell.args``' shapes and dtypes, put on ``mesh`` by
    ``place`` under the cell's ``in_shardings`` (no tensor memory: a 398B
    config touches no host memory), counted by ``hlo.StepCounter``.  The
    outputs' placements must be ``out_shardings``'.  Returns
    ``{"stats": hlo.ModuleStats, "calls": CollectiveLog's calls,
    "memory": {...}, "trace_s": s}``, every number rank ``mesh``'s own.

    Memory a device, in bytes: ``argument`` the distinct local storages of
    the placed state and batch; ``output`` those of the returned state and
    metrics; ``peak`` the most bytes of live local storages over the run,
    the arguments included; ``temp`` = peak - argument - output.  The step
    returns a new state rather than writing into a donated one, so
    ``alias`` is 0 and the peak is measured, not summed from the others.

    Serving cells raise ``NotImplementedError`` (ROADMAP §1, serving on a
    sharded mesh), as the step builder does for ``totoro_tree_q8`` inside a
    sharded pod."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor

    from . import hlo

    if cell.shape.kind != "train":
        raise NotImplementedError(f"{cell.shape.name} ({cell.shape.kind}) on a mesh: ROADMAP §1, "
                                  f"serving on a sharded mesh")
    step = steps_mod.build_train_step(cell.cfg, cell.plan, mesh=mesh)
    # a mesh of an earlier process group (an earlier cell's fake one)
    # compares equal to ``mesh`` (DeviceMesh equality ignores its groups), so
    # DTensor's sharding caches would hand back specs on its groups, gone
    # with that process group (the C++ fast path's cache where torch has one)
    DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding.cache.cache_clear()
    getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", lambda: None)()
    counter = hlo.StepCounter(mesh)
    with FakeTensorMode():
        args = tuple(place(tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), a), sh)
                     for a, sh in zip(cell.args, cell.in_shardings))
        argument = counter.track(args)
        t0 = time.perf_counter()
        with counter:
            out = step(*args)
        trace_s = time.perf_counter() - t0
        output = counter.storage_bytes(out)
        peak = counter.peak_bytes
        state_sh, metric_sh = cell.out_shardings
        got = [tree_map(lambda t: tuple(t.placements), o) for o in out]
        want = [tree_map(lambda sh: tuple(sh.placements), state_sh),
                {k: tuple(metric_sh.placements) for k in out[1]}]
        if got != want:
            raise RuntimeError(f"the step's outputs are not under the cell's out_shardings: "
                                 f"{got} against {want}")
        del args, out
    return {"stats": counter.stats, "calls": counter.calls, "trace_s": trace_s,
            "memory": {"argument": argument, "output": output, "temp": peak - argument - output,
                       "alias": 0, "peak": peak}}
