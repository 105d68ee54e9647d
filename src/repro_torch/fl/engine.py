"""FL round engine: all workers of an app train as one batched program.

Answers to ``repro/fl/engine.py``.  Every worker's shard is stacked into
padded ``(W, B, ...)`` tensors (a mask marks the padding) and the E local
SGD steps run on parameters stacked along a leading worker axis: the
reference's ``vmap`` becomes that axis written out (batched matmuls for
the MLP, grouped convolutions for the CNN), and its ``lax.scan`` a
Python loop over E.  The per-worker losses are separable, so autograd of
their sum gives each worker its own gradient; the masked mean makes each
worker's loss and gradient those of its unpadded shard.  Each SGD step
goes through the ``fused_update`` kernel, one launch for all the leaves
(``kernels.ops.fused_update_leaves``), which applies the FedProx
proximal gradient with the step.

The reference bucketed W and B to powers of two to bound XLA recompiles;
PyTorch runs eagerly, so shards pad to the exact largest shard.  Deltas
stay on the device until aggregation.

``local_training(..., vectorized=False)`` keeps the per-worker loop as
the equivalence oracle.
"""
from __future__ import annotations

import numpy as np
import torch

from . import small_models as sm
from ..kernels import ops as kops
from ..pytree import leaves


def params_device(params) -> torch.device:
    return leaves(params)[0].device


class DispatchStats:
    """Counts batched training dispatches and distinct dispatch keys.

    ``dispatches`` = calls into a batched training entry point;
    ``compiles`` = dispatches whose (entry, static config, padded shape)
    key was never seen since the last ``reset()``: a jit cache miss in the
    reference, a new launch shape here (nothing is compiled).
    """

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.dispatches = 0
        self.compiles = 0
        self._keys: set = set()

    def record(self, key) -> None:
        self.dispatches += 1
        if key not in self._keys:
            self._keys.add(key)
            self.compiles += 1


DISPATCH = DispatchStats()


def pack_shards(data_by_worker: dict, workers: list[int], *, device="cpu"):
    """Stack ragged worker shards into padded (W, B, ...) tensors + mask.

    Returns (x, y, mask) on ``device``: x (W, B, *feat) f32, y (W, B)
    int32, mask (W, B) f32 with 1.0 on real examples, 0.0 on padding.
    """
    if not workers:
        z = torch.zeros((0, 0), device=device)
        return z, z.to(torch.int32), z
    B = max(len(data_by_worker[w][1]) for w in workers)
    x0 = np.asarray(data_by_worker[workers[0]][0])
    xs = np.zeros((len(workers), B) + x0.shape[1:], np.float32)
    ys = np.zeros((len(workers), B), np.int32)
    mask = np.zeros((len(workers), B), np.float32)
    for i, w in enumerate(workers):
        x, y = data_by_worker[w]
        b = len(y)
        xs[i, :b] = np.asarray(x, np.float32)
        ys[i, :b] = np.asarray(y, np.int32)
        mask[i, :b] = 1.0
    return tuple(torch.from_numpy(a).to(device) for a in (xs, ys, mask))


def _masked_ce(logits, y, mask):
    """Per-worker masked mean cross-entropy: (W, B, K), (W, B) -> (W,)."""
    ll = torch.log_softmax(logits, dim=-1).gather(-1, y[..., None].long())[..., 0]
    return -(ll * mask).sum(-1) / torch.clamp(mask.sum(-1), min=1.0)


def megabatched_local_train(
    params_stack, x, y, mask, *, logits_fn, steps: int, lr: float, mu: float = 0.0
):
    """E local SGD steps with *per-worker start params* (each row is also
    its own FedProx anchor); ``logits_fn`` takes stacked params.

    Autograd differentiates the cross-entropy alone; each step is one
    ``fused_update_leaves`` call over every leaf (one launch per dtype), in
    place, which adds the proximal gradient
    ``mu * (w - w0)`` (the FedProx client update).  The reported loss is
    the reference's, cross-entropy plus ``0.5 * mu * ||w - w0||^2``.

    Returns (stacked new params (W, ...), per-worker mean loss (W,)).
    """
    keys = sorted(params_stack)
    # the anchor may be an expanded view (stride 0): one contiguous copy
    # per call, which the kernel reads at every step
    anchor = [params_stack[k].detach().contiguous() for k in keys]
    p = [a.clone().requires_grad_(True) for a in anchor]
    losses = []
    for _ in range(steps):
        per_worker = _masked_ce(logits_fn(dict(zip(keys, p)), x), y, mask)
        grads = torch.autograd.grad(per_worker.sum(), p)
        with torch.no_grad():
            per_worker = per_worker.detach()
            if mu > 0:  # the reported loss keeps the proximal term
                prox = sum(((a - b) ** 2).flatten(1).sum(1) for a, b in zip(p, anchor))
                per_worker = per_worker + 0.5 * mu * prox
            p = [w.requires_grad_(True) for w in kops.fused_update_leaves(
                [w.detach() for w in p], grads, anchor, lr=lr, mu=mu, donate=True)]
        losses.append(per_worker)
    new = {k: w.detach() for k, w in zip(keys, p)}
    return new, torch.stack(losses).mean(0)


def batched_local_train(global_params, x, y, mask, *, logits_fn, steps: int, lr: float, mu: float = 0.0):
    """E local SGD steps for every worker from one start model.

    Returns (stacked new params (W, ...), per-worker mean loss (W,)).
    """
    W = x.shape[0]
    stack = {k: v.expand(W, *v.shape) for k, v in global_params.items()}
    return megabatched_local_train(
        stack, x, y, mask, logits_fn=logits_fn, steps=steps, lr=lr, mu=mu
    )


def local_training(app, workers: list[int], *, vectorized: bool = True, params=None):
    """Run the app's E local steps on every worker's shard.

    Returns (deltas, weights, losses) with one entry per worker, in
    ``workers`` order: deltas are update pytrees on the params' device,
    weights the shard sizes (FedAvg weighting), losses the mean local
    losses.  ``params`` overrides the starting model.
    """
    if not workers:
        return [], [], []
    start = app.params if params is None else params
    device = params_device(start)
    weights = [float(len(app.data[w][1])) for w in workers]
    if not vectorized:
        deltas, losses = [], []
        for w in workers:
            x, y = (torch.from_numpy(np.asarray(a)).to(device) for a in app.data[w])
            new_p, loss = sm.local_train(
                start, start, x.float(), y,
                logits_fn=sm.LOGITS[app.model], steps=app.local_steps, lr=app.lr, mu=app.mu,
            )
            deltas.append({k: new_p[k] - start[k] for k in start})
            losses.append(float(loss))
        return deltas, weights, losses

    x, y, mask = pack_shards(app.data, workers, device=device)
    DISPATCH.record(
        ("batched", app.model, app.local_steps, app.lr, app.mu, tuple(x.shape))
    )
    new_params, losses = batched_local_train(
        start, x, y, mask,
        logits_fn=sm.LOGITS_STACKED[app.model], steps=app.local_steps, lr=app.lr, mu=app.mu,
    )
    stacked = {k: new_params[k] - start[k][None] for k in start}
    deltas = [{k: v[i] for k, v in stacked.items()} for i in range(len(workers))]
    return deltas, weights, losses.tolist()


def fused_local_training(jobs: list) -> list:
    """Train many (app, workers, start_params) jobs in as few dispatches
    as possible: the cross-app / cross-version megabatch.

    Jobs whose static training config (model, local_steps, lr, mu,
    feature shape, parameter shapes, device) matches are stacked along
    the worker axis, each worker row carrying its own start params, and
    run through one ``megabatched_local_train``; deltas and losses are
    then unstacked per job.  ``start_params`` ``None`` = ``app.params``.
    Returns ``[(deltas, weights, losses), ...]`` aligned with ``jobs``.
    """
    results: list = [None] * len(jobs)
    groups: dict[tuple, list[int]] = {}
    for j, (app, workers, start) in enumerate(jobs):
        if not workers:
            results[j] = ([], [], [])
            continue
        start = app.params if start is None else start
        feat = np.asarray(app.data[workers[0]][0]).shape[1:]
        params_sig = tuple((k, tuple(v.shape)) for k, v in sorted(start.items()))
        key = (app.model, app.local_steps, app.lr, app.mu, feat, params_sig,
               params_device(start))
        groups.setdefault(key, []).append(j)

    for key, idxs in groups.items():
        model, steps, lr, mu, feat, params_sig, device = key
        data, spans = {}, []  # data: row -> shard; spans: (job, row offset, worker count)
        for j in idxs:
            app, workers, _ = jobs[j]
            spans.append((j, len(data), len(workers)))
            for w in workers:
                data[len(data)] = app.data[w]
        x, y, mask = pack_shards(data, list(data), device=device)
        params_stack = {
            k: torch.cat([
                (jobs[j][2] if jobs[j][2] is not None else jobs[j][0].params)[k]
                .expand(count, *shape)
                for j, _, count in spans
            ])
            for k, shape in params_sig
        }
        DISPATCH.record(("mega", model, steps, lr, mu, tuple(x.shape), params_sig))
        new_params, losses = megabatched_local_train(
            params_stack, x, y, mask,
            logits_fn=sm.LOGITS_STACKED[model], steps=steps, lr=lr, mu=mu,
        )
        stacked = {k: new_params[k] - params_stack[k] for k in params_stack}
        losses = losses.tolist()
        for j, off, count in spans:
            app, workers, _ = jobs[j]
            deltas = [{k: v[off + i] for k, v in stacked.items()} for i in range(count)]
            weights = [float(len(app.data[w][1])) for w in workers]
            results[j] = (deltas, weights, losses[off : off + count])
    return results


def _server_update(params, agg):
    """params + aggregate, in the params' dtype.  The aggregate is float64
    (divided at the root); it is rounded to the params' dtype before the
    add, as the JAX reference does with 64-bit mode off."""
    return {k: p + agg[k].to(p.dtype) for k, p in params.items()}


def run_round(system, app, *, use_kernel: bool = True, vectorized: bool = True) -> dict:
    """One Totoro+ round through the Table-II verbs; returns metrics.

    Broadcast down the tree, batched local training, hierarchical kernel
    aggregation up the tree (``TotoroSystem.Aggregate`` executes the level
    schedule), master server update + state replication.
    """
    bstats = system.Broadcast(app.handle.app_id, app.params)

    tree = app.handle.tree
    workers = [w for w in sorted(tree.members) if w in app.data]
    deltas, weights, losses = local_training(app, workers, vectorized=vectorized)

    astats = system.Aggregate(
        app.handle.app_id,
        {w: d for w, d in zip(workers, deltas)},
        weights={w: wt for w, wt in zip(workers, weights)},
        use_kernel=use_kernel,
    )
    app.params = _server_update(app.params, astats["result"])
    app.round_num += 1
    system.replicate_master_state(app.handle.app_id, {"round": app.round_num})

    metrics = {
        "round": app.round_num,
        "loss": float(np.mean(losses)),
        "time_ms": bstats["time_ms"] + astats["time_ms"],
        "traffic_bytes": bstats["bytes"] + astats["bytes"],
        "agg_levels": astats.get("levels", []),
    }
    app.history.append(metrics)
    return metrics


def run_round_fused(system, apps: list, *, use_kernel: bool = True) -> list[dict]:
    """One round for MANY apps with a single fused training dispatch.

    Every app Broadcasts, all apps' workers train together through
    ``fused_local_training``, then each app Aggregates and applies its
    server update.  Per-app results match ``run_round`` to fp tolerance.
    Returns one metrics dict per app, in ``apps`` order.
    """
    bstats_all, jobs = [], []
    for app in apps:
        bstats_all.append(system.Broadcast(app.handle.app_id, app.params))
        tree = app.handle.tree
        workers = [w for w in sorted(tree.members) if w in app.data]
        jobs.append((app, workers, app.params))
    trained = fused_local_training(jobs)

    out = []
    for app, bstats, (_, workers, _), (deltas, weights, losses) in zip(
        apps, bstats_all, jobs, trained
    ):
        astats = system.Aggregate(
            app.handle.app_id,
            {w: d for w, d in zip(workers, deltas)},
            weights={w: wt for w, wt in zip(workers, weights)},
            use_kernel=use_kernel,
        )
        app.params = _server_update(app.params, astats["result"])
        app.round_num += 1
        system.replicate_master_state(app.handle.app_id, {"round": app.round_num})
        metrics = {
            "round": app.round_num,
            "loss": float(np.mean(losses)) if losses else 0.0,
            "time_ms": bstats["time_ms"] + astats["time_ms"],
            "traffic_bytes": bstats["bytes"] + astats["bytes"],
            "agg_levels": astats.get("levels", []),
        }
        app.history.append(metrics)
        out.append(metrics)
    return out
