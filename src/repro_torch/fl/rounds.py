"""FL round orchestration over the simulated Totoro+ overlay.

Answers to ``repro/fl/rounds.py``: Broadcast the global model down the
dataflow tree, workers run E local steps on their (non-IID) shards,
model deltas aggregate up the tree level-by-level through the
``tree_aggregate_groups`` kernel, the master applies the server update
and replicates its state to the k-node neighborhood set.

Apps live on the CUDA card unless the caller passes ``device="cpu"``;
with no card and no explicit ``"cpu"``, ``make_app`` raises.
``run_async`` runs FedBuff-style buffered-async rounds on the event clock
(``fl/async_engine``).

Also provides ``CentralizedBaseline``: the OpenFL/FedScale-style single
coordinator that serves M concurrent applications through one queue.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import engine
from . import small_models as sm
from ..convert import params_from_numpy
from ..core.api import TotoroSystem


@dataclass
class FLApp:
    name: str
    handle: object
    params: dict  # name -> tensor, on the app's device
    model: str = "mlp"
    local_steps: int = 4
    lr: float = 0.1
    mu: float = 0.0  # FedProx
    data: dict = field(default_factory=dict)  # node -> (x, y) numpy
    round_num: int = 0
    history: list = field(default_factory=list)


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA card is available; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return dev


def make_app(
    system: TotoroSystem,
    name: str,
    *,
    workers: list[int],
    data_by_worker: dict,
    model: str = "mlp",
    dim: int = 32,
    hidden: int = 64,
    num_classes: int = 8,
    local_steps: int = 4,
    lr: float = 0.1,
    mu: float = 0.0,
    seed: int = 0,
    params: dict | None = None,
    device=None,
) -> FLApp:
    """Publish an FL app and subscribe its workers.

    ``params`` (a dict of numpy arrays in the JAX layout)
    replaces the seeded init, so the port can start from the JAX
    package's parameters; otherwise a ``torch.Generator`` seeded with
    ``seed`` draws them on the CPU before they move to ``device``.
    """
    dev = resolve_device(device)
    handle = system.CreateTree(name)
    for w in workers:
        system.Subscribe(handle.app_id, w)
    if params is not None:
        init = params_from_numpy(params, dev)
    elif model == "mlp":
        init = sm.init_mlp(torch.Generator().manual_seed(seed), dim, hidden, num_classes, device=dev)
    else:
        init = sm.init_cnn(torch.Generator().manual_seed(seed), num_classes, device=dev)
    return FLApp(
        name=name, handle=handle, params=init, model=model,
        local_steps=local_steps, lr=lr, mu=mu, data=data_by_worker,
    )


def run_round(
    system: TotoroSystem, app: FLApp, *, use_kernel: bool = True, vectorized: bool = True
) -> dict:
    """One Totoro+ round; returns metrics incl. modeled wall time.

    Delegates to ``fl/engine.run_round``; ``vectorized=False`` takes the
    per-worker reference loop.
    """
    return engine.run_round(system, app, use_kernel=use_kernel, vectorized=vectorized)


def run_round_fused(system: TotoroSystem, apps: list[FLApp], *, use_kernel: bool = True) -> list[dict]:
    """One round for many apps with a single fused training dispatch
    (``fl/engine.run_round_fused``)."""
    return engine.run_round_fused(system, apps, use_kernel=use_kernel)


def run_async(
    system: TotoroSystem,
    apps: list[FLApp],
    *,
    applies: int,
    buffer_k: int | list[int],
    staleness_alpha: float = 0.5,
    model_bytes: float,
    compute_ms=50.0,
    churn=None,
    barrier: bool = False,
    adaptive: bool = False,
    adaptive_kwargs: dict | None = None,
    selector=None,
    fair: bool = True,
    app_weights=None,
    app_rate_caps=None,
    relay_admission=None,
) -> dict:
    """FedBuff-style buffered-async rounds on the event clock.

    Delegates to ``fl/async_engine.run_async``: every worker's
    download / compute / upload is its own simulator event, the master
    applies a staleness-weighted update after ``buffer_k`` arrivals
    (``CommitDelta``/``ApplyBuffered`` verbs), and optional ``churn``
    (``core.sim.ChurnModel``) fails/rejoins workers mid-round.  The
    handles' ``compression`` policies compress commits and broadcasts.
    """
    from . import async_engine

    return async_engine.run_async(
        system, apps, applies=applies, buffer_k=buffer_k,
        staleness_alpha=staleness_alpha, model_bytes=model_bytes,
        compute_ms=compute_ms, churn=churn, barrier=barrier,
        adaptive=adaptive, adaptive_kwargs=adaptive_kwargs, selector=selector,
        fair=fair, app_weights=app_weights, app_rate_caps=app_rate_caps,
        relay_admission=relay_admission,
    )


def evaluate(app: FLApp, x, y) -> float:
    dev = engine.params_device(app.params)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    yt = torch.as_tensor(np.asarray(y), device=dev)
    with torch.no_grad():
        return float(sm.accuracy(sm.LOGITS[app.model](app.params, xt), yt))


# ---------------------------------------------------------------------------
# centralized baseline (OpenFL / FedScale architecture)


@dataclass
class CentralizedBaseline:
    """Single coordinator, first-come-first-served across M applications
    (paper §VII-D: 'the central coordinator needs to handle them one by
    one ... which causes large queuing delays')."""

    server_bandwidth_mbps: float = 1000.0
    coordinator_overhead_ms: float = 20.0

    def round_time_ms(self, apps: list[FLApp], per_round_compute_ms: float, model_bytes: float) -> list[float]:
        """Per-app wall time for one round of every app: uploads/downloads
        serialize through the central server's link + coordinator queue."""
        times = []
        clock = 0.0
        for app in apps:
            n_workers = max(len(app.data), 1)
            xfer_ms = 2 * n_workers * model_bytes * 8 / (self.server_bandwidth_mbps * 1e3)
            clock += self.coordinator_overhead_ms + xfer_ms + per_round_compute_ms
            times.append(clock)
        return times
