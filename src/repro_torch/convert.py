"""Carry parameters and planner state between the JAX package and the port.

Both packages keep parameters as dicts in the JAX layout (dense weights
``(in, out)``, convolutions HWIO), so conversion is a copy of each leaf:
numpy arrays in, tensors on ``device`` out, and back.  A test initialises
a model with the JAX package, passes ``params_from_numpy`` of it to the
port, and both then compute the same function.  Train states cross the same
way (the optimizer's int32 ``step``, a podded state's leading pod axis:
any dict of arrays).  ``planner_state_from_numpy``
does the same for a path planner's arrays (``pi``, ``mask``, ``cand``, a
bandit's ``counts`` / ``means``), so both planners start from one state.

bfloat16 leaves cross bit for bit: numpy has no bfloat16 of its own, and
JAX hands out ``ml_dtypes.bfloat16`` arrays, which ``torch.tensor`` does
not take, so their 16-bit patterns go across as int16 and are viewed as
``torch.bfloat16`` (and back, for ``params_to_numpy``, which then needs
the ``ml_dtypes`` package).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .pytree import tree_map


def _to_tensor(a: Any, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree: Any, device: str | torch.device) -> Any:
    """Dict of numpy arrays (or anything ``np.asarray`` takes) -> tensors."""
    return tree_map(lambda a: _to_tensor(a, device), tree)


def params_to_numpy(tree: Any) -> Any:
    """Dict of tensors -> numpy arrays on the host."""
    return tree_map(_to_numpy, tree)


def planner_state_from_numpy(planner: Any, **arrays: Any) -> Any:
    """Set each named planner array (numpy, or anything ``np.asarray``
    takes) as a tensor of the attribute's current dtype and device;
    returns the planner.  ``planner_state_from_numpy(p, pi=..., cand=...)``"""
    for name, value in arrays.items():
        cur = getattr(planner, name)
        setattr(planner, name, torch.tensor(np.asarray(value), dtype=cur.dtype, device=cur.device))
    return planner
