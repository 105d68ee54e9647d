"""Carry parameters and planner state between the JAX package and the port.

Both packages keep parameters as dicts in the JAX layout (dense weights
``(in, out)``, convolutions HWIO), so conversion is a copy of each leaf:
numpy arrays in, tensors on ``device`` out, and back.  A test initialises
a model with the JAX package, passes ``params_from_numpy`` of it to the
port, and both then compute the same function.  ``planner_state_from_numpy``
does the same for a path planner's arrays (``pi``, ``mask``, ``cand``, a
bandit's ``counts`` / ``means``), so both planners start from one state.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .pytree import tree_map


def params_from_numpy(tree: Any, device: str | torch.device) -> Any:
    """Dict of numpy arrays (or anything ``np.asarray`` takes) -> tensors."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device), tree)


def params_to_numpy(tree: Any) -> Any:
    """Dict of tensors -> numpy arrays on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def planner_state_from_numpy(planner: Any, **arrays: Any) -> Any:
    """Set each named planner array (numpy, or anything ``np.asarray``
    takes) as a tensor of the attribute's current dtype and device;
    returns the planner.  ``planner_state_from_numpy(p, pi=..., cand=...)``"""
    for name, value in arrays.items():
        cur = getattr(planner, name)
        setattr(planner, name, torch.tensor(np.asarray(value), dtype=cur.dtype, device=cur.device))
    return planner
