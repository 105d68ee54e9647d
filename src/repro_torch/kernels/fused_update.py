"""Fused FedProx client update: the CUDA kernel's wrapper.

``fused_update`` answers to ``repro/kernels/fused_update.py``'s Pallas
kernel of the same name, ``w' = w - lr * (g + mu*(w - w0) + wd*w)``
computed in f32 and stored in ``w.dtype`` (f32 or bf16), with XLA's
roundings (``ref.fused_update_ref``).  ``fused_update_many`` updates a
table of leaves at once: one launch per dtype present (and per
``max_leaves()`` leaves of it), so a local step is one launch, not one
per leaf.  ``fused_update`` is its one-leaf case.  Dispatch goes by the
tensors' device and nothing else:

- CPU tensors go to the plain version, leaf by leaf;
- CUDA tensors launch ``csrc/fused_update.cu`` (built for sm_90a at first
  use) or raise.

At mu = wd = 0 (their f32 values) the kernel and the plain version both
compute ``fma(-lr, g, w)`` and never read ``w0`` (ROADMAP parity rule 8).
Any length is taken as it is (the reference padded L to its 2048-element
tile for the TPU).  An ``out`` may be its ``w``: the update then runs in
place.  ``launches`` counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from . import ref as _ref

launches = 0  # CUDA kernel launches since the last reset (a plain int)

_SYMBOLS = {torch.float32: "fused_update_f32", torch.bfloat16: "fused_update_bf16"}
_fns: dict = {}


def _lib():
    return _build.load("fused_update")


def _fn(dtype: torch.dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(_lib(), _SYMBOLS[dtype])
        fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_void_p)] * 4 + [
            ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def max_leaves() -> int:
    """The most leaves one launch takes (the kernel's parameter table)."""
    return int(_lib().fused_update_max_leaves())


def _check_leaf(j: int, ts: tuple) -> None:
    w = ts[0]
    if any(t.dim() != 1 or t.shape != w.shape for t in ts):
        raise ValueError(f"leaf {j}: w, g, w0 (and out) must be one (L,) shape, got "
                         f"{[tuple(t.shape) for t in ts]}")
    if w.dtype not in _SYMBOLS or any(t.dtype != w.dtype for t in ts):
        raise TypeError(f"leaf {j}: w, g, w0 (and out) must share float32 or bfloat16, got "
                        f"{[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"leaf {j}: w, g, w0 and out must be contiguous")


def fused_update_many(ws, gs, w0s, *, lr: float, mu: float = 0.0, wd: float = 0.0,
                      outs=None) -> list:
    """Leaves ``ws[j], gs[j], w0s[j]``: (L_j,) of one dtype each (f32 or
    bf16; leaves may differ), all on one device -> the updated leaves.

    ``outs`` (default: new tensors) receives the results; ``outs[j]`` may
    be ``ws[j]``.
    """
    global launches
    ws, gs, w0s = list(ws), list(gs), list(w0s)
    outs = [None] * len(ws) if outs is None else list(outs)
    if not len(ws) == len(gs) == len(w0s) == len(outs):
        raise ValueError(f"{len(ws)} w, {len(gs)} g, {len(w0s)} w0 and {len(outs)} out leaves")
    for j, leaf in enumerate(zip(ws, gs, w0s, outs)):
        _check_leaf(j, tuple(t for t in leaf if t is not None))
    if not ws:
        return []
    device = ws[0].device
    if any(t is not None and t.device != device for leaf in zip(ws, gs, w0s, outs) for t in leaf):
        raise ValueError("every leaf's tensors must lie on one device")
    if device.type == "cpu":
        res = [_ref.fused_update_ref(w, g, w0, lr, mu, wd) for w, g, w0 in zip(ws, gs, w0s)]
        return [r if o is None else o.copy_(r) for r, o in zip(res, outs)]
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    outs = [torch.empty_like(w) if o is None else o for w, o in zip(ws, outs)]
    lr32, mu32, wd32 = (float(np.float32(v)) for v in (lr, mu, wd))
    prox = int(not (mu32 == 0.0 and wd32 == 0.0))
    cap = max_leaves()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for dtype in _SYMBOLS:
            idx = [j for j, w in enumerate(ws) if w.dtype == dtype and w.numel() > 0]
            for a in range(0, len(idx), cap):
                part = idx[a : a + cap]
                k = len(part)
                ptrs = [(ctypes.c_void_p * k)(*(ts[j].data_ptr() for j in part))
                        for ts in (ws, gs, w0s, outs)]
                n = (ctypes.c_int64 * k)(*(ws[j].numel() for j in part))
                err = _fn(dtype)(k, *ptrs, n, lr32, mu32, wd32, prox, stream)
                if err != 0:
                    raise RuntimeError(f"fused_update launch failed: CUDA error {err}")
                launches += 1
    return outs


def fused_update(w: torch.Tensor, g: torch.Tensor, w0: torch.Tensor, *, lr: float,
                 mu: float = 0.0, wd: float = 0.0, out: torch.Tensor | None = None) -> torch.Tensor:
    """w, g, w0: (L,) of one dtype (f32 or bf16) -> (L,) in that dtype: the
    one-leaf case of ``fused_update_many``.

    ``out`` (default: a new tensor) receives the result; it may be ``w``.
    """
    return fused_update_many([w], [g], [w0], lr=lr, mu=mu, wd=wd, outs=[out])[0]
