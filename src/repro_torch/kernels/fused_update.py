"""Fused FedProx client update: the CUDA kernel's wrapper.

``fused_update`` answers to ``repro/kernels/fused_update.py``'s Pallas
kernel of the same name, ``w' = w - lr * (g + mu*(w - w0) + wd*w)``
computed in f32 and stored in ``w.dtype`` (f32 or bf16), with XLA's
roundings (``ref.fused_update_ref``).  Dispatch goes by the tensors'
device and nothing else:

- CPU tensors go to the plain version;
- CUDA tensors launch ``csrc/fused_update.cu`` (built for sm_90a at first
  use) or raise.

Any length is taken as it is (the reference padded L to its 2048-element
tile for the TPU).  ``out`` may be ``w`` itself: the update then runs in
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


def _fn(dtype: torch.dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(_build.load("fused_update"), _SYMBOLS[dtype])
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_float] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def fused_update(w: torch.Tensor, g: torch.Tensor, w0: torch.Tensor, *, lr: float,
                 mu: float = 0.0, wd: float = 0.0, out: torch.Tensor | None = None) -> torch.Tensor:
    """w, g, w0: (L,) of one dtype (f32 or bf16) -> (L,) in that dtype.

    ``out`` (default: a new tensor) receives the result; it may be ``w``.
    """
    global launches
    ts = (w, g, w0) if out is None else (w, g, w0, out)
    if any(t.dim() != 1 or t.shape != w.shape for t in ts):
        raise ValueError(f"w, g, w0 (and out) must be one (L,) shape, got {[tuple(t.shape) for t in ts]}")
    if w.dtype not in _SYMBOLS or any(t.dtype != w.dtype for t in ts):
        raise TypeError(f"w, g, w0 (and out) must share float32 or bfloat16, got {[t.dtype for t in ts]}")
    if any(t.device != w.device for t in ts):
        raise ValueError(f"tensors on {[str(t.device) for t in ts]}: one device needed")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("w, g, w0 and out must be contiguous")
    if w.device.type == "cpu":
        res = _ref.fused_update_ref(w, g, w0, lr, mu, wd)
        return res if out is None else out.copy_(res)
    if w.device.type != "cuda":
        raise ValueError(f"no kernel for device {w.device}")
    if out is None:
        out = torch.empty_like(w)
    with torch.cuda.device(w.device):
        err = _fn(w.dtype)(w.data_ptr(), g.data_ptr(), w0.data_ptr(), out.data_ptr(), w.numel(),
                           *(float(np.float32(v)) for v in (lr, mu, wd)),
                           torch.cuda.current_stream(w.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_update launch failed: CUDA error {err}")
    launches += 1
    return out
