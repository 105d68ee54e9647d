"""Fused dequantize-and-apply of broadcast deltas: the CUDA kernel's wrapper.

``apply_quantized_broadcast`` answers to ``repro/kernels/broadcast.py``'s
Pallas kernel of the same name: a worker holding params ``w`` folds a
chain of D quantized version deltas (int8 lattice points + per-row f32
scales) into them in one pass, strictly in chain order, one rounding per
step, so one D-deep call equals D single-step calls bit for bit.
Dispatch goes by the tensor's device and nothing else:

- a CPU tensor goes to the plain version (``ref.apply_quantized_ref``);
- a CUDA tensor launches ``csrc/broadcast.cu`` (built for sm_90a at first
  use) or raises.

Any row count is taken as it is.  ``launches`` counts kernel launches
(never plain-version calls).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import ref as _ref

launches = 0  # CUDA kernel launches since the last reset (a plain int)

_fn_cache: list = []


def _fn():
    if not _fn_cache:
        fn = _build.load("broadcast").apply_quantized_broadcast_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_cache.append(fn)
    return _fn_cache[0]


def apply_quantized_broadcast(w: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """w: (R, C) f32; q: (D, R, C) int8; s: (D, R, 1) f32 -> (R, C) f32."""
    global launches
    if w.dim() != 2 or q.dim() != 3 or tuple(q.shape[1:]) != tuple(w.shape):
        raise ValueError(f"w must be (R, C) and q (D, R, C), got {tuple(w.shape)}, {tuple(q.shape)}")
    D, R, C = q.shape
    if tuple(s.shape) != (D, R, 1):
        raise ValueError(f"s must be (D, R, 1) = {(D, R, 1)}, got {tuple(s.shape)}")
    if w.dtype != torch.float32 or q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"w, q, s must be float32, int8, float32; got {w.dtype}, {q.dtype}, {s.dtype}")
    if not (w.device == q.device == s.device):
        raise ValueError(f"w on {w.device}, q on {q.device}, s on {s.device}")
    if not (w.is_contiguous() and q.is_contiguous() and s.is_contiguous()):
        raise ValueError("w, q and s must be contiguous")
    if w.device.type == "cpu":
        return _ref.apply_quantized_ref(w, q, s)
    if w.device.type != "cuda":
        raise ValueError(f"no kernel for device {w.device}")
    out = torch.empty((R, C), dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        err = _fn()(w.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), D, R, C,
                    torch.cuda.current_stream(w.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"apply_quantized_broadcast launch failed: CUDA error {err}")
    launches += 1
    return out
