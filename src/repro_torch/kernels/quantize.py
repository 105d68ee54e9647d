"""QSGD int8 quantize / dequantize: the wrappers of the CUDA kernels.

``qsgd_quantize`` and ``qsgd_dequantize`` answer to the Pallas kernels of
the same names in ``repro/kernels/quantize.py``: rows of 256 values share
one f32 max-abs scale, and stochastic rounding consumes uniforms the
caller supplies, so the kernel is bit-equal to ``ref.quantize_ref`` on the
same uniforms.  ``qsgd_quantize_residual`` is the same launch writing the
error-feedback residual ``x - q * scale`` too (the reference dequantizes
after quantizing).  Dispatch goes by the tensor's device and nothing else:

- a CPU tensor goes to the plain version (``ref.quantize_ref``,
  ``ref.quantize_residual_ref``, ``ref.dequantize_ref``);
- a CUDA tensor launches ``csrc/quantize.cu`` (built for sm_90a at first
  use) or raises.

Any row count R is taken as it is (the reference padded R to its
256-row block for the TPU).  ``launches`` counts kernel launches of each
wrapper (never plain-version calls): every quantize launch counts under
``qsgd_quantize``, and the residual instance's also under
``qsgd_quantize_residual``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from . import ref as _ref

ROW = 256
LEVELS = 127

launches = {"qsgd_quantize": 0, "qsgd_quantize_residual": 0, "qsgd_dequantize": 0}  # since the last reset

_fns: dict[str, ctypes._CFuncPtr] = {}


def _fn(name: str, argtypes: list):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("quantize"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"tensors on {[str(t.device) for t in ts]}: one device needed")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("tensors must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev


def _check_quantize(x: torch.Tensor, rand: torch.Tensor, levels: int) -> torch.device:
    if x.dim() != 2 or x.shape[1] != ROW or tuple(rand.shape) != tuple(x.shape):
        raise ValueError(f"x and rand must be (R, {ROW}), got {tuple(x.shape)}, {tuple(rand.shape)}")
    if x.dtype != torch.float32 or rand.dtype != torch.float32:
        raise TypeError(f"x and rand must be float32, got {x.dtype}, {rand.dtype}")
    if not 1 <= int(levels) <= 127:
        raise ValueError(f"levels must be in [1, 127], got {levels!r}")
    return _same_device(x, rand)


def _launch_quantize(x: torch.Tensor, rand: torch.Tensor, levels: int, residual: bool):
    """One quantize launch: (q, scale), and the residual when asked."""
    dev, R = x.device, x.shape[0]
    q = torch.empty((R, ROW), dtype=torch.int8, device=dev)
    scale = torch.empty((R, 1), dtype=torch.float32, device=dev)
    res = torch.empty((R, ROW), dtype=torch.float32, device=dev) if residual else None
    inv = float(np.float32(1.0) / np.float32(levels))  # exact in a C float
    ptrs = [x.data_ptr(), rand.data_ptr(), q.data_ptr(), scale.data_ptr()]
    name = "qsgd_quantize_f32"
    if residual:
        ptrs.append(res.data_ptr())
        name = "qsgd_quantize_residual_f32"
    with torch.cuda.device(dev):
        fn = _fn(name, [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int64, ctypes.c_float,
                                                         ctypes.c_void_p])
        err = fn(*ptrs, R, inv, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name[:-4]} launch failed: CUDA error {err}")
    launches["qsgd_quantize"] += 1
    if residual:
        launches["qsgd_quantize_residual"] += 1
        return q, scale, res
    return q, scale


def qsgd_quantize(x: torch.Tensor, rand: torch.Tensor, *, levels: int = LEVELS):
    """x, rand: (R, 256) f32 -> (q int8 (R, 256), scale f32 (R, 1)).

    ``levels`` (1..127) is the per-sign lattice size; ``rand`` holds
    uniforms in [0, 1).
    """
    if _check_quantize(x, rand, levels).type == "cpu":
        return _ref.quantize_ref(x, rand, levels=levels)
    return _launch_quantize(x, rand, levels, residual=False)


def qsgd_quantize_residual(x: torch.Tensor, rand: torch.Tensor, *, levels: int = LEVELS):
    """``qsgd_quantize`` plus the EF residual in the same launch:
    (q int8 (R, 256), scale f32 (R, 1), x - q * scale f32 (R, 256)), the
    residual rounded twice as the reference's dequantize-then-subtract."""
    if _check_quantize(x, rand, levels).type == "cpu":
        return _ref.quantize_residual_ref(x, rand, levels=levels)
    return _launch_quantize(x, rand, levels, residual=True)


def qsgd_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 (R, C) x f32 (R, 1) -> f32 (R, C), ``q * scale`` row-wise."""
    if q.dim() != 2 or tuple(scale.shape) != (q.shape[0], 1):
        raise ValueError(f"q must be (R, C) and scale (R, 1), got {tuple(q.shape)}, {tuple(scale.shape)}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"q must be int8 and scale float32, got {q.dtype}, {scale.dtype}")
    dev = _same_device(q, scale)
    if dev.type == "cpu":
        return _ref.dequantize_ref(q, scale)
    R, C = q.shape
    out = torch.empty((R, C), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        fn = _fn("qsgd_dequantize_i8", [ctypes.c_void_p] * 3 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p])
        err = fn(q.data_ptr(), scale.data_ptr(), out.data_ptr(), R, C,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qsgd_dequantize launch failed: CUDA error {err}")
    launches["qsgd_dequantize"] += 1
    return out
