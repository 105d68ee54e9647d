"""Weighted child-update aggregation: the wrapper of the CUDA kernel.

``tree_aggregate_groups`` answers to ``repro/kernels/tree_aggregate.py``'s
Pallas kernel of the same name: (G, C, L) children's flattened updates
times (G, C) weights -> (G, L) f32 per-parent weighted sums, one launch per
tree level.  The input is f32 or bf16, or int8 for the compressed async
apply (QSGD lattice points, the row scales folded into the weights).  Dispatch goes by the tensor's device and nothing else:

- a CPU tensor goes to the plain version (``ref.tree_aggregate_groups_ref``);
- a CUDA tensor launches ``csrc/tree_aggregate.cu`` (built for sm_90a at
  first use) or raises.

The kernel sums each output element as one fused multiply-add chain in
child order from zero, so it gives the bits of
``ref.tree_aggregate_groups_chain`` at every block shape.

Invariants kept from the reference: the kernel produces partial weighted
*sums*, never means (normalisation happens once, at the tree root), and a
zero-weight slot with a zero input adds an exact zero, so ragged groups pad
with zero rows and zero weights.  ``staleness_weights`` is the whole of the
async change to the math: it discounts each buffered commit's weight.

``tree_aggregate`` answers to the reference's Pallas ``tree_aggregate``
(the G = 1 case: (C, L) x (C,) -> (L,) f32) and launches the same kernel.

``launches`` counts kernel launches (never plain-version calls), so a run
can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np
import torch

from . import _build
from . import ref as _ref

launches = 0  # CUDA kernel launches since the last reset (a plain int)

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "i8"}
_fns: dict[str, ctypes._CFuncPtr] = {}
_libm: list = []  # libm's powf, loaded at first use


def _powf():
    """The C math library's ``powf``, loaded once through ctypes."""
    if not _libm:
        name = ctypes.util.find_library("m")
        if name is None:
            raise RuntimeError("the C math library (libm) was not found: staleness_weights "
                               "needs its powf for bit parity with XLA's pow")
        fn = ctypes.CDLL(name).powf
        fn.argtypes = [ctypes.c_float, ctypes.c_float]
        fn.restype = ctypes.c_float
        _libm.append(fn)
    return _libm[0]


def staleness_weights(weights, staleness, alpha: float, *, device=None) -> torch.Tensor:
    """FedBuff-style staleness discount ``w_i / (1 + s_i)^alpha`` in f32.

    Bit-equal to the JAX package's: XLA's f32 ``pow`` on the CPU gives
    the bits of the C library's ``powf``, which ``torch.pow`` and numpy's
    f32 ``power`` miss by an ulp on some values (ROADMAP §3).  So
    ``p = powf(fl32(1 + s), fl32(-alpha))`` is computed on the host, one
    call per weight (K is a buffer's size), and ``w * p`` in f32 on
    ``device``.  alpha = 0 (or all-zero staleness) leaves the weights as
    they are, so the async apply reproduces the synchronous weighted mean.
    """
    w = torch.as_tensor(weights, dtype=torch.float32, device=device)
    s = torch.as_tensor(staleness, dtype=torch.float32).cpu().numpy()
    base = np.float32(1.0) + s  # f32 sums, as XLA forms them
    exp = float(np.float32(-float(alpha)))
    powf = _powf()
    p = np.array([powf(float(b), exp) for b in base.reshape(-1)], np.float32).reshape(s.shape)
    return w * torch.from_numpy(p).to(w.device)


def _fn(dtype_tag: str):
    fn = _fns.get(dtype_tag)
    if fn is None:
        fn = getattr(_build.load("tree_aggregate"), f"tree_aggregate_groups_{dtype_tag}")
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fns[dtype_tag] = fn
    return fn


def child_tile() -> int:
    """The children whose loads one kernel thread keeps in flight together
    (the CUDA kernel's ``kChildTile``; builds the kernel)."""
    return int(_build.load("tree_aggregate").tree_aggregate_child_tile())


def _check(grads: torch.Tensor, weights: torch.Tensor) -> None:
    if grads.dim() != 3:
        raise ValueError(f"grads must be (G, C, L), got shape {tuple(grads.shape)}")
    if grads.dtype not in _DTYPES:
        raise TypeError(f"grads must be float32, bfloat16 or int8, got {grads.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, got {weights.dtype}")
    if tuple(weights.shape) != tuple(grads.shape[:2]):
        raise ValueError(
            f"weights {tuple(weights.shape)} do not match grads (G, C) = {tuple(grads.shape[:2])}"
        )
    if weights.device != grads.device:
        raise ValueError(f"grads on {grads.device}, weights on {weights.device}")
    if not (grads.is_contiguous() and weights.is_contiguous()):
        raise ValueError("grads and weights must be contiguous")
    if grads.shape[0] >= 2**31:
        raise ValueError(f"G = {grads.shape[0]} exceeds the grid's 2^31 - 1 blocks")


def tree_aggregate_groups(grads: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(G, C, L) f32/bf16/int8 x (G, C) f32 -> (G, L) f32 weighted sums."""
    global launches
    _check(grads, weights)
    if grads.device.type == "cpu":
        return _ref.tree_aggregate_groups_ref(grads, weights)
    if grads.device.type != "cuda":
        raise ValueError(f"no kernel for device {grads.device}")
    G, C, L = grads.shape
    out = torch.empty((G, L), dtype=torch.float32, device=grads.device)
    with torch.cuda.device(grads.device):
        fn = _fn(_DTYPES[grads.dtype])
        stream = torch.cuda.current_stream(grads.device).cuda_stream
        err = fn(grads.data_ptr(), weights.data_ptr(), out.data_ptr(), G, C, L, stream)
    if err != 0:
        raise RuntimeError(f"tree_aggregate_groups launch failed: CUDA error {err}")
    launches += 1
    return out


def tree_aggregate(grads: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(C, L) f32/bf16/int8 x (C,) f32 -> (L,) f32 weighted sum: one group
    of ``tree_aggregate_groups``."""
    if grads.dim() != 2 or weights.dim() != 1:
        raise ValueError(f"grads must be (C, L) and weights (C,), got {tuple(grads.shape)} "
                         f"and {tuple(weights.shape)}")
    return tree_aggregate_groups(grads[None], weights[None])[0]
