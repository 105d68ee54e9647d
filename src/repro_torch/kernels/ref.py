"""Plain PyTorch versions of the ported kernels (the correctness contract).

Each function computes what its CUDA kernel computes, in the same
arithmetic type and with the same roundings, with ordinary tensor
operations.  The wrappers use them for tensors that lie on the CPU;
``chip_smoke.py`` and the card-only tests hold each kernel against them
on the card.  Only the oracles of the kernels ported so far are here
(``repro/kernels/ref.py`` has the rest).

Three rounding rules keep the QSGD and chain-apply versions bit-equal to
the JAX package's compiled path:

- XLA turns the division by the constant ``levels`` into a multiply by
  the f32 reciprocal, so ``quantize_ref`` forms ``max|x| * fl32(1/levels)``;
  the eager, non-256-chunk path divides (``quantize_ref_truediv``);
- JAX's f32 -> int8 cast saturates where PyTorch's wraps
  (``floor(x/scale + r)`` can reach 128), so both clamp to [-128, 127];
- XLA contracts ``acc + q * s`` into one fused multiply-add, so
  ``apply_quantized_ref`` rounds once per chain step: ``q * s`` is exact
  in f64, and the f64 sum rounds once to f32.
"""
from __future__ import annotations

import numpy as np
import torch

SCALE_FLOOR = 1e-12  # the smallest per-row scale (an all-zero row)


def tree_aggregate_ref(grads: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted sum of C children's flattened updates.

    grads: (C, L) any float dtype; weights: (C,) -> (L,) f32, accumulated
    in f32 (``repro/kernels/ref.py::tree_aggregate_ref``).
    """
    return (grads.float() * weights.float()[:, None]).sum(dim=0)


def tree_aggregate_groups_ref(grads: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(G, C, L) f32, bf16 or int8 x (G, C) -> (G, L) f32: one tree
    level's per-group sums (int8 widens to f32 exactly)."""
    return (grads.float() * weights.float()[:, :, None]).sum(dim=1)


def _lattice(xf: torch.Tensor, scale: torch.Tensor, rand: torch.Tensor) -> torch.Tensor:
    """``floor(x / scale + r)`` saturated into int8, as JAX's cast does."""
    return torch.floor(xf / scale + rand.float()).clamp_(-128.0, 127.0).to(torch.int8)


def _floor_scale(scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(scale, SCALE_FLOOR)


def quantize_ref(x: torch.Tensor, rand: torch.Tensor, levels: int = 127):
    """QSGD stochastic int8 quantization with a per-row max-abs scale.

    x, rand: (R, C) -> (q int8 (R, C), scale f32 (R, 1)); ``rand`` holds
    uniforms in [0, 1).  ``scale = max(max|x| * fl32(1/levels), 1e-12)``,
    the jitted reference's arithmetic.
    """
    xf = x.float()
    inv = float(np.float32(1.0) / np.float32(levels))  # an f32 value, exact as a float
    scale = _floor_scale(xf.abs().amax(dim=-1, keepdim=True) * inv)
    return _lattice(xf, scale, rand), scale


def quantize_ref_truediv(x: torch.Tensor, rand: torch.Tensor, levels: int = 127):
    """``quantize_ref`` with ``scale = max|x| / levels`` divided, the eager
    arithmetic of ``repro/fl/compression.py::qsgd_quantize`` (the path of
    every chunk width other than 256).  x: (..., d)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a CPU scalar multiplies
    # by its reciprocal instead
    scale = _floor_scale(amax / torch.full_like(amax, float(levels)))
    return _lattice(xf, scale, rand), scale


def dequantize_ref(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 (R, C) x f32 (R, 1) -> f32 (R, C): one rounding per element."""
    return q.float() * scale.float()


def apply_quantized_ref(w: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Fused dequantize-and-apply of a broadcast delta chain.

    w: (R, C) f32; q: (D, R, C) int8; s: (D, R, 1) f32 -> (R, C) f32.  The
    chain accumulates strictly in order, one rounding per step
    (``acc = fl32(acc + q_d * s_d)``), so one D-deep call equals D
    single-step calls bit for bit.
    """
    acc = w.float()
    for d in range(q.shape[0]):
        acc = (acc.double() + q[d].double() * s[d].double()).float()
    return acc
