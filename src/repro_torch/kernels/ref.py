"""Plain PyTorch versions of the ported kernels (the correctness contract).

Each function computes what its CUDA kernel computes, in the same
arithmetic type and with the same roundings, with ordinary tensor
operations.  The wrappers use them for tensors that lie on the CPU;
``chip_smoke.py`` and the card-only tests hold each kernel against them
on the card.

Three rounding rules keep the QSGD, chain-apply and fused-update
versions bit-equal to the JAX package's compiled path:

- XLA turns the division by the constant ``levels`` into a multiply by
  the f32 reciprocal, so ``quantize_ref`` forms ``max|x| * fl32(1/levels)``;
  the eager, non-256-chunk path divides (``quantize_ref_truediv``);
- JAX's f32 -> int8 cast saturates where PyTorch's wraps
  (``floor(x/scale + r)`` can reach 128), so both clamp to [-128, 127];
- XLA contracts ``acc + q * s`` into one fused multiply-add, so
  ``apply_quantized_ref`` rounds once per chain step (``fma_f32``: the
  product is exact in f64, and the double rounding of the f64 sum to f32
  is undone).  XLA contracts the fused update into three such steps,
  which ``fused_update_ref`` repeats.

The Algorithm-1 policy update has no bit-exact reference: XLA sums its
rows in an order of its own, and permuted candidates that tie in exact
arithmetic do not tie there.  ``policy_update_ref`` and its kernel sum
every row in f64 in one fixed order (``warp_sum``, the CUDA kernel's
lane-and-butterfly order) and round the sum to f32, so the candidates
tie exactly, on every device, and argmin / argmax take the first index.
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


def tree_aggregate_groups_chain(grads: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``tree_aggregate_groups_ref`` as the CUDA kernel sums, bit for bit:
    each output element is the chain ``acc = fma(w[g, c], x[g, c, l], acc)``
    in c order from ``acc = 0``, every step rounded once (``fma_f32``).

    (G, C, L) f32, bf16 or int8 x (G, C) -> (G, L) f32.  Exact on any
    device; the kernels' check on the card, while the wrappers' CPU path
    keeps ``tree_aggregate_groups_ref``.
    """
    x, w = grads.float(), weights.float()
    acc = torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32, device=x.device)
    for c in range(x.shape[1]):
        acc = fma_f32(w[:, c : c + 1], x[:, c], acc)
    return acc


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


def quantize_residual_ref(x: torch.Tensor, rand: torch.Tensor, levels: int = 127):
    """``quantize_ref`` and the error-feedback residual ``x - q * scale``:
    (q, scale, residual f32 (R, C)).  Two roundings, ``fl(q * s)`` then
    the subtraction, as the reference dequantizes and then subtracts."""
    q, scale = quantize_ref(x, rand, levels)
    return q, scale, x.float() - dequantize_ref(q, scale)


def apply_quantized_ref(w: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Fused dequantize-and-apply of a broadcast delta chain.

    w: (R, C) f32; q: (D, R, C) int8; s: (D, R, 1) f32 -> (R, C) f32.  The
    chain accumulates strictly in order, one rounding per step
    (``acc = fma(q_d, s_d, acc)``), so one D-deep call equals D
    single-step calls bit for bit.
    """
    acc = w.float()
    for d in range(q.shape[0]):
        acc = fma_f32(q[d].float(), s[d].float(), acc)
    return acc


def fma_f32(a, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``fl32(a * b + c)`` rounded once, as ``__fmaf_rn`` does; f32 inputs
    (``a`` may be a Python float holding an f32 value).

    ``a * b`` is exact in f64 and ``s = fl64(a*b + c)`` rounds once; the
    f32 rounding of ``s`` is then right unless ``s`` landed exactly on a
    midpoint between two f32 values while the exact sum did not.  The
    f64 sum's error ``e`` (TwoSum) says which side the exact sum lies on.
    """
    b64, c64 = b.double(), c.double()
    p = b64 * a if isinstance(a, float) else a.double() * b64
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    r = s.float()
    r64 = r.double()
    inf = torch.full_like(r, float("inf"))
    other = torch.nextafter(r, torch.where(s > r64, inf, -inf))  # the f32 across s
    tie = (r64 + other.double() == 2.0 * s) & (e != 0) & torch.isfinite(e)
    return torch.where(tie, torch.where(e > 0, torch.maximum(r, other), torch.minimum(r, other)), r)


def fused_update_ref(w: torch.Tensor, g: torch.Tensor, w0: torch.Tensor,
                     lr: float, mu: float, wd: float) -> torch.Tensor:
    """Fused SGD + FedProx proximal term + weight decay,
    ``w' = w - lr * (g + mu*(w - w0) + wd*w)``, computed in f32 and
    returned in ``w.dtype`` (bf16 rounds to nearest even).

    The arithmetic of XLA's compiled reference: ``t = fl32(w - w0)``, then
    three fused multiply-adds, ``a = fma(mu, t, g)``, ``b = fma(wd, w, a)``,
    ``w' = fma(-lr, b, w)``, with lr, mu and wd rounded to f32.

    At ``mu = wd = 0`` (their f32 values) the step is ``fma(-lr, g, w)``,
    one rounding, and ``w0`` is not read: the chain's values wherever
    ``w - w0`` is finite (``fma(0, t, g) = g``), and a finite step where
    the chain would carry a NaN in from ``0 * inf`` (ROADMAP parity rule 8).
    The kernel takes the same shortcut.
    """
    lr, mu, wd = (float(np.float32(v)) for v in (lr, mu, wd))
    wf, gf = w.float(), g.float()
    if mu == 0.0 and wd == 0.0:
        return fma_f32(-lr, gf, wf).to(w.dtype)
    w0f = w0.float()
    a = fma_f32(mu, wf - w0f, gf)
    b = fma_f32(wd, wf, a)
    return fma_f32(-lr, b, wf).to(w.dtype)


def warp_sum(x: torch.Tensor) -> torch.Tensor:
    """f64 sum over the last axis (K <= 64) in the policy-update kernel's
    order: lane l holds ``0.0 + x[l] + x[l + 32]``, then a butterfly adds
    lane l ^ off for off = 16, 8, 4, 2, 1.  Lanes past K hold exact
    zeros, so the butterfly may start at the first power of two >= K."""
    x = x.double()
    K = x.shape[-1]
    width = 32 if K > 32 else 1 << (K - 1).bit_length()
    x = torch.nn.functional.pad(x, (0, (64 if K > 32 else width) - K))
    acc = torch.zeros_like(x[..., :width]) + x[..., :width]
    if K > 32:
        acc = acc + x[..., 32:]
    while width > 1:
        width //= 2
        acc = acc[..., :width] + acc[..., width:]
    return acc[..., 0]


def policy_update_ref(pi: torch.Tensor, mask: torch.Tensor, cand: torch.Tensor,
                      reward_sums: torch.Tensor, tau: int, alpha: float,
                      beta: float) -> torch.Tensor:
    """Algorithm-1 episode update, lines 5-8, with one-hot features.

    pi (N, K) f32, mask (N, K) bool, cand (M, K) f32, reward_sums (N, K)
    f32 (``sum_t 1[a_t = k] r_t``) -> (N, K) f32, as
    ``repro/kernels/ref.py::policy_update_ref``:

    - line 5: each candidate re-normalised onto the node's valid hops;
      rho = the candidate of least ``sum_k log max(candn_k, 1e-12)``;
    - line 6: ``grad = rsum / (tau * max(pi, 1e-12)) * mask``;
    - line 7: pi~ = the candidate of largest ``<candn, grad>``;
    - line 8: ``alpha (pi + beta (pi~ - pi)) + (1 - alpha) rho`` on the
      mask, re-normalised.

    Row sums, log-determinants and scores are ``warp_sum`` f64 sums
    rounded to f32; ties go to the first index.  Every f32 step rounds
    once, in the order written (no contraction).
    """
    candn, rho_i, tilde_i = policy_choices(pi, mask, cand, reward_sums, tau)
    rows = torch.arange(pi.shape[0], device=pi.device)
    rho, pi_t = candn[rows, rho_i], candn[rows, tilde_i]
    alpha32, beta32 = np.float32(alpha), np.float32(beta)
    one_minus_alpha = float(np.float32(1.0) - alpha32)
    mixed = (pi + (pi_t - pi) * float(beta32)) * float(alpha32) + rho * one_minus_alpha
    mixed = mixed * mask.to(torch.float32)
    return mixed / torch.clamp_min(warp_sum(mixed).to(torch.float32), 1e-12)[:, None]


def policy_choices(pi: torch.Tensor, mask: torch.Tensor, cand: torch.Tensor,
                   reward_sums: torch.Tensor, tau: int):
    """Lines 5-7 of ``policy_update_ref``: the re-normalised candidates
    (N, M, K) f32, rho's index (N,) and pi~'s index (N,)."""
    f = torch.float32
    maskf = mask.to(f)
    candm = cand[None] * maskf[:, None, :]  # (N, M, K)
    denom = torch.clamp_min(warp_sum(candm).to(f), 1e-12)
    candn = candm / denom[..., None]
    logs = torch.log(torch.clamp_min(candn, 1e-12)).double()
    logdet = warp_sum(torch.where(mask[:, None, :], logs, torch.zeros_like(logs))).to(f)
    grad = reward_sums / (float(tau) * torch.clamp_min(pi, 1e-12)) * maskf
    scores = warp_sum(candn.double() * grad.double()[:, None, :]).to(f)
    return candn, torch.argmin(logdet, dim=1), torch.argmax(scores, dim=1)
