"""Parameter initialisers and primitive layers of the decoders.

Answers to ``repro/models/nn.py``, for the primitives the decoders use:
``rms_norm``, ``swiglu`` and RoPE, and ``layer_norm`` and ``group_norm``
(RWKV's per-head output norm).  Parameters are plain nested dicts of
tensors in the JAX layout (dense weights ``(in, out)``), so the JAX
package's parameters carry over through ``convert.params_from_numpy``.

Where the reference takes a PRNG key, the port takes a CPU
``torch.Generator``; ``split_keys`` derives child generators from one, so
each submodule's draws depend only on its own generator, as each JAX key
does.  The port's draws are its own: tests that compare with the JAX
package pass the reference's parameters in.

The reference's sharding helpers (``resolve_specs``, ``shardings_for``,
``constrain``, ``set_activation_axes`` and the ``FSDP``/``TP``/``DP``
placeholders) belong with ``launch/specs.py``, which is not ported yet;
``constrain`` is a no-op on one device, so the dense forward leaves its
calls out.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..pytree import leaves, tree_map

Params = Any  # nested dict of tensors

# the standard normal's CDF at -2 and 2, as 2 * Phi(x) - 1 = erf(x / sqrt 2)
_ERF_LO, _ERF_HI = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))


# ---------------------------------------------------------------------------
# initializers


def split_keys(gen: torch.Generator, n: int) -> list[torch.Generator]:
    """``n`` CPU generators seeded from ``gen``'s next draws."""
    seeds = torch.randint(0, 2**62, (n,), generator=gen, dtype=torch.int64, device="cpu")
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


def truncated_normal_init(gen: torch.Generator, shape, dtype, stddev: float) -> torch.Tensor:
    """``stddev`` times a standard normal truncated to [-2, 2], drawn in
    f32 on the CPU by the inverse CDF, then cast to ``dtype``.

    Under ``torch.device("meta")`` it allocates and draws nothing, which is
    how ``lm.count_params_analytic`` reads shapes.
    """
    t = torch.empty(tuple(shape), dtype=torch.float32)
    if t.is_meta:
        return t.to(dtype)
    t.uniform_(_ERF_LO, _ERF_HI, generator=gen).erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return t.mul_(stddev).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_shape, dtype) -> torch.Tensor:
    """Fan-in scaled init for a matmul with contraction dim ``in_dim``."""
    out = tuple(out_shape) if isinstance(out_shape, (tuple, list)) else (out_shape,)
    return truncated_normal_init(gen, (in_dim,) + out, dtype, 1.0 / math.sqrt(in_dim))


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype) -> torch.Tensor:
    return truncated_normal_init(gen, (vocab, dim), dtype, 1.0)


# ---------------------------------------------------------------------------
# primitive layers (pure functions over param dicts)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 RMS norm times ``1 + scale`` (scale starts at zeros), cast back."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """f32 layer norm over the last dim (biased variance), cast back."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """f32 group norm over the last dim cut into ``groups`` equal parts
    (biased variance per group), then a per-channel scale and bias."""
    dt = x.dtype
    *lead, d = x.shape
    xg = x.float().reshape(*lead, groups, d // groups)
    mu = torch.mean(xg, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xg - mu), dim=-1, keepdim=True)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (y * scale.float() + bias.float()).to(dt)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``: it misses ``jax.nn.silu``'s bits on under 1 % of
    f32 values, ``F.silu`` on far more."""
    return x * torch.sigmoid(x)


def chunk_len(cfg, S: int) -> int:
    """A recurrent layer's scan chunk: ``ssm_chunk``, or its gcd with S when
    it does not divide S (as the reference's)."""
    chunk = min(cfg.ssm_chunk, S)
    return math.gcd(S, chunk) if S % chunk else chunk


def remat(fn, *args):
    """``fn(*args)``, through ``torch.utils.checkpoint`` (non-reentrant) when
    grad mode is on: the backward recomputes ``fn`` from its inputs instead
    of keeping its intermediates, as the reference's
    ``jax.checkpoint(nothing_saveable)`` does for a scan's chunk body.  The
    arguments need not require grad (data embeddings do not): the
    parameters ``fn`` closes over get their gradients all the same.  Under
    ``no_grad`` ``fn`` runs plainly.  Inside a block that ``lm``
    checkpoints too, the two nest."""
    if torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def swiglu(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``(silu(x wg) * (x wi)) wo`` in ``x``'s dtype."""
    h = x @ wi.to(x.dtype)
    g = x @ wg.to(x.dtype)
    return (F.silu(g) * h) @ wo.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding in f32.  x: (..., seq, heads, head_dim);
    positions: broadcastable to (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (hd/2,)
    angles = positions[..., :, None, None].float() * freqs  # (..., s, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# misc


def count_params(params: Params) -> int:
    return sum(int(x.numel()) for x in leaves(params))


def cast_tree(params: Params, dtype) -> Params:
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, params)
