"""Small models for the FL rounds: an MLP and a tiny CNN.

Answers to ``repro/fl/small_models.py``.  Parameters are dicts in the JAX
layout (dense ``(in, out)``, convolutions HWIO, images NHWC), so the JAX
package's parameters carry over through ``convert.params_from_numpy``.

Every logits function also takes *stacked* parameters with a leading
worker axis ``(W, ...)`` and inputs ``(W, B, ...)``: the round engine
trains all workers at once that way (the port's counterpart of ``vmap``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..pytree import tree_map


def _trunc_normal(gen: torch.Generator, shape, stddev: float) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``stddev``
    (``repro/models/nn.truncated_normal_init``)."""
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
    return stddev * t


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int) -> torch.Tensor:
    """Fan-in scaled init for an ``(in_dim, out_dim)`` matmul weight."""
    return _trunc_normal(gen, (in_dim, out_dim), 1.0 / math.sqrt(in_dim))


def init_mlp(gen: torch.Generator, dim: int, hidden: int, num_classes: int, *, device="cpu"):
    p = {
        "w1": dense_init(gen, dim, hidden),
        "b1": torch.zeros(hidden),
        "w2": dense_init(gen, hidden, hidden),
        "b2": torch.zeros(hidden),
        "w3": dense_init(gen, hidden, num_classes),
        "b3": torch.zeros(num_classes),
    }
    return tree_map(lambda t: t.to(device), p)


def init_cnn(gen: torch.Generator, num_classes: int, channels: int = 16, *, device="cpu"):
    """Tiny conv net over 16x16x1 images; weights HWIO."""
    p = {
        "conv1": 0.1 * torch.randn((3, 3, 1, channels), generator=gen),
        "conv2": 0.1 * torch.randn((3, 3, channels, channels * 2), generator=gen),
        "head": dense_init(gen, 4 * 4 * channels * 2, num_classes),
    }
    return tree_map(lambda t: t.to(device), p)


def mlp_logits(params, x):
    """x: (..., B, dim) with params of matching leading dims."""
    h = torch.relu(x @ params["w1"] + params["b1"].unsqueeze(-2))
    h = torch.relu(h @ params["w2"] + params["b2"].unsqueeze(-2))
    return h @ params["w3"] + params["b3"].unsqueeze(-2)


def _conv_same_s2(h, w_hwio, workers: int):
    """JAX's ``SAME`` 3x3 stride-2 conv over W workers at once.

    h: (B, W*Cin, H, H) NCHW with the workers' channels side by side;
    w_hwio: (W, 3, 3, Cin, Cout).  On an even size, SAME at stride 2 pads
    only the high side by one; the workers run as conv groups.
    """
    cin = w_hwio.shape[3]
    w = w_hwio.permute(0, 4, 3, 1, 2).reshape(-1, cin, 3, 3)  # (W*Cout, Cin, 3, 3)
    return F.conv2d(F.pad(h, (0, 1, 0, 1)), w, stride=2, groups=workers)


def cnn_logits_stacked(params, x):
    """x: (W, B, 16, 16, 1) NHWC per worker; params stacked (W, ...)."""
    W, B = x.shape[:2]
    h = x.permute(1, 0, 4, 2, 3).reshape(B, W * x.shape[-1], *x.shape[2:4])
    h = torch.relu(_conv_same_s2(h, params["conv1"], W))
    h = torch.relu(_conv_same_s2(h, params["conv2"], W))
    c, hh, ww = h.shape[1] // W, h.shape[2], h.shape[3]
    # back to per-worker NHWC, flattened in H, W, C order as the reference
    h = h.reshape(B, W, c, hh, ww).permute(1, 0, 3, 4, 2).reshape(W, B, hh * ww * c)
    return h @ params["head"]


def cnn_logits(params, x):
    """x: (B, 16, 16, 1) NHWC; params HWIO."""
    return cnn_logits_stacked(tree_map(lambda t: t[None], params), x[None])[0]


def ce_loss(logits, y):
    return -torch.log_softmax(logits, dim=-1).gather(-1, y[..., None].long())[..., 0].mean()


def accuracy(logits, y):
    return (logits.argmax(-1) == y).float().mean()


def local_train(params, global_params, x, y, *, logits_fn, steps: int, lr: float, mu: float = 0.0):
    """E local SGD steps with the optional FedProx proximal term; returns
    (new_params, mean of the E losses, each taken before its update).

    Autograd differentiates the cross-entropy; each step is one
    ``fused_update_leaves`` call over every leaf, which adds the proximal gradient
    ``mu * (w - w0)``.  The loss reported includes ``0.5 mu ||w - w0||^2``.
    """
    keys = sorted(params)
    p = [params[k].detach().clone().contiguous().requires_grad_(True) for k in keys]
    anchor = [global_params[k].detach().contiguous() for k in keys]
    losses = []
    for _ in range(steps):
        loss = ce_loss(logits_fn(dict(zip(keys, p)), x), y)
        grads = torch.autograd.grad(loss, p)
        with torch.no_grad():
            loss = loss.detach()
            if mu > 0:  # the reported loss keeps the proximal term
                loss = loss + 0.5 * mu * sum(((a - b) ** 2).sum() for a, b in zip(p, anchor))
            p = [w.requires_grad_(True) for w in kops.fused_update_leaves(
                [w.detach() for w in p], grads, anchor, lr=lr, mu=mu, donate=True)]
        losses.append(loss)
    return {k: w.detach() for k, w in zip(keys, p)}, torch.stack(losses).mean()


LOGITS = {"mlp": mlp_logits, "cnn": cnn_logits}
LOGITS_STACKED = {"mlp": mlp_logits, "cnn": cnn_logits_stacked}
