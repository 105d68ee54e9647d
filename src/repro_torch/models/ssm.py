"""Mamba selective-SSM block (jamba's mixer).

Answers to ``repro/models/ssm.py``, with the same parameter leaves,
dtypes and cache layout.  The reference replaces the upstream CUDA
selective-scan kernel with a chunked formulation, and so does the port: a
sequential loop over chunks of the sequence (the reference's ``lax.scan``)
carries the (B, d_inner, d_state) f32 state, and inside each chunk a
log-depth scan (``associative_scan``) combines the per-token
``(a, b·u)`` pairs.

- ``associative_scan`` is ``jax.lax.associative_scan``'s algorithm written
  on tensors: combine adjacent pairs, recurse on the result, combine the
  odd results with the even inputs, interleave.  With the same pairing it
  does the products the reference does; XLA may contract ``a_r·b_l + b_r``
  into an FMA, so the two agree fp-tight, not bit for bit;
- each chunk body runs through ``nn.remat`` (the reference's
  ``jax.checkpoint(nothing_saveable)``): under autograd the backward
  recomputes a chunk instead of keeping its (B, C, d_inner, d_state)
  scan tensors for every chunk;
- decode is the conv history and the one-step state update.  It writes
  the cache (``conv``, ``h``) in place and returns it, as the attention
  layers' decode does.

Weights are cast to the activations' dtype at each use (jamba keeps f32
parameters with bf16 activations); ``dt``, ``A``, the state and the scan
are f32, the conv history in the activation dtype.  ``silu`` is ``x *
sigmoid(x)`` (``nn.silu``); ``softplus`` is ``logaddexp(x, 0)``, the
reference's formula.

One divergence, where the reference breaks: a prefill of fewer than
``d_conv - 1`` tokens.  The reference slices ``x[:, S - (d_conv - 1):]``,
whose start is then negative, and returns a conv cache of the wrong
length; the port keeps the last ``d_conv - 1`` inputs of the zero-padded
sequence, the history the causal conv itself saw.  From ``d_conv - 1``
tokens on the two are the same slice.

``mamba_specs`` is the sharding twin of ``init_mamba`` (the inner width
over ``model``); the cache's specs come from ``mamba_cache_specs(cfg)``,
beside ``mamba_cache_shape`` (the reference's returns both).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..pytree import tree_map
from . import nn
from .nn import DP, FSDP, TP, P, dense_init


def d_inner(cfg) -> int:
    return cfg.expand * cfg.d_model


def dt_rank(cfg) -> int:
    return max(16, cfg.d_model // 16)


def init_mamba(gen: torch.Generator, cfg) -> nn.Params:
    d, di, ds, dc, dr = cfg.d_model, d_inner(cfg), cfg.d_state, cfg.d_conv, dt_rank(cfg)
    ks = nn.split_keys(gen, 6)
    dt = cfg.pdtype
    A = torch.arange(1, ds + 1, dtype=torch.float32).expand(di, ds)
    return {
        "in_proj": dense_init(ks[0], d, (2 * di,), dt),
        "conv_w": dense_init(ks[1], dc, (di,), dt),  # depthwise causal conv
        "conv_b": torch.zeros((di,), dtype=dt),
        "x_proj": dense_init(ks[2], di, (dr + 2 * ds,), dt),
        "dt_w": dense_init(ks[3], dr, (di,), dt),
        "dt_b": torch.full((di,), -4.6, dtype=dt),  # softplus^-1(0.01) ~= -4.6
        "A_log": torch.log(A),
        "D": torch.ones((di,), dtype=torch.float32),
        "out_proj": dense_init(ks[4], di, (d,), dt),
    }


def mamba_specs(cfg) -> nn.Specs:
    return {
        "in_proj": P(FSDP, TP),
        "conv_w": P(None, TP),
        "conv_b": P(TP),
        "x_proj": P(TP, None),
        "dt_w": P(None, TP),
        "dt_b": P(TP),
        "A_log": P(TP, None),
        "D": P(TP),
        "out_proj": P(TP, FSDP),
    }


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x, w, b):
    """x: (B, S, di); w: (dc, di) depthwise; left-padded causal conv, the
    taps summed from tap 0 as the reference's ``sum``."""
    dc, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, dc - 1, 0))
    out = sum(xp[:, i : i + S, :] * w[i] for i in range(dc))
    return out + b


def _x_dt_bc(p, cfg, x):
    """From the conv's activated output x (B, S, di): dt (B, S, di) f32 and
    the B and C projections (B, S, d_state) f32."""
    dr, ds = dt_rank(cfg), cfg.d_state
    proj = x @ p["x_proj"].to(x.dtype)
    dt_in, Bm, Cm = proj.split([dr, ds, ds], dim=-1)
    dt = _softplus((dt_in @ p["dt_w"].to(x.dtype)).float() + p["dt_b"].float())
    return dt, Bm.float(), Cm.float()


def _ssm_inputs(p, cfg, xz):
    """From in_proj's output: (x_raw, x_conv, z, dt, A, Bm, Cm)."""
    x_raw, z = xz.chunk(2, dim=-1)
    x = nn.silu(_causal_conv(x_raw, p["conv_w"].to(x_raw.dtype), p["conv_b"].to(x_raw.dtype)))
    dt, Bm, Cm = _x_dt_bc(p, cfg, x)
    A = -torch.exp(p["A_log"])  # (di, ds), negative
    return x_raw, x, z, dt, A, Bm, Cm


def _combine(left, right):
    """The first-order recurrence's operator: (a_l a_r, a_r b_l + b_r)."""
    al, bl = left
    ar, br = right
    return al * ar, ar * bl + br


def _interleave(even, odd, dim: int):
    """even[0], odd[0], even[1], ... along ``dim`` (even one longer, or as long)."""
    n = odd.shape[dim]
    both = torch.stack([even.narrow(dim, 0, n), odd], dim=dim + 1).flatten(dim, dim + 1)
    if even.shape[dim] > n:
        both = torch.cat([both, even.narrow(dim, n, 1)], dim=dim)
    return both


def associative_scan(fn, elems, dim: int):
    """Inclusive scan of the tuple ``elems`` along ``dim`` under the
    associative ``fn(left, right)``, in ``jax.lax.associative_scan``'s
    pairing: adjacent pairs combined, the scan of those by recursion, then
    each odd result combined with the next even input, interleaved."""
    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.dim()
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    def scan(elems):
        n = elems[0].shape[dim]
        if n < 2:
            return elems
        reduced = fn([sl(e, 0, -1, 2) for e in elems], [sl(e, 1, None, 2) for e in elems])
        odd = scan(reduced)
        left = [sl(e, 0, -1) for e in odd] if n % 2 == 0 else odd
        even = fn(left, [sl(e, 2, None, 2) for e in elems])
        even = [torch.cat([sl(e, 0, 1), r], dim=dim) for e, r in zip(elems, even)]
        return [_interleave(e, o, dim) for e, o in zip(even, odd)]

    return tuple(scan(list(elems)))


def _scan_chunk(dt, A, Bm, Cm, x, D, h):
    """One chunk: dt, x (B, C, di) f32; Bm, Cm (B, C, ds) f32; A (di, ds); D
    (di,); h (B, di, ds) the state before the chunk.  Returns (y (B, C,
    di), the state after the chunk's last token)."""
    a = torch.exp(dt[..., None] * A)  # (B, C, di, ds)
    bu = dt[..., None] * Bm[:, :, None, :] * x[..., None]  # (B, C, di, ds)
    a_sc, b_sc = associative_scan(_combine, (a, bu), dim=1)
    hs = a_sc * h[:, None] + b_sc
    y = torch.einsum("bcis,bcs->bci", hs, Cm) + D * x
    return y, hs[:, -1]


def selective_scan(dt, A, Bm, Cm, x, D, h0, chunk: int):
    """The chunk loop: ``_scan_chunk`` over consecutive chunks of ``chunk``
    tokens, each under ``nn.remat``, the state carried.  Returns (y (B, S,
    di) f32, the last state)."""
    ys, h = [], h0
    for c0 in range(0, dt.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        y, h = nn.remat(_scan_chunk, dt[:, sl], A, Bm[:, sl], Cm[:, sl], x[:, sl], D, h)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _ssm_step(a, bu, h):
    """The one-token state update: h' = a h + b u, all (B, di, ds) f32."""
    return a * h + bu


def mamba_forward(p, cfg, x_in, *, mode, cache=None):
    """x_in: (B, S, d).  cache: {'conv': (B, d_conv - 1, di), 'h': (B, di,
    ds) f32}.  Returns (out, new_cache): None in train mode; decode writes
    the conv history and the state into ``cache`` and returns it."""
    B, S, d = x_in.shape
    di, ds, dc = d_inner(cfg), cfg.d_state, cfg.d_conv
    xz = x_in @ p["in_proj"].to(x_in.dtype)

    if mode == "decode":
        x, z = xz.chunk(2, dim=-1)
        conv_hist = torch.cat([cache["conv"], x], dim=1)  # (B, dc, di)
        xc = (conv_hist * p["conv_w"].to(x.dtype)).sum(1) + p["conv_b"].to(x.dtype)
        xc = nn.silu(xc)[:, None, :]
        dt, Bm, Cm = _x_dt_bc(p, cfg, xc)
        A = -torch.exp(p["A_log"])
        a = torch.exp(dt[:, 0, :, None] * A)  # (B, di, ds)
        bu = dt[:, 0, :, None] * Bm[:, 0, None, :] * xc[:, 0, :, None].float()
        h = _ssm_step(a, bu, cache["h"])
        y = torch.einsum("bis,bs->bi", h, Cm[:, 0]) + p["D"] * xc[:, 0].float()
        y = y[:, None, :].to(x_in.dtype) * nn.silu(z)
        out = y @ p["out_proj"].to(x_in.dtype)
        cache["conv"].copy_(conv_hist[:, 1:])
        cache["h"].copy_(h)
        return out, cache

    x_raw, x, z, dt, A, Bm, Cm = _ssm_inputs(p, cfg, xz)
    h0 = (cache["h"] if cache is not None and mode == "prefill"
          else torch.zeros((B, di, ds), dtype=torch.float32, device=x_in.device))
    y, h_last = selective_scan(dt, A, Bm, Cm, x.float(), p["D"], h0, nn.chunk_len(cfg, S))
    y = y.to(x_in.dtype) * nn.silu(z)
    out = y @ p["out_proj"].to(x_in.dtype)
    if mode != "prefill":
        return out, None
    # the last d_conv - 1 inputs of the zero-padded sequence the conv saw
    conv = F.pad(x_raw, (0, 0, dc - 1, 0))[:, S:]
    return out, {"conv": conv.to(cfg.adtype), "h": h_last}


def mamba_cache_shape(cfg, batch: int, max_len: int) -> dict:
    """The cache's shapes and dtypes as meta tensors (no allocation)."""
    del max_len
    di = d_inner(cfg)
    return {
        "conv": torch.empty((batch, cfg.d_conv - 1, di), dtype=cfg.adtype, device="meta"),
        "h": torch.empty((batch, di, cfg.d_state), dtype=torch.float32, device="meta"),
    }


def mamba_cache_specs(cfg) -> dict:
    return {"conv": P(DP, None, TP), "h": P(DP, TP, None)}


def mamba_init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device),
                    mamba_cache_shape(cfg, batch, max_len))
