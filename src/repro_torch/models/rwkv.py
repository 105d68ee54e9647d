"""RWKV-6 ("Finch") time mixing and channel mixing.

Answers to ``repro/models/rwkv.py``, with the same parameter leaves,
dtypes and cache layout.  The reference replaces the upstream
token-sequential CUDA wkv kernel with a chunked formulation, and so does
the port: within a chunk of C tokens the pairwise decays
``exp(cum_{i-1} - cum_j)`` (at most 1, so they cannot overflow) form a
(B, C, C, H, head_dim) tensor that is contracted with r and k; across
chunks only the (B, H, head_dim, head_dim) f32 state is carried.  The
decay is data dependent (Finch): ``w_t = exp(-exp(w0 + tanh(x W_a) W_b))``.

- ``_wkv_chunk`` is the reference's chunk body.  Its three-operand einsum
  ``"bihc,bjhc,bijhc->bhij"`` is contracted as ``(r_i * E_ij) * k_j``
  summed over the channel, so nothing larger than the decay tensor is
  built;
- the reference's ``lax.scan`` over chunks is a loop here, and each chunk
  body runs through ``nn.remat`` (the reference's ``jax.checkpoint(
  nothing_saveable)``): under autograd the backward recomputes a chunk
  instead of keeping its decay tensor (537 MB at rwkv6-7b's width, B 8, C
  64), nested inside ``lm``'s block checkpoint when ``cfg.remat`` is set;
- decode is the exact one-step recurrence, ``_wkv_step``.  It writes the
  cache (token shifts and state) in place and returns it, as the
  attention layers' decode does.

``silu`` is ``x * sigmoid(x)`` (``nn.silu``).  ``time_mix_specs`` and
``channel_mix_specs`` are the sharding twins of the two inits; the cache's
specs come from ``rwkv_cache_specs(cfg)``, beside ``rwkv_cache_shape``
(the reference's returns both).
"""
from __future__ import annotations

import torch

from ..pytree import tree_map
from . import nn
from .nn import DP, FSDP, TP, P, dense_init

HEAD_DIM = 64
DECAY_LORA = 64


def num_heads(cfg) -> int:
    return cfg.d_model // HEAD_DIM


def init_time_mix(gen: torch.Generator, cfg) -> nn.Params:
    d = cfg.d_model
    ks = nn.split_keys(gen, 8)
    dt = cfg.pdtype
    p = {f"mix_{n}": torch.full((d,), 0.5, dtype=dt) for n in "rkvwg"}
    p.update({
        "w_r": dense_init(ks[0], d, (d,), dt),
        "w_k": dense_init(ks[1], d, (d,), dt),
        "w_v": dense_init(ks[2], d, (d,), dt),
        "w_g": dense_init(ks[3], d, (d,), dt),
        "w_o": dense_init(ks[4], d, (d,), dt),
        # data-dependent decay LoRA
        "decay_a": dense_init(ks[5], d, (DECAY_LORA,), dt),
        "decay_b": dense_init(ks[6], DECAY_LORA, (d,), dt),
        "decay_0": torch.full((d,), -6.0, dtype=torch.float32),
        "bonus_u": torch.zeros((d,), dtype=torch.float32),
        "ln_scale": torch.ones((d,), dtype=dt),
        "ln_bias": torch.zeros((d,), dtype=dt),
    })
    return p


def time_mix_specs(cfg) -> nn.Specs:
    mat = P(FSDP, TP)
    vec = P(None)
    return {
        "mix_r": vec, "mix_k": vec, "mix_v": vec, "mix_w": vec, "mix_g": vec,
        "w_r": mat, "w_k": mat, "w_v": mat, "w_g": mat,
        "w_o": P(TP, FSDP),
        "decay_a": P(FSDP, None), "decay_b": P(None, TP),
        "decay_0": vec, "bonus_u": vec, "ln_scale": vec, "ln_bias": vec,
    }


def init_channel_mix(gen: torch.Generator, cfg) -> nn.Params:
    d, dff = cfg.d_model, cfg.d_ff
    ks = nn.split_keys(gen, 3)
    dt = cfg.pdtype
    return {
        "mix_k": torch.full((d,), 0.5, dtype=dt),
        "mix_r": torch.full((d,), 0.5, dtype=dt),
        "w_k": dense_init(ks[0], d, (dff,), dt),
        "w_v": dense_init(ks[1], dff, (d,), dt),
        "w_r": dense_init(ks[2], d, (d,), dt),
    }


def channel_mix_specs(cfg) -> nn.Specs:
    return {
        "mix_k": P(None), "mix_r": P(None),
        "w_k": P(FSDP, TP), "w_v": P(TP, FSDP), "w_r": P(FSDP, TP),
    }


def _shift(x, prev):
    """Token shift: x: (B, S, d), prev: (B, d) -> prev then x without its last token."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _mix(x, xs, m):
    return x + (xs - x) * m.to(x.dtype)


def _shifted(x, cache):
    """The token-shifted input: the cache's last token (zeros without a
    cache) before ``x``'s first."""
    B, S, d = x.shape
    prev = cache["shift"] if cache is not None else x.new_zeros((B, d))
    return _shift(x, prev) if S > 1 else prev[:, None, :]


def _wkv_chunk(r, k, v, lw, u, state):
    """One chunk of the wkv recurrence.

    r, k, v: (B, C, H, hd); lw: (B, C, H, hd) f32 log-decays (<= 0); u:
    (H, hd) bonus; state: (B, H, hd, hd) f32, state[b, h, c_k, c_v] =
    sum_j k_j[c_k] D_j v_j[c_v].  Returns (out (B, C, H, hd) in r's dtype,
    the new state).
    """
    C = r.shape[1]
    rf, kf, vf = r.float(), k.float(), v.float()
    cum = torch.cumsum(lw, dim=1)  # inclusive
    cum_prev = cum - lw  # exclusive (cum_{i-1})

    # inter-chunk: o_i += (r_i * exp(cum_prev_i)) @ state
    o_inter = torch.einsum("bchk,bhkv->bchv", rf * torch.exp(cum_prev), state)

    # intra-chunk: A_ij = sum_c r_i[c] k_j[c] exp(cum_prev_i[c] - cum_j[c]) (j < i)
    #              A_ii = sum_c r_i[c] k_i[c] u[c]
    E = torch.exp(torch.clamp(cum_prev[:, :, None] - cum[:, None, :], -60.0, 0.0))  # (B,C,C,H,hd)
    A = (rf[:, :, None] * E * kf[:, None]).sum(-1).permute(0, 3, 1, 2)  # (B, H, i, j)
    del E
    ar = torch.arange(C, device=r.device)
    A = A * (ar[:, None] > ar[None, :]).float()
    diag = (rf * kf * u).sum(-1).transpose(1, 2)  # (B, H, C)
    A = A + torch.eye(C, dtype=torch.float32, device=r.device) * diag[..., None]
    o_intra = torch.einsum("bhij,bjhv->bihv", A, vf)

    # state update: S' = exp(cum_C) * S + sum_j (k_j * exp(cum_C - cum_j)) v_j^T
    cum_all = cum[:, -1]  # (B, H, hd)
    k_dec = kf * torch.exp(torch.clamp(cum_all[:, None] - cum, -60.0, 0.0))
    state_new = torch.exp(cum_all)[..., None] * state + torch.einsum("bchk,bchv->bhkv", k_dec, vf)
    return (o_inter + o_intra).to(r.dtype), state_new


def _wkv_step(r, k, v, w, u, state):
    """The exact one-token recurrence.  r, k, v: (B, H, hd) f32; w: (B, H,
    hd) decays; u: (H, hd); state: (B, H, hd, hd) f32.  Returns (out (B, H,
    hd), the new state)."""
    kv = k[..., :, None] * v[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", r, state + u[None, :, :, None] * kv)
    return o, w[..., None] * state + kv


def time_mix_forward(p, cfg, x, *, mode, cache=None):
    """x: (B, S, d). cache: {'shift': (B, d), 'state': (B, H, hd, hd) f32}.

    Returns (out, new_cache).  Decode writes the token's shift and state
    into ``cache`` and returns it.
    """
    B, S, d = x.shape
    H = num_heads(cfg)
    xs = _shifted(x, cache)
    xr, xk, xv, xw, xg = (_mix(x, xs, p[f"mix_{n}"]) for n in "rkvwg")

    def w(name):
        return p[name].to(x.dtype)

    r, k, v = xr @ w("w_r"), xk @ w("w_k"), xv @ w("w_v")
    g = nn.silu(xg @ w("w_g"))
    # data-dependent decay (Finch): lw = -exp(w0 + tanh(xw A) B)  (log w, <= 0)
    dec = (torch.tanh(xw @ w("decay_a")) @ w("decay_b")).float()
    lw = -torch.exp(p["decay_0"] + dec)  # (B, S, d) f32

    r, k, v, lw = (t.reshape(B, S, H, HEAD_DIM) for t in (r, k, v, lw))
    u = p["bonus_u"].reshape(H, HEAD_DIM).float()
    state0 = (cache["state"].float() if cache is not None
              else torch.zeros((B, H, HEAD_DIM, HEAD_DIM), dtype=torch.float32, device=x.device))

    if mode == "decode":
        o, state_new = _wkv_step(*(t[:, 0].float() for t in (r, k, v)), torch.exp(lw[:, 0]), u,
                                 state0)
        out = o.reshape(B, 1, d).to(x.dtype)
    else:
        chunk = nn.chunk_len(cfg, S)
        outs, state_new = [], state0
        for c0 in range(0, S, chunk):
            sl = slice(c0, c0 + chunk)
            o, state_new = nn.remat(_wkv_chunk, r[:, sl], k[:, sl], v[:, sl], lw[:, sl], u,
                                    state_new)
            outs.append(o)
        out = torch.cat(outs, dim=1).reshape(B, S, d)

    out = nn.group_norm(out, p["ln_scale"], p["ln_bias"], groups=H)
    out = (out * g) @ w("w_o")
    if mode == "decode":
        cache["shift"].copy_(x[:, -1])
        cache["state"].copy_(state_new)
        return out, cache
    return out, {"shift": x[:, -1, :], "state": state_new}


def channel_mix_forward(p, cfg, x, *, mode, cache=None):
    """x: (B, S, d). cache: {'shift': (B, d)}.  Returns (out, new_cache);
    decode writes the token's shift into ``cache`` and returns it."""
    xs = _shifted(x, cache)
    xk = _mix(x, xs, p["mix_k"])
    xr = _mix(x, xs, p["mix_r"])
    k = torch.square(torch.relu(xk @ p["w_k"].to(x.dtype)))
    kv = k @ p["w_v"].to(x.dtype)
    out = torch.sigmoid(xr @ p["w_r"].to(x.dtype)) * kv
    if mode == "decode":
        cache["shift"].copy_(x[:, -1])
        return out, cache
    return out, {"shift": x[:, -1, :]}


def rwkv_cache_shape(cfg, batch: int, max_len: int) -> dict:
    """The cache's shapes and dtypes as meta tensors (no allocation):
    ``tm`` for the time mix, ``cm`` for the channel mix; no sequence axis."""
    del max_len
    shift = torch.empty((batch, cfg.d_model), dtype=cfg.adtype, device="meta")
    state = torch.empty((batch, num_heads(cfg), HEAD_DIM, HEAD_DIM), dtype=torch.float32,
                        device="meta")
    return {"tm": {"shift": shift, "state": state}, "cm": {"shift": shift}}


def rwkv_cache_specs(cfg) -> dict:
    return {
        "tm": {"shift": P(DP, None), "state": P(DP, TP, None, None)},
        "cm": {"shift": P(DP, None)},
    }


def rwkv_init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device),
                    rwkv_cache_shape(cfg, batch, max_len))
