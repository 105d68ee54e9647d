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

On a mesh (a DTensor ``x``, train mode only: the sharded train step of
``fl/steps``) both mixers run the same code, whose ``nn.constrain``,
``nn.gather_fsdp`` and ``nn.per_rank`` calls are the identity on plain
tensors:

- the input, the sequence-parallel residual ``("dp", "sp", None)``, is
  gathered over the sequence once a sublayer, to ``("dp", None, None)``,
  before the token shift, which needs each sequence shard's first token's
  predecessor; the shift's zeros are placed as the batch is;
- the time mix's r, k, v and g are ``("dp", None, "tp")`` (the
  reference's constraints), every weight gathered over its FSDP axes; the
  decay LoRA runs per rank (``_placed_decay_lora``): ``tanh(x A)`` whole
  on each ``tp`` rank, ``@ B`` channel-sharded, so ``lw`` is too;
- the chunk loop and the group norm run on each rank's whole heads
  through ``nn.per_rank`` (``_heads_wkv``), with the rank's slices of
  ``bonus_u``, ``ln_scale`` and ``ln_bias``; their gradients are partial
  sums over ``dp``.  Where ``tp`` does not divide the heads (a reduced
  config's 2 heads on 4 ``model`` ranks: half a head each), r, k, v and
  ``lw`` are gathered to whole heads and every ``model`` rank runs every
  head, then takes its channel slice back before ``* g``: the reference's
  math (its constraint splits the channels; XLA runs the head's
  contraction over the split); ``w_o`` leaves a partial sum over ``tp``;
- the channel mix's key is ``("dp", None, "tp")`` (the reference's
  constraint) and ``k @ w_v`` a partial sum over ``tp``.  Its gate's
  product sits at one placement: ``kv`` is reduce-scattered over its
  channels to meet ``sigmoid(x w_r)`` at ``("dp", None, "tp")``, and the
  product moves to the sequence-parallel ``("dp", "sp", None)`` by an
  all-to-all over ``tp`` (``nn.constrain``'s own, ``nn._AllToAll``).

Prefill and decode on a mesh raise ``NotImplementedError`` (ROADMAP §1,
serving on a sharded mesh).
"""
from __future__ import annotations

from functools import partial

import torch
from torch.distributed.tensor import Shard

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
    cache, placed as ``x``'s batch on a mesh) before ``x``'s first."""
    B, S, d = x.shape
    prev = cache["shift"] if cache is not None else nn.distribute_like(
        torch.zeros((B, d), dtype=x.dtype, device=x.device), x, ("dp", None))
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


def _heads_wkv(r, k, v, lw, u, scale, bias, *, chunk, state=None):
    """The wkv recurrence and the per-head group norm on one device's (on a
    mesh, one rank's) channels, whole heads of HEAD_DIM: r, k, v, lw (B,
    S, d'); u, scale, bias (d',).  Each chunk of ``chunk`` tokens runs
    through ``nn.remat``; ``state`` (B, d' / HEAD_DIM, hd, hd) f32 or zeros.
    Returns (the normed output (B, S, d') in r's dtype, the last state)."""
    B, S, dl = r.shape
    H = dl // HEAD_DIM
    r, k, v, lw = (t.reshape(B, S, H, HEAD_DIM) for t in (r, k, v, lw))
    u = u.reshape(H, HEAD_DIM).float()
    if state is None:
        state = torch.zeros((B, H, HEAD_DIM, HEAD_DIM), dtype=torch.float32, device=r.device)
    outs = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        o, state = nn.remat(_wkv_chunk, r[:, sl], k[:, sl], v[:, sl], lw[:, sl], u, state)
        outs.append(o)
    out = torch.cat(outs, dim=1).reshape(B, S, dl)
    return nn.group_norm(out, scale, bias, groups=H), state


def _decay_lora(xw, a, b):
    """The Finch decay's LoRA in f32: ``tanh(xw A) B``."""
    return (torch.tanh(xw @ a) @ b).float()


def _placed_decay_lora(xw, a, b):
    """``_decay_lora`` on plain tensors, or on each rank's shards of
    DTensors (``nn.per_rank``): ``xw`` batch-sharded over ``dp``, A whole,
    B's columns over ``tp``, so the output is batch- and channel-sharded
    and each input's gradient a partial sum over the splits it does not
    carry.  (Left to DTensor, the backward of ``tanh`` reduce-scatters its
    partial gradient over the sequence, and the product after it has no
    sharding strategy on a (pod, data, model) mesh.)"""
    def out(x, _, b):
        return (tuple(Shard(2) if isinstance(pb, Shard) else px
                      for px, pb in zip(x.placements, b.placements)),)

    def grad(x, a, b):
        rows, cols = nn.split_dims(x, 0), nn.split_dims(b, 1)
        return (nn.partial_on(x.placements, cols), nn.partial_on(a.placements, rows | cols),
                nn.partial_on(b.placements, rows))

    return nn.per_rank(_decay_lora, xw, a, b, out=out, grad=grad)


def _placed_heads_wkv(r, k, v, lw, p, chunk: int, state0):
    """``_heads_wkv`` on plain tensors, or on each rank's heads of DTensors
    (``nn.per_rank``; module docstring): the rank's slices of the bonus and
    the norm's scale and bias, or every head on every ``model`` rank where
    ``tp`` does not divide the heads."""
    vecs = [p[n] for n in ("bonus_u", "ln_scale", "ln_bias")]
    if isinstance(r, nn.DTensor):
        if (r.shape[-1] // HEAD_DIM) % nn.axis_size("tp"):
            # heads that the tp axis does not divide: whole heads gathered,
            # every head run on every model rank
            r, k, v, lw = (nn.constrain(t, ("dp", None, None)) for t in (r, k, v, lw))
        else:
            vecs = [nn.constrain(t, ("tp",)) for t in vecs]
    B, S, d = r.shape

    def out(r, *_):
        state = nn.layout(r.device_mesh, ("dp", "tp", None, None),
                          (B, d // HEAD_DIM, HEAD_DIM, HEAD_DIM))
        return (r.placements, state)

    def grad(*args):  # each rank's own rows of the vectors' uses: partial sums over dp
        rows = nn.split_dims(args[0], 0)
        return tuple(a.placements if i < 4 else nn.partial_on(a.placements, rows)
                     for i, a in enumerate(args))

    return nn.per_rank(partial(_heads_wkv, chunk=chunk, state=state0), r, k, v, lw, *vecs,
                       out=out, grad=grad)


def time_mix_forward(p, cfg, x, *, mode, cache=None):
    """x: (B, S, d). cache: {'shift': (B, d), 'state': (B, H, hd, hd) f32}.

    Returns (out, new_cache).  Decode writes the token's shift and state
    into ``cache`` and returns it.  A DTensor ``x`` (train mode only) runs
    under the module docstring's placements; ``out`` is then a partial sum
    over ``tp``.
    """
    nn.serving_on_a_mesh(x, mode)
    x = nn.constrain(x, ("dp", None, None))  # the sequence gathered, for the shift
    B, S, d = x.shape
    H = num_heads(cfg)
    xs = _shifted(x, cache)
    xr, xk, xv, xw, xg = (_mix(x, xs, p[f"mix_{n}"]) for n in "rkvwg")

    def w(name):
        return nn.gather_fsdp(p[name]).to(x.dtype)

    heads = ("dp", None, "tp")
    r, k, v = (nn.constrain(a @ w(n), heads) for a, n in ((xr, "w_r"), (xk, "w_k"), (xv, "w_v")))
    g = nn.silu(nn.constrain(xg @ w("w_g"), heads))
    # data-dependent decay (Finch): lw = -exp(w0 + tanh(xw A) B)  (log w, <= 0)
    dec = _placed_decay_lora(xw, w("decay_a"), w("decay_b"))
    lw = -torch.exp(nn.constrain(p["decay_0"], ("tp",)) + dec)  # (B, S, d) f32
    state0 = cache["state"].float() if cache is not None else None

    if mode == "decode":
        r, k, v, lw = (t.reshape(B, S, H, HEAD_DIM) for t in (r, k, v, lw))
        u = p["bonus_u"].reshape(H, HEAD_DIM).float()
        if state0 is None:
            state0 = torch.zeros((B, H, HEAD_DIM, HEAD_DIM), dtype=torch.float32, device=x.device)
        o, state_new = _wkv_step(*(t[:, 0].float() for t in (r, k, v)), torch.exp(lw[:, 0]), u,
                                 state0)
        out = o.reshape(B, 1, d).to(x.dtype)
        out = nn.group_norm(out, p["ln_scale"], p["ln_bias"], groups=H)
    else:
        out, state_new = _placed_heads_wkv(r, k, v, lw, p, nn.chunk_len(cfg, S), state0)
        out = nn.constrain(out, heads)  # where every rank ran every head: its channels back

    out = (out * g) @ w("w_o")  # on a mesh a partial sum over tp, for the caller to reduce
    if mode == "decode":
        cache["shift"].copy_(x[:, -1])
        cache["state"].copy_(state_new)
        return out, cache
    return out, {"shift": x[:, -1, :], "state": state_new}


def channel_mix_forward(p, cfg, x, *, mode, cache=None):
    """x: (B, S, d). cache: {'shift': (B, d)}.  Returns (out, new_cache);
    decode writes the token's shift into ``cache`` and returns it.  A
    DTensor ``x`` (train mode only) runs under the module docstring's
    placements; ``out`` is then sequence-parallel, ``("dp", "sp", None)``."""
    nn.serving_on_a_mesh(x, mode)
    x = nn.constrain(x, ("dp", None, None))  # the sequence gathered, for the shift
    xs = _shifted(x, cache)
    xk = _mix(x, xs, p["mix_k"])
    xr = _mix(x, xs, p["mix_r"])
    k = nn.constrain(xk @ nn.gather_fsdp(p["w_k"]).to(x.dtype), ("dp", None, "tp"))
    k = torch.square(torch.relu(k))
    kv = k @ nn.gather_fsdp(p["w_v"]).to(x.dtype)  # on a mesh a partial sum over tp
    rr = torch.sigmoid(xr @ nn.gather_fsdp(p["w_r"]).to(x.dtype))  # ("dp", None, "tp")
    # the gate's product at one placement: kv reduce-scattered over its
    # channels to meet the gate, the product moved to the residual's
    # sequence-parallel placement by an all-to-all over tp
    out = nn.constrain(rr * nn.constrain(kv, ("dp", None, "tp")), ("dp", "sp", None))
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
