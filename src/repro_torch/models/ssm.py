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

On a mesh (a DTensor ``x_in``, train mode only: the sharded train step of
``fl/steps``) the layer runs the same code, whose ``nn.constrain``,
``nn.gather_fsdp`` and ``nn.per_rank`` calls are the identity on plain
tensors, under these placements (T the ``tp`` axis's size, w = d_inner /
T):

- the input, the sequence-parallel residual ``("dp", "sp", None)``, is
  gathered over the sequence once a sublayer, to ``("dp", None, None)``:
  the causal conv needs the d_conv - 1 tokens before each sequence shard;
- ``xz`` is ``x @ in_proj`` at ``("dp", None, "tp")`` (the reference's
  constraint).  ``in_proj``'s columns are ``[x | z]`` and its spec
  ``P(FSDP, TP)`` splits the concatenation, so ``tp`` rank t stores
  columns [2 t w, 2 (t + 1) w): with T 2, rank 0 all of x and rank 1 all
  of z.  Before the FSDP gather, ``_halves_alike`` moves the stored
  shard's two column chunks by one all-to-all over ``tp`` (its gradient
  back by another) so that rank t holds ``[x_t | z_t]``, channels [t w,
  (t + 1) w) of both halves; ``xz`` then splits on each rank's own
  columns.  The stored leaf, its spec and the checkpoint's bytes are the
  reference's.  On the wire that is the rank's stored shard of
  ``in_proj``, (d / FSDP) x 2 w in the parameter dtype, a layer forward
  and its gradient backward: at jamba's full width on a 16 x 16 mesh 4 MB
  each way, where moving ``xz`` would move B S 2 w activations;
- the conv, its ``silu`` and the chunk loop run on each rank's channels
  through ``nn.per_rank``, with the rank's slices of ``conv_w``,
  ``conv_b``, ``dt_b``, ``A_log`` and ``D``, whose gradients are partial
  sums over ``dp``;
- ``x @ x_proj`` (``P(TP, None)``) is a partial sum over ``tp``, reduced to
  ``("dp", None, None)`` before ``dt_w`` and the scan read ``dt_in``, B and
  C; ``dt`` is ``("dp", None, "tp")`` (``dt_w`` is ``P(None, TP)``); B's
  and C's gradients come back from the chunk loop as partial sums over
  ``tp``;
- ``(y * silu(z)) @ out_proj`` is a partial sum over ``tp``, for
  ``lm._residual`` to reduce-scatter.

Where ``tp`` does not divide d_inner, ``xz`` is gathered over ``tp`` and
every rank runs every channel (the constraints that would split the
channels resolve to None).  Prefill and decode on a mesh raise
``NotImplementedError`` (ROADMAP §1, serving on a sharded mesh).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

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
    the B and C projections (B, S, d_state) f32.  On a mesh ``x @ x_proj``
    is each rank's channels' partial sum (``nn.channel_product``), reduced
    over ``tp`` before its three parts are read, each part's gradient
    reduced on its own (``nn.grad_placed``); ``dt`` comes out
    channel-sharded."""
    dr, ds = dt_rank(cfg), cfg.d_state
    proj = nn.constrain(nn.channel_product(x, nn.gather_fsdp(p["x_proj"])), ("dp", None, None))
    dt_in, Bm, Cm = (nn.grad_placed(t) for t in proj.split([dr, ds, ds], dim=-1))
    dt_b = nn.constrain(p["dt_b"], ("tp",)).float()
    dt = _softplus((dt_in @ nn.gather_fsdp(p["dt_w"]).to(x.dtype)).float() + dt_b)
    return nn.constrain(dt, ("dp", None, "tp")), Bm.float(), Cm.float()


def _chunks_swap(t, group, T: int, r: int, inverse: bool):
    """One ``tp`` rank's part of ``_HalvesAlike``: ``t`` (rows, 2 w), this
    rank's two column chunks, sent by one all-to-all to the ranks that
    take them.  Forward: rank r holds chunks 2 r and 2 r + 1 of the 2 T
    chunks of ``[x | z]`` and sends chunk c to rank c mod T; it receives x
    chunk r from rank r // 2 and z chunk T + r from rank (T + r) // 2.
    ``inverse`` moves them back."""
    from torch.distributed import _functional_collectives as funcol

    rows, w = t.shape[0], t.shape[1] // 2
    held = [(2 * r) % T, (2 * r + 1) % T]  # the ranks of this rank's stored chunks
    alike = [r // 2, (T + r) // 2]  # the ranks storing its x and z chunks
    dests, srcs = (alike, held) if inverse else (held, alike)
    pieces = t.reshape(rows, 2, w).transpose(0, 1)  # (2, rows, w)
    send = torch.stack([pieces[j] for j in sorted(range(2), key=dests.__getitem__)])
    n = rows * w
    got = funcol.wait_tensor(funcol.all_to_all_single(
        send.reshape(-1), [n if s in srcs else 0 for s in range(T)],
        [n if d in dests else 0 for d in range(T)], group)).view(2, rows, w)
    got = got[[sorted(srcs).index(s) for s in srcs]]  # by source rank -> piece order
    return got.transpose(0, 1).reshape(rows, 2 * w)


class _HalvesAlike(torch.autograd.Function):
    """``in_proj`` (d, 2 d_inner) as a DTensor whose columns are rearranged
    so that ``tp`` rank t holds ``[x_t | z_t]`` (module docstring), by
    ``_chunks_swap`` of the column-sharded leaf (``tp`` divides d_inner, so
    ``fit_spec`` keeps the column shard).  The other placements are kept;
    the backward moves the gradient back the same way."""

    @staticmethod
    def forward(ctx, w, m: int):
        mesh = w.device_mesh
        T, r = mesh.size(m), mesh.get_local_rank(m)
        ctx.args = (mesh, m, T, r, tuple(w.placements), w.shape, w.stride())
        return _HalvesAlike.move(w.to_local(), *ctx.args, inverse=False)

    @staticmethod
    def backward(ctx, g):
        mesh, m, T, r, pls, shape, stride = ctx.args
        if tuple(g.placements) != pls:
            g = g.redistribute(mesh, pls)
        return _HalvesAlike.move(g.to_local(), *ctx.args, inverse=True), None

    @staticmethod
    def move(local, mesh, m, T, r, pls, shape, stride, *, inverse):
        local = _chunks_swap(local, mesh.get_group(m), T, r, inverse)
        return DTensor.from_local(local, mesh, pls, shape=shape, stride=stride)


def _in_proj(w, di: int):
    """``in_proj`` as the layer uses it, and whether its halves were made
    alike: a plain tensor as it is; a DTensor through ``_HalvesAlike``
    where ``tp`` (T > 1) divides d_inner, gathered over its FSDP axes."""
    if not isinstance(w, DTensor):
        return w, False
    m = w.device_mesh.mesh_dim_names.index(nn.tp_axis())
    T = w.device_mesh.size(m)
    alike = di % T == 0
    if alike and T > 1:
        w = _HalvesAlike.apply(w, m)
    return nn.gather_fsdp(w), alike


def _split_halves(xz):
    """x and z of ``xz``: on a mesh, of each rank's own columns (``[x_t |
    z_t]`` after ``_HalvesAlike``, or the whole halves where ``xz`` is
    replicated over ``tp``)."""
    return nn.per_rank(lambda t: t.chunk(2, dim=-1), xz,
                       out=lambda t: (t.placements, t.placements))


def _rows_partial(x, *params):
    """``nn.per_rank``'s gradient rule for a per-channel op on ``x`` (B, S,
    ...) and its channels' parameters: ``x``'s as placed, each parameter's a
    partial sum over the mesh dims that split ``x``'s batch."""
    rows = nn.split_dims(x, 0)
    return (x.placements,) + tuple(nn.partial_on(q.placements, rows) for q in params)


def _conv_silu(x_raw, w, b):
    return nn.silu(_causal_conv(x_raw, w.to(x_raw.dtype), b.to(x_raw.dtype)))


def _ssm_inputs(p, cfg, xz):
    """From in_proj's output: (x_raw, x_conv, z, dt, A, Bm, Cm)."""
    x_raw, z = _split_halves(xz)
    w, b = nn.constrain(p["conv_w"], (None, "tp")), nn.constrain(p["conv_b"], ("tp",))
    x = nn.per_rank(_conv_silu, x_raw, w, b, out=lambda x, *_: (x.placements,),
                    grad=_rows_partial)
    dt, Bm, Cm = _x_dt_bc(p, cfg, x)
    A = -torch.exp(nn.constrain(p["A_log"], ("tp", None)))  # (di, ds), negative
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


def _placed_scan(dt, A, Bm, Cm, x, D, *, chunk: int, h0=None):
    """``selective_scan`` from ``h0`` or zeros, on plain tensors or on each
    rank's channels of DTensors (``nn.per_rank``): dt and x ``("dp", None, "tp")``, B and C whole over
    ``tp``, whose gradients are then partial sums over it; the parameters'
    gradients partial sums over ``dp``."""
    def out(dt, *_):
        B, S, di = dt.shape
        return (dt.placements, nn.layout(dt.device_mesh, ("dp", "tp", None), (B, di, Bm.shape[2])))

    def grad(dt, A, Bm, Cm, x, D):
        rows, cols = nn.split_dims(dt, 0), nn.split_dims(dt, 2)
        return (dt.placements, nn.partial_on(A.placements, rows),
                nn.partial_on(Bm.placements, cols), nn.partial_on(Cm.placements, cols),
                x.placements, nn.partial_on(D.placements, rows))

    def fn(dt, A, Bm, Cm, x, D):  # one rank's channels: dt, x (B, S, di') f32
        h = h0 if h0 is not None else torch.zeros((x.shape[0], x.shape[2], Bm.shape[2]),
                                                  dtype=torch.float32, device=x.device)
        return selective_scan(dt, A, Bm, Cm, x, D, h, chunk)

    return nn.per_rank(fn, dt, A, Bm, Cm, x, D, out=out, grad=grad)


def _ssm_step(a, bu, h):
    """The one-token state update: h' = a h + b u, all (B, di, ds) f32."""
    return a * h + bu


def mamba_forward(p, cfg, x_in, *, mode, cache=None):
    """x_in: (B, S, d).  cache: {'conv': (B, d_conv - 1, di), 'h': (B, di,
    ds) f32}.  Returns (out, new_cache): None in train mode; decode writes
    the conv history and the state into ``cache`` and returns it.  A
    DTensor ``x_in`` (train mode only) runs under the module docstring's
    placements; ``out`` is then a partial sum over ``tp``."""
    nn.serving_on_a_mesh(x_in, mode)
    x_in = nn.constrain(x_in, ("dp", None, None))  # the sequence gathered, for the conv
    B, S, d = x_in.shape
    di, ds, dc = d_inner(cfg), cfg.d_state, cfg.d_conv
    w_in, alike = _in_proj(p["in_proj"], di)
    xz = nn.constrain(x_in @ w_in.to(x_in.dtype), ("dp", None, "tp" if alike else None))

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
    h0 = cache["h"] if cache is not None and mode == "prefill" else None
    y, h_last = _placed_scan(dt, A, Bm, Cm, x.float(), nn.constrain(p["D"], ("tp",)),
                             chunk=nn.chunk_len(cfg, S), h0=h0)
    y = y.to(x_in.dtype) * nn.silu(z)
    out = y @ nn.gather_fsdp(p["out_proj"]).to(x_in.dtype)  # on a mesh a partial sum over tp
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
