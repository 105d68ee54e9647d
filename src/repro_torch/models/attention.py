"""Attention: chunked-causal (flash-style) GQA and MLA with their caches.

Answers to the GQA and MLA parts of ``repro/models/attention.py``:

- ``chunked_attention`` is the reference's ``_flash`` core, plain
  PyTorch in the reference's chunk order: for each query chunk, an online
  softmax over every key chunk in turn, masked chunks included, with f32
  scores and accumulators (``_flash_fwd``).  It runs through ``_Flash``, a
  ``torch.autograd.Function`` that answers to the reference's custom VJP:
  autograd keeps ``(q, k, v, out, lse)`` and the backward
  (``_flash_bwd``) recomputes each chunk's probabilities from the scores
  and ``lse`` in f32, in the reference's order;
- ``decode_attention`` is the reference's single-token attention over the
  whole cache under a length mask;
- ``gqa_forward`` runs the train, prefill and decode modes;
- ``mla_forward`` (deepseek-v2's multi-head latent attention) runs them
  too: train and prefill up-project the latent ``c_kv`` to per-head keys
  and values and go through ``chunked_attention`` (q and k head dim
  ``head_dim + qk_rope_dim``, v head dim ``head_dim``); decode is the
  absorbed form over a cache of the latent (B, S, kv_lora_rank) and the
  shared rope key (B, S, qk_rope_dim), its score and value products
  accumulating in f32 where the reference asks for an f32 result.
- ``cross_attn_forward`` (the enc-dec decoder's cross-attention) takes
  no rope and no window: queries from the decoder's states, keys and
  values from the encoder's output (or, in decode, from the cache of
  them), non-causal through ``chunked_attention`` with the kv heads
  handed in as they are (G = H / KV inside the core), and a one-token
  target through ``decode_attention`` under an all-ones source mask, in
  every mode, as the reference's.

Numerics kept from the reference: scores and the PV product take bf16 (or
f32) inputs and accumulate in f32 (XLA's ``preferred_element_type``), so
the inputs are widened to f32 first; the probabilities are rounded to the
value dtype before the PV product; heads are kv-major (``h = kv * G +
g``), so the train path repeats each kv head G times in place
(``repeat_interleave``), not tiled.

One deliberate divergence (ROADMAP §3, parity rule 9): the reference
writes the decode step's key and value with ``dynamic_update_slice``,
which clamps an out-of-range ``cache_index`` and silently overwrites the
cache's last slot; the port raises ``IndexError`` (GQA and MLA alike).  The port's decode
writes the cache in place and returns it (the reference's server donates
its cache buffer to the same end).

The backward, as the reference's, keeps the probabilities in f32 (the
forward rounds them to the value dtype before its PV product).  From
``gqa_forward`` it sees k and v already repeated to H heads (G = 1 inside
the core), so ``repeat_interleave``'s backward sums the G copies of dk
and dv; from ``cross_attn_forward`` it sees the KV heads themselves, and
its own einsums sum the G query heads of each kv head into dk and dv.

Sharding specs (``nn``'s placeholders): ``gqa_specs``, ``mla_specs`` and
``cross_attn_specs`` answer to the reference's; where the reference's
``*_cache_shape`` returns (shapes, specs), the port's returns the shapes
(meta tensors) and a sibling ``*_cache_specs(cfg)`` the specs.

On a mesh (a DTensor ``x``, the sharded train step of ``fl/steps``),
``gqa_forward`` runs the same code, whose ``nn.constrain`` and
``nn.gather_fsdp`` calls are the identity on plain tensors: the
reference's constraints, the sequence gathered and q, k and v
head-sharded over ``tp`` and batch-sharded over ``dp``; rope, the kv
repeat and ``chunked_attention`` with ``_Flash`` run on each rank's
shards through ``local_map`` (heads are kv-major, so a rank's query heads
are exactly its kv heads' groups; where the ``tp`` axis does not divide
KV, k and v are repeated to every query head before the head split and
the core runs at G = 1, as the reference's);
the padded heads' mask is sliced the same way, so the padding stays
exact; ``wo`` leaves a partial sum over ``tp``.  Prefill and decode on a
mesh raise ``NotImplementedError`` (ROADMAP §1, serving on a sharded
mesh).
"""
from __future__ import annotations

import math
from functools import partial

import torch

from . import nn
from .nn import DP, FSDP, TP, P, apply_rope, dense_init, rms_norm

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# chunked flash-style attention core


def _mask_chunk(q_pos, k_pos, causal, window):
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    return mask


def _flash_fwd(q, k, v, causal, q_offset, window, scale):
    """q: (nq, B, Cq, KV, G, Dk); k, v: (nk, B, Ck, KV, D) -> (out (nq, B, Cq,
    KV, G, Dv) in q's dtype, lse (nq, B, Cq, KV, G) f32)."""
    nq, B, Cq, KV, G = q.shape[:5]
    nk, Ck, Dv = k.shape[0], k.shape[2], v.shape[-1]
    dev = q.device
    outs, lses = [], []
    for iq in range(nq):
        q_i = q[iq].float()
        q_pos = q_offset + iq * Cq + torch.arange(Cq, dtype=torch.int32, device=dev)
        acc = torch.zeros((B, Cq, KV, G, Dv), dtype=torch.float32, device=dev)
        m = torch.full((B, Cq, KV, G), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Cq, KV, G), dtype=torch.float32, device=dev)
        for ik in range(nk):
            k_pos = ik * Ck + torch.arange(Ck, dtype=torch.int32, device=dev)
            s = torch.einsum("bqkgd,bckd->bqkgc", q_i, k[ik].float()) * scale
            mask = _mask_chunk(q_pos, k_pos, causal, window)
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bqkgc,bckd->bqkgd", p.to(v.dtype).float(), v[ik].float())
            acc = acc * corr[..., None] + pv
            m = m_new
        l_safe = torch.clamp(l, min=1e-30)
        outs.append((acc / l_safe[..., None]).to(q.dtype))
        lses.append(m + torch.log(l_safe))
    return torch.stack(outs), torch.stack(lses)


def _bwd_q_chunk(iq, q_i, do_i, lse_i, delta_i, k, v, causal, q_offset, window, scale):
    """One query chunk's flash backward: a loop over every key chunk, masked
    ones included.  Returns dq_i (B, Cq, KV, G, Dk) and this chunk's
    contributions to dk and dv, (nk, B, Ck, KV, D), all f32."""
    nk, Ck = k.shape[0], k.shape[2]
    Cq, dev = q_i.shape[1], q_i.device
    q_pos = q_offset + iq * Cq + torch.arange(Cq, dtype=torch.int32, device=dev)
    q_f, do_f = q_i.float(), do_i.float()
    dq_i = torch.zeros(q_i.shape, dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for ik in range(nk):
        k_pos = ik * Ck + torch.arange(Ck, dtype=torch.int32, device=dev)
        k_j, v_j = k[ik].float(), v[ik].float()
        s = torch.einsum("bqkgd,bckd->bqkgc", q_f, k_j) * scale
        mask = _mask_chunk(q_pos, k_pos, causal, window)
        # p in f32, not rounded to the value dtype (the forward rounds it)
        p = torch.where(mask[None, :, None, None, :], torch.exp(s - lse_i[..., None]), 0.0)
        dvs.append(torch.einsum("bqkgc,bqkgd->bckd", p, do_f))
        dp = torch.einsum("bqkgd,bckd->bqkgc", do_f, v_j)
        ds = p * (dp - delta_i[..., None]) * scale
        dq_i = dq_i + torch.einsum("bqkgc,bckd->bqkgd", ds, k_j)
        dks.append(torch.einsum("bqkgc,bqkgd->bckd", ds, q_f))
    return dq_i, torch.stack(dks), torch.stack(dvs)


def _flash_bwd(q, k, v, out, lse, dout, causal, q_offset, window, scale):
    """The reference's ``_flash_bwd`` in its order: ``delta = sum(dout *
    out)`` in f32; per query chunk, ``_bwd_q_chunk``; dk and dv summed in
    f32 over the query chunks from zero; each gradient cast to its input's
    dtype at the end."""
    delta = torch.sum(dout.float() * out.float(), dim=-1)  # (nq, B, Cq, KV, G)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    dqs = []
    for iq in range(q.shape[0]):
        dq_i, dk_i, dv_i = _bwd_q_chunk(iq, q[iq], dout[iq], lse[iq], delta[iq], k, v,
                                        causal, q_offset, window, scale)
        dk = dk + dk_i
        dv = dv + dv_i
        dqs.append(dq_i)
    return torch.stack(dqs).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """The flash core with the flash backward, the reference's custom VJP:
    autograd keeps (q, k, v, out, lse), never a chunk's score matrix."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, window, scale):
        out, lse = _flash_fwd(q, k, v, causal, q_offset, window, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, H, Dk)
    k: torch.Tensor,  # (B, Skv, KV, Dk)
    v: torch.Tensor,  # (B, Skv, KV, Dv)
    *,
    causal: bool = True,
    q_offset: int = 0,
    chunk_q: int = 512,
    chunk_kv: int = 512,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Memory-efficient attention; returns (B, Sq, H, Dv).

    ``q_offset`` is the absolute position of q[0]; the GQA group size is
    H // KV.  The sequence lengths must divide into the chunks.
    """
    B, Sq, H, Dk = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(Dk)

    chunk_q = min(chunk_q, Sq)
    chunk_kv = min(chunk_kv, Skv)
    nq, nk = Sq // chunk_q, Skv // chunk_kv
    assert nq * chunk_q == Sq and nk * chunk_kv == Skv, (Sq, Skv, chunk_q, chunk_kv)

    qc = q.reshape(B, nq, chunk_q, KV, G, Dk).transpose(0, 1)
    kc = k.reshape(B, nk, chunk_kv, KV, Dk).transpose(0, 1)  # (nk, B, Ck, KV, Dk)
    vc = v.reshape(B, nk, chunk_kv, KV, Dv).transpose(0, 1)  # (nk, B, Ck, KV, Dv)
    out = _Flash.apply(qc, kc, vc, causal, int(q_offset), window, scale)
    return out.transpose(0, 1).reshape(B, Sq, H, Dv)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, Dk)
    k_cache: torch.Tensor,  # (B, S, KV, Dk)
    v_cache: torch.Tensor,  # (B, S, KV, Dv)
    length_mask: torch.Tensor,  # (B, S) bool: True for valid positions
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Single-token attention over the cache."""
    B, _, H, Dk = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(Dk)
    qg = q.reshape(B, KV, G, Dk).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    s = torch.where(length_mask[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.clamp(l, min=1e-30)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, 1, H, -1).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA block


def padded_heads(cfg) -> tuple[int, int]:
    """(H_padded, G_padded): query heads padded per KV group to a multiple
    of ``tp_pad_multiple`` (llava's H = 56 on a 16-way axis in the
    reference's sharding; padded heads are masked out of the output
    projection, so the math matches the unpadded model exactly)."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    mult = getattr(cfg, "tp_pad_multiple", 1)
    G = H // KV
    if mult <= 1 or (H % mult == 0 and G >= 1):
        return H, G
    G_pad = G
    while (KV * G_pad) % mult:
        G_pad += 1
    return KV * G_pad, G_pad


def head_mask(cfg, device=None) -> torch.Tensor | None:
    """(H_pad,) f32, 1 on real heads, in kv-major head order; None unpadded."""
    H_pad, G_pad = padded_heads(cfg)
    if H_pad == cfg.num_heads:
        return None
    G = cfg.num_heads // cfg.num_kv_heads
    m = (torch.arange(G_pad, device=device) < G).float()  # (G_pad,)
    return m.repeat(cfg.num_kv_heads)  # tiled: kv-major head order


def init_gqa(gen: torch.Generator, cfg) -> nn.Params:
    d, KV, hd = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    H_pad, _ = padded_heads(cfg)
    ks = nn.split_keys(gen, 4)
    dt = cfg.pdtype
    p = {
        "wq": dense_init(ks[0], d, (H_pad * hd,), dt).reshape(d, H_pad, hd),
        "wk": dense_init(ks[1], d, (KV * hd,), dt).reshape(d, KV, hd),
        "wv": dense_init(ks[2], d, (KV * hd,), dt).reshape(d, KV, hd),
        "wo": dense_init(ks[3], H_pad * hd, (d,), dt).reshape(H_pad, hd, d),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dt)
        p["k_norm"] = torch.zeros((hd,), dtype=dt)
    return p


def gqa_specs(cfg) -> nn.Specs:
    kv = TP if cfg.num_kv_heads % 8 == 0 else None
    s = {
        "wq": P(FSDP, TP, None),
        "wk": P(FSDP, kv, None),
        "wv": P(FSDP, kv, None),
        "wo": P(TP, None, FSDP),
    }
    if cfg.qk_norm:
        s["q_norm"] = P(None)
        s["k_norm"] = P(None)
    return s


def _project(x, w):
    """'bsd,dhk->bshk' as one matmul over the flattened (h, k)."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _cache_slot(cache_index, Smax: int) -> int:
    """The decode step's cache position as an int; out of range it raises
    (the reference clamps it: parity rule 9)."""
    idx = int(cache_index)
    if not 0 <= idx < Smax:
        raise IndexError(f"cache_index {idx} outside a cache of {Smax} positions")
    return idx


def _rope_attend(q, k, v, positions, *, cfg, G: int, causal: bool):
    """The train / prefill core on one device's tensors (on a mesh, on one
    rank's shards through ``local_map``): rope, each kv head repeated G
    times in place (heads are kv-major, so a rank's query heads are
    exactly its kv heads' groups), the flash core.  Returns the output and
    the roped keys (the prefill cache)."""
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    k_full = torch.repeat_interleave(k, G, dim=2) if G > 1 else k
    v_full = torch.repeat_interleave(v, G, dim=2) if G > 1 else v
    out = chunked_attention(q, k_full, v_full, causal=causal, chunk_q=cfg.attn_chunk,
                            chunk_kv=cfg.attn_chunk, window=cfg.window)
    return out, k


def _attend(q, k, v, positions, *, cfg, G: int, causal: bool):
    """``_rope_attend`` on plain tensors, or on each rank's shards of
    DTensors (``local_map``, the positions sliced as q's batch)."""
    fn = partial(_rope_attend, cfg=cfg, G=G, causal=causal)
    if not isinstance(q, nn.DTensor):
        return fn(q, k, v, positions)
    from torch.distributed.tensor.experimental import local_map

    pos = nn.distribute_like(positions, q, ("dp", None))
    return local_map(fn, out_placements=(q.placements, k.placements),
                     in_placements=(q.placements, k.placements, v.placements, pos.placements),
                     device_mesh=q.device_mesh)(q, k, v, pos)


def gqa_forward(p, cfg, x, *, positions, mode, cache=None, cache_index=None, causal=True):
    """mode: 'train'/'prefill' (full seq) or 'decode' (one token).

    Returns (out, new_cache); new_cache is None in train mode.  In decode
    mode ``cache_index`` is a Python int (or a 0-d tensor, read on the
    host) in [0, max_len), and the cache is written in place.  A DTensor
    ``x`` (train mode only) runs the same code under the module
    docstring's constraints.
    """
    if isinstance(x, nn.DTensor):
        if mode != "train":
            raise NotImplementedError(f"{mode} on a sharded mesh: ROADMAP §1, serving on a "
                                      f"sharded mesh")
    B, S, d = x.shape
    H, G = padded_heads(cfg)
    hmask = head_mask(cfg, x.device)
    x = nn.constrain(x, ("dp", None, None))  # Megatron-SP: the sequence gathered
    q = _project(x, nn.gather_fsdp(p["wq"]))
    k = _project(x, nn.gather_fsdp(p["wk"]))
    v = _project(x, nn.gather_fsdp(p["wv"]))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if isinstance(k, nn.DTensor) and G > 1 and cfg.num_kv_heads % nn.axis_size("tp"):
        # kv heads that the tp axis does not divide: every query head's k and
        # v before the head split, the core at G = 1, as the reference
        # (src/repro/models/attention.py:294-302)
        k, v = (torch.repeat_interleave(t, G, dim=2) for t in (k, v))
        G = 1
    heads = ("dp", None, "tp", None)
    q, k, v = (nn.constrain(t, heads) for t in (q, k, v))

    if mode in ("train", "prefill"):
        out, k = _attend(q, k, v, positions, cfg=cfg, G=G, causal=causal)
        new_cache = {"k": k, "v": v} if mode == "prefill" else None
    elif mode == "decode":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        k_cache, v_cache = cache["k"], cache["v"]
        Smax = k_cache.shape[1]
        idx = _cache_slot(cache_index, Smax)
        k_cache[:, idx] = k[:, 0].to(k_cache.dtype)
        v_cache[:, idx] = v[:, 0].to(v_cache.dtype)
        pos_ids = torch.arange(Smax, dtype=torch.int32, device=x.device)
        mask = pos_ids[None, :] <= idx
        if cfg.window is not None:
            mask &= pos_ids[None, :] > idx - cfg.window
        out = decode_attention(q, k_cache, v_cache, mask.expand(B, Smax))
        new_cache = {"k": k_cache, "v": v_cache}
    else:
        raise ValueError(mode)

    if hmask is not None:  # zero the padded query heads (exact-math padding)
        out = out * nn.distribute_like(hmask[None, None, :, None].to(out.dtype), out,
                                       (None, None, "tp", None))
    # on a mesh a partial sum over tp (row-parallel wo), for the caller to reduce
    out = out.flatten(-2) @ nn.gather_fsdp(p["wo"]).to(x.dtype).flatten(0, 1)
    return out, new_cache


def gqa_cache_shape(cfg, batch: int, max_len: int) -> dict:
    """The cache's shapes and dtype as meta tensors (no allocation)."""
    shp = torch.empty((batch, max_len, cfg.num_kv_heads, cfg.head_dim), dtype=cfg.adtype,
                      device="meta")
    return {"k": shp, "v": shp}


def gqa_cache_specs(cfg) -> dict:
    """``gqa_cache_shape``'s specs: sequence-sharded over ``model`` (context
    parallel)."""
    spec = P(DP, TP, None, None)
    return {"k": spec, "v": spec}


def gqa_init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.adtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.adtype, device=device)}


# ---------------------------------------------------------------------------
# MLA block (deepseek-v2 style)


def init_mla(gen: torch.Generator, cfg) -> nn.Params:
    d, H = cfg.d_model, cfg.num_heads
    lora, rope_d = cfg.kv_lora_rank, cfg.qk_rope_dim
    nope_d = v_d = cfg.head_dim  # qk_nope dim == v dim == head_dim
    qd = nope_d + rope_d
    ks = nn.split_keys(gen, 5)
    dt = cfg.pdtype
    return {
        "wq": dense_init(ks[0], d, (H * qd,), dt).reshape(d, H, qd),
        "w_dkv": dense_init(ks[1], d, (lora + rope_d,), dt),
        "kv_norm": torch.zeros((lora,), dtype=dt),
        "w_uk": dense_init(ks[2], lora, (H * nope_d,), dt).reshape(lora, H, nope_d),
        "w_uv": dense_init(ks[3], lora, (H * v_d,), dt).reshape(lora, H, v_d),
        "wo": dense_init(ks[4], H * v_d, (d,), dt).reshape(H, v_d, d),
    }


def mla_specs(cfg) -> nn.Specs:
    return {
        "wq": P(FSDP, TP, None),
        "w_dkv": P(FSDP, None),
        "kv_norm": P(None),
        "w_uk": P(None, TP, None),
        "w_uv": P(None, TP, None),
        "wo": P(TP, None, FSDP),
    }


def _mla_qc(p, cfg, x, positions):
    """(q_nope, q_rope, c_kv, k_rope): per-head queries split at head_dim,
    the normed latent and the one rope key all heads share."""
    lora, nope_d = cfg.kv_lora_rank, cfg.head_dim
    q = _project(x, p["wq"])
    q_nope, q_rope = q[..., :nope_d], q[..., nope_d:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c = x @ p["w_dkv"].to(x.dtype)
    c_kv = rms_norm(c[..., :lora], p["kv_norm"])
    k_rope = apply_rope(c[..., None, lora:], positions, cfg.rope_theta)[:, :, 0]  # (B, S, rope)
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(p, cfg, x, *, positions, mode, cache=None, cache_index=None):
    """mode: 'train'/'prefill' (full seq) or 'decode' (one token).

    Returns (out, new_cache); new_cache is None in train mode, the prompt's
    {"c_kv", "k_rope"} in prefill, and in decode ``cache`` written in place
    at ``cache_index`` (a Python int or a 0-d tensor in [0, max_len)).
    """
    B, S, _ = x.shape
    H = cfg.num_heads
    rope_d, nope_d = cfg.qk_rope_dim, cfg.head_dim
    scale = 1.0 / math.sqrt(nope_d + rope_d)
    q_nope, q_rope, c_kv, k_rope = _mla_qc(p, cfg, x, positions)

    if mode in ("train", "prefill"):
        # up-projected attention: every head's key and value from the latent
        k_nope = _project(c_kv, p["w_uk"])
        v = _project(c_kv, p["w_uv"])
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rope_d)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = chunked_attention(q, k, v, causal=True, chunk_q=cfg.attn_chunk,
                                chunk_kv=cfg.attn_chunk, scale=scale)
        new_cache = {"c_kv": c_kv, "k_rope": k_rope} if mode == "prefill" else None
    elif mode == "decode":
        c_cache, r_cache = cache["c_kv"], cache["k_rope"]
        Smax = c_cache.shape[1]
        idx = _cache_slot(cache_index, Smax)
        c_cache[:, idx] = c_kv[:, 0].to(c_cache.dtype)
        r_cache[:, idx] = k_rope[:, 0].to(r_cache.dtype)
        # absorbed: q_abs (B, H, lora) = q_nope @ w_uk, in the activations' dtype
        q_abs = torch.einsum("bthd,lhd->bthl", q_nope, p["w_uk"].to(x.dtype))[:, 0]
        s = torch.einsum("bhl,bsl->bhs", q_abs.float(), c_cache.float())
        s = s + torch.einsum("bthr,bsr->bhs", q_rope.float(), r_cache.float())
        s = s * scale
        mask = torch.arange(Smax, device=x.device) <= idx
        s = torch.where(mask[None, None, :], s, NEG_INF)
        a = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhs,bsl->bhl", a.to(c_cache.dtype).float(), c_cache.float())
        out = torch.einsum("bhl,lhd->bhd", o_lat.to(x.dtype), p["w_uv"].to(x.dtype))[:, None]
        new_cache = {"c_kv": c_cache, "k_rope": r_cache}
    else:
        raise ValueError(mode)

    out = out.flatten(-2) @ p["wo"].to(x.dtype).flatten(0, 1)
    return out, new_cache


def mla_cache_shape(cfg, batch: int, max_len: int) -> dict:
    """The cache's shapes and dtype as meta tensors (no allocation)."""
    return {
        "c_kv": torch.empty((batch, max_len, cfg.kv_lora_rank), dtype=cfg.adtype, device="meta"),
        "k_rope": torch.empty((batch, max_len, cfg.qk_rope_dim), dtype=cfg.adtype, device="meta"),
    }


def mla_cache_specs(cfg) -> dict:
    return {"c_kv": P(DP, TP, None), "k_rope": P(DP, TP, None)}


def mla_init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    return {k: torch.zeros(t.shape, dtype=t.dtype, device=device)
            for k, t in mla_cache_shape(cfg, batch, max_len).items()}


# ---------------------------------------------------------------------------
# cross attention (enc-dec)


def init_cross_attn(gen: torch.Generator, cfg) -> nn.Params:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ks = nn.split_keys(gen, 4)
    dt = cfg.pdtype
    return {
        "wq": dense_init(ks[0], d, (H * hd,), dt).reshape(d, H, hd),
        "wk": dense_init(ks[1], d, (KV * hd,), dt).reshape(d, KV, hd),
        "wv": dense_init(ks[2], d, (KV * hd,), dt).reshape(d, KV, hd),
        "wo": dense_init(ks[3], H * hd, (d,), dt).reshape(H, hd, d),
    }


cross_attn_specs = gqa_specs  # same shapes and sharding (qk_norm absent)


def cross_attn_forward(p, cfg, x, *, enc_kv=None, enc_out=None):
    """x: (B, S_tgt, d) decoder states; ``enc_kv``: the cached {"k", "v"}
    (B, S_src, KV, hd), else both projected from ``enc_out`` (B, S_src, d).

    Returns (out, {"k", "v"}) in every mode.
    """
    q = _project(x, p["wq"])
    if enc_kv is None:
        k = _project(enc_out, p["wk"])
        v = _project(enc_out, p["wv"])
    else:
        k, v = enc_kv["k"], enc_kv["v"]
    if x.shape[1] == 1:
        mask = torch.ones((x.shape[0], k.shape[1]), dtype=torch.bool, device=x.device)
        out = decode_attention(q, k, v, mask)
    else:
        out = chunked_attention(q, k, v, causal=False, chunk_q=cfg.attn_chunk,
                                chunk_kv=cfg.attn_chunk)
    out = out.flatten(-2) @ p["wo"].to(x.dtype).flatten(0, 1)
    return out, {"k": k, "v": v}
