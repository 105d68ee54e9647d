"""Encoder-decoder assembly (the seamless-m4t backbone).

Answers to ``repro/models/encdec.py`` with the same parameter and cache
layout, so the JAX package's parameters and train states carry over
through ``convert.params_from_numpy`` and ``ckpt``: ``embed``, ``head``,
``enc_norm``, ``final_norm`` and the ``enc`` / ``dec`` layer dicts whose
leaves are stacked over the layers, shape ``(layers, ...)``.  The
reference's ``lax.scan`` over each stack becomes a Python loop over its
leading axis, each stacked leaf split into its layers once per forward
(``unbind``, whose backward is one ``stack``).

The modality frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_src, d_model).  The encoder is
bidirectional self-attention (``gqa_forward(..., causal=False)``, rope
positions 0..S_src-1) and a SwiGLU FFN; it runs in train mode also under
prefill.  A decoder layer is causal self-attention, cross-attention over
the encoder's output (``attention.cross_attn_forward``) and a SwiGLU FFN.
The decode cache holds, per decoder layer, the self-attention's keys and
values (``"self"``) and the cross-attention's keys and values of the
encoder output (``"cross"``), each (layers, B, S, KV, head_dim); a decode
step writes its self-attention key and value in place and reads the
cross keys and values as they are.

With ``cfg.remat`` each encoder layer, and in train mode each decoder
layer, runs under ``nn.remat`` (the reference's ``jax.checkpoint`` with
``nothing_saveable``); encoder layer 0 reads data embeddings, which need
no gradient.  The padded vocabulary columns read -1e9 (``_mask_pad_vocab``,
as the reference's).  ``param_specs`` is the sharding twin of
``init_params``; ``cache_shapes`` returns the cache's shapes (meta
tensors) and ``cache_specs(cfg)`` its specs, where the reference's
``cache_shapes`` returns the pair.

On a mesh (DTensor parameters and batch, ``fl/steps``' sharded step)
the reference's constraints are wired in where it calls them, and the
ones its XLA placement found by propagation are spelled out: every
residual sum of both stacks sits at a sequence-parallel boundary
(``lm._residual``: a mixer's or FFN's partial sum over ``tp`` is
reduce-scattered over the sequence), so each layer's output is ``("dp",
"sp", None)``; the encoder's normed output has its sequence gathered once,
``("dp", None, None)``, for every decoder layer's cross-attention (whose
gradient then sums over the layers before the gather's reduce-scatter);
the target embedding is ``lm.embed_tokens``' vocab-parallel lookup; the
head is gathered over its FSDP axes, the logits are ``("dp", None,
"tp")`` with the padded columns masked on each vocab shard, and
``lm.lm_loss`` takes its vocab-parallel form.  On plain tensors each of
these is the single-device code.  Prefill and decode on a mesh raise
(ROADMAP §1, serving on a sharded mesh).
"""
from __future__ import annotations

import math

import torch

from ..pytree import leaves, tree_map
from . import attention as attn
from . import lm, nn
from .nn import DP, FSDP, TP, P, dense_init, embed_init, rms_norm

MASKED_LOGIT = -1e9


_FFN_SPECS = {"wi": P(FSDP, TP), "wg": P(FSDP, TP), "wo": P(TP, FSDP)}


def _init_enc_layer(gen, cfg):
    k1, k2 = nn.split_keys(gen, 2)
    return {
        "norm1": torch.zeros((cfg.d_model,), dtype=cfg.pdtype),
        "self": attn.init_gqa(k1, cfg),
        "norm2": torch.zeros((cfg.d_model,), dtype=cfg.pdtype),
        "ffn": lm._init_ffn(k2, cfg, "dense"),
    }


def _init_dec_layer(gen, cfg):
    k1, k2, k3 = nn.split_keys(gen, 3)
    return {
        "norm1": torch.zeros((cfg.d_model,), dtype=cfg.pdtype),
        "self": attn.init_gqa(k1, cfg),
        "norm_x": torch.zeros((cfg.d_model,), dtype=cfg.pdtype),
        "cross": attn.init_cross_attn(k2, cfg),
        "norm2": torch.zeros((cfg.d_model,), dtype=cfg.pdtype),
        "ffn": lm._init_ffn(k3, cfg, "dense"),
    }


def init_params(gen: torch.Generator, cfg, *, device="cpu") -> nn.Params:
    """Random parameters from a CPU generator, drawn in f32 on the CPU and
    moved to ``device`` one layer at a time."""
    k_emb, k_head, k_enc, k_dec = nn.split_keys(gen, 4)

    def stacked(init, key, n):
        return lm._stack([tree_map(lambda t: t.to(device), init(k, cfg))
                       for k in nn.split_keys(key, n)])

    return {
        "embed": embed_init(k_emb, cfg.padded_vocab, cfg.d_model, cfg.pdtype).to(device),
        "head": dense_init(k_head, cfg.d_model, (cfg.padded_vocab,), cfg.pdtype).to(device),
        "enc_norm": torch.zeros((cfg.d_model,), dtype=cfg.pdtype, device=device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.pdtype, device=device),
        "enc": stacked(_init_enc_layer, k_enc, cfg.enc_layers),
        "dec": stacked(_init_dec_layer, k_dec, cfg.num_layers),
    }


def param_specs(cfg) -> nn.Specs:
    gs = attn.gqa_specs(cfg)

    def stack(tree):
        return tree_map(lm.stack_spec, tree)

    return {
        "embed": P(TP, FSDP),
        "head": P(FSDP, TP),
        "enc_norm": P(None),
        "final_norm": P(None),
        "enc": stack({"norm1": P(None), "self": gs, "norm2": P(None), "ffn": _FFN_SPECS}),
        "dec": stack({"norm1": P(None), "self": gs, "norm_x": P(None),
                      "cross": attn.cross_attn_specs(cfg), "norm2": P(None), "ffn": _FFN_SPECS}),
    }


def _layers(stack: dict) -> list:
    """A stacked layer dict as one dict per layer, each leaf split once."""
    split = tree_map(lambda t: t.unbind(0), stack)
    n = len(leaves(split)[0])
    return [tree_map(lambda u: u[i], split) for i in range(n)]


def _ffn(lp, cfg, x):
    """x plus the SwiGLU FFN of ``rms_norm(x, norm2)``, at a
    sequence-parallel boundary (``lm._residual``)."""
    return lm._residual(x, lm._ffn_sublayer(lp, cfg, x, "dense")[0])


def _mask_pad_vocab(cfg, logits):
    """The padded vocabulary columns at -1e9; on vocab-sharded logits each
    rank masks the columns of its own shard."""
    if cfg.padded_vocab != cfg.vocab_size:
        vmask = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
        logits = logits.masked_fill(~nn.distribute_like(vmask, logits, ("tp",)), MASKED_LOGIT)
    return logits


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _enc_layer(lp, cfg, x, positions):
    h = rms_norm(x, lp["norm1"])
    out, _ = attn.gqa_forward(lp["self"], cfg, h, positions=positions, mode="train", causal=False)
    return _ffn(lp, cfg, lm._residual(x, out))


def encode(params, cfg, src_embeds):
    """(B, S_src, d) frame embeddings -> the encoder's normed output; on a
    mesh each layer's output sequence-parallel, the normed output with its
    sequence gathered, ``("dp", None, None)``, once for every decoder
    layer's cross-attention."""
    x = src_embeds.to(cfg.adtype)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    for lp in _layers(params["enc"]):
        if cfg.remat:
            x = nn.remat(lambda y, lp=lp: _enc_layer(lp, cfg, y, positions), x)
        else:
            x = _enc_layer(lp, cfg, x, positions)
    return nn.constrain(rms_norm(x, params["enc_norm"]), ("dp", None, None))


def _dec_layer(lp, cfg, x, enc_out, *, positions, mode, cache=None, cache_index=None):
    """One decoder layer: (x, its {"self", "cross"} cache, or None in train
    mode).  In decode the cross keys and values come from ``cache``."""
    h = rms_norm(x, lp["norm1"])
    out, self_c = attn.gqa_forward(lp["self"], cfg, h, positions=positions, mode=mode,
                                   cache=cache["self"] if cache else None,
                                   cache_index=cache_index)
    x = lm._residual(x, out)
    h = rms_norm(x, lp["norm_x"])
    out, cross_c = attn.cross_attn_forward(
        lp["cross"], cfg, h, enc_kv=cache["cross"] if (cache and mode == "decode") else None,
        enc_out=enc_out)
    x = _ffn(lp, cfg, lm._residual(x, out))
    return x, ({"self": self_c, "cross": cross_c} if mode in ("prefill", "decode") else None)


def decode_stack(params, cfg, tgt_x, *, mode, enc_out=None, cache=None, cache_index=None):
    """The decoder over ``tgt_x`` (B, S_tgt, d).  Returns (x, caches):
    None in train mode; in prefill the new stacked cache, self keys and
    values of the target's length; in decode ``cache`` (read for the cross
    keys and values, written in place at ``cache_index``: a Python int or
    a 0-d tensor in [0, self_len))."""
    B, S = tgt_x.shape[0], tgt_x.shape[1]
    if mode == "decode":
        positions = torch.full((B, 1), int(cache_index), dtype=torch.int32, device=tgt_x.device)
    else:
        positions = _positions(B, S, tgt_x.device)
    remat = cfg.remat and mode == "train"
    x, caches = tgt_x, []
    for i, lp in enumerate(_layers(params["dec"])):
        if remat:
            x, _ = nn.remat(lambda y, e, lp=lp: _dec_layer(lp, cfg, y, e, positions=positions,
                                                           mode=mode), x, enc_out)
            continue
        c = tree_map(lambda t: t[i], cache) if cache is not None else None
        x, nc = _dec_layer(lp, cfg, x, enc_out, positions=positions, mode=mode, cache=c,
                           cache_index=cache_index)
        caches.append(nc)
    if mode == "prefill":
        return x, lm._stack(caches)
    return x, (cache if mode == "decode" else None)


def _head(params, cfg, x):
    """The final norm and the head; on a mesh the sequence gathered first
    and the head's FSDP shards, so the logits come vocab-sharded."""
    x = nn.constrain(rms_norm(x, params["final_norm"]), ("dp", None, None))
    return x @ nn.gather_fsdp(params["head"]).to(cfg.adtype)


def forward(params, cfg, batch):
    """The train-mode logits (B, S_tgt, padded_vocab) in the activation
    dtype, the padded columns at -1e9.  batch: ``embeds`` (B, S_src, d),
    ``tokens`` (B, S_tgt).  On a mesh the target embedding is
    ``lm.embed_tokens``' vocab-parallel lookup and the logits are
    ``("dp", None, "tp")``."""
    enc_out = encode(params, cfg, batch["embeds"])
    tgt = lm.embed_tokens(params, cfg, batch["tokens"])
    x, _ = decode_stack(params, cfg, tgt, mode="train", enc_out=enc_out)
    return nn.constrain(_mask_pad_vocab(cfg, _head(params, cfg, x)), ("dp", None, "tp"))


def forward_train(params, cfg, batch):
    """batch: {'embeds': (B,S_src,d), 'tokens': (B,S_tgt), 'labels': (B,S_tgt)}.
    Returns (loss, (loss, aux)); aux is a 0-d f32 zero (no aux loss), on a
    mesh a replicated one, as the loss."""
    loss = lm.lm_loss(forward(params, cfg, batch), batch["labels"])
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss, (loss, nn.distribute_like(aux, loss, ()))


def prefill(params, cfg, batch):
    """Returns (cache, the last position's f32 logits (B, 1, padded_vocab))."""
    enc_out = encode(params, cfg, batch["embeds"])
    tgt = params["embed"].to(cfg.adtype)[batch["tokens"]]
    x, caches = decode_stack(params, cfg, tgt, mode="prefill", enc_out=enc_out)
    return caches, _mask_pad_vocab(cfg, _head(params, cfg, x[:, -1:]).float())


def decode_step(params, cfg, cache, token, cache_index):
    """token (B, 1) at position ``cache_index``: returns (cache, written in
    place; f32 logits (B, 1, padded_vocab))."""
    tgt = params["embed"].to(cfg.adtype)[token]
    x, new_cache = decode_stack(params, cfg, tgt, mode="decode", cache=cache,
                                cache_index=cache_index)
    return new_cache, _mask_pad_vocab(cfg, _head(params, cfg, x).float())


def cache_shapes(cfg, batch: int, self_len: int, src_len: int) -> dict:
    """The stacked cache tree as meta tensors: shapes and dtypes, no memory."""
    def kv(length):
        t = torch.empty((cfg.num_layers, batch, length, cfg.num_kv_heads, cfg.head_dim),
                        dtype=cfg.adtype, device="meta")
        return {"k": t, "v": t}

    return {"self": kv(self_len), "cross": kv(src_len)}


def cache_specs(cfg) -> dict:
    """The specs of ``cache_shapes``' tree."""
    kv = P(None, DP, TP, None, None)
    return {"self": {"k": kv, "v": kv}, "cross": {"k": kv, "v": kv}}


def init_cache(cfg, batch: int, self_len: int, src_len: int, *, device=None) -> dict:
    """Zeros of ``cache_shapes``' shapes, each leaf its own memory."""
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device),
                    cache_shapes(cfg, batch, self_len, src_len))


def count_params_analytic(cfg) -> tuple[int, int]:
    """(total_params, active_params), equal: no expert is routed away."""
    with torch.device("meta"):
        shapes = init_params(torch.Generator(), cfg, device="meta")
    total = sum(math.prod(x.shape) for x in leaves(shapes))
    return total, total
