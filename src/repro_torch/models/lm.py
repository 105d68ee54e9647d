"""Decoder-LM assembly: layer patterns, a loop over stacked blocks, loss.

Answers to ``repro/models/lm.py`` with the same public surface and the
same parameter and cache layout: dicts whose ``blocks/pos{i}`` leaves are
stacked over the ``nb`` blocks, shape ``(nb, ...)``, weights ``(in,
out)``, so the JAX package's parameters carry over through
``convert.params_from_numpy``.  The reference's ``lax.scan`` over the
stack becomes a Python loop over its leading axis.

Layers mix with GQA (``"attn"``), MLA (``"mla"``), Mamba (``"mamba"``,
``models/ssm.py``) or RWKV-6 time mixing (``"rwkv"``, ``models/rwkv.py``)
and feed a dense SwiGLU, an MoE FFN (``models/moe.py``) or RWKV-6 channel
mixing (``"rwkv_cm"``); jamba's pattern block is one attention and seven
Mamba layers with an MoE FFN on every second.  ``first_dense`` leading
layers (deepseek-v2's dense layer 0, with its own ``first_dense_d_ff``)
run before the blocks, as ``params["first"]`` and ``cache["first"]``,
lists of layer dicts as in the reference.  A layer's cache is ``{"mix":
...}``, and an RWKV layer's ``{"mix": time mix, "ffn": channel mix}``: its
cache spans both sublayers (token shifts and the wkv state), as the
reference's ``_layer_cache`` splits it.

``param_specs`` (with ``layer_specs`` and ``_ffn_specs``) is the sharding
twin of ``init_params``: the same tree of ``nn.P`` specs, each stacked
leaf's with a leading None for the block axis.  ``cache_shapes`` returns
the cache's shapes (meta tensors) and ``cache_specs(cfg)`` its specs,
where the reference's ``cache_shapes`` returns the pair.

Each MoE layer returns its load-balance loss as a tensor in the graph,
and ``forward`` sums them (the router gets the aux gradient); a dense
layer's is 0.0.

Train mode runs under autograd: attention goes through the flash
backward (``attention._Flash``), each stacked leaf is split into its
blocks once (``unbind``, whose backward is one ``stack``), and with
``cfg.remat`` each block runs under ``torch.utils.checkpoint``
(``nn.remat``: non-reentrant, so the parameters it closes over get their
gradients).  The reference's policies map so:

- ``remat_policy="nothing"`` (``nothing_saveable``): the whole block is
  checkpointed, and the backward recomputes it from its input;
- ``"save_mixer_ffn"`` (``save_only_these_names("mixer_out",
  "ffn_out")``): each sublayer, norm and mixer then norm and FFN, is
  checkpointed on its own.  What autograd keeps at the block level is
  then each sublayer's input, the residual stream before it; the FFN
  sublayer's input is ``x + mixer_out``, so this keeps what the
  reference's two named outputs keep, and the backward recomputes each
  sublayer alone.

The recurrent mixers checkpoint each chunk of their scans too (the
reference's ``jax.checkpoint`` on a chunk body), nested inside the
block's or the sublayer's checkpoint.  Remat changes no value, only what
is kept for the backward.

On a mesh (DTensor parameters and batch, ``fl/steps``' sharded step for
every decoder family: GQA, MLA, RWKV-6 and jamba's mixed pattern of
attention and Mamba layers with dense and MoE FFNs in one block) the
reference's constraints are wired in, each mixer and FFN placing its own
(``attention``, ``moe``, ``rwkv``, ``ssm``, ``nn.swiglu``): the
embedding is a masked lookup of each rank's vocab shard (``local_map``;
the table is ``P(TP, FSDP)``), reduced to ``("dp", None, None)``; each
residual sum sits at a sequence-parallel boundary ``("dp", "sp", None)``
(``_residual``: a mixer's or FFN's partial sum over ``tp`` is
reduce-scattered over the sequence); the logits are ``("dp", None,
"tp")`` with the padded vocabulary masked on each shard; and ``lm_loss``
takes the vocab-parallel form (``_vocab_parallel_loss``), never gathering
the (B, S, V) logits.  The MoE layers' aux losses are summed into a
replicated DTensor.  On plain tensors each of these is the single-device
code.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..pytree import leaves, tree_map
from . import attention as attn
from . import moe as moe_mod
from . import nn, rwkv, ssm
from .nn import FSDP, TP, P, dense_init, embed_init, rms_norm


def _recurrent(fwd):
    """A recurrent mixer's forward under the attention mixers' signature:
    it reads no positions and no cache index."""
    def mixer(p, cfg, x, *, positions, mode, cache=None, cache_index=None):
        return fwd(p, cfg, x, mode=mode, cache=cache)

    return mixer


# (init, forward, cache shapes) of each mixer kind
_MIXERS = {
    "attn": (attn.init_gqa, attn.gqa_forward, attn.gqa_cache_shape),
    "mla": (attn.init_mla, attn.mla_forward, attn.mla_cache_shape),
    "mamba": (ssm.init_mamba, _recurrent(ssm.mamba_forward), ssm.mamba_cache_shape),
    "rwkv": (rwkv.init_time_mix, _recurrent(rwkv.time_mix_forward), rwkv.rwkv_cache_shape),
}

# (parameter specs, cache specs) of each mixer kind
_MIXER_SPECS = {
    "attn": (attn.gqa_specs, attn.gqa_cache_specs),
    "mla": (attn.mla_specs, attn.mla_cache_specs),
    "mamba": (ssm.mamba_specs, ssm.mamba_cache_specs),
    "rwkv": (rwkv.time_mix_specs, rwkv.rwkv_cache_specs),
}


# ---------------------------------------------------------------------------
# layer pattern


def layer_pattern(cfg) -> list[tuple[str, str]]:
    """Pattern of (mixer, ffn) for one block (excludes first_dense)."""
    if cfg.ssm_kind == "rwkv6":
        return [("rwkv", "rwkv_cm")]
    n = cfg.attn_every if cfg.attn_every > 1 else 1
    if cfg.moe_num_experts and cfg.moe_every > 1:
        n = max(n, cfg.moe_every)
    pat = []
    for i in range(n):
        if cfg.ssm_kind == "mamba" and cfg.attn_every > 1:
            mixer = "attn" if i % cfg.attn_every == 0 else "mamba"
        elif cfg.attn_impl == "mla":
            mixer = "mla"
        else:
            mixer = "attn"
        if cfg.moe_num_experts:
            ffn = "moe" if (i % cfg.moe_every == cfg.moe_every - 1 or cfg.moe_every == 1) else "dense"
        else:
            ffn = "dense"
        pat.append((mixer, ffn))
    return pat


def num_blocks(cfg) -> int:
    pat = layer_pattern(cfg)
    n = (cfg.num_layers - cfg.first_dense) // len(pat)
    assert n * len(pat) + cfg.first_dense == cfg.num_layers, (
        cfg.num_layers,
        cfg.first_dense,
        len(pat),
    )
    return n


def _first_mixer(cfg) -> str:
    """The mixer of the ``first_dense`` leading layers."""
    return "mla" if cfg.attn_impl == "mla" else "attn"


# ---------------------------------------------------------------------------
# single layer (one (mixer, ffn) pair)


def _init_ffn(gen, cfg, kind: str, *, d_ff: int | None = None):
    if kind == "moe":
        return moe_mod.init_moe(gen, cfg)
    if kind == "rwkv_cm":
        return rwkv.init_channel_mix(gen, cfg)
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    ks = nn.split_keys(gen, 3)
    dt = cfg.pdtype
    return {
        "wi": dense_init(ks[0], d, (ff,), dt),
        "wg": dense_init(ks[1], d, (ff,), dt),
        "wo": dense_init(ks[2], ff, (d,), dt),
    }


def _ffn_specs(cfg, kind: str):
    if kind == "moe":
        return moe_mod.moe_specs(cfg)
    if kind == "rwkv_cm":
        return rwkv.channel_mix_specs(cfg)
    return {"wi": P(FSDP, TP), "wg": P(FSDP, TP), "wo": P(TP, FSDP)}


def init_layer(gen, cfg, mixer: str, ffn: str, *, d_ff: int | None = None):
    k1, k2 = nn.split_keys(gen, 2)
    return {
        "norm1": torch.zeros((cfg.d_model,), dtype=cfg.pdtype),
        "mixer": _MIXERS[mixer][0](k1, cfg),
        "norm2": torch.zeros((cfg.d_model,), dtype=cfg.pdtype),
        "ffn": _init_ffn(k2, cfg, ffn, d_ff=d_ff),
    }


def layer_specs(cfg, mixer: str, ffn: str):
    return {
        "norm1": P(None),
        "mixer": _MIXER_SPECS[mixer][0](cfg),
        "norm2": P(None),
        "ffn": _ffn_specs(cfg, ffn),
    }


def _mixer_sublayer(p, cfg, x, mixer: str, *, positions, mode, cache=None, cache_index=None):
    h = rms_norm(x, p["norm1"])
    return _MIXERS[mixer][1](p["mixer"], cfg, h, positions=positions, mode=mode,
                            cache=cache.get("mix") if cache else None, cache_index=cache_index)


def _ffn_sublayer(p, cfg, x, ffn: str, mode="train", cache=None):
    """(out, aux, cache): aux an MoE FFN's load-balance loss, 0.0 for the
    others; cache the channel mix's (``cache`` its ``"ffn"`` entry), None
    for the others."""
    h = rms_norm(x, p["norm2"])
    if ffn == "moe":
        return (*moe_mod.moe_forward(p["ffn"], cfg, h), None)
    if ffn == "rwkv_cm":
        out, nc = rwkv.channel_mix_forward(p["ffn"], cfg, h, mode=mode,
                                           cache=cache.get("ffn") if cache else None)
        return out, 0.0, nc
    return nn.swiglu(h, p["ffn"]["wi"], p["ffn"]["wg"], p["ffn"]["wo"]), 0.0, None


SP = ("dp", "sp", None)  # the residual between sublayers: sequence-parallel


def _residual(x, out):
    """``x + out`` at a sequence-parallel boundary: on a mesh both are
    brought to ``SP`` first (``out``, a partial sum over ``tp``, is
    reduce-scattered over the sequence), as the reference constrains the
    sum."""
    return nn.constrain(x, SP) + nn.constrain(out, SP)


def apply_layer(p, cfg, x, mixer: str, ffn: str, *, positions, mode, cache=None, cache_index=None,
                remat_sublayers: bool = False):
    """Returns (x, new_cache, aux); a dense layer's aux loss is 0.0, an MoE
    layer's a 0-d f32 tensor.

    ``remat_sublayers`` (train mode) recomputes each sublayer, norm and
    mixer, norm and FFN, in the backward from its input.
    """
    if remat_sublayers:
        x = _residual(x, nn.remat(lambda y: _mixer_sublayer(p, cfg, y, mixer, positions=positions,
                                                            mode=mode)[0], x))
        out, aux, _ = nn.remat(lambda y: _ffn_sublayer(p, cfg, y, ffn, mode), x)
        return _residual(x, out), None, aux
    out, nc = _mixer_sublayer(p, cfg, x, mixer, positions=positions, mode=mode, cache=cache,
                              cache_index=cache_index)
    x = _residual(x, out)
    out, aux, fc = _ffn_sublayer(p, cfg, x, ffn, mode, cache)
    x = _residual(x, out)
    new_cache = None
    if mode in ("prefill", "decode"):
        new_cache = {"mix": nc} if fc is None else {"mix": nc, "ffn": fc}
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# full model params


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(gen: torch.Generator, cfg, *, device="cpu", place=None) -> nn.Params:
    """Random parameters from a CPU generator, drawn on the CPU and moved to
    ``device`` one layer at a time.

    ``place(tree, path)``, where given, takes each entry of the tree as
    soon as it is drawn (``path`` its keys: ``("embed",)``, ``("first",
    i)``, ``("blocks", "pos0")``) and returns what the tree keeps: on a mesh
    the rank's shards (``launch/train.init_placed``), so no rank holds more
    than one entry of the whole model at a time.  Each layer draws from its
    own generator, so drawing the stacked blocks one position after another
    gives the values of drawing them block by block."""
    put = place or (lambda tree, path: tree)
    pat = layer_pattern(cfg)
    nb = num_blocks(cfg)
    keys = nn.split_keys(gen, 4)
    params: dict[str, Any] = {
        "embed": put(embed_init(keys[0], cfg.padded_vocab, cfg.d_model, cfg.pdtype).to(device),
                     ("embed",)),
        "final_norm": put(torch.zeros((cfg.d_model,), dtype=cfg.pdtype, device=device),
                          ("final_norm",)),
    }
    if not cfg.tie_embeddings:
        params["head"] = put(dense_init(keys[1], cfg.d_model, (cfg.padded_vocab,),
                                        cfg.pdtype).to(device), ("head",))
    if cfg.first_dense:
        params["first"] = [
            put(tree_map(lambda t: t.to(device), init_layer(
                fk, cfg, _first_mixer(cfg), "dense", d_ff=cfg.first_dense_d_ff or cfg.d_ff)),
                ("first", i))
            for i, fk in enumerate(nn.split_keys(keys[2], cfg.first_dense))
        ]

    def stacked(pos, mixer, ffn):  # one block's leaves as views, no copy
        layers = [tree_map(lambda t: t.to(device), init_layer(lk[pos], cfg, mixer, ffn))
                  for lk in layer_keys]
        return _stack(layers) if nb > 1 else tree_map(lambda t: t.unsqueeze(0), layers[0])

    layer_keys = [nn.split_keys(bkey, len(pat)) for bkey in nn.split_keys(keys[3], nb)]
    params["blocks"] = {f"pos{pos}": put(stacked(pos, mixer, ffn), ("blocks", f"pos{pos}"))
                        for pos, (mixer, ffn) in enumerate(pat)}
    return params


def stack_spec(s: P) -> P:
    """A stacked leaf's spec: the block axis replicated."""
    return P(None, *s)


def param_specs(cfg) -> nn.Specs:
    specs: dict[str, Any] = {"embed": P(TP, FSDP), "final_norm": P(None)}
    if not cfg.tie_embeddings:
        specs["head"] = P(FSDP, TP)
    if cfg.first_dense:
        specs["first"] = [layer_specs(cfg, _first_mixer(cfg), "dense")
                          for _ in range(cfg.first_dense)]
    specs["blocks"] = {f"pos{pos}": tree_map(stack_spec, layer_specs(cfg, mixer, ffn))
                       for pos, (mixer, ffn) in enumerate(layer_pattern(cfg))}
    return specs


# ---------------------------------------------------------------------------
# forward


def embed_tokens(params, cfg, tokens):
    """The table's rows of ``tokens`` in the activation dtype.  On a mesh
    the table is vocab-sharded over ``tp``: ``F.embedding`` looks up each
    rank's rows (a masked local lookup, a partial sum over ``tp``), reduced
    to the batch-sharded ``("dp", None, None)``."""
    emb = params["embed"]
    if isinstance(emb, nn.DTensor):
        table = nn.gather_fsdp(emb).to(cfg.adtype)
        ids = nn.distribute_like(torch.arange(emb.shape[0], device=table.device), table, ("tp",))
        mesh = table.device_mesh
        out = nn.layout(mesh, ("dp", None, None), (*tokens.shape, table.shape[1]))
        rows = nn.per_rank(_lookup_local, table, tokens, ids,
                           out=lambda *_: list(nn.partial_over(out, mesh, "tp")),
                           grad=lambda t, tok, i: (nn.partial_over(t.placements, mesh, "dp"),
                                                   tok.placements, i.placements))
        return nn.constrain(rows, ("dp", None, None))
    return emb.to(cfg.adtype)[tokens]


def _lookup_local(table, tokens, ids):
    """One rank's share of an embedding lookup: the rows of its vocab ids
    (``ids``, its slice of arange(V)), zeros for the tokens outside them.
    Summed over the ``tp`` ranks, each token's row once."""
    idx = tokens.long() - ids[0]
    hit = (idx >= 0) & (idx < table.shape[0])
    rows = F.embedding(idx.clamp(0, table.shape[0] - 1), table)
    return torch.where(hit[..., None], rows, 0.0)


def forward(params, cfg, *, tokens=None, embeds=None, mode="train", cache=None, cache_index=None,
            positions=None):
    """Returns (logits, new_cache, aux_loss).

    tokens: (B, S) int or embeds: (B, S, d).  cache: the stacked cache
    {'blocks': ..., 'first': [...]} for decode, written in place and
    returned; prefill returns a new one of the prompt's length.  aux_loss:
    the sum of the MoE layers' load-balance losses, a 0-d f32 tensor.
    """
    pat = layer_pattern(cfg)
    x = embed_tokens(params, cfg, tokens) if embeds is None else embeds.to(cfg.adtype)
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        if mode == "decode":
            assert cache_index is not None
            positions = torch.full((B, 1), int(cache_index), dtype=torch.int32, device=x.device)
        else:
            positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)

    # on a mesh the sum stays a (replicated) DTensor: the MoE layers' are
    aux = nn.distribute_like(torch.zeros((), dtype=torch.float32, device=x.device), x, ())
    first_caches = []
    for i, lp in enumerate(params.get("first", [])):
        x, nc, a = apply_layer(lp, cfg, x, _first_mixer(cfg), "dense", positions=positions,
                               mode=mode, cache=cache["first"][i] if cache is not None else None,
                               cache_index=cache_index)
        aux = aux + a
        first_caches.append(nc)

    # each stacked leaf split into its blocks once: under autograd the
    # backward of the split is one stack, not a zeroed stack per block
    stacks = {name: tree_map(lambda t: t.unbind(0), params["blocks"][name]) for name in
              params["blocks"]}
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    per_sublayer = remat and cfg.remat_policy == "save_mixer_ffn"

    def block(i, x, caches):
        aux, new_cache = 0.0, {}
        for pos, (mixer, ffn) in enumerate(pat):
            name = f"pos{pos}"
            lp = tree_map(lambda u: u[i], stacks[name])
            x, nc, a = apply_layer(lp, cfg, x, mixer, ffn, positions=positions, mode=mode,
                                   cache=caches[name] if caches else None,
                                   cache_index=cache_index, remat_sublayers=per_sublayer)
            aux = aux + a
            if nc is not None:
                new_cache[name] = nc
        return x, aux, new_cache

    per_block = []
    for i in range(num_blocks(cfg)):
        if remat and not per_sublayer:  # "nothing": the whole block recomputed
            x, a, new_cache = nn.remat(lambda y, i=i: block(i, y, None), x)
        else:
            caches = None
            if cache is not None:
                caches = {n: tree_map(lambda t: t[i], c) for n, c in cache["blocks"].items()}
            x, a, new_cache = block(i, x, caches)
        aux = aux + a
        per_block.append(new_cache)

    x = nn.constrain(rms_norm(x, params["final_norm"]), ("dp", None, None))
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    # logits stay in the activation dtype (the loss widens them to f32)
    logits = x @ nn.gather_fsdp(head).to(cfg.adtype)
    if cfg.padded_vocab != cfg.vocab_size:  # mask padded vocab columns
        vmask = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = logits.masked_fill(~nn.distribute_like(vmask, logits, ("tp",)), -1e9)
    logits = nn.constrain(logits, ("dp", None, "tp"))

    if mode == "prefill":
        new_cache = {"blocks": _stack(per_block)}
        if first_caches:
            new_cache["first"] = first_caches
        return logits, new_cache, aux
    if mode == "decode":  # the per-block caches are views of ``cache``
        return logits, cache, aux
    return logits, None, aux


# ---------------------------------------------------------------------------
# loss


def _target_logit(lf, labels, ids):
    """One rank's share of the target logits: ``lf[..., label]`` where the
    label falls in this rank's vocab ids (``ids``, its slice of arange(V)),
    else 0.  Summed over the ``tp`` ranks, each label's logit once."""
    idx = labels.long() - ids[0]
    hit = (idx >= 0) & (idx < lf.shape[-1])
    got = torch.gather(lf, -1, idx.clamp(0, lf.shape[-1] - 1)[..., None])[..., 0]
    return torch.where(hit, got, 0.0)


def _vocab_parallel_loss(logits, labels, mask):
    """``lm_loss`` on vocab-sharded logits ``("dp", None, "tp")``: the local
    max, sum of exps and target logit of each rank's vocab shard, reduced
    over ``tp``, never the whole (B, S, V); the reference's formula, mask
    and ``max(sum(mask), 1)``.  The max is a constant to autograd (its
    terms cancel in the reference's gradient too)."""
    lf = logits.float()
    m = nn.constrain(lf.detach().amax(dim=-1, keepdim=True), ("dp", None, None))
    lse = torch.log(nn.constrain(torch.sum(torch.exp(lf - m), dim=-1), ("dp", None))) + m[..., 0]
    ids = nn.distribute_like(torch.arange(lf.shape[-1], device=lf.device), lf, ("tp",))
    labels = torch.clamp(labels, min=0)
    share = nn.per_rank(_target_logit, lf, labels, ids,
                        out=lambda *_: list(nn.partial_over(lse.placements, lse.device_mesh, "tp")))
    ll = nn.constrain(share, ("dp", None))
    ce = (lse - ll) * mask.float()
    return nn.replicated(torch.sum(ce)) / torch.clamp(nn.replicated(torch.sum(mask)), min=1)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None):
    """Mean cross-entropy in f32. labels: (B, S) int (-1 = pad).  Logits
    that are a DTensor take the vocab-parallel form (``_vocab_parallel_loss``)."""
    if mask is None:
        mask = labels >= 0
    if isinstance(logits, nn.DTensor):
        return _vocab_parallel_loss(logits, labels, mask)
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    ll = torch.gather(lf, -1, torch.clamp(labels, min=0).long()[..., None])[..., 0]
    ce = (lse - ll) * mask.float()
    return torch.sum(ce) / torch.clamp(torch.sum(mask), min=1)


def train_loss(params, cfg, batch):
    logits, _, aux = forward(
        params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"), mode="train",
    )
    loss = lm_loss(logits, batch["labels"])
    return loss + cfg.moe_aux_weight * aux, (loss, aux)


# ---------------------------------------------------------------------------
# caches


def _layer_cache(cfg, mixer: str, batch: int, max_len: int) -> dict:
    """One layer's cache as meta tensors; an RWKV layer's spans the time mix
    (``"mix"``) and the channel mix (``"ffn"``)."""
    shp = _MIXERS[mixer][2](cfg, batch, max_len)
    if mixer == "rwkv":
        return {"mix": shp["tm"], "ffn": shp["cm"]}
    return {"mix": shp}


def cache_shapes(cfg, batch: int, max_len: int):
    """The stacked cache tree as meta tensors: shapes and dtypes, no memory."""
    pat = layer_pattern(cfg)
    nb = num_blocks(cfg)
    out: dict[str, Any] = {"blocks": {
        f"pos{pos}": tree_map(lambda t: t.expand((nb,) + tuple(t.shape)),
                              _layer_cache(cfg, mixer, batch, max_len))
        for pos, (mixer, _) in enumerate(pat)
    }}
    if cfg.first_dense:
        out["first"] = [_layer_cache(cfg, _first_mixer(cfg), batch, max_len)
                        for _ in range(cfg.first_dense)]
    return out


def _layer_cache_specs(cfg, mixer: str) -> dict:
    spec = _MIXER_SPECS[mixer][1](cfg)
    if mixer == "rwkv":
        return {"mix": spec["tm"], "ffn": spec["cm"]}
    return {"mix": spec}


def cache_specs(cfg) -> dict:
    """The specs of ``cache_shapes``' tree (the second half of the
    reference's ``cache_shapes``)."""
    out: dict[str, Any] = {"blocks": {
        f"pos{pos}": tree_map(stack_spec, _layer_cache_specs(cfg, mixer))
        for pos, (mixer, _) in enumerate(layer_pattern(cfg))
    }}
    if cfg.first_dense:
        out["first"] = [_layer_cache_specs(cfg, _first_mixer(cfg)) for _ in range(cfg.first_dense)]
    return out


def init_cache(cfg, batch: int, max_len: int, *, device=None):
    """Zeros of ``cache_shapes``' shapes, each leaf its own memory (decode
    writes into it)."""
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device),
                       cache_shapes(cfg, batch, max_len))


# ---------------------------------------------------------------------------
# analytic parameter counts (meta tensors: no allocation, no draws)


def count_params_analytic(cfg) -> tuple[int, int]:
    """(total_params, active_params): padded query heads (llava) are not
    counted, and active subtracts the experts a token is not routed to."""
    with torch.device("meta"):
        shapes = init_params(torch.Generator(), cfg, device="meta")
    total = sum(math.prod(x.shape) for x in leaves(shapes))
    pat = layer_pattern(cfg)
    H_pad, _ = attn.padded_heads(cfg)
    if H_pad != cfg.num_heads and cfg.attn_impl == "gqa":
        n_attn = sum(1 for m, _ in pat if m == "attn") * num_blocks(cfg) + cfg.first_dense
        total -= n_attn * (H_pad - cfg.num_heads) * cfg.head_dim * cfg.d_model * 2
    active = total
    if cfg.moe_num_experts:
        n_moe = sum(1 for _, f in pat if f == "moe") * num_blocks(cfg)
        per_expert = 3 * cfg.d_model * cfg.moe_d_ff
        active = total - n_moe * (cfg.moe_num_experts - cfg.moe_top_k) * per_expert
    return total, active
