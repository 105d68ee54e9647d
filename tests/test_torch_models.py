"""The port's decoder (dense GQA; MLA and MoE; RWKV-6 and the Mamba hybrid)
against ``repro.models`` on the CPU.

Parameters come from the JAX package's seeded init and cross over with
``repro_torch.convert`` (bfloat16 leaves bit for bit); inputs are numpy
from a seed.  Tolerances, f32 unless said:

- primitives (``rms_norm``, ``swiglu``, ``apply_rope``): rtol = atol =
  1e-6 (one or two f32 roundings in another order; XLA's and PyTorch's
  ``sin``/``cos``/``pow`` may differ by an ulp);
- attention (``chunked_attention``, ``decode_attention``, ``gqa_forward``):
  rtol = atol = 1e-5, the JAX package's own kernel tolerance;
- ``lm.forward`` logits on the reduced configs (2 layers, d 128; the MoE
  ones 3, a leading dense layer and two MoE blocks; jamba 16, two pattern
  blocks of 8): rtol = atol = 1e-5 (measured max |d| 3e-6 at logits up to
  4.3); the MoE aux loss rtol 1e-5;
- decode against the port's own train forward: < 5e-4, the bound of
  ``tests/test_models_smoke.py``;
- bfloat16: 2^-4 of the largest logit magnitude, for the port against JAX
  and for decode against train (one bf16 rounding of an activation in
  another order moves a logit by an ulp, 2^-8 to 2^-7 of it; measured
  2^-7 against JAX and 2^-5.8 for decode at 22 layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.fl import steps as jsteps
from repro.models import attention as ja
from repro.models import lm as jlm
from repro.models import nn as jnn
from torch_threads import one_torch_thread  # noqa: F401
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.fl import steps as tsteps
from repro_torch.launch import serve
from repro_torch.models import attention as ta
from repro_torch.models import lm as tlm
from repro_torch.models import nn as tnn
from repro_torch.pytree import key_paths, leaves

PRIM = dict(rtol=1e-6, atol=1e-6)
ATTN = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-5, atol=1e-5)
DECODE_ATOL = 5e-4
BF16_REL = 2.0**-4

DENSE = ["tinyllama-1.1b", "qwen3-8b", "mistral-large-123b", "deepseek-67b", "llava-next-34b"]
MOE = ["deepseek-v2-lite-16b", "moonshot-v1-16b-a3b"]  # MLA + MoE + a dense layer 0; GQA + MoE
RECURRENT = ["rwkv6-7b", "jamba-1.5-large-398b"]  # RWKV-6; Mamba + attention + MoE


def _cfgs(arch, **kw):
    return jconfigs.get_reduced(arch).replace(**kw), tconfigs.get_reduced(arch).replace(**kw)


def _params(jcfg, seed=0):
    jp = jax.tree.map(np.asarray, jlm.init_params(jax.random.key(seed), jcfg))
    return jp, params_from_numpy(jp, "cpu")


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        return {"embeds": (rng.standard_normal((B, S, cfg.d_model)) * 0.3).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


# ---------------------------------------------------------------------------
# primitives


@pytest.mark.parametrize("shape,dtype", [((3, 7, 64), "float32"), ((2, 5, 4, 32), "float32"),
                                         ((4, 128), "bfloat16")])
def test_rms_norm_matches(shape, dtype):
    rng = np.random.default_rng(len(shape))
    x = jnp.asarray(rng.standard_normal(shape) * 3, dtype)
    scale = jnp.asarray(rng.standard_normal(shape[-1]) * 0.1, dtype)
    want = jnn.rms_norm(x, scale)
    got = tnn.rms_norm(params_from_numpy(np.asarray(x), "cpu"), params_from_numpy(np.asarray(scale), "cpu"))
    assert str(got.dtype) == f"torch.{dtype}"
    tol = PRIM if dtype == "float32" else dict(rtol=2**-7, atol=2**-7)  # one bf16 ulp
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_swiglu_matches_and_keeps_wi_wg_apart():
    rng = np.random.default_rng(0)
    x, wi, wg, wo = (rng.standard_normal(s).astype(np.float32) * 0.3
                     for s in ((2, 9, 32), (32, 48), (32, 48), (48, 32)))
    want = np.asarray(jnn.swiglu(x, wi, wg, wo))
    t = [torch.from_numpy(a) for a in (x, wi, wg, wo)]
    np.testing.assert_allclose(tnn.swiglu(*t).numpy(), want, **PRIM)
    swapped = tnn.swiglu(t[0], t[2], t[1], t[3]).numpy()
    assert np.abs(swapped - want).max() > 1e-2


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("offset", [0, 37])
def test_apply_rope_matches(theta, offset):
    rng = np.random.default_rng(int(theta) + offset)
    x = rng.standard_normal((2, 16, 3, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(offset, offset + 16, dtype=np.int32)[None], (2, 16))
    want = np.asarray(jnn.apply_rope(x, pos, theta))
    got = tnn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), theta)
    np.testing.assert_allclose(got.numpy(), want, **PRIM)
    np.testing.assert_allclose(tnn.rope_freqs(64, theta).numpy(), np.asarray(jnn.rope_freqs(64, theta)),
                               rtol=1e-6, atol=0)


def test_count_and_cast():
    tree = {"a": torch.ones(3, 4), "b": {"c": torch.zeros(5, dtype=torch.int32)}}
    assert tnn.count_params(tree) == 17
    cast = tnn.cast_tree(tree, torch.bfloat16)
    assert cast["a"].dtype == torch.bfloat16 and cast["b"]["c"].dtype == torch.int32


# ---------------------------------------------------------------------------
# attention


@pytest.mark.parametrize("B,Sq,Skv,H,KV,chunk,causal,window,q_offset", [
    (2, 64, 64, 4, 2, 16, True, None, 0),     # nq = nk = 4, G = 2
    (1, 32, 64, 8, 2, 16, True, None, 32),    # q_offset > 0, G = 4
    (2, 64, 64, 4, 4, 16, True, 24, 0),       # windowed: early chunks fully masked
    (2, 48, 48, 6, 2, 16, False, None, 0),    # not causal
    (1, 40, 40, 2, 1, 512, True, None, 0),    # one chunk (chunk > S)
])
def test_chunked_attention_matches_flash(B, Sq, Skv, H, KV, chunk, causal, window, q_offset):
    rng = np.random.default_rng(Sq * H + Skv)
    Dk = 16
    q = rng.standard_normal((B, Sq, H, Dk)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, Dk)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, Dk)).astype(np.float32)
    G = H // KV
    kf, vf = np.repeat(k, G, axis=2), np.repeat(v, G, axis=2)  # the GQA path's layout
    kw = dict(causal=causal, q_offset=q_offset, chunk_q=chunk, chunk_kv=chunk, window=window)
    want = np.asarray(ja.chunked_attention(q, kf, vf, **kw))
    got = ta.chunked_attention(*(torch.from_numpy(a) for a in (q, kf, vf)), **kw)
    np.testing.assert_allclose(got.numpy(), want, **ATTN)
    # grouped k/v (KV < H heads) is the same function as the repeated layout
    grouped = ta.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(grouped.numpy(), np.asarray(ja.chunked_attention(q, k, v, **kw)), **ATTN)


def test_chunked_attention_bf16_rounds_probabilities_like_jax():
    rng = np.random.default_rng(5)
    q, k, v = (jnp.asarray(rng.standard_normal((2, 32, 4, 16)), jnp.bfloat16) for _ in range(3))
    want = ja.chunked_attention(q, k, v, chunk_q=16, chunk_kv=16)
    got = ta.chunked_attention(*(params_from_numpy(np.asarray(a), "cpu") for a in (q, k, v)),
                               chunk_q=16, chunk_kv=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=2**-7, atol=2**-7)


def test_chunked_attention_keeps_the_chunk_assertion():
    x = torch.zeros(1, 48, 2, 8)
    with pytest.raises(AssertionError):
        ta.chunked_attention(x, x, x, chunk_q=32, chunk_kv=32)


@pytest.mark.parametrize("H,KV,length", [(4, 2, 10), (8, 1, 33), (6, 6, 1)])
def test_decode_attention_matches(H, KV, length):
    rng = np.random.default_rng(H * 10 + length)
    B, S, D = 3, 40, 16
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    vc = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    mask = np.broadcast_to(np.arange(S)[None] < length, (B, S)).copy()
    want = np.asarray(ja.decode_attention(q, kc, vc, mask))
    got = ta.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc, mask)))
    np.testing.assert_allclose(got.numpy(), want, **ATTN)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-8b", "llava-next-34b"])
def test_gqa_forward_three_modes(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = jax.tree.map(np.asarray, ja.init_gqa(jax.random.key(3), jcfg))
    tp = params_from_numpy(jp, "cpu")
    rng = np.random.default_rng(7)
    B, S = 2, 64
    x = (rng.standard_normal((B, S, jcfg.d_model)) * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    for mode in ("train", "prefill"):
        jo, jc = ja.gqa_forward(jp, jcfg, x, positions=pos, mode=mode)
        to, tc = ta.gqa_forward(tp, tcfg, torch.from_numpy(x), positions=torch.from_numpy(pos), mode=mode)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **ATTN)
        if mode == "prefill":
            for key in ("k", "v"):
                np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **ATTN)
        else:
            assert tc is None and jc is None
    # decode: one token at index 40 over a cache holding 40 earlier positions
    Smax, idx = 48, 40
    kc = (rng.standard_normal((B, Smax, jcfg.num_kv_heads, jcfg.head_dim)) * 0.5).astype(np.float32)
    vc = (rng.standard_normal(kc.shape) * 0.5).astype(np.float32)
    xt = x[:, :1]
    pt = np.full((B, 1), idx, np.int32)
    jo, jc = ja.gqa_forward(jp, jcfg, xt, positions=pt, mode="decode",
                            cache={"k": kc, "v": vc}, cache_index=jnp.asarray(idx, jnp.int32))
    tcache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    to, tc = ta.gqa_forward(tp, tcfg, torch.from_numpy(xt), positions=torch.from_numpy(pt),
                            mode="decode", cache=tcache, cache_index=idx)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **ATTN)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **ATTN)
        assert tc[key] is tcache[key]  # written in place


def test_parity_rule_9_out_of_range_cache_index():
    """JAX's ``dynamic_update_slice`` clamps an out-of-range index and
    overwrites the cache's last slot; the port raises instead."""
    jcfg, tcfg = _cfgs("tinyllama-1.1b")
    jp = jax.tree.map(np.asarray, ja.init_gqa(jax.random.key(0), jcfg))
    B, Smax = 1, 8
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    kc = np.zeros((B, Smax, jcfg.num_kv_heads, jcfg.head_dim), np.float32)
    _, jc = ja.gqa_forward(jp, jcfg, x, positions=np.full((B, 1), Smax, np.int32), mode="decode",
                           cache={"k": kc, "v": kc}, cache_index=jnp.asarray(Smax, jnp.int32))
    jk = np.asarray(jc["k"])
    assert np.all(jk[:, : Smax - 1] == 0) and np.any(jk[:, Smax - 1] != 0)  # last slot overwritten
    tcache = {"k": torch.zeros(kc.shape), "v": torch.zeros(kc.shape)}
    for bad in (Smax, Smax + 3, -1):
        with pytest.raises(IndexError, match="cache_index"):
            ta.gqa_forward(params_from_numpy(jp, "cpu"), tcfg, torch.from_numpy(x),
                           positions=torch.full((B, 1), bad), mode="decode", cache=tcache,
                           cache_index=bad)
    assert not tcache["k"].any()  # nothing written


def test_head_mask_and_padded_heads():
    for arch in jconfigs.ARCH_IDS:
        jc, tc = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
        assert ta.padded_heads(tc) == ja.padded_heads(jc)
        jm, tm = ja.head_mask(jc), ta.head_mask(tc)
        assert (jm is None) == (tm is None)
        if tm is not None:
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_llava_padded_heads_exact_math():
    """Masked head padding does not change outputs against an unpadded
    model (``tests/test_models_smoke.py``, in the port)."""
    _, cfg = _cfgs("llava-next-34b")
    cfg_nopad = cfg.replace(tp_pad_multiple=1)
    H_pad, _ = ta.padded_heads(cfg)
    assert H_pad > cfg.num_heads
    p = ta.init_gqa(torch.Generator().manual_seed(0), cfg)
    G, G_pad = cfg.num_heads // cfg.num_kv_heads, H_pad // cfg.num_kv_heads
    idx = torch.cat([torch.arange(G) + kv * G_pad for kv in range(cfg.num_kv_heads)])
    p_nopad = dict(p, wq=p["wq"][:, idx], wo=p["wo"][idx])
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(2)) * 0.3
    pos = torch.arange(16, dtype=torch.int32)[None].expand(2, 16)
    out_pad, _ = ta.gqa_forward(p, cfg, x, positions=pos, mode="train")
    out_ref, _ = ta.gqa_forward(p_nopad, cfg_nopad, x, positions=pos, mode="train")
    torch.testing.assert_close(out_pad, out_ref, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the decoder


@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT)
def test_init_params_layout_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = jlm.init_params(jax.random.key(0), jcfg)
    tp = tlm.init_params(torch.Generator().manual_seed(0), tcfg)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = leaves(tp)
    assert len(jflat) == len(tl)
    for (path, j), t in zip(jflat, tl):
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == j.dtype.name, path
    assert tnn.count_params(tp) == jnn.count_params(jp)
    # seeded: the same generator seed gives the same parameters
    again = tlm.init_params(torch.Generator().manual_seed(0), tcfg)
    assert all(torch.equal(a, b) for a, b in zip(tl, leaves(again)))
    emb = tp["embed"]
    assert float(emb.abs().max()) <= 2.0 and 0.8 < float(emb.std()) < 0.95  # truncated N(0, 1)


@pytest.mark.parametrize("arch", list(jconfigs.ARCH_IDS))
def test_count_params_analytic_matches_jax(arch):
    tcfg = tconfigs.get_config(arch)
    assert tlm.count_params_analytic(tcfg) == jlm.count_params_analytic(jconfigs.get_config(arch))


@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT)
def test_cache_shapes_match_jax(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jshp, _ = jlm.cache_shapes(jcfg, 4, 4096)
    tshp = tlm.cache_shapes(tcfg, 4, 4096)
    jl, tl = jax.tree.leaves(jshp), leaves(tshp)
    assert [(tuple(t.shape), str(t.dtype)[6:]) for t in tl] == [(j.shape, j.dtype.name) for j in jl]
    assert all(t.is_meta for t in tl)
    small = tlm.init_cache(tconfigs.get_reduced(arch), 2, 8)
    assert all(not t.any() for t in leaves(small))


@pytest.mark.parametrize("arch", DENSE + ["seamless-m4t-medium"] + MOE + RECURRENT)
def test_forward_train_logits_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    batch = _inputs(jcfg, 2, 128, seed=1)  # attn_chunk 64: two query and two key chunks
    jl, _, jaux = jlm.forward(jp, jcfg, mode="train", **batch)
    tl, tcache, taux = tlm.forward(tp, tcfg, mode="train", **_t(batch))
    assert tcache is None and taux.dtype == torch.float32 and taux.shape == ()
    if tcfg.moe_num_experts:  # the MoE layers' load-balance losses
        assert float(jaux) > 0
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    else:
        assert float(taux) == float(jaux) == 0.0
    assert tl.shape == (2, 128, tcfg.padded_vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)


def test_forward_masks_padded_vocab_like_jax():
    jcfg, tcfg = _cfgs("tinyllama-1.1b", vocab_size=500, vocab_pad_multiple=256)
    assert tcfg.padded_vocab == 512
    jp, tp = _params(jcfg)
    batch = _inputs(jcfg, 2, 16, seed=3)
    jl, _, _ = jlm.forward(jp, jcfg, mode="train", **batch)
    tl, _, _ = tlm.forward(tp, tcfg, mode="train", **_t(batch))
    assert torch.all(tl[..., 500:] == -1e9)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-8b"] + MOE + RECURRENT)
def test_lm_loss_and_train_loss_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    batch = _inputs(jcfg, 2, 32, seed=4)
    labels = np.random.default_rng(5).integers(-1, jcfg.vocab_size, (2, 32)).astype(np.int32)
    jloss, (jce, jaux) = jlm.train_loss(jp, jcfg, dict(batch, labels=labels))
    tloss, (tce, taux) = tlm.train_loss(tp, tcfg, dict(_t(batch), labels=torch.from_numpy(labels)))
    np.testing.assert_allclose(float(tloss), float(jloss), **LOGITS)
    np.testing.assert_allclose(float(tce), float(jce), **LOGITS)
    np.testing.assert_allclose(float(taux), float(jaux), **LOGITS)


def test_prefill_cache_matches_jax():
    jcfg, tcfg = _cfgs("qwen3-8b")
    jp, tp = _params(jcfg)
    batch = _inputs(jcfg, 2, 64, seed=6)
    jl, jc, _ = jlm.forward(jp, jcfg, mode="prefill", **batch)
    tl, tc, _ = tlm.forward(tp, tcfg, mode="prefill", **_t(batch))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    jleaves, tleaves = jax.tree.leaves(jc), leaves(tc)
    assert len(jleaves) == len(tleaves) == 2
    for a, b in zip(tleaves, jleaves):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ATTN)


@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_cache_matches_jax(arch):
    """The MoE configs' prefill: logits, and a cache whose leaves (the
    leading layer's list entry included) follow JAX's in order and value."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    batch = _inputs(jcfg, 2, 64, seed=6)
    jl, jc, jaux = jlm.forward(jp, jcfg, mode="prefill", **batch)
    tl, tc, taux = tlm.forward(tp, tcfg, mode="prefill", **_t(batch))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert isinstance(tc.get("first", []), list) and (arch == MOE[0]) == ("first" in tc)
    jflat = jax.tree_util.tree_flatten_with_path(jc)[0]
    assert [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)) for kp, _ in
            jflat] == key_paths(tc)
    for a, (_, b) in zip(leaves(tc), jflat):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ATTN)


@pytest.mark.parametrize("arch,B,S", [("rwkv6-7b", 2, 40), ("jamba-1.5-large-398b", 8, 40)])
def test_recurrent_prefill_cache_matches_jax(arch, B, S):
    """A prefill of 40 tokens (40 % ssm_chunk 16 != 0: chunks of 8): logits,
    and a cache whose leaves follow JAX's in order, shape, dtype and value:
    RWKV's spans the time mix ("mix") and the channel mix ("ffn"); jamba's
    holds the attention layer's k and v beside the Mamba layers' conv and
    h.  (jamba: B 8, for the MoE's groups of 64 tokens.)"""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    batch = _inputs(jcfg, B, S, seed=12)
    jl, jc, jaux = jlm.forward(jp, jcfg, mode="prefill", **batch)
    tl, tc, taux = tlm.forward(tp, tcfg, mode="prefill", **_t(batch))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    jflat = jax.tree_util.tree_flatten_with_path(jc)[0]
    assert [("/".join(str(getattr(k, "key", k)) for k in kp)) for kp, _ in jflat] == key_paths(tc)
    for a, (_, b) in zip(leaves(tc), jflat):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == b.dtype.name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ATTN)
    want = {"rwkv6-7b": {"ffn/shift", "mix/shift", "mix/state"},
            "jamba-1.5-large-398b": {"mix/k", "mix/v", "mix/conv", "mix/h"}}[arch]
    assert {p.split("/", 2)[2] for p in key_paths(tc)} == want


@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT)
def test_decode_matches_train_forward(arch):
    """``tests/test_models_smoke.py``'s decode check, in the port (MoE made
    dropless, as there: capacity factor 64)."""
    cfg = tconfigs.get_reduced(arch).replace(capacity_factor=64.0)
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg)
    B, S, P0 = 2, 32, 24
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1))
    logits_full, _, _ = tlm.forward(params, cfg, tokens=tokens, mode="train")
    cache = serve.merge_cache(
        tlm.init_cache(cfg, B, S),
        tlm.forward(params, cfg, tokens=tokens[:, :P0], mode="prefill")[1],
    )
    errs = []
    for t in range(P0, S):
        lt, cache, _ = tlm.forward(params, cfg, tokens=tokens[:, t : t + 1], mode="decode",
                                   cache=cache, cache_index=t)
        errs.append(float((lt[:, 0] - logits_full[:, t]).abs().max()))
    assert max(errs) < DECODE_ATOL, (arch, max(errs))


def test_bf16_reduced_forward_and_decode():
    """bfloat16 activations and parameters: against JAX's bf16 forward, and
    decode against the port's own train forward, each within 2^-4 of the
    largest logit magnitude."""
    jcfg, tcfg = _cfgs("tinyllama-1.1b", dtype="bfloat16", param_dtype="bfloat16")
    jp, tp = _params(jcfg)
    assert all(t.dtype == torch.bfloat16 for t in leaves(tp))
    B, S, P0 = 2, 64, 48
    batch = _inputs(jcfg, B, S, seed=8)
    jl, _, _ = jlm.forward(jp, jcfg, mode="train", **batch)
    tl, _, _ = tlm.forward(tp, tcfg, mode="train", **_t(batch))
    assert tl.dtype == torch.bfloat16
    bound = BF16_REL * float(tl.float().abs().max())
    assert float(np.abs(_np(tl) - _np(jl)).max()) < bound
    toks = _t(batch)["tokens"]
    cache = serve.merge_cache(tlm.init_cache(tcfg, B, S),
                              tlm.forward(tp, tcfg, tokens=toks[:, :P0], mode="prefill")[1])
    assert all(t.dtype == torch.bfloat16 for t in leaves(cache))
    errs = []
    for t in range(P0, S):
        lt, cache, _ = tlm.forward(tp, tcfg, tokens=toks[:, t : t + 1], mode="decode",
                                   cache=cache, cache_index=t)
        errs.append(float((lt[:, 0].float() - tl[:, t].float()).abs().max()))
    assert max(errs) < bound, (max(errs), bound)


def test_bf16_params_round_trip_bit_for_bit():
    jcfg, _ = _cfgs("tinyllama-1.1b", dtype="bfloat16", param_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jlm.init_params(jax.random.key(4), jcfg))
    tp = params_from_numpy(jp, "cpu")
    back = params_to_numpy(tp)
    for a, b, t in zip(jax.tree.leaves(jp), leaves(back), leaves(tp)):
        assert t.dtype == torch.bfloat16 and b.dtype == a.dtype
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))
        np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


# ---------------------------------------------------------------------------
# serving


def _jax_serve(jcfg, jp, batch, G):
    """``repro.launch.serve``'s loop, eagerly: prefill, merge, G - 1 decodes."""
    B, P = next(iter(batch.values())).shape[:2]
    pcache, tok = jsteps.build_prefill_step(jcfg)(jp, batch)
    full = jlm.init_cache(jcfg, B, P + G)
    cache = jax.tree.map(
        lambda a, b: jax.lax.dynamic_update_slice(a, b.astype(a.dtype), (0,) * a.ndim), full, pcache)
    decode = jsteps.build_decode_step(jcfg)
    out = [tok]
    for i in range(G - 1):
        cache, tok = decode(jp, cache, tok[:, None], jnp.asarray(P + i, jnp.int32))
        out.append(tok)
    return np.asarray(jnp.stack(out, axis=1))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-8b", "llava-next-34b"] + MOE + RECURRENT)
def test_reduced_serve_greedy_tokens_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    B, P, G = 4, 32, 16
    batch = _inputs(jcfg, B, P, seed=11)
    want = _jax_serve(jcfg, jp, batch, G)
    res = serve.generate(tp, tcfg, _t(batch), G)
    got = res["tokens"]
    assert got.dtype == torch.int32 and got.shape == (B, G)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(res["decode_ms"]) == G - 1 and res["prefill_ms"] > 0


@pytest.mark.parametrize("arch", ["tinyllama-1.1b"] + RECURRENT)
def test_serve_main_on_cpu(capsys, arch):
    serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "16",
                "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill 16 tokens x2" in out and "ms/token" in out and "generated token ids" in out


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device would run there")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve.main(["--reduced", "--gen", "2"])


def test_merge_cache_writes_the_prefix():
    full = {"k": torch.zeros(2, 3, 8, 1, 4)}
    pre = {"k": torch.ones(2, 3, 5, 1, 4)}
    out = serve.merge_cache(full, pre)
    assert out["k"] is full["k"]
    assert bool(out["k"][:, :, :5].eq(1).all()) and not out["k"][:, :, 5:].any()


def test_config_dataclass_is_frozen():
    cfg = tconfigs.get_reduced("tinyllama-1.1b")
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.d_model = 3
