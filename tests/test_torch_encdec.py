"""The port's encoder-decoder family (``models/encdec.py``, cross-attention)
against ``repro.models.encdec`` on the CPU, at
``configs.get_reduced("seamless-m4t-medium")``: d 128, 4 query heads and 2
kv heads of 32 (G = 2), 2 encoder and 2 decoder layers, f32, attn_chunk 64.

Parameters come from the JAX package's seeded init through ``convert.py``,
with every norm leaf (zeros at init, so a swapped or skipped norm would
not show) redrawn from a seed on both sides; inputs are numpy from a
seed.  The reference runs under a (1, 1, 1) mesh, as the training tests'
do.  Tolerances, f32:

- cross-attention, ``encode``, ``decode_stack``, logits: rtol = atol =
  1e-5, the JAX package's own kernel tolerance;
- gradients: each leaf within GRAD_REL = 1e-5 of its largest magnitude;
  the loss rtol 1e-6;
- decode against the port's own train forward: < 5e-4, the bound of
  ``tests/test_models_smoke.py``;
- training: 5-step loss trajectories within TRAJ_RTOL = 1e-5 of JAX's,
  each step from JAX's own state within STEP_RTOL = 1e-5;
- remat on against off: bit for bit but the embedding table's gradient,
  whose CPU backward adds a repeated token's rows in an order of its own
  (within 1e-6 of its largest magnitude).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro import configs as jconfigs
from repro import data as jdata
from repro.config import RunPlan as JRunPlan
from repro.fl import steps as jsteps
from repro.models import attention as ja
from repro.models import encdec as jencdec
from torch_threads import one_torch_thread  # noqa: F401
from repro_torch import ckpt as tckpt
from repro_torch import configs as tconfigs
from repro_torch.config import RunPlan
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.fl import steps as tsteps
from repro_torch.launch import serve
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as ta
from repro_torch.models import encdec as tencdec
from repro_torch.pytree import key_paths, leaves, tree_map

ARCH = "seamless-m4t-medium"
ATTN = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-5
DECODE_ATOL = 5e-4
TRAJ_RTOL = 1e-5
STEP_RTOL = 1e-5
NORMS = ("norm1", "norm2", "norm_x", "enc_norm", "final_norm")


def _mesh():
    return jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)


def _cfgs(**kw):
    return jconfigs.get_reduced(ARCH).replace(**kw), tconfigs.get_reduced(ARCH).replace(**kw)


def _redraw_norms(tree, rng, path=""):
    """Every norm leaf (zeros at init) drawn as 0.3 N(0, 1), in key order."""
    if isinstance(tree, dict):
        return {k: _redraw_norms(tree[k], rng, k) for k in sorted(tree)}
    if path in NORMS:
        return (0.3 * rng.standard_normal(tree.shape)).astype(tree.dtype)
    return tree


def _params(jcfg, seed=0):
    jp = jax.tree.map(np.asarray, jencdec.init_params(jax.random.key(seed), jcfg))
    jp = _redraw_norms(jp, np.random.default_rng(100 + seed))
    return jp, params_from_numpy(jp, "cpu")


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _batch(cfg, B, S_src, S_tgt, seed):
    rng = np.random.default_rng(seed)
    return {"embeds": (rng.standard_normal((B, S_src, cfg.d_model)) * 0.3).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, S_tgt)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S_tgt)).astype(np.int32)}


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close_to_max(got, want, rel):
    """Every leaf within ``rel`` of that leaf's largest magnitude."""
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        a, b = a.detach().float().numpy(), np.asarray(b, np.float32)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= rel * np.abs(b).max(), (np.abs(a - b).max(), np.abs(b).max())


def _assert_tree_close(got, want, **tol):
    assert key_paths(got) == key_paths(params_from_numpy(jax.tree.map(np.asarray, want), "cpu"))
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


# ---------------------------------------------------------------------------
# the parameter tree and the caches


def test_init_params_keep_the_reference_tree():
    """Key paths, shapes and dtypes of the reference's tree (the stacked
    ``enc`` / ``dec`` leaves with their leading layer axis), and the full
    config's count from meta tensors."""
    jcfg, tcfg = _cfgs()
    jp = jax.eval_shape(lambda: jencdec.init_params(jax.random.key(0), jcfg))
    tp = tencdec.init_params(torch.Generator().manual_seed(0), tcfg)
    want = params_from_numpy(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jp), "cpu")
    assert key_paths(tp) == key_paths(want)
    for a, b in zip(leaves(tp), leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert tp["dec"]["cross"]["wk"].shape == (2, 128, 2, 32)
    full = tconfigs.get_config(ARCH)
    assert tencdec.count_params_analytic(full) == (977_860_608, 977_860_608)


def test_cache_shapes_match_jax():
    jcfg, tcfg = _cfgs()
    want, _ = jencdec.cache_shapes(jcfg, 3, 40, 24)
    got = tencdec.cache_shapes(tcfg, 3, 40, 24)
    jl = jax.tree.leaves(want)
    assert key_paths(got) == ["cross/k", "cross/v", "self/k", "self/v"]
    for a, b in zip(leaves(got), jl):
        assert a.is_meta and tuple(a.shape) == b.shape and str(a.dtype)[6:] == str(b.dtype)
    zeros = tencdec.init_cache(tcfg, 3, 40, 24)
    for a, b in zip(leaves(zeros), jax.tree.leaves(jencdec.init_cache(jcfg, 3, 40, 24))):
        assert not a.is_meta and tuple(a.shape) == b.shape and not a.any()
    assert len({t.data_ptr() for t in leaves(zeros)}) == 4  # each leaf its own memory


# ---------------------------------------------------------------------------
# cross-attention


@pytest.mark.parametrize("S_tgt,S_src,cached", [
    (128, 64, False),   # two query chunks over one key chunk
    (64, 192, False),   # one query chunk over three key chunks
    (1, 80, False),     # the one-token branch: decode_attention, all-ones mask
    (64, 128, True),    # keys and values from the cache, not recomputed
    (1, 128, True),     # a decode step
])
def test_cross_attention_matches_jax(S_tgt, S_src, cached):
    jcfg, tcfg = _cfgs()
    assert jcfg.num_heads // jcfg.num_kv_heads == 2
    jp, tp = _params(jcfg)
    p = jax.tree.map(lambda a: a[1], jp["dec"]["cross"])  # layer 1
    tpc = tree_map(lambda t: t[1], tp["dec"]["cross"])
    x = _x((2, S_tgt, jcfg.d_model), S_tgt)
    enc = _x((2, S_src, jcfg.d_model), S_src + 1)
    kw_j, kw_t = {"enc_out": jnp.asarray(enc)}, {"enc_out": torch.from_numpy(enc)}
    if cached:
        kv = {"k": _x((2, S_src, 2, 32), 7), "v": _x((2, S_src, 2, 32), 8)}
        kw_j, kw_t = {"enc_kv": _j(kv)}, {"enc_kv": _t(kv)}
    want, want_kv = ja.cross_attn_forward(p, jcfg, jnp.asarray(x), **kw_j)
    got, got_kv = ta.cross_attn_forward(tpc, tcfg, torch.from_numpy(x), **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN)
    for k in ("k", "v"):
        np.testing.assert_allclose(got_kv[k].numpy(), np.asarray(want_kv[k]), **ATTN)
    if cached:  # handed back as they came
        assert got_kv["k"] is kw_t["enc_kv"]["k"] and got_kv["v"] is kw_t["enc_kv"]["v"]


@pytest.mark.parametrize("S_tgt,S_src", [(128, 192), (1, 64)])
def test_cross_attention_gradients_match_jax_vjp(S_tgt, S_src):
    """The flash backward with G = 2 inside the core (the kv heads are not
    repeated), and the one-token branch, against ``jax.vjp``: the
    gradients of x, the encoder output and every weight."""
    jcfg, tcfg = _cfgs()
    jp, _ = _params(jcfg)
    p = jax.tree.map(lambda a: a[0], jp["dec"]["cross"])
    x = _x((2, S_tgt, jcfg.d_model), 3)
    enc = _x((2, S_src, jcfg.d_model), 4)
    dout = _x((2, S_tgt, jcfg.d_model), 5)

    def f(p, x, e):
        return ja.cross_attn_forward(p, jcfg, x, enc_out=e)[0]

    out, vjp = jax.vjp(f, _j(p), jnp.asarray(x), jnp.asarray(enc))
    want = vjp(jnp.asarray(dout))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in p.items()}
    tx, te = (torch.from_numpy(a).requires_grad_(True) for a in (x, enc))
    got_out, _ = ta.cross_attn_forward(tp, tcfg, tx, enc_out=te)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), **ATTN)
    names = sorted(tp)
    got = torch.autograd.grad(got_out, [tp[n] for n in names] + [tx, te], torch.from_numpy(dout))
    for g, w in zip(got, [want[0][n] for n in names] + [want[1], want[2]]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ATTN)


# ---------------------------------------------------------------------------
# the encoder and the decoder stack


def test_encode_matches_jax_and_is_bidirectional():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    src = _x((2, 128, jcfg.d_model), 9, 0.3)
    with jax.set_mesh(_mesh()):
        want = jencdec.encode(_j(jp), jcfg, jnp.asarray(src))
    got = tencdec.encode(tp, tcfg, torch.from_numpy(src))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN)
    # a later frame moves the first frame's output (a causal encoder's would not)
    moved = src.copy()
    moved[:, -1] += 1.0
    again = tencdec.encode(tp, tcfg, torch.from_numpy(moved))
    assert float((again[:, 0] - got[:, 0]).abs().max()) > 1e-3


def test_encode_shapes():
    """``tests/test_models_smoke.py``'s enc-dec case on the port."""
    _, tcfg = _cfgs()
    tp = tencdec.init_params(torch.Generator().manual_seed(0), tcfg)
    enc = tencdec.encode(tp, tcfg, torch.zeros(2, 16, tcfg.d_model))
    assert enc.shape == (2, 16, tcfg.d_model) and bool(torch.isfinite(enc).all())


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_decode_stack_matches_jax(mode):
    """The decoder's states in each mode, and the caches: prefill's (self
    keys and values of the target's length, cross keys and values of the
    source's), decode's written in place at the index."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    B, S_src, S_tgt = 2, 128, 64
    enc = _x((B, S_src, jcfg.d_model), 10)
    tgt = _x((B, S_tgt, jcfg.d_model), 11)
    if mode != "decode":
        with jax.set_mesh(_mesh()):
            want, wc = jencdec.decode_stack(_j(jp), jcfg, jnp.asarray(tgt), mode=mode,
                                            enc_out=jnp.asarray(enc))
        got, gc = tencdec.decode_stack(tp, tcfg, torch.from_numpy(tgt), mode=mode,
                                       enc_out=torch.from_numpy(enc))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN)
        if mode == "train":
            assert gc is None
        else:
            _assert_tree_close(gc, wc, **ATTN)
        return
    cache = {"self": {"k": _x((2, B, 80, 2, 32), 12), "v": _x((2, B, 80, 2, 32), 13)},
             "cross": {"k": _x((2, B, S_src, 2, 32), 14), "v": _x((2, B, S_src, 2, 32), 15)}}
    tok = tgt[:, :1]
    with jax.set_mesh(_mesh()):
        want, wc = jencdec.decode_stack(_j(jp), jcfg, jnp.asarray(tok), mode="decode",
                                        cache=_j(cache), cache_index=jnp.asarray(37, jnp.int32))
    tcache = params_from_numpy(cache, "cpu")
    got, gc = tencdec.decode_stack(tp, tcfg, torch.from_numpy(tok), mode="decode", cache=tcache,
                                   cache_index=37)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN)
    assert gc is tcache  # written in place
    _assert_tree_close(gc, wc, **ATTN)
    assert not np.array_equal(gc["self"]["k"][:, :, 37].numpy(), cache["self"]["k"][:, :, 37])


def test_stacked_leaves_are_split_once(monkeypatch):
    """The forward takes each stacked leaf apart once (``unbind``), not
    once per layer."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    batch = _t(_batch(jcfg, 2, 64, 64, seed=2))
    n_stacked = len(leaves(tp["enc"])) + len(leaves(tp["dec"]))
    calls = []
    orig = torch.Tensor.unbind
    monkeypatch.setattr(torch.Tensor, "unbind", lambda t, *a: calls.append(1) or orig(t, *a))
    tsteps.grads_and_metrics(tcfg, RunPlan(), tp, batch)
    assert len(calls) == n_stacked


# ---------------------------------------------------------------------------
# the loss and its gradients


def test_forward_train_loss_and_gradients_match_jax():
    """S_src 128 and S_tgt 64 (different lengths, so a swap shows)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    batch = _batch(jcfg, 2, 128, 64, seed=1)
    with jax.set_mesh(_mesh()):
        (jl, (jce, jaux)), jg = jax.value_and_grad(
            lambda p: jencdec.forward_train(p, jcfg, _j(batch)), has_aux=True)(_j(jp))
    loss, (ce, aux) = tencdec.forward_train(tp, tcfg, _t(batch))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    assert float(aux) == float(jaux) == 0.0 and aux.dtype == torch.float32
    g, m = tsteps.grads_and_metrics(tcfg, RunPlan(), tp, _t(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jce), rtol=1e-6)
    assert all(x.dtype == torch.float32 for x in leaves(g))
    _close_to_max(g, jg, GRAD_REL)


def test_padded_vocab_columns_read_minus_1e9():
    """At ``vocab_size`` 500 (padded to 512) the padded logit columns read
    -1e9 in the train forward and in prefill, and the loss matches JAX's."""
    jcfg, tcfg = _cfgs(vocab_size=500)
    assert tcfg.padded_vocab == 512
    jp, tp = _params(jcfg)
    batch = _batch(jcfg, 2, 64, 64, seed=6)
    with jax.set_mesh(_mesh()):
        jl, _ = jencdec.forward_train(_j(jp), jcfg, _j(batch))
        _, jlast = jencdec.prefill(_j(jp), jcfg, _j(batch))
    logits = tencdec.forward(tp, tcfg, _t(batch))
    assert bool((logits[..., 500:] == -1e9).all()) and bool((logits[..., :500] > -1e3).all())
    np.testing.assert_allclose(float(tencdec.forward_train(tp, tcfg, _t(batch))[0]), float(jl),
                               rtol=1e-6)
    _, last = tencdec.prefill(tp, tcfg, _t(batch))
    assert last.dtype == torch.float32 and bool((last[..., 500:] == -1e9).all())
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **ATTN)


@pytest.mark.parametrize("policy", ["nothing", "save_mixer_ffn"])
def test_remat_changes_no_gradient(policy):
    """Remat recomputes every encoder and decoder layer in the backward
    (encoder layer 0 from data embeddings): every gradient bit-equal."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    batch = _t(_batch(jcfg, 2, 128, 64, seed=2))
    off, m_off = tsteps.grads_and_metrics(tcfg, RunPlan(), tp, batch)
    on, m_on = tsteps.grads_and_metrics(tcfg.replace(remat=True, remat_policy=policy), RunPlan(),
                                        tp, batch)
    assert torch.equal(m_on["loss"], m_off["loss"])
    for name in on:
        if name == "embed":  # the CPU's embedding backward adds repeated rows in any order
            torch.testing.assert_close(on[name], off[name], rtol=0, atol=1e-6 * float(
                off[name].abs().max()))
            continue
        for a, b in zip(leaves(on[name]), leaves(off[name])):
            assert torch.equal(a, b)


def test_remat_recomputes_every_layer(monkeypatch):
    """Under remat each layer's FFN runs twice (forward, then in the
    backward); without it once: 2 + 2 layers."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    batch = _t(_batch(jcfg, 2, 64, 64, seed=2))
    calls = []
    orig = tencdec._ffn
    monkeypatch.setattr(tencdec, "_ffn", lambda *a: calls.append(1) or orig(*a))
    for remat, want in ((False, 4), (True, 8)):
        calls.clear()
        tsteps.grads_and_metrics(tcfg.replace(remat=remat), RunPlan(), tp, batch)
        assert len(calls) == want, (remat, len(calls))


# ---------------------------------------------------------------------------
# decode against the train forward, and serving


def test_encdec_decode_matches_train():
    """``tests/test_models_smoke.py::test_encdec_decode_matches_train`` on
    the port: prefill 12 target tokens over 24 source frames, then each
    decode step's logits against the train forward's."""
    _, tcfg = _cfgs()
    tp = tencdec.init_params(torch.Generator().manual_seed(0), tcfg)
    B, Ss, St, P0 = 2, 24, 16, 12
    gen = torch.Generator().manual_seed(2)
    embeds = torch.randn((B, Ss, tcfg.d_model), generator=gen) * 0.3
    tokens = torch.randint(0, tcfg.vocab_size, (B, St), generator=gen)
    full = tencdec.forward(tp, tcfg, {"embeds": embeds, "tokens": tokens})
    enc_out = tencdec.encode(tp, tcfg, embeds)
    tgt = tp["embed"][tokens]
    cache = serve.merge_cache(
        tencdec.init_cache(tcfg, B, St, Ss),
        tencdec.decode_stack(tp, tcfg, tgt[:, :P0], mode="prefill", enc_out=enc_out)[1])
    errs = []
    for t in range(P0, St):
        cache, lt = tencdec.decode_step(tp, tcfg, cache, tokens[:, t: t + 1], t)
        errs.append(float((lt[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < DECODE_ATOL


def _jax_serve(jcfg, jp, batch, G):
    """``repro.launch.serve``'s enc-dec loop, eagerly: prefill, merge into
    ``init_cache(B, P + G, P)``, G - 1 decodes."""
    B, P = batch["tokens"].shape
    with jax.set_mesh(_mesh()):
        pcache, tok = jsteps.build_prefill_step(jcfg)(jp, batch)
        full = jencdec.init_cache(jcfg, B, P + G, batch["embeds"].shape[1])
        cache = jax.tree.map(lambda a, b: jax.lax.dynamic_update_slice(
            a, b.astype(a.dtype), (0,) * a.ndim), full, pcache)
        decode = jsteps.build_decode_step(jcfg)
        out = [tok]
        for i in range(G - 1):
            cache, tok = decode(jp, cache, tok[:, None], jnp.asarray(P + i, jnp.int32))
            out.append(tok)
    return np.asarray(jnp.stack(out, axis=1))


def test_reduced_serve_greedy_tokens_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    B, P, G = 4, 32, 16
    batch = _batch(jcfg, B, P, P, seed=11)
    del batch["labels"]
    want = _jax_serve(jcfg, _j(jp), _j(batch), G)
    res = serve.generate(tp, tcfg, _t(batch), G)
    got = res["tokens"]
    assert got.dtype == torch.int32 and got.shape == (B, G)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(res["decode_ms"]) == G - 1 and res["prefill_ms"] > 0


def test_serve_make_batch_draws_frames_and_tokens():
    _, tcfg = _cfgs()
    b = serve.make_batch(tcfg, 3, 20, torch.Generator().manual_seed(1), "cpu")
    assert sorted(b) == ["embeds", "tokens"]
    assert b["embeds"].shape == (3, 20, tcfg.d_model) and b["tokens"].dtype == torch.int32
    cache = serve.full_cache(tcfg, b, 5)
    assert cache["self"]["k"].shape == (2, 3, 25, 2, 32)
    assert cache["cross"]["k"].shape == (2, 3, 20, 2, 32)


def test_serve_main_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "16", "--gen", "4",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill 16 tokens x2" in out and "ms/token" in out and "generated token ids" in out


# ---------------------------------------------------------------------------
# training


def _jax_batch(jcfg, sc, s):
    b = jdata.learnable_lm_batch(sc, 0, s)
    return {"embeds": jnp.asarray(jdata.embeds_batch(sc, jcfg.d_model, 0, s)),
            "tokens": jnp.asarray(b["tokens"]), "labels": jnp.asarray(b["labels"])}


@pytest.mark.parametrize("aggregation,num_pods", [("totoro_tree", 1), ("totoro_tree_q8", 2)])
def test_five_step_loss_trajectory_matches_jax(aggregation, num_pods):
    """The plain and the podded step (the q8 hop takes all 27 leaves: 4 top
    level, 9 an encoder layer, 14 a decoder layer) against JAX's jitted
    ``build_train_step``: each step from JAX's own state, then the port's
    own five steps."""
    jcfg, tcfg = _cfgs(learning_rate=2e-3)
    jp, tp = _params(jcfg)
    assert len(leaves(tp)) == 27
    plan_j, plan_t = JRunPlan(aggregation=aggregation), RunPlan(aggregation=aggregation)
    sc = jdata.StreamConfig(jcfg.vocab_size, 64, 8)
    podded = num_pods > 1
    want, jstates = [], []
    with jax.set_mesh(_mesh()):
        jstate = jsteps.init_train_state(jcfg, _j(jp), num_pods=num_pods, podded=podded)
        fn = jax.jit(jsteps.build_train_step(jcfg, plan_j, num_pods=num_pods))
        for s in range(5):
            jstates.append(jax.tree.map(np.asarray, jstate))
            jstate, m = fn(jstate, _jax_batch(jcfg, sc, s))
            want.append(float(m["loss"]))
    step = tsteps.build_train_step(tcfg, plan_t, num_pods=num_pods)
    tsc = ttrain.StreamConfig(tcfg.vocab_size, 64, 8)
    forced = [float(step(params_from_numpy(jstates[s], "cpu"),
                         ttrain.make_batch(tcfg, tsc, s, None, "cpu"))[1]["loss"])
              for s in range(5)]
    np.testing.assert_allclose(forced, want, rtol=STEP_RTOL)
    state = tsteps.init_train_state(tcfg, tp, num_pods=num_pods, podded=podded)
    got = []
    for s in range(5):
        state, m = step(state, ttrain.make_batch(tcfg, tsc, s, None, "cpu"))
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    assert got[-1] < got[0] - 0.5, got
    for a, b in zip(leaves(state), jax.tree.leaves(jstate)):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == str(b.dtype)
    if podded:  # every pod applied the same aggregate
        for t in leaves(state):
            assert torch.equal(t[0], t[1])


def test_six_steps_at_the_full_vocabulary_match_jax():
    """At seamless-m4t-medium's own vocabulary (256,206 tokens, the head
    padded to 256,256 columns at -1e9) and learning rate, reduced width:
    six plain steps of the learnable stream against JAX's jitted step, and
    the loss of the first step's batch once that step is applied (what
    ``chip_smoke.py``'s training gate reads) equal to JAX's and below the
    step's own loss."""
    jcfg, tcfg = _cfgs(vocab_size=256206)
    assert tcfg.padded_vocab == jcfg.padded_vocab == 256256
    jp, tp = _params(jcfg)
    sc = jdata.StreamConfig(jcfg.vocab_size, 32, 4)
    tsc = ttrain.StreamConfig(tcfg.vocab_size, 32, 4)
    want = []
    with jax.set_mesh(_mesh()):
        jstate = jsteps.init_train_state(jcfg, _j(jp))
        fn = jax.jit(jsteps.build_train_step(jcfg, JRunPlan()))
        for s in range(6):
            jstate, m = fn(jstate, _jax_batch(jcfg, sc, s))
            want.append(float(m["loss"]))
            if s == 0:
                want_seen = float(jencdec.forward_train(jstate["params"], jcfg,
                                                        _jax_batch(jcfg, sc, 0))[0])
    step = tsteps.build_train_step(tcfg, RunPlan())
    state, got = tsteps.init_train_state(tcfg, tp), []
    for s in range(6):
        state, m = step(state, ttrain.make_batch(tcfg, tsc, s, None, "cpu"))
        got.append(float(m["loss"]))
        if s == 0:
            with torch.no_grad():
                seen = float(tencdec.forward_train(state["params"], tcfg,
                                                   ttrain.make_batch(tcfg, tsc, 0, None, "cpu"))[0])
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(seen, want_seen, rtol=TRAJ_RTOL)
    assert seen < got[0], (seen, got[0])


def test_podded_step_launches_the_hop_once_a_leaf(monkeypatch):
    from repro_torch.kernels import ops

    _, tcfg = _cfgs()
    tp = tencdec.init_params(torch.Generator().manual_seed(0), tcfg)
    calls = {"q": 0, "d": 0}
    oq, od = ops.qsgd_quantize, ops.qsgd_dequantize
    monkeypatch.setattr(ops, "qsgd_quantize",
                        lambda *a: calls.__setitem__("q", calls["q"] + 1) or oq(*a))
    monkeypatch.setattr(ops, "qsgd_dequantize",
                        lambda *a: calls.__setitem__("d", calls["d"] + 1) or od(*a))
    plan = RunPlan(aggregation="totoro_tree_q8")
    state = tsteps.init_train_state(tcfg, tp, num_pods=2, podded=True)
    step = tsteps.build_train_step(tcfg, plan, num_pods=2)
    sc = ttrain.StreamConfig(tcfg.vocab_size, 32, 4)
    for s in range(2):
        state, _ = step(state, ttrain.make_batch(tcfg, sc, s, None, "cpu"))
    assert calls == {"q": 2 * 27, "d": 2 * 27}


def test_train_make_batch_keeps_the_target_tokens():
    _, tcfg = _cfgs()
    sc = ttrain.StreamConfig(tcfg.vocab_size, 32, 4)
    b = ttrain.make_batch(tcfg, sc, 3, None, "cpu")
    assert sorted(b) == ["embeds", "labels", "tokens"]
    want = jdata.learnable_lm_batch(jdata.StreamConfig(tcfg.vocab_size, 32, 4), 0, 3)
    np.testing.assert_array_equal(b["tokens"].numpy(), want["tokens"])
    np.testing.assert_array_equal(b["labels"].numpy(), want["labels"])
    assert b["embeds"].shape == (4, 32, tcfg.d_model)
    # --layers sets the decoder's depth only, as the reference's
    cfg = ttrain.make_config(ARCH, reduced=True, layers=3)
    assert (cfg.num_layers, cfg.enc_layers) == (3, 2)


def test_train_main_checkpoint_is_the_references_and_resumes(tmp_path, capsys):
    """``launch/train.main`` with ``--ckpt-dir``: the reference's ``save``
    of the restored state writes the same files byte for byte; resumed
    from step 3, steps 3 and 4 log the uninterrupted run's losses."""
    d = str(tmp_path / "ckpt")
    common = ["--arch", ARCH, "--reduced", "--device", "cpu", "--seq-len", "32",
              "--global-batch", "4", "--log-every", "1"]
    ttrain.main(common + ["--steps", "3", "--ckpt-dir", d])
    capsys.readouterr()
    assert tckpt.latest_step(d) == 3
    tcfg = ttrain.make_config(ARCH, reduced=True, lr=1e-3)
    like = tsteps.init_train_state(tcfg, tencdec.init_params(torch.Generator(), tcfg))
    state, _ = tckpt.restore(like, d, device="cpu")
    jd = str(tmp_path / "jax")
    jckpt.save(params_to_numpy(state), jd, step=3, replicas=2)
    for r in range(2):
        name = os.path.join(f"replica_{r}", "step_00000003")
        for f in ("arrays.npz", "manifest.json"):
            with open(os.path.join(jd, name, f), "rb") as a, open(os.path.join(d, name, f),
                                                                  "rb") as b:
                assert a.read() == b.read()
    ttrain.main(common + ["--steps", "5", "--ckpt-dir", d, "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "final checkpoint at step 5" in out
    kw = dict(seq_len=32, global_batch=4, device="cpu", log=lambda *a: None)
    whole = ttrain.train(tcfg, RunPlan(), steps=5, **kw)
    again = ttrain.train(tcfg, RunPlan(), steps=5, ckpt_dir=str(tmp_path / "again"), **kw)
    resumed = ttrain.train(tcfg, RunPlan(), steps=7, ckpt_dir=str(tmp_path / "again"),
                           resume=True, **kw)
    assert again["losses"] == whole["losses"]
    assert resumed["start_step"] == 5 and len(resumed["losses"]) == 2
    longer = ttrain.train(tcfg, RunPlan(), steps=7, **kw)
    np.testing.assert_allclose(resumed["losses"], longer["losses"][5:], rtol=1e-6)
