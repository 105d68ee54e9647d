"""The port's LM training path against the JAX package on the CPU.

Inputs are numpy from a seed; parameters come from the JAX package's
seeded init and cross with ``repro_torch.convert``.  Tolerances (f32):

- the flash backward (``_Flash`` against ``jax.vjp`` of the reference's
  ``chunked_attention``): rtol = atol = 1e-5, the JAX package's kernel
  tolerance;
- ``train_loss`` gradients on the reduced configs: each leaf within
  GRAD_REL = 1e-5 of its largest magnitude (measured 2.6e-7 .. 1.1e-6,
  1.5e-6 on the MoE configs: the same f32 math summed in other orders);
  the loss rtol 1e-6 (measured equal); the MoE router's gradient, with the
  aux loss weighted 1, within rtol 1e-4 / atol 1e-5 of ``jax.grad``'s;
- remat on against off, in the port: bit for bit (remat recomputes the
  same operations on the same inputs), but for the embedding table's
  gradient, whose CPU backward adds a repeated token's rows in an order
  of its own from run to run: within 1e-6 of its largest magnitude;
- ``q8_mean_over_pods``: the int8 lattice and the scales bit-equal to
  JAX's jitted hop, the mean within 1 f32 ulp of the largest value
  (stated at the test: XLA contracts the sum of the dequantized pods);
- 5-step loss trajectories, plain and podded (2 pods): each loss within
  TRAJ_RTOL = 1e-5 of JAX's.  AdamW's first steps are sign-like, so a
  gradient that differs from JAX's by 1e-7 near zero moves a weight by
  2 lr: whole-step parameters are not held fp-tight (the optimizers and
  gradients are, alone).
"""
import dataclasses

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
from repro.kernels import ref as jref
from repro.models import attention as ja
from repro.models import lm as jlm
from torch_threads import one_torch_thread  # noqa: F401
from repro_torch import ckpt as tckpt
from repro_torch import configs as tconfigs
from repro_torch.config import RunPlan
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.fl import steps as tsteps
from repro_torch.kernels import ref as tref
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as ta
from repro_torch.models import lm as tlm
from repro_torch.pytree import leaves, tree_map

ATTN = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-5
TRAJ_RTOL = 1e-5
MOE = ["deepseek-v2-lite-16b", "moonshot-v1-16b-a3b"]


def _cfgs(arch, **kw):
    return jconfigs.get_reduced(arch).replace(**kw), tconfigs.get_reduced(arch).replace(**kw)


def _params(jcfg, seed=0):
    jp = jax.tree.map(np.asarray, jlm.init_params(jax.random.key(seed), jcfg))
    return jp, params_from_numpy(jp, "cpu")


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _close_to_max(got, want, rel):
    """Every leaf within ``rel`` of that leaf's largest magnitude."""
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        a, b = a.detach().float().numpy(), np.asarray(b, np.float32)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= rel * np.abs(b).max(), (np.abs(a - b).max(), np.abs(b).max())


# ---------------------------------------------------------------------------
# the flash backward


@pytest.mark.parametrize("B,Sq,Skv,H,KV,chunk,causal,window,q_offset", [
    (2, 64, 64, 4, 4, 16, True, None, 0),     # nq = nk = 4, the train path's G = 1
    (1, 32, 64, 8, 2, 16, True, None, 32),    # q_offset > 0, G = 4 inside the core
    (2, 64, 64, 4, 4, 16, True, 24, 0),       # windowed: early chunks fully masked
    (2, 48, 48, 6, 2, 16, False, None, 0),    # not causal
])
def test_flash_backward_matches_jax_vjp(B, Sq, Skv, H, KV, chunk, causal, window, q_offset):
    rng = np.random.default_rng(Sq * H + Skv + KV)
    Dk = 16
    q = rng.standard_normal((B, Sq, H, Dk)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, Dk)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, Dk)).astype(np.float32)
    dout = rng.standard_normal((B, Sq, H, Dk)).astype(np.float32)
    kw = dict(causal=causal, q_offset=q_offset, chunk_q=chunk, chunk_kv=chunk, window=window)
    out, vjp = jax.vjp(lambda a, b, c: ja.chunked_attention(a, b, c, **kw), q, k, v)
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got_out = ta.chunked_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), **ATTN)
    got = torch.autograd.grad(got_out, (tq, tk, tv), torch.from_numpy(dout))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ATTN)


def test_flash_forward_keeps_its_bits_and_saves_lse():
    """``chunked_attention``'s value through ``_Flash`` is the plain
    forward's, bit for bit, under autograd and without it."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 64, 4, 16, generator=gen) for _ in range(3))
    qc, kc, vc = (x.reshape(2, 4, 16, 4, 1, 16).transpose(0, 1) for x in (q, k, v))
    out, lse = ta._flash_fwd(qc, kc[..., 0, :], vc[..., 0, :], True, 0, None, 0.25)
    want = out.transpose(0, 1).reshape(2, 64, 4, 16)
    with torch.no_grad():
        assert torch.equal(ta.chunked_attention(q, k, v, chunk_q=16, chunk_kv=16), want)
    got = ta.chunked_attention(q.requires_grad_(True), k, v, chunk_q=16, chunk_kv=16)
    assert got.requires_grad and torch.equal(got.detach(), want)
    assert lse.shape == (4, 2, 16, 4, 1) and bool(torch.isfinite(lse).all())


def test_flash_backward_bf16_keeps_dtypes_and_tracks_f32():
    """bf16 inputs: gradients come back in bf16, within 2^-6 of the f32
    backward's largest magnitude (bf16 rounding of out, p and the casts)."""
    gen = torch.Generator().manual_seed(4)
    q, k, v, do = (torch.randn(2, 64, 4, 16, generator=gen) for _ in range(4))
    kw = dict(chunk_q=32, chunk_kv=32)
    xs32 = [x.clone().requires_grad_(True) for x in (q, k, v)]
    g32 = torch.autograd.grad(ta.chunked_attention(*xs32, **kw), xs32, do)
    xs16 = [x.bfloat16().requires_grad_(True) for x in (q, k, v)]
    g16 = torch.autograd.grad(ta.chunked_attention(*xs16, **kw), xs16, do.bfloat16())
    for a, b in zip(g16, g32):
        assert a.dtype == torch.bfloat16
        assert float((a.float() - b).abs().max()) <= 2.0**-6 * float(b.abs().max())


# ---------------------------------------------------------------------------
# gradients


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-8b"] + MOE)
def test_train_loss_gradients_match_jax(arch):
    """S = 128 at the reduced attn_chunk 64: two query and two key chunks."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    batch = _batch(jcfg, 2, 128, seed=1)
    (jl, (jce, _)), jg = jax.value_and_grad(
        lambda p: jlm.train_loss(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    g, m = tsteps.grads_and_metrics(tcfg, RunPlan(), tp, _t(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jce), rtol=1e-6)
    assert all(x.dtype == torch.float32 for x in leaves(g))
    _close_to_max(g, jg, GRAD_REL)


@pytest.mark.parametrize("arch", MOE)
def test_router_gradient_matches_jax_grad(arch):
    """The routers' gradients, through the gates' top-k weights and the aux
    loss (weighted 1 here, so that its share shows), against ``jax.grad``;
    the aux loss reaches the metrics as the reference's does."""
    jcfg, tcfg = _cfgs(arch, moe_aux_weight=1.0)
    jp, tp = _params(jcfg)
    batch = _batch(jcfg, 2, 64, seed=7)
    jg, jm = jsteps.grads_and_metrics(jcfg, JRunPlan(), jp,
                                      {k: jnp.asarray(v) for k, v in batch.items()})
    g, m = tsteps.grads_and_metrics(tcfg, RunPlan(), tp, _t(batch))
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=1e-5)
    want = np.asarray(jg["blocks"]["pos0"]["ffn"]["router"])
    got = g["blocks"]["pos0"]["ffn"]["router"]
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, jcfg.d_model, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # the aux loss alone moves the router: without it the gradient differs
    g0, _ = tsteps.grads_and_metrics(tcfg.replace(moe_aux_weight=0.0), RunPlan(), tp, _t(batch))
    assert float((g0["blocks"]["pos0"]["ffn"]["router"] - got).abs().max()) > 1e-3 * np.abs(
        want).max()


@pytest.mark.parametrize("policy", ["nothing", "save_mixer_ffn"])
def test_remat_changes_no_moe_gradient(policy):
    """Remat recomputes the routing in the backward: it must route the same
    tokens, so every gradient (the routers' included) is bit-equal."""
    jcfg, tcfg = _cfgs("deepseek-v2-lite-16b")
    _, tp = _params(jcfg)
    batch = _t(_batch(jcfg, 2, 128, seed=2))
    off, m_off = tsteps.grads_and_metrics(tcfg, RunPlan(), tp, batch)
    on, m_on = tsteps.grads_and_metrics(tcfg.replace(remat=True, remat_policy=policy), RunPlan(),
                                        tp, batch)
    assert torch.equal(m_on["loss"], m_off["loss"]) and torch.equal(m_on["aux"], m_off["aux"])
    for name in on:
        if name == "embed":  # the CPU's embedding backward adds repeated rows in any order
            torch.testing.assert_close(on[name], off[name], rtol=0, atol=1e-6 * float(
                off[name].abs().max()))
            continue
        for a, b in zip(leaves(on[name]), leaves(off[name])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("policy", ["nothing", "save_mixer_ffn"])
def test_remat_changes_no_gradient(policy):
    jcfg, tcfg = _cfgs("tinyllama-1.1b")
    _, tp = _params(jcfg)
    batch = _t(_batch(jcfg, 2, 128, seed=2))
    off, m_off = tsteps.grads_and_metrics(tcfg, RunPlan(), tp, batch)
    on_cfg = tcfg.replace(remat=True, remat_policy=policy)
    on, m_on = tsteps.grads_and_metrics(on_cfg, RunPlan(), tp, batch)
    assert torch.equal(m_on["loss"], m_off["loss"])
    for name in on:
        if name == "embed":  # the CPU's embedding backward adds repeated rows in any order
            torch.testing.assert_close(on[name], off[name], rtol=0, atol=1e-6 * float(
                off[name].abs().max()))
            continue
        for a, b in zip(leaves(on[name]), leaves(off[name])):
            assert torch.equal(a, b)


def test_remat_recomputes_the_blocks_in_the_backward(monkeypatch):
    """Under remat each block's forward runs twice (forward, then again in
    the backward); without it once."""
    jcfg, tcfg = _cfgs("tinyllama-1.1b")
    _, tp = _params(jcfg)
    batch = _t(_batch(jcfg, 2, 64, seed=2))
    calls = []
    orig = tlm._ffn_sublayer
    monkeypatch.setattr(tlm, "_ffn_sublayer", lambda *a: calls.append(1) or orig(*a))
    for remat, policy, want in ((False, "nothing", 2), (True, "nothing", 4),
                                (True, "save_mixer_ffn", 4)):
        calls.clear()
        tsteps.grads_and_metrics(tcfg.replace(remat=remat, remat_policy=policy), RunPlan(), tp,
                                 batch)
        assert len(calls) == want, (remat, policy, len(calls))


def test_remat_recomputes_block_0_on_data_embeddings(monkeypatch):
    """An ``embed_inputs`` config's first block reads data embeddings, which
    need no gradient; under remat the backward recomputes it all the same
    (each layer's FFN runs twice), and the gradients are remat off's."""
    jcfg, tcfg = _cfgs("llava-next-34b")
    _, tp = _params(jcfg)
    rng = np.random.default_rng(4)
    batch = {"embeds": torch.from_numpy(
                 (rng.standard_normal((2, 32, tcfg.d_model)) * 0.3).astype(np.float32)),
             "labels": torch.from_numpy(
                 rng.integers(0, tcfg.vocab_size, (2, 32)).astype(np.int32))}
    calls = []
    orig = tlm._ffn_sublayer
    monkeypatch.setattr(tlm, "_ffn_sublayer", lambda *a: calls.append(1) or orig(*a))
    grads = {}
    for remat, want in ((False, tcfg.num_layers), (True, 2 * tcfg.num_layers)):
        calls.clear()
        grads[remat], _ = tsteps.grads_and_metrics(tcfg.replace(remat=remat), RunPlan(), tp,
                                                   batch)
        assert len(calls) == want, (remat, len(calls))
    for a, b in zip(leaves(grads[True]), leaves(grads[False])):
        assert torch.equal(a, b)


def test_stacked_leaves_are_split_once(monkeypatch):
    """The forward takes each stacked leaf apart once (``unbind``), not
    once per block."""
    jcfg, tcfg = _cfgs("tinyllama-1.1b")
    _, tp = _params(jcfg)
    batch = _t(_batch(jcfg, 2, 64, seed=2))
    n_stacked = len(leaves(tp["blocks"]))
    calls = []
    orig = torch.Tensor.unbind
    monkeypatch.setattr(torch.Tensor, "unbind", lambda t, *a: calls.append(1) or orig(t, *a))
    tsteps.grads_and_metrics(tcfg, RunPlan(), tp, batch)
    assert len(calls) == n_stacked


def test_grad_accumulation_matches_jax():
    jcfg, tcfg = _cfgs("tinyllama-1.1b")
    jp, tp = _params(jcfg)
    batch = _batch(jcfg, 4, 64, seed=3)
    jg, jm = jsteps.grads_and_metrics(jcfg, JRunPlan(grad_accum=2), jp,
                                      {k: jnp.asarray(v) for k, v in batch.items()})
    g, m = tsteps.grads_and_metrics(tcfg, RunPlan(grad_accum=2), tp, _t(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-6)
    _close_to_max(g, jg, GRAD_REL)


def test_pod_grads_give_each_pod_its_rows_and_parameters():
    """Pod p's gradients are JAX's ``grads_and_metrics`` on rows
    [p B/P, (p + 1) B/P) with pod p's parameters (the reference's podify);
    the pods' parameters differ here, so a swapped pod would show."""
    jcfg, tcfg = _cfgs("tinyllama-1.1b")
    jp0, _ = _params(jcfg, seed=0)
    jp1, _ = _params(jcfg, seed=1)
    batch = _batch(jcfg, 4, 64, seed=5)
    pod_params = tree_map(lambda a, b: torch.stack([a, b]),
                          params_from_numpy(jp0, "cpu"), params_from_numpy(jp1, "cpu"))
    g, losses, _ = tsteps.pod_grads(tcfg, RunPlan(aggregation="totoro_tree_q8"), pod_params,
                                    _t(batch), 2)
    for p, jp in enumerate((jp0, jp1)):
        rows = {k: jnp.asarray(v[2 * p: 2 * p + 2]) for k, v in batch.items()}
        jg, jm = jsteps.grads_and_metrics(jcfg, JRunPlan(), jp, rows)
        np.testing.assert_allclose(float(losses[p]), float(jm["loss"]), rtol=1e-6)
        _close_to_max(tree_map(lambda t: t[p], g), jg, GRAD_REL)


def test_microbatches_are_strided():
    x = torch.arange(12).reshape(6, 2)
    mbs = tsteps._split_microbatches({"x": x}, 3)
    assert [mb["x"][:, 0].tolist() for mb in mbs] == [[0, 6], [2, 8], [4, 10]]
    jm = jsteps._split_microbatches({"x": jnp.asarray(x.numpy())}, 3)["x"]
    for j, mb in enumerate(mbs):
        np.testing.assert_array_equal(mb["x"].numpy(), np.asarray(jm[j]))


# ---------------------------------------------------------------------------
# the cross-zone QSGD-int8 hop


def _mesh():
    return jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)


def test_q8_mean_over_pods_matches_jax():
    """The lattice and the scales are JAX's jitted hop's, bit for bit.  The
    mean is not: XLA contracts the sum of the two dequantized pods into one
    FMA, ``fma(q1, s1, q0 * s0)``, where the dequantize kernel rounds each
    product.  The fma form of the port's lattice is JAX's mean exactly, and
    the port's mean lies within 2^-23 of the leaf's largest input."""
    rng = np.random.default_rng(0)
    g = {"w": rng.standard_normal((2, 64, 32)).astype(np.float32),
         "b": (rng.standard_normal((2, 300)) * 1e-3).astype(np.float32),  # padded to 512
         "x": (rng.standard_normal((2, 40, 256)) * rng.random((2, 40, 1)) * 10).astype(np.float32)}
    with jax.set_mesh(_mesh()):
        want = jax.jit(jsteps.q8_mean_over_pods)(g)

    def lattice(x):  # the hop's first half, as the reference computes it inside the step
        from repro.fl.compression import qsgd_quantize
        flat = x.reshape(x.shape[0], -1)
        return qsgd_quantize(jnp.pad(flat, ((0, 0), (0, (-flat.shape[1]) % 256))).reshape(
            x.shape[0], -1, 256))

    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    got = tsteps.q8_mean_over_pods(tg)
    for k, x in g.items():
        jq, js = jax.jit(lattice)(x)
        rows = tsteps.pod_rows(tg[k])
        assert rows.shape[0] == tsteps.pod_rows_count(tg[k])
        q, s = tref.quantize_ref(rows, torch.full_like(rows, 0.5))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq).reshape(-1, 256))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js).reshape(-1, 1))
        R = rows.shape[0] // 2
        fma = tref.fma_f32(q[R:].float(), s[R:], q[:R].float() * s[:R]) / 2
        fma = fma.reshape(-1)[: x[0].size].reshape(x.shape[1:])
        np.testing.assert_array_equal(fma.numpy(), np.asarray(want[k]))
        assert got[k].shape == x.shape[1:]
        assert np.abs(got[k].numpy() - np.asarray(want[k])).max() <= 2.0**-23 * np.abs(x).max()
        # within one quantization step of the plain pod mean (tests/test_fl.py's criterion)
        assert np.abs(got[k].numpy() - x.mean(0)).max() <= np.abs(x).max() / 127 + 1e-5


def test_q8_hop_reuses_one_buffer_of_halves(monkeypatch):
    """One quantize and one dequantize call per leaf, every pod's rows in
    it, each given a contiguous prefix of one buffer of 0.5s."""
    from repro_torch.kernels import ops

    g = {"a": torch.randn(2, 3, 256), "b": torch.randn(2, 1000)}
    halves = tsteps.rounding_halves(g)
    assert halves.shape == (2 * 4, 256) and bool((halves == 0.5).all())
    seen = []
    orig = ops.qsgd_quantize
    monkeypatch.setattr(ops, "qsgd_quantize", lambda x, r: seen.append(
        (x.shape[0], r.data_ptr(), r.is_contiguous())) or orig(x, r))
    tsteps.q8_mean_over_pods(g, halves)
    assert seen == [(6, halves.data_ptr(), True), (8, halves.data_ptr(), True)]


# ---------------------------------------------------------------------------
# train steps


def _jax_trajectory(jcfg, jp, plan, steps, num_pods=1):
    sc = jdata.StreamConfig(jcfg.vocab_size, 64, 8)
    podded = plan.aggregation == "totoro_tree_q8" and num_pods > 1
    losses = []
    with jax.set_mesh(_mesh()):
        state = jsteps.init_train_state(jcfg, jax.tree.map(jnp.asarray, jp), num_pods=num_pods,
                                        podded=podded)
        fn = jax.jit(jsteps.build_train_step(jcfg, plan, num_pods=num_pods))
        for s in range(steps):
            b = jdata.learnable_lm_batch(sc, 0, s)
            state, m = fn(state, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
    return losses, state


def _torch_trajectory(tcfg, tp, plan, steps, num_pods=1):
    sc = ttrain.StreamConfig(tcfg.vocab_size, 64, 8)
    podded = plan.aggregation == "totoro_tree_q8" and num_pods > 1
    state = tsteps.init_train_state(tcfg, tp, num_pods=num_pods, podded=podded)
    fn = tsteps.build_train_step(tcfg, plan, num_pods=num_pods)
    losses = []
    for s in range(steps):
        state, m = fn(state, ttrain.make_batch(tcfg, sc, s, None, "cpu"))
        losses.append(float(m["loss"]))
    return losses, state


@pytest.mark.parametrize("aggregation,num_pods", [("totoro_tree", 1), ("totoro_tree_q8", 2)])
def test_five_step_loss_trajectory_matches_jax(aggregation, num_pods):
    jcfg, tcfg = _cfgs("tinyllama-1.1b", learning_rate=2e-3)
    jp, tp = _params(jcfg)
    want, jstate = _jax_trajectory(jcfg, jp, JRunPlan(aggregation=aggregation), 5, num_pods)
    got, state = _torch_trajectory(tcfg, tp, RunPlan(aggregation=aggregation), 5, num_pods)
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    assert got[-1] < got[0] - 0.5
    # the state keeps the reference's layout: the podded leading axis, the int32 step
    for a, b in zip(leaves(state), jax.tree.leaves(jstate)):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == str(b.dtype)
    if num_pods > 1:  # every pod applied the same aggregate
        for t in leaves(state):
            assert torch.equal(t[0], t[1])


@pytest.mark.parametrize("aggregation,num_pods", [("totoro_tree", 1), ("totoro_tree_q8", 2)])
def test_moe_five_step_loss_trajectory_matches_jax(aggregation, num_pods):
    """deepseek-v2's reduced config (a list of leading layers, MLA, MoE)
    through the plain and the podded step: losses and aux losses against
    JAX's ``build_train_step``; the podded hop takes every leaf, the
    routers and the expert stacks included."""
    jcfg, tcfg = _cfgs("deepseek-v2-lite-16b", learning_rate=2e-3)
    jp, tp = _params(jcfg)
    plan_j, plan_t = JRunPlan(aggregation=aggregation), RunPlan(aggregation=aggregation)
    sc = jdata.StreamConfig(jcfg.vocab_size, 64, 8)
    podded = num_pods > 1
    with jax.set_mesh(_mesh()):
        jstate = jsteps.init_train_state(jcfg, jax.tree.map(jnp.asarray, jp), num_pods=num_pods,
                                         podded=podded)
        fn = jax.jit(jsteps.build_train_step(jcfg, plan_j, num_pods=num_pods))
        want = []
        for s in range(5):
            jstate, m = fn(jstate, {k: jnp.asarray(v) for k, v in
                                    jdata.learnable_lm_batch(sc, 0, s).items()})
            want.append((float(m["loss"]), float(m["aux"])))
    state = tsteps.init_train_state(tcfg, tp, num_pods=num_pods, podded=podded)
    step = tsteps.build_train_step(tcfg, plan_t, num_pods=num_pods)
    got = []
    for s in range(5):
        state, m = step(state, ttrain.make_batch(tcfg, ttrain.StreamConfig(tcfg.vocab_size, 64, 8),
                                                 s, None, "cpu"))
        got.append((float(m["loss"]), float(m["aux"])))
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    assert got[-1][0] < got[0][0] - 0.5 and all(a > 0 for _, a in got)
    assert isinstance(state["params"]["first"], list)
    for a, b in zip(leaves(state), jax.tree.leaves(jstate)):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == str(b.dtype)


def test_podded_step_launch_structure(monkeypatch):
    """A podded step calls the quantize and the dequantize once per leaf."""
    from repro_torch.kernels import ops

    jcfg, tcfg = _cfgs("tinyllama-1.1b")
    _, tp = _params(jcfg)
    calls = {"q": 0, "d": 0}
    oq, od = ops.qsgd_quantize, ops.qsgd_dequantize
    monkeypatch.setattr(ops, "qsgd_quantize", lambda *a: calls.__setitem__("q", calls["q"] + 1) or oq(*a))
    monkeypatch.setattr(ops, "qsgd_dequantize", lambda *a: calls.__setitem__("d", calls["d"] + 1) or od(*a))
    _torch_trajectory(tcfg, tp, RunPlan(aggregation="totoro_tree_q8"), 2, num_pods=2)
    n = len(leaves(tp))
    assert calls == {"q": 2 * n, "d": 2 * n}


def test_lm_train_step_learns_and_checkpoints(tmp_path):
    """tests/test_system.py's case on the port: the loss drops on a
    learnable stream; checkpoint/restore mid-run continues."""
    cfg = tconfigs.get_reduced("tinyllama-1.1b").replace(learning_rate=2e-3)
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg)
    state = tsteps.init_train_state(cfg, params)
    step_fn = tsteps.build_train_step(cfg, RunPlan(grad_accum=2))
    sc = ttrain.StreamConfig(cfg.vocab_size, 64, 8)
    losses = []
    for s in range(14):
        state, m = step_fn(state, ttrain.make_batch(cfg, sc, s, None, "cpu"))
        losses.append(float(m["loss"]))
        if s == 7:
            tckpt.save(state, str(tmp_path), step=8, replicas=2)
    assert losses[-1] < losses[0] - 0.5, losses

    tckpt.corrupt_replica(str(tmp_path), replica=0, step=8)
    restored, st = tckpt.restore(state, str(tmp_path), device="cpu")
    assert st == 8
    restored, m = step_fn(restored, ttrain.make_batch(cfg, sc, st, None, "cpu"))
    assert np.isfinite(float(m["loss"]))


def test_straggler_masking_changes_only_weighting():
    """Zero-weight (label -1) examples are excluded exactly."""
    cfg = tconfigs.get_reduced("tinyllama-1.1b")
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg)
    t = torch.randint(0, cfg.vocab_size, (4, 32), generator=torch.Generator().manual_seed(1))
    full, _ = tlm.train_loss(params, cfg, {"tokens": t, "labels": t})
    labels = t.clone()
    labels[:2] = -1
    masked, _ = tlm.train_loss(params, cfg, {"tokens": t, "labels": labels})
    only_last, _ = tlm.train_loss(params, cfg, {"tokens": t[2:], "labels": t[2:]})
    np.testing.assert_allclose(float(masked), float(only_last), rtol=1e-5)
    assert float(full) != float(masked)


# ---------------------------------------------------------------------------
# the entry point


def _logged(capsys):
    return {int(line.split()[1][:-1]): float(line.split("loss=")[1].split()[0])
            for line in capsys.readouterr().out.splitlines() if line.startswith("step ")}


def test_train_main_checkpoints_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    common = ["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu", "--seq-len", "32",
              "--global-batch", "4", "--log-every", "1", "--ckpt-dir", d, "--ckpt-every", "2"]
    ttrain.main(common + ["--steps", "3"])
    first = _logged(capsys)
    assert tckpt.latest_step(d) == 3 and sorted(first) == [0, 1, 2]
    ttrain.main(common + ["--steps", "5", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "final checkpoint at step 5" in out
    assert tckpt.latest_step(d) == 5
    # a run without checkpoints logs the same first losses
    ttrain.main([a for a in common if a not in ("--ckpt-dir", d)] + ["--steps", "5"])
    whole = _logged(capsys)
    assert sorted(whole) == [0, 1, 2, 3, 4]
    np.testing.assert_allclose([first[s] for s in range(3)], [whole[s] for s in range(3)],
                               rtol=1e-6)


def test_train_resume_matches_uninterrupted_losses(tmp_path):
    cfg = ttrain.make_config("tinyllama-1.1b", reduced=True, lr=1e-3)
    kw = dict(seq_len=32, global_batch=4, device="cpu", log=lambda *a: None)
    whole = ttrain.train(cfg, RunPlan(), steps=5, **kw)
    d = str(tmp_path)
    ttrain.train(cfg, RunPlan(), steps=3, ckpt_dir=d, **kw)
    resumed = ttrain.train(cfg, RunPlan(), steps=5, ckpt_dir=d, resume=True, **kw)
    assert resumed["start_step"] == 3 and len(resumed["losses"]) == 2
    np.testing.assert_allclose(resumed["losses"], whole["losses"][3:], rtol=1e-6)
    assert len(whole["step_ms"]) == 5


def test_train_straggler_rate_masks_rows():
    cfg = ttrain.make_config("tinyllama-1.1b", reduced=True)
    kw = dict(steps=2, seq_len=32, global_batch=8, device="cpu", log=lambda *a: None)
    a = ttrain.train(cfg, RunPlan(), straggler_rate=0.5, **kw)["losses"]
    b = ttrain.train(cfg, RunPlan(), **kw)["losses"]
    assert a != b and all(np.isfinite(a))


def test_make_config_keeps_the_width_override():
    cfg = ttrain.make_config("tinyllama-1.1b", reduced=True, width=256, layers=4, lr=0.01)
    assert (cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.num_layers, cfg.learning_rate) == (
        256, 8, 32, 4, 0.01)
    assert ttrain.make_config("tinyllama-1.1b", reduced=True, width=64).num_heads == 4


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ttrain.main(["--reduced", "--steps", "1"])


# ---------------------------------------------------------------------------
# the train state through convert.py


def test_train_state_crosses_convert_both_ways():
    """A podded JAX train state (int32 step, bf16 params) crosses to the
    port and back bit for bit, layout and dtypes kept."""
    jcfg = jconfigs.get_reduced("tinyllama-1.1b").replace(param_dtype="bfloat16")
    params = jlm.init_params(jax.random.key(0), jcfg)
    with jax.set_mesh(_mesh()):
        jstate = jsteps.init_train_state(jcfg, params, num_pods=2, podded=True)
    jnp_state = jax.tree.map(np.asarray, jstate)
    state = params_from_numpy(jnp_state, "cpu")
    assert state["opt"]["step"].dtype == torch.int32 and state["opt"]["step"].shape == (2,)
    assert state["params"]["embed"].dtype == torch.bfloat16
    back = params_to_numpy(state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jnp_state)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
