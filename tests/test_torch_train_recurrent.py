"""The port's recurrent families (rwkv6-7b: RWKV-6; jamba: Mamba +
attention + MoE) through the LM training path against the JAX package on
the CPU, at their reduced configs: ``train_loss`` gradients, remat nested
over the chunk checkpoints, and 5-step trajectories, plain and podded.

Inputs are numpy from a seed; parameters come from the JAX package's
seeded init and cross with ``repro_torch.convert``.  Tolerances (f32):

- gradients: each leaf within GRAD_REL = 1e-5 of its largest magnitude,
  the loss rtol 1e-6;
- remat on against off: bit for bit, but the embedding table's gradient
  (its CPU backward adds a repeated token's rows in an order of its own:
  within 1e-6 of its largest magnitude);
- each training step from JAX's own state: loss and aux within STEP_RTOL
  = 1e-5; the port's own five steps: within FREE_RTOL[arch], the
  reference's own spread (``test_free_rtol_is_the_references_own_spread``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import data as jdata
from repro.config import RunPlan as JRunPlan
from repro.fl import steps as jsteps
from repro.models import lm as jlm
from torch_threads import one_torch_thread  # noqa: F401
from repro_torch import configs as tconfigs
from repro_torch.config import RunPlan
from repro_torch.convert import params_from_numpy
from repro_torch.fl import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.pytree import leaves

GRAD_REL = 1e-5
STEP_RTOL = 1e-5
STEP_REL = 1e-4
STEP_OFF_SHARE = 1e-4
# The port's own five steps against the reference's, (arch, aggregation):
# the reference's own spread from a one-ulp move of its initial parameters
# (test_free_rtol_is_the_references_own_spread) read 2.22e-5 and 1.13e-4
# for rwkv6-7b, 1.62e-4 and 1.28e-3 for jamba, plain and podded
FREE_RTOL = {("rwkv6-7b", "totoro_tree"): 3e-5, ("rwkv6-7b", "totoro_tree_q8"): 1.5e-4,
             ("jamba-1.5-large-398b", "totoro_tree"): 2e-4,
             ("jamba-1.5-large-398b", "totoro_tree_q8"): 1e-3}
SPREAD_OVER = 1.5
RECURRENT = ["rwkv6-7b", "jamba-1.5-large-398b"]  # RWKV-6; Mamba + attention + MoE


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


def _mesh():
    return jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)


@functools.lru_cache(maxsize=None)
def _jax_step(arch, aggregation, num_pods):
    """The reference's jitted train step, one per case: traced and compiled
    once for both tests that run it."""
    jcfg, _ = _cfgs(arch, learning_rate=2e-3)
    return jax.jit(jsteps.build_train_step(jcfg, JRunPlan(aggregation=aggregation),
                                           num_pods=num_pods))


def _jax_trajectory(arch, aggregation, num_pods, jp):
    """Five jitted reference steps from parameters ``jp`` (numpy): each
    step's (loss, aux), and the six train states (numpy) around them."""
    jcfg, _ = _cfgs(arch, learning_rate=2e-3)
    sc = jdata.StreamConfig(jcfg.vocab_size, 64, 8)
    fn = _jax_step(arch, aggregation, num_pods)
    out, states = [], []
    with jax.set_mesh(_mesh()):
        jstate = jsteps.init_train_state(jcfg, jax.tree.map(jnp.asarray, jp), num_pods=num_pods,
                                         podded=num_pods > 1)
        for s in range(5):
            states.append(jax.tree.map(np.asarray, jstate))
            jstate, m = fn(jstate, {k: jnp.asarray(v) for k, v in
                                    jdata.learnable_lm_batch(sc, 0, s).items()})
            out.append((float(m["loss"]), float(m["aux"])))
    states.append(jax.tree.map(np.asarray, jstate))
    return out, states


# ---------------------------------------------------------------------------
# gradients


@pytest.mark.parametrize("arch", RECURRENT)
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


@pytest.mark.parametrize("policy", ["nothing", "save_mixer_ffn"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_remat_changes_no_recurrent_gradient(arch, policy):
    """The chunk loops' own remat (each chunk body checkpointed) nested in
    the block's or the sublayers' checkpoint: every gradient bit-equal to
    the run without the outer remat (the chunk remat runs in both)."""
    jcfg, tcfg = _cfgs(arch)
    _, tp = _params(jcfg)
    batch = _t(_batch(jcfg, 2, 64, seed=3))
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


# ---------------------------------------------------------------------------
# train steps


@pytest.mark.parametrize("aggregation,num_pods", [("totoro_tree", 1), ("totoro_tree_q8", 2)])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_five_step_loss_trajectory_matches_jax(arch, aggregation, num_pods):
    """rwkv6-7b (AdamW) and jamba (its own adafactor, the MoE aux loss)
    through the plain and the podded step against JAX's
    ``build_train_step``; the podded hop takes every leaf, the f32 decay
    and bonus leaves and the Mamba state matrices included.

    - Each step from JAX's own state before it (the whole train state
      carried over by ``convert``): loss and aux within STEP_RTOL.
    - The first step's new state against JAX's: every element within
      STEP_REL of its leaf's largest magnitude but at most STEP_OFF_SHARE
      of them.  Those few are sign-like updates: a first update of a leaf
      that adafactor or AdamW does not factor is about ``lr * sign(g)``,
      so where a gradient element is ~0 (|g| 2e-11 .. 5e-7 where measured;
      jamba: 2 of 1.3e6 elements) a 1e-10 difference moves the weight by
      2 lr.  Later states are not held so: once training has moved the
      RWKV bonus off its zero init, a head's wkv output at the first tokens
      is nearly constant, the group norm divides it by about sqrt(eps),
      and an input difference of 3e-6 leaves a layer at 1e-4 (both sides
      agree with themselves across chunk sizes to 1e-6).
    - The port's own 5 steps, which carry those moves along: losses and
      aux losses within FREE_RTOL[(arch, aggregation)], the reference's
      own spread (measured: 1.42e-5 and 1.4e-6 for rwkv6-7b, 1.62e-4 and
      4.76e-4 for jamba, plain and podded)."""
    jcfg, tcfg = _cfgs(arch, learning_rate=2e-3)
    assert tcfg.optimizer == ("adafactor" if arch.startswith("jamba") else "adamw")
    jp, tp = _params(jcfg)
    plan_t = RunPlan(aggregation=aggregation)
    podded = num_pods > 1
    want, jstates = _jax_trajectory(arch, aggregation, num_pods, jp)
    jstate = jstates[-1]
    step = tsteps.build_train_step(tcfg, plan_t, num_pods=num_pods)
    tsc = ttrain.StreamConfig(tcfg.vocab_size, 64, 8)
    forced = []
    for s in range(5):
        new, m = step(params_from_numpy(jstates[s], "cpu"), ttrain.make_batch(tcfg, tsc, s, None,
                                                                              "cpu"))
        forced.append((float(m["loss"]), float(m["aux"])))
        if s == 0:
            off = total = 0
            for a, b in zip(leaves(new), jax.tree.leaves(jstates[1])):
                a, b = a.float().numpy(), np.asarray(b, np.float32)
                off += int((np.abs(a - b) > STEP_REL * np.abs(b).max()).sum())
                total += b.size
            assert off <= STEP_OFF_SHARE * total, (off, total)
    np.testing.assert_allclose(forced, want, rtol=STEP_RTOL)
    state = tsteps.init_train_state(tcfg, tp, num_pods=num_pods, podded=podded)
    got = []
    for s in range(5):
        state, m = step(state, ttrain.make_batch(tcfg, tsc, s, None, "cpu"))
        got.append((float(m["loss"]), float(m["aux"])))
    np.testing.assert_allclose(got, want, rtol=FREE_RTOL[arch, aggregation])
    assert got[-1][0] < got[0][0] - 0.5
    assert all(a > 0 for _, a in got) == bool(tcfg.moe_num_experts)
    for a, b in zip(leaves(state), jax.tree.leaves(jstate)):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == str(b.dtype)


@pytest.mark.parametrize("aggregation,num_pods", [("totoro_tree", 1), ("totoro_tree_q8", 2)])
@pytest.mark.parametrize("arch", RECURRENT)
def test_free_rtol_is_the_references_own_spread(arch, aggregation, num_pods):
    """The same five jitted JAX steps from the initial parameters moved by
    one ulp, up and then down: the losses and aux losses move from the
    unmoved run's by the reference's own spread.  Each FREE_RTOL is that
    spread rounded up, at most SPREAD_OVER times it, and no looser than
    the 1e-3 it replaced (jamba's podded spread, 1.28e-3, is past it)."""
    jcfg, _ = _cfgs(arch, learning_rate=2e-3)
    jp, _ = _params(jcfg)
    base = np.array(_jax_trajectory(arch, aggregation, num_pods, jp)[0])
    spread = 0.0
    for toward in (np.inf, -np.inf):
        moved = jax.tree.map(lambda a: np.nextafter(a, a.dtype.type(toward)), jp)
        got = np.array(_jax_trajectory(arch, aggregation, num_pods, moved)[0])
        spread = max(spread, float(np.max(np.abs(got - base) / np.maximum(np.abs(base), 1e-30))))
    bound = FREE_RTOL[arch, aggregation]
    assert bound <= min(1e-3, SPREAD_OVER * spread), (bound, spread)
