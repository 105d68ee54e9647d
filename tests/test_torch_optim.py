"""The port's optimizers against ``repro.optim`` on the CPU.

Both packages update the same parameters with the same gradients (numpy
from a seed, standing in for JAX's gradients) for 3 steps; every leaf of
the parameters and of the state agrees to rtol 1e-6 (atol 1e-7 where a
leaf crosses zero) after each step.  The reference runs under ``jax.jit``,
as its train step does, so XLA may fuse or contract expressions the port
rounds step by step, and its f32 ``pow`` for AdamW's ``b1 ** step`` may
differ from PyTorch's by an ulp: both stay far inside 1e-6.  The step
counter is an int32 0-d tensor and equal.  The reference's own tests
(``tests/test_optim_sharding.py``) are mirrored on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro_torch import configs as tconfigs
from repro_torch import optim as toptim
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.pytree import leaves, tree_map

TOL = dict(rtol=1e-6, atol=1e-7)

SHAPES = {"w": (128, 256), "b": (5,), "blocks": {"k": (3, 130, 140), "n": (3, 64)}}


def _tree(shapes, rng, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(v, rng, scale) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _compare(got, want):
    g, w = leaves(params_to_numpy(got)), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32), **TOL)


def _run_both(jopt, topt, steps=3, seed=0, param_dtype=np.float32):
    rng = np.random.default_rng(seed)
    p = _tree(SHAPES, rng)
    jp = jax.tree.map(lambda a: jnp.asarray(a, param_dtype), p)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jst, tst = jopt.init(jp), topt.init(tp)
    _compare(tst, jst)
    jupd = jax.jit(jopt.update)
    for _ in range(steps):
        g = _tree(SHAPES, rng, 0.1)
        jp, jst = jupd(jax.tree.map(jnp.asarray, g), jst, jp)
        tp, tst = topt.update(params_from_numpy(g, "cpu"), tst, tp)
        _compare(tp, jp)
        _compare(tst, jst)
    return tp, tst


@pytest.mark.parametrize("momentum,wd", [(0.0, 0.0), (0.9, 0.0), (0.9, 0.01), (0.0, 0.1)])
def test_sgd_matches_jax(momentum, wd):
    _run_both(joptim.sgd(0.1, momentum, wd), toptim.sgd(0.1, momentum, wd))


@pytest.mark.parametrize("keep_master,wd", [(True, 0.0), (True, 0.01), (False, 0.1)])
def test_adamw_matches_jax(keep_master, wd):
    _, st = _run_both(joptim.adamw(3e-3, weight_decay=wd, keep_master=keep_master),
                      toptim.adamw(3e-3, weight_decay=wd, keep_master=keep_master))
    assert ("master" in st) == keep_master
    assert st["step"].dtype == torch.int32 and st["step"].shape == () and int(st["step"]) == 3


def test_adamw_bf16_params_keep_an_f32_master():
    """bf16 parameters are re-derived from the f32 master each step."""
    tp, st = _run_both(joptim.adamw(3e-3), toptim.adamw(3e-3), param_dtype=jnp.bfloat16)
    assert tp["w"].dtype == torch.bfloat16 and st["master"]["w"].dtype == torch.float32
    assert torch.equal(tp["w"], st["master"]["w"].to(torch.bfloat16))


@pytest.mark.parametrize("min_dim,wd", [(128, 0.0), (2, 0.01), (4096, 0.0)])
def test_adafactor_matches_jax(min_dim, wd):
    """min_dim 128: (128, 256) and (3, 130, 140) factored over their two
    largest dims, the rest not; 2: every leaf of two or more dims; 4096:
    none."""
    _run_both(joptim.adafactor(lr=0.05, min_dim_size_to_factor=min_dim, weight_decay=wd),
              toptim.adafactor(lr=0.05, min_dim_size_to_factor=min_dim, weight_decay=wd))


@pytest.mark.parametrize("shape", [(5,), (128, 256), (3, 130, 140), (130, 3, 140), (64, 64)])
def test_factored_dims_match_jax(shape):
    for m in (2, 64, 128, 200):
        assert toptim._factored_dims(shape, m) == joptim._factored_dims(shape, m)


@pytest.mark.parametrize("arch,kind", [("tinyllama-1.1b", "adamw"), ("mistral-large-123b", "adafactor")])
def test_make_optimizer_follows_the_config(arch, kind):
    tcfg, jcfg = tconfigs.get_reduced(arch), jconfigs.get_reduced(arch)
    assert tcfg.optimizer == kind
    rng = np.random.default_rng(1)
    p = {"w": rng.standard_normal((128, 256)).astype(np.float32)}
    jst = joptim.make_optimizer(jcfg).init(jax.tree.map(jnp.asarray, p))
    tst = toptim.make_optimizer(tcfg).init(params_from_numpy(p, "cpu"))
    _compare(tst, jst)
    sgd_cfg = tcfg.replace(optimizer="sgd")
    assert set(toptim.make_optimizer(sgd_cfg).init(params_from_numpy(p, "cpu"))) == {"step", "mu"}
    with pytest.raises(ValueError):
        toptim.make_optimizer(tcfg.replace(optimizer="lion"))


# ---------------------------------------------------------------------------
# tests/test_optim_sharding.py on the port


def _quad_params():
    return {"w": torch.tensor([1.0, -2.0, 3.0]), "b": torch.tensor([[0.5, -0.5]] * 2)}


def _grads(params):
    return tree_map(lambda p: 2 * p, params)  # grad of sum(p^2)


def test_adamw_reduces_quadratic():
    opt = toptim.adamw(lr=0.05)
    params = _quad_params()
    state = opt.init(params)
    for _ in range(100):
        params, state = opt.update(_grads(params), state, params)
    assert float(sum(torch.sum(torch.square(x)) for x in leaves(params))) < 0.2


def test_adamw_first_step_is_lr_sized():
    opt = toptim.adamw(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([1.0])}
    state = opt.init(params)
    newp, _ = opt.update({"w": torch.tensor([0.5])}, state, params)
    # bias-corrected first step = lr * g/|g| = lr
    np.testing.assert_allclose(float(newp["w"][0]), 1.0 - 0.1, atol=1e-4)


def test_adafactor_factored_states_and_descent():
    opt = toptim.adafactor(lr=0.05, min_dim_size_to_factor=2)
    params = {"w": torch.ones((128, 256)), "v": torch.ones((5,))}
    state = opt.init(params)
    assert set(state["v"]["w"].keys()) == {"vr", "vc"}
    assert state["v"]["w"]["vr"].shape == (128,)
    assert state["v"]["w"]["vc"].shape == (256,)
    assert set(state["v"]["v"].keys()) == {"v"}
    loss0 = float(torch.sum(torch.square(params["w"])))
    for _ in range(20):
        params, state = opt.update(_grads(params), state, params)
    assert float(torch.sum(torch.square(params["w"]))) < loss0


def test_sgd_momentum():
    opt = toptim.sgd(lr=0.1, momentum=0.9)
    params = _quad_params()
    state = opt.init(params)
    for _ in range(50):
        params, state = opt.update(_grads(params), state, params)
    assert float(sum(torch.sum(torch.square(x)) for x in leaves(params))) < 0.5


def test_update_leaves_its_inputs_alone():
    opt = toptim.adamw(lr=0.1)
    params = _quad_params()
    state = opt.init(params)
    before = tree_map(torch.clone, {"p": params, "s": state})
    opt.update(_grads(params), state, params)
    for a, b in zip(leaves({"p": params, "s": state}), leaves(before)):
        assert torch.equal(a, b)
    assert state["master"]["w"].data_ptr() != params["w"].data_ptr()  # a copy, though f32
