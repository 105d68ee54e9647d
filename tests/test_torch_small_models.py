"""The port's small models against ``repro.fl.small_models``.

Parameters come from the JAX package's seeded init and cross over with
``repro_torch.convert``; inputs are numpy from a seed.  Tolerances:
rtol 1e-5, atol 1e-6 for logits and losses; rtol 1e-4, atol 1e-5 after
E = 4 SGD steps, because the matmul and convolution reduction orders
differ between XLA and PyTorch.
"""
import jax
import numpy as np
import pytest
import torch

from repro.fl import small_models as jsm
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.fl import small_models as tsm

FWD = dict(rtol=1e-5, atol=1e-6)
TRAIN = dict(rtol=1e-4, atol=1e-5)


def _setup(model, B, seed):
    rng = np.random.default_rng(seed)
    if model == "mlp":
        jp = jsm.init_mlp(jax.random.key(seed), 12, 24, 5)
        x = rng.standard_normal((B, 12)).astype(np.float32)
        classes = 5
    else:
        jp = jsm.init_cnn(jax.random.key(seed), 6, channels=4)
        x = rng.standard_normal((B, 16, 16, 1)).astype(np.float32)
        classes = 6
    y = rng.integers(0, classes, B).astype(np.int32)
    jp = jax.tree.map(np.asarray, jp)
    return jp, params_from_numpy(jp, "cpu"), x, y


@pytest.mark.parametrize("model", ["mlp", "cnn"])
@pytest.mark.parametrize("B", [1, 9])
def test_logits_and_loss_match_jax(model, B):
    jp, tp, x, y = _setup(model, B, seed=B)
    want = np.asarray(jsm.LOGITS[model](jp, x))
    got = tsm.LOGITS[model](tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    np.testing.assert_allclose(
        float(tsm.ce_loss(got, torch.from_numpy(y))), float(jsm.ce_loss(want, y)), **FWD
    )
    assert float(tsm.accuracy(got, torch.from_numpy(y))) == float(jsm.accuracy(want, y))


@pytest.mark.parametrize("model", ["mlp", "cnn"])
@pytest.mark.parametrize("mu", [0.0, 0.1])
def test_local_train_matches_jax(model, mu):
    jp, tp, x, y = _setup(model, 17, seed=5)
    jg = jax.tree.map(lambda a: a * 0.9, jp)  # a FedProx anchor distinct from the start
    new_j, loss_j = jsm.local_train(
        jp, jg, x, y, logits_fn=jsm.LOGITS[model], steps=4, lr=0.1, mu=mu
    )
    new_t, loss_t = tsm.local_train(
        tp, params_from_numpy(jax.tree.map(np.asarray, jg), "cpu"),
        torch.from_numpy(x), torch.from_numpy(y),
        logits_fn=tsm.LOGITS[model], steps=4, lr=0.1, mu=mu,
    )
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TRAIN)
    got = params_to_numpy(new_t)
    for k, v in jax.tree.map(np.asarray, new_j).items():
        np.testing.assert_allclose(got[k], v, **TRAIN)


@pytest.mark.parametrize("model", ["mlp", "cnn"])
def test_stacked_logits_equal_per_worker_logits(model):
    """The worker axis of the stacked models is a batch of independent
    models: row i of the stacked logits is model i on shard i."""
    shards, params = [], []
    for i in range(3):
        _, tp, x, _ = _setup(model, 5, seed=10 + i)
        shards.append(torch.from_numpy(x))
        params.append(tp)
    stacked = {k: torch.stack([p[k] for p in params]) for k in params[0]}
    out = tsm.LOGITS_STACKED[model](stacked, torch.stack(shards))
    for i in range(3):
        np.testing.assert_allclose(
            out[i].detach().numpy(),
            tsm.LOGITS[model](params[i], shards[i]).detach().numpy(), **FWD
        )


@pytest.mark.parametrize("model", ["mlp", "cnn"])
def test_init_shapes_match_jax_and_are_seeded(model):
    g = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    if model == "mlp":
        a, b = tsm.init_mlp(g(0), 32, 64, 8), tsm.init_mlp(g(0), 32, 64, 8)
        ref = jsm.init_mlp(jax.random.key(0), 32, 64, 8)
    else:
        a, b = tsm.init_cnn(g(0), 8), tsm.init_cnn(g(0), 8)
        ref = jsm.init_cnn(jax.random.key(0), 8)
    assert {k: tuple(v.shape) for k, v in a.items()} == {k: tuple(v.shape) for k, v in ref.items()}
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["w1"] if model == "mlp" else a["head"]
    assert float(w.abs().max()) <= 2.0 / np.sqrt(w.shape[0]) + 1e-7  # truncated at 2 sigma
