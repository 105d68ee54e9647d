"""The port's ``fl/aggregation.py`` and ``fl/dp.py`` against the JAX
package's, on the same numpy inputs.

The reference's aggregation runs eagerly (one XLA op per array op, no FMA
contraction), so ``fedavg``, ``pairwise_accumulate``, ``fedprox_grad``,
``straggler_mask`` and ``server_update`` are held bit-equal.  DP noise
follows the third parity grade: the reference's ``jax.random.normal``
draws are passed in.  The global norm's sum of squares is summed in
PyTorch's order, not XLA's: fp-tight (rtol = atol = 1e-6 on the norm,
TOL after the clip and noise).  Mirrors ``tests/test_fl.py`` and
``tests/test_kernels.py::test_tree_aggregate_pytree_matches_fedavg``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import aggregation as jagg
from repro.fl import dp as jdp
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.fl import aggregation as tagg
from repro_torch.fl import dp as tdp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tree_aggregate as tta
from repro_torch.pytree import leaves

TOL = dict(rtol=1e-5, atol=1e-5)


def _deltas(seed, n, shapes=((40, 7), (13,), (3, 2, 5))):
    rng = np.random.default_rng(seed)
    return [
        {"a": rng.standard_normal(shapes[0]).astype(np.float32),
         "b": {"c": rng.standard_normal(shapes[1]).astype(np.float32),
               "d": rng.standard_normal(shapes[2]).astype(np.float32)}}
        for _ in range(n)
    ]


def _equal(t_tree, j_tree):
    tl, jl = leaves(params_to_numpy(t_tree)), jax.tree.leaves(j_tree)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a, np.asarray(b))


def _t(tree):
    return params_from_numpy(tree, "cpu")


def test_fedavg_weighted_mean():
    deltas = [{"w": np.ones(3, np.float32) * i} for i in range(1, 4)]
    out = tagg.fedavg([_t(d) for d in deltas], [1.0, 1.0, 2.0])
    np.testing.assert_allclose(out["w"].numpy(), (1 + 2 + 3 * 2) / 4 * np.ones(3))


@pytest.mark.parametrize("n,seed", [(1, 0), (4, 1), (16, 2), (32, 3), (33, 4), (70, 5)])
def test_fedavg_matches_jax(n, seed):
    """Bit-equal up to 32 clients; above, XLA sums the weights in an order
    of its own, and the normalised weights (hence the mean) agree to f32
    rounding of that sum."""
    deltas = _deltas(seed, n)
    w = np.random.default_rng(100 + seed).uniform(0.1, 3.0, n).astype(np.float32)
    got, want = tagg.fedavg([_t(d) for d in deltas], list(w)), jagg.fedavg(deltas, list(w))
    if n <= 32:
        _equal(got, want)
    else:
        for a, b in zip(leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_fedavg_bf16_deltas_bit_equal():
    deltas = [jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), d)
              for d in _deltas(7, 5)]
    w = [1.0, 2.0, 0.5, 0.25, 3.0]
    out = tagg.fedavg([_t(d) for d in deltas], w)
    assert all(l.dtype == torch.float32 for l in leaves(out))
    _equal(out, jagg.fedavg(deltas, w))


@pytest.mark.parametrize("n", [4, 16])
def test_pairwise_accumulate_bit_equal_and_matches_fedavg(n):
    deltas = _deltas(n, n)
    w = np.random.default_rng(n).uniform(0.0, 1.0, n)
    w = (w / w.sum()).tolist()
    tacc = jacc = None
    for d, wi in zip(deltas, w):
        tacc = tagg.pairwise_accumulate(tacc, _t(d), wi)
        jacc = jagg.pairwise_accumulate(jacc, d, wi)
    _equal(tacc, jacc)
    for a, b in zip(leaves(tacc), leaves(tagg.fedavg([_t(d) for d in deltas], w))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mu", [0.0, 0.5, 0.01])
def test_fedprox_grad_bit_equal(mu):
    g, p, w0 = _deltas(11, 3)
    out = tagg.fedprox_grad(_t(g), _t(p), _t(w0), mu=mu)
    _equal(out, jagg.fedprox_grad(g, p, w0, mu=mu))
    simple = tagg.fedprox_grad({"w": torch.zeros(3)}, {"w": torch.ones(3) * 2}, {"w": torch.ones(3)}, mu=0.5)
    np.testing.assert_allclose(simple["w"].numpy(), 0.5 * np.ones(3))


@pytest.mark.parametrize("weights,completed", [
    ([1.0, 1.0, 2.0], [True, False, True]),
    ([0.3, 1.7, 2.2, 0.9, 5.1], [True, True, False, True, True]),
    ([1.0, 2.0], [False, False]),  # nobody finished: all zeros, no NaN
    (np.random.default_rng(3).uniform(0.1, 3, 32).tolist(), [i % 3 > 0 for i in range(32)]),
])
def test_straggler_mask_bit_equal(weights, completed):
    got = tagg.straggler_mask(weights, completed).numpy()
    np.testing.assert_array_equal(got, np.asarray(jagg.straggler_mask(weights, completed)))
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("server_lr", [1.0, 0.3])
def test_server_update_bit_equal(dtype, server_lr):
    p, d = _deltas(21, 2)
    p = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, dtype)), p)
    out = tagg.server_update(_t(p), _t(d), server_lr)
    assert all(str(l.dtype) == f"torch.{dtype}" for l in leaves(out))
    _equal(out, jagg.server_update(p, d, server_lr))


def test_tree_aggregate_pytree_matches_fedavg():
    """``ops.tree_aggregate_pytree`` (the kernel's G = 1 entry) against the
    port's fedavg, as ``tests/test_kernels.py`` holds the reference's."""
    deltas = _deltas(5, 5, shapes=((40, 7), (13,), (2, 2, 2)))
    w = [1.0, 2.0, 3.0, 0.5, 1.5]
    agg = tops.tree_aggregate_pytree([_t(d) for d in deltas], np.asarray(w) / np.sum(w))
    expect = tagg.fedavg([_t(d) for d in deltas], w)
    for a, b in zip(leaves(agg), leaves(expect)):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("C,L,dtype", [(3, 1000, torch.float32), (16, 6792, torch.float32),
                                       (5, 333, torch.bfloat16), (1, 7, torch.float32)])
def test_module_tree_aggregate_answers_to_reference(C, L, dtype):
    from repro.kernels import ref as jref

    rng = np.random.default_rng(C * L)
    g = rng.standard_normal((C, L)).astype(np.float32)
    w = rng.uniform(0, 1, C).astype(np.float32)
    tg = torch.from_numpy(g).to(dtype)
    before = tta.launches
    out = tta.tree_aggregate(tg, torch.from_numpy(w))
    assert tta.launches == before  # the CPU launches nothing
    assert out.dtype == torch.float32 and out.shape == (L,)
    want = jref.tree_aggregate_ref(jnp.asarray(tg.float().numpy(), jnp.float32), jnp.asarray(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    torch.testing.assert_close(tops.tree_aggregate(tg, w), out, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tta.tree_aggregate(tg[None], torch.from_numpy(w))


def test_dp_clip_and_noise():
    g = {"w": torch.ones(100) * 10}
    clipped, n = tdp.clip_by_global_norm(g, 1.0)
    assert float(tdp.global_norm(clipped)) <= 1.0 + 1e-5
    noised = tdp.dp_sanitize(g, torch.Generator().manual_seed(0), clip=1.0, sigma=0.1)
    assert float(tdp.global_norm(noised)) > 0


@pytest.mark.parametrize("seed,max_norm", [(0, 1.0), (1, 1e3), (2, 0.05)])
def test_global_norm_and_clip_match_jax(seed, max_norm):
    tree = _deltas(seed, 1)[0]
    tn = tdp.global_norm(_t(tree))
    np.testing.assert_allclose(float(tn), float(jdp.global_norm(tree)), rtol=1e-6, atol=1e-6)
    tc, tn2 = tdp.clip_by_global_norm(_t(tree), max_norm)
    jc, _ = jdp.clip_by_global_norm(tree, max_norm)
    assert float(tn2) == float(tn)
    for a, b in zip(leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    if max_norm >= float(tn):  # under the bound: left as it is
        _equal(tc, tree)


def _jax_draws(tree, key):
    """The standard-normal draws ``repro.fl.dp.gaussianize`` makes."""
    ls = jax.tree.leaves(tree)
    keys = jax.random.split(key, len(ls))
    return [np.array(jax.random.normal(k, np.shape(x))) for x, k in zip(ls, keys)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip,sigma", [(1.0, 0.1), (50.0, 1.0)])
def test_dp_sanitize_with_reference_draws(dtype, clip, sigma):
    tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, dtype)), _deltas(3, 1)[0])
    key = jax.random.key(42)
    want = jdp.dp_sanitize(tree, key, clip=clip, sigma=sigma)
    clipped, _ = jdp.clip_by_global_norm(tree, clip)
    draws = _jax_draws(clipped, key)
    got = tdp.dp_sanitize(_t(tree), [torch.from_numpy(z) for z in draws], clip=clip, sigma=sigma)
    tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)  # one bf16 ulp at the clip
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        assert str(a.dtype) == f"torch.{dtype}"
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), **tol)
    # gaussianize alone, with no clip in front, is bit-equal
    g = tdp.gaussianize(_t(clipped), [torch.from_numpy(z) for z in draws], sigma * clip)
    _equal(g, jdp.gaussianize(clipped, key, sigma * clip))


def test_gaussianize_generator_is_seeded_and_checked():
    tree = _t(_deltas(9, 1)[0])
    a = tdp.gaussianize(tree, torch.Generator().manual_seed(5), 0.3)
    b = tdp.gaussianize(tree, torch.Generator().manual_seed(5), 0.3)
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        tdp.gaussianize(tree, [torch.zeros(1)], 0.3)
    with pytest.raises(ValueError):
        tdp.gaussianize({"w": torch.zeros(3)}, [torch.zeros(4)], 0.3)
