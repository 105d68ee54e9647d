"""The port's tree-aggregation wrappers (CPU path) against the JAX package.

Same numpy inputs go through ``repro.kernels.ops`` (in its compiled
``jnp`` mode and in its ``pallas`` interpret mode) and through
``repro_torch.kernels.ops``.  On the CPU the port's wrappers take the
plain version; the CUDA kernel itself is held against that plain version
in tests/test_torch_gpu.py and chip_smoke.py.  Tolerance rtol = atol =
1e-5, the JAX package's own (tests/test_engine.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import tree_aggregate as jta
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tree_aggregate as tta

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(params=["jnp", "pallas"])
def jax_mode(request):
    prev = jops.set_kernel_mode(request.param)
    try:
        yield request.param
    finally:
        jops.set_kernel_mode(prev)


def _groups(G, C, L, ragged, seed):
    """(G, C, L) f32 rows and (G, C) weights; ragged groups zero the
    padding slots' rows and weights."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((G, C, L)).astype(np.float32)
    w = rng.uniform(0.1, 2.0, (G, C)).astype(np.float32)
    if ragged:
        for i in range(G):
            real = C - (i % C)
            g[i, real:] = 0.0
            w[i, real:] = 0.0
    return g, w


def _both(g, dtype):
    """The same values in both frameworks (bf16 rounds identically: RNE)."""
    if dtype == "bf16":
        return jnp.asarray(g, jnp.bfloat16), torch.from_numpy(g).to(torch.bfloat16)
    return jnp.asarray(g), torch.from_numpy(g)


GROUP_CASES = [
    # (G, C, L, ragged)
    (3, 5, 333, True),     # ragged groups with zero-weight slots, L % 1024 != 0
    (4, 4, 1500, True),
    (5, 1, 1029, False),   # C = 1
    (1, 6, 2100, False),   # G = 1
    (1, 1, 7, False),      # G = C = 1
    (2, 3, 1024, True),    # L a multiple of the TPU tile
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("G,C,L,ragged", GROUP_CASES)
def test_tree_aggregate_groups_matches_jax(jax_mode, G, C, L, ragged, dtype):
    g, w = _groups(G, C, L, ragged, seed=G * 100 + C * 10 + L)
    jg, tg = _both(g, dtype)
    want = np.asarray(jops.tree_aggregate_groups(jg, jnp.asarray(w)))
    got = tops.tree_aggregate_groups(tg, torch.from_numpy(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == (G, L)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("C,L", [(1, 333), (4, 1029), (16, 4096)])
def test_tree_aggregate_matches_jax(jax_mode, C, L, dtype):
    g, w = _groups(1, C, L, False, seed=C * L)
    jg, tg = _both(g[0], dtype)
    want = np.asarray(jops.tree_aggregate(jg, jnp.asarray(w[0])))
    got = tops.tree_aggregate(tg, torch.from_numpy(w[0]))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_zero_weight_slots_add_exact_zeros():
    """Padding a group with zero rows at zero weight changes no bit."""
    g, w = _groups(3, 4, 777, False, seed=7)
    gp = np.concatenate([g, np.zeros((3, 3, 777), np.float32)], axis=1)
    wp = np.concatenate([w, np.zeros((3, 3), np.float32)], axis=1)
    a = tops.tree_aggregate_groups(torch.from_numpy(g), torch.from_numpy(w))
    b = tops.tree_aggregate_groups(torch.from_numpy(gp), torch.from_numpy(wp))
    assert torch.equal(a, b)


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_staleness_weights_match_jax(alpha):
    w = np.array([1.0, 30.0, 7.5, 2.0])
    s = np.array([0, 1, 3, 10])
    want = np.asarray(jta.staleness_weights(w, s, alpha))
    np.testing.assert_allclose(tta.staleness_weights(w, s, alpha).numpy(), want, **TOL)


@pytest.mark.parametrize("K", [1, 3, 6])
def test_buffered_aggregate_matches_jax(jax_mode, K):
    rng = np.random.default_rng(K)
    ups = [
        {"b": rng.standard_normal(13).astype(np.float32),
         "a": rng.standard_normal((40, 7)).astype(np.float32)}
        for _ in range(K)
    ]
    weights = rng.uniform(1, 50, K).tolist()
    stal = rng.integers(0, 5, K).tolist()
    want, wc = jops.buffered_aggregate(
        [{k: jnp.asarray(v) for k, v in u.items()} for u in ups], weights, stal, alpha=0.5
    )
    got, tc = tops.buffered_aggregate(
        [{k: torch.from_numpy(v) for k, v in u.items()} for u in ups], weights, stal, alpha=0.5
    )
    np.testing.assert_allclose(tc.numpy(), np.asarray(wc), **TOL)
    for k in ("a", "b"):
        assert tuple(got[k].shape) == ups[0][k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)


def test_tree_aggregate_pytree_matches_jax():
    rng = np.random.default_rng(3)
    ups = [{"z": rng.standard_normal((5, 3)).astype(np.float32),
            "y": {"q": rng.standard_normal(4).astype(np.float32)}} for _ in range(3)]
    w = [1.0, 2.0, 0.5]
    want = jops.tree_aggregate_pytree([{"z": jnp.asarray(u["z"]), "y": {"q": jnp.asarray(u["y"]["q"])}} for u in ups], w)
    got = tops.tree_aggregate_pytree(
        [{"z": torch.from_numpy(u["z"]), "y": {"q": torch.from_numpy(u["y"]["q"])}} for u in ups], w
    )
    np.testing.assert_allclose(got["z"].numpy(), np.asarray(want["z"]), **TOL)
    np.testing.assert_allclose(got["y"]["q"].numpy(), np.asarray(want["y"]["q"]), **TOL)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 17, 1024, 1025])
def test_bucket_size_matches_jax(n):
    assert tops.bucket_size(n) == jops.bucket_size(n)


@pytest.mark.parametrize("x", [[], [0.0, 0.0], [1.0, 1.0, 1.0], [5.0, 0.0, 0.0], [3.0, 1.0, 2.5]])
def test_jain_fairness_matches_jax(x):
    assert tops.jain_fairness(x) == jops.jain_fairness(x)


@pytest.mark.parametrize(
    "grads,weights,exc",
    [
        (torch.zeros(2, 3), torch.zeros(2, 3), ValueError),                    # not 3-D
        (torch.zeros(2, 3, 4, dtype=torch.float64), torch.zeros(2, 3), TypeError),
        (torch.zeros(2, 3, 4), torch.zeros(2, 3, dtype=torch.float64), TypeError),
        (torch.zeros(2, 3, 4), torch.zeros(3, 2), ValueError),                 # shape
        (torch.zeros(2, 4, 3).transpose(1, 2), torch.zeros(2, 3), ValueError),  # layout
    ],
)
def test_wrapper_rejects_bad_inputs(grads, weights, exc):
    with pytest.raises(exc):
        tta.tree_aggregate_groups(grads, weights)


def test_cpu_path_is_the_plain_version_and_counts_no_launch():
    g, w = _groups(3, 4, 100, True, seed=1)
    before = tta.launches
    out = tta.tree_aggregate_groups(torch.from_numpy(g), torch.from_numpy(w))
    assert tta.launches == before
    assert torch.equal(out, tref.tree_aggregate_groups_ref(torch.from_numpy(g), torch.from_numpy(w)))


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "_lib_path", lambda name: _build.BUILD_DIR / "absent.so")
    monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("tree_aggregate")
