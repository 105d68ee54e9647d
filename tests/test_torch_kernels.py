"""The port's kernel wrappers (CPU path) against the JAX package.

Same numpy inputs go through ``repro.kernels.ops`` (in its compiled
``jnp`` mode and in its ``pallas`` interpret mode) and through
``repro_torch.kernels.ops``.  On the CPU the port's wrappers take the
plain version; the CUDA kernels themselves are held against those plain
versions in tests/test_torch_gpu.py and chip_smoke.py.

Tolerances: f32 reductions rtol = atol = 1e-5, the JAX package's own
(tests/test_engine.py).  QSGD quantize, dequantize, the broadcast chain
apply and the fused FedProx update are held bit for bit: their plain
versions repeat the reference's roundings (reciprocal scale, saturating
cast, one rounding per fused multiply-add).  The policy update is held
within atol 1e-5 (tests/test_kernels.py's tolerance) on candidate sets
without ties: XLA's f32 row sums have an order of their own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import compression as jcomp
from repro.kernels import ops as jops
from repro.kernels import tree_aggregate as jta
from repro_torch.kernels import _build
from repro_torch.kernels import broadcast as tbc
from repro_torch.kernels import fused_update as tfu
from repro_torch.kernels import policy_update as tpu
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tq
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tree_aggregate as tta
from repro_torch.pytree import leaves as tleaves

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


def _assert_bits_equal(got: np.ndarray, want: np.ndarray):
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_staleness_weights_match_jax(alpha):
    w = np.array([1.0, 30.0, 7.5, 2.0])
    s = np.array([0, 1, 3, 10])
    want = np.asarray(jta.staleness_weights(w, s, alpha))
    _assert_bits_equal(tta.staleness_weights(w, s, alpha).numpy(), want)


@pytest.mark.parametrize("w", [1.7, 1.0, 0.37])
@pytest.mark.parametrize("alpha", [0.0, 0.1, 0.25, 0.3, 0.5, 0.75, 1.0, 1.5, 2.0])
def test_staleness_weights_bit_equal_to_jax(alpha, w):
    """libm's powf gives XLA's pow bits, where torch.pow misses by an ulp."""
    s = np.arange(200)
    ws = np.full(200, w)
    want = np.asarray(jta.staleness_weights(ws, s, alpha))
    _assert_bits_equal(tta.staleness_weights(ws, s, alpha).numpy(), want)


def test_staleness_weights_bit_equal_to_jax_at_long_staleness():
    s = np.arange(20_000)
    ws = np.full(20_000, 1.7)
    want = np.asarray(jta.staleness_weights(ws, s, 0.5))
    _assert_bits_equal(tta.staleness_weights(ws, s, 0.5).numpy(), want)


def test_staleness_weights_raise_without_libm(monkeypatch):
    monkeypatch.setattr(tta.ctypes.util, "find_library", lambda name: None)
    monkeypatch.setattr(tta, "_libm", [])
    with pytest.raises(RuntimeError, match="libm"):
        tta.staleness_weights([1.0], [2], 0.5)


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


CHAIN_CASES = [
    # (G, C, L, dtype, ragged)
    (3, 5, 333, "f32", True),    # ragged groups: zero rows at zero weight
    (4, 3, 256, "bf16", False),
    (27, 4, 256, "i8", False),   # the compressed apply's level
    (3, 4, 257, "i8", True),
    (5, 1, 1029, "f32", False),  # C = 1
    (2, 1, 64, "bf16", False),
    (2, 17, 300, "f32", True),   # C = 17: a ragged fifth child tile of 4
    (1, 17, 2048, "bf16", False),
    (3, 17, 256, "i8", True),
]


def _chain_inputs(G, C, L, dtype, ragged, seed):
    """The same (G, C, L) values in both frameworks and (G, C) f32 weights;
    int8 lattices take the compressed apply's small weights."""
    g, w = _groups(G, C, L, ragged, seed)
    if dtype != "i8":
        return (*_both(g, dtype), w)
    rng = np.random.default_rng(seed)
    q = rng.integers(-128, 128, (G, C, L)).astype(np.int8)
    q[g == 0] = 0  # the ragged slots' zero rows
    w = (w * 1e-2).astype(np.float32)
    return jnp.asarray(q), torch.from_numpy(q), w


@pytest.mark.parametrize("G,C,L,dtype,ragged", CHAIN_CASES)
def test_tree_aggregate_groups_chain_matches_jax_and_plain(G, C, L, dtype, ragged):
    """The kernel's exact chain agrees with the JAX package's compiled
    einsum and with the plain version within the f32 reduction tolerance."""
    jg, tg, w = _chain_inputs(G, C, L, dtype, ragged, seed=G * 1000 + C * 10 + L)
    got = tref.tree_aggregate_groups_chain(tg, torch.from_numpy(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == (G, L)
    want = np.asarray(jta.tree_aggregate_groups_jnp(jg, jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    torch.testing.assert_close(got, tref.tree_aggregate_groups_ref(tg, torch.from_numpy(w)), **TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "i8"])
def test_tree_aggregate_groups_chain_is_exact(dtype):
    """C = 1 is one rounded product; zero-weight padding slots change no
    bit; int8 gives the bits of its f32 widening."""
    _, tg, w = _chain_inputs(4, 5, 129, dtype, False, seed=9)
    tw = torch.from_numpy(w)
    one = tref.tree_aggregate_groups_chain(tg[:, :1], tw[:, :1])
    assert torch.equal(one, tg[:, 0].float() * tw[:, :1])
    padded = torch.cat([tg, torch.zeros_like(tg[:, :3])], dim=1)
    tw_padded = torch.cat([tw, torch.zeros(4, 3)], dim=1)
    chain = tref.tree_aggregate_groups_chain(tg, tw)
    assert torch.equal(tref.tree_aggregate_groups_chain(padded, tw_padded), chain)
    assert torch.equal(tref.tree_aggregate_groups_chain(tg.float(), tw), chain)


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


# -- QSGD quantize / dequantize, broadcast chain apply, int8 aggregation -------

OVERFLOW_MAX = np.float32(0.16625983)  # fl(M / fl(M * fl(1/127))) > 127


def _qsgd_inputs(R, seed):
    """(R, 256) rows at mixed magnitudes and their uniforms; row 0 is built
    so that floor(x/scale + r) reaches 128 at levels = 127, the last row is
    all zeros."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((R, 256)) * rng.uniform(1e-4, 10.0, (R, 1))).astype(np.float32)
    r = rng.random((R, 256), dtype=np.float32)
    x[0] = np.linspace(-0.1, 0.1, 256, dtype=np.float32)
    x[0, 0] = OVERFLOW_MAX
    r[0, 0] = np.float32(1.0 - 2.0**-24)
    if R > 1:
        x[-1] = 0.0
    return x, r


@pytest.mark.parametrize("levels", [127, 7, 3])
@pytest.mark.parametrize("R", [1, 27, 64])
def test_qsgd_quantize_bit_exact_against_jax(jax_mode, R, levels):
    x, r = _qsgd_inputs(R, seed=R * 1000 + levels)
    jq, js = jops.qsgd_quantize(jnp.asarray(x), jnp.asarray(r), levels=levels)
    q, s = tops.qsgd_quantize(torch.from_numpy(x), torch.from_numpy(r), levels=levels)
    assert q.dtype == torch.int8 and tuple(q.shape) == (R, 256) and tuple(s.shape) == (R, 1)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    if levels == 127:  # the row that overflows a wrapping cast saturates
        raw = np.floor(x[0, 0] / s.numpy()[0, 0] + r[0, 0])
        assert raw == 128.0 and q[0, 0] == 127
    if R > 1:
        assert s[-1, 0] == np.float32(1e-12) and not q[-1].any()


@pytest.mark.parametrize("levels", [127, 7, 3])
@pytest.mark.parametrize("R", [1, 27, 64])
def test_quantize_residual_bit_exact_against_jax_quantize_then_numpy_dequantize(jax_mode, R, levels):
    """The reference's EF residual: JAX's qsgd_quantize, fl(q * s) in numpy,
    then the subtraction in XLA."""
    x, r = _qsgd_inputs(R, seed=R * 77 + levels)
    jq, js = jops.qsgd_quantize(jnp.asarray(x), jnp.asarray(r), levels=levels)
    deq = np.asarray(jq).astype(np.float32) * np.asarray(js).astype(np.float32)
    want = np.asarray(jnp.asarray(x, jnp.float32) - jnp.asarray(deq, jnp.float32))
    q, s, res = tops.qsgd_quantize_residual(torch.from_numpy(x), torch.from_numpy(r), levels=levels)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    _assert_bits_equal(res.numpy(), want)
    q2, s2 = tops.qsgd_quantize(torch.from_numpy(x), torch.from_numpy(r), levels=levels)
    assert torch.equal(q, q2) and torch.equal(s, s2)


@pytest.mark.parametrize("levels", [127, 3])
@pytest.mark.parametrize("chunk", [100, 7])
def test_quantize_truediv_bit_exact_against_eager_jax(chunk, levels):
    """Chunk widths other than 256 take the reference's eager arithmetic."""
    x, r = _qsgd_inputs(33, seed=chunk + levels)
    x, r = x[:, :chunk], r[:, :chunk]
    jq, js = jcomp.qsgd_quantize(jnp.asarray(x), levels=levels, rand=jnp.asarray(r))
    q, s = tref.quantize_ref_truediv(torch.from_numpy(x), torch.from_numpy(r), levels=levels)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


@pytest.mark.parametrize("R", [1, 27, 64])
def test_qsgd_dequantize_bit_exact_against_jax(jax_mode, R):
    rng = np.random.default_rng(R)
    q = rng.integers(-128, 128, (R, 256)).astype(np.int8)
    s = rng.uniform(1e-6, 0.1, (R, 1)).astype(np.float32)
    want = np.asarray(jops.qsgd_dequantize(jnp.asarray(q), jnp.asarray(s)))
    got = tops.qsgd_dequantize(torch.from_numpy(q), torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), want)


def _chain(D, R, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((R, 256)).astype(np.float32)
    q = rng.integers(-127, 128, (D, R, 256)).astype(np.int8)
    s = rng.uniform(1e-4, 0.05, (D, R, 1)).astype(np.float32)
    return w, q, s


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("R", [1, 27, 64])
def test_apply_quantized_broadcast_bit_exact_against_jax(jax_mode, D, R):
    w, q, s = _chain(D, R, seed=10 * D + R)
    want = np.asarray(jops.apply_quantized_broadcast(w, q, s))
    got = tops.apply_quantized_broadcast(*map(torch.from_numpy, (w, q, s)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("D", [2, 3])
def test_chain_apply_d_deep_equals_d_single_steps(D):
    w, q, s = (torch.from_numpy(a) for a in _chain(D, 27, seed=D))
    step = w
    for d in range(D):
        step = tops.apply_quantized_broadcast(step, q[d : d + 1], s[d : d + 1])
    assert torch.equal(tops.apply_quantized_broadcast(w, q, s), step)


@pytest.mark.parametrize("K", [1, 4])
def test_buffered_aggregate_quantized_matches_jax(jax_mode, K):
    rng = np.random.default_rng(K)
    qs = [rng.integers(-127, 128, (27, 256)).astype(np.int8) for _ in range(K)]
    ss = [rng.uniform(1e-4, 0.05, (27, 1)).astype(np.float32) for _ in range(K)]
    weights = rng.uniform(1, 300, K).tolist()
    stal = rng.integers(0, 4, K).tolist()
    want, wc = jops.buffered_aggregate_quantized(qs, ss, weights, stal, alpha=0.5)
    got, tc = tops.buffered_aggregate_quantized(
        [torch.from_numpy(a) for a in qs], [torch.from_numpy(a) for a in ss],
        weights, stal, alpha=0.5,
    )
    np.testing.assert_allclose(tc.numpy(), np.asarray(wc), **TOL)
    assert tuple(got.shape) == (27 * 256,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_int8_aggregate_equals_f32_path_on_widened_input():
    """int8 -> f32 is exact: the int8 input gives the f32 path's bits."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.integers(-128, 128, (27, 4, 256)).astype(np.int8))
    w = torch.from_numpy(rng.uniform(1e-5, 1e-2, (27, 4)).astype(np.float32))
    assert torch.equal(tops.tree_aggregate_groups(q, w), tops.tree_aggregate_groups(q.float(), w))


@pytest.mark.parametrize(
    "call,exc",
    [
        (lambda: tq.qsgd_quantize(torch.zeros(2, 128), torch.zeros(2, 128)), ValueError),
        (lambda: tq.qsgd_quantize(torch.zeros(2, 256), torch.zeros(3, 256)), ValueError),
        (lambda: tq.qsgd_quantize(torch.zeros(2, 256).double(), torch.zeros(2, 256)), TypeError),
        (lambda: tq.qsgd_quantize(torch.zeros(2, 256), torch.zeros(2, 256), levels=128), ValueError),
        (lambda: tq.qsgd_quantize(torch.zeros(256, 2).t(), torch.zeros(2, 256)), ValueError),
        (lambda: tq.qsgd_quantize_residual(torch.zeros(2, 100), torch.zeros(2, 100)), ValueError),
        (lambda: tq.qsgd_quantize_residual(torch.zeros(2, 256), torch.zeros(2, 256), levels=0), ValueError),
        (lambda: tq.qsgd_dequantize(torch.zeros(2, 256), torch.zeros(2, 1)), TypeError),
        (lambda: tq.qsgd_dequantize(torch.zeros(2, 256, dtype=torch.int8), torch.zeros(2)), ValueError),
        (lambda: tbc.apply_quantized_broadcast(
            torch.zeros(2, 256), torch.zeros(1, 3, 256, dtype=torch.int8), torch.zeros(1, 3, 1)), ValueError),
        (lambda: tbc.apply_quantized_broadcast(
            torch.zeros(2, 256), torch.zeros(1, 2, 256, dtype=torch.int8), torch.zeros(1, 2)), ValueError),
        (lambda: tbc.apply_quantized_broadcast(
            torch.zeros(2, 256), torch.zeros(1, 2, 256), torch.zeros(1, 2, 1)), TypeError),
    ],
)
def test_quantize_and_broadcast_wrappers_reject_bad_inputs(call, exc):
    with pytest.raises(exc):
        call()


def test_new_cpu_paths_are_the_plain_versions_and_count_no_launch():
    x, r = (torch.from_numpy(a) for a in _qsgd_inputs(5, seed=0))
    w, q, s = (torch.from_numpy(a) for a in _chain(2, 5, seed=0))
    before = (dict(tq.launches), tbc.launches, tta.launches)
    qq, sc = tq.qsgd_quantize(x, r, levels=7)
    rq, rs = tref.quantize_ref(x, r, levels=7)
    assert torch.equal(qq, rq) and torch.equal(sc, rs)
    for got, want in zip(tq.qsgd_quantize_residual(x, r, levels=7),
                         tref.quantize_residual_ref(x, r, levels=7)):
        assert torch.equal(got, want)
    assert torch.equal(tq.qsgd_dequantize(qq, sc), tref.dequantize_ref(qq, sc))
    assert torch.equal(tbc.apply_quantized_broadcast(w, q, s), tref.apply_quantized_ref(w, q, s))
    tta.tree_aggregate_groups(q.permute(1, 0, 2).contiguous(), torch.ones(5, 2))
    assert (dict(tq.launches), tbc.launches, tta.launches) == before


# -- the fused FedProx update --------------------------------------------------------------


HYPER = [(0.05, 0.1, 0.01), (0.2, 0.01, 0.0), (0.2, 0.0, 0.0)]


def _fused_inputs(L, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(L).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("lr,mu,wd", HYPER)
@pytest.mark.parametrize("L", [1, 1000, 2048, 65536])
def test_fused_update_bit_exact_against_jax(jax_mode, L, lr, mu, wd):
    w, g, w0 = _fused_inputs(L, seed=L)
    want = np.asarray(jops.fused_update(jnp.asarray(w), jnp.asarray(g), jnp.asarray(w0),
                                        lr=lr, mu=mu, wd=wd))
    got = tops.fused_update(*map(torch.from_numpy, (w, g, w0)), lr=lr, mu=mu, wd=wd)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lr,mu,wd", HYPER)
def test_fused_update_bf16_bit_exact_against_jax(jax_mode, lr, mu, wd):
    w, g, w0 = _fused_inputs(4099, seed=5)
    jw, jg, j0 = (jnp.asarray(a, jnp.bfloat16) for a in (w, g, w0))
    want = jops.fused_update(jw, jg, j0, lr=lr, mu=mu, wd=wd)
    got = tops.fused_update(*(torch.from_numpy(a).to(torch.bfloat16) for a in (w, g, w0)),
                            lr=lr, mu=mu, wd=wd)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_fused_update_in_place_and_pytree():
    """``donate=True`` writes into w; shaped leaves and pytrees take the
    flat path; mu = wd = 0 is one fused multiply-add, fma(-lr, g, w)."""
    rng = np.random.default_rng(0)
    p = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for k, s in (("a", (3, 5)), ("b", (7,)))}
    g = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32)) for k, v in p.items()}
    p0 = {k: v.clone() * 0.5 for k, v in p.items()}
    want = tops.fused_update_pytree(p, g, p0, lr=0.1, mu=0.05, wd=0.01)
    buf = {k: v.clone() for k, v in p.items()}
    ptr = {k: v.data_ptr() for k, v in buf.items()}
    out = tops.fused_update_pytree(buf, g, p0, lr=0.1, mu=0.05, wd=0.01, donate=True)
    for k in p:
        assert out[k].data_ptr() == ptr[k] and torch.equal(out[k], want[k])
        assert out[k].shape == p[k].shape
    w, gg = p["a"].reshape(-1), g["a"].reshape(-1)
    assert torch.equal(tops.fused_update(w, gg, w, lr=0.2), tref.fma_f32(float(np.float32(-0.2)), gg, w))


TREE_SHAPES = {"a": (3, 5), "b": (7,), "c": {"d": (2, 1, 1000), "e": (1,)}, "f": (2048,)}


def _tree(shapes, rng, dtypes, names=()):
    """A nested dict of numpy f32 leaves of the given shapes; dtypes:
    leaf path -> "bf16" or "f32" (default f32)."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = _tree(v, rng, dtypes, names + (k,))
        else:
            out[k] = (rng.standard_normal(v).astype(np.float32), dtypes.get(names + (k,), "f32"))
    return out


def _to(tree, framework):
    conv = {"jax": lambda a, d: jnp.asarray(a, jnp.bfloat16 if d == "bf16" else jnp.float32),
            "torch": lambda a, d: torch.from_numpy(a).to(torch.bfloat16 if d == "bf16" else torch.float32)}
    return {k: _to(v, framework) if isinstance(v, dict) else conv[framework](*v) for k, v in tree.items()}


def _leaves_np(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_np(tree[k])]
    return [tree.float().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree.astype(jnp.float32))]


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("mix", ["f32", "bf16", "mixed"])
@pytest.mark.parametrize("lr,mu,wd", HYPER)
def test_fused_update_pytree_bit_exact_against_jax(jax_mode, lr, mu, wd, mix, donate):
    """The multi-leaf path (one kernel call for every leaf on the card; leaf
    by leaf through the plain version here) equals JAX's per-leaf
    ``ops.fused_update_pytree`` bit for bit, over nested leaves of mixed
    shapes and dtypes, in place and not."""
    rng = np.random.default_rng(7)
    dtypes = {"f32": {}, "bf16": {("a",): "bf16", ("b",): "bf16", ("c", "d"): "bf16", ("c", "e"): "bf16",
                                  ("f",): "bf16"},
              "mixed": {("b",): "bf16", ("c", "d"): "bf16"}}[mix]
    p, g, p0 = (_tree(TREE_SHAPES, rng, dtypes) for _ in range(3))
    # JAX may read p's numpy buffers in place and computes asynchronously;
    # the torch leaves share those buffers, so wait before donate writes them
    want = jax.block_until_ready(
        jops.fused_update_pytree(_to(p, "jax"), _to(g, "jax"), _to(p0, "jax"), lr=lr, mu=mu, wd=wd))
    tp = _to(p, "torch")
    got = tops.fused_update_pytree(tp, _to(g, "torch"), _to(p0, "torch"), lr=lr, mu=mu, wd=wd, donate=donate)
    if donate:
        assert all(a is b for a, b in zip(tleaves(got), tleaves(tp)))
    for a, b in zip(_leaves_np(got), _leaves_np(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("L", [1, 7, 4099])
def test_fused_update_mu_wd_zero_shortcut_bit_exact_against_jax(jax_mode, L):
    """At mu = wd = 0 the port computes fma(-lr, g, w) and never reads w0:
    on finite inputs (zeros, tiny and huge values among them, results kept
    normal) that is JAX's three-FMA chain bit for bit."""
    rng = np.random.default_rng(L)
    w, g, w0 = (rng.standard_normal(L).astype(np.float32) * s for s in (1.0, 3.0, 1e4))
    w[::3], g[1::5] = 0.0, 1e-30
    w0[2::7] = 3e38
    want = np.asarray(jops.fused_update(*map(jnp.asarray, (w, g, w0)), lr=0.2, mu=0.0, wd=0.0))
    got = tops.fused_update(*map(torch.from_numpy, (w, g, w0)), lr=0.2, mu=0.0, wd=0.0)
    np.testing.assert_array_equal(got.numpy(), want)
    anchorless = tops.fused_update(torch.from_numpy(w), torch.from_numpy(g),
                                   torch.full((L,), float("nan")), lr=0.2)
    assert torch.equal(anchorless, got)


def test_parity_rule_8_nonfinite_anchor_at_mu_wd_zero(jax_mode):
    """ROADMAP parity rule 8: at mu = wd = 0 JAX still forms 0 * (w - w0),
    a NaN where w - w0 is not finite, and the port does not read w0, so
    its step stays fma(-lr, g, w).  With mu != 0 both run the chain and
    agree bit for bit, infinities and NaNs included."""
    w = np.array([1.0, -2.0, 0.5, 3e38, 4.0], np.float32)
    g = np.array([0.5, 0.25, -1.0, 0.0, 2.0], np.float32)
    w0 = np.array([np.inf, np.nan, -np.inf, -3e38, 1.0], np.float32)  # w - w0: inf, nan, inf, inf, 3
    jw = lambda mu: np.asarray(jops.fused_update(*map(jnp.asarray, (w, g, w0)), lr=0.2, mu=mu, wd=0.0))
    tw = lambda mu: tops.fused_update(*map(torch.from_numpy, (w, g, w0)), lr=0.2, mu=mu, wd=0.0).numpy()
    step = tref.fma_f32(float(np.float32(-0.2)), torch.from_numpy(g), torch.from_numpy(w)).numpy()
    assert np.isnan(jw(0.0)[:4]).all() and np.isfinite(tw(0.0)).all()
    np.testing.assert_array_equal(tw(0.0), step)
    np.testing.assert_array_equal(tw(0.0)[4], jw(0.0)[4])  # w - w0 finite: the same bits
    assert not np.isfinite(jw(0.01)[:4]).any()
    np.testing.assert_array_equal(tw(0.01), jw(0.01))


def test_fused_update_many_cpu_path_is_per_leaf_and_counts_no_launch():
    """The multi-leaf entry on the CPU is the plain version leaf by leaf:
    mixed dtypes, zero-length and one-element leaves, ``outs`` written in
    place; no launch is counted; bad tables raise."""
    rng = np.random.default_rng(3)
    lengths = [5, 0, 1, 300, 0, 17]
    dts = [torch.float32, torch.bfloat16] * 3
    ws, gs, w0s = ([torch.from_numpy(rng.standard_normal(L).astype(np.float32)).to(d)
                    for L, d in zip(lengths, dts)] for _ in range(3))
    before = tfu.launches
    outs = tfu.fused_update_many(ws, gs, w0s, lr=0.1, mu=0.05, wd=0.01)
    for w, g, w0, o in zip(ws, gs, w0s, outs):
        assert o.dtype == w.dtype and torch.equal(o, tref.fused_update_ref(w, g, w0, 0.1, 0.05, 0.01))
    bufs = [w.clone() for w in ws]
    res = tfu.fused_update_many(ws, gs, w0s, lr=0.1, mu=0.05, wd=0.01, outs=bufs)
    assert all(r is b and torch.equal(b, o) for r, b, o in zip(res, bufs, outs))
    assert tfu.fused_update_many([], [], [], lr=0.1) == []
    assert tfu.launches == before
    with pytest.raises(ValueError):
        tfu.fused_update_many(ws, gs[:-1], w0s, lr=0.1)
    with pytest.raises(ValueError):
        tfu.fused_update_many([ws[0]], [gs[3]], [w0s[0]], lr=0.1)
    with pytest.raises(TypeError):
        tfu.fused_update_many([ws[0]], [gs[0].double()], [w0s[0]], lr=0.1)


def test_fma_f32_undoes_double_rounding():
    """2^30 + 2^7 + (2^6 - 2^-40): the f64 sum lands on an f32 midpoint and
    ties to even (up); the exact sum lies below it."""
    a = torch.tensor([np.float32(2.0**6 * (1 + 2.0**-23))])
    b = torch.tensor([np.float32(1 - 2.0**-23)])
    c = torch.tensor([np.float32(2.0**30 + 2.0**7)])
    assert float((a.double() * b.double() + c.double()).float()) == 2.0**30 + 2.0**8
    assert float(tref.fma_f32(a, b, c)) == 2.0**30 + 2.0**7
    assert float(tref.fma_f32(a, -b, -c)) == -(2.0**30 + 2.0**7)
    assert float(tref.fma_f32(float(a), b, c)) == 2.0**30 + 2.0**7  # a Python float a


# -- the Algorithm-1 policy update ---------------------------------------------------------


def _policy_inputs(N, K, M, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((N, K)) < 0.7
    mask[:, 0] = True
    pi = rng.dirichlet(np.ones(K), N) * mask
    pi = (pi / pi.sum(-1, keepdims=True)).astype(np.float32)
    cand = rng.dirichlet(np.ones(K), M).astype(np.float32)  # no ties
    rs = (rng.uniform(0, 4, (N, K)) * (rng.random((N, K)) < 0.5) * mask).astype(np.float32)
    rs[0] = 0.0  # a node whose packets all failed
    if N > 1:  # a policy at the 1e-12 floor
        pi[1] = np.where(mask[1], 1e-12, 0.0)
        pi[1, 0] = 1.0
    return pi, mask, cand, rs


@pytest.mark.parametrize("N,K,M", [(1, 2, 11), (64, 8, 17), (33, 16, 25), (5, 36, 45)])
def test_policy_update_matches_jax(jax_mode, N, K, M):
    pi, mask, cand, rs = _policy_inputs(N, K, M, seed=N + K)
    kw = dict(tau=8, alpha=0.9, beta=0.5)
    want = np.asarray(jops.policy_update(*map(jnp.asarray, (pi, mask, cand, rs)), **kw))
    got = tops.policy_update(*map(torch.from_numpy, (pi, mask, cand, rs)), **kw)
    assert got.dtype == torch.float32 and got.shape == (N, K)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("N,K,M", [(64, 8, 17), (40, 16, 70), (9, 8, 100), (5, 36, 45)])
def test_policy_update_all_ones_masks_match_jax(jax_mode, N, K, M):
    """The planners' all-ones masks (the kernel's shared-row path), and M
    past one and two warps of candidates."""
    pi, _, cand, rs = _policy_inputs(N, K, M, seed=N * K + M)
    mask = np.ones((N, K), bool)
    pi = np.where(pi > 0, pi, 1e-3).astype(np.float32)
    pi /= pi.sum(-1, keepdims=True)
    kw = dict(tau=16, alpha=0.98, beta=0.5)
    want = np.asarray(jops.policy_update(*map(jnp.asarray, (pi, mask, cand, rs)), **kw))
    got = tops.policy_update(*map(torch.from_numpy, (pi, mask, cand, rs)), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_warp_sum_is_the_kernel_order():
    """Lane l holds 0 + x[l] + x[l+32], then the butterfly: exact sums come
    out exact, in any K up to 64, and inexact ones in that fixed order."""
    rng = np.random.default_rng(0)
    for K in (1, 2, 3, 8, 16, 31, 32, 33, 36, 64):
        x = torch.from_numpy(rng.integers(-1000, 1000, (4, K)).astype(np.float64))
        assert torch.equal(tref.warp_sum(x), x.sum(-1))
    x = torch.tensor([[1.0, 2.0**-60, -1.0, 2.0**-60]])  # butterfly: (1 + -1) + (2^-60 + 2^-60)
    assert float(tref.warp_sum(x)[0]) == 2.0**-59
    y = torch.zeros(1, 36, dtype=torch.float64)
    y[0, 0], y[0, 32], y[0, 1] = 1.0, 2.0**-60, -1.0  # lane 0: (0 + 1) + 2^-60 rounds to 1
    assert float(tref.warp_sum(y)[0]) == 0.0


@pytest.mark.parametrize(
    "call,exc",
    [
        (lambda: tfu.fused_update(torch.zeros(4), torch.zeros(5), torch.zeros(4), lr=0.1), ValueError),
        (lambda: tfu.fused_update(torch.zeros(4), torch.zeros(4).double(), torch.zeros(4), lr=0.1), TypeError),
        (lambda: tfu.fused_update(torch.zeros(2, 2), torch.zeros(2, 2), torch.zeros(2, 2), lr=0.1), ValueError),
        (lambda: tfu.fused_update(torch.zeros(8)[::2], torch.zeros(4), torch.zeros(4), lr=0.1), ValueError),
        (lambda: tops.fused_update(torch.zeros(4, 2).t(), torch.zeros(2, 4), torch.zeros(2, 4),
                                   lr=0.1, donate=True), ValueError),
        (lambda: tpu.policy_update(torch.zeros(2, 65), torch.ones(2, 65, dtype=torch.bool),
                                   torch.ones(3, 65), torch.zeros(2, 65), tau=1, alpha=0.5, beta=0.5), ValueError),
        (lambda: tpu.policy_update(torch.zeros(2, 4), torch.ones(2, 4), torch.ones(3, 4),
                                   torch.zeros(2, 4), tau=1, alpha=0.5, beta=0.5), TypeError),
        (lambda: tpu.policy_update(torch.zeros(2, 4), torch.ones(2, 4, dtype=torch.bool),
                                   torch.ones(3, 5), torch.zeros(2, 4), tau=1, alpha=0.5, beta=0.5), ValueError),
    ],
)
def test_fused_and_policy_wrappers_reject_bad_inputs(call, exc):
    with pytest.raises(exc):
        call()


def test_slice_c_cpu_paths_are_the_plain_versions_and_count_no_launch():
    w, g, w0 = (torch.from_numpy(a) for a in _fused_inputs(100, seed=1))
    pi, mask, cand, rs = (torch.from_numpy(a) for a in _policy_inputs(6, 4, 9, seed=2))
    before = (tfu.launches, tpu.launches)
    assert torch.equal(tfu.fused_update(w, g, w0, lr=0.1, mu=0.2, wd=0.3),
                       tref.fused_update_ref(w, g, w0, 0.1, 0.2, 0.3))
    assert torch.equal(tpu.policy_update(pi, mask, cand, rs, tau=3, alpha=0.7, beta=0.4),
                       tref.policy_update_ref(pi, mask, cand, rs, 3, 0.7, 0.4))
    assert (tfu.launches, tpu.launches) == before
