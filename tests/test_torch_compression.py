"""The port's compressed transport against the JAX package (CPU).

``repro_torch.fl.compression`` is held against ``repro.fl.compression`` on
the same numpy inputs.  The reference draws its rounding uniforms from
threefry keys (``commit_key`` / ``broadcast_key``) that PyTorch cannot
reproduce, so the ``jax_draws`` fixture replaces the port's one draw
function, ``rounding_uniforms``, with the reference's draws for the same
(lane, app, n).  Under those shared uniforms:

- policy wire math, lattices, scales, ``nbytes``, dequantized deltas,
  the fused route's EF residuals and chain applies are bit-exact;
- the signSGD scale is a 256-term f32 sum whose order XLA chooses, so it
  is held to rtol 1e-6 (its signs are exact);
- aggregates are f32 reductions: rtol = atol = 1e-5.

topk is tested on tie-free inputs: ``jax.lax.top_k`` and ``torch.topk``
may order ties differently.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import TotoroSystem as JSystem
from repro.fl import compression as jc
from repro_torch.core.api import TotoroSystem as TSystem
from repro_torch.fl import compression as tc

TOL = dict(rtol=1e-5, atol=1e-5)


def _jpol(tpol: tc.CompressionPolicy) -> jc.CompressionPolicy:
    return jc.CompressionPolicy(**vars(tpol))


@pytest.fixture
def jax_draws(monkeypatch):
    """Make the port round with the reference's uniforms."""

    def draws(policy, lane, app_idx, n, shape, device):
        jp = _jpol(policy)
        key = (jc.commit_key(jp, app_idx, n) if lane == tc.COMMIT_LANE
               else jc.broadcast_key(jp, app_idx, n))
        u = np.array(jax.random.uniform(key, tuple(shape), jnp.float32))
        return torch.from_numpy(u).to(device)

    monkeypatch.setattr(tc, "rounding_uniforms", draws)


def _delta(seed, sizes=((40, 7), (13,), (3, 5, 2))):
    """A nested update pytree with distinct |values| (no topk ties)."""
    rng = np.random.default_rng(seed)
    n = sum(int(np.prod(s)) for s in sizes)
    vals = rng.permutation(np.linspace(1e-3, 1.0, n)) * rng.choice([-1.0, 1.0], n)
    vals = vals.astype(np.float32)
    out, off = [], 0
    for s in sizes:
        k = int(np.prod(s))
        out.append(vals[off : off + k].reshape(s))
        off += k
    return {"w": out[0], "b": out[1], "conv": {"k": out[2]}}


def _to_j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_payload_equal(tq, jq, *, scale_rtol=0.0):
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    if scale_rtol:
        np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale), rtol=scale_rtol, atol=0)
    else:
        np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert tq.length == jq.length and tq.levels == jq.levels and tq.chunk == jq.chunk
    assert tq.nbytes == jq.nbytes


# -- policy surface -------------------------------------------------------------

POLICIES = [
    dict(),
    dict(kind="qsgd-int8"),
    dict(kind="qsgd-int8", chunk=100, levels=7),
    dict(kind="signsgd", chunk=64),
    dict(kind="topk", topk_frac=0.05),
    dict(kind="qsgd-int8", downlink="delta-qsgd", downlink_levels=3, chain_cap=2),
    dict(kind="none", downlink="qsgd-int8", levels=15),
    dict(kind="topk", downlink="delta-qsgd", downlink_levels=127, chunk=33),
]


@pytest.mark.parametrize("kw", POLICIES)
def test_policy_wire_math_exact(kw):
    tp, jp = tc.CompressionPolicy(**kw), jc.CompressionPolicy(**kw)
    assert (tp.enabled, tp.downlink_enabled, tp.downlink_bits) == (
        jp.enabled, jp.downlink_enabled, jp.downlink_bits)
    for b in (4.0, 1000.0, 27168.0, 4.0 * 6792, 1e6, 12345.6):
        assert tp.wire_bytes(b) == jp.wire_bytes(b)
        assert tp.delta_wire_bytes(b) == jp.delta_wire_bytes(b)
        for chain in (None, 0, 1, 3):
            assert tp.downlink_wire_bytes(b, chain) == jp.downlink_wire_bytes(b, chain)


@pytest.mark.parametrize(
    "kw",
    [dict(kind="gzip"), dict(levels=0), dict(levels=128), dict(chunk=0), dict(topk_frac=0.0),
     dict(downlink="zstd"), dict(downlink_levels=200), dict(chain_cap=0)],
)
def test_policy_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        jc.CompressionPolicy(**kw)
    with pytest.raises(ValueError):
        tc.CompressionPolicy(**kw)


def test_as_policy():
    assert tc.as_policy(None) is None
    p = tc.CompressionPolicy(kind="topk")
    assert tc.as_policy(p) is p
    assert tc.as_policy("qsgd-int8") == tc.CompressionPolicy(kind="qsgd-int8")
    with pytest.raises(TypeError):
        tc.as_policy(3)


def test_rounding_uniforms_are_keyed_and_device_independent():
    p = tc.CompressionPolicy(kind="qsgd-int8", seed=3)
    a = tc.rounding_uniforms(p, tc.COMMIT_LANE, 0, 5, (4, 256), "cpu")
    assert a.dtype == torch.float32 and tuple(a.shape) == (4, 256)
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    assert torch.equal(a, tc.rounding_uniforms(p, tc.COMMIT_LANE, 0, 5, (4, 256), "cpu"))
    for other in [(tc.COMMIT_LANE, 0, 6), (tc.COMMIT_LANE, 1, 5), (tc.BROADCAST_LANE, 0, 5)]:
        assert not torch.equal(a, tc.rounding_uniforms(p, *other, (4, 256), "cpu"))
    q = tc.CompressionPolicy(kind="qsgd-int8", seed=4)
    assert not torch.equal(a, tc.rounding_uniforms(q, tc.COMMIT_LANE, 0, 5, (4, 256), "cpu"))


# -- commit payloads ---------------------------------------------------------------


@pytest.mark.parametrize("levels", [127, 7, 3])
@pytest.mark.parametrize("chunk", [256, 100])
def test_quantize_delta_qsgd_bit_exact(jax_draws, chunk, levels):
    tp = tc.CompressionPolicy(kind="qsgd-int8", chunk=chunk, levels=levels, seed=2)
    jp = _jpol(tp)
    d = _delta(levels + chunk)
    for seq in (0, 7):
        jq = jc.quantize_delta(_to_j(d), jp, jc.commit_key(jp, 1, seq))
        tq = tc.quantize_delta(_to_t(d), tp, (tc.COMMIT_LANE, 1, seq))
        _assert_payload_equal(tq, jq)
    # no key: deterministic round-half-down in both
    _assert_payload_equal(tc.quantize_delta(_to_t(d), tp), jc.quantize_delta(_to_j(d), jp))


def test_quantize_delta_signsgd_signs_exact_scale_tight():
    tp = tc.CompressionPolicy(kind="signsgd", chunk=64)
    d = _delta(11)
    jq = jc.quantize_delta(_to_j(d), _jpol(tp))
    tq = tc.quantize_delta(_to_t(d), tp)
    _assert_payload_equal(tq, jq, scale_rtol=1e-6)


@pytest.mark.parametrize("frac", [0.01, 0.2, 1.0])
def test_quantize_delta_topk_bit_exact(jax_draws, frac):
    tp = tc.CompressionPolicy(kind="topk", topk_frac=frac, seed=1)
    jp = _jpol(tp)
    d = _delta(int(frac * 100))
    jq = jc.quantize_delta(_to_j(d), jp, jc.commit_key(jp, 0, 3))
    tq = tc.quantize_delta(_to_t(d), tp, (tc.COMMIT_LANE, 0, 3))
    _assert_payload_equal(tq, jq)


def test_quantize_delta_needs_an_enabled_policy():
    with pytest.raises(ValueError):
        tc.quantize_delta(_to_t(_delta(0)), tc.CompressionPolicy())
    with pytest.raises(ValueError):
        tc.quantize_broadcast_delta(_to_t(_delta(0)), tc.CompressionPolicy(kind="qsgd-int8"))


@pytest.mark.parametrize("chunk", [256, 100])
def test_dequantize_and_unflatten_match_jax(jax_draws, chunk):
    tp = tc.CompressionPolicy(kind="qsgd-int8", chunk=chunk, levels=7)
    jp = _jpol(tp)
    d = _delta(chunk)
    jq = jc.quantize_delta(_to_j(d), jp, jc.commit_key(jp, 0, 1))
    tq = tc.quantize_delta(_to_t(d), tp, (tc.COMMIT_LANE, 0, 1))
    want, got = jq.dequantize(), tq.dequantize()
    for path in (("w",), ("b",), ("conv", "k")):
        a, b = want, got
        for k in path:
            a, b = a[k], b[k]
        assert tuple(b.shape) == a.shape
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("keyed", [True, False])
@pytest.mark.parametrize("levels", [127, 7, 3])
def test_quantize_delta_with_residual_is_quantize_delta_plus_reference_residual(
        jax_draws, levels, keyed):
    """The fused route's payload is ``quantize_delta``'s; its residual is the
    reference's ``target - deq`` (numpy fl(q * s), then XLA's subtraction)."""
    tp = tc.CompressionPolicy(kind="qsgd-int8", levels=levels, seed=3, error_feedback=True)
    jp = _jpol(tp)
    d = _delta(levels * 5)
    key, jkey = ((tc.COMMIT_LANE, 0, 4), jc.commit_key(jp, 0, 4)) if keyed else (None, None)
    tq, res = tc.quantize_delta_with_residual(_to_t(d), tp, key)
    plain = tc.quantize_delta(_to_t(d), tp, key)
    _assert_payload_equal(tq, plain)
    assert tq.wire_nbytes is None and tq.like.keys() == plain.like.keys()
    jq = jc.quantize_delta(_to_j(d), jp, jkey)
    _assert_payload_equal(tq, jq)
    want = jax.tree.map(lambda a, b: jnp.asarray(a, jnp.float32)
                        - jnp.asarray(np.asarray(b), jnp.float32), _to_j(d), jq.dequantize())
    got_leaves, want_leaves = jax.tree.leaves(res), jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves) == 3
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy().view(np.int32), np.asarray(w).view(np.int32))


@pytest.mark.parametrize("kw", [dict(kind="signsgd"), dict(kind="topk"),
                                dict(kind="qsgd-int8", chunk=100)])
def test_quantize_delta_with_residual_refuses_other_grids(kw):
    with pytest.raises(ValueError, match="qsgd-int8"):
        tc.quantize_delta_with_residual(_to_t(_delta(0)), tc.CompressionPolicy(**kw))


@pytest.mark.parametrize("chunk", [256, 100])
def test_dequantize_delta_roundtrip_pytree_and_padding(jax_draws, chunk):
    """tests/test_compression.py's round trip, and the reference's bits."""
    rng = np.random.default_rng(0)
    delta = {"a": rng.normal(size=(13, 7)).astype(np.float32),
             "b": rng.normal(size=(5,)).astype(np.float32)}
    tp = tc.CompressionPolicy(kind="qsgd-int8", chunk=chunk)
    jp = _jpol(tp)
    qd = tc.quantize_delta(_to_t(delta), tp, (tc.COMMIT_LANE, 0, 1))
    assert qd.length == 13 * 7 + 5
    back = tc.dequantize_delta(qd)
    assert set(back) == {"a", "b"}
    assert tuple(back["a"].shape) == (13, 7) and tuple(back["b"].shape) == (5,)
    s_max = max(np.abs(v).max() for v in delta.values()) / tp.levels
    if chunk == 256:  # one 96-element delta -> one row, one shared scale
        for k in delta:
            assert np.abs(back[k].numpy() - delta[k]).max() < s_max + 1e-6
    assert not qd.q.reshape(-1)[qd.length:].any()  # zero padding quantizes to 0
    want = jc.dequantize_delta(jc.quantize_delta(_to_j(delta), jp, jc.commit_key(jp, 0, 1)))
    for k in delta:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(want[k]))


# -- downlink ------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kw", [dict(downlink="delta-qsgd", downlink_levels=3), dict(downlink="qsgd-int8", levels=31)]
)
def test_quantize_broadcast_delta_bit_exact(jax_draws, kw):
    tp = tc.CompressionPolicy(kind="qsgd-int8", seed=5, **kw)
    jp = _jpol(tp)
    d = _delta(21)
    jq = jc.quantize_broadcast_delta(_to_j(d), jp, jc.broadcast_key(jp, 2, 4))
    tq = tc.quantize_broadcast_delta(_to_t(d), tp, (tc.BROADCAST_LANE, 2, 4))
    _assert_payload_equal(tq, jq)


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("chunk", [256, 100])
def test_apply_delta_chain_bit_exact(jax_draws, D, chunk):
    tp = tc.CompressionPolicy(kind="qsgd-int8", downlink="delta-qsgd", downlink_levels=3,
                              chunk=chunk, chain_cap=3)
    jp = _jpol(tp)
    params = _delta(99)
    jds = [jc.quantize_broadcast_delta(_to_j(_delta(v)), jp, jc.broadcast_key(jp, 0, v))
           for v in range(1, D + 1)]
    tds = [tc.quantize_broadcast_delta(_to_t(_delta(v)), tp, (tc.BROADCAST_LANE, 0, v))
           for v in range(1, D + 1)]
    want = jc.apply_delta_chain(_to_j(params), jds)
    got = tc.apply_delta_chain(_to_t(params), tds)
    for k in ("w", "b"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(got["conv"]["k"].numpy(), np.asarray(want["conv"]["k"]))
    assert tc.apply_delta_chain(params, []) is params
    with pytest.raises(ValueError):
        tc.apply_delta_chain({"w": torch.zeros(3)}, tds)


# -- module-level helpers ------------------------------------------------------------


def test_signsgd_topk_and_error_feedback_helpers_match_jax():
    x = np.stack([_delta(s)["w"].reshape(-1)[:256] for s in range(3)])  # (3, 256), no ties
    js, jscale = jc.signsgd_compress(jnp.asarray(x))
    ts, tscale = tc.signsgd_compress(torch.from_numpy(x))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tscale.numpy(), np.asarray(jscale), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        tc.signsgd_decompress(ts, torch.from_numpy(np.array(jscale))).numpy(),
        np.asarray(jc.signsgd_decompress(js, jscale)),
    )
    for frac in (0.01, 0.3):
        np.testing.assert_array_equal(
            tc.topk_sparsify(torch.from_numpy(x), frac).numpy(),
            np.asarray(jc.topk_sparsify(jnp.asarray(x), frac)),
        )
        np.testing.assert_array_equal(
            tc.topk_sparsify(torch.from_numpy(x[0]), frac).numpy(),
            np.asarray(jc.topk_sparsify(jnp.asarray(x[0]), frac)),
        )
    err = (x[::-1] * 0.01).copy()
    (jq, jsc), jres = jc.error_feedback_update(
        jnp.asarray(x), jnp.asarray(err), lambda t: jc.qsgd_quantize(t, levels=7))
    (tq_, tsc), tres = tc.error_feedback_update(
        torch.from_numpy(x), torch.from_numpy(err), lambda t: tc.qsgd_quantize(t, levels=7))
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    np.testing.assert_array_equal(
        tc.qsgd_dequantize(tq_, tsc).numpy(), np.asarray(jc.qsgd_dequantize(jq, jsc)))


# -- the quantized ApplyBuffered branch ----------------------------------------------


def _systems():
    out = []
    for S in (JSystem, TSystem):
        s = S(zone_bits=2, suffix_bits=20, seed=4)
        rng = np.random.default_rng(4)
        nodes = [s.Join("n", i, site=i % 4, coord=rng.uniform(0, 50, 2)) for i in range(40)]
        h = s.CreateTree("q")
        for w in nodes[:6]:
            s.Subscribe(h.app_id, w)
        out.append((s, h, nodes[:6]))
    return out


def test_apply_buffered_quantized_matches_jax(jax_draws):
    tp = tc.CompressionPolicy(kind="qsgd-int8", levels=15)
    jp = _jpol(tp)
    (js, jh, nodes), (ts, th, _) = _systems()
    assert hasattr(th, "compression") and th.transfer_weight == 1.0 and th.rate_cap_mbps is None
    for i, w in enumerate(nodes[:4]):
        d = _delta(30 + i)
        jq = jc.quantize_delta(_to_j(d), jp, jc.commit_key(jp, 0, i))
        tq = tc.quantize_delta(_to_t(d), tp, (tc.COMMIT_LANE, 0, i))
        a = js.CommitDelta(jh.app_id, w, jq, weight=10.0 + i, staleness=i % 3)
        b = ts.CommitDelta(th.app_id, w, tq, weight=10.0 + i, staleness=i % 3)
        assert a == b  # wire bytes, edges, modeled time
    ja = js.ApplyBuffered(jh.app_id, staleness_alpha=0.5)
    ta = ts.ApplyBuffered(th.app_id, staleness_alpha=0.5)
    assert ja["version"] == ta["version"] and ja["staleness_hist"] == ta["staleness_hist"]
    np.testing.assert_allclose(ta["weights"], ja["weights"], **TOL)
    for k in ("w", "b"):
        np.testing.assert_allclose(ta["result"][k].numpy(), np.asarray(ja["result"][k]), **TOL)


def test_apply_buffered_refuses_a_mixed_buffer():
    (_, _, _), (ts, th, nodes) = _systems()
    tp = tc.CompressionPolicy(kind="qsgd-int8")
    ts.CommitDelta(th.app_id, nodes[0], tc.quantize_delta(_to_t(_delta(1)), tp))
    ts.CommitDelta(th.app_id, nodes[1], _to_t(_delta(2)))
    with pytest.raises(ValueError, match="mixed"):
        ts.ApplyBuffered(th.app_id)


def test_apply_buffered_custom_aggregator_sees_dequantized_deltas():
    (_, _, _), (ts, th, nodes) = _systems()
    seen = []
    th.aggregate_fn = lambda deltas, weights: seen.append(deltas) or deltas[0]
    tp = tc.CompressionPolicy(kind="qsgd-int8", levels=3)
    qd = tc.quantize_delta(_to_t(_delta(3)), tp)
    ts.CommitDelta(th.app_id, nodes[0], qd)
    out = ts.ApplyBuffered(th.app_id)
    assert torch.equal(out["result"]["w"], qd.dequantize()["w"])
