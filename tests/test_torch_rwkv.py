"""The port's RWKV-6 layers and norms against ``repro.models.rwkv`` and
``repro.models.nn`` on the CPU.

Inputs are numpy from a seed, at rwkv6-7b's reduced width (d 128: 2 heads
of 64, ``ssm_chunk`` 16).  The leaves that are constants at init (the
``mix_*`` interpolations, ``decay_0``, ``bonus_u``, the group norm's scale
and bias) are overwritten on both sides with draws from a seed, so a term
transposed or dropped there shows.  Tolerances (f32):

- ``layer_norm`` / ``group_norm``: rtol = atol = 1e-6;
- the modules (``_wkv_chunk``, ``time_mix_forward``,
  ``channel_mix_forward``, their caches): rtol = atol = 1e-5;
- the strong-decay chunk (``decay_0`` high enough that the
  ``clip(-60, 0)`` bites): ``cumsum`` of large log-decays carries its
  rounding into ``exp(cum_i - cum_j)``, so the bound is set from the JAX
  package's own spread, its f32 chunk against its f64 chunk on the same
  input: the port within 4x that spread of the f64 result (and the
  rtol 1e-5 grade everywhere the decays are not strong);
- gradients: each leaf within 1e-5 of its largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import nn as jnn
from repro.models import rwkv as jr
from torch_threads import one_torch_thread  # noqa: F401
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.models import nn as tnn
from repro_torch.models import rwkv as tr
from repro_torch.pytree import key_paths, leaves

NORM = dict(rtol=1e-6, atol=1e-6)
MOD = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-5
ARCH = "rwkv6-7b"


def _cfgs(**kw):
    return jconfigs.get_reduced(ARCH).replace(**kw), tconfigs.get_reduced(ARCH).replace(**kw)


def _randomised(p, seed, decay0=-5.0):
    """``p`` (numpy leaves) with every constant-at-init leaf drawn from a
    seed: interpolations in [0, 1], ``decay_0`` around ``decay0``, the
    bonus and the norm's scale and bias normal."""
    rng = np.random.default_rng(seed)
    out = dict(p)
    for name, a in p.items():
        if name.startswith("mix_"):
            out[name] = rng.uniform(0, 1, a.shape).astype(a.dtype)
        elif name == "decay_0":
            out[name] = (decay0 + rng.standard_normal(a.shape)).astype(a.dtype)
        elif name in ("bonus_u", "ln_bias"):
            out[name] = (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        elif name == "ln_scale":
            out[name] = (1 + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
    return out


def _time_mix_params(jcfg, seed=0, decay0=-5.0):
    jp = jax.tree.map(np.asarray, jr.init_time_mix(jax.random.key(seed), jcfg))
    jp = _randomised(jp, seed + 100, decay0)
    return jp, params_from_numpy(jp, "cpu")


def _channel_mix_params(jcfg, seed=0):
    jp = jax.tree.map(np.asarray, jr.init_channel_mix(jax.random.key(seed), jcfg))
    jp = _randomised(jp, seed + 100)
    return jp, params_from_numpy(jp, "cpu")


def _x(B, S, d, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((B, S, d)) * scale).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# norms and silu


@pytest.mark.parametrize("shape", [(3, 7, 64), (2, 5, 4, 128)])
def test_layer_norm_matches(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale, bias = (rng.standard_normal(shape[-1]).astype(np.float32) for _ in range(2))
    want = jnn.layer_norm(x, scale, bias)
    got = tnn.layer_norm(*(torch.from_numpy(a) for a in (x, scale, bias)))
    _close(got, want, **NORM)


@pytest.mark.parametrize("shape,groups", [((2, 9, 128), 2), ((3, 64), 4), ((2, 3, 256), 1)])
def test_group_norm_matches(shape, groups):
    rng = np.random.default_rng(groups + len(shape))
    x = (rng.standard_normal(shape) * 2 - 0.5).astype(np.float32)
    scale, bias = (rng.standard_normal(shape[-1]).astype(np.float32) for _ in range(2))
    want = jnn.group_norm(x, scale, bias, groups=groups)
    got = tnn.group_norm(*(torch.from_numpy(a) for a in (x, scale, bias)), groups=groups)
    _close(got, want, **NORM)
    # the groups are normalised apart: one group's shift moves no other group
    x2 = x.copy()
    x2[..., : shape[-1] // groups] += 5.0
    if groups > 1:
        moved = tnn.group_norm(*(torch.from_numpy(a) for a in (x2, scale, bias)), groups=groups)
        torch.testing.assert_close(moved[..., shape[-1] // groups:], got[..., shape[-1] // groups:],
                                   rtol=1e-5, atol=1e-5)


def test_norms_keep_bf16_and_compute_in_f32():
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((4, 128)) * 3, jnp.bfloat16)
    s, b = (jnp.asarray(rng.standard_normal(128), jnp.bfloat16) for _ in range(2))
    tx, ts, tb = (params_from_numpy(np.asarray(a), "cpu") for a in (x, s, b))
    for jfn, tfn, kw in ((jnn.layer_norm, tnn.layer_norm, {}),
                         (jnn.group_norm, tnn.group_norm, {"groups": 2})):
        got = tfn(tx, ts, tb, **kw)
        assert got.dtype == torch.bfloat16
        _close(got, jfn(x, s, b, **kw), rtol=2**-7, atol=2**-7)  # one bf16 ulp


def test_silu_is_closer_to_jax_than_F_silu():
    """``nn.silu`` (x * sigmoid(x)) against ``jax.nn.silu`` on 200,000 f32
    values: fp-tight, and bit-equal far more often than ``F.silu``."""
    x = (np.random.default_rng(0).standard_normal(200_000) * 4).astype(np.float32)
    want = np.asarray(jax.nn.silu(x))
    ours = tnn.silu(torch.from_numpy(x)).numpy()
    theirs = torch.nn.functional.silu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, want, rtol=1e-6, atol=1e-7)
    assert (ours != want).mean() < 0.01 < (theirs != want).mean()


# ---------------------------------------------------------------------------
# parameters and caches


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_layouts_match_jax(param_dtype):
    """Leaf names, shapes and dtypes: decay_0 and bonus_u stay f32."""
    jcfg, tcfg = _cfgs(param_dtype=param_dtype)
    for jfn, tfn in ((jr.init_time_mix, tr.init_time_mix), (jr.init_channel_mix, tr.init_channel_mix)):
        jp = jfn(jax.random.key(0), jcfg)
        tp = tfn(torch.Generator().manual_seed(0), tcfg)
        assert key_paths(tp) == sorted(jp)
        for name in jp:
            assert tuple(tp[name].shape) == jp[name].shape, name
            assert str(tp[name].dtype)[6:] == jp[name].dtype.name, name
    tp = tr.init_time_mix(torch.Generator().manual_seed(0), tcfg)
    assert tp["decay_0"].dtype == tp["bonus_u"].dtype == torch.float32
    assert bool((tp["decay_0"] == -6).all()) and not tp["bonus_u"].any()
    assert tr.num_heads(tcfg) == jr.num_heads(jcfg) == 2


def test_cache_shape_and_init_match_jax():
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jshp, _ = jr.rwkv_cache_shape(jcfg, 3, 77)
    tshp = tr.rwkv_cache_shape(tcfg, 3, 77)
    assert key_paths(tshp) == ["cm/shift", "tm/shift", "tm/state"]
    for a, b in zip(leaves(tshp), jax.tree.leaves(jshp)):
        assert a.is_meta and tuple(a.shape) == b.shape and str(a.dtype)[6:] == b.dtype.name
    for a, b in zip(leaves(tr.rwkv_init_cache(tcfg, 3, 77)),
                    jax.tree.leaves(jr.rwkv_init_cache(jcfg, 3, 77))):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == b.dtype.name and not a.any()


# ---------------------------------------------------------------------------
# the wkv chunk


def _chunk_inputs(B, C, H, hd, seed, decay_scale):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, C, H, hd)).astype(np.float32) for _ in range(3))
    lw = (-np.exp(rng.standard_normal((B, C, H, hd)) * 0.5) * decay_scale).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.5).astype(np.float32)
    state = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, lw, u, state


def test_wkv_chunk_matches_jax_with_a_carried_state():
    args = _chunk_inputs(2, 16, 2, 64, seed=1, decay_scale=0.05)
    want_o, want_s = jr._wkv_chunk(*args)
    got_o, got_s = tr._wkv_chunk(*(torch.from_numpy(a) for a in args))
    _close(got_o, want_o, **MOD)
    _close(got_s, want_s, **MOD)
    # the carried state and the bonus both reach the output
    for i in (4, 5):
        zeroed = list(args)
        zeroed[i] = np.zeros_like(args[i])
        o, _ = tr._wkv_chunk(*(torch.from_numpy(a) for a in zeroed))
        assert float((o - got_o).abs().max()) > 1e-2


def test_wkv_chunk_at_the_decay_clip():
    """Log-decays of about -14 a token: over a chunk of 16, cum_{i-1} - cum_j
    falls below -60, where the reference clips it.  The bound is the JAX
    package's own f32-against-f64 spread on this input (times 4)."""
    args = _chunk_inputs(2, 16, 2, 64, seed=2, decay_scale=12.0)
    r, k, v, lw, u, state = args
    cum = np.cumsum(lw.astype(np.float64), axis=1)
    gap = (cum - lw)[:, :, None] - cum[:, None, :]  # (B, i, j, H, hd)
    below = np.tril(np.ones((16, 16), bool), -1)  # j < i, the pairs the chunk uses
    assert (gap[:, below] < -60).mean() > 0.3  # the clip bites on a third of them and more
    want_o, want_s = (np.asarray(t) for t in jr._wkv_chunk(*args))
    with jax.enable_x64(True):
        f64_o, f64_s = (np.asarray(t) for t in jr._wkv_chunk(*(a.astype(np.float64) for a in args)))
    got_o, got_s = (t.numpy() for t in tr._wkv_chunk(*(torch.from_numpy(a) for a in args)))
    for got, want, f64 in ((got_o, want_o, f64_o), (got_s, want_s, f64_s)):
        spread = np.abs(want - f64).max()
        assert spread > 0
        assert np.abs(got - f64).max() <= 4 * spread, (np.abs(got - f64).max(), spread)
        # away from the strong decays' roundings the module grade holds
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=max(1e-5, 4 * spread))


def test_time_mix_at_the_decay_clip(monkeypatch):
    """``decay_0`` about 2.5 (log-decays of about -12 a token): the clip
    bites inside the time mix's chunks.  Bound: the JAX package's own
    spread on this input, its time mix against the same with each chunk
    body computed in f64 (``_wkv_chunk`` on f64 inputs, its results
    rounded to f32), times 4."""
    jcfg, tcfg = _cfgs()
    jp, tp = _time_mix_params(jcfg, seed=8, decay0=2.5)
    x = _x(2, 32, jcfg.d_model, seed=15)
    want = np.asarray(jr.time_mix_forward(jp, jcfg, x, mode="train")[0])
    chunk = jr._wkv_chunk

    def chunk_f64(*args):
        o, st = chunk(*(a.astype(jnp.float64) for a in args))
        return o.astype(jnp.float32), st.astype(jnp.float32)

    monkeypatch.setattr(jr, "_wkv_chunk", chunk_f64)
    with jax.enable_x64(True):
        f64 = np.asarray(jr.time_mix_forward(jp, jcfg, x, mode="train")[0])
    got = tr.time_mix_forward(tp, tcfg, torch.from_numpy(x), mode="train")[0].numpy()
    spread = np.abs(want - f64).max()
    assert 0 < spread and np.abs(got - f64).max() <= 4 * spread, (np.abs(got - f64).max(), spread)


def test_wkv_step_is_the_chunk_of_one():
    """Decode's one-step recurrence gives what a chunk of one token gives."""
    r, k, v, lw, u, state = (torch.from_numpy(a) for a in _chunk_inputs(3, 1, 2, 64, 4, 0.5))
    o_chunk, s_chunk = tr._wkv_chunk(r, k, v, lw, u, state)
    o_step, s_step = tr._wkv_step(r[:, 0], k[:, 0], v[:, 0], torch.exp(lw[:, 0]), u, state)
    torch.testing.assert_close(o_step, o_chunk[:, 0], **MOD)
    torch.testing.assert_close(s_step, s_chunk, **MOD)


# ---------------------------------------------------------------------------
# time mixing and channel mixing


def _cache(B, d, H, seed):
    rng = np.random.default_rng(seed)
    return {"shift": rng.standard_normal((B, d)).astype(np.float32),
            "state": (rng.standard_normal((B, H, 64, 64)) * 0.3).astype(np.float32)}


@pytest.mark.parametrize("mode,S,cached", [
    ("train", 48, False),    # 3 chunks of 16
    ("prefill", 40, False),  # 40 % 16 != 0: chunks of gcd(40, 16) = 8
    ("prefill", 24, True),   # a cache's state and shift carried in
    ("decode", 1, True),
])
def test_time_mix_forward_matches_jax(mode, S, cached):
    jcfg, tcfg = _cfgs()
    jp, tp = _time_mix_params(jcfg)
    B, d = 2, jcfg.d_model
    x = _x(B, S, d, seed=S)
    jc = _cache(B, d, 2, seed=7) if cached else None
    tc = params_from_numpy(jc, "cpu") if cached else None
    want, want_c = jr.time_mix_forward(jp, jcfg, x, mode=mode, cache=jc)
    got, got_c = tr.time_mix_forward(tp, tcfg, torch.from_numpy(x), mode=mode, cache=tc)
    _close(got, want, **MOD)
    assert key_paths(got_c) == ["shift", "state"] and got_c["state"].dtype == torch.float32
    for name in ("shift", "state"):
        _close(got_c[name], want_c[name], **MOD)
    if mode == "decode":  # written in place
        assert got_c is tc


@pytest.mark.parametrize("mode,S", [("train", 32), ("prefill", 40), ("decode", 1)])
def test_channel_mix_forward_matches_jax(mode, S):
    jcfg, tcfg = _cfgs()
    jp, tp = _channel_mix_params(jcfg)
    B, d = 3, jcfg.d_model
    x = _x(B, S, d, seed=S + 1)
    jc = {"shift": _x(1, B, d, seed=9)[0]}
    tc = params_from_numpy(jc, "cpu")
    want, want_c = jr.channel_mix_forward(jp, jcfg, x, mode=mode, cache=jc)
    got, got_c = tr.channel_mix_forward(tp, tcfg, torch.from_numpy(x), mode=mode, cache=tc)
    _close(got, want, **MOD)
    _close(got_c["shift"], want_c["shift"], **MOD)


def test_decode_after_prefill_matches_jax():
    """A prefill of 24 tokens, then 6 decode steps, each step's output and
    state against JAX's, and against the port's own train forward over the
    same 30 tokens."""
    jcfg, tcfg = _cfgs()
    jp, tp = _time_mix_params(jcfg, seed=3)
    B, d, P, n = 2, jcfg.d_model, 24, 6
    x = _x(B, P + n, d, seed=11)
    jo, jc = jr.time_mix_forward(jp, jcfg, x[:, :P], mode="prefill")
    to, tc = tr.time_mix_forward(tp, tcfg, torch.from_numpy(x[:, :P]), mode="prefill")
    _close(to, jo, **MOD)
    full, _ = tr.time_mix_forward(tp, tcfg, torch.from_numpy(x), mode="train")
    for t in range(P, P + n):
        jo, jc = jr.time_mix_forward(jp, jcfg, x[:, t:t + 1], mode="decode", cache=jc)
        to, tc = tr.time_mix_forward(tp, tcfg, torch.from_numpy(x[:, t:t + 1]), mode="decode",
                                     cache=tc)
        _close(to, jo, **MOD)
        _close(tc["state"], jc["state"], **MOD)
        torch.testing.assert_close(to[:, 0], full[:, t], **MOD)


def test_time_mix_gradients_match_jax_grad():
    """Train mode's gradients, through the chunk loop's remat, against
    ``jax.grad`` of the reference: every parameter and the input."""
    jcfg, tcfg = _cfgs()
    jp, tp = _time_mix_params(jcfg, seed=5)
    x = _x(2, 48, jcfg.d_model, seed=12)
    w = _x(2, 48, jcfg.d_model, seed=13)

    def jloss(p, x):
        return jnp.sum(jr.time_mix_forward(p, jcfg, x, mode="train")[0] * w)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, x)
    ps = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = (tr.time_mix_forward(ps, tcfg, tx, mode="train")[0] * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(loss, [ps[k] for k in sorted(ps)] + [tx])
    for got, want in zip(grads, [jg[k] for k in sorted(jg)] + [jgx]):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= GRAD_REL * np.abs(want).max()


def test_chunk_remat_changes_no_gradient(monkeypatch):
    """Each chunk runs through ``nn.remat`` under autograd; with it replaced
    by a plain call every gradient is bit-equal, and the chunk body runs
    twice a chunk with it (forward, then the backward's recompute)."""
    jcfg, tcfg = _cfgs()
    _, tp = _time_mix_params(jcfg, seed=6)
    x = torch.from_numpy(_x(2, 48, jcfg.d_model, seed=14))
    calls = []
    chunk = tr._wkv_chunk
    monkeypatch.setattr(tr, "_wkv_chunk", lambda *a: calls.append(1) or chunk(*a))

    def grads():
        ps = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        out = tr.time_mix_forward(ps, tcfg, x, mode="train")[0]
        return torch.autograd.grad(out.square().sum(), [ps[k] for k in sorted(ps)])

    on = grads()
    assert len(calls) == 2 * 3
    monkeypatch.setattr(tnn, "remat", lambda fn, *a: fn(*a))
    calls.clear()
    off = grads()
    assert len(calls) == 3
    for a, b in zip(on, off):
        assert torch.equal(a, b)
