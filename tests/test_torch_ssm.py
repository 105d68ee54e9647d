"""The port's Mamba block against ``repro.models.ssm`` on the CPU.

Inputs are numpy from a seed, at jamba's reduced width (d 128, d_inner
256, d_state 16, d_conv 4, dt_rank 16, ``ssm_chunk`` 16).  The leaves that
are constants at init (``conv_b``, ``D``, ``dt_b`` and ``A_log``, whose
rows are all log(1..16)) are overwritten on both sides with draws from a
seed, so a term transposed or dropped there shows.  Tolerances (f32):

- ``_causal_conv``, ``associative_scan`` against ``jax.lax.
  associative_scan`` with the same combine, ``mamba_forward`` in its
  three modes and its caches: rtol = atol = 1e-5 (XLA may contract the
  combine's ``a_r b_l + b_r`` into an FMA, and ``softplus`` and ``silu``
  miss XLA's bits by an ulp on a few per cent of values: fp-tight, not
  bit-equal);
- gradients: each leaf within 1e-5 of its largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ssm as js
from torch_threads import one_torch_thread  # noqa: F401
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.models import nn as tnn
from repro_torch.models import ssm as ts
from repro_torch.pytree import key_paths, leaves

MOD = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-5
ARCH = "jamba-1.5-large-398b"


def _cfgs(**kw):
    return jconfigs.get_reduced(ARCH).replace(**kw), tconfigs.get_reduced(ARCH).replace(**kw)


def _params(jcfg, seed=0):
    """JAX's init with the constant leaves drawn from a seed: conv_b and D
    normal, dt_b around -3, A_log rows of distinct values."""
    jp = dict(jax.tree.map(np.asarray, js.init_mamba(jax.random.key(seed), jcfg)))
    rng = np.random.default_rng(seed + 100)
    di, ds = jp["A_log"].shape
    jp["conv_b"] = (0.3 * rng.standard_normal(di)).astype(np.float32)
    jp["D"] = (1 + 0.5 * rng.standard_normal(di)).astype(np.float32)
    jp["dt_b"] = (-3 + rng.standard_normal(di)).astype(np.float32)
    jp["A_log"] = np.log(rng.uniform(0.5, 16, (di, ds))).astype(np.float32)
    return jp, params_from_numpy(jp, "cpu")


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# parameters and caches


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_layout_matches_jax(param_dtype):
    """Leaf names, shapes and dtypes (A_log and D f32 at any param_dtype),
    and the sizes the config implies: d_inner 256, dt_rank 16."""
    jcfg, tcfg = _cfgs(param_dtype=param_dtype)
    jp = js.init_mamba(jax.random.key(0), jcfg)
    tp = ts.init_mamba(torch.Generator().manual_seed(0), tcfg)
    assert key_paths(tp) == sorted(jp)
    for name in jp:
        assert tuple(tp[name].shape) == jp[name].shape, name
        assert str(tp[name].dtype)[6:] == jp[name].dtype.name, name
    assert (ts.d_inner(tcfg), ts.dt_rank(tcfg)) == (js.d_inner(jcfg), js.dt_rank(jcfg)) == (256, 16)
    np.testing.assert_allclose(tp["A_log"].numpy(), np.asarray(jp["A_log"]), rtol=1e-7)
    full = tconfigs.get_config(ARCH)
    assert (ts.d_inner(full), ts.dt_rank(full)) == (16384, 512)


def test_cache_shape_and_init_match_jax():
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jshp, _ = js.mamba_cache_shape(jcfg, 3, 99)
    tshp = ts.mamba_cache_shape(tcfg, 3, 99)
    assert key_paths(tshp) == ["conv", "h"]
    for a, b in zip(leaves(tshp), jax.tree.leaves(jshp)):
        assert a.is_meta and tuple(a.shape) == b.shape and str(a.dtype)[6:] == b.dtype.name
    for a, b in zip(leaves(ts.mamba_init_cache(tcfg, 3, 99)),
                    jax.tree.leaves(js.mamba_init_cache(jcfg, 3, 99))):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == b.dtype.name and not a.any()


# ---------------------------------------------------------------------------
# pieces


@pytest.mark.parametrize("S", [1, 3, 17])
def test_causal_conv_matches_jax(S):
    x, w, b = _x((2, S, 256), S), _x((4, 256), S + 1), _x((256,), S + 2)
    _close(ts._causal_conv(*(torch.from_numpy(a) for a in (x, w, b))), js._causal_conv(x, w, b),
           **MOD)


def test_causal_conv_is_causal_and_keeps_its_tap_order():
    x, w, b = (torch.from_numpy(a) for a in (_x((1, 12, 8), 0), _x((4, 8), 1), _x((8,), 2)))
    out = ts._causal_conv(x, w, b)
    x2 = x.clone()
    x2[:, 7] += 1.0
    moved = ts._causal_conv(x2, w, b)
    assert torch.equal(moved[:, :7], out[:, :7]) and not torch.equal(moved[:, 7], out[:, 7])
    # tap dc - 1 weighs the current token: x[t] w[3] + x[t-1] w[2] + ...
    torch.testing.assert_close(moved[:, 7] - out[:, 7], w[3][None], rtol=1e-5, atol=1e-5)


def _jax_comb(l, r):
    al, bl = l
    ar, br = r
    return al * ar, ar * bl + br


@pytest.mark.parametrize("n", [1, 2, 5, 8, 16, 33, 64])
def test_associative_scan_matches_jax(n):
    """The first-order recurrence's combine on (B, n, di, ds), scanned along
    axis 1, at odd and even lengths, against ``jax.lax.associative_scan``."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.2, 1.0, (2, n, 6, 4)).astype(np.float32)
    b = rng.standard_normal((2, n, 6, 4)).astype(np.float32)
    want = jax.lax.associative_scan(_jax_comb, (a, b), axis=1)
    got = ts.associative_scan(ts._combine, (torch.from_numpy(a), torch.from_numpy(b)), dim=1)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, **MOD)
    # and it is the recurrence h_t = a_t h_{t-1} + b_t from h = 0
    h, hs = np.zeros((2, 6, 4), np.float64), []
    for t in range(n):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    np.testing.assert_allclose(got[1].numpy(), np.stack(hs, 1), rtol=1e-5, atol=1e-5)


def test_associative_scan_with_addition_is_cumsum():
    x = torch.from_numpy(_x((3, 21, 5), 4))
    got, = ts.associative_scan(lambda l, r: [l[0] + r[0]], (x,), dim=1)
    torch.testing.assert_close(got, torch.cumsum(x, 1), rtol=1e-5, atol=1e-5)


def test_ssm_inputs_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    xz = _x((2, 24, 512), 5)
    want = js._ssm_inputs(jp, jcfg, xz)
    got = ts._ssm_inputs(tp, tcfg, torch.from_numpy(xz))
    for name, g, w in zip(("x_raw", "x", "z", "dt", "A", "Bm", "Cm"), got, want):
        assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == w.dtype.name, name
        _close(g, w, **MOD)


# ---------------------------------------------------------------------------
# the block


def _cache(B, seed):
    rng = np.random.default_rng(seed)
    return {"conv": rng.standard_normal((B, 3, 256)).astype(np.float32),
            "h": (rng.standard_normal((B, 256, 16)) * 0.5).astype(np.float32)}


@pytest.mark.parametrize("mode,S,cached", [
    ("train", 48, False),    # 3 chunks of 16
    ("train", 40, False),    # 40 % 16 != 0: chunks of gcd(40, 16) = 8
    ("prefill", 40, False),
    ("prefill", 24, True),   # the cache's state carried in
    ("decode", 1, True),
])
def test_mamba_forward_matches_jax(mode, S, cached):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _x((2, S, jcfg.d_model), S)
    jc = _cache(2, seed=7) if cached else None
    tc = params_from_numpy(jc, "cpu") if cached else None
    want, want_c = js.mamba_forward(jp, jcfg, x, mode=mode, cache=jc)
    got, got_c = ts.mamba_forward(tp, tcfg, torch.from_numpy(x), mode=mode, cache=tc)
    _close(got, want, **MOD)
    if mode == "train":
        assert got_c is None and want_c is None
        return
    assert key_paths(got_c) == ["conv", "h"] and got_c["h"].dtype == torch.float32
    for name in ("conv", "h"):
        assert tuple(got_c[name].shape) == want_c[name].shape
        _close(got_c[name], want_c[name], **MOD)
    if mode == "decode":  # written in place
        assert got_c is tc


def test_decode_after_prefill_matches_jax_and_the_train_forward():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=1)
    B, P, n = 2, 24, 6
    x = _x((B, P + n, jcfg.d_model), 8)
    jo, jc = js.mamba_forward(jp, jcfg, x[:, :P], mode="prefill")
    to, tc = ts.mamba_forward(tp, tcfg, torch.from_numpy(x[:, :P]), mode="prefill")
    _close(to, jo, **MOD)
    full, _ = ts.mamba_forward(tp, tcfg, torch.from_numpy(x), mode="train")
    for t in range(P, P + n):
        jo, jc = js.mamba_forward(jp, jcfg, x[:, t:t + 1], mode="decode", cache=jc)
        to, tc = ts.mamba_forward(tp, tcfg, torch.from_numpy(x[:, t:t + 1]), mode="decode",
                                  cache=tc)
        _close(to, jo, **MOD)
        _close(tc["h"], jc["h"], **MOD)
        _close(tc["conv"], jc["conv"], **MOD)
        torch.testing.assert_close(to[:, 0], full[:, t], **MOD)


def test_prefill_shorter_than_the_conv_keeps_the_padded_history():
    """A prompt of 2 tokens at d_conv 4: the port's conv cache is the zero
    padding and the 2 inputs the conv saw, so decoding on from it gives the
    train forward's outputs (the reference returns a cache of 1 row here,
    which its decode cannot take)."""
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0], seed=2)
    x = torch.from_numpy(_x((2, 6, tcfg.d_model), 9))
    full, _ = ts.mamba_forward(tp, tcfg, x, mode="train")
    out, cache = ts.mamba_forward(tp, tcfg, x[:, :2], mode="prefill")
    assert tuple(cache["conv"].shape) == (2, 3, 256) and not cache["conv"][:, 0].any()
    for t in range(2, 6):
        o, cache = ts.mamba_forward(tp, tcfg, x[:, t:t + 1], mode="decode", cache=cache)
        torch.testing.assert_close(o[:, 0], full[:, t], **MOD)


def test_mamba_gradients_match_jax_grad():
    """Train mode's gradients, through the chunk loop's remat and the scan,
    against ``jax.grad`` of the reference (S = 40: chunks of 8)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=3)
    x = _x((2, 40, jcfg.d_model), 10)
    w = _x((2, 40, jcfg.d_model), 11)

    def jloss(p, x):
        return jnp.sum(js.mamba_forward(p, jcfg, x, mode="train")[0] * w)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, x)
    ps = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = (ts.mamba_forward(ps, tcfg, tx, mode="train")[0] * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(loss, [ps[k] for k in sorted(ps)] + [tx])
    for name, got, want in zip(sorted(ps) + ["x"], grads, [jg[k] for k in sorted(jg)] + [jgx]):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= GRAD_REL * np.abs(want).max(), name


def test_chunk_remat_changes_no_gradient(monkeypatch):
    """Each chunk runs through ``nn.remat`` under autograd; with it replaced
    by a plain call every gradient is bit-equal, and the chunk body runs
    twice a chunk with it."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg, seed=4)
    x = torch.from_numpy(_x((2, 48, tcfg.d_model), 12))
    calls = []
    body = ts._scan_chunk
    monkeypatch.setattr(ts, "_scan_chunk", lambda *a: calls.append(1) or body(*a))

    def grads():
        ps = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        out = ts.mamba_forward(ps, tcfg, x, mode="train")[0]
        return torch.autograd.grad(out.square().sum(), [ps[k] for k in sorted(ps)])

    on = grads()
    assert len(calls) == 2 * 3
    monkeypatch.setattr(tnn, "remat", lambda fn, *a: fn(*a))
    calls.clear()
    off = grads()
    assert len(calls) == 3
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_bf16_activations_with_f32_weights():
    """jamba's own dtypes: f32 parameters, bf16 activations; the weights are
    cast at each use, the state stays f32, the conv history bf16."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jp, tp = _params(jcfg)
    x = jnp.asarray(_x((2, 32, jcfg.d_model), 13), jnp.bfloat16)
    want, want_c = js.mamba_forward(jp, jcfg, x, mode="prefill")
    got, got_c = ts.mamba_forward(tp, tcfg, params_from_numpy(np.asarray(x), "cpu"), mode="prefill")
    assert got.dtype == torch.bfloat16 and got_c["conv"].dtype == torch.bfloat16
    assert got_c["h"].dtype == torch.float32
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    assert float(np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()) < 2**-6 * scale
    _close(got_c["conv"], want_c["conv"], rtol=0, atol=0)  # the inputs the conv saw, as given
