"""The port's MoE family against ``repro.models`` on the CPU: GShard
routing, the MoE FFN, MLA attention, and the list-bearing trees
(deepseek-v2's ``params["first"]``) through pytree and checkpoints.

Inputs are numpy from a seed; parameters come from the JAX package's
seeded init and cross with ``repro_torch.convert``.  Tolerances (f32):

- ``route``: dispatch, the top-k indices and each kept token's slot
  exactly (0/1 tensors built by comparisons and integer cumsums); combine
  and the aux loss within rtol 1e-5 (combine holds the normalised gates,
  one f32 division each; the aux loss two means in another order);
- ``moe_forward`` and ``mla_forward`` outputs: rtol = atol = 1e-5, the
  JAX package's kernel tolerance (the same f32 products summed in other
  orders);
- the bf16 MoE FFN: within 2^-5 of the largest output (a bf16 ulp is
  2^-8 of a value, and the expert products round in their own order);
- checkpoints: byte for byte.
"""
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro import configs as jconfigs
from repro.fl import steps as jsteps
from repro.models import attention as ja
from repro.models import lm as jlm
from repro.models import moe as jmoe
from torch_threads import one_torch_thread  # noqa: F401
from repro_torch import ckpt as tckpt
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.fl import steps as tsteps
from repro_torch.models import attention as ta
from repro_torch.models import moe as tmoe
from repro_torch.pytree import key_paths, leaves, ravel, tree_map, unflatten_like

RTOL = 1e-5
OUT = dict(rtol=1e-5, atol=1e-5)
MOE = ["deepseek-v2-lite-16b", "moonshot-v1-16b-a3b"]


def _cfgs(arch, **kw):
    return jconfigs.get_reduced(arch).replace(**kw), tconfigs.get_reduced(arch).replace(**kw)


def _gates(kind, G, T, E, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":  # a zero router: every gate ties at 1/E
        logits = np.zeros((G, T, E), np.float32)
    elif kind == "coarse":  # logits on a grid of 4 values: many ties, not all
        logits = rng.integers(0, 4, (G, T, E)).astype(np.float32)
    else:
        logits = (rng.standard_normal((G, T, E)) * 2).astype(np.float32)
    return np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))


# ---------------------------------------------------------------------------
# routing


@pytest.mark.parametrize("G,T,E,k,C,kind", [
    (2, 64, 8, 1, 8, "normal"),      # k = 1, 8 a slot on average: drops
    (2, 64, 8, 2, 24, "normal"),     # the reduced configs' routing (capacity 24)
    (1, 128, 64, 6, 8, "normal"),    # deepseek's k = 6 of 64, heavy overflow
    (3, 32, 64, 6, 16, "uniform"),   # all gates tie: experts 0..5, the rest dropped
    (2, 48, 16, 6, 24, "coarse"),    # partial ties
    (1, 16, 64, 6, 64, "normal"),    # dropless
])
def test_route_matches_jax(G, T, E, k, C, kind):
    gates = _gates(kind, G, T, E, seed=G * T + E + k)
    jd, jc, jaux = jmoe.route(jnp.asarray(gates), k, C)
    jd, jc = np.asarray(jd), np.asarray(jc)
    td, tc, taux = tmoe.route(torch.from_numpy(gates), k, C)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=RTOL, atol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL)
    # the top-k indices and every kept token's slot, exactly
    jw, jidx = jax.lax.top_k(jnp.asarray(gates), k)
    tw, tidx = tmoe.top_k(torch.from_numpy(gates), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    slots = np.arange(C)
    np.testing.assert_array_equal((td.numpy() * slots).sum(-1), (jd * slots).sum(-1))
    kept = jd.sum((1, 3))  # tokens each expert took, per group
    assert kept.max() <= C
    if kind == "uniform":
        assert np.array_equal(np.asarray(jidx)[0, 0], np.arange(k))
        assert jd[:, :, k:].sum() == 0 and kept[:, :k].min() == min(C, T)
    if C < T * k / E:
        assert jd.sum() < G * T * k  # some tokens were dropped


def test_top_k_keeps_the_lower_index_on_ties():
    """``torch.topk`` promises no order among equal values; the port's
    ``top_k`` gives JAX's: the lower index first."""
    g = torch.full((3, 64), 1 / 64)
    g[1, 40:] = 0.5
    w, idx = tmoe.top_k(g, 6)
    jw, jidx = jax.lax.top_k(jnp.asarray(g.numpy()), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[0].tolist() == [0, 1, 2, 3, 4, 5] and idx[1].tolist() == [40, 41, 42, 43, 44, 45]


def test_route_drops_past_capacity_without_raising():
    """A position of C is JAX's zero one-hot row; ``F.one_hot`` would raise."""
    gates = _gates("uniform", 1, 40, 8, 0)
    d, c, _ = tmoe.route(torch.from_numpy(gates), 1, 8)
    assert d[0, :8, 0].sum() == 8 and d[0, 8:].sum() == 0  # expert 0 takes the first 8
    assert torch.equal(d.sum(-1)[0, :, 0], (torch.arange(40) < 8).float())


@pytest.mark.parametrize("T", [64, 40])
def test_capacity_matches_jax(T):
    for arch in MOE:
        for cf in (1.25, 2.0, 64.0):
            jcfg, tcfg = _cfgs(arch, capacity_factor=cf)
            assert tmoe._capacity(tcfg, T) == jmoe._capacity(jcfg, T)


# ---------------------------------------------------------------------------
# the MoE FFN


@pytest.mark.parametrize("arch,shared,router", [
    ("deepseek-v2-lite-16b", 2, "init"),   # shared experts on
    ("moonshot-v1-16b-a3b", 0, "init"),    # off
    ("deepseek-v2-lite-16b", 2, "zero"),   # every gate ties: experts 0..k-1, drops
    ("moonshot-v1-16b-a3b", 0, "zero"),
])
def test_moe_forward_matches_jax(arch, shared, router):
    jcfg, tcfg = _cfgs(arch, moe_num_shared=shared)
    jp = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.key(5), jcfg))
    if router == "zero":
        jp["router"] = np.zeros_like(jp["router"])
    assert ("shared" in jp) == bool(shared)
    tp = params_from_numpy(jp, "cpu")
    x = (np.random.default_rng(6).standard_normal((2, 96, jcfg.d_model)) * 0.5).astype(np.float32)
    jo, jaux = jmoe.moe_forward(jp, jcfg, x)  # 192 tokens: 3 groups of 64
    to, taux = tmoe.moe_forward(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **OUT)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL)
    assert tp["router"].dtype == torch.float32


def test_moe_bf16_router_stays_f32():
    jcfg, tcfg = _cfgs("deepseek-v2-lite-16b", dtype="bfloat16", param_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.key(1), jcfg))
    tp = params_from_numpy(jp, "cpu")
    assert tp["router"].dtype == torch.float32 and tp["wi"].dtype == torch.bfloat16
    mine = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg)
    assert {k: v.dtype for k, v in mine.items() if k != "shared"} == {
        "router": torch.float32, "wi": torch.bfloat16, "wg": torch.bfloat16, "wo": torch.bfloat16}
    x = jnp.asarray(np.random.default_rng(2).standard_normal((2, 64, jcfg.d_model)), jnp.bfloat16)
    jo, jaux = jmoe.moe_forward(jp, jcfg, x)
    to, taux = tmoe.moe_forward(tp, tcfg, params_from_numpy(np.asarray(x), "cpu"))
    assert to.dtype == torch.bfloat16 and taux.dtype == torch.float32
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL)
    jo = np.asarray(jo, np.float32)
    assert np.abs(to.float().numpy() - jo).max() <= 2.0**-5 * np.abs(jo).max()


def test_init_moe_layout_matches_jax():
    for arch in MOE:
        jcfg, tcfg = _cfgs(arch)
        jflat = jax.tree_util.tree_flatten_with_path(jmoe.init_moe(jax.random.key(0), jcfg))[0]
        mine = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg)
        assert [(tuple(t.shape), str(t.dtype)[6:]) for t in leaves(mine)] == [
            (j.shape, j.dtype.name) for _, j in jflat]
        std = float(mine["wi"].std())
        assert 0.8 / np.sqrt(tcfg.d_model) < std < 0.95 / np.sqrt(tcfg.d_model)  # truncated


# ---------------------------------------------------------------------------
# MLA


def test_mla_forward_three_modes():
    jcfg, tcfg = _cfgs("deepseek-v2-lite-16b")
    jp = jax.tree.map(np.asarray, ja.init_mla(jax.random.key(3), jcfg))
    tp = params_from_numpy(jp, "cpu")
    rng = np.random.default_rng(7)
    B, S = 2, 128  # attn_chunk 64: two query and two key chunks
    x = (rng.standard_normal((B, S, jcfg.d_model)) * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    for mode in ("train", "prefill"):
        jo, jc = ja.mla_forward(jp, jcfg, x, positions=pos, mode=mode)
        to, tc = ta.mla_forward(tp, tcfg, torch.from_numpy(x), positions=torch.from_numpy(pos),
                                mode=mode)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **OUT)
        if mode == "prefill":
            assert tc.keys() == jc.keys() == {"c_kv", "k_rope"}
            for key in tc:
                np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **OUT)
        else:
            assert tc is None and jc is None
    Smax, idx = 48, 40
    cc = (rng.standard_normal((B, Smax, jcfg.kv_lora_rank)) * 0.5).astype(np.float32)
    rc = (rng.standard_normal((B, Smax, jcfg.qk_rope_dim)) * 0.5).astype(np.float32)
    xt, pt = x[:, :1], np.full((B, 1), idx, np.int32)
    jo, jc = ja.mla_forward(jp, jcfg, xt, positions=pt, mode="decode",
                            cache={"c_kv": cc, "k_rope": rc}, cache_index=jnp.asarray(idx, jnp.int32))
    tcache = {"c_kv": torch.from_numpy(cc.copy()), "k_rope": torch.from_numpy(rc.copy())}
    to, tc = ta.mla_forward(tp, tcfg, torch.from_numpy(xt), positions=torch.from_numpy(pt),
                            mode="decode", cache=tcache, cache_index=idx)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **OUT)
    for key in tc:
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **OUT)
        assert tc[key] is tcache[key]  # written in place


def test_mla_out_of_range_cache_index_raises():
    """Parity rule 9 for MLA: JAX clamps and overwrites the last slot."""
    jcfg, tcfg = _cfgs("deepseek-v2-lite-16b")
    jp = jax.tree.map(np.asarray, ja.init_mla(jax.random.key(0), jcfg))
    B, Smax = 1, 8
    x = np.random.default_rng(0).standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    zc = {"c_kv": np.zeros((B, Smax, jcfg.kv_lora_rank), np.float32),
          "k_rope": np.zeros((B, Smax, jcfg.qk_rope_dim), np.float32)}
    _, jc = ja.mla_forward(jp, jcfg, x, positions=np.full((B, 1), Smax, np.int32), mode="decode",
                           cache=zc, cache_index=jnp.asarray(Smax, jnp.int32))
    jk = np.asarray(jc["c_kv"])
    assert np.all(jk[:, : Smax - 1] == 0) and np.any(jk[:, Smax - 1] != 0)
    tcache = ta.mla_init_cache(tcfg, B, Smax)
    for bad in (Smax, Smax + 3, -1):
        with pytest.raises(IndexError, match="cache_index"):
            ta.mla_forward(params_from_numpy(jp, "cpu"), tcfg, torch.from_numpy(x),
                           positions=torch.full((B, 1), bad), mode="decode", cache=tcache,
                           cache_index=bad)
    assert not any(t.any() for t in tcache.values())  # nothing written


def test_mla_cache_shape_matches_jax():
    jcfg, tcfg = jconfigs.get_config("deepseek-v2-lite-16b"), tconfigs.get_config(
        "deepseek-v2-lite-16b")
    jshp, _ = ja.mla_cache_shape(jcfg, 4, 4096)
    tshp = ta.mla_cache_shape(tcfg, 4, 4096)
    assert {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in tshp.items()} == {
        k: (v.shape, v.dtype.name) for k, v in jshp.items()}
    assert tuple(tshp["c_kv"].shape) == (4, 4096, 512) and tuple(tshp["k_rope"].shape) == (4, 4096, 64)


# ---------------------------------------------------------------------------
# lists as interior nodes: pytree and checkpoints


def _jpaths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp) for kp, _ in flat]


def test_pytree_lists_follow_jax_leaf_order():
    rng = np.random.default_rng(0)
    tree = {"z": [rng.standard_normal(2).astype(np.float32), {"b": np.ones(3, np.float32),
                                                               "a": np.zeros(1, np.float32)}],
            "a": {"y": [np.arange(4, dtype=np.float32)] * 2, "x": np.full(2, 7, np.float32)}}
    t = params_from_numpy(tree, "cpu")
    assert isinstance(t["z"], list) and isinstance(t["z"][1], dict)
    jl = jax.tree.leaves(tree)
    assert [x.tolist() for x in leaves(t)] == [x.tolist() for x in jl]
    assert key_paths(t) == _jpaths(tree) == ["a/x", "a/y/0", "a/y/1", "z/0", "z/1/a", "z/1/b"]
    np.testing.assert_array_equal(ravel(t).numpy(), np.concatenate([x.ravel() for x in jl]))
    back = unflatten_like(t, [x * 2 for x in leaves(t)])
    assert isinstance(back["a"]["y"], list) and back["z"][1]["b"].tolist() == [2, 2, 2]
    doubled = tree_map(lambda a, b: a + b, t, t)
    assert all(torch.equal(a, b) for a, b in zip(leaves(doubled), leaves(back)))
    tup = tree_map(lambda x: x, {"t": (1, 2)})  # a tuple stays a leaf
    assert tup == {"t": (1, 2)}


def test_deepseek_params_paths_match_jax():
    jcfg, _ = _cfgs("deepseek-v2-lite-16b")
    jp = jax.tree.map(np.asarray, jlm.init_params(jax.random.key(0), jcfg))
    tp = params_from_numpy(jp, "cpu")
    assert isinstance(tp["first"], list) and len(tp["first"]) == 1
    paths = key_paths(tp)
    assert paths == _jpaths(jp) == tckpt.key_paths(tp)
    assert "first/0/mixer/w_uk" in paths and "blocks/pos0/ffn/router" in paths


def _deepseek_state(podded: bool = False):
    jcfg, tcfg = _cfgs("deepseek-v2-lite-16b", param_dtype="bfloat16")
    params = jlm.init_params(jax.random.key(0), jcfg)
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    with jax.set_mesh(mesh):
        jstate = jsteps.init_train_state(jcfg, params, num_pods=2, podded=podded)
    jstate = jax.tree.map(np.asarray, jstate)
    return jstate, params_from_numpy(jstate, "cpu"), tcfg


def test_deepseek_train_state_init_matches_jax_layout():
    """The port's own ``init_train_state`` (podded too) on the list-bearing
    params gives the reference's leaves, paths, shapes and dtypes."""
    _, plain, tcfg = _deepseek_state()
    for podded in (False, True):
        jstate, _, _ = _deepseek_state(podded)
        mine = tsteps.init_train_state(tcfg, plain["params"], num_pods=2, podded=podded)
        assert key_paths(mine) == _jpaths(jstate)
        for a, b in zip(leaves(mine), jax.tree.leaves(jstate)):
            assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == str(b.dtype)


def _files(d, step):
    out = {}
    for r in range(2):
        name = os.path.join(d, f"replica_{r}", f"step_{step:08d}")
        for f in ("arrays.npz", "manifest.json"):
            with open(os.path.join(name, f), "rb") as fh:
                out[(r, f)] = fh.read()
    return out


def test_deepseek_train_state_checkpoints_byte_for_byte(tmp_path):
    """A reduced deepseek train state (a list under params, opt/m, opt/v
    and opt/master; bf16 params) saved by either package: identical files,
    SHA1 included; each package restores the other's."""
    jstate, tstate, _ = _deepseek_state()
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save(jstate, jd, step=5, replicas=2)
    tckpt.save(tstate, td, step=5, replicas=2)
    jf, tf = _files(jd, 5), _files(td, 5)
    assert jf == tf
    man = json.loads(tf[(0, "manifest.json")])
    assert man["sha1"] == hashlib.sha1(tf[(0, "arrays.npz")]).hexdigest()
    assert "params/first/0/ffn/wi" in man["paths"] and "opt/master/first/0/mixer/wq" in man["paths"]
    restored, step = tckpt.restore(tstate, jd, device="cpu")
    assert step == 5 and isinstance(restored["params"]["first"], list)
    for a, b in zip(leaves(restored), leaves(tstate)):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                                                  else a, b.view(torch.int16)
                                                  if b.dtype == torch.bfloat16 else b)
    jrestored, step = jckpt.restore(jstate, td)
    assert step == 5 and isinstance(jrestored["params"]["first"], list)
    for a, b in zip(jax.tree.leaves(jrestored), jax.tree.leaves(jstate)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
