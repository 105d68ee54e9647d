"""The port's sharding specs against the JAX package's (exact grade).

Every spec function allocates nothing, so every arch runs at its full
config.  The reference's trees come from one subprocess with 512 host
devices (as ``launch/dryrun.py`` runs), dumped to JSON once per module:
spec parts as None, a name or a list of names, keyed by leaf path.  The
port's DTensor placements are held to the reference's ``NamedSharding``
shard shapes, and offsets at rank 0 and the last rank, on both production
meshes, built in this process on a fake process group of 256 or 512 ranks.
"""
import json
import os
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch import configs, optim
from repro_torch.fl import steps
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs
from repro_torch.models import attention as attn
from repro_torch.models import encdec, lm, moe, nn, rwkv, ssm
from repro_torch.pytree import key_paths, leaves

ROOT = Path(__file__).resolve().parents[1]

ARCHS = list(configs.ARCH_IDS)
SIZES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "test": {"data": 2, "model": 4},
    "test_multi_pod": {"pod": 2, "data": 2, "model": 2},
}
MESHES = {"16x16": False, "2x16x16": True}
CELLS = [(m, a, s, None) for m in MESHES for a in ARCHS for s in configs.runnable_cells(a)]
CELLS += [("2x16x16", a, "train_4k", "totoro_tree_q8") for a in ARCHS]
CACHE = (4, 64, 32)  # batch, max_len (self_len), src_len

REF_CODE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from jax.sharding import PartitionSpec as P
from repro import configs, optim
from repro.fl import steps
from repro.launch import mesh as mesh_mod, specs
from repro.models import attention as attn, encdec, lm, moe, nn, rwkv, ssm

SIZES, CELLS, CACHE = json.loads(sys.argv[2])

def spec(s):
    return [list(p) if isinstance(p, tuple) else p for p in s]

def key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)

def flat(tree):
    kv, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return {key(p): spec(v) for p, v in kv}

out = {"arch": {}, "cells": {}}
B, L, S_src = CACHE
for a in configs.ARCH_IDS:
    cfg = configs.get_config(a)
    model = encdec if cfg.is_encoder_decoder else lm
    shapes = jax.eval_shape(lambda k: model.init_params(k, cfg), jax.random.key(0))
    ps = model.param_specs(cfg)
    d = {"param_specs": flat(ps), "family": {}, "opt": {}, "resolve": {}, "fit": {}}
    fam = {"gqa": attn.gqa_specs(cfg), "gqa_cache": attn.gqa_cache_shape(cfg, B, L)[1]}
    if cfg.attn_impl == "mla":
        fam["mla"], fam["mla_cache"] = attn.mla_specs(cfg), attn.mla_cache_shape(cfg, B, L)[1]
    if cfg.moe_num_experts:
        fam["moe"] = moe.moe_specs(cfg)
    if cfg.ssm_kind == "rwkv6":
        fam["time_mix"], fam["channel_mix"] = rwkv.time_mix_specs(cfg), rwkv.channel_mix_specs(cfg)
        fam["rwkv_cache"] = rwkv.rwkv_cache_shape(cfg, B, L)[1]
    if cfg.ssm_kind == "mamba":
        fam["mamba"], fam["mamba_cache"] = ssm.mamba_specs(cfg), ssm.mamba_cache_shape(cfg, B, L)[1]
    if cfg.is_encoder_decoder:
        fam["cross"] = attn.cross_attn_specs(cfg)
        d["cache"] = flat(encdec.cache_shapes(cfg, B, L, S_src)[1])
    else:
        pairs = set(lm.layer_pattern(cfg))
        if cfg.first_dense:
            pairs.add(("mla" if cfg.attn_impl == "mla" else "attn", "dense"))
        for mixer, ffn in sorted(pairs):
            fam[f"layer/{mixer}/{ffn}"] = lm.layer_specs(cfg, mixer, ffn)
            fam[f"ffn/{ffn}"] = lm._ffn_specs(cfg, ffn)
        d["cache"] = flat(lm.cache_shapes(cfg, B, L)[1])
    d["family"] = {k: flat(v) for k, v in fam.items()}
    opts = {"sgd": optim.sgd(0.1, momentum=0.9), "sgd_plain": optim.sgd(0.1),
            "adamw": optim.adamw(1e-3), "adamw_no_master": optim.adamw(1e-3, keep_master=False),
            "adafactor": optim.adafactor(), "adafactor_2": optim.adafactor(min_dim_size_to_factor=2)}
    d["opt"] = {k: flat(o.state_specs(ps, shapes)) for k, o in opts.items()}
    for podded in (False, True):
        d[f"train_state/{podded}"] = flat(steps.train_state_specs(cfg, ps, shapes, podded=podded))
    for mp in (False, True):
        d["resolve"][str(mp)] = flat(nn.resolve_specs(ps, multi_pod=mp))
    for name, sizes in SIZES.items():
        rps = nn.resolve_specs(ps, multi_pod="pod" in sizes)
        d["fit"][name] = flat(specs.fit_specs_tree(rps, shapes, sizes))
    out["arch"][a] = d

test_sizes = {n: mesh_mod.mesh_axis_sizes(mesh_mod.make_test_mesh(multi_pod=mp))
              for n, mp in (("test", False), ("test_multi_pod", True))}
out["test_mesh_sizes"] = test_sizes
for mname, mp in (("16x16", False), ("2x16x16", True)):
    mesh = mesh_mod.make_production_mesh(multi_pod=mp)
    d0, d1 = mesh.devices.flat[0], mesh.devices.flat[-1]
    for m, a, s, agg in CELLS:
        if m != mname:
            continue
        cell = specs.build_cell(a, s, mesh, aggregation=agg)
        entry = {"aggregation": cell.plan.aggregation, "grad_accum": cell.plan.grad_accum,
                 "donate": list(cell.donate_argnums), "in": {}, "out": {}}
        for i, (arg, sh) in enumerate(zip(cell.args, cell.in_shardings)):
            kv, _ = jax.tree_util.tree_flatten_with_path(arg)
            for (p, x), ns in zip(kv, jax.tree.leaves(sh)):
                idx = ns.devices_indices_map(x.shape)
                entry["in"][f"{i}/{key(p)}"] = {
                    "shape": list(x.shape), "dtype": str(x.dtype), "spec": spec(ns.spec),
                    "shard": list(ns.shard_shape(x.shape)),
                    "first": [sl.start or 0 for sl in idx[d0]],
                    "last": [sl.start or 0 for sl in idx[d1]]}
        for i, sh in enumerate(cell.out_shardings):
            kv, _ = jax.tree_util.tree_flatten_with_path(sh)
            for p, ns in kv:
                entry["out"][f"{i}/{key(p)}"] = spec(ns.spec)
        out["cells"]["/".join([m, a, s, str(agg)])] = entry
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("specs") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", REF_CODE, str(path), json.dumps([SIZES, CELLS, CACHE])],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(path.read_text())


@pytest.fixture(autouse=True)
def reset_activation_axes():
    yield
    nn.set_activation_axes()


def spec(s):
    return [list(p) if isinstance(p, tuple) else p for p in s]


def flat(tree) -> dict:
    return {k: spec(v) for k, v in zip(key_paths(tree), leaves(tree))}


def meta_params(cfg):
    model = encdec if cfg.is_encoder_decoder else lm
    with torch.device("meta"):
        return model.init_params(torch.Generator(), cfg, device="meta")


def model_of(cfg):
    return encdec if cfg.is_encoder_decoder else lm


# ---------------------------------------------------------------------------
# spec trees, arch by arch


def test_p_reads_as_the_references_partition_spec():
    """A one-name tuple part is that name and an empty one None, as JAX
    normalises them; a spec is a tuple of its parts."""
    assert nn.P(("data",), None) == ("data", None)
    assert nn.P(("pod", "data"), "model") == (("pod", "data"), "model")
    assert nn.P((), "a") == (None, "a")
    assert nn.P() == () and nn.P(None) == (None,) and nn.P() != nn.P(None)
    assert repr(nn.P("data", None)) == "P('data', None)"


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(ref, arch):
    cfg = configs.get_config(arch)
    got = model_of(cfg).param_specs(cfg)
    assert flat(got) == ref["arch"][arch]["param_specs"]
    assert key_paths(got) == key_paths(meta_params(cfg))  # init_params' tree, leaf for leaf


@pytest.mark.parametrize("arch", ARCHS)
def test_family_specs_match_reference(ref, arch):
    """The per-family spec functions and the mixers' cache specs."""
    cfg = configs.get_config(arch)
    B, L, _ = CACHE
    fam = {"gqa": attn.gqa_specs(cfg), "gqa_cache": attn.gqa_cache_specs(cfg)}
    if cfg.attn_impl == "mla":
        fam["mla"], fam["mla_cache"] = attn.mla_specs(cfg), attn.mla_cache_specs(cfg)
    if cfg.moe_num_experts:
        fam["moe"] = moe.moe_specs(cfg)
    if cfg.ssm_kind == "rwkv6":
        fam["time_mix"], fam["channel_mix"] = rwkv.time_mix_specs(cfg), rwkv.channel_mix_specs(cfg)
        fam["rwkv_cache"] = rwkv.rwkv_cache_specs(cfg)
        assert key_paths(fam["rwkv_cache"]) == key_paths(rwkv.rwkv_cache_shape(cfg, B, L))
    if cfg.ssm_kind == "mamba":
        fam["mamba"], fam["mamba_cache"] = ssm.mamba_specs(cfg), ssm.mamba_cache_specs(cfg)
        assert key_paths(fam["mamba_cache"]) == key_paths(ssm.mamba_cache_shape(cfg, B, L))
    if cfg.is_encoder_decoder:
        fam["cross"] = attn.cross_attn_specs(cfg)
    else:
        pairs = set(lm.layer_pattern(cfg))
        if cfg.first_dense:
            pairs.add((lm._first_mixer(cfg), "dense"))
        for mixer, ffn in sorted(pairs):
            fam[f"layer/{mixer}/{ffn}"] = lm.layer_specs(cfg, mixer, ffn)
            fam[f"ffn/{ffn}"] = lm._ffn_specs(cfg, ffn)
    assert {k: flat(v) for k, v in fam.items()} == ref["arch"][arch]["family"]


@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_state_specs_match_reference(ref, arch):
    cfg = configs.get_config(arch)
    ps, shapes = model_of(cfg).param_specs(cfg), meta_params(cfg)
    opts = {"sgd": optim.sgd(0.1, momentum=0.9), "sgd_plain": optim.sgd(0.1),
            "adamw": optim.adamw(1e-3), "adamw_no_master": optim.adamw(1e-3, keep_master=False),
            "adafactor": optim.adafactor(), "adafactor_2": optim.adafactor(min_dim_size_to_factor=2)}
    got = {k: flat(o.state_specs(ps, shapes)) for k, o in opts.items()}
    assert got == ref["arch"][arch]["opt"]
    with torch.device("meta"):  # the spec tree is the state's tree
        for o in opts.values():
            assert key_paths(o.state_specs(ps, shapes)) == key_paths(o.init(shapes))


def test_adafactor_state_specs_drop_factored_axis():
    """tests/test_optim_sharding.py's case, on the port."""
    opt = optim.adafactor(min_dim_size_to_factor=2)
    ss = opt.state_specs({"w": nn.P("data", "model")},
                         {"w": torch.empty((128, 256), device="meta")})
    assert ss["v"]["w"]["vr"] == nn.P("data")
    assert ss["v"]["w"]["vc"] == nn.P("model")


@pytest.mark.parametrize("podded", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_specs_match_reference(ref, arch, podded):
    cfg = configs.get_config(arch)
    ps, shapes = model_of(cfg).param_specs(cfg), meta_params(cfg)
    got = steps.train_state_specs(cfg, ps, shapes, podded=podded)
    assert flat(got) == ref["arch"][arch][f"train_state/{podded}"]
    with torch.device("meta"):
        state = steps.init_train_state(cfg, shapes, num_pods=2, podded=podded)
    assert key_paths(got) == key_paths(state)
    for s, x in zip(leaves(got), leaves(state)):
        assert len(s) <= x.dim()


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(ref, arch):
    cfg = configs.get_config(arch)
    B, L, S_src = CACHE
    if cfg.is_encoder_decoder:
        got, shapes = encdec.cache_specs(cfg), encdec.cache_shapes(cfg, B, L, S_src)
    else:
        got, shapes = lm.cache_specs(cfg), lm.cache_shapes(cfg, B, L)
    assert flat(got) == ref["arch"][arch]["cache"]
    assert key_paths(got) == key_paths(shapes)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_specs_match_reference(ref, arch, multi_pod):
    cfg = configs.get_config(arch)
    got = nn.resolve_specs(model_of(cfg).param_specs(cfg), multi_pod=multi_pod)
    assert flat(got) == ref["arch"][arch]["resolve"][str(multi_pod)]


@pytest.mark.parametrize("sizes", list(SIZES))
@pytest.mark.parametrize("arch", ARCHS)
def test_fit_specs_tree_matches_reference(ref, arch, sizes):
    cfg = configs.get_config(arch)
    sz = SIZES[sizes]
    if sizes.startswith("test"):  # the test meshes' own axis sizes
        assert ref["test_mesh_sizes"][sizes] == sz
    rps = nn.resolve_specs(model_of(cfg).param_specs(cfg), multi_pod="pod" in sz)
    got = specs.fit_specs_tree(rps, meta_params(cfg), sz)
    assert flat(got) == ref["arch"][arch]["fit"][sizes]


# ---------------------------------------------------------------------------
# build_cell and the DTensor placements on the production meshes


@contextmanager
def fake_world(size: int, rank: int):
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _cell_entries(mesh, m: str) -> dict:
    out = {}
    for mm, a, s, agg in CELLS:
        if mm != m:
            continue
        cell = specs.build_cell(a, s, mesh, aggregation=agg)
        entry = {"aggregation": cell.plan.aggregation, "grad_accum": cell.plan.grad_accum,
                 "donate": list(cell.donate_argnums), "in": {}, "out": {}, "placements": {}}
        for i, (arg, sh) in enumerate(zip(cell.args, cell.in_shardings)):
            assert key_paths(arg) == key_paths(sh)
            for p, x, ns in zip(key_paths(arg), leaves(arg), leaves(sh)):
                assert x.is_meta and ns.mesh is mesh
                shard, first = compute_local_shape_and_global_offset(
                    tuple(x.shape), mesh, ns.placements)
                entry["in"][f"{i}/{p}"] = {
                    "shape": list(x.shape), "dtype": str(x.dtype).removeprefix("torch."),
                    "spec": spec(ns.spec), "shard": list(shard), "first": list(first)}
                entry["placements"][f"{i}/{p}"] = ns.placements
        for i, sh in enumerate(cell.out_shardings):
            for p, ns in zip(key_paths(sh), leaves(sh)):
                entry["out"][f"{i}/{p}"] = spec(ns.spec)
        out["/".join([m, a, s, str(agg)])] = entry
        nn.set_activation_axes()
    return out


@pytest.fixture(scope="module")
def port_cells():
    """Every cell built on each production mesh as rank 0, its leaves'
    local shapes and offsets there, and at the last rank."""
    out = {}
    for m, multi_pod in MESHES.items():
        n = 512 if multi_pod else 256
        with fake_world(n, 0):
            cells = _cell_entries(mesh_mod.make_production_mesh(multi_pod=multi_pod), m)
        with fake_world(n, n - 1):
            last = mesh_mod.make_production_mesh(multi_pod=multi_pod)
            assert list(last.get_coordinate()) == [s - 1 for s in last.mesh.shape]
            for entry in cells.values():
                for p, pl in entry.pop("placements").items():
                    shard, off = compute_local_shape_and_global_offset(
                        tuple(entry["in"][p]["shape"]), last, pl)
                    assert list(shard) == entry["in"][p]["shard"]
                    entry["in"][p]["last"] = list(off)
        out.update(cells)
    return out


def test_cells_cover_the_references(ref, port_cells):
    assert len(CELLS) == 2 * 32 + 10
    assert set(port_cells) == set(ref["cells"])


@pytest.mark.parametrize("cell", ["/".join(map(str, c)) for c in CELLS])
def test_build_cell_matches_reference(ref, port_cells, cell):
    """Shapes, dtypes, fitted specs, shard shapes and the offsets of rank
    0 and the last rank of every input leaf; the output specs; the plan."""
    got, want = port_cells[cell], ref["cells"][cell]
    assert {k: got[k] for k in ("aggregation", "grad_accum", "donate")} == \
        {k: want[k] for k in ("aggregation", "grad_accum", "donate")}
    assert got["out"] == want["out"]
    assert list(got["in"]) == list(want["in"])
    for p, w in want["in"].items():
        assert got["in"][p] == w, p


def test_build_cell_allocates_nothing():
    """jamba-1.5-large-398b's podded train cell: every input a meta tensor."""
    with fake_world(512, 0):
        mesh = mesh_mod.make_production_mesh(multi_pod=True)
        cell = specs.build_cell("jamba-1.5-large-398b", "train_4k", mesh,
                                aggregation="totoro_tree_q8")
        nn.set_activation_axes()
    state = leaves(cell.args[0])
    assert all(x.is_meta for x in state + leaves(cell.args[1]))
    assert sum(x.numel() for x in leaves(cell.args[0]["params"])) > 2 * 390e9


def test_placements_shard_a_dim_over_pod_then_data():
    """``("pod", "data")`` is Shard(d) on both, in mesh order; any other
    order is refused."""
    with fake_world(512, 0):
        mesh = mesh_mod.make_production_mesh(multi_pod=True)
        assert nn.placements(nn.P(("pod", "data"), "model"), mesh) == (Shard(0), Shard(0), Shard(1))
        assert nn.placements(nn.P(None, None), mesh) == (Replicate(),) * 3
        with pytest.raises(ValueError, match="mesh order"):
            nn.placements(nn.P(("data", "pod")), mesh)


def test_mesh_axis_sizes_and_num_pods():
    with fake_world(512, 0):
        for multi_pod, sizes in ((False, {"data": 16, "model": 16}),
                                 (True, {"pod": 2, "data": 16, "model": 16})):
            mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
            assert mesh_mod.mesh_axis_sizes(mesh) == sizes
            assert mesh_mod.num_pods(mesh) == sizes.get("pod", 1)
        for multi_pod, sizes in ((False, SIZES["test"]), (True, SIZES["test_multi_pod"])):
            assert mesh_mod.mesh_axis_sizes(mesh_mod.make_test_mesh(multi_pod=multi_pod)) == sizes


def test_constrain_leaves_a_plain_tensor_as_it_is():
    x = torch.randn(4, 6)
    nn.set_activation_axes(dp="data", tp="model", sizes={"data": 2, "model": 3})
    assert nn.constrain(x, ("dp", "tp")) is x
    nn.set_activation_axes()
    assert nn.constrain(x, ("dp", None)) is x
