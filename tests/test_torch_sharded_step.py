"""The dense family's train step sharded over a mesh's ``pod``, ``data``
and ``model`` axes (``fl/steps``' sharded step on DTensors), against the
JAX package's jitted step under the same shardings and against the port's
single-process step.

Four gloo CPU ranks, spawned once for the module by ``torch.multiprocessing``
over a ``file://`` store in a temporary directory, run every case through
``launch/train.train(mesh=...)`` and save the whole state
(``full_tensor()``), each leaf's placements and the losses; rank 0's copy
is compared here.  The reference runs in one subprocess with four host
devices, jitting its own ``steps.build_train_step`` with the shardings of
its ``param_specs``, ``resolve_specs``, ``fit_specs_tree`` and
``train_state_specs``, on the port's initial parameters and batches
(numpy, as ``convert.py`` carries them).  Grades (ROADMAP §3, fp-tight
after steps): every state leaf and loss within rtol 1e-4 / atol 1e-5 of
JAX's and of the port's single-process run; every leaf's placements those
of ``launch/specs.cell_for``'s ``Cell``.  One qualification, for AdamW's
parameters and master weights against JAX only: its first update is
``g / (|g| + 1e-8)``, so a gradient element of ~1e-9, where the port's and
JAX's f32 gradients differ in sign at fp-tight agreement (1e-6 of the
leaf's largest), moves a weight by up to 2 lr differently.  Those elements
are off JAX in the port's single-process step as well, and there the
sharded step is held to the single-process step alone (ROADMAP §3); they
must be at most ``OFF_SHARE`` of the leaf, each with a first-step
gradient in JAX's run (its m after step 1 over 0.1) under ``TINY_GRAD``.

The collective schedule on ``(pod 2, data 2, model 1)``, logged by
``launch/mesh.CollectiveLog`` over the same runs (by mesh axis; its
counts by op are ``CommDebugMode``'s): ``totoro_tree`` (the
parameters replicated across pods) all-reduces gradients over ``pod`` and
all-gathers nothing over it; ``xla_auto`` (FSDP over ``("pod", "data")``)
all-gathers parameters over both.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor.debug import CommDebugMode

from torch_threads import one_torch_thread  # noqa: F401
from repro_torch import configs, optim
from repro_torch.config import RunPlan, ShapeSpec
from repro_torch.fl import steps
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs, train
from repro_torch.models import nn
from repro_torch.pytree import key_paths, leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
SEQ, BATCH, STEPS = 64, 8, 2
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
# (arch, mesh shape, aggregation, remat policy or None, grad_accum)
CASES = [
    ("tinyllama-1.1b", (2, 2), "xla_auto", None, 1),
    ("tinyllama-1.1b", (2, 2), "totoro_tree", "nothing", 1),
    ("tinyllama-1.1b", (2, 2, 1), "xla_auto", None, 1),
    ("tinyllama-1.1b", (2, 2, 1), "totoro_tree", None, 1),
    ("qwen3-8b", (2, 2), "totoro_tree", "save_mixer_ffn", 1),
    ("llava-next-34b", (2, 2), "totoro_tree", None, 2),
    # a model axis wider than the kv heads (KV 2, H 4 on tp 4): k and v
    # repeated to every query head before the head split
    ("tinyllama-1.1b", (1, 4), "xla_auto", None, 1),
    ("qwen3-8b", (1, 4), "totoro_tree", None, 1),
]
IDS = [f"{a}-{'x'.join(map(str, s))}-{g}{f'-remat-{r}' if r else ''}"
       f"{f'-accum{n}' if n > 1 else ''}" for a, s, g, r, n in CASES]
OPTIMIZERS = ["sgd", "adamw", "adafactor"]
TIGHT = dict(rtol=1e-4, atol=1e-5)
# AdamW's weights off JAX in the single-process step (module docstring):
# at most this share of a leaf's elements, each with a first-step gradient
# in JAX's run under TINY_GRAD (one element of 16,384 or 65,536 in a leaf
# reads so, its gradient ~1e-9)
OFF_SHARE, TINY_GRAD = 1e-4, 1e-8


def _cfg(arch, remat):
    cfg = configs.get_reduced(arch)
    return cfg.replace(remat=True, remat_policy=remat) if remat else cfg


def _plan(aggregation, accum):
    return RunPlan(aggregation=aggregation, grad_accum=accum)


def _optimizer(name):
    return {"sgd": optim.sgd(0.1, momentum=0.9, weight_decay=0.01),
            "adamw": optim.adamw(1e-2, weight_decay=0.1),
            "adafactor": optim.adafactor(1e-2, min_dim_size_to_factor=4)}[name]


def _opt_leaves():
    """Parameters and their specs on (data 2, model 2): a factored leaf
    sharded on both its dims, a stacked one, a replicated vector."""
    gen = torch.Generator().manual_seed(5)
    params = {"w": torch.randn(8, 12, generator=gen), "s": torch.randn(3, 8, 4, generator=gen),
              "b": torch.randn(6, generator=gen)}
    pspecs = {"w": nn.P("data", "model"), "s": nn.P(None, "model", "data"), "b": nn.P(None)}
    return params, pspecs


def _rank(rank: int, tmp: str) -> None:
    """Every case on this rank; rank 0 saves what it got to ``tmp/out.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=WORLD)
    try:
        out = {}
        meshes = {s: mesh_mod._mk(s, AXES[len(s)], "cpu") for s in {c[1] for c in CASES}}
        for cid, (arch, shape, agg, remat, accum) in zip(IDS, CASES):
            with CommDebugMode() as cdm, mesh_mod.CollectiveLog(meshes[shape]) as log:
                run = train.train(_cfg(arch, remat), _plan(agg, accum), steps=STEPS,
                                  seq_len=SEQ, global_batch=BATCH, device="cpu",
                                  mesh=meshes[shape], log=lambda *a: None)
            out[cid] = {"losses": run["losses"],
                        "state": tree_map(lambda t: t.full_tensor(), run["state"]),
                        "placements": tree_map(lambda t: tuple(t.placements), run["state"]),
                        "collectives": log.calls,
                        "comm_debug": {str(k): v for k, v in cdm.get_comm_counts().items()}}
        mesh = meshes[(2, 2)]
        params, pspecs = _opt_leaves()
        shardings = nn.shardings_for(pspecs, mesh)
        for name in OPTIMIZERS:
            opt = _optimizer(name)
            p = specs.place(params, shardings)
            st = opt.init(p)
            gen = torch.Generator().manual_seed(6)
            grads = [tree_map(lambda t: torch.randn(t.shape, generator=gen), params)
                     for _ in range(2)]
            new_p, new_st = p, st
            ip = tree_map(lambda t: t.clone(), p)
            ist = tree_map(lambda t: t.clone(), st)
            for g in grads:
                new_p, new_st = opt.update(specs.place(g, shardings), new_st, new_p)
                optim.update_in_place(opt, specs.place(g, shardings), ist, ip)
            want = nn.shardings_for(opt.state_specs(pspecs, params), mesh)
            out[name] = {"want_placements": tree_map(lambda sh: tuple(sh.placements), want),
                         "init_placements": tree_map(lambda t: tuple(t.placements), st),
                         "placements": tree_map(lambda t: tuple(t.placements), new_st),
                         "params": tree_map(lambda t: t.full_tensor(), new_p),
                         "state": tree_map(lambda t: t.full_tensor(), new_st),
                         "in_place": tree_map(lambda t: t.full_tensor(), {"p": ip, "s": ist}),
                         "grads": grads}
        if rank == 0:
            torch.save(out, f"{tmp}/out.pt")
    finally:
        dist.destroy_process_group()


JAX_CODE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.config import RunPlan
from repro.fl import steps
from repro.launch import specs
from repro.models import encdec, lm, nn

tmp = sys.argv[1]
cases = eval(open(f"{tmp}/cases.txt").read())

def listed(node):  # dicts keyed 0 .. n - 1 back into lists (deepseek's first layers)
    if not isinstance(node, dict):
        return node
    node = {k: listed(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node

def nest(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(v)
    return listed(tree)

def flat(tree, prefix=""):
    out = {}
    items = enumerate(tree) if isinstance(tree, list) else ((k, tree[k]) for k in sorted(tree))
    for k, v in items:
        out.update(flat(v, f"{prefix}{k}/") if isinstance(v, (dict, list))
                   else {f"{prefix}{k}": np.asarray(v)})
    return out

for cid, arch, shape, agg, remat, accum, over in cases:
    cfg = configs.get_reduced(arch).replace(**over)
    if remat:
        cfg = cfg.replace(remat=True, remat_policy=remat)
    plan = RunPlan(aggregation=agg, grad_accum=accum)
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = jax.make_mesh(shape, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
    sizes = dict(zip(axes, shape))
    multi_pod = "pod" in sizes
    nn.set_activation_axes(dp=("pod", "data") if multi_pod else "data", tp="model",
                           sp="model", sizes=sizes)
    params = nest(dict(np.load(f"{tmp}/{cid}_params.npz")))
    batches = [dict(np.load(f"{tmp}/{cid}_batch{s}.npz")) for s in range(%(steps)d)]
    model = encdec if cfg.is_encoder_decoder else lm
    pspecs = specs.fit_specs_tree(specs.resolve(model.param_specs(cfg), multi_pod=multi_pod,
                                                pod_replicated=agg == "totoro_tree" and multi_pod),
                                  params, sizes)
    state = steps.init_train_state(cfg, params)
    sspecs = specs.fit_specs_tree(steps.train_state_specs(cfg, pspecs, params), state, sizes)
    dp = ("pod", "data") if multi_pod else ("data",)
    bspecs = {k: specs.fit_spec(P(dp, *([None] * (v.ndim - 1))), v.shape, sizes)
              for k, v in batches[0].items()}
    named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                   is_leaf=lambda x: isinstance(x, P))
    in_sh = (named(sspecs), named(bspecs))
    fn = jax.jit(steps.build_train_step(cfg, plan), in_shardings=in_sh,
                 out_shardings=(in_sh[0], NamedSharding(mesh, P())), donate_argnums=(0,))
    losses, auxes = [], []
    with jax.set_mesh(mesh):
        state = jax.device_put(state, in_sh[0])
        for b in batches:
            state, m = fn(state, jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                                                in_sh[1]))
            losses.append(float(m["loss"]))
            auxes.append(float(m["aux"]))
            if len(losses) == 1:  # AdamW's m after the first step: 0.1 g; adafactor's v:
                # g^2 + 1e-30 on a leaf it does not factor
                first_m = (flat(state["opt"]["m"], "first_m/") if "m" in state["opt"]
                           else flat(state["opt"]["v"], "first_v/"))
    np.savez(f"{tmp}/{cid}_jax.npz", losses=np.asarray(losses), auxes=np.asarray(auxes),
             **flat(state), **first_m)
""" % {"steps": STEPS}


def _jax_inputs(tmp: Path, ids=IDS, cases_in=CASES, overrides=None) -> None:
    """Each case's initial parameters (``launch/train``'s seed 0) and
    batches, as numpy for the reference: an encoder-decoder's ``enc`` /
    ``dec`` stacks and its ``embeds`` / ``tokens`` / ``labels`` batch
    too.  ``overrides``: config fields set on every case's reduced config,
    on both sides, or a list of them, one a case."""
    from repro_torch.convert import params_to_numpy
    from repro_torch.models import encdec, lm

    cases = []
    for i, (cid, (arch, shape, agg, remat, accum)) in enumerate(zip(ids, cases_in)):
        over = dict((overrides[i] if isinstance(overrides, list) else overrides) or {})
        cfg = _cfg(arch, remat).replace(**over)
        model = encdec if cfg.is_encoder_decoder else lm
        params = model.init_params(torch.Generator().manual_seed(0), cfg)
        np.savez(tmp / f"{cid}_params.npz", **dict(zip(key_paths(params),
                                                       leaves(params_to_numpy(params)))))
        sc = train.StreamConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, batch_per_shard=BATCH)
        for s in range(STEPS):
            b = train.make_batch(cfg, sc, s, None, "cpu")
            np.savez(tmp / f"{cid}_batch{s}.npz", **{k: v.numpy() for k, v in b.items()})
        cases.append((cid, arch, shape, agg, remat, accum, over))
    (tmp / "cases.txt").write_text(repr(cases))


def start_jax(tmp: Path) -> subprocess.Popen:
    """The reference's subprocess over the cases ``_jax_inputs`` wrote."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", JAX_CODE, str(tmp)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def assert_state_matches(got: dict, plain: dict, want: dict, *,
                         qualify_plain: bool = False, tiny_grad: float = TINY_GRAD) -> None:
    """A sharded run's losses and state (``got``, whole leaves) fp-tight to
    the single-process run's (``plain``) and JAX's (``want``), AdamW's
    weights to JAX under the module docstring's qualification, whose
    first-step gradients lie under ``tiny_grad``; ``qualify_plain``: to
    the single-process run's under the same qualification too (the
    sharded step sums a gradient of ~1e-9 in another order than one
    process).  Adafactor's first update of a leaf it does not factor is
    ``g / sqrt(g^2 + 1e-30)``, a sign, and its weights take the same
    qualification; their first-step gradients come from JAX's v."""
    paths = key_paths(got["state"])
    assert paths == key_paths(plain["state"])
    np.testing.assert_allclose(got["losses"], want["losses"], **TIGHT)
    np.testing.assert_allclose(got["losses"], plain["losses"], **TIGHT)
    for path, a, b in zip(paths, leaves(got["state"]), leaves(plain["state"])):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        a, b, w = a.float().numpy(), b.float().numpy(), want[path].astype(np.float32)
        leaf = path.split("/", 1)[1].removeprefix("master/")
        g1 = None  # the first-step gradient of a weight whose first update is normalised
        if path.startswith(("params/", "opt/master/")) and f"first_m/{leaf}" in want:
            g1 = np.abs(want[f"first_m/{leaf}"]) / 0.1
        elif path.startswith("params/") and f"first_v/{leaf}/v" in want:
            g1 = np.sqrt(want[f"first_v/{leaf}/v"])
        if not (g1 is not None and qualify_plain):
            np.testing.assert_allclose(a, b, **TIGHT, err_msg=path)
        if g1 is not None:
            # AdamW's weights: fp-tight to JAX wherever the single-process
            # step is (ROADMAP §3, AdamW's first update), which is off at a
            # few elements of tiny first-step gradient only
            off = ~np.isclose(b, w, **TIGHT)
            offs = [off]
            if qualify_plain:  # each comparison off at such elements alone
                offs += [~np.isclose(a, b, **TIGHT), ~np.isclose(a, w, **TIGHT)]
            for o in offs:
                assert o.sum() <= OFF_SHARE * o.size, (path, int(o.sum()), o.size)
                assert (g1[o] < tiny_grad).all(), (path, g1[o])
            if not qualify_plain:
                np.testing.assert_allclose(a[~off], w[~off], **TIGHT, err_msg=path)
        else:
            np.testing.assert_allclose(a, w, **TIGHT, err_msg=path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, JAX's per case): the reference's subprocess
    runs while the ranks do."""
    tmp = tmp_path_factory.mktemp("sharded")
    _jax_inputs(tmp)
    ref = start_jax(tmp)
    try:
        mp.start_processes(_rank, args=(str(tmp),), nprocs=WORLD, start_method="spawn",
                           join=True)
        _, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-4000:]
    ranks = torch.load(tmp / "out.pt", weights_only=False)
    return ranks, {cid: dict(np.load(tmp / f"{cid}_jax.npz")) for cid in IDS}


@pytest.fixture(scope="module")
def plain():
    """Each case's single-process run (the same seed and batches)."""
    torch.set_num_threads(1)
    return {cid: train.train(_cfg(arch, remat), _plan(agg, accum), steps=STEPS, seq_len=SEQ,
                             global_batch=BATCH, device="cpu", log=lambda *a: None)
            for cid, (arch, shape, agg, remat, accum) in zip(IDS, CASES)}


@pytest.mark.parametrize("cid", IDS)
def test_sharded_step_matches_jax_and_the_single_process_step(runs, plain, cid):
    ranks, jax_runs = runs
    assert_state_matches(ranks[cid], plain[cid], jax_runs[cid])


@pytest.mark.parametrize("cid", IDS)
def test_state_keeps_the_cells_placements(runs, cid):
    """The donated in/out contract: after the steps every leaf sits under
    the placements ``launch/specs.cell_for`` gives it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    arch, shape, agg, remat, accum = CASES[IDS.index(cid)]
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=WORLD)
    try:
        mesh = mesh_mod._mk(shape, AXES[len(shape)], "cpu")
        cell = specs.cell_for(_cfg(arch, remat), ShapeSpec("t", "train", SEQ, BATCH),
                              _plan(agg, accum), mesh)
        want = tree_map(lambda sh: tuple(sh.placements), cell.in_shardings[0])
    finally:
        dist.destroy_process_group()
    got = runs[0][cid]["placements"]
    assert key_paths(got) == key_paths(want)
    for path, a, b in zip(key_paths(want), leaves(got), leaves(want)):
        assert a == b, path


def _schedule(runs, agg):
    """(op, mesh axis) -> count over the (pod 2, data 2, model 1) run's two
    steps, as ``CollectiveLog`` split them; their totals by op are
    ``CommDebugMode``'s counts of the same run."""
    run = runs[0][[c for c in IDS if "2x2x1" in c and c.endswith(agg)][0]]
    counts, totals = {}, {}
    for op, axis, _ in run["collectives"]:
        counts[op, axis] = counts.get((op, axis), 0) + 1
        totals[f"c10d_functional.{op}"] = totals.get(f"c10d_functional.{op}", 0) + 1
    assert totals == run["comm_debug"]
    return counts


def test_totoro_tree_reduces_across_pods_and_gathers_no_parameter_across_them(runs):
    """The paper's tree: inside a zone the parameters are gathered over
    ``data`` and their gradients reduce-scattered back; across zones the
    gradients are all-reduced over ``pod``, and nothing is gathered."""
    counts = _schedule(runs, "totoro_tree")
    assert counts.get(("all_reduce", "pod"), 0) > 0
    assert counts.get(("all_gather_into_tensor", "pod"), 0) == 0
    assert counts.get(("all_gather_into_tensor", "data"), 0) > 0
    assert counts.get(("reduce_scatter_tensor", "data"), 0) > 0


def test_xla_auto_gathers_parameters_over_pod_and_data(runs):
    """The centralised baseline: FSDP over ``("pod", "data")``, so every
    use of a weight gathers it across pods as well."""
    tree = _schedule(runs, "totoro_tree")
    counts = _schedule(runs, "xla_auto")
    assert counts.get(("all_gather_into_tensor", "pod"), 0) > 0
    assert counts.get(("all_gather_into_tensor", "data"), 0) > 0
    assert counts.get(("reduce_scatter_tensor", "pod"), 0) > 0
    assert (counts[("all_gather_into_tensor", "data")]
            == tree[("all_gather_into_tensor", "data")])


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizers_update_dtensor_leaves(runs, name):
    """``opt.init`` on DTensor parameters places the state as
    ``state_specs`` says; two updates (and ``update_in_place``) give the
    plain update's values, the elementwise optimizers bit for bit."""
    got = runs[0][name]
    opt = _optimizer(name)
    params, _ = _opt_leaves()
    state = opt.init(params)
    for grads in got["grads"]:
        params, state = opt.update(grads, state, params)
    assert got["init_placements"] == got["placements"] == got["want_placements"]
    tol = dict(rtol=0, atol=0) if name != "adafactor" else TIGHT
    for a, b in zip(leaves(got["params"]) + leaves(got["state"]), leaves(params) + leaves(state)):
        torch.testing.assert_close(a, b, **tol)
    for a, b in zip(leaves(got["in_place"]["p"]) + leaves(got["in_place"]["s"]),
                    leaves(got["params"]) + leaves(got["state"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _fake_mesh(shape, axes=("pod", "data", "model")):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=int(np.prod(shape)))
    return mesh_mod._mk(shape, axes, "cpu")


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b"])
def test_other_families_on_a_sharded_mesh_raise(arch):
    """No family is left outside the sharded step: jamba, the last, builds
    it under both aggregations, and raises only where every family does,
    the q8 hop inside a sharded pod (ROADMAP §1)."""
    try:
        mesh = _fake_mesh((1, 2, 2))
        for agg in ("xla_auto", "totoro_tree"):
            assert steps.build_train_step(configs.get_reduced(arch), RunPlan(aggregation=agg),
                                          mesh=mesh)
        with pytest.raises(NotImplementedError, match="the q8 hop inside a sharded pod"):
            steps.build_train_step(configs.get_reduced(arch), RunPlan(aggregation="totoro_tree_q8"),
                                   mesh=mesh)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shape", [(1, 1, 2), (2, 1, 2), (1, 2, 1)])
def test_q8_on_a_sharded_pod_raises(shape):
    try:
        mesh = _fake_mesh(shape)
        with pytest.raises(NotImplementedError, match="the q8 hop inside a sharded pod"):
            steps.build_train_step(configs.get_reduced("tinyllama-1.1b"),
                                   RunPlan(aggregation="totoro_tree_q8"), mesh=mesh)
    finally:
        dist.destroy_process_group()
