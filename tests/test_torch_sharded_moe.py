"""The MoE family's train step sharded over a mesh's ``pod``, ``data`` and
``model`` axes (``fl/steps``' sharded step: GShard dispatch with its expert
all-to-all, MLA heads over ``model``, deepseek-v2's dense first layer),
against the JAX package's jitted step under the same shardings and
against the port's single-process step.

The harness is ``test_torch_sharded_step``'s: four gloo CPU ranks spawned
once for the module over a ``file://`` store run every case through
``launch/train.train(mesh=...)``; the reference runs in one subprocess
with four host devices, jitting its own step on the port's initial
parameters and batches, at the same time.  Grades (ROADMAP §3): every
state leaf and loss fp-tight (rtol 1e-4 / atol 1e-5) to JAX's and to the
single-process run's, AdamW's weights against JAX under the dense file's
qualification; the aux loss fp-tight to both; each leaf under
``launch/specs.cell_for``'s placements.  Exact: every top-k routing of
every MoE call, forward and remat's recompute, equal on each rank to the
single-process run's for the groups the rank holds (the groups go over
``dp``, each rank routing its own); and the dry-run's collectives of one
step (``specs.lower_cell`` on a fake process group), repeated for each
step, equal call for call to the ranks' ``CollectiveLog``, the expert
all-to-alls among them.
"""
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import test_torch_sharded_step as dense
from torch_threads import one_torch_thread  # noqa: F401
from repro_torch.config import ShapeSpec
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs, train
from repro_torch.pytree import key_paths, leaves, tree_map

sys.path.insert(0, str(dense.ROOT))
from chip_smoke import RoutingRecorder  # noqa: E402

pytestmark = pytest.mark.xdist_group("test_torch_sharded_moe")

WORLD, SEQ, BATCH, STEPS, AXES = dense.WORLD, dense.SEQ, dense.BATCH, dense.STEPS, dense.AXES
DS, MS = "deepseek-v2-lite-16b", "moonshot-v1-16b-a3b"
# (arch, mesh shape, aggregation, remat policy or None, grad_accum)
CASES = [
    (DS, (2, 2), "totoro_tree", None, 1),
    (DS, (2, 2, 1), "xla_auto", None, 1),
    (DS, (1, 4), "xla_auto", None, 1),
    (DS, (2, 2), "totoro_tree", None, 2),
    (MS, (2, 2), "xla_auto", "save_mixer_ffn", 1),
    # 2 kv heads on a model axis of 4: the kv repeat before the head split, with MoE
    (MS, (1, 4), "totoro_tree", None, 1),
]
IDS = [f"{a}-{'x'.join(map(str, s))}-{g}{f'-remat-{r}' if r else ''}"
       f"{f'-accum{n}' if n > 1 else ''}" for a, s, g, r, n in CASES]
# the cells whose dry-run is held to the ranks' collectives (IDS[1]: the
# all-to-all nested over ("pod", "data"), one exchange a mesh dim)
DRYRUN_CELLS = [IDS[0], IDS[1], IDS[5]]


def dp_coord(mesh) -> tuple[int, int]:
    """(this rank's index among the batch axes' ranks, their number): the
    ``pod`` axis outer, ``data`` inner."""
    c, n = 0, 1
    for axis in ("pod", "data"):
        if axis in mesh.mesh_dim_names:
            size = mesh.size(mesh.mesh_dim_names.index(axis))
            c, n = c * size + mesh.get_local_rank(axis), n * size
    return c, n


def _rank(rank: int, tmp: str) -> None:
    """Every case on this rank; each rank saves its routing, rank 0 its
    state, placements, losses, auxes and collectives (``tmp``)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=WORLD)
    try:
        out, routing = {}, {}
        meshes = {s: mesh_mod._mk(s, AXES[len(s)], "cpu") for s in {c[1] for c in CASES}}
        for cid, (arch, shape, agg, remat, accum) in zip(IDS, CASES):
            with RoutingRecorder() as rt, mesh_mod.CollectiveLog(meshes[shape]) as log:
                run = train.train(dense._cfg(arch, remat), dense._plan(agg, accum), steps=STEPS,
                                  seq_len=SEQ, global_batch=BATCH, device="cpu",
                                  mesh=meshes[shape], log=lambda *a: None)
            routing[cid] = {"idx": rt.idx, "dp": dp_coord(meshes[shape])}
            out[cid] = {"losses": run["losses"], "auxes": run["auxes"],
                        "state": tree_map(lambda t: t.full_tensor(), run["state"]),
                        "placements": tree_map(lambda t: tuple(t.placements), run["state"]),
                        "collectives": log.calls}
        torch.save(routing, f"{tmp}/routing{rank}.pt")
        if rank == 0:
            torch.save(out, f"{tmp}/out.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's results, every rank's routing, JAX's per case): the
    reference's subprocess runs while the ranks do."""
    tmp = tmp_path_factory.mktemp("sharded_moe")
    dense._jax_inputs(tmp, IDS, CASES)
    ref = dense.start_jax(tmp)
    try:
        mp.start_processes(_rank, args=(str(tmp),), nprocs=WORLD, start_method="spawn",
                           join=True)
        _, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-4000:]
    ranks = torch.load(tmp / "out.pt", weights_only=False)
    routing = [torch.load(tmp / f"routing{r}.pt", weights_only=False) for r in range(WORLD)]
    return ranks, routing, {cid: dict(np.load(tmp / f"{cid}_jax.npz")) for cid in IDS}


@pytest.fixture(scope="module")
def plain():
    """Each case's single-process run (the same seed and batches) and its
    routing."""
    torch.set_num_threads(1)
    out = {}
    for cid, (arch, shape, agg, remat, accum) in zip(IDS, CASES):
        with RoutingRecorder() as rt:
            run = train.train(dense._cfg(arch, remat), dense._plan(agg, accum), steps=STEPS,
                              seq_len=SEQ, global_batch=BATCH, device="cpu", log=lambda *a: None)
        out[cid] = dict(run, routing=rt.idx)
    return out


@pytest.mark.parametrize("cid", IDS)
def test_sharded_moe_step_matches_jax_and_the_single_process_step(runs, plain, cid):
    ranks, _, jax_runs = runs
    dense.assert_state_matches(ranks[cid], plain[cid], jax_runs[cid])


@pytest.mark.parametrize("cid", IDS)
def test_aux_loss_matches_jax_and_the_single_process_step(runs, plain, cid):
    """The load-balance loss, the mean over every group of the global
    batch, comes back replicated: each rank holds G / dp groups."""
    ranks, _, jax_runs = runs
    got = ranks[cid]["auxes"]
    assert all(a > 0 for a in got)
    np.testing.assert_allclose(got, plain[cid]["auxes"], **dense.TIGHT)
    np.testing.assert_allclose(got, jax_runs[cid]["auxes"], **dense.TIGHT)


@pytest.mark.parametrize("cid", IDS)
def test_every_rank_routes_its_groups_as_the_single_process_step(runs, plain, cid):
    """Every top-k call (each MoE layer's forward, and remat's recompute
    where it runs) routes each rank's groups to the experts the
    single-process step routes them to: no flip (ROADMAP §3 records any
    with its gate gap)."""
    _, routing, _ = runs
    want = plain[cid]["routing"]
    assert want
    for r, rec in enumerate(routing):
        got, (c, n) = rec[cid]["idx"], rec[cid]["dp"]
        assert len(got) == len(want), r
        for i, (a, b) in enumerate(zip(got, want)):
            g = a.shape[0]
            assert g in (b.shape[0], b.shape[0] // n), (r, i, a.shape, b.shape)
            mine = b if g == b.shape[0] else b[c * g:(c + 1) * g]
            assert torch.equal(a, mine), (r, i, int((a != mine).sum()))


@pytest.mark.parametrize("cid", IDS)
def test_state_keeps_the_cells_placements(runs, cid):
    """After the steps every leaf sits under the placements
    ``launch/specs.cell_for`` gives it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    arch, shape, agg, remat, accum = CASES[IDS.index(cid)]
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=WORLD)
    try:
        mesh = mesh_mod._mk(shape, AXES[len(shape)], "cpu")
        cell = specs.cell_for(dense._cfg(arch, remat), ShapeSpec("t", "train", SEQ, BATCH),
                              dense._plan(agg, accum), mesh)
        want = tree_map(lambda sh: tuple(sh.placements), cell.in_shardings[0])
    finally:
        dist.destroy_process_group()
    got = runs[0][cid]["placements"]
    assert key_paths(got) == key_paths(want)
    for path, a, b in zip(key_paths(want), leaves(got), leaves(want)):
        assert a == b, path


@pytest.mark.parametrize("cid", DRYRUN_CELLS)
def test_dryrun_collectives_are_the_ranks_call_for_call(runs, cid):
    """``specs.lower_cell`` of the case's cell on a fake process group (the
    dry-run's trace): its collectives of one step, repeated for each step,
    are rank 0's ``CollectiveLog`` calls (op, mesh axis, bytes, in order),
    the expert all-to-alls over ``data`` among them where ``data`` has more
    than one rank (over one rank the shard's move is a relabelling,
    ``nn._redistribute``)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    arch, shape, agg, remat, accum = CASES[IDS.index(cid)]
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=WORLD)
    try:
        mesh = mesh_mod._mk(shape, AXES[len(shape)], "cpu")
        cell = specs.cell_for(dense._cfg(arch, remat), ShapeSpec("t", "train", SEQ, BATCH),
                              dense._plan(agg, accum), mesh)
        calls = specs.lower_cell(cell, mesh)["calls"]
    finally:
        dist.destroy_process_group()
    got = runs[0][cid]["collectives"]
    assert [tuple(c) for c in calls] * STEPS == [tuple(c) for c in got]
    moved = any(op == "all_to_all_single" and axis == "data" for op, axis, _ in calls)
    assert moved == (dict(zip(AXES[len(shape)], shape))["data"] > 1)


def test_moe_layers_reach_the_expert_all_to_all_in_forward_and_backward(runs):
    """On (data 2, model 2) each MoE layer's step moves its expert inputs
    and outputs by all-to-all over ``data`` twice forward and twice
    backward: 4 a layer a step, and nothing else moves over that op."""
    from repro_torch.models import lm

    cfg = dense._cfg(DS, None)
    n_moe = sum(f == "moe" for _, f in lm.layer_pattern(cfg)) * lm.num_blocks(cfg)
    calls = runs[0][IDS[0]]["collectives"]
    a2a = [c for c in calls if c[0] == "all_to_all_single"]
    assert len(a2a) == 4 * n_moe * STEPS
    assert {c[1] for c in a2a} == {"data"}


def test_families_that_remain_raise_on_a_sharded_mesh():
    """None remains: the sharded step takes both MoE configs, the
    encoder-decoder, RWKV-6 and jamba (whose MoE layers run this file's
    dispatch beside its Mamba layers), reduced and full, under both
    aggregations."""
    from repro_torch import configs
    from repro_torch.config import RunPlan
    from repro_torch.fl import steps

    assert not hasattr(steps, "sharded_family")
    try:
        mesh = dense._fake_mesh((1, 2, 2))
        for arch in (DS, MS, "seamless-m4t-medium", "rwkv6-7b", "jamba-1.5-large-398b"):
            for get in (configs.get_reduced, configs.get_config):
                for agg in ("xla_auto", "totoro_tree"):
                    assert steps.build_train_step(get(arch), RunPlan(aggregation=agg), mesh=mesh)
    finally:
        dist.destroy_process_group()

