"""The encoder-decoder family's train step sharded over a mesh's ``pod``,
``data`` and ``model`` axes (``fl/steps``' sharded step: the
sequence-parallel encoder, cross-attention heads over ``model``, the
vocab-parallel embedding, head and loss), against the JAX package's
jitted step under the same shardings and against the port's
single-process step.

The harness is ``test_torch_sharded_step``'s: four gloo CPU ranks spawned
once for the module over a ``file://`` store run every case through
``launch/train.train(mesh=...)``; the reference runs in one subprocess
with four host devices, jitting its own step on the port's initial
parameters and batches (the ``enc`` / ``dec`` stacks, ``embeds`` /
``tokens`` / ``labels``), at the same time.  Every case is reduced
seamless-m4t-medium (4 heads, 2 kv heads) with ``vocab_size`` 500,
padded to 512, so the padded columns are real.  Grades (ROADMAP §3):
every state leaf and loss fp-tight (rtol 1e-4 / atol 1e-5) to JAX's and
to the single-process run's, AdamW's weights in each of the three
comparisons (sharded, one process, JAX) under the dense file's
qualification, at first-step gradients under ``TINY_GRAD`` (on
(data 1, model 4) the sharded step sums one first-step gradient of 1.8e-9
in ``dec/self/wk`` in another order than one process, and AdamW's first
update turns its sign into a weight 1.7e-5 apart); each leaf under
``launch/specs.cell_for``'s placements; the logits' padded columns at
-1e9 on the vocab shard of every rank that holds them, the whole logits
fp-tight to one process's; and the
dry-run's collectives of one step (``specs.lower_cell`` on a fake
process group), repeated for each step, equal call for call to the
ranks' ``CollectiveLog``.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import test_torch_sharded_step as dense
from torch_threads import one_torch_thread  # noqa: F401
from repro_torch.config import RunPlan, ShapeSpec
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs, train
from repro_torch.models import encdec
from repro_torch.pytree import key_paths, leaves, tree_map

pytestmark = pytest.mark.xdist_group("test_torch_sharded_encdec")

WORLD, SEQ, BATCH, STEPS, AXES = dense.WORLD, dense.SEQ, dense.BATCH, dense.STEPS, dense.AXES
SM = "seamless-m4t-medium"
OVERRIDES = {"vocab_size": 500}  # padded to 512: 12 masked columns
# the qualification's bound on an off element's first-step gradient: twice
# AdamW's eps, where its first update g / (|g| + eps) moves lr eps / (|g| +
# eps)^2 >= lr / (9 eps) a unit of gradient, so that a gradient's last bits
# move the weight past atol.  The dense file's 1e-8 is too tight here: with
# remat the single-process step is off JAX's (0.0087051 against 0.0087173)
# at one element of dec/ffn/wg, whose first-step gradient is 1.048e-8
TINY_GRAD = 2e-8
# (arch, mesh shape, aggregation, remat policy or None, grad_accum)
CASES = [
    (SM, (2, 2), "totoro_tree", None, 1),
    (SM, (2, 2, 1), "xla_auto", None, 1),
    # 2 kv heads on a model axis of 4: k and v repeated to every query head
    # before the head split, in the self- and the cross-attention
    (SM, (1, 4), "xla_auto", None, 1),
    (SM, (2, 2), "totoro_tree", "nothing", 1),
    (SM, (2, 2), "xla_auto", None, 2),
]
IDS = [f"{a}-{'x'.join(map(str, s))}-{g}{f'-remat-{r}' if r else ''}"
       f"{f'-accum{n}' if n > 1 else ''}" for a, s, g, r, n in CASES]
# the cells whose dry-run is held to the ranks' collectives
DRYRUN_CELLS = [IDS[0], IDS[2]]
# the meshes on which each rank's shard of the logits is read
LOGIT_MESHES = [(2, 2), (1, 4)]


def _cfg(arch, remat):
    return dense._cfg(arch, remat).replace(**OVERRIDES)


def _logit_shard(mesh) -> dict:
    """This rank's shard of ``encdec.forward``'s logits on ``mesh`` (seed-0
    parameters, step 0's batch, placed by the cell's shardings): the
    vocabulary columns it holds, whether exactly the padded ones among them
    read -1e9, and the whole logits."""
    cfg = _cfg(SM, None)
    cell = specs.cell_for(cfg, ShapeSpec("t", "train", SEQ, BATCH),
                          RunPlan(aggregation="totoro_tree"), mesh)
    state_sh, batch_sh = cell.in_shardings
    params = specs.place(encdec.init_params(torch.Generator().manual_seed(0), cfg),
                         state_sh["params"])
    batch = train.make_batch(cfg, train.StreamConfig(cfg.vocab_size, SEQ, BATCH), 0, None, "cpu")
    with torch.no_grad():
        logits = encdec.forward(params, cfg, specs.place(batch, batch_sh))
    local = logits.to_local()
    width = local.shape[-1]
    start = mesh.get_local_rank("model") * width
    cols = torch.arange(start, start + width)
    masked = (local == encdec.MASKED_LOGIT).all(0).all(0)
    return {"cols": (start, start + width), "masked": masked,
            "pad_exact": bool(torch.equal(masked, cols >= cfg.vocab_size)),
            "whole": logits.full_tensor()}


def _rank(rank: int, tmp: str) -> None:
    """Every case on this rank; rank 0 saves its state, placements, losses
    and collectives, every rank its shards of the logits (``tmp``)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=WORLD)
    try:
        out, shards = {}, {}
        meshes = {s: mesh_mod._mk(s, AXES[len(s)], "cpu")
                  for s in {c[1] for c in CASES} | set(LOGIT_MESHES)}
        for cid, (arch, shape, agg, remat, accum) in zip(IDS, CASES):
            with mesh_mod.CollectiveLog(meshes[shape]) as log:
                run = train.train(_cfg(arch, remat), dense._plan(agg, accum), steps=STEPS,
                                  seq_len=SEQ, global_batch=BATCH, device="cpu",
                                  mesh=meshes[shape], log=lambda *a: None)
            out[cid] = {"losses": run["losses"], "auxes": run["auxes"],
                        "state": tree_map(lambda t: t.full_tensor(), run["state"]),
                        "placements": tree_map(lambda t: tuple(t.placements), run["state"]),
                        "collectives": log.calls}
        for shape in LOGIT_MESHES:
            shards[shape] = _logit_shard(meshes[shape])
        torch.save(shards, f"{tmp}/logits{rank}.pt")
        if rank == 0:
            torch.save(out, f"{tmp}/out.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's results, every rank's logit shards, JAX's per case): the
    reference's subprocess runs while the ranks do."""
    tmp = tmp_path_factory.mktemp("sharded_encdec")
    dense._jax_inputs(tmp, IDS, CASES, OVERRIDES)
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
    shards = [torch.load(tmp / f"logits{r}.pt", weights_only=False) for r in range(WORLD)]
    return ranks, shards, {cid: dict(np.load(tmp / f"{cid}_jax.npz")) for cid in IDS}


@pytest.fixture(scope="module")
def plain():
    """Each case's single-process run (the same seed and batches)."""
    torch.set_num_threads(1)
    return {cid: train.train(_cfg(arch, remat), dense._plan(agg, accum), steps=STEPS,
                             seq_len=SEQ, global_batch=BATCH, device="cpu", log=lambda *a: None)
            for cid, (arch, shape, agg, remat, accum) in zip(IDS, CASES)}


@pytest.mark.parametrize("cid", IDS)
def test_sharded_encdec_step_matches_jax_and_the_single_process_step(runs, plain, cid):
    ranks, _, jax_runs = runs
    dense.assert_state_matches(ranks[cid], plain[cid], jax_runs[cid], qualify_plain=True,
                               tiny_grad=TINY_GRAD)
    assert ranks[cid]["auxes"] == [0.0] * STEPS
    np.testing.assert_array_equal(jax_runs[cid]["auxes"], 0.0)


@pytest.mark.parametrize("cid", IDS)
def test_state_keeps_the_cells_placements(runs, cid):
    """After the steps every leaf sits under the placements
    ``launch/specs.cell_for`` gives it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    arch, shape, agg, remat, accum = CASES[IDS.index(cid)]
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=WORLD)
    try:
        mesh = mesh_mod._mk(shape, AXES[len(shape)], "cpu")
        cell = specs.cell_for(_cfg(arch, remat), ShapeSpec("t", "train", SEQ, BATCH),
                              dense._plan(agg, accum), mesh)
        want = tree_map(lambda sh: tuple(sh.placements), cell.in_shardings[0])
    finally:
        dist.destroy_process_group()
    got = runs[0][cid]["placements"]
    assert key_paths(got) == key_paths(want)
    for path, a, b in zip(key_paths(want), leaves(got), leaves(want)):
        assert a == b, path


@pytest.mark.parametrize("shape", LOGIT_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_padded_columns_are_masked_on_each_vocab_shard(runs, shape):
    """Every rank's vocab shard of the logits reads -1e9 on exactly the
    padded columns it holds (on (data 1, model 4) only the last rank holds
    any), and the whole logits are one process's forward's."""
    _, shards, _ = runs
    cfg = _cfg(SM, None)
    width = cfg.padded_vocab // shape[-1]
    assert [s[shape]["cols"] for s in shards] == [
        (r % shape[-1] * width, (r % shape[-1] + 1) * width) for r in range(WORLD)]
    assert all(s[shape]["pad_exact"] for s in shards)
    assert sum(int(s[shape]["masked"].sum()) for s in shards) == (
        (cfg.padded_vocab - cfg.vocab_size) * WORLD // shape[-1])
    params = encdec.init_params(torch.Generator().manual_seed(0), cfg)
    batch = train.make_batch(cfg, train.StreamConfig(cfg.vocab_size, SEQ, BATCH), 0, None, "cpu")
    with torch.no_grad():
        want = encdec.forward(params, cfg, batch)
    for s in shards:
        torch.testing.assert_close(s[shape]["whole"], want, **dense.TIGHT)


@pytest.mark.parametrize("cid", DRYRUN_CELLS)
def test_dryrun_collectives_are_the_ranks_call_for_call(runs, cid):
    """``specs.lower_cell`` of the case's cell on a fake process group (the
    dry-run's trace): its collectives of one step, repeated for each step,
    are rank 0's ``CollectiveLog`` calls (op, mesh axis, bytes, in order)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    arch, shape, agg, remat, accum = CASES[IDS.index(cid)]
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=WORLD)
    try:
        mesh = mesh_mod._mk(shape, AXES[len(shape)], "cpu")
        cell = specs.cell_for(_cfg(arch, remat), ShapeSpec("t", "train", SEQ, BATCH),
                              dense._plan(agg, accum), mesh)
        calls = specs.lower_cell(cell, mesh)["calls"]
    finally:
        dist.destroy_process_group()
    got = runs[0][cid]["collectives"]
    assert calls and [tuple(c) for c in calls] * STEPS == [tuple(c) for c in got]
