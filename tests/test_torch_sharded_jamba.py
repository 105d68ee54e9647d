"""jamba's train step sharded over a mesh's ``pod``, ``data`` and ``model``
axes (``fl/steps``' sharded step: attention, Mamba, dense and MoE layers
in one pattern; Mamba's channels over ``model``, ``in_proj``'s x and z
halves made alike, the chunk loop on each rank's channels), against the
JAX package's jitted step under the same shardings and against the port's
single-process step.

The harness is ``test_torch_sharded_step``'s: four gloo CPU ranks spawned
once for the module over a ``file://`` store run every case through
``launch/train.train(mesh=...)``; the reference runs in one subprocess
with four host devices, jitting its own step on the port's initial
parameters and batches, at the same time.  Reduced jamba (d 128, d_inner
256, 8 experts of which 2 a token, adafactor, ``ssm_chunk`` 16) at S 64,
four chunks, is cut to the pair of one ``("attn", "dense")`` and one
``("mamba", "moe")`` layer (``attn_every`` = ``moe_every`` = 2), or kept
at its own 8-layer pattern block in one case.  Grades (ROADMAP §3):

- every state leaf and loss fp-tight (rtol 1e-4 / atol 1e-5) to JAX's and
  to the single-process run's; adafactor's first update of a leaf it does
  not factor (an expert stack, a vector) is the gradient's sign, so its
  weights take the dense file's AdamW qualification in each of the three
  comparisons: off only at elements whose first-step gradient is under
  1e-8 (at the 8-layer block one element of an expert stack's 65,536,
  gradient ~1e-10, flips between the sharded and the one-process sum);
- the gradients of one step on weights whose constant-at-init Mamba
  leaves (``conv_b``, ``D``, ``dt_b``, ``A_log``) are redrawn from a seed
  fp-tight to one process's: at init ``D`` is all ones and ``A_log``'s
  rows alike, so a rank reading another rank's channel slice of them
  would not show in the first grade;
- each leaf under ``launch/specs.cell_for``'s placements;
- each rank's x and z channels of ``in_proj`` (after ``ssm._HalvesAlike``)
  those of its ``conv_w`` slice;
- the dry-run's collectives of one step (``specs.lower_cell`` on a fake
  process group), repeated for each step, equal call for call to the
  ranks' ``CollectiveLog``, ``in_proj``'s all-to-all over ``model`` among
  them;
- an MoE layer whose capacity slots ``dp`` does not divide (jamba's 80 on
  2x16x16's 32 batch ranks; here a capacity of 26 on (2, 2, 1)'s 4) keeps
  each rank's groups' tokens, moves none by all-to-all, and gives one
  process's loss and gradients.
"""
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import test_torch_sharded_step as dense
from torch_threads import one_torch_thread  # noqa: F401
from repro_torch import configs
from repro_torch.config import RunPlan, ShapeSpec
from repro_torch.fl import steps
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs, train
from repro_torch.models import lm, moe, nn, ssm
from repro_torch.pytree import key_paths, leaves, tree_map

sys.path.insert(0, str(dense.ROOT))
from chip_smoke import randomised_mamba_leaves  # noqa: E402

pytestmark = pytest.mark.xdist_group("test_torch_sharded_jamba")

WORLD, SEQ, BATCH, STEPS, AXES = dense.WORLD, dense.SEQ, dense.BATCH, dense.STEPS, dense.AXES
JB = "jamba-1.5-large-398b"
PAIR = {"num_layers": 2, "attn_every": 2, "moe_every": 2}  # ("attn", "dense"), ("mamba", "moe")
BLOCK = {"num_layers": 8}  # the reduced config's own pattern block: 1 attention, 7 Mamba
# (mesh shape, aggregation, remat policy or None, grad_accum, config overrides)
CASES = [
    ((2, 2), "xla_auto", None, 1, PAIR),
    ((2, 2), "totoro_tree", "nothing", 1, PAIR),
    ((2, 2, 1), "xla_auto", None, 1, PAIR),
    ((2, 2, 1), "totoro_tree", None, 1, PAIR),
    ((1, 4), "xla_auto", None, 1, PAIR),
    ((1, 4), "totoro_tree", "save_mixer_ffn", 1, PAIR),
    ((2, 2), "totoro_tree", None, 2, PAIR),
    ((2, 2), "totoro_tree", None, 1, BLOCK),
]
IDS = [f"{'x'.join(map(str, s))}-{g}{f'-remat-{r}' if r else ''}{f'-accum{n}' if n > 1 else ''}"
       f"-{o['num_layers']}layers" for s, g, r, n, o in CASES]
# the cells whose dry-run is held to the ranks' collectives (a (2, 2, 1)
# cell's sharding propagation costs a fake run ~25 s, and its model axis
# of 1 moves no halves)
DRYRUN_CELLS = [IDS[0], IDS[5], IDS[6]]
# the meshes of the redrawn leaves' gradients and of the channel offsets, and the seed
GRAD_MESHES = [(2, 2), (1, 4)]
LEAF_SEED = 37
# the mesh and capacity of the slots that do not split over dp: 24 + 2 slots
# on (2, 2, 1)'s 4 batch ranks
UNEVEN, UNEVEN_EXTRA_SLOTS = (2, 2, 1), 2


def _cfg(cid):
    shape, agg, remat, accum, over = CASES[IDS.index(cid)]
    return dense._cfg(JB, remat).replace(**over)


def _uneven_slots_grads(mesh=None):
    """``_redrawn_grads`` with every MoE layer's capacity UNEVEN_EXTRA_SLOTS
    above the config's (the same on both sides), and the collectives on a
    mesh."""
    capacity = moe._capacity
    moe._capacity = lambda cfg, tokens: capacity(cfg, tokens) + UNEVEN_EXTRA_SLOTS
    try:
        if mesh is None:
            return _redrawn_grads()
        with mesh_mod.CollectiveLog(mesh) as log:
            out = _redrawn_grads(mesh)
        return {**out, "collectives": log.calls}
    finally:
        moe._capacity = capacity


def _redrawn_grads(mesh=None):
    """One step's gradients and loss at the pair's cut, on seed-0 weights
    with every constant-at-init Mamba leaf redrawn from LEAF_SEED, on
    ``mesh`` (placed by the cell's shardings, read back whole) or in one
    process."""
    cfg = dense._cfg(JB, None).replace(**PAIR)
    plan = RunPlan(aggregation="xla_auto")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    randomised_mamba_leaves(torch, params, LEAF_SEED)
    batch = train.make_batch(cfg, train.StreamConfig(cfg.vocab_size, SEQ, BATCH), 0, None, "cpu")
    if mesh is None:
        grads, m = steps.grads_and_metrics(cfg, plan, params, batch)
        return {"grads": grads, "loss": float(m["loss"])}
    state_sh, batch_sh = specs.cell_for(cfg, ShapeSpec("t", "train", SEQ, BATCH), plan,
                                        mesh).in_shardings
    nn.set_activation_axes(**nn.mesh_activation_axes(dict(zip(mesh.mesh_dim_names,
                                                               mesh.mesh.shape))))
    grads, m = steps.grads_and_metrics(cfg, plan, specs.place(params, state_sh["params"]),
                                       specs.place(batch, batch_sh))
    return {"grads": tree_map(lambda t: t.full_tensor(), grads),
            "loss": float(m["loss"].full_tensor())}


def _channels(mesh):
    """This rank's channels of ``in_proj``'s x and z halves after
    ``ssm._HalvesAlike`` and of ``conv_w``, both placed by the pair's cell
    (``totoro_tree``), each column holding its own index."""
    cfg = dense._cfg(JB, None).replace(**PAIR)
    di = ssm.d_inner(cfg)
    state_sh, _ = specs.cell_for(cfg, ShapeSpec("t", "train", SEQ, BATCH),
                                 RunPlan(aggregation="totoro_tree"), mesh).in_shardings
    sh = state_sh["params"]["blocks"]["pos1"]["mixer"]

    def indexed(n, rows, spec):  # a stacked leaf whose every column holds its index
        return specs.place(torch.arange(n, dtype=torch.float32).repeat(1, rows, 1), spec)[0]

    w, conv = indexed(2 * di, cfg.d_model, sh["in_proj"]), indexed(di, cfg.d_conv, sh["conv_w"])
    nn.set_activation_axes(**nn.mesh_activation_axes(dict(zip(mesh.mesh_dim_names,
                                                               mesh.mesh.shape))))
    w_in, alike = ssm._in_proj(w, di)
    x, z = w_in.to_local().chunk(2, dim=-1)  # every row alike: each column's index
    assert (x == x[:1]).all() and (z == z[:1]).all()
    x, z = x[0], z[0]
    return {"alike": alike, "x": x.long().tolist(), "z": (z - di).long().tolist(),
            "conv_w": conv.to_local()[0].long().tolist()}


def _rank(rank: int, tmp: str) -> None:
    """Every case on this rank; rank 0 saves its state, placements, losses,
    collectives and the redrawn leaves' gradients, every rank its channels
    (``tmp``)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=WORLD)
    try:
        out = {}
        meshes = {s: mesh_mod._mk(s, AXES[len(s)], "cpu")
                  for s in {c[0] for c in CASES} | set(GRAD_MESHES)}
        for cid, (shape, agg, remat, accum, over) in zip(IDS, CASES):
            with mesh_mod.CollectiveLog(meshes[shape]) as log:
                run = train.train(_cfg(cid), dense._plan(agg, accum), steps=STEPS, seq_len=SEQ,
                                  global_batch=BATCH, device="cpu", mesh=meshes[shape],
                                  log=lambda *a: None)
            out[cid] = {"losses": run["losses"], "auxes": run["auxes"],
                        "state": tree_map(lambda t: t.full_tensor(), run["state"]),
                        "placements": tree_map(lambda t: tuple(t.placements), run["state"]),
                        "collectives": log.calls}
        out["redrawn"] = {shape: _redrawn_grads(meshes[shape]) for shape in GRAD_MESHES}
        out["uneven"] = _uneven_slots_grads(meshes[UNEVEN])
        channels = {shape: _channels(meshes[shape]) for shape in GRAD_MESHES}
        torch.save(channels, f"{tmp}/channels{rank}.pt")
        if rank == 0:
            torch.save(out, f"{tmp}/out.pt")
    finally:
        dist.destroy_process_group()


def _fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=WORLD)


def _here() -> dict:
    """What this process computes while the ranks and the reference run:
    each case's single-process run, the redrawn leaves' gradients in one
    process, and on a fake process group each case's ``cell_for``
    placements and the dry-run's collectives of DRYRUN_CELLS."""
    torch.set_num_threads(1)
    out = {"plain": {cid: train.train(_cfg(cid), dense._plan(c[1], c[3]), steps=STEPS,
                                      seq_len=SEQ, global_batch=BATCH, device="cpu",
                                      log=lambda *a: None) for cid, c in zip(IDS, CASES)},
           "redrawn": _redrawn_grads(), "uneven": _uneven_slots_grads(), "placements": {},
           "calls": {}}
    _fake_world()
    try:
        meshes = {s: mesh_mod._mk(s, AXES[len(s)], "cpu") for s in {c[0] for c in CASES}}
        for cid, (shape, agg, remat, accum, over) in zip(IDS, CASES):
            cell = specs.cell_for(_cfg(cid), ShapeSpec("t", "train", SEQ, BATCH),
                                  dense._plan(agg, accum), meshes[shape])
            out["placements"][cid] = tree_map(lambda sh: tuple(sh.placements),
                                              cell.in_shardings[0])
            if cid in DRYRUN_CELLS:
                out["calls"][cid] = specs.lower_cell(cell, meshes[shape])["calls"]
    finally:
        dist.destroy_process_group()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Rank 0's results, JAX's per case, every rank's channels and
    ``_here``'s: the reference runs in two subprocesses (the 8-layer case
    in one of its own) while the ranks run and this process computes
    ``_here``."""
    tmp = tmp_path_factory.mktemp("sharded_jamba")
    parts = [[i for i, c in enumerate(CASES) if c[-1] is not BLOCK],
             [i for i, c in enumerate(CASES) if c[-1] is BLOCK]]
    refs = []
    try:
        for n, part in enumerate(parts):
            (tmp / f"jax{n}").mkdir()
            dense._jax_inputs(tmp / f"jax{n}", [IDS[i] for i in part],
                              [(JB, *CASES[i][:4]) for i in part],
                              overrides=[CASES[i][-1] for i in part])
            refs.append(dense.start_jax(tmp / f"jax{n}"))
        ctx = mp.start_processes(_rank, args=(str(tmp),), nprocs=WORLD, start_method="spawn",
                                 join=False)
        here = _here()
        while not ctx.join():
            pass
        errs = [ref.communicate(timeout=600)[1] for ref in refs]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
    for ref, err in zip(refs, errs):
        assert ref.returncode == 0, err[-4000:]
    jax_runs = {IDS[i]: dict(np.load(tmp / f"jax{n}" / f"{IDS[i]}_jax.npz"))
                for n, part in enumerate(parts) for i in part}
    return {"ranks": torch.load(tmp / "out.pt", weights_only=False), "jax": jax_runs,
            "channels": [torch.load(tmp / f"channels{r}.pt", weights_only=False)
                         for r in range(WORLD)], **here}


@pytest.mark.parametrize("cid", IDS)
def test_sharded_jamba_step_matches_jax_and_the_single_process_step(runs, cid):
    """rtol 1e-4 / atol 1e-5 on every leaf, loss and MoE aux loss, against
    JAX's jitted sharded step and one process."""
    got, plain, want = runs["ranks"][cid], runs["plain"][cid], runs["jax"][cid]
    dense.assert_state_matches(got, plain, want, qualify_plain=True)
    np.testing.assert_allclose(got["auxes"], plain["auxes"], **dense.TIGHT)
    np.testing.assert_allclose(got["auxes"], want["auxes"], **dense.TIGHT)
    assert min(got["auxes"]) > 0


@pytest.mark.parametrize("shape", GRAD_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_redrawn_leaves_gradients_match_the_single_process_step(runs, shape):
    """One step's loss and every gradient leaf on weights whose
    constant-at-init Mamba leaves are redrawn, sharded against one
    process: rtol 1e-4 / atol 1e-5 (``conv_b``, ``D``, ``dt_b`` and
    ``A_log`` are read as each rank's channel slice)."""
    got, want = runs["ranks"]["redrawn"][shape], runs["redrawn"]
    np.testing.assert_allclose(got["loss"], want["loss"], **dense.TIGHT)
    assert key_paths(got["grads"]) == key_paths(want["grads"])
    for path, a, b in zip(key_paths(want["grads"]), leaves(got["grads"]), leaves(want["grads"])):
        assert float(b.abs().max()) > 0, path
        np.testing.assert_allclose(a.numpy(), b.numpy(), **dense.TIGHT, err_msg=path)


def test_capacity_slots_that_do_not_split_over_dp_keep_each_ranks_groups(runs):
    """With a capacity that the batch ranks do not divide, the sharded
    step's loss and every gradient leaf are one process's (rtol 1e-4 /
    atol 1e-5), and no expert token moves by all-to-all (the same mesh at
    the config's own capacity moves them over ``pod`` and ``data``)."""
    cfg = dense._cfg(JB, None).replace(**PAIR)
    dp = UNEVEN[0] * UNEVEN[1]
    C = moe._capacity(cfg, min(cfg.moe_group_size, BATCH * SEQ))
    assert C % dp == 0 and (C + UNEVEN_EXTRA_SLOTS) % dp
    got, want = runs["ranks"]["uneven"], runs["uneven"]
    np.testing.assert_allclose(got["loss"], want["loss"], **dense.TIGHT)
    assert key_paths(got["grads"]) == key_paths(want["grads"])
    for path, a, b in zip(key_paths(want["grads"]), leaves(got["grads"]), leaves(want["grads"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **dense.TIGHT, err_msg=path)
    assert not [c for c in got["collectives"] if c[0] == "all_to_all_single"]
    even = runs["ranks"][IDS[2]]["collectives"]  # (2, 2, 1) at the config's capacity
    assert {c[1] for c in even if c[0] == "all_to_all_single"} == {"pod", "data"}


@pytest.mark.parametrize("shape", GRAD_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_each_rank_holds_the_same_channels_of_x_z_and_conv_w(runs, shape):
    """After ``_HalvesAlike`` each rank's columns of ``in_proj`` are x's and
    z's channels [t w, (t + 1) w) for its ``model`` coordinate t, its
    ``conv_w`` slice's channels; the ranks together hold every channel."""
    cfg = dense._cfg(JB, None).replace(**PAIR)
    di, T = ssm.d_inner(cfg), shape[-1]
    seen = set()
    for rank, channels in enumerate(runs["channels"]):
        got = channels[shape]
        t = rank % T  # row-major ranks: model is the last mesh axis
        want = list(range(t * di // T, (t + 1) * di // T))
        assert got["alike"]
        assert got["conv_w"] == want
        assert got["x"] == want and got["z"] == want
        seen.update(want)
    assert seen == set(range(di))


@pytest.mark.parametrize("cid", IDS)
def test_state_keeps_the_cells_placements(runs, cid):
    """After the steps every leaf sits under the placements
    ``launch/specs.cell_for`` gives it."""
    got, want = runs["ranks"][cid]["placements"], runs["placements"][cid]
    assert key_paths(got) == key_paths(want)
    for path, a, b in zip(key_paths(want), leaves(got), leaves(want)):
        assert a == b, path


@pytest.mark.parametrize("cid", DRYRUN_CELLS)
def test_dryrun_collectives_are_the_ranks_call_for_call(runs, cid):
    """``specs.lower_cell`` of the case's cell on a fake process group (the
    dry-run's trace): its collectives of one step, repeated for each step,
    are rank 0's ``CollectiveLog`` calls (op, mesh axis, bytes, in order);
    where ``model`` is larger than 1, ``in_proj``'s halves move by one
    all-to-all over it a Mamba layer and microbatch forward, one in remat's
    recompute and one backward."""
    shape, agg, remat, accum, over = CASES[IDS.index(cid)]
    calls, got = runs["calls"][cid], runs["ranks"][cid]["collectives"]
    assert calls and [tuple(c) for c in calls] * STEPS == [tuple(c) for c in got]
    a2a = [c for c in got if c[:2] == ("all_to_all_single", "model")]
    assert len(a2a) == ((2 + (remat is not None)) * accum * STEPS if shape[-1] > 1 else 0)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_serving_on_a_mesh_raises(mode):
    """Prefill and decode of the Mamba layer on a DTensor raise naming
    their ROADMAP item, before reading a parameter."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    cfg = dense._cfg(JB, None)
    try:
        mesh = dense._fake_mesh((1, 2, 2))
        S = 1 if mode == "decode" else SEQ
        x = distribute_tensor(torch.zeros(BATCH, S, cfg.d_model), mesh, (Replicate(),) * 3)
        with pytest.raises(NotImplementedError, match="ROADMAP §1, serving on a sharded mesh"):
            ssm.mamba_forward({}, cfg, x, mode=mode, cache=None)
    finally:
        dist.destroy_process_group()


def test_jamba_builds_on_a_sharded_mesh():
    """jamba, reduced and at full width, builds the sharded step under both
    aggregations; ``sharded_family`` is gone with the last family it
    kept out."""
    assert not hasattr(steps, "sharded_family")
    try:
        mesh = dense._fake_mesh((1, 2, 2))
        for get in (configs.get_reduced, configs.get_config):
            for agg in ("xla_auto", "totoro_tree"):
                assert steps.build_train_step(get(JB), RunPlan(aggregation=agg), mesh=mesh)
    finally:
        dist.destroy_process_group()
