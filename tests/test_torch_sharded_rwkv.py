"""The RWKV-6 family's train step sharded over a mesh's ``pod``, ``data``
and ``model`` axes (``fl/steps``' sharded step: the sequence gathered once
a sublayer for the token shift, the channels and wkv heads over
``model``, the channel mix's gate at one placement), against the JAX
package's jitted step under the same shardings and against the port's
single-process step.

The harness is ``test_torch_sharded_step``'s: four gloo CPU ranks spawned
once for the module over a ``file://`` store run every case through
``launch/train.train(mesh=...)``; the reference runs in one subprocess
with four host devices, jitting its own step on the port's initial
parameters and batches, at the same time.  Every case is reduced rwkv6-7b
(2 layers, d 128: 2 wkv heads of 64, ``ssm_chunk`` 16, vocab 512) at S
64: four chunks, so the wkv state crosses chunks, and on a ``model`` axis
of 2 or 4 the token shift crosses a sequence shard.  On (data 1, model
4) each rank holds 32 channels, half a head.  Grades (ROADMAP §3):

- every state leaf and loss fp-tight (rtol 1e-4 / atol 1e-5) to JAX's and
  to the single-process run's, AdamW's weights in each of the three
  comparisons under the dense file's qualification, at first-step
  gradients under ``TINY_GRAD`` (on (pod 2, data 2, model 1) the sharded
  step sums a first-step gradient of ``w_r`` in another order than one
  process, and AdamW's first update turns it into a weight 2.5e-5 apart;
  on (data 1, model 4) JAX's own sharded step reads one element of
  ``ffn/w_v``, first-step gradient 2.03e-8, 1.2e-5 and 1.75e-5 off the
  port's sharded and single-process steps, which agree there).  Two
  steps from RWKV's constant-at-init leaves stay inside this grade, so
  the reference's wider one-ulp spread
  (``test_torch_train_recurrent.FREE_RTOL``) is not needed here;
- the gradients of one step on weights whose constant-at-init leaves
  (``mix_*``, ``decay_0``, ``bonus_u``, ``ln_*``) are redrawn from a seed
  fp-tight to one process's: at init the bonus is zero and the norm's
  scale one, so a rank reading another rank's slice of them would not
  show in the first grade;
- each leaf under ``launch/specs.cell_for``'s placements;
- the dry-run's collectives of one step (``specs.lower_cell`` on a fake
  process group), repeated for each step, equal call for call to the
  ranks' ``CollectiveLog``; the channel mix's gate product moved to the
  sequence-parallel residual by one all-to-all over ``model`` a layer
  forward and one backward.
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
from repro_torch.models import lm, nn, rwkv
from repro_torch.pytree import key_paths, leaves, tree_map

sys.path.insert(0, str(dense.ROOT))
from chip_smoke import randomised_rwkv_leaves  # noqa: E402

pytestmark = pytest.mark.xdist_group("test_torch_sharded_rwkv")

WORLD, SEQ, BATCH, STEPS, AXES = dense.WORLD, dense.SEQ, dense.BATCH, dense.STEPS, dense.AXES
RW = "rwkv6-7b"
# (arch, mesh shape, aggregation, remat policy or None, grad_accum)
CASES = [
    (RW, (2, 2), "xla_auto", None, 1),
    (RW, (2, 2), "totoro_tree", "nothing", 1),
    (RW, (2, 2, 1), "xla_auto", None, 1),
    (RW, (2, 2, 1), "totoro_tree", None, 1),
    # 2 heads on a model axis of 4: half a head a rank, whole heads gathered
    (RW, (1, 4), "xla_auto", None, 1),
    (RW, (1, 4), "totoro_tree", "save_mixer_ffn", 1),
    (RW, (2, 2), "totoro_tree", None, 2),
]
IDS = [f"{a}-{'x'.join(map(str, s))}-{g}{f'-remat-{r}' if r else ''}"
       f"{f'-accum{n}' if n > 1 else ''}" for a, s, g, r, n in CASES]
# the qualification's bound on an off element's first-step gradient: four
# times AdamW's eps, where its first update g / (|g| + eps) moves the weight
# lr eps / (|g| + eps)^2 >= lr / (25 eps) a unit of gradient, so that a
# gradient's last bits move it past atol (the dense file's 1e-8 and the
# encoder-decoder file's 2e-8 are below the 2.03e-8 that JAX's (data 1,
# model 4) step reads off both port steps, module docstring)
TINY_GRAD = 4e-8
# the cells whose dry-run is held to the ranks' collectives
DRYRUN_CELLS = [IDS[0], IDS[3], IDS[5]]
# the meshes of the redrawn leaves' gradients, and their seed
GRAD_MESHES = [(2, 2), (1, 4)]
LEAF_SEED = 37


def _redrawn_params(cfg):
    """Seed-0 parameters with every constant-at-init RWKV leaf redrawn from
    LEAF_SEED (``chip_smoke.randomised_rwkv_leaves``' draws)."""
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    randomised_rwkv_leaves(torch, params, LEAF_SEED)
    return params


def _redrawn_grads(cfg, mesh=None):
    """One step's gradients and loss on ``_redrawn_params``, on ``mesh``
    (placed by the cell's shardings, read back whole) or in one process."""
    plan = RunPlan(aggregation="xla_auto")
    params = _redrawn_params(cfg)
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


def _rank(rank: int, tmp: str) -> None:
    """Every case on this rank; rank 0 saves its state, placements, losses,
    collectives and the redrawn leaves' gradients (``tmp``)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=WORLD)
    try:
        out = {}
        meshes = {s: mesh_mod._mk(s, AXES[len(s)], "cpu")
                  for s in {c[1] for c in CASES} | set(GRAD_MESHES)}
        for cid, (arch, shape, agg, remat, accum) in zip(IDS, CASES):
            with mesh_mod.CollectiveLog(meshes[shape]) as log:
                run = train.train(dense._cfg(arch, remat), dense._plan(agg, accum), steps=STEPS,
                                  seq_len=SEQ, global_batch=BATCH, device="cpu",
                                  mesh=meshes[shape], log=lambda *a: None)
            out[cid] = {"losses": run["losses"], "auxes": run["auxes"],
                        "state": tree_map(lambda t: t.full_tensor(), run["state"]),
                        "placements": tree_map(lambda t: tuple(t.placements), run["state"]),
                        "collectives": log.calls}
        cfg = dense._cfg(RW, None)
        out["redrawn"] = {shape: _redrawn_grads(cfg, meshes[shape]) for shape in GRAD_MESHES}
        if rank == 0:
            torch.save(out, f"{tmp}/out.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's results, JAX's per case): the reference's subprocess runs
    while the ranks do."""
    tmp = tmp_path_factory.mktemp("sharded_rwkv")
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
    return ranks, {cid: dict(np.load(tmp / f"{cid}_jax.npz")) for cid in IDS}


@pytest.fixture(scope="module")
def plain():
    """Each case's single-process run (the same seed and batches)."""
    torch.set_num_threads(1)
    return {cid: train.train(dense._cfg(arch, remat), dense._plan(agg, accum), steps=STEPS,
                             seq_len=SEQ, global_batch=BATCH, device="cpu", log=lambda *a: None)
            for cid, (arch, shape, agg, remat, accum) in zip(IDS, CASES)}


@pytest.mark.parametrize("cid", IDS)
def test_sharded_rwkv_step_matches_jax_and_the_single_process_step(runs, plain, cid):
    """rtol 1e-4 / atol 1e-5 on every leaf and loss, against JAX's jitted
    sharded step and one process; AdamW's weights under the qualification
    (module docstring)."""
    ranks, jax_runs = runs
    dense.assert_state_matches(ranks[cid], plain[cid], jax_runs[cid], qualify_plain=True,
                               tiny_grad=TINY_GRAD)
    assert ranks[cid]["auxes"] == [0.0] * STEPS
    np.testing.assert_array_equal(jax_runs[cid]["auxes"], 0.0)


@pytest.mark.parametrize("shape", GRAD_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_redrawn_leaves_gradients_match_the_single_process_step(runs, shape):
    """One step's loss and every gradient leaf on weights whose
    constant-at-init leaves are redrawn, sharded against one process:
    rtol 1e-4 / atol 1e-5 (the bonus, the norm's scale and bias and
    ``decay_0`` are read as each rank's channel slice, or whole where
    ``model`` splits a head)."""
    got = runs[0]["redrawn"][shape]
    want = _redrawn_grads(dense._cfg(RW, None))
    np.testing.assert_allclose(got["loss"], want["loss"], **dense.TIGHT)
    assert key_paths(got["grads"]) == key_paths(want["grads"])
    for path, a, b in zip(key_paths(want["grads"]), leaves(got["grads"]), leaves(want["grads"])):
        assert float(b.abs().max()) > 0, path
        np.testing.assert_allclose(a.numpy(), b.numpy(), **dense.TIGHT, err_msg=path)


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
    are rank 0's ``CollectiveLog`` calls (op, mesh axis, bytes, in order)."""
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
    assert calls and [tuple(c) for c in calls] * STEPS == [tuple(c) for c in got]


@pytest.mark.parametrize("cid", [IDS[0], IDS[4]])
def test_channel_mix_gate_moves_by_one_all_to_all_over_model(runs, cid):
    """The gate's product, met at ``("dp", None, "tp")``, moves to the
    sequence-parallel residual by one all-to-all over ``model`` a layer
    forward and one backward (no remat here), and nothing else moves by
    all-to-all."""
    cfg = dense._cfg(RW, None)
    a2a = [c for c in runs[0][cid]["collectives"] if c[0] == "all_to_all_single"]
    assert len(a2a) == 2 * cfg.num_layers * STEPS
    assert {c[1] for c in a2a} == {"model"}


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_serving_on_a_mesh_raises(mode):
    """Prefill and decode of the time and the channel mix on a DTensor
    raise naming their ROADMAP item, before reading a parameter."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    cfg = dense._cfg(RW, None)
    try:
        mesh = dense._fake_mesh((1, 2, 2))
        S = 1 if mode == "decode" else SEQ
        x = distribute_tensor(torch.zeros(BATCH, S, cfg.d_model), mesh, (Replicate(),) * 3)
        for fwd in (rwkv.time_mix_forward, rwkv.channel_mix_forward):
            with pytest.raises(NotImplementedError, match="ROADMAP §1, serving on a sharded mesh"):
                fwd({}, cfg, x, mode=mode, cache=None)
    finally:
        dist.destroy_process_group()


def test_rwkv_builds_on_a_sharded_mesh_and_jamba_still_raises():
    """rwkv6-7b and jamba, the two recurrent families (reduced and full),
    build the sharded step under both aggregations; jamba no longer raises
    (``test_torch_sharded_jamba`` runs it)."""
    try:
        mesh = dense._fake_mesh((1, 2, 2))
        for get in (configs.get_reduced, configs.get_config):
            for agg in ("xla_auto", "totoro_tree"):
                plan = RunPlan(aggregation=agg)
                assert steps.build_train_step(get(RW), plan, mesh=mesh)
                assert steps.build_train_step(get("jamba-1.5-large-398b"), plan, mesh=mesh)
    finally:
        dist.destroy_process_group()
