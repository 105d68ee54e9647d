"""The cross-pod hop over a real process group: ``fl/hierarchy.py`` and the
podded train step with one pod per rank, against the JAX package.

Two gloo CPU ranks, spawned once for the module by
``torch.multiprocessing`` over a ``file://`` store in a temporary
directory, run every case and save what they got; the tests compare it
here.  The reference's ``hierarchy`` runs under ``jax.shard_map`` over a
2-device ``pod`` mesh in a subprocess with 2 host devices.  Grades:

- the gathered int8 lattice and the scales: bit-equal to JAX's, in rank
  order; the mean fp-tight, within 2^-23 of the leaf's largest input
  (ROADMAP §3 rule 10: XLA contracts the pod sum into an FMA), and the
  FMA form of the port's lattice equal to JAX's mean exactly;
- ``cross_pod_psum``: rtol 1e-6 against JAX's ``psum / 2``;
- ``cross_pod_q8`` on each rank: bit-equal to ``steps.q8_mean_over_pods``
  on the ranks' gradients stacked;
- three steps of ``launch/train.train`` with a ``(2, 1, 1)`` mesh, at
  reduced tinyllama-1.1b and deepseek-v2-lite-16b: each rank's state
  bit-equal to ``state[p]`` of the single-process podded run, the two
  ranks to each other, and the losses equal.  Every process runs PyTorch
  on one thread, so the CPU's reductions keep one order.
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
from torch.distributed.tensor import Replicate, Shard

from torch_threads import one_torch_thread  # noqa: F401
from repro_torch import configs
from repro_torch.config import RunPlan
from repro_torch.fl import hierarchy, steps
from repro_torch.kernels import ref as tref
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train
from repro_torch.models import nn
from repro_torch.pytree import key_paths, leaves

ROOT = Path(__file__).resolve().parents[1]
PODS = 2
AXES = ("pod", "data", "model")
ARCHS = ["tinyllama-1.1b", "deepseek-v2-lite-16b"]
TRAIN = dict(steps=3, seq_len=32, global_batch=4)
Q8 = RunPlan(aggregation="totoro_tree_q8")


def _grads() -> dict:
    """Per-pod gradients (2, ...): a padded leaf, rows of other scales."""
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((2, 64, 32)).astype(np.float32),
            "b": (rng.standard_normal((2, 300)) * 1e-3).astype(np.float32),  # padded to 512
            "x": (rng.standard_normal((2, 40, 256)) * rng.random((2, 40, 1)) * 10
                  ).astype(np.float32)}


def _rank(rank: int, tmp: str) -> None:
    """One pod: every case, its results saved to ``tmp/rank{rank}.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=PODS)
    try:
        mesh = mesh_mod._mk((PODS, 1, 1), AXES, "cpu")
        group = mesh.get_group("pod")
        out = {"pod_rank": mesh.get_local_rank("pod")}
        g = {k: torch.from_numpy(v[rank]) for k, v in np.load(f"{tmp}/grads.npz").items()}
        gathered = []
        orig = hierarchy.all_gather_pods
        hierarchy.all_gather_pods = lambda t, grp: gathered.append(orig(t, grp)) or gathered[-1]
        try:
            out["q8"] = hierarchy.cross_pod_q8(g, PODS, mesh=mesh)
        finally:
            hierarchy.all_gather_pods = orig
        out["gathered"] = gathered  # per leaf in leaf order: lattice, scales
        out["stacked"] = {k: hierarchy.all_gather_pods(v, group) for k, v in g.items()}
        out["psum"] = hierarchy.cross_pod_psum(g, PODS, group=group)

        from torch.distributed.tensor import distribute_tensor
        x = distribute_tensor(torch.arange(24.0).reshape(4, 6), mesh, [Replicate()] * 3)
        nn.set_activation_axes(dp=("pod", "data"), tp="model", sizes={"pod": 2, "data": 1,
                                                                       "model": 1})
        y = nn.constrain(x, ("dp", None))
        out["constrain"] = {"placements": tuple(y.placements),
                            "local": y.to_local().clone(), "full": y.full_tensor(),
                            "unchanged": nn.constrain(y, (None, None)) is y}
        nn.set_activation_axes()

        for arch in ARCHS:
            run = train.train(configs.get_reduced(arch), Q8, device="cpu", mesh=mesh,
                              log=lambda *a: None, **TRAIN)
            out[arch] = {k: run[k] for k in ("state", "losses", "auxes")}
        out["totoro_tree"] = train.train(configs.get_reduced("tinyllama-1.1b"), RunPlan(),
                                         device="cpu", mesh=mesh, log=lambda *a: None,
                                         **TRAIN)["losses"]
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


JAX_CODE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from repro.fl import hierarchy

g = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh((2,), ("pod",), axis_types=(jax.sharding.AxisType.Auto,))
captured = []
orig = jax.lax.all_gather

def record(x, axis_name, **kw):
    y = orig(x, axis_name, **kw)
    captured.append(y)
    return y

jax.lax.all_gather = record

def hop(agg):
    def f(t):
        captured.clear()
        return agg(jax.tree.map(lambda x: x[0], t), 2), list(captured)
    return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("pod"), out_specs=P(),
                                 check_vma=False))

q8, gathered = hop(hierarchy.cross_pod_q8)(g)
psum, _ = hop(hierarchy.cross_pod_psum)(g)
out = {f"q8/{k}": np.asarray(v) for k, v in q8.items()}
out.update({f"psum/{k}": np.asarray(v) for k, v in psum.items()})
out.update({f"gathered/{i}": np.asarray(v) for i, v in enumerate(gathered)})
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pods")
    np.savez(tmp / "grads.npz", **_grads())
    mp.start_processes(_rank, args=(str(tmp),), nprocs=PODS, start_method="spawn",
                       join=True)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(PODS)]


@pytest.fixture(scope="module")
def jax_hop(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_hop")
    np.savez(tmp / "grads.npz", **_grads())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", JAX_CODE, str(tmp / "grads.npz"),
                          str(tmp / "out.npz")], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(tmp / "out.npz"))


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.detach().contiguous()
    if a.dtype.is_floating_point:
        a = a.view({2: torch.int16, 4: torch.int32}[a.element_size()])
    return a.numpy()


def test_ranks_are_the_pods_in_order(ranks):
    assert [r["pod_rank"] for r in ranks] == [0, 1]


def test_q8_lattice_and_scales_match_jax_shard_map(ranks, jax_hop):
    """Each rank's gathered rows are JAX's all_gather, bit for bit; the mean
    is fp-tight (rule 10), and XLA's FMA form of it is exact."""
    g = _grads()
    names = sorted(g)  # leaf order
    for r in ranks:
        assert len(r["gathered"]) == 2 * len(names)
        for i, k in enumerate(names):
            q, s = r["gathered"][2 * i], r["gathered"][2 * i + 1]
            jq, js = jax_hop[f"gathered/{2 * i}"], jax_hop[f"gathered/{2 * i + 1}"]
            assert q.dtype == torch.int8 and q.shape == jq.shape
            np.testing.assert_array_equal(q.numpy(), jq)
            np.testing.assert_array_equal(_bits(s), js.view(np.int32))
            want = jax_hop[f"q8/{k}"]
            got = r["q8"][k].numpy()
            assert got.shape == want.shape == g[k].shape[1:]
            assert np.abs(got - want).max() <= 2.0**-23 * np.abs(g[k]).max()
            R = q.shape[1]
            fma = tref.fma_f32(q[1].float(), s[1], q[0].float() * s[0]) / 2
            np.testing.assert_array_equal(fma.reshape(-1)[: got.size].reshape(got.shape).numpy(),
                                          want)
            assert R == -(-g[k][0].size // 256)


def test_psum_matches_jax(ranks, jax_hop):
    for r in ranks:
        for k, v in r["psum"].items():
            np.testing.assert_allclose(v.numpy(), jax_hop[f"psum/{k}"], rtol=1e-6, atol=0)


def test_q8_is_q8_mean_over_pods_of_the_stacked_grads(ranks):
    """Every rank's hop equals the single-process hop on the gradients of
    both ranks stacked in rank order, bit for bit."""
    g = _grads()
    for r in ranks:
        for k, v in r["stacked"].items():
            np.testing.assert_array_equal(v.numpy(), g[k])
        want = steps.q8_mean_over_pods(r["stacked"])
        for k in g:
            np.testing.assert_array_equal(_bits(r["q8"][k]), _bits(want[k]))


def test_constrain_redistributes_a_dtensor(ranks):
    """("dp", None) with dp = ("pod", "data"): dim 0 split over the pods;
    the full tensor unchanged; all-None dims hand the DTensor back."""
    full = torch.arange(24.0).reshape(4, 6)
    for p, r in enumerate(ranks):
        c = r["constrain"]
        assert c["placements"] == (Shard(0), Shard(0), Replicate())
        assert torch.equal(c["local"], full[2 * p: 2 * p + 2])
        assert torch.equal(c["full"], full)
        assert c["unchanged"]


@pytest.mark.parametrize("arch", ARCHS)
def test_per_rank_steps_match_the_podded_step(ranks, arch):
    """Three steps of ``train(mesh=...)`` on each rank: its state is
    ``state[p]`` of ``train(num_pods=2)``'s podded state bit for bit, the
    ranks equal each other, and the loss and aux series are the podded
    run's."""
    run = train.train(configs.get_reduced(arch), Q8, device="cpu", num_pods=PODS,
                      log=lambda *a: None, **TRAIN)
    podded = run["state"]
    for p, r in enumerate(ranks):
        mine = r[arch]
        assert key_paths(mine["state"]) == key_paths(podded)
        for path, a, b in zip(key_paths(podded), leaves(mine["state"]), leaves(podded)):
            assert a.shape == b.shape[1:] and a.dtype == b.dtype, path
            np.testing.assert_array_equal(_bits(a), _bits(b[p]), err_msg=path)
        assert mine["losses"] == run["losses"] and mine["auxes"] == run["auxes"]
    for a, b in zip(leaves(ranks[0][arch]["state"]), leaves(ranks[1][arch]["state"])):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
def test_update_in_place_is_opt_update(name):
    """The per-rank step's update, leaf by leaf into the state's own
    tensors, gives ``opt.update``'s bits on every leaf, twice running."""
    from repro_torch import optim
    from repro_torch.pytree import tree_map

    opt = {"sgd": optim.sgd(0.1, momentum=0.9, weight_decay=0.01),
           "adamw": optim.adamw(1e-2, weight_decay=0.1),
           "adafactor": optim.adafactor(1e-2, min_dim_size_to_factor=4)}[name]
    gen = torch.Generator().manual_seed(3)
    params = {"w": torch.randn(8, 16, generator=gen), "b": torch.randn(5, generator=gen),
              "n": {"e": torch.randn(3, 8, 4, generator=gen).bfloat16()}}
    want_p, want_s = params, opt.init(params)
    got_p = tree_map(lambda t: t.clone(), params)
    got_s = tree_map(lambda t: t.clone(), opt.init(params))
    for _ in range(2):
        grads = tree_map(lambda t: torch.randn(t.shape, generator=gen), params)
        want_p, want_s = opt.update(grads, want_s, want_p)
        optim.update_in_place(opt, grads, got_s, got_p)
    assert key_paths(got_s) == key_paths(want_s)
    for a, b in zip(leaves(got_p) + leaves(got_s), leaves(want_p) + leaves(want_s)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _fake_mesh(shape):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(shape)))
    return mesh_mod._mk(shape, AXES, "cpu")


def test_a_mesh_with_a_data_or_model_axis_raises():
    """What a pod sharded over ``data`` / ``model`` does not run yet: the
    q8 hop, for every family (each family's sharded step under the other
    aggregations is ``test_torch_sharded_step`` and its siblings; jamba,
    the last, ``test_torch_sharded_jamba``, builds here)."""
    try:
        for shape in ((1, 2, 1), (2, 1, 2)):
            mesh = _fake_mesh(shape)
            for arch in ("tinyllama-1.1b", "jamba-1.5-large-398b"):
                with pytest.raises(NotImplementedError, match="the q8 hop inside a sharded pod"):
                    steps.build_train_step(configs.get_reduced(arch), Q8, mesh=mesh)
            assert steps.build_train_step(configs.get_reduced("jamba-1.5-large-398b"), RunPlan(),
                                          mesh=mesh)
            dist.destroy_process_group()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_a_mesh_of_one_pod_or_another_aggregation_is_the_plain_step(ranks):
    """P = 1: the plain step's losses, bit for bit.  ``totoro_tree`` on two
    pods is the sharded step (the batch split over the pods, the gradients
    all-reduced across them): the plain step's losses, fp-tight."""
    cfg = configs.get_reduced("tinyllama-1.1b")
    plain = train.train(cfg, RunPlan(), device="cpu", log=lambda *a: None, **TRAIN)
    try:
        mesh = _fake_mesh((1, 1, 1))
        for plan in (Q8, RunPlan()):
            run = train.train(cfg, plan, device="cpu", mesh=mesh, log=lambda *a: None, **TRAIN)
            assert run["losses"] == plain["losses"]
    finally:
        dist.destroy_process_group()
    for r in ranks:
        np.testing.assert_allclose(r["totoro_tree"], plain["losses"], rtol=1e-4, atol=1e-5)


def test_train_with_a_mesh_refuses_a_checkpoint(tmp_path):
    try:
        mesh = _fake_mesh((2, 1, 1))
        with pytest.raises(NotImplementedError, match="checkpoints with a mesh"):
            train.train(configs.get_reduced("tinyllama-1.1b"), Q8, device="cpu", mesh=mesh,
                        ckpt_dir=str(tmp_path), log=lambda *a: None, **TRAIN)
    finally:
        dist.destroy_process_group()
