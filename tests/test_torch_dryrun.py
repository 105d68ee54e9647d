"""The dry-run tools of the port (``launch/hlo.py``, ``specs.lower_cell``,
``launch/dryrun.py``, ``launch/sweep.py``) against the JAX package's.

Every fake process group lives inside ``dryrun.run_cell`` or
``fake_world`` and is destroyed on the way out.  The small-mesh cells
run in ``tools/dryrun_vs_reference.py``'s subprocesses, all four at once,
started when the module's first test runs and read by the last tests:
the reference's (``memory_analysis()`` and ``hlo.analyze_module`` of its
compiled step, 8 host devices) and the port's (``launch/dryrun``'s
command line, a cell each).  The module runs in one pytest-xdist worker
under ``--dist loadfile`` (the repo's command) or ``loadgroup`` (its
``xdist_group``); under the default ``load`` each worker that gets one of
its tests would start the subprocesses again.
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

from torch_threads import one_torch_thread  # noqa: F401
from repro_torch import configs
from repro_torch.config import SHAPES, RunPlan, ShapeSpec
from repro_torch.fl import steps
from repro_torch.launch import dryrun, hlo, specs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import encdec, lm
from repro_torch.pytree import leaves

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
import chip_smoke  # noqa: E402
import dryrun_vs_reference as vs_ref  # noqa: E402

pytestmark = pytest.mark.xdist_group("test_torch_dryrun")

LAYERS = 2  # tinyllama-1.1b at full width, cut to two layers on the test meshes
# XLA's output_size_in_bytes also counts the output tuple's table, 8 bytes a
# leaf (the state's and the two metrics)
TUPLE_BYTES_A_LEAF = 8


def kv_projection_flops(cfg, tokens: int) -> int:
    """The FLOPs of a step's wk and wv products over ``tokens`` tokens: the
    forward, remat's recompute where ``cfg.remat``, and backward's two."""
    one = 2 * tokens * cfg.d_model * cfg.num_kv_heads * cfg.head_dim
    return 2 * cfg.num_layers * (3 + int(cfg.remat)) * one


def replicated_kv_flops_per_dev(cfg, tokens: int, sizes: dict) -> int:
    """What a device of the port's sharded step multiplies beyond its share
    of the single-process products: wk and wv are replicated over ``model``
    (``gqa_specs``: kv heads below 8), so every ``model`` rank projects all
    kv heads of its tokens and slices its heads after the product, where
    XLA's sharding propagation slices the weight first."""
    chips = 1
    for n in sizes.values():
        chips *= n
    return kv_projection_flops(cfg, tokens) * (sizes["model"] - 1) // chips


@contextmanager
def fake_world(size: int):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def small_mesh_procs(tmp_path_factory):
    """Starts ``vs_ref.CELLS``' subprocesses, the reference's and the
    port's three, when the module's first test runs, so that they run
    beside the module's other tests; ``small_mesh`` reads them."""
    tmp = str(tmp_path_factory.mktemp("dryrun"))
    procs = [vs_ref.jax_side(LAYERS)] + vs_ref.port_side(LAYERS, tmp)
    yield procs, tmp
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def small_mesh(small_mesh_procs):
    """Both packages' records of ``vs_ref.CELLS``."""
    procs, tmp = small_mesh_procs
    return vs_ref.jax_records(procs[0]), vs_ref.port_records(procs[1:], tmp)


# ---------------------------------------------------------------------------
# hlo.py: roofline_terms, model_flops


def _ref_params(arch):
    import jax
    from repro import configs as ref_configs
    from repro.models import encdec as ref_encdec
    from repro.models import lm as ref_lm

    cfg = ref_configs.get_config(arch)
    if cfg.is_encoder_decoder:
        shapes = jax.eval_shape(lambda k: ref_encdec.init_params(k, cfg), jax.random.key(0))
        n = sum(int(x.size) for x in jax.tree.leaves(shapes))
        return cfg, n, n
    return (cfg, *ref_lm.count_params_analytic(cfg))


def _port_params(cfg):
    return (encdec if cfg.is_encoder_decoder else lm).count_params_analytic(cfg)


@pytest.mark.parametrize("arch", list(configs.ARCH_IDS))
def test_model_flops_equal_the_references(arch):
    from repro.config import SHAPES as REF_SHAPES
    from repro.launch import hlo as ref_hlo

    ref_cfg, ref_total, ref_active = _ref_params(arch)
    cfg = configs.get_config(arch)
    total, active = _port_params(cfg)
    assert (total, active) == (ref_total, ref_active)
    for shape in configs.runnable_cells(arch):
        assert (hlo.model_flops(cfg, SHAPES[shape], total, active)
                == ref_hlo.model_flops(ref_cfg, REF_SHAPES[shape], ref_total, ref_active))


def test_roofline_terms_equal_the_references_at_its_constants(monkeypatch):
    from repro.launch import hlo as ref_hlo

    for args in [(1e12, 1e9, 1e8), (3e15, 2e12, 5e9), (1.0, 7e11, 9e10)]:
        want = ref_hlo.roofline_terms(*args)
        for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
            monkeypatch.setattr(hlo, name, getattr(ref_hlo, name))
        assert hlo.roofline_terms(*args) == want
        monkeypatch.undo()
    # the H100 SXM's: one second of each term at its own rate
    assert hlo.roofline_terms(989e12, 0, 0) == {
        "compute_s": 1.0, "memory_s": 0.0, "collective_s": 0.0, "bound": "compute"}
    assert hlo.roofline_terms(0, 3.35e12, 0)["memory_s"] == 1.0
    assert hlo.roofline_terms(0, 0, 450e9) == {
        "compute_s": 0.0, "memory_s": 0.0, "collective_s": 1.0, "bound": "collective"}


@pytest.mark.parametrize("arch", list(configs.ARCH_IDS))
def test_chip_smoke_model_flops_differ_by_the_embedding_and_attention_terms(arch):
    """``chip_smoke.model_flops`` (the MFU's numerator) is
    ``hlo.model_flops`` less the embedding table's 6 V d T and plus the
    attention cores' 3 L H (Dk + Dv) S T (its docstring), exactly."""
    cfg = configs.get_config(arch)
    spec = SHAPES["train_4k"]
    T, S = spec.global_batch * spec.seq_len, spec.seq_len
    total, active = _port_params(cfg)
    embed = 6.0 * cfg.padded_vocab * cfg.d_model * T
    if cfg.is_encoder_decoder:
        attn = 3.0 * (2 * cfg.enc_layers + 3 * cfg.num_layers) * cfg.num_heads * 2 * cfg.head_dim
    else:
        dk = cfg.head_dim + (cfg.qk_rope_dim if cfg.attn_impl == "mla" else 0)
        n_attn = (sum(m in ("attn", "mla") for m, _ in lm.layer_pattern(cfg)) * lm.num_blocks(cfg)
                  + cfg.first_dense)
        attn = 3.0 * n_attn * cfg.num_heads * (dk + cfg.head_dim)
    attn *= S * T
    assert (chip_smoke.model_flops(cfg, T, S)
            == hlo.model_flops(cfg, spec, total, active) - embed + attn)


# ---------------------------------------------------------------------------
# the counter


def test_counter_reads_local_products_views_and_collectives():
    """On an 8-rank fake mesh: a DTensor product counts 2 m n k of one
    rank's shapes (not the global product DTensor's shape propagation runs),
    views move no bytes, and the collectives' bytes are those
    ``CollectiveLog`` logs."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with fake_world(8):
        mesh = mesh_mod._mk((2, 4), ("data", "model"), "cpu")
        gen = torch.Generator().manual_seed(0)
        a = distribute_tensor(torch.randn(64, 32, generator=gen), mesh, [Shard(0), Replicate()],
                              src_data_rank=None)
        b = distribute_tensor(torch.randn(32, 48, generator=gen), mesh, [Replicate(), Shard(1)],
                              src_data_rank=None)
        with hlo.StepCounter(mesh) as c:
            y = a @ b
        assert y.to_local().shape == (32, 12)
        assert c.stats.flops == 2 * 32 * 12 * 32
        assert c.stats.hbm_bytes == 4 * (32 * 32 + 32 * 12 + 32 * 12)
        assert c.calls == [] and c.stats.collective_bytes == 0
        with hlo.StepCounter(mesh) as c:
            y.t().unsqueeze(0)
        assert c.stats.hbm_bytes == 0 and c.stats.flops == 0
        with hlo.StepCounter(mesh) as c, mesh_mod.CollectiveLog(mesh) as log:
            y.redistribute(mesh, [Replicate(), Replicate()])
        assert log.calls and c.calls == log.calls
        assert c.stats.collective_bytes == sum(n for *_, n in log.calls)
        assert sum(c.stats.coll_count_by_kind.values()) == len(log.calls)
        assert set(c.stats.coll_bytes_by_kind) == {"all-gather"}


def _rank_and_single_process_flops(sizes: dict):
    """One rank's FLOPs of reduced tinyllama's sharded step on a fake mesh
    of ``sizes`` (4 ranks), and ``FlopCounterMode``'s count of the
    single-process step on the same global batch."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = configs.get_reduced("tinyllama-1.1b")
    spec, plan = ShapeSpec("t", "train", 64, 8), RunPlan(aggregation="totoro_tree")
    with fake_world(4):
        mesh = mesh_mod._mk(tuple(sizes.values()), tuple(sizes), "cpu")
        low = specs.lower_cell(specs.cell_for(cfg, spec, plan, mesh), mesh)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (8, 64), generator=gen, dtype=torch.int32)
             for k in ("tokens", "labels")}
    with FlopCounterMode(display=False) as fc:
        steps.build_train_step(cfg, plan)(steps.init_train_state(cfg, params), batch)
    assert low["stats"].flops > 0
    return low["stats"].flops, fc.get_total_flops()


def test_data_parallel_flops_are_the_single_process_flops_split():
    """On (pod 2, data 2, model 1) every product is split over the batch,
    so a rank's FLOPs times 4 are ``FlopCounterMode``'s count of the
    single-process step on the same global batch."""
    rank, single = _rank_and_single_process_flops({"pod": 2, "data": 2, "model": 1})
    assert rank * 4 == single


@pytest.mark.parametrize("sizes", [
    {"data": 2, "model": 2},
    {"data": 1, "model": 4},  # 2 kv heads on 4 model ranks: the kv-head repair
], ids=lambda d: "x".join(map(str, d.values())))
def test_model_parallel_flops_add_the_repeated_kv_products(sizes):
    """At model > 1 a rank's FLOPs times 4 are the single-process count
    plus the wk and wv products that each of the other ``model`` - 1 ranks
    repeats (``kv_projection_flops``), exactly."""
    rank, single = _rank_and_single_process_flops(sizes)
    cfg = configs.get_reduced("tinyllama-1.1b")
    assert rank * 4 == single + (sizes["model"] - 1) * kv_projection_flops(cfg, 8 * 64)


# ---------------------------------------------------------------------------
# lower_cell / run_cell


@pytest.mark.parametrize("mp,shape,agg,item", [
    (False, "decode_32k", None, "serving on a sharded mesh"),
    (True, "train_4k", "totoro_tree_q8", "the q8 hop inside a sharded pod"),
    (False, "train_4k", "xla_auto", "the other families on sharded meshes"),
])
def test_cells_that_are_not_ported_fail_naming_their_roadmap_item(mp, shape, agg, item):
    arch = "rwkv6-7b" if item.startswith("the other") else "tinyllama-1.1b"
    with pytest.raises(NotImplementedError, match=f"ROADMAP §1, {item}"):
        dryrun.run_cell(arch, shape, multi_pod=mp, aggregation=agg, quiet=True,
                        cfg_overrides={"num_layers": LAYERS},
                        mesh_shape=(2, 2, 2) if mp else (2, 4))
    assert not dist.is_initialized()


def test_command_line_lists_failures_and_exits_1(capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "seamless-m4t-medium", "--shape", "train_4k", "--mesh-shape",
                     "2x4", "--layers", "1"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    fails = json.loads(out[out.index("FAILURES:") + len("FAILURES:"):])
    assert [f["mesh"] for f in fails] == ["2x4"]
    assert "ROADMAP §1, the other families on sharded meshes" in fails[0]["error"]


def test_production_mesh_runs_the_dense_cell_after_the_kv_head_repair(tmp_path):
    """tinyllama-1.1b's 4 kv heads on a model axis of 16 (the repair) on
    the 256-rank mesh, through the command line, every record key set."""
    out = tmp_path / "r.json"
    dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "train_4k", "--mesh", "single",
                 "--layers", "1", "--out", str(out)])
    (rec,) = json.loads(out.read_text())
    assert (rec["mesh"], rec["chips"], rec["aggregation"]) == ("16x16", 256, "totoro_tree")
    assert set(rec) >= {"arch", "shape", "grad_accum", "params_total", "params_active",
                        "trace_s", "memory", "cost", "collectives", "roofline"}
    assert set(rec["memory"]) == {"argument_bytes_per_dev", "output_bytes_per_dev",
                                  "temp_bytes_per_dev", "alias_bytes_per_dev",
                                  "peak_bytes_per_dev"}
    assert rec["memory"]["peak_bytes_per_dev"] == sum(
        rec["memory"][k] for k in ("argument_bytes_per_dev", "output_bytes_per_dev",
                                   "temp_bytes_per_dev")) - rec["memory"]["alias_bytes_per_dev"]
    assert set(rec["roofline"]) >= {"compute_s", "memory_s", "collective_s", "bound",
                                    "model_flops", "useful_flops_ratio"}
    assert rec["cost"]["flops_per_dev"] > 0 and rec["collectives"]["total_bytes_per_dev"] > 0
    assert set(rec["collectives"]["bytes_by_kind"]) <= {"all-gather", "reduce-scatter",
                                                       "all-reduce", "all-to-all"}
    assert not dist.is_initialized()


def test_sweep_records_errors_and_skips_done_cells(tmp_path):
    out = tmp_path / "sweep.jsonl"
    done = {"arch": "seamless-m4t-medium", "shape": "train_4k", "mesh": "16x16"}
    out.write_text(json.dumps(done) + "\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.sweep", "--arch",
                        "seamless-m4t-medium", "--mesh", "single", "--skip-done", "--out",
                        str(out)], capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "sweep: 2 cells to run" in p.stdout
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert recs[0] == done
    assert [r["shape"] for r in recs[1:]] == ["prefill_32k", "decode_32k"]
    assert all("serving on a sharded mesh" in r["error"] for r in recs[1:])


@pytest.mark.parametrize("i", range(len(vs_ref.CELLS)))
def test_small_mesh_cells_hold_the_references_memory_analysis(small_mesh, i):
    """The reference's small-mesh dry-run cells (``test_optim_sharding``'s
    that lower): argument bytes a device equal to XLA's
    ``memory_analysis()``, output bytes too less XLA's output tuple table
    (``TUPLE_BYTES_A_LEAF`` a leaf), the parameter counts and
    ``model_flops`` the reference's, and FLOPs a device those of
    ``hlo.analyze_module`` plus the wk and wv products that the port
    repeats on each ``model`` rank (``replicated_kv_flops_per_dev``),
    exactly."""
    refs, ports = small_mesh
    ref, port = refs[i], ports[i]
    mp, shape, agg = vs_ref.CELLS[i]
    assert (ref["multi_pod"], ref["shape"]) == (mp, shape)
    assert port["aggregation"] == ref["aggregation"]
    assert port["memory"]["argument_bytes_per_dev"] == ref["argument_bytes_per_dev"]
    cfg = configs.get_config(vs_ref.ARCH).replace(num_layers=LAYERS)
    with torch.device("meta"):
        state = steps.init_train_state(cfg, lm.init_params(torch.Generator(), cfg, device="meta"))
    table = TUPLE_BYTES_A_LEAF * (len(leaves(state)) + 2)
    assert port["memory"]["output_bytes_per_dev"] + table == ref["output_bytes_per_dev"]
    assert port["memory"]["alias_bytes_per_dev"] == 0
    assert (port["params_total"], port["params_active"]) == (ref["params_total"],
                                                             ref["params_active"])
    assert port["roofline"]["model_flops"] == ref["model_flops"]
    sizes = dict(zip(("pod", "data", "model") if mp else ("data", "model"),
                     (2, 2, 2) if mp else (2, 4)))
    tokens = SHAPES[shape].global_batch * SHAPES[shape].seq_len
    assert replicated_kv_flops_per_dev(cfg, tokens, sizes) > 0
    assert (port["cost"]["flops_per_dev"]
            == ref["flops_per_dev"] + replicated_kv_flops_per_dev(cfg, tokens, sizes))
    assert port["collectives"]["total_bytes_per_dev"] > 0
