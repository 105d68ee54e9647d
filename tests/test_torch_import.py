"""The port imports neither JAX nor the JAX package, and its entry points
refuse to run on a card that is not there."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None      # any import of jax now raises ImportError
sys.modules["repro"] = None    # and so does any import of the JAX package
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(
    m for m, mod in sys.modules.items()
    if mod is not None and (m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
)
assert not leaked, leaked
print(" ".join(names))
"""


def _run(code, tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run(
        [sys.executable, "-c", code, *args], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_every_module_imports_without_jax_or_repro(tmp_path):
    res = _run(PROBE, tmp_path)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 29 + 20 + 3 + 3 + 1 + 3  # slices A, B and C; aggregation, dp, configs,
    # models, serving; then optim, ckpt and the training entry point; moe, rwkv, ssm; encdec;
    # the multi-device slice
    assert {
        "repro_torch.fl.compression", "repro_torch.fl.async_engine",
        "repro_torch.fl.selection", "repro_torch.core.sim",
        "repro_torch.core.congestion", "repro_torch.kernels.quantize",
        "repro_torch.kernels.broadcast", "repro_torch.core.pathplan",
        "repro_torch.core.multicast", "repro_torch.kernels.fused_update",
        "repro_torch.kernels.policy_update",
        "repro_torch.fl.aggregation", "repro_torch.fl.dp", "repro_torch.config",
        "repro_torch.configs", "repro_torch.configs.tinyllama_1_1b", "repro_torch.configs.qwen3_8b",
        "repro_torch.models.nn", "repro_torch.models.attention", "repro_torch.models.lm",
        "repro_torch.fl.steps", "repro_torch.launch.serve",
        "repro_torch.optim", "repro_torch.ckpt", "repro_torch.launch.train",
        "repro_torch.models.moe", "repro_torch.models.rwkv", "repro_torch.models.ssm",
        "repro_torch.models.encdec",
        "repro_torch.launch.mesh", "repro_torch.launch.specs", "repro_torch.fl.hierarchy",
    } <= names


def test_chip_smoke_imports_no_jax():
    """Every import statement of chip_smoke.py, at any depth."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "repro"}, names


def test_make_app_without_device_needs_a_card():
    """``device=None`` means the card: with none present it raises rather
    than carrying on on the CPU."""
    from repro_torch.core.api import TotoroSystem
    from repro_torch.fl import rounds

    if torch.cuda.is_available():
        assert rounds.resolve_device(None).type == "cuda"
        return
    sys_ = TotoroSystem(zone_bits=2, suffix_bits=20)
    for i in range(8):
        sys_.Join("n", i, site=i % 4)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        rounds.make_app(sys_, "a", workers=[], data_by_worker={})
    assert not sys_.apps  # refused before the tree was created
    with pytest.raises(RuntimeError, match="no CUDA card"):
        rounds.resolve_device("cuda:0")
    assert rounds.resolve_device("cpu").type == "cpu"


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run for real")
    res = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
