"""The port's configs against ``repro.config`` / ``repro.configs``: every
arch's full and reduced config field by field (dtypes by name), the run
plans, the shape specs and the runnable cells."""
import dataclasses

import pytest

from repro import config as jconfig
from repro import configs as jconfigs
from repro_torch import config as tconfig
from repro_torch import configs as tconfigs

ARCHS = list(jconfigs.ARCH_IDS)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _same_config(t, j):
    assert _fields(t) == _fields(j)
    assert t.padded_vocab == j.padded_vocab
    assert str(t.adtype).removeprefix("torch.") == j.jdtype.__name__ == t.dtype
    assert str(t.pdtype).removeprefix("torch.") == j.pdtype.__name__ == t.param_dtype


def test_registry_matches():
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert [f.name for f in dataclasses.fields(tconfig.ModelConfig)] == [
        f.name for f in dataclasses.fields(jconfig.ModelConfig)
    ]


@pytest.mark.parametrize("arch", ARCHS)
def test_full_and_reduced_configs_field_identical(arch):
    _same_config(tconfigs.get_config(arch), jconfigs.get_config(arch))
    _same_config(tconfigs.get_reduced(arch), jconfigs.get_reduced(arch))
    assert type(tconfigs.get_config(arch)).__module__ == "repro_torch.config"
    assert tconfigs.runnable_cells(arch) == jconfigs.runnable_cells(arch)
    cfg = tconfigs.get_config(arch)
    assert tconfigs.supports_long_context(cfg) == jconfigs.supports_long_context(jconfigs.get_config(arch))
    assert tconfigs.supports_decode(cfg) and jconfigs.supports_decode(jconfigs.get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(jconfig.SHAPES))
def test_run_plans_match(arch, shape):
    t, j = tconfigs.get_plan(arch, shape), jconfigs.get_plan(arch, shape)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_shapes_and_dtypes():
    assert {k: dataclasses.asdict(v) for k, v in tconfig.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfig.SHAPES.items()
    }
    assert {k: str(v).removeprefix("torch.") for k, v in tconfig._DTYPES.items()} == {
        k: v.__name__ for k, v in jconfig._DTYPES.items()
    }
    cfg = tconfigs.get_config("seamless-m4t-medium").replace(vocab_size=1000, dtype="float16")
    assert cfg.padded_vocab == 1024 and str(cfg.adtype) == "torch.float16"
