"""The port's checkpoints against ``repro.ckpt`` on the CPU.

``tests/test_recovery_ckpt.py``'s cases run on the port, and the two
packages read each other's checkpoints: a state written by either is
restored by the other bit for bit, bf16 leaves included (``np.load``
hands a bf16 leaf back as a void ``V2`` array; the port views it as
``torch.bfloat16`` by the manifest's dtype name, the reference keeps the
``V2`` array).  numpy writes every zip member with the same fixed
timestamp, so the two packages' ``arrays.npz`` files are identical byte
for byte and so are their manifests, SHA1 included.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro_torch import ckpt as tckpt
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.pytree import leaves


def _jstate():
    """The reference test's state, plus a bf16 leaf and a nested dict."""
    return {
        "params": {"w": jnp.arange(12.0).reshape(3, 4), "b": jnp.ones(4),
                   "h": {"e": (jnp.arange(10.0) / 3).astype(jnp.bfloat16)}},
        "opt": {"step": jnp.asarray(7, jnp.int32), "m": jnp.zeros((3, 4))},
    }


def _tstate():
    return params_from_numpy(jax.tree.map(np.asarray, _jstate()), "cpu")


def _bits(x) -> bytes:
    x = x.detach().contiguous() if isinstance(x, torch.Tensor) else np.ascontiguousarray(x)
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    return x.tobytes()


def _same(a_tree, b_tree):
    a, b = leaves(a_tree), leaves(b_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert tuple(x.shape) == tuple(np.shape(y)) and _bits(x) == _bits(y)


# ---------------------------------------------------------------------------
# tests/test_recovery_ckpt.py on the port


def test_ckpt_roundtrip(tmp_path):
    st = _tstate()
    written = tckpt.save(st, str(tmp_path), step=7, replicas=2)
    assert [os.path.basename(os.path.dirname(w)) for w in written] == ["replica_0", "replica_1"]
    restored, step = tckpt.restore(st, str(tmp_path), device="cpu")
    assert step == 7
    _same(restored, st)
    for a, b in zip(leaves(restored), leaves(st)):
        assert a.dtype == b.dtype and a.device.type == "cpu"


def test_ckpt_survives_replica_corruption(tmp_path):
    st = _tstate()
    tckpt.save(st, str(tmp_path), step=3, replicas=2)
    tckpt.corrupt_replica(str(tmp_path), replica=0, step=3)
    restored, step = tckpt.restore(st, str(tmp_path), device="cpu")
    assert step == 3
    assert torch.equal(restored["params"]["w"], st["params"]["w"])


def test_ckpt_all_replicas_corrupt_raises(tmp_path):
    st = _tstate()
    tckpt.save(st, str(tmp_path), step=3, replicas=2)
    for r in range(2):
        tckpt.corrupt_replica(str(tmp_path), replica=r, step=3)
    with pytest.raises(IOError, match="all replicas unreadable"):
        tckpt.restore(st, str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        tckpt.restore(st, str(tmp_path / "none"), device="cpu")


def test_ckpt_latest_step_and_multiple(tmp_path):
    st = _tstate()
    for s in (1, 5, 9):
        tckpt.save(st, str(tmp_path), step=s, replicas=2)
    assert tckpt.latest_step(str(tmp_path)) == 9
    _, step = tckpt.restore(st, str(tmp_path), step=5, device="cpu")
    assert step == 5
    assert tckpt.latest_step(str(tmp_path / "missing")) is None


def test_ckpt_leaf_count_mismatch_is_a_bad_replica(tmp_path):
    st = _tstate()
    tckpt.save(st, str(tmp_path), step=1, replicas=1)
    with pytest.raises(IOError, match="leaf count mismatch"):
        tckpt.restore({"only": st["opt"]["m"]}, str(tmp_path), device="cpu")


def test_restore_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    st = _tstate()
    tckpt.save(st, str(tmp_path), step=1, replicas=1)
    with pytest.raises((RuntimeError, AssertionError)):
        tckpt.restore(st, str(tmp_path))


# ---------------------------------------------------------------------------
# across the two packages


def _manifest(d, step):
    with open(os.path.join(d, "replica_0", f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_same_files_as_the_reference(tmp_path):
    """Paths, dtypes (``bfloat16``, ``int32``), shapes, the npz bytes and
    so the SHA1 all equal the reference's."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save(_jstate(), jd, step=4, replicas=2)
    tckpt.save(_tstate(), td, step=4, replicas=2)
    jm, tm = _manifest(jd, 4), _manifest(td, 4)
    assert tm == jm
    assert tm["paths"] == ["opt/m", "opt/step", "params/b", "params/h/e", "params/w"]
    assert tm["dtypes"] == ["float32", "int32", "float32", "bfloat16", "float32"]
    for r in range(2):
        name = os.path.join(f"replica_{r}", "step_00000004")
        for f in ("arrays.npz", "manifest.json"):
            with open(os.path.join(jd, name, f), "rb") as a, open(os.path.join(td, name, f), "rb") as b:
                assert a.read() == b.read()


def test_jax_writes_the_port_restores(tmp_path):
    jckpt.save(_jstate(), str(tmp_path), step=2, replicas=2)
    jckpt.corrupt_replica(str(tmp_path), replica=0, step=2)
    restored, step = tckpt.restore(_tstate(), str(tmp_path), device="cpu")
    assert step == 2
    assert restored["params"]["h"]["e"].dtype == torch.bfloat16
    assert restored["opt"]["step"].dtype == torch.int32
    _same(restored, _jstate())


def test_port_writes_jax_restores(tmp_path):
    """The reference's own restore hands the bf16 leaf back as void V2
    (its tests checkpoint only f32 states); its bits are the state's."""
    tckpt.save(_tstate(), str(tmp_path), step=6, replicas=2)
    tckpt.corrupt_replica(str(tmp_path), replica=0, step=6)
    restored, step = jckpt.restore(_jstate(), str(tmp_path))
    assert step == 6
    e = restored["params"]["h"]["e"]
    assert e.dtype == np.dtype("V2")
    np.testing.assert_array_equal(e.view(ml_dtypes.bfloat16), np.asarray(_jstate()["params"]["h"]["e"]))
    _same(restored, _jstate())


def test_f32_and_bf16_leaves_restore_bit_for_bit(tmp_path):
    """Values a bf16 or f32 round trip could lose: NaN payloads, -0.0,
    infinities, subnormals."""
    special = np.array([np.nan, -0.0, np.inf, -np.inf, 1e-40, -3.5, 65504.0], np.float32)
    st = {"f": torch.from_numpy(special), "h": torch.from_numpy(special).to(torch.bfloat16)}
    tckpt.save(st, str(tmp_path), step=1, replicas=1)
    restored, _ = tckpt.restore(st, str(tmp_path), device="cpu")
    _same(restored, st)
    back = params_to_numpy(restored)
    assert back["h"].dtype == ml_dtypes.bfloat16


def test_rwkv_bf16_train_state_same_files_as_the_reference(tmp_path):
    """A bf16 rwkv6-7b train state (reduced), whose f32 ``decay_0`` and
    ``bonus_u`` sit among bf16 leaves, with AdamW's f32 master and moments:
    the port writes the reference's files byte for byte and restores every
    leaf in its own dtype, bit for bit."""
    from repro import configs as jconfigs
    from repro.fl import steps as jsteps
    from repro.models import lm as jlm

    jcfg = jconfigs.get_reduced("rwkv6-7b").replace(dtype="bfloat16", param_dtype="bfloat16")
    jstate = jsteps.init_train_state(jcfg, jlm.init_params(jax.random.key(0), jcfg))
    tstate = params_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    mixer = tstate["params"]["blocks"]["pos0"]["mixer"]
    assert mixer["decay_0"].dtype == mixer["bonus_u"].dtype == torch.float32
    assert mixer["w_r"].dtype == torch.bfloat16
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save(jstate, jd, step=3, replicas=1)
    tckpt.save(tstate, td, step=3, replicas=1)
    assert _manifest(td, 3) == _manifest(jd, 3)
    name = os.path.join("replica_0", "step_00000003", "arrays.npz")
    with open(os.path.join(jd, name), "rb") as a, open(os.path.join(td, name), "rb") as b:
        assert a.read() == b.read()
    restored, _ = tckpt.restore(tstate, td, device="cpu")
    assert [t.dtype for t in leaves(restored)] == [t.dtype for t in leaves(tstate)]
    _same(restored, tstate)
