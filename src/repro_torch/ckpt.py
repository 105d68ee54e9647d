"""Checkpointing with k-replica writes (the paper's master-state replication).

Answers to ``repro/ckpt.py`` with its file format: ``save`` writes
``replicas`` identical copies under ``directory/replica_i/step_N``, each
an ``arrays.npz`` of the leaves (``a0``, ``a1``, ... in leaf order)
and a ``manifest.json`` of their ``/``-joined key paths (``opt/m/blocks/
pos0/ffn/wg``, ``params/first/0/mixer/wq``: the paths
``jax.tree.flatten_with_path`` gives, ``pytree.key_paths``),
numpy dtype names, shapes and the npz's SHA1, written to ``.tmp`` and
then renamed; ``restore`` reads the first replica whose SHA1 checks, so
the loop survives the loss of any k-1 replicas.

The files are the reference's byte for byte: numpy writes every zip
member with the same fixed timestamp, and a bfloat16 leaf is stored as
the JAX package's ``np.savez`` stores an ``ml_dtypes.bfloat16`` array, a
``'<V2'`` header over its 16-bit patterns (written here from the int16
view, so no ``ml_dtypes`` is needed).  ``np.load`` hands such a leaf back
as a void ``V2`` array; ``restore`` views it as ``torch.bfloat16`` by the
manifest's dtype name, bit for bit.  Both packages read each other's
checkpoints (``tests/test_torch_ckpt.py``).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import zipfile
from typing import Any

import numpy as np
import torch
from numpy.lib import format as npy

from .pytree import key_paths, leaves, unflatten_like


def _sha1(path: str) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf as (a C-contiguous numpy array, its numpy dtype name); a
    bfloat16 leaf as its int16 bit patterns."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _write_npz(path: str, arrays: list[tuple[np.ndarray, str]]) -> None:
    """``np.savez(path, a0=..., a1=...)``, with bfloat16 leaves under the
    header ``ml_dtypes`` gives them."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for i, (a, name) in enumerate(arrays):
            with zf.open(f"a{i}.npy", "w", force_zip64=True) as fid:
                if name == "bfloat16":
                    npy.write_array_header_1_0(
                        fid, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
                    fid.write(a.tobytes())
                else:
                    npy.write_array(fid, a)


def save(tree: Any, directory: str, *, step: int, replicas: int = 2) -> list[str]:
    """Write ``replicas`` identical copies under directory/replica_i/step_N."""
    paths = key_paths(tree)
    arrays = [_host(t) for t in leaves(tree)]
    written = []
    for r in range(replicas):
        dst = os.path.join(directory, f"replica_{r}", f"step_{step:08d}")
        tmp = dst + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        npz = os.path.join(tmp, "arrays.npz")
        _write_npz(npz, arrays)
        manifest = {
            "step": step,
            "paths": paths,
            "dtypes": [name for _, name in arrays],
            "shapes": [list(a.shape) for a, _ in arrays],
            "sha1": _sha1(npz),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(dst):
            shutil.rmtree(dst)
        os.replace(tmp, dst)
        written.append(dst)
    return written


def latest_step(directory: str) -> int | None:
    steps = set()
    if not os.path.isdir(directory):
        return None
    for rep in os.listdir(directory):
        rd = os.path.join(directory, rep)
        if not os.path.isdir(rd):
            continue
        for s in os.listdir(rd):
            if s.startswith("step_") and not s.endswith(".tmp"):
                steps.add(int(s[5:]))
    return max(steps) if steps else None


def _tensor(a: np.ndarray, name: str, device) -> torch.Tensor:
    if name == "bfloat16":  # np.load gives a void V2 array: view its bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def restore(tree_like: Any, directory: str, *, step: int | None = None,
            device="cuda") -> tuple[Any, int]:
    """Restore from the first intact replica (checksum-verified), as
    tensors on ``device``.

    ``tree_like`` provides the dict structure (values ignored).
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    errors = []
    for rep in sorted(os.listdir(directory)):
        d = os.path.join(directory, rep, f"step_{step:08d}")
        if not os.path.isdir(d):
            continue
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            npz_path = os.path.join(d, "arrays.npz")
            if _sha1(npz_path) != manifest["sha1"]:
                raise IOError(f"checksum mismatch in {d}")
            n = len(manifest["paths"])
            if len(leaves(tree_like)) != n:
                raise IOError(f"leaf count mismatch: ckpt {n} vs tree {len(leaves(tree_like))}")
            with np.load(npz_path) as z:
                arrays = [z[f"a{i}"] for i in range(n)]
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            errors.append(f"{d}: {e}")  # corrupted replica: try the next one
            continue
        out = [_tensor(a, name, device) for a, name in zip(arrays, manifest["dtypes"])]
        return unflatten_like(tree_like, out), manifest["step"]
    raise IOError("all replicas unreadable:\n" + "\n".join(errors))


def corrupt_replica(directory: str, replica: int, step: int) -> None:
    """Test helper: simulate a failed neighborhood node (truncate its copy)."""
    d = os.path.join(directory, f"replica_{replica}", f"step_{step:08d}", "arrays.npz")
    with open(d, "r+b") as f:
        f.truncate(max(0, os.path.getsize(d) // 2))
