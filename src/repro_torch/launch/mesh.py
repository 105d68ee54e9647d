"""Production meshes as ``torch.distributed`` ``DeviceMesh``es.

Answers to ``repro/launch/mesh.py``: the same shapes and axis names.
Functions, not module constants, so importing this module touches no
device and no process group.  A mesh needs the default process group of
as many ranks as it has devices (``torch.distributed.init_process_group``
with its address, world size and rank); ``DeviceMesh`` then makes one
process group per mesh axis, and ``mesh.get_group("pod")`` is the
cross-zone group that ``fl/hierarchy`` aggregates over.
"""
from __future__ import annotations


def _mk(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks 0 .. n - 1
    in row-major order; ``device_type`` "cpu" for a gloo CPU group."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 chips/pod; multi_pod: 2 pods = 512 chips."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes)


def make_test_mesh(*, multi_pod: bool = False):
    """Small mesh for integration tests (8 ranks)."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def num_pods(mesh) -> int:
    return mesh_axis_sizes(mesh).get("pod", 1)
