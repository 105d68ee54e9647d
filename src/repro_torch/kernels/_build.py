"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
its own nvcc process (``build_all`` starts them together) into
``build/kernels/lib<name>-<hash>.so`` at the repository root (listed in
``.gitignore``), for ``sm_90a`` only:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so csrc/<name>.cu

The hash is of the source and the flags, so an edited source rebuilds
and an unchanged one is reused.  Nothing here falls back: a missing
``nvcc`` or a failed build raises.  Nothing is built or loaded at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}  # name -> nvcc's output (ptxas register/spill report)


def nvcc_path() -> str:
    """The nvcc binary: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "cannot be built, and a CUDA tensor has no other path"
    )


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def sources() -> list[str]:
    """The names of every ``csrc/<name>.cu``, sorted."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names: list[str] | None = None) -> None:
    """Compile every named source (default: all) that is not built yet.

    One nvcc per source, all started together, so the build takes as
    long as the slowest file.  Each output appears atomically; any failed
    build raises after every process has ended.
    """
    todo = [(n, _lib_path(n)) for n in (sources() if names is None else names)]
    todo = [(n, out) for n, out in todo if not out.exists()]
    if not todo:
        return
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    try:
        for name, out in todo:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, out, tmp, proc in procs:
            BUILD_LOG[name] = proc.communicate()[0]
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"csrc/{name}.cu (rc {proc.returncode}):\n{BUILD_LOG[name]}")
            else:
                os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib
