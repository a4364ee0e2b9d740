"""Build and load the port's CUDA kernels.

Each source in `csrc/` is compiled by nvcc, at first use, into a shared
library with a plain C interface under `build/kernels/` at the repository
root, named by a hash of the source, the shared headers (`csrc/*.cuh`) and
the flags, and loaded with ctypes.
Nothing is built when a module is imported.  A failed build or load
raises `KernelError`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "KernelError", "build", "build_log", "load"]

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)



class KernelError(RuntimeError):
    """A CUDA kernel of the port failed to build, load or launch.  Callers
    that tolerate a failing candidate (the autotuner) re-raise it: a broken
    kernel must never pass for a slow one."""


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise KernelError("no CUDA toolkit found (set CUDA_HOME); nvcc builds the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _library_path(name: str) -> Path:
    # The headers count too: a change to a shared .cuh rebuilds every source.
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names) -> dict[str, Path]:
    """Compile every named source that is not built yet, all nvcc processes
    started together; returns each library's path."""
    paths = {name: _library_path(name) for name in names}
    todo = {name: path for name, path in paths.items() if not path.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{out}")
            continue
        todo[name].with_suffix(".log").write_text(out)
        os.replace(tmp, todo[name])  # atomic: concurrent builders never load a partial file
    if failed:
        raise KernelError("\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """What nvcc and ptxas reported (registers, shared memory, spills) when
    the library for `name` was built."""
    return _library_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/`name`.cu, built first if needed."""
    with _lock:
        if name not in _libs:
            path = build([name])[name]
            try:
                _libs[name] = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelError(f"cannot load {path}: {e}") from e
        return _libs[name]
