"""Build, load and route to the port's CUDA kernels.

Every `csrc/*.cu` is one shared library with a plain C interface,
`csrc/build/libnr_<stem>.so`, compiled by `nvcc` for `sm_90a` and
loaded with ctypes. `build_all` starts one `nvcc` per source, all at
once, and waits for every one of them; a library is rebuilt when any
source or header under `csrc/` is newer than it (or on `force`). The
kernel modules (`ops/replay.py`, `ops/vspace.py`) get their library
through `library(stem, bind)`, which builds at first use and declares
the C signatures once.

Also the wrappers' shared rules: `route` (the kernel for tensors on
one CUDA device, the plain version for CPU tensors, nothing else),
`expect` (dtype, shape, contiguity) and `Kernel` (a launch count).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: nvcc's output of the last build of each source (register and
#: shared-memory report), by file name
BUILD_LOG: dict[str, str] = {}

_libs: dict[str, ctypes.CDLL] = {}
_bound: set[str] = set()
_lock = threading.Lock()


class Kernel:
    """A kernel's launch count: plain integer, +1 per launch."""

    __slots__ = ("name", "launches")

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _lib_path(src: Path) -> Path:
    return BUILD_DIR / f"libnr_{src.stem}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built with the CUDA "
        "toolkit at first use"
    )


def build_all(force: bool = False) -> dict[str, ctypes.CDLL]:
    """Build every stale library (all of them with `force`), in
    parallel, and load them all: `{stem: CDLL}`."""
    global _libs
    with _lock:
        if _libs and not force:
            return _libs
        srcs = sources()
        newest = max(p.stat().st_mtime for p in
                     [*srcs, *CSRC.glob("*.cuh")])
        stale = [s for s in srcs if force or not _lib_path(s).exists()
                 or _lib_path(s).stat().st_mtime < newest]
        if stale:
            nvcc = _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            jobs = []
            for src in stale:
                tmp = BUILD_DIR / f"{_lib_path(src).name}.{os.getpid()}.tmp"
                proc = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                )
                jobs.append((src, tmp, proc))
            failed = []
            for src, tmp, proc in jobs:  # wait for every job, then judge
                BUILD_LOG[src.name] = proc.communicate()[0]
                if proc.returncode != 0:
                    failed.append(src.name)
                else:
                    os.replace(tmp, _lib_path(src))
            if failed:
                raise RuntimeError(
                    "nvcc failed to build " + ", ".join(failed) + ":\n"
                    + "\n".join(BUILD_LOG[f] for f in failed)
                )
        _libs = {s.stem: ctypes.CDLL(str(_lib_path(s))) for s in srcs}
        _bound.clear()
        return _libs


def library(stem: str, bind) -> ctypes.CDLL:
    """The loaded library of `csrc/<stem>.cu`, its C signatures
    declared by `bind(lib)` the first time."""
    lib = build_all()[stem]
    with _lock:
        if stem not in _bound:
            bind(lib)
            _bound.add(stem)
    return lib


def route(*tensors) -> str:
    """'cpu' when every tensor is on the CPU (plain version), 'cuda'
    when every tensor is on one CUDA device (the kernel); anything else
    raises — there is no fallback from one to the other."""
    devs = {t.device for t in tensors}
    kinds = {d.type for d in devs}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"} and len(devs) == 1:
        return "cuda"
    raise ValueError(
        f"tensors on {sorted(str(d) for d in devs)}: the kernel takes "
        f"tensors on one CUDA device, its plain version CPU tensors"
    )


def expect(t: torch.Tensor, name: str, shape: tuple, dtype) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
