"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every ``kernels/*/csrc/*.cu`` is compiled on its own, for ``sm_90a``, into
a shared library with a plain C interface under
``<repo>/build/repro_torch_kernels/`` (listed in ``.gitignore``).  The
library's file name carries a hash of its source, so an edited source is
rebuilt and an unchanged one is reused.  Nothing is built at import: the
first call that needs a kernel builds it, or ``build_all()`` builds every
source at once with one ``nvcc`` process per source, all started together.

A failed build raises with nvcc's output; nothing catches it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "BuiltLibrary", "build_all", "load", "sources"]

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills, kept in the build log
)

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class BuiltLibrary:
    name: str
    path: Path
    seconds: float  # nvcc wall time; 0.0 when an up-to-date library was reused
    log: str  # nvcc's output (ptxas -v resource report)


def sources() -> dict[str, Path]:
    """Kernel name (the source's stem) -> ``.cu`` path."""
    found = {p.stem: p for p in sorted(_KERNELS_DIR.glob("*/csrc/*.cu"))}
    if not found:
        raise FileNotFoundError(f"no CUDA sources under {_KERNELS_DIR}/*/csrc/")
    return found


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(path, os.X_OK):
        raise FileNotFoundError(
            "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc; the CUDA "
            "kernels are built on a machine with the CUDA toolkit"
        )
    return path


def _library_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_all(names: list[str] | None = None) -> dict[str, BuiltLibrary]:
    """Build the named sources (default: all) in parallel; reuse up-to-date ones."""
    srcs = sources()
    names = list(srcs) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    built: dict[str, BuiltLibrary] = {}
    running: dict[str, tuple[subprocess.Popen, Path, Path, float]] = {}
    try:
        for name in names:
            src = srcs[name]
            lib = _library_path(src)
            if lib.exists():
                built[name] = BuiltLibrary(name, lib, 0.0, "")
                continue
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
            running[name] = (proc, tmp, lib, time.perf_counter())
        for name, (proc, tmp, lib, t0) in running.items():
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {srcs[name]}:\n{log}"
                )
            os.replace(tmp, lib)
            built[name] = BuiltLibrary(name, lib, seconds, log)
    finally:
        for proc, tmp, _, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return built


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use and loaded once per process."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path = build_all([name])[name].path
            lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib
