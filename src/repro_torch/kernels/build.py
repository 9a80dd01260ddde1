"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every ``kernels/*/csrc/*.cu`` is compiled on its own, for ``sm_90a``, into
a shared library with a plain C interface under
``<repo>/build/repro_torch_kernels/`` (listed in ``.gitignore``).  A source
may also be built a second time with extra defines under another name
(``VARIANT_LIBRARIES``: the split MTTKRP kernel's audit build).  The
library's file name carries a hash of its source, of every ``*.cuh`` header
in the same ``csrc/`` directory and of every flag it is built with, so an
edited source, header or flag is rebuilt and an unchanged one is reused.  Nothing is built at import: the first call that needs a kernel
builds it, or ``build_all()`` builds every library at once with one
``nvcc`` process per library, all started together.

``python -m repro_torch.kernels.build --ptxas SRC.cu [--define NAME ...]`` builds
one source into a temporary directory and prints each kernel's ``ptxas -v``
resource line (registers, shared memory, spills), to compare two versions
of a source on the card.

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

__all__ = ["BUILD_DIR", "VARIANT_LIBRARIES", "BuiltLibrary", "build_all", "headers", "libraries",
           "load", "ptxas_resources", "sources"]

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills, kept in the build log
)

# Library name -> (source stem, extra nvcc flags): a source built again with
# defines, beside its own library.
VARIANT_LIBRARIES = {
    "mttkrp_split_audit": ("mttkrp_split", ("-DMTTKRP_AUDIT",)),
}

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


def libraries() -> dict[str, tuple[Path, tuple[str, ...]]]:
    """Library name -> (source, extra nvcc flags): every source under its own
    name with no extra flag, then ``VARIANT_LIBRARIES``."""
    srcs = sources()
    return {**{name: (src, ()) for name, src in srcs.items()},
            **{name: (srcs[stem], flags) for name, (stem, flags) in VARIANT_LIBRARIES.items()}}


def headers(src: Path) -> list[Path]:
    """The headers beside ``src`` in its ``csrc/`` directory, which it may include."""
    return sorted(src.parent.glob("*.cuh"))


def _library_path(name: str, src: Path, flags: tuple[str, ...]) -> Path:
    """The library's path: its name and a digest of its source, every header
    beside it (an edited header rebuilds every source next to it) and its flags."""
    digest = hashlib.sha256(src.read_bytes())
    for header in headers(src):
        digest.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    digest.update("\0".join(NVCC_FLAGS + flags).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, BuiltLibrary]:
    """Build the named libraries (default: all) in parallel; reuse up-to-date ones."""
    libs = libraries()
    names = list(libs) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    built: dict[str, BuiltLibrary] = {}
    running: dict[str, tuple[subprocess.Popen, Path, Path, float]] = {}
    try:
        for name in names:
            src, flags = libs[name]
            lib = _library_path(name, src, flags)
            if lib.exists():
                built[name] = BuiltLibrary(name, lib, 0.0, "")
                continue
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(src)],
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
                    f"nvcc failed ({proc.returncode}) building {libs[name][0]}:\n{log}"
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


def ptxas_resources(log: str) -> dict[str, str]:
    """Mangled kernel name -> its ``ptxas -v`` resource lines (registers,
    shared memory, spills), joined, from an nvcc log built with ``-Xptxas -v``."""
    out: dict[str, list[str]] = {}
    kernel = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
            out[kernel] = []
        elif kernel is not None and ("registers" in line or "spill" in line
                                     or "stack frame" in line):
            out[kernel].append(line.split(":", 1)[-1].strip())
    return {k: " | ".join(v) for k, v in out.items()}


def _main(argv: list[str] | None = None) -> int:
    import argparse
    import tempfile

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ptxas", type=Path, required=True, help="a .cu source to build")
    parser.add_argument("--define", action="append", default=[], metavar="NAME",
                        help="build with -DNAME (repeatable)")
    args = parser.parse_args(argv)
    defines = [f"-D{name}" for name in args.define]
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, *defines, "-o", str(Path(tmp) / "lib.so"),
             str(args.ptxas)], capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stdout + proc.stderr)
        return proc.returncode
    for kernel, line in sorted(ptxas_resources(proc.stdout + proc.stderr).items()):
        print(f"{kernel}: {line}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
