"""Build the port's CUDA sources with ``nvcc`` at first use and load them
with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C interface and becomes one shared
library ``build/kernels/lib<name>-<digest>.so`` beside the package (the
digest is the source's sha256, so an edited source is rebuilt and a stale
library is never loaded). Nothing is built when a module is imported: the
first launch builds, or a caller builds every library at once with
:func:`build_all`, which starts one ``nvcc`` per source in parallel.

Each :class:`CudaLibrary` also carries the launch count of its kernel: the
wrapper that launches it adds one per launch, so a run can show that its
main path really went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Iterable

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v"]

#: every library the package defines, in definition order
LIBRARIES: list["CudaLibrary"] = []


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built on the "
            "machine with the card (set CUDA_HOME to the toolkit)")
    return found


class CudaLibrary:
    """One ``csrc/<name>.cu`` source, its built library and launch count.

    ``declare(lib)`` sets ``argtypes``/``restype`` of every exported
    function once the library is loaded."""

    def __init__(self, name: str, declare: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self._declare = declare
        self._lib = None
        self.launches = 0
        self.build_log = ""
        self.build_seconds = 0.0
        LIBRARIES.append(self)

    @property
    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def _start_build(self):
        """Start ``nvcc`` for this source; None when already built."""
        out = self.path
        if out.is_file():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, out, time.perf_counter()

    def _finish_build(self, started) -> None:
        proc, tmp, out, t0 = started
        log, _ = proc.communicate()
        self.build_log = log
        self.build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed to build {self.source} (rc "
                f"{proc.returncode}):\n{log}")
        os.replace(tmp, out)

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first when needed."""
        if self._lib is None:
            build_all([self])
            lib = ctypes.CDLL(str(self.path))
            self._declare(lib)
            self._lib = lib
        return self._lib


def build_all(libraries: Iterable[CudaLibrary] = None) -> dict:
    """Build every library not yet built, one ``nvcc`` per source, all
    started together. Returns ``{name: seconds}`` of the builds that ran."""
    libraries = list(LIBRARIES if libraries is None else libraries)
    started = [(lib, lib._start_build()) for lib in libraries]
    built = {}
    failures = []
    for lib, handle in started:
        if handle is None:
            continue
        try:
            lib._finish_build(handle)
            built[lib.name] = lib.build_seconds
        except RuntimeError as e:
            failures.append(str(e))
    if failures:
        raise RuntimeError("\n".join(failures))
    return built
