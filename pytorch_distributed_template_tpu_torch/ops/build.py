"""Build the port's CUDA sources with ``nvcc`` at first use and load them
with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C interface and becomes one shared
library ``build/kernels/lib<name>-<digest>.so`` beside the package (the
digest is the sha256 of the source and of every ``csrc`` header it
includes, directly or through another header, so an edited source or
header is rebuilt and a stale library is never loaded). The libraries link
the driver library (``-lcuda``) for ``cuTensorMapEncodeTiled``, which
builds the TMA tensor maps of the Hopper kernels. Nothing is built when a
module is imported: the first launch builds, or a caller builds every
library at once with :func:`build_all`, which starts one ``nvcc`` per
source in parallel.

Every build that runs is noted as a compile event (``{"event":
"nvcc/<name>", "dur_ms": ...}``), which the flight recorder
(observability/telemetry.py) drains into the next step record; a library
found already built counts as a cache hit, a build as a miss
(:func:`cache_counters`, read by ``utils/compile_cache.py``).

Each :class:`CudaLibrary` also carries the launch count of its kernel: the
wrapper that launches it adds one per launch, so a run can show that its
main path really went through the kernel. A source that exports several
kernels names them (``kernels=``) and each gets a :class:`Kernel` with its
own count.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Iterable

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v"]
# after the source: the linker drops a library named before its users
LINK_FLAGS = ["-lcuda"]
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

#: every library the package defines, in definition order
LIBRARIES: list["CudaLibrary"] = []

_events_lock = threading.Lock()
_build_events: collections.deque = collections.deque(maxlen=256)
_cache = {"hits": 0, "misses": 0}


def drain_build_events() -> list:
    """The builds noted since the last drain, oldest first."""
    with _events_lock:
        out = list(_build_events)
        _build_events.clear()
    return out


def cache_counters() -> dict:
    """Process-lifetime ``{"hits", "misses"}`` of :meth:`CudaLibrary.load`:
    a library found built in ``BUILD_DIR`` is a hit, one built is a
    miss."""
    with _events_lock:
        return dict(_cache)


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


def local_includes(source: Path) -> list[Path]:
    """The headers that ``source`` includes with quotes (resolved against
    the including file's directory), directly or through each other,
    sorted, each once."""
    seen, todo = set(), [source]
    while todo:
        including = todo.pop()
        for name in _INCLUDE.findall(including.read_text(errors="replace")):
            path = (including.parent / name).resolve()
            if path.is_file() and path not in seen:
                seen.add(path)
                todo.append(path)
    return sorted(seen)


def source_digest(source: Path) -> str:
    """sha256 (16 hex digits) of ``source`` and its local headers."""
    h = hashlib.sha256(source.read_bytes())
    for header in local_includes(source):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


#: guards the launch counts: the engine threads of several DP groups, each
#: on its own card, launch from one process
COUNT_LOCK = threading.Lock()


class LaunchCount:
    """A kernel's launches: ``launches`` in all, ``per_device`` by card
    index. A wrapper calls :meth:`count` once where it launches."""

    def __init__(self):
        self.launches = 0
        self.per_device: dict = {}

    def count(self, device) -> None:
        with COUNT_LOCK:
            self.launches += 1
            self.per_device[device.index] = self.per_device.get(
                device.index, 0) + 1

    def reset(self) -> None:
        with COUNT_LOCK:
            self.launches = 0
            self.per_device = {}


class Kernel(LaunchCount):
    """One kernel of a multi-kernel library and its own launch count."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name


class CudaLibrary(LaunchCount):
    """One ``csrc/<name>.cu`` source, its built library and launch count.

    ``declare(lib)`` sets ``argtypes``/``restype`` of every exported
    function once the library is loaded. ``kernels`` names the kernels of
    a source that exports several; their counts live in ``self.kernels``
    (``launches`` then stays 0)."""

    def __init__(self, name: str, declare: Callable[[ctypes.CDLL], None],
                 kernels: Iterable[str] = ()):
        super().__init__()
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self._declare = declare
        self._lib = None
        self.kernels = {k: Kernel(k) for k in kernels}
        self.build_log = ""
        self.build_seconds = 0.0
        LIBRARIES.append(self)

    @property
    def path(self) -> Path:
        return BUILD_DIR / f"lib{self.name}-{source_digest(self.source)}.so"

    def _start_build(self):
        """Start ``nvcc`` for this source; None when already built."""
        out = self.path
        if out.is_file():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source),
               *LINK_FLAGS]
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
            built = build_all([self])
            with _events_lock:
                _cache["misses" if built else "hits"] += 1
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
            with _events_lock:
                _build_events.append({"event": f"nvcc/{lib.name}",
                                      "dur_ms": round(
                                          lib.build_seconds * 1e3, 3)})
        except RuntimeError as e:
            failures.append(str(e))
    if failures:
        raise RuntimeError("\n".join(failures))
    return built
