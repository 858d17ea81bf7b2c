"""Flight recorder: one structured record per training step (the port of
the JAX package's ``observability/telemetry.py``: the same JSONL schema,
ring, aggregates and atexit flush).

MegaScale-style per-step telemetry as a first-class subsystem: the
trainer feeds one record per step into a bounded
in-memory ring buffer, and process 0 appends each record as a JSON
line to ``<run_dir>/telemetry.jsonl``. A wedged or crashed run leaves
its last ``capacity`` steps on disk and in the watchdog's stall dump
(utils/watchdog.py) instead of evaporating; a healthy run leaves a
machine-parseable timeline that tooling reads back without scraping
logs.

Record schema (all optional except ``v``/``step``/``t``):

    {"v": 1, "step": 0, "t": <unix seconds>,
     "wall_ms": ..., "data_wait_ms": ...,
     "loss": ..., "grad_norm": ..., "lr": ...,
     "examples": ..., "tokens": ...,
     "steps_per_sec": ..., "examples_per_sec": ..., "tokens_per_sec": ...,
     "mfu": ...,
     "compile_events": [{"event": ..., "dur_ms": ...}, ...],
     "host_rss_mb": ..., "devices": {"0": {"bytes_in_use": ...,
                                           "peak_bytes_in_use": ...}}}

Memory fields attach every ``memory_every`` records (host RSS is a
/proc read, device memory the caching allocator's counters of this
process's card, ``torch.cuda.memory_stats`` — no device sync). Compile
events are the port's own compile work: the ``nvcc`` builds of the CUDA
kernel libraries that ``ops/build.py`` runs at first launch
(``{"event": "nvcc/<library>", "dur_ms": ...}``). Any build since the
previous record rides along on the next one, so the first step's
record carries the kernel builds it paid for.
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import threading
import time
import weakref
from pathlib import Path
from typing import Optional

SCHEMA_VERSION = 1

# File-backed recorders register here so ONE atexit hook fsyncs every
# live JSONL tail on interpreter exit — normal return, sys.exit, and
# unhandled exceptions all run atexit, so a crashing run keeps its last
# ring of records on disk without every caller remembering to flush().
# (os._exit and SIGKILL bypass atexit; the watchdog's stall-path flush
# covers the wedged-then-killed case.) WeakSet: registration must not
# keep closed recorders alive.
_live_recorders: "weakref.WeakSet" = weakref.WeakSet()
_atexit_lock = threading.Lock()
_atexit_installed = False


def _flush_live_recorders() -> None:
    for rec in list(_live_recorders):
        try:
            rec.flush()
        except Exception:  # noqa: BLE001 — exit hooks must never raise
            pass


def _register_for_atexit(recorder) -> None:
    global _atexit_installed
    _live_recorders.add(recorder)
    with _atexit_lock:
        if not _atexit_installed:
            _atexit_installed = True
            atexit.register(_flush_live_recorders)

# ---------------------------------------------------------------------------
# host / device memory probes
# ---------------------------------------------------------------------------


def host_rss_bytes() -> Optional[int]:
    """Resident set size of this process, or None when unknowable."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        import resource
        import sys

        # ru_maxrss is KB on linux, bytes on macOS; prefer /proc above,
        # this is the portable fallback (peak, not current)
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return rss if sys.platform == "darwin" else rss * 1024
    except Exception:
        return None


def device_memory_stats() -> dict:
    """This process's card's memory, with the JAX function's keys.

    ``{device_index: {"bytes_in_use", "peak_bytes_in_use", "bytes_limit",
    "num_allocs"}}`` from ``torch.cuda.memory_stats`` (allocated bytes
    now and at peak, allocations made) and the card's total memory; empty
    on the CPU and before CUDA is initialised. Only the current device
    is read: touching another would create a CUDA context on it."""
    out: dict = {}
    try:
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return out
        index = torch.cuda.current_device()
        stats = torch.cuda.memory_stats(index)
        out[str(index)] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(
                stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(
                torch.cuda.get_device_properties(index).total_memory),
            "num_allocs": int(stats.get("allocation.all.allocated", 0)),
        }
    except Exception:
        pass
    return out


# ---------------------------------------------------------------------------
# compile events: the kernel builds of ops/build.py
# ---------------------------------------------------------------------------


def drain_compile_events() -> list:
    """Kernel builds since the last drain (process-wide), as
    ``{"event": "nvcc/<library>", "dur_ms": ...}``."""
    from ..ops import build

    return build.drain_build_events()


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Bounded per-step record ring + JSONL writer.

    :param run_dir: directory for ``telemetry.jsonl``; None disables the
        file (ring buffer only — e.g. non-main processes, tests).
    :param capacity: ring size; the watchdog stall dump and
        ``aggregates()`` see at most this many trailing records.
    :param memory_every: attach host RSS + device HBM stats to every
        N-th record (0 disables the memory fields entirely).
    :param filename: JSONL file name inside ``run_dir``.

    Thread-safe: the serving/bench paths record from worker threads.
    """

    def __init__(self, run_dir=None, capacity: int = 512,
                 memory_every: int = 16,
                 filename: str = "telemetry.jsonl"):
        self.capacity = int(capacity)
        self.memory_every = int(memory_every)
        self.ring: "collections.deque" = collections.deque(
            maxlen=self.capacity
        )
        # _lock guards ONLY the ring + counter (never held across I/O or
        # device probes): the watchdog's stall dump reads the ring from
        # its monitor thread, and a wedged file write or memory_stats()
        # call — exactly the stalls it diagnoses — must not deadlock it.
        # _io_lock serializes the JSONL file.
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        self._n = 0
        self._file = None
        self.path = None
        if run_dir is not None:
            self.path = Path(run_dir) / filename
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._file = open(self.path, "a", buffering=1)  # line-buffered
            _register_for_atexit(self)

    # -- write ---------------------------------------------------------------

    def record(self, step: int, **fields) -> dict:
        """Append one step record; returns the full record as written.

        Non-finite floats are nulled (strict-JSON consumers choke on
        NaN/Infinity); None-valued fields are dropped."""
        rec = {"v": SCHEMA_VERSION, "step": int(step),
               "t": round(time.time(), 3)}
        for k, v in fields.items():
            if v is None:
                continue
            if (not isinstance(v, (bool, int, float, str, bytes))
                    and hasattr(v, "item")):
                # numpy/torch scalars: unwrap to builtins so the
                # non-finite nulling below sees them and json.dumps
                # never chokes on a caller's un-converted scalar
                try:
                    v = v.item()
                except Exception:
                    pass
            if isinstance(v, float) and (v != v or v in (float("inf"),
                                                         float("-inf"))):
                v = None
            rec[k] = v
        compile_events = drain_compile_events()
        if compile_events:
            # EXTEND a caller-provided list rather than replace it: a
            # deferred record (trainer sync-free logging) drains at
            # enqueue time so its own compile rides under its own step,
            # and anything arriving before the flush still lands here
            rec["compile_events"] = (
                list(rec.get("compile_events") or []) + compile_events
            )
        with self._lock:
            self._n += 1
            attach_memory = (
                self.memory_every
                and (self._n - 1) % self.memory_every == 0
            )
        if attach_memory:  # probes run OUTSIDE the ring lock (see init)
            rss = host_rss_bytes()
            if rss:
                rec["host_rss_mb"] = round(rss / 2**20, 1)
            devices = device_memory_stats()
            if devices:
                rec["devices"] = devices
        with self._lock:
            self.ring.append(rec)
        with self._io_lock:
            if self._file is not None:
                try:
                    # default=repr: one exotic caller field must not
                    # void the line (same policy as SpanRecorder.dump)
                    self._file.write(json.dumps(rec, default=repr) + "\n")
                except (OSError, ValueError, TypeError):
                    pass  # a full disk must never kill the step loop
        return rec

    # -- read ----------------------------------------------------------------

    def last(self, n: Optional[int] = None) -> list:
        """The trailing ``n`` records (all buffered when None)."""
        with self._lock:
            records = list(self.ring)
        return records if n is None else records[-int(n):]

    def aggregates(self) -> dict:
        """Throughput over the buffered window, computed from the
        records themselves: steps/s from
        summed ``wall_ms``, tokens/s and examples/s from the summed
        ``tokens``/``examples`` fields over the same wall time."""
        records = self.last()
        timed = [r for r in records if r.get("wall_ms")]
        if not timed:
            return {"steps": len(records)}
        wall_s = sum(r["wall_ms"] for r in timed) / 1e3
        out = {
            "steps": len(timed),
            "wall_s": round(wall_s, 3),
            "steps_per_sec": round(len(timed) / wall_s, 4),
        }
        tokens = sum(r.get("tokens", 0) for r in timed)
        if tokens:
            out["tokens_per_sec"] = round(tokens / wall_s, 1)
        examples = sum(r.get("examples", 0) for r in timed)
        if examples:
            out["examples_per_sec"] = round(examples / wall_s, 1)
        waits = [r["data_wait_ms"] for r in timed
                 if r.get("data_wait_ms") is not None]
        if waits:
            out["data_wait_ms_mean"] = round(sum(waits) / len(waits), 3)
        losses = [r["loss"] for r in timed if r.get("loss") is not None]
        if losses:
            out["last_loss"] = losses[-1]
        return out

    # -- lifecycle -----------------------------------------------------------

    def flush(self) -> None:
        with self._io_lock:
            if self._file is not None:
                try:
                    self._file.flush()
                    os.fsync(self._file.fileno())
                except (OSError, ValueError):
                    pass

    def close(self) -> None:
        with self._io_lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_jsonl(path) -> list:
    """Load a telemetry JSONL file back into a list of records —
    the round-trip consumers (tests, dashboards, bench) use."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records
