"""Bounded fixed-interval time-series ring for the serving fleet: a copy
of the JAX package's ``observability/timeseries.py``.

The fleet already *scrapes* rich signals — the poller reads every
replica's ``/metrics?format=json`` each sweep and the slot scheduler
records a telemetry line per chunk — but until this module everything
except the latest snapshot was discarded: ``/metrics`` answers "what
is the queue depth NOW", never "what has it been doing for the last
two minutes", which is exactly the question an autoscaling policy (and
the operator staring at a brownout) needs answered.

:class:`TimeSeriesStore` turns a stream of ``observe(counters,
gauges)`` calls into fixed-interval *points*:

- **counters** (monotonic, ``*_total`` by convention) are delta'd
  against the previous observation with the same reset-correction
  discipline as ``fleet/replicas.absorb_counters`` (a drop means the
  process restarted: the new value IS the delta) and emitted as
  per-second **rates** (``tokens_generated_total`` →
  ``tokens_generated_per_s``) over the actually-covered span — an
  idle stretch between observations widens the denominator instead of
  fabricating a spike;
- **gauges** are sampled (last write in the interval wins);
- each completed interval appends ONE point to a bounded in-memory
  ring (the query API below) and ONE JSON line to ``timeseries.jsonl``
  (line-buffered, torn tails skipped on load — the FlightRecorder
  discipline), so a crash keeps the trend that explains it and an
  offline consumer replays the whole run.

Feeders: the continuous engine once per absorbed chunk (tokens,
admissions, queue, pool), and the shadow auditor's verdict counters (the
fleet poller, the JAX package's other feeder, is not ported yet).

A process-wide default store (:func:`set_default_store`) lets the
watchdog's ``stall_dump.json`` and the health layer's
``anomaly_<step>.json`` attach the last window of points to their
forensic bundles — a dump then carries the *trend* into the incident,
not just the instant.

Stdlib-only.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..utils.promtext import percentile as _pctl

TIMESERIES_FILENAME = "timeseries.jsonl"

# process-wide default store for forensic dumps (watchdog / health):
# registered by whoever builds the store (serve.py, the fleet CLI)
_default_store: Optional["TimeSeriesStore"] = None
_default_lock = threading.Lock()


def set_default_store(store: Optional["TimeSeriesStore"]) -> None:
    """Register (or clear, with None) the process's dump-context
    store. The watchdog and health layers read it best-effort — a
    process without one simply dumps without trend context."""
    global _default_store
    with _default_lock:
        _default_store = store


def default_store() -> Optional["TimeSeriesStore"]:
    with _default_lock:
        return _default_store


def rate_name(counter: str) -> str:
    """``tokens_generated_total`` -> ``tokens_generated_per_s`` (a
    counter without the ``_total`` suffix still gets ``_per_s``)."""
    base = counter[:-len("_total")] if counter.endswith("_total") \
        else counter
    return f"{base}_per_s"


class TimeSeriesStore:
    """Fixed-interval ring of rate/gauge points with JSONL persistence.

    :param path: ``timeseries.jsonl`` destination (None = ring only —
        tests, overhead benches).
    :param interval_s: point width; observations landing in the same
        interval fold into one point.
    :param window: ring capacity in points (the query API and the
        forensic dumps see at most this much history).
    :param process: stamped on the file's anchor line (stitch-side
        provenance, mirroring ``RequestTracer``).

    Thread-safe: the poller, the scheduler thread, and ``/metrics``
    scrapes may interleave. The lock is never held across file I/O of
    a *read* path; point emission (one small JSON line per interval)
    writes under it — bounded, line-buffered, and rarer than the
    observations by construction.
    """

    def __init__(self, path=None, interval_s: float = 1.0,
                 window: int = 720, process: str = "serve"):
        self.interval_s = max(float(interval_s), 1e-3)
        self.window = int(window)
        self.process = str(process)
        self._lock = threading.Lock()
        self._points: "deque" = deque(maxlen=self.window)
        self._last_raw: Dict[str, float] = {}
        self._acc: Dict[str, float] = {}      # per-bucket counter deltas
        self._gauges: Dict[str, float] = {}   # per-bucket last samples
        self._bucket_id: Optional[int] = None
        self._span = 0.0          # seconds of history the bucket covers
        self._prev_obs_t: Optional[float] = None
        self.points_written = 0
        self._file = None
        self.path = None
        if path is not None:
            self.path = Path(path)
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._file = open(self.path, "a", buffering=1)
            self._write_line({"anchor": 1, "proc": self.process,
                              "interval_s": self.interval_s,
                              "epoch": round(time.time(), 6)})

    # -- internals ----------------------------------------------------------

    def _write_line(self, rec: dict) -> None:
        if self._file is None:
            return
        try:
            self._file.write(json.dumps(rec, default=repr) + "\n")
        except (OSError, ValueError):
            pass                  # a full disk must not stall the feed

    def _emit_locked(self, t_end: float) -> None:
        """Close the open bucket into one point (caller holds lock)."""
        if self._bucket_id is None:
            return
        point: dict = {"t": round(t_end, 3),
                       "span_s": round(self._span, 3)}
        if self._span > 1e-9:
            for name, delta in self._acc.items():
                point[rate_name(name)] = round(
                    max(delta, 0.0) / self._span, 4)
        # a first-ever bucket has no covered span: counter history up
        # to it is startup state, not a rate — gauges still emit
        point.update({k: v for k, v in self._gauges.items()})
        self._points.append(point)
        self.points_written += 1
        self._write_line(point)
        self._acc = {}
        self._gauges = {}
        self._span = 0.0
        self._bucket_id = None

    # -- feeding ------------------------------------------------------------

    def observe(self, counters: Optional[dict] = None,
                gauges: Optional[dict] = None,
                t: Optional[float] = None) -> None:
        """Absorb one scrape / one chunk record.

        ``counters`` are cumulative monotonic values (reset-corrected
        deltas feed the rates); ``gauges`` are sampled as-is. ``t``
        defaults to ``time.time()`` — tests pin it to drive interval
        boundaries deterministically."""
        t = time.time() if t is None else float(t)
        with self._lock:
            bid = int(t // self.interval_s)
            if self._bucket_id is not None and bid != self._bucket_id:
                self._emit_locked(
                    (self._bucket_id + 1) * self.interval_s)
            if self._bucket_id is None:
                self._bucket_id = bid
            if self._prev_obs_t is not None and t > self._prev_obs_t:
                self._span += t - self._prev_obs_t
            self._prev_obs_t = t
            for name, v in (counters or {}).items():
                if isinstance(v, bool) or not isinstance(
                        v, (int, float)):
                    continue
                last = self._last_raw.get(name)
                if last is not None:
                    # reset correction (fleet/replicas discipline): a
                    # counter below its last value means the source
                    # restarted — the new value IS the delta since
                    # reset. The FIRST sighting only sets the
                    # baseline: its value is pre-store history, and
                    # charging it to one interval would fabricate a
                    # rate spike on attach.
                    self._acc[name] = self._acc.get(name, 0.0) + (
                        (v - last) if v >= last else float(v))
                self._last_raw[name] = float(v)
            for name, v in (gauges or {}).items():
                if isinstance(v, bool) or not isinstance(
                        v, (int, float)):
                    continue
                self._gauges[name] = float(v)

    def observe_flat(self, metrics: dict,
                     t: Optional[float] = None) -> None:
        """Absorb a flat ``/metrics``-shaped dict: ``*_total`` keys
        are counters, other scalar numerics are gauges, histogram
        snapshots / nested dicts / bools / strings are skipped."""
        counters, gauges = {}, {}
        for k, v in (metrics or {}).items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            (counters if k.endswith("_total") else gauges)[k] = v
        self.observe(counters=counters, gauges=gauges, t=t)

    def flush(self, t: Optional[float] = None) -> None:
        """Emit the partially-filled bucket (drain/shutdown path) and
        force the JSONL tail to disk."""
        t = time.time() if t is None else float(t)
        with self._lock:
            self._emit_locked(t)
            if self._file is not None:
                try:
                    self._file.flush()
                except (OSError, ValueError):
                    pass

    def close(self) -> None:
        self.flush()
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None

    # -- querying -----------------------------------------------------------

    def points(self, last_n: Optional[int] = None) -> List[dict]:
        """The trailing ``last_n`` points (all buffered when None)."""
        with self._lock:
            pts = list(self._points)
        return pts if last_n is None else pts[-int(last_n):]

    def series_names(self) -> List[str]:
        names: set = set()
        for p in self.points():
            names.update(k for k in p if k not in ("t", "span_s"))
        return sorted(names)

    def series(self, name: str,
               last_n: Optional[int] = None) -> List[Tuple[float,
                                                           float]]:
        """``[(t, value), ...]`` for one metric over the window."""
        return [(p["t"], p[name]) for p in self.points(last_n)
                if name in p]

    def latest(self, name: str) -> Optional[float]:
        for p in reversed(self.points()):
            if name in p:
                return p[name]
        return None

    def quantile(self, name: str, q: float,
                 last_n: Optional[int] = None) -> Optional[float]:
        """Window quantile via THE package percentile convention
        (utils/promtext.percentile — linear interpolation)."""
        vals = sorted(v for _, v in self.series(name, last_n))
        return _pctl(vals, q)

    def summary(self, last_n: Optional[int] = None) -> dict:
        """Per-series p50/p99/last over the window — the compact form
        the dashboard and the dump consumers embed."""
        out: dict = {"points": len(self.points(last_n))}
        for name in self.series_names():
            vals = sorted(v for _, v in self.series(name, last_n))
            if not vals:
                continue
            out[name] = {
                "last": self.latest(name),
                "p50": round(_pctl(vals, 0.5), 4),
                "p99": round(_pctl(vals, 0.99), 4),
            }
        return out


def load_timeseries(path) -> List[dict]:
    """Read a ``timeseries.jsonl`` back into points (anchor lines and
    torn tails skipped) — the offline analyzer's loader."""
    points: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict) and "anchor" not in rec:
                    points.append(rec)
    except OSError:
        pass
    return points
