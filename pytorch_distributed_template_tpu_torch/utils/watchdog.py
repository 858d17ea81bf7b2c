"""Hung-step detection (the port of the JAX package's
``utils/watchdog.py``).

A hung rank deadlocks everyone in a collective with no diagnostics: the
host blocks inside an NCCL all-reduce, a device copy or a
``cuda.synchronize`` with no Python traceback ever surfacing.

``StepWatchdog`` is a monitor thread fed a heartbeat from the training
loop. When no step completes within ``timeout_s`` it logs an error and
dumps ALL thread stacks (``faulthandler``) to stderr — so a wedged run
leaves a post-mortem trail showing exactly which call never returned —
and keeps repeating while the stall lasts. Wired to the telemetry tier
(observability/telemetry + trace) it additionally dumps the ACTIVE
spans ("stuck 214 s inside checkpoint/save") and the last-N step
records, to stderr and — when ``dump_path`` is set — as a JSON stall
artifact next to the run's logs, turning a hang into a diagnosable
record instead of a silent timeout. Detection only, by design:
killing or restarting is the orchestrator's job.
"""
from __future__ import annotations

import faulthandler
import json
import logging
import sys
import threading
import time
from pathlib import Path

logger = logging.getLogger(__name__)


class StepWatchdog:
    """Monitor thread that alarms when ``beat()`` stops arriving.

    :param timeout_s: stall threshold; <= 0 disables entirely (no thread).
    :param dump_stacks: also ``faulthandler.dump_traceback`` on alarm.
    :param recorder: optional ``FlightRecorder`` — its trailing
        ``dump_last_n`` step records go into the stall dump.
    :param spans: optional ``SpanRecorder`` — its currently-open spans
        go into the stall dump.
    :param dump_path: optional file path; each alarm (over)writes a JSON
        stall artifact ``{"stalled_s", "active_spans", "last_records"}``.
    :param heartbeat_path: optional file the beat touches (throttled to
        ``heartbeat_interval_s``) — a liveness signal for a supervisor
        watching from OUTSIDE the process (``PDT_HEARTBEAT_FILE``; the
        port's supervisor is ROADMAP A17). Works even with
        ``timeout_s == 0``.

    Usage::

        wd = StepWatchdog(timeout_s=300); wd.start()
        for batch in loader:
            ...
            wd.beat()
        wd.stop()
    """

    def __init__(self, timeout_s: float, dump_stacks: bool = True,
                 recorder=None, spans=None, dump_path=None,
                 dump_last_n: int = 16, heartbeat_path=None,
                 heartbeat_interval_s: float = 1.0):
        self.timeout_s = float(timeout_s)
        self.dump_stacks = dump_stacks
        self.recorder = recorder
        self.spans = spans
        self.dump_path = Path(dump_path) if dump_path else None
        self.dump_last_n = int(dump_last_n)
        self.heartbeat_path = (
            Path(heartbeat_path) if heartbeat_path else None
        )
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self._hb_last = 0.0
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.alarms = 0  # number of stall alarms fired (observable in tests)

    def start(self) -> None:
        self._touch_heartbeat(force=True)  # alive before the first step
        if self.timeout_s <= 0 or self._thread is not None:
            return
        self._last = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="step-watchdog", daemon=True
        )
        self._thread.start()

    def beat(self) -> None:
        self._last = time.monotonic()
        self._touch_heartbeat()

    def heartbeat_keepalive(self, interval_s: float = 1.0):
        """Context manager: touch the heartbeat from a side thread for
        the duration of a LEGITIMATE long host block — the end-of-run
        checkpoint flush, where no step will ever beat again but the
        process is making real progress. Without it, a supervisor
        ``--hang-timeout`` shorter than the final orbax flush would
        SIGKILL a healthy, finishing run mid-write. No-op when no
        heartbeat file is configured."""
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            if self.heartbeat_path is None:
                yield
                return
            stop = threading.Event()

            def pump():
                while not stop.wait(interval_s):
                    self._touch_heartbeat(force=True)

            t = threading.Thread(target=pump, name="heartbeat-keepalive",
                                 daemon=True)
            t.start()
            try:
                yield
            finally:
                stop.set()
                t.join(timeout=2)

        return _ctx()

    def _touch_heartbeat(self, force: bool = False) -> None:
        """Update the heartbeat file's mtime (the supervisor's liveness
        signal), at most once per ``heartbeat_interval_s`` — steps can
        be sub-millisecond and a per-step write would tax the loop."""
        if self.heartbeat_path is None:
            return
        now = time.monotonic()
        if not force and now - self._hb_last < self.heartbeat_interval_s:
            return
        self._hb_last = now
        try:
            with open(self.heartbeat_path, "w") as f:
                f.write(f"{time.time():.3f}\n")
        except OSError:
            pass  # liveness reporting must never kill the step loop

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5)
        self._thread = None

    # -- internals ----------------------------------------------------------

    def _run(self) -> None:
        # poll at a fraction of the timeout so alarms fire promptly without
        # busy-waiting
        poll = max(self.timeout_s / 4.0, 0.05)
        while not self._stop.wait(poll):
            stalled = time.monotonic() - self._last
            if stalled >= self.timeout_s:
                self.alarms += 1
                logger.error(
                    "Watchdog: no training step completed in %.0fs "
                    "(threshold %.0fs) — device/collective likely hung. "
                    "Dumping thread stacks to stderr.",
                    stalled, self.timeout_s,
                )
                # stacks FIRST: the telemetry dump touches the recorder
                # and span registries, and the guaranteed faulthandler
                # dump must never wait behind them
                if self.dump_stacks:
                    try:
                        faulthandler.dump_traceback(file=sys.stderr)
                    except Exception:  # stderr closed in exotic harnesses
                        pass
                self._dump_telemetry(stalled)
                self._last = time.monotonic()  # re-arm, repeat while stalled

    def stall_report(self, stalled_s: float) -> dict:
        """The stall artifact: active spans (what the process is stuck
        inside), the trailing step records (what it was doing before),
        and the host/device memory picture (was it dying of OOM?)."""
        report: dict = {"stalled_s": round(float(stalled_s), 1),
                        "t": time.time()}
        if self.spans is not None:
            try:
                report["active_spans"] = self.spans.active_spans()
            except Exception:
                pass
        if self.recorder is not None:
            try:
                report["last_records"] = self.recorder.last(
                    self.dump_last_n
                )
            except Exception:
                pass
        # the process's time-series window: a stall dump carries the
        # trend into the incident (was the queue growing for a minute,
        # or did the world stop cold?) when a store is registered (the
        # serving paths register one)
        from ..observability.timeseries import default_store

        ts = default_store()
        if ts is not None:
            report["timeseries_window"] = ts.points(last_n=self.dump_last_n)
        # memory probes: high-water marks make OOM-adjacent stalls
        # diagnosable post-mortem. Probes run on the monitor thread and
        # never block on the wedged device path (the caching
        # allocator's counters are host memory); each guarded
        # independently.
        try:
            from ..observability.telemetry import (
                device_memory_stats, host_rss_bytes,
            )

            rss = host_rss_bytes()
            if rss:
                report["host_rss_mb"] = round(rss / 2**20, 1)
            devices = device_memory_stats()
            if devices:
                report["devices"] = devices
        except Exception:
            pass
        return report

    def _dump_telemetry(self, stalled_s: float) -> None:
        """Log + (optionally) write the stall artifact. Never raises —
        diagnostics must not crash the run they diagnose."""
        if self.recorder is None and self.spans is None:
            return
        if self.recorder is not None:
            try:
                # force the JSONL tail to disk FIRST: a stall often ends
                # in an external SIGKILL, which runs no atexit hooks —
                # this is the last guaranteed chance to persist the ring
                self.recorder.flush()
            except Exception:
                pass
        try:
            report = self.stall_report(stalled_s)
            logger.error(
                "Watchdog stall report: %d active span(s) %s; "
                "last step record: %s",
                len(report.get("active_spans", [])),
                [s["name"] for s in report.get("active_spans", [])],
                (report.get("last_records") or [None])[-1],
            )
            if self.dump_path is not None:
                self.dump_path.parent.mkdir(parents=True, exist_ok=True)
                self.dump_path.write_text(json.dumps(report, default=repr))
                logger.error("Watchdog: stall dump written to %s",
                             self.dump_path)
        except Exception:
            logger.warning("watchdog stall dump failed", exc_info=True)
