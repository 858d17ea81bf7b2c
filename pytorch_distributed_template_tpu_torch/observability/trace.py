"""Lightweight span tracing: ``with span("data/next_batch"): ...`` (a copy
of the JAX package's ``observability/trace.py``).

Host-side structured timing for the paths ``torch.profiler`` does not
answer (it traces kernels; the question "was the step slow because of
data wait, checkpoint flush, or the dispatch itself?" is a HOST
timeline question). Spans nest, survive exceptions, cost two
``perf_counter`` calls plus a deque append, and record into a bounded
ring as Chrome trace-event ``"X"`` (complete) events — ``dump()``
writes a file that chrome://tracing and Perfetto load directly.

Two consumers beyond the viewer:

- the watchdog (utils/watchdog.py) snapshots ``active_spans()`` when a
  step stalls, so the dump says WHICH call never returned ("stuck 214 s
  inside checkpoint/save") next to the faulthandler stacks;
- tests assert nesting and exception safety on the recorded events.

The module-level ``span()`` uses one process-wide recorder
(``get_recorder()``); subsystems that want isolation construct their
own ``SpanRecorder`` and use its ``.span()`` method.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Optional


class SpanRecorder:
    """Bounded ring of finished spans + registry of open ones.

    Chrome trace-event fields per finished span: ``name``, ``ph: "X"``,
    ``ts``/``dur`` (microseconds, one process-wide monotonic origin),
    ``pid``/``tid``, and ``args`` (user attrs; ``error: true`` when the
    body raised).
    """

    def __init__(self, capacity: int = 8192):
        self.capacity = int(capacity)
        self.events: "collections.deque" = collections.deque(
            maxlen=self.capacity
        )
        self._lock = threading.Lock()
        # open spans per thread: {tid: [ {name, t0, args}, ... ]}
        self._open: dict = {}
        self._t0 = time.perf_counter()  # trace time origin

    # -- the core API --------------------------------------------------------

    @contextmanager
    def span(self, name: str, **attrs):
        tid = threading.get_ident()
        t0 = time.perf_counter()
        frame = {"name": name, "t0": t0, "args": attrs}
        with self._lock:
            self._open.setdefault(tid, []).append(frame)
        try:
            yield frame
        except BaseException:
            frame["args"] = {**frame["args"], "error": True}
            raise
        finally:
            t1 = time.perf_counter()
            with self._lock:
                stack = self._open.get(tid)
                if stack and stack[-1] is frame:
                    stack.pop()
                    if not stack:
                        del self._open[tid]
                event = {
                    "name": name,
                    "ph": "X",
                    "ts": round((t0 - self._t0) * 1e6, 1),
                    "dur": round((t1 - t0) * 1e6, 1),
                    "pid": os.getpid(),
                    "tid": tid,
                }
                if frame["args"]:
                    event["args"] = dict(frame["args"])
                self.events.append(event)

    # -- introspection -------------------------------------------------------

    def active_spans(self) -> list:
        """Currently-open spans across all threads, outermost first —
        the watchdog's 'what is the process stuck inside' snapshot."""
        now = time.perf_counter()
        out = []
        with self._lock:
            for tid, stack in self._open.items():
                for depth, frame in enumerate(stack):
                    out.append({
                        "tid": tid,
                        "depth": depth,
                        "name": frame["name"],
                        "elapsed_ms": round((now - frame["t0"]) * 1e3, 3),
                        **({"args": dict(frame["args"])}
                           if frame["args"] else {}),
                    })
        return out

    def drain(self) -> list:
        """Finished events so far; clears the ring."""
        with self._lock:
            out = list(self.events)
            self.events.clear()
        return out

    def snapshot(self) -> list:
        with self._lock:
            return list(self.events)

    # -- output --------------------------------------------------------------

    def to_chrome(self) -> dict:
        """The Chrome trace-event JSON object (load in chrome://tracing
        or Perfetto)."""
        return {"traceEvents": self.snapshot(),
                "displayTimeUnit": "ms"}

    def dump(self, path) -> Optional[Path]:
        """Write the Chrome trace file; returns the path (None when
        nothing was recorded)."""
        events = self.to_chrome()
        if not events["traceEvents"]:
            return None
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        # default=repr: span attrs are caller-arbitrary, and a single
        # non-JSON attr must not void the whole trace file
        path.write_text(json.dumps(events, default=repr))
        return path

    def clear(self) -> None:
        with self._lock:
            self.events.clear()


_default = SpanRecorder()


def get_recorder() -> SpanRecorder:
    """The process-wide recorder behind the module-level ``span()``."""
    return _default


def span(name: str, **attrs):
    """``with span("checkpoint/save"): ...`` on the default recorder."""
    return _default.span(name, **attrs)
