"""Sampled shadow-replay token-integrity auditor: a copy of the JAX
package's ``observability/audit.py``.

The serving stack's correctness story rests on ONE invariant: every
optimized path — paged warm admits, int8-KV, spill/ship/promote,
speculative decode, ring layouts — is token-identical to the cold
no-pool reference (greedy bit-exact; sampled exact under the request's
own seed). Tier-1 tests and bench gates enforce it at build time;
NOTHING enforced it on live traffic, where a stale adopted page or a
torn promote would serve wrong tokens invisibly. This module audits it
continuously:

- :class:`ShadowAuditor` samples COMPLETED requests — stratified by
  their serve-path fingerprint (reqtrace.path_fingerprint), so rare
  paths (ring wraps, tier promotes, shipped imports) get a coverage
  floor instead of drowning under the uniform majority — and replays
  prompt + sampling config + seed through a caller-supplied cold
  reference closure, comparing token ids EXACTLY.
- The replay runs on a background worker, OFF the scheduler hot path:
  completions ``offer()`` into a bounded queue; a full queue drops
  (counted), never blocks.
- Any mismatch increments ``token_divergence_total`` (and the
  per-fingerprint family), writes a bounded ``divergence_<rid>.json``
  bundle (both token streams, first-divergence index, the request's
  fingerprint + its reqtrace timeline) under the same max-dumps +
  cooldown discipline as the SLO watcher's slow-request dumps, and
  flips :meth:`healthy` — serve.py degrades ``/healthz`` on it so the
  fleet poller surfaces the replica.

Layout discipline: the reference closure MUST decode through the same
KV layout as the serving path. warm==cold is exact per layout;
int8-vs-f32 is a documented tolerance, so a cross-layout
reference would false-positive on healthy traffic. serve.py builds
the closure from the serving model itself — and for an int8-KV POOL
the reference gets its own private pool too, because pool pages and
the contiguous no-pool cache quantize at different granularities
(pool-cold is the exact peer of pool-warm; no-pool int8 is not).

Stdlib-only; torch enters only through the injected ``reference_fn``.
"""
from __future__ import annotations

import json
import logging
import queue as queue_mod
import threading
import time
from pathlib import Path
from typing import Callable, List, Optional

logger = logging.getLogger(__name__)

#: terminal classifications eligible for replay: a truncated request
#: (cancelled / deadline) stopped at an absorb boundary the reference
#: cannot reproduce, so comparing it would false-positive on healthy
#: traffic
AUDITABLE_OUTCOMES = ("length", "stop")


def first_divergence(a, b) -> int:
    """Index of the first position where two token streams differ
    (length difference counts); -1 when identical."""
    a, b = list(a), list(b)
    for i, (x, y) in enumerate(zip(a, b)):
        if int(x) != int(y):
            return i
    return -1 if len(a) == len(b) else min(len(a), len(b))


class ShadowAuditor:
    """Stratified shadow-replay worker over completed requests.

    ``reference_fn(record) -> list[int]`` replays the record's prompt +
    sampling config through the cold no-pool path and returns the
    token ids the reference produced (the serving layer owns how —
    typically a second GenerationService sharing model/params with no
    prefix cache). It runs on THIS auditor's worker thread and may
    take seconds; that is the design (the queue bounds the backlog).

    Sampling is deterministic (no RNG): per fingerprint, the first
    ``floor`` completions always audit — the coverage floor that keeps
    a 1%-of-traffic ring-wrap path covered — and after the floor a
    systematic 1-in-``round(1/sample_rate)`` of that fingerprint's
    completions audits, so coverage per path is exact and testable.
    """

    def __init__(self, reference_fn: Callable[[dict], List[int]],
                 sample_rate: float = 0.05, floor: int = 4,
                 queue_max: int = 64, dump_dir=None, tracer=None,
                 tsdb=None, max_dumps: int = 8,
                 cooldown_s: float = 30.0):
        self.reference_fn = reference_fn
        self.sample_rate = max(0.0, min(1.0, float(sample_rate)))
        self.floor = max(0, int(floor))
        self.dump_dir = Path(dump_dir) if dump_dir is not None else None
        self.tracer = tracer
        self._tsdb = tsdb
        self.max_dumps = int(max_dumps)
        self.cooldown_s = float(cooldown_s)
        self._last_dump_t: Optional[float] = None
        self._lock = threading.Lock()
        self._q: "queue_mod.Queue" = queue_mod.Queue(
            maxsize=max(1, int(queue_max)))
        # fingerprint -> completions seen / audited (coverage report)
        self._seen: dict = {}
        self._audited: dict = {}
        self._divergent: dict = {}
        self._c = {"audit_sampled_total": 0, "audit_matched_total": 0,
                   "token_divergence_total": 0,
                   "audit_dropped_total": 0, "audit_skipped_total": 0,
                   "audit_error_total": 0, "audit_dumps_written": 0}
        self._closed = False
        self._idle = threading.Event()
        self._idle.set()
        self._thread = threading.Thread(
            target=self._worker, daemon=True, name="shadow-audit")
        self._thread.start()

    # ---- completion-side API (hot path: must never block) -----------

    def offer(self, record: dict) -> bool:
        """One completed request's audit candidacy. ``record`` needs
        ``serve_path`` plus everything a replay takes: ``prompt_ids``,
        ``max_new_tokens``, ``temperature``, ``top_k``, ``top_p``,
        ``seed``, ``stop``, and the served ``ids`` (+ ``rid``,
        ``stop_reason``). Returns True when enqueued for replay."""
        if self._closed:
            return False
        if record.get("stop_reason", "length") not in AUDITABLE_OUTCOMES:
            with self._lock:
                self._c["audit_skipped_total"] += 1
            return False
        fp = str(record.get("serve_path") or "")
        if not fp:
            with self._lock:
                self._c["audit_skipped_total"] += 1
            return False
        with self._lock:
            n = self._seen.get(fp, 0)
            self._seen[fp] = n + 1
            if not self._take(n):
                return False
        try:
            self._q.put_nowait(dict(record))
            return True
        except queue_mod.Full:
            with self._lock:
                self._c["audit_dropped_total"] += 1
            return False

    def _take(self, n: int) -> bool:
        """Deterministic stratified pick for the ``n``-th completion of
        a fingerprint (0-based): everything under the floor, then
        systematic 1-in-k."""
        if n < self.floor:
            return True
        if self.sample_rate <= 0.0:
            return False
        k = max(1, round(1.0 / self.sample_rate))
        return (n - self.floor) % k == 0

    # ---- worker -----------------------------------------------------

    def _worker(self) -> None:
        while True:
            rec = self._q.get()
            if rec is None:
                return
            self._idle.clear()
            try:
                self._audit_one(rec)
            except Exception:  # noqa: BLE001 — the auditor must never
                # take the server down; an errored replay is counted,
                # not raised
                logger.exception("shadow audit error (rid=%s)",
                                 rec.get("rid"))
                with self._lock:
                    self._c["audit_error_total"] += 1
            finally:
                if self._q.empty():
                    self._idle.set()

    def _audit_one(self, rec: dict) -> None:
        fp = str(rec.get("serve_path") or "")
        replay = [int(t) for t in (self.reference_fn(rec) or ())]
        served = [int(t) for t in (rec.get("ids") or ())]
        div = first_divergence(served, replay)
        counters = None
        with self._lock:
            self._c["audit_sampled_total"] += 1
            self._audited[fp] = self._audited.get(fp, 0) + 1
            if div < 0:
                self._c["audit_matched_total"] += 1
            else:
                self._c["token_divergence_total"] += 1
                self._divergent[fp] = self._divergent.get(fp, 0) + 1
            if self._tsdb is not None:
                counters = {
                    "audit_sampled_total": self._c[
                        "audit_sampled_total"],
                    "token_divergence_total": self._c[
                        "token_divergence_total"]}
        if counters is not None:
            # verdict counters ride the TimeSeriesStore so stall /
            # anomaly dumps carry the audit trend alongside goodput
            self._tsdb.observe(counters=counters)
        if div < 0:
            return
        logger.error(
            "TOKEN DIVERGENCE rid=%s fingerprint=%s first_index=%d "
            "(served %d tokens, replay %d)", rec.get("rid"), fp, div,
            len(served), len(replay))
        self._maybe_dump(rec, fp, served, replay, div)

    def _maybe_dump(self, rec, fp, served, replay, div) -> None:
        if self.dump_dir is None:
            return
        now = time.monotonic()
        with self._lock:
            if self._c["audit_dumps_written"] >= self.max_dumps:
                return
            if (self._last_dump_t is not None
                    and now - self._last_dump_t < self.cooldown_s):
                return
            self._c["audit_dumps_written"] += 1
            self._last_dump_t = now
        rid = str(rec.get("rid") or "unknown")
        payload = {
            "rid": rid,
            "fingerprint": fp,
            "first_divergence": div,
            "served_ids": served,
            "replay_ids": replay,
            "prompt_ids": list(rec.get("prompt_ids") or ()),
            "sampling": {
                k: rec.get(k) for k in
                ("max_new_tokens", "temperature", "top_k", "top_p",
                 "seed", "stop")},
            "stop_reason": rec.get("stop_reason"),
        }
        if self.tracer is not None:
            # the request's pool/page event timeline (admit mode, kv
            # adoptions, tier promotes) — the forensic half of the
            # bundle: WHICH event put the wrong bytes in reach
            payload["timeline"] = self.tracer.timeline(rid)
        try:
            self.dump_dir.mkdir(parents=True, exist_ok=True)
            path = Path(self.dump_dir) / f"divergence_{rid}.json"
            path.write_text(json.dumps(payload, indent=2,
                                       default=repr))
            logger.error("divergence bundle written: %s", path)
        except OSError:
            logger.exception("divergence bundle write failed")

    # ---- observability ----------------------------------------------

    def healthy(self) -> bool:
        """False once any replay diverged — serve.py degrades
        ``/healthz`` on it so the fleet poller surfaces the replica."""
        with self._lock:
            return self._c["token_divergence_total"] == 0

    def stats(self) -> dict:
        """Flat counters + queue gauge for /metrics."""
        with self._lock:
            out = dict(self._c)
        out["audit_queue_depth"] = self._q.qsize()
        return out

    def coverage(self) -> dict:
        """fingerprint -> {seen, audited, divergent} (the coverage
        report the serve_audit rung and the fleet dashboard read)."""
        with self._lock:
            fps = set(self._seen) | set(self._audited)
            return {fp: {"seen": self._seen.get(fp, 0),
                         "audited": self._audited.get(fp, 0),
                         "divergent": self._divergent.get(fp, 0)}
                    for fp in sorted(fps)}

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Block until the queue is empty and the worker idles (tests
        and the serve_audit rung use this to read final verdicts)."""
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline:
            if self._q.empty() and self._idle.is_set():
                return True
            time.sleep(0.01)
        return False

    def close(self) -> None:
        self._closed = True
        self._q.put(None)
