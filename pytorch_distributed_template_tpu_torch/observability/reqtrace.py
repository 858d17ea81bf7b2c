"""Request-scoped distributed tracing across the serving fleet: a copy of
the JAX package's ``observability/reqtrace.py`` (the port imports nothing
of that package, not even its stdlib-only modules).

The serving stack spans up to three processes per request (fleet
router -> serve.py replica -> engine scheduler), but the span tracing
that exists (observability/trace.py) is process-local: each process
dumps its own Chrome trace with no shared request identity, so a slow
p99 request cannot be decomposed into router-queue vs admission-wait
vs admit vs decode time. This module is the Dapper/OpenTelemetry-style
layer on top:

- **Identity**: the first hop (router, or serve.py for direct
  traffic) mints a request id (:func:`mint_request_id`) and
  propagates it via the ``X-Request-Id`` header; every hop echoes it
  back on the response, so a client log line joins server-side spans.
- **Recording**: each process appends request-keyed span records to
  its own ``spans.jsonl`` through a :class:`RequestTracer` — one JSON
  line per span, wall-clock anchored (each file opens with an anchor
  record pairing ``time.time()`` with ``time.monotonic()``), written
  line-buffered so a live fleet can be stitched mid-run and a crash
  loses at most one torn line.
- **Stitching**: :func:`stitch_spans` merges the per-process files
  into per-request timelines, aligning clocks causally (a replica
  span can never start before the router dispatched it — skewed files
  are shifted by the median violation), decomposes each request into
  non-overlapping segments (router queue / WFQ admission wait / proxy
  hop / replica queue / admit-to-first-token / decode / stream — plus
  ``page_ship`` on disaggregated fleets: the prefill-stage execution +
  page transfer + decode-side import of a prefill→decode handoff), and
  reports the residual instead of hiding it. :func:`to_perfetto`
  emits one merged Chrome/Perfetto trace with flow events linking the
  router's proxy span to the replica's handler span per request.
- **SLO plumbing**: :class:`SloWatcher` checks per-request TTFT/e2e
  against configured thresholds, maintains ``slo_breach_total``
  counters (scraped via ``/metrics`` at both router and replica), and
  writes bounded ``slow_request_<rid>.json`` dumps carrying the
  request's full span timeline — modeled on the health layer's
  anomaly dumps (cooldown + max_dumps, so a bad hour cannot fill a
  disk).

Stdlib-only. The port's ``serve.py`` writes ``spans.jsonl`` through
:class:`RequestTracer` (on by default, ``--reqtrace off`` disables it) and
the engines stamp their spans at their existing sync points; the
stitcher's CLI and report renderer are later work (ROADMAP A19).
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional

# one percentile convention package-wide (linear interpolation):
# loadgen's client summaries, this stitcher, and the engines must
# never disagree on what "p99" means
from ..utils.promtext import percentile as _pctl

SPANS_FILENAME = "spans.jsonl"

# ---------------------------------------------------------------------------
# request ids
# ---------------------------------------------------------------------------

_RID_OK = re.compile(r"^[A-Za-z0-9_.:-]{1,64}$")


def mint_request_id() -> str:
    """A fresh 16-hex request id (collision odds are irrelevant at
    fleet request rates; short enough to grep and to echo in headers)."""
    return uuid.uuid4().hex[:16]


def sanitize_request_id(rid) -> Optional[str]:
    """A client-supplied ``X-Request-Id`` value, validated — or None
    when absent/hostile (caller mints a fresh one). Bounded charset and
    length: the id lands in filenames (slow-request dumps) and JSONL."""
    if not rid or not isinstance(rid, str):
        return None
    rid = rid.strip()
    return rid if _RID_OK.match(rid) else None


# ---------------------------------------------------------------------------
# deadline propagation
# ---------------------------------------------------------------------------

DEADLINE_HEADER = "X-Deadline-Ms"
DEADLINE_EXPIRED_HEADER = "X-Deadline-Expired"

#: clamp bounds for a client-supplied deadline budget (milliseconds):
#: 0/negative is meaningless, and anything past an hour is "no deadline
#: in practice" — clamping keeps hostile headers from minting huge ints
MIN_DEADLINE_MS = 1
MAX_DEADLINE_MS = 3_600_000


class Deadline:
    """A request's remaining time budget, monotonic-clock only.

    The wire form is RELATIVE (``X-Deadline-Ms: 1500`` = "you have
    1.5 s from receipt"), so propagation is clock-skew-free by
    construction: each hop anchors the budget to its OWN
    ``time.monotonic()`` at receipt and forwards the REMAINING budget
    (``header_value()``), never an absolute timestamp two clocks could
    disagree about. Wall-clock steps (NTP) cannot move a deadline
    mid-request."""

    __slots__ = ("t0", "budget_s")

    def __init__(self, budget_s: float, t0: Optional[float] = None):
        self.budget_s = float(budget_s)
        self.t0 = time.monotonic() if t0 is None else float(t0)

    @classmethod
    def from_header(cls, value, t0: Optional[float] = None
                    ) -> Optional["Deadline"]:
        """Parse an ``X-Deadline-Ms`` header -> Deadline, or None when
        absent. Raises ``ValueError`` on a malformed value (the caller
        answers 400 — a silently dropped deadline would serve an
        unbounded request the client thinks is bounded)."""
        if value is None or (isinstance(value, str)
                             and not value.strip()):
            return None
        ms = int(str(value).strip())     # ValueError on garbage
        if ms <= 0:
            raise ValueError(f"{DEADLINE_HEADER} must be a positive "
                             f"integer (got {ms})")
        ms = max(MIN_DEADLINE_MS, min(ms, MAX_DEADLINE_MS))
        return cls(ms / 1e3, t0=t0)

    def remaining_s(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        return self.budget_s - (now - self.t0)

    def expired(self, now: Optional[float] = None) -> bool:
        return self.remaining_s(now) <= 0.0

    def header_value(self, now: Optional[float] = None) -> str:
        """The REMAINING budget for the next hop (floor 1 ms: a
        forwarded deadline of 0 would be a malformed header)."""
        return str(max(int(round(self.remaining_s(now) * 1e3)),
                       MIN_DEADLINE_MS))

    def deadline_at(self) -> float:
        """Absolute monotonic expiry (engine-internal convenience)."""
        return self.t0 + self.budget_s


# ---------------------------------------------------------------------------
# serve-path provenance
# ---------------------------------------------------------------------------

SERVE_PATH_HEADER = "X-Serve-Path"

#: admit modes, mutually exclusive — the first fingerprint token.
#: ``stream`` is a chunked streaming-prefill admission (paged
#: underneath, but its correctness surface — per-chunk scatter + ring
#: slack accounting — is its own path).
PATH_MODES = ("cold", "warm", "paged", "stream")

#: ordered feature flags; a fingerprint includes the ones that are
#: truthy in the path dict, in THIS order, so the same feature set
#: always renders the same string (the string keys a metric family —
#: ``serve_path_<fp>_total`` — and strings that differ only by token
#: order would split one path's counts across two series).
#:
#:   int8    - pool pages hold quantized KV (kv layout)
#:   ring    - sliding-window ring layout pool
#:   wrap    - this request's ring actually wrapped (ring_wrap plan)
#:   adopt   - admit consumed adopted (radix-shared) pool pages
#:   promote - admit consumed pages promoted back from a spill tier
#:   pull    - admit consumed pages pulled from a peer replica's pool
#:   ship    - admit consumed pages imported from a shipped payload
#:             (disaggregated prefill→decode handoff)
#:   spec    - speculative decode produced the tokens
PATH_FLAGS = ("int8", "ring", "wrap", "adopt", "promote", "pull",
              "ship", "spec")

_FP_OK = re.compile(r"^[a-z0-9_]{1,96}$")


def path_fingerprint(path: dict) -> str:
    """A request's path dict -> its compact fingerprint string.

    The dict is accumulated by whichever scheduler served the request
    (``mode`` + the :data:`PATH_FLAGS` booleans + ``tp``/``dp``/
    ``brownout`` ints); the string is lowercase ``[a-z0-9_]`` only, so
    it is simultaneously a legal ``X-Serve-Path`` header value and a
    legal metric-name fragment (``serve_path_<fp>_total`` passes the
    prometheus charset and the repo's promtext lint)."""
    mode = str(path.get("mode") or "cold")
    toks = [mode if mode in PATH_MODES else "cold"]
    for flag in PATH_FLAGS:
        if path.get(flag):
            toks.append(flag)
    tp = int(path.get("tp") or 1)
    if tp > 1:
        toks.append(f"tp{tp}")
    dp = int(path.get("dp") or 1)
    if dp > 1:
        toks.append(f"dp{dp}")
    level = int(path.get("brownout") or 0)
    if level > 0:
        toks.append(f"b{level}")
    return "_".join(toks)


def sanitize_serve_path(value) -> Optional[str]:
    """A propagated ``X-Serve-Path`` value, validated — or None when
    absent/hostile. Bounded lowercase charset: the value lands in
    metric names and loadgen summaries verbatim."""
    if not value or not isinstance(value, str):
        return None
    value = value.strip()
    return value if _FP_OK.match(value) else None


def fingerprint_features(fp: str) -> List[str]:
    """Fingerprint -> its feature tokens (attribution unit: the audit
    report ranks these across divergence bundles). The mode token is
    prefixed ``mode_`` so ``cold`` the mode never collides with a
    future flag named cold."""
    toks = [t for t in str(fp).split("_") if t]
    if not toks:
        return []
    return [f"mode_{toks[0]}"] + toks[1:]


# ---------------------------------------------------------------------------
# the per-process tracer
# ---------------------------------------------------------------------------


class RequestTracer:
    """Append request-keyed span records to one ``spans.jsonl``.

    Each record::

        {"rid": ..., "name": ..., "proc": ..., "pid": ..., "tid": ...,
         "t": <epoch seconds>, "dur_ms": ..., "attrs": {...}?}

    Times are wall-clock (epoch) floats derived from monotonic
    measurements through a per-process anchor captured at construction
    — callers time with ``time.monotonic()`` (never subject to NTP
    steps mid-request) and the stitcher gets absolute timestamps it
    can align across processes. The file opens append + line-buffered:
    concurrent tracers in one process serialize on a lock, a crash
    loses at most the torn tail line (the stitcher skips it), and a
    live fleet can be stitched mid-run.

    A bounded in-memory ring keeps the most recent records so the
    :class:`SloWatcher` can dump a slow request's full timeline
    without re-reading the file.
    """

    def __init__(self, path, process: str = "serve",
                 ring: int = 4096):
        self.path = Path(path)
        self.process = str(process)
        self.pid = os.getpid()
        self._anchor_epoch = time.time()
        self._anchor_mono = time.monotonic()
        self._lock = threading.Lock()
        self._ring: "deque" = deque(maxlen=int(ring))
        self.records_written = 0
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a", buffering=1)
        self._write({"anchor": 1, "proc": self.process, "pid": self.pid,
                     "epoch": round(self._anchor_epoch, 6),
                     "mono": round(self._anchor_mono, 6)})

    # -- internals ----------------------------------------------------------

    def _epoch(self, mono: float) -> float:
        return self._anchor_epoch + (mono - self._anchor_mono)

    def _write(self, rec: dict) -> None:
        # default=repr: attrs are caller-arbitrary; one bad value must
        # not void the line (same contract as trace.py's dump)
        line = json.dumps(rec, default=repr)
        with self._lock:
            if self._f is not None:
                try:
                    self._f.write(line + "\n")
                    self.records_written += 1
                except (OSError, ValueError):
                    pass                 # a full disk must not 500 requests
            if "anchor" not in rec:
                self._ring.append(rec)

    # -- recording ----------------------------------------------------------

    def add(self, rid: str, name: str, t0: float,
            t1: Optional[float] = None, **attrs) -> None:
        """Record a span measured by the caller with
        ``time.monotonic()``: ``t0`` start, ``t1`` end (None = instant
        event at ``t0``)."""
        rec = {
            "rid": str(rid), "name": str(name),
            "proc": self.process, "pid": self.pid,
            "tid": threading.get_ident() % 1_000_000,
            "t": round(self._epoch(t0), 6),
            "dur_ms": (round((t1 - t0) * 1e3, 3)
                       if t1 is not None else 0.0),
        }
        if attrs:
            rec["attrs"] = attrs
        self._write(rec)

    def event(self, rid: str, name: str, **attrs) -> None:
        """Instant event at now."""
        self.add(rid, name, time.monotonic(), None, **attrs)

    @contextmanager
    def span(self, rid: str, name: str, **attrs):
        """``with tracer.span(rid, "proxy", replica="r1"): ...`` —
        records even when the body raises (``error: true`` attr)."""
        t0 = time.monotonic()
        try:
            yield attrs
        except BaseException:
            attrs = {**attrs, "error": True}
            raise
        finally:
            self.add(rid, name, t0, time.monotonic(), **attrs)

    # -- introspection / lifecycle ------------------------------------------

    def timeline(self, rid: str) -> List[dict]:
        """Recent records for one request (the SLO dump payload)."""
        rid = str(rid)
        with self._lock:
            return [dict(r) for r in self._ring if r.get("rid") == rid]

    def flush(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.flush()
                except (OSError, ValueError):
                    pass

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None


# ---------------------------------------------------------------------------
# SLO watcher: thresholds -> counters + bounded slow-request dumps
# ---------------------------------------------------------------------------


class SloWatcher:
    """Per-request SLO check with bounded forensic dumps.

    ``observe(rid, ttft_s=..., e2e_s=...)`` compares against the
    configured thresholds (None = not checked). Every breach bumps the
    counters; at most ``max_dumps`` ``slow_request_<rid>.json`` files
    are written, no closer together than ``cooldown_s`` (wall time) —
    the same bounding discipline as the health layer's anomaly dumps,
    because the pathology that breaches SLOs is exactly the pathology
    that breaches them thousands of times an hour. The dump carries
    the request's span timeline from the tracer's ring, so "p99 was
    300 ms" comes with "240 ms of it was WFQ wait"."""

    def __init__(self, ttft_s: Optional[float] = None,
                 e2e_s: Optional[float] = None,
                 dump_dir=None, tracer: Optional[RequestTracer] = None,
                 max_dumps: int = 8, cooldown_s: float = 30.0):
        self.ttft_s = float(ttft_s) if ttft_s else None
        self.e2e_s = float(e2e_s) if e2e_s else None
        self.dump_dir = Path(dump_dir) if dump_dir is not None else None
        self.tracer = tracer
        self.max_dumps = int(max_dumps)
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        self._c = {"slo_breach_total": 0, "slo_ttft_breach_total": 0,
                   "slo_e2e_breach_total": 0, "slo_dumps_written": 0}
        self._last_dump_t: Optional[float] = None

    @property
    def enabled(self) -> bool:
        return self.ttft_s is not None or self.e2e_s is not None

    #: terminal classifications that are OUT of the served-latency SLO:
    #: a cancelled request's latency is the client's choice, a
    #: deadline-truncated one's is the deadline's — counting
    #: either as a breach would punish the mechanisms that bound tails
    EXEMPT_OUTCOMES = ("cancelled", "deadline")

    def observe(self, rid: str, ttft_s: Optional[float] = None,
                e2e_s: Optional[float] = None, **extra) -> List[str]:
        """Returns the breach reasons (empty = inside SLO)."""
        if extra.get("stop_reason") in self.EXEMPT_OUTCOMES:
            return []
        reasons = []
        if (self.ttft_s is not None and ttft_s is not None
                and ttft_s > self.ttft_s):
            reasons.append("ttft")
        if (self.e2e_s is not None and e2e_s is not None
                and e2e_s > self.e2e_s):
            reasons.append("e2e")
        if not reasons:
            return reasons
        now = time.monotonic()
        dump = False
        with self._lock:
            self._c["slo_breach_total"] += 1
            if "ttft" in reasons:
                self._c["slo_ttft_breach_total"] += 1
            if "e2e" in reasons:
                self._c["slo_e2e_breach_total"] += 1
            if (self.dump_dir is not None
                    and self._c["slo_dumps_written"] < self.max_dumps
                    and (self._last_dump_t is None
                         or now - self._last_dump_t >= self.cooldown_s)):
                self._c["slo_dumps_written"] += 1
                self._last_dump_t = now
                dump = True
        if dump:
            self._dump(rid, reasons, ttft_s, e2e_s, extra)
        return reasons

    def _dump(self, rid, reasons, ttft_s, e2e_s, extra) -> None:
        payload = {
            "rid": str(rid),
            "reasons": reasons,
            "ttft_s": ttft_s,
            "e2e_s": e2e_s,
            "thresholds": {"ttft_s": self.ttft_s, "e2e_s": self.e2e_s},
            "t": time.time(),
            **({"extra": extra} if extra else {}),
        }
        if self.tracer is not None:
            payload["timeline"] = self.tracer.timeline(rid)
        try:
            self.dump_dir.mkdir(parents=True, exist_ok=True)
            safe = sanitize_request_id(str(rid)) or "unknown"
            path = self.dump_dir / f"slow_request_{safe}.json"
            path.write_text(json.dumps(payload, indent=2, default=repr))
        except OSError:
            pass                          # forensics are best-effort

    def stats(self) -> dict:
        with self._lock:
            return dict(self._c)


# ---------------------------------------------------------------------------
# stitching: per-process spans.jsonl files -> cross-process timelines
# ---------------------------------------------------------------------------


def discover_span_files(run_dir) -> List[Path]:
    """Every ``spans.jsonl`` under a fleet run dir (the router writes
    one at the top, each replica one under its save dir)."""
    return sorted(Path(run_dir).rglob(SPANS_FILENAME))


def resolve_span_files(explicit=None, run_dir=None) -> List[Path]:
    """Explicit span paths + run-dir discovery, deduped on the
    RESOLVED path — the one owner of the invariant that an overlap
    (``--spans run/spans.jsonl --run-dir run``) must not double-load
    every span record. Explicit paths keep their caller-given order,
    discovered ones follow."""
    files: List[Path] = []
    candidates = list(explicit or [])
    if run_dir is not None:
        candidates += discover_span_files(run_dir)
    for f in candidates:
        p = Path(f).resolve()
        if p not in files:
            files.append(p)
    return files


def load_spans(paths) -> List[dict]:
    """Parse span files; torn tail lines (live runs, crashes) skip."""
    spans: List[dict] = []
    for path in paths:
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
                    if isinstance(rec, dict):
                        spans.append(rec)
        except OSError:
            continue
    return spans


def _proc_key(rec: dict) -> tuple:
    return (rec.get("proc", "?"), rec.get("pid", 0))


def _by_rid(spans: List[dict]) -> Dict[str, List[dict]]:
    out: Dict[str, List[dict]] = {}
    for s in spans:
        rid = s.get("rid")
        if rid:
            out.setdefault(rid, []).append(s)
    return out


def _named(recs: List[dict], name: str,
           proc: Optional[str] = None) -> Optional[dict]:
    for r in recs:
        if r.get("name") == name and (proc is None
                                      or r.get("proc") == proc):
            return r
    return None


def _last_named(recs: List[dict], name: str,
                proc: Optional[str] = None) -> Optional[dict]:
    """The LATEST-starting matching span. A router retry records one
    ``proxy`` span per attempt under the same rid; the attempt that
    actually carried the request is the last one — attribution and
    flow linkage must not anchor on a dead first attempt."""
    best = None
    for r in recs:
        if r.get("name") == name and (proc is None
                                      or r.get("proc") == proc):
            if best is None or float(r.get("t", 0.0)) \
                    >= float(best.get("t", 0.0)):
                best = r
    return best


def estimate_offsets(spans: List[dict]) -> Dict[tuple, float]:
    """Causal clock alignment per (proc, pid).

    Single-host fleets share one wall clock, but multi-host (or
    synthetic/test) span sets can carry skew. The causal invariant:
    a replica's handler span cannot START before the router's proxy
    span for the same request did (the request had not been sent yet).
    For each non-router process, collect ``proxy.t - http.t`` over the
    rids both sides recorded; when the median is positive (the child
    systematically appears to start BEFORE its parent), the child's
    clock is behind — shift that process forward by the median
    violation. Processes already causal (median <= 0) are untouched:
    genuine queueing delay must not be "aligned" away."""
    deltas: Dict[tuple, List[float]] = {}
    for rid, recs in _by_rid(spans).items():
        proxy = _last_named(recs, "proxy", proc="router")
        if proxy is None:
            continue
        http = _named(recs, "http")
        if http is None or http.get("proc") == "router":
            continue
        deltas.setdefault(_proc_key(http), []).append(
            float(proxy["t"]) - float(http["t"]))
    offsets: Dict[tuple, float] = {}
    for key, ds in deltas.items():
        ds = sorted(ds)
        med = ds[len(ds) // 2]
        if med > 0.0:
            offsets[key] = med
    return offsets


def apply_offsets(spans: List[dict],
                  offsets: Dict[tuple, float]) -> List[dict]:
    if not offsets:
        return spans
    out = []
    for s in spans:
        off = offsets.get(_proc_key(s))
        if off and "t" in s:
            s = dict(s, t=float(s["t"]) + off)
        out.append(s)
    return out


def _t1(rec: dict) -> float:
    return float(rec["t"]) + float(rec.get("dur_ms", 0.0)) / 1e3


def _segments(recs: List[dict]) -> Dict[str, float]:
    """One request's non-overlapping latency segments, from whichever
    spans exist (full fleet path, or direct-to-replica with no router
    spans). Every segment is clamped at >= 0; missing spans simply
    produce fewer segments — the residual column owns the gap."""
    req = _named(recs, "request", proc="router")
    aw = _named(recs, "admission_wait", proc="router")
    proxy = _last_named(recs, "proxy", proc="router")
    ship = _named(recs, "page_ship", proc="router")
    pull = _named(recs, "peer_pull", proc="router")
    tier = _named(recs, "tier")
    http = _named(recs, "http")
    if http is not None and http.get("proc") == "router":
        http = None
    qw = _named(recs, "queue_wait")
    ft = _named(recs, "first_token")
    done = _named(recs, "complete")

    seg: Dict[str, float] = {}

    def put(name, value):
        if value is not None and value == value:   # drop NaN
            seg[name] = max(round(float(value), 6), 0.0)

    if req is not None and aw is not None:
        put("router_recv", float(aw["t"]) - float(req["t"]))
    if aw is not None:
        put("admission_wait", float(aw.get("dur_ms", 0.0)) / 1e3)
    if ship is not None:
        # disaggregated handoff: the 12th segment. The
        # router's page_ship span runs from the prefill-stage dispatch
        # to the decode-stage dispatch — remote prefill execution +
        # page transfer + decode-side import as one non-overlapping
        # slice; ``route`` then covers only the routing ahead of it,
        # and the decode proxy span (the LAST proxy — _last_named)
        # starts where page_ship ends, so the decomposition stays
        # gap-free and coverage holds.
        put("page_ship", float(ship.get("dur_ms", 0.0)) / 1e3)
        if aw is not None:
            put("route", float(ship["t"]) - _t1(aw))
    elif pull is not None and aw is not None:
        # miss-driven peer page pull: the router pulled a
        # peer's pages ahead of the proxy hop — its own slice, with
        # "route" ending where the pull begins (the proxy span starts
        # right after the pull, so the decomposition stays gap-free)
        put("peer_pull", float(pull.get("dur_ms", 0.0)) / 1e3)
        put("route", float(pull["t"]) - _t1(aw))
    elif proxy is not None and aw is not None:
        put("route", float(proxy["t"]) - _t1(aw))
    if proxy is not None and http is not None:
        put("proxy_send", float(http["t"]) - float(proxy["t"]))
    if http is not None and qw is not None:
        put("replica_recv", float(qw["t"]) - float(http["t"]))
    if tier is not None:
        # spill-tier promotion: runs at tick start while
        # the request is still queued, INSIDE the queue_wait window —
        # carved out below so the two stay non-overlapping
        put("tier", float(tier.get("dur_ms", 0.0)) / 1e3)
    if qw is not None:
        put("scheduler_queue",
            float(qw.get("dur_ms", 0.0)) / 1e3
            - (float(tier.get("dur_ms", 0.0)) / 1e3
               if tier is not None else 0.0))
    if ft is not None and qw is not None:
        put("admit", float(ft["t"]) - _t1(qw))
    if done is not None and ft is not None:
        put("decode", float(done["t"]) - float(ft["t"]))
    if http is not None and done is not None:
        put("stream", _t1(http) - float(done["t"]))
    if proxy is not None and http is not None:
        put("proxy_return", _t1(proxy) - _t1(http))
    if req is not None and proxy is not None:
        put("router_send", _t1(req) - _t1(proxy))
    return seg


def stitch_spans(spans: List[dict],
                 client_e2e_by_rid: Optional[Dict[str, float]] = None
                 ) -> dict:
    """Merge span records into per-request timelines + attribution.

    Returns::

        {"offsets": {"proc:pid": seconds_shifted, ...},
         "counts": {"requests": N, "stitched": n_cross_process,
                    "partial": n_single_process},
         "requests": [{"rid", "procs", "stitched", "e2e_s",
                       "e2e_source", "ttft_s", "segments": {...},
                       "attributed_s", "coverage", "residual_s",
                       "tokens"?}, ...]}

    A request is **stitched** when spans from >= 2 processes agree on
    its rid (the cross-process contract CI gates on); single-process
    rids are **partial** — orphan spans are reported, never dropped
    silently. ``e2e_s`` prefers the client's measured total (when a
    loadgen summary is joined in), falling back to the router request
    span, then the replica handler span; ``coverage`` is the attributed
    fraction and ``residual_s`` the remainder — reported, not hidden.
    """
    offsets = estimate_offsets(spans)
    spans = apply_offsets(spans, offsets)
    rows = []
    stitched = partial = 0
    for rid, recs in sorted(_by_rid(spans).items()):
        recs = sorted(recs, key=lambda r: float(r.get("t", 0.0)))
        procs = sorted({r.get("proc", "?") for r in recs})
        seg = _segments(recs)
        req = _named(recs, "request", proc="router")
        http = _named(recs, "http")
        done = _named(recs, "complete")
        ft = _named(recs, "first_token")
        e2e = None
        source = None
        if client_e2e_by_rid and rid in client_e2e_by_rid:
            e2e = float(client_e2e_by_rid[rid])
            source = "client"
        elif req is not None:
            e2e = float(req.get("dur_ms", 0.0)) / 1e3
            source = "router"
        elif http is not None:
            e2e = float(http.get("dur_ms", 0.0)) / 1e3
            source = "replica"
        attributed = round(sum(seg.values()), 6)
        is_stitched = len(procs) >= 2
        if is_stitched:
            stitched += 1
        else:
            partial += 1
        row = {
            "rid": rid,
            "procs": procs,
            "stitched": is_stitched,
            "spans": len(recs),
            "segments": seg,
            "attributed_s": attributed,
        }
        if ft is not None:
            ttft = (ft.get("attrs") or {}).get("ttft_s")
            if ttft is not None:
                row["ttft_s"] = float(ttft)
        if done is not None:
            tokens = (done.get("attrs") or {}).get("tokens")
            if tokens is not None:
                row["tokens"] = int(tokens)
        if e2e is not None:
            row["e2e_s"] = round(e2e, 6)
            row["e2e_source"] = source
            row["residual_s"] = round(e2e - attributed, 6)
            row["coverage"] = (round(attributed / e2e, 4)
                               if e2e > 0 else None)
        rows.append(row)
    return {
        "offsets": {f"{p}:{pid}": round(off, 6)
                    for (p, pid), off in offsets.items()},
        "counts": {"requests": len(rows), "stitched": stitched,
                   "partial": partial},
        "requests": rows,
    }


def attribution(stitched: dict) -> dict:
    """Tail-latency attribution over stitched requests: per-segment
    p50/p99 seconds, e2e/TTFT percentiles, median coverage, and the
    p99 request's own breakdown (the "where did THAT request's time
    go" row). Residuals are first-class: ``residual_p99_s`` says how
    much of the tail the spans do NOT explain."""
    rows = [r for r in stitched.get("requests", ())
            if r.get("stitched") and r.get("e2e_s") is not None]
    # NOT "requests": that name belongs to the stitch counts (total
    # ids seen); this is the subset that was cross-process stitched
    # WITH a measured e2e — the rows the percentiles below come from
    out: dict = {"attributed_requests": len(rows)}
    if not rows:
        return out
    names = sorted({n for r in rows for n in r["segments"]})
    for name in names:
        vals = sorted(r["segments"][name] for r in rows
                      if name in r["segments"])
        out[f"seg_{name}_p50_s"] = round(_pctl(vals, 0.50), 6)
        out[f"seg_{name}_p99_s"] = round(_pctl(vals, 0.99), 6)
    e2es = sorted(r["e2e_s"] for r in rows)
    out["e2e_p50_s"] = round(_pctl(e2es, 0.50), 6)
    out["e2e_p99_s"] = round(_pctl(e2es, 0.99), 6)
    ttfts = sorted(r["ttft_s"] for r in rows if r.get("ttft_s")
                   is not None)
    if ttfts:
        out["ttft_p50_s"] = round(_pctl(ttfts, 0.50), 6)
        out["ttft_p99_s"] = round(_pctl(ttfts, 0.99), 6)
    covs = sorted(r["coverage"] for r in rows
                  if r.get("coverage") is not None)
    if covs:
        out["coverage_p50"] = round(_pctl(covs, 0.50), 4)
        out["coverage_min"] = round(covs[0], 4)
    residuals = sorted(abs(r["residual_s"]) for r in rows
                       if r.get("residual_s") is not None)
    if residuals:
        out["residual_p99_s"] = round(_pctl(residuals, 0.99), 6)
    # the p99 request, decomposed: sort by e2e, take the p99 index row
    worst = sorted(rows, key=lambda r: r["e2e_s"])[
        min(len(rows) - 1, int(0.99 * len(rows)))]
    out["p99_request"] = {
        "rid": worst["rid"], "e2e_s": worst["e2e_s"],
        "segments": worst["segments"],
        "residual_s": worst.get("residual_s"),
    }
    return out


# ---------------------------------------------------------------------------
# Perfetto / Chrome trace output
# ---------------------------------------------------------------------------


def _flow_id(rid: str) -> int:
    # stable across runs of the stitcher (hash() is salted per process)
    h = 0
    for ch in rid:
        h = (h * 131 + ord(ch)) & 0x7FFFFFFF
    return h or 1


#: virtual thread id for the modeled kernel-class track — far above any
#: real tid so the anatomy row never interleaves with measured spans
_ANATOMY_TID = 999_983


def to_perfetto(spans: List[dict],
                offsets: Optional[Dict[tuple, float]] = None,
                anatomy: Optional[dict] = None,
                anatomy_rids=None) -> dict:
    """One merged Chrome-trace-event JSON over every process's spans,
    with per-process ``process_name`` metadata and ``s``/``f`` flow
    events linking the router's proxy span to the replica's handler
    span per request — load it in Perfetto and follow a request across
    process rows.

    ``anatomy`` is a rendered ``decode_step_anatomy``
    section (observability/anatomy.render_anatomy — classes with
    ``frac_time``/``bound`` + ``dispatch_gap_frac``): each selected
    request's decode window (first_token -> complete) gains a "step
    anatomy (modeled)" track splitting it into kernel-class slices
    proportional to their modeled time share, with the dispatch gap as
    its own trailing slice. ``anatomy_rids`` restricts the expansion
    (trace_stitch passes the p99 request); None expands every stitched
    decode window."""
    if offsets is None:
        offsets = estimate_offsets(spans)
    spans = apply_offsets(spans, offsets)
    events: List[dict] = []
    pid_map: Dict[tuple, int] = {}

    def pid_for(rec: dict) -> int:
        key = _proc_key(rec)
        if key not in pid_map:
            pid_map[key] = len(pid_map) + 1
            events.append({
                "ph": "M", "name": "process_name", "pid": pid_map[key],
                "args": {"name": f"{key[0]} (pid {key[1]})"},
            })
        return pid_map[key]

    t_origin = min((float(s["t"]) for s in spans if "t" in s
                    and s.get("rid")), default=0.0)
    for s in spans:
        if "t" not in s or not s.get("rid"):
            continue
        ev = {
            "name": s.get("name", "?"), "ph": "X",
            "ts": round((float(s["t"]) - t_origin) * 1e6, 1),
            "dur": max(round(float(s.get("dur_ms", 0.0)) * 1e3, 1), 1),
            "pid": pid_for(s), "tid": s.get("tid", 0),
            "args": {"rid": s["rid"], **(s.get("attrs") or {})},
        }
        events.append(ev)
    # flow events per cross-process rid: proxy (router) -> http
    # (replica); the LAST proxy attempt is the one the replica served
    for rid, recs in _by_rid(spans).items():
        proxy = _last_named(recs, "proxy", proc="router")
        http = _named(recs, "http")
        if proxy is None or http is None \
                or http.get("proc") == "router":
            continue
        fid = _flow_id(rid)
        events.append({
            "ph": "s", "cat": "request", "name": "req", "id": fid,
            "pid": pid_for(proxy), "tid": proxy.get("tid", 0),
            "ts": round((float(proxy["t"]) - t_origin) * 1e6, 1),
            "args": {"rid": rid},
        })
        events.append({
            "ph": "f", "cat": "request", "name": "req", "id": fid,
            "bp": "e",
            "pid": pid_for(http), "tid": http.get("tid", 0),
            "ts": round((float(http["t"]) - t_origin) * 1e6, 1),
            "args": {"rid": rid},
        })
    if anatomy and (anatomy.get("classes") or {}):
        classes = [(cls, c) for cls, c in sorted(
            anatomy["classes"].items(),
            key=lambda kv: -(kv[1].get("frac_time") or 0.0))
            if (c.get("frac_time") or 0.0) > 0.0]
        gap = float(anatomy.get("dispatch_gap_frac") or 0.0)
        named_pids: set = set()
        want = set(anatomy_rids) if anatomy_rids is not None else None
        for rid, recs in _by_rid(spans).items():
            if want is not None and rid not in want:
                continue
            ft = _named(recs, "first_token")
            done = _named(recs, "complete")
            if ft is None or done is None:
                continue
            t0, t1 = float(ft["t"]), float(done["t"])
            if t1 <= t0:
                continue
            pid = pid_for(ft)
            if pid not in named_pids:
                named_pids.add(pid)
                events.append({
                    "ph": "M", "name": "thread_name", "pid": pid,
                    "tid": _ANATOMY_TID,
                    "args": {"name": "step anatomy (modeled)"},
                })
            dur_us = (t1 - t0) * 1e6
            dev_us = dur_us * (1.0 - gap)
            cursor = (t0 - t_origin) * 1e6
            for cls, c in classes:
                d = dev_us * float(c["frac_time"])
                events.append({
                    "name": f"kernel/{cls}", "ph": "X",
                    "cat": "anatomy", "ts": round(cursor, 1),
                    "dur": max(round(d, 1), 1),
                    "pid": pid, "tid": _ANATOMY_TID,
                    "args": {"rid": rid,
                             "frac_time": c.get("frac_time"),
                             "bound": c.get("bound")},
                })
                cursor += d
            if gap > 0:
                events.append({
                    "name": "dispatch_gap", "ph": "X",
                    "cat": "anatomy", "ts": round(cursor, 1),
                    "dur": max(round(dur_us - dev_us, 1), 1),
                    "pid": pid, "tid": _ANATOMY_TID,
                    "args": {"rid": rid,
                             "dispatch_gap_frac": round(gap, 4)},
                })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def stitch_run(run_dir,
               client_e2e_by_rid: Optional[Dict[str, float]] = None
               ) -> dict:
    """Run-dir convenience: discover + load + stitch + attribute."""
    spans = load_spans(discover_span_files(run_dir))
    report = stitch_spans(spans, client_e2e_by_rid=client_e2e_by_rid)
    report["attribution"] = attribution(report)
    return report
