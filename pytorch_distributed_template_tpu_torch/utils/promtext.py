"""Prometheus text exposition (0.0.4) from a flat metrics dict: a copy of
the JAX package's ``utils/promtext.py``.

``serve.py`` renders its ``/metrics`` through it (prefix ``pdt_serve``);
a fleet router would use the same helpers with its own prefix. Deliberately
in utils/ and stdlib-only.

Besides counters and gauges this module owns the latency HISTOGRAM
support: fixed-bucket :class:`LatencyHistogram` instances
for TTFT/TPOT/e2e whose snapshots render as proper
``_bucket``/``_sum``/``_count`` series. Fixed buckets are the point —
bucket counters from N replicas SUM into a fleet-level histogram
(fleet/replicas.py aggregates them reset-corrected), which is the only
honest way to get fleet-level percentiles; averaging per-replica
percentile gauges is not aggregation.
"""
from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional

#: fixed latency buckets in seconds, shared by every exporter so
#: fleet-level aggregation is a per-bucket sum. Range covers sub-10ms
#: cache hits through multi-minute long-context generations.
LATENCY_BUCKETS_S = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)
_INF = "+Inf"


def percentile(sorted_vals: List[float], q: float) -> Optional[float]:
    """Linear-interpolation percentile over a pre-sorted list (the
    numpy/``histogram_quantile`` convention). THE one percentile
    helper for client- and server-side latency summaries — loadgen,
    the trace stitcher, and the engines all route through it so their
    percentiles never drift onto different conventions."""
    if not sorted_vals:
        return None
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * frac


class LatencyHistogram:
    """Thread-safe fixed-bucket histogram (Prometheus semantics).

    ``snapshot()`` returns ``{"buckets": {le: cumulative_count, ...,
    "+Inf": n}, "sum": seconds, "count": n}`` — cumulative counts, so
    snapshots from different processes aggregate by plain per-key
    addition and ``histogram_quantile`` reads them directly."""

    def __init__(self, buckets=LATENCY_BUCKETS_S):
        self.buckets = tuple(float(b) for b in buckets)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)   # +Inf last
        self._sum = 0.0
        self._count = 0

    def observe(self, seconds: float) -> None:
        s = float(seconds)
        i = len(self.buckets)
        for j, b in enumerate(self.buckets):
            if s <= b:
                i = j
                break
        with self._lock:
            self._counts[i] += 1
            self._sum += s
            self._count += 1

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, count = self._sum, self._count
        cum, buckets = 0, {}
        for b, c in zip(self.buckets, counts):
            cum += c
            buckets[f"{b:g}"] = cum
        buckets[_INF] = count
        return {"buckets": buckets, "sum": round(total, 6),
                "count": count}


def is_histogram(value) -> bool:
    """Does this metrics-dict value carry a histogram snapshot?"""
    return (isinstance(value, dict) and "buckets" in value
            and "count" in value
            and isinstance(value["buckets"], dict))


def zero_histogram() -> dict:
    """An empty cumulative snapshot (aggregation identity)."""
    buckets = {f"{b:g}": 0 for b in LATENCY_BUCKETS_S}
    buckets[_INF] = 0
    return {"buckets": buckets, "sum": 0.0, "count": 0}


def add_histograms(into: dict, other: dict, scale: float = 1.0) -> dict:
    """``into += other * scale`` per bucket/sum/count (scale -1 gives
    subtraction — the reset-correction delta in fleet/replicas.py).
    Mutates and returns ``into``; bucket keys are unioned."""
    for le, c in (other.get("buckets") or {}).items():
        into["buckets"][le] = (into["buckets"].get(le, 0)
                               + scale * int(c))
    into["sum"] = round(into.get("sum", 0.0)
                        + scale * float(other.get("sum", 0.0)), 6)
    into["count"] = int(into.get("count", 0)
                        + scale * int(other.get("count", 0)))
    return into


def histogram_quantile(snapshot: dict, q: float) -> Optional[float]:
    """Prometheus-style quantile estimate from a cumulative-bucket
    snapshot: linear interpolation inside the bucket the quantile rank
    lands in (the ``+Inf`` bucket clamps to the largest finite bound).
    None when the histogram is empty."""
    count = int(snapshot.get("count", 0))
    if count <= 0:
        return None
    pairs: List[tuple] = []
    inf_count = None
    for le, c in (snapshot.get("buckets") or {}).items():
        if le == _INF:
            inf_count = int(c)
            continue
        pairs.append((float(le), int(c)))
    pairs.sort()
    rank = q * count
    prev_le, prev_c = 0.0, 0
    for le, c in pairs:
        if c >= rank:
            span = c - prev_c
            frac = ((rank - prev_c) / span) if span > 0 else 1.0
            return round(prev_le + (le - prev_le) * frac, 6)
        prev_le, prev_c = le, c
    # rank lands in +Inf: clamp to the largest finite bound
    del inf_count
    return round(pairs[-1][0], 6) if pairs else None


def prometheus_text(metrics: dict, prefix: str = "pdt_serve") -> str:
    """Flat numeric fields -> Prometheus exposition format.

    Counters get a ``_total``-suffix-preserving counter TYPE;
    histogram snapshots (see :func:`is_histogram`) render as
    ``_bucket{le=...}`` + ``_sum`` + ``_count`` with TYPE histogram;
    everything else is a gauge. Other nested dicts (latency
    percentiles) flatten with an underscore; bools and the
    ``scheduler`` label stay out (numeric series only)."""
    lines = []

    def emit(name: str, value) -> None:
        kind = "counter" if name.endswith("_total") else "gauge"
        lines.append(f"# TYPE {prefix}_{name} {kind}")
        lines.append(f"{prefix}_{name} {value}")

    def emit_histogram(name: str, snap: dict) -> None:
        lines.append(f"# TYPE {prefix}_{name} histogram")
        items = [(le, c) for le, c in snap["buckets"].items()]
        items.sort(key=lambda kv: (kv[0] == _INF,
                                   float(kv[0]) if kv[0] != _INF
                                   else 0.0))
        for le, c in items:
            lines.append(
                f'{prefix}_{name}_bucket{{le="{le}"}} {int(c)}')
        lines.append(f"{prefix}_{name}_sum {snap.get('sum', 0.0)}")
        lines.append(f"{prefix}_{name}_count {int(snap['count'])}")

    for k, v in metrics.items():
        if isinstance(v, bool) or k == "scheduler":
            continue
        if isinstance(v, (int, float)):
            emit(k, v)
        elif is_histogram(v):
            emit_histogram(k, v)
        elif isinstance(v, dict):
            for kk, vv in v.items():
                if isinstance(vv, (int, float)):
                    emit(f"{k}_{kk}", vv)
    return "\n".join(lines) + "\n"


_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def lint_exposition(text: str) -> List[str]:
    """Self-lint a Prometheus exposition body.

    Every ``/metrics`` producer in the repo (serve.py's
    ``service_metrics``, the fleet router's ``router_metrics``) builds
    its dict by MERGING several sources — engine stats, manager
    counters, admission stats, goodput ledgers — so naming drift is a
    merge away: a counter that forgot its ``_total`` suffix, a nested
    dict flattening onto an existing top-level key (duplicate series),
    a histogram snapshot whose child series collide with a scalar.
    This walks the rendered text (the single choke point every
    producer already routes through) and returns violation strings —
    empty means clean. Checked:

    - metric names are charset-legal and declared by exactly ONE
      ``# TYPE`` line (a duplicate declaration IS the flatten
      collision above);
    - counter-typed series end ``_total``, and nothing typed gauge
      ends ``_total`` (it would silently demote a counter);
    - every histogram exposes ``_bucket`` series including
      ``le="+Inf"``, ``_sum`` and ``_count``, bucket counts are
      cumulative (non-decreasing by ``le``) and the ``+Inf`` bucket
      equals ``_count``;
    - histogram child names never collide with an independently
      declared series;
    - no sample line repeats the same series (name + labels).
    """
    violations: List[str] = []
    types: Dict[str, str] = {}
    samples: Dict[str, float] = {}
    seen_lines: set = set()
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                name, kind = parts[2], parts[3]
                if name in types:
                    violations.append(
                        f"duplicate TYPE declaration: {name}")
                types[name] = kind
            continue
        token, _, value = line.partition(" ")
        if token in seen_lines:
            violations.append(f"duplicate sample: {token}")
        seen_lines.add(token)
        name = token.split("{", 1)[0]
        if not _METRIC_NAME_RE.match(name):
            violations.append(f"illegal metric name: {name}")
        try:
            samples[token] = float(value)
        except ValueError:
            violations.append(f"non-numeric sample: {line}")
    for name, kind in types.items():
        if kind == "counter" and not name.endswith("_total"):
            violations.append(
                f"counter without _total suffix: {name}")
        if kind == "gauge" and name.endswith("_total"):
            violations.append(
                f"_total series typed gauge (demoted counter): "
                f"{name}")
        if kind != "histogram":
            continue
        for child in (f"{name}_bucket", f"{name}_sum",
                      f"{name}_count"):
            if child in types:
                violations.append(
                    f"histogram child collides with declared "
                    f"series: {child}")
        buckets = []
        for token, v in samples.items():
            if token.startswith(f"{name}_bucket{{"):
                m = re.search(r'le="([^"]+)"', token)
                if m:
                    buckets.append((m.group(1), v))
        count = samples.get(f"{name}_count")
        if not buckets or f"{name}_sum" not in samples \
                or count is None:
            violations.append(
                f"incomplete histogram (needs _bucket/_sum/_count): "
                f"{name}")
            continue
        inf = dict(buckets).get("+Inf")
        if inf is None:
            violations.append(f'histogram missing le="+Inf": {name}')
        elif inf != count:
            violations.append(
                f"histogram +Inf bucket ({inf}) != _count "
                f"({count}): {name}")
        finite = sorted(((float(le), v) for le, v in buckets
                         if le != "+Inf"))
        if any(b[1] > a[1] for b, a in zip(finite, finite[1:])):
            violations.append(
                f"histogram buckets not cumulative: {name}")
    # samples referencing an undeclared family (typo'd child names)
    declared: set = set(types)
    for name, kind in types.items():
        if kind == "histogram":
            declared.update(
                {f"{name}_bucket", f"{name}_sum", f"{name}_count"})
    for token in samples:
        if token.split("{", 1)[0] not in declared:
            violations.append(f"sample without TYPE: {token}")
    return violations
