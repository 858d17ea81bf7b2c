"""Cross-rank stats aggregation + straggler detection (the port of the JAX
package's ``observability/crosshost.py``; "host" below is a rank of the
process group).

On a multi-rank job, rank 0's ``telemetry.jsonl`` only sees its own
step loop — a slow host (thermal throttling, a sick NIC, a noisy
neighbor stealing its data-loader cores) is invisible until it drags
every collective down, and then it is indistinguishable from "the model
got slower". MegaScale-style straggler hunting needs each host's view
side by side.

``CrossHostAggregator`` piggybacks a tiny fixed-shape per-host stats
vector — mean step wall ms, mean data-wait ms, host RSS MB, and the
HBM high-water MB of its card — on one ``all_gather`` over the process
group (NCCL on the cards, gloo on the CPU) once per log window. Every
host computes the same aggregate deterministically; process 0 attaches
it to the window's flight-recorder record::

    "hosts": {"0": {"wall_ms": 101.2, "data_wait_ms": 0.4, ...},
              "1": {"wall_ms": 163.0, ...}},
    "straggler": true, "straggler_hosts": [1], "wall_spread": 1.61

A host is flagged a straggler when its mean step wall time exceeds the
cross-host median by ``threshold`` (default 1.25x). Flagged windows
bump the process-wide ``straggler_windows_total`` counter
(health.health_counters — served by ``GET /metrics``).

Single-host the exchange degrades to a local no-collective snapshot
(``hosts`` has one entry, never a straggler), so the code path is
identical in tests and production.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .health import bump_counter
from .telemetry import device_memory_stats, host_rss_bytes

# fixed per-host vector layout (version the layout, not the wire)
_FIELDS = ("wall_ms", "data_wait_ms", "rss_mb", "hbm_peak_mb")


def local_stats_vector(records: List[dict]) -> np.ndarray:
    """This host's stats vector over a window of recorder records.

    Records carrying ``compile_events`` are excluded: the compile
    step's wall time lands in DIFFERENT hosts' rings asymmetrically
    (process 0 defers its log-step records by one window; other hosts
    record every step immediately), and a 30s compile in one host's
    window mean but not another's reads as a 7x "straggler" on the
    first window of every multi-host run."""
    timed = [r for r in records
             if r.get("wall_ms") and not r.get("compile_events")]
    wall = (sum(r["wall_ms"] for r in timed) / len(timed)) if timed else 0.0
    waits = [r["data_wait_ms"] for r in timed
             if r.get("data_wait_ms") is not None]
    wait = (sum(waits) / len(waits)) if waits else 0.0
    rss = host_rss_bytes() or 0
    hbm_peak = 0
    for stats in device_memory_stats().values():
        hbm_peak = max(hbm_peak, int(stats.get("peak_bytes_in_use", 0)))
    return np.array([wall, wait, rss / 2**20, hbm_peak / 2**20],
                    np.float32)


def aggregate(host_vectors: np.ndarray, threshold: float = 1.25) -> dict:
    """Pure aggregation of the gathered ``[P, len(_FIELDS)]`` matrix —
    deterministic on every host (all inputs are the gathered matrix)."""
    host_vectors = np.asarray(host_vectors, np.float64).reshape(
        -1, len(_FIELDS)
    )
    hosts = {
        str(i): {f: round(float(v), 3) for f, v in zip(_FIELDS, row)}
        for i, row in enumerate(host_vectors)
    }
    walls = host_vectors[:, 0]
    out = {"hosts": hosts}
    median = float(np.median(walls))
    # every host must have a measured window (wall > 0): a host whose
    # records were all compile-filtered would drag the median down and
    # flag its healthy peers
    if median > 0 and all(w > 0 for w in walls):
        stragglers = [
            i for i, w in enumerate(walls) if w > threshold * median
        ]
        out["wall_spread"] = round(float(walls.max()) / median, 3)
        if stragglers:
            out["straggler"] = True
            out["straggler_hosts"] = stragglers
    return out


class CrossHostAggregator:
    """Per-log-window host stats exchange (see module doc).

    :param cfg: ``trainer.telemetry.crosshost`` dict: ``enabled``
        (default: auto — on iff multi-host), ``threshold`` (1.25).
    :param is_main: whether this process attaches/counts (process 0).
    """

    def __init__(self, cfg: Optional[dict] = None, is_main: bool = True):
        cfg = dict(cfg or {})
        self.threshold = float(cfg.get("threshold", 1.25))
        self.is_main = bool(is_main)
        enabled = cfg.get("enabled")
        if enabled is None:
            try:
                from ..parallel import dist

                enabled = dist.process_count() > 1
            except Exception:  # noqa: BLE001
                enabled = False
        self.enabled = bool(enabled)
        self.windows = 0
        self.straggler_windows = 0

    def should_exchange(self, batch_idx: int, log_step: int) -> bool:
        """Deterministic per-host condition — every host must reach the
        collective at the same batch or the gather deadlocks."""
        return (self.enabled and log_step > 0 and batch_idx > 0
                and batch_idx % log_step == 0)

    def exchange(self, records: List[dict]) -> Optional[dict]:
        """Gather every host's window vector; return the aggregate
        (identical on all hosts), or None on collective failure."""
        vec = local_stats_vector(records)
        try:
            from ..parallel import dist

            if dist.process_count() > 1:
                device = (torch.device("cuda", torch.cuda.current_device())
                          if dist.backend() == "nccl"
                          else torch.device("cpu"))
                gathered = dist.all_gather_tensor(
                    torch.from_numpy(vec).to(device)).cpu().numpy()
            else:
                gathered = vec[None]
        except Exception:  # noqa: BLE001 — observability must not kill
            return None    # the step loop on a flaky gather
        agg = aggregate(gathered, threshold=self.threshold)
        self.windows += 1
        if agg.get("straggler"):
            self.straggler_windows += 1
            if self.is_main:
                bump_counter("straggler_windows_total")
        return agg
