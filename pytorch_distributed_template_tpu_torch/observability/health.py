"""Numerics forensics: per-step health summary + anomaly detection (the
port of the JAX package's ``observability/health.py``).

- **The per-step summary** (:func:`pack_health_summary`, called by
  ``engine/steps.py`` when ``health`` is on): one packed float32 vector on
  the device, in the order :func:`health_layout` gives -- the step's loss
  (the masked mean), the global grad norm before clipping, the global
  norm of the update, the non-finite count of the new params, and the
  non-finite counts of the pre-clip gradients per top-level parameter
  group. A group is the first component of a parameter's JAX path
  (``models/convert.py::flax_path``), so both packages write the same
  ``nonfinite/<group>`` keys in the same (sorted) order. The trainer
  copies the vector into pinned host memory without blocking
  (:class:`DeferredFetch`) and the monitor reads it one step later, so
  detection never stalls the step just issued.

  The JAX function hides the gradient counts behind a ``lax.cond`` on
  the finiteness of the loss and the norms: when they are finite every
  count is provably 0. Eager PyTorch cannot branch on a device scalar
  without reading it, so the train step passes the counts it took
  (:func:`nonfinite_by_group`, before clipping) or None when the host
  already knows the step was finite (``skip_nonfinite`` reads that flag
  anyway), which is exact. The params' count is always taken (one pass
  over the flat params on the device).

- **Anomaly detector** (``EwmaDetector`` + ``HealthMonitor``, copies of
  the JAX classes): hard triggers on any non-finite count, loss or norm,
  soft triggers on EWMA z-scores of loss and grad norm after
  ``warmup_steps`` observations. On firing, rank 0 writes
  ``<log_dir>/anomaly_<step>.json`` (the summary, the detector state,
  the flight recorder's trailing records, the active spans, the epoch
  and batch) and flushes the recorder; firing can pause best-checkpoint
  promotion for the epoch (``pause_best_promotion``).

- **Process-wide counters** (``health_counters()``): ``anomaly_total``,
  ``straggler_windows_total``, ``profile_captures_total``,
  ``last_anomaly_step``; the trainer rides them on log-step records.

Config (``trainer.health``, all optional; on unless ``enabled`` is
false, as in the JAX trainer)::

    "health": {"enabled": true, "ewma_alpha": 0.05, "z_threshold": 8.0,
               "warmup_steps": 20, "dump_last_n": 32, "max_dumps": 8,
               "cooldown_steps": 25, "pause_best_promotion": false}
"""
from __future__ import annotations

import collections
import json
import math
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..models.convert import flax_path

# ---------------------------------------------------------------------------
# process-wide health counters (serve /metrics + recorder piggyback)
# ---------------------------------------------------------------------------

_counter_lock = threading.Lock()
_counters: dict = {
    "anomaly_total": 0,
    "straggler_windows_total": 0,
    "profile_captures_total": 0,
    "last_anomaly_step": None,
}


def health_counters() -> dict:
    """Snapshot of the process-lifetime health counters."""
    with _counter_lock:
        return dict(_counters)


def bump_counter(name: str, n: int = 1) -> None:
    with _counter_lock:
        _counters[name] = int(_counters.get(name) or 0) + n


def note_anomaly(step: int) -> None:
    with _counter_lock:
        _counters["anomaly_total"] += 1
        _counters["last_anomaly_step"] = int(step)


def reset_counters() -> None:
    """Test hook: counters are process-global."""
    with _counter_lock:
        _counters.update(anomaly_total=0, straggler_windows_total=0,
                         profile_captures_total=0, last_anomaly_step=None)


# ---------------------------------------------------------------------------
# the per-step summary (device tensors)
# ---------------------------------------------------------------------------


def parameter_groups(model) -> Dict[str, list]:
    """``{group: [parameter, ...]}`` over ``model.named_parameters()``,
    the groups sorted by name: a group is the first component of the
    parameter's JAX path (``h_0``, ``wte``, ``ln_f``, ...), the top-level
    key of the flax params. A ``DistributedDataParallel`` wrapper is read
    through its ``module``."""
    model = getattr(model, "module", model)
    groups: Dict[str, list] = {}
    for name, p in model.named_parameters():
        groups.setdefault(flax_path(name).split("/")[0], []).append(p)
    return dict(sorted(groups.items()))


def health_layout(groups) -> list:
    """Field order of the packed summary vector; ``groups`` is the group
    names (or :func:`parameter_groups`' dict)."""
    return ["loss", "grad_norm", "update_norm", "nonfinite_params"] + [
        f"nonfinite/{name}" for name in sorted(groups)
    ]


def _flat(tensors: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    if not tensors:     # a rank that counts none (a sharded model's)
        return torch.zeros(0, device=device)
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def nonfinite_total(tensors: Sequence[torch.Tensor],
                    device=None) -> torch.Tensor:
    """Count of non-finite elements across ``tensors`` (an int64 scalar on
    their device, or ``device`` when there are none; one pass over their
    concatenation)."""
    return torch.isfinite(_flat(tensors, device)).logical_not_().sum()


def nonfinite_by_group(grouped: Dict[str, Sequence[torch.Tensor]],
                       device=None) -> torch.Tensor:
    """Non-finite element counts per group, in sorted group order, as
    one int64 vector: one pass over all the tensors concatenated, then
    a sum per group's slice (on ``device`` when there are none)."""
    names = sorted(grouped)
    sizes = [sum(t.numel() for t in grouped[n]) for n in names]
    bad = torch.isfinite(_flat([t for n in names for t in grouped[n]],
                               device)).logical_not_()
    return torch.stack([part.sum() for part in bad.split(sizes)])


def pack_health_summary(loss, grad_norm, update_norm, grad_counts,
                        new_params: Sequence[torch.Tensor],
                        groups: int) -> torch.Tensor:
    """The packed float32 summary vector (order: :func:`health_layout`).

    ``grad_counts``: :func:`nonfinite_by_group` of the pre-clip gradients
    (a NaN global norm would make the clip scale NaN and smear one bad
    group over all of them), or None for ``groups`` zero counts, which is
    exact only when the caller knows the loss and the grad norm are finite
    (every element is then finite)."""
    device = torch.as_tensor(loss).device
    scalars = torch.stack([torch.as_tensor(x, device=device).float()
                           .reshape(()) for x in (loss, grad_norm,
                                                  update_norm)])
    if grad_counts is None:   # made on the device: a host tensor needs a copy
        grad_counts = torch.zeros(groups, dtype=torch.int64, device=device)
    counts = torch.cat([nonfinite_total(new_params, device).reshape(1),
                        grad_counts])
    return torch.cat([scalars, counts.float()])


def unpack_health_summary(vec, layout: list) -> dict:
    """Packed vector -> named summary dict; derives the total
    ``nonfinite_grads`` from the per-group counts."""
    flat = np.asarray(vec, np.float64).reshape(-1)
    summary = {name: float(v) for name, v in zip(layout, flat)}
    summary["nonfinite_grads"] = float(sum(
        v for k, v in summary.items() if k.startswith("nonfinite/")
    ))
    return summary


class DeferredFetch:
    """A dict of device tensors on its way to the host without a sync.

    On CUDA every value is copied ``non_blocking`` into pinned host
    memory after the work that produced it, and an event is recorded
    behind the copies; :meth:`get` waits on that event (by the time a
    caller reads an entry a step or a log window later, it has long
    completed) and returns numpy arrays. On the CPU the values are read
    directly."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self._event = None
        self._host = {}
        for k, v in tensors.items():
            v = v.detach()
            if v.is_cuda:
                self._host[k] = v.to("cpu", non_blocking=True)
            else:
                self._host[k] = v
        if any(v.is_cuda for v in tensors.values()):
            self._event = torch.cuda.Event()
            self._event.record()

    def get(self) -> dict:
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return {k: v.numpy() for k, v in self._host.items()}


# ---------------------------------------------------------------------------
# host-side detection
# ---------------------------------------------------------------------------


class EwmaDetector:
    """EWMA mean/variance z-score detector for one scalar series.

    ``update(x)`` returns the z-score of ``x`` against the series'
    exponentially-weighted history, or None while warming up (fewer than
    ``warmup`` finite observations) or when ``x`` is non-finite (the
    hard-trigger path owns that case). The deviation floor
    (``1e-8 + floor_frac * |mean|``) keeps a near-constant series (e.g.
    a converged loss) from turning sub-percent jitter into huge
    z-scores.

    One-sided by default: the monitored series (loss, grad norm) are
    "bigger is worse" — a healthy training run's steadily DECREASING
    loss must never fire, so downward deviations score 0.
    """

    def __init__(self, alpha: float = 0.05, warmup: int = 20,
                 floor_frac: float = 0.02, one_sided: bool = True):
        self.one_sided = bool(one_sided)
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.floor_frac = float(floor_frac)
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def update(self, x) -> Optional[float]:
        if x is None or not math.isfinite(float(x)):
            return None
        x = float(x)
        z = None
        if self.n >= self.warmup:
            dev = (x - self.mean) if self.one_sided else abs(x - self.mean)
            std = math.sqrt(max(self.var, 0.0))
            floor = 1e-8 + self.floor_frac * abs(self.mean)
            z = max(dev, 0.0) / max(std, floor)
        if self.n == 0:
            self.mean, self.var = x, 0.0
        else:
            a = self.alpha
            delta = x - self.mean
            self.mean += a * delta
            self.var = (1.0 - a) * (self.var + a * delta * delta)
        self.n += 1
        return z

    def state(self) -> dict:
        return {"mean": self.mean, "std": math.sqrt(max(self.var, 0.0)),
                "n": self.n}


class HealthMonitor:
    """Consumes per-step health summaries; dumps forensics on anomaly.

    :param cfg: the ``trainer.health`` config dict (see module doc).
    :param recorder: optional ``FlightRecorder`` — its trailing records
        go into the anomaly bundle and it is flushed after a dump.
    :param spans: optional ``SpanRecorder`` — active spans at dump time.
    :param log_dir: where ``anomaly_<step>.json`` lands (None: no file,
        e.g. non-main processes — detection/counters still run).

    ``enqueue(step, device_metrics)`` defers the fetch by one step:
    ``device_metrics`` is a :class:`DeferredFetch` (or a plain dict of
    tensors or numbers), and the entry observed at step N was issued at
    step N-1, whose copies completed while step N ran -- so consuming the
    summary never blocks on the step just issued. ``drain()`` at
    epoch end observes the final pending entry.
    """

    def __init__(self, cfg: Optional[dict] = None, recorder=None,
                 spans=None, log_dir=None, layout=None):
        cfg = dict(cfg or {})
        self.layout = list(layout) if layout is not None else None
        self.enabled = bool(cfg.get("enabled", True))
        self.z_threshold = float(cfg.get("z_threshold", 8.0))
        self.dump_last_n = int(cfg.get("dump_last_n", 32))
        self.max_dumps = int(cfg.get("max_dumps", 8))
        self.cooldown_steps = int(cfg.get("cooldown_steps", 25))
        self.pause_best_promotion = bool(
            cfg.get("pause_best_promotion", False)
        )
        alpha = float(cfg.get("ewma_alpha", 0.05))
        warmup = int(cfg.get("warmup_steps", 20))
        self.detectors = {
            "loss": EwmaDetector(alpha, warmup),
            # grad norm legitimately swings several-x during normal
            # training (schedule phases, batch composition — measured
            # 0.6 -> 4.3 on the bench TinyLM). floor_frac=1.0 makes the
            # z-score count multiples of the running MEAN, so the soft
            # trigger needs an ~order-of-magnitude explosion
            # (> (1 + z_threshold) x EWMA), not a few sigmas of a
            # quiet stretch
            "grad_norm": EwmaDetector(alpha, warmup, floor_frac=1.0),
        }
        self.recorder = recorder
        self.spans = spans
        self.log_dir = Path(log_dir) if log_dir is not None else None
        self.cfg = cfg
        self.anomalies = 0          # fires this process
        self.dumps_written = 0
        self.last_anomaly_step: Optional[int] = None
        self._last_dump_step: Optional[int] = None
        self._last_note_step: Optional[int] = None
        self._epoch_anomaly = False
        self._pending: "collections.deque" = collections.deque()

    # -- deferred per-step feed ---------------------------------------------

    def enqueue(self, step: int, device_metrics: dict,
                meta: Optional[dict] = None) -> None:
        """Queue this step's health summary (still in flight); observe
        the previously queued step (its copy has completed)."""
        if not self.enabled:
            return
        self._pending.append((step, device_metrics, meta))
        while len(self._pending) > 1:
            self._observe_device(*self._pending.popleft())

    def drain(self) -> None:
        """Observe anything still pending (epoch end)."""
        while self._pending:
            self._observe_device(*self._pending.popleft())

    def _observe_device(self, step, device_metrics, meta) -> None:
        try:
            fetched = (device_metrics.get()
                       if isinstance(device_metrics, DeferredFetch)
                       else {k: np.asarray(v)
                             for k, v in device_metrics.items()})
            if self.layout is not None and "health" in fetched:
                summary = unpack_health_summary(fetched["health"],
                                                self.layout)
            else:  # pre-unpacked scalar dicts (tests, custom feeds)
                summary = {k.replace("health/", "", 1): float(v)
                           for k, v in fetched.items()}
        except Exception:  # noqa: BLE001 — diagnostics must not crash
            return
        self.observe(step, summary, meta=meta)

    # -- detection -----------------------------------------------------------

    def observe(self, step: int, summary: dict,
                meta: Optional[dict] = None) -> Optional[dict]:
        """Run the detectors over one step's summary; returns the
        anomaly dict when one fired (also written to disk), else None.

        ``summary`` keys: ``loss``, ``grad_norm``, ``update_norm``,
        ``nonfinite_grads``, ``nonfinite_params``, and per-group
        ``nonfinite/<group>`` counts (all plain floats).
        """
        if not self.enabled:
            return None
        reasons = []
        loss = summary.get("loss")
        if loss is not None and not math.isfinite(float(loss)):
            reasons.append({"kind": "nonfinite_loss", "value": repr(loss)})
        for key in ("grad_norm", "update_norm"):
            # hard trigger, not EWMA (the detector skips non-finite
            # inputs and this path owns them): a norm can overflow f32
            # to inf from FINITE elements (squares sum past ~3.4e38),
            # in which case grad clipping silently zeroes every update
            # — loss stays finite, counts stay 0, and without this
            # check the run stalls with the health layer all-clear
            v = summary.get(key)
            if v is not None and not math.isfinite(float(v)):
                reasons.append({"kind": f"nonfinite_{key}",
                                "value": repr(v)})
        for key in ("nonfinite_grads", "nonfinite_params"):
            v = summary.get(key)
            if v is not None and (not math.isfinite(float(v))
                                  or float(v) > 0):
                reasons.append({"kind": key, "count": float(v)})
        zscores = {}
        for name, det in self.detectors.items():
            z = det.update(summary.get(name))
            if z is not None:
                zscores[name] = round(z, 2)
                if z > self.z_threshold:
                    reasons.append({
                        "kind": f"{name}_zscore", "z": round(z, 2),
                        "value": summary.get(name),
                        "ewma": det.state(),
                    })
        if not reasons:
            return None
        return self._fire(step, summary, reasons, zscores, meta)

    def _fire(self, step, summary, reasons, zscores, meta) -> dict:
        self.anomalies += 1
        self.last_anomaly_step = int(step)
        self._epoch_anomaly = True
        note_anomaly(step)
        anomaly = {
            "v": 1,
            "step": int(step),
            "t": round(time.time(), 3),
            "reasons": reasons,
            "summary": summary,
            "zscores": zscores,
            "detector": {k: d.state() for k, d in self.detectors.items()},
            "config": self.cfg,
        }
        if meta:
            anomaly.update(meta)
        if self.spans is not None:
            try:
                anomaly["active_spans"] = self.spans.active_spans()
            except Exception:  # noqa: BLE001
                pass
        if self.recorder is not None:
            try:
                anomaly["last_records"] = self.recorder.last(
                    self.dump_last_n
                )
            except Exception:  # noqa: BLE001
                pass
        # the process's time-series window: the bundle carries the
        # trailing trend, not just the offending instant (present only
        # when a store is registered; the serving paths register one)
        from .timeseries import default_store

        ts = default_store()
        if ts is not None:
            anomaly["timeseries_window"] = ts.points(last_n=self.dump_last_n)
        self._write_dump(step, anomaly)
        # timeline note + tail fsync rate-limited by the SAME cooldown
        # as the dumps: a persistent NaN streak under skip_nonfinite
        # fires every step for the rest of the run, and an fsync per
        # hot-loop step (ms-to-tens-of-ms on networked filesystems)
        # would tax exactly the run the user asked to keep going.
        # Counters still count every fire.
        note_ok = (self._last_note_step is None
                   or step - self._last_note_step >= self.cooldown_steps)
        if self.recorder is not None and note_ok:
            self._last_note_step = int(step)
            try:
                # the anomaly becomes a timeline event, and the JSONL
                # tail is forced to disk — a crash right after a NaN
                # must not lose the records that explain it
                self.recorder.record(
                    step, event="anomaly",
                    reasons=json.dumps([r["kind"] for r in reasons]),
                )
                self.recorder.flush()
            except Exception:  # noqa: BLE001
                pass
        return anomaly

    def _write_dump(self, step, anomaly) -> None:
        if self.log_dir is None:
            return
        if self.dumps_written >= self.max_dumps:
            return
        if (self._last_dump_step is not None
                and step - self._last_dump_step < self.cooldown_steps):
            return  # a NaN streak fires per step; don't flood the dir
        try:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            path = self.log_dir / f"anomaly_{int(step)}.json"
            path.write_text(json.dumps(anomaly, default=repr))
            self.dumps_written += 1
            self._last_dump_step = int(step)
            anomaly["dump_path"] = str(path)
        except Exception:  # noqa: BLE001 — a full disk must not kill
            pass           # the run the dump is diagnosing

    # -- checkpoint-promotion gate -------------------------------------------

    def promotion_allowed(self) -> bool:
        """False while ``pause_best_promotion`` is set and the current
        epoch saw an anomaly — a poisoned metric must not crown
        ``model_best``."""
        return not (self.pause_best_promotion and self._epoch_anomaly)

    def epoch_start(self) -> None:
        self._epoch_anomaly = False
