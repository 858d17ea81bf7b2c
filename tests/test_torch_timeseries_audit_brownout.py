"""The port's ``observability/timeseries.py``, ``observability/audit.py``
and ``utils/brownout.py`` against the JAX package's, on the same inputs:

- ``TimeSeriesStore``: equal points, JSONL lines (``load_timeseries``) and
  summary at fixed timestamps, counter resets included;
- ``ShadowAuditor``: the same deterministic sampling decisions, verdicts
  and per-fingerprint coverage over one record stream (a divergent
  fingerprint among clean ones), the same bounded bundles;
  ``first_divergence`` agrees;
- ``BrownoutController``: the same level sequence and stats over one
  pressure trace on a fake clock.

Outputs are compared for equality.
"""
import numpy as np
import pytest

from pytorch_distributed_template_tpu.observability import audit as ja
from pytorch_distributed_template_tpu.observability import timeseries as jt
from pytorch_distributed_template_tpu.utils import brownout as jb
from pytorch_distributed_template_tpu_torch.observability import audit as ta
from pytorch_distributed_template_tpu_torch.observability import (
    timeseries as tt,
)
from pytorch_distributed_template_tpu_torch.utils import brownout as tb


def test_time_series_points_and_summary(tmp_path):
    rng = np.random.default_rng(3)
    out = {}
    for name, mod in (("jax", jt), ("torch", tt)):
        store = mod.TimeSeriesStore(tmp_path / name / "timeseries.jsonl",
                                    interval_s=0.5, window=16)
        tokens = 0
        for i in range(60):
            tokens = (tokens + int(rng.integers(0, 50))) if i != 31 else 3
            store.observe(counters={"tokens_generated_total": tokens,
                                    "flag_total": True},
                          gauges={"queue_depth": i % 7, "note": "x"},
                          t=1000.0 + 0.13 * i)
        store.observe_flat({"completed_total": 9, "live_slots": 2,
                            "ttft_seconds": {"buckets": {}, "count": 0}},
                           t=1008.0)
        store.flush(t=1008.2)
        store.close()
        rng = np.random.default_rng(3)
        out[name] = (store.points(), store.summary(), store.series_names(),
                     store.quantile("queue_depth", 0.9),
                     mod.load_timeseries(store.path))
    assert out["jax"] == out["torch"]
    assert len(out["torch"][0]) == 16
    assert tt.rate_name("tokens_generated_total") == \
        jt.rate_name("tokens_generated_total")


def _records():
    rng = np.random.default_rng(8)
    recs = []
    for i in range(60):
        fp = ("paged_adopt", "paged", "stream_ring_wrap", "paged_ship")[
            i % 4 if i % 10 else 2]
        ids = [int(x) for x in rng.integers(0, 99, 6)]
        recs.append({"rid": f"r{i}", "serve_path": fp, "ids": ids,
                     "stop_reason": ("length", "stop", "cancelled")[i % 3],
                     "prompt_ids": [1, 2, i]})
    recs.append({"rid": "nofp", "ids": [1], "stop_reason": "length"})
    return recs


def _reference(rec):
    """Replays agree except on the ``ship`` path, which flips token 3."""
    ids = list(rec["ids"])
    if "ship" in rec["serve_path"]:
        ids[3] += 1
    return ids


@pytest.mark.parametrize("rate,floor", [(0.25, 2), (1.0, 0), (0.01, 4)])
def test_shadow_auditor_sampling_and_verdicts(tmp_path, rate, floor):
    out = {}
    for name, mod in (("jax", ja), ("torch", ta)):
        aud = mod.ShadowAuditor(_reference, sample_rate=rate, floor=floor,
                                queue_max=4096, dump_dir=tmp_path / name,
                                max_dumps=3, cooldown_s=0.0)
        try:
            picks = [aud._take(n) for n in range(12)]
            offered = [aud.offer(dict(r)) for r in _records()]
            assert aud.drain(timeout_s=30.0)
            dumps = sorted(p.name for p in (tmp_path / name).glob("*"))
            out[name] = (picks, offered, aud.stats(), aud.coverage(),
                         aud.healthy(), dumps)
        finally:
            aud.close()
    assert out["jax"] == out["torch"]
    stats = out["torch"][2]
    assert stats["token_divergence_total"] > 0 and not out["torch"][4]


def test_first_divergence():
    for a, b in (([], []), ([1, 2], [1, 2]), ([1, 2], [1, 3]),
                 ([1, 2, 3], [1, 2]), ([5], [6, 7]), ((1, 2), [1, 2])):
        assert ta.first_divergence(a, b) == ja.first_divergence(a, b)


def test_brownout_level_sequence_on_a_fake_clock():
    trace = [0.2, 1.1, 1.1, 2.5, 0.4, 0.4, 0.4, 3.7, 5.0, 0.1, 0.1, 0.1,
             0.1, 0.1, 0.1, 1.6, 0.9, 0.2, 0.2, 0.2]
    out = {}
    for name, mod in (("jax", jb), ("torch", tb)):
        now = [0.0]
        changes = []
        ctl = mod.BrownoutController(
            dwell_s=1.0, time_fn=lambda: now[0],
            on_change=lambda o, n, p: changes.append((o, n, p)))
        levels = []
        for p in trace:
            now[0] += 0.6
            levels.append((ctl.update(p), ctl.name()))
        out[name] = (levels, changes, ctl.stats())
    assert out["jax"] == out["torch"]
    assert max(lv for lv, _ in out["torch"][0]) == 4
    with pytest.raises(ValueError):
        tb.BrownoutController(enter=(1.0,), exit=(1.0,))
