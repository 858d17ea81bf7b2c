"""The port's flight recorder and spans against the JAX package's.

- ``FlightRecorder``: the same records written by both give the same
  ``telemetry.jsonl`` line for line (every field but the wall-clock ``t``;
  non-finite floats as null, None fields dropped, numpy scalars unwrapped),
  the same ring after eviction and the same ``aggregates()``; memory fields
  ride the same records.
- The port's compile events are its kernel builds: a build run by
  ``ops/build.py`` (here with a stand-in ``nvcc``) rides the next record as
  ``compile_events``, and ``compile_cache_stats`` reports the library.
- Spans nest, survive exceptions, and ``dump`` writes a Chrome trace.
"""
import json
import os
import stat

import numpy as np
import pytest

from pytorch_distributed_template_tpu.observability import (
    telemetry as jtel, trace as jtrace,
)

from pytorch_distributed_template_tpu_torch.observability import (
    telemetry, trace,
)
from pytorch_distributed_template_tpu_torch.ops import build
from pytorch_distributed_template_tpu_torch.utils import compile_cache

RECORDS = [
    (0, {"wall_ms": 12.5, "data_wait_ms": 0.25, "examples": 8,
         "tokens": 8192, "loss": 3.5, "lr": 1e-3}),
    (1, {"wall_ms": 10.0, "data_wait_ms": 0.5, "examples": 8,
         "tokens": 8192}),
    (2, {"wall_ms": 11.0, "loss": float("nan"), "grad_norm": float("inf"),
         "skip_me": None, "np_scalar": np.float32(2.5),
         "np_int": np.int64(7), "flag": True, "name": "x"}),
    (3, {"event": "anomaly", "reasons": json.dumps(["nonfinite_loss"])}),
    (4, {"wall_ms": 9.0, "examples": 8, "tokens": 8192, "loss": 3.25,
         "hosts": {"0": {"wall_ms": 9.0}}, "straggler": False}),
    (5, {"wall_ms": 9.5, "data_wait_ms": 0.125, "examples": 8,
         "tokens": 8192, "loss": 3.0}),
]


def _write(mod, run_dir, capacity, memory_every):
    rec = mod.FlightRecorder(run_dir=run_dir, capacity=capacity,
                             memory_every=memory_every)
    if mod is jtel:
        jtel.drain_compile_events()   # nothing compiled before a record
    out = [rec.record(step, **fields) for step, fields in RECORDS]
    rec.close()
    return rec, out


@pytest.mark.parametrize("capacity, memory_every", [(512, 0), (3, 2)])
def test_recorder_jsonl_ring_and_aggregates_match(tmp_path, capacity,
                                                  memory_every):
    jrec, jout = _write(jtel, tmp_path / "jax", capacity, memory_every)
    trec, tout = _write(telemetry, tmp_path / "port", capacity,
                        memory_every)

    def lines(path):
        return [json.loads(line) for line in path.read_text().splitlines()]

    jl = lines(tmp_path / "jax" / "telemetry.jsonl")
    tl = lines(tmp_path / "port" / "telemetry.jsonl")
    assert len(jl) == len(tl) == len(RECORDS)
    for a, b in zip(jl, tl):
        a.pop("t"), b.pop("t")
        assert set(a) == set(b)
        for key in ("host_rss_mb", "devices"):   # this process's memory
            a.pop(key, None), b.pop(key, None)
        assert a == b
    assert tl[2]["loss"] is None and tl[2]["grad_norm"] is None
    assert "skip_me" not in tl[2] and tl[2]["np_scalar"] == 2.5
    assert [r["step"] for r in trec.last()] == \
        [r["step"] for r in jrec.last()]
    assert len(trec.last()) == min(capacity, len(RECORDS))
    assert [r["step"] for r in trec.last(2)] == [4, 5]
    ja, ta = jrec.aggregates(), trec.aggregates()
    assert ta == ja and ta["steps"] >= 1
    assert telemetry.SCHEMA_VERSION == jtel.SCHEMA_VERSION
    assert telemetry.read_jsonl(tmp_path / "port" / "telemetry.jsonl")


def test_device_memory_stats_empty_on_the_cpu():
    assert telemetry.device_memory_stats() == {}
    assert telemetry.host_rss_bytes() > 0


def test_kernel_builds_ride_the_next_record(tmp_path, monkeypatch):
    """A stand-in nvcc writes the library file; the build becomes a
    compile event on the next record, and the cache stats see it."""
    cuda = tmp_path / "cuda" / "bin"
    cuda.mkdir(parents=True)
    nvcc = cuda / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ \"$1\" != -o ]; do shift; done\n"
                    "echo built > \"$2\"\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "LIBRARIES", list(build.LIBRARIES))
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "standin.cu").write_text("// stand-in source\n")
    build.drain_build_events()
    lib = build.CudaLibrary("standin", lambda lib: None)
    assert build.build_all([lib]) == {"standin": lib.build_seconds}
    assert build.build_all([lib]) == {}          # built once
    rec = telemetry.FlightRecorder(run_dir=None, memory_every=0)
    first = rec.record(0, wall_ms=1.0)
    second = rec.record(1, wall_ms=1.0)
    assert [e["event"] for e in first["compile_events"]] == ["nvcc/standin"]
    assert "compile_events" not in second
    stats = compile_cache.compile_cache_stats()
    assert stats["dir"] == str(tmp_path / "kernels")
    assert stats["entries"] == 1 and stats["bytes"] > 0
    assert os.path.basename(lib.path).startswith("libstandin-")


def test_compile_cache_section_is_read_and_logged(caplog):
    import logging

    with caplog.at_level(logging.INFO):
        where = compile_cache.configure_compile_cache(
            {"compile_cache": {"dir": "~/.cache/pdt-xla-cache"}})
    assert where == str(build.BUILD_DIR)
    assert "no use in the port" in caplog.text
    assert compile_cache.configure_compile_cache(None) == str(
        build.BUILD_DIR)


@pytest.mark.parametrize("mod", [jtrace, trace], ids=["jax", "port"])
def test_spans_nest_survive_exceptions_and_dump(mod, tmp_path):
    rec = mod.SpanRecorder()
    with rec.span("outer", epoch=1):
        with rec.span("inner"):
            assert [s["name"] for s in rec.active_spans()] == \
                ["outer", "inner"]
    with pytest.raises(ValueError):
        with rec.span("boom"):
            raise ValueError("x")
    events = rec.snapshot()
    assert [e["name"] for e in events] == ["inner", "outer", "boom"]
    inner, outer, boom = events
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 0.2
    assert outer["args"] == {"epoch": 1} and boom["args"] == {"error": True}
    assert rec.active_spans() == []
    path = rec.dump(tmp_path / "trace.json")
    chrome = json.loads(path.read_text())
    assert chrome["displayTimeUnit"] == "ms"
    assert all(e["ph"] == "X" for e in chrome["traceEvents"])


def test_span_records_match_in_shape():
    a, b = jtrace.SpanRecorder(capacity=4), trace.SpanRecorder(capacity=4)
    for rec in (a, b):
        for i in range(6):
            with rec.span("s", i=i):
                pass
    assert [e["args"] for e in a.drain()] == [e["args"] for e in b.drain()]
    assert a.snapshot() == b.snapshot() == []
    assert trace.get_recorder() is trace.get_recorder()
