"""The port's ``observability/reqtrace.py`` against the JAX package's:

- ``path_fingerprint`` over every mode x all 2^8 flag sets x tp / dp /
  brownout values, with ``sanitize_serve_path`` and
  ``fingerprint_features`` on each fingerprint;
- ``Deadline.from_header`` budgets and errors over a list of header
  values; request-id sanitizing;
- ``SloWatcher`` stats and dumps over one observation sequence;
- ``stitch_spans``, ``attribution`` and ``to_perfetto`` on span records
  written by the JAX package's own ``RequestTracer`` (a router and two
  replica processes) and on a fixed two-process set whose replica clock is
  skewed; ``load_spans`` and ``stitch_run`` over the files.

Outputs are compared for equality (the same arithmetic on both sides).
"""
import itertools
import json

import pytest

from pytorch_distributed_template_tpu.observability import reqtrace as jr
from pytorch_distributed_template_tpu_torch.observability import (
    reqtrace as tr,
)


def test_path_fingerprint_grid():
    n = 0
    for mode in tr.PATH_MODES + ("bogus", None):
        for bits in range(1 << len(tr.PATH_FLAGS)):
            flags = {f: bool(bits >> i & 1)
                     for i, f in enumerate(tr.PATH_FLAGS)}
            for tp_, dp, level in itertools.product((1, 2, 4), (1, 2),
                                                    (0, 1, 3)):
                path = dict(flags, mode=mode, tp=tp_, dp=dp, brownout=level)
                fp = tr.path_fingerprint(path)
                assert fp == jr.path_fingerprint(path)
                assert tr.sanitize_serve_path(fp) == fp
                assert tr.fingerprint_features(fp) == \
                    jr.fingerprint_features(fp)
                n += 1
    assert n == 6 * 256 * 18
    assert tr.PATH_FLAGS == jr.PATH_FLAGS and tr.PATH_MODES == jr.PATH_MODES
    for value in (None, "", " paged ", "Paged", "a" * 97, "paged-adopt", 7):
        assert tr.sanitize_serve_path(value) == jr.sanitize_serve_path(value)


HEADERS = [None, "", "  ", "1", "750", " 42 ", "0", "-5", "tomorrow", "1.5",
           "99999999", "3600000", "1e3", "0x10"]


@pytest.mark.parametrize("value", HEADERS)
def test_deadline_from_header(value):
    def parse(mod):
        try:
            d = mod.Deadline.from_header(value, t0=100.0)
        except ValueError as e:
            return "ValueError", str(e)
        if d is None:
            return None
        return (d.budget_s, d.remaining_s(100.25), d.expired(100.25),
                d.header_value(100.25), d.deadline_at())

    assert parse(tr) == parse(jr)


def test_request_ids():
    for rid in (None, "", "abc", "a b", "x" * 64, "x" * 65, "r-1:2.3_x",
                "é", 5):
        assert tr.sanitize_request_id(rid) == jr.sanitize_request_id(rid)
    assert len(tr.mint_request_id()) == 16


def test_slo_watcher_stats_and_dumps(tmp_path):
    seq = [("a", 0.2, 1.0, None), ("b", 0.01, 0.05, None),
           ("c", None, 3.0, None), ("d", 0.9, 0.9, "cancelled"),
           ("e", 0.6, 0.7, "deadline"), ("f", 0.6, 2.5, "length"),
           ("g", 0.05, 0.5, "stop")]
    out = {}
    for name, mod in (("jax", jr), ("torch", tr)):
        w = mod.SloWatcher(ttft_s=0.1, e2e_s=0.8, dump_dir=tmp_path / name,
                           max_dumps=2, cooldown_s=0.0)
        reasons = [w.observe(rid, ttft_s=t, e2e_s=e, stop_reason=s)
                   for rid, t, e, s in seq]
        dumps = sorted(p.name for p in (tmp_path / name).iterdir())
        out[name] = (reasons, w.stats(), dumps, w.enabled)
    assert out["jax"] == out["torch"]
    assert out["torch"][1]["slo_breach_total"] == 3


def _write_jax_spans(tmp_path):
    """Three processes' span files written by the JAX package's tracer:
    a router, a prefill replica and a decode replica, with a shipped
    request, a colocated one and a replica-only one."""
    t = {}
    for proc in ("router", "prefill", "decode"):
        t[proc] = jr.RequestTracer(tmp_path / proc / "spans.jsonl",
                                   process="router" if proc == "router"
                                   else "serve")
    base = t["router"]._anchor_mono
    r, p, d = t["router"], t["prefill"], t["decode"]
    for i, rid in enumerate(("ship-1", "colo-2")):
        o = base + i
        r.add(rid, "request", o, o + 0.6)
        r.add(rid, "admission_wait", o + 0.001, o + 0.01)
        if rid.startswith("ship"):
            r.add(rid, "page_ship", o + 0.012, o + 0.25)
            p.add(rid, "prefill_http", o + 0.013, o + 0.2)
            p.add(rid, "prefill_export", o + 0.014, o + 0.19, blocks=8)
        r.add(rid, "proxy", o + 0.26, o + 0.59, replica="d")
        d.add(rid, "http", o + 0.262, o + 0.588, stream=True)
        d.add(rid, "tier", o + 0.264, o + 0.27, blocks=2)
        d.add(rid, "queue_wait", o + 0.263, o + 0.28)
        d.add(rid, "admit", o + 0.28, o + 0.3, mode="paged")
        d.add(rid, "first_token", o + 0.31, ttft_s=0.048)
        d.add(rid, "decode_chunk", o + 0.4, tokens=8)
        d.add(rid, "complete", o + 0.58, tokens=16, e2e_s=0.317)
    d.add("solo-3", "http", base + 3, base + 3.2)
    d.add("solo-3", "queue_wait", base + 3.001, base + 3.01)
    d.add("solo-3", "first_token", base + 3.1)
    d.add("solo-3", "complete", base + 3.19)
    for tracer in t.values():
        tracer.close()


def _skewed(skew=-0.05):
    spans = []
    for i, rid in enumerate(("r1", "r2", "r3")):
        t0 = 1_700_000_000.0 + i
        s = skew
        spans += [
            {"rid": rid, "name": "request", "proc": "router", "pid": 1,
             "t": t0, "dur_ms": 200.0},
            {"rid": rid, "name": "admission_wait", "proc": "router",
             "pid": 1, "t": t0 + 0.002, "dur_ms": 30.0},
            {"rid": rid, "name": "proxy", "proc": "router", "pid": 1,
             "t": t0 + 0.034, "dur_ms": 160.0, "attrs": {"replica": "r0"}},
            {"rid": rid, "name": "http", "proc": "serve", "pid": 2,
             "t": t0 + 0.036 + s, "dur_ms": 155.0},
            {"rid": rid, "name": "queue_wait", "proc": "serve", "pid": 2,
             "t": t0 + 0.038 + s, "dur_ms": 20.0},
            {"rid": rid, "name": "admit", "proc": "serve", "pid": 2,
             "t": t0 + 0.058 + s, "dur_ms": 40.0,
             "attrs": {"mode": "warm", "prefix_hit_tokens": 32}},
            {"rid": rid, "name": "first_token", "proc": "serve", "pid": 2,
             "t": t0 + 0.108 + s, "dur_ms": 0.0, "attrs": {"ttft_s": 0.108}},
            {"rid": rid, "name": "complete", "proc": "serve", "pid": 2,
             "t": t0 + 0.180 + s, "dur_ms": 0.0,
             "attrs": {"tokens": 16, "e2e_s": 0.144}}]
    return spans + [{"rid": "orphan", "name": "http", "proc": "serve",
                     "pid": 2, "t": 1_700_000_010.0, "dur_ms": 5.0}]


def _same(spans, client=None):
    got = tr.stitch_spans(spans, client_e2e_by_rid=client)
    assert got == jr.stitch_spans(spans, client_e2e_by_rid=client)
    assert tr.attribution(got) == jr.attribution(got)
    assert tr.estimate_offsets(spans) == jr.estimate_offsets(spans)
    assert json.dumps(tr.to_perfetto(spans)) == \
        json.dumps(jr.to_perfetto(spans))
    return got


def test_stitch_attribution_perfetto_on_jax_written_spans(tmp_path):
    _write_jax_spans(tmp_path)
    files = tr.discover_span_files(tmp_path)
    assert files == jr.discover_span_files(tmp_path) and len(files) == 3
    spans = tr.load_spans(files)
    assert spans == jr.load_spans(files)
    got = _same(spans, client={"ship-1": 0.61})
    rows = {r["rid"]: r for r in got["requests"]}
    assert rows["ship-1"]["stitched"] and "page_ship" in rows[
        "ship-1"]["segments"]
    assert not rows["solo-3"]["stitched"]
    run = tr.stitch_run(tmp_path)
    assert run == jr.stitch_run(tmp_path)


def test_stitch_on_a_skewed_two_process_set():
    got = _same(_skewed())
    assert got["offsets"] == {"serve:2": pytest.approx(0.048)}
    assert got["counts"] == {"requests": 4, "stitched": 3, "partial": 1}
    _same(_skewed(skew=0.01))
