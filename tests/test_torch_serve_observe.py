"""The observability surface of the port's ``serve.py`` over HTTP on the CPU
(a tiny TinyLlama artifact from the port's tool, servers in-process):

- ``X-Request-Id`` honoured or minted and echoed (SSE included),
  ``X-Serve-Path`` in the header and the body (the SSE done event too);
  ``X-Deadline-Ms: tomorrow`` is a 400, a spent budget a 504 with
  ``X-Deadline-Expired: 1``, a budget that runs out mid-decode (made
  deterministic with ``slow_decode``) a 200 with that header,
  ``stop_reason: "deadline"`` and fewer tokens; ``deadline_expired_total``
  counts all three;
- ``GET /metrics`` is Prometheus text that ``lint_exposition`` passes, and
  its metric families are the JAX ``serve.py``'s ``service_metrics`` families
  for the same traffic, but for an allow-list written here with the reason
  for each;
- ``POST /profile`` answers 200, and 409 while a capture runs;
  ``/admin/x`` answers 404;
- ``stall_stream`` holds an SSE stream open after its first delta;
- a stall dump of the serving process carries the time series' window;
- ``hang`` wedges an engine while its metrics keep answering (its thread
  a daemon nothing waits on: nothing here can hang the suite);
- ``ckpt_corrupt`` makes ``serve.py -r`` refuse the artifact;
- ``--dp 2`` sums the groups' histograms and shares one SLO count;
- ``--audit on`` replays every request and reports no divergence.
"""
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from pytorch_distributed_template_tpu_torch import serve
from pytorch_distributed_template_tpu_torch.resilience import faults
from pytorch_distributed_template_tpu_torch.tools import (
    make_serving_artifact as tool,
)
from pytorch_distributed_template_tpu_torch.utils.promtext import (
    lint_exposition,
)

PROMPT = list(range(3, 40))

#: families the JAX server exposes and the port's does not, and why
JAX_ONLY = {
    # the JAX engine counts an era at every idle tick (its non-paged
    # shared cache restarts positions there); the port's engine is paged
    # only and has no eras
    "pdt_serve_eras",
}
#: family prefixes the JAX server exposes and the port's does not
JAX_ONLY_PREFIXES = (
    # XLA's cost model of the decode executable (the step anatomy, a
    # background analysis of the compiled HLO): the port has no HLO
    "pdt_serve_decode_step_anatomy_",
)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("art")
    tool.main(["-o", str(tmp / "art"), "--arch", "TinyLlama", "--seed", "2",
               "--device", "cpu"])
    return tmp / "art" / "model"


class Server:
    """``serve.main`` in a thread on a free port."""

    def __init__(self, artifact, run_dir, *flags):
        ready, self.box = threading.Event(), {}

        def on_ready(srv, svc):
            self.box.update(server=srv, service=svc)
            ready.set()

        def target():
            try:
                serve.main(argv, on_ready)
            except BaseException as e:  # noqa: BLE001 — asserted below
                self.box["error"] = e
                ready.set()

        self.run_dir = Path(run_dir)
        argv = ["-r", str(artifact), "-s", str(run_dir), "--port", "0",
                "--device", "cpu", "--prefix-cache", "on",
                "--max-batch", "3", "--decode-chunk", "4",
                "--batch-window-ms", "5", *flags]
        self.thread = threading.Thread(target=target, daemon=True)
        self.thread.start()
        assert ready.wait(120), "serve.main never became ready"
        if "error" in self.box:
            raise self.box["error"]
        self.service = self.box["service"]
        host, port = self.box["server"].server_address[:2]
        self.url = f"http://{host}:{port}"
        self.streams = 0

    def close(self):
        self.box["server"].shutdown()
        self.thread.join(60)
        assert not self.thread.is_alive()

    def post(self, path, body=None, headers=None, timeout=60):
        """``(status, headers, body bytes)``; an error status does not
        raise."""
        req = urllib.request.Request(
            self.url + path, data=json.dumps(body or {}).encode(),
            headers=dict(headers or {}), method="POST")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()

    def get(self, path):
        try:
            with urllib.request.urlopen(self.url + path, timeout=60) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    def metrics(self) -> dict:
        return json.loads(self.get("/metrics?format=json")[1])

    def stream(self, body, headers=None):
        """One SSE ``/generate``: ``(response headers, events)``."""
        self.streams += 1
        status, hdrs, raw = self.post("/generate", dict(body, stream=True),
                                      headers)
        assert status == 200, raw
        events = [json.loads(line[len(b"data: "):])
                  for line in raw.splitlines() if line.startswith(b"data: ")]
        return hdrs, events


@pytest.fixture(scope="module")
def server(artifact, tmp_path_factory):
    srv = Server(artifact, tmp_path_factory.mktemp("run"))
    yield srv
    srv.close()


def families(text: str) -> set:
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def test_request_ids_serve_paths_and_deadlines(server):
    body = {"prompt_ids": PROMPT, "max_new_tokens": 6}
    expired0 = server.metrics()["deadline_expired_total"]
    status, hdrs, raw = server.post("/generate", body,
                                    {"X-Request-Id": "client-7"})
    out = json.loads(raw)
    assert status == 200 and hdrs["X-Request-Id"] == "client-7"
    assert out["request_id"] == "client-7"
    assert hdrs["X-Serve-Path"] == out["serve_path"] == "paged"
    # minted when absent; a hostile id is replaced
    for sent in (None, "bad id with spaces"):
        _, hdrs, raw = server.post(
            "/generate", body, {"X-Request-Id": sent} if sent else None)
        assert len(hdrs["X-Request-Id"]) == 16
        assert json.loads(raw)["serve_path"] == "paged_adopt"
    sse_hdrs, events = server.stream(body, {"X-Request-Id": "sse-1"})
    assert sse_hdrs["X-Request-Id"] == "sse-1"
    assert events[-1]["done"] and events[-1]["serve_path"] == "paged_adopt"
    assert events[-1]["request_id"] == "sse-1"
    # malformed budget: 400; a spent one: 504 before dispatch
    status, _, raw = server.post("/generate", body,
                                 {"X-Deadline-Ms": "tomorrow"})
    assert status == 400 and "request_id" in json.loads(raw)
    status, hdrs, _ = server.post("/generate", body, {"X-Deadline-Ms": "1"})
    assert status == 504 and hdrs["X-Deadline-Expired"] == "1"
    # a budget spent mid-decode: the third round sleeps past it
    svc = server.service
    faults.configure(f"slow_decode@tick:{svc.stats['chunks'] + 2}:1000ms")
    status, hdrs, raw = server.post(
        "/generate", {"prompt_ids": list(range(50, 70)),
                      "max_new_tokens": 40}, {"X-Deadline-Ms": "500"})
    out = json.loads(raw)
    assert status == 200 and hdrs["X-Deadline-Expired"] == "1"
    assert out["stop_reason"] == "deadline" and len(out["ids"]) == 13
    assert server.metrics()["deadline_expired_total"] == expired0 + 2
    # the spans carry the client's id through the engine
    spans = [json.loads(line) for line in next(
        server.run_dir.rglob("spans.jsonl")).read_text().splitlines()]
    names = [r["name"] for r in spans if r.get("rid") == "client-7"]
    for name in ("queue_wait", "admit", "first_token", "serve_path",
                 "complete", "http"):
        assert name in names, names


def test_metrics_text_lints_clean_and_has_jax_families(server, tmp_path):
    import jax
    import jax.numpy as jnp

    import pytorch_distributed_template_tpu.models  # noqa: F401
    import serve as jserve
    from pytorch_distributed_template_tpu.config.registry import MODELS
    from pytorch_distributed_template_tpu.engine.continuous import (
        ContinuousBatchingService,
    )
    from pytorch_distributed_template_tpu.observability.reqtrace import (
        RequestTracer, SloWatcher,
    )
    from pytorch_distributed_template_tpu.utils.promtext import (
        prometheus_text,
    )

    traffic = [{"prompt_ids": PROMPT, "max_new_tokens": 6},
               {"prompt_ids": PROMPT + [9], "max_new_tokens": 6}]
    for body in traffic:
        assert server.post("/generate", body)[0] == 200
    status, text = server.get("/metrics")
    assert status == 200
    assert lint_exposition(text) == []
    port = families(text)
    for fam in ("pdt_serve_slo_breach_total", "pdt_serve_brownout_level",
                "pdt_serve_deadline_expired_total",
                "pdt_serve_serve_path_paged_total",
                "pdt_serve_serve_path_paged_adopt_total",
                "pdt_serve_ttft_seconds", "pdt_serve_tpot_seconds",
                "pdt_serve_e2e_seconds"):
        assert fam in port, fam
    # the JAX server's families for the same traffic
    # families do not depend on the widths: a small model compiles fast
    model = MODELS.get("Llama")(vocab_size=256, n_layer=1, n_head=2,
                                n_kv_head=1, d_model=16, max_len=128)
    params = model.init(jax.random.key(0),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    tracer = RequestTracer(tmp_path / "spans.jsonl")
    jsvc = ContinuousBatchingService.from_model(
        model, params, slots=3, chunk=4, window_ms=5.0,
        prefix_cache={"enabled": True, "paged": True}, tracer=tracer,
        slo=SloWatcher(dump_dir=tmp_path, tracer=tracer))
    for i, body in enumerate(traffic):
        jsvc.generate(request_id=f"j{i}", **body)
    jax_fams = families(prometheus_text(jserve.service_metrics(jsvc)))
    tracer.close()
    missing = {f for f in jax_fams - port
               if f not in JAX_ONLY and not f.startswith(JAX_ONLY_PREFIXES)}
    assert missing == set()
    assert port - jax_fams == set()


def test_profile_and_unknown_paths(server):
    box = {}
    first = threading.Thread(target=lambda: box.update(
        r=server.post("/profile?steps=100000&timeout_s=2")))
    first.start()
    time.sleep(0.5)
    status, _, raw = server.post("/profile?steps=0")
    assert status == 409 and json.loads(raw)["busy"]
    first.join(60)
    status, _, raw = box["r"]
    out = json.loads(raw)
    assert status == 200 and out["timed_out"]
    assert Path(out["trace_file"]).is_file()
    assert server.metrics()["profile_captures_total"] >= 1
    assert server.post("/profile?steps=x")[0] == 400
    for path in ("/admin/drain", "/admin/x"):
        assert server.post(path)[0] == 404
        assert server.get(path)[0] == 404


def test_stall_stream_holds_the_stream_open(server):
    faults.configure(f"stall_stream@req:{server.streams + 1}:30s")
    server.streams += 1
    body = json.dumps({"prompt_ids": PROMPT, "max_new_tokens": 24,
                       "stream": True}).encode()
    host, port = server.url.split("//")[1].split(":")
    with socket.create_connection((host, int(port)), timeout=60) as sock:
        sock.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
                     b"X-Request-Id: stalled-1\r\n"
                     b"Content-Length: %d\r\n\r\n" % len(body) + body)
        got = b""
        while b"data: " not in got:
            got += sock.recv(65536)
        sock.settimeout(1.0)
        with pytest.raises(socket.timeout):
            while True:
                chunk = sock.recv(65536)
                assert chunk, "the stalled stream was closed"
                assert b'"done"' not in chunk
    # the hang-up ends the stall long before its 30 s: the handler's
    # span lands
    spans = next(server.run_dir.rglob("spans.jsonl"))
    end = time.monotonic() + 10
    while '"rid": "stalled-1", "name": "http"' not in spans.read_text():
        assert time.monotonic() < end, "the stall outlived its client"
        time.sleep(0.05)


def test_stall_dump_carries_the_time_series_window(server, tmp_path):
    from pytorch_distributed_template_tpu_torch.observability.timeseries \
        import default_store
    from pytorch_distributed_template_tpu_torch.observability.trace import (
        get_recorder,
    )
    from pytorch_distributed_template_tpu_torch.utils.watchdog import (
        StepWatchdog,
    )

    assert server.post("/generate", {"prompt_ids": PROMPT,
                                     "max_new_tokens": 4})[0] == 200
    store = default_store()
    assert store is not None and store is server.service._tsdb
    dump = tmp_path / "stall.json"
    wd = StepWatchdog(timeout_s=0.2, dump_stacks=False, dump_path=dump,
                      spans=get_recorder())
    wd.start()
    try:
        end = time.monotonic() + 30
        while not dump.exists():
            assert time.monotonic() < end, "no stall dump"
            time.sleep(0.05)
    finally:
        wd.stop()
    report = json.loads(dump.read_text())
    assert "timeseries_window" in report
    assert report["timeseries_window"] == store.points(last_n=16)[
        :len(report["timeseries_window"])]


def test_hang_wedges_the_engine_while_metrics_answer(server):
    """``hang@tick`` blocks the engine's thread forever by design: an
    engine of its own on the server's model, its thread a daemon left
    wedged (the fault fires once; nothing waits on that thread)."""
    from pytorch_distributed_template_tpu_torch.engine.continuous import (
        ContinuousBatchingService,
    )

    eng = ContinuousBatchingService.from_model(
        server.service.model, device="cpu", slots=2, chunk=4,
        prefix_cache={"enabled": True, "paged": True})
    faults.configure("hang@tick:0")
    box = {}
    th = threading.Thread(target=lambda: box.update(r=eng.generate(
        prompt_ids=PROMPT, max_new_tokens=4)), daemon=True)
    th.start()
    progress = []
    for _ in range(2):
        time.sleep(0.3)
        progress.append(serve.service_metrics(eng)[
            "scheduler_progress_total"])
    assert th.is_alive() and "r" not in box
    assert progress[0] == progress[1] == 0
    assert eng._worker_thread.is_alive()


def test_corrupt_artifact_is_refused(artifact, tmp_path):
    from pytorch_distributed_template_tpu_torch.checkpoint.serving import (
        ArtifactCorrupt,
    )

    faults.configure("ckpt_corrupt@load:1")
    with pytest.raises(ArtifactCorrupt):
        serve.main(["-r", str(artifact), "-s", str(tmp_path), "--port", "0",
                    "--device", "cpu"])


def test_dp2_sums_histograms_and_slo_counts(artifact, tmp_path):
    srv = Server(artifact, tmp_path, "--dp", "2", "--slo-ttft-s", "1e-9")
    try:
        bodies = [{"prompt_ids": [5 + i] * 20, "max_new_tokens": 4}
                  for i in range(4)]
        for b in bodies:
            status, hdrs, _ = srv.post("/generate", b)
            assert status == 200 and hdrs["X-Serve-Path"] == "paged_dp2"
        m = srv.metrics()
        engines = srv.service._engines
        per = [e.hist["ttft_seconds"].snapshot()["count"] for e in engines]
        assert all(per) and sum(per) == 4
        assert m["ttft_seconds"]["count"] == m["e2e_seconds"]["count"] == 4
        assert m["slo_breach_total"] == m["slo_ttft_breach_total"] == 4
        assert m["serve_path_paged_dp2_total"] == 4
        assert m["dp_groups"] == 2
    finally:
        srv.close()


def test_audit_replays_every_request_clean(artifact, tmp_path):
    srv = Server(artifact, tmp_path, "--audit", "on",
                 "--audit-sample-rate", "1.0", "--audit-floor", "2")
    try:
        bodies = [{"prompt_ids": PROMPT, "max_new_tokens": 5},
                  {"prompt_ids": PROMPT + [4], "max_new_tokens": 5},
                  {"prompt_ids": list(range(60, 70)), "max_new_tokens": 5}]
        for b in bodies:
            assert srv.post("/generate", b)[0] == 200
        end = time.monotonic() + 60
        while srv.metrics().get("audit_matched_total", 0) < len(bodies):
            assert time.monotonic() < end, srv.metrics()
            time.sleep(0.05)
        m = srv.metrics()
        assert m["audit_sampled_total"] == 3
        assert m["token_divergence_total"] == 0
        assert m["audit_path_paged_adopt_audited_total"] == 1
        _, health = srv.get("/healthz")
        health = json.loads(health)
        assert health["status"] == "ok"
        assert health["audit"]["audit_matched_total"] == 3
        assert health["last_anomaly_step"] is None
    finally:
        srv.close()
