"""HTTP serving CLI of the port: the counterpart of the repository's root
``serve.py``, serving a params-only artifact (or a training checkpoint)
on the continuous slot engine over the paged KV pool, on the static
micro-batch scheduler, or one request at a time.

    python -m pytorch_distributed_template_tpu_torch.serve \\
        -r <artifact>/model \\
        -c pytorch_distributed_template_tpu_torch/configs/mistral_7b_serve_paged.json \\
        --port 0
    curl -s localhost:<port>/generate \\
        -d '{"prompt_ids": [1, 2, 3], "max_new_tokens": 16}'

Endpoints:

- ``POST /generate``: ``prompt`` or ``prompt_ids``, ``max_new_tokens``,
  ``temperature``, ``top_k``, ``top_p``, ``seed``, ``stop``,
  ``speculative`` (draft length of a batch-1 speculative request; the
  response adds its ``speculative`` stats), ``stream``.
  ``"stream": true`` answers with server-sent events: one ``data:`` line
  per absorbed batch of new ids (``{"ids": [...]}``, the deltas
  concatenate to the final ids), then the full response with ``"done":
  true``; a client that disconnects cancels its request.
- ``GET /healthz``: status, scheduler, engine stats, latency percentiles.
- ``GET /metrics?format=json``: the engine's ``stats`` and the pool's
  ``stats_snapshot``.

``--scheduler auto`` is the JAX rule: the continuous engine when the model
is pad-capable (the Llama family without a window) or has a window and a
prefix pool, the static micro-batcher (engine/serving.py
``BatchedGenerationService``) for other models (the GPT-2 family) when
``--max-batch`` > 1, else one request at a time. The port's continuous
engine runs over the paged pool only: when ``auto`` picks it and
``--prefix-cache`` is ``auto`` with no pool configured, the pool is turned
on with its default geometry. ``/healthz`` (``batching``) and
``/metrics?format=json`` (``stats``) report the scheduler's counters
(the static one's ``batches``, ``max_batch_size``, ...).
Runs on CUDA unless ``--device cpu``. ``--port 0`` binds a free port,
printed on the ``READY <url>`` line.

``--tp T`` (or the config's ``serving.tensor_parallel``) serves one model
over T cards: this process starts T rank processes itself (no
``torchrun``; ``parallel/serving_ranks.py``), each holding its Megatron
slice on its card, and keeps the engine on its own CPU. ``--dp D`` runs D
independent groups (engine/dp.py; the continuous scheduler only): group g
on cards ``[g T, (g + 1) T)``. With ``--device cpu`` the ranks run on gloo.
A rank that fails fails the server: its requests get an error, and the
process stops serving and exits non-zero. ``/metrics?format=json`` adds
``dp_groups``, ``tp_degree`` and one decode step's collectives
(``tp_collective_count_per_step``, ``tp_collective_bytes_per_step``,
``tp_collective_floor_bytes``, ``tp_<op>_count_per_step`` /
``tp_<op>_bytes_per_step``).

Left to later slices, each refused with a message naming it: ``--role``
(ROADMAP A3a.4), the spill tiers (A3a.3), ``POST /profile``, the page
shipping endpoints (A3a.4), ``/admin/*`` and the Prometheus text of
``/metrics``.
"""
from __future__ import annotations

import argparse
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from . import models  # noqa: F401  (registers the model families)
from .config import ConfigParser
from .engine.continuous import ContinuousBatchingService
from .engine.generate import pad_capable
from .engine.serving import (
    BatchedGenerationService, GenerationService, load_generation_stack,
)
from .parallel.tp import validate_dp_geometry

logger = logging.getLogger(__name__)

_LATER = {
    "/profile": "on-demand profiling (POST /profile) is a later slice of "
                "the port",
    "/prefill": "page shipping (disaggregated prefill/decode) is a later "
                "slice of the port (ROADMAP A3a.4)",
    "/export_pages": "page shipping is a later slice of the port (ROADMAP "
                     "A3a.4)",
    "/admit_pages": "page shipping is a later slice of the port (ROADMAP "
                    "A3a.4)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="LM HTTP serving CLI (PyTorch)")
    p.add_argument("-c", "--config", default=None, type=str,
                   help="Config overlay (its serving section applies).")
    p.add_argument("-r", "--resume", required=True, type=str,
                   help="Serving artifact to serve.")
    p.add_argument("-s", "--save_dir", default=None, type=str)
    p.add_argument("--host", default="127.0.0.1", type=str)
    p.add_argument("--port", default=8000, type=int,
                   help="0 picks a free port (printed on READY).")
    p.add_argument("--max-batch", default=8, type=int,
                   help="continuous engine slots; 1 serves one request at "
                        "a time")
    p.add_argument("--decode-chunk", default=8, type=int,
                   help="base decode steps per engine chunk")
    p.add_argument("--batch-window-ms", default=25.0, type=float,
                   help="how long an idle engine waits to group arrivals")
    p.add_argument("--scheduler", default="auto",
                   choices=("auto", "continuous", "static", "none"),
                   help="auto = continuous for pad-capable models (or a "
                        "window with a pool), static for the others when "
                        "--max-batch > 1, else none (one request at a "
                        "time)")
    p.add_argument("--prefix-cache", default="auto",
                   choices=("auto", "on", "off"),
                   help="paged KV prefix pool: auto follows the config's "
                        "serving.prefix_cache block")
    p.add_argument("--prefill-chunk-tokens", default=0, type=int,
                   help="chunked streaming prefill width (power of two; 0 "
                        "= config serving.prefill_chunk_tokens; window "
                        "models default to the ring slack)")
    p.add_argument("--device", default=None,
                   help="Device to run on (default cuda).")
    p.add_argument("--tp", default=0, type=int,
                   help="tensor-parallel degree: ranks started by this "
                        "process, one per card (0 = the config's "
                        "serving.tensor_parallel, else 1)")
    p.add_argument("--dp", default=1, type=int,
                   help="data-parallel engine groups, each on its own "
                        "--tp cards (continuous scheduler only)")
    p.add_argument("--role", default="both",
                   choices=("both", "prefill", "decode"),
                   help="disaggregated serving role (a later slice)")
    p.add_argument("--spill-blocks", default=0, type=int,
                   help="host KV spill tier (a later slice)")
    p.add_argument("--spill-dir", default="", type=str,
                   help="disk KV spill tier (a later slice)")
    return p


def _refuse_later(args) -> None:
    if args.role != "both":
        raise NotImplementedError(
            f"--role {args.role} (disaggregated prefill/decode with page "
            "shipping) is a later slice of the port (ROADMAP A3a.4)")
    if int(args.spill_blocks) > 0 or args.spill_dir:
        raise NotImplementedError(
            "KV spill tiers (--spill-blocks/--spill-dir) are a later slice "
            "of the port (ROADMAP A3a.3)")


def build_service(args, config) -> GenerationService:
    """The service the flags and config ask for, with its model loaded on
    ``args.device`` (CUDA unless asked otherwise): over ``--tp`` ranks per
    group and ``--dp`` groups."""
    _refuse_later(args)
    serving = config.get("serving") or {}
    prefix_cfg = dict(serving.get("prefix_cache") or {})
    if args.prefix_cache != "auto":
        prefix_cfg["enabled"] = args.prefix_cache == "on"
    chunk = int(args.prefill_chunk_tokens or 0) or int(
        serving.get("prefill_chunk_tokens") or 0)
    if chunk:
        prefix_cfg["prefill_chunk_tokens"] = chunk
    tp = int(args.tp or 0) or int(serving.get("tensor_parallel") or 1)
    dp = max(int(args.dp), 1)
    draft_layers = int(serving.get("speculative_draft_layers") or 0)
    continuous = dict(slots=args.max_batch, chunk=args.decode_chunk,
                      window_ms=args.batch_window_ms,
                      prefix_cache=prefix_cfg, prefill_chunk_tokens=chunk,
                      spec_draft_layers=draft_layers)
    if dp > 1:
        # validated before any load: a geometry typo fails at once
        validate_dp_geometry(dp, tp, args.device or "cuda")
        if args.scheduler not in ("auto", "continuous"):
            raise SystemExit("--dp > 1 requires the continuous scheduler "
                             f"(got --scheduler {args.scheduler})")
        from .engine.dp import DataParallelService

        return DataParallelService.build_from_config(
            config, ContinuousBatchingService, device=args.device, dp=dp,
            tp=tp, service_kw=continuous)
    model, tok = load_generation_stack(config, device=args.device,
                                       tensor_parallel=tp)
    want = args.scheduler
    if want == "auto":
        want = auto_scheduler(model, prefix_cfg, args.max_batch)
        if (want == "continuous" and args.prefix_cache == "auto"
                and not prefix_cfg.get("enabled")):
            # the port's continuous engine runs over the paged pool
            logger.info("scheduler auto: continuous engine over a default "
                        "paged pool")
            prefix_cfg.update(enabled=True, paged=True)
    try:
        if want == "continuous":
            return ContinuousBatchingService.from_model(
                model, tok, device=model.device, **continuous)
        if want == "static":
            return BatchedGenerationService.from_model(
                model, tok, device=model.device, max_batch=args.max_batch,
                window_ms=args.batch_window_ms, prefix_cache=prefix_cfg,
                spec_draft_layers=draft_layers)
        return GenerationService.from_model(model, tok, device=model.device,
                                            prefix_cache=prefix_cfg,
                                            spec_draft_layers=draft_layers)
    except BaseException:
        if hasattr(model, "close"):
            model.close()
        raise


def auto_scheduler(model, prefix_cfg: dict, max_batch: int) -> str:
    """The JAX ``--scheduler auto`` rule: ``"continuous"`` for a
    pad-capable model, or a windowed one with a prefix pool enabled,
    ``"static"`` for the others when ``max_batch`` > 1, else ``"none"``."""
    ring_ok = (int(getattr(model, "window", 0) or 0) > 0
               and bool(prefix_cfg.get("enabled")))
    if (pad_capable(model) or ring_ok) and int(max_batch) > 1:
        return "continuous"
    return "static" if int(max_batch) > 1 else "none"


def _groups(service) -> list:
    """The tensor-parallel rank groups behind a service."""
    engines = getattr(service, "_engines", None) or [service]
    return [e.model for e in engines if hasattr(e.model, "on_failure")]


def _run_request(service, req: dict, on_tokens=None, cancel=None) -> dict:
    """JSON request body -> ``service.generate`` kwargs."""
    kwargs = dict(
        prompt=req.get("prompt"), prompt_ids=req.get("prompt_ids"),
        max_new_tokens=int(req.get("max_new_tokens", 64)),
        temperature=float(req.get("temperature", 0.0)),
        top_k=int(req.get("top_k", 0)), top_p=float(req.get("top_p", 0.0)),
        seed=int(req.get("seed", 0)),
        speculative=int(req.get("speculative", 0)), stop=req.get("stop"))
    if on_tokens is not None:
        kwargs["on_tokens"] = on_tokens
    if cancel is not None:
        kwargs["cancel"] = cancel
    return service.generate(**kwargs)


def service_metrics(service) -> dict:
    """The ``/metrics?format=json`` payload: the engine's counters, queue
    and slot gauges, latency percentiles, and the pool's snapshot."""
    out = {"scheduler": type(service).__name__,
           "stats": dict(getattr(service, "stats", None) or {})}
    if hasattr(service, "queue_depth"):
        out["queue_depth"] = service.queue_depth()
        out["live_slots"] = service.live_slots()
        out["latency"] = service.latency_percentiles()
    out["prefix_cache"] = service.prefix_cache_stats()
    out["pool_refusal_reason"] = service.pool_refusal_reason
    # DP x TP: the group count, the TP degree and one decode step's
    # collectives (counted once on the ranks; zeros at tp 1), flat
    out["dp_groups"] = int(out["stats"].get("dp_groups", 1) or 1)
    tp = service.tp_stats()
    out["tp_degree"] = int(tp["tp_degree"])
    out["tp_collective_count_per_step"] = int(
        tp["collective_count_per_step"])
    out["tp_collective_bytes_per_step"] = int(
        tp["collective_bytes_per_step"])
    out["tp_collective_floor_bytes"] = int(tp["analytic_floor_bytes"])
    for op, n in tp["counts"].items():
        key = op.replace("-", "_")
        out[f"tp_{key}_count_per_step"] = int(n)
        out[f"tp_{key}_bytes_per_step"] = int(tp["bytes"].get(op, 0))
    return out


def make_handler(service):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            path, _, query = self.path.partition("?")
            if path == "/metrics":
                if "format=json" in query:
                    return self._send(200, service_metrics(service))
                return self._send(501, {
                    "error": "the Prometheus text exposition is a later "
                             "slice of the port: use /metrics?format=json"})
            if path.startswith("/admin/"):
                return self._send(501, {"error": "/admin/* is a later "
                                        "slice of the port"})
            if path != "/healthz":
                return self._send(404, {"error": "unknown path"})
            payload = {"status": "ok", "arch": service.arch,
                       "scheduler": type(service).__name__,
                       "vocab_size": service.vocab,
                       "tokenizer": service.tokenizer is not None,
                       "device": str(service.device),
                       "batching": getattr(service, "stats", None)}
            if hasattr(service, "latency_percentiles"):
                payload["latency"] = service.latency_percentiles()
            return self._send(200, payload)

        def do_POST(self):  # noqa: N802
            path = self.path.partition("?")[0]
            if path in _LATER or path.startswith("/admin/"):
                return self._send(501, {"error": _LATER.get(
                    path, "/admin/* is a later slice of the port")})
            if path != "/generate":
                return self._send(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if req.get("stream"):
                    return self._stream(req)
                return self._send(200, _run_request(service, req))
            except (ValueError, TypeError) as e:
                return self._send(400, {"error": str(e)})
            except NotImplementedError as e:
                return self._send(501, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — surface, keep serving
                logger.exception("request failed")
                return self._send(500, {"error": f"{type(e).__name__}: "
                                                 f"{e}"})

        def _stream(self, req: dict) -> None:
            """Server-sent events: token deltas as they absorb, then the
            full response with ``"done": true``. A client that hangs up
            sets the request's cancel event."""
            import queue as queue_mod

            service.validate_request(req)
            incremental = getattr(service, "STREAM_DELTAS", False)
            cancel = threading.Event() if incremental else None
            q: "queue_mod.Queue" = queue_mod.Queue()

            def run():
                try:
                    r = _run_request(
                        service, req,
                        on_tokens=((lambda ids: q.put(("tokens", ids)))
                                   if incremental else None),
                        cancel=cancel)
                    if not incremental and r.get("ids"):
                        q.put(("tokens", r["ids"]))
                    q.put(("done", r))
                except Exception as e:  # noqa: BLE001 — surfaced below
                    q.put(("error", e))

            threading.Thread(target=run, daemon=True).start()
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()

            def emit(payload: dict) -> None:
                self.wfile.write(b"data: " + json.dumps(payload).encode(
                    "utf-8") + b"\n\n")
                self.wfile.flush()

            try:
                while True:
                    kind, payload = q.get()
                    if kind == "tokens":
                        emit({"ids": [int(t) for t in payload]})
                    elif kind == "error":
                        emit({"error": f"{type(payload).__name__}: "
                                       f"{payload}", "done": True})
                        return
                    else:
                        emit({**payload, "done": True})
                        return
            except (BrokenPipeError, ConnectionError, OSError):
                if cancel is not None:
                    cancel.set()

        def log_message(self, fmt, *fmt_args):
            pass  # no per-request stderr lines

    return Handler


def main(argv=None, on_ready=None):
    """Parse ``argv`` (default ``sys.argv``), load the artifact, and serve
    until the server is shut down. ``on_ready(server, service)`` is
    called once the socket is bound (in-process callers stop the server
    with ``server.shutdown()``)."""
    args, config = ConfigParser.from_args(build_parser(), (),
                                          training=False, argv=argv)
    log = config.get_logger("serve")
    service = build_service(args, config)
    log.info("scheduler: %s on %s (dp %d, tp %d)", type(service).__name__,
             service.device, getattr(service, "dp", 1), service.tp)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(service))
    server.daemon_threads = True
    failed = []

    def on_failure(err):
        # the failing call has answered its requests with the error; stop
        # serving a moment later (shutdown() waits for serve_forever)
        failed.append(err)
        threading.Timer(1.0, server.shutdown).start()

    for group in _groups(service):
        group.on_failure.append(on_failure)
    threads = torch.get_num_threads()
    if _groups(service):
        # the engine computes only on small host tensors here: one
        # intra-op thread keeps its OpenMP team from competing with the
        # ranks' processes for the host's cores (PERF.md)
        torch.set_num_threads(1)
    url = f"http://{args.host}:{server.server_address[1]}"
    log.info("serving %s (vocab %d) on %s: POST /generate, GET /healthz, "
             "GET /metrics", service.arch, service.vocab, url)
    print(f"READY {url}", flush=True)
    if on_ready is not None:
        on_ready(server, service)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if hasattr(service, "close"):
            service.close()
        for group in _groups(service):
            group.close()
        torch.set_num_threads(threads)
    if failed:
        raise RuntimeError(f"a serving rank failed: {failed[0]}")
    return service


if __name__ == "__main__":
    main()
