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

Disaggregated prefill/decode (the JAX ``serve.py``'s endpoints and flags):
``--role prefill`` serves ``POST /prefill`` (``prompt`` or ``prompt_ids``:
the prompt's KV computed into this replica's pool and its full-block chain
answered as ``application/octet-stream`` page bytes, engine/kvcache.py's
``PDTPAGES1`` format, with ``X-Ship-Blocks``) and refuses ``/generate``
budgets over 1 token; ``--role decode`` serves ``POST /admit_pages`` (those
bytes as the body; ``X-Page-Origin: ship`` or ``pull`` tags the adopted
pages; a JSON receipt) and everything ``/generate`` asks; the wrong role
answers 403, a torn or foreign payload 400. ``POST /export_pages`` ships
the chain a replica already holds without computing anything, any role.
A role needs the prefix pool. ``--spill-blocks N`` demotes evicted pages
to a host tier of N blocks, ``--spill-dir D`` (with ``--spill-disk-blocks
M``) its overflow to disk (``D/g<i>`` for DP group i); every read is
checksummed. ``/metrics?format=json`` adds ``role``,
``pages_shipped_total``, ``page_ship_out_bytes_total``,
``page_ship_in_bytes_total``, ``page_ship_dropped_total`` and the tier
counters and gauges. Shipping and spill at ``--tp`` > 1 are refused,
naming A3a.4's TP remainder.

SIGTERM drains: the server stops accepting, waits up to ``--drain-grace-s``
(30) for the requests in flight, and exits with code 75 (the preemption
path a supervisor classifies). ``--ema`` serves a training checkpoint's
EMA weights.

Left to later slices, each refused with a message naming it: ``POST
/profile``, ``/admin/*`` and the Prometheus text of ``/metrics``.
"""
from __future__ import annotations

import argparse
import json
import logging
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from . import models  # noqa: F401  (registers the model families)
from .config import ConfigParser
from .data.tokenizer import tokenizer_from_config
from .engine.continuous import ContinuousBatchingService
from .engine.generate import pad_capable
from .engine.kvcache import TP_LATER, serialize_pages
from .engine.serving import (
    BatchedGenerationService, GenerationService, check_served_model,
    load_generation_stack,
)
from .parallel.tp import validate_dp_geometry
from .utils.preemption import EXIT_PREEMPTED

logger = logging.getLogger(__name__)

_LATER = {
    "/profile": "on-demand profiling (POST /profile) is a later slice of "
                "the port",
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
                   help="disaggregated serving role: prefill ships prompt "
                        "KV pages (POST /prefill), decode lands them (POST "
                        "/admit_pages); both = colocated")
    p.add_argument("--spill-blocks", default=0, type=int,
                   help="host KV spill tier: evicted pool pages demote to "
                        "host memory (this many blocks; 0 = off)")
    p.add_argument("--spill-dir", default="", type=str,
                   help="disk KV spill tier under the host one (with "
                        "--spill-disk-blocks)")
    p.add_argument("--spill-disk-blocks", default=0, type=int,
                   help="blocks the disk tier holds (0 = no disk tier)")
    p.add_argument("--ema", action="store_true",
                   help="serve a training checkpoint's EMA weights")
    p.add_argument("--drain-grace-s", default=30.0, type=float,
                   help="SIGTERM drain: how long to wait for in-flight "
                        "requests before exiting (rc 75)")
    return p


def _refuse_later(args, tp: int) -> None:
    """Shipping and spill under tensor parallelism, refused before any
    load."""
    if tp > 1 and (args.role != "both" or int(args.spill_blocks) > 0
                   or args.spill_dir):
        raise NotImplementedError(
            f"--role/--spill-* at --tp {tp}: {TP_LATER}")


def build_service(args, config, model=None) -> GenerationService:
    """The service the flags and config ask for, with its model loaded on
    ``args.device`` (CUDA unless asked otherwise): over ``--tp`` ranks per
    group and ``--dp`` groups. ``model``: one already loaded (tp 1, dp 1),
    served instead of loading the artifact again: in-process callers run
    several roles on one set of weights, each service with its own pool.
    It must be the model the config would load (``check_served_model``)."""
    serving = (config.get("serving") or {}) if config is not None else {}
    _refuse_later(args, int(args.tp or 0)
                  or int(serving.get("tensor_parallel") or 1))
    prefix_cfg = dict(serving.get("prefix_cache") or {})
    if args.prefix_cache != "auto":
        prefix_cfg["enabled"] = args.prefix_cache == "on"
    if int(args.spill_blocks) > 0:
        prefix_cfg["host_spill_blocks"] = int(args.spill_blocks)
    if args.spill_dir:
        prefix_cfg["disk_spill_dir"] = args.spill_dir
        if int(args.spill_disk_blocks) > 0:
            prefix_cfg["disk_spill_blocks"] = int(args.spill_disk_blocks)
    chunk = int(args.prefill_chunk_tokens or 0) or int(
        serving.get("prefill_chunk_tokens") or 0)
    if chunk:
        prefix_cfg["prefill_chunk_tokens"] = chunk
    tp = int(args.tp or 0) or int(serving.get("tensor_parallel") or 1)
    dp = max(int(args.dp), 1)
    if model is not None:
        if tp > 1 or dp > 1:
            raise ValueError("a model handed in serves one group at tp 1 "
                             f"(got --tp {tp}, --dp {dp})")
        check_served_model(model, config)
    draft_layers = int(serving.get("speculative_draft_layers") or 0)
    continuous = dict(slots=args.max_batch, chunk=args.decode_chunk,
                      window_ms=args.batch_window_ms,
                      prefix_cache=prefix_cfg, prefill_chunk_tokens=chunk,
                      spec_draft_layers=draft_layers, role=args.role)
    if dp > 1:
        # validated before any load: a geometry typo fails at once
        validate_dp_geometry(dp, tp, args.device or "cuda")
        if args.scheduler not in ("auto", "continuous"):
            raise SystemExit("--dp > 1 requires the continuous scheduler "
                             f"(got --scheduler {args.scheduler})")
        from .engine.dp import DataParallelService

        return DataParallelService.build_from_config(
            config, ContinuousBatchingService, device=args.device, dp=dp,
            tp=tp, use_ema=args.ema, service_kw=continuous)
    owned = model is None
    if owned:
        model, tok = load_generation_stack(config, device=args.device,
                                           use_ema=args.ema,
                                           tensor_parallel=tp)
    else:
        tok = tokenizer_from_config(config)
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
        if args.role != "both" and (want == "static"
                                    or not prefix_cfg.get("enabled")):
            # a role IS page shipping: it needs the pool, which the static
            # scheduler's shared prefills do not consult
            raise SystemExit(
                f"--role {args.role} needs the prefix pool (--prefix-cache "
                "on or a serving.prefix_cache block) and the continuous or "
                "plain scheduler: page shipping moves pool pages")
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
                                            spec_draft_layers=draft_layers,
                                            role=args.role)
    except BaseException:
        if owned and hasattr(model, "close"):
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
    pool = service.prefix_cache_stats()
    out["prefix_cache"] = pool
    out["pool_refusal_reason"] = service.pool_refusal_reason
    # disaggregated serving and the spill tiers, under the JAX server's
    # flat names: the role, the handoff counters, the page and byte
    # counters of shipping and the tiers, and the tiers' occupancy
    stats = out["stats"]
    out["role"] = str(getattr(service, "role", "both"))
    out["prefill_exports_total"] = int(stats.get("prefill_exports", 0))
    out["remote_admits_total"] = int(stats.get("remote_admits", 0))
    out["peer_exports_total"] = int(stats.get("peer_exports", 0))
    pool = pool or {}
    for key, name in _POOL_METRICS.items():
        out[name] = int(pool.get(key, 0))
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


#: pool snapshot key -> ``/metrics?format=json`` name (the JAX server's)
_POOL_METRICS = {
    "pages_exported": "pages_shipped_total",
    "pages_imported": "pages_imported_total",
    "page_ship_out_bytes": "page_ship_out_bytes_total",
    "page_ship_in_bytes": "page_ship_in_bytes_total",
    "page_ship_dropped": "page_ship_dropped_total",
    "warm_admit_copy_bytes": "warm_admit_copy_bytes_total",
    "tier_demoted_blocks": "tier_demoted_blocks_total",
    "tier_promoted_blocks": "tier_promoted_blocks_total",
    "tier_demote_bytes": "tier_demote_bytes_total",
    "tier_promote_bytes": "tier_promote_bytes_total",
    "tier_checksum_failures": "tier_checksum_failures_total",
    "tier_exhaust_drops": "tier_exhaust_drops_total",
    "tier_demote_errors": "tier_demote_errors_total",
    "tier_host_blocks": "tier_host_blocks",
    "tier_host_bytes": "tier_host_bytes",
    "tier_disk_blocks": "tier_disk_blocks",
    "tier_disk_bytes": "tier_disk_bytes",
}


class ActiveRequests:
    """In-flight HTTP requests: the SIGTERM drain waits for zero (a
    response completes only after its generate returns, SSE included)."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def __enter__(self):
        with self._lock:
            self._n += 1
        return self

    def __exit__(self, *exc):
        with self._lock:
            self._n -= 1
        return False

    @property
    def count(self) -> int:
        with self._lock:
            return self._n


def make_handler(service, active=None):
    active = active if active is not None else ActiveRequests()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_pages(self, payload: dict) -> None:
            body = serialize_pages(payload)
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Ship-Blocks", str(int(payload["n_blocks"])))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> bytes:
            return self.rfile.read(int(self.headers.get("Content-Length",
                                                        0)))

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
            with active:
                self._post()

        def _post(self):
            path = self.path.partition("?")[0]
            if path in _LATER or path.startswith("/admin/"):
                return self._send(501, {"error": _LATER.get(
                    path, "/admin/* is a later slice of the port")})
            role = getattr(service, "role", "both")
            if path == "/prefill" and role == "decode":
                return self._send(403, {
                    "error": "decode-role replica: POST pages to "
                             "/admit_pages, prompts to a prefill-role "
                             "replica's /prefill"})
            if path == "/admit_pages" and role == "prefill":
                return self._send(403, {
                    "error": "prefill-role replica does not ingest pages "
                             "(ship them to a decode-role replica)"})
            if path not in ("/generate", "/prefill", "/export_pages",
                            "/admit_pages"):
                return self._send(404, {"error": "unknown path"})
            try:
                if path == "/admit_pages":
                    # who pushed the pages: the prefill handoff ("ship")
                    # or a peer pull ("pull"); tags the adopted nodes
                    origin = (self.headers.get("X-Page-Origin")
                              or "ship").strip().lower()
                    return self._send(200, service.import_remote_pages(
                        self._body(),
                        origin=origin if origin == "pull" else "ship"))
                req = json.loads(self._body() or b"{}")
                if path == "/prefill":
                    return self._send_pages(service.prefill_export(
                        prompt=req.get("prompt"),
                        prompt_ids=req.get("prompt_ids")))
                if path == "/export_pages":
                    return self._send_pages(service.export_cached_pages(
                        prompt=req.get("prompt"),
                        prompt_ids=req.get("prompt_ids")))
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


def main(argv=None, on_ready=None, model=None):
    """Parse ``argv`` (default ``sys.argv``), load the artifact, and serve
    until the server is shut down. ``on_ready(server, service)`` is
    called once the socket is bound (in-process callers stop the server
    with ``server.shutdown()``). ``model``: an already loaded model to
    serve instead of loading ``-r`` again (:func:`build_service`). A
    SIGTERM drains and exits with ``EXIT_PREEMPTED`` (75)."""
    args, config = ConfigParser.from_args(build_parser(), (),
                                          training=False, argv=argv)
    log = config.get_logger("serve")
    service = build_service(args, config, model=model)
    log.info("scheduler: %s on %s (dp %d, tp %d, role %s)",
             type(service).__name__, service.device,
             getattr(service, "dp", 1), service.tp, service.role)
    active = ActiveRequests()
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(service, active))
    server.daemon_threads = True
    failed = []
    # SIGTERM drains (the preemption path): stop accepting, let requests
    # in flight finish within --drain-grace-s, exit EXIT_PREEMPTED
    draining = threading.Event()

    def on_sigterm(signum, frame):  # noqa: ARG001 (signal signature)
        if not draining.is_set():
            draining.set()
            # shutdown() waits for serve_forever, which runs this handler
            threading.Thread(target=server.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, on_sigterm)
    except ValueError:
        pass                    # not the main thread (in-process callers)

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
        if draining.is_set():
            deadline = time.monotonic() + float(args.drain_grace_s)
            while active.count and time.monotonic() < deadline:
                time.sleep(0.05)
            log.info("drained (%d request(s) still open); exiting via the "
                     "preemption path", active.count)
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if hasattr(service, "close"):
            service.close()
        if model is None:
            for group in _groups(service):
                group.close()
        torch.set_num_threads(threads)
    if failed:
        raise RuntimeError(f"a serving rank failed: {failed[0]}")
    if draining.is_set():
        raise SystemExit(EXIT_PREEMPTED)
    return service


if __name__ == "__main__":
    main()
