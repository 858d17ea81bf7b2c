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
- ``GET /healthz``: status (``degraded`` once the shadow auditor saw a
  divergence), scheduler, engine stats, latency percentiles,
  ``last_anomaly_step`` and the ``audit`` block.
- ``GET /metrics``: the Prometheus text exposition (prefix ``pdt_serve``;
  counters, gauges and the ``ttft_seconds`` / ``tpot_seconds`` /
  ``e2e_seconds`` histograms, the SLO, brownout, deadline,
  ``serve_path_<fingerprint>_total`` and audit families);
  ``?format=json`` for the same as JSON, plus the engine's ``stats`` and
  the pool's ``stats_snapshot`` (``prefix_cache``).
- ``POST /profile?steps=N[&timeout_s=S]``: a ``torch.profiler`` capture
  windowed on the scheduler's progress counter, written under the run's
  save dir; it answers when the capture closes, 409 while another runs.

Request tracing, deadlines and provenance (the JAX ``serve.py``'s): every
``/generate``, ``/prefill``, ``/export_pages`` and ``/admit_pages`` honours
an ``X-Request-Id`` (or mints one) and echoes it, SSE included; the tracer
appends the request's spans to ``<save_dir>/spans.jsonl`` (``--reqtrace``,
on by default). ``X-Deadline-Ms`` is a relative budget: malformed, 400;
spent before dispatch, 504 with ``X-Deadline-Expired: 1``; spent
mid-decode, 200 with the tokens so far, ``stop_reason: "deadline"`` and
that header. Each response carries its serve-path fingerprint in
``X-Serve-Path`` and ``serve_path`` (the SSE done event too).
``--slo-ttft-s`` / ``--slo-e2e-s`` (or ``serving.slo``) count breaches and
write bounded ``slow_request_<rid>.json`` dumps; ``--brownout`` (or
``serving.brownout``) turns on the continuous engine's degradation ladder;
``--audit`` (or ``serving.audit``) replays a deterministic stratified
sample of completed requests through the plain batch-1 service on the
same weights (a pooled reference of its own for an int8 pool; off at
``--dp`` > 1) and degrades ``/healthz`` on a token divergence. The
continuous engine feeds ``<save_dir>/timeseries.jsonl``, whose trailing
window anomaly and stall dumps carry. The ``stall_stream`` fault holds a
streamed ``/generate`` open; paths the server does not serve (``/admin/*``
among them: that route is the fleet router's) answer 404.

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
"""
from __future__ import annotations

import argparse
import itertools
import json
import logging
import os
import select
import signal
import socket
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
    BatchedGenerationService, DeadlineExceeded, GenerationService,
    check_served_model, load_generation_stack,
)
from .observability.audit import ShadowAuditor
from .observability.health import health_counters
from .observability.profiler import OnDemandProfiler
from .observability.reqtrace import (
    DEADLINE_EXPIRED_HEADER, DEADLINE_HEADER, SERVE_PATH_HEADER, Deadline,
    RequestTracer, SloWatcher, mint_request_id, sanitize_request_id,
)
from .observability.timeseries import (
    TimeSeriesStore, default_store, set_default_store,
)
from .parallel.tp import validate_dp_geometry
from .resilience import faults
from .resilience.supervisor import ENV_EVENTS, read_supervisor_stats
from .utils.compile_cache import compile_cache_stats
from .utils.preemption import EXIT_PREEMPTED
from .utils.promtext import prometheus_text

logger = logging.getLogger(__name__)


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
    p.add_argument("--reqtrace", default="on", choices=("on", "off"),
                   help="request-scoped span tracing: X-Request-Id-keyed "
                        "spans appended to <save_dir>/spans.jsonl")
    p.add_argument("--slo-ttft-s", default=0.0, type=float,
                   help="TTFT SLO in seconds: breaches count in "
                        "slo_breach_total and write bounded "
                        "slow_request_<rid>.json dumps (0 = config "
                        "serving.slo, else off)")
    p.add_argument("--slo-e2e-s", default=0.0, type=float,
                   help="end-to-end latency SLO in seconds (0 = config "
                        "serving.slo, else off)")
    p.add_argument("--brownout", default="auto",
                   choices=("auto", "on", "off"),
                   help="the continuous engine's brownout ladder (no "
                        "speculation, short chunks, clamped budgets, with "
                        "hysteresis); auto follows the config's "
                        "serving.brownout block (off when absent)")
    p.add_argument("--brownout-queue-norm", default=0.0, type=float,
                   help="a queue of slots x this reads as pressure 1.0 "
                        "(0 = config, else 1.0)")
    p.add_argument("--brownout-dwell-s", default=0.0, type=float,
                   help="least seconds at a brownout level before it may "
                        "step down (0 = config, else 2.0)")
    p.add_argument("--brownout-max-new", default=0, type=int,
                   help="level 3's cap on admitted max_new_tokens (0 = "
                        "config, else 4 decode chunks)")
    p.add_argument("--audit", default="auto", choices=("auto", "on", "off"),
                   help="sampled shadow replay of completed requests "
                        "through the plain batch-1 service on the same "
                        "weights; a token divergence counts, writes a "
                        "bounded divergence_<rid>.json and degrades "
                        "/healthz. auto follows serving.audit (off when "
                        "absent); needs --dp 1")
    p.add_argument("--audit-sample-rate", default=0.0, type=float,
                   help="audited fraction per fingerprint after the floor "
                        "(0 = config serving.audit.sample_rate, else 0.05)")
    p.add_argument("--audit-floor", default=0, type=int,
                   help="the first N completions of every fingerprint "
                        "audit whatever the rate (0 = config, else 4)")
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


def brownout_config(args, serving: dict) -> dict:
    """The ``serving.brownout`` block with the flags over it."""
    cfg = dict(serving.get("brownout") or {})
    if args.brownout != "auto":
        cfg["enabled"] = args.brownout == "on"
    for flag, key in (("brownout_queue_norm", "queue_norm"),
                      ("brownout_dwell_s", "dwell_s"),
                      ("brownout_max_new", "max_new_cap")):
        if getattr(args, flag) > 0:
            cfg[key] = getattr(args, flag)
    return cfg


def audit_config(args, serving: dict) -> dict:
    """The ``serving.audit`` block with the flags over it."""
    cfg = dict(serving.get("audit") or {})
    if args.audit != "auto":
        cfg["enabled"] = args.audit == "on"
    if args.audit_sample_rate > 0:
        cfg["sample_rate"] = args.audit_sample_rate
    if args.audit_floor > 0:
        cfg["floor"] = args.audit_floor
    return cfg


def build_service(args, config, model=None, tracer=None, slo=None,
                  tsdb=None) -> GenerationService:
    """The service the flags and config ask for, with its model loaded on
    ``args.device`` (CUDA unless asked otherwise): over ``--tp`` ranks per
    group and ``--dp`` groups. ``model``: one already loaded (tp 1, dp 1),
    served instead of loading the artifact again: in-process callers run
    several roles on one set of weights, each service with its own pool.
    It must be the model the config would load (``check_served_model``).
    ``tracer`` and ``slo`` go to every scheduler, the brownout ladder
    (``--brownout*``, ``serving.brownout``) to the continuous engine, and
    the store ``tsdb()`` makes (called only for that engine) to it, to
    group 0 alone at ``--dp`` > 1."""
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
    observe = dict(tracer=tracer, slo=slo)
    continuous = dict(slots=args.max_batch, chunk=args.decode_chunk,
                      window_ms=args.batch_window_ms,
                      prefix_cache=prefix_cfg, prefill_chunk_tokens=chunk,
                      spec_draft_layers=draft_layers, role=args.role,
                      brownout=brownout_config(args, serving), **observe)
    if dp > 1:
        # validated before any load: a geometry typo fails at once
        validate_dp_geometry(dp, tp, args.device or "cuda")
        if args.scheduler not in ("auto", "continuous"):
            raise SystemExit("--dp > 1 requires the continuous scheduler "
                             f"(got --scheduler {args.scheduler})")
        from .engine.dp import DataParallelService

        return DataParallelService.build_from_config(
            config, ContinuousBatchingService, device=args.device, dp=dp,
            tp=tp, use_ema=args.ema, service_kw=continuous,
            service_kw_fn=lambda g: ({"tsdb": tsdb()} if g == 0 and tsdb
                                     else {}))
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
                model, tok, device=model.device,
                tsdb=tsdb() if tsdb else None, **continuous)
        if want == "static":
            return BatchedGenerationService.from_model(
                model, tok, device=model.device, max_batch=args.max_batch,
                window_ms=args.batch_window_ms, prefix_cache=prefix_cfg,
                spec_draft_layers=draft_layers, **observe)
        return GenerationService.from_model(model, tok, device=model.device,
                                            prefix_cache=prefix_cfg,
                                            spec_draft_layers=draft_layers,
                                            role=args.role, **observe)
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


def _run_request(service, req: dict, on_tokens=None, cancel=None,
                 request_id=None, deadline=None) -> dict:
    """JSON request body -> ``service.generate`` kwargs. ``request_id``
    keys the request's spans; ``deadline`` is its ``X-Deadline-Ms``
    budget."""
    kwargs = dict(
        prompt=req.get("prompt"), prompt_ids=req.get("prompt_ids"),
        max_new_tokens=int(req.get("max_new_tokens", 64)),
        temperature=float(req.get("temperature", 0.0)),
        top_k=int(req.get("top_k", 0)), top_p=float(req.get("top_p", 0.0)),
        seed=int(req.get("seed", 0)),
        speculative=int(req.get("speculative", 0)), stop=req.get("stop"),
        request_id=request_id, deadline=deadline)
    if on_tokens is not None:
        kwargs["on_tokens"] = on_tokens
    if cancel is not None:
        kwargs["cancel"] = cancel
    return service.generate(**kwargs)


def audit_record(req: dict, out: dict) -> dict:
    """Wire request + finished response -> a ``ShadowAuditor`` record: the
    sampling a replay takes (``_run_request``'s defaults) and the served
    ids, fingerprint and stop reason the verdict compares."""
    return {"rid": out.get("request_id"), "serve_path": out.get("serve_path"),
            "ids": out.get("ids"), "stop_reason": out.get("stop_reason"),
            "prompt": req.get("prompt"), "prompt_ids": req.get("prompt_ids"),
            "max_new_tokens": int(req.get("max_new_tokens", 64)),
            "temperature": float(req.get("temperature", 0.0)),
            "top_k": int(req.get("top_k", 0)),
            "top_p": float(req.get("top_p", 0.0)),
            "seed": int(req.get("seed", 0)), "stop": req.get("stop")}


def supervisor_restart_stats() -> dict:
    """Restart counters from the resilience supervisor's log
    (``PDT_SUPERVISOR_EVENTS``, else ``supervisor.jsonl`` in the working
    directory; {} when neither exists)."""
    path = os.environ.get(ENV_EVENTS, "supervisor.jsonl")
    if not os.path.exists(path):
        return {}
    try:
        stats = read_supervisor_stats(path)
    except OSError:
        return {}
    return {"restarts_total": int(stats["restarts_total"]),
            "last_restart_cause": stats["last_restart_cause"]}


#: JSON-only sections of ``service_metrics`` (nested engine counters and
#: pool snapshot): the Prometheus text carries their flat counterparts
_JSON_ONLY = ("stats", "prefix_cache")


def service_metrics(service, auditor=None) -> dict:
    """The ``/metrics`` payload under the JAX server's flat names (and its
    order): request, token, deadline and brownout counters, queue and slot
    gauges, latency percentiles, the pool's counters and gauges, DP x TP,
    the health layer's counters, the latency histograms, the SLO, serve-path
    and audit families. JSON adds the engine's ``stats`` and the pool's
    snapshot (``prefix_cache``) as they are."""
    stats = dict(getattr(service, "stats", None) or {})
    out = {
        "scheduler": type(service).__name__,
        "requests_total": int(stats.get("requests",
                                        stats.get("completed", 0))),
        "requests_completed": int(stats.get("completed",
                                            stats.get("requests", 0))),
        "tokens_generated_total": int(stats.get("tokens_generated", 0)),
        "cancelled_total": int(stats.get("cancelled", 0)),
        "queue_depth": int(service.queue_depth()
                           if hasattr(service, "queue_depth") else 0),
        "live_slots": int(service.live_slots()
                          if hasattr(service, "live_slots") else 0),
        # a capacity gauge (no _total suffix)
        "slots": int(getattr(service, "_slots", 0)
                     or getattr(service, "_max_batch", 0) or 1),
    }
    for k in ("batches", "chunks", "admissions", "max_active",
              "batched_requests", "max_batch_size"):
        if k in stats:
            out[k] = int(stats[k])
    out["role"] = str(getattr(service, "role", "both"))
    out["dp_groups"] = int(stats.get("dp_groups", 1) or 1)
    out["prefill_exports_total"] = int(stats.get("prefill_exports", 0))
    out["remote_admits_total"] = int(stats.get("remote_admits", 0))
    out["deadline_expired_total"] = int(stats.get("deadline_expired", 0))
    out["brownout_clamped_total"] = int(stats.get("brownout_clamped", 0))
    # one monotonic progress counter over every scheduler's (a fleet
    # poller's wedge signature: frozen progress with pending work)
    out["scheduler_progress_total"] = (
        int(stats.get("chunks", 0)) + int(stats.get("batches", 0))
        + int(stats.get("admissions", 0))
        + int(stats.get("completed", stats.get("requests", 0)))
        + int(stats.get("tokens_generated", 0)))
    if hasattr(service, "brownout_stats"):
        out.update(service.brownout_stats())
    else:
        out["brownout_level"] = 0
    if hasattr(service, "latency_percentiles"):
        out["latency"] = service.latency_percentiles()
    pool = service.prefix_cache_stats()
    if pool is not None:
        for key in ("prefix_hit_tokens", "prefix_hit_requests",
                    "prefix_lookups", "prefix_inserted_blocks",
                    "prefix_evictions", "prefix_dropped_inserts"):
            out[f"{key}_total"] = int(pool[key])
        out["prefix_hit_rate"] = float(pool["prefix_hit_rate"])
        for key in ("prefix_pool_blocks", "prefix_pool_blocks_used",
                    "prefix_pool_blocks_resident",
                    "prefix_pool_blocks_referenced"):
            out[key] = int(pool[key])
        out["prefix_adopted_blocks_total"] = int(
            pool["prefix_adopted_blocks"])
        for key, name in _POOL_METRICS.items():
            out[name] = int(pool.get(key, 0))
        out["peer_exports_total"] = int(stats.get("peer_exports", 0))
        out["prefill_chunks_total"] = int(stats.get("prefill_chunks", 0))
        out["streamed_prefill_tokens_total"] = int(
            stats.get("streamed_prefill_tokens", 0))
        out["streamed_requests_total"] = int(
            stats.get("streamed_requests", 0))
        for key in ("prefix_page_bytes", "prefix_pool_window",
                    "prefix_pool_kv_quant"):
            out[key] = int(pool.get(key, 0))
        for reason in ("window", "kv_quant", "undersized", "gpt2_layout",
                       "dry_pool"):
            out[f"pool_fallback_{reason}_total"] = int(
                pool.get(f"pool_fallback_{reason}", 0))
        out["pool_fallback_total"] = int(pool.get("pool_fallback_total", 0))
        out["prefill_export_batches_total"] = int(
            stats.get("prefill_export_batches", 0))
        out["prefill_export_max_batch"] = int(
            stats.get("prefill_export_max_batch", 0))
        chunks = int(stats.get("chunks", 0) or 0)
        if chunks:
            out["paged_decode_frac"] = round(
                int(stats.get("paged_chunks", 0)) / chunks, 4)
        else:
            # which arm served each batch-1 request
            paged = int(pool.get("batch1_paged_requests", 0))
            served = paged + int(pool.get("batch1_scatter_requests", 0))
            out["paged_decode_frac"] = (round(paged / served, 4)
                                        if served else 0.0)
    out["pool_refusal_reason"] = service.pool_refusal_reason
    if pool is None and service.pool_refusal_reason:
        # the pool refused to build: every request ran without it,
        # attributed to the refusal's reason
        reason = str(service.pool_refusal_reason)
        refused = int(stats.get("pool_refused_requests", 0))
        for r in ("window", "kv_quant", "undersized", "gpt2_layout",
                  "unsupported"):
            out[f"pool_fallback_{r}_total"] = refused if r == reason else 0
        out["pool_fallback_total"] = refused
    # the kernel libraries' build cache (utils/compile_cache.py)
    cache = compile_cache_stats()
    out["compile_cache_hits_total"] = int(cache["hits"])
    out["compile_cache_misses_total"] = int(cache["misses"])
    # DP x TP: the TP degree and one decode step's collectives (counted
    # once on the ranks; zeros at tp 1), flat
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
    hc = health_counters()
    for key in ("anomaly_total", "straggler_windows_total",
                "profile_captures_total"):
        out[key] = int(hc[key])
    # fixed-bucket latency histograms (aggregable by bucket sums)
    for k, h in (getattr(service, "hist", None) or {}).items():
        out[k] = h.snapshot()
    if hasattr(service, "slo_stats"):
        out.update(service.slo_stats())
    # one counter per serve-path fingerprint (the label rides the name;
    # fingerprints are [a-z0-9_] by construction)
    if hasattr(service, "path_counts_snapshot"):
        for fp, n in sorted(service.path_counts_snapshot().items()):
            out[f"serve_path_{fp}_total"] = int(n)
    if auditor is not None:
        out.update(auditor.stats())
        for fp, cov in auditor.coverage().items():
            out[f"audit_path_{fp}_audited_total"] = int(cov["audited"])
            out[f"audit_path_{fp}_divergent_total"] = int(cov["divergent"])
    out.update(supervisor_restart_stats())
    out["stats"] = stats
    out["prefix_cache"] = pool
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


def make_handler(service, active=None, tracer=None, auditor=None,
                 profiler=None):
    active = active if active is not None else ActiveRequests()
    # 1-based ordinal of this server's streamed /generate requests, the
    # stall_stream fault's unit (streams only: deterministic under mixed
    # traffic)
    stream_ordinal = itertools.count(1)

    def count_expired() -> None:
        service.stats["deadline_expired"] = (
            service.stats.get("deadline_expired", 0) + 1)

    class Handler(BaseHTTPRequestHandler):
        _rid = None     # the request id echoed on every response

        def _send(self, code: int, payload: dict, headers=()) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if self._rid:
                self.send_header("X-Request-Id", self._rid)
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_text(self, code: int, text: str) -> None:
            body = text.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_pages(self, payload: dict) -> None:
            body = serialize_pages(payload)
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Request-Id", self._rid)
            self.send_header("X-Ship-Blocks", str(int(payload["n_blocks"])))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> bytes:
            return self.rfile.read(int(self.headers.get("Content-Length",
                                                        0)))

        def _offer_audit(self, req: dict, out) -> None:
            """A finished request offered to the shadow auditor (never
            blocks). Sampled speculative requests resample on rejection
            and cannot be replayed token for token: they are not
            offered."""
            if auditor is None or not isinstance(out, dict):
                return
            if (int(req.get("speculative", 0) or 0)
                    and float(req.get("temperature", 0.0) or 0.0)):
                return
            auditor.offer(audit_record(req, out))

        def do_GET(self):  # noqa: N802 (http.server API)
            with active:
                self._get()

        def _get(self):
            path, _, query = self.path.partition("?")
            if path == "/metrics":
                metrics = service_metrics(service, auditor=auditor)
                if "format=json" in query:
                    return self._send(200, metrics)
                return self._send_text(200, prometheus_text(
                    {k: v for k, v in metrics.items()
                     if k not in _JSON_ONLY}))
            if path != "/healthz":
                return self._send(404, {"error": "unknown path"})
            # a replica whose shadow replay caught a divergence still
            # serves, but says so
            degraded = auditor is not None and not auditor.healthy()
            payload = {"status": "degraded" if degraded else "ok",
                       "arch": service.arch,
                       "scheduler": type(service).__name__,
                       "vocab_size": service.vocab,
                       "tokenizer": service.tokenizer is not None,
                       "device": str(service.device),
                       "batching": getattr(service, "stats", None),
                       "last_anomaly_step":
                           health_counters()["last_anomaly_step"],
                       **supervisor_restart_stats()}
            if hasattr(service, "latency_percentiles"):
                payload["latency"] = service.latency_percentiles()
            if auditor is not None:
                payload["audit"] = auditor.stats()
            return self._send(200, payload)

        def do_POST(self):  # noqa: N802
            with active:
                self._post()

        def _post(self):
            path, _, query = self.path.partition("?")
            if path == "/profile":
                return self._profile(query)
            if path not in ("/generate", "/prefill", "/export_pages",
                            "/admit_pages"):
                return self._send(404, {"error": "unknown path"})
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
            # request identity: a propagated X-Request-Id is honoured,
            # direct traffic gets one minted; every response echoes it
            rid = (sanitize_request_id(self.headers.get("X-Request-Id"))
                   or mint_request_id())
            self._rid = rid
            t0 = time.monotonic()
            span, attrs = _SPANS[path], {}
            try:
                if path == "/admit_pages":
                    # who pushed the pages: the prefill handoff ("ship")
                    # or a peer pull ("pull"); tags the adopted nodes
                    origin = (self.headers.get("X-Page-Origin")
                              or "ship").strip().lower()
                    receipt = service.import_remote_pages(
                        self._body(),
                        origin=origin if origin == "pull" else "ship")
                    receipt["request_id"] = rid
                    return self._send(200, receipt)
                if path == "/export_pages":
                    req = json.loads(self._body() or b"{}")
                    return self._send_pages(service.export_cached_pages(
                        prompt=req.get("prompt"),
                        prompt_ids=req.get("prompt_ids")))
                # the RELATIVE X-Deadline-Ms budget anchored at this
                # hop's receipt: malformed is a client error, spent sheds
                # now, before any device work
                try:
                    deadline = Deadline.from_header(
                        self.headers.get(DEADLINE_HEADER), t0=t0)
                except ValueError as e:
                    return self._send(400, {"error": str(e),
                                            "request_id": rid})
                if deadline is not None and deadline.expired():
                    raise DeadlineExceeded("deadline already expired")
                req = json.loads(self._body() or b"{}")
                if path == "/prefill":
                    return self._send_pages(service.prefill_export(
                        prompt=req.get("prompt"),
                        prompt_ids=req.get("prompt_ids"), request_id=rid,
                        deadline=deadline))
                attrs["stream"] = bool(req.get("stream"))
                if attrs["stream"]:
                    return self._stream(req, rid, deadline)
                out = _run_request(service, req, request_id=rid,
                                   deadline=deadline)
                out["request_id"] = rid
                if out.get("stop_reason") == "deadline" and not out["ids"]:
                    # the engine dropped it in its queue (and counted
                    # it): spent before dispatch, no token was bought
                    return self._send(
                        504, {"error": "deadline expired in the queue",
                              "request_id": rid},
                        headers=[(DEADLINE_EXPIRED_HEADER, "1")])
                # a deadline-truncated result is a 200 with the marker
                hdrs = ([(DEADLINE_EXPIRED_HEADER, "1")]
                        if out.get("stop_reason") == "deadline" else [])
                if out.get("serve_path"):
                    hdrs.append((SERVE_PATH_HEADER, str(out["serve_path"])))
                self._send(200, out, headers=hdrs)
                self._offer_audit(req, out)
            except DeadlineExceeded as e:
                count_expired()
                self._send(504, {"error": str(e), "request_id": rid},
                           headers=[(DEADLINE_EXPIRED_HEADER, "1")])
            except (ValueError, TypeError) as e:
                self._send(400, {"error": str(e), "request_id": rid})
            except NotImplementedError as e:
                self._send(501, {"error": str(e), "request_id": rid})
            except Exception as e:  # noqa: BLE001 — surface, keep serving
                logger.exception("request failed")
                self._send(500, {"error": f"{type(e).__name__}: {e}",
                                 "request_id": rid})
            finally:
                if tracer is not None:
                    # the handler's span: receipt to the last byte out
                    # (an SSE tail included)
                    tracer.add(rid, span, t0, time.monotonic(), **attrs)
                self._rid = None

        def _profile(self, query: str) -> None:
            """``POST /profile?steps=N[&timeout_s=S]``: a capture windowed
            on the scheduler's progress counter (one counter: the first
            of chunks, batches, completed, requests, tokens_generated that
            the scheduler keeps); 409 while another capture runs."""
            from urllib.parse import parse_qsl

            params = dict(parse_qsl(query))
            try:
                steps = int(params.get("steps", 8))
                timeout_s = float(params.get("timeout_s", 30.0))
            except ValueError as e:
                return self._send(400, {"error": str(e)})
            counter = next((k for k in ("chunks", "batches", "completed",
                                        "requests", "tokens_generated")
                            if k in (service.stats or {})), None)
            if steps > 0 and counter is None:
                return self._send(503, {
                    "error": "the scheduler keeps no progress counter; "
                             "steps=0 captures at once"})
            out = profiler.capture(
                steps=steps, timeout_s=timeout_s,
                progress_fn=lambda: int(service.stats.get(counter, 0)))
            code = (409 if out.get("busy")
                    else 500 if "error" in out else 200)
            self._send(code, out)

        def _stall_stream(self, spec) -> None:
            """The ``stall_stream`` fault: hold the SSE connection open
            without writing until the peer hangs up or the spec's
            duration (30 x it without an argument) runs out."""
            end = time.monotonic() + max(spec.duration_s, 1.0) * (
                30.0 if spec.arg is None else 1.0)
            while time.monotonic() < end:
                try:
                    ready, _, _ = select.select([self.connection], [], [],
                                                0.25)
                    if ready and not self.connection.recv(1,
                                                          socket.MSG_PEEK):
                        return          # the peer closed
                except OSError:
                    return

        def _stream(self, req: dict, rid: str, deadline) -> None:
            """Server-sent events: token deltas as they absorb, then the
            full response with ``"done": true``. A client that hangs up
            sets the request's cancel event; the ``stall_stream`` fault
            freezes the stream after its first delta."""
            import queue as queue_mod

            # validated before the 200 goes out: a bad body is a 400
            service.validate_request(req)
            stall = faults.on_serve_request(next(stream_ordinal))
            incremental = getattr(service, "STREAM_DELTAS", False)
            # speculative requests run batch 1 and ignore cancel
            cancel = (threading.Event()
                      if incremental and not int(req.get("speculative", 0))
                      else None)
            q: "queue_mod.Queue" = queue_mod.Queue()

            def run():
                try:
                    r = _run_request(
                        service, req,
                        on_tokens=((lambda ids: q.put(("tokens", ids)))
                                   if incremental else None),
                        cancel=cancel, request_id=rid, deadline=deadline)
                    r["request_id"] = rid
                    if not incremental and r.get("ids"):
                        q.put(("tokens", r["ids"]))
                    q.put(("done", r))
                except Exception as e:  # noqa: BLE001 — surfaced below
                    q.put(("error", e))

            threading.Thread(target=run, daemon=True).start()
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("X-Request-Id", rid)
            self.end_headers()

            def emit(payload: dict) -> None:
                self.wfile.write(b"data: " + json.dumps(payload).encode(
                    "utf-8") + b"\n\n")
                self.wfile.flush()

            # the headers are out: nothing may write a second response
            try:
                while True:
                    kind, payload = q.get()
                    if kind == "tokens":
                        emit({"ids": [int(t) for t in payload]})
                        if stall is not None:
                            self._stall_stream(stall)
                            if cancel is not None:
                                cancel.set()
                            return
                    elif kind == "error":
                        emit({"error": f"{type(payload).__name__}: "
                                       f"{payload}", "done": True})
                        return
                    else:
                        emit({**payload, "done": True})
                        self._offer_audit(req, payload)
                        return
            except (BrokenPipeError, ConnectionError, OSError):
                if cancel is not None:
                    cancel.set()

        def log_message(self, fmt, *fmt_args):
            pass  # no per-request stderr lines

    # the shadow auditor (None: off) and the profiler, for in-process
    # callers (``server.RequestHandlerClass.auditor``)
    Handler.auditor, Handler.profiler = auditor, profiler
    return Handler


#: the handler span each POST route records (the JAX server's names)
_SPANS = {"/generate": "http", "/prefill": "prefill_http",
          "/export_pages": "export_http", "/admit_pages": "admit_http"}


def build_auditor(args, config, service, model, tracer=None, tsdb=None):
    """The shadow auditor ``--audit`` / ``serving.audit`` asks for, or
    None. Its reference is the plain batch-1 service on the served
    weights (no pool: B1's prefill and the masked decode); with an int8
    pool, a pooled service with a pool of its own (pool pages and the
    contiguous cache quantize at different granularities, and a corrupt
    serving page must not leak into its reference). Off at ``--dp`` > 1,
    where no single model serves."""
    serving = (config.get("serving") or {}) if config is not None else {}
    cfg = audit_config(args, serving)
    if not cfg.get("enabled"):
        return None
    if int(args.dp) > 1:
        logger.warning("audit: unavailable with --dp > 1; disabled")
        return None
    ref = GenerationService.from_model(model, service.tokenizer,
                                       device=model.device)
    pool = service._prefix
    if getattr(model, "kv_quant", "") and pool is not None:
        ref = GenerationService.from_model(
            model, service.tokenizer, device=model.device, prefix_cache={
                "enabled": True, "block_tokens": pool.block,
                "pool_blocks": pool.pool_blocks, "paged": pool.paged,
                "ring_slack_tokens": pool.ring_slack_tokens})
        logger.info("audit: pooled %s reference", model.kv_quant)

    def reference(rec: dict) -> list:
        return ref.generate(
            prompt=rec.get("prompt"), prompt_ids=rec.get("prompt_ids"),
            max_new_tokens=int(rec.get("max_new_tokens", 64)),
            temperature=float(rec.get("temperature", 0.0)),
            top_k=int(rec.get("top_k", 0)),
            top_p=float(rec.get("top_p", 0.0)),
            seed=int(rec.get("seed", 0)), stop=rec.get("stop"))["ids"]

    auditor = ShadowAuditor(
        reference, sample_rate=float(cfg.get("sample_rate", 0.05)),
        floor=int(cfg.get("floor", 4)),
        queue_max=int(cfg.get("queue_max", 64)),
        dump_dir=config.save_dir, tracer=tracer, tsdb=tsdb)
    logger.info("audit: shadow replay on (sample_rate=%.3f floor=%d)",
                auditor.sample_rate, auditor.floor)
    return auditor


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
    serving = config.get("serving") or {}
    # request tracing (on by default) and the SLO watcher: the flags win,
    # else the config's serving.slo block; no thresholds, no breaches
    tracer = (RequestTracer(config.save_dir / "spans.jsonl",
                            process="serve")
              if args.reqtrace != "off" else None)
    slo_cfg = dict(serving.get("slo") or {})
    slo = SloWatcher(ttft_s=args.slo_ttft_s or slo_cfg.get("ttft_s"),
                     e2e_s=args.slo_e2e_s or slo_cfg.get("e2e_s"),
                     dump_dir=config.save_dir, tracer=tracer,
                     max_dumps=int(slo_cfg.get("max_dumps", 8)),
                     cooldown_s=float(slo_cfg.get("cooldown_s", 30.0)))
    stores = []

    def make_tsdb():
        # the continuous engine's time series, and the process default
        # (anomaly and stall dumps carry its trailing window)
        store = TimeSeriesStore(config.save_dir / "timeseries.jsonl",
                                process="serve")
        set_default_store(store)
        stores.append(store)
        return store

    service = auditor = None
    try:
        service = build_service(args, config, model=model, tracer=tracer,
                                slo=slo, tsdb=make_tsdb)
        auditor = build_auditor(args, config, service, service.model,
                                tracer=tracer,
                                tsdb=stores[0] if stores else None)
    except BaseException:
        _close_observers(service, model, tracer, stores, auditor)
        raise
    log.info("scheduler: %s on %s (dp %d, tp %d, role %s)",
             type(service).__name__, service.device,
             getattr(service, "dp", 1), service.tp, service.role)
    active = ActiveRequests()
    server = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(service, active, tracer=tracer, auditor=auditor,
                     profiler=OnDemandProfiler(config.save_dir)))
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
    log.info("serving %s (vocab %d) on %s: POST /generate, POST /profile, "
             "GET /healthz, GET /metrics", service.arch, service.vocab, url)
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
        _close_observers(service, model, tracer, stores, auditor)
        torch.set_num_threads(threads)
    if failed:
        raise RuntimeError(f"a serving rank failed: {failed[0]}")
    if draining.is_set():
        raise SystemExit(EXIT_PREEMPTED)
    return service


def _close_observers(service, model, tracer, stores, auditor) -> None:
    """Stop what ``main`` started: the auditor's replays (queued ones are
    abandoned), the service (and the rank groups it loaded), the time
    series (its open interval written out) and the tracer."""
    if auditor is not None:
        auditor.close()
    if service is not None:
        if hasattr(service, "close"):
            service.close()
        if model is None:
            for group in _groups(service):
                group.close()
    for store in stores:
        store.close()
        if default_store() is store:
            set_default_store(None)
    if tracer is not None:
        tracer.close()


if __name__ == "__main__":
    main()
