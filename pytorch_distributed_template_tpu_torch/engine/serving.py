"""Request-level generation and model loading: the port of the JAX
package's ``engine/serving.py`` (the serialized service, the static
micro-batch scheduler, speculative requests).

``GenerationService`` validates and encodes a request (prompt text or ids,
stop tokens), runs ``engine.generate.generate`` for it with the request's
own ``torch.Generator``, and decodes the response. ``load_generation_stack``
turns ``config.resume`` (a params-only serving artifact, a w8a16 one
included, or a training checkpoint's ``model.pt``) into the model on its
device and the run's tokenizer.

``speculative: D`` (> 0) runs the request through prompt-lookup
speculative decoding (engine/generate.py) with the JAX service's
acceptance probe: the first ``SPEC_PROBE`` tokens speculate, then the rest
speculate on while the probe's tokens per verify call reach
``SPEC_MIN_TOKENS_PER_CALL``, else finish with plain decode
(``speculation_disabled``). With a prefix pool and a prefix hit the prompt
warm-prefills through the pool's scatter arm first. ``serving.
speculative_draft_layers`` > 0 drafts with the model's first layers
(Llama family). The response carries the ``speculative`` stats.

With ``serving.prefix_cache`` enabled the service builds the paged KV
block pool (engine/kvcache.py): a batch-1 request without stop tokens
reserves its cached prefix as block-table entries (no device copy),
prefills only the uncached suffix into private pool pages, decodes reading
the pool in place through the paged kernel (B4), and at the end adopts its
written blocks into the radix index. A pool that is not paged, a layout
the pool refuses, or a dry pool serves the request cold, counted under the
JAX package's ``pool_fallback_*`` reasons. ``serving.kv_quant: "int8"``
stores K/V int8 in the pool and in the cold path's cache.

Tensor parallelism (``serving.tensor_parallel`` or ``tensor_parallel=``
T > 1, parallel/tp.py): the model is a ``parallel.serving_ranks.
TensorParallelModel``, T rank processes each holding its Megatron slice
and its KV-head slice of every cache and of the pool, and the service
runs on the CPU of the serving process exactly as over a local model
(prefill B1 and the pool's B4 run on the ranks' local heads). ``tp`` and
``tp_stats()`` report the degree and one decode step's collectives.

A pool that is not paged (the GPT-2 family, or ``prefix_cache.paged:
false``) serves batch-1 requests through its scatter arm
(``PrefixCache.warm_prefill``: cached blocks copied into a contiguous
cache, the suffix prefilled, the prompt's blocks captured back).

``BatchedGenerationService`` is the static micro-batch scheduler: one
worker groups concurrent compatible requests (same prompt length for the
GPT-2 family, the same 128-token bucket for pad-capable models, whose
shorter rows are left-padded and masked; same budget and sampling) within
a batching window into one batched prefill and decode loop. Each row keeps
its own generator, so a request's output never depends on its batch;
speculative requests bypass the batcher. A batch of one request without
stop tokens runs the batch-1 pool path when a pool is attached (the JAX
scheduler has none), so a repeated prompt is served warm.

Disaggregated serving: ``role`` (``"both"``, ``"prefill"``, ``"decode"``;
a role needs the pool) gates budgets (:meth:`GenerationService.
_check_role`); :meth:`prefill_export` computes a prompt's pages and exports
its chain (concurrent calls coalesce under one lock acquisition),
:meth:`export_cached_pages` ships what the pool holds (spilled pages
promoted on the way out), :meth:`import_remote_pages` lands a payload or
its wire bytes (engine/kvcache.py). A spill tier configured in
``prefix_cache`` (``host_spill_blocks``, ``disk_spill_dir``,
``disk_spill_blocks``) promotes a demoted prefix at the batch-1 lookup.

Request tracing, deadlines and SLOs (the JAX service's): ``tracer`` (an
``observability.reqtrace.RequestTracer``) and ``slo`` (a ``SloWatcher``)
are optional; with them each request keyed by ``request_id`` records its
spans and events (``complete``, ``serve_path``, ``spec``,
``prefill_export``) and its SLO observation. ``deadline`` (a
``reqtrace.Deadline``) is checked at dispatch boundaries (entry, after the
lock wait; the static batcher sheds expired members before forming a
batch) and raises :class:`DeadlineExceeded`. Every response carries its
``serve_path`` fingerprint (``reqtrace.path_fingerprint``: admit mode, KV
layout, the pool events it consumed, TP / DP degree, brownout level),
counted per fingerprint for ``/metrics``; ``hist`` holds the fixed-bucket
TTFT / TPOT / e2e histograms.

Tensor parallelism refuses speculative requests (ROADMAP A4's
remainder), page shipping and spill (A3a.4's TP remainder), and serves a
non-paged pool's requests cold. A config with
LoRA adapters (``lora_rank > 0``) is refused at load: serving them
unmerged is A4's remainder (``tools/merge_lora.py`` merges them).
"""
from __future__ import annotations

import logging
import queue as queue_mod
import threading
import time

import torch

from .. import models  # noqa: F401  (registers the model families)
from ..resilience import faults
from ..observability.reqtrace import path_fingerprint
from .kvcache import (
    PrefixCache, deserialize_pages, empty_payload, page_origin_flags,
)
from ..checkpoint import (
    check_artifact_tp_geometry, load_serving_meta, restore_serving_params,
    verify_artifact_manifest,
)
from ..config.registry import MODELS, resolve
from ..data.tokenizer import tokenizer_from_config
from ..parallel.tp import (
    decode_step_collectives, dp_group_devices, shard_serving_params,
    tp_degree,
)
from ..utils.promtext import LatencyHistogram
from ..utils.util import resolve_device
from .generate import (
    _check_draft_layers, _decode_step, generate, generate_speculative,
    pad_capable, sample_logits, speculative_from_cache,
)

logger = logging.getLogger(__name__)


class DeadlineExceeded(RuntimeError):
    """A request's ``X-Deadline-Ms`` budget expired before (or while) it
    could be served. ``serve.py`` answers 504 with ``X-Deadline-Expired``;
    the continuous engine never raises it mid-flight (an expired decoding
    row finalizes with its tokens and ``stop_reason: "deadline"``)."""


class GenerationService:
    """The request-level generation entry of the front-ends.

    ``generate`` is serialized with a lock: one device, one decode path at
    a time. :meth:`close` stops the ranks of a tensor-parallel model the
    service loaded itself (a model handed to :meth:`from_model` stays its
    caller's).
    """

    def __init__(self, config, device=None, use_ema: bool = False,
                 tensor_parallel: int = 0, **kw):
        model, tokenizer = load_generation_stack(
            config, device=device, use_ema=use_ema,
            tensor_parallel=tensor_parallel)
        serving = config.get("serving") or {}
        kw.setdefault("prefix_cache", serving.get("prefix_cache"))
        kw.setdefault("spec_draft_layers",
                      int(serving.get("speculative_draft_layers") or 0))
        self._setup(model, tokenizer, **kw)
        self._owns_model = True

    #: serving roles (disaggregated prefill/decode): a "prefill" replica
    #: computes prompt KV into its pool and ships the pages
    #: (:meth:`prefill_export`) and refuses decode-scale budgets; a
    #: "decode" replica lands shipped pages (:meth:`import_remote_pages`)
    #: and serves everything; "both" is the colocated replica
    ROLES = ("both", "prefill", "decode")
    #: the largest budget a prefill-role replica serves on /generate (the
    #: prefill and its first sample)
    PREFILL_MAX_NEW = 1

    @classmethod
    def from_model(cls, model, tokenizer=None, device=None, **kw):
        """A service around an already built model, moved to ``device``
        (CUDA unless the caller asks for another); ``kw`` goes to
        ``_setup`` (``prefix_cache``, and the engine's own options in
        subclasses)."""
        obj = cls.__new__(cls)
        obj._setup(model.to(resolve_device(device)), tokenizer, **kw)
        return obj

    def _setup(self, model, tokenizer=None, prefix_cache=None,
               spec_draft_layers: int = 0, role: str = "both", tracer=None,
               slo=None):
        if role not in self.ROLES:
            raise ValueError(f"unknown serving role {role!r} (one of "
                             f"{self.ROLES})")
        self.role = role
        self.model, self.tokenizer = model.eval(), tokenizer
        self._owns_model = False
        self.device = model.device
        self.arch = getattr(model, "arch", None) or type(model).__name__
        self.vocab = int(getattr(model, "vocab_size", 0))
        self.tp = tp_degree(model)
        self._tp_stats = None
        self._tp_lock = threading.Lock()
        self._lock = threading.Lock()
        # pad-capable: per-row left-pad masking over a non-rolling cache
        # (mixed-length micro-batches, length-bucketed speculation)
        self._pad_ok = pad_capable(model)
        # early-exit draft depth of speculative requests (0: n-grams)
        try:
            self._spec_draft_layers = _check_draft_layers(
                model, spec_draft_layers or 0)
        except ValueError as e:
            logger.warning("speculative_draft_layers=%s unusable: %s; "
                           "falling back to n-gram drafting",
                           spec_draft_layers, e)
            self._spec_draft_layers = 0
        # the paged KV prefix pool: a prebuilt PrefixCache or a
        # ``serving.prefix_cache`` dict. A layout the pool refuses
        # disables it loudly (the reason is kept for /metrics) instead of
        # failing the load
        self._prefix = None
        self.pool_refusal_reason = ""
        if isinstance(prefix_cache, PrefixCache):
            self._prefix = prefix_cache
        elif prefix_cache is not None and dict(prefix_cache).get("enabled"):
            cfg = dict(prefix_cache)
            try:
                self._prefix = PrefixCache(
                    model, block_tokens=int(cfg.get("block_tokens", 32)),
                    pool_blocks=int(cfg.get("pool_blocks", 256)),
                    eviction=cfg.get("eviction", "lru"),
                    paged=bool(cfg.get("paged", True)),
                    ring_slack_tokens=int(
                        cfg.get("prefill_chunk_tokens", 0)
                        or cfg.get("ring_slack_tokens", 512)),
                    host_spill_blocks=int(cfg.get("host_spill_blocks", 0)),
                    disk_spill_dir=cfg.get("disk_spill_dir"),
                    disk_spill_blocks=int(cfg.get("disk_spill_blocks", 0)))
            except ValueError as e:
                logger.warning("prefix cache disabled: %s", e)
                self.pool_refusal_reason = getattr(e, "reason",
                                                   "unsupported")
        if self.role != "both" and self._prefix is None:
            # a role IS page shipping: refuse at startup, not at the first
            # handoff
            raise ValueError(
                f"role={self.role!r} needs a prefix cache (serving."
                "prefix_cache.enabled / --prefix-cache on): page shipping "
                "moves pool pages")
        # concurrent prefill exports coalesce: callers enqueue, one leader
        # drains the queue under one service-lock acquisition
        self._export_mu = threading.Lock()        # guards the queue
        self._export_leader = threading.Lock()    # one drainer at a time
        self._export_q: list = []
        # request tracing and the SLO watcher (None: nothing recorded)
        self._tracer = tracer
        self._slo = slo
        # fixed-bucket latency histograms: TTFT and TPOT fill on the
        # continuous engine (which observes first tokens), e2e everywhere
        self.hist = {"ttft_seconds": LatencyHistogram(),
                     "tpot_seconds": LatencyHistogram(),
                     "e2e_seconds": LatencyHistogram()}
        # serve-path fingerprint -> served requests (for /metrics)
        self._path_counts: dict = {}
        self._path_lock = threading.Lock()
        # the DP degree of the facade this engine serves in (engine/dp.py)
        self.dp_degree = 1
        # subclasses replace this with their scheduler's counters
        self.stats = {}

    # ---- tracing, SLOs and serve-path provenance ----------------------------

    def _observe_request(self, request_id, t0: float, resp: dict,
                         ttft_s=None) -> None:
        """One completed request's latency bookkeeping on the schedulers
        without an engine-side observation point (plain and static; the
        continuous engine observes in ``_complete``): the e2e histogram,
        the SLO check and the tracer's ``complete`` event."""
        e2e = time.monotonic() - t0
        self.hist["e2e_seconds"].observe(e2e)
        tokens = len(resp.get("ids") or ())
        if self._tracer is not None and request_id:
            self._tracer.event(request_id, "complete", e2e_s=round(e2e, 6),
                               tokens=tokens,
                               stop_reason=resp.get("stop_reason"))
        if self._slo is not None and request_id:
            self._slo.observe(request_id, ttft_s=ttft_s, e2e_s=e2e,
                              tokens=tokens)

    def _base_path(self, speculative: int = 0) -> dict:
        """The request-independent half of a serve-path fingerprint: KV
        layout, TP / DP geometry and speculative intent. Engines add the
        admit mode and the pool events the request consumed."""
        pf = self._prefix
        kvq = str(getattr(pf, "kv_quant", "")
                  or getattr(self.model, "kv_quant", "") or "")
        window = int(getattr(pf, "window", 0)
                     or getattr(self.model, "window", 0) or 0)
        return {"mode": "cold", "tp": self.tp, "dp": self.dp_degree,
                "int8": kvq == "int8", "ring": window > 0,
                "spec": int(speculative) > 0}

    def _finalize_path(self, resp: dict, path: dict,
                       request_id=None) -> str:
        """Render ``path`` to its fingerprint and attach it where a
        completed request is observable: the response (``serve_path``;
        ``serve.py`` echoes it as ``X-Serve-Path``), the per-fingerprint
        counts and the request's trace."""
        fp = path_fingerprint(path)
        resp["serve_path"] = fp
        with self._path_lock:
            self._path_counts[fp] = self._path_counts.get(fp, 0) + 1
        if self._tracer is not None and request_id:
            self._tracer.event(request_id, "serve_path", fingerprint=fp)
        return fp

    def path_counts_snapshot(self) -> dict:
        """fingerprint -> served requests (for /metrics)."""
        with self._path_lock:
            return dict(self._path_counts)

    def slo_stats(self) -> dict:
        """The SLO breach counters for /metrics (zeros without a
        watcher)."""
        if self._slo is None:
            return {"slo_breach_total": 0, "slo_ttft_breach_total": 0,
                    "slo_e2e_breach_total": 0, "slo_dumps_written": 0}
        return self._slo.stats()

    def prefix_cache_stats(self):
        """Prefix-cache counters + pool occupancy for /metrics, or None
        when no pool is attached."""
        return (self._prefix.stats_snapshot()
                if self._prefix is not None else None)

    def tp_stats(self) -> dict:
        """The TP degree and the collectives of one one-token decode step
        (``parallel.tp.decode_step_collectives``), counted once on the
        ranks and kept; zeros at tp 1."""
        with self._tp_lock:
            if self._tp_stats is None:
                self._tp_stats = decode_step_collectives(self.model)
            return self._tp_stats

    def close(self) -> None:
        """Stop the ranks of a tensor-parallel model this service loaded."""
        close = getattr(self.model, "close", None)
        if self._owns_model and close is not None:
            close()

    def encode_prompt(self, prompt=None, prompt_ids=None) -> list:
        """Text or explicit ids -> validated id list (raises ValueError
        with a caller-presentable message on every bad input)."""
        if prompt_ids is not None:
            try:
                if isinstance(prompt_ids, (str, bytes)):
                    raise ValueError("got a string, not a list")
                ids = []
                for i in prompt_ids:
                    # bool is an int subclass and 1.9 would truncate:
                    # reject, don't coerce
                    if isinstance(i, bool) or int(i) != i:
                        raise ValueError(f"non-integer id {i!r}")
                    ids.append(int(i))
            except (TypeError, ValueError, OverflowError) as e:
                raise ValueError(
                    f"prompt_ids must be a flat list of ints: {e}") from e
            if self.vocab and any(i >= self.vocab or i < 0 for i in ids):
                raise ValueError(
                    f"prompt id outside [0, {self.vocab}) — the embedding "
                    "lookup would fail or read the wrong row")
        elif prompt is None:
            raise ValueError("pass a prompt or prompt ids")
        elif self.vocab <= 256:
            ids = list(str(prompt).encode("utf-8"))
            if any(i >= self.vocab for i in ids):
                raise ValueError(f"prompt byte >= vocab_size {self.vocab}")
        else:
            if self.tokenizer is None:
                raise ValueError(
                    f"vocab_size {self.vocab} > 256 and no BpeLMLoader "
                    "tokenizer found in the run config: pass prompt ids, "
                    "or train through BpeLMLoader for text round-tripping")
            ids = [int(i) for i in self.tokenizer.encode(str(prompt))]
            if any(i >= self.vocab for i in ids):
                raise ValueError(
                    f"tokenizer id >= model vocab_size {self.vocab} — "
                    "the checkpoint and tokenizer disagree")
        if not ids:
            raise ValueError("empty prompt (need at least one token)")
        return ids

    def encode_stop(self, stop) -> list:
        """Wire-level ``stop`` -> validated stop-token id list. Strings
        must encode to exactly one token; returns [] for None."""
        if stop is None:
            return []
        items = stop if isinstance(stop, (list, tuple)) else [stop]
        ids = []
        for s in items:
            if isinstance(s, (bool, float)):
                raise ValueError(f"stop entries are ids or strings, "
                                 f"got {s!r}")
            if isinstance(s, int):
                ids.append(int(s))
            elif isinstance(s, str):
                toks = self.encode_prompt(prompt=s)
                if len(toks) != 1:
                    raise ValueError(
                        f"stop string {s!r} encodes to {len(toks)} "
                        "tokens; only single-token stops are supported "
                        "(pass stop ids for multi-token sequences)")
                ids.append(int(toks[0]))
            else:
                raise ValueError(f"bad stop entry {s!r}")
        if self.vocab and any(i >= self.vocab or i < 0 for i in ids):
            raise ValueError(f"stop id outside [0, {self.vocab})")
        return ids

    # ---- roles and page shipping -------------------------------------------

    def _check_role(self, max_new: int) -> None:
        """The role gate: a prefill-role replica refuses decode-scale
        budgets (decode and colocated replicas serve everything; a decode
        replica prefills a miss cold)."""
        if self.role == "prefill" and int(max_new) > self.PREFILL_MAX_NEW:
            raise ValueError(
                f"prefill-role replica serves max_new_tokens <= "
                f"{self.PREFILL_MAX_NEW} (got {int(max_new)}): decode work "
                "belongs on a decode-role replica (POST /prefill ships this "
                "prompt's KV pages instead)")

    def _shipping_pool(self, what: str):
        if self._prefix is None:
            raise ValueError(f"{what} needs a prefix cache "
                             "(serving.prefix_cache.enabled)")
        return self._prefix

    def prefill_export(self, prompt=None, prompt_ids=None, request_id=None,
                       deadline=None) -> dict:
        """The prefill role's entry: compute the prompt's KV into this
        replica's pool (the paged batch-1 prefill, or the scatter arm) and
        export its full-block chain as a ship payload
        (:func:`engine.kvcache.serialize_pages` makes the wire bytes). Only
        pages and token ids ship: the decode replica's warm admit
        recomputes the suffix (the final prompt token included), so its
        output equals a colocated warm run's. A prompt shorter than one
        block gives ``n_blocks == 0``.

        Concurrent calls coalesce: each enqueues its chain, and the first
        thread to take the leader lock drains the whole queue under one
        service-lock acquisition (``prefill_export_batches`` and
        ``prefill_export_max_batch`` count it). A spent ``deadline`` raises
        :class:`DeadlineExceeded` before any work; with a tracer the call
        is the request's ``prefill_export`` span."""
        t0 = time.monotonic()
        if deadline is not None and deadline.expired(t0):
            raise DeadlineExceeded("deadline expired before prefill")
        pf = self._shipping_pool("prefill_export")
        ids = self.encode_prompt(prompt, prompt_ids)
        if len(ids) // pf.block == 0:
            return empty_payload(pf)
        item = {"ids": ids, "evt": threading.Event(), "result": None,
                "error": None}
        with self._export_mu:
            self._export_q.append(item)
        while not item["evt"].is_set():
            if self._export_leader.acquire(blocking=False):
                try:
                    self._drain_export_queue()
                finally:
                    self._export_leader.release()
            else:
                # a leader drains until the queue is empty: it takes this
                # item, or this thread leads on a later spin
                item["evt"].wait(0.002)
        if item["error"] is not None:
            raise item["error"]
        with self._export_mu:
            self.stats["prefill_exports"] = self.stats.get(
                "prefill_exports", 0) + 1
        payload = item["result"] or empty_payload(pf)
        if self._tracer is not None and request_id:
            self._tracer.add(request_id, "prefill_export", t0,
                             time.monotonic(), blocks=payload["n_blocks"])
        return payload

    def _drain_export_queue(self) -> None:
        """The export leader's loop: take every queued chain and compute
        and export the batch under one service-lock acquisition, until the
        queue stays empty. One chain's failure is its own."""
        while True:
            with self._export_mu:
                batch, self._export_q = self._export_q, []
            if not batch:
                return
            with self._lock:
                for it in batch:
                    try:
                        it["result"] = self._export_chain_locked(it["ids"])
                    except Exception as e:  # noqa: BLE001 — per chain
                        it["error"] = e
            self.stats["prefill_export_batches"] = self.stats.get(
                "prefill_export_batches", 0) + 1
            self.stats["prefill_export_max_batch"] = max(
                self.stats.get("prefill_export_max_batch", 0), len(batch))
            for it in batch:
                it["evt"].set()

    @torch.no_grad()
    def _export_chain_locked(self, ids):
        """Compute what is missing of one chain and export it (the leader
        holds the service lock): spilled blocks promote first; the paged
        arm prefills into a 1-token plan finished at once, so the prompt's
        blocks adopt in place; the scatter arm captures them."""
        pf = self._prefix
        if pf.spill is not None:
            pf.promote_spilled(ids)
        if pf.cached_block_count(ids) < len(ids) // pf.block:
            done = False
            if pf.paged:
                res = pf.paged_prefill(ids, 1)
                if res is not None:
                    pf.paged_finish(res[2], [], 0)
                    done = True
            if not done and not pf.window:
                # a dry ring pool exports whatever chain is resident
                pf.warm_prefill(ids, len(ids) + 1)
        return pf.export_pages(ids)

    def export_cached_pages(self, prompt=None, prompt_ids=None) -> dict:
        """Export-only: ship the full-block chain this replica holds for
        the prompt (resident pages, plus spilled ones promoted and
        checksum-verified on the way out) without computing anything
        missing; a replica holding nothing answers ``n_blocks == 0``. Any
        role with a pool serves it."""
        pf = self._shipping_pool("export_cached_pages")
        ids = self.encode_prompt(prompt, prompt_ids)
        with self._lock:
            if pf.spill is not None:
                pf.promote_spilled(ids)
            payload = pf.export_pages(ids)
            self.stats["peer_exports"] = self.stats.get("peer_exports",
                                                        0) + 1
        return payload if payload is not None else empty_payload(pf)

    def import_remote_pages(self, payload, origin: str = "ship") -> dict:
        """The decode role's entry: land a shipped chain (a payload, or its
        serialized bytes) in this replica's pool, so the prompt's next
        request admits warm. ``origin`` tags the adopted radix nodes:
        ``ship`` (the prefill -> decode handoff) or ``pull`` (a peer pull;
        the ``peer_pull_timeout`` fault fires here, and the pull then
        degrades to a dropped import: the request prefills cold). Runs
        under the service lock, between scheduler ticks."""
        pf = self._shipping_pool("import_remote_pages")
        if isinstance(payload, (bytes, bytearray, memoryview)):
            payload = deserialize_pages(bytes(payload))
        if origin == "pull":
            spec = faults.on_peer_pull()
            if spec is not None:
                time.sleep(spec.duration_s)
                with self._lock:
                    self.stats["peer_pull_timeouts"] = self.stats.get(
                        "peer_pull_timeouts", 0) + 1
                return {"imported_blocks": 0, "cached_tokens": 0,
                        "bytes": 0, "dropped": True}
        with self._lock:
            receipt = pf.import_pages(payload, origin=origin)
            self.stats["remote_admits"] = self.stats.get("remote_admits",
                                                         0) + 1
        return receipt

    def validate_request(self, req: dict) -> None:
        """Host-side validation of a wire request body (what serve.py
        reads off the socket): raises the ``ValueError`` the matching
        ``generate()`` call would, without touching the device, so a bad
        streaming request gets a 400 before the 200 of the event
        stream."""
        ids = self.encode_prompt(req.get("prompt"), req.get("prompt_ids"))
        stops = self.encode_stop(req.get("stop"))
        max_new = int(req.get("max_new_tokens", 64))
        float(req.get("temperature", 0.0))
        int(req.get("top_k", 0))
        float(req.get("top_p", 0.0))
        int(req.get("seed", 0))
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self._check_role(max_new)
        self._validate_budget(ids, max_new, stops)

    def _validate_budget(self, ids, max_new: int, stops) -> None:
        """Budget check at enqueue (schedulers refine it): prompt +
        budget within ``max_len``."""
        max_len = int(getattr(self.model, "max_len", 0) or 0)
        if max_len and len(ids) + max_new > max_len:
            raise ValueError(
                f"prompt ({len(ids)} tokens) + max_new_tokens "
                f"({max_new}) exceeds model.max_len {max_len}")

    def decode_text(self, ids):
        """Generated ids -> text, when the model has a text form (byte
        vocab or a recovered tokenizer); else None."""
        ids = [int(t) for t in ids]
        if self.vocab and self.vocab <= 256:
            return bytes(ids).decode("utf-8", errors="replace")
        if self.tokenizer is not None:
            return self.tokenizer.decode(ids, errors="replace")
        return None

    def generate(self, prompt=None, prompt_ids=None,
                 max_new_tokens: int = 64, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0, seed: int = 0,
                 speculative: int = 0, stop=None, request_id=None,
                 deadline=None) -> dict:
        """One validated request -> ``{"ids", "text"?, "stop_reason",
        "serve_path"}``.

        ``stop``: stop ids and/or single-token strings; the stop token is
        left out of the response and reported as ``stop_reason: "stop"``.
        ``seed`` seeds the request's own generator, so the same request
        samples the same tokens. ``speculative`` > 0: the draft length of a
        speculative request (module docstring); the response adds its
        ``speculative`` stats. ``request_id`` keys the request's spans and
        SLO observation; ``deadline`` (a ``reqtrace.Deadline``) is checked
        at entry and after the lock wait (:class:`DeadlineExceeded`); a
        generation already running runs out."""
        t_req = time.monotonic()
        if deadline is not None and deadline.expired(t_req):
            raise DeadlineExceeded("deadline expired before dispatch")
        self._check_role(max_new_tokens)
        ids = self.encode_prompt(prompt, prompt_ids)
        stops = self.encode_stop(stop)
        max_new = int(max_new_tokens)
        self._validate_budget(ids, max_new, stops)
        path = self._base_path(speculative)
        if int(speculative) > 0 and self.tp > 1:
            raise NotImplementedError(
                "speculative decoding under tensor parallelism is ROADMAP "
                "A4's remainder, a later slice")
        arr = torch.tensor([ids], dtype=torch.long, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        emitted = None
        with self._lock:
            if deadline is not None and deadline.expired():
                # the lock wait ate the budget: shed before computing
                raise DeadlineExceeded(
                    "deadline expired waiting for the device")
            if int(speculative) > 0:
                new_ids, stats = self._adaptive_speculative(
                    ids, max_new, int(speculative), float(temperature),
                    int(top_k), float(top_p), int(seed), stops)
                resp = self._response(new_ids, stops=stops,
                                      emitted=len(new_ids))
                resp["speculative"] = stats
                if self._tracer is not None and request_id:
                    self._tracer.event(
                        request_id, "spec",
                        tokens_per_call=stats.get("tokens_per_call"),
                        model_calls=stats.get("model_calls"),
                        disabled=stats.get("speculation_disabled"))
                if self._prefix is not None and stats.get(
                        "prefix_hit_tokens"):
                    # warm-prefilled through the pool's scatter arm
                    path["mode"] = "warm"
                    path.update(self._prefix.last_warm_flags)
                return self._finish_request(resp, path, request_id, t_req)
            if self._prefix is not None and not stops and max_new >= 1:
                # the pool: prefill only the uncached suffix (paged: decode
                # reading the pool in place; else the scatter arm). None =
                # the pool cannot serve this request: the cold path below
                # serves it, counted as a pool fallback
                new_ids = self._generate_prefix_cached(
                    ids, max_new, float(temperature), int(top_k),
                    float(top_p), gen)
                if new_ids is not None:
                    path.update(self._last_path_info)
                    return self._finish_request(
                        self._response(new_ids, stops=stops), path,
                        request_id, t_req)
            if stops:
                out, lengths = generate(
                    self.model, arr, max_new_tokens=int(max_new_tokens),
                    temperature=float(temperature), top_k=int(top_k),
                    top_p=float(top_p), generators=[gen],
                    stop_tokens=stops, return_lengths=True)
                emitted = int(lengths[0])
            else:
                out = generate(
                    self.model, arr, max_new_tokens=int(max_new_tokens),
                    temperature=float(temperature), top_k=int(top_k),
                    top_p=float(top_p), generators=[gen])
        return self._finish_request(
            self._response(out[0, len(ids):].tolist(), stops=stops,
                           emitted=emitted), path, request_id, t_req)

    def _finish_request(self, resp: dict, path: dict, request_id,
                        t_req: float) -> dict:
        self._finalize_path(resp, path, request_id)
        self._observe_request(request_id, t_req, resp)
        return resp

    @torch.no_grad()
    def _generate_prefix_cached(self, ids, max_new: int, temperature: float,
                                top_k: int, top_p: float, gen):
        """Batch-1 decode through the prefix pool (the JAX
        ``_generate_prefix_cached``), two arms:

        - paged (the pool is paged and has pages): the cached prefix is a
          block-table entry (zero admit copy), the suffix prefills into
          private pages, each step feeds one token at its row-local
          position and reads the pool in place, and the finished request's
          pages adopt into the radix index;
        - scatter (a pool that is not paged, or a dry paged pool):
          ``PrefixCache.warm_prefill`` copies the cached blocks into a
          contiguous cache, prefills the suffix and captures the prompt's
          blocks; the normal decode steps follow.

        Same sampling ops and generator as the cold path, so output
        matches it token for token (float-tolerance exact). Returns the
        new ids, or None when the pool cannot serve the request (a ring
        layout's dry pool; a non-paged pool under tensor parallelism).
        Caller holds the lock. ``_last_path_info`` gets the arm that served
        the request and the pool events it consumed (its serve path)."""
        pf = self._prefix
        self._last_path_info = {"mode": "cold"}
        res = pf.paged_prefill(ids, max_new) if pf.paged else None
        if res is None:
            pf.count_batch1(paged=False)
            pf.count_fallback("dry_pool" if pf.paged else "")
            if pf.window or self.tp > 1:
                return None
            # a dry paged pool's fall-through counted its lookup already
            last, cache, hit = pf.warm_prefill(ids, len(ids) + max_new,
                                               record=not pf.paged)
            if hit:
                self._last_path_info = {"mode": "warm",
                                        **pf.last_warm_flags}
            gens = [gen]
            token = sample_logits(last, temperature, top_k, top_p, gens)
            out = [token]
            for _ in range(1, max_new):
                token = _decode_step(self.model, cache, token, temperature,
                                     top_k, top_p, gens)
                out.append(token)
            return torch.cat(out).tolist()
        return self._paged_decode(ids, max_new, temperature, top_k, top_p,
                                  gen, res)

    def _paged_decode(self, ids, max_new: int, temperature: float,
                      top_k: int, top_p: float, gen, res):
        """The paged arm's decode steps over a ``paged_prefill`` result."""
        from .kvcache import paged_forward

        pf = self._prefix
        last, tables, plan = res
        gens = [gen]
        token = sample_logits(last, temperature, top_k, top_p, gens)
        out = [token]
        try:
            for i in range(1, max_new):
                last = paged_forward(self.model, pf.pool, token,
                                     tables, len(ids) + i - 1)
                token = sample_logits(last, temperature, top_k, top_p, gens)
                out.append(token)
            row = torch.cat(out).tolist()
        except Exception:
            pf.paged_finish(plan, [], 0)
            raise
        pf.paged_finish(plan, row, max_new)
        pf.count_batch1(paged=True)
        self._last_path_info = {"mode": "paged",
                                "wrap": bool(plan.get("ring_wrap")),
                                **page_origin_flags(plan["nodes"])}
        return row

    # ---- speculative requests ---------------------------------------------

    # The JAX service's acceptance probe: speculate over the first
    # SPEC_PROBE tokens, then keep speculating only while the probe's
    # tokens per verify call reach the bar (a verify call costs about one
    # plain step at batch 1, decode being bound by the weight reads)
    SPEC_PROBE = 32
    SPEC_MIN_TOKENS_PER_CALL = 1.25

    def _spec_pad_to(self, t0: int, budget: int, draft: int):
        """The JAX length bucket of a speculative prompt on pad-capable
        models (16, 32, ..., capped by what ``max_len`` leaves for the
        budget and the draft slack), or None."""
        if not self._pad_ok:
            return None
        bucket = 16
        while bucket < t0:
            bucket *= 2
        limit = int(self.model.max_len) - budget - 2 * (draft + 1)
        pad_to = min(bucket, limit)
        return pad_to if pad_to > t0 else None

    def _spec_generate(self, ids, budget: int, draft: int,
                       temperature: float, top_k: int, top_p: float, gen,
                       stops):
        """One speculative phase: through the pool's scatter arm on a
        prefix hit (target and early-exit draft skip the shared prefix's
        prefill), else ``generate_speculative`` on a fresh cache.
        Returns ``(out [1, T0 + budget], stats)``."""
        t0 = len(ids)
        dl, prefix = self._spec_draft_layers, self._prefix
        total = t0 + int(budget) + 2 * (int(draft) + 1)
        if (prefix is not None and total <= int(self.model.max_len)
                and not prefix.window):
            probe, _, c = prefix.lookup(ids, record=False)
            prefix.release(probe)
            if c:
                last, cache, hit = prefix.warm_prefill(ids, total)
                out, stats = speculative_from_cache(
                    self.model, ids, cache, last, total, budget,
                    draft_len=draft, temperature=temperature, top_k=top_k,
                    top_p=top_p, generator=gen, stop_tokens=stops or None,
                    draft_layers=dl)
                stats["prefix_hit_tokens"] = hit
                return out, stats
        arr = torch.tensor([ids], dtype=torch.long, device=self.device)
        return generate_speculative(
            self.model, arr, budget, draft_len=draft, return_stats=True,
            temperature=temperature, top_k=top_k, top_p=top_p,
            generator=gen, pad_to=self._spec_pad_to(t0, budget, draft),
            stop_tokens=stops or None, draft_layers=dl)

    def _adaptive_speculative(self, ids, max_new: int, draft: int,
                              temperature: float, top_k: int, top_p: float,
                              seed: int, stops):
        """Speculative decoding with the acceptance probe (the JAX
        ``_adaptive_speculative``): returns ``(emitted ids, stats)``, the
        stop token included when one fired. Greedy output equals plain
        greedy either way; sampled output stays distribution-exact (one
        generator, seeded ``seed``, runs through both phases)."""
        t0 = len(ids)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        probe = min(self.SPEC_PROBE, max_new)
        out, stats = self._spec_generate(ids, probe, draft, temperature,
                                         top_k, top_p, gen, stops)
        emitted = stats["tokens_emitted"]
        new = [int(t) for t in out[0, t0:t0 + emitted].tolist()]
        stats = dict(stats, probe_tokens_per_call=stats["tokens_per_call"],
                     speculation_disabled=False)
        rest = max_new - probe
        if stops and new and new[-1] in stops:
            stats["stopped"] = True
        if stats["stopped"] or rest <= 0:
            return new, stats
        ids2 = list(ids) + new
        if stats["probe_tokens_per_call"] >= self.SPEC_MIN_TOKENS_PER_CALL:
            out2, s2 = self._spec_generate(ids2, rest, draft, temperature,
                                           top_k, top_p, gen, stops)
            em2 = s2["tokens_emitted"]
            calls = stats["model_calls"] + s2["model_calls"]
            stopped = s2["stopped"]
        else:
            # under the bar: plain decode, one model call per token
            arr2 = torch.tensor([ids2], dtype=torch.long,
                                device=self.device)
            if stops:
                out2, lengths = generate(
                    self.model, arr2, rest, temperature=temperature,
                    top_k=top_k, top_p=top_p, generators=[gen],
                    stop_tokens=stops, return_lengths=True)
                em2 = int(lengths[0])
            else:
                out2 = generate(self.model, arr2, rest,
                                temperature=temperature, top_k=top_k,
                                top_p=top_p, generators=[gen])
                em2 = rest
            calls = stats["model_calls"] + em2
            stopped = bool(stops) and em2 < rest
            stats["speculation_disabled"] = True
        t1 = len(ids2)
        new += [int(t) for t in out2[0, t1:t1 + em2].tolist()]
        if stops and new and new[-1] in stops:
            stopped = True
        stats.update(model_calls=calls, tokens_emitted=emitted + em2,
                     stopped=stopped,
                     tokens_per_call=round((emitted + em2)
                                           / max(calls, 1), 3))
        return new, stats

    def _response(self, new_ids, stops=(), emitted=None) -> dict:
        """Generated row -> wire response. ``emitted`` = tokens the model
        produced (stop token included, frozen tail excluded)."""
        ids = [int(t) for t in new_ids]
        reason = "length"
        if emitted is not None:
            ids = ids[:emitted]
        if stops and ids and ids[-1] in stops:
            ids = ids[:-1]
            reason = "stop"
        resp: dict = {"ids": ids, "stop_reason": reason}
        text = self.decode_text(ids)
        if text is not None:
            resp["text"] = text
        return resp


_STOP = object()           # batcher shutdown sentinel


class BatchedGenerationService(GenerationService):
    """``GenerationService`` with the static micro-batch scheduler (the JAX
    ``BatchedGenerationService``; module docstring). ``stats``: requests,
    batches, requests that shared a batch, the largest batch."""

    PAD_BUCKET = 128

    def _setup(self, model, tokenizer=None, max_batch: int = 8,
               window_ms: float = 25.0, prefix_cache=None,
               spec_draft_layers: int = 0, tracer=None, slo=None):
        super()._setup(model, tokenizer, prefix_cache=prefix_cache,
                       spec_draft_layers=spec_draft_layers, tracer=tracer,
                       slo=slo)
        self._max_batch = int(max_batch)
        self._window_s = float(window_ms) / 1e3
        self._queue: "queue_mod.Queue" = queue_mod.Queue()
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0,
                      "max_batch_size": 0, "tokens_generated": 0}
        self._worker_thread = threading.Thread(
            target=self._worker, daemon=True, name="gen-batcher")
        self._worker_thread.start()

    def close(self, timeout: float = 60.0) -> None:
        """Stop the worker (requests queued behind the sentinel are never
        served), then the parent's close."""
        self._queue.put(_STOP)
        self._worker_thread.join(timeout)
        super().close()

    def generate(self, prompt=None, prompt_ids=None,
                 max_new_tokens: int = 64, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0, seed: int = 0,
                 speculative: int = 0, stop=None, request_id=None,
                 deadline=None) -> dict:
        if int(speculative) > 0:
            # batch 1 by construction: under the parent's lock
            return super().generate(
                prompt=prompt, prompt_ids=prompt_ids,
                max_new_tokens=max_new_tokens, temperature=temperature,
                top_k=top_k, top_p=top_p, seed=seed,
                speculative=speculative, stop=stop, request_id=request_id,
                deadline=deadline)
        t_req = time.monotonic()
        if deadline is not None and deadline.expired(t_req):
            raise DeadlineExceeded("deadline expired before dispatch")
        # validated and keyed in the caller's thread: a bad request fails
        # here and never reaches the worker
        ids = self.encode_prompt(prompt, prompt_ids)
        stops = self.encode_stop(stop)
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self._validate_budget(ids, int(max_new_tokens), stops)
        req = {"ids": ids, "max_new_tokens": int(max_new_tokens),
               "temperature": float(temperature), "top_k": int(top_k),
               "top_p": float(top_p), "seed": int(seed), "stop": stops,
               "deadline": deadline, "event": threading.Event()}
        req["key"] = self._group_key(req)
        self._queue.put(req)
        req["event"].wait()
        if "error" in req:
            raise req["error"]
        self._finalize_path(req["result"], req["path"], request_id)
        self._observe_request(request_id, t_req, req["result"])
        return req["result"]

    def _group_key(self, req) -> tuple:
        """Exact prompt length (absolute positions) or, pad-capable, its
        128-token bucket; then the budget and the sampling triple."""
        n = len(req["ids"])
        length_key = -(-n // self.PAD_BUCKET) if self._pad_ok else n
        return (length_key, req["max_new_tokens"], req["temperature"],
                req["top_k"], req["top_p"])

    def _worker(self) -> None:
        stash: list = []
        while True:
            batch = []
            try:
                first = stash.pop(0) if stash else self._queue.get()
                if first is _STOP:
                    return
                batch.append(first)
                key = first["key"]
                rest = []
                for r in stash:
                    (batch if r is not _STOP and r["key"] == key
                     and len(batch) < self._max_batch else rest).append(r)
                stash = rest
                deadline = time.monotonic() + self._window_s
                while len(batch) < self._max_batch and _STOP not in stash:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    try:
                        nxt = self._queue.get(timeout=left)
                    except queue_mod.Empty:
                        break
                    (batch if nxt is not _STOP and nxt["key"] == key
                     else stash).append(nxt)
                self._run_batch(batch)
            except Exception as e:  # noqa: BLE001 — surfaced per request
                logger.exception("batch worker error (batch of %d)",
                                 len(batch))
                for r in batch:
                    r["error"] = e
                    r["event"].set()

    @torch.no_grad()
    def _run_batch(self, batch: list) -> None:
        """One group: a lone request without stops through the pool when
        one is attached, else one batched ``generate`` (left-padded to the
        JAX shape menu for pad-capable models). Members whose deadline
        expired in the batching window are shed first: a static group
        decodes to the longest member's budget."""
        live = []
        for r in batch:
            if r["deadline"] is not None and r["deadline"].expired():
                r["error"] = DeadlineExceeded(
                    "deadline expired in the batch queue")
                r["event"].set()
            else:
                live.append(r)
        if not live:
            return
        batch = live
        for r in batch:
            r["path"] = self._base_path()
        first = batch[0]
        budget = first["max_new_tokens"]
        samp = dict(temperature=first["temperature"], top_k=first["top_k"],
                    top_p=first["top_p"])
        lengths = None
        with self._lock:
            if (len(batch) == 1 and self._prefix is not None
                    and not first["stop"]):
                gen = torch.Generator(device=self.device).manual_seed(
                    first["seed"])
                row = self._generate_prefix_cached(
                    first["ids"], budget, samp["temperature"],
                    samp["top_k"], samp["top_p"], gen)
                if row is not None:
                    first["path"].update(self._last_path_info)
                    self._finish(batch, [row], None)
                    return
            t0 = max(len(r["ids"]) for r in batch)
            if self._pad_ok:
                # the JAX shape menu: powers of two within the bucket, never
                # past what max_len leaves for the budget
                shape = 16
                while shape < t0:
                    shape *= 2
                t0 = max(t0, min(shape, int(self.model.max_len) - budget))
            arr = torch.tensor([[0] * (t0 - len(r["ids"])) + list(r["ids"])
                                for r in batch], dtype=torch.long,
                               device=self.device)
            pads = [t0 - len(r["ids"]) for r in batch]
            gens = [torch.Generator(device=self.device).manual_seed(
                r["seed"]) for r in batch]
            kw = dict(samp, generators=gens,
                      pad_lens=pads if any(pads) else None)
            if any(r["stop"] for r in batch):
                out, lengths = generate(
                    self.model, arr, budget,
                    stop_tokens=[r["stop"] for r in batch],
                    return_lengths=True, **kw)
                lengths = lengths.tolist()
            else:
                out = generate(self.model, arr, budget, **kw)
        self._finish(batch, out[:, t0:].tolist(), lengths)

    def _finish(self, batch: list, rows: list, lengths) -> None:
        """Count the group and hand each request its response."""
        self.stats["requests"] += len(batch)
        self.stats["batches"] += 1
        if len(batch) > 1:
            self.stats["batched_requests"] += len(batch)
        self.stats["max_batch_size"] = max(self.stats["max_batch_size"],
                                           len(batch))
        for i, r in enumerate(batch):
            r["result"] = self._response(
                rows[i], stops=r["stop"],
                emitted=None if lengths is None else int(lengths[i]))
            self.stats["tokens_generated"] += len(r["result"]["ids"])
            r["event"].set()


def serving_arch(config) -> dict:
    """``{"type", "args"}`` of the model ``config`` serves: its arch, with
    ``serving.kv_quant`` switched on over it (a serving mode: the scales
    are cache leaves, not params, so a full-precision arch takes it)."""
    arch = {"type": config["arch"]["type"],
            "args": dict(config["arch"].get("args") or {})}
    kvq = str((config.get("serving") or {}).get("kv_quant") or "")
    if kvq:
        arch["args"]["kv_quant"] = kvq
    return arch


def check_served_model(model, config) -> None:
    """Refuse a loaded ``model`` handed in to serve ``config`` unless it
    is the model ``config`` would load: the same family and KV
    quantization, and the same parameter names, shapes and dtypes (depth,
    widths, weight quantization)."""
    arch = serving_arch(config)
    want = resolve(MODELS, arch["type"])(**arch["args"], device="meta")
    shapes = {k: (tuple(t.shape), t.dtype)
              for k, t in want.state_dict().items()}
    got = {k: (tuple(t.shape), t.dtype)
           for k, t in model.state_dict().items()}
    kvq = (str(getattr(want, "kv_quant", "") or ""),
           str(getattr(model, "kv_quant", "") or ""))
    if type(model) is not type(want) or kvq[0] != kvq[1] or got != shapes:
        raise ValueError(
            f"the model handed in is not the one the config serves "
            f"({arch['type']}, kv_quant {kvq[0]!r}): a "
            f"{type(model).__name__} with kv_quant {kvq[1]!r}"
            + ("" if got == shapes else " and other parameters"))


def load_generation_stack(config, device=None, use_ema: bool = False,
                          tensor_parallel: int = 0, group: int = 0):
    """``(model, tokenizer | None)`` for ``config.resume``: a params-only
    serving artifact (a w8a16 one builds the quant model from its
    config's ``arch.args.quant``), or a training checkpoint's ``model.pt``
    (``ema.pt`` over it with ``use_ema``; one card only). At tensor
    parallelism T = ``tensor_parallel`` (or
    ``serving.tensor_parallel``) > 1 the model is a
    ``parallel.serving_ranks.TensorParallelModel`` on cards ``[group T,
    (group + 1) T)`` (gloo ranks on the CPU), the recorded geometry and
    the manifest checked here first; else the weights load on ``device``
    (CUDA unless asked otherwise; card ``group`` of a DP group)."""
    if config.resume is None:
        raise ValueError("generation requires a serving artifact (-r)")
    device = resolve_device(device)
    serving = config.get("serving") or {}
    tp = int(tensor_parallel or 0) or int(serving.get("tensor_parallel")
                                          or 1)
    meta = load_serving_meta(config.resume)
    arch = serving_arch(config)
    if int(arch["args"].get("lora_rank", 0) or 0) > 0:
        raise NotImplementedError(
            "serving LoRA adapters unmerged is ROADMAP A4's remainder, a "
            "later slice: merge them first (tools/merge_lora.py)")
    if meta is None:
        if tp > 1 or not (config.resume / "model.pt").exists():
            raise ValueError(
                f"{config.resume} is not a params-only serving artifact"
                + ("" if tp <= 1 else " (tensor-parallel serving reads "
                   "artifacts only)")
                + "; make one with tools/make_serving_artifact.py or "
                "tools/quantize_checkpoint.py")
        dev = dp_group_devices(group, 1, device)[0] if group else device
        return (load_checkpoint_model(arch, config.resume, dev, use_ema),
                tokenizer_from_config(config))
    if use_ema:
        logger.warning("--ema ignored: %s is a params-only serving "
                       "artifact", config.resume)
    if tp > 1:
        from ..parallel.serving_ranks import TensorParallelModel

        # refuse before a byte of weights is read; the ranks skip the hash
        check_artifact_tp_geometry(config.resume, tp)
        verify_artifact_manifest(config.resume)
        model = TensorParallelModel(arch, config.resume, tp, device,
                                    first=int(group) * tp)
    else:
        model = load_serving_model(
            arch, config.resume,
            dp_group_devices(group, 1, device)[0] if group else device)
    return model, tokenizer_from_config(config)


def load_checkpoint_model(arch: dict, resume, device,
                          use_ema: bool = False):
    """The model of ``arch`` with a training checkpoint's weights
    (``<resume>/model.pt``, ``ema.pt``'s params over it with ``use_ema``)
    on ``device``: the JAX ``load_generation_stack``'s checkpoint arm."""
    from ..checkpoint.manager import EMA_FILE

    model = resolve(MODELS, arch["type"])(**dict(arch.get("args") or {}),
                                          device="meta")
    state = torch.load(resume / "model.pt", map_location="cpu",
                       weights_only=True)
    if use_ema and (resume / EMA_FILE).exists():
        state.update(torch.load(resume / EMA_FILE, map_location="cpu",
                                weights_only=True))
    elif use_ema:
        logger.warning("--ema ignored: %s holds no %s", resume, EMA_FILE)
    return _assign(model, state, arch["type"], resume, device)


def _assign(model, state: dict, what: str, resume, device):
    """Load ``state`` into the meta-built ``model`` on ``device`` in the
    model's dtypes; the names must match exactly."""
    want = {k: p.dtype for k, p in model.state_dict().items()}
    missing = sorted(set(want) - set(state))
    unexpected = sorted(set(state) - set(want))
    if missing or unexpected:
        raise ValueError(f"{resume} does not match {what}: missing "
                         f"{missing[:5]}, unexpected {unexpected[:5]}")
    model.load_state_dict(
        {k: t.to(device=device, dtype=want[k]) for k, t in state.items()},
        assign=True)
    return model.eval()


def load_serving_model(arch: dict, resume, device, mesh=None,
                       verify: bool = True):
    """The model of ``arch`` (``{"type", "args"}``) with the artifact's
    weights on ``device``. With a tensor ``mesh`` (a TP rank) it holds
    only this rank's Megatron slices: the artifact is read memory-mapped
    on the host and only the slices are copied to the device
    (``parallel.tp.shard_serving_params``)."""
    model = resolve(MODELS, arch["type"])(**dict(arch.get("args") or {}),
                                          device="meta")
    state = restore_serving_params(
        resume, "cpu" if mesh is not None else device, verify=verify)
    if mesh is not None and set(state) == set(model.state_dict()):
        state = shard_serving_params(model, state, mesh)
    return _assign(model, state, arch["type"], resume, device)
