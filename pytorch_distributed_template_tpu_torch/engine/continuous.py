"""Continuous (slot-based) batching over the paged KV pool: the paged arm
of the JAX package's ``engine/continuous.py``.

- ``slots`` rows decode together; requests ADMIT into free rows between
  decode chunks and leave as soon as they finish, so a short request never
  waits out a long one.
- There is no shared contiguous cache: the model's cache IS the KV block
  pool (engine/kvcache.py) and each slot owns a row of the ``[slots, NB]``
  block table. An admission reserves its pages up front (shared radix
  prefix + a private chain for the suffix and the whole budget), writes its
  table row (the whole "warm admit": a pointer update, zero device copy),
  and prefills only the uncached suffix into its private pages. Positions
  are row-local. A dry pool DEFERS the admission (FIFO) until completions
  free pages.
- Decode runs in chunks of ``chunk`` steps with per-row budgets, stop sets,
  sampling parameters and one ``torch.Generator`` per request (seeded with
  the request's seed, so a row samples what the same request samples
  served alone). Frozen rows feed ``pad_lens=1``, so their writes land in
  the scratch page and a finished row never dirties a page the index
  shares. Attention for every admission, prefill chunk and decode step
  runs through ``paged_attention`` (the B4 kernel on CUDA).
- Chunked streaming prefill: a prompt whose uncached suffix exceeds
  ``prefill_chunk_tokens`` (mandatory for window models, capped at the
  ring slack) streams one chunk per scheduler tick through the batch-1
  paged prefill, adopting its completed blocks as it goes, so decode rows
  keep stepping between chunks.
- One worker thread owns the device; request threads enqueue and wait.

PyTorch runs eagerly, so two pieces of the JAX engine that exist for XLA
compile reuse are left out: the warm-up ladders (``_warm_chunk_ladder``,
``_warm_admit_ladder``) and, for a dense model, power-of-two bucketing of
admission feeds and group widths (bucketing changes only pad lanes, never
valid outputs). A sparse model keeps them: its pad lanes and padding rows
claim expert capacity as the JAX engine's do, and the capacity follows the
call's token count, so a dropping capacity would route otherwise. A
cancelled row is frozen on the device at once (its done flag is set in
stream order), so its pages free at completion without the JAX engine's
deferred zombie cleanup.

Tensor parallelism: over a ``parallel.serving_ranks.TensorParallelModel``
the scheduler runs unchanged on the serving process's CPU, and every model
call (prefill chunks, admissions, decode steps) runs in lockstep on the
group's ranks, each over its KV-head slice of the pool; page ids, tables
and refcounts are the same for every rank, so warm admits stay pointer
updates. ``stats["tp_degree"]`` reports the degree; ``tp_stats()`` is
counted once at setup. DP groups are engine/dp.py.

A request with ``speculative > 0`` bypasses the slots (the JAX engine's
rule): it runs batch 1 through the parent service's speculative path
under the engine's lock, between two scheduler ticks, warm-prefilling
through the pool on a prefix hit.

Observability and overload, as the JAX engine does them:

- tracing (``tracer=``): per request ``queue_wait`` and ``admit`` spans
  at its admission, ``prefill_chunk`` per streamed chunk, ``tier`` for a
  promotion from a spill tier, events ``kv_evictions``, ``first_token``,
  ``decode_chunk``, ``kv_adopt``, ``serve_path`` and ``complete``. Every
  stamp is taken where the host already learns the tokens (the absorb's
  device read) or does host work anyway: tracing adds no synchronisation.
  TTFT / TPOT / e2e feed the ``hist`` histograms and the SLO watcher
  (``slo=``); ``tsdb=`` (a ``TimeSeriesStore``) gets one observation per
  absorbed chunk;
- deadlines (``generate(deadline=)``): a queued request whose deadline
  expires is dropped before it takes a slot, a decoding one finalizes at
  its next absorb with ``stop_reason: "deadline"`` (its row frozen at
  once, as a cancelled one's), both counted in ``deadline_expired``;
- the brownout ladder (``brownout=``, a ``serving.brownout`` dict or a
  ``BrownoutController``): pressure is the larger of the queue over
  ``slots x queue_norm``, the pool's referenced fraction and an EWMA of
  the SLO breach rate; level 1 strips speculation from requests, level 2
  caps chunk growth at the base chunk, level 3 clamps admitted budgets to
  ``max_new_cap``;
- the fault hook ``faults.on_serve_tick`` runs once per scheduler round
  (``slow_decode``, ``hang``, and ``pool_exhaust``'s dry-pool window, in
  which reservations, promotions and streamed chunks defer);
- each response carries its ``serve_path`` fingerprint (admit mode
  ``paged`` or ``stream``, the pool events behind its prefix, ``wrap``,
  the brownout level at admission).

Roles and the spill tiers: ``role="prefill"`` refuses budgets over one
token and serves ``prefill_export`` (the parent's, under the engine's
lock), ``role="decode"`` lands shipped pages (``import_remote_pages``,
between ticks) that the next admission of the prompt reads as radix hits,
B4 over them; ``stats`` count ``prefill_exports`` and ``remote_admits``.
With a spill tier, pending requests whose prefix was demoted promote at the
tick's start, before the tick reserves pages.

Left to later slices: the non-paged shared-cache engine (eras, the scatter
warm admit; ROADMAP A3a.1's other half) and the step anatomy. Without a
paged pool the constructor raises.
"""
from __future__ import annotations

import logging
import queue as queue_mod
import threading
import time

import numpy as np
import torch

from ..models.moe import MoeMlp
from ..resilience import faults
from ..utils.brownout import BrownoutController
from ..utils.promtext import percentile
from .generate import isin_stops, sample_rows
from .kvcache import page_origin_flags, paged_forward
from .serving import GenerationService

logger = logging.getLogger(__name__)

_SLICE_SHARED = ("the non-paged shared-cache continuous engine (scatter "
                 "warm admits, eras) is a later slice of the port "
                 "(ROADMAP A3a.1)")
_STOP = object()           # worker shutdown sentinel


class ContinuousBatchingService(GenerationService):
    """``GenerationService`` with the slot scheduler over the paged pool.
    Same wire API (prompt / budget / sampling / seed / stop per request);
    any mix of requests shares the engine. ``stats`` counts requests,
    admissions, chunks, model calls and streamed prefill."""

    MAX_STOPS = 8          # stop-set width per request
    GROW_MAX = 8           # adaptive chunk growth cap, x base chunk
    GROW_MAX_STOPS = 4     # growth cap while rows can exit mid-chunk
    STREAM_DELTAS = True   # generate(on_tokens=...) emits token deltas

    def _setup(self, model, tokenizer=None, slots: int = 8, chunk: int = 8,
               window_ms: float = 5.0, prefix_cache=None,
               prefill_chunk_tokens: int = 0, spec_draft_layers: int = 0,
               role: str = "both", tracer=None, slo=None, brownout=None,
               tsdb=None):
        super()._setup(model, tokenizer, prefix_cache=prefix_cache,
                       spec_draft_layers=spec_draft_layers, role=role,
                       tracer=tracer, slo=slo)
        if self._prefix is None or not self._prefix.paged:
            raise NotImplementedError(
                "the port's continuous engine runs over a paged KV pool "
                "(serving.prefix_cache with paged=true); "
                + _SLICE_SHARED)
        self._slots = int(slots)
        self._chunk = int(chunk)
        if self._slots < 1 or self._chunk < 1:
            raise ValueError("slots and chunk must be >= 1")
        self._tsdb = tsdb
        # the pool_exhaust fault window: until this monotonic instant the
        # pool reads dry (0: no window)
        self._pool_dry_until = 0.0
        self._init_brownout(brownout)
        chunk_tok = int(prefill_chunk_tokens or 0)
        if chunk_tok and (chunk_tok & (chunk_tok - 1)):
            raise ValueError(
                f"serving.prefill_chunk_tokens={chunk_tok} must be a power "
                "of two")
        if self._prefix.window > 0:
            cap = int(self._prefix.ring_slack_tokens)
            chunk_tok = min(chunk_tok or cap, cap)
        self._prefill_chunk = chunk_tok
        # a sparse model's expert capacity couples the rows of one call,
        # so its admissions take the JAX engine's shape (see _admit_group)
        self._jax_shaped_admits = any(
            isinstance(m, MoeMlp) for m in getattr(model, "modules",
                                                   lambda: ())())
        self._window_s = float(window_ms) / 1e3
        self._queue: "queue_mod.Queue" = queue_mod.Queue()
        self._latencies: list = []
        self._ttfts: list = []
        self.stats = {"requests": 0, "completed": 0, "chunks": 0,
                      "admissions": 0, "max_active": 0,
                      "tokens_generated": 0, "cancelled": 0,
                      "paged_chunks": 0, "paged_admissions": 0,
                      "deferred_admissions": 0, "model_calls": 0,
                      "prefill_chunks": 0, "streamed_prefill_tokens": 0,
                      "streamed_requests": 0, "admit_calls": 0,
                      "decode_calls": 0, "tp_degree": self.tp,
                      # page shipping: chains landed from prefill-role
                      # replicas, chains exported to decode-role ones
                      "remote_admits": 0, "prefill_exports": 0,
                      "deadline_expired": 0, "brownout_clamped": 0}
        # the per-step collective accounting runs a probe on the ranks:
        # once here, never on the scrape path
        self.tp_stats()
        self._worker_thread = threading.Thread(
            target=self._worker, daemon=True, name="gen-continuous")
        self._worker_thread.start()

    def close(self, timeout: float = 60.0) -> None:
        """Stop the worker thread (queued requests behind the sentinel
        are never served) and drop the device state (and the ranks of a
        tensor-parallel model the service loaded)."""
        self._queue.put(_STOP)
        self._worker_thread.join(timeout)
        if self._worker_thread.is_alive():
            raise RuntimeError("continuous scheduler did not stop")
        super().close()

    # ---- the brownout ladder -----------------------------------------------

    def _init_brownout(self, cfg) -> None:
        """Attach the hysteresis ladder (utils/brownout.py) from a
        ``serving.brownout`` dict (``{"enabled": true, ...}``) or a built
        controller. Off by default: level 3 clamps budgets, which an
        operator opts into."""
        self._brownout = None
        self._bo_queue_norm = 1.0
        self._bo_max_new = 0
        self._bo_breach_ewma = 0.0
        self._bo_last = (0, 0)          # (breaches, completed) marks
        self._bo_lock = threading.Lock()
        if isinstance(cfg, BrownoutController):
            self._brownout = cfg
            return
        cfg = dict(cfg or {})
        if not cfg.get("enabled"):
            return
        # a queue of slots x queue_norm reads as pressure 1.0
        self._bo_queue_norm = float(cfg.get("queue_norm", 1.0))
        # level 3's budget cap (0: four base chunks)
        self._bo_max_new = int(cfg.get("max_new_cap", 0)) or self._chunk * 4
        kw = {k: tuple(cfg[k]) for k in ("enter", "exit") if k in cfg}
        self._brownout = BrownoutController(
            dwell_s=float(cfg.get("dwell_s", 2.0)),
            on_change=self._on_brownout_change, **kw)

    @staticmethod
    def _on_brownout_change(old: int, new: int, pressure: float) -> None:
        logger.warning("brownout level %d -> %d (pressure %.2f)", old, new,
                       pressure)

    @property
    def brownout_level(self) -> int:
        return self._brownout.level if self._brownout is not None else 0

    def brownout_stats(self) -> dict:
        """The ladder's gauges for /metrics. Each read feeds the controller
        the current pressure (ticks run only under traffic, so an idle
        engine's level would freeze otherwise; the dwell still holds)."""
        if self._brownout is None:
            return {"brownout_level": 0}
        with self._bo_lock:
            self._brownout.update(self._brownout_pressure())
            return self._brownout.stats()

    def _brownout_pressure(self, waiting: int = 0) -> float:
        """Normalized pressure (1.0 ~ at capacity): the max of the waiting
        requests (queued plus the tick's unadmitted pending) over ``slots x
        queue_norm``, the pool's live-referenced page fraction, and an EWMA
        of the SLO breaches per completion."""
        p = (self._queue.qsize() + waiting) / max(
            self._slots * self._bo_queue_norm, 1e-9)
        snap = self._prefix.stats_snapshot()
        p = max(p, snap["prefix_pool_blocks_referenced"]
                / max(snap["prefix_pool_blocks"], 1))
        if self._slo is not None:
            breaches = self._slo.stats()["slo_breach_total"]
            completed = self.stats["completed"]
            db = breaches - self._bo_last[0]
            dc = completed - self._bo_last[1]
            if dc > 0:
                self._bo_breach_ewma += 0.3 * (min(db / dc, 1.0)
                                               - self._bo_breach_ewma)
                self._bo_last = (breaches, completed)
            p = max(p, self._bo_breach_ewma)
        return p

    def _pool_dry(self) -> bool:
        """The pool_exhaust fault window is open: reservations defer."""
        return (self._pool_dry_until > 0.0
                and time.monotonic() < self._pool_dry_until)

    # ---- request entry ---------------------------------------------------

    def generate(self, prompt=None, prompt_ids=None,
                 max_new_tokens: int = 64, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0, seed: int = 0,
                 speculative: int = 0, stop=None, on_tokens=None,
                 cancel=None, request_id=None, deadline=None) -> dict:
        """The parent's contract plus ``on_tokens`` (called on the
        scheduler thread with each absorbed batch of this request's new
        ids, stop ids filtered: the deltas concatenate to the response's
        ``ids``; must not block), ``cancel`` (a ``threading.Event``: once
        set, the request finalizes at its next chunk absorb with
        ``stop_reason: "cancelled"`` and its slot and pages free; a
        request still queued is dropped) and ``deadline`` (a
        ``reqtrace.Deadline``: a cancel the engine raises itself, with
        ``stop_reason: "deadline"``). At brownout level 1 or more a
        speculative request is served without speculation."""
        self._check_role(max_new_tokens)
        if int(speculative) > 0 and self.brownout_level >= 1:
            # level 1: the verify calls' extra work goes back to the batch
            speculative = 0
        if int(speculative) > 0:
            # batch 1 under the engine's lock, between ticks
            result = super().generate(
                prompt=prompt, prompt_ids=prompt_ids,
                max_new_tokens=max_new_tokens, temperature=temperature,
                top_k=top_k, top_p=top_p, seed=seed,
                speculative=speculative, stop=stop, request_id=request_id,
                deadline=deadline)
            if on_tokens is not None and result.get("ids"):
                on_tokens(list(result["ids"]))   # one final delta
            return result
        ids = self.encode_prompt(prompt, prompt_ids)
        stops = self.encode_stop(stop)
        max_new = int(max_new_tokens)
        self._validate_budget(ids, max_new, stops)
        req = {"ids": ids, "budget": max_new,
               "temperature": float(temperature), "top_k": int(top_k),
               "top_p": float(top_p), "seed": int(seed), "stop": stops,
               "on_tokens": on_tokens, "cancel": cancel, "rid": request_id,
               "deadline": deadline, "event": threading.Event(),
               "t0": time.monotonic()}
        self._queue.put(req)
        req["event"].wait()
        if "error" in req:
            raise req["error"]
        return req["result"]

    def _validate_budget(self, ids, max_new: int, stops) -> None:
        """Enqueue-time checks: stop-set width, ``max_new >= 1``, and the
        raw prompt + budget against ``max_len`` (paged admissions are
        position-free: no admission bucket to round up to)."""
        if len(stops) > self.MAX_STOPS:
            raise ValueError(f"at most {self.MAX_STOPS} stop tokens per "
                             f"request (got {len(stops)})")
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        super()._validate_budget(ids, max_new, stops)

    # ---- scheduler internals --------------------------------------------

    @classmethod
    def _grow_cap(cls, live) -> int:
        """Chunk-growth cap (x base chunk): full ``GROW_MAX`` only when no
        live row can exit a chunk early (stop tokens, cancel events,
        deadlines)."""
        return (min(cls.GROW_MAX_STOPS, cls.GROW_MAX)
                if any(m["req"]["stop"] or m["req"].get("cancel") is not None
                       or m["req"].get("deadline") is not None
                       for m in live)
                else cls.GROW_MAX)

    @staticmethod
    def _bucket(n: int) -> int:
        """Power-of-two length class; admissions group by it, so one
        dispatch's rows have suffixes of similar width."""
        b = 16
        while b < n:
            b *= 2
        return b

    def _reserve_pages(self, r):
        """Page reservation for one admission (``paged_plan``); ``None`` =
        dry pool, the caller defers. Only a request's first attempt
        counts toward the hit/lookup stats. In the pool_exhaust fault's
        window the pool reads dry (no lookup runs, so the first real
        attempt still records)."""
        r["_page_attempts"] = r.get("_page_attempts", 0) + 1
        if self._pool_dry():
            return None
        first = not r.get("_page_retry")
        r["_page_retry"] = True
        # spilled prefixes promoted at the tick's start (_tick)
        return self._prefix.paged_plan(r["ids"], r["budget"], record=first,
                                       promote=False)

    def _needs_streaming(self, r) -> bool:
        """True while a reserved request's remaining uncached suffix is
        wider than one prefill chunk."""
        plan = r.get("_pages")
        if plan is None or not self._prefill_chunk:
            return False
        return len(r["ids"]) - plan.get("done", plan["c"]) \
            > self._prefill_chunk

    def _stream_prefill_step(self, r) -> str:
        """One chunk of streaming prefill for a pending long request:
        ``"chunked"`` when a chunk ran, ``"deferred"`` on a dry pool (the
        caller stops walking pending: FIFO), ``"skip"`` when the request
        needs no streaming. The whole page plan reserves on first sight;
        each chunk feeds ``prefill_chunk`` prompt tokens into the plan's
        pages and adopts the completed full blocks (ref-pinned; they move
        from private to shared and stay in the row's table), so a
        same-prefix request arriving mid-prefill already hits them."""
        ids = r["ids"]
        chunk = self._prefill_chunk
        plan = r.get("_pages")
        if plan is None:
            if len(ids) <= chunk:
                return "skip"
            plan = self._reserve_pages(r)
            if plan is None:
                return "deferred"
            r["_pages"] = plan
            plan["done"] = plan["c"]
            if len(ids) - plan["c"] > chunk:
                self.stats["streamed_requests"] += 1
        done = plan.get("done", plan["c"])
        if len(ids) - done <= chunk:
            return "skip"
        pf = self._prefix
        t0 = time.monotonic()
        table = torch.from_numpy(pf.table_row(plan)[None]).to(self.device)
        try:
            paged_forward(self.model, pf.pool, ids[done:done + chunk], table,
                          done)
        except Exception:
            pf.drop_plan(r.pop("_pages"))
            raise
        self.stats["model_calls"] += 1
        plan["done"] = done + chunk
        self.stats["prefill_chunks"] += 1
        self.stats["streamed_prefill_tokens"] += chunk
        if not plan.get("ring_wrap"):
            adopted, anodes = pf.adopt(ids[:plan["done"]],
                                       dict(plan["private"]), acquire=True)
            if adopted:
                taken = set(adopted)
                shared = dict(plan.get("shared") or {})
                for idx in [i for i, b in plan["private"].items()
                            if b in taken]:
                    shared[idx] = plan["private"].pop(idx)
                plan["shared"] = shared
                # extend, never overwrite: each chunk's pins accumulate
                plan["adopt_nodes"] = list(plan["adopt_nodes"]) + anodes
        if self._tracer is not None and r.get("rid"):
            # the chunk was only enqueued: the span is its host dispatch
            self._tracer.add(r["rid"], "prefill_chunk", t0, time.monotonic(),
                             tokens=chunk, done=plan["done"], total=len(ids))
        return "chunked"

    def _init_state(self) -> None:
        """The device slot state: every slot done with budget 0 and an
        all -1 table row (writes land in the scratch page)."""
        S, W, dev = self._slots, self.MAX_STOPS, self.device
        self._tables = torch.full((S, self._prefix.nb_max), -1,
                                  dtype=torch.int32, device=dev)
        self._starts = torch.zeros((S,), dtype=torch.int32, device=dev)
        self._tok = torch.zeros((S,), dtype=torch.long, device=dev)
        self._emitted = torch.zeros((S,), dtype=torch.int32, device=dev)
        self._done = torch.ones((S,), dtype=torch.bool, device=dev)
        self._budgets = torch.zeros((S,), dtype=torch.int32, device=dev)
        self._stops = torch.full((S, W), -1, dtype=torch.long, device=dev)

    @torch.no_grad()
    def _admit_group(self, reqs: list, slots: list) -> None:
        """Admit reserved requests in ONE model call: write their table
        rows (the warm prefix is a pointer update), prefill only each
        row's unfed suffix (right-aligned, leading lanes padded), sample
        first tokens with each request's own generator, and adopt each
        prompt's full blocks into the radix index in place."""
        pf = self._prefix
        dev = self.device
        t_admit0 = time.monotonic()
        ev0 = (pf.counter("prefix_evictions")
               if self._tracer is not None else 0)
        n, W = len(reqs), self.MAX_STOPS
        plans = [r["_pages"] for r in reqs]
        # "done" covers the radix-cached prefix AND chunks a streamed
        # prefill already landed; the suffix is >= 1 (the final prompt
        # token is never served from cache)
        feed = max(len(r["ids"]) - p.get("done", p["c"])
                   for r, p in zip(reqs, plans))
        rows, extra = list(zip(reqs, plans)), {}
        if self._jax_shaped_admits:
            # every lane of the call claims expert capacity, and the
            # capacity is a function of the call's token count: feed the
            # JAX engine's shape, the suffix bucket wide and ``slots`` rows
            # (copies of the last request). A copy whose tokens are
            # dropped where the request's are not computes other K/V; the
            # JAX engine's scatter races the two on the request's pages,
            # here the copies write nothing
            feed = self._bucket(feed)
            rows += [rows[-1]] * (self._slots - n)
            extra["write_rows"] = n
        prompts = np.zeros((len(rows), feed), np.int64)
        pads = np.zeros((len(rows),), np.int32)
        starts = np.zeros((len(rows),), np.int32)
        stops = np.full((n, W), -1, np.int64)
        tables = np.stack([pf.table_row(p) for _, p in rows])
        for j, (r, p) in enumerate(rows):
            ids = r["ids"]
            c = p.get("done", p["c"])
            s = len(ids) - c
            prompts[j, feed - s:] = ids[c:]
            pads[j] = feed - s
            starts[j] = len(ids) - feed          # lane 0's position
            if j < n:
                stops[j, :len(r["stop"])] = r["stop"]
        idx = torch.tensor(slots, dtype=torch.long, device=dev)
        tables_k = torch.from_numpy(tables).to(dev)
        starts_k = torch.from_numpy(starts).to(dev)
        gens = [torch.Generator(device=dev).manual_seed(r["seed"])
                if r["temperature"] > 0 else None for r in reqs]
        try:
            logits = self.model(
                torch.from_numpy(prompts).to(dev), cache=pf.pool,
                prefill=True, block_tables=tables_k, row_starts=starts_k,
                pad_lens=torch.from_numpy(pads).to(dev), **extra)[:n, -1]
            self.stats["model_calls"] += 1
            self.stats["admit_calls"] += 1
            tok0 = sample_rows(logits, [r["temperature"] for r in reqs],
                               [r["top_k"] for r in reqs],
                               [r["top_p"] for r in reqs], gens)
        except Exception:
            for r in reqs:
                pf.drop_plan(r.pop("_pages"))
            raise
        self._tables[idx] = tables_k[:n]
        self._starts[idx] = starts_k[:n] + feed
        self._tok[idx] = tok0
        self._emitted[idx] = 1
        self._done[idx] = False
        self._budgets[idx] = torch.tensor([r["budget"] for r in reqs],
                                          dtype=torch.int32, device=dev)
        self._stops[idx] = torch.from_numpy(stops).to(dev)
        for j, (r, slot) in enumerate(zip(reqs, slots)):
            plan = r.pop("_pages")
            # zero-copy insert of the prompt's own full blocks, ref-pinned
            # (this slot keeps reading them); never for a ring_wrap plan,
            # whose decode recycles these very slots
            if not plan.get("ring_wrap"):
                adopted, anodes = pf.adopt(plan["ids"],
                                           dict(plan["private"]),
                                           acquire=True)
                for bid in adopted:
                    for i in [i for i, b in plan["private"].items()
                              if b == bid]:
                        del plan["private"][i]
                # extend, never overwrite: a streamed prefill's per-chunk
                # pins are already here
                plan["adopt_nodes"] = list(plan["adopt_nodes"]) + anodes
            # serve-path provenance: "stream" when chunked streaming landed
            # part of the prompt before this admit; the node origins name
            # the pool events behind the cached prefix
            streamed = plan.get("done", plan["c"]) > plan["c"]
            path = {"mode": "stream" if streamed else "paged",
                    "wrap": bool(plan.get("ring_wrap")),
                    "brownout": self.brownout_level,
                    **page_origin_flags(plan.get("nodes"))}
            self._meta[slot] = {"req": r, "emitted": 1, "out": [],
                                "tok0_ref": (tok0, j), "done": False,
                                "pages": plan, "gen": gens[j], "path": path}
        self.stats["admissions"] += n
        self.stats["paged_admissions"] += n
        if self._tracer is not None:
            self._trace_admits(reqs, slots, feed, t_admit0,
                               pf.counter("prefix_evictions") - ev0)

    def _trace_admits(self, reqs, slots, feed: int, t_admit0: float,
                      evictions: int) -> None:
        """One admission group's spans: per request ``queue_wait``
        (enqueue to this admit) and ``admit`` (the host dispatch), and the
        pool evictions it paid as one ``kv_evictions`` event on the
        group's first traced request."""
        t_admit1 = time.monotonic()
        for r, slot in zip(reqs, slots):
            rid = r.get("rid")
            if not rid:
                continue
            plan = self._meta[slot]["pages"]
            bucket = self._bucket(len(r["ids"]))
            self._tracer.add(rid, "queue_wait", r["t0"], t_admit0,
                             bucket=bucket)
            self._tracer.add(
                rid, "admit", t_admit0, t_admit1, mode="paged",
                bucket=bucket, feed=feed, group=len(reqs),
                prefix_hit_tokens=plan["c"],
                streamed_tokens=plan.get("done", plan["c"]) - plan["c"],
                copy_blocks=0, private_pages=len(plan["private"]),
                deferred=r.get("_page_attempts", 1) > 1)
        if evictions:
            rid = next((r.get("rid") for r in reqs if r.get("rid")), None)
            if rid:
                self._tracer.event(rid, "kv_evictions", blocks=evictions,
                                   group=len(reqs))

    @torch.no_grad()
    def _dispatch_chunk(self, steps: int):
        """Queue ``steps`` decode steps over all slots (nothing forced):
        each live row feeds its last token at its own position, its K/V
        appends into its private page, and it freezes on a stop token or
        its budget. Returns the chunk's ``(toks [S, steps], emitted,
        done)`` device tensors."""
        metas = [m if m is not None and not m["done"] else None
                 for m in self._meta]
        temps = [m["req"]["temperature"] if m else 0.0 for m in metas]
        top_ks = [m["req"]["top_k"] if m else 0 for m in metas]
        top_ps = [m["req"]["top_p"] if m else 0.0 for m in metas]
        gens = [m["gen"] if m else None for m in metas]
        sampled = any(t > 0 for t in temps)
        tok, emitted, starts = self._tok, self._emitted, self._starts
        # a freshly admitted row whose first token is a stop (or whose
        # budget is 1) freezes from step one
        done = (self._done | isin_stops(tok, self._stops)
                | (emitted >= self._budgets))
        toks = []
        for _ in range(steps):
            logits = self.model(tok[:, None], cache=self._prefix.pool,
                                block_tables=self._tables,
                                row_starts=starts,
                                pad_lens=done.to(torch.int32))
            self.stats["model_calls"] += 1
            self.stats["decode_calls"] += 1
            lg = logits[:, -1]
            nxt = (sample_rows(lg, temps, top_ks, top_ps, gens) if sampled
                   else torch.argmax(lg, dim=-1))
            nxt = torch.where(done, torch.zeros_like(nxt), nxt)
            live = (~done).to(torch.int32)
            emitted = emitted + live
            starts = starts + live
            done = done | isin_stops(nxt, self._stops) | (
                emitted >= self._budgets)
            toks.append(nxt)
            tok = nxt
        self._tok, self._emitted, self._done = tok, emitted, done
        self._starts = starts
        self.stats["chunks"] += 1
        self.stats["paged_chunks"] += 1
        return torch.stack(toks, dim=1), emitted, done

    def _absorb(self, toks, emitted, done) -> None:
        """Force a dispatched chunk's outputs and hand tokens to their
        requests; finished and cancelled rows complete and free their
        slots and pages."""
        toks = toks.cpu().numpy()
        emitted = emitted.cpu().numpy()
        done = done.cpu().numpy()
        t_absorb = time.monotonic()
        tok0_np: dict = {}          # one device read per admission group
        for s in range(self._slots):
            m = self._meta[s]
            if m is None or m["done"]:
                continue
            n_before = len(m["out"])
            if not m["out"]:
                arr, j = m["tok0_ref"]
                if id(arr) not in tok0_np:
                    tok0_np[id(arr)] = arr.cpu().numpy()
                m["out"].append(int(tok0_np[id(arr)][j]))
            fresh = int(emitted[s]) - m["emitted"]
            m["out"].extend(int(t) for t in toks[s, :fresh])
            m["emitted"] = int(emitted[s])
            m["done"] = bool(done[s])
            rid = m["req"].get("rid")
            if "t_first" not in m and m["out"]:
                # server-side TTFT: the first absorb that makes the row's
                # first token servable
                m["t_first"] = t_absorb
                ttft = t_absorb - m["req"]["t0"]
                self._ttfts.append(ttft)
                if len(self._ttfts) > 1024:
                    del self._ttfts[:512]
                self.hist["ttft_seconds"].observe(ttft)
                if self._tracer is not None and rid:
                    self._tracer.event(rid, "first_token",
                                       ttft_s=round(ttft, 6))
            elif self._tracer is not None and fresh > 0 and rid:
                self._tracer.event(rid, "decode_chunk", tokens=fresh)
            ev = m["req"].get("cancel")
            dl = m["req"].get("deadline")
            if ev is not None and not m["done"] and ev.is_set():
                # cancelled mid-flight: finalize with what is decoded and
                # freeze the device row now (in stream order, before any
                # later chunk), so its pages can free at completion
                m["done"] = True
                self._done[s] = True
            elif (dl is not None and not m["done"]
                  and dl.expired(t_absorb)):
                # the deadline expired mid-decode: a cancel the engine
                # raises itself, classified "deadline" at completion
                m["done"] = m["deadline"] = True
                self._done[s] = True
            cb = m["req"].get("on_tokens")
            if cb is not None:
                stops = m["req"]["stop"]
                delta = [t for t in m["out"][n_before:] if t not in stops]
                if delta:
                    try:
                        cb(delta)
                    except Exception:   # noqa: BLE001 — a consumer's
                        pass            # callback must not kill absorb
        for s in range(self._slots):
            m = self._meta[s]
            if m is not None and m["done"]:
                self._complete(s)
        if self._tsdb is not None:
            self._observe_tsdb()

    def _observe_tsdb(self) -> None:
        """One time-series observation per absorbed chunk: cumulative
        counters (the store folds them into rates) and gauges."""
        st = self.stats
        snap = self._prefix.stats_snapshot()
        self._tsdb.observe(
            counters={
                "tokens_generated_total": st["tokens_generated"],
                "admissions_total": st["admissions"],
                "chunks_total": st["chunks"],
                "completed_total": st["completed"],
                "cancelled_total": st["cancelled"],
                "deadline_expired_total": st["deadline_expired"],
                "prefix_hit_tokens_total": snap["prefix_hit_tokens"]},
            gauges={
                "queue_depth": self._queue.qsize(),
                "live_slots": self.live_slots(),
                "brownout_level": self.brownout_level,
                "prefix_pool_blocks_used": snap["prefix_pool_blocks_used"]})

    def _complete(self, slot: int) -> None:
        m = self._meta[slot]
        req = m["req"]
        rid = req.get("rid")
        pf = self._prefix
        ad0 = pf.counter("prefix_adopted_blocks")
        # adopt the written (prompt + decoded) blocks, free the tail,
        # release the slot's refs
        pf.paged_finish(m["pages"], m["out"], m["emitted"])
        if self._tracer is not None and rid:
            adopted = pf.counter("prefix_adopted_blocks") - ad0
            if adopted:
                # zero-copy radix adoption of this request's pages
                self._tracer.event(rid, "kv_adopt", blocks=adopted)
        resp = self._response(m["out"], stops=req["stop"],
                              emitted=m["emitted"])
        ev = req.get("cancel")
        if (ev is not None and ev.is_set()
                and resp["stop_reason"] == "length"
                and m["emitted"] < req["budget"]):
            resp["stop_reason"] = "cancelled"
            self.stats["cancelled"] += 1
        if (m.get("deadline") and resp["stop_reason"] == "length"
                and m["emitted"] < req["budget"]):
            # finalized by its own expired deadline, not by its budget
            resp["stop_reason"] = "deadline"
            self.stats["deadline_expired"] += 1
        path = self._base_path()
        path.update(m["path"])
        self._finalize_path(resp, path, rid)
        req["result"] = resp
        req["event"].set()
        self._meta[slot] = None
        self.stats["completed"] += 1
        self.stats["tokens_generated"] += len(resp["ids"])
        t_done = time.monotonic()
        lat = t_done - req["t0"]
        self._latencies.append(lat)
        if len(self._latencies) > 1024:
            del self._latencies[:512]
        # cancelled and deadline-truncated requests stay out of the
        # served-e2e histogram and the SLO: their latency is the client's
        # or the deadline's choice. TPOT stays in: the cadence was real
        if resp["stop_reason"] not in ("cancelled", "deadline"):
            self.hist["e2e_seconds"].observe(lat)
        t_first = m.get("t_first")
        emitted = int(m["emitted"])
        ttft = (t_first - req["t0"]) if t_first is not None else None
        if t_first is not None and emitted > 1:
            self.hist["tpot_seconds"].observe(
                (t_done - t_first) / (emitted - 1))
        if self._tracer is not None and rid:
            self._tracer.event(rid, "complete", e2e_s=round(lat, 6),
                               tokens=emitted,
                               stop_reason=resp["stop_reason"])
        if self._slo is not None and rid:
            self._slo.observe(rid, ttft_s=ttft, e2e_s=lat, tokens=emitted,
                              stop_reason=resp["stop_reason"])

    def queue_depth(self) -> int:
        """Requests waiting for a slot (not yet admitted)."""
        return self._queue.qsize()

    def live_slots(self) -> int:
        """Slots currently decoding a request."""
        meta = getattr(self, "_meta", None) or []
        return sum(m is not None for m in meta)

    def latency_percentiles(self) -> dict:
        lats = sorted(self._latencies[-1024:])
        if not lats:
            return {}
        pick = lambda q: round(percentile(lats, q), 4)   # noqa: E731
        out = {"p50_s": pick(0.50), "p95_s": pick(0.95),
               "p99_s": pick(0.99), "n": len(lats)}
        ttfts = sorted(self._ttfts[-1024:])
        if ttfts:
            tp = lambda q: round(percentile(ttfts, q), 4)    # noqa: E731
            out.update(ttft_p50_s=tp(0.50), ttft_p95_s=tp(0.95),
                       ttft_p99_s=tp(0.99))
        return out

    def _worker(self):
        """The scheduler loop: one thread owns the device state. An
        exception fails every request it involved (never silently kills
        the thread), releases their page plans, and resets the slots."""
        self._meta = [None] * self._slots
        self._init_state()
        pending: list = []
        while True:
            involved = [m["req"] for m in self._meta if m is not None]
            try:
                active = any(m is not None for m in self._meta)
                if not active and not pending:
                    item = self._queue.get()        # block when idle
                    if item is _STOP:
                        return
                    pending.append(item)
                    deadline = time.monotonic() + self._window_s
                    while time.monotonic() < deadline:
                        try:
                            pending.append(self._queue.get_nowait())
                        except queue_mod.Empty:
                            time.sleep(self._window_s / 10)
                while True:
                    try:
                        pending.append(self._queue.get_nowait())
                    except queue_mod.Empty:
                        break
                if any(r is _STOP for r in pending):
                    return
                involved = ([m["req"] for m in self._meta if m is not None]
                            + pending)
                self.stats["requests"] = (self.stats["completed"]
                                          + len(involved))
                with self._lock:
                    self._tick(pending)
            except Exception as e:  # noqa: BLE001 — surfaced per request
                logger.exception("continuous scheduler error")
                for r in involved:
                    r["error"] = e
                    r["event"].set()
                pf = self._prefix
                plans = ([m["pages"] for m in self._meta
                          if m is not None and m.get("pages")]
                         + [r["_pages"] for r in pending
                            if r.get("_pages")])
                for plan in plans:
                    try:
                        pf.drop_plan(plan)
                    except Exception:  # noqa: BLE001 — best effort
                        pass
                pending.clear()
                self._meta = [None] * self._slots
                self._init_state()

    def _tick(self, pending: list) -> None:
        """One scheduler round under the lock: drop cancelled queued
        requests, one streaming-prefill chunk, admissions, then one (or
        two, pipelined) decode chunks. The serving fault hook runs first
        (``slow_decode`` sleeps, ``hang`` wedges this thread, a fired
        ``pool_exhaust`` opens the dry-pool window, in which reservations,
        promotions and streamed chunks defer), then the brownout ladder
        reads the pressure."""
        spec = faults.on_serve_tick(self.stats["chunks"])
        if spec is not None:
            self._pool_dry_until = time.monotonic() + spec.duration_s
            logger.warning("fault pool_exhaust: the pool reads dry for "
                           "%.2fs", spec.duration_s)
        if self._brownout is not None:
            with self._bo_lock:
                self._brownout.update(
                    self._brownout_pressure(waiting=len(pending)))
        # drop queued requests whose cancel fired or whose deadline
        # expired before they took a slot
        for r in list(pending):
            ev, dl = r.get("cancel"), r.get("deadline")
            dead = ev is not None and ev.is_set()
            if not (dead or (dl is not None and dl.expired())):
                continue
            pending.remove(r)
            plan = r.pop("_pages", None)
            if plan is not None:
                # between streaming chunks: chunks already adopted stay in
                # the radix (valid content), the rest of the plan frees
                self._prefix.paged_finish(plan, [], 0,
                                          written=plan.get("done", 0))
            resp = self._response([], stops=r["stop"], emitted=0)
            resp["stop_reason"] = "cancelled" if dead else "deadline"
            r["result"] = resp
            r["event"].set()
            self.stats["cancelled" if dead else "deadline_expired"] += 1
            self.stats["completed"] += 1
        pf = self._prefix
        pf.apply_pending_corruption()
        dry = self._pool_dry()
        # the spill tiers: pending requests whose prefix was demoted
        # promote here, before any reservation of this tick looks it up
        if pf.spill is not None and not dry:
            for r in pending[:self._slots]:
                t_tier0 = time.monotonic()
                n = pf.promote_spilled(r["ids"])
                if n and self._tracer is not None and r.get("rid"):
                    # the request's time pulling its prefix back up the
                    # hierarchy (inside its queue wait)
                    self._tracer.add(r["rid"], "tier", t_tier0,
                                     time.monotonic(), blocks=n)
        # ONE chunk of ONE long pending prompt per tick: decode rows
        # interleave between chunks
        if self._prefill_chunk and pending and not dry:
            for r in pending:
                if (len(r["ids"]) > self._prefill_chunk
                        or r.get("_pages") is not None):
                    if self._stream_prefill_step(r) != "skip":
                        break
        free = [s for s in range(self._slots) if self._meta[s] is None]
        groups: dict = {}
        for r in list(pending):
            if not free:
                break
            if (self.brownout_level >= 3
                    and r["budget"] > self._bo_max_new):
                # level 3: long generations finish short so slots recycle
                # (the stop_reason stays "length": the browned-out budget
                # was exhausted)
                r["budget"] = self._bo_max_new
                self.stats["brownout_clamped"] += 1
            if self._needs_streaming(r):
                continue        # still streaming: later requests go by
            plan = r.get("_pages") or self._reserve_pages(r)
            if plan is None:
                # dry pool: defer (FIFO — later requests wait too)
                self.stats["deferred_admissions"] += 1
                break
            r["_pages"] = plan
            if self._needs_streaming(r):
                continue
            pending.remove(r)
            groups.setdefault(self._bucket(len(r["ids"])), []).append(
                (r, free.pop(0)))
        for pairs in groups.values():
            self._admit_group([r for r, _ in pairs], [s for _, s in pairs])
        self.stats["max_active"] = max(
            self.stats["max_active"],
            sum(m is not None for m in self._meta))
        live = [m for m in self._meta if m is not None]
        if not live:
            return
        min_left = min(m["req"]["budget"] - m["emitted"] for m in live)
        steps = self._chunk
        # adaptive growth: with every slot busy no slot can free before
        # min_left steps (unless a row stops early), so one longer chunk
        # recycles slots as fast with fewer host round trips. Brownout
        # level 2 turns growth off: the queue's admission latency first
        if (min_left > self._chunk and self.brownout_level < 2
                and not any(m is None for m in self._meta)):
            limit = min(min_left, self._chunk * self._grow_cap(live))
            while steps * 2 <= limit:
                steps *= 2
        out1 = self._dispatch_chunk(steps)
        # dispatch one chunk ahead while the first runs, unless queued
        # traffic wants a slot between them or every row finishes first
        min_left -= steps
        if (self._queue.empty() and min_left > 0
                and not any(m is None for m in self._meta)):
            out2 = self._dispatch_chunk(self._chunk)
            self._absorb(*out1)
            self._absorb(*out2)
        else:
            self._absorb(*out1)
