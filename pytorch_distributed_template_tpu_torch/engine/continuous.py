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
``_warm_admit_ladder``) and power-of-two bucketing of admission feeds and
group widths (bucketing changes only pad lanes, never valid outputs). A
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

Left to later slices: the non-paged shared-cache engine (eras, the scatter
warm admit; ROADMAP A3a.1), brownout and SLOs (A3a.5, A3a.7), deadlines,
tracing, anatomy, speculative decoding (A4) and roles/page shipping
(A3a.4). Without a paged pool the constructor raises.
"""
from __future__ import annotations

import logging
import queue as queue_mod
import threading
import time

import numpy as np
import torch

from ..utils.promtext import percentile
from .generate import isin_stops, sample_rows
from .kvcache import paged_forward
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
               prefill_chunk_tokens: int = 0):
        super()._setup(model, tokenizer, prefix_cache=prefix_cache)
        if self._prefix is None or not self._prefix.paged:
            raise NotImplementedError(
                "the port's continuous engine runs over a paged KV pool "
                "(serving.prefix_cache with paged=true); "
                + _SLICE_SHARED)
        self._slots = int(slots)
        self._chunk = int(chunk)
        if self._slots < 1 or self._chunk < 1:
            raise ValueError("slots and chunk must be >= 1")
        chunk_tok = int(prefill_chunk_tokens or 0)
        if chunk_tok and (chunk_tok & (chunk_tok - 1)):
            raise ValueError(
                f"serving.prefill_chunk_tokens={chunk_tok} must be a power "
                "of two")
        if self._prefix.window > 0:
            cap = int(self._prefix.ring_slack_tokens)
            chunk_tok = min(chunk_tok or cap, cap)
        self._prefill_chunk = chunk_tok
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
                      "decode_calls": 0, "tp_degree": self.tp}
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

    # ---- request entry ---------------------------------------------------

    def generate(self, prompt=None, prompt_ids=None,
                 max_new_tokens: int = 64, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0, seed: int = 0,
                 speculative: int = 0, stop=None, on_tokens=None,
                 cancel=None) -> dict:
        """The parent's contract plus ``on_tokens`` (called on the
        scheduler thread with each absorbed batch of this request's new
        ids, stop ids filtered: the deltas concatenate to the response's
        ``ids``; must not block) and ``cancel`` (a ``threading.Event``:
        once set, the request finalizes at its next chunk absorb with
        ``stop_reason: "cancelled"`` and its slot and pages free; a
        request still queued is dropped)."""
        if int(speculative) > 0:
            raise NotImplementedError(
                "speculative decoding is a later slice of the port "
                "(ROADMAP A4)")
        ids = self.encode_prompt(prompt, prompt_ids)
        stops = self.encode_stop(stop)
        max_new = int(max_new_tokens)
        self._validate_budget(ids, max_new, stops)
        req = {"ids": ids, "budget": max_new,
               "temperature": float(temperature), "top_k": int(top_k),
               "top_p": float(top_p), "seed": int(seed), "stop": stops,
               "on_tokens": on_tokens, "cancel": cancel,
               "event": threading.Event(), "t0": time.monotonic()}
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
        live row can exit a chunk early (stop tokens, cancel events)."""
        return (min(cls.GROW_MAX_STOPS, cls.GROW_MAX)
                if any(m["req"]["stop"] or m["req"].get("cancel") is not None
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
        counts toward the hit/lookup stats."""
        first = not r.get("_page_retry")
        r["_page_retry"] = True
        return self._prefix.paged_plan(r["ids"], r["budget"], record=first)

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
        n, W = len(reqs), self.MAX_STOPS
        plans = [r["_pages"] for r in reqs]
        # "done" covers the radix-cached prefix AND chunks a streamed
        # prefill already landed; the suffix is >= 1 (the final prompt
        # token is never served from cache)
        feed = max(len(r["ids"]) - p.get("done", p["c"])
                   for r, p in zip(reqs, plans))
        prompts = np.zeros((n, feed), np.int64)
        pads = np.zeros((n,), np.int32)
        starts = np.zeros((n,), np.int32)
        stops = np.full((n, W), -1, np.int64)
        tables = np.stack([pf.table_row(p) for p in plans])
        for j, (r, p) in enumerate(zip(reqs, plans)):
            ids = r["ids"]
            c = p.get("done", p["c"])
            s = len(ids) - c
            prompts[j, feed - s:] = ids[c:]
            pads[j] = feed - s
            starts[j] = len(ids) - feed          # lane 0's position
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
                pad_lens=torch.from_numpy(pads).to(dev))[:, -1]
            self.stats["model_calls"] += 1
            self.stats["admit_calls"] += 1
            tok0 = sample_rows(logits, [r["temperature"] for r in reqs],
                               [r["top_k"] for r in reqs],
                               [r["top_p"] for r in reqs], gens)
        except Exception:
            for r in reqs:
                pf.drop_plan(r.pop("_pages"))
            raise
        self._tables[idx] = tables_k
        self._starts[idx] = starts_k + feed
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
            self._meta[slot] = {"req": r, "emitted": 1, "out": [],
                                "tok0_ref": (tok0, j), "done": False,
                                "pages": plan, "gen": gens[j]}
        self.stats["admissions"] += n
        self.stats["paged_admissions"] += n

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
            if "t_first" not in m and m["out"]:
                m["t_first"] = t_absorb
                self._ttfts.append(t_absorb - m["req"]["t0"])
                if len(self._ttfts) > 1024:
                    del self._ttfts[:512]
            ev = m["req"].get("cancel")
            if ev is not None and not m["done"] and ev.is_set():
                # cancelled mid-flight: finalize with what is decoded and
                # freeze the device row now (in stream order, before any
                # later chunk), so its pages can free at completion
                m["done"] = True
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

    def _complete(self, slot: int) -> None:
        m = self._meta[slot]
        req = m["req"]
        # adopt the written (prompt + decoded) blocks, free the tail,
        # release the slot's refs
        self._prefix.paged_finish(m["pages"], m["out"], m["emitted"])
        resp = self._response(m["out"], stops=req["stop"],
                              emitted=m["emitted"])
        ev = req.get("cancel")
        if (ev is not None and ev.is_set()
                and resp["stop_reason"] == "length"
                and m["emitted"] < req["budget"]):
            resp["stop_reason"] = "cancelled"
            self.stats["cancelled"] += 1
        self._meta[slot] = None
        self.stats["completed"] += 1
        self.stats["tokens_generated"] += len(resp["ids"])
        self._latencies.append(time.monotonic() - req["t0"])
        if len(self._latencies) > 1024:
            del self._latencies[:512]
        req["result"] = resp
        req["event"].set()

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
        two, pipelined) decode chunks."""
        for r in list(pending):
            ev = r.get("cancel")
            if ev is not None and ev.is_set():
                pending.remove(r)
                plan = r.pop("_pages", None)
                if plan is not None:
                    # cancelled between streaming chunks: chunks already
                    # adopted stay in the radix (valid content), the rest
                    # of the plan frees
                    self._prefix.paged_finish(plan, [], 0,
                                              written=plan.get("done", 0))
                resp = self._response([], stops=r["stop"], emitted=0)
                resp["stop_reason"] = "cancelled"
                r["result"] = resp
                r["event"].set()
                self.stats["cancelled"] += 1
                self.stats["completed"] += 1
        # ONE chunk of ONE long pending prompt per tick: decode rows
        # interleave between chunks
        if self._prefill_chunk and pending:
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
        # recycles slots as fast with fewer host round trips
        if min_left > self._chunk and not any(m is None
                                              for m in self._meta):
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
