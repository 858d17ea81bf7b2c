"""Paged KV block pool + radix prefix index: the paged subset of the JAX
package's ``engine/kvcache.py``.

- **Block pool** (``PrefixCache.pool``): the model's ``PagedCache`` — per
  layer K/V pages ``[pool_blocks, block_tokens, KVH, D]`` (int8 pages plus
  f32 scale pages ``[P, bt, KVH]`` under ``kv_quant="int8"``) on the
  model's device. Page ``SCRATCH_BLOCK`` (0) is never allocated: pad lanes
  and unallocated table lanes write there. Forward calls write the pool in
  place, so the JAX package's donate-and-resync of the pool has no
  counterpart here: the pool tensors ARE the cache.
- **Radix index** (``RadixIndex``): a trie over prompt ids with one edge
  per FULL block, each node owning one page; refcounts pin pages a live
  request reads, LRU eviction takes unreferenced leaves only.
- **Paged plans**: a request reserves its shared prefix (refs held for its
  lifetime) plus a private chain covering the uncached suffix and the
  whole budget up front (``paged_plan``); at the end its written full
  blocks are ADOPTED into the index in place (``paged_finish``), a
  zero-copy insert. Warm admits are block-table pointer updates: the
  pool's ``warm_admit_copy_bytes`` stays 0.
- **Ring layout** (``window > 0``): a row's table is a ring of
  ``window/bt + 1 + slack/bt`` pages (logical block j in slot j % NB). A
  request whose ``prompt + budget`` exceeds that span wraps: it shares and
  adopts nothing. A single prefill feed never exceeds the slack, so long
  prompts stream in ``ring_slack_tokens`` chunks.

- **Tensor parallelism**: the pool's pages are split on the KV-head axis
  over the group's ranks (each rank's ``new_paged_cache`` holds its
  ``KVH / T`` heads; ``parallel/serving_ranks.py``), while the radix index,
  the tables, the free list and the refcounts stay single, here: a page id
  means the same page on every rank. KV heads that T does not divide are
  refused (``kv_heads``), as in the JAX package.

- **Scatter arm** (a pool that is not paged: the GPT-2 family, whose
  ``kv_cache_spec`` says ``paged: False``, or ``prefix_cache.paged:
  false``; the JAX ``warm_prefill`` / ``scatter_blocks`` / ``capture``):
  the pool's pages are plain storage ``[P, bt, H, D]`` (built from the
  model's one-block cache). A batch-1 request's cached prefix blocks are
  COPIED into a fresh contiguous cache at slots ``0 .. c - 1``
  (:meth:`PrefixCache.warm_prefill`, counted in ``warm_admit_copy_bytes``),
  the suffix is fed through the masked continuation path, and the prompt's
  own new full blocks are captured back into freshly inserted pages. At
  batch 1 the prompt starts at slot 0, so pool space is cache space: rows
  copy verbatim, int8 bytes and scales included, and no K rotation is
  needed (the JAX delta-0 rotation is the identity). A full miss takes the
  cold flash prefill and is captured the same way.

Left to later slices: the scatter arm of the continuous engine (a shared
non-paged cache with per-slot rotation; ROADMAP A3a.1's other half), the
spill tiers (``SpillTier``; A3a.3, refused by name) and page shipping
(``serialize_pages``, ``export_pages``/``import_pages``; A3a.4).
"""
from __future__ import annotations

import logging
import threading

import numpy as np
import torch

from ..models.llama import SCRATCH_BLOCK, PagedCache, PagedLayer
from ..parallel.tp import model_geometry, tp_degree

logger = logging.getLogger(__name__)


class PoolUnsupported(ValueError):
    """A KV layout the pool cannot serve, with the machine-readable
    ``reason`` (``window`` / ``kv_quant`` / ``undersized`` /
    ``gpt2_layout``) that feeds the ``pool_fallback_*`` counters."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


class RadixIndex:
    """Block-granular radix/trie over prompt token ids (the JAX package's
    ``RadixIndex``, verbatim in behaviour).

    One edge per full ``block_tokens``-id chunk; each node owns exactly
    one pool block. Matching walks whole blocks. Nodes carry a refcount
    and an LRU clock; eviction only ever takes an UNREFERENCED LEAF."""

    def __init__(self, block_tokens: int):
        self.block = int(block_tokens)
        self.root = {"children": {}, "block": None, "parent": None,
                     "refs": 0, "last_use": 0}
        self._clock = 0
        self.nodes = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _chunks(self, ids):
        ids = list(ids)
        n = len(ids) // self.block
        return [tuple(ids[i * self.block:(i + 1) * self.block])
                for i in range(n)]

    def match(self, ids):
        """Longest fully-blocked cached prefix of ``ids`` ->
        ``(nodes, block_ids)`` (refs NOT acquired)."""
        now = self._tick()
        node, nodes, blocks = self.root, [], []
        for chunk in self._chunks(ids):
            nxt = node["children"].get(chunk)
            if nxt is None:
                break
            nxt["last_use"] = now
            nodes.append(nxt)
            blocks.append(nxt["block"])
            node = nxt
        return nodes, blocks

    def acquire(self, nodes):
        for n in nodes:
            n["refs"] += 1

    def release(self, nodes):
        for n in nodes:
            n["refs"] -= 1
            if n["refs"] < 0:
                raise RuntimeError("radix refcount underflow")

    def insert(self, ids, alloc):
        """Create nodes for every full block of ``ids`` not yet present;
        ``alloc()`` returns a free block id or None (insertion stops).
        Returns ``(new_nodes, new_block_ids, start_block_index)``. The
        walked path is pinned while ``alloc`` may evict."""
        now = self._tick()
        node = self.root
        pinned = []
        new_nodes, new_blocks, start = [], [], None
        try:
            for i, chunk in enumerate(self._chunks(ids)):
                nxt = node["children"].get(chunk)
                if nxt is None:
                    bid = alloc()
                    if bid is None:
                        break
                    nxt = {"children": {}, "block": bid, "parent": node,
                           "chunk": chunk, "refs": 0, "last_use": now}
                    node["children"][chunk] = nxt
                    self.nodes += 1
                    new_nodes.append(nxt)
                    new_blocks.append(bid)
                    if start is None:
                        start = i
                nxt["refs"] += 1
                pinned.append(nxt)
                nxt["last_use"] = now
                node = nxt
        finally:
            for n in pinned:
                n["refs"] -= 1
        return new_nodes, new_blocks, (0 if start is None else start)

    def evict_lru(self):
        """Detach the least-recently-used unreferenced LEAF node and
        return its block id (None when everything is pinned)."""
        best, best_key = None, None
        stack = [self.root]
        while stack:
            node = stack.pop()
            for child in node["children"].values():
                if not child["children"]:
                    if child["refs"] == 0 and (
                            best is None or child["last_use"] < best_key):
                        best, best_key = child, child["last_use"]
                else:
                    stack.append(child)
        if best is None:
            return None
        del best["parent"]["children"][best["chunk"]]
        best["parent"] = None
        self.nodes -= 1
        return best["block"]


class PrefixCache:
    """Radix index + the device block pool + the paged plan bookkeeping.

    Thread-safety: host bookkeeping (index, free list, stats) is guarded
    by a lock; device work is issued by the caller's single scheduler
    thread (or under the batch-1 service's lock)."""

    def __init__(self, model, block_tokens: int = 32, pool_blocks: int = 256,
                 eviction: str = "lru", paged: bool = True,
                 ring_slack_tokens: int = 512, host_spill_blocks: int = 0,
                 disk_spill_dir=None, disk_spill_blocks: int = 0):
        if int(host_spill_blocks) > 0 or (disk_spill_dir
                                          and int(disk_spill_blocks) > 0):
            raise NotImplementedError(
                "KV spill tiers (host/disk demote-on-evict) are a later "
                "slice of the port (ROADMAP A3a.3)")
        spec = getattr(model, "kv_cache_spec", None)
        if spec is None:
            raise PoolUnsupported(
                "gpt2_layout",
                f"{type(model).__name__} declares no kv_cache_spec(): "
                "prefix caching needs the decode-cache layout contract")
        spec = spec()
        if spec.get("kv_quant") not in ("", None, "int8"):
            raise PoolUnsupported(
                "kv_quant", f"unknown kv_quant {spec['kv_quant']!r} (the "
                "int8-KV pool layout is the only quantized layout)")
        if eviction != "lru":
            raise ValueError(f"unknown eviction policy {eviction!r} "
                             "(only 'lru')")
        # TP: every rank's pool holds KVH / T heads of each page
        self.tp = tp_degree(model)
        kv_heads = model_geometry(model)["n_kv_head"]
        if self.tp > 1 and kv_heads % self.tp:
            raise ValueError(
                f"kv_heads={kv_heads} does not split over "
                f"tensor_parallel={self.tp}: the pool shards its pages on "
                "the KV-head axis")
        if int(block_tokens) < 1 or int(pool_blocks) < 2:
            raise ValueError("need block_tokens >= 1 and pool_blocks "
                             ">= 2 (block 0 is reserved scratch)")
        self.model = model
        self.block = int(block_tokens)
        self.pool_blocks = int(pool_blocks)
        self.rotary = bool(spec.get("rotary"))
        self.rope_base = float(spec.get("rope_base") or 0.0)
        self.kv_quant = str(spec.get("kv_quant") or "")
        self.window = int(spec.get("window", 0) or 0)
        self.ring_slack_tokens = 0
        if self.window:
            if not (bool(paged) and spec.get("paged", False)):
                raise PoolUnsupported(
                    "window",
                    f"window={self.window} needs the paged pool layout "
                    "(the scatter fallback's rolling cache is "
                    "position-dependent)")
            if self.window % self.block or self.window < self.block:
                raise PoolUnsupported(
                    "window",
                    f"window={self.window} must be a positive multiple "
                    f"of block_tokens={self.block} for the ring layout")
            # the largest single prefill feed the ring tolerates without
            # a dispatch's writes clobbering its own queries' band
            slack = 16
            while slack < min(int(ring_slack_tokens), self.window):
                slack *= 2
            self.ring_slack_tokens = slack
        self.index = RadixIndex(self.block)
        self._free = list(range(1, self.pool_blocks))      # 0 = scratch
        # pages allocated to live requests but not owned by the index
        # (prompt suffixes being written + decode appends)
        self._private: set = set()
        self._lock = threading.Lock()
        self.stats = {
            "prefix_lookups": 0, "prefix_hit_requests": 0,
            "prefix_hit_tokens": 0, "prefix_inserted_blocks": 0,
            "prefix_evictions": 0, "prefix_dropped_inserts": 0,
            # device bytes copied by warm admits: the paged path keeps
            # this at 0 (warm admits are block-table pointer updates)
            "warm_admit_copy_bytes": 0,
            "prefix_adopted_blocks": 0,
            "batch1_paged_requests": 0,
            "batch1_scatter_requests": 0,
            "pool_fallback_window": 0,
            "pool_fallback_kv_quant": 0,
            "pool_fallback_undersized": 0,
            "pool_fallback_gpt2_layout": 0,
            "pool_fallback_dry_pool": 0,
        }
        self.nb_max = -(-int(model.max_len) // self.block)
        if self.window:
            nb_ring = (self.window // self.block + 1
                       + self.ring_slack_tokens // self.block)
            self.nb_max = min(self.nb_max, nb_ring)
        self.paged = bool(paged) and bool(spec.get("paged", False))
        self.fallback_reason = ""
        if not spec.get("paged", False):
            self.fallback_reason = "gpt2_layout"
        if self.paged and self.pool_blocks - 1 < self.nb_max:
            if self.window:
                raise PoolUnsupported(
                    "undersized",
                    f"prefix_cache.pool_blocks={self.pool_blocks} cannot "
                    f"hold one ring request ({self.nb_max} blocks for "
                    f"window={self.window} + slack at "
                    f"block_tokens={self.block})")
            logger.warning(
                "prefix_cache.pool_blocks=%d cannot hold one full-budget "
                "request (%d blocks for max_len=%d at block_tokens=%d): "
                "paged decode disabled; requests serve cold",
                self.pool_blocks, self.nb_max, int(model.max_len),
                self.block)
            self.paged = False
            self.fallback_reason = "undersized"
        with torch.no_grad():
            if spec.get("paged", False):
                self.pool = model.new_paged_cache(self.pool_blocks,
                                                  self.block)
            else:
                self.pool = _scatter_pool(model, self.pool_blocks,
                                          self.block)
        self.page_bytes = int(sum(
            t[0].numel() * t.element_size()
            for layer in self.pool.layers
            for t in (layer.k, layer.v, layer.k_scale, layer.v_scale)
            if t is not None))

    # ---- host bookkeeping -------------------------------------------------

    def used_blocks(self) -> int:
        return self.pool_blocks - 1 - len(self._free)

    def _alloc(self):
        """One free block id, evicting the LRU unreferenced leaf when the
        free list is empty; None when everything is pinned (caller holds
        the lock)."""
        if self._free:
            return self._free.pop()
        bid = self.index.evict_lru()
        if bid is None:
            self.stats["prefix_dropped_inserts"] += 1
            return None
        self.stats["prefix_evictions"] += 1
        return bid

    def lookup(self, ids, record: bool = True):
        """Longest cached, fully-blocked, PROPER prefix of ``ids`` ->
        ``(nodes, block_ids, cached_tokens)`` with refs acquired (callers
        ``release(nodes)``). The prompt's final token is never served
        from cache, so ``cached_tokens <= len(ids) - 1``. ``record=False``
        (a deferred request retrying) skips the hit/lookup counters."""
        with self._lock:
            if record:
                self.stats["prefix_lookups"] += 1
            nodes, blocks = self.index.match(ids)
            limit = (len(ids) - 1) // self.block     # proper-prefix cap
            nodes, blocks = nodes[:limit], blocks[:limit]
            c = len(nodes) * self.block
            if c:
                if record:
                    self.stats["prefix_hit_requests"] += 1
                    self.stats["prefix_hit_tokens"] += c
                self.index.acquire(nodes)
            return nodes, blocks, c

    def count_fallback(self, reason: str = "") -> None:
        """Count one request that degraded off the paged pool path;
        ``reason`` defaults to the pool's structural ``fallback_reason``.
        An empty reason (paged turned off by choice) is not counted."""
        reason = reason or self.fallback_reason
        if not reason:
            return
        key = f"pool_fallback_{reason}"
        with self._lock:
            if key in self.stats:
                self.stats[key] += 1

    def plan_insert(self, ids):
        """Allocate pages and index nodes for the full blocks of ``ids``
        not cached yet: ``(page ids, first block index)`` for
        :meth:`capture` (empty when nothing is new)."""
        with self._lock:
            _, blocks, start = self.index.insert(ids, self._alloc)
            self.stats["prefix_inserted_blocks"] += len(blocks)
            return blocks, start

    def record_copy_bytes(self, n_blocks: int) -> None:
        """Count one warm admit's device copy of ``n_blocks`` pool pages
        into a contiguous cache (the scatter arm's cost)."""
        if n_blocks:
            with self._lock:
                self.stats["warm_admit_copy_bytes"] += (
                    int(n_blocks) * self.page_bytes)

    def count_batch1(self, paged: bool) -> None:
        """Tally which arm served one batch-1 request."""
        key = ("batch1_paged_requests" if paged
               else "batch1_scatter_requests")
        with self._lock:
            self.stats[key] += 1

    def cached_block_count(self, ids) -> int:
        """Full blocks of ``ids`` the pool holds now (no refs taken, no
        proper-prefix cap): the DP facade's affinity probe."""
        with self._lock:
            _, blocks = self.index.match(list(ids))
            return len(blocks)

    def counter(self, name: str) -> int:
        with self._lock:
            return int(self.stats.get(name, 0))

    def release(self, nodes):
        with self._lock:
            self.index.release(nodes)

    def alloc_chain(self, n: int):
        """Allocate ``n`` PRIVATE blocks, LRU-evicting under pressure;
        all-or-nothing (None on a dry pool, partial allocation rolled
        back)."""
        with self._lock:
            got = []
            for _ in range(int(n)):
                bid = self._alloc()
                if bid is None:
                    self._free.extend(got)
                    return None
                got.append(bid)
            self._private.update(got)
            return got

    def free_blocks(self, ids) -> None:
        """Return private blocks to the free list."""
        if not ids:
            return
        with self._lock:
            for bid in ids:
                self._private.discard(bid)
            self._free.extend(ids)

    def adopt(self, token_ids, owned: dict, acquire: bool = False):
        """ZERO-COPY radix insert: hand privately written pages to the
        index. ``owned`` maps full-block INDEX of ``token_ids`` -> the
        private page holding that block. The walk creates missing nodes
        where a page is owned and stops at a missing node it cannot
        supply; a node that already exists leaves the private duplicate
        private. Returns ``(adopted_ids, nodes)`` (``nodes``: the created
        nodes, ref-pinned when ``acquire``)."""
        bt = self.block
        nfull = len(token_ids) // bt
        with self._lock:
            node = self.index.root
            adopted, nodes = [], []
            now = self.index._tick()
            for i in range(nfull):
                chunk = tuple(token_ids[i * bt:(i + 1) * bt])
                nxt = node["children"].get(chunk)
                if nxt is None:
                    bid = owned.get(i)
                    if bid is None:
                        break
                    nxt = {"children": {}, "block": int(bid),
                           "parent": node, "chunk": chunk,
                           "refs": 0, "last_use": now}
                    node["children"][chunk] = nxt
                    self.index.nodes += 1
                    self._private.discard(int(bid))
                    adopted.append(int(bid))
                    if acquire:
                        nxt["refs"] += 1
                        nodes.append(nxt)
                nxt["last_use"] = now
                node = nxt
            self.stats["prefix_adopted_blocks"] += len(adopted)
            return adopted, nodes

    def stats_snapshot(self) -> dict:
        with self._lock:
            out = dict(self.stats)
            resident = self.index.nodes
            referenced = len(self._private) + self._count_referenced()
        out["prefix_pool_blocks"] = self.pool_blocks - 1
        out["prefix_pool_blocks_used"] = self.used_blocks()
        # resident = unique pages the radix index owns; referenced =
        # pages live requests hold (shared refs + private tails)
        out["prefix_pool_blocks_resident"] = resident
        out["prefix_pool_blocks_referenced"] = referenced
        out["prefix_paged"] = bool(self.paged)
        lk = out["prefix_lookups"]
        out["prefix_hit_rate"] = round(
            out["prefix_hit_requests"] / lk, 4) if lk else 0.0
        out["pool_fallback_total"] = sum(
            v for k, v in out.items() if k.startswith("pool_fallback_"))
        out["prefix_page_bytes"] = int(self.page_bytes)
        out["prefix_pool_window"] = int(self.window)
        out["prefix_pool_kv_quant"] = 1 if self.kv_quant else 0
        return out

    def _count_referenced(self) -> int:
        n, stack = 0, [self.index.root]
        while stack:
            node = stack.pop()
            for child in node["children"].values():
                if child["refs"] > 0:
                    n += 1
                stack.append(child)
        return n

    # ---- scatter arm ------------------------------------------------------

    @torch.no_grad()
    def capture(self, cache, start: int, block_ids) -> None:
        """Copy the cache row-0 blocks ``start, start + 1, ..`` into the
        pool pages ``block_ids`` (the JAX ``capture`` at batch 1: slot 0 is
        the prompt's start, so rows copy verbatim)."""
        bt = self.block
        for layer, pl in zip(cache.layers, self.pool.layers):
            for j, bid in enumerate(block_ids):
                lo = (start + j) * bt
                for src, dst in ((layer.k, pl.k), (layer.v, pl.v),
                                 (layer.k_scale, pl.k_scale),
                                 (layer.v_scale, pl.v_scale)):
                    if dst is not None:
                        dst[int(bid)] = src[0, lo:lo + bt]

    @torch.no_grad()
    def warm_prefill(self, ids, total: int, record: bool = True):
        """Batch-1 prefill through the pool's scatter arm (the JAX
        ``warm_prefill``): copy the cached chain into a fresh ``[1,
        total]`` cache, feed only the suffix, then capture the prompt's new
        full blocks. Returns ``(last logits [1, V], cache, cached
        tokens)``, the cold prefill's contract. ``record=False`` when the
        request's lookup was counted already (a paged dry-pool fall
        through)."""
        from .generate import _prefill_fresh

        if self.window:
            raise PoolUnsupported(
                "window", "the scatter arm cannot serve a rolling-window "
                "layout (paged ring only)")
        model, bt = self.model, self.block
        dev = model.device
        nodes, blocks, c = self.lookup(ids, record=record)
        try:
            if c == 0:
                prompt = torch.tensor([list(ids)], dtype=torch.long,
                                      device=dev)
                last, cache = _prefill_fresh(model, prompt, int(total))
            else:
                cache = model.new_cache(1, int(total))
                idx = torch.tensor(blocks, dtype=torch.long, device=dev)
                for layer, pl in zip(cache.layers, self.pool.layers):
                    for dst, src in ((layer.k, pl.k), (layer.v, pl.v),
                                     (layer.k_scale, pl.k_scale),
                                     (layer.v_scale, pl.v_scale)):
                        if dst is not None:
                            rows = src[idx]
                            dst[0, :c] = rows.reshape(c, *rows.shape[2:])
                cache.pos_index = c
                suffix = torch.tensor([list(ids[c:])], dtype=torch.long,
                                      device=dev)
                last = model(suffix, cache=cache)[:, -1]
                self.record_copy_bytes(len(blocks))
        finally:
            self.release(nodes)
        new_blocks, start = self.plan_insert(ids)
        if new_blocks:
            self.capture(cache, start, new_blocks)
        return last, cache, c

    # ---- paged plans ------------------------------------------------------

    def paged_plan(self, ids, budget: int, record: bool = True):
        """Page reservation for one request: shared-prefix lookup (refs
        held for the request's lifetime) plus a private chain for the
        uncached suffix AND the full budget. ``None`` when the pool cannot
        supply the chain now (the caller defers or serves cold).

        Ring layout: a request whose ``prompt + budget`` exceeds the ring
        span WRAPS — it shares nothing and runs fully private on exactly
        ``nb_max`` pages (``ring_wrap``); nothing it writes is adopted."""
        ring_wrap = False
        nfull_total = -(-(len(ids) + int(budget)) // self.block)
        if self.window and nfull_total > self.nb_max:
            ring_wrap = True
            if record:
                with self._lock:
                    self.stats["prefix_lookups"] += 1
            nodes, blocks, c = [], [], 0
            n_need = self.nb_max
        else:
            nodes, blocks, c = self.lookup(ids, record=record)
            n_need = nfull_total - c // self.block
        priv = self.alloc_chain(n_need)
        if priv is None:
            self.release(nodes)
            return None
        return {
            "ids": list(ids), "c": c, "nodes": nodes, "blocks": blocks,
            "private": {c // self.block + i: bid
                        for i, bid in enumerate(priv)},
            "ring_wrap": ring_wrap,
            # shared nodes pinned after reservation (pages a streamed
            # prefill adopted mid-prompt) — released with the plan
            "adopt_nodes": [],
        }

    def table_row(self, plan) -> np.ndarray:
        """The plan's block-table row ``[nb_max]`` int32: shared prefix
        pages, pages adopted mid-prefill, then the private chain; ``-1``
        elsewhere."""
        row = np.full((self.nb_max,), -1, np.int32)
        for i, b in enumerate(plan["blocks"]):
            row[i] = b
        for idx, bid in (plan.get("shared") or {}).items():
            row[idx] = bid
        for idx, bid in plan["private"].items():
            row[idx] = bid
        return row

    def drop_plan(self, plan) -> None:
        """Undo a plan without adopting anything: release its refs and
        free its private pages (a failed dispatch)."""
        self.release(plan["nodes"])
        self.release(plan.get("adopt_nodes") or [])
        self.free_blocks(list(plan["private"].values()))

    def paged_prefill(self, ids, budget: int):
        """Batch-1 paged prefill: the cached prefix is a block-table entry
        (no device copy), the uncached suffix is fed into the plan's
        private pages. Returns ``(last_logits [1, V], tables, plan)`` or
        ``None`` on a dry pool. Ring layouts stream suffixes longer than
        ``ring_slack_tokens`` in chunks of that size. The caller decodes
        with :func:`paged_forward` and MUST ``paged_finish`` the plan; a
        failed prefill drops the plan and re-raises."""
        plan = self.paged_plan(ids, budget)
        if plan is None:
            return None
        dev = self.model.device
        tables = torch.from_numpy(self.table_row(plan)[None]).to(dev)
        done, L = plan["c"], len(ids)
        try:
            while self.window and L - done > self.ring_slack_tokens:
                f = self.ring_slack_tokens
                paged_forward(self.model, self.pool, ids[done:done + f],
                              tables, done)
                done += f
            last = paged_forward(self.model, self.pool, ids[done:], tables,
                                 done)
        except Exception:
            self.drop_plan(plan)
            raise
        return last, tables, plan

    def paged_finish(self, plan, out_ids, emitted: int,
                     written=None) -> None:
        """End-of-request bookkeeping: zero-copy ADOPT the written full
        (prompt + decoded) blocks, free the unadoptable tail, release the
        plan's refs. ``written`` overrides the written-token count (a
        request cancelled mid-prompt); a ``ring_wrap`` plan adopts
        nothing (its recycled slots no longer match any prefix)."""
        ids = plan["ids"]
        seq = list(ids) + [int(t) for t in out_ids]
        if written is None:
            # the prompt plus every fed decode token (the last sampled
            # token is never fed back)
            written = len(ids) + max(int(emitted) - 1, 0)
        if plan.get("ring_wrap"):
            adopted = []
        else:
            adopted, _ = self.adopt(seq[:int(written)],
                                    dict(plan["private"]))
        taken = set(adopted)
        self.free_blocks([b for b in plan["private"].values()
                          if b not in taken])
        self.release(plan["nodes"])
        self.release(plan.get("adopt_nodes") or [])


def _scatter_pool(model, pool_blocks: int, block_tokens: int):
    """The scatter arm's page storage: one zeroed ``[P, bt, ...]`` leaf per
    leaf of the model's one-block decode cache (``[1, bt, H, D]`` K/V,
    ``[1, bt, H]`` int8 scales), as JAX shapes its pool from a ``[1,
    block]`` cache."""
    one = model.new_cache(1, int(block_tokens))

    def pages(t):
        return None if t is None else t.new_zeros(
            (int(pool_blocks),) + tuple(t.shape[1:]))

    return PagedCache([PagedLayer(pages(layer.k), pages(layer.v),
                                  pages(layer.k_scale), pages(layer.v_scale))
                       for layer in one.layers])


@torch.no_grad()
def paged_forward(model, pool, token_ids, tables, row_start: int,
                  pad_lens=None):
    """One batch-1 model call over the pool (the JAX package's
    ``_paged_prefill_fn`` / ``_paged_decode_fns`` bodies): feed
    ``token_ids`` at row-local positions ``row_start ..`` through the
    ``[1, NB]`` table, writing their K/V into the row's pages in place.
    ``token_ids``: a list, or a device tensor (no host sync).
    Returns the last position's f32 logits ``[1, V]``."""
    dev = model.device
    if isinstance(token_ids, torch.Tensor):
        x = token_ids.to(device=dev, dtype=torch.long).view(1, -1)
    else:
        x = torch.as_tensor(list(token_ids), dtype=torch.long,
                            device=dev)[None, :]
    rs = torch.tensor([int(row_start)], dtype=torch.int32, device=dev)
    pads = (torch.zeros((1,), dtype=torch.int32, device=dev)
            if pad_lens is None else pad_lens)
    logits = model(x, cache=pool, prefill=True, block_tables=tables,
                   row_starts=rs, pad_lens=pads)
    return logits[:, -1]
