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

- **Page shipping** (disaggregated prefill/decode): ``export_pages``
  gathers the cached full-block chain of a prompt (refs held across the
  gather), ``serialize_pages`` writes it in the JAX package's
  ``PDTPAGES1`` wire format (the magic, a big-endian u32 header length, the
  header JSON, then each leaf's raw bytes in sorted path order, trimmed to
  ``n_blocks``; leaf paths are JAX's flax cache paths,
  ``models/convert.py::pool_leaf_path``; bf16 leaves travel as their raw
  bytes under ``"dtype": "bfloat16"``), and ``import_pages`` lands a chain
  as private pages (never evictable) with one host-to-device copy before
  the radix insert makes them visible. Payloads cross both ways between
  this package and the JAX one.
- **Spill tiers** (``SpillTier``): with ``host_spill_blocks`` (and a disk
  directory) eviction DEMOTES a page's bytes, sha256-checksummed, to a
  bounded host dict whose LRU overflow goes to disk; a radix miss the tier
  holds PROMOTES the chain back (checksum-verified, landed like an import,
  then adopted). A failed checksum drops the entry and the blocks recompute
  cold. Faults ``slow_spill``/``corrupt_spill``/``tier_exhaust``
  (``resilience/faults.py::on_tier_event``) and ``corrupt_page``
  (``on_page_adopt``) act here as in the JAX package.

Ordering on the card: every pool read and write of an engine is issued
under its service lock on the device's default stream, and so are the
export's gather, the demote's read and the import's and promote's copies.
Stream order therefore puts an export after the engine's writes to the
pages it reads, and an import's copy before any later model call that reads
the pages the radix insert made visible. The host copies (``.cpu()``)
synchronise.

Left to later slices: the scatter arm of the continuous engine (a shared
non-paged cache with per-slot rotation; ROADMAP A3a.1's other half), and
spill and shipping under tensor parallelism (each rank would send its
KV-head slice over the rank protocol; A3a.4's TP remainder, refused by
name).
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import struct
import threading
import time

import numpy as np
import torch

from ..models.convert import pool_leaves
from ..models.llama import SCRATCH_BLOCK, PagedCache, PagedLayer
from ..parallel.tp import model_geometry, tp_degree
from ..resilience import faults

logger = logging.getLogger(__name__)

#: wire magic of serialized page payloads (the JAX package's): a receiver
#: refuses a foreign format with one 10-byte read
PAGE_MAGIC = b"PDTPAGES1\n"

#: the pool dtypes' names on the wire (numpy's, as the JAX package writes
#: them)
_WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}
_DTYPE_NAMES = {v: k for k, v in _WIRE_DTYPES.items()}

TP_LATER = ("KV page shipping and spill under tensor parallelism (each "
             "rank sending its KV-head slice over the rank protocol) are "
             "A3a.4's TP remainder, a later slice of the port")


def _as_tensor(leaf) -> torch.Tensor:
    """A payload leaf (a torch tensor, or a numpy array as the JAX package
    gives them; bf16 arrays come as their raw 16-bit words) -> tensor."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.ascontiguousarray(np.asarray(leaf))
    if not arr.flags.writeable:
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _leaf_blob(leaf, n: int):
    """The first ``n`` pages of one leaf -> ``(shape, dtype name, raw
    bytes)`` on the host, C order, native byte order."""
    t = _as_tensor(leaf)[:n].detach().to("cpu").contiguous()
    if t.dtype not in _DTYPE_NAMES:
        raise ValueError(f"no wire name for page dtype {t.dtype}")
    raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return list(t.shape), _DTYPE_NAMES[t.dtype], raw


def _tensor_from_bytes(raw, dtype: torch.dtype, shape) -> torch.Tensor:
    """Raw native-order bytes -> a CPU tensor of ``dtype`` and ``shape``
    (one copy, so the tensor owns writable memory)."""
    if not len(raw):
        return torch.empty(tuple(shape), dtype=dtype)
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(
        dtype).reshape(tuple(shape))


def serialize_pages(payload: dict) -> bytes:
    """Page payload (``PrefixCache.export_pages``) -> self-contained bytes,
    the JAX package's format byte for byte: magic + big-endian u32 header
    length + header JSON + each leaf's raw bytes in sorted path order,
    every leaf trimmed to ``n_blocks`` pages."""
    leaves = payload["leaves"]
    nb = int(payload["n_blocks"])
    header = {
        "version": int(payload.get("version", 1)),
        "block_tokens": int(payload["block_tokens"]),
        "n_blocks": nb,
        "token_ids": [int(t) for t in payload["token_ids"]],
        "tp_geometry": dict(payload.get("tp_geometry") or {}),
        "leaves": [],
    }
    blobs = []
    for ps in sorted(leaves):
        shape, dtype, raw = _leaf_blob(leaves[ps], nb)
        header["leaves"].append({"path": ps, "shape": shape,
                                 "dtype": dtype})
        blobs.append(raw)
    hj = json.dumps(header).encode("utf-8")
    return PAGE_MAGIC + struct.pack(">I", len(hj)) + hj + b"".join(blobs)


def deserialize_pages(data: bytes) -> dict:
    """Inverse of :func:`serialize_pages` (leaves as CPU tensors); raises
    ``ValueError`` on a foreign or torn payload (the server answers 400)."""
    data = bytes(data)
    if not data.startswith(PAGE_MAGIC):
        raise ValueError("not a serialized page payload (bad magic)")
    off = len(PAGE_MAGIC)
    if len(data) < off + 4:
        raise ValueError("truncated page payload (no header length)")
    (hlen,) = struct.unpack(">I", data[off:off + 4])
    off += 4
    try:
        header = json.loads(data[off:off + hlen].decode("utf-8"))
        meta = {"version": int(header.get("version", 1)),
                "block_tokens": int(header["block_tokens"]),
                "n_blocks": int(header["n_blocks"]),
                "token_ids": [int(t) for t in header["token_ids"]],
                "tp_geometry": dict(header.get("tp_geometry") or {})}
        specs = [(str(s["path"]), tuple(int(d) for d in s["shape"]),
                  str(s["dtype"])) for s in header.get("leaves", ())]
    except (UnicodeDecodeError, ValueError, KeyError, TypeError,
            AttributeError) as e:
        raise ValueError(f"bad page payload header: {e}") from e
    off += hlen
    view = memoryview(data)
    leaves = {}
    for path, shape, name in specs:
        if name not in _WIRE_DTYPES:
            raise ValueError(f"page payload leaf {path!r}: unknown dtype "
                             f"{name!r}")
        dtype = _WIRE_DTYPES[name]
        n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        if off + n > len(data):
            raise ValueError("truncated page payload (leaf bytes)")
        leaves[path] = _tensor_from_bytes(view[off:off + n], dtype, shape)
        off += n
    return dict(meta, leaves=leaves)


def ship_pages(src: "PrefixCache", dst: "PrefixCache", ids) -> dict:
    """Move the cached block chain of ``ids`` from one pool to another in
    this process: pools on one device copy device to device, others
    through the host, byte-identical to the serialized arm. Returns the
    import receipt (:meth:`PrefixCache.import_pages`)."""
    device = src.device == dst.device
    payload = src.export_pages(ids, device=device)
    if payload is None:
        return {"imported_blocks": 0, "cached_tokens": 0, "bytes": 0}
    return dst.import_pages(payload)


def empty_payload(pool: "PrefixCache") -> dict:
    """The payload of a prompt with no full block to ship."""
    return {"version": 1, "block_tokens": pool.block, "n_blocks": 0,
            "token_ids": [], "tp_geometry": {"tp": pool.tp}, "leaves": {}}


def page_origin_flags(nodes) -> dict:
    """The ``origin`` tags of the radix nodes a request consumed, as flags
    (the JAX package's): locally captured pages (``capture``) add none; an
    adoption, a tier promote, a peer pull or a shipped import each set
    theirs."""
    flags: dict = {}
    for n in nodes or ():
        o = n.get("origin")
        if o in ("adopt", "promote", "pull", "ship"):
            flags[o] = True
    return flags


class SpillTier:
    """Bounded demote-on-evict store under the device pool (the JAX
    package's ``SpillTier``).

    One entry per evicted pool block, keyed by the full token prefix up to
    and including that block, holding the block's raw leaf bytes and a
    sha256 recorded at demote time. A host dict bounded at ``host_blocks``
    entries whose LRU overflow goes to a disk directory (bounded at
    ``disk_blocks`` files) when one is configured, else is dropped. Every
    read verifies the checksum: a failed read removes the entry and reads
    as a miss, so a corrupt or torn page costs a cold recompute, never a
    wrong token. ``full_until`` is the ``tier_exhaust`` fault's window:
    until then :meth:`put` refuses.

    Thread-safety: one internal lock; entries are immutable after put."""

    def __init__(self, host_blocks: int = 0, disk_dir=None,
                 disk_blocks: int = 0):
        self.host_blocks = max(int(host_blocks), 0)
        self.disk_dir = str(disk_dir) if disk_dir else None
        self.disk_blocks = (max(int(disk_blocks), 0) if self.disk_dir
                            else 0)
        if self.disk_dir:
            os.makedirs(self.disk_dir, exist_ok=True)
        self._host: dict = {}       # key -> entry (insertion order = LRU)
        self._disk: dict = {}       # key -> {"path", "sha", "nbytes"}
        self._seq = 0
        self._lock = threading.Lock()
        self.full_until = 0.0
        self.disk_hits = 0          # reads that verified from the disk tier

    @property
    def enabled(self) -> bool:
        return self.host_blocks > 0 or self.disk_blocks > 0

    @staticmethod
    def digest(leaves: dict) -> str:
        """sha256 over the leaf bytes concatenated in sorted path order:
        the one checksum formula (demote and verify share it)."""
        h = hashlib.sha256()
        for ps in sorted(leaves):
            h.update(leaves[ps])
        return h.hexdigest()

    def occupancy(self) -> dict:
        with self._lock:
            host_bytes = sum(e["nbytes"] for e in self._host.values())
            disk_bytes = sum(e["nbytes"] for e in self._disk.values())
            return {"tier_host_blocks": len(self._host),
                    "tier_host_bytes": int(host_bytes),
                    "tier_disk_blocks": len(self._disk),
                    "tier_disk_bytes": int(disk_bytes)}

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._host or key in self._disk

    def put(self, key, leaves: dict, sha: str):
        """Store one demoted block's bytes: ``"host"``, or None when the
        tier is off or inside a ``tier_exhaust`` window (the caller counts
        a destroy-on-evict). Host overflow moves the LRU host entry to
        disk, or drops it without a disk tier."""
        if not self.enabled or time.monotonic() < self.full_until:
            return None
        nbytes = sum(len(b) for b in leaves.values())
        with self._lock:
            self._host.pop(key, None)       # a re-demote refreshes LRU
            self._disk.pop(key, None)
            self._host[key] = {"leaves": dict(leaves), "sha": sha,
                               "nbytes": int(nbytes)}
            while len(self._host) > self.host_blocks:
                old_key = next(iter(self._host))
                self._spill_to_disk_locked(old_key,
                                           self._host.pop(old_key))
        return "host"

    def _spill_to_disk_locked(self, key, entry) -> None:
        """Move one host entry to the disk tier (caller holds the lock);
        without a disk tier, or on a failed write, the entry is dropped:
        the eviction path never raises."""
        if not self.disk_blocks:
            return
        self._seq += 1
        path = os.path.join(self.disk_dir,
                            f"{entry['sha'][:12]}-{self._seq}.kvblk")
        try:
            with open(path, "wb") as f:
                for ps in sorted(entry["leaves"]):
                    blob = entry["leaves"][ps]
                    f.write(struct.pack(">I", len(ps)))
                    f.write(ps.encode("utf-8"))
                    f.write(struct.pack(">Q", len(blob)))
                    f.write(blob)
        except OSError:
            return
        self._disk[key] = {"path": path, "sha": entry["sha"],
                           "nbytes": entry["nbytes"]}
        while len(self._disk) > self.disk_blocks:
            old = self._disk.pop(next(iter(self._disk)))
            try:
                os.unlink(old["path"])
            except OSError:
                pass

    @staticmethod
    def _read_disk(path) -> dict:
        leaves = {}
        with open(path, "rb") as f:
            while True:
                head = f.read(4)
                if not head:
                    break
                (n,) = struct.unpack(">I", head)
                ps = f.read(n).decode("utf-8")
                (m,) = struct.unpack(">Q", f.read(8))
                leaves[ps] = f.read(m)
        return leaves

    def get(self, key):
        """Checksum-verified read -> ``(leaf bytes, "verified")`` or
        ``(None, "miss" | "corrupt")``; a corrupt entry is removed."""
        with self._lock:
            entry = self._host.get(key)
            disk = None if entry is not None else self._disk.get(key)
        if entry is not None:
            leaves, sha = entry["leaves"], entry["sha"]
        elif disk is not None:
            try:
                leaves = self._read_disk(disk["path"])
            except Exception:  # noqa: BLE001 — any parse failure of a
                leaves = {}    # torn file is the corruption the checksum
            sha = disk["sha"]  # covers: read as corrupt, never raise
        else:
            return None, "miss"
        if not leaves or self.digest(leaves) != sha:
            self.drop(key)
            return None, "corrupt"
        with self._lock:
            if key in self._host:
                self._host[key] = self._host.pop(key)   # LRU touch
            if entry is None:
                self.disk_hits += 1
        return leaves, "verified"

    def drop(self, key) -> None:
        with self._lock:
            self._host.pop(key, None)
            disk = self._disk.pop(key, None)
        if disk is not None:
            try:
                os.unlink(disk["path"])
            except OSError:
                pass

    def corrupt_latest(self) -> bool:
        """The ``corrupt_spill`` fault's effect: flip one byte of the most
        recently demoted host entry after its checksum was recorded."""
        with self._lock:
            if not self._host:
                return False
            entry = self._host[next(reversed(self._host))]
            ps = sorted(entry["leaves"])[0]
            blob = bytearray(entry["leaves"][ps])
            if not blob:
                return False
            blob[0] ^= 0xFF
            entry["leaves"][ps] = bytes(blob)
            return True


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
                    # origin: the scatter arm's capture wrote this page
                    nxt = {"children": {}, "block": bid, "parent": node,
                           "chunk": chunk, "refs": 0, "last_use": now,
                           "origin": "capture"}
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
        evicted = self.evict_lru_path()
        return None if evicted is None else evicted[0]

    def evict_lru_path(self):
        """Like :meth:`evict_lru`, but ``(block_id, token_path)``: the full
        id prefix up to and including the evicted block, the spill tier's
        key (rebuilt from the chunks up the parent chain)."""
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
        chunks, node = [], best
        while node is not None and node is not self.root:
            chunks.append(node["chunk"])
            node = node["parent"]
        path = tuple(i for chunk in reversed(chunks) for i in chunk)
        del best["parent"]["children"][best["chunk"]]
        best["parent"] = None
        self.nodes -= 1
        return best["block"], path


class PrefixCache:
    """Radix index + the device block pool + the paged plan bookkeeping.

    Thread-safety: host bookkeeping (index, free list, stats) is guarded
    by a lock; device work is issued by the caller's single scheduler
    thread (or under the batch-1 service's lock), exports and imports
    under the same service lock (module docstring: ordering)."""

    def __init__(self, model, block_tokens: int = 32, pool_blocks: int = 256,
                 eviction: str = "lru", paged: bool = True,
                 ring_slack_tokens: int = 512, host_spill_blocks: int = 0,
                 disk_spill_dir=None, disk_spill_blocks: int = 0):
        spill = int(host_spill_blocks) > 0 or bool(
            disk_spill_dir and int(disk_spill_blocks) > 0)
        if spill and tp_degree(model) > 1:
            raise NotImplementedError(TP_LATER)
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
            # page shipping: blocks exported / imported and their bytes;
            # an import also counts into warm_admit_copy_bytes (the one
            # device copy a decode pool pays), so there the two are equal
            "pages_exported": 0,
            "pages_imported": 0,
            "page_ship_out_bytes": 0,
            "page_ship_in_bytes": 0,
            "page_ship_dropped": 0,
            # the spill tiers: demote-on-evict / promote-on-hit traffic,
            # checksum verdicts, and the destroy-on-evict fallbacks
            "tier_demoted_blocks": 0,
            "tier_demote_bytes": 0,
            "tier_promoted_blocks": 0,
            "tier_promote_bytes": 0,
            "tier_checksum_failures": 0,
            "tier_exhaust_drops": 0,
            "tier_demote_errors": 0,
        }
        # the corrupt_page fault: a block marked at adoption, overwritten
        # at the pool's next read entry (_apply_pending_corruption)
        self._corrupt_block = None
        self.spill = (SpillTier(host_blocks=int(host_spill_blocks),
                                disk_dir=disk_spill_dir,
                                disk_blocks=int(disk_spill_blocks))
                      if spill else None)
        # host seconds of the demotes and promotes (device copies and
        # host work together), for their cost per block
        self.tier_seconds = {"demote": 0.0, "promote": 0.0}
        # origin flags of the last scatter-arm hit (warm_prefill)
        self.last_warm_flags: dict = {}
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
        # the pool's tensors under their JAX cache paths (the Llama
        # family's layers_i/self_attn/..., the GPT-2 family's h_i/attn/...)
        self.leaves = pool_leaves(
            self.pool, "layers" if hasattr(model, "layers") else "h")
        self.device = next(iter(self.leaves.values())).device
        self.page_bytes = int(sum(t[0].numel() * t.element_size()
                                  for t in self.leaves.values()))

    # ---- host bookkeeping -------------------------------------------------

    def used_blocks(self) -> int:
        return self.pool_blocks - 1 - len(self._free)

    def _alloc(self, evicted: list):
        """One free block id, evicting the LRU unreferenced leaf when the
        free list is empty (its ``(block, path)`` appended to ``evicted``
        for the caller to demote); None when everything is pinned (caller
        holds the lock)."""
        if self._free:
            return self._free.pop()
        taken = self.index.evict_lru_path()
        if taken is None:
            self.stats["prefix_dropped_inserts"] += 1
            return None
        self.stats["prefix_evictions"] += 1
        evicted.append(taken)
        return taken[0]

    # ---- the spill tiers --------------------------------------------------

    def _host_pages(self, block_ids) -> dict:
        """The pages ``block_ids`` of every leaf copied to the host in ONE
        device-to-host copy: ``{path: CPU tensor [n, ...]}``."""
        idx = torch.as_tensor(list(block_ids), dtype=torch.long,
                              device=self.device)
        paths = sorted(self.leaves)
        parts = [self.leaves[ps].index_select(0, idx) for ps in paths]
        flat = torch.cat([p.reshape(-1).view(torch.uint8)
                          for p in parts]).cpu()
        out, off = {}, 0
        for ps, p in zip(paths, parts):
            n = p.numel() * p.element_size()
            out[ps] = flat[off:off + n].view(p.dtype).reshape(p.shape)
            off += n
        return out

    def _write_pages(self, block_ids, content: dict) -> None:
        """Write ``content`` (``{path: [n, ...]}`` host tensors or arrays,
        n = len(block_ids)) into the pages ``block_ids`` of every leaf: ONE
        host-to-device copy, then an in-place index copy per leaf, all on
        the default stream (so before any model call issued later)."""
        paths = sorted(self.leaves)
        host = [_as_tensor(content[ps]).to(self.leaves[ps].dtype)
                .contiguous() for ps in paths]
        flat = torch.cat([h.reshape(-1).view(torch.uint8) for h in host])
        flat = flat.to(self.device)
        idx = torch.as_tensor(list(block_ids), dtype=torch.long,
                              device=self.device)
        off = 0
        for ps, h in zip(paths, host):
            n = h.numel() * h.element_size()
            self.leaves[ps].index_copy_(
                0, idx, flat[off:off + n].view(h.dtype).reshape(h.shape))
            off += n

    def _demote_blocks(self, evicted: list) -> None:
        """Move evicted blocks' bytes into the spill tier, in eviction order
        (caller holds the lock; ``evicted``: ``(block, path)`` pairs, path
        the full token prefix up to and including the block, the key a
        later promotion matches). The read is ONE device-to-host copy of
        all of them before any can be rewritten. Every failure degrades to
        destroy-on-evict, counted, never raised."""
        if not evicted or self.spill is None:
            return
        t0 = time.perf_counter()
        try:
            host = self._host_pages([bid for bid, _ in evicted])
        except Exception:  # noqa: BLE001 — the eviction path never raises
            self.stats["tier_demote_errors"] += len(evicted)
            return
        for i, (_, path) in enumerate(evicted):
            fired = faults.on_tier_event()
            if fired is not None and fired.get("exhaust") is not None:
                self.spill.full_until = (time.monotonic()
                                         + fired["exhaust"].duration_s)
                logger.warning("fault tier_exhaust: spill tier reads full "
                               "for %.2fs", fired["exhaust"].duration_s)
            leaves = {ps: t[i].reshape(-1).view(torch.uint8).numpy()
                      .tobytes() for ps, t in host.items()}
            sha = SpillTier.digest(leaves)
            if self.spill.put(path, leaves, sha) is None:
                self.stats["tier_exhaust_drops"] += 1
                continue
            self.stats["tier_demoted_blocks"] += 1
            self.stats["tier_demote_bytes"] += sum(len(b)
                                                   for b in leaves.values())
            if fired is not None and fired.get("corrupt") is not None:
                if self.spill.corrupt_latest():
                    logger.warning("fault corrupt_spill: flipped a byte of "
                                   "the just-demoted spill entry")
        self.tier_seconds["demote"] += time.perf_counter() - t0

    def promote_spilled(self, ids) -> int:
        """Extend the radix with spilled blocks of ``ids``: walk the tier
        past the deepest resident block, checksum-verify each entry, land
        the verified chain as private pages (one host-to-device copy), then
        adopt them (origin ``promote``). Returns the blocks promoted (0:
        nothing spilled, no tier, or a pool too dry to land them). A
        checksum failure counts ``tier_checksum_failures``, drops the entry
        and stops the walk: everything past it recomputes cold."""
        if self.spill is None:
            return 0
        ids = [int(t) for t in ids]
        nfull = len(ids) // self.block
        with self._lock:
            _, have = self.index.match(ids)
        start = len(have)
        if start >= nfull:
            return 0
        # the common case (nothing spilled for this prompt) stays a dict
        # lookup: no fault hook, no allocation
        if tuple(ids[:(start + 1) * self.block]) not in self.spill:
            return 0
        t0 = time.perf_counter()
        fired = faults.on_tier_event()
        if fired is not None:
            if fired.get("exhaust") is not None:
                self.spill.full_until = (time.monotonic()
                                         + fired["exhaust"].duration_s)
            if fired.get("corrupt") is not None:
                self.spill.corrupt_latest()
        chain = []                  # [(block index, {path: tensor})]
        for i in range(start, nfull):
            key = tuple(ids[:(i + 1) * self.block])
            blob, verdict = self.spill.get(key)
            if blob is None:
                if verdict == "corrupt":
                    with self._lock:
                        self.stats["tier_checksum_failures"] += 1
                    logger.warning("spill tier checksum failure at block "
                                   "%d: entry dropped, recomputing cold", i)
                break
            content = {}
            for ps, leaf in self.leaves.items():
                raw = blob.get(ps)
                shape = tuple(leaf.shape[1:])
                n = int(np.prod(shape)) * leaf.element_size()
                if raw is None or len(raw) != n:
                    content = None      # geometry changed under the tier
                    break
                content[ps] = _tensor_from_bytes(raw, leaf.dtype, shape)
            if content is None:
                self.spill.drop(key)
                break
            chain.append((i, content))
        if not chain:
            return 0
        priv = self.alloc_chain(len(chain))
        if priv is None:
            return 0                # dry pool: the promotion waits
        self._write_pages(priv, {ps: torch.stack([c[ps] for _, c in chain])
                                 for ps in self.leaves})
        owned = {i: bid for (i, _), bid in zip(chain, priv)}
        adopted, _ = self.adopt(ids[:nfull * self.block], owned,
                                origin="promote")
        taken = set(adopted)
        self.free_blocks([b for b in priv if b not in taken])
        # adopted entries leave the tier; entries the walk never reached
        # (a concurrent eviction broke the resident prefix) keep theirs
        for i, _ in chain:
            if owned[i] in taken:
                self.spill.drop(tuple(ids[:(i + 1) * self.block]))
        n = len(adopted)
        with self._lock:
            self.stats["tier_promoted_blocks"] += n
            self.stats["tier_promote_bytes"] += n * self.page_bytes
            self.tier_seconds["promote"] += time.perf_counter() - t0
        return n

    def lookup(self, ids, record: bool = True, promote: bool = True):
        """Longest cached, fully-blocked, PROPER prefix of ``ids`` ->
        ``(nodes, block_ids, cached_tokens)`` with refs acquired (callers
        ``release(nodes)``). The prompt's final token is never served
        from cache, so ``cached_tokens <= len(ids) - 1``. ``record=False``
        (a deferred request retrying) skips the hit/lookup counters.
        ``promote`` first promotes a spilled extension of the match (the
        continuous engine promotes at its tick start instead)."""
        if promote and self.spill is not None:
            self.promote_spilled(ids)
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
            evicted = []
            _, blocks, start = self.index.insert(
                ids, lambda: self._alloc(evicted))
            # the evicted pages are read before the capture writes them
            self._demote_blocks(evicted)
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
            got, evicted = [], []
            for _ in range(int(n)):
                bid = self._alloc(evicted)
                if bid is None:
                    self._free.extend(got)
                    break
                got.append(bid)
            # the evicted pages are read before anyone can write them
            self._demote_blocks(evicted)
            if len(got) < int(n):
                return None
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

    def adopt(self, token_ids, owned: dict, acquire: bool = False,
              origin: str = "adopt"):
        """ZERO-COPY radix insert: hand privately written pages to the
        index. ``owned`` maps full-block INDEX of ``token_ids`` -> the
        private page holding that block. The walk creates missing nodes
        where a page is owned and stops at a missing node it cannot
        supply; a node that already exists leaves the private duplicate
        private. ``origin`` tags the created nodes (``adopt``, ``ship``,
        ``pull``, ``promote``; :func:`page_origin_flags`). Returns
        ``(adopted_ids, nodes)`` (``nodes``: the created nodes, ref-pinned
        when ``acquire``)."""
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
                           "refs": 0, "last_use": now,
                           "origin": str(origin)}
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
            # the corrupt_page fault marks the first adopted block; the
            # overwrite waits for the pool's next read entry
            if adopted and faults.on_page_adopt() is not None:
                self._corrupt_block = int(adopted[0])
            return adopted, nodes

    # ---- page shipping ----------------------------------------------------

    def export_pages(self, ids, device: bool = False):
        """The cached full-block chain of ``ids`` -> a ship payload (None
        when not one full block is pooled): ``leaves`` ``{path: [n_blocks,
        ...]}``, host tensors, or device tensors with ``device=True`` (the
        in-process arm, :func:`ship_pages`). Refs pin the chain across the
        gather (no eviction, no demote); the caller holds the service lock,
        so the gather follows the engine's writes in stream order.
        ``token_ids`` covers exactly the exported blocks (no proper-prefix
        cap: the receiver's own lookup applies it)."""
        if self.tp > 1:
            raise NotImplementedError(TP_LATER)
        ids = [int(t) for t in ids]
        with self._lock:
            nodes, blocks = self.index.match(ids)
            if not blocks:
                return None
            self.index.acquire(nodes)
        try:
            nb = len(blocks)
            if device:
                idx = torch.as_tensor(blocks, dtype=torch.long,
                                      device=self.device)
                leaves = {ps: t.index_select(0, idx)
                          for ps, t in self.leaves.items()}
            else:
                leaves = self._host_pages(blocks)
        finally:
            self.release(nodes)
        with self._lock:
            self.stats["pages_exported"] += nb
            self.stats["page_ship_out_bytes"] += nb * self.page_bytes
        return {"version": 1, "block_tokens": self.block, "n_blocks": nb,
                "token_ids": ids[:nb * self.block],
                "tp_geometry": {"tp": self.tp}, "leaves": leaves}

    def import_pages(self, payload: dict, origin: str = "ship") -> dict:
        """Adopt a shipped page chain into this pool. Blocks the pool holds
        already are skipped; the rest land as PRIVATE pages (never
        evictable), get their content in one host-to-device copy, and only
        then adopt into the radix (origin ``ship``, or ``pull`` for a peer
        pull): a request admitted later reads whole pages. Returns
        ``{"imported_blocks", "cached_tokens", "bytes"}`` (+ ``"dropped"``
        when the pool cannot supply the chain now: the request then
        prefills cold). Raises ``ValueError`` on a payload whose geometry
        cannot land here (block size, a missing leaf, a leaf shape)."""
        if self.tp > 1:
            raise NotImplementedError(TP_LATER)
        if int(payload.get("block_tokens", 0)) != self.block:
            raise ValueError(
                f"page import: block_tokens {payload.get('block_tokens')} "
                f"!= pool's {self.block}")
        leaves_in = payload.get("leaves") or {}
        for ps, leaf in self.leaves.items():
            src = leaves_in.get(ps)
            if src is None:
                raise ValueError(f"page import: payload missing leaf "
                                 f"{ps!r}")
            if tuple(src.shape[1:]) != tuple(leaf.shape[1:]):
                raise ValueError(
                    f"page import: leaf {ps!r} shape {tuple(src.shape[1:])} "
                    f"!= pool's {tuple(leaf.shape[1:])}")
        ids = [int(t) for t in payload["token_ids"]]
        nb = min(int(payload["n_blocks"]),
                 *(int(leaves_in[ps].shape[0]) for ps in self.leaves))
        nb = min(nb, len(ids) // self.block)
        if nb <= 0:
            return {"imported_blocks": 0, "cached_tokens": 0, "bytes": 0}
        with self._lock:
            _, have = self.index.match(ids)
            have_n = min(len(have), nb)
        if have_n == nb:
            return {"imported_blocks": 0, "cached_tokens": nb * self.block,
                    "bytes": 0}
        priv = self.alloc_chain(nb - have_n)
        if priv is None:
            with self._lock:
                self.stats["page_ship_dropped"] += 1
            return {"imported_blocks": 0, "cached_tokens": 0, "bytes": 0,
                    "dropped": True}
        try:
            self._write_pages(priv, {ps: leaves_in[ps][have_n:nb]
                                     for ps in self.leaves})
        except Exception:
            self.free_blocks(priv)
            raise
        owned = {have_n + i: bid for i, bid in enumerate(priv)}
        adopted, _ = self.adopt(ids[:nb * self.block], owned, origin=origin)
        taken = set(adopted)
        self.free_blocks([b for b in priv if b not in taken])
        n = len(adopted)
        nbytes = n * self.page_bytes
        with self._lock:
            self.stats["pages_imported"] += n
            self.stats["page_ship_in_bytes"] += nbytes
            self.stats["warm_admit_copy_bytes"] += nbytes
        return {"imported_blocks": n,
                "cached_tokens": (have_n + n) * self.block, "bytes": nbytes}

    def apply_pending_corruption(self) -> None:
        """Apply a deferred ``corrupt_page`` fault: overwrite the marked
        block with ones in every leaf. Called where the pool is about to be
        read (the batch-1 prefills, the continuous engine's tick start)."""
        with self._lock:
            bid, self._corrupt_block = self._corrupt_block, None
        if bid is None:
            return
        with torch.no_grad():
            for t in self.leaves.values():
                t[bid] = 1
        logger.warning("fault corrupt_page: overwrote pool block %d with a "
                       "constant pattern", bid)

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
        # the spill tiers' occupancy: neither resident nor referenced
        out["tier_enabled"] = self.spill is not None
        out.update(self.spill.occupancy() if self.spill is not None else
                   {"tier_host_blocks": 0, "tier_host_bytes": 0,
                    "tier_disk_blocks": 0, "tier_disk_bytes": 0})
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
        self.apply_pending_corruption()
        nodes, blocks, c = self.lookup(ids, record=record)
        # the origins of the nodes this request's hit consumed, for its
        # serve-path fingerprint (the caller holds the service lock)
        self.last_warm_flags = page_origin_flags(nodes) if c else {}
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

    def paged_plan(self, ids, budget: int, record: bool = True,
                   promote: bool = True):
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
            nodes, blocks, c = self.lookup(ids, record=record,
                                           promote=promote)
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
        self.apply_pending_corruption()
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
