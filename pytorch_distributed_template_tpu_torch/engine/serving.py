"""Request-level generation and model loading: the plain path of the JAX
package's ``engine/serving.py``.

``GenerationService`` validates and encodes a request (prompt text or ids,
stop tokens), runs ``engine.generate.generate`` for it with the request's
own ``torch.Generator``, and decodes the response. ``load_generation_stack``
turns ``config.resume`` (a params-only serving artifact) into the model on
its device and the run's tokenizer.

With ``serving.prefix_cache`` enabled the service builds the paged KV
block pool (engine/kvcache.py): a batch-1 request without stop tokens
reserves its cached prefix as block-table entries (no device copy),
prefills only the uncached suffix into private pool pages, decodes reading
the pool in place through the paged kernel (B4), and at the end adopts its
written blocks into the radix index. A pool that is not paged, a layout
the pool refuses, or a dry pool serves the request cold, counted under the
JAX package's ``pool_fallback_*`` reasons. ``serving.kv_quant: "int8"``
stores K/V int8 in the pool and in the cold path's cache.

Left to later slices, each refused with a message naming it: speculative
decoding, tensor-parallel serving, and the scatter arm of the prefix cache
(cached blocks copied into a contiguous cache).
"""
from __future__ import annotations

import logging
import threading

import torch

from .. import models  # noqa: F401  (registers the model families)
from .kvcache import PrefixCache
from ..checkpoint import load_serving_meta, restore_serving_params
from ..config.registry import MODELS
from ..data.tokenizer import tokenizer_from_config
from ..utils.util import resolve_device
from .generate import generate, sample_logits

logger = logging.getLogger(__name__)


class GenerationService:
    """The request-level generation entry of the front-ends.

    ``generate`` is serialized with a lock: one device, one decode path at
    a time.
    """

    def __init__(self, config, device=None, use_ema: bool = False,
                 tensor_parallel: int = 0, **kw):
        model, tokenizer = load_generation_stack(
            config, device=device, use_ema=use_ema,
            tensor_parallel=tensor_parallel)
        kw.setdefault("prefix_cache",
                      (config.get("serving") or {}).get("prefix_cache"))
        self._setup(model, tokenizer, **kw)

    @classmethod
    def from_model(cls, model, tokenizer=None, device=None, **kw):
        """A service around an already built model, moved to ``device``
        (CUDA unless the caller asks for another); ``kw`` goes to
        ``_setup`` (``prefix_cache``, and the engine's own options in
        subclasses)."""
        obj = cls.__new__(cls)
        obj._setup(model.to(resolve_device(device)), tokenizer, **kw)
        return obj

    def _setup(self, model, tokenizer=None, prefix_cache=None):
        self.model, self.tokenizer = model.eval(), tokenizer
        self.device = model.device
        self.arch = type(model).__name__
        self.vocab = int(getattr(model, "vocab_size", 0))
        self._lock = threading.Lock()
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

    def prefix_cache_stats(self):
        """Prefix-cache counters + pool occupancy for /metrics, or None
        when no pool is attached."""
        return (self._prefix.stats_snapshot()
                if self._prefix is not None else None)

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
                 speculative: int = 0, stop=None) -> dict:
        """One validated request -> ``{"ids", "text"?, "stop_reason"}``.

        ``stop``: stop ids and/or single-token strings; the stop token is
        left out of the response and reported as ``stop_reason: "stop"``.
        ``seed`` seeds the request's own generator, so the same request
        samples the same tokens."""
        if int(speculative) > 0:
            raise NotImplementedError(
                "speculative decoding is a later slice of the port")
        ids = self.encode_prompt(prompt, prompt_ids)
        stops = self.encode_stop(stop)
        max_new = int(max_new_tokens)
        self._validate_budget(ids, max_new, stops)
        arr = torch.tensor([ids], dtype=torch.long, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        emitted = None
        with self._lock:
            if self._prefix is not None and not stops and max_new >= 1:
                # the paged pool: prefill only the uncached suffix, decode
                # reading the pool in place. None = the pool cannot serve
                # this request (not paged, or dry): the cold path below
                # serves it, counted as a pool fallback
                new_ids = self._generate_prefix_cached(
                    ids, max_new, float(temperature), int(top_k),
                    float(top_p), gen)
                if new_ids is not None:
                    return self._response(new_ids, stops=stops)
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
        return self._response(out[0, len(ids):].tolist(), stops=stops,
                              emitted=emitted)

    @torch.no_grad()
    def _generate_prefix_cached(self, ids, max_new: int, temperature: float,
                                top_k: int, top_p: float, gen):
        """Batch-1 decode through the paged pool (the JAX package's paged
        arm of ``_generate_prefix_cached``): the cached prefix is a
        block-table entry (zero admit copy), the suffix prefills into
        private pages, each step feeds one token at its row-local position
        and reads the pool in place, and the finished request's pages
        adopt into the radix index. Same sampling ops and generator as the
        cold path, so output matches it token for token (float-tolerance
        exact). Returns the new ids, or None when the pool cannot serve
        the request (the scatter arm is a later slice). Caller holds the
        lock."""
        from .kvcache import paged_forward

        pf = self._prefix
        res = pf.paged_prefill(ids, max_new) if pf.paged else None
        if res is None:
            pf.count_batch1(paged=False)
            pf.count_fallback("dry_pool" if pf.paged else "")
            return None
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
        return row

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


def load_generation_stack(config, device=None, use_ema: bool = False,
                          tensor_parallel: int = 0):
    """``(model, tokenizer | None)`` for ``config.resume``, a params-only
    serving artifact, with the weights on ``device`` (CUDA unless asked
    otherwise)."""
    if config.resume is None:
        raise ValueError("generation requires a serving artifact (-r)")
    device = resolve_device(device)
    serving = config.get("serving") or {}
    tp = int(tensor_parallel or 0) or int(serving.get("tensor_parallel")
                                          or 1)
    if tp > 1:
        raise NotImplementedError(
            f"tensor_parallel={tp}: tensor-parallel serving is a later "
            "slice (parallel axes); this slice serves on one device")
    kvq = str(serving.get("kv_quant") or "")
    if kvq:
        # a serving mode (the scales are cache leaves, not params): the
        # serving section switches it on over a full-precision arch
        config["arch"].setdefault("args", {})["kv_quant"] = kvq
    meta = load_serving_meta(config.resume)
    if meta is None:
        raise ValueError(
            f"{config.resume} is not a params-only serving artifact; "
            "training checkpoints are restored by the training slice "
            "(make one with tools/make_serving_artifact.py)")
    if use_ema:
        logger.warning("--ema ignored: %s is a params-only serving "
                       "artifact", config.resume)
    # build on the meta device (no memory), then adopt the restored tensors
    model = config.init_obj("arch", MODELS, device="meta")
    state = restore_serving_params(config.resume, device)
    want = {k: p.dtype for k, p in model.state_dict().items()}
    missing = sorted(set(want) - set(state))
    unexpected = sorted(set(state) - set(want))
    if missing or unexpected:
        raise ValueError(f"artifact {config.resume} does not match "
                         f"{config['arch']['type']}: missing {missing[:5]}, "
                         f"unexpected {unexpected[:5]}")
    model.load_state_dict(
        {k: t.to(device=device, dtype=want[k]) for k, t in state.items()},
        assign=True)
    return model.eval(), tokenizer_from_config(config)
