"""Request-level generation and model loading: the plain path of the JAX
package's ``engine/serving.py``.

``GenerationService`` validates and encodes a request (prompt text or ids,
stop tokens), runs ``engine.generate.generate`` for it with the request's
own ``torch.Generator``, and decodes the response. ``load_generation_stack``
turns ``config.resume`` (a params-only serving artifact) into the model on
its device and the run's tokenizer.

Left to later slices, each refused with a message naming it: speculative
decoding, tensor-parallel serving, the int8 KV cache and the paged prefix
cache (an enabled ``serving.prefix_cache`` logs one warning and the
service serves cold, as the JAX service does with a pool it cannot build).
"""
from __future__ import annotations

import logging
import threading

import torch

from .. import models  # noqa: F401  (registers the model families)
from ..checkpoint import load_serving_meta, restore_serving_params
from ..config.registry import MODELS
from ..data.tokenizer import tokenizer_from_config
from ..utils.util import resolve_device
from .generate import generate

logger = logging.getLogger(__name__)

_SLICE_PAGED = "slice 2 (continuous engine + paged KV pool, kernel B4)"


class GenerationService:
    """The request-level generation entry of the front-ends.

    ``generate`` is serialized with a lock: one device, one decode path at
    a time.
    """

    def __init__(self, config, device=None, use_ema: bool = False,
                 tensor_parallel: int = 0):
        model, tokenizer = load_generation_stack(
            config, device=device, use_ema=use_ema,
            tensor_parallel=tensor_parallel)
        self._setup(model, tokenizer,
                    prefix_cache=(config.get("serving") or {}).get(
                        "prefix_cache"))

    @classmethod
    def from_model(cls, model, tokenizer=None, device=None,
                   prefix_cache=None):
        """A service around an already built model, moved to ``device``
        (CUDA unless the caller asks for another)."""
        obj = cls.__new__(cls)
        obj._setup(model.to(resolve_device(device)), tokenizer,
                   prefix_cache=prefix_cache)
        return obj

    def _setup(self, model, tokenizer=None, prefix_cache=None):
        self.model, self.tokenizer = model.eval(), tokenizer
        self.device = model.device
        self.vocab = int(getattr(model, "vocab_size", 0))
        if prefix_cache is not None and dict(prefix_cache).get("enabled"):
            logger.warning("prefix cache disabled: the paged prefix pool "
                           "is %s; serving cold", _SLICE_PAGED)
        self._lock = threading.Lock()

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
                "speculative decoding is a later slice (it rides the "
                f"paged pool of {_SLICE_PAGED})")
        ids = self.encode_prompt(prompt, prompt_ids)
        stops = self.encode_stop(stop)
        max_len = int(getattr(self.model, "max_len", 0) or 0)
        if max_len and len(ids) + int(max_new_tokens) > max_len:
            raise ValueError(
                f"prompt ({len(ids)} tokens) + max_new_tokens "
                f"({int(max_new_tokens)}) exceeds model.max_len {max_len}")
        arr = torch.tensor([ids], dtype=torch.long, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        emitted = None
        with self._lock:
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
    if serving.get("kv_quant"):
        raise NotImplementedError(
            f"serving.kv_quant={serving['kv_quant']!r} (int8 KV cache) is "
            f"{_SLICE_PAGED}")
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
