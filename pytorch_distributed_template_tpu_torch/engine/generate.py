"""Autoregressive generation with a KV cache: the port of the JAX
package's ``engine/generate.py`` (plain and stop-capable paths).

Shape of a call: one prefill over the whole prompt on a fresh cache (its
attention runs through the flash kernel), then one single-token decode
step per new token, each writing its K/V row into the cache in place.
PyTorch runs eagerly, so the step loop is a Python loop: the plain path
never waits on the device inside it, and the stop-capable path reads one
flag per step to exit as soon as every row is done.

Sampling: ``temperature <= 0`` is greedy argmax; otherwise top-k then
top-p filtering and a draw from one ``torch.Generator`` per row, so a
row's samples depend on its own generator only. JAX's threefry and
PyTorch's Philox give different numbers from the same seed: sampled
tokens are reproducible within each package, not across them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def filter_logits(logits, temperature: float, top_k: int,
                  top_p: float = 0.0):
    """Temperature/top-k/top-p filtering of ``[B, V]`` logits: filtered
    entries become ``-inf``. Top-p keeps tokens while the probability of
    the strictly higher-ranked ones is below ``top_p`` (the boundary token
    is kept, like HF)."""
    logits = logits / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1) - probs
        keep = cum < top_p
        thresh = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, float("inf"))
                             ).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < thresh, float("-inf"))
    return logits


def sample_logits(logits, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 0.0,
                  generators: Optional[Sequence[torch.Generator]] = None):
    """Token ids ``[B]`` (int64) from ``[B, V]`` logits; row ``b`` draws
    from ``generators[b]``."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    if generators is None:
        return torch.multinomial(probs, 1).squeeze(-1)
    if len(generators) != probs.shape[0]:
        raise ValueError(f"{len(generators)} generators for "
                         f"{probs.shape[0]} rows")
    return torch.cat([torch.multinomial(probs[i:i + 1], 1, generator=g)[0]
                      for i, g in enumerate(generators)])


def row_generators(batch: int, device, seed: int = 0):
    """One generator per row, row ``b`` seeded ``seed + b``."""
    return [torch.Generator(device=device).manual_seed(seed + b)
            for b in range(batch)]


def _prefill_fresh(model, prompt, total: int):
    """Fresh cache for a ``total``-token budget plus the prompt's prefill:
    ``(last-position logits [B, V], cache)``."""
    cache = model.new_cache(prompt.shape[0], total)
    logits = model(prompt, cache=cache, prefill=True)
    return logits[:, -1], cache


def _decode_step(model, cache, token, temperature: float, top_k: int,
                 top_p: float, generators):
    """Feed one token per row; returns the next token per row."""
    logits = model(token[:, None], cache=cache)
    return sample_logits(logits[:, -1], temperature, top_k, top_p,
                         generators)


@torch.inference_mode()
def generate(model, prompt, max_new_tokens: int, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 0.0, generators=None,
             stop_tokens=None, row_budgets=None, pad_id: int = 0,
             return_lengths: bool = False):
    """Generate up to ``max_new_tokens`` continuations per prompt row.

    :param model: a ``LlamaLM`` (decode support).
    :param prompt: ``[B, T0]`` int token ids on the model's device.
    :param generators: one ``torch.Generator`` per row on the model's
        device (default: row ``b`` seeded ``b``); unused when greedy.
    :param stop_tokens: stop ids — one flat list for every row or one list
        per row. A row freezes after emitting a stop token (which is
        emitted); generation ends when every row is done.
    :param row_budgets: optional ``[B]`` per-row budgets
        (<= ``max_new_tokens``); a row past its budget freezes too.
    :param pad_id: id written at frozen positions.
    :param return_lengths: also return the ``[B]`` emitted-token counts
        (stop token included).
    :returns: ``[B, T0 + max_new_tokens]`` int64 tokens (prompt included;
        frozen tail = ``pad_id``), plus the lengths when asked.
    """
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=model.device)
    b, t0 = prompt.shape
    max_new_tokens = int(max_new_tokens)
    if max_new_tokens <= 0:
        lengths = torch.zeros(b, dtype=torch.long, device=prompt.device)
        return (prompt, lengths) if return_lengths else prompt
    total = t0 + max_new_tokens
    if total > model.max_len:
        raise ValueError(
            f"prompt + max_new_tokens = {total} exceeds model.max_len "
            f"= {model.max_len}")
    if generators is None:
        generators = row_generators(b, prompt.device)
    elif len(generators) != b:
        raise ValueError(f"{len(generators)} generators for {b} rows")
    if (stop_tokens is not None or row_budgets is not None
            or return_lengths):
        return _generate_with_stops(
            model, prompt, max_new_tokens, generators, stop_tokens,
            row_budgets, float(temperature), int(top_k), float(top_p),
            int(pad_id), return_lengths)

    last, cache = _prefill_fresh(model, prompt, total)
    token = sample_logits(last, temperature, top_k, top_p, generators)
    out = [prompt, token[:, None]]
    for _ in range(1, max_new_tokens):
        token = _decode_step(model, cache, token, temperature, top_k, top_p,
                             generators)
        out.append(token[:, None])
    return torch.cat(out, dim=1)


def _stop_table(stop_tokens, b: int, device):
    """Ragged stop lists -> a ``[B, S]`` table padded with -1 (ids are
    non-negative, so -1 never matches)."""
    rows = list(stop_tokens or [])
    if not rows:
        return torch.full((b, 1), -1, dtype=torch.long, device=device)
    if not isinstance(rows[0], (list, tuple)):
        rows = [rows] * b
    elif len(rows) != b:
        raise ValueError(f"per-row stop_tokens has {len(rows)} rows for {b}")
    width = max(1, max(len(r) for r in rows))
    table = [[-1] * width for _ in range(b)]
    for i, r in enumerate(rows):
        for j, s in enumerate(r):
            if int(s) < 0:
                raise ValueError(f"negative stop token {s}")
            table[i][j] = int(s)
    return torch.tensor(table, dtype=torch.long, device=device)


def _generate_with_stops(model, prompt, max_new: int, generators,
                         stop_tokens, row_budgets, temperature: float,
                         top_k: int, top_p: float, pad_id: int,
                         return_lengths: bool):
    """The stop-capable loop: exits as soon as every row has emitted a
    stop token or reached its budget; frozen rows emit ``pad_id`` (and
    keep feeding it, their cache writes ignored)."""
    b, t0 = prompt.shape
    device = prompt.device
    stops = _stop_table(stop_tokens, b, device)
    if row_budgets is None:
        budgets = torch.full((b,), max_new, dtype=torch.long, device=device)
    else:
        budgets = torch.as_tensor(row_budgets, dtype=torch.long,
                                  device=device)
        if budgets.shape != (b,):
            raise ValueError(f"row_budgets shape {tuple(budgets.shape)} "
                             f"!= ({b},)")
        if int(budgets.max()) > max_new:
            raise ValueError(f"row budget {int(budgets.max())} exceeds "
                             f"max_new_tokens {max_new}")
        budgets = budgets.clamp(1, max_new)

    def is_stop(tok):
        return (tok[:, None] == stops).any(dim=-1)

    total = t0 + max_new
    last, cache = _prefill_fresh(model, prompt, total)
    tok = sample_logits(last, temperature, top_k, top_p, generators)
    done = is_stop(tok) | (budgets <= 1)
    buf = torch.full((b, total), pad_id, dtype=torch.long, device=device)
    buf[:, :t0] = prompt
    buf[:, t0] = tok
    lengths = torch.ones(b, dtype=torch.long, device=device)
    i = 1
    while i < max_new and not bool(done.all()):
        nxt = _decode_step(model, cache, tok, temperature, top_k, top_p,
                           generators)
        nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
        buf[:, t0 + i] = nxt
        lengths += (~done).long()
        done = done | is_stop(nxt) | (i + 1 >= budgets)
        tok = nxt
        i += 1
    col = torch.arange(total, device=device)[None, :]
    buf = buf.masked_fill(col >= t0 + lengths[:, None], pad_id)
    return (buf, lengths) if return_lengths else buf
