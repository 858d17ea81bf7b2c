"""Autoregressive generation with a KV cache: the port of the JAX
package's ``engine/generate.py`` (plain, stop-capable and speculative
paths).

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

``pad_lens`` (pad-capable models, the Llama family without a window):
row ``b``'s prompt is left-padded by ``pad_lens[b]`` slots the model
hides, so prompts of different lengths share one batch (the static
micro-batcher, engine/serving.py).

Speculative decoding (:func:`generate_speculative`,
:func:`speculative_from_cache`): batch 1, prompt-lookup drafting (the
latest earlier occurrence of the trailing ``ngram`` tokens proposes the
``draft_len`` tokens that followed it) or an early-exit draft (the
model's first ``draft_layers`` blocks, Llama family), one ``D + 1``-token
verify call per iteration, and a rewind of the cache's ``pos_index``
after a rejection (the rejected rows stay in the cache, invisible, and
are overwritten next). Greedy output equals plain greedy decoding;
sampled output is distribution-exact by rejection sampling against the
filtered target distribution. The token buffer and its writes follow the
JAX loop's, so greedy drafts and model-call counts match JAX's. The loop
runs on the host and reads the accepted count once per verify call.
"""
from __future__ import annotations

import inspect
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


def isin_stops(x, stops):
    """Per-element membership of ``x`` in the id set ``stops`` (``[..., S]``
    padded with -1, which never matches a token id): the JAX package's
    ``_isin``."""
    return (x[..., None] == stops).any(dim=-1)


def sample_rows(logits, temps, top_ks, top_ps, generators):
    """Per-row sampling with per-row (temperature, top_k, top_p): the
    mixed-sampling batch path (the JAX package's ``_sample_rows_traced``).

    Rows with ``temps[b] <= 0`` take the greedy argmax; every other row
    runs exactly :func:`sample_logits`'s ops on its own ``[1, V]`` slice
    with ``generators[b]``, so a row sampled in a batch draws what the
    same request draws served alone. ``temps``/``top_ks``/``top_ps`` and
    ``generators`` are host sequences (``None`` generators for rows that
    need none)."""
    out = torch.argmax(logits, dim=-1)
    for i, temp in enumerate(temps):
        if temp > 0:
            out[i] = sample_logits(logits[i:i + 1], float(temp),
                                   int(top_ks[i]), float(top_ps[i]),
                                   [generators[i]])[0]
    return out


def row_generators(batch: int, device, seed: int = 0):
    """One generator per row, row ``b`` seeded ``seed + b``."""
    return [torch.Generator(device=device).manual_seed(seed + b)
            for b in range(batch)]


def _pad_kw(pad_lens) -> dict:
    return {} if pad_lens is None else {"pad_lens": pad_lens}


def _forward_takes(model, arg: str) -> bool:
    """Whether the model's ``forward`` takes ``arg`` (``pad_lens``: per-row
    left-pad masking; ``exit_layer``: early-exit drafting)."""
    return arg in inspect.signature(type(model).forward).parameters


def _takes_pads(model) -> bool:
    return _forward_takes(model, "pad_lens")


def pad_capable(model) -> bool:
    """The JAX ``_pad_ok``: per-row left-pad masking (the model's forward
    takes ``pad_lens``) over a non-rolling cache (no window)."""
    return _takes_pads(model) and int(getattr(model, "window", 0) or 0) == 0


def _prefill_fresh(model, prompt, total: int, pad_lens=None):
    """Fresh cache for a ``total``-token budget plus the prompt's prefill:
    ``(last-position logits [B, V], cache)``."""
    cache = model.new_cache(prompt.shape[0], total)
    logits = model(prompt, cache=cache, prefill=True, **_pad_kw(pad_lens))
    return logits[:, -1], cache


def _decode_step(model, cache, token, temperature: float, top_k: int,
                 top_p: float, generators, pad_lens=None):
    """Feed one token per row; returns the next token per row."""
    logits = model(token[:, None], cache=cache, **_pad_kw(pad_lens))
    return sample_logits(logits[:, -1], temperature, top_k, top_p,
                         generators)


@torch.inference_mode()
def generate(model, prompt, max_new_tokens: int, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 0.0, generators=None,
             stop_tokens=None, row_budgets=None, pad_id: int = 0,
             return_lengths: bool = False, pad_lens=None):
    """Generate up to ``max_new_tokens`` continuations per prompt row.

    :param model: a decode-capable LM (``new_cache``: the Llama and GPT-2
        families).
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
    :param pad_lens: optional ``[B]`` left-pad lengths (pad-capable models
        only): row ``b``'s prompt is ``prompt[b, pad_lens[b]:]``.
    :returns: ``[B, T0 + max_new_tokens]`` int64 tokens (prompt included,
        left pads included; frozen tail = ``pad_id``), plus the lengths
        when asked.
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
    if pad_lens is not None:
        if not _takes_pads(model):
            raise ValueError(
                f"{type(model).__name__} does not support pad_lens "
                "(mixed-length batching needs per-row pad masking + "
                "shift-invariant positions — the RoPE families)")
        pad_lens = torch.as_tensor(pad_lens, dtype=torch.int32,
                                   device=prompt.device)
    if (stop_tokens is not None or row_budgets is not None
            or return_lengths):
        return _generate_with_stops(
            model, prompt, max_new_tokens, generators, stop_tokens,
            row_budgets, float(temperature), int(top_k), float(top_p),
            int(pad_id), return_lengths, pad_lens)

    last, cache = _prefill_fresh(model, prompt, total, pad_lens)
    token = sample_logits(last, temperature, top_k, top_p, generators)
    out = [prompt, token[:, None]]
    for _ in range(1, max_new_tokens):
        token = _decode_step(model, cache, token, temperature, top_k, top_p,
                             generators, pad_lens)
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
                         return_lengths: bool, pad_lens=None):
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
    last, cache = _prefill_fresh(model, prompt, total, pad_lens)
    tok = sample_logits(last, temperature, top_k, top_p, generators)
    done = is_stop(tok) | (budgets <= 1)
    buf = torch.full((b, total), pad_id, dtype=torch.long, device=device)
    buf[:, :t0] = prompt
    buf[:, t0] = tok
    lengths = torch.ones(b, dtype=torch.long, device=device)
    i = 1
    while i < max_new and not bool(done.all()):
        nxt = _decode_step(model, cache, tok, temperature, top_k, top_p,
                           generators, pad_lens)
        nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
        buf[:, t0 + i] = nxt
        lengths += (~done).long()
        done = done | is_stop(nxt) | (i + 1 >= budgets)
        tok = nxt
        i += 1
    col = torch.arange(total, device=device)[None, :]
    buf = buf.masked_fill(col >= t0 + lengths[:, None], pad_id)
    return (buf, lengths) if return_lengths else buf


def _stop_ids(stop_tokens) -> list:
    flat = [int(t) for t in (stop_tokens or [])]
    if any(t < 0 for t in flat):
        raise ValueError(f"negative stop token in {flat}")
    return flat


def _check_draft_layers(model, draft_layers: int) -> int:
    draft_layers = int(draft_layers)
    if draft_layers:
        if not 0 < draft_layers < int(model.n_layer):
            raise ValueError(
                f"draft_layers must be in (0, n_layer={model.n_layer}) "
                f"(got {draft_layers}) — the early-exit draft needs a "
                "strict prefix of the target's blocks")
        if not _forward_takes(model, "exit_layer"):
            raise ValueError(
                f"{type(model).__name__} has no exit_layer support: the "
                "early-exit draft needs the Llama-family call path")
    return draft_layers


def _spec_stats(iters: int, emitted: int, stopped: bool) -> dict:
    return {"model_calls": int(iters), "tokens_emitted": int(emitted),
            "stopped": bool(stopped),
            # clamped to the tokens returned: the last chunk may commit
            # past the budget
            "tokens_per_call": round(float(emitted) / max(int(iters), 1),
                                     3)}


@torch.inference_mode()
def generate_speculative(model, prompt, max_new_tokens: int,
                         draft_len: int = 4, ngram: int = 2,
                         return_stats: bool = False,
                         temperature: float = 0.0, top_k: int = 0,
                         top_p: float = 0.0, generator=None,
                         pad_to: Optional[int] = None, stop_tokens=None,
                         draft_layers: int = 0):
    """Self-speculative (prompt-lookup) generation for one prompt row (the
    JAX ``generate_speculative``; module docstring).

    :param prompt: ``[1, T0]`` token ids.
    :param generator: the request's ``torch.Generator`` (sampled mode).
    :param pad_to: left-pad the prompt to this length (pad-capable
        models): pad slots are hidden from attention and from the drafter;
        the output keeps the caller's unpadded layout.
    :param stop_tokens: flat stop ids; a stop inside an accepted chunk
        truncates the commit there (the stop token is emitted).
    :param draft_layers: ``> 0`` drafts with the first ``draft_layers``
        blocks instead of n-grams (Llama family).
    :returns: ``[1, T0 + max_new_tokens]`` ids (positions past a stop are
        0), plus ``{"model_calls", "tokens_emitted", "stopped",
        "tokens_per_call"}`` with ``return_stats``.
    """
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=model.device)
    b, t0 = prompt.shape
    if b != 1:
        raise ValueError("speculative decoding supports batch size 1 "
                         f"(got {b}) — the KV cache keeps one position "
                         "counter")
    D, g = int(draft_len), int(ngram)
    draft_layers = _check_draft_layers(model, draft_layers)
    if not draft_layers and t0 < g:
        raise ValueError(f"prompt length {t0} < ngram {g}")
    pad = 0
    if pad_to is not None and int(pad_to) > t0:
        if not _takes_pads(model):
            raise ValueError(f"{type(model).__name__} does not support "
                             "pad_to (needs the pad_lens masking path)")
        pad = int(pad_to) - t0
        prompt = torch.cat([prompt.new_zeros((1, pad)), prompt], dim=1)
        t0 = int(pad_to)
    max_new_tokens = int(max_new_tokens)
    if D < 1:
        raise ValueError("draft_len must be >= 1")
    if max_new_tokens <= 0:
        return (prompt, {}) if return_stats else prompt
    # the loop stops at the budget: slack for the last iteration's <= D
    # overshoot plus its D + 1 written predictions
    L = t0 + max_new_tokens + 2 * (D + 1)
    if L > int(model.max_len):
        raise ValueError(
            f"prompt + max_new_tokens + draft slack = {L} exceeds "
            f"model.max_len = {model.max_len}")
    window = int(getattr(model, "window", 0) or 0)
    if 0 < window <= L:
        raise ValueError(
            f"speculative decoding needs a non-rolling cache: window "
            f"{window} <= prompt + budget + slack {L} would evict rows "
            "that rejection must rewind")
    stops = _stop_ids(stop_tokens)
    pad_lens = (torch.tensor([pad], dtype=torch.int32, device=model.device)
                if pad else None)
    cache = model.new_cache(1, L)
    logits = model(prompt, cache=cache, prefill=True, **_pad_kw(pad_lens))
    toks, n, iters = _spec_loop(
        model, cache, logits[:, -1], prompt[0].tolist(), L, D, g,
        max_new_tokens, float(temperature), int(top_k), float(top_p),
        generator, pad, pad_lens, stops, draft_layers)
    emitted = min(n - t0, max_new_tokens)
    out = torch.tensor([toks[pad:t0 + max_new_tokens]], dtype=torch.long,
                       device=model.device)
    stopped = stop_tokens is not None and emitted < max_new_tokens
    if stopped:
        out[:, (t0 - pad) + emitted:] = 0
    if return_stats:
        return out, _spec_stats(iters, emitted, stopped)
    return out


@torch.inference_mode()
def speculative_from_cache(model, prompt_ids, cache, last_logits,
                           total: int, max_new_tokens: int,
                           draft_len: int = 4, ngram: int = 2,
                           temperature: float = 0.0, top_k: int = 0,
                           top_p: float = 0.0, generator=None,
                           stop_tokens=None, draft_layers: int = 0):
    """Speculative decoding continuing from a prefilled cache (the JAX
    ``speculative_from_cache``, the pool-shared serving arm): ``cache`` of
    length ``total`` with ``pos_index == len(prompt_ids)`` (a prefix
    pool's warm prefill, engine/kvcache.py) and the prompt's last-position
    logits. Same loop as :func:`generate_speculative`; returns ``(out [1,
    T0 + max_new], stats)``."""
    t0 = len(prompt_ids)
    D, g = int(draft_len), int(ngram)
    max_new_tokens = int(max_new_tokens)
    L = int(total)
    if L < t0 + max_new_tokens + 2 * (D + 1):
        raise ValueError(
            f"cache length {L} lacks the spec loop's overshoot slack "
            f"(need >= {t0 + max_new_tokens + 2 * (D + 1)})")
    draft_layers = _check_draft_layers(model, draft_layers)
    if not draft_layers and t0 < g:
        raise ValueError(f"prompt length {t0} < ngram {g}")
    if int(cache.pos_index) != t0:
        raise ValueError(f"cache pos_index {cache.pos_index} != prompt "
                         f"length {t0}")
    stops = _stop_ids(stop_tokens)
    toks, n, iters = _spec_loop(
        model, cache, last_logits, [int(t) for t in prompt_ids], L, D, g,
        max_new_tokens, float(temperature), int(top_k), float(top_p),
        generator, 0, None, stops, draft_layers)
    emitted = min(n - t0, max_new_tokens)
    out = torch.tensor([toks[:t0 + max_new_tokens]], dtype=torch.long,
                       device=model.device)
    stopped = stop_tokens is not None and emitted < max_new_tokens
    if stopped:
        out[:, t0 + emitted:] = 0
    return out, _spec_stats(iters, emitted, stopped)


def _spec_loop(model, cache, last_logits, prompt: list, L: int, D: int,
               g: int, max_new: int, temperature: float, top_k: int,
               top_p: float, generator, pad: int, pad_lens, stops: list,
               draft_layers: int):
    """The speculative loop (the JAX ``_spec_loop`` body) over a cache
    whose ``pos_index`` is ``len(prompt)``: returns ``(token buffer [L],
    committed count n, verify calls)``. Invariant: the token at ``n - 1``
    is committed but not yet in the cache (``pos_index == n - 1``)."""
    greedy = temperature <= 0
    t0 = len(prompt)
    kw = _pad_kw(pad_lens)
    if greedy:
        token0 = int(torch.argmax(last_logits[0]))
    else:
        token0 = int(sample_logits(last_logits.float(), temperature, top_k,
                                   top_p, [generator])[0])
    toks = [0] * L
    toks[:t0] = prompt
    toks[t0] = token0
    n, iters = t0 + 1, 0
    done = token0 in stops
    dev = model.device
    while n - t0 - 1 < max_new and iters < max_new and not done:
        if draft_layers > 0:
            # D greedy early-exit steps over the same cache; the verify
            # pass rewrites those layers' rows from the same tokens
            cur, draft = toks[n - 1], []
            for _ in range(D):
                dl = model(torch.tensor([[cur]], device=dev), cache=cache,
                           exit_layer=draft_layers, **kw)
                cur = int(torch.argmax(dl[0, -1]))
                draft.append(cur)
        else:
            # the latest earlier occurrence of the trailing g-gram whose
            # continuation lies in committed history, pad slots excluded
            key = toks[n - g:n]
            i = -1
            for s in range(n - g - 1, pad - 1, -1):
                if toks[s:s + g] == key:
                    i = s
                    break
            cont = i + g if i >= 0 else n - 1
            draft = toks[cont:cont + D]
        cache.pos_index = n - 1
        chunk = torch.tensor([[toks[n - 1]] + draft], device=dev)
        logits = model(chunk, cache=cache, **kw)[0]          # [D + 1, V]
        if greedy:
            write = torch.argmax(logits, dim=-1).tolist()
            na = 0
            while na < D and draft[na] == write[na]:
                na += 1
        else:
            flogits = filter_logits(logits.float(), temperature, top_k,
                                    top_p)
            probs = torch.softmax(flogits, dim=-1)
            d_idx = torch.tensor(draft, device=dev)
            p_draft = probs[:D].gather(1, d_idx[:, None])[:, 0]
            u = torch.rand(D, generator=generator, device=dev)
            acc = (u < p_draft).tolist()
            na = 0
            while na < D and acc[na]:
                na += 1
            res = flogits[na].clone()
            if na < D:
                res[draft[na]] = float("-inf")
            fresh = int(torch.multinomial(torch.softmax(res, dim=-1)[None],
                                          1, generator=generator)[0, 0])
            write = draft[:na] + [fresh] * (D + 1 - na)
        c = na + 1
        for j in range(na + 1):
            if write[j] in stops:
                c, done = j + 1, True
                break
        toks[n:n + D + 1] = write
        cache.pos_index = n + c - 1
        n += c
        iters += 1
    return toks, n, iters
