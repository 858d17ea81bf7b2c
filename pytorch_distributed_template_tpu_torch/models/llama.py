"""Llama-family causal LM in PyTorch: RMSNorm + SwiGLU + RoPE + GQA.

Port of ``pytorch_distributed_template_tpu/models/llama.py`` for serving:
the plain forward and the decode forward over a KV cache, registered as
``Llama``, ``Mistral`` and ``TinyLlama`` with the JAX registry's defaults.

- Serving stores the weights in the compute dtype on the model's device
  (``bfloat16: true`` stores bf16). Training builds the model with
  ``param_dtype=torch.float32``: float32 master weights, cast to the
  compute dtype at use (models/layers.py), as flax keeps float32 params
  under ``dtype=bfloat16``. RMSNorm weights stay float32 and normalise in
  float32, like the flax module; logits come back float32.
- RoPE is the HF rotate-half convention (``concat(freqs, freqs)``), so
  state dicts converted from the flax tree (models/convert.py) reproduce
  the JAX logits.
- K/V are projected and cached at ``n_kv_head`` heads. A fresh-cache
  prefill runs attention through the flash kernel (ops/flash.py), which
  reads K/V at that width; decode steps use the grouped GQA read.
- ``window > 0`` (Mistral): sliding-window attention; the decode cache is a
  rolling ring buffer of ``window`` slots once the budget exceeds the
  window.
- Training (no cache): the flash path is differentiable (ops/flash.py:
  B2/B3 on the card, with K/V gradients at ``n_kv_head`` heads, summed
  over each group as ``jnp.repeat``'s VJP sums them); ``remat`` runs each
  block under ``torch.utils.checkpoint``; ``fused_head`` returns
  ``(hidden, head_w [D, V])`` for the chunked loss (engine/losses.py).
- Paged decode (``forward(..., cache=PagedCache, block_tables=...,
  row_starts=...)``): the cache leaves ARE the KV block pool's pages
  ``[P, bt, KVH, D]``; each row's positions are row-local and map to pages
  through its block table (a ring of pages when ``window > 0``), new rows
  are written into their pages in place, and attention reads the pool
  through the paged kernel (B4, ops/flash.py). engine/kvcache.py owns the
  tables.
- ``kv_quant="int8"``: K/V stored int8 with an f32 scale per (token, kv
  head) (models/quant.py). Paged: the call's own tokens round-trip through
  int8 too; contiguous and rolling caches: only history rows do.

Left to later slices, each refused with a message naming it:
sequence-parallel attention (ring, Ulysses), MoE, w8a16 weights, LoRA.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..config.registry import MODELS
from ..ops.attention import (
    grouped_query_attention, multihead_attention, paged_gqa_attention,
)
from ..ops.flash import flash_attention
from .layers import Dense, embed
from .quant import dequantize_kv, quantize_kv

#: reserved pool page: pad lanes and unallocated table lanes write here
SCRATCH_BLOCK = 0


class RMSNorm(nn.Module):
    """f32 normalisation with an f32 weight, cast back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        dtype = x.dtype
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight).to(dtype)


def rope_tables(positions, head_dim: int, base: float = 10000.0):
    """cos/sin tables ``[T, head_dim]`` (f32) for HF-convention RoPE, the
    half frequencies duplicated (``concat(freqs, freqs)``)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (base ** exponent)
    freqs = positions.float()[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x, cos, sin):
    """Rotate ``[B, T, H, D]`` by per-position tables ``[T, D]``."""
    d = x.shape[-1]
    xf = x.float()
    rot = torch.cat([-xf[..., d // 2:], xf[..., : d // 2]], dim=-1)
    out = xf * cos[None, :, None, :] + rot * sin[None, :, None, :]
    return out.to(x.dtype)


def apply_rope_rows(x, cos, sin):
    """Rotate ``[B, T, H, D]`` by PER-ROW tables ``[B, T, D]`` (the paged
    path, where each row carries its own row-local positions)."""
    d = x.shape[-1]
    xf = x.float()
    rot = torch.cat([-xf[..., d // 2:], xf[..., : d // 2]], dim=-1)
    out = xf * cos[:, :, None, :] + rot * sin[:, :, None, :]
    return out.to(x.dtype)


@dataclass
class LayerCache:
    """One layer's decode cache. ``k``/``v``: ``[B, L, KVH, D]`` (int8
    under ``kv_quant``, with ``k_scale``/``v_scale`` ``[B, L, KVH]``
    f32); ``slot_pos`` (windowed models): ``[L]`` int32, the position each
    slot holds plus one, 0 meaning empty."""
    k: torch.Tensor
    v: torch.Tensor
    slot_pos: Optional[torch.Tensor] = None
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


@dataclass
class PagedLayer:
    """One layer's leaves of the KV block pool: ``k``/``v`` pages
    ``[P, bt, KVH, D]`` (int8 under ``kv_quant``, with f32 ``k_scale``/
    ``v_scale`` ``[P, bt, KVH]``). Page ``SCRATCH_BLOCK`` is never
    allocated to a request."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


@dataclass
class PagedCache:
    """The KV block pool as the model reads it: one ``PagedLayer`` per
    layer. Forward calls write into these tensors in place."""
    layers: List[PagedLayer]


@dataclass
class PagedPlacement:
    """Where one model call's lanes sit, the same for every layer:
    the block table and row placement the kernel reads, the per-row RoPE
    tables ``cos``/``sin`` ``[B, T, D]`` and the flat pool row ``flat``
    ``[B*T]`` each lane's K/V is written to."""
    tables: torch.Tensor
    row_starts: torch.Tensor
    pad_lens: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor
    flat: torch.Tensor


def paged_placement(tables, row_starts, pad_lens, t: int, bt: int,
                    window: int, head_dim: int,
                    rope_base: float) -> PagedPlacement:
    """Row ``b``'s lane ``i`` sits at the row-local position
    ``row_starts[b] + i`` (its RoPE angle); the page for position p is
    ``tables[b, p // bt]``, or ``tables[b, (p // bt) % NB]`` in ring mode
    (``window > 0``; flat mode clips positions to ``NB*bt - 1``), at
    offset ``p % bt``. Pad lanes (``i < pad_lens[b]``) and ``-1`` table
    lanes write to the scratch page."""
    b, nb = tables.shape
    lane = torch.arange(t, device=tables.device)
    pos = row_starts.long()[:, None] + lane[None, :]              # [B, T]
    if window > 0:
        safe = pos.clamp_min(0)
        blk = torch.remainder(torch.div(safe, bt, rounding_mode="floor"),
                              nb)
    else:
        safe = pos.clamp(0, nb * bt - 1)
        blk = torch.div(safe, bt, rounding_mode="floor")
    cos, sin = rope_tables(safe.reshape(-1), head_dim, rope_base)
    page = tables.long().gather(1, blk)
    ok = (lane[None, :] >= pad_lens.long()[:, None]) & (page >= 0)
    flat = torch.where(ok, page, SCRATCH_BLOCK) * bt + safe % bt
    return PagedPlacement(tables, row_starts, pad_lens,
                          cos.view(b, t, head_dim), sin.view(b, t, head_dim),
                          flat.reshape(-1))


@dataclass
class DecodeCache:
    """The model's decode state: per-layer caches plus the position
    counter that runs across calls (tokens fed so far)."""
    layers: List[LayerCache]
    pos_index: int = 0


class LlamaAttention(nn.Module):
    def __init__(self, d_model: int, n_head: int, n_kv_head: int,
                 attn_impl: str = "xla", rope_base: float = 10000.0,
                 window: int = 0, dtype=torch.float32, device=None,
                 kv_quant: str = "", param_dtype=None):
        super().__init__()
        self.n_head, self.n_kv_head = n_head, n_kv_head
        self.head_dim = d_model // n_head
        self.attn_impl = attn_impl
        self.rope_base = rope_base
        self.window = window
        self.kv_quant = kv_quant
        hd = self.head_dim
        lin = dict(bias=False, compute_dtype=dtype, param_dtype=param_dtype,
                   device=device)
        self.q_proj = Dense(d_model, n_head * hd, **lin)
        self.k_proj = Dense(d_model, n_kv_head * hd, **lin)
        self.v_proj = Dense(d_model, n_kv_head * hd, **lin)
        self.o_proj = Dense(n_head * hd, d_model, **lin)

    def forward(self, x, cache=None, start: int = 0,
                prefill: bool = False, paged=None):
        b, t, _ = x.shape
        hd = self.head_dim
        q = self.q_proj(x).view(b, t, self.n_head, hd)
        k = self.k_proj(x).view(b, t, self.n_kv_head, hd)
        v = self.v_proj(x).view(b, t, self.n_kv_head, hd)
        if isinstance(cache, PagedLayer):
            ctx = self._paged_attention(q, k, v, cache, paged)
        elif cache is not None:
            ctx = self._cached_attention(q, k, v, cache, start, prefill)
        else:
            pos = torch.arange(t, device=x.device)
            cos, sin = rope_tables(pos, hd, self.rope_base)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            if self.attn_impl == "flash":
                ctx = flash_attention(q, k, v, causal=True,
                                      window=self.window)
            else:
                groups = self.n_head // self.n_kv_head
                ctx = multihead_attention(
                    q, k.repeat_interleave(groups, dim=2),
                    v.repeat_interleave(groups, dim=2), causal=True,
                    window=self.window)
        return self.o_proj(ctx.reshape(b, t, self.n_head * hd))

    def _paged_attention(self, q, k, v, layer: PagedLayer,
                         at: PagedPlacement):
        """Attention over the KV block pool (the JAX package's
        ``_paged_attention``), with the call's lanes placed by ``at``
        (:func:`paged_placement`).

        The call's new K/V rows are written into their pages IN PLACE
        (flat pool row ``page*bt + p % bt``) before attending: the pool
        tensors are the decode state, and the engine only ever feeds
        positions covered by the row's private pages, so a write never
        touches a page another row reads. Under ``kv_quant="int8"`` the
        rows are quantized at the write and the call's own tokens are
        read back through int8 like history."""
        b, t = q.shape[:2]
        q = apply_rope_rows(q, at.cos, at.sin)
        k = apply_rope_rows(k, at.cos, at.sin)

        def put(pool, new):
            pool.view(-1, *pool.shape[2:])[at.flat] = new.reshape(
                b * t, *new.shape[2:]).to(pool.dtype)

        if layer.k_scale is not None:
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            put(layer.k, kq)
            put(layer.v, vq)
            put(layer.k_scale, ks)
            put(layer.v_scale, vs)
        else:
            put(layer.k, k)
            put(layer.v, v)
        return paged_gqa_attention(q, layer.k, layer.v, at.tables,
                                   at.row_starts, at.pad_lens,
                                   window=self.window,
                                   k_scale=layer.k_scale,
                                   v_scale=layer.v_scale)

    def _cached_attention(self, q, k, v, cache: LayerCache, cur: int,
                          prefill: bool):
        """Decode against the layer cache, writing this call's K/V rows
        into it IN PLACE (the cache tensors are the decode state, owned by
        the caller's DecodeCache; nothing else aliases them).

        RoPE rotates the new rows at their absolute positions
        ``cur .. cur + t - 1``. ``prefill`` asserts a fresh cache
        (``cur == 0``): the call's own tokens are the whole context, so
        attention goes through the flash kernel. Otherwise the grouped GQA
        read attends over the cache with the visibility mask. An int8
        cache (``k_scale`` set) stores quantized rows; history is read
        dequantized and the call's own rows at full precision."""
        b, t, _, d = q.shape
        cache_len = cache.k.shape[1]
        window = self.window
        rolling = window > 0 and cache_len == window
        if not rolling and cur + t > cache_len:
            raise ValueError(f"decode input ends at {cur + t}, past the "
                             f"cache's {cache_len} slots")
        pos = torch.arange(cur, cur + t, device=q.device)
        cos, sin = rope_tables(pos, d, self.rope_base)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        fresh = prefill and t > 1
        kvq = cache.k_scale is not None
        if kvq:
            hist_k = dequantize_kv(cache.k, cache.k_scale, k.dtype)
            hist_v = dequantize_kv(cache.v, cache.v_scale, v.dtype)
        else:
            hist_k, hist_v = cache.k, cache.v

        def write(dst_slice, rows_k, rows_v):
            """Store rows into cache slots (quantized under int8)."""
            if kvq:
                (kq, ks), (vq, vs) = quantize_kv(rows_k), quantize_kv(rows_v)
                pairs = ((cache.k, kq), (cache.v, vq),
                         (cache.k_scale, ks), (cache.v_scale, vs))
            else:
                pairs = ((cache.k, rows_k), (cache.v, rows_v))
            for dst, src in pairs:
                dst_slice(dst, src.to(dst.dtype))

        if rolling:
            if not fresh:
                # history (the ring, before this call's write) + the
                # call's own tokens, with the band mask
                hist_pos = cache.slot_pos.long() - 1          # -1 = empty
                k_all = torch.cat([hist_k, k.to(hist_k.dtype)], dim=1)
                v_all = torch.cat([hist_v, v.to(hist_v.dtype)], dim=1)
                k_pos = torch.cat([hist_pos, pos])[None, :]
                visible = ((k_pos >= 0) & (k_pos <= pos[:, None])
                           & (pos[:, None] - k_pos < window))
            # ring write of the trailing <= W rows: slot p % W holds
            # position p (at most two contiguous slices)
            n_new = min(t, cache_len)
            kw, vw = k[:, t - n_new:], v[:, t - n_new:]
            first = cur + t - n_new
            start = first % cache_len
            n1 = min(n_new, cache_len - start)

            def ring_slice(dst, src):
                dst[:, start:start + n1] = src[:, :n1]
                dst[:, :n_new - n1] = src[:, n1:]

            write(ring_slice, kw, vw)
            new_pos = torch.arange(first + 1, first + n_new + 1,
                                   dtype=cache.slot_pos.dtype,
                                   device=q.device)
            cache.slot_pos[start:start + n1] = new_pos[:n1]
            cache.slot_pos[:n_new - n1] = new_pos[n1:]
            if fresh:
                return flash_attention(q, k, v, causal=True, window=window)
            return grouped_query_attention(q, k_all, v_all,
                                           mask=visible[None, None])
        if kvq and not fresh:
            # attention reads the dequantized history with the call's own
            # rows exact; the write below stores them quantized
            k_all, v_all = hist_k.clone(), hist_v.clone()
            k_all[:, cur:cur + t] = k
            v_all[:, cur:cur + t] = v

        def span(dst, src):
            dst[:, cur:cur + t] = src

        write(span, k, v)
        if fresh:
            return flash_attention(q, k, v, causal=True, window=window)
        if not kvq:
            k_all, v_all = cache.k, cache.v
        k_pos = torch.arange(cache_len, device=q.device)[None, :]
        visible = k_pos <= pos[:, None]
        if window > 0:
            visible = visible & (pos[:, None] - k_pos < window)
        return grouped_query_attention(q, k_all, v_all,
                                       mask=visible[None, None])


class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype=torch.float32,
                 device=None, param_dtype=None):
        super().__init__()
        lin = dict(bias=False, compute_dtype=dtype, param_dtype=param_dtype,
                   device=device)
        self.gate_proj = Dense(d_model, d_ff, **lin)
        self.up_proj = Dense(d_model, d_ff, **lin)
        self.down_proj = Dense(d_ff, d_model, **lin)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, d_model, n_head, n_kv_head, d_ff, attn_impl,
                 rope_base, rms_eps, window, dtype, device, kv_quant="",
                 param_dtype=None):
        super().__init__()
        self.input_layernorm = RMSNorm(d_model, rms_eps, device=device)
        self.self_attn = LlamaAttention(d_model, n_head, n_kv_head,
                                        attn_impl, rope_base, window,
                                        dtype=dtype, device=device,
                                        kv_quant=kv_quant,
                                        param_dtype=param_dtype)
        self.post_attention_layernorm = RMSNorm(d_model, rms_eps,
                                                device=device)
        self.mlp = SwiGLU(d_model, d_ff, dtype=dtype, device=device,
                          param_dtype=param_dtype)

    def forward(self, x, cache=None, start: int = 0, prefill: bool = False,
                paged=None):
        x = x + self.self_attn(self.input_layernorm(x), cache, start,
                               prefill, paged)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaLM(nn.Module):
    """Decoder-only Llama-architecture causal LM."""

    def __init__(self, vocab_size: int = 32000, n_layer: int = 12,
                 n_head: int = 12, n_kv_head: int = 0, d_model: int = 768,
                 d_ff: int = 0, max_len: int = 2048,
                 dtype=torch.float32, attn_impl: str = "xla",
                 rope_base: float = 10000.0, rms_eps: float = 1e-6,
                 window: int = 0, device=None, kv_quant: str = "",
                 remat: bool = False, fused_head: bool = False,
                 param_dtype=None):
        super().__init__()
        n_kv = n_kv_head or n_head
        if kv_quant not in ("", "int8"):
            raise ValueError(f"unknown kv_quant {kv_quant!r} (int8 is the "
                             "only quantized KV layout)")
        if n_head % n_kv:
            raise ValueError(
                f"n_head {n_head} not divisible by n_kv_head {n_kv}")
        if attn_impl not in ("xla", "flash"):
            raise NotImplementedError(
                f"attn_impl={attn_impl!r}: sequence-parallel attention is "
                "a later slice (parallel axes); this slice runs 'flash' "
                "and 'xla'")
        # Llama's ~8/3 ratio rounded up to a multiple of 16, as in JAX
        d_ff = d_ff or -(-int(d_model * 8 / 3) // 16) * 16
        self.vocab_size, self.n_layer, self.n_head = vocab_size, n_layer, \
            n_head
        self.n_kv_head, self.d_model, self.d_ff = n_kv, d_model, d_ff
        self.max_len, self.window, self.dtype = max_len, window, dtype
        self.rope_base, self.kv_quant = rope_base, kv_quant
        self.remat, self.fused_head = remat, fused_head
        self.head_dim = d_model // n_head
        self.embed_tokens = nn.Embedding(vocab_size, d_model,
                                         dtype=param_dtype or dtype,
                                         device=device)
        self.layers = nn.ModuleList(
            LlamaBlock(d_model, n_head, n_kv, d_ff, attn_impl, rope_base,
                       rms_eps, window, dtype, device, kv_quant, param_dtype)
            for _ in range(n_layer))
        self.norm = RMSNorm(d_model, rms_eps, device=device)
        self.lm_head = Dense(d_model, vocab_size, bias=False,
                             compute_dtype=dtype, param_dtype=param_dtype,
                             device=device)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random init from ``generator``, the flax initializers' law:
        N(0, 0.02) for every projection and the embedding, ones for the
        norms."""
        for name, p in self.named_parameters():
            if name.endswith("layernorm.weight") or name == "norm.weight":
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=generator)

    def cache_len(self, total: int) -> int:
        """Slots per layer for a ``total``-token budget:
        ``min(window, total)`` when windowed."""
        return min(self.window, total) if self.window > 0 else total

    def _kv_leaves(self, lead: tuple):
        """Zeroed ``(k, v, k_scale, v_scale)`` of shape ``lead + (KVH,
        D)``; int8 with f32 scales under ``kv_quant`` (zero rows decode
        to zeros, as in the JAX package's zeroed caches)."""
        shape = lead + (self.n_kv_head, self.head_dim)
        dev = self.device
        if not self.kv_quant:
            return (torch.zeros(shape, dtype=self.dtype, device=dev),
                    torch.zeros(shape, dtype=self.dtype, device=dev),
                    None, None)
        return (torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                torch.zeros(shape[:-1], dtype=torch.float32, device=dev))

    def new_cache(self, batch: int, total: int) -> DecodeCache:
        """Zeroed decode cache for a ``[batch, total]`` budget."""
        n = self.cache_len(total)
        layers = []
        for _ in range(self.n_layer):
            slot_pos = (torch.zeros(n, dtype=torch.int32, device=self.device)
                        if self.window > 0 else None)
            k, v, ks, vs = self._kv_leaves((batch, n))
            layers.append(LayerCache(k, v, slot_pos, ks, vs))
        return DecodeCache(layers)

    def new_paged_cache(self, pool_blocks: int,
                        block_tokens: int) -> PagedCache:
        """Zeroed KV block pool: ``pool_blocks`` pages of
        ``block_tokens`` tokens per layer."""
        return PagedCache([PagedLayer(*self._kv_leaves(
            (int(pool_blocks), int(block_tokens))))
            for _ in range(self.n_layer)])

    def kv_cache_spec(self) -> dict:
        """The decode-cache layout contract engine/kvcache.py reads (the
        JAX package's ``kv_cache_spec``): RoPE family, ``paged`` call path
        implemented for every layout (int8 pages + scales, ring tables
        when windowed), K/V at ``kv_heads`` heads."""
        return {"rotary": True, "rope_base": float(self.rope_base),
                "window": int(self.window), "kv_quant": self.kv_quant,
                "paged": True, "kv_heads": int(self.n_kv_head)}

    def forward(self, tokens, cache=None, prefill: bool = False,
                block_tables=None, row_starts=None, pad_lens=None):
        """tokens ``[B, T]`` -> f32 logits ``[B, T, V]`` (or, with no
        cache and ``fused_head``, ``(hidden, head_w [D, V])`` in the
        compute dtype).

        With a ``DecodeCache``: decode forward from ``cache.pos_index``,
        which advances by ``T``. ``prefill=True`` asserts the cache is
        fresh and returns the last position's logits only (``[B, 1, V]``).

        With a ``PagedCache`` (the pool): ``block_tables`` ``[B, NB]``,
        ``row_starts`` ``[B]`` and ``pad_lens`` ``[B]`` (int32, on the
        model's device) place each row's lanes; ``prefill=True`` keeps the
        last position's logits only."""
        b, t = tokens.shape
        x = embed(self.embed_tokens.weight, tokens, self.dtype)
        start, paged = 0, None
        if isinstance(cache, PagedCache):
            if block_tables is None or row_starts is None:
                raise ValueError("a paged cache needs block_tables and "
                                 "row_starts")
            if pad_lens is None:
                pad_lens = torch.zeros((b,), dtype=torch.int32,
                                       device=tokens.device)
            # the lanes' placement is the same for every layer: once here
            paged = paged_placement(block_tables, row_starts, pad_lens, t,
                                    cache.layers[0].k.shape[1], self.window,
                                    self.head_dim, self.rope_base)
        elif cache is not None:
            start = cache.pos_index
            if prefill and start != 0:
                raise ValueError("prefill=True needs a fresh cache "
                                 f"(pos_index is {start})")
            cache.pos_index = start + t
        remat = self.remat and cache is None and torch.is_grad_enabled()
        for i, block in enumerate(self.layers):
            if remat:
                x = checkpoint(block, x, use_reentrant=False)
                continue
            layer_cache = cache.layers[i] if cache is not None else None
            x = block(x, layer_cache, start, prefill, paged)
        x = self.norm(x)
        if cache is None and self.fused_head:
            return x.to(self.dtype), self.lm_head.weight.t().to(self.dtype)
        if cache is not None and prefill and t > 1:
            x = x[:, -1:]
        return self.lm_head(x).float()


def _refuse_later(quant="", lora_rank=0, mesh=None,
                  seq_layout="natural") -> None:
    if quant:
        raise NotImplementedError(
            f"quant={quant!r} (w8a16 serving weights) is a later slice")
    if lora_rank:
        raise NotImplementedError("LoRA is a later slice (other model "
                                  "families)")
    if mesh is not None or seq_layout != "natural":
        raise NotImplementedError(
            "meshes and sequence layouts are a later slice (parallel axes)")


def _dtype(bfloat16: bool):
    return torch.bfloat16 if bfloat16 else torch.float32


@MODELS.register("Llama")
def llama(vocab_size: int = 32000, n_layer: int = 12, n_head: int = 12,
          n_kv_head: int = 0, d_model: int = 768, d_ff: int = 0,
          max_len: int = 2048, bfloat16: bool = False,
          attn_impl: str = "xla", remat: bool = False, mesh=None,
          seq_layout: str = "natural", rope_base: float = 10000.0,
          rms_eps: float = 1e-6, window: int = 0, fused_head: bool = False,
          quant: str = "", kv_quant: str = "", lora_rank: int = 0,
          lora_alpha: float = 16.0, device=None, param_dtype=None):
    """``param_dtype`` (default: the compute dtype) stores the weights
    wider than they compute: training passes float32."""
    _refuse_later(quant, lora_rank, mesh, seq_layout)
    return LlamaLM(vocab_size, n_layer, n_head, n_kv_head, d_model, d_ff,
                   max_len, _dtype(bfloat16), attn_impl, rope_base, rms_eps,
                   window, device, kv_quant, remat, fused_head, param_dtype)


@MODELS.register("Mistral")
def mistral(vocab_size: int = 32000, n_layer: int = 32, n_head: int = 32,
            n_kv_head: int = 8, d_model: int = 4096, d_ff: int = 14336,
            max_len: int = 32768, window: int = 4096,
            rope_base: float = 10000.0, rms_eps: float = 1e-5,
            bfloat16: bool = True, attn_impl: str = "flash",
            remat: bool = True, mesh=None, fused_head: bool = False,
            quant: str = "", kv_quant: str = "", lora_rank: int = 0,
            lora_alpha: float = 16.0, device=None, param_dtype=None):
    """Mistral-7B-v0.1 shape: the Llama architecture with 4:1 GQA and a
    4096-token sliding window."""
    _refuse_later(quant, lora_rank, mesh)
    return LlamaLM(vocab_size, n_layer, n_head, n_kv_head, d_model, d_ff,
                   max_len, _dtype(bfloat16), attn_impl, rope_base, rms_eps,
                   window, device, kv_quant, remat, fused_head, param_dtype)


@MODELS.register("TinyLlama")
def tiny_llama(vocab_size: int = 256, n_layer: int = 2, n_head: int = 4,
               n_kv_head: int = 2, d_model: int = 64, d_ff: int = 0,
               max_len: int = 128, attn_impl: str = "xla",
               remat: bool = False, mesh=None, bfloat16: bool = False,
               seq_layout: str = "natural", window: int = 0,
               fused_head: bool = False, quant: str = "",
               kv_quant: str = "", lora_rank: int = 0,
               lora_alpha: float = 16.0, device=None, param_dtype=None):
    """Small GQA config for tests and dry runs."""
    _refuse_later(quant, lora_rank, mesh, seq_layout)
    return LlamaLM(vocab_size, n_layer, n_head, n_kv_head, d_model, d_ff,
                   max_len, _dtype(bfloat16), attn_impl, 10000.0, 1e-6,
                   window, device, kv_quant, remat, fused_head, param_dtype)
