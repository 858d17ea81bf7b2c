"""Llama-family causal LM in PyTorch: RMSNorm + SwiGLU + RoPE + GQA.

Port of ``pytorch_distributed_template_tpu/models/llama.py`` for serving:
the plain forward and the decode forward over a KV cache, registered as
``Llama``, ``Mistral``, ``MixtralMoE`` and ``TinyLlama`` with the JAX
registry's defaults.

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

- Sequence parallelism (``attn_impl`` ``ring``, ``ring_flash``,
  ``ulysses``, ``ulysses_flash``; ops/attention.py), training only: with a
  mesh whose ``seq`` axis is S > 1, each rank embeds its shard of the row
  and RoPE rotates q and k by the shard's global positions; the SP impls
  take compact K/V (``n_kv_head`` heads cross the wire). ``window > 0``
  forces the contiguous layout (the band balances the causal triangle and
  the ring stops early), as in the JAX model; ``seq_layout: "zigzag"``
  applies to an unwindowed ring.

- LoRA (``lora_rank > 0``, ``lora_alpha``): every projection, the head
  included unless fused (JAX puts LoRA on the untied head too), is a
  ``models.lora.LoRADense`` (``models.quant.dense_factory``).

- Tensor parallelism (a mesh whose ``tensor`` axis is T > 1,
  :meth:`LlamaLM.use_tensor_axis`): each rank holds its slice of JAX's
  Megatron placements (:meth:`LlamaLM.partition_rules`, over the torch
  dimensions) and computes on it: ``n_head / T`` query heads over
  ``n_kv_head / T`` KV heads (flash B1-B3 on the local heads),
  ``d_ff / T`` SwiGLU columns and ``vocab / T`` rows of the embedding and
  the head. Megatron's ``f`` (parallel/collectives.py) goes before q/k/v,
  gate/up and the head, its ``g`` after ``o_proj``, ``down_proj`` and the
  vocab-sharded lookup (models/layers.py); the vocab-sharded logits, or
  under ``fused_head`` the head's weight, are gathered whole, and every
  rank of a tensor row computes the same loss. The blocks are the fsdp
  gather units (:meth:`LlamaLM.fsdp_units`, parallel/fsdp.py). LoRA on a
  tensor axis is A11b's remainder.
- Decoding on a tensor axis (TP serving, parallel/tp.py): the caches and
  the pool hold this rank's ``n_kv_head / T`` heads (int8 pages with their
  scales), attention runs on the local heads with no collective (B1
  prefill, B4 over the rank's head slice of the pool), the vocab-sharded
  lookup and the logits' gather work as in training; every rank of the
  group runs each call with the same inputs (parallel/serving_ranks.py).

- MoE (``moe_experts > 0``: ``MixtralMoE``, the sparse Llama family): every
  ``moe_every``-th block swaps its SwiGLU MLP for ``MoeMlp(expert_act=
  "swiglu")`` (models/moe.py; parameter name ``moe``, as in the flax
  tree). ``forward(..., example_mask=...)`` keeps padded examples out of
  expert capacity; in training mode the forward sets ``model.aux_loss`` to
  the blocks' summed load-balancing loss (None without one), once per
  call, a block recomputed under remat adding nothing twice. The blocks
  route over the global batch of the LM's ``mesh`` and split their
  experts over its ``expert`` axis (models/moe.py); the rules are
  MoeMlp's plus the Llama rules. The decode paths (contiguous, rolling
  and paged caches) pass no ``example_mask``, as JAX's engines call the
  model: every row of a decode or chunk call, an idle or padded one too,
  claims expert capacity as JAX's does. Zigzag stays off for MoE, as in
  JAX (the routing keeps natural order).

- ``quant="w8a16"`` (serving): every projection and the head are
  ``models.quant.W8A16Dense`` (int8 kernel, per-channel scale), as in the
  JAX family; the embedding and the norms stay float. The sparse family
  refuses it (``validate_quant_config``).
- Mixed-length batches on the contiguous cache (``forward(...,
  pad_lens=...)``, the static micro-batcher of engine/serving.py): row
  ``b``'s prompt is LEFT-padded by ``pad_lens[b]`` slots, which its
  attention hides; RoPE rotates by cache slot, a per-row constant shift
  that leaves q-k offsets (all RoPE sees) unchanged. A padded prefill runs
  the masked plain attention (the flash kernel has no pad mask), so the
  logits match a solo run to float tolerance, as in JAX. A rolling cache
  refuses pads.
- ``forward(..., exit_layer=k)``: the early-exit forward of the
  speculative draft (engine/generate.py ``draft_layers``), the first ``k``
  blocks then the final norm and the head, sharing the cache.

Left to later slices, each refused with a message naming it: decoding on a
seq axis, MoE blocks on a tensor axis (training: ROADMAP A11d's
remainder; ``serve.py --tp``: A6c.3's remainder), w8a16 under
tensor-parallel serving (A4's remainder, ``parallel/tp.py``).
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
    SP_IMPLS, grouped_query_attention, multihead_attention,
    paged_gqa_attention, seq_plan, sequence_attention,
)
from ..ops.flash import flash_attention
from ..parallel.collectives import copy_to, gather_replicated
from ..parallel.sharding import P
from .layers import embed, row_parallel, vocab_embed
from .moe import MoeMlp
from .quant import (
    check_lora_quant, dense_factory, dequantize_kv, quantize_kv,
    validate_quant_config,
)

#: reserved pool page: pad lanes and unallocated table lanes write here
SCRATCH_BLOCK = 0
_SLICE_MOE_TENSOR = ("MoE blocks on a tensor axis: ROADMAP A11d's "
                     "remainder (training) and A6c.3's remainder "
                     "(tensor-parallel serving), a later slice")


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
                    window: int, head_dim: int, rope_base: float,
                    write_rows=None) -> PagedPlacement:
    """Row ``b``'s lane ``i`` sits at the row-local position
    ``row_starts[b] + i`` (its RoPE angle); the page for position p is
    ``tables[b, p // bt]``, or ``tables[b, (p // bt) % NB]`` in ring mode
    (``window > 0``; flat mode clips positions to ``NB*bt - 1``), at
    offset ``p % bt``. Pad lanes (``i < pad_lens[b]``), ``-1`` table
    lanes and the rows from ``write_rows`` on (copies of an earlier row
    that read its pages) write to the scratch page."""
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
    if write_rows is not None:
        ok &= torch.arange(b, device=tables.device)[:, None] < write_rows
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
                 kv_quant: str = "", param_dtype=None, lora: dict = None,
                 quant: str = ""):
        super().__init__()
        self.n_head, self.n_kv_head = n_head, n_kv_head
        self.head_dim = d_model // n_head
        self.attn_impl = attn_impl
        self.rope_base = rope_base
        self.window = window
        self.kv_quant = kv_quant
        hd = self.head_dim
        dense = dense_factory(dtype, param_dtype=param_dtype, device=device,
                              quant=quant, **(lora or {}))
        self.q_proj = dense(d_model, n_head * hd)
        self.k_proj = dense(d_model, n_kv_head * hd)
        self.v_proj = dense(d_model, n_kv_head * hd)
        self.o_proj = dense(n_head * hd, d_model)
        self.tp = None      # the tensor axis (``LlamaLM.use_tensor_axis``)

    def forward(self, x, cache=None, start: int = 0,
                prefill: bool = False, paged=None, sp=None, pad_lens=None):
        """``sp``: ``(positions [T] of a seq shard or None, layout, mesh)``
        of the seq axis (``LlamaLM.forward``), or None."""
        b, t, _ = x.shape
        hd, tp = self.head_dim, self.tp
        heads, kv_heads = self.n_head, self.n_kv_head
        if tp is not None:
            x = copy_to(x, tp.group)
            heads, kv_heads = heads // tp.size, kv_heads // tp.size
        q = self.q_proj(x).view(b, t, heads, hd)
        k = self.k_proj(x).view(b, t, kv_heads, hd)
        v = self.v_proj(x).view(b, t, kv_heads, hd)
        if isinstance(cache, PagedLayer):
            ctx = self._paged_attention(q, k, v, cache, paged)
        elif cache is not None:
            ctx = self._cached_attention(q, k, v, cache, start, prefill,
                                         pad_lens)
        else:
            pos, layout, mesh = sp or (None, "contig", None)
            if pos is None:
                pos = torch.arange(t, device=x.device)
            cos, sin = rope_tables(pos, hd, self.rope_base)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            if self.attn_impl in SP_IMPLS:
                ctx = sequence_attention(
                    q, k, v.contiguous(), self.attn_impl, mesh, causal=True,
                    layout=layout, window=self.window)
            elif self.attn_impl == "flash":
                ctx = flash_attention(q, k, v, causal=True,
                                      window=self.window)
            else:
                groups = self.n_head // self.n_kv_head
                ctx = multihead_attention(
                    q, k.repeat_interleave(groups, dim=2),
                    v.repeat_interleave(groups, dim=2), causal=True,
                    window=self.window)
        ctx = ctx.reshape(b, t, heads * hd)
        if tp is not None:
            return row_parallel(self.o_proj, ctx, tp)
        return self.o_proj(ctx)

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
                          prefill: bool, pad_lens=None):
        """Decode against the layer cache, writing this call's K/V rows
        into it IN PLACE (the cache tensors are the decode state, owned by
        the caller's DecodeCache; nothing else aliases them).

        RoPE rotates the new rows at their absolute positions
        ``cur .. cur + t - 1``. ``prefill`` asserts a fresh cache
        (``cur == 0``): the call's own tokens are the whole context, so
        attention goes through the flash kernel. Otherwise the grouped GQA
        read attends over the cache with the visibility mask. An int8
        cache (``k_scale`` set) stores quantized rows; history is read
        dequantized and the call's own rows at full precision.
        ``pad_lens`` ``[B]`` hides each row's left-pad slots (module
        docstring); a padded prefill takes the masked path."""
        b, t, _, d = q.shape
        cache_len = cache.k.shape[1]
        window = self.window
        rolling = window > 0 and cache_len == window
        if pad_lens is not None and rolling:
            raise ValueError(
                "pad_lens (mixed-length batching) is incompatible with a "
                "rolling-window cache: ring eviction order would differ "
                "per row")
        if not rolling and cur + t > cache_len:
            raise ValueError(f"decode input ends at {cur + t}, past the "
                             f"cache's {cache_len} slots")
        pos = torch.arange(cur, cur + t, device=q.device)
        cos, sin = rope_tables(pos, d, self.rope_base)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        fresh = prefill and t > 1 and pad_lens is None
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
        if pad_lens is not None:
            # [B, t, L]: row b also hides its left-pad slots
            visible = visible[None] & (
                k_pos[None] >= pad_lens.long()[:, None, None])
            return grouped_query_attention(q, k_all, v_all,
                                           mask=visible[:, None])
        return grouped_query_attention(q, k_all, v_all,
                                       mask=visible[None, None])


class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype=torch.float32,
                 device=None, param_dtype=None, lora: dict = None,
                 quant: str = ""):
        super().__init__()
        dense = dense_factory(dtype, param_dtype=param_dtype, device=device,
                              quant=quant, **(lora or {}))
        self.gate_proj = dense(d_model, d_ff)
        self.up_proj = dense(d_model, d_ff)
        self.down_proj = dense(d_ff, d_model)
        self.tp = None      # the tensor axis (``LlamaLM.use_tensor_axis``)

    def forward(self, x):
        if self.tp is None:
            return self.down_proj(F.silu(self.gate_proj(x))
                                  * self.up_proj(x))
        x = copy_to(x, self.tp.group)
        h = F.silu(self.gate_proj(x)) * self.up_proj(x)
        return row_parallel(self.down_proj, h, self.tp)


class LlamaBlock(nn.Module):
    """Pre-norm block: attention, then the SwiGLU MLP or, with ``moe`` (the
    ``MoeMlp`` kwargs), the routed swiglu experts. ``forward`` returns
    ``(x, aux)``: the MoE load-balancing loss in training mode, else
    None."""

    def __init__(self, d_model, n_head, n_kv_head, d_ff, attn_impl,
                 rope_base, rms_eps, window, dtype, device, kv_quant="",
                 param_dtype=None, lora: dict = None, moe: dict = None,
                 n_layer: int = 1, quant: str = ""):
        super().__init__()
        self.input_layernorm = RMSNorm(d_model, rms_eps, device=device)
        self.self_attn = LlamaAttention(d_model, n_head, n_kv_head,
                                        attn_impl, rope_base, window,
                                        dtype=dtype, device=device,
                                        kv_quant=kv_quant,
                                        param_dtype=param_dtype, lora=lora,
                                        quant=quant)
        self.post_attention_layernorm = RMSNorm(d_model, rms_eps,
                                                device=device)
        if moe:
            self.moe = MoeMlp(d_model, d_ff, dropout=0.0, n_layer=n_layer,
                              dtype=dtype, expert_act="swiglu",
                              device=device,
                              param_dtype=param_dtype or dtype, **moe)
        else:
            self.mlp = SwiGLU(d_model, d_ff, dtype=dtype, device=device,
                              param_dtype=param_dtype, lora=lora,
                              quant=quant)

    def forward(self, x, cache=None, start: int = 0, prefill: bool = False,
                paged=None, sp=None, example_mask=None, pad_lens=None):
        x = x + self.self_attn(self.input_layernorm(x), cache, start,
                               prefill, paged, sp, pad_lens)
        h = self.post_attention_layernorm(x)
        if hasattr(self, "moe"):
            y, aux = self.moe(h, example_mask,
                              mesh=sp[2] if sp is not None else None)
            return x + y, aux
        return x + self.mlp(h), None


class LlamaLM(nn.Module):
    """Decoder-only Llama-architecture causal LM."""

    def __init__(self, vocab_size: int = 32000, n_layer: int = 12,
                 n_head: int = 12, n_kv_head: int = 0, d_model: int = 768,
                 d_ff: int = 0, max_len: int = 2048,
                 dtype=torch.float32, attn_impl: str = "xla",
                 rope_base: float = 10000.0, rms_eps: float = 1e-6,
                 window: int = 0, device=None, kv_quant: str = "",
                 remat: bool = False, fused_head: bool = False,
                 param_dtype=None, mesh=None, seq_layout: str = "natural",
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 moe_experts: int = 0, moe_top_k: int = 2,
                 moe_every: int = 1, moe_capacity_factor: float = 1.25,
                 moe_aux_loss_weight: float = 0.01, quant: str = ""):
        super().__init__()
        check_lora_quant(quant, lora_rank)
        validate_quant_config(quant, fused_head, moe_experts)
        self.quant = quant
        n_kv = n_kv_head or n_head
        if kv_quant not in ("", "int8"):
            raise ValueError(f"unknown kv_quant {kv_quant!r} (int8 is the "
                             "only quantized KV layout)")
        if n_head % n_kv:
            raise ValueError(
                f"n_head {n_head} not divisible by n_kv_head {n_kv}")
        if attn_impl not in ("xla", "flash") + SP_IMPLS:
            raise ValueError(f"attn_impl={attn_impl!r}; expected one of "
                             f"{('xla', 'flash') + SP_IMPLS}")
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
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha)
        self.moe_experts, self.moe_every = moe_experts, moe_every
        moe = dict(num_experts=moe_experts, top_k=moe_top_k,
                   capacity_factor=moe_capacity_factor,
                   aux_loss_weight=moe_aux_loss_weight)
        self.layers = nn.ModuleList(
            LlamaBlock(d_model, n_head, n_kv, d_ff, attn_impl, rope_base,
                       rms_eps, window, dtype, device, kv_quant, param_dtype,
                       lora, moe if self._is_moe_layer(i) else None,
                       n_layer, quant)
            for i in range(n_layer))
        self.aux_loss = None
        self.norm = RMSNorm(d_model, rms_eps, device=device)
        # a fused head hands its plain kernel to the loss (JAX's
        # ``_HeadKernel``): no adapters there
        self.lm_head = dense_factory(
            dtype, param_dtype=param_dtype, device=device, quant=quant,
            **({} if fused_head else lora))(d_model, vocab_size)
        self.attn_impl, self.seq_layout = attn_impl, seq_layout
        # the parallel mesh whose seq axis the SP impls run over
        # (parallel/mesh.py); None until ``inject_mesh`` sets it
        self.mesh = mesh
        self.tp = None      # the tensor axis (``use_tensor_axis``)

    def _is_moe_layer(self, i: int) -> bool:
        """The JAX ``_moe_kwargs`` rule: every ``moe_every``-th block."""
        return self.moe_experts > 0 and (i + 1) % self.moe_every == 0

    def partition_rules(self):
        """JAX's Megatron rules over ``tensor`` (``LlamaLM.
        partition_rules``), over the torch dimensions: column-parallel
        q/k/v and gate/up (weight rows), row-parallel o/down (weight
        columns), the vocab-sharded embedding and head; MoE blocks add
        MoeMlp's expert rules in front."""
        rules = [
            (r"embed_tokens/weight", P("tensor", None)),
            (r"self_attn/(q_proj|k_proj|v_proj)/weight", P("tensor", None)),
            (r"self_attn/o_proj/weight", P(None, "tensor")),
            (r"mlp/(gate_proj|up_proj)/weight", P("tensor", None)),
            (r"mlp/down_proj/weight", P(None, "tensor")),
            (r"lm_head/weight", P("tensor", None)),
        ]
        if self.moe_experts > 0:
            rules = MoeMlp.partition_rules() + rules
        return rules

    def fsdp_units(self):
        """The fsdp gather units (parallel/fsdp.py): the blocks."""
        return [(f"layers.{i}", block)
                for i, block in enumerate(self.layers)]

    def use_tensor_axis(self, mesh) -> None:
        """Compute on this rank's shards of a tensor axis (module
        docstring); refuses what does not split over it."""
        tp = mesh.axis("tensor")
        if self.moe_experts > 0:
            raise NotImplementedError(_SLICE_MOE_TENSOR)
        for what, n in (("n_head", self.n_head),
                        ("n_kv_head", self.n_kv_head), ("d_ff", self.d_ff),
                        ("vocab_size", self.vocab_size)):
            if n % tp.size:
                raise ValueError(f"{what} {n} does not split over a tensor "
                                 f"axis of {tp.size}")
        self.tp = tp
        for block in self.layers:
            block.self_attn.tp = block.mlp.tp = tp

    def _seq_plan(self, t: int):
        if (self.moe_experts > 0 and self.mesh is not None
                and self.mesh.axis_size("seq") > 1):
            raise NotImplementedError(
                "MoE blocks on a seq axis need the routing over the whole "
                "sequence: ROADMAP A11d's remainder, a later slice")
        # a window rides the contiguous banded ring; MoE routing keeps
        # natural order
        return seq_plan(self.mesh, self.attn_impl, self.seq_layout, t,
                        self.device,
                        zigzag_ok=self.window == 0 and self.moe_experts <= 0)

    def seq_shard(self, t: int):
        """The :class:`ops.attention.SeqShard` this rank's outputs hold of
        a ``[B, t]`` row, or None without a seq axis > 1."""
        return self._seq_plan(t)[0]

    @property
    def device(self) -> torch.device:
        return self.norm.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random init from ``generator``, the flax initializers' law:
        N(0, 0.02) for every projection, the embedding, the router and the
        experts' ``wi``/``wg``, N(0, 0.02/sqrt(2 n_layer)) for the experts'
        ``wo``, ones for the norms, zeros for the router's bias and the
        LoRA ``lora_b``."""
        resid = 0.02 / (2 * self.n_layer) ** 0.5
        for name, p in self.named_parameters():
            if not p.is_floating_point():
                continue                 # w8a16 kernels: from a converter
            if name.endswith(".scale") or name.endswith(
                    "layernorm.weight") or name == "norm.weight":
                p.fill_(1.0)
            elif name.endswith(("lora_b", "router.bias")):
                p.zero_()
            elif name.endswith("moe.wo"):
                p.normal_(0.0, resid, generator=generator)
            else:
                p.normal_(0.0, 0.02, generator=generator)

    def cache_len(self, total: int) -> int:
        """Slots per layer for a ``total``-token budget:
        ``min(window, total)`` when windowed."""
        return min(self.window, total) if self.window > 0 else total

    @property
    def local_kv_heads(self) -> int:
        """The KV heads this rank's caches hold: ``n_kv_head / T`` on a
        tensor axis of T, else all of them."""
        return self.n_kv_head // (self.tp.size if self.tp else 1)

    def _kv_leaves(self, lead: tuple):
        """Zeroed ``(k, v, k_scale, v_scale)`` of shape ``lead + (KVH,
        D)`` at this rank's KV heads; int8 with f32 scales under
        ``kv_quant`` (zero rows decode to zeros, as in the JAX package's
        zeroed caches)."""
        shape = lead + (self.local_kv_heads, self.head_dim)
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
        when windowed), K/V at ``kv_heads`` heads: what this rank's pool
        holds (``n_kv_head / T`` on a tensor axis of T)."""
        return {"rotary": True, "rope_base": float(self.rope_base),
                "window": int(self.window), "kv_quant": self.kv_quant,
                "paged": True, "kv_heads": self.local_kv_heads}

    def forward(self, tokens, cache=None, prefill: bool = False,
                block_tables=None, row_starts=None, pad_lens=None,
                example_mask=None, write_rows=None, exit_layer: int = 0):
        """tokens ``[B, T]`` -> f32 logits ``[B, T, V]`` (or, with no
        cache and ``fused_head``, ``(hidden, head_w [D, V])`` in the
        compute dtype); on a seq axis S > 1 the shard's ``[B, T / S,
        ...]`` (:meth:`seq_shard`).

        With a ``DecodeCache``: decode forward from ``cache.pos_index``,
        which advances by ``T``. ``prefill=True`` asserts the cache is
        fresh and returns the last position's logits only (``[B, 1, V]``).

        With a ``PagedCache`` (the pool): ``block_tables`` ``[B, NB]``,
        ``row_starts`` ``[B]`` and ``pad_lens`` ``[B]`` (int32, on the
        model's device) place each row's lanes; ``prefill=True`` keeps the
        last position's logits only. ``write_rows`` (int) keeps the pool
        writes to the leading rows: the rest are copies of the last of them
        that read its pages and write nothing. With a ``DecodeCache``,
        ``pad_lens`` ``[B]`` are the rows' left-pad lengths (module
        docstring). ``exit_layer > 0`` runs only the first ``exit_layer``
        blocks before the norm and the head (the early-exit draft).

        ``example_mask`` ([B] bool, training and evaluation) marks the real
        rows of a padded batch for the MoE blocks (dense blocks ignore
        it). Sets ``self.aux_loss``."""
        b, t = tokens.shape
        sp = None
        if cache is None:
            shard, layout = self._seq_plan(t)
            if shard is not None:
                tokens = tokens[:, shard.positions]
            sp = (None if shard is None else shard.positions, layout,
                  self.mesh)
        elif self.mesh is not None and self.mesh.axis_size("seq") > 1:
            raise NotImplementedError("decoding on a seq axis is a later "
                                      "slice (serving over parallel axes)")
        tp = self.tp
        x = (embed(self.embed_tokens.weight, tokens, self.dtype)
             if tp is None else vocab_embed(self.embed_tokens.weight,
                                            tokens, self.dtype, tp))
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
                                    self.head_dim, self.rope_base,
                                    write_rows)
        elif cache is not None:
            start = cache.pos_index
            if prefill and start != 0:
                raise ValueError("prefill=True needs a fresh cache "
                                 f"(pos_index is {start})")
            cache.pos_index = start + t
        remat = self.remat and cache is None and torch.is_grad_enabled()
        dense_pads = pad_lens if isinstance(cache, DecodeCache) else None
        n_run = (min(int(exit_layer), self.n_layer) if exit_layer
                 else self.n_layer)
        aux_total = None
        for i, block in enumerate(self.layers[:n_run]):
            if remat:
                x, aux = checkpoint(block, x, None, 0, False, None, sp,
                                    example_mask, use_reentrant=False)
            else:
                layer_cache = cache.layers[i] if cache is not None else None
                x, aux = block(x, layer_cache, start, prefill, paged, sp,
                               example_mask, dense_pads)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        self.aux_loss = aux_total
        x = self.norm(x)
        if cache is None and self.fused_head:
            w = self.lm_head.weight
            if tp is not None:
                w = gather_replicated(w, 0, tp.group)
            return x.to(self.dtype), w.t().to(self.dtype)
        if cache is not None and prefill and t > 1:
            x = x[:, -1:]
        if tp is None:
            return self.lm_head(x).float()
        logits = self.lm_head(copy_to(x, tp.group)).float()
        return gather_replicated(logits, logits.dim() - 1, tp.group)


def _refuse_later(quant="", lora_rank=0) -> None:
    check_lora_quant(quant, lora_rank)


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
    _refuse_later(quant, lora_rank)
    return LlamaLM(vocab_size, n_layer, n_head, n_kv_head, d_model, d_ff,
                   max_len, _dtype(bfloat16), attn_impl, rope_base, rms_eps,
                   window, device, kv_quant, remat, fused_head, param_dtype,
                   mesh, seq_layout, lora_rank, lora_alpha, quant=quant)


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
    _refuse_later(quant, lora_rank)
    return LlamaLM(vocab_size, n_layer, n_head, n_kv_head, d_model, d_ff,
                   max_len, _dtype(bfloat16), attn_impl, rope_base, rms_eps,
                   window, device, kv_quant, remat, fused_head, param_dtype,
                   mesh, lora_rank=lora_rank, lora_alpha=lora_alpha,
                   quant=quant)


@MODELS.register("MixtralMoE")
def mixtral_moe(vocab_size: int = 32000, n_layer: int = 32, n_head: int = 32,
                n_kv_head: int = 8, d_model: int = 4096, d_ff: int = 14336,
                max_len: int = 32768, window: int = 4096,
                num_experts: int = 8, top_k: int = 2, moe_every: int = 1,
                capacity_factor: float = 1.25,
                aux_loss_weight: float = 0.01,
                rope_base: float = 1e6, rms_eps: float = 1e-5,
                bfloat16: bool = True, attn_impl: str = "flash",
                remat: bool = True, mesh=None, fused_head: bool = True,
                device=None, param_dtype=None, **overrides):
    """Mixtral-8x7B's shape: the Mistral trunk (4:1 GQA, sliding window)
    with every FFN replaced by 8 routed SwiGLU experts, top-2 gating
    (models/moe.py, ``expert_act='swiglu'``); the expert weights shard over
    the ``expert`` mesh axis. ``overrides``: the other ``LlamaLM``
    arguments (``seq_layout``, ``kv_quant``, ``lora_rank``, ...)."""
    _refuse_later(overrides.get("quant", ""),
                  overrides.get("lora_rank", 0))
    return LlamaLM(vocab_size=vocab_size, n_layer=n_layer, n_head=n_head,
                   n_kv_head=n_kv_head, d_model=d_model, d_ff=d_ff,
                   max_len=max_len, dtype=_dtype(bfloat16),
                   attn_impl=attn_impl, rope_base=rope_base,
                   rms_eps=rms_eps, window=window, device=device,
                   remat=remat, fused_head=fused_head,
                   param_dtype=param_dtype, mesh=mesh,
                   moe_experts=num_experts, moe_top_k=top_k,
                   moe_every=moe_every, moe_capacity_factor=capacity_factor,
                   moe_aux_loss_weight=aux_loss_weight, **overrides)


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
    _refuse_later(quant, lora_rank)
    return LlamaLM(vocab_size, n_layer, n_head, n_kv_head, d_model, d_ff,
                   max_len, _dtype(bfloat16), attn_impl, 10000.0, 1e-6,
                   window, device, kv_quant, remat, fused_head, param_dtype,
                   mesh, seq_layout, lora_rank, lora_alpha, quant=quant)
