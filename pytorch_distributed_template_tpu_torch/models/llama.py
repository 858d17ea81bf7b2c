"""Llama-family causal LM in PyTorch: RMSNorm + SwiGLU + RoPE + GQA.

Port of ``pytorch_distributed_template_tpu/models/llama.py`` for serving:
the plain forward and the decode forward over a KV cache, registered as
``Llama``, ``Mistral`` and ``TinyLlama`` with the JAX registry's defaults.

- Weights live in the compute dtype on the model's device (``bfloat16:
  true`` stores bf16); RMSNorm weights stay float32 and normalise in
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

Left to later slices, each refused with a message naming it: the paged
KV pool, sequence-parallel attention (ring, Ulysses), MoE, w8a16 weights,
the int8 KV cache, LoRA and the fused training head.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..config.registry import MODELS
from ..ops.attention import grouped_query_attention, multihead_attention
from ..ops.flash import flash_attention

_SLICE_TRAINING = "the training slice (flash backward kernels B2/B3)"
_SLICE_PAGED = "slice 2 (continuous engine + paged KV pool, kernel B4)"


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


@dataclass
class LayerCache:
    """One layer's decode cache. ``k``/``v``: ``[B, L, KVH, D]``;
    ``slot_pos`` (windowed models): ``[L]`` int32, the position each slot
    holds plus one, 0 meaning empty."""
    k: torch.Tensor
    v: torch.Tensor
    slot_pos: Optional[torch.Tensor] = None


@dataclass
class DecodeCache:
    """The model's decode state: per-layer caches plus the position
    counter that runs across calls (tokens fed so far)."""
    layers: List[LayerCache]
    pos_index: int = 0


class LlamaAttention(nn.Module):
    def __init__(self, d_model: int, n_head: int, n_kv_head: int,
                 attn_impl: str = "xla", rope_base: float = 10000.0,
                 window: int = 0, dtype=torch.float32, device=None):
        super().__init__()
        self.n_head, self.n_kv_head = n_head, n_kv_head
        self.head_dim = d_model // n_head
        self.attn_impl = attn_impl
        self.rope_base = rope_base
        self.window = window
        hd = self.head_dim
        lin = dict(bias=False, dtype=dtype, device=device)
        self.q_proj = nn.Linear(d_model, n_head * hd, **lin)
        self.k_proj = nn.Linear(d_model, n_kv_head * hd, **lin)
        self.v_proj = nn.Linear(d_model, n_kv_head * hd, **lin)
        self.o_proj = nn.Linear(n_head * hd, d_model, **lin)

    def forward(self, x, cache: Optional[LayerCache] = None, start: int = 0,
                prefill: bool = False):
        b, t, _ = x.shape
        hd = self.head_dim
        q = self.q_proj(x).view(b, t, self.n_head, hd)
        k = self.k_proj(x).view(b, t, self.n_kv_head, hd)
        v = self.v_proj(x).view(b, t, self.n_kv_head, hd)
        if cache is not None:
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

    def _cached_attention(self, q, k, v, cache: LayerCache, cur: int,
                          prefill: bool):
        """Decode against the layer cache, writing this call's K/V rows
        into it IN PLACE (the cache tensors are the decode state, owned by
        the caller's DecodeCache; nothing else aliases them).

        RoPE rotates the new rows at their absolute positions
        ``cur .. cur + t - 1``. ``prefill`` asserts a fresh cache
        (``cur == 0``): the call's own tokens are the whole context, so
        attention goes through the flash kernel. Otherwise the grouped GQA
        read attends over the cache with the visibility mask."""
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
        if rolling:
            if not fresh:
                # history (the ring, before this call's write) + the
                # call's own tokens, with the band mask
                hist_pos = cache.slot_pos.long() - 1          # -1 = empty
                k_all = torch.cat([cache.k, k.to(cache.k.dtype)], dim=1)
                v_all = torch.cat([cache.v, v.to(cache.v.dtype)], dim=1)
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
            for dst, src in ((cache.k, kw), (cache.v, vw)):
                dst[:, start:start + n1] = src[:, :n1]
                dst[:, :n_new - n1] = src[:, n1:]
            new_pos = torch.arange(first + 1, first + n_new + 1,
                                   dtype=cache.slot_pos.dtype,
                                   device=q.device)
            cache.slot_pos[start:start + n1] = new_pos[:n1]
            cache.slot_pos[:n_new - n1] = new_pos[n1:]
            if fresh:
                return flash_attention(q, k, v, causal=True, window=window)
            return grouped_query_attention(q, k_all, v_all,
                                           mask=visible[None, None])
        cache.k[:, cur:cur + t] = k
        cache.v[:, cur:cur + t] = v
        if fresh:
            return flash_attention(q, k, v, causal=True, window=window)
        k_pos = torch.arange(cache_len, device=q.device)[None, :]
        visible = k_pos <= pos[:, None]
        if window > 0:
            visible = visible & (pos[:, None] - k_pos < window)
        return grouped_query_attention(q, cache.k, cache.v,
                                       mask=visible[None, None])


class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        lin = dict(bias=False, dtype=dtype, device=device)
        self.gate_proj = nn.Linear(d_model, d_ff, **lin)
        self.up_proj = nn.Linear(d_model, d_ff, **lin)
        self.down_proj = nn.Linear(d_ff, d_model, **lin)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, d_model, n_head, n_kv_head, d_ff, attn_impl,
                 rope_base, rms_eps, window, dtype, device):
        super().__init__()
        self.input_layernorm = RMSNorm(d_model, rms_eps, device=device)
        self.self_attn = LlamaAttention(d_model, n_head, n_kv_head,
                                        attn_impl, rope_base, window,
                                        dtype=dtype, device=device)
        self.post_attention_layernorm = RMSNorm(d_model, rms_eps,
                                                device=device)
        self.mlp = SwiGLU(d_model, d_ff, dtype=dtype, device=device)

    def forward(self, x, cache=None, start: int = 0, prefill: bool = False):
        x = x + self.self_attn(self.input_layernorm(x), cache, start,
                               prefill)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaLM(nn.Module):
    """Decoder-only Llama-architecture causal LM."""

    def __init__(self, vocab_size: int = 32000, n_layer: int = 12,
                 n_head: int = 12, n_kv_head: int = 0, d_model: int = 768,
                 d_ff: int = 0, max_len: int = 2048,
                 dtype=torch.float32, attn_impl: str = "xla",
                 rope_base: float = 10000.0, rms_eps: float = 1e-6,
                 window: int = 0, device=None):
        super().__init__()
        n_kv = n_kv_head or n_head
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
        self.head_dim = d_model // n_head
        self.embed_tokens = nn.Embedding(vocab_size, d_model, dtype=dtype,
                                         device=device)
        self.layers = nn.ModuleList(
            LlamaBlock(d_model, n_head, n_kv, d_ff, attn_impl, rope_base,
                       rms_eps, window, dtype, device)
            for _ in range(n_layer))
        self.norm = RMSNorm(d_model, rms_eps, device=device)
        self.lm_head = nn.Linear(d_model, vocab_size, bias=False,
                                 dtype=dtype, device=device)

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

    def new_cache(self, batch: int, total: int) -> DecodeCache:
        """Zeroed decode cache for a ``[batch, total]`` budget."""
        n = self.cache_len(total)
        shape = (batch, n, self.n_kv_head, self.head_dim)
        dev = self.device
        layers = []
        for _ in range(self.n_layer):
            slot_pos = (torch.zeros(n, dtype=torch.int32, device=dev)
                        if self.window > 0 else None)
            layers.append(LayerCache(
                torch.zeros(shape, dtype=self.dtype, device=dev),
                torch.zeros(shape, dtype=self.dtype, device=dev),
                slot_pos))
        return DecodeCache(layers)

    def forward(self, tokens, cache: Optional[DecodeCache] = None,
                prefill: bool = False):
        """tokens ``[B, T]`` -> f32 logits ``[B, T, V]``.

        With ``cache``: decode forward from ``cache.pos_index``, which
        advances by ``T``. ``prefill=True`` asserts the cache is fresh and
        returns the last position's logits only (``[B, 1, V]``)."""
        b, t = tokens.shape
        x = self.embed_tokens(tokens)
        start = 0
        if cache is not None:
            start = cache.pos_index
            if prefill and start != 0:
                raise ValueError("prefill=True needs a fresh cache "
                                 f"(pos_index is {start})")
            cache.pos_index = start + t
        for i, block in enumerate(self.layers):
            layer_cache = cache.layers[i] if cache is not None else None
            x = block(x, layer_cache, start, prefill)
        x = self.norm(x)
        if cache is not None and prefill and t > 1:
            x = x[:, -1:]
        return self.lm_head(x).float()


def _refuse_later(quant="", kv_quant="", lora_rank=0, fused_head=False,
                  mesh=None, seq_layout="natural") -> None:
    if quant:
        raise NotImplementedError(
            f"quant={quant!r} (w8a16 serving weights) is a later slice")
    if kv_quant:
        raise NotImplementedError(
            f"kv_quant={kv_quant!r} (int8 KV cache) is {_SLICE_PAGED}")
    if lora_rank:
        raise NotImplementedError(f"LoRA is {_SLICE_TRAINING}")
    if fused_head:
        raise NotImplementedError(f"fused_head is {_SLICE_TRAINING}")
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
          lora_alpha: float = 16.0, device=None):
    """``remat`` and ``lora_alpha`` are training options: accepted so the
    JAX package's configs load, without effect on serving."""
    _refuse_later(quant, kv_quant, lora_rank, fused_head, mesh, seq_layout)
    return LlamaLM(vocab_size, n_layer, n_head, n_kv_head, d_model, d_ff,
                   max_len, _dtype(bfloat16), attn_impl, rope_base, rms_eps,
                   window, device)


@MODELS.register("Mistral")
def mistral(vocab_size: int = 32000, n_layer: int = 32, n_head: int = 32,
            n_kv_head: int = 8, d_model: int = 4096, d_ff: int = 14336,
            max_len: int = 32768, window: int = 4096,
            rope_base: float = 10000.0, rms_eps: float = 1e-5,
            bfloat16: bool = True, attn_impl: str = "flash",
            remat: bool = True, mesh=None, fused_head: bool = False,
            quant: str = "", kv_quant: str = "", lora_rank: int = 0,
            lora_alpha: float = 16.0, device=None):
    """Mistral-7B-v0.1 shape: the Llama architecture with 4:1 GQA and a
    4096-token sliding window."""
    _refuse_later(quant, kv_quant, lora_rank, fused_head, mesh)
    return LlamaLM(vocab_size, n_layer, n_head, n_kv_head, d_model, d_ff,
                   max_len, _dtype(bfloat16), attn_impl, rope_base, rms_eps,
                   window, device)


@MODELS.register("TinyLlama")
def tiny_llama(vocab_size: int = 256, n_layer: int = 2, n_head: int = 4,
               n_kv_head: int = 2, d_model: int = 64, d_ff: int = 0,
               max_len: int = 128, attn_impl: str = "xla",
               remat: bool = False, mesh=None, bfloat16: bool = False,
               seq_layout: str = "natural", window: int = 0,
               fused_head: bool = False, quant: str = "",
               kv_quant: str = "", lora_rank: int = 0,
               lora_alpha: float = 16.0, device=None):
    """Small GQA config for tests and dry runs."""
    _refuse_later(quant, kv_quant, lora_rank, fused_head, mesh, seq_layout)
    return LlamaLM(vocab_size, n_layer, n_head, n_kv_head, d_model, d_ff,
                   max_len, _dtype(bfloat16), attn_impl, 10000.0, 1e-6,
                   window, device)
