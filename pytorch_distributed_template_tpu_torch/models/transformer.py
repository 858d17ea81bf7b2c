"""GPT-2-family causal transformer LM in PyTorch, for training.

Port of ``pytorch_distributed_template_tpu/models/transformer.py``
(``MlpBlock``, ``SelfAttention``, ``Block``, ``TransformerLM``), registered
as ``GPT2`` and ``TinyLM`` with the JAX registry's defaults.

- Parameters are float32 (the flax modules' ``param_dtype``); with
  ``bfloat16: true`` the projections, the embedding lookup and the head run
  in bf16 over weights cast at use (models/layers.py), LayerNorm runs in
  float32, and the residual stream is bf16, as in the flax module.
- ``attn_impl``: ``"flash"`` (ops/flash.py: kernel B1 forward, B2/B3
  backward on the card) or ``"xla"`` (the plain einsum attention).
- ``remat``: each block runs under ``torch.utils.checkpoint``
  (non-reentrant) when gradients are on, the flax ``nn.remat`` with
  ``nothing_saveable``.
- ``fused_head``: the forward returns ``(hidden [B, T, D], head_w [D, V])``
  in the compute dtype for the chunked loss (engine/losses.py); the tied
  head's weight is the embedding transposed.
- Dropout after the embedding, the attention out-projection and the MLP,
  while the module is in training mode; masks come from
  ``forward(..., dropout_seed=...)`` folded with (layer, site), so a
  recomputed block redraws them (models/layers.py).
- Init law (:meth:`TransformerLM.init_weights`): N(0, 0.02), the ``out``
  and ``down`` projections N(0, 0.02/sqrt(2 n_layer)), ``wpe`` N(0, 0.01),
  LayerNorm ones and zeros, biases zero.

- MoE (``moe_experts > 0``, the ``MoeLM``/``TinyMoeLM`` family of
  models/moe.py): every ``moe_every``-th block takes a top-k routed expert
  FFN (``MoeMlp`` with gelu experts, parameter name ``moe`` as in the flax
  tree) in place of the dense MLP. ``forward(..., example_mask=...)``
  keeps padded examples out of expert capacity. In training mode each MoE
  block returns its weighted load-balancing loss beside its output and
  the forward sets ``model.aux_loss`` to their sum (None when there is
  none), once per call: a block recomputed under remat returns its value
  again but adds nothing twice. The blocks route over the global batch of
  the LM's ``mesh`` and split their experts over its ``expert`` axis
  (models/moe.py).

- Sequence parallelism (``attn_impl`` ``ring``, ``ring_flash``,
  ``ulysses``, ``ulysses_flash``; ops/attention.py): with a mesh whose
  ``seq`` axis is S > 1 (the LM's ``mesh``, set by
  ``models.base.inject_mesh`` and handed to the blocks with the layout),
  each rank embeds only its shard of the ``[B, T]`` row, the shard's
  tokens and the ``wpe`` rows of its global positions
  (:meth:`TransformerLM.seq_shard`), and returns the shard's logits (or
  hidden states) in the shard's order: the LM losses read their labels
  from the whole row (engine/losses.py). ``seq_layout: "zigzag"`` gives
  the ring impls the zigzag shards (JAX permutes the tokens before the
  blocks and back before the head; a rank here holds its zigzag shard
  throughout). Dropout folds the seq index into each site's seed, so the
  shards of a row draw different masks. With S == 1 the SP impls compute
  the whole attention (the flash kernels for ``*_flash``).

- Tensor parallelism (a mesh whose ``tensor`` axis is T > 1,
  :meth:`TransformerLM.use_tensor_axis`): each rank holds its slice of the
  Megatron placements of :meth:`TransformerLM.partition_rules` (JAX's
  rules over the torch dimensions) and computes on it: ``n_head / T``
  heads (``qkv`` split on the head dimension of its ``[3, H, hd, D]``
  view, :meth:`TransformerLM.split_view`, so a rank holds the q, k and v
  of its heads), ``d_ff / T`` MLP columns, ``vocab / T`` embedding rows.
  Megatron's ``f`` (parallel/collectives.py) goes before ``qkv``, ``up``
  and the tied head, its ``g`` after ``out`` and ``down`` (their
  replicated biases added once, after it) and after the vocab-sharded
  lookup (models/layers.py); the head's vocab-sharded logits, or under
  ``fused_head`` the head's weight, are gathered whole, and every rank of
  a tensor row computes the same loss. Dropout acts on the summed,
  replicated activations with the same seeds, so every rank of the row
  draws the same masks. The blocks are the fsdp gather units
  (:meth:`TransformerLM.fsdp_units`, parallel/fsdp.py). MoE blocks refuse
  a tensor axis (ROADMAP A11d's remainder), as does LoRA (A11b's
  remainder).
- ``causal`` (``SelfAttention``, ``Block``; default True): False gives
  the bidirectional attention of the BERT family (models/bert.py).
- LoRA (``lora_rank > 0``, ``lora_alpha``): every projection (``qkv``,
  ``out``, ``up``, ``down``, and an untied head that is not fused) is a
  ``models.lora.LoRADense`` (``models.quant.dense_factory``), as in the
  JAX family; the MoE experts and router stay dense.

- Decoding (serving, the JAX ``decode=True`` path): :meth:`TransformerLM.
  new_cache` allocates per-layer contiguous caches ``[B, L, H, D]`` in the
  compute dtype (int8 with f32 ``[B, L, H]`` scales under
  ``kv_quant="int8"``) and ``forward(tokens, cache=...)`` feeds ``tokens``
  at the cache's ``pos_index`` (the learned ``wpe`` rows of those
  positions), writing each layer's K/V rows in place. A fresh-cache
  ``prefill=True`` call with T > 1 attends through the flash kernel (B1)
  and returns the last position's logits only; every other cached call
  runs the masked plain attention over the filled prefix. Under int8 KV
  the history rows are read dequantized and the call's own rows exactly,
  as in JAX. Positions past ``pos_index`` are invisible, so a
  speculative rewind is setting ``pos_index`` back. MoE blocks route over
  the call's own tokens (no mesh, no ``example_mask``), as JAX's decode
  does. :meth:`TransformerLM.kv_cache_spec` is JAX's contract: no rotary,
  no window, not paged (a prefix pool serves this family through its
  scatter arm, engine/kvcache.py), K/V at ``n_head`` heads.
- ``quant="w8a16"`` (serving): the biased projections and an untied
  head are ``models.quant.W8A16Dense``; the tied head attends through the
  float embedding, as in JAX. MoE and ``fused_head`` refuse it
  (``validate_quant_config``).

Left to later slices, each refused with a message naming it: MoE blocks on
a seq or tensor axis (A11d's remainder), decoding on a seq axis, and
tensor-parallel serving of this family (A6a.5's remainder,
parallel/tp.py).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..config.registry import MODELS
from ..ops.attention import (
    SP_IMPLS, multihead_attention, seq_plan, sequence_attention,
)
from ..ops.flash import flash_attention
from ..parallel.collectives import copy_to, gather_replicated
from ..parallel.sharding import P
from .layers import (
    dropout, embed, fold_in, layer_norm_f32, row_parallel, vocab_embed,
)
from .llama import DecodeCache, LayerCache
from .moe import MoeMlp
from .quant import check_lora_quant, dense_factory, validate_quant_config
from .quant import dequantize_kv, quantize_kv

_ATTN_IMPLS = ("xla", "flash") + SP_IMPLS
_SLICE_MOE_SEQ = ("MoE blocks on a seq axis need the routing over the "
                  "whole sequence: ROADMAP A11d's remainder, a later slice")
#: folded into the dropout seed with the seq index: the shards of one row
#: must not repeat one mask
SEQ_DROPOUT_SALT = 0x5E0
_SLICE_MOE_TENSOR = ("MoE blocks on a tensor axis (MoeMlp's expert rules "
                     "over tensor, B5 on a split FFN): ROADMAP A11d's "
                     "remainder, a later slice")


def _site(seed, *where):
    return None if seed is None else fold_in(seed, *where)


class LayerNorm(nn.Module):
    """float32 scale and bias; normalises in float32 (flax ``LayerNorm(
    dtype=float32)``)."""

    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        return layer_norm_f32(x, self.weight, self.bias, self.eps)


def _biased(dtype, lora: dict, device, quant: str = ""):
    """The family's biased projections (``dense_factory``): float32 params,
    LoRA per ``lora`` (``lora_rank``, ``lora_alpha``), int8 under
    ``quant="w8a16"``."""
    return dense_factory(dtype, use_bias=True, param_dtype=torch.float32,
                         device=device, quant=quant, **(lora or {}))


class MlpBlock(nn.Module):
    def __init__(self, d_model: int, d_ff: int, rate: float, dtype,
                 device=None, lora: dict = None, quant: str = ""):
        super().__init__()
        self.rate = rate
        dense = _biased(dtype, lora, device, quant)
        self.up = dense(d_model, d_ff)
        self.down = dense(d_ff, d_model)
        self.tp = None      # the tensor axis (``use_tensor_axis``)

    def forward(self, x, seed=None):
        if self.tp is None:
            y = self.down(F.gelu(self.up(x), approximate="tanh"))
        else:
            h = F.gelu(self.up(copy_to(x, self.tp.group)),
                       approximate="tanh")
            y = row_parallel(self.down, h, self.tp)
        return dropout(y, self.rate, seed, self.training)


class SelfAttention(nn.Module):
    def __init__(self, d_model: int, n_head: int, rate: float, dtype,
                 attn_impl: str, device=None, causal: bool = True,
                 lora: dict = None, quant: str = ""):
        super().__init__()
        self.n_head, self.rate, self.attn_impl = n_head, rate, attn_impl
        self.causal = causal
        self.head_dim = d_model // n_head
        dense = _biased(dtype, lora, device, quant)
        self.qkv = dense(d_model, 3 * d_model)
        self.out = dense(d_model, d_model)
        self.tp = None      # the tensor axis (``use_tensor_axis``)

    def forward(self, x, seed=None, sp=None, cache=None, start: int = 0,
                prefill: bool = False):
        """``sp``: ``(positions, layout, mesh)`` of the seq axis
        (``TransformerLM.forward``), or None; ``cache``: this layer's
        ``LayerCache`` for a decode call at position ``start``."""
        b, t, d_model = x.shape
        tp, heads = self.tp, self.n_head
        if tp is not None:
            x, heads = copy_to(x, tp.group), heads // tp.size
        qkv = self.qkv(x).view(b, t, 3, heads, self.head_dim)
        q, k, v = (qkv[:, :, i].contiguous() for i in range(3))
        if cache is not None:
            ctx = self._cached_attention(q, k, v, cache, start, prefill)
        elif self.attn_impl in SP_IMPLS:
            _, layout, mesh = sp or (None, "contig", None)
            ctx = sequence_attention(q, k, v, self.attn_impl, mesh,
                                     causal=self.causal, layout=layout)
        elif self.attn_impl == "flash":
            ctx = flash_attention(q, k, v, causal=self.causal)
        else:
            ctx = multihead_attention(q, k, v, causal=self.causal)
        ctx = ctx.reshape(b, t, heads * self.head_dim)
        out = self.out(ctx) if tp is None else row_parallel(self.out, ctx,
                                                            tp)
        return dropout(out, self.rate, seed, self.training)

    def _cached_attention(self, q, k, v, cache: LayerCache, cur: int,
                          prefill: bool):
        """Decode against the layer cache (the JAX ``_cached_attention``),
        writing this call's K/V rows at ``cur ..`` IN PLACE. ``prefill``
        asserts a fresh cache: with T > 1 the call's own tokens are the
        whole context and attention runs through the flash kernel (B1).
        Otherwise the masked plain attention reads slots ``<= cur + i``
        for query ``i``. An int8 cache stores quantized rows; attention
        reads the history dequantized and the call's own rows exactly."""
        if not self.causal:
            raise ValueError("decode is autoregressive by construction; "
                             "bidirectional attention has no decode mode")
        t = q.shape[1]
        cache_len = cache.k.shape[1]
        if cur + t > cache_len:
            raise ValueError(f"decode input ends at {cur + t}, past the "
                             f"cache's {cache_len} slots")
        fresh = prefill and t > 1
        if cache.k_scale is not None:
            if not fresh:
                k_all = dequantize_kv(cache.k, cache.k_scale, k.dtype)
                v_all = dequantize_kv(cache.v, cache.v_scale, v.dtype)
                k_all[:, cur:cur + t] = k
                v_all[:, cur:cur + t] = v
            (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
            cache.k[:, cur:cur + t] = kq
            cache.v[:, cur:cur + t] = vq
            cache.k_scale[:, cur:cur + t] = ks
            cache.v_scale[:, cur:cur + t] = vs
        else:
            cache.k[:, cur:cur + t] = k.to(cache.k.dtype)
            cache.v[:, cur:cur + t] = v.to(cache.v.dtype)
            k_all, v_all = cache.k, cache.v
        if fresh:
            return flash_attention(q, k, v, causal=True)
        q_pos = torch.arange(cur, cur + t, device=q.device)
        visible = (torch.arange(cache_len, device=q.device)[None, :]
                   <= q_pos[:, None])
        return multihead_attention(q, k_all, v_all, causal=False,
                                   mask=visible[None, None])


class Block(nn.Module):
    """Pre-LN block: attention, then the dense MLP or, with ``moe`` (the
    ``MoeMlp`` kwargs), the routed expert FFN. ``forward`` returns ``(x,
    aux)``: the MoE load-balancing loss in training mode, else None."""

    def __init__(self, d_model: int, n_head: int, d_ff: int, rate: float,
                 dtype, attn_impl: str, ln_eps: float, n_layer: int = 1,
                 moe: dict = None, device=None, causal: bool = True,
                 lora: dict = None, quant: str = ""):
        super().__init__()
        self.ln_1 = LayerNorm(d_model, ln_eps, device=device)
        self.attn = SelfAttention(d_model, n_head, rate, dtype, attn_impl,
                                  device=device, causal=causal, lora=lora,
                                  quant=quant)
        self.ln_2 = LayerNorm(d_model, ln_eps, device=device)
        if moe:
            self.moe = MoeMlp(d_model, d_ff, dropout=rate, n_layer=n_layer,
                              dtype=dtype, device=device, **moe)
        else:
            self.mlp = MlpBlock(d_model, d_ff, rate, dtype, device=device,
                                lora=lora, quant=quant)

    def forward(self, x, seed=None, example_mask=None, sp=None, cache=None,
                start: int = 0, prefill: bool = False):
        x = x + self.attn(self.ln_1(x), _site(seed, 1), sp, cache, start,
                          prefill)
        if hasattr(self, "moe"):
            y, aux = self.moe(self.ln_2(x), example_mask, _site(seed, 2),
                              sp[2] if sp is not None else None)
            return x + y, aux
        return x + self.mlp(self.ln_2(x), _site(seed, 2)), None


class TransformerLM(nn.Module):
    """Decoder-only causal LM (GPT-2 shape family)."""

    def __init__(self, vocab_size: int = 50257, n_layer: int = 12,
                 n_head: int = 12, d_model: int = 768, d_ff: int = 0,
                 max_len: int = 1024, dropout: float = 0.1,
                 dtype=torch.float32, attn_impl: str = "xla",
                 remat: bool = False, fused_head: bool = False,
                 tie_embeddings: bool = True, ln_eps: float = 1e-5,
                 moe_experts: int = 0, moe_top_k: int = 2,
                 moe_every: int = 2, moe_capacity_factor: float = 1.25,
                 moe_aux_loss_weight: float = 0.01, mesh=None,
                 seq_layout: str = "natural", lora_rank: int = 0,
                 lora_alpha: float = 16.0, quant: str = "",
                 kv_quant: str = "", device=None):
        super().__init__()
        check_lora_quant(quant, lora_rank)
        validate_quant_config(quant, fused_head, moe_experts)
        if kv_quant not in ("", "int8"):
            raise ValueError(f"unknown kv_quant {kv_quant!r}")
        self.quant, self.kv_quant = quant, kv_quant
        if attn_impl not in _ATTN_IMPLS:
            raise ValueError(f"attn_impl={attn_impl!r}; expected one of "
                             f"{_ATTN_IMPLS}")
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} not divisible by n_head "
                             f"{n_head}")
        d_ff = d_ff or 4 * d_model
        self.vocab_size, self.n_layer, self.n_head = vocab_size, n_layer, \
            n_head
        self.d_model, self.d_ff, self.max_len = d_model, d_ff, max_len
        self.rate, self.dtype, self.attn_impl = dropout, dtype, attn_impl
        self.remat, self.fused_head = remat, fused_head
        self.tie_embeddings, self.ln_eps = tie_embeddings, ln_eps
        self.head_dim = d_model // n_head
        self.wte = nn.Embedding(vocab_size, d_model, device=device)
        self.wpe = nn.Parameter(torch.zeros(max_len, d_model, device=device))
        self.moe_experts, self.moe_every = moe_experts, moe_every
        moe = dict(num_experts=moe_experts, top_k=moe_top_k,
                   capacity_factor=moe_capacity_factor,
                   aux_loss_weight=moe_aux_loss_weight)
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha)
        self.h = nn.ModuleList(
            Block(d_model, n_head, d_ff, dropout, dtype, attn_impl, ln_eps,
                  n_layer=n_layer,
                  moe=moe if self._is_moe_layer(i) else None, device=device,
                  lora=lora, quant=quant)
            for i in range(n_layer))
        self.aux_loss = None
        self.ln_f = LayerNorm(d_model, ln_eps, device=device)
        if not tie_embeddings:
            # a fused head hands its plain kernel to the loss (JAX's
            # ``_HeadKernel``): no adapters there
            self.lm_head = dense_factory(
                dtype, param_dtype=torch.float32, device=device, quant=quant,
                **({} if fused_head else lora))(d_model, vocab_size)
        self.seq_layout = seq_layout
        # the parallel mesh whose seq axis the SP impls run over
        # (parallel/mesh.py); None until ``inject_mesh`` sets it
        self.mesh = mesh
        self.tp = None      # the tensor axis (``use_tensor_axis``)

    def partition_rules(self):
        """JAX's Megatron rules over ``tensor`` (``TransformerLM.
        partition_rules``), over the torch dimensions: column-parallel
        ``qkv`` and ``up`` (weight rows, bias), row-parallel ``out`` and
        ``down`` (weight columns), the vocab-sharded embedding and head;
        ``wpe`` pinned replicated; MoE blocks add MoeMlp's rules."""
        rules = [
            (r"wte/weight", P("tensor", None)),
            (r"attn/qkv/weight", P("tensor", None)),
            (r"attn/qkv/bias", P("tensor")),
            (r"attn/out/weight", P(None, "tensor")),
            (r"mlp/up/weight", P("tensor", None)),
            (r"mlp/up/bias", P("tensor")),
            (r"mlp/down/weight", P(None, "tensor")),
            (r"lm_head/weight", P("tensor", None)),
            (r"wpe", P()),
        ]
        if self.moe_experts > 0:
            rules = MoeMlp.partition_rules() + rules
        return rules

    def split_view(self, name: str, shape: tuple):
        """``(view, dim)`` a tensor split of ``name`` is taken in: the
        fused ``qkv`` as ``[3, H, hd, ...]`` on its head dimension; else
        None."""
        if name.endswith(("attn.qkv.weight", "attn.qkv.bias")):
            return (3, self.n_head, self.head_dim) + tuple(shape[1:]), 1
        return None

    def fsdp_units(self):
        """The fsdp gather units (parallel/fsdp.py): the blocks."""
        return [(f"h.{i}", block) for i, block in enumerate(self.h)]

    def use_tensor_axis(self, mesh) -> None:
        """Compute on this rank's shards of a tensor axis (module
        docstring); refuses what does not split over it."""
        tp = mesh.axis("tensor")
        if self.moe_experts > 0:
            raise NotImplementedError(_SLICE_MOE_TENSOR)
        for what, n in (("n_head", self.n_head), ("d_ff", self.d_ff),
                        ("vocab_size", self.vocab_size)):
            if n % tp.size:
                raise ValueError(f"{what} {n} does not split over a tensor "
                                 f"axis of {tp.size}")
        self.tp = tp
        for block in self.h:
            block.attn.tp = block.mlp.tp = tp

    def _seq_plan(self, t: int):
        if (self.moe_experts > 0 and self.mesh is not None
                and self.mesh.axis_size("seq") > 1):
            raise NotImplementedError(_SLICE_MOE_SEQ)
        return seq_plan(self.mesh, self.attn_impl, self.seq_layout, t,
                        self.wpe.device)

    def seq_shard(self, t: int):
        """The :class:`ops.attention.SeqShard` this rank's outputs hold of
        a ``[B, t]`` row, or None without a seq axis > 1."""
        return self._seq_plan(t)[0]

    def _is_moe_layer(self, i: int) -> bool:
        """The JAX ``_moe_kwargs`` rule: every ``moe_every``-th block."""
        return self.moe_experts > 0 and (i + 1) % self.moe_every == 0

    @property
    def device(self) -> torch.device:
        return self.wpe.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random init from ``generator`` with the flax module's law."""
        resid = 0.02 / (2 * self.n_layer) ** 0.5
        for name, p in self.named_parameters():
            if not p.is_floating_point():
                continue                 # w8a16 kernels: from a converter
            if name.endswith(".scale"):
                p.fill_(1.0)
            elif name == "wpe":
                p.normal_(0.0, 0.01, generator=generator)
            elif ".ln_" in name or name.startswith("ln_f."):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith(("bias", "moe.bi", "moe.bo", "lora_b")):
                p.zero_()
            elif name.endswith(("attn.out.weight", "mlp.down.weight",
                                "moe.wo")):
                p.normal_(0.0, resid, generator=generator)
            else:
                p.normal_(0.0, 0.02, generator=generator)

    def new_cache(self, batch: int, length: int) -> DecodeCache:
        """Zeroed decode cache for a ``[batch, length]`` budget: per layer
        K/V ``[B, L, H, D]`` in the compute dtype, or int8 with f32
        ``[B, L, H]`` scales under ``kv_quant`` (zero rows decode to
        zeros, as JAX's zeroed caches)."""
        shape = (int(batch), int(length), self.n_head, self.head_dim)
        dev = self.device
        layers = []
        for _ in range(self.n_layer):
            if self.kv_quant:
                layers.append(LayerCache(
                    torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.zeros(shape, dtype=torch.int8, device=dev), None,
                    torch.zeros(shape[:3], dtype=torch.float32, device=dev),
                    torch.zeros(shape[:3], dtype=torch.float32,
                                device=dev)))
            else:
                layers.append(LayerCache(
                    torch.zeros(shape, dtype=self.dtype, device=dev),
                    torch.zeros(shape, dtype=self.dtype, device=dev)))
        return DecodeCache(layers)

    def kv_cache_spec(self) -> dict:
        """The decode-cache layout contract engine/kvcache.py reads (the
        JAX ``kv_cache_spec``): positions live in the learned embedding, so
        cached rows carry no rotation and copy verbatim; no paged call
        path (a prefix pool serves through its scatter arm); K/V at all
        ``n_head`` heads."""
        return {"rotary": False, "rope_base": 0.0, "window": 0,
                "kv_quant": self.kv_quant, "paged": False,
                "kv_heads": int(self.n_head)}

    def forward(self, tokens, dropout_seed=None, example_mask=None,
                cache=None, prefill: bool = False):
        """tokens ``[B, T]`` -> f32 logits ``[B, T, V]``, or ``(hidden,
        head_w)`` in the compute dtype with ``fused_head``; on a seq axis
        S > 1 the shard's ``[B, T / S, ...]`` (:meth:`seq_shard`).
        ``dropout_seed`` seeds every dropout mask of the call (needed in
        training mode when dropout > 0). ``example_mask`` ([B] bool) marks
        the real rows of a padded batch for the MoE blocks (dense blocks
        are per token and ignore it). Sets ``self.aux_loss``.

        With a ``DecodeCache`` (:meth:`new_cache`): decode forward from
        ``cache.pos_index``, which advances by ``T``; ``prefill=True``
        asserts the cache is fresh and returns the last position's logits
        only (``[B, 1, V]``)."""
        b, t = tokens.shape
        if t > self.max_len:
            raise ValueError(f"sequence {t} exceeds max_len {self.max_len}")
        dt = self.dtype
        start = 0
        if cache is not None:
            if self.mesh is not None and self.mesh.axis_size("seq") > 1:
                raise NotImplementedError("decoding on a seq axis is a "
                                          "later slice (serving over "
                                          "parallel axes)")
            start = cache.pos_index
            if prefill and start != 0:
                raise ValueError("prefill=True needs a fresh cache "
                                 f"(pos_index is {start})")
            if start + t > self.max_len:
                raise ValueError(f"decode positions end at {start + t}, "
                                 f"past max_len {self.max_len}")
            cache.pos_index = start + t
            shard, layout = None, "contig"
        else:
            shard, layout = self._seq_plan(t)
        if cache is not None:
            pos = self.wpe[start:start + t]
        elif shard is None:
            pos = self.wpe[:t]
        else:
            # this rank's shard: its tokens and its global positions' rows
            tokens = tokens[:, shard.positions]
            pos = self.wpe[shard.positions]
            if dropout_seed is not None:
                dropout_seed = fold_in(dropout_seed, SEQ_DROPOUT_SALT,
                                       shard.index)
        sp = (None if cache is not None
              else (None if shard is None else shard.positions, layout,
                    self.mesh))
        tp = self.tp
        x = (embed(self.wte.weight, tokens, dt) if tp is None
             else vocab_embed(self.wte.weight, tokens, dt, tp))
        x = x + pos.to(dt)[None]
        x = dropout(x, self.rate, _site(dropout_seed, 0), self.training)
        aux_total = None
        for i, block in enumerate(self.h):
            seed = _site(dropout_seed, i + 1)
            if cache is not None:
                x, aux = block(x, seed, example_mask, None, cache.layers[i],
                               start, prefill)
            elif self.remat and torch.is_grad_enabled():
                x, aux = checkpoint(block, x, seed, example_mask, sp,
                                    use_reentrant=False)
            else:
                x, aux = block(x, seed, example_mask, sp)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        self.aux_loss = aux_total
        x = self.ln_f(x)
        if cache is not None and prefill and t > 1:
            x = x[:, -1:]
        if self.fused_head and cache is None:
            w = (self.wte.weight if self.tie_embeddings
                 else self.lm_head.weight)
            if tp is not None:
                w = gather_replicated(w, 0, tp.group)
            return x.to(dt), w.t().to(dt)
        if tp is not None:
            x = copy_to(x, tp.group)
        if self.tie_embeddings:
            w = self.wte.weight
            logits = (x.to(dt) @ w.to(dt).t()).float()
        else:
            logits = self.lm_head(x).float()
        if tp is not None:
            logits = gather_replicated(logits, logits.dim() - 1, tp.group)
        return logits


def _refuse_later(quant="", lora_rank=0) -> None:
    check_lora_quant(quant, lora_rank)


_GPT2_SIZES = {
    "gpt2-small": dict(n_layer=12, n_head=12, d_model=768),
    "gpt2-medium": dict(n_layer=24, n_head=16, d_model=1024),
    "gpt2-large": dict(n_layer=36, n_head=20, d_model=1280),
    "gpt2-xl": dict(n_layer=48, n_head=25, d_model=1600),
}


def _dtype(bfloat16: bool):
    return torch.bfloat16 if bfloat16 else torch.float32


def _check_param_dtype(param_dtype) -> None:
    """The family keeps float32 params (flax's); ``param_dtype`` is
    accepted for the trainer's uniform call and must say so."""
    if param_dtype not in (None, torch.float32):
        raise ValueError(f"the GPT-2 family stores float32 params, not "
                         f"{param_dtype}")


@MODELS.register("GPT2")
def gpt2(size: str = "gpt2-small", vocab_size: int = 50257,
         max_len: int = 1024, dropout: float = 0.1, bfloat16: bool = False,
         attn_impl: str = "xla", remat: bool = False, mesh=None,
         seq_layout: str = "natural", fused_head: bool = False,
         device=None, param_dtype=None, **overrides):
    _check_param_dtype(param_dtype)
    cfg = dict(_GPT2_SIZES[size])
    cfg.update(overrides)
    _refuse_later(cfg.get("quant", ""), cfg.get("lora_rank", 0))
    return TransformerLM(vocab_size=vocab_size, max_len=max_len,
                         dropout=dropout, dtype=_dtype(bfloat16),
                         attn_impl=attn_impl, remat=remat,
                         fused_head=fused_head, mesh=mesh,
                         seq_layout=seq_layout, device=device, **cfg)


@MODELS.register("TinyLM")
def tiny_lm(vocab_size: int = 256, n_layer: int = 2, n_head: int = 4,
            d_model: int = 64, max_len: int = 128, dropout: float = 0.0,
            attn_impl: str = "xla", remat: bool = False, mesh=None,
            bfloat16: bool = False, seq_layout: str = "natural",
            fused_head: bool = False, tie_embeddings: bool = True,
            quant: str = "", kv_quant: str = "", lora_rank: int = 0,
            lora_alpha: float = 16.0, device=None, param_dtype=None):
    """Small config for tests and dry runs."""
    _check_param_dtype(param_dtype)
    _refuse_later(quant, lora_rank)
    return TransformerLM(vocab_size=vocab_size, n_layer=n_layer,
                         n_head=n_head, d_model=d_model, max_len=max_len,
                         dropout=dropout, dtype=_dtype(bfloat16),
                         attn_impl=attn_impl, remat=remat,
                         fused_head=fused_head,
                         tie_embeddings=tie_embeddings, mesh=mesh,
                         seq_layout=seq_layout, lora_rank=lora_rank,
                         lora_alpha=lora_alpha, quant=quant,
                         kv_quant=kv_quant, device=device)
