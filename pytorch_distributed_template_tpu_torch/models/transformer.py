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
  again but adds nothing twice.

Left to later slices, each refused with a message naming it: decode
caches (serving the GPT-2 family), swiglu experts (other model families)
and expert parallelism, ring/Ulysses attention and zigzag layouts
(parallel axes), w8a16 weights and int8 KV (serving), LoRA.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..config.registry import MODELS
from ..ops.attention import multihead_attention
from ..ops.flash import flash_attention
from .layers import Dense, dropout, embed, fold_in, layer_norm_f32
from .moe import MoeMlp

_SLICE_PARALLEL = "a later slice (parallel axes)"
_SLICE_GPT2_SERVING = ("serving the GPT-2 family (its decode caches) is a "
                       "later slice")


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


class MlpBlock(nn.Module):
    def __init__(self, d_model: int, d_ff: int, rate: float, dtype,
                 device=None):
        super().__init__()
        self.rate = rate
        self.up = Dense(d_model, d_ff, compute_dtype=dtype,
                        param_dtype=torch.float32, device=device)
        self.down = Dense(d_ff, d_model, compute_dtype=dtype,
                          param_dtype=torch.float32, device=device)

    def forward(self, x, seed=None):
        y = self.down(F.gelu(self.up(x), approximate="tanh"))
        return dropout(y, self.rate, seed, self.training)


class SelfAttention(nn.Module):
    def __init__(self, d_model: int, n_head: int, rate: float, dtype,
                 attn_impl: str, device=None):
        super().__init__()
        self.n_head, self.rate, self.attn_impl = n_head, rate, attn_impl
        self.head_dim = d_model // n_head
        self.qkv = Dense(d_model, 3 * d_model, compute_dtype=dtype,
                         param_dtype=torch.float32, device=device)
        self.out = Dense(d_model, d_model, compute_dtype=dtype,
                         param_dtype=torch.float32, device=device)

    def forward(self, x, seed=None):
        b, t, d_model = x.shape
        qkv = self.qkv(x).view(b, t, 3, self.n_head, self.head_dim)
        q, k, v = (qkv[:, :, i].contiguous() for i in range(3))
        if self.attn_impl == "flash":
            ctx = flash_attention(q, k, v, causal=True)
        else:
            ctx = multihead_attention(q, k, v, causal=True)
        out = self.out(ctx.reshape(b, t, d_model))
        return dropout(out, self.rate, seed, self.training)


class Block(nn.Module):
    """Pre-LN block: attention, then the dense MLP or, with ``moe`` (the
    ``MoeMlp`` kwargs), the routed expert FFN. ``forward`` returns ``(x,
    aux)``: the MoE load-balancing loss in training mode, else None."""

    def __init__(self, d_model: int, n_head: int, d_ff: int, rate: float,
                 dtype, attn_impl: str, ln_eps: float, n_layer: int = 1,
                 moe: dict = None, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(d_model, ln_eps, device=device)
        self.attn = SelfAttention(d_model, n_head, rate, dtype, attn_impl,
                                  device=device)
        self.ln_2 = LayerNorm(d_model, ln_eps, device=device)
        if moe:
            self.moe = MoeMlp(d_model, d_ff, dropout=rate, n_layer=n_layer,
                              dtype=dtype, device=device, **moe)
        else:
            self.mlp = MlpBlock(d_model, d_ff, rate, dtype, device=device)

    def forward(self, x, seed=None, example_mask=None):
        x = x + self.attn(self.ln_1(x), _site(seed, 1))
        if hasattr(self, "moe"):
            y, aux = self.moe(self.ln_2(x), example_mask, _site(seed, 2))
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
                 moe_aux_loss_weight: float = 0.01, device=None):
        super().__init__()
        if attn_impl not in ("xla", "flash"):
            raise NotImplementedError(
                f"attn_impl={attn_impl!r}: sequence-parallel attention is "
                f"{_SLICE_PARALLEL}; this slice runs 'flash' and 'xla'")
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
        self.h = nn.ModuleList(
            Block(d_model, n_head, d_ff, dropout, dtype, attn_impl, ln_eps,
                  n_layer=n_layer,
                  moe=moe if self._is_moe_layer(i) else None, device=device)
            for i in range(n_layer))
        self.aux_loss = None
        self.ln_f = LayerNorm(d_model, ln_eps, device=device)
        if not tie_embeddings:
            self.lm_head = Dense(d_model, vocab_size, bias=False,
                                 compute_dtype=dtype,
                                 param_dtype=torch.float32, device=device)

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
            if name == "wpe":
                p.normal_(0.0, 0.01, generator=generator)
            elif ".ln_" in name or name.startswith("ln_f."):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith(("bias", "moe.bi", "moe.bo")):
                p.zero_()
            elif name.endswith(("attn.out.weight", "mlp.down.weight",
                                "moe.wo")):
                p.normal_(0.0, resid, generator=generator)
            else:
                p.normal_(0.0, 0.02, generator=generator)

    def new_cache(self, *args, **kwargs):
        raise NotImplementedError(_SLICE_GPT2_SERVING)

    def kv_cache_spec(self) -> dict:
        raise NotImplementedError(_SLICE_GPT2_SERVING)

    def forward(self, tokens, dropout_seed=None, example_mask=None):
        """tokens ``[B, T]`` -> f32 logits ``[B, T, V]``, or ``(hidden,
        head_w)`` in the compute dtype with ``fused_head``.
        ``dropout_seed`` seeds every dropout mask of the call (needed in
        training mode when dropout > 0). ``example_mask`` ([B] bool) marks
        the real rows of a padded batch for the MoE blocks (dense blocks
        are per token and ignore it). Sets ``self.aux_loss``."""
        b, t = tokens.shape
        if t > self.max_len:
            raise ValueError(f"sequence {t} exceeds max_len {self.max_len}")
        dt = self.dtype
        x = embed(self.wte.weight, tokens, dt) + self.wpe[:t].to(dt)[None]
        x = dropout(x, self.rate, _site(dropout_seed, 0), self.training)
        aux_total = None
        for i, block in enumerate(self.h):
            seed = _site(dropout_seed, i + 1)
            if self.remat and torch.is_grad_enabled():
                x, aux = checkpoint(block, x, seed, example_mask,
                                    use_reentrant=False)
            else:
                x, aux = block(x, seed, example_mask)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        self.aux_loss = aux_total
        x = self.ln_f(x)
        if self.fused_head:
            w = self.wte.weight if self.tie_embeddings \
                else self.lm_head.weight
            return x.to(dt), w.t().to(dt)
        if self.tie_embeddings:
            return (x.to(dt) @ self.wte.weight.to(dt).t()).float()
        return self.lm_head(x).float()


def _refuse_later(quant="", kv_quant="", lora_rank=0, mesh=None,
                  seq_layout="natural") -> None:
    if quant or kv_quant:
        raise NotImplementedError(
            f"quant={quant!r} / kv_quant={kv_quant!r}: "
            f"{_SLICE_GPT2_SERVING}")
    if lora_rank:
        raise NotImplementedError("LoRA fine-tuning is a later slice "
                                  "(other model families)")
    if mesh is not None or seq_layout != "natural":
        raise NotImplementedError(
            f"meshes and sequence layouts are {_SLICE_PARALLEL}")


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
    _refuse_later(cfg.pop("quant", ""), cfg.pop("kv_quant", ""),
                  cfg.pop("lora_rank", 0), mesh, seq_layout)
    cfg.pop("lora_alpha", None)
    return TransformerLM(vocab_size=vocab_size, max_len=max_len,
                         dropout=dropout, dtype=_dtype(bfloat16),
                         attn_impl=attn_impl, remat=remat,
                         fused_head=fused_head, device=device, **cfg)


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
    _refuse_later(quant, kv_quant, lora_rank, mesh, seq_layout)
    return TransformerLM(vocab_size=vocab_size, n_layer=n_layer,
                         n_head=n_head, d_model=d_model, max_len=max_len,
                         dropout=dropout, dtype=_dtype(bfloat16),
                         attn_impl=attn_impl, remat=remat,
                         fused_head=fused_head,
                         tie_embeddings=tie_embeddings, device=device)
