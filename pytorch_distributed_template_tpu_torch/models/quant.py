"""The int8 KV-cache leg of serving quantization and the linear-layer
dispatch: the port of the JAX package's ``models/quant.py``
``quantize_kv`` / ``dequantize_kv`` and ``dense_factory`` (its plain and
LoRA arms).

Symmetric per-row int8: one f32 scale per head-dim vector (per token x kv
head), ``amax / 127`` so the row's largest magnitude maps to +-127, scale 1
for an all-zero row (zeros decode to zeros, so a zeroed cache stays a
valid empty cache), values ``round`` (half to even) then clipped to
[-127, 127]. On float32 input the bytes equal the JAX package's.

The weight leg (w8a16) is a later slice (ROADMAP A4).
"""
from __future__ import annotations

import torch

from .layers import Dense

QUANT_LORA = ("lora_rank is a FINE-TUNING mode and quant a SERVING mode: "
              "merge the adapters first (tools/merge_lora.py), then "
              "quantize the merged checkpoint")


def check_lora_quant(quant: str, lora_rank: int) -> None:
    """The JAX ``dense_factory``'s refusal of LoRA with quantization."""
    if quant and lora_rank:
        raise ValueError(QUANT_LORA)


def dense_factory(dtype, use_bias: bool = False, lora_rank: int = 0,
                  lora_alpha: float = 16.0, param_dtype=None, device=None):
    """The linear-layer dispatch of the LM families, the JAX
    ``dense_factory`` without its w8a16 arm: ``f(in, out) -> module``, a
    :class:`LoRADense` when ``lora_rank > 0`` (models/lora.py), else a
    :class:`Dense`, computing in ``dtype`` over ``param_dtype`` params."""
    kw = dict(bias=use_bias, compute_dtype=dtype, param_dtype=param_dtype,
              device=device)
    if lora_rank:
        from .lora import LoRADense

        return lambda i, o: LoRADense(i, o, lora_rank, lora_alpha, **kw)
    return lambda i, o: Dense(i, o, **kw)


def quantize_kv(x):
    """Float K/V rows ``[..., D]`` -> ``(int8 [..., D], f32 scale [...])``."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype):
    """Inverse of :func:`quantize_kv`: f32 multiply, then cast to
    ``dtype`` (the attention compute dtype)."""
    return (q.float() * scale[..., None]).to(dtype)
