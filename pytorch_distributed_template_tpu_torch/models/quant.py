"""The int8 KV-cache leg of serving quantization: the port of the JAX
package's ``models/quant.py`` ``quantize_kv`` / ``dequantize_kv``.

Symmetric per-row int8: one f32 scale per head-dim vector (per token x kv
head), ``amax / 127`` so the row's largest magnitude maps to +-127, scale 1
for an all-zero row (zeros decode to zeros, so a zeroed cache stays a
valid empty cache), values ``round`` (half to even) then clipped to
[-127, 127]. On float32 input the bytes equal the JAX package's.

The weight leg (w8a16) is a later slice.
"""
from __future__ import annotations

import torch


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
