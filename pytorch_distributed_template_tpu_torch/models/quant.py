"""Serving quantization and the linear-layer dispatch: the port of the
JAX package's ``models/quant.py``.

- **int8 KV cache** (``quantize_kv`` / ``dequantize_kv``): symmetric
  per-row int8, one f32 scale per head-dim vector (per token x kv head),
  ``amax / 127`` so the row's largest magnitude maps to +-127, scale 1 for
  an all-zero row (zeros decode to zeros, so a zeroed cache stays a valid
  empty cache), values ``round`` (half to even) then clipped to
  [-127, 127].
- **w8a16 weights** (:class:`W8A16Dense`, ``quantize_kernel_w8``,
  ``quantize_params_w8``, ``dequantize_params_w8``): a Dense stores an int8
  ``kernel_q`` ``[in, out]`` (flax's layout) and a per-output-channel f32
  ``scale`` ``[out]`` (``amax / 127`` over the column, 1 for an all-zero
  column), plus its f32 ``bias`` in the GPT-2 family. The product runs in
  the compute dtype on the int8 values cast to it, then the scale and the
  bias: ``(x @ w8) * s + b``, a plain product (the JAX package leaves it
  to XLA). Embeddings, norms, the MoE router and experts stay unquantized.

On float32 input the int8 bytes and the scales equal the JAX package's.
``dense_factory`` is the one linear-layer dispatch of the LM families:
plain, LoRA (models/lora.py) or w8a16.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import Dense

QUANT_LORA = ("lora_rank is a FINE-TUNING mode and quant a SERVING mode: "
              "merge the adapters first (tools/merge_lora.py), then "
              "quantize the merged checkpoint")


def check_lora_quant(quant: str, lora_rank: int) -> None:
    """The JAX ``dense_factory``'s refusal of LoRA with quantization."""
    if quant and lora_rank:
        raise ValueError(QUANT_LORA)


def validate_quant_config(quant: str, fused_head: bool = False,
                          moe_experts: int = 0) -> None:
    """The JAX ``validate_quant_config``: w8a16 is a serving mode of the
    plain models; a fused head (the training loss's raw head kernel) and
    MoE models (routers and experts stay dense) are refused up front."""
    if quant not in ("", "w8a16"):
        raise ValueError(f"unknown quant {quant!r} (w8a16 is the only "
                         "weight quantization)")
    if quant and (fused_head or moe_experts > 0):
        raise ValueError(
            f"quant={quant!r} supports plain serving models only — "
            "not fused_head (training-loss path) or MoE "
            f"(moe_experts={moe_experts})")


class W8A16Dense(nn.Module):
    """Dense over an int8 kernel and a per-output-channel scale (the JAX
    ``W8A16Dense``): ``kernel_q`` int8 ``[in, out]``, ``scale`` f32
    ``[out]``, optional f32 ``bias``; computes ``(x @ kernel_q) * scale +
    bias`` in ``compute_dtype``. The values come from
    :func:`quantize_params_w8`; the zeros here are placeholders."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = False, compute_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = compute_dtype
        self.kernel_q = nn.Parameter(
            torch.zeros(in_features, out_features, dtype=torch.int8,
                        device=device), requires_grad=False)
        self.scale = nn.Parameter(
            torch.ones(out_features, dtype=torch.float32, device=device),
            requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(out_features,
                                              dtype=torch.float32,
                                              device=device),
                                  requires_grad=False)
                     if bias else None)

    def forward(self, x):
        dt = self.compute_dtype
        y = x.to(dt) @ self.kernel_q.to(dt)
        y = y * self.scale.to(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


def dense_factory(dtype, use_bias: bool = False, lora_rank: int = 0,
                  lora_alpha: float = 16.0, param_dtype=None, device=None,
                  quant: str = ""):
    """The linear-layer dispatch of the LM families (the JAX
    ``dense_factory``): ``f(in, out) -> module``, a :class:`W8A16Dense`
    under ``quant="w8a16"``, a :class:`LoRADense` when ``lora_rank > 0``
    (models/lora.py), else a :class:`Dense`, computing in ``dtype`` over
    ``param_dtype`` params."""
    check_lora_quant(quant, lora_rank)
    if quant == "w8a16":
        return lambda i, o: W8A16Dense(i, o, bias=use_bias,
                                       compute_dtype=dtype, device=device)
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


#: state-dict modules whose 2-D ``weight`` is not a Dense kernel
_NOT_DENSE = ("wte", "embed_tokens", "router")


def quantize_kernel_w8(w) -> dict:
    """f32/bf16 ``[in, out]`` kernel (flax's layout) -> ``{"kernel_q":
    int8, "scale": f32 [out]}``: symmetric per output channel, the
    column's largest magnitude mapped to +-127, scale 1 for an all-zero
    column."""
    w = torch.as_tensor(w).float()
    amax = w.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127)
    return {"kernel_q": q.to(torch.int8), "scale": scale}


def quantize_params_w8(state: dict, device=None) -> dict:
    """Dense model state dict -> the w8a16 model's (the JAX
    ``quantize_params_w8``): every Dense's 2-D float ``<m>.weight``
    ``[out, in]`` becomes ``<m>.kernel_q`` ``[in, out]`` and ``<m>.scale``,
    its ``<m>.bias`` cast to f32; embeddings, norms, ``wpe``, the MoE
    router and the experts pass through unchanged. ``device``: where each
    kernel's arithmetic runs (default: where it lies)."""
    out = {}
    dense = set()
    for name, t in state.items():
        mod, _, leaf = name.rpartition(".")
        owner = mod.rpartition(".")[2]
        if (leaf == "weight" and t.dim() == 2 and t.is_floating_point()
                and owner not in _NOT_DENSE):
            w = t.detach() if device is None else t.detach().to(device)
            q = quantize_kernel_w8(w.t())
            out[f"{mod}.kernel_q"] = q["kernel_q"]
            out[f"{mod}.scale"] = q["scale"]
            dense.add(mod)
    for name, t in state.items():
        mod, _, leaf = name.rpartition(".")
        if mod in dense:
            if leaf == "bias":
                out[name] = t.detach().float()
        else:
            out[name] = t
    return out


def dequantize_params_w8(state: dict) -> dict:
    """Inverse layout of :func:`quantize_params_w8` (lossy values: the
    dequantized f32 kernels ``kernel_q * scale`` as ``<m>.weight``
    ``[out, in]``), for parity checks."""
    out = {}
    for name, t in state.items():
        mod, _, leaf = name.rpartition(".")
        if leaf == "kernel_q":
            w = t.float() * state[f"{mod}.scale"].float()[None, :]
            out[f"{mod}.weight"] = w.t().contiguous()
        elif leaf == "scale" and f"{mod}.kernel_q" in state:
            continue
        else:
            out[name] = t
    return out


def weight_bytes(state: dict) -> int:
    """Bytes of a state dict's tensors (the served weight footprint)."""
    return int(sum(t.numel() * t.element_size() for t in state.values()))
