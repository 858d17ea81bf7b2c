"""LoRA, low-rank adaptation for fine-tuning: the port of the JAX
package's ``models/lora.py`` (``LoRADense``, ``merge_lora_params``).

A LoRA layer keeps its pretrained ``weight`` (and ``bias``) frozen and
trains a rank-``r`` update: ``y = x W + (alpha / r) (x A) B``, with
``lora_a`` ``[in, r]`` drawn from N(0, 0.02) and ``lora_b`` ``[r, out]``
zeros, so step 0 reproduces the base model. ``weight`` and ``bias`` keep
the path of the ``Dense`` they replace, so a dense checkpoint grafts
straight in (``trainer.init_from``); the adapters are stored in flax's
layout (``models/convert.py`` moves them as they are).

The freeze is the JAX module's ``stop_gradient``: the base's weight
gradient is never computed (no ``x^T dy`` product), but a base parameter
that requires gradients gets a gradient of *zeros*, not none. That
matters to the optimizer: without ``optimizer.args.trainable`` AdamW
holds state for the base weights and decays them, ``w <- w - lr wd w``,
as optax's AdamW does on JAX's zero gradients; a base left with no
gradient would be skipped by torch's AdamW and stay fixed. With
``trainable: ["lora_"]`` the trainer turns ``requires_grad`` off for the
base (engine/optim.py ``freeze_untrainable``): no gradient, no state, no
update, and the base stays bitwise fixed.

Workflow (as the JAX package's):

    python -m pytorch_distributed_template_tpu_torch.train -c <config> \\
        --set "arch;args;lora_rank" 8 \\
        --set "optimizer;args;trainable" '["lora_"]' \\
        --set "trainer;init_from" '"<base run>/model_best"'
    python -m pytorch_distributed_template_tpu_torch.tools.merge_lora \\
        -r <fine-tune run>/model_best
    python -m pytorch_distributed_template_tpu_torch.generate \\
        -r <fine-tune run>/serving_merged/model_merged ...
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .layers import Dense

ADAPTER_LEAVES = ("lora_a", "lora_b")


class _FrozenBase(torch.autograd.Function):
    """Identity on ``y``; gives the frozen ``weight`` and ``bias`` zero
    gradients (a fill, no product) where they require gradients."""

    @staticmethod
    def forward(ctx, y, weight, bias):
        ctx.shapes = [(None if t is None else (t.shape, t.dtype, t.device))
                      for t in (weight, bias)]
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        zeros = [None if s is None or not need else
                 torch.zeros(s[0], dtype=s[1], device=s[2])
                 for s, need in zip(ctx.shapes, ctx.needs_input_grad[1:])]
        return (g, *zeros)


class LoRADense(Dense):
    """:class:`Dense` with a frozen base and a trainable low-rank update
    (module docstring). ``lora_a`` and ``lora_b`` are stored in
    ``param_dtype``, as the base."""

    def __init__(self, in_features: int, out_features: int, rank: int,
                 alpha: float = 16.0, bias: bool = True,
                 compute_dtype=torch.float32, param_dtype=None,
                 device=None):
        super().__init__(in_features, out_features, bias=bias,
                         compute_dtype=compute_dtype,
                         param_dtype=param_dtype, device=device)
        self.rank, self.alpha = int(rank), float(alpha)
        dt = param_dtype or compute_dtype
        self.lora_a = nn.Parameter(torch.empty(in_features, self.rank,
                                               dtype=dt, device=device))
        self.lora_b = nn.Parameter(torch.zeros(self.rank, out_features,
                                               dtype=dt, device=device))
        with torch.no_grad():
            self.lora_a.normal_(0.0, 0.02)

    def forward(self, x):
        dt = self.compute_dtype
        xd = x.to(dt)
        y = F.linear(xd, self.weight.detach().to(dt))
        y = y + (xd @ self.lora_a.to(dt)) @ self.lora_b.to(dt) * (
            self.alpha / self.rank)
        if self.bias is not None:
            y = y + self.bias.detach().to(dt)
        if torch.is_grad_enabled() and (
                self.weight.requires_grad
                or (self.bias is not None and self.bias.requires_grad)):
            y = _FrozenBase.apply(y, self.weight, self.bias)
        return y

    def extra_repr(self) -> str:
        return f"{super().extra_repr()}, rank={self.rank}, alpha={self.alpha}"


def merge_lora_params(state_dict, alpha: float = 16.0) -> dict:
    """Fold every layer's adapters into its weight, ``W + (alpha / r) (A
    B)^T`` in float32, cast back to the weight's dtype, and drop
    ``lora_a``/``lora_b``: the plain dense state dict a model built
    without ``lora_rank`` loads. ``alpha`` must be the model's
    ``lora_alpha`` (the rank is ``lora_a``'s second axis)."""
    out = {}
    for name, t in state_dict.items():
        prefix, _, leaf = name.rpartition(".")
        if leaf in ADAPTER_LEAVES:
            continue
        a = state_dict.get(f"{prefix}.lora_a") if prefix else None
        if leaf == "weight" and a is not None:
            a = a.float()
            b = state_dict[f"{prefix}.lora_b"].float()
            delta = (a @ b * (alpha / a.shape[1])).t()
            t = (t.float() + delta.to(t.device)).to(t.dtype)
        out[name] = t
    return out
