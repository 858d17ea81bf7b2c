"""LeNet-style MNIST CNN: the port of the JAX package's ``models/lenet.py``
(``LeNet``, alias ``MnistModel``).

Same layers in the same order: conv 5x5 VALID to 10, max-pool 2, relu;
conv 5x5 to 20, dropout 0.5, max-pool 2, relu; flatten; dense 50, relu,
dropout 0.5; dense 10; log-softmax. It takes the loaders' NHWC ``[B, 28,
28, 1]`` batch, runs NCHW inside (the ``nn.Conv2d`` layout), and flattens
the conv features in the JAX module's ``(h, w, c)`` order, so the flax
params convert without permuting ``Dense_0``'s rows
(``models/convert.py``). The submodules keep the flax names. Dropout masks
come from an explicit ``torch.Generator`` seeded per call
(``models/layers.Dropout``); setting a ``Dropout``'s ``p`` to 0 turns it
off.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..config.registry import MODELS
from .layers import Dropout, fold_in


class LeNet(nn.Module):
    def __init__(self, num_classes: int = 10, device=None,
                 param_dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=param_dtype or torch.float32)
        self.Conv_0 = nn.Conv2d(1, 10, kernel_size=5, **kw)
        self.Conv_1 = nn.Conv2d(10, 20, kernel_size=5, **kw)
        self.Dense_0 = nn.Linear(320, 50, **kw)
        self.Dense_1 = nn.Linear(50, num_classes, **kw)
        self.Dropout_0 = Dropout(0.5)
        self.Dropout_1 = Dropout(0.5)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's default law: kernels lecun-normal (a normal truncated at
        two deviations, std ``1 / sqrt(fan_in) / 0.8796``), biases 0."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            else:
                std = (p[0].numel() ** -0.5) / 0.87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)

    def forward(self, x, dropout_seed=None):
        """NHWC images ``[B, 28, 28, 1]`` -> log-probabilities ``[B, C]``.
        ``dropout_seed`` seeds both masks (needed in training while a
        rate is above 0)."""
        seeds = ((None, None) if dropout_seed is None
                 else (fold_in(dropout_seed, 0), fold_in(dropout_seed, 1)))
        # NCHW with standard strides: a bare permute of a one-channel
        # batch reads as channels-last too, and the conv's weight
        # gradient would then come back in strides DDP's buckets lack
        x = x.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)
        x = self.Conv_0(x)
        x = F.relu(F.max_pool2d(x, 2))
        x = self.Dropout_0(self.Conv_1(x), seeds[0])
        x = F.relu(F.max_pool2d(x, 2))
        x = x.permute(0, 2, 3, 1).flatten(1)       # (h, w, c), as in JAX
        x = self.Dropout_1(F.relu(self.Dense_0(x)), seeds[1])
        return F.log_softmax(self.Dense_1(x), dim=-1)


MODELS.register("LeNet")(LeNet)
MODELS.register("MnistModel")(LeNet)
