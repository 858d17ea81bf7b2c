"""ResNet family: the port of the JAX package's ``models/resnet.py``
(``BasicBlock``, ``BottleneckBlock``, ``ResNet`` and the registered
``ResNet18/34/50/101/152``).

- The loaders' NHWC ``[B, H, W, C]`` batch goes in; inside, the convs
  run on NCHW tensors in ``channels_last`` memory (the module is moved
  there at construction), which is cuDNN's fast layout and the NHWC
  bytes unchanged.
- Convs and the max pool use flax's ``SAME`` padding (models/layers.py:
  asymmetric where a window overhangs by an odd count); the convs have
  no bias and compute in the compute dtype (``bfloat16: true``) over
  float32 weights.
- BatchNorm is flax's (models/layers.py ``BatchNorm``: float32
  statistics, momentum 0.9, eps 1e-5, the biased variance, global
  statistics over the process group); the last norm of each residual
  branch starts with scale 0 (``zero_scale``), so every block starts as
  the identity.
- Stems, as in the JAX module: ``cifar_stem`` a 3x3/1 conv and no pool;
  ``space_to_depth`` each 2x2 pixel tile packed into channels, then a
  4x4/1 conv; and the default "ImageNet" stem, which in the JAX module
  has no conv at all: ``bn_init`` normalises the raw pixels, then the
  3x3/2 max pool (``models/resnet.py:112-133`` of the JAX package has no
  branch for a 7x7/2 conv). The port keeps that, so that its params and
  logits are the JAX module's (ROADMAP C lists it).
- The head: the spatial mean in the compute dtype, a float32 ``Dense``
  and ``log_softmax``.
- Submodules keep flax's names (``conv_init``, ``bn_init``,
  ``BasicBlock_0``/``BottleneckBlock_0`` with ``Conv_i``,
  ``BatchNorm_i``, ``conv_proj``, ``norm_proj``; ``head``), so
  ``models/convert.py`` maps the params and ``batch_stats`` one to one
  and ``observability/health.py`` groups them as the JAX package does.
- Init law (:meth:`ResNet.init_weights`): flax's, the conv and head
  kernels lecun-normal (a normal truncated at two deviations, std
  ``1 / sqrt(fan_in) / 0.8796``), biases 0, BN scale 1 (0 where zero-
  initialised), running mean 0 and variance 1.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..config.registry import MODELS
from .layers import BatchNorm, SameConv2d, max_pool_same


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, features: int, stride: int,
                 dtype, device=None):
        super().__init__()
        conv = dict(compute_dtype=dtype, param_dtype=torch.float32,
                    device=device)
        self.Conv_0 = SameConv2d(in_features, features, 3, stride, **conv)
        self.BatchNorm_0 = BatchNorm(features, device=device)
        self.Conv_1 = SameConv2d(features, features, 3, **conv)
        self.BatchNorm_1 = BatchNorm(features, zero_scale=True,
                                     device=device)
        if in_features != features or stride != 1:
            self.conv_proj = SameConv2d(in_features, features, 1, stride,
                                        **conv)
            self.norm_proj = BatchNorm(features, device=device)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        if hasattr(self, "conv_proj"):
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_features: int, features: int, stride: int,
                 dtype, device=None):
        super().__init__()
        conv = dict(compute_dtype=dtype, param_dtype=torch.float32,
                    device=device)
        out = features * 4
        self.Conv_0 = SameConv2d(in_features, features, 1, **conv)
        self.BatchNorm_0 = BatchNorm(features, device=device)
        self.Conv_1 = SameConv2d(features, features, 3, stride, **conv)
        self.BatchNorm_1 = BatchNorm(features, device=device)
        self.Conv_2 = SameConv2d(features, out, 1, **conv)
        self.BatchNorm_2 = BatchNorm(out, zero_scale=True, device=device)
        if in_features != out or stride != 1:
            self.conv_proj = SameConv2d(in_features, out, 1, stride, **conv)
            self.norm_proj = BatchNorm(out, device=device)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if hasattr(self, "conv_proj"):
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


class ResNet(nn.Module):
    """ResNet over NHWC inputs (the JAX ``ResNet``'s fields, plus
    ``device`` and ``param_dtype``, which must be float32)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 cifar_stem: bool = False, space_to_depth: bool = False,
                 dtype=torch.float32, input_shape=(224, 224, 3),
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.cifar_stem, self.space_to_depth = cifar_stem, space_to_depth
        self.input_shape = tuple(input_shape)
        self.stage_sizes = tuple(stage_sizes)
        conv = dict(compute_dtype=dtype, param_dtype=torch.float32,
                    device=device)
        channels = self.input_shape[2]
        if cifar_stem:
            self.conv_init = SameConv2d(channels, num_filters, 3, **conv)
            channels = num_filters
        elif space_to_depth:
            self.conv_init = SameConv2d(4 * channels, num_filters, 4, **conv)
            channels = num_filters
        self.bn_init = BatchNorm(channels, device=device)
        name = block_cls.__name__
        i = 0
        for stage, count in enumerate(self.stage_sizes):
            for j in range(count):
                stride = 2 if stage > 0 and j == 0 else 1
                features = num_filters * 2 ** stage
                self.add_module(f"{name}_{i}", block_cls(
                    channels, features, stride, dtype, device=device))
                channels = features * block_cls.expansion
                i += 1
        self.head = nn.Linear(channels, num_classes, device=device)
        self.to(memory_format=torch.channels_last)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for mod in self.modules():
            if isinstance(mod, BatchNorm):
                mod.reset()
            elif isinstance(mod, (nn.Conv2d, nn.Linear)):
                std = (mod.weight[0].numel() ** -0.5) / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()

    def blocks(self):
        return [m for m in self.children()
                if isinstance(m, (BasicBlock, BottleneckBlock))]

    def forward(self, x):
        """NHWC images ``[B, H, W, C]`` -> log-probabilities ``[B,
        classes]`` (float32)."""
        x = x.to(self.dtype)
        if self.space_to_depth:
            b, h, w, c = x.shape
            if h % 2 or w % 2:
                raise ValueError(f"space_to_depth requires even spatial "
                                 f"dims, got {h}x{w}")
            # each 2x2 tile into the channels, as the JAX reshape orders it
            x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(
                0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
        # NHWC bytes read as NCHW in channels_last memory
        x = x.permute(0, 3, 1, 2)
        if self.cifar_stem or self.space_to_depth:
            x = self.conv_init(x)
        x = F.relu(self.bn_init(x))
        if not self.cifar_stem:
            x = max_pool_same(x, 3, 2)
        for block in self.blocks():
            x = block(x)
        x = x.mean(dim=(2, 3))
        logits = self.head(x.float())
        return F.log_softmax(logits, dim=-1)

    def flops_per_example(self) -> float:
        """Forward FLOPs of one example at ``input_shape``: 2 k² C_in
        C_out H_out W_out per conv plus the head's 2 C classes (norms,
        pools and activations not counted)."""
        h, w, _ = self.input_shape
        total = 0.0

        def conv(mod, h, w):
            nonlocal total
            (k, _), (s, _) = mod.kernel_size, mod.stride
            ho, wo = -(-h // s), -(-w // s)
            total += 2.0 * k * k * mod.in_channels * mod.out_channels \
                * ho * wo
            return ho, wo

        if self.space_to_depth:
            h, w = h // 2, w // 2
        if self.cifar_stem or self.space_to_depth:
            h, w = conv(self.conv_init, h, w)
        if not self.cifar_stem:
            h, w = -(-h // 2), -(-w // 2)
        for block in self.blocks():
            convs = [block.Conv_0, block.Conv_1] + (
                [block.Conv_2] if isinstance(block, BottleneckBlock)
                else [])
            hi, wi = h, w
            for c in convs:
                h, w = conv(c, h, w)
            if hasattr(block, "conv_proj"):
                conv(block.conv_proj, hi, wi)
        return total + 2.0 * self.head.in_features * self.head.out_features


def _dtype(bfloat16: bool):
    return torch.bfloat16 if bfloat16 else torch.float32


def _register(name: str, stage_sizes, block_cls):
    @MODELS.register(name)
    def factory(num_classes: int = 1000, cifar_stem: bool = False,
                bfloat16: bool = False, space_to_depth: bool = False,
                input_shape: Optional[Sequence[int]] = None,
                device=None, param_dtype=None):
        if param_dtype not in (None, torch.float32):
            raise ValueError("ResNet keeps float32 params (flax's "
                             "param_dtype); bfloat16: true sets the compute")
        shape = tuple(input_shape) if input_shape else (
            (32, 32, 3) if cifar_stem else (224, 224, 3))
        if cifar_stem and space_to_depth:
            raise ValueError(
                "space_to_depth applies to the ImageNet 7x7 stem; "
                "it is incompatible with cifar_stem")
        return ResNet(stage_sizes, block_cls, num_classes=num_classes,
                      cifar_stem=cifar_stem, space_to_depth=space_to_depth,
                      dtype=_dtype(bfloat16), input_shape=shape,
                      device=device)
    factory.__name__ = name
    return factory


ResNet18 = _register("ResNet18", (2, 2, 2, 2), BasicBlock)
ResNet34 = _register("ResNet34", (3, 4, 6, 3), BasicBlock)
ResNet50 = _register("ResNet50", (3, 4, 6, 3), BottleneckBlock)
ResNet101 = _register("ResNet101", (3, 4, 23, 3), BottleneckBlock)
ResNet152 = _register("ResNet152", (3, 8, 36, 3), BottleneckBlock)
