"""Optimizers and LR schedules: the port of the JAX package's
``engine/optim.py`` onto ``torch.optim``.

- ``AdamW`` and ``Adam`` take the JAX factories' torch-style args. Both build
  two parameter groups: parameters whose JAX path
  (``models.convert.flax_path``, e.g. ``h_0/attn/qkv/bias``) matches a
  ``weight_decay_exclude`` regex get no weight decay, exactly the tensors
  the JAX package's ``_decay_mask`` exempts. ``torch.optim.AdamW`` applies
  optax's ``adamw`` update, ``p <- p - lr (m_hat / (sqrt(v_hat) + eps) + wd
  p)``; ``torch.optim.Adam``'s ``weight_decay`` is the coupled L2 of
  optax's ``add_decayed_weights`` chained before ``adam``.
- Schedules are epoch-indexed scale factories ``f(epoch) -> scale``
  (``WarmupCosine``); :func:`build_optimizer` turns one into ``lr_fn(step)
  -> lr`` with the JAX package's convention: ``unit: "epoch"`` gives
  ``base * f(step // steps_per_epoch)`` (the epoch index is 0-based, so the
  first epoch runs at ``base / warmup_epochs``), ``unit: "step"`` gives
  ``base * f(step)``. ``step`` counts the optimizer updates applied, as
  optax's schedule count does (a step skipped for non-finite gradients
  advances neither). The train step sets each group's ``lr`` from it
  before every update.

The other optimizers, the other schedules and ``ReduceLROnPlateau`` are
registered so a config naming them fails with the slice they wait for.
"""
from __future__ import annotations

import math
import re

import torch

from ..config.registry import OPTIMIZERS, SCHEDULERS

_SLICE5 = "slice 5 (the training main path on LeNet/MNIST)"


def decay_groups(model, weight_decay: float, exclude=None) -> list:
    """``[{"params": decayed, "weight_decay": wd}, {"params": exempt,
    "weight_decay": 0.0}]``: a parameter is exempt when any regex of
    ``exclude`` matches its JAX path (``flax_path``)."""
    from ..models.convert import flax_path

    pats = [re.compile(p) for p in (exclude or ())]
    decay, exempt = [], []
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        path = flax_path(name)
        (exempt if any(pt.search(path) for pt in pats) else decay).append(p)
    groups = [{"params": decay, "weight_decay": float(weight_decay)}]
    if exempt:
        groups.append({"params": exempt, "weight_decay": 0.0})
    return groups


def _common(lr, learning_rate, mu_dtype):
    if mu_dtype:
        raise NotImplementedError(f"mu_dtype (a reduced-precision first "
                                  f"moment) is {_SLICE5}")
    return learning_rate if learning_rate is not None else lr


@OPTIMIZERS.register("AdamW")
def adamw(model, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01,
          learning_rate=None, weight_decay_exclude=None, mu_dtype=None):
    lr = _common(lr, learning_rate, mu_dtype)
    return torch.optim.AdamW(
        decay_groups(model, weight_decay, weight_decay_exclude), lr=lr,
        betas=tuple(betas), eps=eps)


@OPTIMIZERS.register("Adam")
def adam(model, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
         amsgrad=False, learning_rate=None, weight_decay_exclude=None,
         mu_dtype=None):
    lr = _common(lr, learning_rate, mu_dtype)
    if amsgrad:
        raise NotImplementedError(f"amsgrad is {_SLICE5}")
    return torch.optim.Adam(
        decay_groups(model, weight_decay, weight_decay_exclude), lr=lr,
        betas=tuple(betas), eps=eps)


def _later(registry, name: str) -> None:
    def refuse(*args, **kwargs):
        raise NotImplementedError(f"{name} is {_SLICE5}")

    registry.register(name)(refuse)


for _name in ("SGD", "RMSprop", "Adagrad", "Adadelta", "Adamax", "NAdam",
              "RAdam", "Adafactor", "LARS", "LAMB", "Lion"):
    _later(OPTIMIZERS, _name)


@SCHEDULERS.register("WarmupCosine")
def warmup_cosine(warmup_epochs: int, total_epochs: int,
                  min_ratio: float = 0.0):
    """Linear warmup over ``warmup_epochs`` (scale ``(e + 1) / warmup``),
    then a cosine decay to ``min_ratio`` by ``total_epochs``."""

    def f(epoch):
        if epoch < warmup_epochs:
            return (epoch + 1) / max(warmup_epochs, 1)
        frac = (epoch - warmup_epochs) / max(total_epochs - warmup_epochs, 1)
        cos = (1 + math.cos(math.pi * min(max(frac, 0.0), 1.0))) / 2
        return min_ratio + (1 - min_ratio) * cos

    return f


for _name in ("StepLR", "MultiStepLR", "ExponentialLR", "CosineAnnealingLR",
              "LinearLR", "ConstantLR", "PolynomialLR",
              "CosineAnnealingWarmRestarts", "ReduceLROnPlateau"):
    _later(SCHEDULERS, _name)


def build_optimizer(config, steps_per_epoch: int, model):
    """``(optimizer, lr_fn)`` from the config's ``optimizer`` and
    ``lr_scheduler`` blocks; ``lr_fn(step) -> lr`` for the ``step``-th
    applied update (0-based)."""
    opt_cfg = config["optimizer"]
    opt_args = dict(opt_cfg.get("args", {}))
    if opt_args.get("trainable"):
        raise NotImplementedError(f"optimizer.args.trainable (freezing "
                                  f"params) is {_SLICE5}")
    opt_args.pop("trainable", None)
    base_lr = opt_args.get("learning_rate", opt_args.get("lr", 1e-3))
    if base_lr is None:
        raise ValueError(f"optimizer {opt_cfg['type']!r} requires a "
                         "numeric lr")
    sched_cfg = config["lr_scheduler"] if "lr_scheduler" in config else None
    unit = (sched_cfg or {}).get("unit", "epoch")
    if unit not in ("epoch", "step"):
        raise ValueError(f"lr_scheduler unit must be epoch|step, got "
                         f"{unit!r}")
    scale_fn = None
    if sched_cfg:
        scale_fn = SCHEDULERS.get(sched_cfg["type"])(
            **sched_cfg.get("args", {}))

    if scale_fn is None:
        def lr_fn(step: int) -> float:
            return float(base_lr)
    elif unit == "step":
        def lr_fn(step: int) -> float:
            return float(base_lr * scale_fn(step))
    else:
        def lr_fn(step: int) -> float:
            return float(base_lr * scale_fn(step // max(steps_per_epoch, 1)))

    optimizer = OPTIMIZERS.get(opt_cfg["type"])(model, **opt_args)
    return optimizer, lr_fn

