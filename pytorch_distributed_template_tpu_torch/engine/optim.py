"""Optimizers and LR schedules: the port of the JAX package's
``engine/optim.py`` onto ``torch.optim``.

- ``AdamW``, ``Adam`` and ``SGD`` take the JAX factories' torch-style args.
  Each builds two parameter groups: parameters whose JAX path
  (``models.convert.flax_path``, e.g. ``h_0/attn/qkv/bias``) matches a
  ``weight_decay_exclude`` regex get no weight decay, exactly the tensors
  the JAX package's ``_decay_mask`` exempts. ``torch.optim.AdamW`` applies
  optax's ``adamw`` update, ``p <- p - lr (m_hat / (sqrt(v_hat) + eps) + wd
  p)``; ``torch.optim.Adam``'s and ``torch.optim.SGD``'s ``weight_decay``
  is the coupled L2 of optax's ``add_decayed_weights`` chained before
  ``adam`` / ``sgd``. ``torch.optim.SGD`` (dampening 0) is optax's ``sgd``
  trace from the first step: ``t <- g + m t``, the update ``t`` or, with
  nesterov, ``g + m t``.
- ``Adam`` with ``amsgrad: true`` is :class:`AmsGrad`, optax's
  ``amsgrad``: the running max of the *bias-corrected* second moment.
  ``torch.optim.Adam(amsgrad=True)`` keeps the max of the raw moment and
  divides by the current step's correction, which drifts from optax by
  about one update after one large gradient.
- Schedules are epoch-indexed scale factories ``f(epoch) -> scale``
  (``StepLR`` ... ``CosineAnnealingWarmRestarts``, ``WarmupCosine``), each
  a pure function of the epoch; :func:`build_optimizer` turns one into
  ``lr_fn(step) -> lr`` with the JAX package's convention: ``unit:
  "epoch"`` gives ``base * f(step // steps_per_epoch)`` (the epoch index is
  0-based, so the first epoch runs at ``f(0)``), ``unit: "step"`` gives
  ``base * f(step)``. ``step`` counts the optimizer updates applied, as
  optax's schedule count does (a step skipped for non-finite gradients
  advances neither). The train step sets each group's ``lr`` from it
  before every update.

The other optimizers, ``mu_dtype``, ``trainable`` and
``ReduceLROnPlateau`` are registered so a config naming them fails with
the slice they wait for.
"""
from __future__ import annotations

import math
import re

import torch

from ..config.registry import OPTIMIZERS, SCHEDULERS
from ..utils.util import LATER_A17


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
                                  f"moment) is {LATER_A17}")
    return learning_rate if learning_rate is not None else lr


@OPTIMIZERS.register("AdamW")
def adamw(model, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01,
          learning_rate=None, weight_decay_exclude=None, mu_dtype=None):
    lr = _common(lr, learning_rate, mu_dtype)
    return torch.optim.AdamW(
        decay_groups(model, weight_decay, weight_decay_exclude), lr=lr,
        betas=tuple(betas), eps=eps)


class AmsGrad(torch.optim.Optimizer):
    """optax's ``amsgrad`` (behind ``add_decayed_weights`` when
    ``weight_decay`` is set), step for step in float32:

    ``g += wd p``; ``m <- (1 - b1) g + b1 m``; ``v <- (1 - b2) g^2 + b2 v``;
    ``v_max <- max(v_max, v / (1 - b2^t))``;
    ``p <- p - lr (m / (1 - b1^t)) / (sqrt(v_max) + eps)``.
    """

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            wd, lr, eps = group["weight_decay"], group["lr"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.float()
                if wd:
                    g = g + wd * p.float()
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    for k in ("mu", "nu", "nu_max"):
                        st[k] = torch.zeros_like(p, dtype=torch.float32)
                st["step"] += 1
                t = torch.tensor(float(st["step"]), dtype=torch.float32)
                st["mu"].mul_(b1).add_((1 - b1) * g)
                st["nu"].mul_(b2).add_((1 - b2) * (g * g))
                bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
                bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
                torch.maximum(st["nu_max"], st["nu"] / bc2.item(),
                              out=st["nu_max"])
                upd = (st["mu"] / bc1.item()) / (st["nu_max"].sqrt() + eps)
                p.add_((-lr * upd).to(p.dtype))


@OPTIMIZERS.register("Adam")
def adam(model, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
         amsgrad=False, learning_rate=None, weight_decay_exclude=None,
         mu_dtype=None):
    lr = _common(lr, learning_rate, mu_dtype)
    groups = decay_groups(model, weight_decay, weight_decay_exclude)
    if amsgrad:
        return AmsGrad(groups, lr=lr, betas=betas, eps=eps)
    return torch.optim.Adam(groups, lr=lr, betas=tuple(betas), eps=eps)


@OPTIMIZERS.register("SGD")
def sgd(model, lr=0.1, momentum=0.0, weight_decay=0.0, nesterov=False,
        learning_rate=None, weight_decay_exclude=None):
    return torch.optim.SGD(
        decay_groups(model, weight_decay, weight_decay_exclude),
        lr=_common(lr, learning_rate, None), momentum=momentum or 0.0,
        nesterov=bool(nesterov))


def _later(registry, name: str) -> None:
    def refuse(*args, **kwargs):
        raise NotImplementedError(f"{name} is {LATER_A17}")

    registry.register(name)(refuse)


for _name in ("RMSprop", "Adagrad", "Adadelta", "Adamax", "NAdam", "RAdam",
              "Adafactor", "LARS", "LAMB", "Lion"):
    _later(OPTIMIZERS, _name)


@SCHEDULERS.register("StepLR")
def step_lr(step_size: int, gamma: float = 0.1):
    return lambda epoch: gamma ** (epoch // step_size)


@SCHEDULERS.register("MultiStepLR")
def multi_step_lr(milestones, gamma: float = 0.1):
    ms = sorted(milestones)
    return lambda epoch: gamma ** sum(epoch >= m for m in ms)


@SCHEDULERS.register("ExponentialLR")
def exponential_lr(gamma: float):
    return lambda epoch: gamma ** epoch


@SCHEDULERS.register("CosineAnnealingLR")
def cosine_annealing_lr(T_max: int, eta_min_ratio: float = 0.0):
    def f(epoch):
        cos = (1 + math.cos(math.pi * min(epoch, T_max) / T_max)) / 2
        return eta_min_ratio + (1 - eta_min_ratio) * cos

    return f


@SCHEDULERS.register("LinearLR")
def linear_lr(start_factor: float = 1.0 / 3, end_factor: float = 1.0,
              total_iters: int = 5):
    """Ramp ``start_factor -> end_factor`` over ``total_iters`` epochs,
    then hold."""

    def f(epoch):
        frac = min(epoch, total_iters) / max(total_iters, 1)
        return start_factor + (end_factor - start_factor) * frac

    return f


@SCHEDULERS.register("ConstantLR")
def constant_lr(factor: float = 1.0 / 3, total_iters: int = 5):
    return lambda epoch: factor if epoch < total_iters else 1.0


@SCHEDULERS.register("PolynomialLR")
def polynomial_lr(total_iters: int = 5, power: float = 1.0):
    def f(epoch):
        return (1.0 - min(epoch, total_iters) / max(total_iters, 1)) ** power

    return f


@SCHEDULERS.register("CosineAnnealingWarmRestarts")
def cosine_annealing_warm_restarts(T_0: int, T_mult: int = 1):
    """Cosine cycles of ``T_0``, ``T_0 T_mult``, ... epochs; the cycle is
    found with integer arithmetic, so restarts land exactly."""
    if T_mult < 1:
        raise ValueError("T_mult must be >= 1")

    def f(epoch):
        t_cur, t_i = int(epoch), T_0
        if T_mult == 1:
            t_cur %= T_0
        while t_cur >= t_i:         # at most log_T_mult(epoch) cycles
            t_cur -= t_i
            t_i *= T_mult
        return (1 + math.cos(math.pi * t_cur / t_i)) / 2

    return f


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


_later(SCHEDULERS, "ReduceLROnPlateau")


def build_optimizer(config, steps_per_epoch: int, model):
    """``(optimizer, lr_fn)`` from the config's ``optimizer`` and
    ``lr_scheduler`` blocks; ``lr_fn(step) -> lr`` for the ``step``-th
    applied update (0-based)."""
    opt_cfg = config["optimizer"]
    opt_args = dict(opt_cfg.get("args", {}))
    if opt_args.get("trainable"):
        raise NotImplementedError(f"optimizer.args.trainable (freezing "
                                  f"params) is {LATER_A17}")
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

