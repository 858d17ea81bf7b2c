"""Optimizers and LR schedules: the port of the JAX package's
``engine/optim.py``, each optimizer computing what optax computes there.

- Every factory takes the JAX factory's torch-style args and builds
  parameter groups with :func:`decay_groups`: parameters whose JAX path
  (``models.convert.flax_path``, e.g. ``h_0/attn/qkv/bias``) matches a
  ``weight_decay_exclude`` regex get no weight decay, exactly the tensors
  the JAX package's ``_decay_mask`` exempts.
- ``AdamW``, ``Adam`` and ``SGD`` without ``mu_dtype`` are
  ``torch.optim``'s classes: ``torch.optim.AdamW`` applies optax's
  ``adamw`` update, ``p <- p - lr (m_hat / (sqrt(v_hat) + eps) + wd p)``;
  ``torch.optim.Adam``'s and ``torch.optim.SGD``'s ``weight_decay`` is the
  coupled L2 of optax's ``add_decayed_weights`` chained before ``adam`` /
  ``sgd``; ``torch.optim.SGD`` (dampening 0) is optax's ``sgd`` trace.
- The rest are :class:`OptaxOptimizer` subclasses, float32 state, each a
  transcription of optax's chain for one parameter (``torch.optim``'s
  classes of the same names compute something else):
  ``AmsGrad`` (the running max of the *bias-corrected* second moment),
  ``RMSprop`` (``g rsqrt(nu + eps)``, eps inside the root, the learning
  rate before the momentum trace), ``Adagrad`` (``rsqrt(sum + eps)`` over
  a 0.1 initial accumulator; eps 1e-10 as the JAX factory passes it),
  ``Adadelta``, ``Adamax``, ``NAdam`` (optax's ``adam(nesterov=True)``: no
  momentum decay schedule), ``RAdam`` (rectified past optax's threshold
  of 5), ``Adafactor`` (``scale_by_factored_rms`` with decay 0.8,
  matrices whose two largest dims are >= 128 factored into a row and a
  column moment, eps 1e-30; then ``clip_by_block_rms(1)``, the learning
  rate when there is one, ``scale_by_param_block_rms``, the decay *after*
  the learning rate, and the sign), ``LARS`` (decay, the trust ratio
  ``c |p| / |g|``, the learning rate, then a momentum trace), ``LAMB``
  (Adam, decay, the trust ratio ``|p| / |u|``) and ``Lion`` (the sign of
  an interpolated momentum, one moment buffer). RMSprop, Adagrad, Adamax,
  NAdam and RAdam take the coupled decay of the JAX package's
  ``_decayed``; Adadelta, Adafactor, LARS, LAMB and Lion their own.
- ``mu_dtype`` (``"bfloat16"``) keeps Adam's / AdamW's / AMSGrad's first
  moment in that type, as optax does: the moment is updated in float32
  from the stored one (``b1 m`` rounded to it, as a weakly typed product
  is there), used unrounded for this step's update and stored rounded
  (:class:`OptaxAdam`).
- ``optimizer.args.trainable`` (regexes over the JAX paths) freezes every
  other parameter, as the JAX package's ``_trainable_only``: frozen
  parameters are in no group, so they hold no optimizer state and get no
  update and no decay; the train step drops their gradients before the
  global norm (engine/steps.py). The trainer turns their
  ``requires_grad`` off before it wraps the model
  (:func:`freeze_untrainable`), so no gradient is computed for them: a
  LoRA fine-tune's frozen base holds neither gradients nor state.
- The train step multiplies the *final* update by ``lr_scale``
  (``ReduceLROnPlateau``), as the JAX step does: an ``OptaxOptimizer``
  reads it from its groups (``group["lr_scale"]``); for the
  ``torch.optim`` classes, whose learning rate is the chain's last factor,
  it scales the group's ``lr``.
- Schedules are epoch-indexed scale factories ``f(epoch) -> scale``
  (``StepLR`` ... ``CosineAnnealingWarmRestarts``, ``WarmupCosine``), each
  a pure function of the epoch; :func:`build_optimizer` turns one into
  ``lr_fn(step) -> lr`` with the JAX package's convention: ``unit:
  "epoch"`` gives ``base * f(step // steps_per_epoch)`` (the epoch index is
  0-based, so the first epoch runs at ``f(0)``), ``unit: "step"`` gives
  ``base * f(step)``. ``step`` counts the optimizer updates applied, as
  optax's schedule count does (a step skipped for non-finite gradients
  advances neither). The train step sets each group's ``lr`` from it
  before every update. ``ReduceLROnPlateau`` is a host-side
  :class:`PlateauController` (a copy of the JAX package's) that the
  trainer steps once per epoch on its monitored metric.
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch

from ..config.registry import OPTIMIZERS, SCHEDULERS


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


class Trainable:
    """``model`` seen through ``optimizer.args.trainable``: its
    ``named_parameters`` are those whose JAX path matches a regex of
    ``patterns`` (the optimizer factories build their groups from it)."""

    def __init__(self, model, patterns):
        from ..models.convert import flax_path

        pats = [re.compile(p) for p in patterns]
        self._named = [(n, p) for n, p in model.named_parameters()
                       if any(pt.search(flax_path(n)) for pt in pats)]

    def named_parameters(self):
        return iter(self._named)


def freeze_untrainable(model, patterns) -> int:
    """``requires_grad`` off for every parameter of ``model`` whose JAX
    path no regex of ``patterns`` (``optimizer.args.trainable``) matches;
    returns how many were frozen."""
    held = {id(p) for _, p in Trainable(model, patterns).named_parameters()}
    frozen = 0
    for p in model.parameters():
        if id(p) not in held and p.requires_grad:
            p.requires_grad_(False)
            frozen += 1
    return frozen


def _lr(lr, learning_rate):
    return learning_rate if learning_rate is not None else lr


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay ** count``, in float32."""
    return float(1 - _f32(decay) ** _f32(count))


def _ema(new, old, decay: float):
    """optax's ``update_moment``: ``(1 - decay) new + decay old``."""
    return (1 - decay) * new + decay * old


def _trust_ratio(u, p, coefficient: float = 1.0, eps: float = 0.0):
    """optax's ``scale_by_trust_ratio`` for one parameter: ``u`` times
    ``c |p| / (|u| + eps)``, or 1 when either norm is 0."""
    pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
    ratio = coefficient * pn / (un + eps)
    return u * torch.where((pn == 0) | (un == 0), torch.ones_like(ratio),
                           ratio)


class OptaxOptimizer(torch.optim.Optimizer):
    """Base of the optimizers written after optax's chains. A subclass
    defines ``_init(p, group) -> state`` and ``_update(p, g, state,
    group) -> u``: optax's final update for one parameter in float32 (the
    learning rate, its sign and the decay included), from the float32
    gradient ``g``. :meth:`step` applies ``p <- p + u lr_scale``
    (``group["lr_scale"]``, 1 unless the train step sets it)."""

    def __init__(self, params, defaults: dict):
        super().__init__(params, {"weight_decay": 0.0, "lr_scale": 1.0,
                                  **defaults})

    def _init(self, p, group) -> dict:
        return {}

    def _update(self, p, g, state, group):
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            scale = float(group.get("lr_scale", 1.0))
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(self._init(p, group))
                u = self._update(p.float(), p.grad.float(), state, group)
                if scale != 1.0:
                    u = u * scale
                p.add_(u.to(p.dtype))


def _coupled(g, p, group):
    """``add_decayed_weights`` chained before the optimizer (the JAX
    package's ``_decayed``): ``g + wd p``; absent when wd is 0."""
    wd = group["weight_decay"]
    return g + wd * p if wd else g


def _moment_dtype(mu_dtype) -> torch.dtype:
    if mu_dtype is None:
        return torch.float32
    dtype = getattr(torch, str(mu_dtype), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"mu_dtype {mu_dtype!r} is not a torch dtype")
    return dtype


class OptaxAdam(OptaxOptimizer):
    """optax's ``scale_by_adam`` (``nesterov`` for NAdam) or
    ``scale_by_amsgrad`` (``amsgrad``), with the coupled decay before it
    or, ``decoupled``, AdamW's decay after it, then the learning rate.
    The first moment is stored in ``mu_dtype`` (see the module
    docstring)."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, nesterov=False, amsgrad=False,
                 decoupled=False, mu_dtype=None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))
        self.nesterov, self.amsgrad = bool(nesterov), bool(amsgrad)
        self.decoupled = bool(decoupled)
        self.mu_dtype = _moment_dtype(mu_dtype)

    def _init(self, p, group):
        state = {"step": 0,
                 "mu": torch.zeros_like(p, dtype=self.mu_dtype),
                 "nu": torch.zeros_like(p, dtype=torch.float32)}
        if self.amsgrad:
            state["nu_max"] = torch.zeros_like(p, dtype=torch.float32)
        return state

    def _update(self, p, g, st, group):
        return -group["lr"] * self._adam(p, g, st, group)

    def _adam(self, p, g, st, group):
        """The update before the learning rate (AdamW's decay in it)."""
        b1, b2 = group["betas"]
        if not self.decoupled:
            g = _coupled(g, p, group)
        mu_old = st["mu"]
        if mu_old.dtype != torch.float32:
            # the stored moment's type: b1 rounds to it, and so does the
            # product (a weakly typed scalar times a bf16 array in JAX)
            b1_m = mu_old * torch.tensor(b1, dtype=mu_old.dtype)
        else:
            b1_m = b1 * mu_old
        mu = (1 - b1) * g + b1_m
        nu = _ema(g * g, st["nu"], b2)
        st["step"] += 1
        t = st["step"]
        if self.nesterov:
            mu_hat = (b1 * (mu / _bias_correction(b1, t + 1))
                      + (1 - b1) * (g / _bias_correction(b1, t)))
        else:
            mu_hat = mu / _bias_correction(b1, t)
        nu_hat = nu / _bias_correction(b2, t)
        if self.amsgrad:
            nu_hat = torch.maximum(st["nu_max"], nu_hat)
            st["nu_max"] = nu_hat
        u = mu_hat / (nu_hat.sqrt() + group["eps"])
        st["mu"], st["nu"] = mu.to(self.mu_dtype), nu
        if self.decoupled and group["weight_decay"]:
            u = u + group["weight_decay"] * p
        return u


class AmsGrad(OptaxAdam):
    """optax's ``amsgrad`` (behind ``add_decayed_weights`` when
    ``weight_decay`` is set), step for step in float32:

    ``g += wd p``; ``m <- (1 - b1) g + b1 m``; ``v <- (1 - b2) g^2 + b2 v``;
    ``v_max <- max(v_max, v / (1 - b2^t))``;
    ``p <- p - lr (m / (1 - b1^t)) / (sqrt(v_max) + eps)``.
    ``torch.optim.Adam(amsgrad=True)`` keeps the max of the raw moment and
    divides by the current step's correction, which drifts from optax by
    about one update after one large gradient.
    """

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, mu_dtype=None):
        super().__init__(params, lr=lr, betas=betas, eps=eps,
                         weight_decay=weight_decay, amsgrad=True,
                         mu_dtype=mu_dtype)


@OPTIMIZERS.register("AdamW")
def adamw(model, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01,
          learning_rate=None, weight_decay_exclude=None, mu_dtype=None):
    groups = decay_groups(model, weight_decay, weight_decay_exclude)
    lr = _lr(lr, learning_rate)
    if mu_dtype:
        return OptaxAdam(groups, lr=lr, betas=betas, eps=eps,
                         decoupled=True, mu_dtype=mu_dtype)
    return torch.optim.AdamW(groups, lr=lr, betas=tuple(betas), eps=eps)


@OPTIMIZERS.register("Adam")
def adam(model, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
         amsgrad=False, learning_rate=None, weight_decay_exclude=None,
         mu_dtype=None):
    lr = _lr(lr, learning_rate)
    groups = decay_groups(model, weight_decay, weight_decay_exclude)
    if amsgrad:
        return AmsGrad(groups, lr=lr, betas=betas, eps=eps,
                       mu_dtype=mu_dtype)
    if mu_dtype:
        return OptaxAdam(groups, lr=lr, betas=betas, eps=eps,
                         mu_dtype=mu_dtype)
    return torch.optim.Adam(groups, lr=lr, betas=tuple(betas), eps=eps)


@OPTIMIZERS.register("SGD")
def sgd(model, lr=0.1, momentum=0.0, weight_decay=0.0, nesterov=False,
        learning_rate=None, weight_decay_exclude=None):
    return torch.optim.SGD(
        decay_groups(model, weight_decay, weight_decay_exclude),
        lr=_lr(lr, learning_rate), momentum=momentum or 0.0,
        nesterov=bool(nesterov))


class RMSprop(OptaxOptimizer):
    """optax's ``rmsprop``: ``nu <- (1 - a) g^2 + a nu``, ``u = -lr g
    rsqrt(nu + eps)``, then (``momentum``) the trace ``t <- u + m t``."""

    def __init__(self, params, lr=1e-2, alpha=0.99, eps=1e-8, momentum=0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps,
                                      momentum=momentum or 0.0))

    def _init(self, p, group):
        state = {"nu": torch.zeros_like(p, dtype=torch.float32)}
        if group["momentum"]:
            state["trace"] = torch.zeros_like(p, dtype=torch.float32)
        return state

    def _update(self, p, g, st, group):
        g = _coupled(g, p, group)
        st["nu"] = _ema(g * g, st["nu"], group["alpha"])
        u = -group["lr"] * (torch.rsqrt(st["nu"] + group["eps"]) * g)
        if group["momentum"]:
            u = st["trace"] = u + group["momentum"] * st["trace"]
        return u


class Adagrad(OptaxOptimizer):
    """optax's ``adagrad``: ``s <- g^2 + s`` from 0.1, ``u = -lr g
    rsqrt(s + eps)`` (0 where ``s`` is 0)."""

    def __init__(self, params, lr=1e-2, eps=1e-10,
                 initial_accumulator_value=0.1):
        super().__init__(params, dict(lr=lr, eps=eps))
        self.initial = float(initial_accumulator_value)

    def _init(self, p, group):
        return {"sum": torch.full_like(p, self.initial,
                                       dtype=torch.float32)}

    def _update(self, p, g, st, group):
        g = _coupled(g, p, group)
        s = st["sum"] = g * g + st["sum"]
        inv = torch.where(s > 0, torch.rsqrt(s + group["eps"]),
                          torch.zeros_like(s))
        return -group["lr"] * (inv * g)


class Adadelta(OptaxOptimizer):
    """optax's ``adadelta``: ``g += wd p``; ``E[g^2] <- ema``; ``u =
    sqrt(E[dx^2] + eps) / sqrt(E[g^2] + eps) g``; ``E[dx^2] <- ema(u^2)``;
    then ``-lr u``."""

    def __init__(self, params, lr=1.0, rho=0.9, eps=1e-6):
        super().__init__(params, dict(lr=lr, rho=rho, eps=eps))

    def _init(self, p, group):
        return {"e_g": torch.zeros_like(p, dtype=torch.float32),
                "e_x": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, p, g, st, group):
        rho, eps = group["rho"], group["eps"]
        g = _coupled(g, p, group)
        st["e_g"] = _ema(g * g, st["e_g"], rho)
        u = (st["e_x"] + eps).sqrt() / (st["e_g"] + eps).sqrt() * g
        st["e_x"] = _ema(u * u, st["e_x"], rho)
        return -group["lr"] * u


class Adamax(OptaxOptimizer):
    """optax's ``adamax``: ``m <- ema(g)``, ``v <- max(|g| + eps, b2 v)``,
    ``u = -lr (m / (1 - b1^t)) / v``."""

    def __init__(self, params, lr=2e-3, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps))

    def _init(self, p, group):
        return {"step": 0, "mu": torch.zeros_like(p, dtype=torch.float32),
                "nu": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, p, g, st, group):
        b1, b2 = group["betas"]
        g = _coupled(g, p, group)
        st["step"] += 1
        st["mu"] = _ema(g, st["mu"], b1)
        st["nu"] = torch.maximum(g.abs() + group["eps"], b2 * st["nu"])
        mu_hat = st["mu"] / _bias_correction(b1, st["step"])
        return -group["lr"] * (mu_hat / st["nu"])


class RAdam(OptaxOptimizer):
    """optax's ``radam``: Adam's moments; while the variance's length
    ``rho_t`` is under the threshold (5) the update is the corrected
    momentum alone, past it rectified by ``r_t``; the scalars in float32
    in optax's order."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 threshold=5.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      threshold=threshold))

    def _init(self, p, group):
        return {"step": 0, "mu": torch.zeros_like(p, dtype=torch.float32),
                "nu": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, p, g, st, group):
        b1, b2 = group["betas"]
        g = _coupled(g, p, group)
        st["mu"] = _ema(g, st["mu"], b1)
        st["nu"] = _ema(g * g, st["nu"], b2)
        st["step"] += 1
        t = st["step"]
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = _f32(b2) ** _f32(t)
        ro = _f32(ro_inf) - 2 * t * b2t / (1 - b2t)
        mu_hat = st["mu"] / _bias_correction(b1, t)
        if float(ro) >= group["threshold"]:
            nu_hat = st["nu"] / _bias_correction(b2, t)
            r = torch.sqrt((ro - 4.0) * (ro - 2.0) * _f32(ro_inf)
                           / (_f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
            u = float(r) * mu_hat / (nu_hat.sqrt() + group["eps"])
        else:
            u = mu_hat
        return -group["lr"] * u


def _factored_dims(shape, min_dim: int = 128):
    """optax's ``_factored_dims``: ``(d1, d0)``, the second-largest and the
    largest dim, when there are two dims and the second-largest is at
    least ``min_dim``; else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


def jax_axes(name: str, p) -> tuple:
    """For each axis of parameter ``name``'s JAX array, the port's axis:
    a dense kernel is transposed (``[in, out]`` against ``[out, in]``), a
    conv kernel is ``HWIO`` against ``OIHW``; the rest share the layout."""
    from ..models.convert import flax_path

    if flax_path(name).endswith("kernel"):
        return (2, 3, 1, 0) if p.dim() == 4 else (1, 0)
    return tuple(range(p.dim()))


class Adafactor(OptaxOptimizer):
    """optax's ``adafactor`` with the JAX factory's defaults (decay 0.8,
    factoring from dims of 128, eps 1e-30, clipping 1, parameter scale
    on, no momentum). ``lr`` None is optax's relative-step mode: no
    learning-rate factor (the group's ``lr`` is ignored). State: a row
    and a column moment per factored matrix, else one moment the shape
    of the parameter. Which two axes factor is decided on the JAX
    array's shape (``axes``: parameter -> :func:`jax_axes`), so a square
    kernel factors as it does there."""

    def __init__(self, params, lr=None, decay_rate=0.8, min_dim_size=128,
                 eps=1e-30, clipping_threshold=1.0, min_scale=1e-3,
                 axes=None):
        super().__init__(params, dict(lr=lr))
        self.relative_step = lr is None
        self.decay_rate, self.min_dim = float(decay_rate), int(min_dim_size)
        self.eps, self.clip = float(eps), float(clipping_threshold)
        self.min_scale = float(min_scale)
        self.axes = axes or {}

    def _dims(self, p):
        """``(d1, d0)`` in the port's axes, or None (not factored)."""
        axes = self.axes.get(p, tuple(range(p.dim())))
        dims = _factored_dims(tuple(p.shape[a] for a in axes), self.min_dim)
        return None if dims is None else (axes[dims[0]], axes[dims[1]])

    def _init(self, p, group):
        dims = self._dims(p)
        if dims is None:
            return {"step": 0, "v": torch.zeros_like(p, dtype=torch.float32)}
        d1, d0 = dims
        return {"step": 0,
                "v_row": torch.zeros_like(p.float().select(d0, 0)),
                "v_col": torch.zeros_like(p.float().select(d1, 0))}

    def _update(self, p, g, st, group):
        decay = float(1.0 - _f32(st["step"] + 1) ** _f32(-self.decay_rate))
        st["step"] += 1
        g2 = g * g + self.eps
        dims = self._dims(p)
        if dims is None:
            st["v"] = decay * st["v"] + (1.0 - decay) * g2
            u = g * st["v"] ** -0.5
        else:
            d1, d0 = dims
            st["v_row"] = decay * st["v_row"] + (1.0 - decay) * g2.mean(d0)
            st["v_col"] = decay * st["v_col"] + (1.0 - decay) * g2.mean(d1)
            reduced = d1 - 1 if d1 > d0 else d1
            row_mean = st["v_row"].mean(reduced, keepdim=True)
            row = (st["v_row"] / row_mean) ** -0.5
            col = st["v_col"] ** -0.5
            u = g * row.unsqueeze(d0) * col.unsqueeze(d1)
        # clip_by_block_rms, the lr, scale_by_param_block_rms
        u = u / torch.clamp((u * u).mean().sqrt() / self.clip, min=1.0)
        if not self.relative_step:
            u = group["lr"] * u
        rms = (p * p).mean().sqrt()
        u = u * torch.where(rms <= self.min_scale,
                            torch.full_like(rms, self.min_scale), rms)
        if group["weight_decay"]:
            u = u + group["weight_decay"] * p
        return -u


class LARS(OptaxOptimizer):
    """optax's ``lars``: ``g += wd p``; the trust ratio ``c |p| / |g|``;
    ``-lr``; then the momentum trace ``t <- u + m t``."""

    def __init__(self, params, lr=1.0, momentum=0.9, trust_coefficient=1e-3,
                 eps=0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      trust_coefficient=trust_coefficient,
                                      eps=eps))

    def _init(self, p, group):
        return {"trace": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, p, g, st, group):
        g = _coupled(g, p, group)
        u = -group["lr"] * _trust_ratio(g, p, group["trust_coefficient"],
                                        group["eps"])
        st["trace"] = u + group["momentum"] * st["trace"]
        return st["trace"]


class LAMB(OptaxAdam):
    """optax's ``lamb``: Adam's update (eps outside the root), ``+ wd
    p``, times the trust ratio ``|p| / |u|``, then ``-lr``."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-6):
        super().__init__(params, lr=lr, betas=betas, eps=eps,
                         decoupled=True)

    def _update(self, p, g, st, group):
        return -group["lr"] * _trust_ratio(self._adam(p, g, st, group), p)


class Lion(OptaxOptimizer):
    """optax's ``lion``: ``u = sign((1 - b1) g + b1 m)``, ``m <- (1 - b2) g
    + b2 m``, ``+ wd p``, then ``-lr``. One moment buffer."""

    def __init__(self, params, lr=1e-4, betas=(0.9, 0.99)):
        super().__init__(params, dict(lr=lr, betas=tuple(betas)))

    def _init(self, p, group):
        return {"mu": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, p, g, st, group):
        b1, b2 = group["betas"]
        u = torch.sign((1.0 - b1) * g + b1 * st["mu"])
        st["mu"] = _ema(g, st["mu"], b2)
        if group["weight_decay"]:
            u = u + group["weight_decay"] * p
        return -group["lr"] * u


@OPTIMIZERS.register("RMSprop")
def rmsprop(model, lr=1e-2, alpha=0.99, eps=1e-8, momentum=0.0,
            weight_decay=0.0, learning_rate=None, weight_decay_exclude=None):
    return RMSprop(decay_groups(model, weight_decay, weight_decay_exclude),
                   lr=_lr(lr, learning_rate), alpha=alpha, eps=eps,
                   momentum=momentum)


@OPTIMIZERS.register("Adagrad")
def adagrad(model, lr=1e-2, eps=1e-10, weight_decay=0.0, learning_rate=None,
            weight_decay_exclude=None):
    return Adagrad(decay_groups(model, weight_decay, weight_decay_exclude),
                   lr=_lr(lr, learning_rate), eps=eps)


@OPTIMIZERS.register("Adadelta")
def adadelta(model, lr=1.0, rho=0.9, eps=1e-6, weight_decay=0.0,
             learning_rate=None, weight_decay_exclude=None):
    return Adadelta(decay_groups(model, weight_decay, weight_decay_exclude),
                    lr=_lr(lr, learning_rate), rho=rho, eps=eps)


@OPTIMIZERS.register("Adamax")
def adamax(model, lr=2e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
           learning_rate=None, weight_decay_exclude=None):
    return Adamax(decay_groups(model, weight_decay, weight_decay_exclude),
                  lr=_lr(lr, learning_rate), betas=betas, eps=eps)


@OPTIMIZERS.register("NAdam")
def nadam(model, lr=2e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
          learning_rate=None, weight_decay_exclude=None):
    return OptaxAdam(decay_groups(model, weight_decay, weight_decay_exclude),
                     lr=_lr(lr, learning_rate), betas=betas, eps=eps,
                     nesterov=True)


@OPTIMIZERS.register("RAdam")
def radam(model, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
          learning_rate=None, weight_decay_exclude=None):
    return RAdam(decay_groups(model, weight_decay, weight_decay_exclude),
                 lr=_lr(lr, learning_rate), betas=betas, eps=eps)


@OPTIMIZERS.register("Adafactor")
def adafactor(model, lr=None, weight_decay=0.0, learning_rate=None,
              weight_decay_exclude=None):
    """Factored second moments (Shazeer & Stern 2018): O(n + m) state per
    factored [n, m] matrix; ``lr`` None is the relative-step mode."""
    return Adafactor(decay_groups(model, weight_decay, weight_decay_exclude),
                     lr=_lr(lr, learning_rate),
                     axes={p: jax_axes(n, p)
                           for n, p in model.named_parameters()})


@OPTIMIZERS.register("LARS")
def lars(model, lr=1.0, momentum=0.9, weight_decay=0.0,
         trust_coefficient=0.001, learning_rate=None,
         weight_decay_exclude=None):
    return LARS(decay_groups(model, weight_decay, weight_decay_exclude),
                lr=_lr(lr, learning_rate), momentum=momentum,
                trust_coefficient=trust_coefficient)


@OPTIMIZERS.register("LAMB")
def lamb(model, lr=1e-3, betas=(0.9, 0.999), eps=1e-6, weight_decay=0.0,
         learning_rate=None, weight_decay_exclude=None):
    return LAMB(decay_groups(model, weight_decay, weight_decay_exclude),
                lr=_lr(lr, learning_rate), betas=betas, eps=eps)


@OPTIMIZERS.register("Lion")
def lion(model, lr=1e-4, betas=(0.9, 0.99), weight_decay=0.0,
         learning_rate=None, weight_decay_exclude=None):
    return Lion(decay_groups(model, weight_decay, weight_decay_exclude),
                lr=_lr(lr, learning_rate), betas=betas)


def set_lr(optimizer, lr: float, lr_scale: float = 1.0) -> None:
    """Every group's learning rate for the next update, and the plateau
    scale of its final update (see the module docstring)."""
    for group in optimizer.param_groups:
        if isinstance(optimizer, OptaxOptimizer):
            group["lr"], group["lr_scale"] = lr, lr_scale
        else:
            group["lr"] = lr * lr_scale


def state_bytes(optimizer) -> int:
    """Bytes of the optimizer's per-parameter state tensors (its scalar
    counters left out)."""
    return sum(v.numel() * v.element_size()
               for st in optimizer.state.values() for v in st.values()
               if torch.is_tensor(v) and v.dim() > 0)


def expected_state_bytes(optimizer) -> int:
    """The state bytes the parameter shapes give once every parameter has
    taken a step: Adam-type 2 x 4 B per element (a bf16 ``mu`` 2 + 4 B,
    AMSGrad's max 4 B more), Adadelta, Adamax and RAdam 8 B, RMSprop 4 B
    (8 B with momentum), Adagrad, LARS and Lion 4 B, SGD 4 B with
    momentum, and Adafactor a row and a column (4 B each) per factored
    matrix, else 4 B per element."""
    per = {Adadelta: 8, Adamax: 8, RAdam: 8, Adagrad: 4, LARS: 4, Lion: 4}
    total = 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            n = p.numel()
            if isinstance(optimizer, Adafactor):
                dims = optimizer._dims(p)
                total += 4 * (n if dims is None else
                              n // p.shape[dims[1]] + n // p.shape[dims[0]])
            elif isinstance(optimizer, OptaxAdam):
                size = torch.empty((), dtype=optimizer.mu_dtype)
                total += n * (size.element_size() + 4
                              + 4 * optimizer.amsgrad)
            elif isinstance(optimizer, RMSprop):
                total += n * (4 + 4 * bool(group["momentum"]))
            elif isinstance(optimizer, (torch.optim.Adam,
                                        torch.optim.AdamW)):
                total += 8 * n
            elif isinstance(optimizer, torch.optim.SGD):
                total += 4 * n * bool(group["momentum"])
            else:
                total += per[type(optimizer)] * n
    return total


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


class PlateauController:
    """Host-side ReduceLROnPlateau (``torch.optim.lr_scheduler``
    semantics), a copy of the JAX package's: ``step(value) -> scale`` once
    per epoch with the monitored metric (``monitor``, an epoch-log key);
    the train step multiplies its final update by the scale. The scale is
    saved with the checkpoint (``train_state.json``); the counters reset
    on resume, as in the JAX package (and the reference, which
    checkpoints no scheduler state)."""

    def __init__(self, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 threshold_mode: str = "rel", cooldown: int = 0,
                 min_scale: float = 0.0, eps_scale: float = 1e-8,
                 monitor: str = "val_loss"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min|max, got {mode!r}")
        if threshold_mode not in ("rel", "abs"):
            raise ValueError(
                f"threshold_mode must be rel|abs, got {threshold_mode!r}")
        if not 0.0 < factor < 1.0:
            raise ValueError("factor must be in (0, 1)")
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_scale = min_scale
        self.eps_scale = eps_scale  # torch's eps, in scale (lr/base_lr) units
        self.monitor = monitor
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        self.scale = 1.0

    def _improved(self, value: float) -> bool:
        if self.mode == "min":
            bar = (self.best * (1 - self.threshold)
                   if self.threshold_mode == "rel"
                   else self.best - self.threshold)
            return value < bar
        bar = (self.best * (1 + self.threshold)
               if self.threshold_mode == "rel"
               else self.best + self.threshold)
        return value > bar

    def step(self, value: float) -> float:
        # torch's order: the cooldown ticks down every epoch (improved or
        # not) and zeroes the bad-epoch count after it
        if self._improved(value):
            self.best = value
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_scale = max(self.scale * self.factor, self.min_scale)
            if self.scale - new_scale > self.eps_scale:  # torch's eps gate
                self.scale = new_scale
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.scale


def build_optimizer(config, steps_per_epoch: int, model):
    """``(optimizer, lr_fn, plateau)`` from the config's ``optimizer`` and
    ``lr_scheduler`` blocks: ``lr_fn(step) -> lr`` for the ``step``-th
    applied update (0-based; NaN in Adafactor's relative-step mode, which
    has no single lr), ``plateau`` a :class:`PlateauController` when the
    scheduler is ``ReduceLROnPlateau``, else None. Refuses what the JAX
    package's ``build_optimizer`` refuses: an lr of None but for
    Adafactor, a schedule without a numeric lr, ``ReduceLROnPlateau`` by
    step."""
    opt_cfg = config["optimizer"]
    opt_args = dict(opt_cfg.get("args", {}))
    trainable = opt_args.pop("trainable", None)
    # Adafactor's own default is lr None (relative steps); every other
    # optimizer defaults to a numeric lr, as torch's do
    default_lr = None if opt_cfg["type"] == "Adafactor" else 1e-3
    base_lr = opt_args.get("learning_rate", opt_args.get("lr", default_lr))
    if base_lr is None and opt_cfg["type"] != "Adafactor":
        raise ValueError(
            f"optimizer {opt_cfg['type']!r} requires a numeric lr (lr=None "
            "is Adafactor's relative-step mode only)")
    sched_cfg = config["lr_scheduler"] if "lr_scheduler" in config else None
    if sched_cfg and base_lr is None:
        raise ValueError(
            "lr_scheduler requires an explicit numeric optimizer lr (got "
            f"lr=None for {opt_cfg['type']}, which means optimizer-internal "
            "relative stepping)")
    unit = (sched_cfg or {}).get("unit", "epoch")
    if unit not in ("epoch", "step"):
        raise ValueError(f"lr_scheduler unit must be epoch|step, got "
                         f"{unit!r}")
    scale_fn, plateau = None, None
    if sched_cfg and sched_cfg["type"] == "ReduceLROnPlateau":
        if unit == "step":
            raise ValueError("ReduceLROnPlateau is metric-driven per epoch; "
                             "unit='step' does not apply")
        args = dict(sched_cfg.get("args", {}))
        # torch spells min_lr and eps in lr units (min_lr possibly one per
        # group: there is one here); the controller's are scale units
        if "min_lr" in args:
            min_lr = args.pop("min_lr")
            if isinstance(min_lr, (list, tuple)):
                min_lr = min_lr[0]
            args["min_scale"] = min_lr / base_lr
        if "eps" in args:
            args["eps_scale"] = args.pop("eps") / base_lr
        plateau = PlateauController(**args)
    elif sched_cfg:
        scale_fn = SCHEDULERS.get(sched_cfg["type"])(
            **sched_cfg.get("args", {}))

    if base_lr is None:
        def lr_fn(step: int) -> float:
            return float("nan")
    elif scale_fn is None:
        def lr_fn(step: int) -> float:
            return float(base_lr)
    elif unit == "step":
        def lr_fn(step: int) -> float:
            return float(base_lr * scale_fn(step))
    else:
        def lr_fn(step: int) -> float:
            return float(base_lr * scale_fn(step // max(steps_per_epoch, 1)))

    target = Trainable(model, trainable) if trainable else model
    optimizer = OPTIMIZERS.get(opt_cfg["type"])(target, **opt_args)
    return optimizer, lr_fn, plateau
