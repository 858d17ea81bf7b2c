"""Train and eval steps: the port of the JAX package's
``engine/steps.py`` (``make_train_step``, ``make_eval_step``,
``finalize_metrics``) for the options the LM configs use.

A train step: forward, per-example loss, the masked loss sum divided by
the valid count (``batch["mask"]`` marks real rows of a padded batch),
backward, optional global-norm clipping ``g * min(1, c / (|g| + 1e-6))``,
then the optimizer update at ``lr_fn(applied updates)``. Metrics come back
as sufficient statistics (``loss_sum``, ``count``, ``<metric>_sum``) in
device tensors, summed over an epoch and divided once
(:func:`finalize_metrics`).

``skip_nonfinite``: when the loss or any gradient is non-finite the update
is skipped (params and optimizer moments untouched, the schedule and
Adam's step count not advanced), the step's statistics are zeroed and
``skipped_sum`` counts it. The JAX step decides this branchlessly inside
the compiled program; here the decision reads one scalar back to the host
per step.

Dropout draws from ``fold_in(seed, step)`` (the JAX step's
``fold_in(state.rng, state.step)``), folded further per layer and site by
the model (models/layers.py).

Refused by name (slice 4 or later): ``grad_accum_steps > 1``,
``ema_decay``, ``augment``, ``mixup_alpha``, ``log_grad_norm``,
``trainable_patterns``, ``health`` and ``inject_nan_grad_step``.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, Sequence

import torch

from ..models.layers import fold_in

_SLICE4 = "slice 4 (the training main path on LeNet/MNIST)"


def _takes_dropout_seed(model) -> bool:
    try:
        return "dropout_seed" in inspect.signature(model.forward).parameters
    except (TypeError, ValueError):
        return False


def _detached(output):
    if isinstance(output, tuple):
        return tuple(x.detach() for x in output)
    return output.detach()


def _refuse(grad_accum_steps=1, ema_decay=0.0, augment=None,
            mixup_alpha=0.0, log_grad_norm=False, trainable_patterns=None,
            health=False, inject_nan_grad_step=None) -> None:
    later = {"grad_accum_steps > 1": grad_accum_steps > 1,
             "ema_decay": ema_decay > 0, "augment": augment is not None,
             "mixup_alpha": mixup_alpha > 0,
             "log_grad_norm": bool(log_grad_norm),
             "trainable": bool(trainable_patterns),
             "health": bool(health),
             "inject_nan_grad_step": inject_nan_grad_step is not None}
    for name, on in later.items():
        if on:
            raise NotImplementedError(f"{name} is {_SLICE4}")


class TrainStep:
    """``step(batch) -> metrics``; owns the step and update counters (the
    JAX ``TrainState.step`` and the optimizer's count), which checkpoints
    save and restore (:meth:`state_dict`)."""

    def __init__(self, model, optimizer, criterion: Callable,
                 metric_fns: Sequence[Callable], input_key: str,
                 target_key: str, grad_clip_norm: float,
                 skip_nonfinite: bool, lr_fn: Callable[[int], float],
                 seed: int):
        self.model, self.optimizer = model, optimizer
        self.criterion, self.metric_fns = criterion, list(metric_fns)
        self.input_key, self.target_key = input_key, target_key
        self.grad_clip_norm = float(grad_clip_norm or 0.0)
        self.skip_nonfinite = skip_nonfinite
        self.lr_fn, self.seed = lr_fn, int(seed)
        self._seeded = _takes_dropout_seed(model)
        self.step = 0       # steps taken (the dropout key's counter)
        self.applied = 0    # optimizer updates applied (the schedule's)

    def state_dict(self) -> dict:
        return {"step": self.step, "applied": self.applied}

    def load_state_dict(self, state: dict) -> None:
        self.step, self.applied = int(state["step"]), int(state["applied"])

    def _params(self):
        return [p for g in self.optimizer.param_groups for p in g["params"]
                if p.grad is not None]

    def __call__(self, batch) -> Dict[str, torch.Tensor]:
        model, opt = self.model, self.optimizer
        model.train()
        target = batch[self.target_key]
        mask = batch["mask"].float()
        kw = ({"dropout_seed": fold_in(self.seed, self.step)}
              if self._seeded else {})
        output = model(batch[self.input_key], **kw)
        per_ex = self.criterion(output, target)
        loss_sum = (per_ex * mask).sum()
        count = mask.sum()
        denom = count.clamp_min(1.0)
        opt.zero_grad(set_to_none=True)
        (loss_sum / denom).backward()
        metrics = {"loss_sum": loss_sum.detach(), "count": count}
        out = _detached(output)
        for fn in self.metric_fns:
            metrics[f"{fn.__name__}_sum"] = (fn(out, target) * mask).sum()
        del output, out

        params = self._params()
        gnorm = None
        if self.grad_clip_norm > 0:
            # pre-clip global norm; grads scaled by min(1, c / (norm + 1e-6))
            gnorm = torch.nn.utils.clip_grad_norm_(params,
                                                   self.grad_clip_norm)
        ok = True
        if self.skip_nonfinite:
            finite = torch.isfinite(loss_sum)
            if gnorm is not None:
                finite = finite & torch.isfinite(gnorm)
            else:
                for p in params:
                    finite = finite & torch.isfinite(p.grad).all()
            ok = bool(finite)
        if ok:
            lr = self.lr_fn(self.applied)
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
            self.applied += 1
        else:
            metrics = {k: torch.zeros_like(v) for k, v in metrics.items()}
        if self.skip_nonfinite:
            metrics["skipped_sum"] = denom * (0.0 if ok else 1.0)
        self.step += 1
        return metrics


def make_train_step(model, optimizer, criterion: Callable,
                    metric_fns: Sequence[Callable] = (),
                    input_key: str = "image", target_key: str = "label",
                    grad_clip_norm: float = 0.0, grad_accum_steps: int = 1,
                    ema_decay: float = 0.0, skip_nonfinite: bool = False,
                    augment=None, mixup_alpha: float = 0.0,
                    log_grad_norm: bool = False, trainable_patterns=None,
                    health: bool = False, inject_nan_grad_step=None,
                    lr_fn: Callable[[int], float] = None,
                    seed: int = 0) -> TrainStep:
    """Build the train step (the JAX ``make_train_step`` signature, plus
    the torch optimizer, ``lr_fn`` and the dropout ``seed``)."""
    _refuse(grad_accum_steps, ema_decay, augment, mixup_alpha,
            log_grad_norm, trainable_patterns, health, inject_nan_grad_step)
    if lr_fn is None:
        base = optimizer.param_groups[0]["lr"]

        def lr_fn(step):
            return base
    return TrainStep(model, optimizer, criterion, metric_fns, input_key,
                     target_key, grad_clip_norm, skip_nonfinite, lr_fn, seed)


def make_eval_step(model, criterion: Callable,
                   metric_fns: Sequence[Callable] = (),
                   input_key: str = "image", target_key: str = "label"):
    """``eval_step(batch) -> metrics`` (sufficient statistics), the model
    in eval mode and no gradients."""

    @torch.no_grad()
    def eval_step(batch):
        model.eval()
        output = model(batch[input_key])
        target = batch[target_key]
        per_ex = criterion(output, target)
        mask = batch["mask"].float()
        metrics = {"loss_sum": (per_ex * mask).sum(), "count": mask.sum()}
        for fn in metric_fns:
            metrics[f"{fn.__name__}_sum"] = (fn(output, target) * mask).sum()
        return metrics

    return eval_step


def finalize_metrics(sums: Dict[str, float]) -> Dict[str, float]:
    """Sufficient statistics -> averages. ``count == 0`` (every batch
    skipped) gives NaN averages, never an unbeatable 0.0; ``skipped_sum``
    is a raw example count."""
    raw_count = float(sums.get("count", 1.0))
    count = raw_count or 1.0
    out = {}
    for k, v in sums.items():
        if k == "count":
            continue
        if k == "skipped_sum":
            out["skipped"] = float(v)
        elif k.endswith("_sum"):
            out[k[: -len("_sum")]] = (
                float(v) / count if raw_count > 0 else float("nan"))
        else:
            out[k] = float(v)
    return out
