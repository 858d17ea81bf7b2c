"""Train and eval steps: the port of the JAX package's
``engine/steps.py`` (``make_train_step``, ``make_eval_step``,
``finalize_metrics``) for the options the LM and image configs use.

A train step: forward, per-example loss, the masked loss sum divided by
the valid count (``batch["mask"]`` marks real rows of a padded batch),
backward, optional global-norm clipping ``g * min(1, c / (|g| + 1e-6))``,
then the optimizer update at ``lr_fn(applied updates)``. Metrics come back
as sufficient statistics (``loss_sum``, ``count``, ``<metric>_sum``) in
device tensors, summed over an epoch and divided once
(:func:`finalize_metrics`).

Under DDP (a process group, the model wrapped in
``DistributedDataParallel``) the step keeps the JAX step's *global* masked
mean: the count and the statistics are summed over the ranks with one
``all_reduce`` before the backward, and each rank's loss for the backward
is its local masked sum x world size / the global count, so DDP's
averaging of the gradients gives sum over all real rows / global count.
(A textbook DDP loop, each rank's mean averaged, would weigh a rank whose
last batch is mostly padding as much as a full one.) Every rank holds the
global statistics, so every rank takes the same monitor and early-stop
decisions. Clipping runs after DDP's gradient all-reduce.

``skip_nonfinite``: when the loss or any gradient is non-finite the update
is skipped (params and optimizer moments untouched, the schedule and
Adam's step count not advanced), the step's statistics are zeroed and
``skipped_sum`` counts it. The JAX step decides this branchlessly inside
the compiled program; here the decision reads one scalar back to the host
per step.

Dropout draws from ``fold_in(seed, step)`` (the JAX step's
``fold_in(state.rng, state.step)``), folded further per layer and site by
the model (models/layers.py).

Models with cross-example coupling (MoE capacity routing) take the batch
mask inside the forward: a model whose ``forward`` accepts
``example_mask`` gets ``batch["mask"]`` in both steps. Auxiliary
objectives (the MoE load-balancing loss) come back as ``model.aux_loss``
after the forward, a scalar or None; the train step adds ``aux *
valid_count`` to ``loss_sum``, so the logged ``loss`` and the gradient
include it as in the JAX step (which collects flax's ``losses``).

Refused by name, each naming its slice: ``grad_accum_steps > 1``,
``ema_decay``, ``trainable_patterns`` (ROADMAP A17), ``log_grad_norm``,
``health``, ``inject_nan_grad_step`` (A10), ``augment``, ``mixup_alpha``
(A12).
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, Sequence

import torch

from ..models.layers import fold_in
from ..parallel import dist
from ..utils.util import LATER_OBSERVABILITY, LATER_RESUME

_LATER_AUGMENT = "ROADMAP A12 (ops/augment.py, with the other model families)"


def _forward_takes(model, name: str) -> bool:
    try:
        return name in inspect.signature(model.forward).parameters
    except (TypeError, ValueError):
        return False


def _detached(output):
    if isinstance(output, tuple):
        return tuple(x.detach() for x in output)
    return output.detach()


def _refuse(grad_accum_steps=1, ema_decay=0.0, augment=None,
            mixup_alpha=0.0, log_grad_norm=False, trainable_patterns=None,
            health=False, inject_nan_grad_step=None) -> None:
    later = {"grad_accum_steps > 1": (grad_accum_steps > 1, LATER_RESUME),
             "ema_decay": (ema_decay > 0, LATER_RESUME),
             "trainable": (bool(trainable_patterns), LATER_RESUME),
             "augment": (augment is not None, _LATER_AUGMENT),
             "mixup_alpha": (mixup_alpha > 0, _LATER_AUGMENT),
             "log_grad_norm": (bool(log_grad_norm), LATER_OBSERVABILITY),
             "health": (bool(health), LATER_OBSERVABILITY),
             "inject_nan_grad_step": (inject_nan_grad_step is not None,
                                      LATER_OBSERVABILITY)}
    for name, (on, where) in later.items():
        if on:
            raise NotImplementedError(f"{name} is {where}")


def _global(stats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``stats`` summed over the process group with one ``all_reduce``;
    unchanged without a group."""
    if not dist.in_group():
        return stats
    vec = dist.all_reduce_sum(torch.stack([v.float() for v in
                                           stats.values()]))
    return dict(zip(stats, vec.unbind()))


class TrainStep:
    """``step(batch) -> metrics``; owns the step and update counters (the
    JAX ``TrainState.step`` and the optimizer's count), which checkpoints
    save and restore (:meth:`state_dict`). ``model`` may be a
    ``DistributedDataParallel`` wrapper: the forward goes through it, and
    its ``module`` answers for the model (forward arguments, ``aux_loss``)."""

    def __init__(self, model, optimizer, criterion: Callable,
                 metric_fns: Sequence[Callable], input_key: str,
                 target_key: str, grad_clip_norm: float,
                 skip_nonfinite: bool, lr_fn: Callable[[int], float],
                 seed: int):
        self.model, self.optimizer = model, optimizer
        self.module = getattr(model, "module", model)
        self.criterion, self.metric_fns = criterion, list(metric_fns)
        self.input_key, self.target_key = input_key, target_key
        self.grad_clip_norm = float(grad_clip_norm or 0.0)
        self.skip_nonfinite = skip_nonfinite
        self.lr_fn, self.seed = lr_fn, int(seed)
        self._seeded = _forward_takes(self.module, "dropout_seed")
        self._masked = _forward_takes(self.module, "example_mask")
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
        if self._masked:
            kw["example_mask"] = batch["mask"]
        output = model(batch[self.input_key], **kw)
        per_ex = self.criterion(output, target)
        loss_sum = (per_ex * mask).sum()
        count = mask.sum()
        aux = getattr(self.module, "aux_loss", None)
        if aux is not None:
            loss_sum = loss_sum + aux * count
        stats = {"loss_sum": loss_sum.detach(), "count": count}
        out = _detached(output)
        for fn in self.metric_fns:
            stats[f"{fn.__name__}_sum"] = (fn(out, target) * mask).sum()
        del out
        metrics = _global(stats)
        denom = metrics["count"].clamp_min(1.0)
        opt.zero_grad(set_to_none=True)
        (loss_sum * dist.process_count() / denom).backward()
        del output

        params = self._params()
        gnorm = None
        if self.grad_clip_norm > 0:
            # pre-clip global norm; grads scaled by min(1, c / (norm + 1e-6))
            gnorm = torch.nn.utils.clip_grad_norm_(params,
                                                   self.grad_clip_norm)
        ok = True
        if self.skip_nonfinite:
            finite = torch.isfinite(metrics["loss_sum"])
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
    """``eval_step(batch) -> metrics`` (sufficient statistics, summed over
    the process group's ranks), the model in eval mode and no gradients.
    A DDP wrapper is evaluated through its ``module``."""

    model = getattr(model, "module", model)
    masked = _forward_takes(model, "example_mask")

    @torch.no_grad()
    def eval_step(batch):
        model.eval()
        kw = {"example_mask": batch["mask"]} if masked else {}
        output = model(batch[input_key], **kw)
        target = batch[target_key]
        per_ex = criterion(output, target)
        mask = batch["mask"].float()
        metrics = {"loss_sum": (per_ex * mask).sum(), "count": mask.sum()}
        for fn in metric_fns:
            metrics[f"{fn.__name__}_sum"] = (fn(output, target) * mask).sum()
        return _global(metrics)

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
