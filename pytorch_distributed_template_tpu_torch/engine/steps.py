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
the model (models/layers.py). The step counters are the whole of the RNG
state: nothing on the path draws from torch's global generator, so a
resumed run repeats the uninterrupted one.

Gradient accumulation (``grad_accum_steps`` k > 1), as the JAX step
computes it: the batch is split into k microbatches of consecutive rows (a
batch size k does not divide raises ``ValueError``), microbatch ``i``
draws its dropout from ``fold_in(fold_in(seed, step), i)``, each
microbatch's masked loss *sum* is backpropagated, the gradients add up in
``.grad``, and the sum is divided once by the global valid count. Under
DDP every microbatch but the last runs in ``no_sync()``, each backward is
of the loss sum x world size (DDP's average of the summed gradients is
then the global sum), and the statistics are summed over the ranks with
one ``all_reduce`` after the last microbatch, before the division.

EMA (``ema_decay`` d > 0): ``ema <- d ema + (1 - d) params`` after each
applied update, one shadow tensor per parameter (the float32 master
weights' dtype), keyed by parameter name (:attr:`TrainStep.ema`, saved as
``ema.pt``); a step that ``skip_nonfinite`` skips leaves it untouched.
:func:`ema_weights` evaluates with the shadow weights
(``trainer.eval_with_ema``).

Models with cross-example coupling (MoE capacity routing) take the batch
mask inside the forward: a model whose ``forward`` accepts
``example_mask`` gets ``batch["mask"]`` in both steps. Auxiliary
objectives (the MoE load-balancing loss) come back as ``model.aux_loss``
after the forward, a scalar or None; the train step adds ``aux *
valid_count`` to ``loss_sum``, so the logged ``loss`` and the gradient
include it as in the JAX step (which collects flax's ``losses``).

Observability (the JAX step's options at its points in the dataflow):
``log_grad_norm`` adds ``grad_norm_sum`` (the pre-clip global norm x the
valid count, so the epoch's ``finalize_metrics`` gives the mean per-step
norm); ``health`` adds the packed summary vector ``metrics["health"]``
(observability/health.py: loss, pre-clip grad norm, update norm,
non-finite counts), which callers strip out of the epoch accumulator;
``inject_nan_grad_step`` (``nan_grad@step:N``) adds NaN to every gradient
element at step N, before clipping and the health capture, keyed on the
host's step counter (no device read).

The update norm is the global norm of ``p_new - p_old`` over every
parameter, against a copy taken before ``opt.step()`` (foreach copies and
norms, a few launches): the torch optimizers expose no update, and the
difference in float32 carries rounding against the exact update. On a
step that ``skip_nonfinite`` skips, the JAX step still computes an update
from the zeroed gradients and discards it; the port does the same (an
optimizer step on zero gradients, measured, then params and optimizer
state restored), so both report the same finite norm there.

The per-group non-finite counts of the gradients are taken before
clipping (a NaN global norm makes the clip scale NaN and would smear one
bad group over all of them). With ``skip_nonfinite`` the host reads the
step's finiteness anyway and counts only on a non-finite step (exact:
on a finite step every count is 0); without it the counts are taken on
the device every step, which costs no read.

Refused by name, each naming its slice: ``trainable_patterns`` (ROADMAP
A17), ``augment``, ``mixup_alpha`` (A12).
"""
from __future__ import annotations

import contextlib
import inspect
from typing import Callable, Dict, Optional, Sequence

import torch

from ..models.layers import fold_in
from ..observability.health import (
    nonfinite_by_group, pack_health_summary, parameter_groups,
)
from ..parallel import dist
from ..utils.util import LATER_A17

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


def _refuse(augment=None, mixup_alpha=0.0,
            trainable_patterns=None) -> None:
    later = {"trainable": (bool(trainable_patterns), LATER_A17),
             "augment": (augment is not None, _LATER_AUGMENT),
             "mixup_alpha": (mixup_alpha > 0, _LATER_AUGMENT)}
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
    save and restore (:meth:`state_dict`), and the EMA (:attr:`ema`, None
    without ``ema_decay``). ``model`` may be a
    ``DistributedDataParallel`` wrapper: the forward goes through it, and
    its ``module`` answers for the model (forward arguments, ``aux_loss``,
    the parameter groups of the health summary, the EMA's names)."""

    def __init__(self, model, optimizer, criterion: Callable,
                 metric_fns: Sequence[Callable], input_key: str,
                 target_key: str, grad_clip_norm: float,
                 skip_nonfinite: bool, lr_fn: Callable[[int], float],
                 seed: int, log_grad_norm: bool = False,
                 health: bool = False, inject_nan_grad_step=None,
                 grad_accum_steps: int = 1, ema_decay: float = 0.0):
        self.model, self.optimizer = model, optimizer
        self.module = getattr(model, "module", model)
        self.criterion, self.metric_fns = criterion, list(metric_fns)
        self.input_key, self.target_key = input_key, target_key
        self.grad_clip_norm = float(grad_clip_norm or 0.0)
        self.skip_nonfinite = skip_nonfinite
        self.lr_fn, self.seed = lr_fn, int(seed)
        self.log_grad_norm, self.health = bool(log_grad_norm), bool(health)
        self.nan_step = (None if inject_nan_grad_step is None
                         else int(inject_nan_grad_step))
        self._seeded = _forward_takes(self.module, "dropout_seed")
        self._masked = _forward_takes(self.module, "example_mask")
        self._all = [p for g in optimizer.param_groups for p in g["params"]]
        self._groups = parameter_groups(self.module) if health else {}
        self._before = None  # the params before the update (health)
        self.grad_accum_steps = max(int(grad_accum_steps), 1)
        self.ema_decay = float(ema_decay)
        #: ``{param name: shadow tensor}``, or None without ``ema_decay``
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        if self.ema_decay > 0:
            named = dict(self.module.named_parameters())
            self.ema = {n: p.detach().clone() for n, p in named.items()}
            self._ema_params = list(named.values())
        self.step = 0       # steps taken (the dropout key's counter)
        self.applied = 0    # optimizer updates applied (the schedule's)

    def state_dict(self) -> dict:
        return {"step": self.step, "applied": self.applied}

    def load_state_dict(self, state: dict) -> None:
        self.step, self.applied = int(state["step"]), int(state["applied"])

    def seed_ema(self) -> None:
        """Restart the EMA at the current params (a warm start)."""
        if self.ema is not None:
            with torch.no_grad():
                torch._foreach_copy_(list(self.ema.values()),
                                     self._ema_params)

    def _params(self):
        return [p for p in self._all if p.grad is not None]

    def _poison(self) -> None:
        """``nan_grad``: every gradient element NaN (a missing gradient
        becomes a NaN one, as the JAX step's zero leaves do)."""
        for p in self._all:
            if p.grad is None:
                p.grad = torch.full_like(p, float("nan"))
            else:
                p.grad.add_(float("nan"))

    def _update(self) -> None:
        lr = self.lr_fn(self.applied)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()

    @torch.no_grad()
    def _discarded_update_norm(self) -> torch.Tensor:
        """The norm of the update the JAX step computes from zeroed
        gradients on a skipped step and throws away: one optimizer step
        on zero gradients, measured, then params and state restored."""
        opt = self.optimizer
        saved = {p: {k: (v.clone() if torch.is_tensor(v) else v)
                     for k, v in st.items()} for p, st in opt.state.items()}
        for p in self._all:
            p.grad = torch.zeros_like(p)
        self._update()
        delta = torch._foreach_sub(self._all, self._before)
        torch._foreach_copy_(self._all, self._before)
        for p in list(opt.state):
            if p not in saved:
                del opt.state[p]
        for p, st in saved.items():
            for k, v in st.items():
                if torch.is_tensor(v):
                    opt.state[p][k].copy_(v)
                else:
                    opt.state[p][k] = v
        return torch.nn.utils.get_total_norm(delta)

    def _forward(self, batch, seed: int):
        """One (micro)batch's forward: ``(loss_sum, stats)``, the masked
        loss sum (with the aux loss) to backpropagate and the local
        sufficient statistics."""
        target = batch[self.target_key]
        mask = batch["mask"].float()
        kw = {"dropout_seed": seed} if self._seeded else {}
        if self._masked:
            kw["example_mask"] = batch["mask"]
        output = self.model(batch[self.input_key], **kw)
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
        return loss_sum, stats

    def _backward_batch(self, batch):
        """The whole batch at once: the global statistics first, then the
        backward of the local loss sum x world size / global count.
        Returns ``(metrics, denom)``."""
        loss_sum, stats = self._forward(batch, fold_in(self.seed,
                                                       self.step))
        metrics = _global(stats)
        denom = metrics["count"].clamp_min(1.0)
        (loss_sum * dist.process_count() / denom).backward()
        return metrics, denom

    def _backward_accumulated(self, batch):
        """k microbatches (see the module docstring); returns
        ``(metrics, denom)`` with the summed gradients divided once by
        ``denom``."""
        k = self.grad_accum_steps
        b = batch["mask"].shape[0]
        if b % k:
            raise ValueError(f"batch size {b} not divisible by "
                             f"grad_accum_steps {k}")
        rows = b // k
        seed = fold_in(self.seed, self.step)
        world = dist.process_count()
        no_sync = getattr(self.model, "no_sync", None)
        stats = None
        for idx in range(k):
            micro = {key: v[idx * rows:(idx + 1) * rows]
                     for key, v in batch.items()}
            quiet = no_sync is not None and idx < k - 1
            with no_sync() if quiet else contextlib.nullcontext():
                loss_sum, s = self._forward(micro, fold_in(seed, idx))
                (loss_sum * world).backward()
            stats = s if stats is None else {key: stats[key] + v
                                             for key, v in s.items()}
        metrics = _global(stats)
        denom = metrics["count"].clamp_min(1.0)
        torch._foreach_div_([p.grad for p in self._params()], denom)
        return metrics, denom

    @torch.no_grad()
    def _update_ema(self) -> None:
        torch._foreach_lerp_(list(self.ema.values()), self._ema_params,
                             1.0 - self.ema_decay)

    def __call__(self, batch) -> Dict[str, torch.Tensor]:
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        if self.grad_accum_steps > 1:
            metrics, denom = self._backward_accumulated(batch)
        else:
            metrics, denom = self._backward_batch(batch)
        health_loss = metrics["loss_sum"] / denom
        if self.nan_step is not None and self.step == self.nan_step:
            self._poison()

        params = self._params()
        gnorm = None
        if self.grad_clip_norm > 0 or self.log_grad_norm or self.health:
            # the pre-clip global norm of the mean gradient
            gnorm = torch.nn.utils.get_total_norm([p.grad for p in params])
        ok = True
        if self.skip_nonfinite:
            finite = torch.isfinite(metrics["loss_sum"])
            if gnorm is not None:
                finite = finite & torch.isfinite(gnorm)
            else:
                for p in params:
                    finite = finite & torch.isfinite(p.grad).all()
            ok = bool(finite)   # the step's one read
        grad_counts = None
        if self.health:
            if not (self.skip_nonfinite and ok):
                # before the clip: clipping by a NaN norm would smear one
                # bad group over all of them
                grad_counts = nonfinite_by_group(
                    {g: [p.grad for p in ps if p.grad is not None]
                     for g, ps in self._groups.items()})
            if self._before is None:
                self._before = [torch.empty_like(p) for p in self._all]
            torch._foreach_copy_(self._before, self._all)
        if self.log_grad_norm:
            metrics["grad_norm_sum"] = gnorm * denom
        if self.grad_clip_norm > 0 and ok:
            # g * min(1, c / (|g| + 1e-6)), clip_grad_norm_'s scaling
            torch.nn.utils.clip_grads_with_norm_(params, self.grad_clip_norm,
                                                 gnorm)
        update_norm = None
        if ok:
            self._update()
            self.applied += 1
            if self.ema is not None:
                self._update_ema()
            if self.health:
                torch._foreach_sub_(self._before, self._all)  # -update
                update_norm = torch.nn.utils.get_total_norm(self._before)
        else:
            metrics = {k: torch.zeros_like(v) for k, v in metrics.items()}
            if self.health:
                update_norm = self._discarded_update_norm()
        if self.skip_nonfinite:
            metrics["skipped_sum"] = denom * (0.0 if ok else 1.0)
        if self.health:
            metrics["health"] = pack_health_summary(
                health_loss, gnorm, update_norm, grad_counts, self._all,
                groups=len(self._groups))
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
    _refuse(augment, mixup_alpha, trainable_patterns)
    if lr_fn is None:
        base = optimizer.param_groups[0]["lr"]

        def lr_fn(step):
            return base
    return TrainStep(model, optimizer, criterion, metric_fns, input_key,
                     target_key, grad_clip_norm, skip_nonfinite, lr_fn, seed,
                     log_grad_norm=log_grad_norm, health=health,
                     inject_nan_grad_step=inject_nan_grad_step,
                     grad_accum_steps=grad_accum_steps, ema_decay=ema_decay)


@contextlib.contextmanager
def ema_weights(model, ema: Optional[Dict[str, torch.Tensor]]):
    """Within the block, ``model``'s (or a DDP wrapper's module's) params
    hold the EMA's shadow weights; the live params come back after it.
    A no-op when ``ema`` is None."""
    if ema is None:
        yield
        return
    params = dict(getattr(model, "module", model).named_parameters())
    with torch.no_grad():
        live = {n: params[n].detach().clone() for n in ema}
        for n, shadow in ema.items():
            params[n].copy_(shadow)
    try:
        yield
    finally:
        with torch.no_grad():
            for n, value in live.items():
                params[n].copy_(value)


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
