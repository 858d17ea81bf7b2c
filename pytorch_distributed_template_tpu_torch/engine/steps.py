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

``skip_nonfinite``: when the loss or any gradient *after the clip* is
non-finite the update is skipped (params and optimizer moments untouched,
the schedule and Adam's step count not advanced), the step's statistics
are zeroed and ``skipped_sum`` counts it. As in the JAX step, a global
norm that overflows while every gradient is finite clips them to zeros
(scale 0), and that step applies (AdamW's decay with it). The JAX step
decides this branchlessly inside the compiled program; here the decision
reads one scalar back to the host per step.

``trainable`` (``optimizer.args.trainable``): the parameters the
optimizer's groups leave out are frozen; their gradients are dropped
after the backward, so the global norm, the clip, the health summary and
the update see the trainable ones alone (the JAX step zeroes them).
``lr_scale`` (:attr:`TrainStep.lr_scale`, ``ReduceLROnPlateau``'s
controller sets it per epoch) multiplies the final update
(``optim.set_lr``) and is saved with the counters. ``debug.nan_check``
raises ``FloatingPointError`` at the first step whose loss or gradients
(the injected ``nan_grad`` included) are not finite, as ``jax_debug_nans``
stops the JAX step; autograd's anomaly mode names a backward function
that made a NaN.

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

Sequence parallelism (a model with ``seq_shard``: the LM families on a
mesh whose ``seq`` axis is S > 1): the model returns one shard of each
row's positions, and the steps pass that ``shard=`` to the loss and the
LM metrics (engine/losses.py), which give the shard's part of each
example's value. The statistics stay sums over every rank, so the parts
add up; only the example count is the data axis's: the rank at seq index 0
counts the batch's real rows and the others count 0 (each example would
otherwise count S times). The backward of each rank's part reaches the
other shards' activations through the ring's permutes, and DDP over the
whole world averages the gradients, which leaves sum over all real rows /
global count as with data parallelism alone.

Augment and mixup (image batches ``[B, H, W, C]``), before the forward
and before the microbatch split, as in the JAX step: ``augment`` (an
``ops.augment.Augment``) draws its per-example randomness on the host
from ``fold_in(fold_in(seed, step), 7919)`` for the global batch and
applies this rank's rows on the device. ``mixup_alpha`` > 0 draws one
``lam`` ~ Beta(alpha, alpha) from ``fold_in(fold_in(seed, step), 7920)``
and one shift in ``[1, B)`` (B the global batch) from that folded with 1,
mixes ``x = lam x + (1 - lam) roll(x, shift)`` and rolls the targets into
``batch["_mix_target"]``; the loss is ``lam L(y) + (1 - lam)
L(y_rolled)``, the metrics are against the original labels. The roll is
over the global batch: a data shard holds the global rows ``index::count``
(``data/sampler.py``), so its rolled rows are one other shard's rows
rolled locally (:func:`global_roll`), received with one
``parallel.collectives.ppermute`` over the data group (none when the
shift is a multiple of the shard count). The draws are numpy's Philox,
not JAX's threefry: an augmented or mixed step is reproducible within
each package, on any number of ranks, not across the packages.

Pipeline parallelism (a mesh whose ``pipe`` axis is S > 1, a model with
``pipe`` placements: the pipelined families, each rank holding its
stage's slices of the trunk and the whole embeddings and head). Every rank
of a pipe row computes the same loss from the outputs the pipeline sums
over the row, and backpropagates it scaled by ``1 / S``; the sum's
backward sums the cotangents over the row, so each stage slice gets its
one-process gradient and each replicated parameter gets ``1 / S`` of the
head's part on every rank and the embedding's part on stage 0 alone. The
replicated parameters' gradients are then summed over the pipe group (one
``all_reduce`` of their concatenation): every rank holds their whole
gradient, bit for bit the same. DDP runs over the data group only (the
trainer), so each backward is of the loss x data-axis size / S. The
statistics are counted at pipe index 0 (the others add zeros to the one
``all_reduce``).

Tensor parallelism and ZeRO-3 (a mesh whose ``tensor`` or ``fsdp`` axis
is > 1; no DDP): every rank of a tensor row computes the same loss (the
model gathers its vocab-sharded logits), counted at tensor index 0; an
fsdp rank holds its own rows (the batch shards over data x fsdp). Each
backward is of the local loss sum / the global count, so the gradients'
sums are the global mean's: an fsdp-placed parameter's gather
reduce-scatters the fsdp ranks' parts into its slice, then it is summed
over the data group; every other gradient (a tensor slice, the same on
the ranks of a row, or a replicated one) is summed over the data x fsdp
group; in ``all_reduce``s of up to :data:`SUM_BUCKET_BYTES`, once per
update (after the last microbatch). Expert parallelism (an ``expert`` axis
> 1; no DDP) is the same sum: every rank of an expert row computes the
same loss (the MoE blocks sum their experts' parts over the row), counted
at expert index 0, its replicated gradients come out equal on the row and
its expert slices are its own, so every gradient is summed over the data
group alone.

Every global read on a pipe, fsdp, expert or tensor axis takes the
whole mesh (``parallel.sharding.MeshReduce``): the pre-clip gradient
norm, the update norm, the non-finite counts of the health summary and of
``skip_nonfinite`` / ``debug.nan_check`` sum a slice's part over its axis
and count a replicated parameter once, so every rank clips by the same
scale and takes the same skip decision.

Masked-LM corruption (a model with ``mask_draws``: ``BertMLM``), before
the forward and the microbatch split, beside the augment draws: the model
draws ``sel``, ``mix`` and ``rand_tok`` on the host for the global batch
from ``fold_in(fold_in(seed, step), MLM_SALT)`` (their own salt, not
7919), this data shard's rows kept; they ride the batch as
``_mlm_<name>`` (so microbatches slice them) and reach the forward as
``mask_draws``. The eval step takes an optional ``seed`` (``test.py
--seed``: the evaluator's per-batch ``fold_in(seed, batch index)``) and
hands a model with ``eval_draws`` its seeded eval mask; without one the
model keeps its deterministic eval mask.

Models with running statistics (BatchNorm buffers): the forward in
training mode updates them, each microbatch in turn; a step that
``skip_nonfinite`` skips puts them back bit for bit (a copy taken before
the forward), as the JAX step keeps its ``batch_stats``. The EMA is over
the parameters only.
"""
from __future__ import annotations

import contextlib
import inspect
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist

from ..models.layers import fold_in
from ..observability.health import (
    nonfinite_by_group, pack_health_summary, parameter_groups,
)
from ..parallel import dist
from ..parallel.collectives import all_reduce_, ppermute
from ..parallel.mesh import BATCH
from ..parallel.sharding import MeshReduce
from .optim import set_lr

#: folded into the step's seed for the mixup draws (the JAX step's)
MIXUP_SALT = 7920
#: the batch keys that carry the masked-LM draws (``_mlm_<name>``)
_MLM = "_mlm_"


def _forward_takes(model, name: str) -> bool:
    try:
        return name in inspect.signature(model.forward).parameters
    except (TypeError, ValueError):
        return False


def _detached(output):
    if isinstance(output, tuple):
        return tuple(x.detach() for x in output)
    return output.detach()


def draw_mixup(seed: int, alpha: float, b: int) -> tuple:
    """``(lam, shift)`` of step seed ``seed`` (``fold_in(seed, step)``):
    ``lam`` ~ Beta(alpha, alpha) as float32, ``shift`` uniform in ``[1,
    b)`` for a global batch of ``b`` rows."""
    key = fold_in(seed, MIXUP_SALT)
    lam = np.random.Generator(np.random.Philox(key=key)).beta(alpha, alpha)
    shift = np.random.Generator(np.random.Philox(
        key=fold_in(key, 1))).integers(1, max(b, 2))
    return np.float32(lam), int(shift)


def global_roll(x: torch.Tensor, shift: int, shard=(0, 1),
                group=None) -> torch.Tensor:
    """This data shard's rows of ``roll(global batch, shift, axis 0)``,
    where shard ``(index, count)`` holds the global rows ``index::count``:
    global row ``j count + index`` takes row ``j count + index - shift``,
    which is row ``j - c`` of shard ``(index - shift) % count``, with ``c
    = shift // count`` plus 1 where ``index < shift % count``. That
    shard's rows come by one ``ppermute`` over ``group`` (none when
    ``shift % count == 0``), then roll by ``c`` here."""
    index, count = shard
    hop = shift % count
    c = shift // count + (1 if index < hop else 0)
    if hop:
        x = ppermute(x, group, hop)
    return torch.roll(x, c, dims=0)


def _seq_shard(model, inputs):
    """The model's seq shard of the ``[B, T]`` input rows, or None."""
    fn = getattr(model, "seq_shard", None)
    return fn(inputs.shape[1]) if fn is not None else None


def _example_count(mask, shard) -> torch.Tensor:
    """Real rows, counted once per data shard: seq index 0 counts."""
    count = mask.sum()
    return count if shard is None or shard.index == 0 else count * 0.0


def _counted(mesh) -> bool:
    """Whether this rank counts its statistics: index 0 on the pipe,
    expert and tensor axes (the other ranks of such a row compute the same
    ones)."""
    return mesh is None or all(mesh.axis_index(a) == 0
                               for a in ("pipe", "expert", "tensor"))


def _replicas(model) -> int:
    """The ranks a ``DistributedDataParallel`` wrapper averages the
    gradients over (1 for a bare module)."""
    if isinstance(model, torch.nn.parallel.DistributedDataParallel):
        return tdist.get_world_size(model.process_group)
    return 1


def _global(stats: Dict[str, torch.Tensor],
            counted: bool = True) -> Dict[str, torch.Tensor]:
    """``stats`` summed over the process group with one ``all_reduce``
    (zeros from a rank that is not ``counted``: a pipe stage past the
    first); unchanged without a group."""
    if not dist.in_group():
        return stats
    if not counted:
        stats = {k: torch.zeros_like(v) for k, v in stats.items()}
    vec = dist.all_reduce_sum(torch.stack([v.float() for v in
                                           stats.values()]))
    return dict(zip(stats, vec.unbind()))


#: the largest gradient bucket summed in one ``all_reduce`` (bytes)
SUM_BUCKET_BYTES = 256 << 20


def _sum_flat(grads, group) -> None:
    """``grads`` summed over ``group`` in place, by ``all_reduce``s of
    their concatenation in buckets of at most :data:`SUM_BUCKET_BYTES`."""
    bucket, size = [], 0
    for g in list(grads) + [None]:
        if g is not None and (not bucket or size + g.numel()
                              * g.element_size() <= SUM_BUCKET_BYTES):
            bucket.append(g)
            size += g.numel() * g.element_size()
            continue
        if bucket:
            flat = all_reduce_(torch.cat([t.reshape(-1) for t in bucket]),
                               group)
            torch._foreach_copy_(bucket, [f.view_as(t) for f, t in zip(
                flat.split([t.numel() for t in bucket]), bucket)])
        bucket, size = ([g], g.numel() * g.element_size()) \
            if g is not None else ([], 0)


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
                 grad_accum_steps: int = 1, ema_decay: float = 0.0,
                 nan_check: bool = False, augment=None,
                 mixup_alpha: float = 0.0, mesh=None):
        self.model, self.optimizer = model, optimizer
        self.augment, self.mixup_alpha = augment, float(mixup_alpha)
        # the data axis: the draws' rows and the mixup roll's partners
        self.shard = (mesh.data_shard() if mesh is not None else
                      (dist.process_index(), dist.process_count()))
        self.data_group = mesh.group(BATCH) if mesh is not None else None
        self._lam = None    # (lam, 1 - lam) of this step's mixup, float32
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
        self._mlm = hasattr(self.module, "mask_draws")
        self._all = [p for g in optimizer.param_groups for p in g["params"]]
        # parameters no group holds (``trainable``): their gradients are
        # dropped after the backward, before the norm and the clip
        held = {id(p) for p in self._all}
        self._frozen = [p for p in self.module.parameters()
                        if id(p) not in held]
        self.nan_check = bool(nan_check)
        #: the plateau controller's multiplier of the final update
        self.lr_scale = 1.0
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
        # running statistics (BN buffers), restored on a skipped step
        self._stats = [b for b in self.module.buffers()
                       if b.is_floating_point()]
        self._stats_before = ([torch.empty_like(b) for b in self._stats]
                              if skip_nonfinite and self._stats else None)
        # a pipe, fsdp or tensor axis > 1: the global reads and the
        # gradient sums over the mesh; the loss x DDP's ranks / S
        self.mesh = mesh
        pipe = 1 if mesh is None else mesh.axis_size("pipe")
        self.reduce = (MeshReduce(self.module, mesh)
                       if mesh is not None and mesh.model_parallel()
                       else None)
        # the statistics: counted at pipe, expert and tensor index 0 (the
        # other ranks of such a row compute the same ones)
        self._counted = _counted(mesh)
        self._loss_scale = _replicas(model) / pipe

    def state_dict(self) -> dict:
        """The counters, and ``lr_scale`` once a plateau has moved it."""
        state = {"step": self.step, "applied": self.applied}
        if self.lr_scale != 1.0:
            state["lr_scale"] = self.lr_scale
        return state

    def load_state_dict(self, state: dict) -> None:
        self.step, self.applied = int(state["step"]), int(state["applied"])
        self.lr_scale = float(state.get("lr_scale", 1.0))

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
        set_lr(self.optimizer, self.lr_fn(self.applied), self.lr_scale)
        self.optimizer.step()

    def _nonfinite(self, grads, *scalars) -> torch.Tensor:
        """How many of ``scalars`` and of ``grads``' max-abs norms are not
        finite, over the pipe row."""
        norms = torch._foreach_norm(grads, float("inf")) if grads else []
        bad = (~torch.isfinite(torch.stack([*scalars, *norms]).float())
               ).sum().float()
        return self.reduce.sum(bad) if self.reduce is not None else bad

    def _norm(self, tensors, params) -> torch.Tensor:
        """The global 2-norm of ``tensors``, one per parameter of
        ``params``."""
        if self.reduce is None:
            return torch.nn.utils.get_total_norm(tensors)
        return self.reduce.norm(tensors, params)

    def _counted_params(self, params) -> list:
        """The tensors of ``params`` this rank counts in a mesh-wide sum."""
        return list(params) if self.reduce is None else \
            self.reduce.counted(params)

    def _sync_grads(self) -> None:
        """The gradient sums over the mesh, once per update: on a pipe
        axis the replicated parameters' over the pipe group (DDP averaged
        over the data group); on an fsdp, expert or tensor axis (no DDP) an
        fsdp-placed parameter's over the data group (its gather's
        reduce-scatter summed the fsdp ranks'), every other one's over the
        data x fsdp group."""
        mesh, buckets = self.mesh, {}
        for p in self._params():
            axis = self.reduce.axis(p)
            if mesh.axis_size("pipe") > 1:
                group = mesh.group("pipe") if axis is None else None
            else:
                group = mesh.group("data" if axis == "fsdp" else BATCH)
            if group is not None:
                buckets.setdefault(id(group), (group, []))[1].append(p.grad)
        for group, grads in buckets.values():
            _sum_flat(grads, group)

    def _check_finite(self, loss_sum) -> None:
        """``debug.nan_check``: stop at the first step whose loss or
        gradients are not finite (one read per step)."""
        grads = [p.grad for p in self._params()]
        if bool(self._nonfinite(grads, loss_sum) > 0):
            raise FloatingPointError(
                f"debug.nan_check: non-finite loss or gradients at step "
                f"{self.step}")

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
        return self._norm(delta, self._all)

    def _prepare(self, batch):
        """Augment, then mixup, and the masked-LM draws, on the whole
        (global) batch before any microbatch split; the batch unchanged
        without them."""
        if self.augment is None and self.mixup_alpha <= 0 and not self._mlm:
            return batch
        batch = dict(batch)
        seed = fold_in(self.seed, self.step)
        x = batch[self.input_key]
        if self._mlm:
            for name, d in self.module.mask_draws(seed, x,
                                                  self.shard).items():
                batch[_MLM + name] = d
        if self.augment is not None:
            x = self.augment(seed, x, self.shard)
        if self.mixup_alpha > 0:
            lam, shift = draw_mixup(seed, self.mixup_alpha,
                                    x.shape[0] * self.shard[1])
            group = self.data_group
            batch["_mix_target"] = global_roll(batch[self.target_key],
                                               shift, self.shard, group)
            one_minus = np.float32(1.0) - lam
            x = x * float(lam) + global_roll(x, shift, self.shard,
                                             group) * float(one_minus)
            self._lam = (float(lam), float(one_minus))
        batch[self.input_key] = x
        return batch

    def _forward(self, batch, seed: int):
        """One (micro)batch's forward: ``(loss_sum, stats)``, the masked
        loss sum (with the aux loss) to backpropagate and the local
        sufficient statistics."""
        target = batch[self.target_key]
        mask = batch["mask"].float()
        kw = {"dropout_seed": seed} if self._seeded else {}
        if self._masked:
            kw["example_mask"] = batch["mask"]
        if self._mlm:
            kw["mask_draws"] = {k[len(_MLM):]: v for k, v in batch.items()
                                if k.startswith(_MLM)}
        output = self.model(batch[self.input_key], **kw)
        shard = _seq_shard(self.module, batch[self.input_key])
        skw = {} if shard is None else {"shard": shard}
        per_ex = self.criterion(output, target, **skw)
        if "_mix_target" in batch:
            lam, one_minus = self._lam
            per_ex = lam * per_ex + one_minus * self.criterion(
                output, batch["_mix_target"], **skw)
        loss_sum = (per_ex * mask).sum()
        count = _example_count(mask, shard)
        aux = getattr(self.module, "aux_loss", None)
        if aux is not None:
            loss_sum = loss_sum + aux * count
        stats = {"loss_sum": loss_sum.detach(), "count": count}
        out = _detached(output)
        for fn in self.metric_fns:
            stats[f"{fn.__name__}_sum"] = (fn(out, target, **skw)
                                           * mask).sum()
        return loss_sum, stats

    def _backward_batch(self, batch):
        """The whole batch at once: the global statistics first, then the
        backward of the local loss sum x world size / global count.
        Returns ``(metrics, denom)``."""
        loss_sum, stats = self._forward(batch, fold_in(self.seed,
                                                       self.step))
        metrics = _global(stats, self._counted)
        denom = metrics["count"].clamp_min(1.0)
        (loss_sum * self._loss_scale / denom).backward()
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
        no_sync = getattr(self.model, "no_sync", None)
        stats = None
        for idx in range(k):
            micro = {key: v[idx * rows:(idx + 1) * rows]
                     for key, v in batch.items()}
            quiet = no_sync is not None and idx < k - 1
            with no_sync() if quiet else contextlib.nullcontext():
                loss_sum, s = self._forward(micro, fold_in(seed, idx))
                (loss_sum * self._loss_scale).backward()
            stats = s if stats is None else {key: stats[key] + v
                                             for key, v in s.items()}
        metrics = _global(stats, self._counted)
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
        batch = self._prepare(batch)
        if self._stats_before is not None:
            torch._foreach_copy_(self._stats_before, self._stats)
        try:
            if self.grad_accum_steps > 1:
                metrics, denom = self._backward_accumulated(batch)
            else:
                metrics, denom = self._backward_batch(batch)
        except RuntimeError as exc:
            # anomaly mode (debug.nan_check) names the backward function
            # that made a NaN
            if self.nan_check and "nan" in str(exc).lower():
                raise FloatingPointError(
                    f"debug.nan_check: step {self.step}: {exc}") from exc
            raise
        for p in self._frozen:
            p.grad = None
        if self.reduce is not None:
            self._sync_grads()
        health_loss = metrics["loss_sum"] / denom
        if self.nan_step is not None and self.step == self.nan_step:
            self._poison()
        if self.nan_check:
            self._check_finite(metrics["loss_sum"])

        params = self._params()
        gnorm = None
        if self.grad_clip_norm > 0 or self.log_grad_norm or self.health:
            # the pre-clip global norm of the mean gradient
            gnorm = self._norm([p.grad for p in params], params)
        ok = True
        if self.skip_nonfinite:
            # the JAX step's test, on the gradients after the clip: a
            # finite norm means finite leaves; an overflowed norm clips
            # finite leaves to zeros (scale 0), so there the leaves decide
            # (their max-abs norms overflow no sum)
            leaves = self._nonfinite([p.grad for p in params]) == 0
            if gnorm is not None:
                leaves = torch.isfinite(gnorm) | leaves
            ok = bool(torch.isfinite(metrics["loss_sum"]) & leaves)
            # ^ the step's one read
        grad_counts = None
        if self.health:
            if not (self.skip_nonfinite and ok):
                # before the clip: clipping by a NaN norm would smear one
                # bad group over all of them; this rank's counted
                # gradients (summed over the mesh below)
                grad_counts = nonfinite_by_group(
                    {g: [p.grad for p in self._counted_params(ps)
                         if p.grad is not None]
                     for g, ps in self._groups.items()},
                    device=metrics["loss_sum"].device)
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
                update_norm = self._norm(self._before, self._all)
        else:
            metrics = {k: torch.zeros_like(v) for k, v in metrics.items()}
            if self._stats_before is not None:
                torch._foreach_copy_(self._stats, self._stats_before)
            if self.health:
                update_norm = self._discarded_update_norm()
        if self.skip_nonfinite:
            metrics["skipped_sum"] = denom * (0.0 if ok else 1.0)
        if self.health:
            vec = pack_health_summary(
                health_loss, gnorm, update_norm, grad_counts,
                self._counted_params(self._all), groups=len(self._groups))
            if self.reduce is not None:
                # the counts over the mesh (each slice and replicated
                # tensor counted once)
                vec = torch.cat([vec[:3], self.reduce.sum(vec[3:].clone())])
            metrics["health"] = vec
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
                    seed: int = 0, nan_check: bool = False,
                    mesh=None) -> TrainStep:
    """Build the train step (the JAX ``make_train_step`` signature, plus
    the torch optimizer, ``lr_fn``, the dropout ``seed``,
    ``debug.nan_check`` and the ``mesh``, whose data axis the augment
    draws and the mixup roll run over; default the process group).
    ``augment`` is ``ops.augment.build_augment``'s. ``trainable_patterns``
    is accepted for that signature: the freeze follows the optimizer's
    groups, which ``build_optimizer`` built from the same patterns."""
    del trainable_patterns
    if lr_fn is None:
        base = optimizer.param_groups[0]["lr"]

        def lr_fn(step):
            return base
    return TrainStep(model, optimizer, criterion, metric_fns, input_key,
                     target_key, grad_clip_norm, skip_nonfinite, lr_fn, seed,
                     log_grad_norm=log_grad_norm, health=health,
                     inject_nan_grad_step=inject_nan_grad_step,
                     grad_accum_steps=grad_accum_steps, ema_decay=ema_decay,
                     nan_check=nan_check, augment=augment,
                     mixup_alpha=mixup_alpha, mesh=mesh)


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


def eval_kwargs(model, batch, input_key: str, seed=None, shard=None):
    """The eval forward's keyword arguments: the batch mask for a model
    that takes ``example_mask``, and with a ``seed`` the seeded eval mask
    of a model with ``eval_draws`` over data shard ``shard`` (default the
    process group's rank and size)."""
    kw = ({"example_mask": batch["mask"]}
          if _forward_takes(model, "example_mask") else {})
    if seed is not None and hasattr(model, "eval_draws"):
        shard = shard or (dist.process_index(), dist.process_count())
        kw["mask_draws"] = model.eval_draws(seed, batch[input_key], shard)
    return kw


def make_eval_step(model, criterion: Callable,
                   metric_fns: Sequence[Callable] = (),
                   input_key: str = "image", target_key: str = "label",
                   data_shard=None, mesh=None):
    """``eval_step(batch, seed=None) -> metrics`` (sufficient statistics,
    summed over the process group's ranks; on a pipe axis of ``mesh`` the
    first stage's, every stage computing the same), the model in eval mode
    and no gradients; ``seed`` seeds eval-time model randomness
    (:func:`eval_kwargs`, over ``data_shard``). A DDP wrapper is
    evaluated through its ``module``."""

    model = getattr(model, "module", model)
    counted = _counted(mesh)

    @torch.no_grad()
    def eval_step(batch, seed=None):
        model.eval()
        kw = eval_kwargs(model, batch, input_key, seed, data_shard)
        output = model(batch[input_key], **kw)
        target = batch[target_key]
        shard = _seq_shard(model, batch[input_key])
        skw = {} if shard is None else {"shard": shard}
        per_ex = criterion(output, target, **skw)
        mask = batch["mask"].float()
        metrics = {"loss_sum": (per_ex * mask).sum(),
                   "count": _example_count(mask, shard)}
        for fn in metric_fns:
            metrics[f"{fn.__name__}_sum"] = (fn(output, target, **skw)
                                             * mask).sum()
        return _global(metrics, counted)

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
