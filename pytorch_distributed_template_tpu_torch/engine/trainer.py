"""Training loops: the port of the JAX package's ``engine/trainer.py``
(``BaseTrainer.train``'s epoch policy, ``Trainer._train_epoch`` and
``_valid_epoch``).

The base class owns the epoch loop: the monitor (``"min val_loss"``,
``"max ..."`` or ``"off"``), best-model tracking, early stop after
``early_stop`` epochs without improvement, a checkpoint every
``save_period`` epochs (plus ``model_best``) and ``summary.json`` in the
run directory. The concrete :class:`Trainer` runs an epoch of train steps
(engine/steps.py) on the explicit device and a validation pass, and logs
the epoch with the JAX package's names (``loss``, ``accuracy``,
``examples_per_sec``, ``val_loss``, ...).

Data parallelism: when a process group exists (``parallel.dist``) the
model is wrapped in ``DistributedDataParallel`` and every loader shards
over the ranks; the steps reduce the statistics over the ranks, so every
rank logs the same global numbers and takes the same monitor and
early-stop decisions. Rank 0 alone writes checkpoints and
``summary.json``; the other ranks wait for it at a barrier. Batches reach
the device through ``data.loader.prefetch_to_device`` (a side-stream copy
pipeline on CUDA). ``trainer.len_epoch`` switches to iteration-based
epochs of that many steps over an endless loader that reshuffles on each
pass. On CUDA the trainer asks cuDNN for deterministic algorithms, so a
resumed run repeats the uninterrupted one. The train step runs the model
in training mode (BatchNorm on the batch's statistics, updating its
running averages), validation in eval mode (on the running averages);
``trainer.augment`` and ``mixup_alpha`` go to the step
(``ops/augment.py``, engine/steps.py), which draws them over the mesh's
data axis.

Observability, as in the JAX trainer (``engine/trainer.py:776-1075``):
spans ``data/next_batch``, ``train/step``, ``train/log`` and
``train/validate`` (``log_dir/trace.json`` at the end of the run, rank 0);
one flight record per step in ``telemetry.jsonl`` (``wall_ms``,
``data_wait_ms``, ``examples``, ``tokens``; on log steps ``loss``, ``lr``,
``grad_norm``, the rates and ``anomaly_total``); TensorBoard scalars (and
the input-image grid for image batches, from the host-side batch) on rank
0; the health monitor over the per-step summary, read one step late, with
``model_best`` withheld in an epoch that fired when
``pause_best_promotion`` is set; a ``torch.profiler`` window and ``mfu`` in
the epoch log when the profiler is on; the step watchdog; the cross-rank
stats exchange; the fault plan (``trainer.faults`` or ``PDT_FAULTS``);
preemption: on SIGTERM every rank breaks at the same batch, the epoch is
checkpointed and training stops. No log-step metric is read on the step
that made it: the log window's metrics and the health summary are copied
into pinned host memory without blocking and read one window (one step)
later (``observability.health.DeferredFetch``).

Resilience, as in the JAX trainer (``engine/trainer.py:200-363``,
``:719-778``, ``:961-980``): the loop keeps a cursor ``(epoch, next
batch)`` that counts steps *taken* (never the batches the prefetch holds),
and every checkpoint gets a ``data_state`` sidecar from it
(:meth:`BaseTrainer._data_state_snapshot`). A resume from a checkpoint
with one continues at that exact batch (``step_accurate_resume``, default
on): the resumed epoch's loader starts at the batch ordinal without
gathering what came before. It falls back to the next epoch, with a
warning, when the sidecar is missing, the run is iteration-based
(``len_epoch``) or the length or batch size changed. Every
``save_interval_steps`` steps of an epoch the state goes to the
alternating interval slots (a host copy; a thread writes it). An
unhandled exception in :meth:`BaseTrainer.train` writes
``checkpoint-emergency`` first (unless ``emergency_checkpoint`` is false,
the exception is a checkpoint fault, or no step has run) and always
propagates. ``keep_last`` prunes the epoch checkpoints after each save,
``init_from`` grafts a checkpoint's params into a fresh run, and with
``ema_decay`` validation runs on the EMA's weights (``eval_with_ema``,
default on). Rank 0 writes every checkpoint; every rank takes the same
steps, so every rank's cursor is the same.

The JAX trainer's other keys: ``trainer.host_prefetch`` (default 2)
assembles the batches on a thread that many ahead of the device copies;
``trainer.progress`` wraps the train and validation loops in a tqdm bar
on rank 0 (``utils.util.maybe_tqdm``: on a TTY by default, the plain loop
without tqdm); ``trainer.debug`` goes to ``utils.debug.configure_debug``
(``nan_check`` stops the run at the first non-finite loss or gradient,
and anomaly mode is put back when the run ends); ``aot_warmup`` is
accepted and logged as meaningless in eager PyTorch. A
``ReduceLROnPlateau`` scheduler's controller steps once per epoch on its
monitored key (every rank holds the same global metrics), sets the train
step's ``lr_scale`` and is warned about once when the key is missing; the
scale is saved with the counters and restored on resume, the
controller's counters restart. A train loader with a ``tokenizer_path``
(``BpeLMLoader``) gets its tokenizer copied into the run directory.

The config's mesh (``parallel.mesh``): ``pipe``, ``data``, ``fsdp``,
``seq``, ``expert`` and ``tensor``. The loaders shard over the data and
fsdp axes (built with :meth:`Mesh.data_shard`, and checked here), so the
ranks of a seq row, an expert row, a tensor row and the stages of a pipe
row train on the same batch, and the model gets the mesh
(``models.base.inject_mesh``) for its sequence-parallel attention, its
tensor-parallel layers, its MoE blocks' routing and experts, or its
pipeline. Every rank builds the whole model from the seed; the injection
leaves it its slices of every parameter its rules (or the fsdp fallback)
place on pipe, fsdp, expert or tensor (``parallel/sharding.py``), and the
optimizer is built after it, so the moments and the EMA are per slice too.
Without such an axis DDP runs over the whole world (parameters are
replicated over data and seq). On a pipe axis (a pipelined model,
``n_stages`` equal to the axis) DDP runs over the data group (none when
the data axis is 1: DDP over the world would average different stages'
weights of equal shapes); the train step sums the replicated parameters'
gradients over the pipe group. On an fsdp, expert or tensor axis no DDP
runs (its ranks hold different slices): the train step sums each gradient
over the mesh itself (engine/steps.py). The global norms and counts read
the whole mesh (``parallel.sharding.MeshReduce``). Every checkpoint holds
the whole tensors, params, optimizer moments and EMA gathered over the
mesh by every rank, one tensor at a time into rank 0's host memory, before
rank 0 writes: the files a one-process run writes; a resume or
``init_from`` cuts them to this rank's slices, whatever mesh wrote them.
The emergency save gathers too, so on a sharded model it lands only when
every rank raises (a fault plan's crash); a rank that fails alone leaves
the others waiting in the gather, as they would in the next collective,
until the process group's timeout. Optimizers that read a whole
parameter's norm (``LARS``, ``LAMB``, ``Adafactor``) refuse a pipe, fsdp,
expert or tensor axis: a rank holds a slice. Rank 0 writes; the
``data_state`` sidecar's sampler state records the batch axes' shard
count. Refused by name: the expert axis beside pipe, fsdp, seq or tensor
(ROADMAP A11d's remainder), fsdp or tensor beside pipe or seq (A11b's
remainder), a seq axis > 1 for a model without sequence parallelism, a
pipe axis > 1 for a model without a pipelined trunk, and a tensor axis for
a model without tensor-parallel layers.
"""
from __future__ import annotations

import collections
import hashlib
import json
import math
import os
import re
import shutil
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager, warm_start_params
from ..data.loader import host_prefetch, prefetch_to_device, to_tensors
from ..models.base import describe, inject_mesh
from ..ops.augment import build_augment
from ..observability.crosshost import CrossHostAggregator
from ..observability.health import (
    DeferredFetch, HealthMonitor, health_counters, health_layout,
)
from ..observability.profiler import (
    ThroughputMeter, TraceCapture, mfu, train_step_flops,
)
from ..observability.tb import TensorboardWriter
from ..observability.telemetry import FlightRecorder, drain_compile_events
from ..observability.trace import get_recorder as get_span_recorder
from ..observability.trace import span
from ..observability.tracker import MetricTracker
from ..parallel import dist
from ..parallel.mesh import build_mesh, mesh_from_config
from ..parallel.sharding import gather_optimizer_state, gather_placed
from ..resilience import faults
from ..utils import preemption
from ..utils.debug import configure_debug
from ..utils.util import maybe_tqdm
from ..utils.watchdog import StepWatchdog
from .optim import build_optimizer, freeze_untrainable
from .steps import (
    ema_weights, finalize_metrics, make_eval_step, make_train_step,
)


def _endless_reshuffling(loader):
    """An endless loader for iteration-based training that reshuffles on
    every full pass (pass ``i`` runs at loader epoch ``i``)."""
    pass_idx = 0
    while True:
        loader.set_epoch(pass_idx)
        yield from loader
        pass_idx += 1


class BaseTrainer:
    """Epoch policy (the JAX package's ``BaseTrainer``)."""

    def __init__(self, config):
        self.config = config
        cfg_trainer = config["trainer"]
        self.logger = config.get_logger("trainer",
                                        cfg_trainer.get("verbosity", 2))
        self.epochs = cfg_trainer["epochs"]
        self.save_period = cfg_trainer.get("save_period", 1)
        # 0 = off; else every N batches of an epoch, an interval save
        self.save_interval_steps = int(
            cfg_trainer.get("save_interval_steps", 0))
        self.monitor = cfg_trainer.get("monitor", "off")
        if self.monitor == "off":
            self.mnt_mode = "off"
            self.mnt_best = 0
        else:
            self.mnt_mode, self.mnt_metric = self.monitor.split()
            assert self.mnt_mode in ("min", "max")
            self.mnt_best = math.inf if self.mnt_mode == "min" else -math.inf
            self.early_stop = cfg_trainer.get("early_stop", math.inf)
            if self.early_stop is None or self.early_stop <= 0:
                self.early_stop = math.inf
        self.start_epoch = 1
        # (epoch, next batch): the steps taken, kept by the batch loop;
        # what the data_state sidecar and the emergency save record
        self._cursor = None
        self._resume_next_batch = 0
        self.checkpoint_dir = config.save_dir
        self.ckpt_manager = CheckpointManager(self.checkpoint_dir)
        # rank 0 writes the events (the ranks share the run directory)
        self.writer = TensorboardWriter(
            config.log_dir, self.logger,
            bool(cfg_trainer.get("tensorboard", False))
            and dist.is_main_process())

    def _train_epoch(self, epoch: int) -> dict:
        raise NotImplementedError

    def _save_checkpoint(self, epoch: int, save_best: bool = False) -> None:
        raise NotImplementedError

    def _state(self) -> dict:
        """The checkpoint manager's keyword arguments for the live state
        (model, optimizer, counters, EMA, arch, config, monitor best)."""
        raise NotImplementedError

    def _saved_state(self) -> Optional[dict]:
        """:meth:`_state` where a save needs it: on rank 0, and on every
        rank of a sharded model (its gather is collective); else None."""
        if dist.is_main_process() or getattr(self, "_sharded", False):
            return self._state()
        return None

    def train(self) -> dict:
        """The epoch loop; returns the last epoch's log."""
        preemption.install()
        not_improved_count = 0
        log: dict = {}
        try:
            for epoch in range(self.start_epoch, self.epochs + 1):
                log = {"epoch": epoch}
                log.update(self._train_epoch(epoch))
                if dist.is_main_process():
                    for key, value in log.items():
                        self.logger.info("    %-15s: %s", str(key), value)
                best = False
                if self.mnt_mode != "off":
                    try:
                        improved = (
                            self.mnt_mode == "min"
                            and log[self.mnt_metric] <= self.mnt_best
                        ) or (
                            self.mnt_mode == "max"
                            and log[self.mnt_metric] >= self.mnt_best)
                    except KeyError:
                        self.logger.warning(
                            "Warning: Metric '%s' is not found. Model "
                            "performance monitoring is disabled.",
                            self.mnt_metric)
                        self.mnt_mode = "off"
                        improved = False
                    if improved:
                        self.mnt_best = log[self.mnt_metric]
                        not_improved_count = 0
                        best = True
                    else:
                        not_improved_count += 1
                if preemption.sync_requested():
                    # any rank got SIGTERM: checkpoint now (whatever the
                    # save_period) and stop everywhere together
                    if dist.is_main_process():
                        self.logger.warning(
                            "Preemption signal received; saving checkpoint "
                            "at epoch %d and stopping.", epoch)
                    self._save_checkpoint(epoch, save_best=best)
                    break
                if epoch % self.save_period == 0:
                    self._save_checkpoint(epoch, save_best=best)
                if (self.mnt_mode != "off"
                        and not_improved_count > self.early_stop):
                    self.logger.info(
                        "Validation performance didn't improve for %s "
                        "epochs. Training stops.", self.early_stop)
                    break
        except Exception as exc:
            # land the live state and its cursor before the process dies;
            # the original exception always propagates
            self._emergency_save(exc)
            raise
        finally:
            self._close()
            self._write_summary(log)
        return log

    def _close(self) -> None:
        """End of the run: stop the watchdog, let the interval writes
        finish (the heartbeat kept alive meanwhile), close the profiler
        window, the recorder and the TB writer, and write ``trace.json``
        (rank 0)."""
        watchdog = getattr(self, "watchdog", None)
        try:
            if watchdog is None:
                self.ckpt_manager.wait()
            else:
                watchdog.stop()
                with watchdog.heartbeat_keepalive():
                    self.ckpt_manager.wait()
        finally:
            if getattr(self, "_anomaly_was", None) is not None:
                torch.autograd.set_detect_anomaly(self._anomaly_was)
            for name in ("trace", "recorder", "writer"):
                part = getattr(self, name, None)
                if part is not None:
                    part.close()
            if dist.is_main_process():
                try:
                    get_span_recorder().dump(
                        self.config.log_dir / "trace.json")
                except Exception:  # noqa: BLE001 — teardown diagnostics
                    self.logger.warning(      # must not crash the run
                        "could not write trace.json", exc_info=True)

    def _write_summary(self, log: dict) -> None:
        """``summary.json`` in the run dir (rank 0): the last epoch's
        metrics, the monitor and its best value, the run dir."""
        if not log or not dist.is_main_process():
            return
        summary = {
            **{k: (v if isinstance(v, int) else
                   float(v) if isinstance(v, float) else v)
               for k, v in log.items()},
            "monitor": f"{self.mnt_mode} {self.mnt_metric}"
                       if self.mnt_mode != "off" else "off",
            "monitor_best": (
                float(self.mnt_best)
                if self.mnt_mode != "off" and math.isfinite(self.mnt_best)
                else None),
            "run_dir": str(self.config.save_dir),
        }
        (self.config.save_dir / "summary.json").write_text(
            json.dumps(summary, indent=2))

    def _data_state_snapshot(self) -> Optional[dict]:
        """The ``data_state`` sidecar of the state being saved: where the
        next batch lives (epoch and batch ordinal, past an epoch's end
        the next epoch's first), the step counter, the data order's
        knobs, and a fingerprint of the dropout stream's ``(seed, step)``
        for forensics. None before the first batch."""
        if self._cursor is None:
            return None
        epoch, next_batch = self._cursor
        len_epoch = int(getattr(self, "len_epoch", 0) or 0)
        if len_epoch and next_batch >= len_epoch:
            epoch, next_batch = epoch + 1, 0
        ds = {"epoch": int(epoch), "next_batch": int(next_batch),
              "len_epoch": len_epoch}
        step = getattr(self, "train_step", None)
        if step is not None:
            ds["global_step"] = int(step.step)
            ds["rng_fingerprint"] = hashlib.sha256(
                f"{step.seed}:{step.step}".encode()).hexdigest()[:12]
        loader = getattr(self, "train_loader", None)
        if loader is not None:
            ds["batch_size"] = int(loader.batch_size)
            if loader.sampler is not None:
                ds["sampler"] = loader.sampler.state()
            else:
                ds["shuffle"] = bool(loader.shuffle)
                ds["data_seed"] = int(loader.seed)
        return ds

    def _emergency_save(self, exc: Exception) -> None:
        """``checkpoint-emergency`` on the unhandled-exception path (rank
        0). Skipped when ``trainer.emergency_checkpoint`` is false, when
        the exception is a checkpoint fault (the checkpointer is what
        failed), or when no step has run. Never raises: the original
        exception is the story."""
        if not bool(self.config["trainer"].get("emergency_checkpoint",
                                               True)):
            return
        if getattr(exc, "is_checkpoint_fault", False):
            self.logger.warning(
                "Emergency checkpoint SKIPPED: the failure is the "
                "checkpoint path itself (%s).", exc)
            return
        if self._cursor is None:
            return
        try:
            state = self._saved_state()
            if not dist.is_main_process():
                return
            self.ckpt_manager.save_emergency(
                epoch=self._cursor[0], **state,
                data_state=self._data_state_snapshot())
            self.logger.warning("Emergency checkpoint saved after %s: %s",
                                type(exc).__name__, exc)
        except Exception:  # noqa: BLE001 — never mask the original error
            self.logger.warning(
                "Emergency checkpoint failed (original error propagates)",
                exc_info=True)


def _check_shards(mesh, *loaders) -> None:
    """Refuse a loader whose rows are not sharded as ``mesh``'s data axis
    (:meth:`Mesh.data_shard`): sharded by world rank instead, the ranks of
    a seq row would read different batches."""
    want = mesh.data_shard()
    for loader in loaders:
        if loader is None or not hasattr(loader, "sampler"):
            continue
        got = ((0, 1) if loader.sampler is None else
               (loader.sampler.shard_index, loader.sampler.num_shards))
        if got != want:
            raise ValueError(
                f"a loader reads data shard {got[0]} of {got[1]}; the mesh "
                f"{mesh.sizes} gives this rank shard {want[0]} of {want[1]} "
                "(build the loaders with shard=mesh.data_shard())")


class Trainer(BaseTrainer):
    """Concrete trainer (the JAX package's ``Trainer``).

    :param model: a module from the MODELS registry, already on ``device``;
        wrapped in ``DistributedDataParallel`` (``self.ddp``) when a
        process group exists. ``self.model`` stays the bare module.
    :param criterion: per-example loss ``(output, target) -> [B]``.
    :param metric_ftns: per-example metric functions.
    :param config: ConfigParser.
    :param train_loader / valid_loader: ``ArrayDataLoader``-compatible.
    :param device: where the batches go (the model's device).
    :param seed: the dropout stream's seed (``--seed``).
    :param mesh: the config's ``parallel.mesh.Mesh`` (built from the config
        when None); the loaders must shard over its data axis.
    """

    def __init__(self, model, criterion, metric_ftns, config, train_loader,
                 valid_loader=None, device=None, seed: int = 0, mesh=None):
        # refuses A11b's and A11d's remainders
        self.mesh = (mesh if mesh is not None
                     else build_mesh(mesh_from_config(config)))
        _check_shards(self.mesh, train_loader, valid_loader)
        if (self.mesh.axis_size("seq") > 1
                and not hasattr(model, "seq_shard")):
            raise ValueError(
                f"a seq axis of {self.mesh.axis_size('seq')} needs a model "
                f"with sequence-parallel attention; {type(model).__name__} "
                "has none")
        pipe = self.mesh.axis_size("pipe")
        if pipe > 1 and getattr(model, "n_stages", None) != pipe:
            raise ValueError(
                f"a pipe axis of {pipe} needs a pipelined model of as many "
                f"stages; {type(model).__name__} has "
                f"{getattr(model, 'n_stages', 'no pipelined trunk')}")
        # on a pipe, fsdp or tensor axis: this rank keeps its slices,
        # before the optimizer and DDP see the parameters
        inject_mesh(model, self.mesh)
        self._sharded = bool(model.placements)
        super().__init__(config)
        cfg = config["trainer"]
        self._anomaly_was = torch.is_anomaly_enabled()
        nan_check = configure_debug(cfg.get("debug"))
        if "aot_warmup" in cfg and dist.is_main_process():
            self.logger.info(
                "trainer.aot_warmup has no meaning in eager PyTorch (no "
                "step is compiled ahead); ignored")
        # the fault plan: PDT_FAULTS wins over trainer.faults; installed
        # per trainer so one-shot faults re-arm for each fresh run
        faults.install_from_env_or_config(cfg.get("faults"))
        faults.watch_loader(train_loader)
        self.device = torch.device(device) if device is not None \
            else model_device(model)
        if self.device.type == "cuda":
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        self.model = model
        trainable = (config["optimizer"].get("args", {}) or {}).get(
            "trainable")
        if trainable:
            # before DDP registers the parameters that take gradients
            freeze_untrainable(model, trainable)
        self.ddp = None
        # DDP over the world, or over the data group on a pipe axis (the
        # stages of a pipe row hold different weights of equal shapes);
        # none on an fsdp, expert or tensor axis, whose ranks hold
        # different slices (the train step sums the gradients over the
        # mesh)
        ddp_group = self.mesh.group("data") if pipe > 1 else None
        split = any(self.mesh.axis_size(a) > 1
                    for a in ("fsdp", "expert", "tensor"))
        if dist.in_group() and not split and (pipe == 1
                                              or ddp_group is not None):
            # BN's running averages come from the global statistics, the
            # same on every rank: nothing to broadcast before a forward
            self.ddp = torch.nn.parallel.DistributedDataParallel(
                model, device_ids=([self.device]
                                   if self.device.type == "cuda" else None),
                broadcast_buffers=False, process_group=ddp_group)
        net = self.ddp if self.ddp is not None else model
        self.criterion = criterion
        self.metric_ftns = list(metric_ftns)
        self.train_loader = train_loader
        self.valid_loader = valid_loader
        self.do_validation = valid_loader is not None
        tok_path = getattr(train_loader, "tokenizer_path", None)
        if tok_path is not None and dist.is_main_process():
            # the run's own copy of the tokenizer: the corpus-side cache
            # can be rewritten by a later run, generate.py must read the
            # merges this run's embeddings saw (tokenizer_from_config)
            try:
                shutil.copyfile(tok_path,
                                self.checkpoint_dir / "tokenizer.json")
            except OSError as exc:
                self.logger.warning("could not pin the tokenizer: %s", exc)
        len_epoch = cfg.get("len_epoch")
        self._train_iter = None
        if len_epoch is None:
            self.len_epoch = len(train_loader)
        else:
            self.len_epoch = int(len_epoch)
            self._train_iter = iter(_endless_reshuffling(train_loader))
        self.log_step = max(int(np.sqrt(train_loader.batch_size)), 1)
        self.prefetch_depth = max(int(cfg.get("prefetch_depth", 2)), 1)
        dk = config.get("data_keys", {}) or {}
        self.input_key = dk.get("input", "image")
        self.target_key = dk.get("target", "label")

        self.optimizer, self.lr_fn, self.plateau = build_optimizer(
            config, self.len_epoch, model)
        if self.mesh.model_parallel() and type(self.optimizer).__name__ in (
                "LARS", "LAMB", "Adafactor"):
            raise NotImplementedError(
                f"{type(self.optimizer).__name__} reads each parameter's "
                "whole norm; on a pipe, fsdp, expert or tensor axis a rank "
                "holds a slice of it (an elementwise optimizer runs "
                "there)")
        self._plateau_warned = False
        self.skip_nonfinite = bool(cfg.get("skip_nonfinite", False))
        self.log_grad_norm = bool(cfg.get("log_grad_norm", False))
        # the health summary rides the step; on unless enabled is false
        # (the JAX trainer's default)
        health_cfg = cfg.get("health", {}) or {}
        self._health_enabled = bool(health_cfg.get("enabled", True))
        ema_decay = float(cfg.get("ema_decay", 0.0))
        self.use_ema = ema_decay > 0 and bool(cfg.get("eval_with_ema",
                                                      True))
        self.train_step = make_train_step(
            net, self.optimizer, criterion, self.metric_ftns,
            input_key=self.input_key, target_key=self.target_key,
            grad_clip_norm=cfg.get("grad_clip_norm", 0.0),
            grad_accum_steps=int(cfg.get("grad_accum_steps", 1)),
            ema_decay=ema_decay,
            skip_nonfinite=self.skip_nonfinite,
            augment=build_augment(cfg.get("augment")),
            mixup_alpha=float(cfg.get("mixup_alpha", 0.0)),
            log_grad_norm=self.log_grad_norm,
            health=self._health_enabled,
            inject_nan_grad_step=faults.nan_grad_step(),
            lr_fn=self.lr_fn, seed=seed, nan_check=nan_check,
            mesh=self.mesh)
        self.eval_step = make_eval_step(
            net, criterion, self.metric_ftns, input_key=self.input_key,
            target_key=self.target_key, mesh=self.mesh)
        if dist.is_main_process():
            self.logger.info(describe(model))
            self.logger.info("on %s, %d process(es), mesh %s%s",
                             self.device, dist.process_count(),
                             self.mesh.sizes,
                             ", DistributedDataParallel" if self.ddp
                             else "")
        if config.resume is not None:
            state, self.start_epoch, best = self.ckpt_manager.restore(
                config.resume, model, self.optimizer, config.config,
                type(model).__name__, map_location=self.device,
                ema=self.train_step.ema)
            self.train_step.load_state_dict(state)
            if self.plateau is not None:
                # the scale survives the resume, the counters restart
                self.plateau.scale = self.train_step.lr_scale
            if best is not None:
                self.mnt_best = best
            if bool(cfg.get("step_accurate_resume", True)):
                self._apply_data_state(
                    CheckpointManager.load_data_state(config.resume),
                    config.resume)
        elif cfg.get("init_from"):
            # params only: the optimizer, the counters and the epoch start
            # fresh; the EMA starts at the grafted weights
            restored, skipped = warm_start_params(
                cfg["init_from"], model, map_location=self.device)
            self.train_step.seed_ema()
            if dist.is_main_process():
                self.logger.info(
                    "Warm start from %s: %d param tensors restored, %d "
                    "kept their init%s", cfg["init_from"], len(restored),
                    len(skipped),
                    (" (e.g. " + ", ".join(skipped[:3]) + ")") if skipped
                    else "")

        self.train_metrics = MetricTracker("loss", writer=self.writer)
        self.valid_metrics = MetricTracker(
            "loss", *[m.__name__ for m in self.metric_ftns],
            writer=self.writer)
        prof_cfg = cfg.get("profiler", {}) or {}
        self.profile_enabled = bool(prof_cfg.get("enabled", False))
        self.throughput = ThroughputMeter()     # log_step windows (TB)
        self.epoch_meter = ThroughputMeter()    # whole-epoch averages
        self.trace = TraceCapture(
            config.log_dir, start_step=prof_cfg.get("trace_start_step", 10),
            num_steps=prof_cfg.get("trace_steps", 0))
        self._peak_flops = prof_cfg.get("peak_flops_per_device")
        self._flops_per_step = None     # counted on the first step
        self._first_step_timed = False  # the first-step meter reset latch

        main = dist.is_main_process()
        tel_cfg = cfg.get("telemetry", {}) or {}
        self.recorder = FlightRecorder(
            run_dir=(self.checkpoint_dir
                     if main and bool(tel_cfg.get("enabled", True))
                     else None),
            capacity=int(tel_cfg.get("capacity", 512)),
            memory_every=int(tel_cfg.get("memory_every", 16)))
        self.health = HealthMonitor(
            health_cfg, recorder=self.recorder, spans=get_span_recorder(),
            log_dir=(config.log_dir if main else None),
            layout=(health_layout(self.train_step._groups)
                    if self._health_enabled else None))
        self.crosshost = CrossHostAggregator(tel_cfg.get("crosshost"),
                                             is_main=main)
        self.trace.attach_recorder(self.recorder)
        # tokens per example for LM data (integer [B, T] inputs)
        arr = train_loader.arrays.get(self.input_key)
        dtype, shape = getattr(arr, "dtype", None), getattr(arr, "shape", ())
        self._tokens_per_example = (
            int(shape[1]) if dtype is not None
            and np.issubdtype(dtype, np.integer) and len(shape) == 2
            else None)
        # watchdog_secs must exceed the first step, which builds the
        # CUDA kernels when they are not built yet
        self.watchdog = StepWatchdog(
            timeout_s=float(cfg.get("watchdog_secs", 0)),
            recorder=self.recorder, spans=get_span_recorder(),
            dump_path=(config.log_dir / "stall_dump.json" if main
                       else None),
            heartbeat_path=(os.environ.get("PDT_HEARTBEAT_FILE")
                            or cfg.get("heartbeat_file")))

    def _to_device(self, batch: dict) -> dict:
        return to_tensors(batch, self.device)

    def _apply_data_state(self, ds: Optional[dict], resume=None) -> None:
        """Turn a checkpoint's ``data_state`` sidecar into a mid-epoch
        start: ``start_epoch`` becomes the epoch in flight and
        :meth:`_batches` starts it at ``next_batch``. Keeps the epoch
        granularity, with a warning, for an iteration-based run or a
        changed length or batch size. A mid-epoch slot (``resume`` an
        interval or emergency save) without its cursor restarts its own
        epoch at batch 0, with a warning: the next epoch would skip the
        rest of it."""
        if not ds:
            name = Path(resume).name if resume is not None else ""
            if re.match(r"checkpoint-(interval-[ab]|emergency)$", name):
                self.start_epoch = max(self.start_epoch - 1, 1)
                self.logger.warning(
                    "%s has no data_state sidecar (its write was cut); "
                    "restarting its epoch %d at batch 0, the steps it "
                    "took in that epoch replayed.", name, self.start_epoch)
            return
        if self._train_iter is not None:
            self.logger.warning(
                "data_state present but len_epoch (iteration-based) "
                "training resumes at epoch granularity.")
            return
        if (int(ds.get("len_epoch", self.len_epoch)) != self.len_epoch
                or int(ds.get("batch_size", self.train_loader.batch_size))
                != self.train_loader.batch_size):
            self.logger.warning(
                "data_state geometry mismatch (checkpoint len_epoch=%s/"
                "batch_size=%s vs current %s/%s); resuming at epoch "
                "granularity.", ds.get("len_epoch"), ds.get("batch_size"),
                self.len_epoch, self.train_loader.batch_size)
            return
        epoch = int(ds.get("epoch", self.start_epoch))
        next_batch = int(ds.get("next_batch", 0))
        if next_batch >= self.len_epoch:
            epoch, next_batch = epoch + 1, 0
        self.start_epoch = epoch
        self._resume_next_batch = next_batch
        if next_batch and dist.is_main_process():
            self.logger.info(
                "Step-accurate resume: continuing epoch %d at batch %d "
                "(global step %s).", epoch, next_batch,
                ds.get("global_step", "?"))

    def _state(self) -> dict:
        """The checkpoint manager's keyword arguments; for a sharded model
        the whole tensors, gathered over the mesh one at a time into host
        memory on rank 0 (collective: every rank calls it, at the same
        point; the others keep only what they hold whole)."""
        model, optimizer, ema = self.model, self.optimizer, \
            self.train_step.ema
        if self._sharded:
            keep = dist.is_main_process()
            model = _Whole(gather_placed(model, model.state_dict(), keep))
            optimizer = _Whole(gather_optimizer_state(self.model, optimizer,
                                                      keep))
            ema = None if ema is None else gather_placed(self.model, ema,
                                                         keep)
        return dict(model=model, optimizer=optimizer,
                    train_state=self.train_step.state_dict(),
                    arch=type(self.model).__name__,
                    config=dict(self.config.config),
                    monitor_best=(self.mnt_best
                                  if isinstance(self.mnt_best, (int, float))
                                  else 0.0),
                    ema=ema)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _first_batch(self, epoch: int) -> int:
        """The batch ordinal ``epoch`` starts at: the resume point in the
        resumed epoch, else 0."""
        return self._resume_next_batch if epoch == self.start_epoch else 0

    def _batches(self, epoch: int):
        if self._train_iter is not None:
            for _ in range(self.len_epoch):
                yield next(self._train_iter)
        else:
            self.train_loader.set_epoch(epoch)
            yield from self.train_loader.iter_batches(
                start_batch=self._first_batch(epoch))

    def _train_epoch(self, epoch: int) -> dict:
        self.train_metrics.reset()
        self.health.epoch_start()   # the promotion pause is epoch-scoped
        self.throughput.reset()
        self.epoch_meter.reset()
        accum = None
        # the host batches, in step order, for the TB image grid
        host = collections.deque()

        def kept(batches):
            for b in batches:
                host.append(b)
                yield b

        batches = self._batches(epoch)
        depth = int(self.config["trainer"].get("host_prefetch", 2))
        if depth > 0:
            batches = host_prefetch(batches, depth)
        main = dist.is_main_process()
        batches_it = iter(maybe_tqdm(
            prefetch_to_device(
                kept(batches), self.device, self.prefetch_depth,
                getattr(self.train_loader, "device_transform", None)),
            total=self.len_epoch, desc=f"train {epoch}",
            enable=self.config["trainer"].get("progress") if main
            else False))
        # preemption: one rank polls its flag every batch; several reach
        # consensus every preempt_check_steps batches, all at the same one
        check_every = max(int(self.config["trainer"].get(
            "preempt_check_steps", 100)), 1)
        single = dist.process_count() == 1
        preempted = False
        self.watchdog.start()
        batch_idx = self._first_batch(epoch) - 1
        self._cursor = (epoch, batch_idx + 1)
        # log-step metrics are read one log window late (never on the step
        # that made them); holds at most one entry
        pending_log = collections.deque()
        t_iter = time.perf_counter()
        while True:
            t_wait = time.perf_counter()
            with span("data/next_batch"):
                try:
                    batch = next(batches_it)
                except StopIteration:
                    break
            host_batch = host.popleft()
            data_wait_ms = (time.perf_counter() - t_wait) * 1e3
            batch_idx += 1
            step = (epoch - 1) * self.len_epoch + batch_idx
            # slow_host / crash / kill fire before the step runs
            faults.on_step(step)
            self.trace.before_step(step)
            with span("train/step", step=step):
                m = self.train_step(batch)
            self._cursor = (epoch, batch_idx + 1)   # the step is taken
            self.trace.after_step(step)
            self.watchdog.beat()
            if "health" in m:
                # a per-step signal, not a sufficient statistic: to the
                # monitor, which reads it one step later
                self.health.enqueue(
                    step, DeferredFetch({"health": m.pop("health")}),
                    meta={"epoch": epoch, "batch_idx": batch_idx})
            bs = self.train_loader.batch_size
            self.throughput.update(bs)
            self.epoch_meter.update(bs)
            rec = {"wall_ms": round((time.perf_counter() - t_iter) * 1e3, 3),
                   "data_wait_ms": round(data_wait_ms, 3),
                   "examples": bs}
            t_iter = time.perf_counter()
            if self._tokens_per_example:
                rec["tokens"] = self._tokens_per_example * bs
            if not self._first_step_timed:
                # the run's first step carries one-time set-up (kernel
                # builds, allocator warm-up): keep it out of the rates
                self._first_step_timed = True
                if self.profile_enabled:
                    self._flops_per_step = train_step_flops(
                        self.model, bs, self._seq_len(batch))
                self._sync()
                self.throughput.reset()
                self.epoch_meter.reset()
            accum = m if accum is None else {k: accum[k] + v
                                             for k, v in m.items()}
            if self.crosshost.should_exchange(batch_idx, self.log_step):
                # every rank reaches the gather at the same batch; rank 0
                # attaches the aggregate
                agg = self.crosshost.exchange(
                    self.recorder.last(self.log_step))
                if agg is not None and main:
                    rec["hosts"] = agg["hosts"]
                    if "wall_spread" in agg:
                        rec["wall_spread"] = agg["wall_spread"]
                    if agg.get("straggler"):
                        rec["straggler"] = True
                        rec["straggler_hosts"] = agg["straggler_hosts"]
            if main and batch_idx % self.log_step == 0:
                # complete the previous window's entry, start this one
                if pending_log:
                    self._flush_log_entry(pending_log.popleft())
                events = drain_compile_events()
                if events:
                    rec["compile_events"] = events
                self.writer.set_step(step)
                self._log_input_images(host_batch)
                fetch = DeferredFetch({k: v for k, v in m.items()
                                       if k in ("loss_sum", "count",
                                                "grad_norm_sum")})
                pending_log.append((step, epoch, batch_idx, fetch, rec))
            else:
                self.recorder.record(step, **rec)
            if ((single or (batch_idx + 1) % check_every == 0)
                    and preemption.sync_requested()):
                preempted = True
                if main:
                    self.logger.warning(
                        "Preemption signal: breaking epoch %d at batch %d "
                        "(the partial epoch will be checkpointed).",
                        epoch, batch_idx + 1)
                break
            if (self.save_interval_steps
                    and (batch_idx + 1) % self.save_interval_steps == 0
                    and (main or self._sharded)):
                state = self._saved_state()
                if main:
                    self.ckpt_manager.save_interval(
                        epoch=epoch, step=batch_idx + 1, **state,
                        data_state=self._data_state_snapshot())
        while pending_log:
            self._flush_log_entry(pending_log.popleft())
        self.health.drain()   # the last step's summary
        log = finalize_metrics({k: float(v) for k, v in accum.items()}) \
            if accum else {}
        self._sync()
        if log:
            rate = self.epoch_meter.rate()
            log["examples_per_sec"] = round(rate["examples_per_sec"], 1)
            util = mfu(self._flops_per_step, rate["steps_per_sec"],
                       peak_per_device=self._peak_flops)
            if util is not None:
                log["mfu"] = round(util, 4)
        # a preempted epoch skips validation: the notice window is for
        # the checkpoint
        if self.do_validation and not preempted:
            with span("train/validate", epoch=epoch):
                val_log = self._valid_epoch(epoch)
            log.update(**{f"val_{k}": v for k, v in val_log.items()})
        # a preempted epoch skipped validation: its monitored key is
        # absent, which is no plateau decision
        if self.plateau is not None and not preempted:
            self._plateau_step(log)
        return log

    def _plateau_step(self, log: dict) -> None:
        """ReduceLROnPlateau, once per epoch: the controller reads the
        monitored key (every rank holds the same global epoch metrics, so
        every rank takes the same decision) and the step's ``lr_scale``
        follows it. A missing key is warned about once."""
        value = log.get(self.plateau.monitor)
        if value is None:
            if not self._plateau_warned and dist.is_main_process():
                self.logger.warning(
                    "Warning: ReduceLROnPlateau monitor '%s' not found in "
                    "epoch metrics %s; plateau LR scheduling is inactive.",
                    self.plateau.monitor, sorted(log))
            self._plateau_warned = True
            return
        # NaN counts as a bad epoch (comparisons with NaN are false), as
        # in torch
        new_scale = self.plateau.step(float(value))
        if new_scale != self.train_step.lr_scale:
            if dist.is_main_process():
                self.logger.info(
                    "ReduceLROnPlateau: %s did not improve for %d epochs; "
                    "lr scale %.3g -> %.3g", self.plateau.monitor,
                    self.plateau.patience + 1, self.train_step.lr_scale,
                    new_scale)
            self.train_step.lr_scale = new_scale

    def _seq_len(self, batch: dict) -> int:
        x = batch[self.input_key]
        return int(x.shape[1]) if x.dim() == 2 else 0

    def _flush_log_entry(self, entry) -> None:
        """Complete one deferred log-step record, a log window after its
        step: the copies have long completed, so the read does not wait
        on the step just issued."""
        step, epoch, batch_idx, fetch, rec = entry
        with span("train/log", step=step):
            m = fetch.get()
            self.writer.set_step(step)
            count = max(float(m["count"]), 1.0)
            loss_val = float(m["loss_sum"]) / count
            self.train_metrics.update("loss", loss_val)
            lr_val = float(self.lr_fn(step)) * self.train_step.lr_scale
            self.writer.add_scalar("lr", lr_val)
            rec["loss"] = round(loss_val, 6)
            rec["lr"] = lr_val
            if self.log_grad_norm:
                rec["grad_norm"] = round(float(m["grad_norm_sum"]) / count,
                                         6)
            if self.profile_enabled and step > 0:
                rate = self.throughput.rate()
                self.writer.add_scalar("examples_per_sec",
                                       rate["examples_per_sec"])
                rec["steps_per_sec"] = round(rate["steps_per_sec"], 4)
                rec["examples_per_sec"] = round(rate["examples_per_sec"], 1)
                if self._tokens_per_example:
                    rec["tokens_per_sec"] = round(
                        rate["examples_per_sec"] * self._tokens_per_example,
                        1)
                util = mfu(self._flops_per_step, rate["steps_per_sec"],
                           peak_per_device=self._peak_flops)
                if util is not None:
                    self.writer.add_scalar("mfu", util)
                    rec["mfu"] = round(util, 4)
            self.logger.debug("Train Epoch: %d %s Loss: %.6f", epoch,
                              self._progress(batch_idx + 1), loss_val)
        hc = health_counters()
        if hc["anomaly_total"]:
            rec["anomaly_total"] = hc["anomaly_total"]
        if hc["straggler_windows_total"]:
            rec["straggler_windows_total"] = hc["straggler_windows_total"]
        self.recorder.record(step, **rec)

    def _valid_epoch(self, epoch: int) -> dict:
        self.valid_metrics.reset()
        self.valid_loader.set_epoch(epoch)
        accum = None
        batches = prefetch_to_device(
            self.valid_loader, self.device, self.prefetch_depth,
            getattr(self.valid_loader, "device_transform", None))
        if dist.is_main_process():
            batches = maybe_tqdm(
                batches, total=len(self.valid_loader), desc=f"valid {epoch}",
                enable=self.config["trainer"].get("progress"))
        with ema_weights(self.model,
                         self.train_step.ema if self.use_ema else None):
            for batch in batches:
                m = self.eval_step(batch)
                accum = m if accum is None else {k: accum[k] + v
                                                 for k, v in m.items()}
                self.watchdog.beat()
        result = finalize_metrics({k: float(v) for k, v in accum.items()}) \
            if accum else {}
        if dist.is_main_process():
            self.writer.set_step(epoch * self.len_epoch, mode="valid")
            for k, v in result.items():
                self.valid_metrics.update(k, v)
        return result

    def _save_checkpoint(self, epoch: int, save_best: bool = False) -> None:
        """Rank 0 writes the checkpoint; every rank waits for it. An epoch
        whose health monitor fired does not crown ``model_best`` under
        ``health.pause_best_promotion``."""
        if save_best and not self.health.promotion_allowed():
            save_best = False
            if dist.is_main_process():
                self.logger.warning(
                    "Health: anomaly at step %s this epoch; best-model "
                    "promotion skipped for epoch %d "
                    "(health.pause_best_promotion).",
                    self.health.last_anomaly_step, epoch)
        state = self._saved_state()
        if dist.is_main_process():
            self.ckpt_manager.save(
                epoch=epoch, **state, save_best=save_best,
                # a finished epoch gives (epoch + 1, batch 0); a preempted
                # one its exact next batch
                data_state=self._data_state_snapshot())
            self.ckpt_manager.prune(
                int(self.config["trainer"].get("keep_last", 0)))
        dist.synchronize()

    def _log_input_images(self, batch: dict) -> None:
        """TB input grid of the first 8 examples, for image batches,
        from the host-side batch."""
        x = batch.get(self.input_key)
        if x is None or np.ndim(x) != 4 or self.writer.writer is None:
            return
        imgs = np.asarray(x[:8]).astype(np.float32)
        lo, hi = imgs.min(), imgs.max()
        imgs = (imgs - lo) / max(hi - lo, 1e-6)
        grid = np.concatenate(list(imgs), axis=1)  # [H, 8*W, C]
        self.writer.add_image("input", grid, dataformats="HWC")

    def _progress(self, batch_idx: int) -> str:
        current = batch_idx * self.train_loader.batch_size
        total = self.train_loader.n_samples
        if self._train_iter is not None:
            current, total = batch_idx, self.len_epoch
        return f"[{current}/{total} ({100.0 * current / total:.0f}%)]"


class _Whole:
    """A gathered state dict in the place of the module or optimizer it
    came from (what the checkpoint manager calls ``state_dict()`` on)."""

    def __init__(self, state: dict):
        self._state = state

    def state_dict(self) -> dict:
        return self._state


def model_device(model) -> torch.device:
    return next(model.parameters()).device
