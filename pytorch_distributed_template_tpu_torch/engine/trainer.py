"""Training loops: the port of the JAX package's ``engine/trainer.py``
(``BaseTrainer.train``'s epoch policy, ``Trainer._train_epoch`` and
``_valid_epoch``).

The base class owns the epoch loop: the monitor (``"min val_loss"``,
``"max ..."`` or ``"off"``), best-model tracking, early stop after
``early_stop`` epochs without improvement, a checkpoint every
``save_period`` epochs (plus ``model_best``) and ``summary.json`` in the
run directory. The concrete :class:`Trainer` runs an epoch of train steps
(engine/steps.py) on the explicit device and a validation pass, and logs
the epoch with the JAX package's names (``loss``, ``lm_token_accuracy``,
``examples_per_sec``, ``val_loss``, ...).

Refused by name: TensorBoard, the health monitor, telemetry, the profiler,
the watchdog, fault injection, iteration-based epochs (``len_epoch``),
interval saves, ``keep_last``, ``init_from`` (slice 4's observability and
resilience layers), the XLA ``compile_cache``, and any mesh other than
``{"data": -1}`` on one device (parallel axes).
"""
from __future__ import annotations

import json
import math
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from .optim import build_optimizer
from .steps import finalize_metrics, make_eval_step, make_train_step

_SLICE4 = "slice 4 (the training main path on LeNet/MNIST)"


def _enabled(block) -> bool:
    """A config block is on when it is truthy and not ``enabled: false``."""
    if isinstance(block, dict):
        return bool(block) and bool(block.get("enabled", True))
    return bool(block)


def refuse_later_keys(config) -> None:
    """Raise NotImplementedError naming the slice for every config key
    this slice does not run."""
    trainer = config["trainer"]
    later = {
        "trainer.tensorboard": bool(trainer.get("tensorboard", False)),
        "trainer.health": _enabled(trainer.get("health")),
        "trainer.telemetry": _enabled(trainer.get("telemetry")),
        "trainer.profiler": _enabled(trainer.get("profiler")),
        "trainer.watchdog_secs": float(trainer.get("watchdog_secs", 0)) > 0,
        "trainer.faults": bool(trainer.get("faults")),
        "trainer.len_epoch": trainer.get("len_epoch") is not None,
        "trainer.save_interval_steps":
            int(trainer.get("save_interval_steps", 0)) > 0,
        "trainer.keep_last": int(trainer.get("keep_last", 0)) > 0,
        "trainer.init_from": bool(trainer.get("init_from")),
    }
    for key, on in later.items():
        if on:
            raise NotImplementedError(f"{key} is {_SLICE4}")
    if "compile_cache" in config:
        raise NotImplementedError(
            "compile_cache (the XLA compilation cache) has no counterpart "
            "in the port yet (a later slice)")
    axes = (config.get("mesh") or {}).get("axes", {"data": -1})
    if dict(axes) not in ({"data": -1}, {"data": 1}):
        raise NotImplementedError(
            f"mesh {dict(axes)}: meshes other than {{'data': -1}} on one "
            "device are a later slice (parallel axes)")


class BaseTrainer:
    """Epoch policy (the JAX package's ``BaseTrainer``)."""

    def __init__(self, config):
        self.config = config
        cfg_trainer = config["trainer"]
        self.logger = config.get_logger("trainer",
                                        cfg_trainer.get("verbosity", 2))
        self.epochs = cfg_trainer["epochs"]
        self.save_period = cfg_trainer.get("save_period", 1)
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
        self.checkpoint_dir = config.save_dir
        self.ckpt_manager = CheckpointManager(self.checkpoint_dir)

    def _train_epoch(self, epoch: int) -> dict:
        raise NotImplementedError

    def _save_checkpoint(self, epoch: int, save_best: bool = False) -> None:
        raise NotImplementedError

    def train(self) -> dict:
        """The epoch loop; returns the last epoch's log."""
        not_improved_count = 0
        log: dict = {}
        try:
            for epoch in range(self.start_epoch, self.epochs + 1):
                log = {"epoch": epoch}
                log.update(self._train_epoch(epoch))
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
                if epoch % self.save_period == 0:
                    self._save_checkpoint(epoch, save_best=best)
                if (self.mnt_mode != "off"
                        and not_improved_count > self.early_stop):
                    self.logger.info(
                        "Validation performance didn't improve for %s "
                        "epochs. Training stops.", self.early_stop)
                    break
        finally:
            self._write_summary(log)
        return log

    def _write_summary(self, log: dict) -> None:
        """``summary.json`` in the run dir: the last epoch's metrics, the
        monitor and its best value, the run dir."""
        if not log:
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


class Trainer(BaseTrainer):
    """Concrete trainer (the JAX package's ``Trainer``) on one device.

    :param model: a module from the MODELS registry, already on ``device``.
    :param criterion: per-example loss ``(output, target) -> [B]``.
    :param metric_ftns: per-example metric functions.
    :param config: ConfigParser.
    :param train_loader / valid_loader: ``ArrayDataLoader``-compatible.
    :param device: where the batches go (the model's device).
    :param seed: the dropout stream's seed (``--seed``).
    """

    def __init__(self, model, criterion, metric_ftns, config, train_loader,
                 valid_loader=None, device=None, seed: int = 0):
        refuse_later_keys(config)
        super().__init__(config)
        cfg = config["trainer"]
        self.device = torch.device(device) if device is not None \
            else model_device(model)
        self.model = model
        self.criterion = criterion
        self.metric_ftns = list(metric_ftns)
        self.train_loader = train_loader
        self.valid_loader = valid_loader
        self.do_validation = valid_loader is not None
        self.len_epoch = len(train_loader)
        self.log_step = max(int(np.sqrt(train_loader.batch_size)), 1)
        dk = config.get("data_keys", {}) or {}
        self.input_key = dk.get("input", "image")
        self.target_key = dk.get("target", "label")

        self.optimizer, self.lr_fn = build_optimizer(config, self.len_epoch,
                                                     model)
        self.train_step = make_train_step(
            model, self.optimizer, criterion, self.metric_ftns,
            input_key=self.input_key, target_key=self.target_key,
            grad_clip_norm=cfg.get("grad_clip_norm", 0.0),
            grad_accum_steps=int(cfg.get("grad_accum_steps", 1)),
            ema_decay=float(cfg.get("ema_decay", 0.0)),
            skip_nonfinite=bool(cfg.get("skip_nonfinite", False)),
            augment=cfg.get("augment"),
            mixup_alpha=float(cfg.get("mixup_alpha", 0.0)),
            log_grad_norm=bool(cfg.get("log_grad_norm", False)),
            lr_fn=self.lr_fn, seed=seed)
        self.eval_step = make_eval_step(
            model, criterion, self.metric_ftns, input_key=self.input_key,
            target_key=self.target_key)
        n = sum(p.numel() for p in model.parameters())
        self.logger.info("%s: %d parameters on %s", type(model).__name__,
                         n, self.device)
        if config.resume is not None:
            state, self.start_epoch, best = self.ckpt_manager.restore(
                config.resume, model, self.optimizer, config.config,
                type(model).__name__)
            self.train_step.load_state_dict(state)
            if best is not None:
                self.mnt_best = best
        self._first_step_done = False

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _train_epoch(self, epoch: int) -> dict:
        self.train_loader.set_epoch(epoch)
        accum = None
        steps, t0 = 0, time.perf_counter()
        for batch_idx, batch in enumerate(self.train_loader):
            m = self.train_step(self._to_device(batch))
            accum = m if accum is None else {k: accum[k] + v
                                             for k, v in m.items()}
            if not self._first_step_done:
                # the run's first step carries one-time set-up (kernel
                # builds, allocator warm-up): keep it out of the rate
                self._first_step_done = True
                self._sync()
                steps, t0 = 0, time.perf_counter()
            else:
                steps += 1
            if batch_idx % self.log_step == 0:
                loss = float(m["loss_sum"]) / max(float(m["count"]), 1.0)
                self.logger.debug(
                    "Train Epoch: %d %s Loss: %.6f", epoch,
                    self._progress(batch_idx + 1), loss)
        log = finalize_metrics({k: float(v) for k, v in accum.items()}) \
            if accum else {}
        self._sync()
        elapsed = time.perf_counter() - t0
        if log and steps and elapsed > 0:
            log["examples_per_sec"] = round(
                steps * self.train_loader.batch_size / elapsed, 1)
        if self.do_validation:
            val_log = self._valid_epoch(epoch)
            log.update(**{f"val_{k}": v for k, v in val_log.items()})
        return log

    def _valid_epoch(self, epoch: int) -> dict:
        self.valid_loader.set_epoch(epoch)
        accum = None
        for batch in self.valid_loader:
            m = self.eval_step(self._to_device(batch))
            accum = m if accum is None else {k: accum[k] + v
                                             for k, v in m.items()}
        return finalize_metrics({k: float(v) for k, v in accum.items()}) \
            if accum else {}

    def _save_checkpoint(self, epoch: int, save_best: bool = False) -> None:
        self.ckpt_manager.save(
            epoch=epoch, model=self.model, optimizer=self.optimizer,
            train_state=self.train_step.state_dict(),
            arch=type(self.model).__name__, config=dict(self.config.config),
            monitor_best=(self.mnt_best
                          if isinstance(self.mnt_best, (int, float))
                          else 0.0),
            save_best=save_best)

    def _progress(self, batch_idx: int) -> str:
        current = batch_idx * self.train_loader.batch_size
        total = self.train_loader.n_samples
        return f"[{current}/{total} ({100.0 * current / total:.0f}%)]"


def model_device(model) -> torch.device:
    return next(model.parameters()).device
