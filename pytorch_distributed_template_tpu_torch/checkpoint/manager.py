"""Training checkpoints: the port of the JAX package's
``checkpoint/manager.py::CheckpointManager`` (save, resume, interval and
emergency saves, pruning, warm start).

The layout follows the JAX package's directories: ``<run_dir>/
checkpoint-epoch{N}/`` (and ``model_best/`` when the monitored metric
improved), the mid-epoch slots ``checkpoint-interval-a/`` and ``-b/``, and
``checkpoint-emergency/``, each beside a ``<name>.meta.json`` sidecar
holding ``{arch, epoch, monitor_best, config}`` (a slot adds ``step``, the
emergency save ``emergency: true``) and, for all but ``model_best``, a
``<name>.data_state.json`` sidecar: where the next batch after the saved
state lives (the trainer's ``_data_state_snapshot``). Inside a checkpoint
directory: ``model.pt``, ``optimizer.pt`` (``torch.save`` of the state
dicts), ``train_state.json`` (the step and applied-update counters) and,
when the run keeps an EMA of the params, ``ema.pt``. The port does not
read the JAX package's orbax checkpoints.

Every directory is written whole into a hidden temporary directory beside
it, then renamed into place, and its sidecars are written after it (each
by a rename): a kill at any point leaves either the old checkpoint or the
new one, never a torn one, and a slot whose sidecars are missing ranks
below every other checkpoint (``config.parser.find_latest_checkpoint``).
The interval slots alternate, so one of them is always complete.

An interval save stops the step loop only for a host copy of the state
(pinned memory, one synchronisation on CUDA); a thread writes it while
training goes on. :meth:`CheckpointManager.wait` joins the writers; it
runs before an epoch save, before the emergency save, before a slot is
reused and at the end of training. ``interval_saves`` records each
interval save's stop of the loop and its write.

Resume restores the model, the optimizer, the counters and the EMA, and
continues at ``meta.epoch + 1`` with the saved ``monitor_best`` (the
trainer turns the ``data_state`` sidecar into a mid-epoch start), with the
JAX package's compatibility policy: a warning when the architecture
differs, the optimizer state dropped when the optimizer type changed, an
EMA seeded from the params when the checkpoint has none, and a
checkpoint's EMA dropped when the run keeps none.

Under DDP the trainer calls the manager on rank 0 only. The model's state
dict is always the bare module's (a ``DistributedDataParallel`` wrapper is
unwrapped, and a ``module.`` prefix is stripped on load), so a checkpoint
written under DDP loads in one process and the other way round. Every
rank loads with ``map_location`` set to its own device.
"""
from __future__ import annotations

import json
import logging
import math
import os
import re
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from ..observability.trace import span
from ..resilience import faults

logger = logging.getLogger(__name__)

EMA_FILE = "ema.pt"
_SIDECARS = (".meta.json", ".data_state.json")


def _json_safe_best(monitor_best) -> Optional[float]:
    """A never-improved +/-inf maps to None (no ``Infinity`` in JSON)."""
    v = float(monitor_best)
    return v if math.isfinite(v) else None


def _bare(model):
    return getattr(model, "module", model)


def _strip_module(state: dict) -> dict:
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state.items()}


def load_model(path, model, map_location="cpu", name="model.pt") -> None:
    """Load ``<path>/<name>`` (the params, or ``ema.pt``'s shadow
    params) into ``model`` (or a DDP wrapper's module), read onto
    ``map_location``."""
    state = torch.load(Path(path) / name, map_location=map_location)
    _bare(model).load_state_dict(_strip_module(state))


def _payload(model, optimizer, train_state: dict, ema) -> dict:
    """File name -> object of one checkpoint; the state dicts hold the
    live tensors."""
    out = {"model.pt": _bare(model).state_dict(),
           "optimizer.pt": optimizer.state_dict(),
           "train_state.json": dict(train_state)}
    if ema is not None:
        out[EMA_FILE] = ema
    return out


def _to_host(obj, on_cuda: list):
    """``obj`` with every tensor copied to host memory: CUDA tensors into
    pinned memory without blocking (``on_cuda`` gets a flag; the caller
    synchronises once), host tensors cloned."""
    if torch.is_tensor(obj):
        t = obj.detach()
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            on_cuda.append(t.device)
            return host
        return t.clone()
    if isinstance(obj, dict):
        return {k: _to_host(v, on_cuda) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v, on_cuda) for v in obj)
    return obj


def _write_json(path: Path, obj) -> None:
    """``path`` replaced whole (a temporary file, then a rename)."""
    tmp = path.parent / f".{path.name}.tmp"
    tmp.write_text(json.dumps(obj, indent=2))
    os.replace(tmp, path)


def _replace_dir(tmp: Path, path: Path) -> None:
    """Put the complete directory ``tmp`` in place of ``path``; the old
    directory and its sidecars go first (a kill in between leaves no
    directory there, never a torn one)."""
    for suffix in _SIDECARS:
        (path.parent / f"{path.name}{suffix}").unlink(missing_ok=True)
    old = path.parent / f".{path.name}.old"
    if path.exists():
        shutil.rmtree(old, ignore_errors=True)
        os.replace(path, old)
    os.replace(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def _write_file(path: Path, obj) -> None:
    if path.suffix == ".json":
        path.write_text(json.dumps(obj))
    else:
        torch.save(obj, path)


def _write_checkpoint(path: Path, payload: dict, meta: dict,
                      data_state: Optional[dict]) -> int:
    """Write ``payload`` as the checkpoint directory ``path`` (see the
    module docstring; its files in parallel, ``torch.save`` releasing the
    GIL while it writes), then its sidecars; returns the bytes
    written."""
    tmp = path.parent / f".{path.name}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    with ThreadPoolExecutor(len(payload)) as pool:
        for done in [pool.submit(_write_file, tmp / name, obj)
                     for name, obj in payload.items()]:
            done.result()
    nbytes = sum(f.stat().st_size for f in tmp.iterdir())
    _replace_dir(tmp, path)
    _write_json(path.parent / f"{path.name}.meta.json", meta)
    if data_state is not None:
        _write_json(path.parent / f"{path.name}.data_state.json",
                    data_state)
    return nbytes


class CheckpointManager:
    def __init__(self, checkpoint_dir):
        self.checkpoint_dir = Path(checkpoint_dir)
        self._slot = 0                   # the next interval slot (0 = a)
        self._writers = [None, None]     # each slot's write thread
        self._error = None               # the first failed write
        #: one record per interval save: ``path``, ``epoch``, ``step``,
        #: ``stop_ms`` (the loop's stop for the host copy), then
        #: ``write_s`` and ``bytes`` when its write is done
        self.interval_saves: List[dict] = []

    @staticmethod
    def _meta(arch: str, epoch: int, monitor_best, config: dict,
              **extra) -> dict:
        return {"arch": arch, "epoch": epoch, **extra,
                "monitor_best": _json_safe_best(monitor_best),
                "config": config}

    # -- save -----------------------------------------------------------

    def save(self, epoch: int, model, optimizer, train_state: dict,
             arch: str, config: dict, monitor_best: float,
             save_best: bool = False, ema=None,
             data_state: Optional[dict] = None) -> Path:
        """Save ``checkpoint-epoch{epoch}`` (+ ``model_best`` when
        ``save_best``). The fault hook ``on_checkpoint_save``
        (``ckpt_write_fail@epoch:N``) runs first; the interval writers
        are joined before the write."""
        faults.on_checkpoint_save(epoch)
        self.wait()
        path = self.checkpoint_dir / f"checkpoint-epoch{epoch}"
        meta = self._meta(arch, epoch, monitor_best, config)
        with span("checkpoint/save", epoch=epoch):
            _write_checkpoint(path, _payload(model, optimizer, train_state,
                                             ema), meta, data_state)
        logger.info("Saving checkpoint: %s ...", path)
        if save_best:
            with span("checkpoint/save_best", epoch=epoch):
                best = self.checkpoint_dir / "model_best"
                tmp = self.checkpoint_dir / ".model_best.tmp"
                shutil.rmtree(tmp, ignore_errors=True)
                shutil.copytree(path, tmp)
                _replace_dir(tmp, best)
                _write_json(self.checkpoint_dir / "model_best.meta.json",
                            meta)
            logger.info("Saving current best: model_best ...")
        return path

    def save_interval(self, epoch: int, step: int, model, optimizer,
                      train_state: dict, arch: str, config: dict,
                      monitor_best: float, ema=None,
                      data_state: Optional[dict] = None) -> Path:
        """Mid-epoch save into the alternating ``checkpoint-interval-a``
        / ``-b`` slots: a host copy of the state now, the write on a
        thread. Blocks only when the slot's write from two intervals ago
        is still running."""
        faults.on_checkpoint_save(epoch)
        i, self._slot = self._slot, 1 - self._slot
        self._join(i)
        path = self.checkpoint_dir / f"checkpoint-interval-{'ab'[i]}"
        meta = self._meta(arch, epoch, monitor_best, config, step=step)
        t0 = time.perf_counter()
        with span("checkpoint/save_interval", epoch=epoch, step=step):
            on_cuda: list = []
            payload = _to_host(_payload(model, optimizer, train_state, ema),
                               on_cuda)
            if on_cuda:
                torch.cuda.synchronize(on_cuda[0])
        record = {"path": path.name, "epoch": epoch, "step": step,
                  "stop_ms": (time.perf_counter() - t0) * 1e3}
        self.interval_saves.append(record)
        writer = threading.Thread(
            target=self._background_write,
            args=(path, payload, meta, data_state, record),
            name=f"write-{path.name}")
        writer.start()
        self._writers[i] = writer
        return path

    def _background_write(self, path, payload, meta, data_state,
                          record) -> None:
        t0 = time.perf_counter()
        try:
            record["bytes"] = _write_checkpoint(path, payload, meta,
                                                data_state)
        except Exception as exc:  # noqa: BLE001 — wait() raises it
            logger.exception("Interval checkpoint %s failed", path)
            if self._error is None:
                self._error = exc
            return
        record["write_s"] = time.perf_counter() - t0
        logger.info("Interval checkpoint: %s (the loop stopped %.1f ms; "
                    "written in %.2f s, %d bytes)", path,
                    record["stop_ms"], record["write_s"], record["bytes"])

    def save_emergency(self, epoch: int, model, optimizer,
                       train_state: dict, arch: str, config: dict,
                       monitor_best: float, ema=None,
                       data_state: Optional[dict] = None) -> Path:
        """Last-breath save into ``checkpoint-emergency``, written before
        returning (the process exits right after), with ``emergency:
        true`` in both sidecars so ``--auto-resume`` and a reader can
        tell it from a planned save."""
        self._join_all()
        path = self.checkpoint_dir / "checkpoint-emergency"
        meta = self._meta(arch, epoch, monitor_best, config)
        meta["emergency"] = True
        if data_state is not None:
            data_state = dict(data_state, emergency=True)
        with span("checkpoint/save_emergency", epoch=epoch):
            _write_checkpoint(path, _payload(model, optimizer, train_state,
                                             ema), meta, data_state)
        logger.warning("Emergency checkpoint written: %s", path)
        return path

    def _join(self, i: int) -> None:
        writer, self._writers[i] = self._writers[i], None
        if writer is not None:
            writer.join()

    def _join_all(self) -> None:
        with span("checkpoint/wait"):
            for i in range(len(self._writers)):
                self._join(i)

    def wait(self) -> None:
        """Join the interval writers; raise the first write that failed
        (once)."""
        self._join_all()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def prune(self, keep_last: int) -> None:
        """Delete all but the newest ``keep_last`` epoch checkpoints and
        their sidecars. ``model_best`` and the interval and emergency
        slots are never pruned; a directory that cannot be removed keeps
        its sidecars."""
        if keep_last <= 0:
            return
        epochs = []
        for p in self.checkpoint_dir.glob("checkpoint-epoch*"):
            m = re.match(r"checkpoint-epoch(\d+)$", p.name)
            if m and p.is_dir():
                epochs.append((int(m.group(1)), p))
        epochs.sort()
        for _, path in epochs[:-keep_last]:
            shutil.rmtree(path, ignore_errors=True)
            if path.exists():
                logger.warning(
                    "Warning: could not prune checkpoint %s; keeping its "
                    "metadata sidecar.", path)
                continue
            for suffix in _SIDECARS:
                (path.parent / f"{path.name}{suffix}").unlink(
                    missing_ok=True)
            logger.info("Pruned old checkpoint: %s", path)

    # -- restore --------------------------------------------------------

    @staticmethod
    def load_meta(resume_path) -> Optional[dict]:
        resume_path = Path(resume_path)
        cand = resume_path.parent / f"{resume_path.name}.meta.json"
        if cand.exists():
            return json.loads(cand.read_text())
        return None

    @staticmethod
    def load_data_state(resume_path) -> Optional[dict]:
        """The ``data_state`` sidecar next to a checkpoint, or None (the
        resume then keeps the epoch granularity)."""
        resume_path = Path(resume_path)
        cand = resume_path.parent / f"{resume_path.name}.data_state.json"
        if cand.exists():
            try:
                return json.loads(cand.read_text())
            except (OSError, ValueError):
                logger.warning("unreadable data_state sidecar %s", cand)
        return None

    def restore(self, resume_path, model, optimizer, current_config: dict,
                current_arch: str, map_location="cpu", ema=None
                ) -> Tuple[dict, int, Optional[float]]:
        """Load a checkpoint into ``model``, ``optimizer`` and ``ema`` (the
        run's ``{param name: shadow tensor}``, or None) in place, reading
        the tensors onto ``map_location``. Returns ``(train_state,
        start_epoch, monitor_best)``."""
        resume_path = Path(resume_path)
        logger.info("Loading checkpoint: %s ...", resume_path)
        meta = self.load_meta(resume_path)
        if meta is None:
            m = re.match(r"checkpoint-epoch(\d+)$", resume_path.name)
            meta = {"epoch": int(m.group(1)) if m else 0}
            logger.warning(
                "Warning: checkpoint metadata sidecar (%s.meta.json) not "
                "found; skipping config compatibility checks and recovering "
                "epoch=%d from the path.", resume_path.name, meta["epoch"])
            ckpt_config = None
        else:
            ckpt_config = meta.get("config", {})
        if ckpt_config is not None and (
                ckpt_config.get("arch") != current_config.get("arch")
                or meta.get("arch", current_arch) != current_arch):
            logger.warning(
                "Warning: Architecture configuration given in config file "
                "is different from that of checkpoint. This may yield an "
                "exception while state is being loaded.")
        load_model(resume_path, model, map_location)
        opt_changed = ckpt_config is not None and (
            ckpt_config.get("optimizer", {}).get("type")
            != current_config.get("optimizer", {}).get("type"))
        if opt_changed:
            logger.warning(
                "Warning: Optimizer type given in config file is different "
                "from that of checkpoint. Optimizer parameters not being "
                "resumed.")
        else:
            optimizer.load_state_dict(torch.load(
                resume_path / "optimizer.pt", map_location=map_location))
        self._restore_ema(resume_path, model, ema, map_location)
        train_state = json.loads((resume_path / "train_state.json")
                                 .read_text())
        start_epoch = int(meta.get("epoch", 0)) + 1
        logger.info("Checkpoint loaded. Resume training from epoch %d",
                    start_epoch)
        return train_state, start_epoch, meta.get("monitor_best")

    @staticmethod
    def _restore_ema(resume_path: Path, model, ema, map_location) -> None:
        has_ema = (resume_path / EMA_FILE).exists()
        if ema is None:
            if has_ema:
                logger.warning(
                    "Warning: checkpoint contains ema_params but EMA is "
                    "disabled in this run; shadow weights discarded.")
            return
        if has_ema:
            source = _strip_module(torch.load(resume_path / EMA_FILE,
                                              map_location=map_location))
        else:
            logger.warning("Warning: checkpoint has no ema_params; seeding "
                           "EMA from the restored params.")
            source = dict(_bare(model).named_parameters())
        with torch.no_grad():
            for name, shadow in ema.items():
                shadow.copy_(source[name])


def warm_start_params(resume_path, model, map_location="cpu"
                      ) -> Tuple[List[str], List[str]]:
    """Graft a training checkpoint's ``model.pt`` into ``model`` (its bare
    module) by state-dict key and shape, in place: the transfer and
    fine-tune start behind ``trainer.init_from``. What does not match
    keeps its initialisation; the optimizer, the counters and the epoch do
    not travel. Returns ``(restored keys, skipped keys)``, sorted."""
    resume_path = Path(resume_path).resolve()
    disk = _strip_module(torch.load(resume_path / "model.pt",
                                    map_location=map_location))
    current = _bare(model).state_dict()
    matched = sorted(k for k, v in current.items()
                     if k in disk and tuple(disk[k].shape) == tuple(v.shape))
    skipped = sorted(set(current) - set(matched))
    if not matched:
        logger.warning(
            "Warning: warm start from %s matched NO param leaves "
            "(checkpoint arch likely differs); all %d leaves keep their "
            "fresh init.", resume_path, len(current))
        return [], skipped
    with torch.no_grad():
        for key in matched:
            current[key].copy_(disk[key])
    return matched, skipped
