"""Training checkpoints: the port of the JAX package's
``checkpoint/manager.py::CheckpointManager`` (save and resume).

The layout follows the JAX package's directories: ``<run_dir>/
checkpoint-epoch{N}/`` (and ``model_best/`` when the monitored metric
improved), each beside a ``<name>.meta.json`` sidecar holding ``{arch,
epoch, monitor_best, config}``. Inside a checkpoint directory:
``model.pt`` and ``optimizer.pt`` (``torch.save`` of the state dicts) and
``train_state.json`` (the step and applied-update counters). Resume
restores all three and continues at ``meta.epoch + 1`` with the saved
``monitor_best``, with the JAX package's compatibility policy: a warning
when the architecture differs, the optimizer state dropped when the
optimizer type changed. The port does not read the JAX package's orbax
checkpoints.

Under DDP the trainer calls :meth:`CheckpointManager.save` on rank 0 only.
The model's state dict is always the bare module's (a
``DistributedDataParallel`` wrapper is unwrapped, and a ``module.`` prefix
is stripped on load), so a checkpoint written under DDP loads in one
process and the other way round. Every rank loads with ``map_location``
set to its own device (:meth:`restore`, :func:`load_model`).

Left to ROADMAP A17: the ``data_state`` sidecar and mid-epoch resume,
interval and emergency saves, ``keep_last`` pruning.
"""
from __future__ import annotations

import json
import logging
import math
import re
import shutil
from pathlib import Path
from typing import Optional, Tuple

import torch

logger = logging.getLogger(__name__)

_FILES = ("model.pt", "optimizer.pt", "train_state.json")


def _json_safe_best(monitor_best) -> Optional[float]:
    """A never-improved +/-inf maps to None (no ``Infinity`` in JSON)."""
    v = float(monitor_best)
    return v if math.isfinite(v) else None


def _bare(model):
    return getattr(model, "module", model)


def load_model(path, model, map_location="cpu") -> None:
    """Load ``<path>/model.pt`` into ``model`` (or a DDP wrapper's module),
    read onto ``map_location``."""
    state = torch.load(Path(path) / "model.pt", map_location=map_location)
    state = {(k[len("module."):] if k.startswith("module.") else k): v
             for k, v in state.items()}
    _bare(model).load_state_dict(state)


class CheckpointManager:
    def __init__(self, checkpoint_dir):
        self.checkpoint_dir = Path(checkpoint_dir)

    def _write(self, path: Path, model, optimizer, train_state: dict,
               meta: dict) -> None:
        path.mkdir(parents=True, exist_ok=True)
        torch.save(_bare(model).state_dict(), path / "model.pt")
        torch.save(optimizer.state_dict(), path / "optimizer.pt")
        (path / "train_state.json").write_text(json.dumps(train_state))
        (path.parent / f"{path.name}.meta.json").write_text(
            json.dumps(meta, indent=2))

    def save(self, epoch: int, model, optimizer, train_state: dict,
             arch: str, config: dict, monitor_best: float,
             save_best: bool = False) -> Path:
        """Save ``checkpoint-epoch{epoch}`` (+ ``model_best`` when
        ``save_best``)."""
        path = self.checkpoint_dir / f"checkpoint-epoch{epoch}"
        meta = {"arch": arch, "epoch": epoch,
                "monitor_best": _json_safe_best(monitor_best),
                "config": config}
        self._write(path, model, optimizer, train_state, meta)
        logger.info("Saving checkpoint: %s ...", path)
        if save_best:
            best = self.checkpoint_dir / "model_best"
            best.mkdir(exist_ok=True)
            for name in _FILES:
                shutil.copyfile(path / name, best / name)
            (self.checkpoint_dir / "model_best.meta.json").write_text(
                json.dumps(meta, indent=2))
            logger.info("Saving current best: model_best ...")
        return path

    @staticmethod
    def load_meta(resume_path) -> Optional[dict]:
        resume_path = Path(resume_path)
        cand = resume_path.parent / f"{resume_path.name}.meta.json"
        if cand.exists():
            return json.loads(cand.read_text())
        return None

    def restore(self, resume_path, model, optimizer, current_config: dict,
                current_arch: str, map_location="cpu"
                ) -> Tuple[dict, int, Optional[float]]:
        """Load a checkpoint into ``model`` and ``optimizer`` in place,
        reading the tensors onto ``map_location``. Returns
        ``(train_state, start_epoch, monitor_best)``."""
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
        train_state = json.loads((resume_path / "train_state.json")
                                 .read_text())
        start_epoch = int(meta.get("epoch", 0)) + 1
        logger.info("Checkpoint loaded. Resume training from epoch %d",
                    start_epoch)
        return train_state, start_epoch, meta.get("monitor_best")
