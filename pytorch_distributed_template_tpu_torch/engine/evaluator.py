"""Distributed evaluation: the port of the JAX package's
``engine/evaluator.py::evaluate`` (the reference's ``test.py`` as a
library).

Build the model, the loss and the metrics from the config, restore
``config.resume``'s ``model.pt`` onto the device (its ``ema.pt``, the EMA's
shadow weights, when the config trains one and ``trainer.eval_with_ema``
is not false, as the JAX evaluator does), and run the masked eval step
over the test loader. Under a process group the loader shards over
the ranks and the eval step sums the statistics over them, so every rank
holds the result over the global, unpadded set. With ``save_outputs``
every rank writes its real rows' outputs and targets (pads dropped, eval
order) as ``outputs_p{rank}.npy`` / ``targets_p{rank}.npy``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..checkpoint import load_model
from ..checkpoint.manager import EMA_FILE
from ..config.registry import LOADERS, METRICS, MODELS
from ..data.loader import prefetch_to_device
from ..parallel import dist, mesh_from_config
from .losses import resolve_loss
from .steps import finalize_metrics, make_eval_step


def _build_test_loader(config):
    """The config's ``test_loader``; else its ``valid_loader`` (or
    ``train_loader``) rebuilt with ``training=False`` and no shuffle, as
    the reference's ``test.py`` does."""
    if config.get("test_loader", None):
        return config.init_obj("test_loader", LOADERS)
    for block in ("valid_loader", "train_loader"):
        spec = config.get(block, None)
        if spec:
            args = dict(spec.get("args", {}))
            args["training"] = False
            args["shuffle"] = False
            return LOADERS.get(spec["type"])(**args)
    raise KeyError("config defines none of test_loader/valid_loader/"
                   "train_loader")


def _outputs(model, batch, input_key: str):
    """The model's per-example outputs as float32 (a fused head's
    ``(hidden, head_w)`` materialised as logits)."""
    with torch.no_grad():
        out = model(batch[input_key])
    if isinstance(out, tuple):
        hidden, w = out
        out = hidden @ w
    return out.float()


def evaluate(config, device, save_outputs=None, seed=None) -> dict:
    """Evaluate ``config.resume`` on the config's test loader; returns the
    loss and metrics over the global set. ``seed`` seeds eval-time model
    randomness in the JAX package (BertMLM's eval mask); no model of the
    port draws any, so evaluation is deterministic either way."""
    del seed
    logger = config.get_logger("test")
    if config.resume is None:
        raise ValueError("evaluation requires a checkpoint (-r)")
    mesh_from_config(config)
    model = config.init_obj("arch", MODELS, device=device,
                            param_dtype=torch.float32)
    trainer_cfg = config["trainer"]
    use_ema = (float(trainer_cfg.get("ema_decay", 0.0)) > 0
               and bool(trainer_cfg.get("eval_with_ema", True))
               and (config.resume / EMA_FILE).exists())
    load_model(config.resume, model, map_location=device,
               name=EMA_FILE if use_ema else "model.pt")
    if use_ema:
        logger.info("evaluating the EMA's weights (%s)", EMA_FILE)
    criterion = resolve_loss(config["loss"])
    metric_fns = [METRICS.get(m) for m in config["metrics"]]
    test_loader = _build_test_loader(config)
    dk = config.get("data_keys", {}) or {}
    input_key = dk.get("input", "image")
    target_key = dk.get("target", "label")
    eval_step = make_eval_step(model, criterion, metric_fns,
                               input_key=input_key, target_key=target_key)
    depth = max(int(config["trainer"].get("prefetch_depth", 2)), 1)
    accum, dumped_out, dumped_tgt = None, [], []
    for batch in prefetch_to_device(test_loader, device, depth):
        m = eval_step(batch)
        accum = m if accum is None else {k: accum[k] + v
                                         for k, v in m.items()}
        if save_outputs is not None:
            keep = batch["mask"].bool()
            dumped_out.append(_outputs(model, batch, input_key)[keep].cpu())
            dumped_tgt.append(batch[target_key][keep].cpu())

    if save_outputs is not None:
        out_dir = Path(save_outputs)
        out_dir.mkdir(parents=True, exist_ok=True)
        rank = dist.process_index()
        if dumped_out:
            np.save(out_dir / f"outputs_p{rank}.npy",
                    torch.cat(dumped_out).numpy())
            np.save(out_dir / f"targets_p{rank}.npy",
                    torch.cat(dumped_tgt).numpy())
            logger.info("saved per-example outputs to %s", out_dir)
        else:
            logger.info("no local eval rows on process %d; skipping the "
                        "output dump", rank)

    n_samples = int(accum["count"]) if accum else 0
    result = finalize_metrics({k: float(v) for k, v in accum.items()}) \
        if accum else {}
    if dist.is_main_process():
        logger.info({"n_samples": n_samples, **result})
    return result
