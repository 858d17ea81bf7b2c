"""Distributed evaluation: the port of the JAX package's
``engine/evaluator.py::evaluate`` (the reference's ``test.py`` as a
library).

Build the model, the loss and the metrics from the config, restore
``config.resume``'s ``model.pt`` onto the device (then its ``ema.pt``, the
EMA's shadow params, when the config trains one and
``trainer.eval_with_ema`` is not false, as the JAX evaluator does; a
BatchNorm model keeps ``model.pt``'s running averages), and run the
masked eval step in eval mode (BatchNorm on the running averages)
over the test loader. Under a process group the loader shards over
the ranks and the eval step sums the statistics over them, so every rank
holds the result over the global, unpadded set. With ``save_outputs``
every rank writes its real rows' outputs and targets (pads dropped, eval
order) as ``outputs_p{rank}.npy`` / ``targets_p{rank}.npy``, and for a
masked LM (the class attribute ``mlm_output``: ``BertMLM``'s ``(logits,
mask)``) the logits as outputs and the mask beside them as
``masks_p{rank}.npy`` (bool), as the JAX evaluator writes them. The mesh
is the config's, as the trainer's: the test set shards over the data
axis and the model gets the mesh (on a pipe axis each rank keeps its
stage's slices and ``model.pt``'s whole tensors are cut to them); on a seq
axis > 1 a rank's outputs are one shard of each row, so ``save_outputs``
refuses there. The output files are one per data shard, named by its
index (the rank without a pipe axis) and written by the shard's first
pipe stage; every stage runs the pipeline.

``seed`` (``test.py --seed``) seeds eval-time model randomness, as the
JAX evaluator's ``"eval"`` stream does: batch ``i`` gets ``fold_in(seed,
i)`` (``models.layers.fold_in``; the same on every rank), which a model
with ``eval_draws`` (``BertMLM``'s seeded eval mask) draws from; without
it the model's deterministic eval mask stays.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..checkpoint import load_model
from ..checkpoint.manager import EMA_FILE
from ..config.registry import LOADERS, METRICS, MODELS
from ..data.loader import prefetch_to_device
from ..models.base import inject_mesh
from ..models.layers import fold_in
from ..parallel import dist
from ..parallel.mesh import build_mesh, mesh_from_config
from .losses import resolve_loss
from .steps import eval_kwargs, finalize_metrics, make_eval_step


def _build_test_loader(config, shard):
    """The config's ``test_loader``; else its ``valid_loader`` (or
    ``train_loader``) rebuilt with ``training=False`` and no shuffle, as
    the reference's ``test.py`` does; ``shard``: ``(index, count)`` of the
    mesh's data axis."""
    if config.get("test_loader", None):
        return config.init_obj("test_loader", LOADERS, shard=shard)
    for block in ("valid_loader", "train_loader"):
        spec = config.get(block, None)
        if spec:
            args = dict(spec.get("args", {}))
            args["training"] = False
            args["shuffle"] = False
            return LOADERS.get(spec["type"])(**args, shard=shard)
    raise KeyError("config defines none of test_loader/valid_loader/"
                   "train_loader")


def _outputs(model, batch, input_key: str, seed=None, shard=None):
    """``(outputs, mask)``: the model's per-example outputs as float32 (a
    fused head's ``(hidden, head_w)`` materialised as logits; a masked
    LM's logits) and a masked LM's position mask as bool (else None), for
    the batch the eval step scored (the same ``seed``)."""
    with torch.no_grad():
        out = model(batch[input_key],
                    **eval_kwargs(model, batch, input_key, seed, shard))
        if getattr(model, "mlm_output", False):
            logits, sel = out
            return logits.float(), sel.bool()
        if isinstance(out, tuple):
            # the head's weight is a view of a parameter: inside no_grad
            hidden, w = out
            out = hidden @ w
    return out.float(), None


def evaluate(config, device, save_outputs=None, seed=None) -> dict:
    """Evaluate ``config.resume`` on the config's test loader; returns the
    loss and metrics over the global set. ``seed`` seeds eval-time model
    randomness (module docstring); None keeps the deterministic path."""
    logger = config.get_logger("test")
    if config.resume is None:
        raise ValueError("evaluation requires a checkpoint (-r)")
    mesh = build_mesh(mesh_from_config(config))
    if save_outputs is not None and mesh.axis_size("seq") > 1:
        raise ValueError("save_outputs writes whole rows; on a seq axis > 1 "
                         "each rank holds one shard of a row")
    model = inject_mesh(config.init_obj("arch", MODELS, device=device,
                                        param_dtype=torch.float32), mesh)
    trainer_cfg = config["trainer"]
    use_ema = (float(trainer_cfg.get("ema_decay", 0.0)) > 0
               and bool(trainer_cfg.get("eval_with_ema", True))
               and (config.resume / EMA_FILE).exists())
    load_model(config.resume, model, map_location=device)
    if use_ema:
        # the EMA's params over model.pt's buffers (BN's running averages)
        load_model(config.resume, model, map_location=device, name=EMA_FILE)
        logger.info("evaluating the EMA's weights (%s)", EMA_FILE)
    criterion = resolve_loss(config["loss"])
    metric_fns = [METRICS.get(m) for m in config["metrics"]]
    test_loader = _build_test_loader(config, mesh.data_shard())
    dk = config.get("data_keys", {}) or {}
    input_key = dk.get("input", "image")
    target_key = dk.get("target", "label")
    shard = mesh.data_shard()
    eval_step = make_eval_step(model, criterion, metric_fns,
                               input_key=input_key, target_key=target_key,
                               data_shard=shard, mesh=mesh)
    depth = max(int(config["trainer"].get("prefetch_depth", 2)), 1)
    accum, dumped_out, dumped_tgt, dumped_msk = None, [], [], []
    for i, batch in enumerate(prefetch_to_device(
            test_loader, device, depth,
            getattr(test_loader, "device_transform", None))):
        batch_seed = None if seed is None else fold_in(int(seed), i)
        m = eval_step(batch, seed=batch_seed)
        accum = m if accum is None else {k: accum[k] + v
                                         for k, v in m.items()}
        if save_outputs is not None:
            # rows picked on the host: a uint16 token target has no CUDA
            # index kernel
            keep = batch["mask"].bool().cpu().numpy()
            out, msk = _outputs(model, batch, input_key, batch_seed, shard)
            dumped_out.append(out.cpu().numpy()[keep])
            dumped_tgt.append(batch[target_key].cpu().numpy()[keep])
            if msk is not None:
                dumped_msk.append(msk.cpu().numpy()[keep])

    if save_outputs is not None and all(
            mesh.axis_index(a) == 0 for a in ("pipe", "expert", "tensor")):
        out_dir = Path(save_outputs)
        out_dir.mkdir(parents=True, exist_ok=True)
        rank = shard[0]
        if dumped_out:
            np.save(out_dir / f"outputs_p{rank}.npy",
                    np.concatenate(dumped_out))
            np.save(out_dir / f"targets_p{rank}.npy",
                    np.concatenate(dumped_tgt))
            if dumped_msk:
                np.save(out_dir / f"masks_p{rank}.npy",
                        np.concatenate(dumped_msk))
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
