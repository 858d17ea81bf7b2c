"""Merge a LoRA fine-tune's adapters into a plain dense serving artifact:
the port of the repository's ``scripts/merge_lora.py``.

    python -m pytorch_distributed_template_tpu_torch.tools.merge_lora \\
        -r <fine-tune run>/model_best [-o DIR] [--ema]
    python -m pytorch_distributed_template_tpu_torch.generate \\
        -r <fine-tune run>/serving_merged/model_merged --prompt-ids 1,2,3

Reads the checkpoint's ``model.pt`` (``ema.pt`` with ``--ema``), folds
every layer's ``weight + (lora_alpha / rank) (A B)^T`` in float32
(``models.lora.merge_lora_params``), and writes a params-only artifact
through ``checkpoint.serving.save_serving_params`` (the meta sidecar and
the checksum manifest) at ``<out>/model_merged``, beside a
``<out>/config.json`` without ``lora_rank``/``lora_alpha``,
``optimizer.args.trainable`` and ``trainer.init_from``: ``generate.py``
and ``serve.py`` build the plain dense model from it. ``<out>`` defaults
to ``<checkpoint's parent>/serving_merged``. The merge is host
arithmetic on the saved tensors; nothing runs on a device.
"""
from __future__ import annotations

import argparse
import copy
import json
from pathlib import Path

import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Merge LoRA adapters into a dense serving artifact")
    parser.add_argument("-c", "--config", default=None, type=str)
    parser.add_argument("-r", "--resume", required=True, type=str,
                        help="LoRA training checkpoint directory.")
    parser.add_argument("-s", "--save_dir", default=None, type=str)
    parser.add_argument("-o", "--output", default=None, type=str,
                        help="Artifact directory (default: "
                             "<checkpoint_parent>/serving_merged).")
    parser.add_argument("--ema", action="store_true",
                        help="Merge the EMA shadow weights if present.")
    return parser


def merge(config, output=None, ema: bool = False) -> Path:
    """Write the merged artifact of ``config.resume`` (module docstring);
    returns its ``-r``-able path."""
    from ..checkpoint import save_serving_params
    from ..checkpoint.manager import EMA_FILE
    from ..models.lora import merge_lora_params

    logger = config.get_logger("merge_lora")
    if config.resume is None:
        raise ValueError("merging requires a checkpoint (-r)")
    arch_args = config["arch"].get("args", {})
    rank = int(arch_args.get("lora_rank", 0))
    if rank <= 0:
        raise SystemExit("checkpoint's arch has no lora_rank: nothing to "
                         "merge")
    alpha = float(arch_args.get("lora_alpha", 16.0))
    src = "ema" if ema and (config.resume / EMA_FILE).exists() else "params"
    state = torch.load(config.resume / (EMA_FILE if src == "ema"
                                        else "model.pt"),
                       map_location="cpu")
    merged = merge_lora_params(state, alpha=alpha)

    out_dir = (config.resume.parent / "serving_merged" if output is None
               else Path(output))
    out_dir.mkdir(parents=True, exist_ok=True)
    serving_cfg = copy.deepcopy(config.config)
    sargs = serving_cfg.setdefault("arch", {}).setdefault("args", {})
    sargs.pop("lora_rank", None)
    sargs.pop("lora_alpha", None)
    serving_cfg.get("optimizer", {}).get("args", {}).pop("trainable", None)
    serving_cfg.get("trainer", {}).pop("init_from", None)
    (out_dir / "config.json").write_text(json.dumps(serving_cfg, indent=2))
    path = save_serving_params(
        out_dir / "model_merged", merged,
        meta={"arch": config["arch"]["type"],
              "lora_merged": {"rank": rank, "alpha": alpha},
              "source": str(config.resume), "source_params": src})
    logger.info("Merged rank-%d LoRA (alpha=%s) from %s -> %s", rank, alpha,
                config.resume, path)
    return path


def main(argv=None) -> Path:
    from ..config import ConfigParser

    args, config = ConfigParser.from_args(build_parser(), (),
                                          training=False, argv=argv)
    path = merge(config, args.output, args.ema)
    print(path)
    return path


if __name__ == "__main__":
    main()
