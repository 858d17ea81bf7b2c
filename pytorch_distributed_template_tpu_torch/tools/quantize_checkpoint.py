"""Quantize a trained checkpoint into an int8 (w8a16) serving artifact:
the port of the repository's ``scripts/quantize_checkpoint.py``.

    python -m pytorch_distributed_template_tpu_torch.train \\
        -c configs/bytelm_stdlib.json
    python -m pytorch_distributed_template_tpu_torch.tools.quantize_checkpoint \\
        -r saved/<...>/model_best
    python -m pytorch_distributed_template_tpu_torch.generate \\
        -r saved/<...>/serving_w8a16/model_w8a16 --prompt "def main(" \\
        --max-new-tokens 128 --speculative 4

Input: a training checkpoint (``model.pt``, or ``ema.pt``'s params over it
with ``--ema``) or a params-only serving artifact (a merged LoRA, say).
Output: ``<out>/config.json``, the run's config with ``arch.args.quant:
"w8a16"`` and ``fused_head: false`` (the sampling CLI builds the quant
model from it with no extra flag), beside ``<out>/model_w8a16``, a
params-only artifact whose Denses hold int8 ``kernel_q`` and per-channel
``scale`` (``models.quant.quantize_params_w8``; embeddings and norms stay
float). ``<out>`` defaults to ``<checkpoint's parent>/serving_w8a16``.
MoE configs are refused with the converter's message; a w8a16 artifact is
refused as input. KV-cache quantization stays a serving-time choice:
``--set "arch;args;kv_quant" int8`` on the generate call. The arithmetic
runs on the card, one tensor at a time (``--device cpu`` runs it on the
host); the artifact is written from the host.
"""
from __future__ import annotations

import argparse
import copy
import json
from pathlib import Path

import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Quantize a checkpoint to an int8 serving artifact")
    parser.add_argument("-c", "--config", default=None, type=str,
                        help="Optional config overlay (fine-tune style).")
    parser.add_argument("-r", "--resume", required=True, type=str,
                        help="Trained checkpoint or serving artifact.")
    parser.add_argument("-s", "--save_dir", default=None, type=str)
    parser.add_argument("-o", "--output", default=None, type=str,
                        help="Artifact directory (default: "
                             "<checkpoint_parent>/serving_w8a16).")
    parser.add_argument("--ema", action="store_true",
                        help="Quantize the EMA shadow weights if present.")
    parser.add_argument("--device", default=None,
                        help="Where the arithmetic runs, one tensor at a "
                             "time (default cuda); the artifact is written "
                             "from the host.")
    return parser


def quantize(config, output=None, ema: bool = False,
             device=None) -> Path:
    """Write the w8a16 artifact of ``config.resume`` (module docstring),
    the arithmetic on ``device`` (default cuda); returns its ``-r``-able
    path."""
    from ..checkpoint import (
        load_serving_meta, restore_serving_params, save_serving_params,
    )
    from ..checkpoint.manager import EMA_FILE
    from ..models.quant import (
        quantize_params_w8, validate_quant_config, weight_bytes,
    )
    from ..utils.util import resolve_device

    device = resolve_device(device)
    logger = config.get_logger("quantize")
    if config.resume is None:
        raise ValueError("quantization requires a checkpoint (-r)")
    from .. import models  # noqa: F401  (registers the families)
    from ..config.registry import MODELS, resolve

    arch = config["arch"]
    # the refusals first, with the converter's own message (MoE experts
    # and routers stay dense; fused_head is stripped below)
    shape = resolve(MODELS, arch["type"])(**dict(arch.get("args") or {}),
                                          device="meta")
    validate_quant_config("w8a16", False,
                          int(getattr(shape, "moe_experts", 0) or 0))
    meta = load_serving_meta(config.resume)
    if meta is not None and meta.get("quant") == "w8a16":
        raise SystemExit(
            f"{config.resume} is already a w8a16 serving artifact "
            f"(quantized from {meta.get('source', 'unknown')}); "
            "re-quantizing is a no-op that would write a duplicate "
            "artifact — point -r at the original training checkpoint "
            "or merged-LoRA artifact instead")
    if meta is not None:
        if ema:
            raise SystemExit(
                f"--ema has no effect on {config.resume}: it is a "
                "params-only serving artifact (the EMA-or-not choice was "
                "baked in when the artifact was produced — re-run its "
                "producer with --ema instead)")
        src = "params"
        state = dict(restore_serving_params(config.resume, "cpu"))
    else:
        state = torch.load(config.resume / "model.pt", map_location="cpu",
                           weights_only=True)
        src = "params"
        if ema and (config.resume / EMA_FILE).exists():
            state.update(torch.load(config.resume / EMA_FILE,
                                    map_location="cpu", weights_only=True))
            src = "ema_params"
    if any(k.endswith(".kernel_q") for k in state):
        raise SystemExit(f"{config.resume} already holds int8 kernel_q "
                         "leaves; re-quantizing is a no-op — use the "
                         "original checkpoint")
    qstate = {k: v.cpu() for k, v in quantize_params_w8(
        state, device=device).items()}

    out_dir = (config.resume.parent / "serving_w8a16" if output is None
               else Path(output))
    out_dir.mkdir(parents=True, exist_ok=True)
    serving_cfg = copy.deepcopy(config.config)
    sargs = serving_cfg.setdefault("arch", {}).setdefault("args", {})
    sargs["quant"] = "w8a16"
    if sargs.get("fused_head"):
        sargs["fused_head"] = False   # training-loss mode; decode emits logits
    (out_dir / "config.json").write_text(json.dumps(serving_cfg, indent=2))
    path = save_serving_params(
        out_dir / "model_w8a16", qstate,
        meta={"arch": arch["type"], "quant": "w8a16",
              "source": str(config.resume), "source_params": src,
              "dense_bytes": weight_bytes(state),
              "w8a16_bytes": weight_bytes(qstate)})
    n_int8 = sum(t.numel() for t in qstate.values()
                 if t.dtype == torch.int8)
    n_all = sum(t.numel() for t in qstate.values())
    logger.info("Quantized %s (%s) -> %s: %.1f%% of %d params stored int8, "
                "%d -> %d weight bytes", config.resume, src, path,
                100.0 * n_int8 / max(n_all, 1), n_all, weight_bytes(state),
                weight_bytes(qstate))
    return path


def main(argv=None) -> Path:
    from ..config import ConfigParser

    args, config = ConfigParser.from_args(build_parser(), (),
                                          training=False, argv=argv)
    path = quantize(config, args.output, args.ema, args.device)
    print(path)
    return path


if __name__ == "__main__":
    main()
