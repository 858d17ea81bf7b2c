"""Random-init params-only serving artifact for the port.

Writes the same layout as the JAX package's
``scripts/make_serving_artifact.py``:

    <out>/config.json     serving config (arch + serving sections)
    <out>/model/          params.pt + model.meta.json + model.manifest.json

The base config is the package's ``configs/mistral_7b_serve.json``; the
architecture is taken at its registry defaults (``--arch Mistral`` is the
published Mistral-7B-v0.1 shape, ``--arch MixtralMoE`` Mixtral-8x7B's)
with any ``--vocab-size``/``--d-model``/... given on the CLI overriding
them. Weights are drawn from an explicit ``torch.Generator`` seeded with
``--seed``, directly on the device. The
meta records the model's ``tp_geometry``; ``--tensor-parallel T`` refuses a
T that geometry cannot shard, then records T as the artifact's intended
``serving.tensor_parallel``.

    python -m pytorch_distributed_template_tpu_torch.tools.make_serving_artifact \\
        -o /path/to/art --arch Mistral
    python -m pytorch_distributed_template_tpu_torch.generate \\
        -r /path/to/art/model --prompt-ids 1,2,3
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

import torch

BASE_CONFIG = Path(__file__).resolve().parent.parent / "configs" \
    / "mistral_7b_serve.json"
ARCH_FLAGS = ("vocab_size", "n_layer", "n_head", "n_kv_head", "d_model",
              "d_ff", "max_len", "window", "attn_impl", "bfloat16")


def make_artifact(out_dir, arch: str = "Mistral", arch_args=None,
                  seed: int = 0, device=None,
                  tensor_parallel: int = 0) -> Path:
    """Build, randomly initialise and save the artifact; returns the
    ``-r``-able model path. ``tensor_parallel`` > 1 is refused before any
    weight is drawn when the model's geometry does not divide it."""
    import pytorch_distributed_template_tpu_torch.models  # noqa: F401
    from pytorch_distributed_template_tpu_torch.checkpoint import (
        save_serving_params,
    )
    from pytorch_distributed_template_tpu_torch.config.registry import MODELS
    from pytorch_distributed_template_tpu_torch.parallel.tp import (
        model_geometry, validate_tp_geometry,
    )
    from pytorch_distributed_template_tpu_torch.utils.util import (
        resolve_device,
    )

    arch_args = dict(arch_args or {})
    shape = MODELS.get(arch)(**arch_args, device="meta")
    # refuse at production time: an intended tp the geometry cannot shard
    # would only move the failure to the restore
    validate_tp_geometry(shape, int(tensor_parallel))
    device = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    model = MODELS.get(arch)(**arch_args, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(int(seed)))
    cfg = copy.deepcopy(json.loads(BASE_CONFIG.read_text()))
    cfg["name"] = f"{arch}Serve"
    cfg["arch"] = {"type": arch, "args": arch_args}
    if int(tensor_parallel) > 1:
        cfg.setdefault("serving", {})["tensor_parallel"] = \
            int(tensor_parallel)
    (out_dir / "config.json").write_text(json.dumps(cfg, indent=2))
    meta = {"arch": arch, "source": "random-init", "seed": int(seed),
            "params": sum(p.numel() for p in model.parameters()),
            "tp_geometry": model_geometry(shape)}
    if int(tensor_parallel) > 1:
        meta["tensor_parallel"] = int(tensor_parallel)
    state = {k: t.detach() for k, t in model.state_dict().items()}
    return save_serving_params(out_dir / "model", state, meta=meta)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="random-init params-only serving artifact")
    p.add_argument("-o", "--out", required=True,
                   help="artifact directory (config.json + model/)")
    p.add_argument("--arch", default="Mistral")
    for flag in ARCH_FLAGS:
        kind = {"attn_impl": str, "bfloat16": json.loads}.get(flag, int)
        p.add_argument("--" + flag.replace("_", "-"), type=kind,
                       default=None, help="arch arg (default: registry)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tensor-parallel", type=int, default=0,
                   help="the intended serving TP degree (refused when the "
                        "geometry does not divide it)")
    p.add_argument("--device", default=None,
                   help="device for init (default cuda)")
    args = p.parse_args(argv)
    arch_args = {f: getattr(args, f) for f in ARCH_FLAGS
                 if getattr(args, f) is not None}
    path = make_artifact(args.out, arch=args.arch, arch_args=arch_args,
                         seed=args.seed, device=args.device,
                         tensor_parallel=args.tensor_parallel)
    print(f"ARTIFACT {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
