"""Training entry point of the port, the counterpart of the repository's
root ``train.py``.

    python -m pytorch_distributed_template_tpu_torch.train \\
        -c configs/lm_debug.json [--device cpu] [-s SAVE_DIR]
    python -m pytorch_distributed_template_tpu_torch.train \\
        -r <run_dir>/checkpoint-epochN            # resume at epoch N + 1

Flags as in the JAX ``train.py``: ``-c``, ``-r``, ``-s``, ``--seed``,
``--no-validate``, ``--lr``, ``--bs``, ``--set KEYCHAIN VALUE``, plus
``--device`` (default ``cuda``; raises without a CUDA device). ``-l`` and
``--deterministic`` are accepted as the JAX CLI accepts them;
``--auto-resume`` is slice 4's and refuses. The model is built with
float32 master weights (``param_dtype``); its compute dtype is the
config's (``bfloat16: true``), and the model's weights are drawn from
``--seed`` (default 0) with the family's init law.
"""
from __future__ import annotations

import argparse
import collections

import torch

from . import models  # noqa: F401  (registers the model families)
from .config import LOADERS, METRICS, MODELS, ConfigParser
from .data import datasets  # noqa: F401  (registers the loaders)
from .engine import metrics  # noqa: F401  (registers the metrics)
from .engine.losses import resolve_loss
from .engine.trainer import Trainer
from .utils.util import resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="LM training (PyTorch)")
    parser.add_argument("-c", "--config", default=None, type=str,
                        help="config file path (default: None)")
    parser.add_argument("-r", "--resume", default=None, type=str,
                        help="path to a checkpoint-epochN to resume from")
    parser.add_argument("-l", "--local_rank", default=0, type=int,
                        help="accepted for launcher compatibility; unused")
    parser.add_argument("-s", "--save_dir", default=None, type=str,
                        help="dir of save path")
    parser.add_argument("--no-validate", action="store_true",
                        help="skip validation during training")
    parser.add_argument("--auto-resume", action="store_true",
                        help="resume from the newest checkpoint (slice 4)")
    parser.add_argument("--seed", type=int, default=None,
                        help="Random seed (weights and dropout).")
    parser.add_argument("--deterministic", action="store_true",
                        help="accepted for parity with the JAX CLI")
    parser.add_argument("--device", default=None,
                        help="Device to train on (default cuda).")
    return parser


CustomArgs = collections.namedtuple("CustomArgs", "flags type target")
OPTIONS = [
    CustomArgs(["--lr", "--learning_rate"], float, "optimizer;args;lr"),
    CustomArgs(["--bs", "--batch_size"], int, "train_loader;args;batch_size"),
]


def build_trainer(args, config) -> Trainer:
    """Model, loss, metrics, loaders and the trainer, from the config."""
    if args.auto_resume:
        raise NotImplementedError("--auto-resume is slice 4 (the training "
                                  "main path on LeNet/MNIST)")
    device = resolve_device(args.device)
    seed = args.seed if args.seed is not None else 0
    model = config.init_obj("arch", MODELS, device=device,
                            param_dtype=torch.float32)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    criterion = resolve_loss(config["loss"])
    metric_fns = [METRICS.get(m) for m in config["metrics"]]
    train_loader = config.init_obj("train_loader", LOADERS)
    valid_loader = (None if args.no_validate
                    else config.init_obj("valid_loader", LOADERS))
    return Trainer(model, criterion, metric_fns, config=config,
                   train_loader=train_loader, valid_loader=valid_loader,
                   device=device, seed=seed)


def main(argv=None, on_trainer=None) -> dict:
    """Parse ``argv`` (default ``sys.argv``), build the trainer, call
    ``on_trainer(trainer)`` when given (before the first epoch), train, and
    return the last epoch's log."""
    args, config = ConfigParser.from_args(build_parser(), OPTIONS,
                                          training=True, argv=argv)
    trainer = build_trainer(args, config)
    if on_trainer is not None:
        on_trainer(trainer)
    return trainer.train()


if __name__ == "__main__":
    main()
