"""Evaluation entry point of the port, the counterpart of the repository's
root ``test.py`` (the reference's distributed evaluation).

    python -m pytorch_distributed_template_tpu_torch.test \\
        -r <run_dir>/model_best [--save-outputs DIR] [--device cpu]
    torchrun --standalone --nproc_per_node=N \\
        -m pytorch_distributed_template_tpu_torch.test -r <run>/model_best

Flags as in the JAX ``test.py``: ``-r`` (required; the config is found
next to the checkpoint), ``-c`` (a config overlay), ``-l`` (accepted for
launchers), ``-s``, ``--seed`` and ``--save-outputs DIR``, plus
``--device`` (default ``cuda``; raises without a CUDA device). The
process joins the launcher's group first, when there is one; the loss and
metrics cover the global test set.
"""
from __future__ import annotations

import argparse

from . import models  # noqa: F401  (registers the model families)
from .config import ConfigParser
from .data import datasets  # noqa: F401  (registers the loaders)
from .engine import metrics  # noqa: F401  (registers the metrics)
from .engine.evaluator import evaluate
from .parallel import dist


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="evaluation (PyTorch)")
    parser.add_argument("-c", "--config", default=None, type=str,
                        help="optional config overlay (fine-tune style)")
    parser.add_argument("-r", "--resume", required=True, type=str,
                        help="checkpoint directory to evaluate")
    parser.add_argument("-l", "--local_rank", default=0, type=int,
                        help="accepted for launcher compatibility; unused")
    parser.add_argument("-s", "--save_dir", default=None, type=str)
    parser.add_argument("--seed", type=int, default=None,
                        help="seed for eval-time model randomness (no "
                             "model of the port draws any)")
    parser.add_argument("--save-outputs", default=None, type=str,
                        metavar="DIR",
                        help="dump per-example outputs/targets (npy) here "
                             "in addition to metrics")
    parser.add_argument("--device", default=None,
                        help="Device to evaluate on (default cuda).")
    return parser


def main(argv=None) -> dict:
    """Parse ``argv``, join the launcher's group if there is one, and
    return the loss and metrics of ``-r``'s checkpoint on the test set."""
    args = ConfigParser.parse_args(build_parser(), (), argv)
    device = dist.initialize(args.device)
    _, config = ConfigParser.from_args(args, (), training=False)
    return evaluate(config, device, save_outputs=args.save_outputs,
                    seed=args.seed)


if __name__ == "__main__":
    try:
        main()
    finally:
        dist.shutdown()
