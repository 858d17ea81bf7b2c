"""Training entry point of the port, the counterpart of the repository's
root ``train.py``.

    python -m pytorch_distributed_template_tpu_torch.train \\
        -c configs/lm_debug.json [--device cpu] [-s SAVE_DIR]
    python -m pytorch_distributed_template_tpu_torch.train \\
        -r <run_dir>/checkpoint-epochN            # resume at epoch N + 1
    python -m pytorch_distributed_template_tpu_torch.train \\
        -c configs/lm_debug.json --auto-resume    # the newest checkpoint
    torchrun --standalone --nproc_per_node=N \\
        -m pytorch_distributed_template_tpu_torch.train -c configs/mnist.json

Flags as in the JAX ``train.py``: ``-c``, ``-r``, ``-s``, ``--seed``,
``--no-validate``, ``--lr``, ``--bs``, ``--set KEYCHAIN VALUE``, plus
``--device`` (default ``cuda``; raises without a CUDA device). ``-l`` and
``--deterministic`` are accepted as the JAX CLI accepts them.
``--auto-resume`` resumes the ``-c`` config's experiment from its newest
checkpoint (``config.parser.find_latest_checkpoint``: an epoch edge, an
interval slot or the emergency save, at the exact next batch when the
checkpoint has a ``data_state`` sidecar), or starts it fresh; the
supervisor (``supervise.py``) relaunches a run this way. As in the JAX
``train.py``: the
config's ``compile_cache`` section is read (``utils/compile_cache.py``;
the port's compiled artifacts are its kernel libraries), SIGUSR2 arms an
on-demand ``torch.profiler`` window of ``PDT_PROFILE_STEPS`` (default 5)
steps, and a run stopped by SIGTERM checkpoints its epoch and exits with
status 75 (``utils.preemption.EXIT_PREEMPTED``). Under a launcher
(``torchrun``) the process joins the group first
(``parallel.dist.initialize``: NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``) and trains with DDP;
``--bs`` is then the batch of one data shard. A config's ``mesh`` with a
``seq`` axis (``configs/llama_swa_long.json``, ``gpt2_long.json``) splits
each row over that many ranks (sequence parallelism; ranks ``data * S +
seq``), the ranks of a seq row reading the same batch::

    torchrun --standalone --nproc_per_node=4 \
        -m pytorch_distributed_template_tpu_torch.train \
        -c configs/llama_swa_long.json

The model is built with float32
master weights (``param_dtype``); its compute dtype is the config's
(``bfloat16: true``), and the model's weights are drawn from ``--seed``
(default 0) with the family's init law.
"""
from __future__ import annotations

import argparse
import collections
import logging
import os

import torch

from . import models  # noqa: F401  (registers the model families)
from .config import LOADERS, METRICS, MODELS, ConfigParser
from .data import datasets  # noqa: F401  (registers the loaders)
from .engine import metrics  # noqa: F401  (registers the metrics)
from .engine.losses import resolve_loss
from .engine.trainer import Trainer
from .observability.profiler import install_sigusr2
from .parallel import dist
from .parallel.mesh import build_mesh, mesh_from_config
from .utils import preemption
from .utils.compile_cache import configure_compile_cache

logger = logging.getLogger(__name__)


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
                        help="resume the experiment's newest checkpoint "
                             "(a fresh run when there is none)")
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


def build_trainer(args, config, device) -> Trainer:
    """Model, loss, metrics, loaders and the trainer, from the config."""
    seed = args.seed if args.seed is not None else 0
    mesh = build_mesh(mesh_from_config(config))   # refuses A11d, A11b's rest
    model = config.init_obj("arch", MODELS, device=device,
                            param_dtype=torch.float32)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    criterion = resolve_loss(config["loss"])
    metric_fns = [METRICS.get(m) for m in config["metrics"]]
    shard = mesh.data_shard()
    train_loader = config.init_obj("train_loader", LOADERS, shard=shard)
    valid_loader = (None if args.no_validate else
                    config.init_obj("valid_loader", LOADERS, shard=shard))
    return Trainer(model, criterion, metric_fns, config=config,
                   train_loader=train_loader, valid_loader=valid_loader,
                   device=device, seed=seed, mesh=mesh)


def main(argv=None, on_trainer=None) -> dict:
    """Parse ``argv`` (default ``sys.argv``), join the launcher's process
    group if there is one, build the trainer, call ``on_trainer(trainer)``
    when given (before the first epoch), train, and return the last
    epoch's log. Raises ``SystemExit(75)`` when a preemption signal
    stopped the run (after its checkpoint)."""
    args = ConfigParser.parse_args(build_parser(), OPTIONS, argv)
    device = dist.initialize(args.device)
    _, config = ConfigParser.from_args(args, OPTIONS, training=True)
    configure_compile_cache(config)
    trainer = build_trainer(args, config, device)
    if install_sigusr2(trainer.trace) and dist.is_main_process():
        logger.info("SIGUSR2 armed: signal pid %d to capture an on-demand "
                    "profiler trace (PDT_PROFILE_STEPS=%s steps).",
                    os.getpid(), os.environ.get("PDT_PROFILE_STEPS", "5"))
    if on_trainer is not None:
        on_trainer(trainer)
    log = trainer.train()
    if preemption.requested():
        # checkpointed, but the work is not finished: a distinct status
        logger.warning("exiting with preemption status %d (resume with -r "
                       "<run_dir>/checkpoint-epochN or --auto-resume)",
                       preemption.EXIT_PREEMPTED)
        raise SystemExit(preemption.EXIT_PREEMPTED)
    return log


if __name__ == "__main__":
    try:
        main()
    finally:
        dist.shutdown()
