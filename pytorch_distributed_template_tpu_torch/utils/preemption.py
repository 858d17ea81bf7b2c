"""Preemption-aware graceful shutdown (the port of the JAX package's
``utils/preemption.py``).

A SIGTERM handler flips a process-local plain bool (async-signal-safe: a
module-global store, no locks or I/O). The trainer polls the local flag
every batch with one rank, and reaches *consensus across ranks* every
``preempt_check_steps`` batches and at epoch edges through
:func:`sync_requested`: any rank signalled => every rank checkpoints and
stops together at the same batch, because a lone early exit would hang
the other ranks' next DDP all-reduce. The consensus is one ``all_reduce``
(MAX) of a one-element tensor over the process group, on the group's
device (the card under NCCL, the CPU under gloo).
"""
from __future__ import annotations

import logging
import signal
from typing import Iterable

import torch

from ..parallel import dist

logger = logging.getLogger(__name__)

#: the exit status of a run stopped by preemption (the JAX ``train.py``'s):
#: ``EX_TEMPFAIL``, which supervisors read as "relaunch me"
EXIT_PREEMPTED = 75

_flag = False
_installed = False


def _handler(signum, frame):  # noqa: ARG001 (signal signature)
    global _flag
    _flag = True


def install(signals: Iterable[int] = (signal.SIGTERM,)) -> None:
    """Install the preemption handler (main thread only; idempotent)."""
    global _installed
    if _installed:
        return
    try:
        for s in signals:
            signal.signal(s, _handler)
        _installed = True
    except ValueError:  # not the main thread (e.g. tests run in a worker)
        logger.info("preemption handler not installed (non-main thread)")


def requested() -> bool:
    """This process's local flag (no exchange; free to poll)."""
    return _flag


def sync_requested() -> bool:
    """Consensus: True iff ANY rank saw a preemption signal.

    With one process this is the local flag; in a process group it is
    one ``all_reduce`` of the flag. Callers MUST invoke it at the same
    point on every rank (epoch edge, or every ``preempt_check_steps``
    batches)."""
    if dist.process_count() == 1:
        return _flag
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.backend() == "nccl" else torch.device("cpu"))
    flag = torch.tensor([1.0 if _flag else 0.0], device=device)
    dist.all_reduce_max(flag)
    return bool(flag.item() > 0)


def set_local() -> None:
    """Set the flag as if a signal had arrived (tests)."""
    global _flag
    _flag = True


def reset() -> None:
    """Clear the flag (tests)."""
    global _flag
    _flag = False
