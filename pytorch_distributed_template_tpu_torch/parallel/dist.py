"""Process-level distribution over ``torch.distributed``: the port of the
JAX package's ``parallel/dist.py``.

:func:`initialize` joins the process group when a launcher's environment is
present (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` and
``LOCAL_RANK``, as ``torchrun`` sets them), ``WORLD_SIZE=1`` included, so
one card can run NCCL and DDP. The backend is ``nccl`` on CUDA and ``gloo``
when the caller asks for the CPU; the port never drops to gloo on a card.
Without that environment it joins nothing, as the JAX one does on one
host.

The helpers below degrade to the identity in one process (no group):
``process_index() == 0``, ``process_count() == 1``, ``synchronize`` returns
at once, ``all_gather_object(x) == [x]``, ``broadcast_object(x) is x``.
"""
from __future__ import annotations

import os
from typing import Any, List

import torch
import torch.distributed as tdist

from ..utils.util import resolve_device

LAUNCH_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """Whether a launcher's environment names a process group to join."""
    return all(k in os.environ for k in LAUNCH_ENV)


def initialize(device=None) -> torch.device:
    """Join the launcher's process group (once) and return this process's
    device: ``cuda:{LOCAL_RANK}`` under a launcher when ``device`` is
    CUDA (the default), else ``device`` as :func:`resolve_device` gives
    it."""
    dev = resolve_device(device)
    if not launched():
        return dev
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not tdist.is_initialized():
        tdist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method="env://", world_size=int(os.environ["WORLD_SIZE"]),
            rank=int(os.environ["RANK"]))
    return dev


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if tdist.is_available() and tdist.is_initialized():
        tdist.destroy_process_group()


def in_group() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def process_index() -> int:
    return tdist.get_rank() if in_group() else 0


def process_count() -> int:
    return tdist.get_world_size() if in_group() else 1


def is_main_process() -> bool:
    return process_index() == 0


def synchronize() -> None:
    """Barrier across the group; returns at once without one."""
    if not in_group():
        return
    if tdist.get_backend() == "nccl":
        tdist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        tdist.barrier()


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` summed over the group, in place; unchanged without
    one."""
    if in_group():
        tdist.all_reduce(tensor, op=tdist.ReduceOp.SUM)
    return tensor


def backend() -> str:
    """The group's backend (``"nccl"``/``"gloo"``); ``""`` without one."""
    return tdist.get_backend() if in_group() else ""


def all_reduce_max(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` maxed over the group, in place; unchanged without one."""
    if in_group():
        tdist.all_reduce(tensor, op=tdist.ReduceOp.MAX)
    return tensor


def all_gather_tensor(tensor: torch.Tensor) -> torch.Tensor:
    """Every process's ``tensor`` stacked in rank order (``[P, ...]``);
    ``tensor[None]`` without a group."""
    if not in_group():
        return tensor[None]
    out = [torch.empty_like(tensor) for _ in range(tdist.get_world_size())]
    tdist.all_gather(out, tensor)
    return torch.stack(out)


def all_gather_object(obj: Any) -> List[Any]:
    """Every process's ``obj`` (picklable), in rank order."""
    if not in_group():
        return [obj]
    out = [None] * tdist.get_world_size()
    tdist.all_gather_object(out, obj)
    return out


def broadcast_object(obj: Any) -> Any:
    """Rank 0's ``obj`` on every process."""
    if not in_group():
        return obj
    box = [obj]
    tdist.broadcast_object_list(box, src=0)
    return box[0]
