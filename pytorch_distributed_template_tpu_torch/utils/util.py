"""Host-side helpers: ordered JSON round-trip and device selection.

``read_json``/``write_json`` are copies of the JAX package's
``utils/util.py`` functions; ``resolve_device`` is the port's one rule for
where an entry point runs. ``LATER_RESUME`` names the slice that the
port's refusals of resume state point at (ROADMAP.md, queue A).
"""
from __future__ import annotations

import json
from collections import OrderedDict
from pathlib import Path

import torch

LATER_RESUME = ("ROADMAP A17 (resume state, the native batcher and the "
                "other optimizers, a later slice)")


def read_json(fname) -> OrderedDict:
    fname = Path(fname)
    with fname.open("rt") as handle:
        return json.load(handle, object_hook=OrderedDict)


def write_json(content, fname) -> None:
    fname = Path(fname)
    with fname.open("wt") as handle:
        json.dump(content, handle, indent=4, sort_keys=False)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for (or defaulted to) and absent —
    the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU")
    return dev
