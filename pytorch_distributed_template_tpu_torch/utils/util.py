"""Host-side helpers: ordered JSON round-trip, the progress bar and
device selection.

``read_json``/``write_json`` and ``maybe_tqdm`` are copies of the JAX
package's ``utils/util.py`` functions; ``resolve_device`` is the port's one
rule for where an entry point runs.
"""
from __future__ import annotations

import json
import sys
from collections import OrderedDict
from pathlib import Path

import torch


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


def maybe_tqdm(iterable, total=None, desc: str = "", enable=None):
    """``iterable`` in a tqdm progress bar (the reference's hot loops have
    one) when ``enable`` (``trainer.progress``) is true, or when it is
    None and stderr is a TTY (log files must not fill with carriage-return
    frames); tqdm is optional, and without it the iterable comes back as
    it is. Callers also gate on rank 0."""
    if enable is None:
        enable = getattr(sys.stderr, "isatty", lambda: False)()
    if not enable:
        return iterable
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, total=total, desc=desc, leave=False,
                dynamic_ncols=True)
