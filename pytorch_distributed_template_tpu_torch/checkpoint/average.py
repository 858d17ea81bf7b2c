"""Checkpoint averaging (model soups, post-hoc Polyak): the port of the
JAX package's ``checkpoint/average.py``.

    python -m pytorch_distributed_template_tpu_torch.checkpoint.average \\
        <run>/checkpoint-epoch1 <run>/checkpoint-epoch2 -o <run>/soup \\
        [--weights 1 3]

The floating tensors of ``model.pt`` (the params and a BatchNorm model's
running averages, the JAX package's ``params`` and ``batch_stats``) and of
``ema.pt`` (the EMA's shadow params) are averaged in float64 with the
weights normalised (uniform by default), in the JAX function's order
(the last checkpoint's share first, then the others in turn), and cast
back to each tensor's dtype; any other entry of ``model.pt`` comes from
the last checkpoint. Every other file (``optimizer.pt``,
``train_state.json``, the ``data_state`` sidecar) is the last
checkpoint's, so resuming from a soup is resuming from that checkpoint
with averaged weights. The soup's ``<out>.meta.json`` is the last
checkpoint's meta with ``averaged_from`` and ``average_weights`` added
(``<out>.provenance.json`` when it has no meta). Checkpoints whose
``model.pt`` (or ``ema.pt``) names or shapes differ are refused, and so
is an output path that exists. ``test.py -r <out>`` evaluates the soup
(its config is found beside it, as for any checkpoint).
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from .manager import EMA_FILE, CheckpointManager

_AVERAGED = ("model.pt", EMA_FILE)


def _signature(state: dict) -> dict:
    return {k: tuple(v.shape) for k, v in state.items()}


def average_checkpoints(paths: Sequence, out_path,
                        weights: Optional[Sequence[float]] = None) -> Path:
    """Write the soup of the checkpoint directories ``paths`` to
    ``out_path`` (module docstring); returns ``out_path``."""
    paths = [Path(p) for p in paths]
    if not paths:
        raise ValueError("need at least one checkpoint to average")
    out_path = Path(out_path)
    if out_path.exists():
        raise FileExistsError(f"{out_path} already exists")
    w = np.asarray([1.0] * len(paths) if weights is None
                   else list(weights), np.float64)
    if len(w) != len(paths) or not np.all(w > 0):
        raise ValueError(f"bad weights {weights!r} for {len(paths)} ckpts")
    w = w / w.sum()
    last = paths[-1]
    files = [f for f in _AVERAGED if (last / f).exists()]
    soups = {}
    for name in files:
        ref = torch.load(last / name, map_location="cpu")
        keys = [k for k, v in ref.items() if v.is_floating_point()]
        acc = {k: ref[k].double() * w[-1] for k in keys}
        for p, wi in zip(paths[:-1], w[:-1]):
            # one checkpoint at a time: only the last is held whole
            t = (torch.load(p / name, map_location="cpu")
                 if (p / name).exists() else None)
            if t is None or _signature(t) != _signature(ref):
                raise ValueError(
                    f"checkpoint {p} has a different '{name}' tree than "
                    f"{last}: only same-architecture checkpoints average")
            for k in keys:
                acc[k] += t[k].double() * wi
            del t
        soups[name] = {k: (acc[k].to(v.dtype) if k in acc else v)
                       for k, v in ref.items()}

    tmp = out_path.with_name(f".{out_path.name}.tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    shutil.copytree(last, tmp)
    for name, state in soups.items():
        torch.save(state, tmp / name)
    tmp.rename(out_path)
    data_state = last.parent / f"{last.name}.data_state.json"
    if data_state.exists():
        shutil.copyfile(data_state,
                        out_path.parent / f"{out_path.name}.data_state.json")
    provenance = {"averaged_from": [str(p) for p in paths],
                  "average_weights": [float(x) for x in w]}
    meta = CheckpointManager.load_meta(last)
    if meta is not None:
        meta.update(provenance)
        (out_path.parent / f"{out_path.name}.meta.json").write_text(
            json.dumps(meta, indent=2))
    else:
        (out_path.parent / f"{out_path.name}.provenance.json").write_text(
            json.dumps(provenance, indent=2))
    return out_path


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Average checkpoint params into a model soup.")
    ap.add_argument("checkpoints", nargs="+",
                    help="checkpoint directories (order matters: every "
                         "file but the averaged tensors comes from the "
                         "LAST one)")
    ap.add_argument("-o", "--out", required=True,
                    help="output checkpoint directory (must not exist)")
    ap.add_argument("--weights", type=float, nargs="+", default=None)
    args = ap.parse_args(argv)
    out = average_checkpoints(args.checkpoints, args.out, args.weights)
    print(f"wrote soup of {len(args.checkpoints)} checkpoints to {out}")


if __name__ == "__main__":
    main()
