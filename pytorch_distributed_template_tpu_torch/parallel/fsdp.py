"""ZeRO-3 over the ``fsdp`` mesh axis: what XLA inserts for the JAX
package's fsdp placements (``parallel/sharding.py::apply_rules``' fallback)
around a jitted step, as gather units around the module's forward.

Each rank holds its slice of every fsdp-placed parameter
(``parallel.sharding.shard_params``). A unit is a module whose forward
first gathers its fsdp-placed parameters whole over the fsdp group (one
differentiable ``parallel.collectives.all_gather`` of the unit's slices
concatenated, in the stored dtype), then runs with the whole tensors in
place of the parameters, and puts the slices back. The gather's backward
is a reduce-scatter (sum): each rank's part of the gradient comes back to
its slice, summed over the fsdp ranks, whose batch rows differ.

The units: each of the model's ``fsdp_units()`` (``[(name, block)]``: the
LM families' transformer blocks), and the root, the model itself over the
parameters no block holds (the embeddings, the final norm and the head),
gathered once per forward and kept to its end. A model that declares no
units is one root unit (LeNet, as the JAX package trains it on ``{"data":
2, "fsdp": 4}``). A block that runs under ``torch.utils.checkpoint``
gathers inside the region: the remat recompute gathers again and the
backward keeps no whole weight. Without remat the whole weights a block's
backward reads stay alive from its forward to its backward, as DDP keeps
its replicas.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict

import torch

from .collectives import all_gather
from .sharding import join


def _gather(params, placements, size: int, group):
    """The whole tensors of ``params`` (this rank's slices, placed by
    ``placements``), by one differentiable gather."""
    flat = torch.cat([p.reshape(-1) for p in params])
    stacked = all_gather(flat, 0, group).view(size, flat.numel())
    out, off = [], 0
    for p, pl in zip(params, placements):
        n = p.numel()
        whole = list(p.shape)
        whole[pl.dim] *= size
        out.append(join(stacked[:, off:off + n].reshape(
            (size,) + tuple(p.shape)), pl, tuple(whole)))
        off += n
    return out


@contextlib.contextmanager
def _swapped(module, tensors: Dict[str, torch.Tensor]):
    """Within the block, ``module``'s parameters named in ``tensors`` are
    those tensors (plain attributes); the parameters come back after."""
    saved = []
    try:
        for name, t in tensors.items():
            owner_name, _, attr = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            saved.append((owner, attr, owner._parameters.pop(attr)))
            setattr(owner, attr, t)
        yield
    finally:
        for owner, attr, param in reversed(saved):
            delattr(owner, attr)
            owner._parameters[attr] = param


def _wrap(module, placed: dict, size: int, group) -> None:
    """Make ``module`` a unit over its parameters in ``placed``."""
    if not placed:
        return
    names = sorted(placed)
    params = dict(module.named_parameters())
    params = [params[n] for n in names]
    placements = [placed[n] for n in names]
    forward = module.forward

    @functools.wraps(forward)    # the signature the train step reads
    def gathered(*args, **kwargs):
        whole = _gather(params, placements, size, group)
        with _swapped(module, dict(zip(names, whole))):
            return forward(*args, **kwargs)

    module.forward = gathered


def install_units(model, mesh, placements) -> None:
    """Make ``model`` (its slices in place) gather its fsdp-placed
    parameters per unit (module docstring)."""
    size, group = mesh.axis_size("fsdp"), mesh.group("fsdp")
    fsdp = {n: pl for n, pl in placements.items() if pl.axis == "fsdp"}
    units = model.fsdp_units() if hasattr(model, "fsdp_units") else []
    for prefix, block in units:
        head = prefix + "."
        _wrap(block, {n[len(head):]: pl for n, pl in fsdp.items()
                      if n.startswith(head)}, size, group)
        fsdp = {n: pl for n, pl in fsdp.items() if not n.startswith(head)}
    _wrap(model, fsdp, size, group)
