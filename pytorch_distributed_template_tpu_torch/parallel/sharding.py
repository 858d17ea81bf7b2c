"""Placement of parameters over the mesh: the port of the JAX package's
``parallel/sharding.py`` (``path_str``, ``apply_rules``, ``_prune_spec``,
``_largest_divisible_axis``) as placement math over a state dict's names,
and what the trainer does with a ``pipe`` placement.

A model's ``partition_rules()`` are ordered ``(regex, P)`` pairs, matched
with ``re.search`` against each parameter's JAX path (``a/b/c``,
:func:`path_str`). :class:`P` is a tuple of axis names (or None) per
dimension, JAX's ``PartitionSpec``. :func:`apply_rules` maps every leaf to
the spec of its first matching rule, with the axes the mesh lacks dropped;
an unmatched leaf, or one whose spec pruned to nothing, replicates, except
on an ``fsdp`` axis, where JAX's ZeRO-3 fallback shards it on its largest
divisible dimension. A rule written with no axes (``P()``) pins its leaf
replicated on purpose.

The trainer acts on ``pipe`` placements only (``fsdp`` and ``tensor`` are
ROADMAP A11b and refuse in ``parallel.mesh.mesh_from_config``):
:func:`shard_pipe` keeps this rank's slice of every leaf placed on
``pipe`` (the slice ``shard_map`` would hand the rank), and records each
such leaf's dimension in ``model.pipe_placements``. Every rank builds the
whole model from the seed first, so the slices are the one-process
weights. A sharded model keeps the one-process state dict on disk:
:func:`gather_pipe` / :func:`gather_optimizer_state` rebuild the whole
tensors over the pipe group (collective), and :func:`slice_pipe` /
:func:`slice_optimizer_state` cut whole tensors back to this rank's slice
on load, whatever pipe size wrote them. :class:`PipeReduce` gives the
train step the global norms and counts over a pipe row: a stage leaf's
part is summed over the pipe group, a replicated leaf counted once.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

class P(tuple):
    """JAX's ``PartitionSpec``: one entry per leading dimension, an axis
    name, a tuple of axis names, or None (not sharded)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)


def path_str(name: str) -> str:
    """A state-dict key (``h.0.attn.qkv.weight``) rendered as ``a/b/c``
    for regex matching."""
    return name.replace(".", "/")


def _axis_names(mesh) -> tuple:
    return tuple(mesh.axis_names) if mesh is not None else ()


def _prune_spec(spec: P, mesh) -> P:
    """Drop mesh axes not present in this mesh from a spec."""
    names = _axis_names(mesh)
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            out.append(kept if kept else None)
        else:
            out.append(entry if entry in names else None)
    return P(*out)


def _largest_divisible_axis(shape, size: int):
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % size == 0 and shape[i] >= size:
            return i
    return None


def apply_rules(shapes: Dict[str, tuple], mesh,
                rules: Sequence[Tuple[str, P]] = ()) -> Dict[str, P]:
    """``{name: shape}`` -> ``{name: P}``: each leaf's spec from the first
    rule whose regex searches its :func:`path_str` (see the module
    docstring); ``P()`` is replicated."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]
    fsdp = (mesh is not None and "fsdp" in _axis_names(mesh)
            and mesh.axis_size("fsdp") > 1)
    out = {}
    for name, shape in shapes.items():
        path = path_str(name)
        matched = deliberate = None
        for pat, spec in compiled:
            if pat.search(path):
                matched = _prune_spec(spec, mesh)
                deliberate = not any(e for e in spec)
                break
        if matched is not None and (any(e for e in matched) or deliberate):
            out[name] = matched
            continue
        if fsdp and len(shape) >= 1:
            ax = _largest_divisible_axis(shape, mesh.axis_size("fsdp"))
            if ax is not None:
                spec = [None] * len(shape)
                spec[ax] = "fsdp"
                out[name] = P(*spec)
                continue
        out[name] = P()
    return out


def placement(spec: P, axis: str) -> Optional[int]:
    """The dimension ``spec`` shards over ``axis``, or None."""
    for dim, entry in enumerate(spec):
        names = entry if isinstance(entry, (tuple, list)) else (entry,)
        if axis in names:
            return dim
    return None


def shard_pipe(model, mesh) -> Dict[str, int]:
    """Keep this rank's ``pipe`` slice of every parameter a rule places on
    ``pipe`` (a mesh with a pipe axis > 1); returns and records
    ``model.pipe_placements``: ``{name: dim}``. A no-op without one."""
    placements: Dict[str, int] = {}
    if mesh is None or mesh.axis_size("pipe") == 1:
        model.pipe_placements = placements
        return placements
    size, index = mesh.axis_size("pipe"), mesh.axis_index("pipe")
    params = dict(model.named_parameters())
    specs = apply_rules({n: tuple(p.shape) for n, p in params.items()},
                        mesh, model.partition_rules())
    for name, spec in specs.items():
        dim = placement(spec, "pipe")
        if dim is None:
            continue
        p = params[name]
        if p.shape[dim] % size:
            raise ValueError(f"{name} {tuple(p.shape)}: dim {dim} does not "
                             f"split over a pipe axis of {size}")
        n = p.shape[dim] // size
        with torch.no_grad():
            p.data = p.data.narrow(dim, index * n, n).clone()
        placements[name] = dim
    model.pipe_placements = placements
    return placements


def _pipe_of(model) -> Tuple[Dict[str, int], int, int, object]:
    mesh = getattr(model, "mesh", None)
    placements = getattr(model, "pipe_placements", None) or {}
    if not placements:
        return {}, 1, 0, None
    return (placements, mesh.axis_size("pipe"), mesh.axis_index("pipe"),
            mesh.group("pipe"))


def _slice(t: torch.Tensor, dim: int, size: int, index: int,
           local: int) -> torch.Tensor:
    """``t``'s slice when it is whole (``local * size`` on ``dim``); else
    ``t`` (already the slice, or another shape the caller refuses)."""
    if t.dim() <= dim or t.shape[dim] != local * size:
        return t
    return t.narrow(dim, index * local, local)


def _gather(t: torch.Tensor, dim: int, size: int, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(size)]
    tdist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def slice_pipe(model, state: dict) -> dict:
    """``state`` (``{name: tensor}``, whole or already sliced) with every
    pipe-placed entry cut to this rank's slice; unchanged for a model
    without pipe placements."""
    placements, size, index, _ = _pipe_of(model)
    if not placements:
        return state
    local = dict(model.named_parameters())
    out = dict(state)
    for name, dim in placements.items():
        if name in out:
            out[name] = _slice(out[name], dim, size, index,
                               local[name].shape[dim])
    return out


def gather_pipe(model, state: dict) -> dict:
    """``state`` with every pipe-placed entry gathered whole over the pipe
    group (collective: every rank of the row calls it, in the same
    order)."""
    placements, size, _, group = _pipe_of(model)
    if not placements:
        return state
    out = dict(state)
    for name in sorted(placements):
        if name in out:
            out[name] = _gather(out[name], placements[name], size, group)
    return out


def _optimizer_params(model, optimizer):
    """``[(name, param)]`` in the optimizer state dict's index order."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [(names.get(id(p)), p) for g in optimizer.param_groups
            for p in g["params"]]


def gather_optimizer_state(model, optimizer) -> dict:
    """``optimizer.state_dict()`` with each pipe-placed parameter's state
    tensors of its shape gathered whole (collective)."""
    state = optimizer.state_dict()
    placements, size, _, group = _pipe_of(model)
    if not placements:
        return state
    per = dict(state["state"])
    for idx, (name, p) in enumerate(_optimizer_params(model, optimizer)):
        if name not in placements or idx not in per:
            continue
        entry = dict(per[idx])
        for key in sorted(entry):
            v = entry[key]
            if torch.is_tensor(v) and v.shape == p.shape:
                entry[key] = _gather(v, placements[name], size, group)
        per[idx] = entry
    return {**state, "state": per}


def slice_optimizer_state(model, optimizer, state: dict) -> dict:
    """An optimizer state dict (whole or sliced) cut to this rank's pipe
    slices, ready for ``optimizer.load_state_dict``."""
    placements, size, index, _ = _pipe_of(model)
    if not placements:
        return state
    per = dict(state["state"])
    for idx, (name, p) in enumerate(_optimizer_params(model, optimizer)):
        if name not in placements or idx not in per:
            continue
        dim = placements[name]
        whole = tuple(s * (size if d == dim else 1)
                      for d, s in enumerate(p.shape))
        per[idx] = {k: (_slice(v, dim, size, index, p.shape[dim])
                        if torch.is_tensor(v) and tuple(v.shape) == whole
                        else v) for k, v in per[idx].items()}
    return {**state, "state": per}


class PipeReduce:
    """Global reductions of a pipe row's per-parameter tensors: a stage
    parameter's part (its slice) is summed over the pipe group, a
    replicated parameter's (the same on every rank) is counted once, at
    pipe index 0. ``module``: the bare model with ``pipe_placements``."""

    def __init__(self, module, mesh):
        placed = getattr(module, "pipe_placements", {}) or {}
        self.group = mesh.group("pipe")
        self.first = mesh.axis_index("pipe") == 0
        self._stage = {id(p) for n, p in module.named_parameters()
                       if n in placed}

    def is_stage(self, p) -> bool:
        return id(p) in self._stage

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the pipe group, in place; returns it."""
        tdist.all_reduce(t, group=self.group)
        return t

    def counted(self, params: Sequence[torch.Tensor]) -> list:
        """The tensors this rank contributes to a row-wide count: its
        stage slices, and the replicated ones at pipe index 0."""
        return [p for p in params if self.first or self.is_stage(p)]

    def norm(self, tensors: Sequence[torch.Tensor], params) -> torch.Tensor:
        """The global 2-norm of ``tensors`` (aligned with ``params``) over
        the row."""
        parts = [t for t, p in zip(tensors, params)
                 if self.first or self.is_stage(p)]
        if parts:
            sq = torch.stack(torch._foreach_norm(parts)).float().square()
            sq = sq.sum()
        else:
            sq = torch.zeros((), device=tensors[0].device)
        return self.sum(sq).sqrt()

    def group_weights(self, groups: Dict[str, list], device) -> torch.Tensor:
        """1 for a health group of stage parameters, else 1 at pipe index
        0 and 0 elsewhere (sorted group order)."""
        return torch.tensor(
            [1.0 if self.first or all(self.is_stage(p) for p in groups[n])
             else 0.0 for n in sorted(groups)], device=device)
