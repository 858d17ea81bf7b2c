"""Placement of parameters over the mesh: the port of the JAX package's
``parallel/sharding.py`` (``path_str``, ``apply_rules``, ``_prune_spec``,
``_largest_divisible_axis``) as placement math over a state dict's names,
and what the trainer does with a placement on ``pipe``, ``fsdp``,
``expert`` or ``tensor``.

A model's ``partition_rules()`` are ordered ``(regex, P)`` pairs, matched
with ``re.search`` against each parameter's path (``a/b/c``,
:func:`path_str` of the state-dict name), each spec written over the torch
tensor's dimensions (an ``nn.Linear`` weight is ``[out, in]``, flax's
kernel ``[in, out]``). :class:`P` is a tuple of axis names (or None) per
dimension, JAX's ``PartitionSpec``. :func:`apply_rules` maps every leaf to
the spec of its first matching rule, with the axes the mesh lacks dropped;
an unmatched leaf, or one whose spec pruned to nothing, replicates, except
on an ``fsdp`` axis, where JAX's ZeRO-3 fallback shards it on its largest
divisible dimension, computed on the flax shape (``models/convert.py``'s
layout) so that it picks the dimension JAX picks, ties included. A rule
written with no axes (``P()``) pins its leaf replicated on purpose; a
matched spec keeps its axes even where another axis could shard the leaf
(on ``{"fsdp": 2, "tensor": 2}`` a Megatron kernel is split on ``tensor``
and replicated over ``fsdp``), as JAX's ``apply_rules`` returns it.

:func:`shard_params` keeps this rank's slice of every placed leaf (the
slice ``shard_map`` would hand the rank) and records ``model.placements``:
``{name: Placement(axis, dim, view, vdim)}``, at most one axis per leaf.
``view`` is the whole tensor seen in another shape, split on its ``vdim``:
GPT-2's fused ``qkv`` on ``tensor`` is split on the head dimension of its
``[3, H, hd, ...]`` view, so that each rank holds the q, k and v of its
head group (JAX splits the columns contiguously and lets XLA reconcile
the layouts). Every rank builds the whole model from the seed first, so
the slices are the one-process weights. A tensor axis makes the model
compute on its shards (its ``use_tensor_axis``, refused for a model
without Megatron layers), an fsdp axis gathers them in units
(parallel/fsdp.py), an expert axis leaves each rank ``E / X`` of every MoE
block's stacked experts (``MoeMlp.partition_rules``), on which its blocks
compute (models/moe.py). A sharded model keeps the one-process state dict on
disk: :func:`gather_placed` / :func:`gather_optimizer_state` rebuild the
whole tensors (collective; one tensor at a time, into host memory on the
rank that writes), and :func:`slice_placed` /
:func:`slice_optimizer_state` cut whole tensors back to this rank's slice
on load, whatever mesh wrote them. :class:`MeshReduce` gives the train
step the global norms and counts: a placed leaf's part is summed over its
axis, a replicated one counted once.
"""
from __future__ import annotations

import re
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

from .mesh import PORTED_AXES

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


def flax_order(name: str, ndim: int) -> tuple:
    """The torch dimension of each flax dimension of parameter ``name``
    (models/convert.py's layout): ``(1, 0)`` for a dense kernel, ``(2, 3,
    1, 0)`` for a conv kernel (``OIHW`` <- ``HWIO``), else the identity."""
    from ..models.convert import flax_path

    try:
        kernel = flax_path(name).endswith("/kernel")
    except KeyError:
        kernel = False
    if kernel and ndim == 2:
        return (1, 0)
    if kernel and ndim == 4:
        return (2, 3, 1, 0)
    return tuple(range(ndim))


def apply_rules(shapes: Dict[str, tuple], mesh,
                rules: Sequence[Tuple[str, P]] = ()) -> Dict[str, P]:
    """``{name: torch shape}`` -> ``{name: P}`` over the torch dimensions:
    each leaf's spec from the first rule whose regex searches its
    :func:`path_str` (see the module docstring); ``P()`` is replicated."""
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
            order = flax_order(name, len(shape))
            ax = _largest_divisible_axis([shape[d] for d in order],
                                         mesh.axis_size("fsdp"))
            if ax is not None:
                spec = [None] * len(shape)
                spec[order[ax]] = "fsdp"
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


class Placement(NamedTuple):
    """Where a leaf is split: ``axis``, the torch ``dim`` of the whole
    tensor that it divides, and the ``view`` shape the split is taken in
    (None: the tensor's own) with the split dimension ``vdim`` of it."""
    axis: str
    dim: int
    view: Optional[tuple] = None
    vdim: Optional[int] = None

    def shape_view(self, shape) -> Tuple[tuple, int]:
        """``(view, vdim)`` of a whole tensor of ``shape``."""
        if self.view is None:
            return tuple(shape), self.dim
        return tuple(self.view), self.vdim


_LORA = ("ROADMAP A11b's remainder (LoRA on a tensor or fsdp axis), a "
         "later slice")
_NO_TP = ("has no tensor-parallel layers: ROADMAP A11b's remainder (the "
          "ViT and BERT rules, and the models without Megatron layers), a "
          "later slice")


def plan_placements(model, mesh) -> Dict[str, Placement]:
    """``{name: Placement}`` of every parameter the model's rules (or the
    fsdp fallback) put on an axis of size > 1 of ``mesh``; refuses a
    placed dimension its axis does not divide, naming the leaf."""
    rules = model.partition_rules() if hasattr(model, "partition_rules") \
        else []
    params = dict(model.named_parameters())
    specs = apply_rules({n: tuple(p.shape) for n, p in params.items()},
                        mesh, rules)
    views = getattr(model, "split_view", None)
    out: Dict[str, Placement] = {}
    for name, spec in specs.items():
        for axis in PORTED_AXES:
            dim = placement(spec, axis)
            if dim is None or mesh.axis_size(axis) == 1:
                continue
            shape = tuple(params[name].shape)
            pl = Placement(axis, dim)
            if axis == "tensor" and views is not None:
                v = views(name, shape)
                if v is not None:
                    pl = Placement(axis, dim, tuple(v[0]), int(v[1]))
            view, vdim = pl.shape_view(shape)
            if view[vdim] % mesh.axis_size(axis):
                raise ValueError(
                    f"{name} {shape}: dim {dim} does not split over a "
                    f"{axis} axis of {mesh.axis_size(axis)}")
            out[name] = pl
            break
    return out


def shard_params(model, mesh) -> Dict[str, Placement]:
    """Keep this rank's slice of every parameter placed on an axis of
    ``mesh`` (see the module docstring); returns and records
    ``model.placements`` (and ``model.placed_mesh``; a second call returns
    them). A tensor axis calls the model's ``use_tensor_axis(mesh)`` first
    (NotImplementedError without one), an fsdp axis installs the gather
    units (parallel/fsdp.py). A no-op (no placements) on a mesh without a
    pipe, fsdp, expert or tensor axis > 1."""
    if getattr(model, "placed_mesh", None) is not None:
        return model.placements      # sliced already
    model.placed_mesh = mesh
    if mesh is None or not mesh.model_parallel():
        model.placements = {}
        return model.placements
    split = [a for a in ("fsdp", "tensor") if mesh.axis_size(a) > 1]
    if split and any(n.rsplit(".", 1)[-1].startswith("lora_")
                     for n, _ in model.named_parameters()):
        raise NotImplementedError(f"LoRA adapters on {split}: {_LORA}")
    if mesh.axis_size("tensor") > 1:
        use = getattr(model, "use_tensor_axis", None)
        if use is None:
            raise NotImplementedError(
                f"a tensor axis of {mesh.axis_size('tensor')}: "
                f"{type(model).__name__} {_NO_TP}")
        use(mesh)
    placements = plan_placements(model, mesh)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, pl in placements.items():
            p = params[name]
            p.data = _cut(p.data, pl, mesh.axis_size(pl.axis),
                          mesh.axis_index(pl.axis)).clone()
    model.placements = placements
    if mesh.axis_size("fsdp") > 1:
        from .fsdp import install_units

        install_units(model, mesh, placements)
    return placements


def placed_on(model, axis: str) -> Dict[str, Placement]:
    """The model's placements on ``axis``."""
    return {n: pl for n, pl in (getattr(model, "placements", None)
                                or {}).items() if pl.axis == axis}


def _local_shape(shape, pl: Placement, size: int) -> tuple:
    shape = list(shape)
    shape[pl.dim] //= size
    return tuple(shape)


def _cut(t: torch.Tensor, pl: Placement, size: int,
         index: int) -> torch.Tensor:
    """The slice ``index`` of ``size`` of whole tensor ``t``."""
    view, vdim = pl.shape_view(t.shape)
    n = view[vdim] // size
    part = t.reshape(view).narrow(vdim, index * n, n)
    return part.reshape(_local_shape(t.shape, pl, size))


def join(stacked: torch.Tensor, pl: Placement, shape) -> torch.Tensor:
    """The whole tensor of ``shape`` from the ``size`` slices stacked along
    a new dim 0 (rank order): the inverse of :func:`_cut`."""
    size = stacked.shape[0]
    view, vdim = pl.shape_view(shape)
    local = list(view)
    local[vdim] //= size
    return stacked.reshape([size] + local).movedim(0, vdim).reshape(shape)


def _mesh_of(model):
    return model.placed_mesh


def _whole_shape(local_shape, pl: Placement, size: int) -> tuple:
    shape = list(local_shape)
    shape[pl.dim] *= size
    return tuple(shape)


def _gather_whole(t: torch.Tensor, pl: Placement, mesh,
                  keep: bool) -> Optional[torch.Tensor]:
    """One placed tensor gathered whole over its axis's group (collective);
    in host memory where ``keep``, else None."""
    size = mesh.axis_size(pl.axis)
    t = t.detach().contiguous()
    out = torch.empty((size * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    tdist.all_gather_into_tensor(out, t, group=mesh.group(pl.axis))
    if not keep:
        return None
    whole = join(out.view((size,) + tuple(t.shape)), pl,
                 _whole_shape(t.shape, pl, size))
    return whole.to("cpu")


def _slice_if_whole(t, pl: Placement, mesh, local_shape):
    """``t``'s slice when it is whole; else ``t`` (already the slice, or
    another shape the caller refuses)."""
    size = mesh.axis_size(pl.axis)
    if not torch.is_tensor(t) or tuple(t.shape) != _whole_shape(
            local_shape, pl, size):
        return t
    return _cut(t, pl, size, mesh.axis_index(pl.axis))


def slice_placed(model, state: dict) -> dict:
    """``state`` (``{name: tensor}``, whole or already sliced) with every
    placed entry cut to this rank's slice; unchanged for a model without
    placements."""
    placements = getattr(model, "placements", None) or {}
    if not placements:
        return state
    mesh = _mesh_of(model)
    local = dict(model.named_parameters())
    out = dict(state)
    for name, pl in placements.items():
        if name in out:
            out[name] = _slice_if_whole(out[name], pl, mesh,
                                        local[name].shape)
    return out


def gather_placed(model, state: dict, keep: bool = True) -> dict:
    """``state`` with every placed entry gathered whole over its axis,
    one tensor at a time into host memory (collective: every rank calls
    it, in the same order); ``keep`` False (a rank that does not write)
    leaves the placed entries out."""
    placements = getattr(model, "placements", None) or {}
    if not placements:
        return state
    mesh = _mesh_of(model)
    out = dict(state)
    for name in sorted(placements):
        if name in out:
            whole = _gather_whole(out[name], placements[name], mesh, keep)
            if keep:
                out[name] = whole
            else:
                del out[name]
    return out


def _optimizer_params(model, optimizer):
    """``[(name, param)]`` in the optimizer state dict's index order."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [(names.get(id(p)), p) for g in optimizer.param_groups
            for p in g["params"]]


def gather_optimizer_state(model, optimizer, keep: bool = True) -> dict:
    """``optimizer.state_dict()`` with each placed parameter's state
    tensors of its shape gathered whole, one at a time (collective);
    ``keep`` as in :func:`gather_placed` (the entries are dropped)."""
    state = optimizer.state_dict()
    placements = getattr(model, "placements", None) or {}
    if not placements:
        return state
    mesh = _mesh_of(model)
    per = dict(state["state"])
    for idx, (name, p) in enumerate(_optimizer_params(model, optimizer)):
        if name not in placements or idx not in per:
            continue
        entry = dict(per[idx])
        for key in sorted(entry):
            v = entry[key]
            if torch.is_tensor(v) and v.shape == p.shape:
                whole = _gather_whole(v, placements[name], mesh, keep)
                if keep:
                    entry[key] = whole
                else:
                    del entry[key]
        per[idx] = entry
    return {**state, "state": per}


def slice_optimizer_state(model, optimizer, state: dict) -> dict:
    """An optimizer state dict (whole or sliced) cut to this rank's
    slices, ready for ``optimizer.load_state_dict``."""
    placements = getattr(model, "placements", None) or {}
    if not placements:
        return state
    mesh = _mesh_of(model)
    per = dict(state["state"])
    for idx, (name, p) in enumerate(_optimizer_params(model, optimizer)):
        if name not in placements or idx not in per:
            continue
        per[idx] = {k: _slice_if_whole(v, placements[name], mesh, p.shape)
                    for k, v in per[idx].items()}
    return {**state, "state": per}


class MeshReduce:
    """Global reductions of per-parameter tensors over the mesh (every
    rank's ``module.placements``): a placed parameter's part (its slice) is
    summed over the ranks that hold its other slices, a replicated one is
    counted once. After the step's gradient sync the ranks that differ
    only on axes a parameter is not split on hold the same values, so a
    rank counts a parameter where its index on every other axis is 0, and
    one ``all_reduce`` over the world sums the counted parts.
    ``module``: the bare model."""

    def __init__(self, module, mesh):
        placed = getattr(module, "placements", {}) or {}
        index = {a: mesh.axis_index(a) for a in PORTED_AXES}

        def owns(axis):
            return all(i == 0 for a, i in index.items() if a != axis)

        self._axis = {id(p): placed[n].axis
                      for n, p in module.named_parameters() if n in placed}
        self._owned = {id(p) for n, p in module.named_parameters()
                       if owns(placed[n].axis if n in placed else None)}

    def axis(self, p) -> Optional[str]:
        """The axis ``p`` is split on, or None (replicated)."""
        return self._axis.get(id(p))

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the world, in place; returns it."""
        tdist.all_reduce(t)
        return t

    def counted(self, params: Sequence[torch.Tensor]) -> list:
        """The tensors this rank contributes to a mesh-wide count."""
        return [p for p in params if id(p) in self._owned]

    def norm(self, tensors: Sequence[torch.Tensor], params) -> torch.Tensor:
        """The global 2-norm of ``tensors`` (aligned with ``params``)."""
        parts = [t for t, p in zip(tensors, params) if id(p) in self._owned]
        if parts:
            sq = torch.stack(torch._foreach_norm(parts)).float().square()
            sq = sq.sum()
        else:
            sq = torch.zeros((), device=tensors[0].device)
        return self.sum(sq).sqrt()
