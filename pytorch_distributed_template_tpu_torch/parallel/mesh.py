"""The config's ``mesh`` block over ``torch.distributed`` ranks: the port of
the JAX package's ``parallel/mesh.py`` (``resolve_axis_sizes``,
``build_mesh``, ``mesh_from_config``).

The port runs JAX's six axes: ``pipe`` (pipeline parallelism:
parallel/pipeline.py, the pipelined models), ``data`` (data parallelism),
``fsdp`` (ZeRO-3: the batch and the parameters sharded, parallel/fsdp.py),
``seq`` (sequence parallelism: ring and Ulysses attention,
ops/attention.py), ``expert`` (expert parallelism: the MoE blocks' stacked
experts sharded, models/moe.py; the batch is not sharded over it) and
``tensor`` (Megatron tensor parallelism in the LM families). Ranks are laid
out as JAX's ``build_mesh`` reshapes its devices in ``MESH_AXES`` order,
pipe outermost and tensor innermost: ``rank = ((((pipe * D + data) * F +
fsdp) * S + seq) * X + expert) * T + tensor``.
:func:`build_mesh` makes one process group per row of each axis of size >
1 (the ranks that differ only in their index on it), and one per row of the
data x fsdp plane (the ranks sharing every model-parallel index: pipe, seq
and tensor), over which replicated gradients are averaged, on every rank in
the same order (``dist.new_group`` is collective). ``expert`` runs beside
``data`` only; beside ``pipe``, ``fsdp``, ``seq`` or ``tensor`` it refuses
by name (:data:`EXPERT_LATER`).

:func:`build_mesh` of :func:`mesh_from_config` is the config's mesh; the
entry points build it once and hand its batch shard
(:meth:`Mesh.data_shard`: over data and fsdp, JAX's ``DATA_AXES``) to the
loaders, so every rank of a seq row, an expert row, a tensor row and a
pipe row reads the same batch, as JAX's ``batch_spec`` shards the batch
over the data axes only. :attr:`Mesh.axis_names` keeps the axes the config
named, size 1 included, as the JAX mesh does (partition rules prune
against them).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np

from . import dist

MESH_AXES = ("pipe", "data", "fsdp", "seq", "expert", "tensor")
#: the axes the port runs, in rank order (outer first): all of JAX's
PORTED_AXES = MESH_AXES
#: what an expert axis beside another model-parallel axis waits for
EXPERT_LATER = ("ROADMAP A11d's remainder (the expert axis beside pipe, "
                "fsdp, seq or tensor), a later slice")
#: the axes that shard the batch (JAX's ``DATA_AXES``)
DATA_AXES = ("data", "fsdp")
#: the group key of the data x fsdp plane (:meth:`Mesh.group`)
BATCH = "batch"


def resolve_axis_sizes(axes: Optional[Dict[str, int]],
                       n_devices: int) -> Dict[str, int]:
    """Normalize an axis-size request: fill one ``-1``, validate the
    product (a copy of the JAX function)."""
    if not axes:
        axes = {"data": -1}
    unknown = [a for a in axes if a not in MESH_AXES]
    if unknown:
        raise ValueError(f"Unknown mesh axes {unknown}; valid axes: "
                         f"{MESH_AXES}")
    sizes = {a: int(s) for a, s in axes.items()}
    wild = [a for a, s in sizes.items() if s == -1]
    if len(wild) > 1:
        raise ValueError("At most one mesh axis may be -1")
    fixed = int(np.prod([s for s in sizes.values() if s != -1])) \
        if sizes else 1
    if wild:
        if n_devices % fixed != 0:
            raise ValueError(f"{n_devices} devices not divisible by fixed "
                             f"axes product {fixed}")
        sizes[wild[0]] = n_devices // fixed
    total = int(np.prod(list(sizes.values())))
    if total != n_devices:
        raise ValueError(f"Mesh axes {sizes} multiply to {total} but "
                         f"{n_devices} devices are available")
    return sizes


def mesh_from_config(config, world_size: Optional[int] = None
                     ) -> Dict[str, int]:
    """The axis sizes of the config's ``mesh`` block (default ``{"data":
    -1}``) over ``world_size`` ranks (default: the process group's), in
    ``MESH_AXES`` order; ``fsdp`` or ``tensor`` beside ``pipe`` or
    ``seq``, and ``expert`` beside any axis but ``data``, raise
    NotImplementedError naming the ROADMAP item."""
    block = config.get("mesh") or {}
    axes = dict(block.get("axes") or {"data": -1})
    _refuse_expert_beside({a: int(v) for a, v in axes.items()})
    n = dist.process_count() if world_size is None else int(world_size)
    sizes = resolve_axis_sizes(axes, n)
    split = [a for a in ("fsdp", "tensor") if sizes.get(a, 1) > 1]
    other = [a for a in ("pipe", "seq") if sizes.get(a, 1) > 1]
    if split and other:
        raise NotImplementedError(
            f"mesh axes {split} together with {other} are ROADMAP A11b's "
            "remainder (tensor and fsdp composed with pipe or seq), a later "
            "slice")
    _refuse_expert_beside(sizes)
    return {a: sizes[a] for a in MESH_AXES if a in sizes}


def _refuse_expert_beside(sizes: Dict[str, int]) -> None:
    """NotImplementedError for an expert axis > 1 beside another
    model-parallel axis > 1 (:data:`EXPERT_LATER`)."""
    beside = [a for a in ("pipe", "fsdp", "seq", "tensor")
              if sizes.get(a, 1) > 1]
    if sizes.get("expert", 1) > 1 and beside:
        raise NotImplementedError(
            f"mesh axis 'expert' together with {beside} is {EXPERT_LATER}")


class AxisGroup(NamedTuple):
    """One axis of this rank: its process group, size and index."""
    group: object
    size: int
    index: int


class Mesh:
    """The ``{pipe, data, fsdp, seq, expert, tensor}`` mesh of one rank: the
    axis sizes, this rank's index on each axis and the process group of
    each axis it belongs to (None for an axis of size 1, or without a process
    group). ``names``: the axes the config named (default: those of
    ``sizes``)."""

    def __init__(self, sizes: Dict[str, int], rank: int = 0,
                 groups: Optional[dict] = None, names=None):
        self.sizes = {a: int(sizes.get(a, 1)) for a in PORTED_AXES}
        self.rank = int(rank)
        self._groups = dict(groups or {})
        named = set(sizes if names is None else names)
        self._names = tuple(a for a in PORTED_AXES
                            if a in named or self.sizes[a] > 1)

    def axis_size(self, name: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have."""
        return self.sizes.get(name, 1)

    @property
    def axis_names(self) -> tuple:
        """The axes of the mesh in rank order: those the config named, size
        1 included, as JAX's mesh keeps them (what a partition rule's axis
        must name to stay in its spec: parallel/sharding.py)."""
        return self._names

    def axis_index(self, name: str) -> int:
        """This rank's index on the axis (``rank = ((((pipe * D + data) *
        F + fsdp) * S + seq) * X + expert) * T + tensor``)."""
        return _index(self.sizes, self.rank, name)

    def data_shard(self) -> tuple:
        """``(index, count)`` of this rank's batch shard, as the loaders
        take it: ``(data * F + fsdp, D * F)``; every rank of a seq row, an
        expert row, a tensor row and a pipe row reads the same shard."""
        f = self.axis_size("fsdp")
        return (self.axis_index("data") * f + self.axis_index("fsdp"),
                self.axis_size("data") * f)

    def group(self, name: str):
        """The process group of this rank's ``name`` axis, or of its data x
        fsdp plane for :data:`BATCH`, or None (size 1)."""
        return self._groups.get(name)

    def axis(self, name: str) -> Optional[AxisGroup]:
        """This rank's :class:`AxisGroup` of ``name``, or None (size 1)."""
        size = self.axis_size(name)
        if size == 1:
            return None
        return AxisGroup(self.group(name), size, self.axis_index(name))

    def batch(self) -> Optional[AxisGroup]:
        """The data x fsdp plane of this rank (the ranks that hold other
        rows of the batch) as an :class:`AxisGroup` whose index is this
        rank's shard (:meth:`data_shard`), or None (size 1)."""
        index, count = self.data_shard()
        if count == 1:
            return None
        return AxisGroup(self.group(BATCH), count, index)

    def model_parallel(self) -> bool:
        """Whether a parameter may be split over the ranks: a pipe, fsdp,
        expert or tensor axis > 1."""
        return any(self.sizes[a] > 1
                   for a in ("pipe", "fsdp", "expert", "tensor"))


def _index(sizes: Dict[str, int], rank: int, axis: str) -> int:
    """``rank``'s index on ``axis`` (0 for an axis the mesh lacks)."""
    if axis not in PORTED_AXES:
        return 0
    inner = int(np.prod([sizes[a] for a in PORTED_AXES[
        PORTED_AXES.index(axis) + 1:]]))
    return (rank // inner) % sizes[axis]


def _axis_ranks(sizes: Dict[str, int], axes):
    """Every group of ``axes`` (an axis name or a tuple of them): the
    global ranks that differ only in their indices on them, groups in rank
    order."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    n = int(np.prod([sizes[a] for a in PORTED_AXES]))
    groups: dict = {}
    for rank in range(n):
        key = tuple(_index(sizes, rank, a) for a in PORTED_AXES
                    if a not in axes)
        groups.setdefault(key, []).append(rank)
    return list(groups.values())


def build_mesh(sizes: Dict[str, int]) -> Mesh:
    """This rank's :class:`Mesh` over the process group (collective: every
    rank creates every axis group, in the same order)."""
    names = tuple(sizes)
    sizes = {a: int(sizes.get(a, 1)) for a in PORTED_AXES}
    n = dist.process_count()
    if int(np.prod(list(sizes.values()))) != n:
        raise ValueError(f"mesh {sizes} does not cover the {n} process(es)")
    rank = dist.process_index()
    groups = {}
    if dist.in_group():
        import torch.distributed as tdist

        plan = [(a, a) for a in PORTED_AXES if sizes[a] > 1]
        if sizes["data"] > 1 and sizes["fsdp"] > 1:
            plan.append((BATCH, DATA_AXES))
        for key, axes in plan:
            for ranks in _axis_ranks(sizes, axes):
                group = tdist.new_group(ranks=ranks)
                if rank in ranks:
                    groups[key] = group
        if BATCH not in groups:
            # one of the two is 1: the plane is the other axis's row
            groups[BATCH] = groups.get("data", groups.get("fsdp"))
    return Mesh(sizes, rank, groups, names)

