"""The config's ``mesh`` block over ``torch.distributed`` ranks: the port of
the JAX package's ``parallel/mesh.py`` (``resolve_axis_sizes``,
``build_mesh``, ``mesh_from_config``).

The port runs three axes: ``pipe`` (pipeline parallelism:
parallel/pipeline.py, the pipelined models), ``data`` (DDP over the
ranks) and ``seq`` (sequence parallelism: ring and Ulysses attention,
ops/attention.py). Ranks are laid out as JAX's ``build_mesh`` reshapes its
devices in ``MESH_AXES`` order, pipe outermost and seq innermost: ``rank =
(pipe_index * D + data_index) * S + seq_index``. :func:`build_mesh` makes
one process group per row of each axis of size > 1 (the ranks that differ
only in their index on it), on every rank in the same order
(``dist.new_group`` is collective). The other axes refuse by name until
their ROADMAP items port them (:data:`LATER_AXES`).

:func:`build_mesh` of :func:`mesh_from_config` is the config's mesh; the
entry points build it once and hand its data axis (:meth:`Mesh.data_shard`)
to the loaders, so every rank of a seq row and every stage of a pipe row
reads the same batch, as JAX's ``batch_spec`` shards the batch over the
data axes only.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from . import dist

MESH_AXES = ("pipe", "data", "fsdp", "seq", "expert", "tensor")
#: the axes the port runs, in rank order (outer first)
PORTED_AXES = ("pipe", "data", "seq")
#: the ROADMAP item that ports each other axis
LATER_AXES = {
    "tensor": "ROADMAP A11b (tensor parallelism and FSDP), a later slice",
    "fsdp": "ROADMAP A11b (tensor parallelism and FSDP), a later slice",
    "expert": "ROADMAP A11d (expert parallelism), a later slice",
}


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
    ``MESH_AXES`` order; an axis the port does not run raises
    NotImplementedError naming its ROADMAP item."""
    block = config.get("mesh") or {}
    axes = dict(block.get("axes") or {"data": -1})
    later = sorted(a for a in axes if a in LATER_AXES)
    if later:
        raise NotImplementedError("; ".join(
            f"mesh axis {a!r} is {LATER_AXES[a]}" for a in later))
    n = dist.process_count() if world_size is None else int(world_size)
    sizes = resolve_axis_sizes(axes, n)
    return {a: sizes[a] for a in MESH_AXES if a in sizes}


class Mesh:
    """The ``{pipe, data, seq}`` mesh of one rank: the axis sizes, this
    rank's index on each axis and the process group of each axis it belongs
    to (None for an axis of size 1, or without a process group)."""

    def __init__(self, sizes: Dict[str, int], rank: int = 0,
                 groups: Optional[dict] = None):
        self.sizes = {a: int(sizes.get(a, 1)) for a in PORTED_AXES}
        self.rank = int(rank)
        self._groups = dict(groups or {})

    def axis_size(self, name: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have."""
        return self.sizes.get(name, 1)

    @property
    def axis_names(self) -> tuple:
        """The axes of size > 1, in rank order (what a partition rule's
        axis must name to shard: parallel/sharding.py)."""
        return tuple(a for a in PORTED_AXES if self.sizes[a] > 1)

    def axis_index(self, name: str) -> int:
        """This rank's index on the axis (``rank = (pipe * D + data) * S +
        seq``)."""
        return _index(self.sizes, self.rank, name)

    def data_shard(self) -> tuple:
        """``(index, count)`` of this rank's data shard, as the loaders
        take it: every rank of a seq row and of a pipe row reads the same
        shard."""
        return self.axis_index("data"), self.axis_size("data")

    def group(self, name: str):
        """The process group of this rank's ``name`` axis, or None."""
        return self._groups.get(name)


def _index(sizes: Dict[str, int], rank: int, axis: str) -> int:
    """``rank``'s index on ``axis`` (0 for an axis the mesh lacks)."""
    if axis not in PORTED_AXES:
        return 0
    inner = int(np.prod([sizes[a] for a in PORTED_AXES[
        PORTED_AXES.index(axis) + 1:]]))
    return (rank // inner) % sizes[axis]


def _axis_ranks(sizes: Dict[str, int], axis: str):
    """Every group of ``axis``: the global ranks that differ only in their
    index on it, groups in rank order."""
    n = int(np.prod([sizes[a] for a in PORTED_AXES]))
    groups: dict = {}
    for rank in range(n):
        key = tuple(_index(sizes, rank, a) for a in PORTED_AXES if a != axis)
        groups.setdefault(key, []).append(rank)
    return list(groups.values())


def build_mesh(sizes: Dict[str, int]) -> Mesh:
    """This rank's :class:`Mesh` over the process group (collective: every
    rank creates every axis group, in the same order)."""
    sizes = {a: int(sizes.get(a, 1)) for a in PORTED_AXES}
    n = dist.process_count()
    if int(np.prod(list(sizes.values()))) != n:
        raise ValueError(f"mesh {sizes} does not cover the {n} process(es)")
    rank = dist.process_index()
    groups = {}
    if dist.in_group():
        import torch.distributed as tdist

        for axis in PORTED_AXES:
            if sizes[axis] == 1:
                continue
            for ranks in _axis_ranks(sizes, axis):
                group = tdist.new_group(ranks=ranks)
                if rank in ranks:
                    groups[axis] = group
    return Mesh(sizes, rank, groups)

