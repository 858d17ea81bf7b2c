"""The config's ``mesh`` block over ``torch.distributed`` ranks: the port of
the JAX package's ``parallel/mesh.py::resolve_axis_sizes`` and
``mesh_from_config``.

The port runs data parallelism only: ``{"data": -1}`` and ``{"data":
world_size}`` resolve to the data axis over the ranks (DDP). Every other
axis refuses by name until ROADMAP A11 (parallel axes) ports it.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from . import dist

MESH_AXES = ("pipe", "data", "fsdp", "seq", "expert", "tensor")
LATER_AXES = "ROADMAP A11 (parallel axes beyond data, a later slice)"


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
    """``{"data": world_size}`` from the config's ``mesh`` block (default
    ``{"data": -1}``); any axis but ``data`` raises NotImplementedError
    naming its slice."""
    block = config.get("mesh") or {}
    axes = dict(block.get("axes") or {"data": -1})
    others = sorted(a for a in axes if a != "data")
    if others:
        raise NotImplementedError(f"mesh axes {others} are {LATER_AXES}")
    n = dist.process_count() if world_size is None else int(world_size)
    return resolve_axis_sizes(axes, n)
