"""Parallelism over ``torch.distributed``: the process group and its
host-side collectives (``dist``), the config's ``{pipe, data, fsdp, seq,
tensor}`` mesh over the ranks (``mesh``), the differentiable collectives
(``collectives``), parameter placement (``sharding``), the ZeRO-3 gather
units (``fsdp``), the pipeline schedule (``pipeline``), and tensor-parallel
serving: its geometry and placements (``tp``) and its rank processes
(``serving_ranks``)."""
from . import dist
from .mesh import build_mesh, mesh_from_config, resolve_axis_sizes

__all__ = ["dist", "build_mesh", "mesh_from_config", "resolve_axis_sizes"]
