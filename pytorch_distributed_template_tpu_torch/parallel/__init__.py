"""Data and sequence parallelism over ``torch.distributed``: the process
group and its host-side collectives (``dist``), the config's ``{data,
seq}`` mesh over the ranks (``mesh``), and the differentiable collectives
of the sequence-parallel attention (``collectives``)."""
from . import dist
from .mesh import build_mesh, mesh_from_config, resolve_axis_sizes

__all__ = ["dist", "build_mesh", "mesh_from_config", "resolve_axis_sizes"]
