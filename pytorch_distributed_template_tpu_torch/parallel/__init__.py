"""Data parallelism over ``torch.distributed`` (DDP): the process group and
its host-side collectives (``dist``), and the config's mesh over the ranks
(``mesh``)."""
from . import dist
from .mesh import mesh_from_config, resolve_axis_sizes

__all__ = ["dist", "mesh_from_config", "resolve_axis_sizes"]
