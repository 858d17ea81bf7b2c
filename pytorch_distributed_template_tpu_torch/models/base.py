"""Model description helpers: the port of the JAX package's
``models/base.py`` (``param_count``, ``inject_mesh``, ``describe``), the
reference's ``BaseModel`` summary, over a module's parameters."""
from __future__ import annotations

from torch import nn


def param_count(model: nn.Module) -> int:
    """Number of parameter elements (a DDP wrapper counts its module's)."""
    return sum(p.numel() for p in model.parameters())


def inject_mesh(model: nn.Module, mesh) -> nn.Module:
    """Give a mesh-aware model (a ``mesh`` attribute that is None: the LM
    families, whose forward hands it to their SP attention or their
    tensor-parallel layers, and the pipelined families) the runtime mesh;
    then keep only this rank's slice of every parameter placed on the
    ``pipe``, ``fsdp`` or ``tensor`` axis, whatever the model
    (``parallel.sharding.shard_params``): inject before the optimizer is
    built, so that its state is per slice too. Returns the model."""
    if getattr(model, "mesh", "absent") is None:
        model.mesh = mesh
    from ..parallel.sharding import shard_params

    shard_params(model, mesh)
    return model


def describe(model: nn.Module) -> str:
    """The reference's model summary: class name and parameter count."""
    model = getattr(model, "module", model)
    return (f"{type(model).__name__}\n"
            f"Trainable parameters: {param_count(model)}")
