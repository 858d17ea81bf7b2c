"""Model description helpers: the port of the JAX package's
``models/base.py`` (``param_count``, ``describe``), the reference's
``BaseModel`` summary, over a module's parameters."""
from __future__ import annotations

from torch import nn


def param_count(model: nn.Module) -> int:
    """Number of parameter elements (a DDP wrapper counts its module's)."""
    return sum(p.numel() for p in model.parameters())


def describe(model: nn.Module) -> str:
    """The reference's model summary: class name and parameter count."""
    model = getattr(model, "module", model)
    return (f"{type(model).__name__}\n"
            f"Trainable parameters: {param_count(model)}")
