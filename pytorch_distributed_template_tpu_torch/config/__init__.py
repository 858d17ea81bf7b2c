"""Config layer: the JSON config parser and the component registries."""
from .parser import ConfigParser
from .registry import (
    LOADERS, LOSSES, METRICS, MODELS, OPTIMIZERS, SCHEDULERS, Registry,
    resolve,
)

__all__ = ["ConfigParser", "LOADERS", "LOSSES", "METRICS", "MODELS",
           "OPTIMIZERS", "SCHEDULERS", "Registry", "resolve"]
