"""Config layer: the JSON config parser and the component registries."""
from .parser import ConfigParser, find_latest_checkpoint
from .registry import (
    LOADERS, LOSSES, METRICS, MODELS, OPTIMIZERS, SCHEDULERS, Registry,
    resolve,
)

__all__ = ["ConfigParser", "LOADERS", "LOSSES", "METRICS", "MODELS",
           "OPTIMIZERS", "SCHEDULERS", "Registry", "find_latest_checkpoint",
           "resolve"]
