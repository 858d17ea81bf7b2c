"""Config layer: the JSON config parser and the component registries."""
from .parser import ConfigParser
from .registry import MODELS, Registry, resolve

__all__ = ["ConfigParser", "MODELS", "Registry", "resolve"]
