"""Decorator-based component registries (the port's copy of the JAX
package's ``config/registry.py``, holding the registries the ported slices
fill).

A config block names a component (``"type"``) plus its kwargs (``"args"``)
and ``ConfigParser.init_obj`` builds it. Names resolve through explicit
registries rather than module ``getattr``: no arbitrary attribute lookup,
and ``REGISTRY.names()`` lists what a config may name. A plain module still
works anywhere a registry is accepted (``resolve`` falls back to
``getattr``), as in the template this framework follows.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    """A name -> callable mapping with a decorator-style ``register``."""

    def __init__(self, name: str):
        self._name = name
        self._entries: Dict[str, Callable] = {}

    @property
    def name(self) -> str:
        return self._name

    def register(self, name: Optional[str] = None):
        """``@R.register("Name")`` (or ``@R.register()`` for the callable's
        own name)."""

        def _do_register(obj: Callable) -> Callable:
            key = name if name is not None else obj.__name__
            if key in self._entries:
                raise KeyError(
                    f"'{key}' already registered in registry '{self._name}'")
            self._entries[key] = obj
            return obj

        return _do_register

    def get(self, key: str) -> Callable:
        if key not in self._entries:
            raise KeyError(
                f"'{key}' is not registered in registry '{self._name}'. "
                f"Available: {sorted(self._entries)}")
        return self._entries[key]

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def names(self):
        return sorted(self._entries)

    def __repr__(self) -> str:
        return f"Registry({self._name!r}, {self.names()})"


def resolve(namespace: Any, key: str) -> Callable:
    """Look up ``key`` in a Registry or fall back to ``getattr`` on a
    module."""
    if isinstance(namespace, Registry):
        return namespace.get(key)
    return getattr(namespace, key)


# The port's registries. Components self-register at import time from their
# defining modules (models/, data/datasets.py, engine/{losses,metrics,
# optim}.py).
MODELS = Registry("models")
LOADERS = Registry("loaders")
LOSSES = Registry("losses")
METRICS = Registry("metrics")
OPTIMIZERS = Registry("optimizers")
SCHEDULERS = Registry("schedulers")
