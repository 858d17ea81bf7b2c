"""The ``trainer.debug`` block: the port of the JAX package's
``utils/debug.py::configure_debug``.

- ``nan_check``: ``torch.autograd.set_detect_anomaly(True)`` (the backward
  names the function that made a NaN), and the train step raises
  ``FloatingPointError`` at the first step whose loss or gradients are not
  finite (engine/steps.py), where ``jax_debug_nans`` stops the JAX step.
- ``disable_jit``: accepted and logged; eager PyTorch runs op by op
  already, so it changes nothing.

Process-global and slow; for the debug configs, never production runs.
"""
from __future__ import annotations

import logging

import torch

logger = logging.getLogger(__name__)


def configure_debug(debug_cfg) -> bool:
    """Apply ``trainer.debug`` (``{"nan_check": bool, "disable_jit":
    bool}``; absent or empty: nothing). Returns ``nan_check``."""
    if not debug_cfg:
        return False
    nan_check = bool(debug_cfg.get("nan_check"))
    if nan_check:
        torch.autograd.set_detect_anomaly(True)
        logger.warning("debug: nan_check on (autograd anomaly mode, and "
                       "the step stops at the first non-finite loss or "
                       "gradient; slow)")
    if debug_cfg.get("disable_jit"):
        logger.warning("debug: disable_jit has no meaning in eager PyTorch "
                       "(every op already runs eagerly); ignored")
    return nan_check
