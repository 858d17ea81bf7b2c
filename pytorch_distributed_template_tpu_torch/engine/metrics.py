"""LM metrics: the port of the JAX package's
``engine/metrics.py::lm_token_accuracy``.

Metrics are per-example functions ``(output, target) -> [B]`` computed
without gradients; the steps reduce them with the padding mask as
sufficient statistics (engine/steps.py).
"""
from __future__ import annotations

import torch

from ..config.registry import METRICS
from .losses import chunk_shifted_sequence


@METRICS.register("lm_token_accuracy")
@torch.no_grad()
def lm_token_accuracy(output, target):
    """Next-token accuracy: output ``[B, T, V]`` logits, or the
    ``fused_head`` model's ``(hidden [B, T, D], head_w [D, V])``, whose
    argmax is taken per 256-token chunk so the full logits never exist."""
    if isinstance(output, tuple):
        h, w = output
        tm1 = h.shape[1] - 1
        # pad_label -1 never matches an argmax: padding rows count 0
        h_c, l_c, _ = chunk_shifted_sequence(
            h[:, :-1], target[:, 1:].long(), chunk=256, pad_label=-1)
        hits = torch.zeros(h.shape[0], dtype=torch.float32,
                           device=h.device)
        for i in range(h_c.shape[0]):
            pred = (h_c[i] @ w).float().argmax(-1)
            hits += (pred == l_c[i]).float().sum(-1)
        return hits / tm1
    pred = output[:, :-1].argmax(-1)
    return (pred == target[:, 1:].long()).float().mean(-1)
