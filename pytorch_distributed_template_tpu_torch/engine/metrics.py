"""Metrics: the port of the JAX package's ``engine/metrics.py``
(``accuracy``, ``top_k_acc``, ``lm_token_accuracy``, ``lm_bits_per_byte``).

Metrics are per-example functions ``(output, target) -> [B]`` computed
without gradients; the steps reduce them with the padding mask as
sufficient statistics (engine/steps.py).
"""
from __future__ import annotations

import torch

from ..config.registry import METRICS
from .losses import (
    chunk_shifted_sequence, fused_lm_cross_entropy, lm_cross_entropy,
)

_LN2 = 0.6931471805599453


@METRICS.register("accuracy")
@torch.no_grad()
def accuracy(output, target):
    """1 where the argmax (the first, on a tie) is the label."""
    return (output.argmax(-1) == target.long()).float()


@METRICS.register("top_k_acc")
@torch.no_grad()
def top_k_acc(output, target, k: int = 3):
    """1 where the label is among the ``k`` largest outputs. Ties at the
    k-th place go to the lower index, as ``jax.lax.top_k`` orders them
    (``models.moe.top_k``; ``torch.topk`` does not fix that order)."""
    from ..models.moe import top_k

    _, idx = top_k(output, k)
    return (idx == target.long()[:, None]).any(-1).float()


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


@METRICS.register("lm_bits_per_byte")
@torch.no_grad()
def lm_bits_per_byte(output, target):
    """Per-example next-token cross entropy in bits (the byte-LM quality
    number when tokens are bytes, vocab 256: 8.0 is uniform). Plain
    ``[B, T, V]`` logits or the fused head's ``(hidden, head_w)``, through
    the loss implementations (fused: chunk 256), divided by ln 2."""
    if isinstance(output, tuple):
        return fused_lm_cross_entropy(chunk=256)(output, target) / _LN2
    return lm_cross_entropy(output, target) / _LN2
