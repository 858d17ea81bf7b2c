"""Metrics: the port of the JAX package's ``engine/metrics.py``
(``accuracy``, ``top_k_acc``, ``lm_token_accuracy``, ``lm_bits_per_byte``,
``lm_nll``, ``mlm_accuracy``).

Metrics are per-example functions ``(output, target) -> [B]`` computed
without gradients; the steps reduce them with the padding mask as
sufficient statistics (engine/steps.py). The LM metrics take a seq
shard's ``shard=`` as the LM losses do (engine/losses.py): the value is
the shard's part, the parts add up over the seq group.
"""
from __future__ import annotations

import torch

from ..config.registry import METRICS
from .losses import (
    chunk_shifted_sequence, fused_lm_cross_entropy, lm_cross_entropy,
    shard_labels,
)

_LN2 = 0.6931471805599453


@METRICS.register("accuracy")
@torch.no_grad()
def accuracy(output, target):
    """1 where the argmax (the first, on a tie) is the label."""
    return (output.argmax(-1) == target.long()).float()


@METRICS.register("mlm_accuracy")
@torch.no_grad()
def mlm_accuracy(output, target):
    """Per-example accuracy of the BERT MLM pair ``(logits, mask)`` at the
    masked positions against the original tokens, over ``max(mask.sum(),
    1)``."""
    logits, sel = output
    hit = (logits.argmax(-1) == target.long()).float()
    return (hit * sel).sum(-1) / sel.sum(-1).clamp_min(1.0)


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
def lm_token_accuracy(output, target, shard=None):
    """Next-token accuracy: output ``[B, T, V]`` logits, or the
    ``fused_head`` model's ``(hidden [B, T, D], head_w [D, V])``, whose
    argmax is taken per 256-token chunk so the full logits never exist.
    ``shard``: a seq shard's part (engine/losses.py)."""
    h = output[0] if isinstance(output, tuple) else output
    if shard is None:
        tm1 = h.shape[1] - 1
        h, labels = h[:, :-1], target[:, 1:].long()
    else:
        tm1 = shard.length - 1
        labels, valid = shard_labels(target, shard)
        # label -1 never matches an argmax: the row's last position
        labels = torch.where(valid > 0, labels, torch.full_like(labels, -1))
    if isinstance(output, tuple):
        w = output[1]
        # pad_label -1 never matches an argmax: padding rows count 0
        h_c, l_c, _ = chunk_shifted_sequence(h, labels, chunk=256,
                                             pad_label=-1)
        hits = torch.zeros(h.shape[0], dtype=torch.float32,
                           device=h.device)
        for i in range(h_c.shape[0]):
            pred = (h_c[i] @ w).float().argmax(-1)
            hits += (pred == l_c[i]).float().sum(-1)
        return hits / tm1
    return (h.argmax(-1) == labels).float().sum(-1) / tm1


@METRICS.register("lm_bits_per_byte")
@torch.no_grad()
def lm_bits_per_byte(output, target, shard=None):
    """Per-example next-token cross entropy in bits (the byte-LM quality
    number when tokens are bytes, vocab 256: 8.0 is uniform). Plain
    ``[B, T, V]`` logits or the fused head's ``(hidden, head_w)``, through
    the loss implementations (fused: chunk 256), divided by ln 2."""
    if isinstance(output, tuple):
        return fused_lm_cross_entropy(chunk=256)(output, target,
                                                 shard) / _LN2
    return lm_cross_entropy(output, target, shard) / _LN2


@METRICS.register("lm_nll")
def lm_nll(output, target, shard=None):
    """Per-example next-token negative log likelihood in nats per token
    (the subword counterpart of ``lm_bits_per_byte``; ``exp`` of the
    aggregated value is the corpus perplexity). Plain ``[B, T, V]`` logits
    or the fused head's ``(hidden, head_w)``, through the loss
    implementations (fused: chunk 256); differentiable, as the JAX
    function is."""
    if isinstance(output, tuple):
        return fused_lm_cross_entropy(chunk=256)(output, target, shard)
    return lm_cross_entropy(output, target, shard)
