"""Losses: the port of the JAX package's ``engine/losses.py`` for the
language-model family and the image losses (``nll_loss``,
``cross_entropy``, ``mse_loss``, ``smooth_cross_entropy``).

Losses are per-example functions ``(output, target) -> [B]``; the train
and eval steps apply the padding mask and reduce (engine/steps.py).
``resolve_loss`` keeps the JAX package's config contract: a plain string
names a loss, a ``{"type", "args"}`` dict calls a registered factory.

``mlm_cross_entropy`` waits for BERT (other model families).
"""
from __future__ import annotations

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..config.registry import LOSSES


@LOSSES.register("nll_loss")
def nll_loss(output, target):
    """Negative log-likelihood of log-probability outputs ``[B, C]`` (the
    model ends in log-softmax)."""
    return -output.gather(1, target.long()[:, None])[:, 0]


@LOSSES.register("cross_entropy")
def cross_entropy(output, target):
    """Softmax cross entropy of raw logits ``[B, C]``."""
    return F.cross_entropy(output.float(), target.long(), reduction="none")


@LOSSES.register("mse_loss")
def mse_loss(output, target):
    """Mean squared error over every axis but the batch."""
    return ((output - target) ** 2).mean(dim=tuple(range(1, output.ndim)))


@LOSSES.register("smooth_cross_entropy")
def smooth_cross_entropy(smoothing: float = 0.1):
    """FACTORY loss (dict-form config): softmax cross entropy against the
    label-smoothed target ``onehot (1 - s) + s / C``."""
    if not 0.0 <= smoothing < 1.0:
        raise ValueError(f"smoothing must be in [0, 1), got {smoothing}")

    def loss(output, target):
        n = output.shape[-1]
        soft = F.one_hot(target.long(), n).to(output.dtype) \
            * (1.0 - smoothing) + smoothing / n
        return -(soft * F.log_softmax(output, dim=-1)).sum(-1)

    return loss


smooth_cross_entropy._loss_factory = True


def _token_ce(logits, labels):
    """Per-token cross entropy ``[B, T]`` of float32 logits ``[B, T, V]``
    against integer labels (optax's
    ``softmax_cross_entropy_with_integer_labels``)."""
    b, t, v = logits.shape
    return F.cross_entropy(logits.reshape(b * t, v), labels.reshape(b * t),
                           reduction="none").view(b, t)


@LOSSES.register("lm_cross_entropy")
def lm_cross_entropy(output, target):
    """Next-token LM loss: output ``[B, T, V]`` logits, target ``[B, T]``
    tokens. Shifts internally (predict token t+1 from position t) and
    returns the per-sequence mean."""
    return _token_ce(output[:, :-1].float(), target[:, 1:].long()).mean(-1)


def chunk_shifted_sequence(h, labels, chunk: int, pad_label: int = 0):
    """Split an already-shifted ``(hidden [B, T-1, D], labels [B, T-1])``
    pair into chunk-leading tensors ``(h_c [n, B, chunk, D], l_c [n, B,
    chunk], valid [n, chunk])``: trailing padding rows are marked invalid
    and their labels set to ``pad_label``."""
    b, tm1, d = h.shape
    n_chunks = -(-tm1 // chunk)
    t_pad = n_chunks * chunk
    if t_pad != tm1:
        h = F.pad(h, (0, 0, 0, t_pad - tm1))
        labels = F.pad(labels, (0, t_pad - tm1), value=pad_label)
    h_c = h.reshape(b, n_chunks, chunk, d).transpose(0, 1)
    l_c = labels.reshape(b, n_chunks, chunk).transpose(0, 1)
    valid = (torch.arange(t_pad, device=h.device) < tm1).float().view(
        n_chunks, chunk)
    return h_c, l_c, valid


def _chunk_loss(hc, lc, vc, w):
    """Summed cross entropy of one chunk: ``[B]``."""
    logits = (hc @ w).float()                           # [B, chunk, V]
    return (_token_ce(logits, lc) * vc[None, :]).sum(-1)


@LOSSES.register("fused_lm_cross_entropy")
def fused_lm_cross_entropy(chunk: int = 256):
    """FACTORY loss: next-token CE fused with the LM head, chunked along
    the sequence.

    Pairs with a ``fused_head`` model: ``output`` is ``(hidden [B, T, D],
    head_w [D, V])``. Each ``chunk``-token slice computes its logits
    ``(h @ w).float()`` and its CE under ``torch.utils.checkpoint``, so the
    backward recomputes them and one ``[B, chunk, V]`` slice is alive at a
    time (the JAX package's ``jax.checkpoint`` scan). Same value as
    ``lm_cross_entropy`` on the same params up to float reassociation."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")

    def loss(output, target):
        h, w = output
        tm1 = h.shape[1] - 1
        h_c, l_c, v_c = chunk_shifted_sequence(h[:, :-1],
                                               target[:, 1:].long(), chunk)
        total = torch.zeros(h.shape[0], dtype=torch.float32,
                            device=h.device)
        grad = torch.is_grad_enabled()
        for i in range(h_c.shape[0]):
            if grad:
                part = checkpoint(_chunk_loss, h_c[i], l_c[i], v_c[i], w,
                                  use_reentrant=False)
            else:
                part = _chunk_loss(h_c[i], l_c[i], v_c[i], w)
            total = total + part
        return total / tm1

    return loss


fused_lm_cross_entropy._loss_factory = True


def resolve_loss(loss_cfg):
    """The config ``loss`` entry as a per-example callable: a plain string
    names a loss, a ``{"type", "args"}`` dict calls a registered factory
    with ``args``. Form/kind mismatches raise here."""
    if isinstance(loss_cfg, str):
        loss = LOSSES.get(loss_cfg)
        if getattr(loss, "_loss_factory", False):
            raise ValueError(
                f"loss '{loss_cfg}' is parameterized; use the dict form "
                f'{{"type": "{loss_cfg}", "args": {{...}}}}')
        return loss
    factory = LOSSES.get(loss_cfg["type"])
    if not getattr(factory, "_loss_factory", False):
        raise ValueError(
            f"loss '{loss_cfg['type']}' takes no args; use the string form "
            f'"loss": "{loss_cfg["type"]}"')
    return factory(**dict(loss_cfg.get("args", {})))
