"""Building blocks the port's model families share for training.

- :class:`Dense`: ``nn.Linear`` whose parameters may be stored wider than
  it computes (float32 master weights, bf16 compute), cast at use like
  flax's ``Dense(dtype=...)`` over float32 params. When the two dtypes
  agree (the serving path's bf16-stored weights) the casts are no-ops.
- :func:`embed`: an embedding lookup cast to the compute dtype (flax's
  ``Embed(dtype=...)``).
- :func:`layer_norm_f32`: LayerNorm in float32 with float32 scale and bias
  (flax's ``LayerNorm(dtype=float32)``).
- :func:`dropout` with :func:`fold_in` seeds (and :class:`Dropout`, its
  module form): every mask is drawn from a ``torch.Generator`` seeded by
  ``(seed, step, layer, site)`` inside the module that uses it, so a block recomputed by ``torch.utils.checkpoint``
  redraws the very same mask. (Checkpointing replays only the global RNG
  state; a mask drawn from a generator handed in from outside would differ
  in the recompute and the gradients would be silently wrong.)
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijective avalanche on 64-bit ints."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, *data: int) -> int:
    """A new seed from ``seed`` and integers ``data`` (the role of
    ``jax.random.fold_in``; the bits differ from JAX's by construction).
    Pure: the same arguments give the same seed, in [0, 2**63)."""
    x = _mix64(int(seed) & _MASK64)
    for d in data:
        x = _mix64(x ^ (int(d) & _MASK64))
    return x >> 1


def dropout(x, rate: float, seed, training: bool):
    """Inverted dropout: zero each element with probability ``rate`` and
    scale the rest by ``1 / (1 - rate)``. The mask comes from a generator
    seeded with ``seed`` on ``x``'s device; identity when not training or
    ``rate == 0``."""
    if not training or rate <= 0.0:
        return x
    if seed is None:
        raise ValueError("dropout > 0 in training needs a seed (the "
                         "model's forward takes dropout_seed)")
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(seed))
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Dropout(nn.Module):
    """:func:`dropout` as a module: rate ``p`` (0 turns it off), the mask
    seeded by the ``seed`` of each call."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x, seed):
        return dropout(x, self.p, seed, self.training)

    def extra_repr(self) -> str:
        return f"p={self.p}"


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` over parameters stored
    in ``param_dtype`` (default: the compute dtype). Input, weight and bias
    are cast to the compute dtype at use; gradients flow back to the
    stored parameters in their own dtype."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, compute_dtype=torch.float32,
                 param_dtype=None, device=None):
        super().__init__(in_features, out_features, bias=bias,
                         dtype=param_dtype or compute_dtype, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def embed(weight, tokens, dtype):
    """Rows of ``weight`` for ``tokens`` (any integer dtype; byte tokens
    arrive as uint8), in ``dtype``. Both backwards sum repeated rows in a
    fixed order, which a resumed training run needs to reproduce the
    uninterrupted one: on CUDA an index (its backward sorts the rows;
    ``F.embedding``'s does not fix the order at a small vocabulary with
    many repeated rows, 256 bytes and thousands of tokens), on the CPU
    ``F.embedding`` (the index's backward there adds rows from several
    threads in whatever order they run)."""
    if weight.is_cuda:
        return weight[tokens.long()].to(dtype)
    return F.embedding(tokens.long(), weight).to(dtype)


def layer_norm_f32(x, weight, bias, eps: float):
    """LayerNorm over the last axis in float32; returns float32."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(),
                        bias.float(), eps)
