"""Building blocks the port's model families share for training.

- :class:`Dense`: ``nn.Linear`` whose parameters may be stored wider than
  it computes (float32 master weights, bf16 compute), cast at use like
  flax's ``Dense(dtype=...)`` over float32 params. When the two dtypes
  agree (the serving path's bf16-stored weights) the casts are no-ops.
- :func:`embed`: an embedding lookup cast to the compute dtype (flax's
  ``Embed(dtype=...)``).
- :func:`layer_norm_f32`: LayerNorm in float32 with float32 scale and bias
  (flax's ``LayerNorm(dtype=float32)``).
- :class:`BatchNorm`: flax's ``nn.BatchNorm`` over the channels of an
  NCHW tensor, its statistics global over the process group (below).
- :class:`SameConv2d` and :func:`max_pool_same`: a convolution and a max
  pool with TF/flax ``SAME`` padding, which is asymmetric where the
  window overhangs by an odd count (a 3x3/2 conv on 112 pads (0, 1), the
  7x7/2 stem conv on 224 (2, 3), a 4x4/1 conv (1, 2)); the conv computes
  in its compute dtype over parameters stored wider, like :class:`Dense`.
- :func:`dropout` with :func:`fold_in` seeds (and :class:`Dropout`, its
  module form): every mask is drawn from a ``torch.Generator`` seeded by
  ``(seed, step, layer, site)`` inside the module that uses it, so a block recomputed by ``torch.utils.checkpoint``
  redraws the very same mask. (Checkpointing replays only the global RNG
  state; a mask drawn from a generator handed in from outside would differ
  in the recompute and the gradients would be silently wrong.)
"""
from __future__ import annotations

import torch
import torch.distributed as tdist
from torch import nn
from torch.nn import functional as F

from ..parallel.collectives import reduce_from

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


def vocab_embed(weight, tokens, dtype, tp):
    """:func:`embed` from a vocab-sharded table: ``weight`` holds rows
    ``[index * n, (index + 1) * n)`` of the tensor axis ``tp``
    (``parallel.mesh.AxisGroup``); the tokens outside them look up row 0
    and are zeroed, then the ranks' rows are summed (Megatron's ``g``)."""
    n = weight.shape[0]
    local = tokens.long() - tp.index * n
    inside = (local >= 0) & (local < n)
    rows = embed(weight, torch.where(inside, local, 0), dtype)
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return reduce_from(rows, tp.group)


def row_parallel(dense, x, tp):
    """A row-parallel projection: ``dense``'s weight holds this rank's
    input columns of the tensor axis ``tp``; the partial products are
    summed over the ranks (Megatron's ``g``) and the replicated bias is
    added once, after the sum."""
    dt = dense.compute_dtype
    y = reduce_from(F.linear(x.to(dt), dense.weight.to(dt)), tp.group)
    return y if dense.bias is None else y + dense.bias.to(dt)


def layer_norm_f32(x, weight, bias, eps: float):
    """LayerNorm over the last axis in float32; returns float32."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(),
                        bias.float(), eps)


def same_pads(size: int, kernel: int, stride: int) -> tuple:
    """``(before, after)`` padding of TF/flax ``SAME`` on one axis: the
    output has ``ceil(size / stride)`` positions and the extra one of an
    odd total goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with ``padding`` ``"SAME"`` (TF/flax; the pads come
    from the input's size at each call) or ``"VALID"``, computing in
    ``compute_dtype`` over parameters stored in ``param_dtype``. Where
    ``SAME``'s pads are symmetric the conv pads them itself; else the
    input is padded first (``F.pad``) and the conv pads nothing."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, bias: bool = False, padding: str = "SAME",
                 compute_dtype=torch.float32, param_dtype=None, device=None):
        super().__init__(in_channels, out_channels, kernel, stride,
                         padding=0, bias=bias, device=device,
                         dtype=param_dtype or compute_dtype)
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding}")
        self.same = padding == "SAME"
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        w = self.weight.to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        x = x.to(dt)
        pad = (0, 0)
        if self.same:
            ph = same_pads(x.shape[2], self.kernel_size[0], self.stride[0])
            pw = same_pads(x.shape[3], self.kernel_size[1], self.stride[1])
            if ph[0] == ph[1] and pw[0] == pw[1]:
                pad = (ph[0], pw[0])
            else:
                x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, w, b, self.stride, pad)


def max_pool_same(x, kernel: int, stride: int):
    """flax's ``max_pool(x, (k, k), (s, s), "SAME")`` on NCHW: the pads
    are -inf, asymmetric as :func:`same_pads` gives them."""
    ph = same_pads(x.shape[2], kernel, stride)
    pw = same_pads(x.shape[3], kernel, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        tdist.all_reduce(t, group=group)
    return t


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode batch norm over every axis but 1, flax's arithmetic:
    float32 statistics from the sums of x and x**2 (``var = E[x**2] -
    E[x]**2``, clipped at 0), ``y = (x - mean) * (rsqrt(var + eps) *
    scale) + bias`` in float32, cast to x's dtype. With a ``group`` the
    sums ``[sum x, sum x**2, n]`` are all-reduced over it before the
    division (one call), and the backward all-reduces the two sums its
    input gradient needs (another): the statistics and their gradients
    are the global batch's. Saves x in its own dtype and two float32
    vectors, not the float32 intermediates."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.float()
        n = xf.new_full((1,), x.numel() / x.shape[1])  # no host copy
        sums = _all_reduce(torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                                      n]), group)
        c = x.shape[1]
        count = sums[-1]
        mean = sums[:c] / count
        var = torch.clamp_min(sums[c:2 * c] / count - mean * mean, 0.0)
        rstd = torch.rsqrt(var + eps)
        y = (xf - mean.view(shape)) * (rstd * weight).view(shape) \
            + bias.view(shape)
        ctx.save_for_backward(x, weight, mean, rstd, var > 0, count)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _mean, _var):
        x, weight, mean, rstd, positive, count = ctx.saved_tensors
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1, -1] + [1] * (x.dim() - 2)
        g = gy.float()
        xc = x.float() - mean.view(shape)
        sums = torch.cat([g.sum(dims), (g * xc).sum(dims)])
        c = x.shape[1]
        # the parameters' gradients are this rank's part (DDP averages
        # them); the input's needs the global sums
        d_bias, d_weight = sums[:c].clone(), sums[c:] * rstd
        sums = _all_reduce(sums, ctx.group)
        # dL/dmean through y, and dL/dvar (0 where the clip held var at 0)
        d_mean = -sums[:c] * weight * rstd
        d_var = torch.where(positive,
                            -0.5 * rstd ** 3 * weight * sums[c:],
                            torch.zeros_like(rstd))
        dx = (g * (weight * rstd).view(shape)
              + (d_mean / count).view(shape)
              + (2.0 * d_var / count).view(shape) * xc)
        return dx.to(x.dtype), d_weight, d_bias, None, None


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5,
    param_dtype=float32)`` over axis 1 (the channels of NCHW).

    Training mode: the batch's statistics, every row of it (flax's BN
    sees no mask: padded rows count), float32 whatever the input's
    dtype, and the running averages ``r = 0.9 r + 0.1 batch`` of the mean
    and the **biased** variance (``nn.BatchNorm2d`` weighs the other
    way round and keeps the unbiased variance). Eval mode: the running
    averages. Scale and bias are float32, the output has the input's
    dtype. Under a process group the statistics are the global batch's
    (the sums all-reduced over ``group``, default the whole group: the
    data axis of an image model's mesh), as the JAX package gets them
    from ``jit`` over a sharded batch; rank-local statistics would make
    four ranks differ from one. The running averages are buffers
    (``running_mean``, ``running_var``: flax's ``batch_stats``), so they
    ride the model's state dict into every checkpoint."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, zero_scale: bool = False, device=None):
        super().__init__()
        kw = dict(device=device, dtype=torch.float32)
        self.momentum, self.eps = float(momentum), float(eps)
        self.zero_scale = bool(zero_scale)
        self.weight = nn.Parameter(torch.ones(features, **kw))
        self.bias = nn.Parameter(torch.zeros(features, **kw))
        self.register_buffer("running_mean", torch.zeros(features, **kw))
        self.register_buffer("running_var", torch.ones(features, **kw))

    @torch.no_grad()
    def reset(self) -> None:
        """flax's init: scale 1 (0 with ``zero_scale``), bias 0, running
        mean 0 and variance 1."""
        self.weight.fill_(0.0 if self.zero_scale else 1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        shape = [1, -1] + [1] * (x.dim() - 2)
        if self.training:
            group = (tdist.group.WORLD
                     if tdist.is_available() and tdist.is_initialized()
                     else None)
            y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias,
                                                 self.eps, group)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * var)
            return y
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean.view(shape)) * mul.view(shape) \
            + self.bias.view(shape)
        return y.to(x.dtype)

    def extra_repr(self) -> str:
        return (f"{self.weight.shape[0]}, momentum={self.momentum}, "
                f"eps={self.eps}")
