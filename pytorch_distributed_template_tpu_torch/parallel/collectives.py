"""Differentiable collectives over one process group: the counterparts of
``lax.ppermute``, the tiled ``lax.all_to_all`` and ``lax.psum`` that the
JAX package's ring and Ulysses attention and its pipeline schedule run
inside ``shard_map``.

Each is a ``torch.autograd.Function``: :func:`ppermute` sends to the next
rank of the group and receives from the previous one (``batch_isend_irecv``);
its backward is the reverse permutation. :func:`all_to_all` splits a tensor
into the group's size along one axis, sends chunk ``j`` to rank ``j`` and
concatenates what it receives along another axis in rank order
(``all_to_all_single``); its backward is the inverse all-to-all.
:func:`psum` sums a tensor over the group (``all_reduce``); its backward
sums the cotangents over the group, psum's transpose. Autograd
then differentiates a ring as JAX does, through the flash backward, the
merges and the permutes. Every rank must issue the same collectives in the
same order: callers never branch on their rank around one.

:data:`P2P` counts the calls and the bytes each process sends through
them, for the smoke run's per-step report.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

#: ``{"ppermute": calls, "ppermute_bytes": bytes sent, "all_to_all": ...}``
P2P = {"ppermute": 0, "ppermute_bytes": 0, "all_to_all": 0,
       "all_to_all_bytes": 0, "psum": 0, "psum_bytes": 0}


def reset_counts() -> None:
    for key in P2P:
        P2P[key] = 0


def _send_recv(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    size = tdist.get_world_size(group)
    me = tdist.get_rank(group)
    dst = tdist.get_global_rank(group, (me + shift) % size)
    src = tdist.get_global_rank(group, (me - shift) % size)
    x = x.contiguous()
    out = torch.empty_like(x)
    P2P["ppermute"] += 1
    P2P["ppermute_bytes"] += x.numel() * x.element_size()
    ops = [tdist.P2POp(tdist.isend, x, dst, group),
           tdist.P2POp(tdist.irecv, out, src, group)]
    for req in tdist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _send_recv(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _send_recv(g, ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Rank ``i`` of ``group`` gets rank ``(i - shift) % S``'s ``x``
    (``lax.ppermute`` with ``perm = [(i, (i + shift) % S)]``)."""
    return _PPermute.apply(x, group, shift)


def _a2a(x: torch.Tensor, group, split_axis: int,
         concat_axis: int) -> torch.Tensor:
    size = tdist.get_world_size(group)
    if x.shape[split_axis] % size:
        raise ValueError(f"all_to_all: axis {split_axis} of "
                         f"{tuple(x.shape)} does not split {size} ways")
    chunks = torch.stack(x.chunk(size, dim=split_axis)).contiguous()
    out = torch.empty_like(chunks)
    P2P["all_to_all"] += 1
    P2P["all_to_all_bytes"] += chunks.numel() * chunks.element_size()
    tdist.all_to_all_single(out, chunks, group=group)
    return torch.cat(out.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _a2a(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _a2a(g, group, concat_axis, split_axis), None, None, None


def all_to_all(x: torch.Tensor, group, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """The tiled ``lax.all_to_all``: ``x`` split ``S`` ways along
    ``split_axis``, chunk ``j`` to rank ``j``, the received chunks
    concatenated along ``concat_axis`` in rank order."""
    return _AllToAll.apply(x, group, split_axis, concat_axis)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    P2P["psum"] += 1
    P2P["psum_bytes"] += out.numel() * out.element_size()
    tdist.all_reduce(out, group=group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` on every rank (``lax.psum``); the
    backward sums the cotangents over the group."""
    return _PSum.apply(x, group)


def all_to_all_local(xs, split_axis: int, concat_axis: int):
    """:func:`all_to_all` for ``S`` shards held in one process (a list, in
    rank order): shard ``j`` gets chunk ``j`` of every shard."""
    s = len(xs)
    parts = [x.chunk(s, dim=split_axis) for x in xs]
    return [torch.cat([parts[i][j] for i in range(s)], dim=concat_axis)
            for j in range(s)]
