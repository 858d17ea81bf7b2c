"""Differentiable collectives over one process group: the counterparts of
``lax.ppermute``, the tiled ``lax.all_to_all`` and ``lax.psum`` that the
JAX package's ring and Ulysses attention and its pipeline schedule run
inside ``shard_map``, and the gathers and reductions that XLA inserts for
the JAX package's ``fsdp`` and ``tensor`` placements.

Each is a ``torch.autograd.Function``: :func:`ppermute` sends to the next
rank of the group and receives from the previous one (``batch_isend_irecv``);
its backward is the reverse permutation. :func:`all_to_all` splits a tensor
into the group's size along one axis, sends chunk ``j`` to rank ``j`` and
concatenates what it receives along another axis in rank order
(``all_to_all_single``); its backward is the inverse all-to-all.
:func:`psum` sums a tensor over the group (``all_reduce``); its backward
sums the cotangents over the group, psum's transpose. Autograd
then differentiates a ring as JAX does, through the flash backward, the
merges and the permutes.

The ``fsdp`` and ``tensor`` axes (parallel/fsdp.py, the LM families'
Megatron layers): :func:`all_gather` concatenates the group's tensors
along a dimension and its backward is a reduce-scatter (sum), the ZeRO-3
gather of a parameter whose users differ per rank (each rank holds other
rows of the batch). :func:`gather_replicated` is the same forward whose
backward takes this rank's slice of the cotangent, for a computation that
every rank of the group repeats on the whole tensor (the vocab-sharded
logits, the fused head's weight). :func:`copy_to` is Megatron's ``f``
(identity, all-reduce backward: before a column-parallel projection) and
:func:`reduce_from` its ``g`` (all-reduce, identity backward: after a
row-parallel projection and the vocab-sharded embedding lookup). Every
rank must issue the same collectives in the same order: callers never
branch on their rank around one.

:data:`P2P` counts the calls and the bytes of each (a gather's and a
reduce-scatter's whole tensor, an all-reduce's tensor, what a permute
sends), for the smoke run's per-step report.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

#: ``{"ppermute": calls, "ppermute_bytes": bytes sent, "all_to_all": ...}``
P2P = {"ppermute": 0, "ppermute_bytes": 0, "all_to_all": 0,
       "all_to_all_bytes": 0, "psum": 0, "psum_bytes": 0,
       "all_gather": 0, "all_gather_bytes": 0, "reduce_scatter": 0,
       "reduce_scatter_bytes": 0, "all_reduce": 0, "all_reduce_bytes": 0}


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


def _count(kind: str, t: torch.Tensor) -> None:
    P2P[kind] += 1
    P2P[kind + "_bytes"] += t.numel() * t.element_size()


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    size = tdist.get_world_size(group)
    x = x.contiguous()
    # the parts stacked along dim 0 (what gloo and NCCL both take)
    out = torch.empty((size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _count("all_gather", out)
    tdist.all_gather_into_tensor(out, x, group=group)
    if dim == 0:
        return out
    return torch.cat(out.chunk(size, dim=0), dim=dim)


def _local(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    size = tdist.get_world_size(group)
    return g.chunk(size, dim=dim)[tdist.get_rank(group)].contiguous()


def reduce_scatter(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``g`` summed over ``group`` and split along ``dim``: this rank's
    part of the sum (not differentiable)."""
    size = tdist.get_world_size(group)
    chunks = g.chunk(size, dim=dim)
    parts = (g.contiguous() if dim == 0 else torch.cat(chunks, dim=0))
    out = torch.empty(chunks[0].shape, dtype=g.dtype, device=g.device)
    _count("reduce_scatter", parts)
    tdist.reduce_scatter_tensor(out, parts, group=group)
    return out


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` in place (not differentiable); returns
    it."""
    _count("all_reduce", t)
    tdist.all_reduce(t, group=group)
    return t


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in rank order; the
    backward reduce-scatters (sums) the cotangent, each rank getting its
    slice's part."""
    return _AllGather.apply(x, dim, group)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _local(g, ctx.dim, ctx.group), None, None


def gather_replicated(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """:func:`all_gather` whose backward takes this rank's slice of the
    cotangent: for a computation every rank of ``group`` repeats on the
    whole tensor (its cotangent is the same on every rank)."""
    return _GatherReplicated.apply(x, dim, group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``f``: ``x`` as it is; the backward sums the cotangent
    over ``group`` (each rank's column-parallel slice gave a part)."""
    return _CopyTo.apply(x, group)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``g``: ``x`` summed over ``group``; the backward passes
    the cotangent through (every rank repeats what follows)."""
    return _ReduceFrom.apply(x, group)
