"""Pipeline parallelism over the ``pipe`` mesh axis: the port of the JAX
package's ``parallel/pipeline.py`` (``pipeline_apply``,
``regroup_for_pipeline``, ``_stage_rng``).

The model's repeated trunk is a set of stacked stage parameters whose
leading dim is the stage; each rank of a pipe row holds its own stage's
slice (parallel/sharding.py). Microbatches stream through the stages in a
tick loop: each tick every rank applies one stage chunk to what it holds,
and the activations hop to the next rank with ``parallel.collectives.
ppermute``. Autograd differentiates the schedule: the backward runs the
ticks in reverse, each permute's backward the reverse permute.

Two schedules, as in JAX:

- ``n_chunks=1``, GPipe: ``M + S - 1`` ticks, bubble ``(S-1)/(M+S-1)``;
- ``n_chunks=V > 1``, circular (interleaved): rank ``s`` holds the ``V``
  chunks of virtual stages ``v*S + s`` and each microbatch loops the ring
  ``V`` times; ``ceil(M/S)*S*V + S - 1`` ticks, bubble ``(S-1)/(M*V + S -
  1)`` when ``S`` divides ``M``.

Every rank issues the same collectives in the same order: the tick loop
never branches on the rank around one. Stage 0's fresh microbatch and the
ring's handoff are chosen with ``torch.where`` (JAX's ``jnp.where``), so
each tick's received tensor stays in the graph on every rank and its
permute's backward runs everywhere, zeros where the value was not used;
each tick's output slot is written the same way, on every rank. At the
end the last stage's outputs are summed over the pipe group
(:func:`parallel.collectives.psum`, JAX's ``psum``), so every rank holds
them; the backward sums the cotangents over the group (psum's transpose).

The microbatches a rank passes are its data shard's rows: the loaders
shard the batch over the data axis (``parallel.mesh.Mesh.data_shard``),
the placement JAX's ``in_specs`` give the microbatch dim (``:184-199``),
so every data column pipelines only its own rows.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.layers import fold_in
from .collectives import ppermute, psum


def tree_map(fn, tree):
    """``fn`` over the tensors of a dict / list / tuple nest."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _stage_first(a: torch.Tensor) -> torch.Tensor:
    """``[S, V, ...] -> [V * S, ...]`` in virtual-stage order ``g = v*S +
    s``."""
    return a.transpose(0, 1).reshape((-1,) + tuple(a.shape[2:]))


def pipeline_apply(stage_fn: Callable, stage_params, microbatches,
                   mesh, axis_name: str = "pipe", rng: Optional[int] = None,
                   n_chunks: int = 1, extras=None):
    """Run ``microbatches`` through ``S`` pipeline stages.

    :param stage_fn: ``(params_one_chunk, x, seed_or_None) -> y`` applying
        ONE stage chunk to ONE microbatch; ``y`` has ``x``'s shape and
        dtype. With ``extras``: ``(params_one_chunk, x, extras,
        seed_or_None) -> y``.
    :param stage_params: a nest of tensors whose leading dim is ``S``
        (``[S, V, ...]`` with ``n_chunks=V > 1``, entry ``[s, v]`` virtual
        stage ``v*S + s``: :func:`regroup_for_pipeline`). On a pipe axis a
        rank may pass the whole stack (it takes entry ``s``, as
        ``shard_map`` hands it) or its own entry with a leading dim of 1.
    :param microbatches: ``[M, mb, ...]``.
    :param rng: an optional base seed; each (virtual stage, tick) folds in
        its own (:func:`_stage_rng`).
    :param n_chunks: virtual chunks per rank (circular schedule); 1 is
        GPipe.
    :param extras: an optional nest every stage needs whole (RoPE tables).
    :returns: ``[M, mb, ...]`` outputs, on every rank of the pipe row.
    """
    V = int(n_chunks)
    if V < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    if extras is not None:
        call = stage_fn
    else:
        def call(p, x, _e, r):
            return stage_fn(p, x, r)

    if mesh is None or mesh.axis_size(axis_name) == 1:
        # no pipe axis: every virtual stage in order g = v*S + s
        flat = tree_map(_stage_first, stage_params) if V > 1 \
            else stage_params
        n_virtual = _leaves(flat)[0].shape[0]
        outs = []
        for mb in microbatches.unbind(0):
            for g in range(n_virtual):
                mb = call(tree_map(lambda a: a[g], flat), mb, extras,
                          _stage_rng(rng, g, 0))
            outs.append(mb)
        return torch.stack(outs)

    S, s = mesh.axis_size(axis_name), mesh.axis_index(axis_name)
    group = mesh.group(axis_name)

    def local(a):
        if a.shape[0] == S:
            return a[s]
        if a.shape[0] != 1:
            raise ValueError(f"stage params of leading dim {a.shape[0]}: "
                             f"neither the {S} stages nor this rank's one")
        return a[0]

    p_local = tree_map(local, stage_params)   # [V, Lc, ...] or [Lc, ...]
    m = microbatches.shape[0]
    groups = -(-m // S)
    total_ticks = groups * S * V + S - 1
    flag = torch.tensor([False, True], device=microbatches.device)
    recv = torch.zeros_like(microbatches[0])
    outs = list(torch.zeros_like(microbatches).unbind(0))
    for t in range(total_ticks):
        # virtual time: rank s starts s ticks after rank 0; tau < 0 is the
        # fill bubble (garbage compute)
        tau = max(t - s, 0)
        slot = tau % (S * V)
        v, member = slot // S, slot % S
        mb_idx = (tau // (S * V)) * S + member
        idx = min(mb_idx, m - 1)
        # stage 0 ingests a fresh microbatch at chunk 0; every other
        # (rank, chunk) takes the ring's handoff (rank 0 at v > 0: the
        # wrap-around from the last rank, one chunk back)
        x_in = torch.where(flag[int(s == 0 and v == 0)], microbatches[idx],
                           recv)
        p_chunk = tree_map(lambda a: a[v], p_local) if V > 1 else p_local
        r = _stage_rng(rng, v * S + s, t)
        y = call(p_chunk, x_in, extras, r)
        # the last virtual stage finishes microbatch mb_idx at this tick
        valid = (s == S - 1 and v == V - 1 and t - s >= 0 and mb_idx < m)
        outs[idx] = torch.where(flag[int(valid)], y, outs[idx])
        recv = ppermute(y, group, 1)
    out = torch.stack(outs)
    # only the last stage holds real outputs; every rank gets them
    out = torch.where(flag[int(s == S - 1)], out, torch.zeros_like(out))
    return psum(out, group)


def regroup_for_pipeline(stacked, n_stages: int, n_chunks: int = 1):
    """``[L, ...]``-stacked layer params -> :func:`pipeline_apply`'s
    layout: ``[S, L/S, ...]`` (GPipe, stage ``s`` the contiguous layers
    ``[s*L/S, (s+1)*L/S)``) or ``[S, V, L/(S*V), ...]`` (circular, entry
    ``[s, v]`` the layers of virtual stage ``v*S + s``)."""
    S, V = int(n_stages), int(n_chunks)

    def one(a):
        L = a.shape[0]
        if L % (S * V):
            raise ValueError(
                f"n_layer {L} not divisible by n_stages*n_chunks {S * V}")
        lc = L // (S * V)
        g_major = a.reshape((S * V, lc) + tuple(a.shape[1:]))
        if V == 1:
            return g_major.reshape((S, lc) + tuple(a.shape[1:]))
        return g_major.reshape((V, S, lc) + tuple(a.shape[1:])) \
            .transpose(0, 1)

    return tree_map(one, stacked)


def _stage_rng(rng, stage_idx: int, t: int):
    if rng is None:
        return None
    return fold_in(fold_in(rng, stage_idx), t)
