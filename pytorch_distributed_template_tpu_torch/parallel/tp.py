"""Tensor-parallel and DP x TP serving: the port of the JAX package's
``parallel/tp.py`` (geometry, placements, per-step collective
accounting), with the process model PyTorch needs.

Megatron TP over the ``tensor`` axis, from the model's own
``partition_rules()`` (the training rules): q/k/v and gate/up are split by
output rows, o/down by input columns, the embedding and the head by
vocabulary rows. KV caches and pool pages ``[B | P, T | bt, KVH, D]`` (and
the int8 pool's scales ``[P, bt, KVH]``) are split on the KV-head axis, so
attention needs no collective: each rank reads and appends its own head
slice. Block tables, the radix index, refcounts, row starts and slot
state stay single host metadata; a page id means the same page on every
rank, so a warm admit stays a pointer update under TP as at tp 1. A
decode step issues Megatron's pair per layer (one all-reduce after
``o_proj``, one after ``down_proj``), one for the vocab-sharded lookup,
and the gather of the vocab-sharded logits.

The process model. JAX runs TP serving as one SPMD program in one
process, XLA inserting the all-reduces. PyTorch has no such program, and
two ranks of one NCCL communicator cannot share a card, so the port runs
**one process per card**, as the training ranks do
(``parallel/serving_ranks.py``):

- each rank of a TP group holds only its Megatron slice of the weights
  (``load_generation_stack`` slices a memory-mapped artifact as it
  reads, so no rank holds the whole model) and its head slice of every
  cache and of the pool, and runs each model call in lockstep with the
  group through the model's Megatron forward on its local heads (B1
  prefill and B4 paged attention on the card);
- the engine's host state (scheduler thread, radix index, block tables,
  refcounts, sampling) lives in the serving process alone, which holds no
  card of a TP group. Per model call it sends every rank the call's small
  integer inputs (tokens, block tables, row starts, pad lengths) and gets
  back rank 0's last-position logits, already gathered over the
  vocabulary (``gather_replicated``), then samples on the host;
- ``serve.py --tp T`` starts its own ranks (no ``torchrun``), and
  ``--dp D`` runs D independent groups: group ``g`` owns cards
  ``[g T, (g + 1) T)``; a tp-1 group is an engine of the serving process
  on its own card. A rank that fails fails its group at once: the call
  raises, the server answers the request with an error and exits
  non-zero, without waiting out NCCL's timeout.

One Python thread launching for T cards would multiply each decode
step's eager launches by T (decode is already host-bound on one card);
with a process per card each rank launches only its own.

JAX's ``hlo_collectives`` and ``_decode_step_hlo`` read compiled HLO and
have no counterpart: :func:`decode_step_collectives` runs one batch-``B``
one-token decode step on the ranks and counts the collectives it issues
(``parallel.collectives.P2P``: ``all_reduce`` for Megatron's ``g`` and
the lookup, ``all_gather`` for the logits), under JAX's op names.
"""
from __future__ import annotations

import torch

from .mesh import Mesh
from .sharding import P, apply_rules, shard_params, slice_placed

#: the serving TP axis: the name the training rules use, so one
#: ``partition_rules()`` serves both
TP_AXIS = "tensor"
#: ``P2P`` keys -> JAX's HLO op names
_OPS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
        "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
        "ppermute": "collective-permute"}


def serving_devices(tp: int, device="cuda", first: int = 0) -> list:
    """The ``tp`` devices of one TP group starting at card ``first`` (the
    counterpart of ``serving_mesh``): ``cuda:first .. cuda:first+tp-1``;
    on the CPU every rank runs on the CPU (gloo). Refuses with JAX's
    wording when the host has too few cards."""
    tp, dev = int(tp), torch.device(device)
    if dev.type != "cuda":
        return [dev] * tp
    have = torch.cuda.device_count()
    if have < first + tp:
        raise ValueError(
            f"serving.tensor_parallel={tp} needs {first + tp} devices, "
            f"found {have}")
    return [torch.device("cuda", first + r) for r in range(tp)]


def validate_dp_geometry(dp: int, tp: int, device="cuda") -> None:
    """Refuse a DP x TP geometry the host cannot place, before any load:
    ``dp`` groups of ``tp`` cards need ``dp * tp`` cards."""
    dp, tp = int(dp), int(tp)
    if dp < 1 or tp < 1:
        raise ValueError(f"need dp >= 1 and tp >= 1 (got dp={dp}, "
                         f"tp={tp})")
    if torch.device(device).type == "cuda":
        have = torch.cuda.device_count()
        if have < dp * tp:
            raise ValueError(f"dp={dp} x tp={tp} needs {dp * tp} "
                             f"devices, found {have}")


def dp_group_devices(group: int, tp: int, device="cuda") -> list:
    """The devices of DP group ``group``: cards ``[g tp, (g + 1) tp)``."""
    tp = max(int(tp), 1)
    return serving_devices(tp, device, first=int(group) * tp)


def tp_degree(obj) -> int:
    """The TP degree of a mesh, a model (its tensor axis, or the tensor
    axis of the mesh it was built with), a rank group's model, or 1."""
    if obj is None:
        return 1
    if isinstance(obj, Mesh):
        return obj.axis_size(TP_AXIS)
    if isinstance(getattr(obj, "tensor_parallel", None), int):
        return obj.tensor_parallel
    tp = getattr(obj, "tp", None)
    if tp is not None and hasattr(tp, "size"):
        return int(tp.size)
    mesh = getattr(obj, "mesh", None)
    return mesh.axis_size(TP_AXIS) if isinstance(mesh, Mesh) else 1


def model_geometry(model) -> dict:
    """The shape a TP layout must divide, as JAX records it in serving
    artifacts: heads, KV heads, width, ``d_ff`` (each family's ``d_ff=0``
    default: the Llama family's ~8/3 x d_model rounded up to 16, GPT-2's 4
    x d_model) and the vocabulary."""
    n_head = int(getattr(model, "n_head", 0) or 0)
    n_kv = int(getattr(model, "n_kv_head", 0) or 0) or n_head
    d_model = int(getattr(model, "d_model", 0) or 0)
    d_ff = int(getattr(model, "d_ff", 0) or 0)
    if not d_ff and d_model:
        if hasattr(model, "n_kv_head"):
            d_ff = -(-int(d_model * 8 / 3) // 16) * 16
        else:
            d_ff = 4 * d_model
    return {"n_head": n_head, "n_kv_head": n_kv, "d_model": d_model,
            "d_ff": d_ff,
            "vocab_size": int(getattr(model, "vocab_size", 0) or 0)}


def validate_tp_geometry(model, tp: int) -> None:
    """Refuse a TP degree the model cannot shard, every violated dimension
    in one message, before any rank starts; a model without
    ``partition_rules()`` is refused at tp > 1 (an artifact's recorded
    geometry: ``checkpoint.check_artifact_tp_geometry``), and a sparse
    model (MoE blocks) by name as ROADMAP A6c.3's remainder, the GPT-2
    family as A6a.5's and w8a16 weights as A4's."""
    tp = int(tp)
    if tp <= 1:
        return
    if int(getattr(model, "moe_experts", 0) or 0) > 0:
        raise NotImplementedError(
            f"tensor_parallel={tp} on {type(model).__name__}'s MoE blocks: "
            "MoE under tensor-parallel serving is ROADMAP A6c.3's "
            "remainder, a later slice")
    if not hasattr(model, "n_kv_head") and hasattr(model, "n_head"):
        raise NotImplementedError(
            f"tensor_parallel={tp} on the GPT-2 family "
            f"({type(model).__name__}): tensor-parallel serving of the "
            "GPT-2 family is ROADMAP A6a.5's remainder, a later slice")
    if str(getattr(model, "quant", "") or ""):
        raise NotImplementedError(
            f"tensor_parallel={tp} on w8a16 weights: sharding the int8 "
            "kernels is ROADMAP A4's remainder, a later slice")
    if not hasattr(model, "partition_rules"):
        raise ValueError(
            f"{type(model).__name__} declares no partition_rules(): "
            "tensor-parallel serving needs the TP sharding contract "
            "(the Llama/GPT-2 families)")
    g = model_geometry(model)
    bad = [f"{key}={int(g.get(key) or 0)}"
           for key in ("n_head", "n_kv_head", "d_ff", "vocab_size")
           if int(g.get(key) or 0) % tp]
    if bad:
        raise ValueError(
            f"tensor_parallel={tp} does not divide model geometry: "
            f"{', '.join(bad)} (KV heads shard over the tensor axis; "
            "pick tp dividing every listed dimension)")


def kv_pool_pspec(ndim: int = 4) -> P:
    """The placement of a cache leaf ``[B, T, KVH, D]``, a pool page
    ``[P, bt, KVH, D]`` (``ndim`` 4) or an int8 scale leaf ``[P, bt, KVH]``
    (``ndim`` 3): KV heads over ``tensor``, the rest whole. A rank's model
    allocates its slice directly (``LlamaLM.local_kv_heads``)."""
    if ndim == 3:
        return P(None, None, TP_AXIS)
    return P(None, None, TP_AXIS, None)


def serving_mesh(tp: int, index: int = 0) -> Mesh:
    """A ``{"tensor": tp}`` mesh of rank ``index`` without process groups:
    placement math only (the ranks build theirs with ``build_mesh``)."""
    return Mesh({TP_AXIS: int(tp)}, rank=int(index))


def serving_placements(model, tp: int) -> dict:
    """``{name: P}`` of every parameter on a ``{"tensor": tp}`` mesh: the
    model's rules through ``parallel.sharding.apply_rules`` (what
    :func:`shard_serving_params` cuts by)."""
    rules = (model.partition_rules() if hasattr(model, "partition_rules")
             else [])
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return apply_rules(shapes, serving_mesh(tp), rules)


def shard_serving_params(model, state: dict, mesh) -> dict:
    """Rank ``mesh``'s slices of a whole state dict: the model is placed
    on the mesh first (``parallel.sharding.shard_params``: its parameters
    cut, ``use_tensor_axis`` on), then every placed entry of ``state`` is
    cut to this rank's slice (``slice_placed``); the replicated entries
    stay as they are. Works on a model on the meta device, whose
    parameters the caller then assigns from the result."""
    if tp_degree(mesh) > 1:
        validate_tp_geometry(model, tp_degree(mesh))
    shard_params(model, mesh)
    return slice_placed(model, state)


def analytic_decode_floor_bytes(model, batch: int = 1, t: int = 1) -> int:
    """The least all-reduce payload of one decode step under Megatron TP:
    the row-parallel ``o_proj``/``down_proj`` pair moves one whole ``[B, t,
    d_model]`` activation per layer each (JAX's formula; the vocab-sharded
    lookup's all-reduce is not in the floor)."""
    g = model_geometry(model)
    dtype = getattr(model, "dtype", torch.float32)
    itemsize = torch.empty((), dtype=dtype).element_size()
    return int(2 * int(model.n_layer) * batch * t * g["d_model"] * itemsize)


def _zeros(tp: int) -> dict:
    return {"tp_degree": tp, "collective_count_per_step": 0,
            "collective_bytes_per_step": 0, "analytic_floor_bytes": 0,
            "counts": {}, "bytes": {}}


def decode_step_collectives(model, batch: int = 1) -> dict:
    """The collectives one one-token decode step of ``batch`` rows issues
    on a TP group, counted as it runs (the model's ``decode_probe``)::

        {"tp_degree", "collective_count_per_step",
         "collective_bytes_per_step", "analytic_floor_bytes",
         "counts": {op: n}, "bytes": {op: B}}

    keyed by JAX's op names. A tp-1 model gives zeros without running
    anything."""
    tp = tp_degree(model)
    if tp <= 1:
        return _zeros(tp)
    p2p = model.decode_probe(int(batch))
    counts = {_OPS[k]: int(p2p[k]) for k in _OPS if p2p.get(k)}
    nbytes = {_OPS[k]: int(p2p[k + "_bytes"]) for k in _OPS if p2p.get(k)}
    out = _zeros(tp)
    out.update(collective_count_per_step=sum(counts.values()),
               collective_bytes_per_step=sum(nbytes.values()),
               analytic_floor_bytes=analytic_decode_floor_bytes(model,
                                                                batch),
               counts=counts, bytes=nbytes)
    return out
