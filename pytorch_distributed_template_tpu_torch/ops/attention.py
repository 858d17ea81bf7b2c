"""Plain PyTorch attention, the counterpart of
``pytorch_distributed_template_tpu/ops/attention.py``.

``multihead_attention`` is the reference einsum-softmax-einsum path and
``grouped_query_attention`` the decode-step read that never expands the
K/V heads. Both take and return ``[B, T, H, D]``, compute scores and
probabilities in float32 for every input dtype, and mask with
``NEG_INF = -1e30`` exactly like the JAX functions. The JAX package leaves
these to XLA, so the port leaves them to PyTorch: no kernel of their own.
``paged_gqa_attention`` is the entry to the paged kernel (B4,
ops/flash.py).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def multihead_attention(q, k, v, causal: bool = True,
                        mask: Optional[torch.Tensor] = None,
                        window: int = 0):
    """q, k, v: ``[B, T, H, D]`` -> ``[B, T, H, D]``.

    ``window > 0`` keeps keys in ``(t - window, t]`` for query ``t``;
    ``mask`` (bool, broadcastable to ``[B, H, Tq, Tk]``) hides keys
    further."""
    dtype = q.dtype
    depth = q.shape[-1]
    qf = q.float() * (depth ** -0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    tq, tk = scores.shape[-2], scores.shape[-1]
    if causal:
        cm = torch.ones((tq, tk), dtype=torch.bool,
                        device=q.device).tril()
        scores = scores.masked_fill(~cm, NEG_INF)
    if window > 0:
        q_pos = torch.arange(tq, device=q.device)[:, None]
        k_pos = torch.arange(tk, device=q.device)[None, :]
        scores = scores.masked_fill(~(q_pos - k_pos < window), NEG_INF)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(dtype)


def _gqa_groups(q, k, v) -> int:
    h, kvh = q.shape[2], k.shape[2]
    if v.shape[2] != kvh or h % kvh:
        raise ValueError(f"GQA needs q heads ({h}) a multiple of k/v heads "
                         f"({kvh}/{v.shape[2]})")
    return h // kvh


def grouped_query_attention(q, k, v, mask=None):
    """Decode-path GQA: q ``[B, T, H, D]``, k/v ``[B, L, KVH, D]`` with
    ``H = KVH * g``; query head ``i`` reads kv head ``i // g``, and the
    cache is read at its stored width. ``mask`` follows
    :func:`multihead_attention` (broadcastable to ``[B, 1, T, L]``)."""
    dtype = q.dtype
    b, t, h, d = q.shape
    g = _gqa_groups(q, k, v)
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None, None]
        elif mask.dim() == 3:
            mask = mask[:, None]
    if g == 1:
        return multihead_attention(q, k, v, causal=False, mask=mask)
    kvh = h // g
    qg = q.reshape(b, t, kvh, g, d).float() * (d ** -0.5)
    scores = torch.einsum("btkgd,blkd->bkgtl", qg, k.float())
    if mask is not None:
        scores = scores.masked_fill(~mask[:, :, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgtl,blkd->btkgd", probs, v.float())
    return out.reshape(b, t, h, d).to(dtype)


def paged_gqa_attention(q, k_pool, v_pool, tables, row_starts, pad_lens,
                        mesh=None, window: int = 0, k_scale=None,
                        v_scale=None):
    """Attention straight from the paged KV block pool (the JAX
    package's ``paged_gqa_attention``, single device): q ``[B, T, Hq,
    D]`` over pools ``[P, bt, KVH, D]`` through ``[B, NB]`` block tables,
    query head ``i`` reading kv head ``i // (Hq / KVH)``. Runs
    ``ops.flash.paged_attention`` (the B4 kernel on CUDA, its plain
    version on the CPU). Head-sharded meshes are a later slice (parallel
    axes)."""
    from .flash import paged_attention

    if mesh is not None:
        raise NotImplementedError(
            "paged attention over a mesh (head-sharded TP serving) is a "
            "later slice (parallel axes)")
    return paged_attention(q, k_pool, v_pool, tables, row_starts,
                           pad_lens, window=window, k_scale=k_scale,
                           v_scale=v_scale)
