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

Sequence parallelism (the JAX ``ring_attention`` and ``ulysses_attention``)
over the mesh's ``seq`` axis: each rank holds its own ``[B, Tl, H, D]``
shard of q, k and v (``Tl = T / S``), never the whole sequence.

- Ring: K/V blocks rotate around the seq group (``parallel.collectives.
  ppermute``, compact GQA K/V on the wire) while the rank's queries
  accumulate the blocks' partial results. Four bodies, as in JAX: einsum
  and flash blocks, each in the contiguous layout (shard ``i`` holds
  positions ``[i Tl, (i + 1) Tl)``) and in the zigzag layout (shard ``i``
  holds chunks ``i`` and ``2S - 1 - i`` of ``2S``, which balances the
  causal triangle). Flash blocks go through ``ops.flash.
  flash_attention_lse`` (kernel B1 forward, B2/B3 backward with the lse
  cotangent on the card) and merge by logsumexp (:func:`_merge_blocks`);
  einsum blocks keep an online-softmax accumulator (:func:`_online_update`).
  A windowed causal contiguous ring stops after
  :func:`_ring_steps_needed` hops (the banded-skip schedule), its blocks at
  the band's edge running as masked einsum blocks.
- Ulysses: one all-to-all turns the sequence shard into a head shard, the
  whole sequence's attention runs locally, one all-to-all turns it back.

Each body's per-step work is one function, shared by the process-group
path (:func:`ring_attention`, :func:`ulysses_attention`: a collective
between steps) and a one-process path over ``S`` shards held in a list
(:func:`ring_attention_shards`, :func:`ulysses_attention_shards`: the
exchange is a list rotation or a reshape), which the tests and the smoke
run's one-card phase call; no entry point uses it. Every rank runs every
ring step and issues the same permutes in the same order: a block a causal
mask hides entirely still runs and merges as a no-op (its lse is
``NEG_INF``), so ranks never branch around a collective. Where JAX falls
back to dense attention because a rank would not hold whole shards (T not
divisible by S, too few heads for Ulysses) the port raises ``ValueError``
naming the constraint; with ``S == 1`` it computes JAX's dense function.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30
SP_IMPLS = ("ring", "ring_flash", "ulysses", "ulysses_flash")


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
            "later slice (parallel axes, ROADMAP A11b)")
    return paged_attention(q, k_pool, v_pool, tables, row_starts,
                           pad_lens, window=window, k_scale=k_scale,
                           v_scale=v_scale)


# ---------------------------------------------------------------------------
# Sequence parallelism: ring and Ulysses attention over the seq axis
# ---------------------------------------------------------------------------

def zigzag_perm(t: int, s: int) -> np.ndarray:
    """Natural -> zigzag permutation for ``s`` ring shards (the JAX
    function): ``2s`` chunks of ``t // (2s)``, shard ``i`` holding chunks
    ``(i, 2s-1-i)``; ``x[:, perm]`` is the zigzag layout, ``np.argsort``
    inverts it."""
    if t % (2 * s) != 0:
        raise ValueError(f"t={t} not divisible by 2*s={2 * s}")
    c = t // (2 * s)
    parts = []
    for i in range(s):
        parts.append(np.arange(i * c, (i + 1) * c))
        j = 2 * s - 1 - i
        parts.append(np.arange(j * c, (j + 1) * c))
    return np.concatenate(parts)


def seq_positions(t: int, s: int, index: int,
                  layout: str = "contig") -> np.ndarray:
    """The global positions of a length-``t`` row that seq shard ``index``
    of ``s`` holds, in its order: ``[index Tl, (index + 1) Tl)`` contig, or
    its two zigzag chunks."""
    if t % s:
        raise ValueError(
            f"sequence length {t} is not divisible by the seq axis ({s}): "
            "every rank holds a whole shard of T / seq positions")
    tl = t // s
    if layout == "zigzag":
        return zigzag_perm(t, s)[index * tl:(index + 1) * tl]
    return np.arange(index * tl, (index + 1) * tl)


@dataclass(frozen=True)
class SeqShard:
    """Which positions of the ``[B, length]`` rows a rank's outputs hold:
    ``positions`` (``[Tl]`` int64, on the outputs' device, in output
    order), and the rank's ``index`` on the seq axis."""
    positions: torch.Tensor
    length: int
    index: int


def seq_plan(mesh, attn_impl: str, seq_layout: str, t: int, device,
             zigzag_ok: bool = True):
    """``(shard, layout)`` for a ``[B, t]`` row on this rank: ``(None,
    "contig")`` without a seq axis > 1; else the rank's :class:`SeqShard`
    and the ring's layout. ``zigzag`` applies as the JAX models apply it:
    to the ring impls when ``t`` divides into ``2 S`` chunks (and
    ``zigzag_ok``: not for a windowed model)."""
    s = 1 if mesh is None else mesh.axis_size("seq")
    if s == 1:
        return None, "contig"
    if attn_impl not in SP_IMPLS:
        raise ValueError(
            f"a seq axis of {s} needs a sequence-parallel attn_impl "
            f"{SP_IMPLS}: a rank holds only its shard of the sequence; got "
            f"{attn_impl!r}")
    zigzag = (seq_layout == "zigzag" and zigzag_ok
              and attn_impl in ("ring", "ring_flash") and t % (2 * s) == 0)
    layout = "zigzag" if zigzag else "contig"
    index = mesh.axis_index("seq")
    pos = torch.as_tensor(seq_positions(t, s, index, layout),
                          device=device)
    return SeqShard(pos, t, index), layout


def _online_update(m, l, o, scores, vb):
    """One key block into the running max / normaliser ``[B, H, Tq]`` and
    output ``[B, H, Tq, D]`` (the JAX function): ``scores`` ``[B, H, Tq,
    Tk]``, ``vb`` ``[B, Tk, H, D]``."""
    blk_max = scores.amax(dim=-1)
    m_new = torch.maximum(m, blk_max)
    p = torch.exp(scores - m_new[..., None])
    scale = torch.exp(m - m_new)
    l_new = l * scale + p.sum(dim=-1)
    o_new = o * scale[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                vb.float())
    return m_new, l_new, o_new


def _merge_blocks(o, lse, o_b, lse_b):
    """Merge two partials over disjoint key blocks (the JAX function):
    ``o``/``o_b`` ``[B, T, H, D]`` (``o`` float32), ``lse``/``lse_b`` ``[B,
    H, T]``. A partial with ``lse_b == NEG_INF`` merges as a no-op."""
    lse_new = torch.logaddexp(lse, lse_b)
    w = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
    w_b = torch.exp(lse_b - lse_new).transpose(1, 2)[..., None]
    return o * w + o_b.float() * w_b, lse_new


def _expand_kv(x, groups: int):
    """GQA: compact ``[B, T, KVH, D]`` K/V broadcast to the query heads
    (``jnp.repeat`` along the head axis)."""
    return x if groups == 1 else x.repeat_interleave(groups, dim=2)


def _einsum_block_lse(q, kb, vb, visible):
    """``(out [B, T, H, D] f32, lse [B, H, T])`` of one block under an
    explicit ``[Tq, Tk]`` mask (the JAX function): the band-edge blocks of
    the windowed flash ring. Fully masked rows get ``lse = NEG_INF``."""
    d = q.shape[-1]
    qf = q.float() * (d ** -0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float())
    scores = scores.masked_fill(~visible[None, None], NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bhqd", p, vb.float())
    o = o / l.clamp_min(1e-30)[..., None]
    lse = torch.where(m <= NEG_INF / 2, torch.full_like(m, NEG_INF),
                      m + torch.log(l.clamp_min(1e-30)))
    return o.transpose(1, 2), lse


def _ring_steps_needed(tl: int, axis_size: int, window: int) -> int:
    """Ring steps holding any in-band key for a causal ``window`` (the JAX
    function): a block at ring distance ``t`` is out of the band once
    ``t tl - (tl - 1) >= window``."""
    if window <= 0:
        return axis_size
    return min(axis_size, (window + tl - 2) // tl + 1)


def _positions(start: int, n: int, device):
    return start + torch.arange(n, device=device)


class _ContigEinsum:
    """Contiguous ring, einsum blocks with an online-softmax accumulator
    (JAX ``_ring_attention_local``); ``window`` bands every block."""

    def __init__(self, s, tl, causal, window, groups):
        self.s, self.causal, self.window, self.groups = (s, causal, window,
                                                         groups)
        self.n = _ring_steps_needed(tl, s, window) if causal else s

    def init(self, q, k, v, my):
        b, tl, h, d = q.shape
        dev = q.device
        qf = q.float() * (d ** -0.5)
        carry = (qf, torch.full((b, h, tl), NEG_INF, device=dev),
                 torch.zeros((b, h, tl), device=dev),
                 torch.zeros((b, h, tl, d), device=dev))
        return self.step(carry, q, k, v, my, 0)

    def step(self, carry, q, kb, vb, my, t):
        qf, m, l, o = carry
        tl = q.shape[1]
        src = (my - t) % self.s
        q_pos = _positions(my * tl, tl, q.device)[:, None]
        k_pos = _positions(src * tl, tl, q.device)[None, :]
        scores = torch.einsum("bqhd,bkhd->bhqk", qf,
                              _expand_kv(kb, self.groups).float())
        visible = None
        if self.causal:
            visible = q_pos >= k_pos
        if self.window > 0:
            band = q_pos - k_pos < self.window
            visible = band if visible is None else visible & band
        if visible is not None:
            scores = scores.masked_fill(~visible[None, None], NEG_INF)
        m, l, o = _online_update(m, l, o, scores,
                                 _expand_kv(vb, self.groups))
        return qf, m, l, o

    def finish(self, carry, dtype):
        _, _, l, o = carry
        out = o / l.clamp_min(1e-30)[..., None]
        return out.transpose(1, 2).to(dtype)


class _ContigFlash:
    """Contiguous ring, flash blocks merged by logsumexp (JAX
    ``_ring_attention_local_flash``): step 0 the diagonal block (causal,
    banded inside the kernel); later blocks fully visible or, wrapped from
    a later shard, masked through ``lse = NEG_INF``. Causal with a window:
    the ring stops after :func:`_ring_steps_needed` steps, distances inside
    the band run maskless flash blocks and the ones straddling its edge
    masked einsum blocks (:func:`_einsum_block_lse`)."""

    def __init__(self, s, tl, causal, window, groups):
        self.s, self.tl, self.causal, self.window = s, tl, causal, window
        self.groups = groups
        self.banded = window > 0 and causal
        self.n = _ring_steps_needed(tl, s, window) if self.banded else s

    def is_edge(self, t: int) -> bool:
        return self.banded and t * self.tl + self.tl - 1 >= self.window

    def init(self, q, k, v, my):
        from .flash import flash_attention_lse

        out0, lse0 = flash_attention_lse(q, k, v, causal=self.causal,
                                         window=self.window)
        return out0.float(), lse0

    def step(self, carry, q, kb, vb, my, t):
        from .flash import flash_attention_lse

        o, lse = carry
        tl = q.shape[1]
        src = (my - t) % self.s
        if self.is_edge(t):
            q_pos = _positions(my * tl, tl, q.device)[:, None]
            k_pos = _positions(src * tl, tl, q.device)[None, :]
            # a wrapped source (src > my) is masked out by the positions
            visible = (q_pos >= k_pos) & (q_pos - k_pos < self.window)
            out_b, lse_b = _einsum_block_lse(
                q, _expand_kv(kb, self.groups),
                _expand_kv(vb, self.groups), visible)
        else:
            out_b, lse_b = flash_attention_lse(q, kb, vb, causal=False)
            if self.causal and not src < my:
                lse_b = torch.full_like(lse_b, NEG_INF)
        return _merge_blocks(o, lse, out_b, lse_b)

    def finish(self, carry, dtype):
        return carry[0].to(dtype)


def _halves(x):
    c = x.shape[1] // 2
    return x[:, :c].contiguous(), x[:, c:].contiguous()


class _ZigzagFlash:
    """Zigzag ring, flash quarter blocks (JAX
    ``_ring_attention_zigzag_local_flash``): step 0 runs three quarter
    blocks (the two chunk diagonals, causal, and hi x lo), every later step
    two maskless ones: ``q_hi x k_lo`` and, for a source before this shard,
    ``q_lo x k_lo``, else ``q_hi x k_hi``."""

    def __init__(self, s, tl, causal, window, groups):
        self.s, self.n = s, s

    def init(self, q, k, v, my):
        from .flash import flash_attention_lse

        q_lo, q_hi = _halves(q)
        k_lo, k_hi = _halves(k)
        v_lo, v_hi = _halves(v)
        o_ll, l_ll = flash_attention_lse(q_lo, k_lo, v_lo, causal=True)
        o_hl, l_hl = flash_attention_lse(q_hi, k_lo, v_lo, causal=False)
        o_hh, l_hh = flash_attention_lse(q_hi, k_hi, v_hi, causal=True)
        o_hi, l_hi = _merge_blocks(o_hl.float(), l_hl, o_hh, l_hh)
        return q_lo, q_hi, o_ll.float(), l_ll, o_hi, l_hi

    def step(self, carry, q, kb, vb, my, t):
        from .flash import flash_attention_lse

        q_lo, q_hi, o_lo, l_lo, o_hi, l_hi = carry
        before = (my - t) % self.s < my
        k_lo, k_hi = _halves(kb)
        v_lo, v_hi = _halves(vb)
        e1_o, e1_l = flash_attention_lse(q_hi, k_lo, v_lo, causal=False)
        if before:
            e2_o, e2_l = flash_attention_lse(q_lo, k_lo, v_lo, causal=False)
        else:
            e2_o, e2_l = flash_attention_lse(q_hi, k_hi, v_hi, causal=False)
        o_hi, l_hi = _merge_blocks(o_hi, l_hi, e1_o, e1_l)
        if before:
            o_lo, l_lo = _merge_blocks(o_lo, l_lo, e2_o, e2_l)
        else:
            o_hi, l_hi = _merge_blocks(o_hi, l_hi, e2_o, e2_l)
        return q_lo, q_hi, o_lo, l_lo, o_hi, l_hi

    def finish(self, carry, dtype):
        return torch.cat([carry[2], carry[4]], dim=1).to(dtype)


class _ZigzagEinsum:
    """Zigzag ring, einsum quarter blocks with an online-softmax
    accumulator (JAX ``_ring_attention_zigzag_local``): step 0 the local
    block under its position mask, every later step two fully visible
    quarter blocks."""

    def __init__(self, s, tl, causal, window, groups):
        self.s, self.n, self.groups = s, s, groups

    def init(self, q, k, v, my):
        b, tl, h, d = q.shape
        c = tl // 2
        qf = q.float() * (d ** -0.5)
        q_pos = torch.cat([
            _positions(my * c, c, q.device),
            _positions((2 * self.s - 1 - my) * c, c, q.device)])
        scores = torch.einsum("bqhd,bkhd->bhqk", qf,
                              _expand_kv(k, self.groups).float())
        visible = q_pos[:, None] >= q_pos[None, :]
        scores = scores.masked_fill(~visible[None, None], NEG_INF)
        m = scores.amax(dim=-1)
        p = torch.exp(scores - m[..., None])
        l = p.sum(dim=-1)
        o = torch.einsum("bhqk,bkhd->bhqd", p,
                         _expand_kv(v, self.groups).float())
        return qf, m, l, o

    def step(self, carry, q, kb, vb, my, t):
        qf, m, l, o = carry
        c = q.shape[1] // 2
        before = (my - t) % self.s < my
        kbx = _expand_kv(kb, self.groups).float()
        vbx = _expand_kv(vb, self.groups)
        k_lo, k_hi = kbx[:, :c], kbx[:, c:]
        v_lo, v_hi = vbx[:, :c], vbx[:, c:]
        q_lo, q_hi = qf[:, :c], qf[:, c:]
        e1 = torch.einsum("bqhd,bkhd->bhqk", q_hi, k_lo)
        if before:
            e2 = torch.einsum("bqhd,bkhd->bhqk", q_lo, k_lo)
        else:
            e2 = torch.einsum("bqhd,bkhd->bhqk", q_hi, k_hi)
        m_lo, l_lo, o_lo = m[..., :c], l[..., :c], o[..., :c, :]
        m_hi, l_hi, o_hi = m[..., c:], l[..., c:], o[..., c:, :]
        m_hi, l_hi, o_hi = _online_update(m_hi, l_hi, o_hi, e1, v_lo)
        if before:
            m_lo, l_lo, o_lo = _online_update(m_lo, l_lo, o_lo, e2, v_lo)
        else:
            m_hi, l_hi, o_hi = _online_update(m_hi, l_hi, o_hi, e2, v_hi)
        return (qf, torch.cat([m_lo, m_hi], dim=-1),
                torch.cat([l_lo, l_hi], dim=-1),
                torch.cat([o_lo, o_hi], dim=-2))

    def finish(self, carry, dtype):
        _, _, l, o = carry
        out = o / l.clamp_min(1e-30)[..., None]
        return out.transpose(1, 2).to(dtype)


def _ring_body(s: int, q, k, v, causal: bool, layout: str,
               block_impl: str, window: int):
    """The ring body for ``s`` shards of ``q``'s shape, after JAX
    ``ring_attention``'s checks."""
    groups = _gqa_groups(q, k, v)
    tl = q.shape[1]
    if layout not in ("contig", "zigzag"):
        raise ValueError(f"layout={layout!r}; expected 'contig' or "
                         "'zigzag'")
    zigzag = layout == "zigzag"
    if zigzag and (not causal or tl % 2):
        raise ValueError(
            "layout='zigzag' needs causal=True and T divisible by "
            f"2*seq ({2 * s}); got causal={causal}, T={tl * s}")
    if zigzag and window > 0:
        raise ValueError(
            "layout='zigzag' does not compose with window (sliding-window "
            "attention): the band already load-balances the causal "
            "triangle, so use layout='contig', which also enables the "
            "banded-skip early ring exit")
    if block_impl not in ("einsum", "flash"):
        raise ValueError(f"block_impl={block_impl!r}; expected 'einsum' or "
                         "'flash'")
    # the flash body's banded-skip schedule is causal-only; a non-causal
    # band runs the einsum body, as in JAX
    flash = block_impl == "flash" and not (window > 0 and not causal)
    cls = ({(False, False): _ContigEinsum, (False, True): _ContigFlash,
            (True, False): _ZigzagEinsum, (True, True): _ZigzagFlash}
           [(zigzag, flash)])
    return cls(s, tl, causal, window, groups)


def _dense(q, k, v, causal: bool, window: int, flash: bool):
    """JAX's ``dense()`` for a seq axis of 1: the flash kernel path for the
    ``*_flash`` impls (compact K/V), else the einsum attention."""
    if flash:
        from .flash import flash_attention

        return flash_attention(q, k, v, causal=causal, window=window)
    groups = _gqa_groups(q, k, v)
    return multihead_attention(q, _expand_kv(k, groups),
                               _expand_kv(v, groups), causal=causal,
                               window=window)


def _ring_group(body, q, k, v, group, my: int):
    from ..parallel.collectives import ppermute

    carry = body.init(q, k, v, my)
    kv = torch.stack([k, v])   # compact K/V, one permute per step
    for t in range(1, body.n):
        kv = ppermute(kv, group)
        carry = body.step(carry, q, kv[0], kv[1], my, t)
    return body.finish(carry, q.dtype)


def _ring_local(body, qs, ks, vs):
    s = len(qs)
    carries = [body.init(qs[i], ks[i], vs[i], i) for i in range(s)]
    kvs = [torch.stack([k, v]) for k, v in zip(ks, vs)]
    for t in range(1, body.n):
        kvs = [kvs[(i - 1) % s] for i in range(s)]   # i receives i - 1's
        carries = [body.step(carries[i], qs[i], kvs[i][0], kvs[i][1], i, t)
                   for i in range(s)]
    return [body.finish(c, q.dtype) for c, q in zip(carries, qs)]


def ring_attention(q, k, v, mesh=None, causal: bool = True,
                   layout: str = "contig", block_impl: str = "einsum",
                   window: int = 0):
    """Ring attention over ``mesh``'s ``seq`` group (JAX
    ``ring_attention``). q ``[B, Tl, H, D]``, k/v ``[B, Tl, KVH, D]``: this
    rank's shard, in ``layout`` (``"contig"`` or ``"zigzag"``: causal only,
    no window). ``block_impl`` ``"flash"`` (B1-B3) or ``"einsum"``. Returns
    the shard's output ``[B, Tl, H, D]`` in the input dtype. A seq axis of
    1 (or no mesh) computes the whole attention here."""
    s = 1 if mesh is None else mesh.axis_size("seq")
    if s == 1:
        return _dense(q, k, v, causal, window, block_impl == "flash")
    body = _ring_body(s, q, k, v, causal, layout, block_impl, window)
    return _ring_group(body, q, k, v, mesh.group("seq"),
                       mesh.axis_index("seq"))


def ring_attention_shards(qs, ks, vs, causal: bool = True,
                          layout: str = "contig", block_impl: str = "einsum",
                          window: int = 0):
    """:func:`ring_attention` for ``S = len(qs)`` shards held in one
    process (lists in seq-rank order): the same per-step work, the K/V
    exchange a list rotation. For tests and the smoke run."""
    if len(qs) == 1:
        return [_dense(qs[0], ks[0], vs[0], causal, window,
                       block_impl == "flash")]
    body = _ring_body(len(qs), qs[0], ks[0], vs[0], causal, layout,
                      block_impl, window)
    return _ring_local(body, qs, ks, vs)


def _ulysses_prepare(s: int, q, k, v):
    """JAX ``ulysses_attention``'s head split: the query heads must divide
    by ``s``; compact K/V cross the all-to-all when their heads do too,
    else they are expanded first."""
    groups = _gqa_groups(q, k, v)
    if q.shape[2] % s:
        raise ValueError(
            f"ulysses attention needs the query heads ({q.shape[2]}) "
            f"divisible by the seq axis ({s}): each rank attends over its "
            "H / seq heads")
    if groups > 1 and k.shape[2] % s:
        k, v = _expand_kv(k, groups), _expand_kv(v, groups)
    return k, v


def _ulysses_inner(q, k, v, causal: bool, window: int, inner: str):
    if inner not in ("xla", "flash"):
        raise ValueError(f"inner={inner!r}; expected 'xla' or 'flash'")
    return _dense(q, k, v, causal, window, inner == "flash")


def ulysses_attention(q, k, v, mesh=None, causal: bool = True,
                      inner: str = "xla", window: int = 0):
    """All-to-all sequence parallelism (JAX ``ulysses_attention``): this
    rank's ``[B, Tl, H, D]`` shard becomes ``[B, T, H / S, D]`` by one
    all-to-all per tensor, attention runs over the whole sequence
    (``inner`` ``"flash"``: B1-B3, or ``"xla"``: einsum), and one
    all-to-all restores the shard."""
    s = 1 if mesh is None else mesh.axis_size("seq")
    if s == 1:
        return _ulysses_inner(q, k, v, causal, window, inner)
    from ..parallel.collectives import all_to_all

    k, v = _ulysses_prepare(s, q, k, v)
    group = mesh.group("seq")
    q, k, v = (all_to_all(x, group, 2, 1) for x in (q, k, v))
    out = _ulysses_inner(q, k, v, causal, window, inner)
    return all_to_all(out, group, 1, 2)


def ulysses_attention_shards(qs, ks, vs, causal: bool = True,
                             inner: str = "xla", window: int = 0):
    """:func:`ulysses_attention` for ``S`` shards held in one process: the
    all-to-alls are reshapes (``collectives.all_to_all_local``)."""
    from ..parallel.collectives import all_to_all_local

    s = len(qs)
    if s == 1:
        return [_ulysses_inner(qs[0], ks[0], vs[0], causal, window, inner)]
    pairs = [_ulysses_prepare(s, q, k, v) for q, k, v in zip(qs, ks, vs)]
    ks, vs = [p[0] for p in pairs], [p[1] for p in pairs]
    qs, ks, vs = (all_to_all_local(xs, 2, 1) for xs in (qs, ks, vs))
    outs = [_ulysses_inner(q, k, v, causal, window, inner)
            for q, k, v in zip(qs, ks, vs)]
    return all_to_all_local(outs, 1, 2)


def sequence_attention(q, k, v, attn_impl: str, mesh, causal: bool = True,
                       layout: str = "contig", window: int = 0):
    """The models' dispatch of the sequence-parallel impls (``ring``,
    ``ring_flash``, ``ulysses``, ``ulysses_flash``) on this rank's shard;
    compact GQA K/V."""
    if mesh is None:
        raise ValueError(f"attn_impl={attn_impl!r} requires a mesh")
    if attn_impl in ("ring", "ring_flash"):
        return ring_attention(
            q, k, v, mesh, causal=causal, layout=layout,
            block_impl="flash" if attn_impl == "ring_flash" else "einsum",
            window=window)
    if attn_impl in ("ulysses", "ulysses_flash"):
        return ulysses_attention(
            q, k, v, mesh, causal=causal,
            inner="flash" if attn_impl == "ulysses_flash" else "xla",
            window=window)
    raise ValueError(f"attn_impl={attn_impl!r} is not sequence-parallel "
                     f"{SP_IMPLS}")
