"""Mixture-of-Experts FFN blocks and the MoE LM family in PyTorch.

Port of ``pytorch_distributed_template_tpu/models/moe.py`` (``MoeMlp``,
``MoeLM``, ``TinyMoeLM``), registered as ``MoeLM`` and ``TinyMoeLM`` with
the JAX registry's defaults.

:class:`MoeMlp` routes each token to its top-k experts and runs the
experts' FFNs on stacked weights (``wi [E, D, F]``, ``wo [E, F, D]``,
``bi [E, F]``, ``bo [E, D]``):

- the router and its softmax run in float32 (``router`` is an ``[E, D]``
  linear layer with bias); the top-k choice breaks ties toward the lower
  expert index, deterministically; top-k gates are renormalised when
  k > 1, while Switch (k = 1) keeps the raw top-1 probability so the
  router stays on the task gradient;
- capacity ``C = min(ceil(k S cf / E), S)`` slots per expert, filled in
  slot order (every token's first choice, then its second), in token
  order within a slot; tokens past an expert's capacity are dropped (the
  residual carries them);
- ``example_mask`` ([B] bool) marks padded examples: their tokens claim
  no slot and move none of the statistics;
- the Switch load-balancing loss ``E * sum(me * ce)`` over valid tokens,
  scaled by ``aux_loss_weight``, is returned beside the output in
  training mode (the flax module sows it into ``losses``);
- dispatch ``"gather"`` (slot indices, row gathers; ``"auto"``'s choice
  without an expert mesh) or ``"einsum"`` (the GShard one-hot
  dispatch/combine tensors ``[S, E, C]``), the same routing either way;
- the experts' FFN is ``ops/expert_ffn.py`` (kernel B5 on the card).

Refused by name: ``expert_act="swiglu"`` (the Mixtral / sparse-Llama
expert) and expert parallelism (a mesh with an ``expert`` axis, and with
it the einsum arm's all-to-all), both later slices.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..config.registry import MODELS
from ..ops.expert_ffn import expert_ffn
from .layers import dropout

_SLICE_SWIGLU = ("the swiglu expert (Mixtral / sparse Llama) is a later "
                 "slice (other model families)")
_SLICE_EXPERT_PARALLEL = ("expert parallelism (a mesh with an 'expert' "
                          "axis, the einsum arm's all-to-all) is a later "
                          "slice (parallel axes)")


class RowGather(torch.autograd.Function):
    """``[src; 0][idx]``: rows of ``src`` (``R`` rows; index ``R`` reads a
    zero row), differentiable in ``src`` through the inverse map ``rev``
    ``[R, J]``: row ``r`` was read at positions ``rev[r, :]`` (``M`` =
    ``len(idx)`` for none), so its gradient is a sum of ``J`` row gathers
    of the output gradient. The backward of plain advanced indexing is a
    sorted scatter-add, which runs serially over the positions that share
    a row: here the thousands of empty and dropped slots that all read the
    zero row."""

    @staticmethod
    def forward(ctx, src, idx, rev):
        ctx.save_for_backward(rev)
        return torch.cat([src, src.new_zeros((1, src.shape[1]))])[idx]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (rev,) = ctx.saved_tensors
        g_ext = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        grad = g_ext[rev[:, 0]]
        for j in range(1, rev.shape[1]):
            grad = grad + g_ext[rev[:, j]]
        return grad, None, None


def top_k(probs, k: int):
    """``(values, indices)`` of the ``k`` largest entries of each row of
    ``probs`` ``[S, E]``, largest first, in ``jax.lax.top_k``'s order: a
    tie goes to the lower index, and ``-0.0`` ranks below ``+0.0`` (the
    float32 bits are compared as a total order). Built from ``argmax``
    (which returns the first maximum): ``torch.topk`` on CUDA may resolve
    a tie at the k-th place differently from run to run, and one flipped
    route makes a training run irreproducible. Values stay
    differentiable."""
    bits = probs.detach().float().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = []
    for _ in range(k):
        i = key.argmax(dim=-1)
        idx.append(i)
        key = key.scatter(1, i[:, None], torch.iinfo(torch.int32).min)
    idx = torch.stack(idx, dim=1)
    return probs.gather(1, idx), idx


def capacity(tokens: int, num_experts: int, k: int,
             capacity_factor: float) -> int:
    """Slots per expert: ``min(max(ceil(k S cf / E), 1), S)``."""
    k = min(k, num_experts)
    cap = max(int(-(-k * tokens * capacity_factor // num_experts)), 1)
    return min(cap, tokens)


class MoeMlp(nn.Module):
    """Top-k routed expert FFN (drop-in for the dense ``MlpBlock``).

    ``forward(x [B, T, D], example_mask=None, seed=None) -> (y [B, T, D],
    aux)``: ``aux`` is the weighted load-balancing loss (a float32 scalar)
    in training mode with ``aux_loss_weight > 0``, else None."""

    def __init__(self, d_model: int, d_ff: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 aux_loss_weight: float = 0.01, dropout: float = 0.0,
                 n_layer: int = 1, dtype=torch.float32,
                 expert_act: str = "gelu", dispatch_impl: str = "auto",
                 mesh=None, device=None):
        super().__init__()
        if expert_act == "swiglu":
            raise NotImplementedError(_SLICE_SWIGLU)
        if expert_act != "gelu":
            raise ValueError(f"expert_act={expert_act!r}; expected "
                             "'gelu'/'swiglu'")
        if dispatch_impl not in ("auto", "gather", "einsum"):
            raise ValueError(f"dispatch_impl={dispatch_impl!r}; expected "
                             "'auto'/'gather'/'einsum'")
        if mesh is not None:
            raise NotImplementedError(_SLICE_EXPERT_PARALLEL)
        self.d_model, self.d_ff = d_model, d_ff
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.rate, self.n_layer, self.dtype = dropout, n_layer, dtype
        self.dispatch_impl = dispatch_impl
        e, f32 = num_experts, torch.float32
        self.router = nn.Linear(d_model, e, dtype=f32, device=device)
        self.wi = nn.Parameter(torch.zeros(e, d_model, d_ff, dtype=f32,
                                           device=device))
        self.wo = nn.Parameter(torch.zeros(e, d_ff, d_model, dtype=f32,
                                           device=device))
        self.bi = nn.Parameter(torch.zeros(e, d_ff, dtype=f32,
                                           device=device))
        self.bo = nn.Parameter(torch.zeros(e, d_model, dtype=f32,
                                           device=device))

    def forward(self, x, example_mask=None, seed=None):
        b, t, d = x.shape
        s, e = b * t, self.num_experts
        k = min(self.top_k, e)
        cap = capacity(s, e, k, self.capacity_factor)
        dt = self.dtype
        xf = x.reshape(s, d)
        if example_mask is not None:
            tok = example_mask.to(torch.float32)[:, None].expand(b, t)
            tok = tok.reshape(s)
        else:
            tok = torch.ones(s, dtype=torch.float32, device=x.device)

        # routing, float32
        logits = F.linear(xf.float(), self.router.weight, self.router.bias)
        probs = torch.softmax(logits, dim=-1)                   # [S, E]
        gate_vals, gate_idx = top_k(probs, k)                   # [S, k]
        if k > 1:
            gate_vals = gate_vals / gate_vals.sum(
                -1, keepdim=True).clamp_min(1e-9)
        gate_vals = gate_vals * tok[:, None]

        use_gather = self.dispatch_impl in ("auto", "gather")
        # capacity fill: slot 0 for every token first, then slot 1; the
        # one-hot is [E, S] so the running count scans the inner axis
        valid = tok > 0
        experts = torch.arange(e, device=x.device)[:, None]
        combine = None if use_gather else torch.zeros(
            (s, e, cap), dtype=torch.float32, device=x.device)
        pos_s, keep_s = [], []
        fill = torch.zeros(e, dtype=torch.int64, device=x.device)
        for slot in range(k):
            idx = gate_idx[:, slot]
            oh = (experts == idx[None, :]) & valid[None, :]  # padding: none
            pos = torch.cumsum(oh, dim=1) - 1 + fill[:, None]    # [E, S]
            keep = (pos < cap) & oh
            pos_s.append(pos.gather(0, idx[None, :])[0])
            keep_s.append(keep.gather(0, idx[None, :])[0])
            if combine is not None:
                combine = combine + (
                    gate_vals[:, slot, None, None]
                    * keep.t()[..., None].float()
                    * F.one_hot(torch.where(keep, pos, 0).t(), cap).float())
            fill = fill + keep.sum(dim=1)

        aux = None
        if self.training and self.aux_loss_weight > 0:
            denom = tok.sum().clamp_min(1.0)
            me = (probs * tok[:, None]).sum(0) / denom              # [E]
            ce = (F.one_hot(gate_idx[:, 0], e).float()
                  * tok[:, None]).sum(0) / denom                    # [E]
            aux = self.aux_loss_weight * (e * (me * ce).sum())

        slots = e * cap
        if use_gather:
            # flat slot per (token, slot); dropped ones name the scratch
            # slot e * cap. inv: the token in each slot (s: empty).
            dst = torch.stack([
                torch.where(keep_s[i], gate_idx[:, i] * cap + pos_s[i],
                            slots) for i in range(k)], dim=1)      # [S, k]
            inv = torch.full((slots + 1,), s, dtype=torch.int64,
                             device=x.device)
            inv[dst.reshape(-1)] = torch.arange(
                s, device=x.device).repeat_interleave(k)
            expert_in = RowGather.apply(xf.to(dt), inv[:slots], dst)
            expert_in = expert_in.reshape(e, cap, d)
        else:
            dispatch = (combine > 0).to(dt)                       # [S, E, C]
            expert_in = torch.einsum("sec,sd->ecd", dispatch, xf.to(dt))
        out = expert_ffn(expert_in.contiguous(), self.wi.to(dt),
                         self.wo.to(dt), self.bi.to(dt), self.bo.to(dt))
        if use_gather:
            # each (token, slot) reads its slot's output (dropped: zeros);
            # rev: the (token, slot) position reading each slot
            flat = dst.reshape(-1)
            rev = torch.full((slots + 1,), s * k, dtype=torch.int64,
                             device=x.device)
            rev[flat] = torch.arange(s * k, device=x.device)
            picked = RowGather.apply(out.reshape(slots, d), flat,
                                     rev[:slots, None]).view(s, k, d)
            w = (gate_vals * torch.stack(keep_s, dim=1).float()).to(dt)
            y = (w[..., None] * picked).sum(dim=1)
        else:
            y = torch.einsum("sec,ecd->sd", combine.to(dt), out)
        y = dropout(y, self.rate, seed, self.training)
        return y.reshape(b, t, d), aux


def _moe_lm(vocab_size, n_layer, n_head, d_model, max_len, dropout,
            num_experts, top_k, moe_every, capacity_factor, aux_loss_weight,
            bfloat16, attn_impl, remat, mesh, device, param_dtype,
            **overrides):
    from .transformer import (
        TransformerLM, _check_param_dtype, _dtype, _refuse_later,
    )

    _check_param_dtype(param_dtype)
    _refuse_later(overrides.pop("quant", ""), overrides.pop("kv_quant", ""),
                  overrides.pop("lora_rank", 0), mesh,
                  overrides.pop("seq_layout", "natural"))
    overrides.pop("lora_alpha", None)
    return TransformerLM(
        vocab_size=vocab_size, n_layer=n_layer, n_head=n_head,
        d_model=d_model, max_len=max_len, dropout=dropout,
        dtype=_dtype(bfloat16), attn_impl=attn_impl, remat=remat,
        moe_experts=num_experts, moe_top_k=top_k, moe_every=moe_every,
        moe_capacity_factor=capacity_factor,
        moe_aux_loss_weight=aux_loss_weight, device=device, **overrides)


@MODELS.register("MoeLM")
def moe_lm(vocab_size: int = 50257, n_layer: int = 12, n_head: int = 12,
           d_model: int = 768, max_len: int = 1024, dropout: float = 0.1,
           num_experts: int = 8, top_k: int = 2, moe_every: int = 2,
           capacity_factor: float = 1.25, aux_loss_weight: float = 0.01,
           bfloat16: bool = False, attn_impl: str = "xla",
           remat: bool = False, mesh=None, device=None, param_dtype=None,
           **overrides):
    """Decoder-only LM with MoE FFNs every ``moe_every``-th block
    (GShard-style interleaving; ``moe_every=1`` = every block)."""
    return _moe_lm(vocab_size, n_layer, n_head, d_model, max_len, dropout,
                   num_experts, top_k, moe_every, capacity_factor,
                   aux_loss_weight, bfloat16, attn_impl, remat, mesh, device,
                   param_dtype, **overrides)


@MODELS.register("TinyMoeLM")
def tiny_moe_lm(vocab_size: int = 256, n_layer: int = 2, n_head: int = 4,
                d_model: int = 64, max_len: int = 128, dropout: float = 0.0,
                num_experts: int = 4, top_k: int = 2, moe_every: int = 1,
                capacity_factor: float = 2.0, aux_loss_weight: float = 0.01,
                attn_impl: str = "xla", remat: bool = False, mesh=None,
                bfloat16: bool = False, fused_head: bool = False,
                d_ff: int = 0, device=None, param_dtype=None):
    """Small MoE config for tests and dry runs (``fused_head`` and
    ``d_ff`` beyond the JAX registry's, for the card-vs-CPU check)."""
    return _moe_lm(vocab_size, n_layer, n_head, d_model, max_len, dropout,
                   num_experts, top_k, moe_every, capacity_factor,
                   aux_loss_weight, bfloat16, attn_impl, remat, mesh, device,
                   param_dtype, fused_head=fused_head, d_ff=d_ff)
