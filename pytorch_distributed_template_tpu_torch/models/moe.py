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
- ``expert_act``: ``"gelu"`` (``wi``/``bi``, gelu, ``wo``/``bo``: the
  experts' FFN is ``ops/expert_ffn.py``, kernel B5 on the card) or
  ``"swiglu"`` (the Mixtral / sparse-Llama expert: ``silu(x wg) * (x wi)
  wo`` with a stacked gate ``wg [E, D, F]`` and no biases, three
  ``torch.bmm`` in the model dtype, as JAX computes three einsums outside
  any Pallas kernel).

Routing is global over the batch of the ``mesh`` passed to ``forward``
(the LM's): JAX's ``MoeMlp`` runs under SPMD on the global array,
so its capacity, its slot-order fill and the aux loss's means are over the
data x fsdp plane's whole batch, in global token order. A data shard
holds the global rows ``index::count`` (data/sampler.py: shard ``i`` takes
positions ``i::n`` of the sampler's order, and ``Mesh.data_shard`` is the
loaders' shard), so global row ``j n + i`` is row ``j`` of rank ``i``: the
order of the one-process batch, as JAX's one-host trainer sees it. Each
rank takes ``S`` and ``C`` from the global token count, all-gathers its
per-slot, per-expert, per-row counts of eligible tokens once, offsets each
row's cumsum by the eligible tokens of the global rows before it and keeps
a token when its global slot is under ``C``; the aux loss's ``me``, ``ce``
and valid count are summed over the plane with one differentiable
``psum``. Each rank then runs the experts on its own kept tokens only, in
local slots (``min(C, S_local)`` per expert): a token's output does not
depend on its slot number.

Expert parallelism (a mesh whose ``expert`` axis is X > 1, the stacked
leaves sliced to ``E / X`` experts by ``parallel/sharding.py`` from
:meth:`MoeMlp.partition_rules`): the batch is not sharded over ``expert``,
so the ranks of an expert group route the same tokens identically (the
router is replicated); each runs its experts' FFN on its slice of
``expert_in`` and combines a partial output, summed over the group by
Megatron's pair (``parallel/collectives.py``: ``copy_to`` on the expert
inputs and the gates, ``reduce_from`` on the output). The replicated
leaves' gradients come out equal on every rank of the group and the
expert leaves' are local; for the einsum arm this is the sum XLA's
all-to-all pair computes. ``"auto"`` dispatch picks ``"einsum"`` on such
a mesh, as JAX does. An expert count the axis does not divide stays
unsliced (the rules refuse it by name, as JAX's placement would fail).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..config.registry import MODELS
from ..ops.expert_ffn import expert_ffn
from ..parallel.collectives import all_gather, copy_to, psum, reduce_from
from ..parallel.sharding import P
from .layers import dropout


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
    """Top-k routed expert FFN (drop-in for the dense ``MlpBlock`` or the
    Llama family's ``SwiGLU``).

    ``forward(x [B, T, D], example_mask=None, seed=None, mesh=None) -> (y
    [B, T, D], aux)``: ``aux`` is the weighted load-balancing loss (a
    float32 scalar) in training mode with ``aux_loss_weight > 0``, else
    None. ``param_dtype`` (default float32, flax's) stores the expert
    leaves (a bf16 serving model stores them bf16); the router stays
    float32."""

    def __init__(self, d_model: int, d_ff: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 aux_loss_weight: float = 0.01, dropout: float = 0.0,
                 n_layer: int = 1, dtype=torch.float32,
                 expert_act: str = "gelu", dispatch_impl: str = "auto",
                 device=None, param_dtype=None):
        super().__init__()
        if expert_act not in ("gelu", "swiglu"):
            raise ValueError(f"expert_act={expert_act!r}; expected "
                             "'gelu'/'swiglu'")
        if dispatch_impl not in ("auto", "gather", "einsum"):
            raise ValueError(f"dispatch_impl={dispatch_impl!r}; expected "
                             "'auto'/'gather'/'einsum'")
        self.d_model, self.d_ff = d_model, d_ff
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.rate, self.n_layer, self.dtype = dropout, n_layer, dtype
        self.expert_act, self.dispatch_impl = expert_act, dispatch_impl
        e, f32 = num_experts, torch.float32
        pdt = param_dtype or f32
        self.router = nn.Linear(d_model, e, dtype=f32, device=device)

        def stack(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=pdt,
                                            device=device))

        self.wi = stack(e, d_model, d_ff)
        if expert_act == "swiglu":
            self.wg = stack(e, d_model, d_ff)
        self.wo = stack(e, d_ff, d_model)
        if expert_act == "gelu":
            self.bi = stack(e, d_ff)
            self.bo = stack(e, d_model)

    @staticmethod
    def partition_rules():
        """JAX's expert-parallel rules (``MoeMlp.partition_rules``) over the
        torch dimensions (the stacked expert leaves keep flax's layout; the
        router replicated on purpose)."""
        return [
            (r"moe/wi", P("expert", None, "tensor")),
            (r"moe/wg", P("expert", None, "tensor")),
            (r"moe/wo", P("expert", "tensor", None)),
            (r"moe/bi", P("expert", "tensor")),
            (r"moe/bo", P("expert", None)),
            (r"moe/router/weight", P()),
            (r"moe/router/bias", P()),
        ]

    def _experts(self, mesh):
        """``(group, first expert, local count)`` of this rank's experts:
        ``(None, 0, E)`` unless the stacked leaves hold a slice."""
        e_loc = self.wi.shape[0]
        if e_loc == self.num_experts:
            return None, 0, e_loc
        ep = mesh.axis("expert") if mesh is not None else None
        if ep is None or e_loc * ep.size != self.num_experts:
            raise ValueError(f"{e_loc} of {self.num_experts} experts held "
                             f"without an expert axis that splits them")
        return ep, ep.index * e_loc, e_loc

    def _ffn(self, expert_in):
        """The experts' FFN on ``expert_in [E_local, C, D]`` in the model
        dtype."""
        dt = self.dtype
        if self.expert_act == "gelu":
            return expert_ffn(expert_in.contiguous(), self.wi.to(dt),
                              self.wo.to(dt), self.bi.to(dt),
                              self.bo.to(dt))
        gate = torch.bmm(expert_in, self.wg.to(dt))
        up = torch.bmm(expert_in, self.wi.to(dt))
        return torch.bmm(F.silu(gate) * up, self.wo.to(dt))

    def forward(self, x, example_mask=None, seed=None, mesh=None):
        b, t, d = x.shape
        s_loc, e = b * t, self.num_experts
        k = min(self.top_k, e)
        batch = mesh.batch() if mesh is not None else None
        s = s_loc * (batch.size if batch is not None else 1)
        cap = capacity(s, e, k, self.capacity_factor)
        cap_l = min(cap, s_loc)       # a rank's kept tokens per expert
        ep, lo, e_loc = self._experts(mesh)
        dt = self.dtype
        dev = x.device
        xf = x.reshape(s_loc, d)
        if example_mask is not None:
            tok = example_mask.to(torch.float32)[:, None].expand(b, t)
            tok = tok.reshape(s_loc)
        else:
            tok = torch.ones(s_loc, dtype=torch.float32, device=dev)

        # routing, float32
        logits = F.linear(xf.float(), self.router.weight, self.router.bias)
        probs = torch.softmax(logits, dim=-1)                   # [S, E]
        gate_vals, gate_idx = top_k(probs, k)                   # [S, k]
        if k > 1:
            gate_vals = gate_vals / gate_vals.sum(
                -1, keepdim=True).clamp_min(1e-9)
        gate_vals = gate_vals * tok[:, None]

        use_gather = self.dispatch_impl == "gather" or (
            self.dispatch_impl == "auto"
            and not (mesh is not None and mesh.axis_size("expert") > 1))
        # capacity fill over the global batch: slot 0 for every token
        # first, then slot 1, in global token order; the one-hot is
        # [E, S] so the running count scans the inner axis
        valid = tok > 0
        experts = torch.arange(e, device=dev)[:, None]
        ohs = torch.stack([(experts == gate_idx[None, :, i]) & valid[None, :]
                           for i in range(k)])  # [k, E, S]; padding: none
        # the eligible tokens before each of this rank's rows in global
        # order, per slot and expert: [k, E, B]
        rows = ohs.view(k, e, b, t).sum(dim=-1)
        if batch is not None:
            n, r = batch.size, batch.index
            every = all_gather(rows[None], 0, batch.group)  # [n, k, E, B]
            flat = every.permute(1, 2, 3, 0).reshape(k, e, b * n)
            row_base = (torch.cumsum(flat, dim=-1) - flat)[..., r::n]
            total = flat.sum(dim=-1)
        else:
            row_base = torch.cumsum(rows, dim=-1) - rows
            total = rows.sum(dim=-1)
        before = (row_base[..., None] + torch.cumsum(
            ohs.view(k, e, b, t), dim=-1) - 1).view(k, e, s_loc)
        pos_s, keep_s = [], []
        gfill = torch.zeros(e, dtype=torch.int64, device=dev)
        lfill = torch.zeros(e, dtype=torch.int64, device=dev)
        for slot in range(k):
            idx = gate_idx[:, slot]
            oh = ohs[slot]
            keep = (before[slot] + gfill[:, None] < cap) & oh    # [E, S]
            pos = torch.cumsum(oh, dim=1) - 1 + lfill[:, None]
            pos_s.append(pos.gather(0, idx[None, :])[0])
            keep_s.append(keep.gather(0, idx[None, :])[0])
            gfill = torch.clamp(gfill + total[slot], max=cap)
            lfill = lfill + keep.sum(dim=1)

        aux = None
        if self.training and self.aux_loss_weight > 0:
            me = (probs * tok[:, None]).sum(0)                      # [E]
            ce = (F.one_hot(gate_idx[:, 0], e).float()
                  * tok[:, None]).sum(0)                            # [E]
            n = tok.sum()
            if batch is not None:
                stats = psum(torch.cat([me, ce, n[None]]), batch.group)
                me, ce, n = stats[:e], stats[e:2 * e], stats[2 * e]
            denom = n.clamp_min(1.0)
            aux = self.aux_loss_weight * (e * ((me / denom)
                                               * (ce / denom)).sum())

        # flat local slot per (token, slot); dropped tokens and tokens of
        # other ranks' experts name the scratch slot
        slots = e_loc * cap_l
        dst = torch.stack([
            torch.where(keep_s[i] & (gate_idx[:, i] >= lo)
                        & (gate_idx[:, i] < lo + e_loc),
                        (gate_idx[:, i] - lo) * cap_l + pos_s[i], slots)
            for i in range(k)], dim=1)                          # [S, k]
        xin = xf.to(dt)
        if ep is not None:
            # Megatron's f: each rank's experts give a part of dx and of
            # the gates' cotangent
            xin = copy_to(xin, ep.group)
            gate_vals = copy_to(gate_vals, ep.group)
        if use_gather:
            # inv: the token in each slot (s: empty)
            inv = torch.full((slots + 1,), s_loc, dtype=torch.int64,
                             device=dev)
            inv[dst.reshape(-1)] = torch.arange(
                s_loc, device=dev).repeat_interleave(k)
            expert_in = RowGather.apply(xin, inv[:slots], dst)
            expert_in = expert_in.reshape(e_loc, cap_l, d)
        else:
            # the GShard combine tensor [S, E_local, C]: one entry per
            # kept (token, slot); the scratch column is cut off
            w = gate_vals * torch.stack(keep_s, dim=1).float()
            combine = torch.zeros((s_loc, slots + 1), dtype=torch.float32,
                                  device=dev).scatter(1, dst, w)
            combine = combine[:, :slots].view(s_loc, e_loc, cap_l)
            dispatch = (combine > 0).to(dt)
            expert_in = torch.einsum("sec,sd->ecd", dispatch, xin)
        out = self._ffn(expert_in)
        if use_gather:
            # each (token, slot) reads its slot's output (dropped: zeros);
            # rev: the (token, slot) position reading each slot
            flat = dst.reshape(-1)
            rev = torch.full((slots + 1,), s_loc * k, dtype=torch.int64,
                             device=dev)
            rev[flat] = torch.arange(s_loc * k, device=dev)
            picked = RowGather.apply(out.reshape(slots, d), flat,
                                     rev[:slots, None]).view(s_loc, k, d)
            w = (gate_vals * torch.stack(keep_s, dim=1).float()).to(dt)
            y = (w[..., None] * picked).sum(dim=1)
        else:
            y = torch.einsum("sec,ecd->sd", combine.to(dt), out)
        if ep is not None:
            y = reduce_from(y, ep.group)     # Megatron's g
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
    _refuse_later(overrides.get("quant", ""), overrides.get("lora_rank", 0))
    return TransformerLM(
        vocab_size=vocab_size, n_layer=n_layer, n_head=n_head,
        d_model=d_model, max_len=max_len, dropout=dropout,
        dtype=_dtype(bfloat16), attn_impl=attn_impl, remat=remat,
        moe_experts=num_experts, moe_top_k=top_k, moe_every=moe_every,
        moe_capacity_factor=capacity_factor,
        moe_aux_loss_weight=aux_loss_weight, mesh=mesh, device=device,
        **overrides)


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
                d_ff: int = 0, kv_quant: str = "", device=None,
                param_dtype=None):
    """Small MoE config for tests and dry runs (``fused_head``, ``d_ff``
    and ``kv_quant`` beyond the JAX registry's, for the card-vs-CPU
    checks)."""
    return _moe_lm(vocab_size, n_layer, n_head, d_model, max_len, dropout,
                   num_experts, top_k, moe_every, capacity_factor,
                   aux_loss_weight, bfloat16, attn_impl, remat, mesh, device,
                   param_dtype, fused_head=fused_head, d_ff=d_ff,
                   kv_quant=kv_quant)
