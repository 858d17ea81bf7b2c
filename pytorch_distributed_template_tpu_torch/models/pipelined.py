"""Pipeline-parallel causal LMs (the trunk streamed through ``pipe``
stages): the port of the JAX package's ``models/pipelined.py``
(``PipelinedLM``, ``PipelinedLlama``, ``stack_dense_params``,
``stack_dense_llama_params``), registered as ``GPT2Pipelined``,
``PipelinedLM``, ``LlamaPipelined`` and ``TinyPipeLM`` with the JAX
registry's defaults.

- The embedding, the final norm and the head live outside the pipeline
  and replicate over ``pipe``; the ``n_layer`` homogeneous blocks are
  stacked parameter tensors under the flax names (``qkv_k [L, D, 3D]``,
  ``ln1_g [L, D]``, ...; kernels in flax's ``[in, out]`` layout), created
  ``[L, ...]`` for GPipe and directly in the interleaved ``[S, V, Lc,
  ...]`` layout for ``n_chunks = V > 1`` (:func:`_stacked_lead`), with the
  flax module's init scales. :meth:`partition_rules` places them on
  ``pipe`` (dim 0), so ``models.base.inject_mesh`` leaves each rank its
  stage's slice (parallel/sharding.py); a sharded model loads whole
  tensors by cutting them to its slice (:meth:`load_state_dict`).
- The block math is the JAX functions' (``_block_apply``: pre-LN, causal
  multi-head attention, tanh-GeLU MLP; ``_llama_block_apply``: pre-RMSNorm,
  RoPE GQA attention, SwiGLU), over ``ops.attention.multihead_attention``
  (the plain einsum attention the JAX trunk calls, not a kernel).
- ``bfloat16``: float32 master weights cast at use, the residual stream
  in bf16, the norms in float32, as in the flax modules.
- The batch splits into ``n_microbatches`` (``_microbatch``); on a mesh
  with a pipe axis the trunk runs ``parallel.pipeline.pipeline_apply``'s
  schedule (``n_stages`` must equal the axis), else the layers in order
  over all the microbatches at once (JAX vmaps them: each row is computed
  alone either way).
- ``remat``: each tick's stage (on a pipe axis) or each layer (without)
  runs under ``torch.utils.checkpoint`` (non-reentrant) while gradients
  are on, JAX's ``nothing_saveable``; the permutes and the output sum stay
  outside it, so a recompute sends nothing.
- ``fused_head``: ``(hidden, head_w [D, V])`` in the compute dtype for the
  chunked loss (engine/losses.py); the GPT-2 head is tied to ``wte``.
- No dropout in the pipelined trunk, as in JAX.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..config.registry import MODELS
from ..ops.attention import multihead_attention
from ..parallel.sharding import P, placed_on, slice_placed
from .layers import embed
from .llama import apply_rope, rope_tables
from .transformer import _GPT2_SIZES, _check_param_dtype, _dtype


def _layer_norm(x, g, b, eps: float = 1e-5):
    """LayerNorm in float32, cast back to ``x``'s dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(),
                        eps).to(x.dtype)


def _rms_norm(x, g, eps: float = 1e-6):
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (y * g).to(x.dtype)


def _dense(x, k, b=None):
    """``x @ k (+ b)`` in ``x``'s dtype over a ``[in, out]`` kernel."""
    return F.linear(x, k.to(x.dtype).t(),
                    None if b is None else b.to(x.dtype))


def _block_apply(p, x, n_head: int):
    """One pre-LN GPT-2 block from a dict of raw tensors."""
    b, t, d = x.shape
    h = _layer_norm(x, p["ln1_g"], p["ln1_b"])
    qkv = _dense(h, p["qkv_k"], p["qkv_b"]).reshape(b, t, 3, n_head,
                                                    d // n_head)
    ctx = multihead_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                              causal=True).reshape(b, t, d)
    x = x + _dense(ctx, p["out_k"], p["out_b"])
    h = _layer_norm(x, p["ln2_g"], p["ln2_b"])
    y = F.gelu(_dense(h, p["up_k"], p["up_b"]), approximate="tanh")
    return x + _dense(y, p["down_k"], p["down_b"])


def _llama_block_apply(p, x, cos, sin, n_head: int, n_kv_head: int,
                       eps: float = 1e-6):
    """One Llama block (pre-RMSNorm, RoPE GQA attention, SwiGLU) from a
    dict of raw tensors."""
    b, t, d = x.shape
    hd = d // n_head
    h = _rms_norm(x, p["ln1_g"], eps)
    q = _dense(h, p["q_k"]).reshape(b, t, n_head, hd)
    k = _dense(h, p["k_k"]).reshape(b, t, n_kv_head, hd)
    v = _dense(h, p["v_k"]).reshape(b, t, n_kv_head, hd)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    groups = n_head // n_kv_head
    if groups > 1:
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    ctx = multihead_attention(q, k, v, causal=True).reshape(b, t, d)
    x = x + _dense(ctx, p["o_k"])
    h = _rms_norm(x, p["ln2_g"], eps)
    return x + _dense(F.silu(_dense(h, p["gate_k"])) * _dense(h, p["up_k"]),
                      p["down_k"])


def _stacked_lead(n_layer: int, n_stages: int, n_chunks: int) -> tuple:
    """Leading dims of the stacked trunk params: ``(L,)`` for
    ``n_chunks == 1`` (``P('pipe')`` then cuts the S contiguous stages),
    else ``(S, V, L/(S*V))``, entry ``[s, v]`` virtual stage ``v*S + s``."""
    if n_layer % (n_stages * n_chunks):
        raise ValueError(f"n_layer {n_layer} not divisible by "
                         f"n_stages*n_chunks {n_stages * n_chunks}")
    if n_chunks == 1:
        return (n_layer,)
    return (n_stages, n_chunks, n_layer // (n_stages * n_chunks))


def _microbatch(x, n_microbatches: int):
    """``[B, ...] -> [M, B/M, ...]``, M at most the batch."""
    b = x.shape[0]
    m = min(n_microbatches, b)
    if b % m:
        raise ValueError(f"batch {b} not divisible by n_microbatches {m}")
    return x.reshape((m, b // m) + tuple(x.shape[1:]))


def _run_trunk(blocks: dict, micro, mesh, n_stages: int, n_chunks: int,
               remat: bool, layer_fn, extras=(), sharded: bool = False):
    """The trunk over ``micro`` (``[M, mb, T, D]``): ``pipeline_apply`` on
    a mesh with a pipe axis, else every layer in layer order.
    ``layer_fn(p_layer, x, extras) -> x`` applies one layer; ``blocks``
    holds ``[L, ...]`` or ``[S, V, Lc, ...]`` tensors, whole, or this
    rank's pipe slice when ``sharded``."""
    from ..parallel.pipeline import pipeline_apply, regroup_for_pipeline

    grad = torch.is_grad_enabled()
    if mesh is not None and mesh.axis_size("pipe") > 1:
        if mesh.axis_size("pipe") != n_stages:
            raise ValueError(f"n_stages {n_stages} on a pipe axis of "
                             f"{mesh.axis_size('pipe')}")

        def stage_fn(p_chunk, mb, ex, _rng):
            for i in range(next(iter(p_chunk.values())).shape[0]):
                mb = layer_fn({k: a[i] for k, a in p_chunk.items()}, mb, ex)
            return mb

        if remat and grad:
            def run(p_chunk, mb, ex, rng):
                return checkpoint(stage_fn, p_chunk, mb, ex, rng,
                                  use_reentrant=False)
        else:
            run = stage_fn
        if n_chunks > 1 or sharded:
            # [S, V, Lc] stacks (whole, or this rank's [1, V, Lc]); a
            # rank's GPipe slice [L/S] is its one stage
            staged = blocks if n_chunks > 1 else {k: a[None] for k, a in
                                                  blocks.items()}
        else:
            staged = regroup_for_pipeline(blocks, n_stages, 1)
        return pipeline_apply(run, staged, micro, mesh, n_chunks=n_chunks,
                              extras=extras)

    if n_chunks > 1:
        flat = {k: a.transpose(0, 1).reshape((-1,) + tuple(a.shape[3:]))
                for k, a in blocks.items()}
    else:
        flat = blocks
    m, mb = micro.shape[:2]
    x = micro.reshape((m * mb,) + tuple(micro.shape[2:]))
    for i in range(next(iter(flat.values())).shape[0]):
        p_layer = {k: a[i] for k, a in flat.items()}
        if remat and grad:
            x = checkpoint(layer_fn, p_layer, x, extras, use_reentrant=False)
        else:
            x = layer_fn(p_layer, x, extras)
    return x.reshape(micro.shape)


class _PipelinedBase(nn.Module):
    """The stacked-trunk plumbing both families share."""

    #: the stacked trunk's ``(name, init, trailing shape)``, set per model
    _trunk: tuple = ()

    def _stack(self, device):
        lead = _stacked_lead(self.n_layer, self.n_stages, self.n_chunks)
        for name, _, shape in self._trunk:
            setattr(self, name, nn.Parameter(torch.empty(
                lead + shape, dtype=torch.float32, device=device)))

    def _blocks(self) -> dict:
        return {name: getattr(self, name) for name, _, _ in self._trunk}

    def _trunk_out(self, x, layer_fn, extras=()):
        b = x.shape[0]
        y = _run_trunk(self._blocks(), _microbatch(x, self.n_microbatches),
                       self.mesh, self.n_stages, self.n_chunks, self.remat,
                       layer_fn, extras,
                       sharded=bool(placed_on(self, "pipe")))
        return y.reshape((b,) + tuple(x.shape[1:]))

    @torch.no_grad()
    def _init_trunk(self, generator, stds: dict) -> None:
        for name, init, _ in self._trunk:
            p = getattr(self, name)
            if init == "normal":
                p.normal_(0.0, stds[name], generator=generator)
            else:
                p.fill_(1.0 if init == "ones" else 0.0)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """``nn.Module.load_state_dict``, whole tensors of a pipe-placed
        parameter cut to this rank's slice first."""
        return super().load_state_dict(slice_placed(self, dict(state_dict)),
                                       strict=strict, assign=assign)


def _gpt2_trunk(d: int, f: int) -> tuple:
    return (("ln1_g", "ones", (d,)), ("ln1_b", "zeros", (d,)),
            ("qkv_k", "normal", (d, 3 * d)), ("qkv_b", "zeros", (3 * d,)),
            ("out_k", "normal", (d, d)), ("out_b", "zeros", (d,)),
            ("ln2_g", "ones", (d,)), ("ln2_b", "zeros", (d,)),
            ("up_k", "normal", (d, f)), ("up_b", "zeros", (f,)),
            ("down_k", "normal", (f, d)), ("down_b", "zeros", (d,)))


class PipelinedLM(_PipelinedBase):
    """Decoder-only GPT-2-family LM with a pipeline-parallel trunk (the
    flax ``PipelinedLM``: tied head, ``d_ff`` 0 meaning 4 x d_model)."""

    def __init__(self, vocab_size: int = 50257, n_layer: int = 12,
                 n_head: int = 12, d_model: int = 768, d_ff: int = 0,
                 max_len: int = 1024, n_stages: int = 2,
                 n_microbatches: int = 4, n_chunks: int = 1,
                 remat: bool = False, fused_head: bool = False,
                 dtype=torch.float32, mesh=None, device=None):
        super().__init__()
        d, f = d_model, d_ff or 4 * d_model
        self.vocab_size, self.n_layer, self.n_head = vocab_size, n_layer, \
            n_head
        self.d_model, self.d_ff, self.max_len = d, f, max_len
        self.n_stages, self.n_microbatches = n_stages, n_microbatches
        self.n_chunks, self.remat, self.fused_head = n_chunks, remat, \
            fused_head
        self.dtype = dtype
        self.wte = nn.Parameter(torch.empty(vocab_size, d, device=device))
        self.wpe = nn.Parameter(torch.empty(max_len, d, device=device))
        self._trunk = _gpt2_trunk(d, f)
        self._stack(device)
        self.lnf_g = nn.Parameter(torch.ones(d, device=device))
        self.lnf_b = nn.Parameter(torch.zeros(d, device=device))
        # the parallel mesh (parallel/mesh.py); None until inject_mesh
        self.mesh = mesh
        self.placements = {}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The flax module's law: ``wte`` N(0, 0.02), ``wpe`` N(0, 0.01),
        ``qkv``/``up`` N(0, 0.02), ``out``/``down`` N(0, 0.02/sqrt(2L)),
        norms ones and zeros, biases zero."""
        res = 0.02 / (2 * self.n_layer) ** 0.5
        self.wte.normal_(0.0, 0.02, generator=generator)
        self.wpe.normal_(0.0, 0.01, generator=generator)
        self._init_trunk(generator, {"qkv_k": 0.02, "up_k": 0.02,
                                     "out_k": res, "down_k": res})
        self.lnf_g.fill_(1.0)
        self.lnf_b.zero_()

    def forward(self, tokens):
        """tokens ``[B, T]`` -> float32 logits ``[B, T, V]``, or ``(hidden,
        head_w)`` in the compute dtype with ``fused_head``."""
        b, t = tokens.shape
        if t > self.max_len:
            raise ValueError(f"sequence {t} exceeds max_len {self.max_len}")
        dt, n_head = self.dtype, self.n_head
        x = (embed(self.wte, tokens, torch.float32)
             + self.wpe[:t][None]).to(dt)
        x = self._trunk_out(x, lambda p, xx, _ex: _block_apply(p, xx,
                                                               n_head))
        x = _layer_norm(x, self.lnf_g, self.lnf_b)
        if self.fused_head:
            return x.to(dt), self.wte.t().to(dt)
        return (x.to(dt) @ self.wte.t().to(dt)).float()

    def partition_rules(self):
        """The stacked trunk shards dim 0 over ``pipe`` (``[L]`` for GPipe,
        the stage dim of ``[S, V, Lc]``); embeddings and head replicate."""
        return [(r"(ln1|ln2|qkv|out|up|down)_[kgb]", P("pipe")),
                (r"wte|wpe|lnf_[gb]", P())]


def _stacked_layers(dense: dict, prefix: str, leaf, n_stages: int,
                    n_chunks: int):
    """``leaf(state, 'prefix.i.')`` of every dense layer stacked ``[L,
    ...]``, or in the interleaved ``[S, V, Lc, ...]`` layout."""
    layers = sorted({int(k.split(".")[1]) for k in dense
                     if k.startswith(prefix + ".")})
    if layers != list(range(len(layers))):
        raise ValueError(f"non-contiguous dense layer indices: {layers}")
    S, V, L = int(n_stages), int(n_chunks), len(layers)
    if V > 1 and L % (S * V):
        raise ValueError(f"n_layer {L} not divisible by n_stages*n_chunks "
                         f"{S * V}")
    flat = torch.stack([leaf(f"{prefix}.{i}.") for i in layers])
    if V == 1:
        return flat
    lc = L // (S * V)
    return flat.reshape((V, S, lc) + tuple(flat.shape[1:])).transpose(0, 1) \
        .contiguous()


def stack_dense_params(dense_params: dict, n_stages: int = 1,
                       n_chunks: int = 1) -> dict:
    """The port's ``GPT2`` / ``TinyLM`` state dict -> ``PipelinedLM``'s
    (the same block math; per-layer ``h.i.*`` -> stacked tensors, kernels
    to flax's ``[in, out]``). For a circular model pass its ``n_stages`` /
    ``n_chunks``: the trunk lands in the interleaved layout. Refuses an
    untied ``lm_head`` (the pipelined head is tied to ``wte``)."""
    if any(k.startswith("lm_head.") for k in dense_params):
        raise ValueError(
            "dense checkpoint has an untied lm_head; PipelinedLM ties its "
            "head to wte, so converting would silently change the logits "
            "— untie is not supported in the pipelined family")
    sd = dense_params

    def stacked(suffix, transpose=False):
        def leaf(p):
            t = sd[p + suffix].detach()
            return t.t() if transpose else t
        return _stacked_layers(sd, "h", leaf, n_stages, n_chunks)

    return {
        "wte": sd["wte.weight"], "wpe": sd["wpe"],
        "ln1_g": stacked("ln_1.weight"), "ln1_b": stacked("ln_1.bias"),
        "qkv_k": stacked("attn.qkv.weight", True),
        "qkv_b": stacked("attn.qkv.bias"),
        "out_k": stacked("attn.out.weight", True),
        "out_b": stacked("attn.out.bias"),
        "ln2_g": stacked("ln_2.weight"), "ln2_b": stacked("ln_2.bias"),
        "up_k": stacked("mlp.up.weight", True),
        "up_b": stacked("mlp.up.bias"),
        "down_k": stacked("mlp.down.weight", True),
        "down_b": stacked("mlp.down.bias"),
        "lnf_g": sd["ln_f.weight"], "lnf_b": sd["ln_f.bias"],
    }


class PipelinedLlama(_PipelinedBase):
    """The Llama architecture (RMSNorm, RoPE GQA, SwiGLU, untied head)
    with a pipeline-parallel trunk (the flax ``PipelinedLlama``)."""

    def __init__(self, vocab_size: int = 32000, n_layer: int = 12,
                 n_head: int = 12, n_kv_head: int = 0, d_model: int = 768,
                 d_ff: int = 0, max_len: int = 2048, n_stages: int = 2,
                 n_microbatches: int = 4, n_chunks: int = 1,
                 remat: bool = False, fused_head: bool = False,
                 rope_base: float = 10000.0, rms_eps: float = 1e-6,
                 dtype=torch.float32, mesh=None, device=None):
        super().__init__()
        n_kv = n_kv_head or n_head
        if n_head % n_kv:
            raise ValueError(f"n_head {n_head} not divisible by n_kv_head "
                             f"{n_kv}")
        d = d_model
        f = d_ff or -(-int(d * 8 / 3) // 16) * 16
        hd = d // n_head
        self.vocab_size, self.n_layer, self.n_head = vocab_size, n_layer, \
            n_head
        self.n_kv_head, self.d_model, self.d_ff = n_kv, d, f
        self.max_len, self.n_stages = max_len, n_stages
        self.n_microbatches, self.n_chunks = n_microbatches, n_chunks
        self.remat, self.fused_head = remat, fused_head
        self.rope_base, self.rms_eps, self.dtype = rope_base, rms_eps, dtype
        self.embed_tokens = nn.Parameter(torch.empty(vocab_size, d,
                                                     device=device))
        self._trunk = (("ln1_g", "ones", (d,)),
                       ("q_k", "normal", (d, d)),
                       ("k_k", "normal", (d, n_kv * hd)),
                       ("v_k", "normal", (d, n_kv * hd)),
                       ("o_k", "normal", (d, d)),
                       ("ln2_g", "ones", (d,)),
                       ("gate_k", "normal", (d, f)),
                       ("up_k", "normal", (d, f)),
                       ("down_k", "normal", (f, d)))
        self._stack(device)
        self.norm_g = nn.Parameter(torch.ones(d, device=device))
        self.head_k = nn.Parameter(torch.empty(d, vocab_size,
                                               device=device))
        self.mesh = mesh
        self.placements = {}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The flax module's law: N(0, 0.02) for the embedding, every
        projection and the head; ones for the norms."""
        self.embed_tokens.normal_(0.0, 0.02, generator=generator)
        self._init_trunk(generator, {name: 0.02 for name, init, _ in
                                     self._trunk if init == "normal"})
        self.norm_g.fill_(1.0)
        self.head_k.normal_(0.0, 0.02, generator=generator)

    def forward(self, tokens):
        """tokens ``[B, T]`` -> float32 logits ``[B, T, V]``, or ``(hidden,
        head_w)`` in the compute dtype with ``fused_head``."""
        b, t = tokens.shape
        dt = self.dtype
        x = embed(self.embed_tokens, tokens, dt)
        cos, sin = rope_tables(torch.arange(t, device=tokens.device),
                               self.d_model // self.n_head, self.rope_base)
        n_head, n_kv, eps = self.n_head, self.n_kv_head, self.rms_eps

        def layer_fn(p, xx, ex):
            return _llama_block_apply(p, xx, ex[0], ex[1], n_head, n_kv, eps)

        x = self._trunk_out(x, layer_fn, (cos, sin))
        x = _rms_norm(x, self.norm_g, self.rms_eps)
        if self.fused_head:
            return x.to(dt), self.head_k.to(dt)
        return (x.to(dt) @ self.head_k.to(dt)).float()

    def partition_rules(self):
        return [(r"(ln1|ln2)_g|(q|k|v|o|gate|up|down)_k", P("pipe")),
                (r"embed_tokens|norm_g|head_k", P())]


def stack_dense_llama_params(dense_params: dict, n_stages: int = 1,
                             n_chunks: int = 1) -> dict:
    """The port's Llama-family state dict -> ``PipelinedLlama``'s (the same
    math, stacked layout, kernels to flax's ``[in, out]``; circular models
    get the interleaved ``[S, V, Lc]`` arrangement)."""
    sd = dense_params

    def stacked(suffix, transpose=True):
        def leaf(p):
            t = sd[p + suffix].detach()
            return t.t() if transpose else t
        return _stacked_layers(sd, "layers", leaf, n_stages, n_chunks)

    return {
        "embed_tokens": sd["embed_tokens.weight"],
        "ln1_g": stacked("input_layernorm.weight", False),
        "q_k": stacked("self_attn.q_proj.weight"),
        "k_k": stacked("self_attn.k_proj.weight"),
        "v_k": stacked("self_attn.v_proj.weight"),
        "o_k": stacked("self_attn.o_proj.weight"),
        "ln2_g": stacked("post_attention_layernorm.weight", False),
        "gate_k": stacked("mlp.gate_proj.weight"),
        "up_k": stacked("mlp.up_proj.weight"),
        "down_k": stacked("mlp.down_proj.weight"),
        "norm_g": sd["norm.weight"],
        "head_k": sd["lm_head.weight"].detach().t(),
    }


@MODELS.register("LlamaPipelined")
def llama_pipelined(vocab_size: int = 32000, n_layer: int = 12,
                    n_head: int = 12, n_kv_head: int = 0,
                    d_model: int = 768, d_ff: int = 0,
                    max_len: int = 2048, n_stages: int = 4,
                    n_microbatches: int = 8, n_chunks: int = 1,
                    remat: bool = True, fused_head: bool = True,
                    rope_base: float = 10000.0, rms_eps: float = 1e-6,
                    bfloat16: bool = True, mesh=None, device=None,
                    param_dtype=None):
    _check_param_dtype(param_dtype)
    return PipelinedLlama(
        vocab_size=vocab_size, n_layer=n_layer, n_head=n_head,
        n_kv_head=n_kv_head, d_model=d_model, d_ff=d_ff, max_len=max_len,
        n_stages=n_stages, n_microbatches=n_microbatches,
        n_chunks=n_chunks, remat=remat, fused_head=fused_head,
        rope_base=rope_base, rms_eps=rms_eps, dtype=_dtype(bfloat16),
        mesh=mesh, device=device)


@MODELS.register("PipelinedLM")
def pipelined_lm(vocab_size: int = 50257, n_layer: int = 12,
                 n_head: int = 12, d_model: int = 768, max_len: int = 1024,
                 n_stages: int = 2, n_microbatches: int = 4,
                 n_chunks: int = 1, remat: bool = False,
                 fused_head: bool = False, bfloat16: bool = False,
                 mesh=None, device=None, param_dtype=None, **overrides):
    _check_param_dtype(param_dtype)
    return PipelinedLM(
        vocab_size=vocab_size, n_layer=n_layer, n_head=n_head,
        d_model=d_model, max_len=max_len, n_stages=n_stages,
        n_microbatches=n_microbatches, n_chunks=n_chunks, remat=remat,
        fused_head=fused_head, dtype=_dtype(bfloat16), mesh=mesh,
        device=device, **overrides)


@MODELS.register("GPT2Pipelined")
def gpt2_pipelined(size: str = "gpt2-small", vocab_size: int = 50257,
                   max_len: int = 1024, n_stages: int = 4,
                   n_microbatches: int = 8, n_chunks: int = 1,
                   remat: bool = True, fused_head: bool = True,
                   bfloat16: bool = True, mesh=None, device=None,
                   param_dtype=None, **overrides):
    """GPT-2 family sizes through the pipeline (the same math and weights
    as ``GPT2`` via :func:`stack_dense_params`)."""
    cfg = dict(_GPT2_SIZES[size])
    cfg.update(overrides)
    return pipelined_lm(
        vocab_size=vocab_size, max_len=max_len, n_stages=n_stages,
        n_microbatches=n_microbatches, n_chunks=n_chunks, remat=remat,
        fused_head=fused_head, bfloat16=bfloat16, mesh=mesh, device=device,
        param_dtype=param_dtype, **cfg)


@MODELS.register("TinyPipeLM")
def tiny_pipe_lm(vocab_size: int = 256, n_layer: int = 4, n_head: int = 4,
                 d_model: int = 64, max_len: int = 128, n_stages: int = 2,
                 n_microbatches: int = 4, n_chunks: int = 1,
                 remat: bool = False, fused_head: bool = False,
                 bfloat16: bool = False, mesh=None, device=None,
                 param_dtype=None):
    """Small pipelined config for tests and dry runs."""
    return pipelined_lm(
        vocab_size=vocab_size, n_layer=n_layer, n_head=n_head,
        d_model=d_model, max_len=max_len, n_stages=n_stages,
        n_microbatches=n_microbatches, n_chunks=n_chunks, remat=remat,
        fused_head=fused_head, bfloat16=bfloat16, mesh=mesh, device=device,
        param_dtype=param_dtype)
