"""Vision Transformer: the port of the JAX package's ``models/vit.py``
(``EncoderBlock``, ``ViT``, ``_VIT_SIZES`` and the registered ``ViT``
factory).

- Patch embedding: a ``patch x patch`` VALID conv with stride ``patch``
  (bias, N(0, 0.02) kernel) over the NHWC batch, flattened row-major
  into ``[B, N, D]`` tokens as flax's reshape orders them; with ``pool
  "cls"`` a learned token (zeros) is prepended, then the learned
  position table (N(0, 0.02)) is added: ViT-B/16 at 224 px has 197
  tokens.
- Pre-LN encoder blocks: flax's ``LayerNorm`` (eps 1e-6, float32 out),
  ``qkv``, ``out``, ``up``, ``down`` Dense layers computing in the
  compute dtype (``bfloat16: true``) over float32 params, the tanh GELU
  (flax's ``nn.gelu`` default; torch's default is the erf form), and
  non-causal attention: ``attn_impl "xla"`` the plain einsum
  (``ops/attention.py::multihead_attention``), ``"flash"`` the kernels
  B1 forward and B3, B2 backward through ``ops/flash.py::
  flash_attention(causal=False)`` on contiguous q, k, v (TMA needs
  them).
- Dropout after the embedding (site 0) and in each block after the
  attention and the MLP, masks from ``forward(..., dropout_seed=...)``
  folded with (layer, site) (models/layers.py), so ``remat``
  (``torch.utils.checkpoint`` around each block, flax's ``nn.remat``
  with ``nothing_saveable``) redraws the same masks.
- The head: ``ln_f``, the cls token's row (or the tokens' mean with
  ``pool "mean"``), a float32 Dense initialised to zeros, and
  ``log_softmax``.
- Submodules keep flax's names (``patch_embed``, ``cls``, ``pos_embed``,
  ``h_i`` as ``h.i``, ``ln_1``, ``qkv``, ``out``, ``ln_2``, ``up``,
  ``down``, ``ln_f``, ``head``) for ``models/convert.py`` and the health
  groups.
- :meth:`ViT.partition_rules`: JAX's rules over the torch dimensions. On
  an fsdp axis they leave ``pos_embed``, ``cls`` and the head replicated
  and the rest to the ZeRO-3 fallback (parallel/sharding.py), as in JAX;
  computing on ``tensor`` shards is ROADMAP A11b's remainder (no
  ``use_tensor_axis``: a tensor axis refuses).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..config.registry import MODELS
from ..ops.attention import multihead_attention
from ..ops.flash import flash_attention
from ..parallel.sharding import P
from .layers import Dense, SameConv2d, dropout
from .transformer import LayerNorm, _site

LN_EPS = 1e-6       # flax nn.LayerNorm's default
_ATTN_IMPLS = ("xla", "flash")


class EncoderBlock(nn.Module):
    def __init__(self, d_model: int, n_head: int, d_ff: int, rate: float,
                 dtype, attn_impl: str = "xla", device=None):
        super().__init__()
        self.n_head, self.rate, self.attn_impl = n_head, rate, attn_impl
        self.head_dim = d_model // n_head
        dense = dict(compute_dtype=dtype, param_dtype=torch.float32,
                     device=device)
        self.ln_1 = LayerNorm(d_model, LN_EPS, device=device)
        self.qkv = Dense(d_model, 3 * d_model, **dense)
        self.out = Dense(d_model, d_model, **dense)
        self.ln_2 = LayerNorm(d_model, LN_EPS, device=device)
        self.up = Dense(d_model, d_ff, **dense)
        self.down = Dense(d_ff, d_model, **dense)

    def forward(self, x, seed=None):
        b, n, d = x.shape
        qkv = self.qkv(self.ln_1(x)).view(b, n, 3, self.n_head,
                                          self.head_dim)
        q, k, v = (qkv[:, :, i].contiguous() for i in range(3))
        if self.attn_impl == "flash":
            ctx = flash_attention(q, k, v, causal=False)
        else:
            ctx = multihead_attention(q, k, v, causal=False)
        ctx = self.out(ctx.reshape(b, n, d))
        x = x + dropout(ctx, self.rate, _site(seed, 1), self.training)
        y = self.down(F.gelu(self.up(self.ln_2(x)), approximate="tanh"))
        return x + dropout(y, self.rate, _site(seed, 2), self.training)


class ViT(nn.Module):
    """ViT classifier: patchify -> encoder stack -> cls-token head (the
    JAX ``ViT``'s fields, plus ``device``)."""

    def __init__(self, num_classes: int = 1000, image_size: int = 224,
                 channels: int = 3, patch_size: int = 16, n_layer: int = 12,
                 n_head: int = 12, d_model: int = 768, d_ff: int = 0,
                 dropout: float = 0.0, dtype=torch.float32,
                 attn_impl: str = "xla", remat: bool = False,
                 pool: str = "cls", device=None):
        super().__init__()
        if attn_impl not in _ATTN_IMPLS:
            raise ValueError(f"ViT attn_impl must be one of {_ATTN_IMPLS}, "
                             f"got {attn_impl!r}")
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {pool!r}")
        self.image_size, self.channels = image_size, channels
        self.patch_size, self.n_layer, self.d_model = (
            patch_size, n_layer, d_model)
        self.d_ff = d_ff or 4 * d_model
        self.rate, self.dtype, self.remat, self.pool = (
            float(dropout), dtype, remat, pool)
        self.patch_embed = SameConv2d(
            channels, d_model, patch_size, patch_size, bias=True,
            padding="VALID", compute_dtype=dtype,
            param_dtype=torch.float32, device=device)
        kw = dict(device=device, dtype=torch.float32)
        n = self.num_tokens()
        if pool == "cls":
            self.cls = nn.Parameter(torch.zeros(1, 1, d_model, **kw))
        self.pos_embed = nn.Parameter(torch.zeros(1, n, d_model, **kw))
        self.h = nn.ModuleList(
            EncoderBlock(d_model, n_head, self.d_ff, self.rate, dtype,
                         attn_impl, device=device)
            for _ in range(n_layer))
        self.ln_f = LayerNorm(d_model, LN_EPS, device=device)
        self.head = nn.Linear(d_model, num_classes, **kw)

    def num_tokens(self) -> int:
        """Tokens per image: the patches, plus the cls token."""
        n = (self.image_size // self.patch_size) ** 2
        return n + (1 if self.pool == "cls" else 0)

    def partition_rules(self):
        """JAX's ``ViT.partition_rules`` over the torch dimensions (the
        Dense weights ``[out, in]``, the patch kernel ``OIHW``)."""
        return [
            (r"qkv/weight", P("tensor", None)),
            (r"qkv/bias", P("tensor")),
            (r"out/weight", P(None, "tensor")),
            (r"up/weight", P("tensor", None)),
            (r"up/bias", P("tensor")),
            (r"down/weight", P(None, "tensor")),
            (r"patch_embed/weight", P("tensor", None, None, None)),
            (r"patch_embed/bias", P("tensor")),
            (r"pos_embed|cls|head", P()),
        ]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's init: Dense and patch kernels and ``pos_embed``
        N(0, 0.02); biases, ``cls`` and the head 0; LayerNorm 1 and 0."""
        for name, p in self.named_parameters():
            if ".ln_" in name or name.startswith("ln_f."):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif (name.endswith("bias") or name == "cls"
                  or name.startswith("head.")):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=generator)

    def forward(self, x, dropout_seed=None):
        """NHWC images ``[B, H, W, C]`` -> log-probabilities ``[B,
        classes]`` (float32). ``dropout_seed`` seeds every mask (needed
        in training mode when dropout > 0)."""
        b = x.shape[0]
        dt = self.dtype
        x = self.patch_embed(x.permute(0, 3, 1, 2))    # [B, D, h, w]
        x = x.flatten(2).transpose(1, 2)                # [B, N, D]
        if self.pool == "cls":
            x = torch.cat([self.cls.to(dt).expand(b, 1, self.d_model), x],
                          dim=1)
        x = x + self.pos_embed.to(dt)
        x = dropout(x, self.rate, _site(dropout_seed, 0), self.training)
        for i, block in enumerate(self.h):
            seed = _site(dropout_seed, i + 1)
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, seed, use_reentrant=False)
            else:
                x = block(x, seed)
        x = self.ln_f(x)
        x = x[:, 0] if self.pool == "cls" else x.mean(dim=1)
        return F.log_softmax(self.head(x), dim=-1)

    def flops_per_example(self) -> float:
        """Forward FLOPs of one image: the patch conv, per layer the four
        Dense layers (2 x params x tokens) and non-causal attention (4 x
        T² x D: two matrix products over every key), and the head."""
        t, d, p = self.num_tokens(), self.d_model, self.patch_size
        patches = (self.image_size // p) ** 2
        embed = 2.0 * p * p * self.channels * d * patches
        dense = 2.0 * (4 * d * d + 2 * d * self.d_ff) * t
        attn = 4.0 * t * t * d
        return embed + self.n_layer * (dense + attn) \
            + 2.0 * d * self.head.out_features


_VIT_SIZES = {
    "vit-ti": dict(n_layer=12, n_head=3, d_model=192),
    "vit-s": dict(n_layer=12, n_head=6, d_model=384),
    "vit-b": dict(n_layer=12, n_head=12, d_model=768),
    "vit-l": dict(n_layer=24, n_head=16, d_model=1024),
    "vit-h": dict(n_layer=32, n_head=16, d_model=1280),
}


@MODELS.register("ViT")
def vit(size: str = "vit-b", num_classes: int = 1000, image_size: int = 224,
        channels: int = 3, patch_size: int = 16, dropout: float = 0.0,
        bfloat16: bool = False, attn_impl: str = "xla", remat: bool = False,
        pool: str = "cls", device=None, param_dtype=None, **overrides):
    if param_dtype not in (None, torch.float32):
        raise ValueError("ViT keeps float32 params (flax's param_dtype); "
                         "bfloat16: true sets the compute")
    cfg = dict(_VIT_SIZES[size])
    cfg.update(overrides)
    return ViT(num_classes=num_classes, image_size=image_size,
               channels=channels, patch_size=patch_size, dropout=dropout,
               dtype=torch.bfloat16 if bfloat16 else torch.float32,
               attn_impl=attn_impl, remat=remat, pool=pool, device=device,
               **cfg)
