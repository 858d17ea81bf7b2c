"""BERT-family bidirectional encoder, MLM pretraining and classification:
the port of the JAX package's ``models/bert.py`` (``BertEncoder``,
``BertMLM``, ``BertClassifier``), registered as ``BertMLM`` and
``BertClassifier`` with the JAX registry's defaults.

- The encoder is the GPT-2 trunk's blocks (models/transformer.py) with
  ``causal=False``: token embedding ``wte`` and position table ``wpe``,
  dropout, ``n_layer`` pre-LN blocks, the float32 ``ln_f``. Both models
  hold it under ``encoder.``, as the flax modules hold their trunk in the
  ``encoder`` scope, so ``trainer.init_from`` an MLM checkpoint grafts
  every ``encoder.*`` tensor into a classifier and leaves
  ``classifier_head.*`` at its init.
- ``attn_impl``: ``"xla"`` (the plain einsum attention) or ``"flash"``
  (kernel B1 forward, B2/B3 backward on the card, non-causal). The
  sequence-parallel impls are refused by name (ROADMAP A12b).
- ``BertMLM`` returns ``(logits, mask)``: float32 logits of the head tied
  to ``wte`` and the float32 mask of the positions it corrupted; the
  class attribute ``mlm_output`` tells the evaluator so. The paired
  ``mlm_cross_entropy`` loss and ``mlm_accuracy`` metric score the masked
  positions only. ``mask_id`` -1 means ``vocab_size - 1``, the reserved
  [MASK] id.
- ``BertClassifier`` pools the encoder's output by the mean over tokens
  into ``classifier_head``.

The 80/10/10 corruption is split as ``ops/augment.py`` splits its
transforms:

- a host-side draw (:meth:`BertMLM.mask_draws`) of the global batch's
  ``sel`` (Bernoulli(``mask_rate``)), ``mix`` (uniform float32) and
  ``rand_tok`` (uniform over ``vocab_size - 1`` ids) with numpy's Philox,
  keyed by ``fold_in(step seed, MLM_SALT)`` (``models.layers.fold_in``;
  the train step's seed is ``fold_in(seed, step)``), each data shard
  keeping its rows ``index::count``;
- a device-side apply (:func:`corrupt`): of the selected positions those
  with ``mix < 0.8`` become [MASK], those with ``mix >= 0.9`` a random
  token that skips ``mask_id``, the rest stay. Fed JAX's own draws it
  gives JAX's corrupted tokens exactly.

The mask is therefore the same on the card and on the CPU, on one rank
and on two, and after a resume. JAX draws from its threefry stream
inside the model and the port from Philox on the host: a masked train
step is reproducible within each package, not across them.

In eval mode the mask is every 7th position from position 3, fully
[MASK]ed (JAX's deterministic eval mask); with a seed (``test.py
--seed``, the evaluator's per-batch ``fold_in(seed, batch)``) it is a
Bernoulli(``mask_rate``) draw from ``fold_in(that, EVAL_SALT)``
(:meth:`BertMLM.eval_draws`), fully [MASK]ed, as the JAX model's
``"eval"`` stream gives it.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..config.registry import MODELS
from ..ops.augment import to_device
from .layers import Dense, dropout, embed, fold_in
from .transformer import Block, LayerNorm, _check_param_dtype, _dtype, _site

#: folded into the train step's seed for the mask draws (the JAX model's
#: fold-in constant for its dropout key)
MLM_SALT = 0x4D4C4D
#: folded into the eval batch's seed for the seeded eval mask (JAX's)
EVAL_SALT = 0x4D4C45
_ATTN_IMPLS = ("xla", "flash")
_SLICE_SEQ = ("the BERT family on a seq axis (ring/Ulysses attention) is "
              "not ported: ROADMAP A12b")


def _rng(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=int(seed)))


def corrupt(tokens, sel, mix, rand_tok, mask_id: int):
    """BERT's 80/10/10 on ``tokens`` ``[B, T]``: where ``sel``, [MASK] if
    ``mix < 0.8``, ``rand_tok`` shifted past ``mask_id`` if ``mix >=
    0.9``, else the token."""
    tokens = tokens.long()
    rand_tok = rand_tok.long()
    rand_tok = rand_tok + (rand_tok >= mask_id).long()
    mask = torch.full_like(tokens, mask_id)
    return torch.where(sel & (mix < 0.8), mask,
                       torch.where(sel & (mix >= 0.9), rand_tok, tokens))


class BertEncoder(nn.Module):
    """Token + position embedding, ``n_layer`` bidirectional blocks, then
    the float32 ``ln_f``; returns float32 ``[B, T, d_model]``."""

    def __init__(self, vocab_size: int, n_layer: int, n_head: int,
                 d_model: int, d_ff: int = 0, max_len: int = 512,
                 dropout: float = 0.1, dtype=torch.float32,
                 attn_impl: str = "xla", device=None):
        super().__init__()
        if attn_impl not in _ATTN_IMPLS:
            if attn_impl.startswith(("ring", "ulysses")):
                raise NotImplementedError(_SLICE_SEQ)
            raise ValueError(f"attn_impl={attn_impl!r}; expected one of "
                             f"{_ATTN_IMPLS}")
        self.max_len, self.rate, self.dtype = max_len, dropout, dtype
        self.wte = nn.Embedding(vocab_size, d_model, device=device)
        self.wpe = nn.Parameter(torch.zeros(max_len, d_model, device=device))
        self.h = nn.ModuleList(
            Block(d_model, n_head, d_ff or 4 * d_model, dropout, dtype,
                  attn_impl, 1e-5, n_layer=n_layer, device=device,
                  causal=False)
            for _ in range(n_layer))
        self.ln_f = LayerNorm(d_model, 1e-5, device=device)

    def forward(self, tokens, seed=None):
        b, t = tokens.shape
        if t > self.max_len:
            raise ValueError(f"sequence {t} exceeds max_len {self.max_len}")
        dt = self.dtype
        x = embed(self.wte.weight, tokens, dt) + self.wpe[:t].to(dt)[None]
        x = dropout(x, self.rate, _site(seed, 0), self.training)
        for i, block in enumerate(self.h):
            x, _ = block(x, _site(seed, i + 1))
        return self.ln_f(x)


class _Bert(nn.Module):
    """What both models share: the encoder, its description (the
    attributes the trainer's tools read) and the init law."""

    remat = False
    fused_head = False
    moe_experts = 0
    causal = False

    def __init__(self, vocab_size, n_layer, n_head, d_model, d_ff, max_len,
                 dropout, dtype, attn_impl, device):
        super().__init__()
        self.vocab_size, self.n_layer, self.n_head = vocab_size, n_layer, \
            n_head
        self.d_model, self.d_ff, self.max_len = d_model, d_ff or \
            4 * d_model, max_len
        self.rate, self.dtype, self.attn_impl = dropout, dtype, attn_impl
        self.encoder = BertEncoder(vocab_size, n_layer, n_head, d_model,
                                   d_ff, max_len, dropout, dtype, attn_impl,
                                   device)

    @property
    def h(self):
        """The encoder's blocks."""
        return self.encoder.h

    @property
    def device(self) -> torch.device:
        return self.encoder.wpe.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random init from ``generator``, the flax modules' law: ``wte``
        and every kernel N(0, 0.02), the ``out`` and ``down`` projections
        N(0, 0.02/sqrt(2 n_layer)), ``wpe`` N(0, 0.01), LayerNorm ones
        and zeros, biases zero."""
        resid = 0.02 / (2 * self.n_layer) ** 0.5
        for name, p in self.named_parameters():
            if name.endswith("wpe"):
                p.normal_(0.0, 0.01, generator=generator)
            elif ".ln_" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            elif name.endswith(("attn.out.weight", "mlp.down.weight")):
                p.normal_(0.0, resid, generator=generator)
            else:
                p.normal_(0.0, 0.02, generator=generator)


class BertMLM(_Bert):
    """Masked-LM pretraining over :class:`BertEncoder`, the head tied to
    ``wte``; ``forward`` returns ``(logits [B, T, V] float32, mask [B, T]
    float32)``."""

    #: the evaluator's dispatch: the output is the (logits, mask) pair
    mlm_output = True

    def __init__(self, vocab_size: int = 256, n_layer: int = 4,
                 n_head: int = 4, d_model: int = 256, d_ff: int = 0,
                 max_len: int = 512, dropout: float = 0.1,
                 dtype=torch.float32, attn_impl: str = "xla",
                 mask_rate: float = 0.15, mask_id: int = -1, device=None):
        super().__init__(vocab_size, n_layer, n_head, d_model, d_ff,
                         max_len, dropout, dtype, attn_impl, device)
        self.mask_rate = float(mask_rate)
        self.mask_id = int(mask_id) if mask_id >= 0 else vocab_size - 1

    def mask_draws(self, seed: int, tokens, shard=(0, 1)
                   ) -> Dict[str, torch.Tensor]:
        """The train step's draws for step seed ``seed``: ``sel``, ``mix``
        and ``rand_tok`` of the global batch whose data shard ``shard =
        (index, count)`` holds ``tokens`` ``[B, T]``, this shard's rows,
        on ``tokens``' device (one pinned, non-blocking copy)."""
        index, count = shard
        shape = (tokens.shape[0] * count, tokens.shape[1])
        key = fold_in(seed, MLM_SALT)
        draws = {
            "sel": _rng(fold_in(key, 0)).random(shape) < self.mask_rate,
            "mix": _rng(fold_in(key, 1)).random(shape, dtype=np.float32),
            "rand_tok": _rng(fold_in(key, 2)).integers(
                0, self.vocab_size - 1, shape)}
        return to_device({k: v[index::count] for k, v in draws.items()},
                         tokens.device)

    def eval_draws(self, seed: int, tokens, shard=(0, 1)
                   ) -> Dict[str, torch.Tensor]:
        """The seeded eval mask of eval-batch seed ``seed``: ``sel`` ~
        Bernoulli(``mask_rate``) over the global batch, this shard's
        rows."""
        index, count = shard
        shape = (tokens.shape[0] * count, tokens.shape[1])
        sel = _rng(fold_in(seed, EVAL_SALT)).random(shape) < self.mask_rate
        return to_device({"sel": sel[index::count]}, tokens.device)

    def forward(self, tokens, dropout_seed=None,
                mask_draws: Optional[Dict[str, torch.Tensor]] = None):
        """In training mode ``mask_draws`` (:meth:`mask_draws`'s, the
        train step's) is required; in eval mode it is optional
        (:meth:`eval_draws`'s ``sel``), else the every-7th mask."""
        tokens = tokens.long()
        if self.training:
            if mask_draws is None:
                raise ValueError("BertMLM in training mode needs the train "
                                 "step's mask_draws")
            sel = mask_draws["sel"]
            corrupted = corrupt(tokens, sel, mask_draws["mix"],
                                mask_draws["rand_tok"], self.mask_id)
        else:
            if mask_draws is not None:
                sel = mask_draws["sel"]
            else:
                pos = torch.arange(tokens.shape[1], device=tokens.device)
                sel = (pos % 7 == 3)[None, :].expand(tokens.shape)
            corrupted = torch.where(sel, torch.full_like(tokens,
                                                         self.mask_id),
                                    tokens)
        h = self.encoder(corrupted, dropout_seed)
        dt = self.dtype
        logits = h.to(dt) @ self.encoder.wte.weight.to(dt).t()
        return logits.float(), sel.float()


class BertClassifier(_Bert):
    """Mean-pooled classification over the shared ``encoder``; float32
    logits ``[B, num_classes]``."""

    def __init__(self, num_classes: int, vocab_size: int = 256,
                 n_layer: int = 4, n_head: int = 4, d_model: int = 256,
                 d_ff: int = 0, max_len: int = 512, dropout: float = 0.1,
                 dtype=torch.float32, attn_impl: str = "xla", device=None):
        super().__init__(vocab_size, n_layer, n_head, d_model, d_ff,
                         max_len, dropout, dtype, attn_impl, device)
        self.num_classes = num_classes
        self.classifier_head = Dense(d_model, num_classes,
                                     compute_dtype=dtype,
                                     param_dtype=torch.float32,
                                     device=device)

    def forward(self, tokens, dropout_seed=None):
        h = self.encoder(tokens, dropout_seed)
        return self.classifier_head(h.mean(dim=1)).float()


@MODELS.register("BertMLM")
def bert_mlm(vocab_size: int = 256, n_layer: int = 4, n_head: int = 4,
             d_model: int = 256, d_ff: int = 0, max_len: int = 512,
             dropout: float = 0.1, bfloat16: bool = False,
             attn_impl: str = "xla", mesh=None, mask_rate: float = 0.15,
             mask_id: int = -1, device=None, param_dtype=None):
    """``mesh`` is accepted for the registry's uniform call: the family
    runs on the data axis only."""
    del mesh
    _check_param_dtype(param_dtype)
    return BertMLM(vocab_size, n_layer, n_head, d_model, d_ff, max_len,
                   dropout, _dtype(bfloat16), attn_impl, mask_rate, mask_id,
                   device)


@MODELS.register("BertClassifier")
def bert_classifier(num_classes: int, vocab_size: int = 256,
                    n_layer: int = 4, n_head: int = 4, d_model: int = 256,
                    d_ff: int = 0, max_len: int = 512,
                    dropout: float = 0.1, bfloat16: bool = False,
                    attn_impl: str = "xla", mesh=None, device=None,
                    param_dtype=None):
    del mesh
    _check_param_dtype(param_dtype)
    return BertClassifier(num_classes, vocab_size, n_layer, n_head,
                          d_model, d_ff, max_len, dropout, _dtype(bfloat16),
                          attn_impl, device)
