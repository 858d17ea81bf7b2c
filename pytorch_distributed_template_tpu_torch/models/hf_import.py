"""Import and export HuggingFace GPT-2 / Llama weights for the port's LM
families: the port of the JAX package's ``models/hf_import.py``
(``import_hf_gpt2``, ``import_hf_llama``, ``export_hf_gpt2``,
``export_hf_llama``) over the port's state dicts.

A user takes an HF ``GPT2LMHeadModel`` or ``LlamaForCausalLM``
``state_dict()`` (tensors or arrays, on the CPU; never on the compute
path), obtains a state dict for the port's ``GPT2`` / ``TinyLM`` or
Llama-family module, trains it, and exports it back into an HF state dict.
Nothing is downloaded: the caller brings the weights.

The layout rules are the JAX package's, seen from ``nn.Linear``: HF's
GPT-2 ``Conv1D`` stores ``[in, out]`` (a flax kernel's layout, copied
untransposed there), so here, where every projection is an ``nn.Linear``
``[out, in]``, it transposes; HF Llama's ``nn.Linear`` ``[out, in]`` is
transposed for flax, so here it copies as it is.

==========================  ==================================
HF GPT-2                    the port's GPT2 state dict
==========================  ==================================
``wte.weight [V, D]``       ``wte.weight``
``wpe.weight [P, D]``       ``wpe``
``h.{i}.ln_1.{w,b}``        ``h.{i}.ln_1.{weight,bias}``
``h.{i}.attn.c_attn``       ``h.{i}.attn.qkv`` (T; q|k|v blocks)
``h.{i}.attn.c_proj``       ``h.{i}.attn.out`` (T)
``h.{i}.ln_2.{w,b}``        ``h.{i}.ln_2.{weight,bias}``
``h.{i}.mlp.c_fc``          ``h.{i}.mlp.up`` (T)
``h.{i}.mlp.c_proj``        ``h.{i}.mlp.down`` (T)
``ln_f.{w,b}``              ``ln_f.{weight,bias}``
(tied lm_head)              (``tie_embeddings=True``)
==========================  ==================================

The Llama names are the same on both sides (``model.`` stripped);
a tied-embedding Llama checkpoint (no ``lm_head.weight``) gets its head
from ``embed_tokens``. Refusals, as in JAX: a missing key, a checkpoint
with more blocks than ``n_layer``, and an untied head on the GPT-2
export (the export writes the tied layout).
"""
from __future__ import annotations

import numpy as np
import torch


def _to_np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().float().numpy()
    return np.asarray(t)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(arr, np.float32))


def _strip(hf_state_dict, prefix: str) -> dict:
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in hf_state_dict.items()}


def _layer_indices(state: dict, prefix: str) -> list:
    layers = sorted({int(k.split(".")[1]) for k in state
                     if k.startswith(prefix + ".")})
    if layers != list(range(len(layers))):
        raise ValueError(f"non-contiguous layer indices: {layers}")
    return layers


def import_hf_gpt2(hf_state_dict, n_layer: int) -> dict:
    """An HF ``GPT2LMHeadModel`` (``transformer.``-prefixed) or
    ``GPT2Model`` ``state_dict()`` -> the port's ``GPT2`` state dict
    (float32 CPU tensors; load with ``tie_embeddings=True``)."""
    sd = _strip(hf_state_dict, "transformer.")

    def g(name, transpose=False):
        if name not in sd:
            raise KeyError(f"HF state dict is missing '{name}' — not a "
                           "GPT-2 checkpoint, or n_layer too large")
        arr = _to_np(sd[name]).astype(np.float32)
        return _tensor(arr.T if transpose else arr)

    if f"h.{n_layer}.ln_1.weight" in sd:
        raise ValueError(
            f"HF checkpoint has more than n_layer={n_layer} blocks (found "
            f"'h.{n_layer}.'); converting a truncated model would silently "
            "produce wrong logits")
    out = {"wte.weight": g("wte.weight"), "wpe": g("wpe.weight"),
           "ln_f.weight": g("ln_f.weight"), "ln_f.bias": g("ln_f.bias")}
    for i in range(n_layer):
        hf, me = f"h.{i}.", f"h.{i}."
        for a, b in (("ln_1", "ln_1"), ("ln_2", "ln_2")):
            out[f"{me}{b}.weight"] = g(f"{hf}{a}.weight")
            out[f"{me}{b}.bias"] = g(f"{hf}{a}.bias")
        for a, b in (("attn.c_attn", "attn.qkv"), ("attn.c_proj", "attn.out"),
                     ("mlp.c_fc", "mlp.up"), ("mlp.c_proj", "mlp.down")):
            out[f"{me}{b}.weight"] = g(f"{hf}{a}.weight", transpose=True)
            out[f"{me}{b}.bias"] = g(f"{hf}{a}.bias")
    return out


_LLAMA_PROJ = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
               "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
               "mlp.down_proj")
_LLAMA_NORMS = ("input_layernorm", "post_attention_layernorm")


def import_hf_llama(hf_state_dict, n_layer: int) -> dict:
    """An HF ``LlamaForCausalLM`` ``state_dict()`` -> the port's Llama-family
    state dict (float32 CPU tensors). A tied checkpoint (no
    ``lm_head.weight``, e.g. Llama-3.2-1B) gets ``lm_head.weight`` from
    ``embed_tokens``."""
    sd = _strip(hf_state_dict, "model.")

    def g(name):
        if name not in sd:
            raise KeyError(f"HF state dict is missing '{name}' — not a "
                           "Llama checkpoint, or n_layer too large")
        return _tensor(_to_np(sd[name]).astype(np.float32))

    if f"layers.{n_layer}.input_layernorm.weight" in sd:
        raise ValueError(
            f"HF checkpoint has more than n_layer={n_layer} blocks (found "
            f"'layers.{n_layer}.'); converting a truncated model would "
            "silently produce wrong logits")
    emb = g("embed_tokens.weight")
    out = {"embed_tokens.weight": emb, "norm.weight": g("norm.weight"),
           "lm_head.weight": (g("lm_head.weight") if "lm_head.weight" in sd
                              else emb.clone())}
    for i in range(n_layer):
        p = f"layers.{i}."
        for name in _LLAMA_NORMS + _LLAMA_PROJ:
            out[f"{p}{name}.weight"] = g(f"{p}{name}.weight")
    return out


def export_hf_gpt2(state_dict: dict) -> dict:
    """The port's ``GPT2`` / ``TinyLM`` state dict -> HF ``GPT2LMHeadModel``
    state-dict arrays (float32 numpy; ``lm_head.weight`` is ``wte``, the
    tied layout; HF's attention-mask buffers are not emitted, so load with
    ``strict=False``). Refuses an untied ``lm_head``."""
    if any(k.startswith("lm_head.") for k in state_dict):
        raise ValueError(
            "state dict has an untied lm_head; export_hf_gpt2 emits the tied "
            "layout (lm_head.weight = wte), so exporting would silently "
            "serve wrong logits — untie export is not supported")
    sd = state_dict

    def a(name, transpose=False):
        arr = _to_np(sd[name]).astype(np.float32)
        return np.ascontiguousarray(arr.T) if transpose else arr

    out = {"transformer.wte.weight": a("wte.weight"),
           "transformer.wpe.weight": a("wpe"),
           "transformer.ln_f.weight": a("ln_f.weight"),
           "transformer.ln_f.bias": a("ln_f.bias"),
           "lm_head.weight": a("wte.weight")}
    for i in _layer_indices(sd, "h"):
        hf, me = f"transformer.h.{i}.", f"h.{i}."
        for name in ("ln_1", "ln_2"):
            out[f"{hf}{name}.weight"] = a(f"{me}{name}.weight")
            out[f"{hf}{name}.bias"] = a(f"{me}{name}.bias")
        for hname, name in (("attn.c_attn", "attn.qkv"),
                            ("attn.c_proj", "attn.out"),
                            ("mlp.c_fc", "mlp.up"),
                            ("mlp.c_proj", "mlp.down")):
            out[f"{hf}{hname}.weight"] = a(f"{me}{name}.weight", True)
            out[f"{hf}{hname}.bias"] = a(f"{me}{name}.bias")
    return out


def export_hf_llama(state_dict: dict) -> dict:
    """The port's Llama-family state dict -> HF ``LlamaForCausalLM``
    state-dict arrays (an explicit ``lm_head.weight``, right for tied and
    untied HF configs alike)."""
    sd = state_dict

    def a(name):
        return _to_np(sd[name]).astype(np.float32)

    out = {"model.embed_tokens.weight": a("embed_tokens.weight"),
           "model.norm.weight": a("norm.weight"),
           "lm_head.weight": a("lm_head.weight")}
    for i in _layer_indices(sd, "layers"):
        p = f"layers.{i}."
        for name in _LLAMA_NORMS + _LLAMA_PROJ:
            out[f"model.{p}{name}.weight"] = a(f"{p}{name}.weight")
    return out
