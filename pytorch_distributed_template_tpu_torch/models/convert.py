"""Flax param tree <-> the port's state dict, for the Llama, GPT-2,
LeNet, ResNet, ViT and BERT families, LoRA adapters included.

The JAX package's params are nested dicts (``layers_0/self_attn/q_proj/
kernel``, ``h_0/attn/qkv/bias``); the port's modules name the same weights
``layers.0.self_attn.q_proj.weight``, ``h.0.attn.qkv.bias``. The
translation:

- ``layers_i`` / ``h_i`` <-> ``layers.i`` / ``h.i``;
- every ``*/kernel`` ``[in, out]`` -> ``*.weight`` ``[out, in]`` (the
  ``nn.Linear`` layout), transposed — ``lm_head/kernel`` included; a conv
  kernel (4-D, ``HWIO``) -> ``OIHW`` (the ``nn.Conv2d`` layout). LeNet's
  modules keep the flax names (``Conv_0``, ``Dense_0``, ...), and its
  forward flattens the conv features in the JAX module's ``(h, w, c)``
  order, so ``Dense_0``'s rows need no permutation;
- ``embed_tokens/embedding``, ``wte/embedding`` -> ``*.weight`` as is;
- LayerNorm ``scale`` -> ``weight``; ``bias`` and RMSNorm ``weight``
  leaves as they are; the bare ``wpe`` param as it is;
- BatchNorm ``scale`` -> ``weight`` (a BN is ``bn_init``, ``norm_proj``
  or ``BatchNorm_i``; the ResNet blocks keep flax's names,
  ``BasicBlock_i``, ``Conv_i``, ``conv_proj``); ViT's bare ``cls`` and
  ``pos_embed`` params as they are;
- the MoE block's stacked expert leaves ``h_i/moe/{wi, wo, bi, bo}``
  (``[E, D, F]``, ``[E, F, D]``, ``[E, F]``, ``[E, D]``; the swiglu
  expert's ``layers_i/moe/{wi, wg, wo}``) as they are, and its router
  ``h_i/moe/router/{kernel, bias}`` like any dense layer;
- the LoRA adapters ``*/lora_a`` ``[in, r]`` and ``*/lora_b`` ``[r, out]``
  as they are (``models/lora.py`` stores flax's layout);
- a w8a16 Dense's ``*/kernel_q`` (int8 ``[in, out]``) and ``*/scale``
  (f32 ``[out]``) as they are (``models.quant.W8A16Dense`` stores flax's
  layout; its ``scale`` is told from a LayerNorm's by the ``kernel_q``
  beside it), its ``bias`` like any bias;
- the BERT tree: the trunk under ``encoder`` (``encoder/wte/embedding``,
  ``encoder/wpe``, ``encoder/h_i/...``, ``encoder/ln_f``) and
  ``classifier_head`` like any dense layer; a bare ``wpe`` under a module
  as at the root;
- the pipelined families' trees (``models/pipelined.py``): flat top-level
  leaves (``wte``, ``qkv_k [L, D, 3D]``, ..., ``lnf_g``; ``embed_tokens``,
  ``q_k``, ..., ``head_k``) as they are, under the same names: the port's
  pipelined modules keep flax's stacked ``[in, out]`` kernels.

A ResNet's ``batch_stats`` (``<bn>/mean`` and ``<bn>/var``) are the BN
modules' buffers ``<bn>.running_mean`` and ``<bn>.running_var``
(:func:`batch_stats_from_flax`, :func:`flax_batch_stats`);
:func:`flax_from_params` leaves them out, as flax keeps them out of the
params.

Both directions take and give plain containers: nested dicts of numpy
arrays on the flax side, a flat dict of CPU tensors on the torch side.
:func:`flax_path` gives the JAX path string of a port parameter (what the
optimizer's ``weight_decay_exclude`` regexes are matched against).

The KV block pool crosses the same way (:func:`pool_from_flax`,
:func:`flax_from_pool`): the JAX pool's cache leaves
``layers_i/self_attn/cached_key`` / ``cached_value`` ``[P, bt, KVH, D]``
(and ``cached_key_scale`` / ``cached_value_scale`` ``[P, bt, KVH]`` for the
int8 layout) are the port's ``PagedLayer`` tensors, byte for byte; the
GPT-2 family's scatter pool names its leaves ``h_i/attn/<leaf>``.
:func:`pool_leaf_path` and :func:`pool_leaf_slot` map a leaf both ways, and
:func:`pool_leaves` keys a pool's tensors by those paths: the leaf names
of the page wire format (engine/kvcache.py ``serialize_pages``) and of the
spill tier's entries.
"""
from __future__ import annotations

import re

import numpy as np
import torch

_LAYER = re.compile(r"^layers_(\d+)$")
_INDEXED = re.compile(r"^(layers|h)_(\d+)$")
_INDEXED_PARENTS = ("layers", "h")
_EMBEDDINGS = ("wte", "embed_tokens")
_EXPERT_LEAVES = ("wi", "wg", "wo", "bi", "bo")  # MoeMlp's stacked leaves
_TOP_LEVEL = ("wpe", "cls", "pos_embed")     # bare params (BERT's wpe
#                                              sits under ``encoder``)
_AS_IS = _TOP_LEVEL + ("lora_a", "lora_b", "kernel_q")   # keep their name
#: the pipelined families' flat top-level leaves (GPT-2, then Llama)
_PIPELINED = ("wte", "ln1_g", "ln1_b", "qkv_k", "qkv_b", "out_k", "out_b",
              "ln2_g", "ln2_b", "up_k", "up_b", "down_k", "down_b", "lnf_g",
              "lnf_b", "embed_tokens", "q_k", "k_k", "v_k", "o_k",
              "gate_k", "norm_g", "head_k")
_BATCH_NORM = re.compile(r"^(bn_init|norm_proj|BatchNorm_\d+)$")
#: batch_stats leaf <-> BN buffer
_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flatten(val, path)
        else:
            yield path, val


def _is_scale(module: str) -> bool:
    """A LayerNorm or BatchNorm, whose flax weight leaf is ``scale``."""
    return module.startswith("ln_") or bool(_BATCH_NORM.match(module))


def flax_path(name: str) -> str:
    """The JAX param path of port parameter ``name``:
    ``h.0.attn.qkv.weight`` -> ``h_0/attn/qkv/kernel``,
    ``h.0.ln_1.weight`` -> ``h_0/ln_1/scale``, ``wte.weight`` ->
    ``wte/embedding``, ``layers.1.input_layernorm.weight`` ->
    ``layers_1/input_layernorm/weight``, ``h.1.moe.wi`` ->
    ``h_1/moe/wi``, ``wpe`` -> ``wpe``, ``BasicBlock_0.BatchNorm_1.weight``
    -> ``BasicBlock_0/BatchNorm_1/scale``, ``h.0.attn.qkv.lora_a`` ->
    ``h_0/attn/qkv/lora_a``, ``encoder.wpe`` -> ``encoder/wpe``."""
    parts = name.split(".")
    mods, i = [], 0
    while i < len(parts) - 1:
        if parts[i] in _INDEXED_PARENTS and parts[i + 1].isdigit():
            mods.append(f"{parts[i]}_{parts[i + 1]}")
            i += 2
        else:
            mods.append(parts[i])
            i += 1
    leaf = parts[-1]
    if not mods:
        return leaf
    if leaf == "scale" and not _is_scale(mods[-1]):
        pass                         # a W8A16Dense's per-channel scale
    elif leaf == "weight":
        owner = mods[-1]
        if owner in _EMBEDDINGS:
            leaf = "embedding"
        elif _is_scale(owner):
            leaf = "scale"
        elif not (owner.endswith("layernorm") or owner == "norm"):
            leaf = "kernel"
    elif leaf != "bias" and leaf not in _AS_IS and not (
            mods[-1] == "moe" and leaf in _EXPERT_LEAVES):
        raise KeyError(f"unexpected state-dict entry {name}")
    return "/".join(mods + [leaf])


def params_from_flax(tree) -> dict:
    """Flax param tree (nested dicts of arrays) -> torch state dict."""
    out = {}
    leaves = list(_flatten(tree))
    quant_mods = {path[:-1] for path, _ in leaves if path[-1] == "kernel_q"}
    for path, leaf in leaves:
        arr = np.asarray(leaf)
        parts = [_INDEXED.sub(r"\1.\2", p) for p in path[:-1]]
        last = path[-1]
        if last == "scale" and path[:-1] in quant_mods:
            out[".".join(parts + [last])] = torch.tensor(
                np.ascontiguousarray(arr))
            continue
        if not parts:
            if last not in _TOP_LEVEL + _PIPELINED:
                raise KeyError(f"unexpected flax leaf {last}")
            name = last
        elif last == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            name = "weight"
        elif last in ("embedding", "weight", "scale"):
            name = "weight"
        elif last == "bias" or last in _AS_IS or (
                parts[-1] == "moe" and last in _EXPERT_LEAVES):
            name = last
        else:
            raise KeyError(f"unexpected flax leaf {'/'.join(path)}")
        out[".".join(parts + [name])] = torch.tensor(
            np.ascontiguousarray(arr))
    return out


def flax_from_params(state_dict) -> dict:
    """Inverse of :func:`params_from_flax`: torch state dict -> flax tree
    of float32 numpy arrays (BN buffers left out: :func:`flax_batch_stats`
    gives them)."""
    tree: dict = {}
    for name, tensor in state_dict.items():
        if name.rsplit(".", 1)[-1] in _STATS.values():
            continue
        path = flax_path(name).split("/")
        arr = tensor.detach().to("cpu")
        arr = (arr if path[-1] == "kernel_q" else arr.to(torch.float32)
               ).numpy()
        if path[-1] == "kernel":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        node = tree
        for m in path[:-1]:
            node = node.setdefault(m, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return tree


def batch_stats_from_flax(tree) -> dict:
    """Flax ``batch_stats`` (``{bn path: {"mean", "var"}}``) -> the BN
    buffers' state-dict entries (CPU float32 tensors)."""
    out = {}
    for path, leaf in _flatten(tree):
        if path[-1] not in _STATS:
            raise KeyError(f"unexpected batch_stats leaf {'/'.join(path)}")
        out[".".join(list(path[:-1]) + [_STATS[path[-1]]])] = torch.tensor(
            np.ascontiguousarray(np.asarray(leaf, np.float32)))
    return out


def flax_batch_stats(state_dict) -> dict:
    """Inverse of :func:`batch_stats_from_flax`: the BN buffers of a state
    dict as a flax ``batch_stats`` tree of float32 numpy arrays."""
    leaves = {v: k for k, v in _STATS.items()}
    tree: dict = {}
    for name, tensor in state_dict.items():
        *mods, leaf = name.split(".")
        if leaf not in leaves:
            continue
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaves[leaf]] = tensor.detach().to("cpu", torch.float32) \
            .numpy().copy()
    return tree


_POOL_LEAVES = {"cached_key": "k", "cached_value": "v",
                "cached_key_scale": "k_scale",
                "cached_value_scale": "v_scale"}
_POOL_ATTRS = {v: k for k, v in _POOL_LEAVES.items()}
#: a family's layer scope -> the attention module holding its cache leaves
#: (the Llama family's ``layers_i/self_attn``, the GPT-2 family's
#: ``h_i/attn``)
_POOL_SCOPES = {"layers": "self_attn", "h": "attn"}
_POOL_PATH = re.compile(r"^(layers|h)_(\d+)/(self_attn|attn)/(\w+)$")


def pool_leaf_path(scope: str, layer: int, attr: str) -> str:
    """The JAX cache path of one pool leaf: ``pool_leaf_path("layers", 3,
    "k_scale")`` -> ``layers_3/self_attn/cached_key_scale``."""
    return f"{scope}_{int(layer)}/{_POOL_SCOPES[scope]}/{_POOL_ATTRS[attr]}"


def pool_leaf_slot(path: str) -> tuple:
    """Inverse of :func:`pool_leaf_path`: ``(scope, layer, attr)``; a path
    that names no pool leaf raises ``KeyError``."""
    m = _POOL_PATH.match(path)
    if (m is None or m.group(3) != _POOL_SCOPES[m.group(1)]
            or m.group(4) not in _POOL_LEAVES):
        raise KeyError(f"not a pool leaf path: {path!r}")
    return m.group(1), int(m.group(2)), _POOL_LEAVES[m.group(4)]


def pool_leaves(pool, scope: str = "layers") -> dict:
    """A ``PagedCache``'s tensors keyed by their JAX cache paths (the keys
    of the JAX ``PrefixCache.pool``, the names on the page wire): the
    tensors themselves, not copies."""
    out = {}
    for i, layer in enumerate(pool.layers):
        for attr in _POOL_ATTRS:
            t = getattr(layer, attr)
            if t is not None:
                out[pool_leaf_path(scope, i, attr)] = t
    return out


def pool_from_flax(tree):
    """JAX pool leaves (a nested cache tree, or ``PrefixCache.pool``'s
    flat ``{"layers_0/self_attn/cached_key": ...}`` dict) -> the port's
    ``PagedCache`` of CPU tensors, bytes unchanged."""
    from .llama import PagedCache, PagedLayer

    layers: dict = {}
    for path, leaf in _flatten(tree):
        try:
            _, i, attr = pool_leaf_slot("/".join(path))
        except KeyError:
            continue
        layers.setdefault(i, {})[attr] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(leaf)))
    if sorted(layers) != list(range(len(layers))):
        raise KeyError(f"pool layers {sorted(layers)} are not 0..n-1")
    return PagedCache([PagedLayer(**layers[i]) for i in range(len(layers))])


def flax_from_pool(pool, scope: str = "layers") -> dict:
    """Inverse of :func:`pool_from_flax`: ``PagedCache`` -> nested JAX
    cache tree of numpy arrays (``layers_i/self_attn/<leaf>``)."""
    tree: dict = {}
    for path, t in pool_leaves(pool, scope).items():
        node = tree
        *mods, leaf = path.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = t.detach().cpu().numpy().copy()
    return tree
