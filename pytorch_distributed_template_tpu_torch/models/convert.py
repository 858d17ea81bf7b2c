"""Flax param tree <-> the port's state dict, for the Llama and GPT-2
families.

The JAX package's params are nested dicts (``layers_0/self_attn/q_proj/
kernel``, ``h_0/attn/qkv/bias``); the port's modules name the same weights
``layers.0.self_attn.q_proj.weight``, ``h.0.attn.qkv.bias``. The
translation:

- ``layers_i`` / ``h_i`` <-> ``layers.i`` / ``h.i``;
- every ``*/kernel`` ``[in, out]`` -> ``*.weight`` ``[out, in]`` (the
  ``nn.Linear`` layout), transposed — ``lm_head/kernel`` included;
- ``embed_tokens/embedding``, ``wte/embedding`` -> ``*.weight`` as is;
- LayerNorm ``scale`` -> ``weight``; ``bias`` and RMSNorm ``weight``
  leaves as they are; the bare ``wpe`` param as it is.

Both directions take and give plain containers: nested dicts of numpy
arrays on the flax side, a flat dict of CPU tensors on the torch side.
:func:`flax_path` gives the JAX path string of a port parameter (what the
optimizer's ``weight_decay_exclude`` regexes are matched against).

The KV block pool crosses the same way (:func:`pool_from_flax`,
:func:`flax_from_pool`): the JAX pool's cache leaves
``layers_i/self_attn/cached_key`` / ``cached_value`` ``[P, bt, KVH, D]``
(and ``cached_key_scale`` / ``cached_value_scale`` ``[P, bt, KVH]`` for the
int8 layout) are the port's ``PagedLayer`` tensors, byte for byte.
"""
from __future__ import annotations

import re

import numpy as np
import torch

_LAYER = re.compile(r"^layers_(\d+)$")
_INDEXED = re.compile(r"^(layers|h)_(\d+)$")
_INDEXED_PARENTS = ("layers", "h")
_EMBEDDINGS = ("wte", "embed_tokens")


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flatten(val, path)
        else:
            yield path, val


def _is_layer_norm(module: str) -> bool:
    return module.startswith("ln_")


def flax_path(name: str) -> str:
    """The JAX param path of port parameter ``name``:
    ``h.0.attn.qkv.weight`` -> ``h_0/attn/qkv/kernel``,
    ``h.0.ln_1.weight`` -> ``h_0/ln_1/scale``, ``wte.weight`` ->
    ``wte/embedding``, ``layers.1.input_layernorm.weight`` ->
    ``layers_1/input_layernorm/weight``, ``wpe`` -> ``wpe``."""
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
    if leaf == "weight":
        owner = mods[-1]
        if owner in _EMBEDDINGS:
            leaf = "embedding"
        elif _is_layer_norm(owner):
            leaf = "scale"
        elif not (owner.endswith("layernorm") or owner == "norm"):
            leaf = "kernel"
    elif leaf != "bias":
        raise KeyError(f"unexpected state-dict entry {name}")
    return "/".join(mods + [leaf])


def params_from_flax(tree) -> dict:
    """Flax param tree (nested dicts of arrays) -> torch state dict."""
    out = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf)
        parts = [_INDEXED.sub(r"\1.\2", p) for p in path[:-1]]
        last = path[-1]
        if not parts:
            if last != "wpe":
                raise KeyError(f"unexpected flax leaf {last}")
            name = last
        elif last == "kernel":
            arr, name = arr.T, "weight"
        elif last in ("embedding", "weight", "scale"):
            name = "weight"
        elif last == "bias":
            name = "bias"
        else:
            raise KeyError(f"unexpected flax leaf {'/'.join(path)}")
        out[".".join(parts + [name])] = torch.tensor(
            np.ascontiguousarray(arr))
    return out


def flax_from_params(state_dict) -> dict:
    """Inverse of :func:`params_from_flax`: torch state dict -> flax tree
    of float32 numpy arrays."""
    tree: dict = {}
    for name, tensor in state_dict.items():
        path = flax_path(name).split("/")
        arr = tensor.detach().to("cpu", torch.float32).numpy()
        if path[-1] == "kernel":
            arr = arr.T
        node = tree
        for m in path[:-1]:
            node = node.setdefault(m, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return tree


_POOL_LEAVES = {"cached_key": "k", "cached_value": "v",
                "cached_key_scale": "k_scale",
                "cached_value_scale": "v_scale"}


def pool_from_flax(tree):
    """JAX pool leaves (a nested cache tree, or ``PrefixCache.pool``'s
    flat ``{"layers_0/self_attn/cached_key": ...}`` dict) -> the port's
    ``PagedCache`` of CPU tensors, bytes unchanged."""
    from .llama import PagedCache, PagedLayer

    layers: dict = {}
    for path, leaf in _flatten(tree):
        parts = "/".join(path).split("/")
        m = _LAYER.match(parts[0])
        if m is None or parts[-1] not in _POOL_LEAVES:
            continue
        layers.setdefault(int(m.group(1)), {})[_POOL_LEAVES[parts[-1]]] = \
            torch.from_numpy(np.ascontiguousarray(np.asarray(leaf)))
    if sorted(layers) != list(range(len(layers))):
        raise KeyError(f"pool layers {sorted(layers)} are not 0..n-1")
    return PagedCache([PagedLayer(**layers[i]) for i in range(len(layers))])


def flax_from_pool(pool) -> dict:
    """Inverse of :func:`pool_from_flax`: ``PagedCache`` -> nested JAX
    cache tree of numpy arrays (``layers_i/self_attn/<leaf>``)."""
    tree: dict = {}
    for i, layer in enumerate(pool.layers):
        attn = tree.setdefault(f"layers_{i}", {}).setdefault(
            "self_attn", {})
        for name, attr in _POOL_LEAVES.items():
            t = getattr(layer, attr)
            if t is not None:
                attn[name] = t.detach().cpu().numpy().copy()
    return tree
