"""Flax param tree <-> the port's state dict, for the Llama family.

The JAX package's params are nested dicts (``layers_0/self_attn/q_proj/
kernel``); the port's modules name the same weights
``layers.0.self_attn.q_proj.weight``. The translation:

- ``embed_tokens/embedding`` ``[V, D]`` -> ``embed_tokens.weight``, as is;
- every ``*/kernel`` ``[in, out]`` -> ``*.weight`` ``[out, in]`` (the
  ``nn.Linear`` layout), transposed — ``lm_head/kernel`` included;
- RMSNorm ``weight`` leaves go across as they are.

Both directions take and give plain containers: nested dicts of numpy
arrays on the flax side, a flat dict of CPU tensors on the torch side.
"""
from __future__ import annotations

import re

import numpy as np
import torch

_LAYER = re.compile(r"^layers_(\d+)$")


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flatten(val, path)
        else:
            yield path, val


def params_from_flax(tree) -> dict:
    """Flax param tree (nested dicts of arrays) -> torch state dict."""
    out = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf)
        parts = [_LAYER.sub(r"layers.\1", p) for p in path[:-1]]
        last = path[-1]
        if last == "kernel":
            arr = arr.T
        elif last not in ("embedding", "weight"):
            raise KeyError(f"unexpected flax leaf {'/'.join(path)}")
        out[".".join(parts + ["weight"])] = torch.tensor(
            np.ascontiguousarray(arr))
    return out


def flax_from_params(state_dict) -> dict:
    """Inverse of :func:`params_from_flax`: torch state dict -> flax tree
    of float32 numpy arrays."""
    tree: dict = {}
    for name, tensor in state_dict.items():
        parts = name.split(".")
        if parts[-1] != "weight":
            raise KeyError(f"unexpected state-dict entry {name}")
        mods = []
        i = 0
        while i < len(parts) - 1:
            if parts[i] == "layers":
                mods.append(f"layers_{parts[i + 1]}")
                i += 2
            else:
                mods.append(parts[i])
                i += 1
        arr = tensor.detach().to("cpu", torch.float32).numpy()
        if mods[-1] == "embed_tokens":
            leaf = "embedding"
        elif mods[-1].endswith("layernorm") or mods[-1] == "norm":
            leaf = "weight"
        else:
            leaf, arr = "kernel", arr.T
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree
