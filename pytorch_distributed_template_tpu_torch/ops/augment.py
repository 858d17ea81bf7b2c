"""Data augmentation inside the train step: the port of the JAX package's
``ops/augment.py`` (``random_flip``, ``random_crop``, ``random_cutout``,
``build_augment``).

Each transform is split in two:

- a host-side draw (numpy) of its per-example randomness for the
  **global** batch: the flip flags, the crop offsets, the cutout corners;
- a device-side apply that takes those draws and the ``[B, H, W, C]``
  batch (``apply_flip``, ``apply_crop``, ``apply_cutout``).

The JAX step draws from ``fold_in(fold_in(rng, step), 7919)`` on the
device, per example of the global batch, and transform ``i`` (in the
order flip, crop, cutout, the enabled ones counted) from
``fold_in(that, i)``. The port draws from
``fold_in(fold_in(fold_in(seed, step), 7919), i)`` (``models.layers.
fold_in``) with numpy's Philox, for the whole global batch on every
rank, and each rank keeps its own rows (:meth:`Augment.draw`'s
``shard``): a data shard's row ``j`` is the global batch's row ``j x
count + index`` (``data/sampler.py``: shard ``i`` takes positions
``i::count`` of the global order). The draws are therefore the same on
the card and on the CPU, on one rank and on four, and after a resume.
JAX's threefry and the port's Philox give different numbers from the
same seed: an augmented step is reproducible within each package, not
across them. The applies are exact: fed JAX's own draws they give JAX's
output bit for bit (``tests/test_torch_augment.py``).

The crop's reflect padding is folded into the gather's indices (a
padded coordinate ``u`` reads row ``reflect(u - p)``), so one gather
makes the cropped batch and nothing is padded in memory.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..models.layers import fold_in

#: folded into the step's seed for the augment draws (the JAX step's
#: constant: outside the 0..k-1 microbatch range)
AUGMENT_SALT = 7919
_KEYS = ("flip", "crop_padding", "cutout")


def _rng(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=int(seed)))


def draw_flip(seed: int, b: int) -> np.ndarray:
    """Per-example coin tosses, ``[b]`` bool."""
    return _rng(seed).random(b) < 0.5


def draw_crop(seed: int, b: int, padding: int) -> np.ndarray:
    """Per-example window offsets in ``[0, 2 padding]``, ``[2, b]``
    (rows, then columns)."""
    return _rng(seed).integers(0, 2 * padding + 1, size=(2, b))


def draw_cutout(seed: int, b: int, h: int, w: int, size: int) -> np.ndarray:
    """Per-example square corners placed fully inside the image, ``[2,
    b]`` (rows in ``[0, h - size]``, columns in ``[0, w - size]``)."""
    rng = _rng(seed)
    return np.stack([rng.integers(0, max(h - size + 1, 1), size=b),
                     rng.integers(0, max(w - size + 1, 1), size=b)])


def apply_flip(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of the rows where ``flip`` is true."""
    return torch.where(flip[:, None, None, None], x.flip(2), x)


def _reflect(u: torch.Tensor, n: int) -> torch.Tensor:
    """Index into ``0..n-1`` of position ``u`` of numpy's ``reflect``
    padding (the edge is not repeated); ``|u| < n``."""
    u = u.abs()
    return torch.where(u >= n, 2 * (n - 1) - u, u)


def apply_crop(x: torch.Tensor, offsets: torch.Tensor,
               padding: int) -> torch.Tensor:
    """The ``H x W`` window at ``offsets`` ``[2, B]`` of each example
    reflect-padded by ``padding`` on both spatial axes."""
    b, h, w, _ = x.shape
    rows = _reflect(offsets[0][:, None] - padding
                    + torch.arange(h, device=x.device)[None, :], h)
    cols = _reflect(offsets[1][:, None] - padding
                    + torch.arange(w, device=x.device)[None, :], w)
    batch = torch.arange(b, device=x.device)[:, None, None]
    return x[batch, rows[:, :, None], cols[:, None, :], :]


def apply_cutout(x: torch.Tensor, corners: torch.Tensor,
                 size: int) -> torch.Tensor:
    """Zero the ``size x size`` square at ``corners`` ``[2, B]`` of each
    example."""
    _, h, w, _ = x.shape
    ys = torch.arange(h, device=x.device)[None, :, None]
    xs = torch.arange(w, device=x.device)[None, None, :]
    oy, ox = corners[0][:, None, None], corners[1][:, None, None]
    mask = (ys >= oy) & (ys < oy + size) & (xs >= ox) & (xs < ox + size)
    return x.masked_fill(mask[..., None], 0)


class Augment:
    """The configured transforms, in the JAX order (flip, crop, cutout).
    :meth:`draw` makes a step's draws on the host, :meth:`apply` runs
    them on the batch's device."""

    def __init__(self, flip: bool, crop_padding: int, cutout: int):
        self.flip, self.crop_padding, self.cutout = (
            bool(flip), int(crop_padding), int(cutout))
        self.steps = [name for name, on in (
            ("flip", self.flip), ("crop", self.crop_padding > 0),
            ("cutout", self.cutout > 0)) if on]

    def draw(self, seed: int, b: int, h: int, w: int,
             shard=(0, 1)) -> Dict[str, np.ndarray]:
        """The draws of step seed ``seed`` (the step's ``fold_in(seed,
        step)``) for a global batch of ``b`` rows of ``h x w``, the
        rows of data shard ``shard = (index, count)`` kept."""
        index, count = shard
        key = fold_in(seed, AUGMENT_SALT)
        out = {}
        for i, name in enumerate(self.steps):
            k = fold_in(key, i)
            if name == "flip":
                out[name] = draw_flip(k, b)
            elif name == "crop":
                out[name] = draw_crop(k, b, self.crop_padding)
            else:
                out[name] = draw_cutout(k, b, h, w, self.cutout)
        return {name: d[..., index::count] for name, d in out.items()}

    def apply(self, x: torch.Tensor, draws: Dict[str, torch.Tensor]
              ) -> torch.Tensor:
        """The transforms on ``x`` ``[B, H, W, C]`` with ``draws`` (as
        :meth:`draw` gives them, as tensors on ``x``'s device)."""
        for name in self.steps:
            if name == "flip":
                x = apply_flip(x, draws[name])
            elif name == "crop":
                x = apply_crop(x, draws[name], self.crop_padding)
            else:
                x = apply_cutout(x, draws[name], self.cutout)
        return x

    def __call__(self, seed: int, x: torch.Tensor, shard=(0, 1)
                 ) -> torch.Tensor:
        """Draw for the global batch ``x``'s shard belongs to and apply:
        one pinned, non-blocking copy of the draws to ``x``'s device."""
        b, h, w, _ = x.shape
        draws = self.draw(seed, b * shard[1], h, w, shard)
        return self.apply(x, to_device(draws, x.device))


def to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str,
                                                             torch.Tensor]:
    """Small host arrays on ``device``: pinned and non-blocking on CUDA
    (no synchronisation), as they are on the CPU."""
    out = {}
    for name, a in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        if torch.device(device).type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[name] = t
    return out


def build_augment(cfg: Optional[dict]) -> Optional[Augment]:
    """The ``trainer.augment`` block (``{"flip": true, "crop_padding": 4,
    "cutout": 8}``, every key optional) as an :class:`Augment`, or None
    when nothing is enabled. Unknown keys raise."""
    if not cfg:
        return None
    unknown = set(cfg) - set(_KEYS)
    if unknown:
        raise ValueError(
            f"unknown trainer.augment keys {sorted(unknown)}; "
            "valid: flip, crop_padding, cutout")
    aug = Augment(cfg.get("flip", False), cfg.get("crop_padding", 0),
                  cfg.get("cutout", 0))
    return aug if aug.steps else None
