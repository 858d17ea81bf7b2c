"""Convert an image dataset into the uint8 mmap shards that
``ShardedImageNetLoader`` trains from (the port's counterpart of the
repository's ``scripts/make_image_shards.py``; the same files)::

    <out>/{split}_images_0000.npy  uint8 [n, H, W, C]
    <out>/{split}_labels_0000.npy  int32 [n]

Sources (one):

- ``--from-npy IMAGES.npy LABELS.npy``: re-shard one aligned pair
  (images uint8, or float in [0, 1] or [0, 255]; read through mmap, so
  the input may exceed memory);
- ``--synthetic N``: the deterministic synthetic ImageNet of
  ``data/datasets.py``, min-max rescaled into uint8 over the whole set.

Conversion streams one shard at a time::

    python -m pytorch_distributed_template_tpu_torch.tools.make_image_shards \\
        --synthetic 4096 --out data/imagenet_shards --split train
"""
from __future__ import annotations

import argparse

import numpy as np

from ..data.sharded import write_image_shards


def _float_scale(images, chunk: int = 1024) -> float:
    """One decision for a float source, from its largest magnitude over
    the whole array: values in [0, 1] scale by 255, else by 1."""
    hi = 0.0
    for start in range(0, len(images), chunk):
        part = np.asarray(images[start:start + chunk], np.float32)
        hi = max(hi, float(np.max(np.abs(part))))
    scale = 255.0 if hi <= 1.0 else 1.0
    print(f"float source: |max| = {hi:.3f} -> scale {scale:g}")
    return scale


def _to_u8(img: np.ndarray, scale: float = 1.0) -> np.ndarray:
    if img.dtype == np.uint8:
        return img
    x = np.asarray(img, np.float32) * scale
    return np.clip(x, 0, 255).astype(np.uint8)


def _iter_npy(images_path: str, labels_path: str):
    images = np.load(images_path, mmap_mode="r")
    labels = np.load(labels_path, mmap_mode="r")
    if len(images) != len(labels):
        raise SystemExit(f"{images_path} has {len(images)} samples but "
                         f"{labels_path} has {len(labels)}")
    scale = 1.0 if images.dtype == np.uint8 else _float_scale(images)
    for i in range(len(images)):
        yield _to_u8(images[i], scale), int(labels[i])


def _iter_synthetic(n: int, image_size: int, split: str):
    from ..data.datasets import synthetic_imagenet

    data = synthetic_imagenet(n=n, image_size=image_size,
                              training=split == "train")
    # min-max over the whole set into uint8, so the class structure
    # survives the quantisation
    x = data["image"]
    lo, hi = float(np.min(x)), float(np.max(x))
    span = max(hi - lo, 1e-9)
    for i in range(n):
        img = (np.asarray(x[i], np.float32) - lo) / span * 255.0
        yield img.astype(np.uint8), int(data["label"][i])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--from-npy", nargs=2, metavar=("IMAGES", "LABELS"))
    src.add_argument("--synthetic", type=int, metavar="N")
    ap.add_argument("--out", required=True)
    ap.add_argument("--split", default="train", choices=["train", "val"])
    ap.add_argument("--shard-size", type=int, default=8192)
    ap.add_argument("--image-size", type=int, default=224)
    args = ap.parse_args(argv)
    if args.from_npy:
        samples = _iter_npy(*args.from_npy)
    else:
        samples = _iter_synthetic(args.synthetic, args.image_size,
                                  args.split)
    n = write_image_shards(samples, args.out, split=args.split,
                           shard_size=args.shard_size)
    print(f"wrote {n} samples to {args.out} "
          f"({-(-n // args.shard_size)} shards of <= {args.shard_size})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
