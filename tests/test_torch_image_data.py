"""The port's image data layer (``data/datasets.py``'s CIFAR-10 and
ImageNet loaders, ``data/sharded.py``, ``tools/make_image_shards.py``)
against the JAX package's. Exact equality (both sides are numpy) but for
the on-device normalize, a float32 ``(x / 255 - mean) / std`` on each
side (atol 1e-6):

- ``synthetic_cifar10`` and ``synthetic_imagenet`` byte for byte;
- a CIFAR-10 pickle directory written here (``data_batch_1``..``5``,
  ``test_batch``), read and normalised as the JAX loader does;
- uint8 shards written by each package read by the other
  (``open_sharded_split``), ``gather`` and ``gather_normalize`` equal
  (the native batcher's fused pass against the JAX package's);
- ``ShardedImageNetLoader``'s batches (shards, fused normalize or
  ``on_device``; the synthetic fallback without shards) and
  ``SyntheticImageNetLoader``'s, over 2 epochs and a shard of 2;
- the port's ``tools/make_image_shards.py`` (``--synthetic``,
  ``--from-npy``) writes the files the repository's
  ``scripts/make_image_shards.py`` writes, byte for byte.
"""
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_distributed_template_tpu.config import LOADERS as JLOADERS
from pytorch_distributed_template_tpu.data import datasets as jdata
from pytorch_distributed_template_tpu.data import sharded as jsharded

from pytorch_distributed_template_tpu_torch.config.registry import LOADERS
from pytorch_distributed_template_tpu_torch.data import datasets as tdata
from pytorch_distributed_template_tpu_torch.data import native
from pytorch_distributed_template_tpu_torch.data import sharded as tsharded
from pytorch_distributed_template_tpu_torch.data.loader import (
    prefetch_to_device,
)
from pytorch_distributed_template_tpu_torch.tools import make_image_shards

REPO = Path(__file__).resolve().parent.parent
MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("training", [True, False])
def test_synthetic_sets_are_byte_identical(training):
    _same(jdata.synthetic_cifar10(n=21, seed=3, training=training),
          tdata.synthetic_cifar10(n=21, seed=3, training=training))
    _same(jdata.synthetic_imagenet(n=9, image_size=48, seed=2,
                                   training=training, num_classes=7),
          tdata.synthetic_imagenet(n=9, image_size=48, seed=2,
                                   training=training, num_classes=7))
    with pytest.raises(ValueError, match="multiple of 16"):
        tdata.synthetic_imagenet(n=2, image_size=40)


def _write_cifar(root: Path, per_batch: int = 6):
    rng = np.random.default_rng(0)
    base = root / "cifar-10-batches-py"
    base.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        d = {b"data": rng.integers(0, 256, (per_batch, 3072),
                                   dtype=np.uint8),
             b"labels": list(rng.integers(0, 10, per_batch))}
        with open(base / name, "wb") as f:
            pickle.dump(d, f)


def _batches(loader, epochs=(0, 1)):
    out = []
    for e in epochs:
        loader.set_epoch(e)
        out += [dict(b) for b in loader]
    return out


def test_cifar_pickles_load_as_in_jax(tmp_path):
    _write_cifar(tmp_path)
    for training, n in ((True, 30), (False, 6)):
        a = jdata._try_load_cifar10(tmp_path, training)
        b = tdata._try_load_cifar10(tmp_path, training)
        _same(a, b)
        assert b["image"].shape == (n, 32, 32, 3)
    assert tdata._try_load_cifar10(tmp_path / "nothing", True) is None
    args = dict(data_dir=str(tmp_path), batch_size=8, shuffle=True)
    for ja, tb in zip(_batches(JLOADERS.get("Cifar10DataLoader")(**args)),
                      _batches(LOADERS.get("Cifar10DataLoader")(**args))):
        _same(ja, tb)
    # no pickles: the synthetic set, as in JAX
    args = dict(data_dir=str(tmp_path / "none"), batch_size=16,
                synthetic_n=40, training=False, shuffle=False)
    for ja, tb in zip(_batches(JLOADERS.get("Cifar10DataLoader")(**args)),
                      _batches(LOADERS.get("Cifar10DataLoader")(**args))):
        _same(ja, tb)


def _samples(n, size=16, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        yield rng.integers(0, 256, (size, size, 3), dtype=np.uint8), i % 5


@pytest.mark.parametrize("writer,reader", [(jsharded, tsharded),
                                           (tsharded, jsharded)])
def test_shards_cross_read(tmp_path, writer, reader):
    for split in ("train", "val"):
        assert writer.write_image_shards(_samples(23), tmp_path, split=split,
                                         shard_size=7) == 23
    assert len(reader.find_shards(tmp_path, "train")) == 4
    for training in (True, False):
        a_img, a_lbl = jsharded.open_sharded_split(tmp_path, training)
        b_img, b_lbl = tsharded.open_sharded_split(tmp_path, training)
        assert a_lbl.tobytes() == b_lbl.tobytes()
        assert len(a_img) == len(b_img) == 23
        idx = np.array([22, 0, 7, 6, 13, 14, 3, 21])
        assert a_img.gather(idx).tobytes() == b_img.gather(idx).tobytes()
        mean, std = np.array(MEAN, np.float32), np.array(STD, np.float32)
        assert (a_img.gather_normalize(idx, mean, std).tobytes()
                == b_img.gather_normalize(idx, mean, std).tobytes())
        np.testing.assert_array_equal(b_img[2:5], a_img[2:5])
    assert tsharded.open_sharded_split(tmp_path / "none", True) is None


def test_gather_normalize_is_native_and_equal(tmp_path):
    tsharded.write_image_shards(_samples(10), tmp_path, shard_size=4)
    images, _ = tsharded.open_sharded_split(tmp_path, True)
    idx = np.arange(10)[::-1].copy()
    mean, std = np.array(MEAN, np.float32), np.array(STD, np.float32)
    native.CALLS.reset()
    got = images.gather_normalize(idx, mean, std)
    assert native.CALLS.calls == 3      # one per shard
    want = (images.gather(idx).astype(np.float32) / 255.0 - mean) / std
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_unpaired_shards_raise(tmp_path):
    tsharded.write_image_shards(_samples(5), tmp_path, shard_size=2)
    (tmp_path / "train_labels_0002.npy").unlink()
    with pytest.raises(ValueError, match="corrupt"):
        tsharded.open_sharded_split(tmp_path, True)


@pytest.mark.parametrize("on_device,shard", [(True, None), (False, None),
                                             (True, (1, 2))])
def test_sharded_imagenet_loader_batches_match_jax(tmp_path, on_device,
                                                   shard):
    for split in ("train", "val"):
        jsharded.write_image_shards(_samples(19), tmp_path, split=split,
                                    shard_size=8)
    norm = {"mean": MEAN, "std": STD, "on_device": on_device}
    args = dict(data_dir=str(tmp_path), batch_size=4, shuffle=True,
                normalize=norm)
    jl = JLOADERS.get("ShardedImageNetLoader")(**args)
    if shard is not None:
        from pytorch_distributed_template_tpu.data.sampler import (
            ShardedSampler,
        )
        jl.sampler = ShardedSampler(19, num_shards=shard[1],
                                    shard_index=shard[0], shuffle=True)
        jl.shuffle = False
    tl = LOADERS.get("ShardedImageNetLoader")(**args, shard=shard)
    jt, tt = jl.device_transform, tl.device_transform
    assert (jt is None) == (tt is None) == (not on_device)
    jb = _batches(jl)
    tb = list(b for e in (0, 1) for b in (tl.set_epoch(e) or
                                          prefetch_to_device(tl, "cpu", 2,
                                                             tt)))
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        if on_device:
            a = {k: np.asarray(v) for k, v in jt(a).items()}
            assert b["image"].dtype == torch.float32
        np.testing.assert_array_equal(a["label"], b["label"].numpy())
        np.testing.assert_array_equal(a["mask"], b["mask"].numpy())
        np.testing.assert_allclose(b["image"].numpy(), a["image"],
                                   atol=1e-6)


def test_imagenet_fallbacks_match_jax(tmp_path):
    args = dict(data_dir=str(tmp_path), batch_size=4, image_size=32,
                num_classes=5, seed=1)
    for ja, tb in zip(
            _batches(JLOADERS.get("ShardedImageNetLoader")(
                synthetic_n=10, **args)),
            _batches(LOADERS.get("ShardedImageNetLoader")(
                synthetic_n=10, **args))):
        _same(ja, tb)
    for ja, tb in zip(
            _batches(JLOADERS.get("SyntheticImageNetLoader")(n=10, **args)),
            _batches(LOADERS.get("SyntheticImageNetLoader")(n=10, **args))):
        _same(ja, tb)


def test_tool_writes_the_scripts_files(tmp_path):
    jout, tout = tmp_path / "jax", tmp_path / "port"
    common = ["--split", "val", "--shard-size", "3", "--image-size", "32"]
    subprocess.run([sys.executable, str(REPO / "scripts" /
                                        "make_image_shards.py"),
                    "--synthetic", "7", "--out", str(jout)] + common,
                   check=True, capture_output=True, cwd=REPO, timeout=300)
    assert make_image_shards.main(["--synthetic", "7", "--out", str(tout)]
                                  + common) == 0
    names = sorted(p.name for p in jout.iterdir())
    assert names == sorted(p.name for p in tout.iterdir())
    assert len(names) == 6
    for name in names:
        assert (jout / name).read_bytes() == (tout / name).read_bytes()
    # --from-npy: floats in [0, 1] scaled by 255
    x = np.random.default_rng(0).random((5, 8, 8, 3)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "y.npy", np.arange(5))
    make_image_shards.main(["--from-npy", str(tmp_path / "x.npy"),
                            str(tmp_path / "y.npy"), "--out",
                            str(tmp_path / "npy")])
    images, labels = tsharded.open_sharded_split(tmp_path / "npy", True)
    np.testing.assert_array_equal(images[:5], (x * 255).astype(np.uint8))
    np.testing.assert_array_equal(labels, np.arange(5))
