"""The port's MNIST data layer against the JAX package's: the synthetic
arrays byte for byte, ``_try_load_mnist`` on raw and gzipped idx files
written here, and the loaders' batches and masks (shuffled or not, one
process or a shard of two via ``ShardedSampler``) over 2 epochs. Exact
equality throughout: both sides are numpy."""
import gzip

import numpy as np
import pytest

from pytorch_distributed_template_tpu.data import datasets as jdata
from pytorch_distributed_template_tpu.data.loader import (
    ArrayDataLoader as JLoader,
)
from pytorch_distributed_template_tpu.data.sampler import (
    ShardedSampler as JSampler,
)

from pytorch_distributed_template_tpu_torch.config.registry import LOADERS
from pytorch_distributed_template_tpu_torch.data import datasets as tdata
from pytorch_distributed_template_tpu_torch.data.loader import (
    ArrayDataLoader as TLoader, prefetch_to_device,
)
from pytorch_distributed_template_tpu_torch.data.sampler import (
    ShardedSampler as TSampler,
)


@pytest.mark.parametrize("training", [True, False])
def test_synthetic_mnist_is_byte_identical(training):
    a = jdata.synthetic_mnist(n=37, seed=5, training=training)
    b = tdata.synthetic_mnist(n=37, seed=5, training=training)
    for k in ("image", "label"):
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert a[k].tobytes() == b[k].tobytes()
    assert b["image"].shape == (37, 28, 28, 1)


def _write_idx(root, training, n, compress):
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, n, dtype=np.uint8)
    stem = "train" if training else "t10k"
    sub = root / "MNIST" / "raw"
    sub.mkdir(parents=True, exist_ok=True)
    op = gzip.open if compress else open
    sfx = ".gz" if compress else ""
    with op(sub / f"{stem}-images-idx3-ubyte{sfx}", "wb") as f:
        f.write(b"\0" * 16 + images.tobytes())
    with op(sub / f"{stem}-labels-idx1-ubyte{sfx}", "wb") as f:
        f.write(b"\0" * 8 + labels.tobytes())


@pytest.mark.parametrize("compress", [False, True])
def test_idx_files_load_as_in_jax(tmp_path, compress):
    _write_idx(tmp_path, True, 12, compress)
    _write_idx(tmp_path, False, 5, compress)
    for training, n in ((True, 12), (False, 5)):
        a = jdata._try_load_mnist(tmp_path, training)
        b = tdata._try_load_mnist(tmp_path, training)
        assert b["image"].shape == (n, 28, 28, 1)
        for k in ("image", "label"):
            assert a[k].dtype == b[k].dtype
            assert np.array_equal(a[k], b[k])
    assert tdata._try_load_mnist(tmp_path / "missing", True) is None
    loader = LOADERS.get("MnistDataLoader")(data_dir=str(tmp_path),
                                            batch_size=4, training=False)
    assert loader.n_samples == 5


def _batches(loader, epoch):
    loader.set_epoch(epoch)
    return [{k: np.asarray(v) for k, v in b.items()} for b in loader]


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_batches_and_masks_match_jax(shuffle, shards):
    """n = 75 over batches of 16 per process: the last batch is padded by
    wraparound, and with 2 shards the sampler pads the set to 76 too."""
    data = tdata.synthetic_mnist(n=75, seed=2)
    for rank in range(shards):
        js = ts = None
        if shards > 1:
            js = JSampler(75, shards, rank, shuffle=shuffle, seed=2)
            ts = TSampler(75, shards, rank, shuffle=shuffle, seed=2)
        jl = JLoader(data, batch_size=16, shuffle=shuffle, sampler=js,
                     seed=2)
        tl = TLoader(data, batch_size=16, shuffle=shuffle, sampler=ts,
                     seed=2)
        assert len(tl) == len(jl)
        for epoch in (1, 2):
            jb, tb = _batches(jl, epoch), _batches(tl, epoch)
            assert len(jb) == len(tb) == len(tl)
            for x, y in zip(jb, tb):
                assert sorted(x) == sorted(y) == ["image", "label", "mask"]
                for k in x:
                    assert np.array_equal(x[k], y[k]), k
        real = sum(int(b["mask"].sum()) for b in tb)
        assert real == (75 if shards == 1 else 38 - (rank == 1))


def test_prefetch_on_the_cpu_gives_the_batches_as_tensors():
    import torch

    tl = TLoader(tdata.synthetic_mnist(n=20, seed=0), batch_size=8)
    got = list(prefetch_to_device(tl, "cpu", depth=2))
    want = list(tl)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert all(isinstance(v, torch.Tensor) for v in g.values())
        for k in w:
            assert np.array_equal(g[k].numpy(), w[k])
