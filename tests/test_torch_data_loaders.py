"""Slice 8's data layer and metric against the JAX package's, on the CPU:
``DigitsDataLoader`` (the port's own copy of the UCI digits, byte-equal
to scikit-learn's file), ``BpeLMLoader`` (its arrays, its split at the
byte cut, caches either package wrote loading in the other, the
tokenizer path), ``token_index_at_byte``, ``NpyDataLoader`` with uint8
``normalize`` on the host and on the device, the native gather against
numpy and against the JAX package's batcher, ``host_prefetch``, and
``lm_nll`` in value and gradient on plain and fused-head outputs.

Arrays and batches must be byte-identical; ``normalize`` atol 1e-6 (one
float32 rounding of the fused affine); ``lm_nll`` atol 1e-5 (summation
order).
"""
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_distributed_template_tpu.data  # noqa: F401  (register)
import pytorch_distributed_template_tpu.engine  # noqa: F401
from pytorch_distributed_template_tpu.config.registry import (
    LOADERS as JLOADERS,
)
from pytorch_distributed_template_tpu.data import native as jnative
from pytorch_distributed_template_tpu.data import tokenizer as jtok
from pytorch_distributed_template_tpu.engine import metrics as jmetrics
from pytorch_distributed_template_tpu_torch.config.registry import (
    LOADERS as TLOADERS,
)
from pytorch_distributed_template_tpu_torch.data import datasets as tdata
from pytorch_distributed_template_tpu_torch.data import loader as tloader
from pytorch_distributed_template_tpu_torch.data import native as tnative
from pytorch_distributed_template_tpu_torch.data import tokenizer as ttok
from pytorch_distributed_template_tpu_torch.engine import metrics as tmetrics

from test_torch_bytelm import _assert_same_batches
from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401


def _same_image_batches(jl, tl, epochs=(1, 2)):
    assert len(jl) == len(tl)
    for epoch in epochs:
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        for x, y in zip(jl, tl):
            assert sorted(x) == sorted(y)
            for k in x:
                a = np.asarray(x[k])
                assert a.dtype == y[k].dtype, k
                assert np.array_equal(a, y[k]), k


def test_vendored_digits_file_is_scikit_learns():
    import sklearn

    theirs = Path(sklearn.__file__).parent / "datasets" / "data" / \
        "digits.csv.gz"
    assert tdata.DIGITS_CSV.read_bytes() == theirs.read_bytes()
    assert len(tdata.DIGITS_CSV.read_bytes()) == 57523


@pytest.mark.parametrize("training, shuffle, seed", [
    (True, True, 0), (False, False, 0), (True, False, 7)])
def test_digits_loader_is_byte_identical(training, shuffle, seed):
    args = dict(batch_size=64, shuffle=shuffle, training=training,
                seed=seed)
    jl = JLOADERS.get("DigitsDataLoader")(**args)
    tl = TLOADERS.get("DigitsDataLoader")(**args)
    assert tl.n_samples == (1438 if training else 359)
    assert tl.arrays["image"].shape[1:] == (28, 28, 1)
    _same_image_batches(jl, tl)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """30 kB of code-like text whose tail compresses unlike its head (the
    byte cut and a fraction of the id stream differ there)."""
    path = tmp_path_factory.mktemp("bpe") / "corpus.txt"
    rng = np.random.default_rng(1)
    words = [b"def ", b"return ", b"self", b".value", b"\n", b"    ",
             b"(", b")", b"import ", b"# comment\n", b"for i in range(",
             b"\xc3\xa9t\xc3\xa9"]
    out = bytearray()
    while len(out) < 27000:
        out += words[rng.integers(len(words))]
    out += bytes(rng.integers(32, 127, 3000).astype(np.uint8))
    path.write_bytes(bytes(out))
    return path


def _bpe_args(path, **kw):
    return dict(dict(data_dir=str(path.parent), file=path.name,
                     vocab_size=300, batch_size=4, seq_len=64,
                     val_fraction=0.2, seed=3), **kw)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bpe_loader_arrays_and_caches_cross_packages(tmp_path, corpus,
                                                     writer):
    """One package builds the caches; the other reads them (no refit:
    mtimes unchanged); both give the same batches, train and val."""
    path = tmp_path / corpus.name
    path.write_bytes(corpus.read_bytes())
    first, second = ((JLOADERS, TLOADERS) if writer == "jax"
                     else (TLOADERS, JLOADERS))
    built = first.get("BpeLMLoader")(**_bpe_args(path, training=True))
    tok_path = ttok.bpe_cache_path(str(tmp_path), path.name, 300,
                                   val_fraction=0.2)
    ids_path = tok_path.with_suffix(".npy")
    assert built.tokenizer_path == tok_path and ids_path.exists()
    stamps = (tok_path.stat().st_mtime_ns, ids_path.stat().st_mtime_ns)
    for training in (True, False):
        other = second.get("BpeLMLoader")(
            **_bpe_args(path, training=training, shuffle=training))
        same = first.get("BpeLMLoader")(
            **_bpe_args(path, training=training, shuffle=training))
        jl, tl = (same, other) if writer == "jax" else (other, same)
        _assert_same_batches(jl, tl)
        assert tl.tokenizer_path == tok_path
        assert tl.arrays["tokens"].dtype == np.uint16
    assert stamps == (tok_path.stat().st_mtime_ns,
                      ids_path.stat().st_mtime_ns)


def test_bpe_split_falls_at_the_byte_cut(corpus):
    tok = ttok.BpeTokenizer.train_from_file(corpus, 300, sample_until=0.8)
    ids = tok.encode_file(corpus)
    cut = int(corpus.stat().st_size * 0.8)
    got = ttok.token_index_at_byte(tok, ids, cut)
    jtk = jtok.BpeTokenizer([tuple(m) for m in tok.merges])
    assert got == jtok.token_index_at_byte(jtk, ids, cut)
    lens = np.array([len(v) for v in tok.vocab])[ids]
    # the token that straddles the cut is train's, the next starts at or
    # after it
    assert lens[:got - 1].sum() < cut <= lens[:got].sum()
    for byte_cut in (0, 1, 17, cut + 5, int(lens.sum()), 10 ** 9):
        assert ttok.token_index_at_byte(tok, ids, byte_cut) == \
            jtok.token_index_at_byte(jtk, ids, byte_cut)


def test_bpe_loader_falls_back_to_synthetic_data(tmp_path):
    args = _bpe_args(tmp_path / "absent.txt", seq_len=32)
    _assert_same_batches(JLOADERS.get("BpeLMLoader")(**args),
                         TLOADERS.get("BpeLMLoader")(**args), epochs=(1,))


@pytest.fixture()
def npy_dir(tmp_path):
    rng = np.random.default_rng(4)
    for split, n in (("train", 70), ("val", 30)):
        np.save(tmp_path / f"{split}_images.npy",
                rng.integers(0, 256, (n, 6, 5, 3)).astype(np.uint8))
        np.save(tmp_path / f"{split}_labels.npy",
                rng.integers(0, 10, n).astype(np.int64))
    return tmp_path


NORM = {"mean": [0.4, 0.5, 0.6], "std": [0.2, 0.25, 0.3]}


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("normalize", [None, NORM])
def test_npy_loader_matches_jax(npy_dir, training, normalize):
    args = dict(data_dir=str(npy_dir), batch_size=16, training=training,
                shuffle=training, seed=2, normalize=normalize)
    jl = JLOADERS.get("NpyDataLoader")(**args)
    tl = TLOADERS.get("NpyDataLoader")(**args)
    assert tl.arrays["label"].dtype == np.int32
    assert isinstance(tl.arrays["image"], np.memmap)
    if normalize is None:
        _same_image_batches(jl, tl)
        return
    for x, y in zip(jl, tl):
        assert y["image"].dtype == np.float32
        np.testing.assert_allclose(y["image"], np.asarray(x["image"]),
                                   atol=1e-6)
        assert np.array_equal(np.asarray(x["label"]), y["label"])


def test_normalize_on_device_keeps_uint8_across_the_copy(npy_dir):
    args = dict(data_dir=str(npy_dir), batch_size=16, training=True,
                shuffle=False, normalize=dict(NORM, on_device=True))
    tl = TLOADERS.get("NpyDataLoader")(**args)
    host = dict(args, normalize=NORM)
    want = list(TLOADERS.get("NpyDataLoader")(**host))
    got = list(tloader.prefetch_to_device(tl, "cpu", 2,
                                          tl.device_transform))
    assert next(iter(tl))["image"].dtype == np.uint8
    for x, y in zip(want, got):
        assert y["image"].dtype == torch.float32
        np.testing.assert_allclose(y["image"].numpy(), x["image"],
                                   atol=1e-6)
    with pytest.raises(ValueError, match="uint8"):
        tloader.ArrayDataLoader({"image": np.zeros((4, 2), np.float32)}, 2,
                                normalize=NORM)


@pytest.mark.parametrize("dtype, shape", [
    (np.uint8, (300, 7)), (np.float32, (64, 4, 4, 3)), (np.uint16, (50,)),
    (np.int32, (2000, 600))])
def test_native_gather_equals_numpy_and_jax_batcher(dtype, shape):
    rng = np.random.default_rng(6)
    src = (rng.random(shape) * 1000).astype(dtype)
    idx = rng.integers(-len(src), len(src), 257)
    before = tnative.CALLS.calls
    got = tnative.gather(src, idx)
    assert tnative.available() and tnative.CALLS.calls == before + 1
    assert np.array_equal(got, src[idx])
    assert np.array_equal(got, jnative.gather(src, idx))
    # what the native code cannot take goes through numpy, uncounted
    strided = src[::2]
    assert np.array_equal(tnative.gather(strided, idx[idx < len(strided)]
                                         % len(strided)),
                          strided[idx[idx < len(strided)] % len(strided)])
    assert tnative.CALLS.calls == before + 1


def test_native_normalize_equals_jax_batcher():
    rng = np.random.default_rng(7)
    src = rng.integers(0, 256, (40, 8, 8, 3)).astype(np.uint8)
    idx = rng.integers(0, 40, 33)
    mean, std = np.array(NORM["mean"]), np.array(NORM["std"])
    got = tnative.gather_normalize_u8(src, idx, mean, std)
    assert np.array_equal(got, jnative.gather_normalize_u8(src, idx, mean,
                                                           std))
    np.testing.assert_allclose(
        got, (src[idx].astype(np.float32) / 255 - mean) / std, atol=1e-6)


def test_host_prefetch_keeps_order_and_raises_where_reached():
    seen = []

    def items():
        for i in range(6):
            seen.append(threading.current_thread().name)
            yield i
        raise KeyError("boom")

    it = tloader.host_prefetch(items(), depth=2)
    assert [next(it) for _ in range(6)] == list(range(6))
    with pytest.raises(KeyError, match="boom"):
        next(it)
    assert set(seen) == {"host-prefetch"}
    # a consumer that stops early releases the thread
    slow = tloader.host_prefetch(iter(range(100)), depth=2)
    assert next(slow) == 0
    slow.close()
    time.sleep(0.3)
    assert not any(t.name == "host-prefetch" and t.is_alive()
                   for t in threading.enumerate())


def _lm_inputs(fused: bool):
    rng = np.random.default_rng(8)
    tgt = rng.integers(0, 50, (3, 9)).astype(np.int32)
    if fused:
        h = rng.standard_normal((3, 9, 16)).astype(np.float32)
        w = (rng.standard_normal((16, 50)) * 0.3).astype(np.float32)
        return (h, w), tgt
    return rng.standard_normal((3, 9, 50)).astype(np.float32), tgt


@pytest.mark.parametrize("fused", [False, True])
def test_lm_nll_value_and_gradient_match_jax(fused):
    out, tgt = _lm_inputs(fused)
    if fused:
        jout = tuple(jnp.asarray(a) for a in out)
        tout = tuple(torch.tensor(a, requires_grad=True) for a in out)
    else:
        jout = jnp.asarray(out)
        tout = torch.tensor(out, requires_grad=True)

    def jloss(o):
        return jmetrics.lm_nll(o, jnp.asarray(tgt)).sum()

    want = np.asarray(jmetrics.lm_nll(jout, jnp.asarray(tgt)))
    got = tmetrics.lm_nll(tout, torch.from_numpy(tgt))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    got.sum().backward()
    jgrad = jax.grad(jloss)(jout)
    for tg, jg in zip(tout if fused else (tout,),
                      jgrad if fused else (jgrad,)):
        np.testing.assert_allclose(tg.grad.numpy(), np.asarray(jg),
                                   atol=1e-5)
    assert tmetrics.METRICS.get("lm_nll") is tmetrics.lm_nll
