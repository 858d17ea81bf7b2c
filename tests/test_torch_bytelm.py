"""Slice 4's data and metric against the JAX package's, on the CPU: the
port's ``ByteLMLoader`` (real bytes from a small file, train and val
splits, padded last batches, and the synthetic fallback when the file is
absent), the port's copy of ``scripts/make_text_corpus.py``
(``tools/make_text_corpus.py``: the same bytes), and
``lm_bits_per_byte`` on plain and fused-head outputs.

Loader batches must be byte-identical (same memory-mapped bytes, same
permutations, same padding and masks). The metric: atol 1e-5 in float32
(summation order).
"""
import logging

import jax  # noqa: F401  (the JAX side runs on the CPU)
import numpy as np
import pytest
import torch

import pytorch_distributed_template_tpu.data  # noqa: F401  (register)
import pytorch_distributed_template_tpu.engine  # noqa: F401
import scripts.make_text_corpus as jcorpus
from pytorch_distributed_template_tpu.config.registry import (
    LOADERS as JLOADERS,
)
from pytorch_distributed_template_tpu.engine import metrics as jmetrics
from pytorch_distributed_template_tpu_torch.config.registry import (
    LOADERS as TLOADERS, METRICS as TMETRICS,
)
from pytorch_distributed_template_tpu_torch.data import datasets  # noqa: F401
from pytorch_distributed_template_tpu_torch.engine import metrics as tmetrics
from pytorch_distributed_template_tpu_torch.tools import (
    make_text_corpus as tcorpus,
)


@pytest.fixture(scope="module")
def text_file(tmp_path_factory):
    """9,000 bytes of text: at a 0.25 validation split, 26 train windows
    of 256 bytes fill batches of 4 unevenly, so the last batch is
    padded."""
    path = tmp_path_factory.mktemp("bytes") / "corpus.txt"
    rng = np.random.default_rng(0)
    words = [b"def ", b"return ", b"self", b".x", b"\n", b"    ", b"(", b")",
             b"import ", b"# note\n", b"\xc3\xa9"]
    out = bytearray()
    while len(out) < 9000:
        out += words[rng.integers(len(words))]
    path.write_bytes(bytes(out[:9000]))
    return path


def _assert_same_batches(jl, tl, epochs=(1, 2)):
    assert len(jl) == len(tl)
    for epoch in epochs:
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == len(tl)
        for x, y in zip(jb, tb):
            assert sorted(x) == sorted(y) == ["mask", "tokens"]
            xt = np.asarray(x["tokens"])
            assert xt.dtype == y["tokens"].dtype
            assert np.array_equal(xt, y["tokens"])
            assert np.array_equal(np.asarray(x["mask"]), y["mask"])
    return tb


@pytest.mark.parametrize("training, shuffle", [(True, True), (False, False),
                                               (True, False)])
def test_byte_loader_batches_are_byte_identical(text_file, training,
                                                shuffle):
    args = dict(data_dir=str(text_file.parent), file=text_file.name,
                batch_size=4, seq_len=256, shuffle=shuffle,
                training=training, val_fraction=0.25, seed=5)
    jl = JLOADERS.get("ByteLMLoader")(**args)
    tl = TLOADERS.get("ByteLMLoader")(**args)
    tb = _assert_same_batches(jl, tl)
    assert tb[0]["tokens"].dtype == np.uint8
    # the tail split: val windows come from the last quarter of the file
    raw = text_file.read_bytes()
    split = int(len(raw) * 0.75)
    part = raw[:split] if training else raw[split:]
    assert tl.n_samples == len(part) // 256
    if not shuffle:
        assert bytes(tb[0]["tokens"][0]) == part[:256]


def test_byte_loader_falls_back_to_synthetic_data(tmp_path, caplog):
    args = dict(data_dir=str(tmp_path), file="absent.txt", batch_size=64,
                seq_len=32, shuffle=True, training=True, seed=2)
    jl = JLOADERS.get("ByteLMLoader")(**args)
    with caplog.at_level(logging.WARNING):
        tl = TLOADERS.get("ByteLMLoader")(**args)
    assert "using synthetic byte-LM data" in caplog.text
    tb = _assert_same_batches(jl, tl, epochs=(1,))
    assert tl.n_samples == 2048 and int(tb[0]["tokens"].max()) < 256


def test_byte_loader_refuses_a_file_too_small(tmp_path):
    (tmp_path / "tiny.txt").write_bytes(b"x" * 100)
    with pytest.raises(ValueError, match="too small"):
        TLOADERS.get("ByteLMLoader")(data_dir=str(tmp_path),
                                     file="tiny.txt", seq_len=256)


@pytest.mark.parametrize("max_mb", [0.02, 0.3])
def test_corpus_tool_writes_the_same_bytes(tmp_path, max_mb):
    a = jcorpus.build(tmp_path / "a.txt", int(max_mb * 1e6))
    b = tcorpus.main(["--out", str(tmp_path / "b.txt"), "--max-mb",
                      str(max_mb)])
    assert (a["files"], a["bytes"]) == (b["files"], b["bytes"]) and a["bytes"]
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path /
                                                 "b.txt").read_bytes()


def test_bits_per_byte_matches_jax():
    rng = np.random.default_rng(1)
    b, t, d, v = 3, 300, 16, 256      # t - 1 = 299: a padded 256-chunk
    logits = rng.normal(size=(b, t, v)).astype(np.float32)
    h = rng.normal(size=(b, t, d)).astype(np.float32)
    w = rng.normal(size=(d, v)).astype(np.float32)
    toks = rng.integers(0, v, (b, t)).astype(np.uint8)
    assert TMETRICS.get("lm_bits_per_byte") is tmetrics.lm_bits_per_byte
    got = tmetrics.lm_bits_per_byte(torch.from_numpy(logits),
                                    torch.from_numpy(toks))
    want = jmetrics.lm_bits_per_byte(logits, toks.astype(np.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    got = tmetrics.lm_bits_per_byte(
        (torch.from_numpy(h), torch.from_numpy(w)), torch.from_numpy(toks))
    want = jmetrics.lm_bits_per_byte((h, w), toks.astype(np.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # uniform logits: exactly 8 bits per byte
    flat = tmetrics.lm_bits_per_byte(torch.zeros(1, 5, 256),
                                      torch.zeros(1, 5, dtype=torch.uint8))
    np.testing.assert_allclose(flat.numpy(), [8.0], atol=1e-5)
