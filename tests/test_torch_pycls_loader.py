"""The port's ``PyModuleClsLoader`` (``data/datasets.py``) against the JAX
package's, array for array, on a tiny corpus and a 300-id BPE tokenizer
in ``tmp_path`` over a subset of this machine's standard library (three
packages and a module, a few windows each): the train and validation
tokens and labels are bit-equal, the window caches carry the same key,
a refit tokenizer misses the cache (a new key, new windows), and without
a tokenizer both packages give the same synthetic rows.
"""
import shutil
import sysconfig
from pathlib import Path

import numpy as np
import pytest

from pytorch_distributed_template_tpu.data import datasets as jdata

from pytorch_distributed_template_tpu_torch.data import datasets, tokenizer

ARGS = dict(modules=("json", "tomllib", "colorsys", "csv"), seq_len=32,
            vocab_size=300, max_chunks_per_module=12, val_fraction=0.3,
            batch_size=8)
STDLIB = Path(sysconfig.get_paths()["stdlib"])


def _corpus(d: Path, files) -> None:
    d.mkdir(parents=True, exist_ok=True)
    text = b"".join((STDLIB / f).read_bytes() for f in files)
    (d / "pystdlib.txt").write_bytes(text)
    tok = tokenizer.BpeTokenizer.train_from_file(d / "pystdlib.txt", 300,
                                                 sample_until=0.9)
    tok.save(tokenizer.bpe_cache_path(d, "pystdlib.txt", 300))


def _both(tmp_path, name, training):
    """The two packages' loaders, each over its own copy of ``name``'s
    corpus and tokenizer (so each builds its own window cache)."""
    out = []
    for pkg, fn in (("jax", jdata.py_module_cls_loader),
                    ("port", datasets.py_module_cls_loader)):
        d = tmp_path / f"{name}_{pkg}"
        if not d.exists():
            shutil.copytree(tmp_path / name, d)
        out.append((fn(data_dir=str(d), training=training,
                       shuffle=False, **ARGS), d))
    return out


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pycls")
    _corpus(tmp / "a", ["colorsys.py", "csv.py", "json/encoder.py"])
    _corpus(tmp / "b", ["colorsys.py", "json/decoder.py"])
    return tmp


@pytest.mark.parametrize("training", [True, False], ids=["train", "val"])
def test_windows_bit_equal_to_jax(corpora, training):
    (jl, jd), (tl, td) = _both(corpora, "a", training)
    for key in ("tokens", "label"):
        np.testing.assert_array_equal(tl.arrays[key], jl.arrays[key])
    assert tl.arrays["tokens"].dtype == jl.arrays["tokens"].dtype
    assert sorted(p.name for p in td.glob("pycls_*.npz")) == sorted(
        p.name for p in jd.glob("pycls_*.npz"))
    # a one-file module's file is held out whole: its class is val-only
    labels = set(tl.arrays["label"].tolist())
    assert labels == ({0, 1} if training else {0, 1, 2, 3})
    assert tl.window_cache.exists()


def test_a_refit_tokenizer_misses_the_cache(corpora):
    (_, _), (a, _) = _both(corpora, "a", True)
    (jb, _), (b, _) = _both(corpora, "b", True)
    assert a.window_cache.name != b.window_cache.name
    assert not np.array_equal(a.arrays["tokens"][:4], b.arrays["tokens"][:4])
    np.testing.assert_array_equal(b.arrays["tokens"], jb.arrays["tokens"])


@pytest.mark.parametrize("training", [True, False], ids=["train", "val"])
def test_synthetic_fallback_equal_to_jax(tmp_path, training):
    kw = dict(ARGS, data_dir=str(tmp_path), training=training)
    want = jdata.py_module_cls_loader(**kw)
    got = datasets.py_module_cls_loader(**kw)
    for key in ("tokens", "label"):
        np.testing.assert_array_equal(got.arrays[key], want.arrays[key])
    tokens, labels = got.arrays["tokens"], got.arrays["label"]
    step = ARGS["vocab_size"] // (2 * len(ARGS["modules"]))
    assert (tokens >= labels[:, None] * step).all()
