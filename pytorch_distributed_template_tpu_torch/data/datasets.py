"""Datasets and their loaders, registered in ``config.LOADERS``: the port
of the JAX package's ``data/datasets.py`` for the LM family
(``synthetic_lm``, ``SyntheticLMLoader``, ``ByteLMLoader``,
``BpeLMLoader``), MNIST (``_synthetic_image_classification``,
``synthetic_mnist``, ``_try_load_mnist``, ``MnistDataLoader``), the real
UCI digits (``DigitsDataLoader``), ``.npy`` arrays (``NpyDataLoader``),
CIFAR-10 (``synthetic_cifar10``, ``_try_load_cifar10``,
``Cifar10DataLoader``), ImageNet (``synthetic_imagenet``,
``SyntheticImageNetLoader``, and ``ShardedImageNetLoader`` over the uint8
shards of ``data/sharded.py``) and the standard-library package
classification of the BERT family (``PyModuleClsLoader``).

The arrays are byte-identical to the JAX package's (same numpy Philox
generators, same seeds, the same memory-mapped bytes). Real MNIST is read
from raw or gzipped idx files anywhere under ``data_dir``; nothing is
downloaded, so without them the loader falls back to the deterministic,
learnable synthetic set of the same shapes; so do CIFAR-10 (its python
pickle batches, ``data_batch_1``.. and ``test_batch``, anywhere under
``data_dir``, normalised by the per-channel mean and std) and ImageNet
(no shards under ``data_dir``: the synthetic set at 224 px, templates of
16 x 16 repeated up). The digits are the port's own
``digits.csv.gz``, a byte copy of the file scikit-learn ships (the UCI
optical-recognition test set, 1,797 8x8 images; BSD-3 with
scikit-learn), read with ``gzip`` and numpy. ``BpeLMLoader``'s tokenizer
and id-stream caches have the JAX package's paths and formats
(``tokenizer.bpe_cache_path``), so a cache either package wrote loads in
the other. Every loader shards its rows (a ``ShardedSampler``) when it has
more than one shard: ``shard=(index, count)``, the mesh's data axis as
the entry points pass it, else the process group's rank and size.
"""
from __future__ import annotations

import gzip
import logging
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np

from ..config.registry import LOADERS
from ..parallel import dist
from .loader import ArrayDataLoader
from .sampler import ShardedSampler

DIGITS_CSV = Path(__file__).parent / "digits.csv.gz"
logger = logging.getLogger(__name__)


def _synthetic_image_classification(n: int, shape, num_classes: int,
                                    seed: int, noise: float = 0.3,
                                    split: int = 0):
    """Images = per-class smooth template + Gaussian noise; labels uniform.

    The class templates depend only on ``seed``; ``split`` (0 = train,
    1 = eval) offsets the sample stream, so train and validation draw
    disjoint samples from the same class distribution."""
    tmpl_rng = np.random.Generator(np.random.Philox(key=seed))
    rng = np.random.Generator(
        np.random.Philox(np.random.SeedSequence((seed, split + 1)))
    )
    templates = tmpl_rng.normal(0.0, 1.0, size=(num_classes, *shape)) \
        .astype(np.float32)
    # smooth the templates along the spatial axes so convs find structure
    for _ in range(2):
        templates = (
            templates
            + np.roll(templates, 1, axis=1)
            + np.roll(templates, -1, axis=1)
            + np.roll(templates, 1, axis=2)
            + np.roll(templates, -1, axis=2)
        ) / 5.0
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    images = templates[labels] + noise * rng.normal(size=(n, *shape)) \
        .astype(np.float32)
    return images.astype(np.float32), labels


def synthetic_mnist(n: int = 4096, seed: int = 0, training: bool = True):
    images, labels = _synthetic_image_classification(
        n, (28, 28, 1), 10, seed=seed, split=0 if training else 1)
    return {"image": images, "label": labels}


def synthetic_cifar10(n: int = 4096, seed: int = 0, training: bool = True):
    images, labels = _synthetic_image_classification(
        n, (32, 32, 3), 10, seed=seed, split=0 if training else 1)
    return {"image": images, "label": labels}


def synthetic_imagenet(n: int = 1024, image_size: int = 224, seed: int = 0,
                       training: bool = True, num_classes: int = 1000):
    """``n`` images of ``image_size``: per-class 16 x 16 x 3 templates
    repeated up to the size, plus noise of std 0.3 (full-size templates
    would be ~600 MB at 1000 classes)."""
    split = 0 if training else 1
    tmpl_rng = np.random.Generator(np.random.Philox(key=seed))
    rng = np.random.Generator(
        np.random.Philox(np.random.SeedSequence((seed, split + 1))))
    small = 16
    if image_size % small != 0 or image_size < small:
        raise ValueError(f"image_size must be a positive multiple of "
                         f"{small}, got {image_size}")
    templates = tmpl_rng.normal(0, 1, size=(num_classes, small, small, 3)) \
        .astype(np.float32)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    factor = image_size // small
    images = np.repeat(np.repeat(templates[labels], factor, 1), factor, 2)
    images += 0.3 * rng.normal(size=images.shape).astype(np.float32)
    return {"image": images.astype(np.float32), "label": labels}


def _try_load_mnist(data_dir: Path, training: bool):
    """Raw MNIST idx files (plain or ``.gz``) anywhere under ``data_dir``,
    normalised as the reference does (``(x / 255 - 0.1307) / 0.3081``), or
    None when they are absent."""
    names = (("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
             if training else
             ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"))

    def find(stem):
        for cand in (list(data_dir.rglob(stem))
                     + list(data_dir.rglob(stem + ".gz"))):
            return cand
        return None

    img_f, lbl_f = find(names[0]), find(names[1])
    if img_f is None or lbl_f is None:
        return None

    def read(fp):
        op = gzip.open if fp.suffix == ".gz" else open
        with op(fp, "rb") as f:
            return f.read()

    images = np.frombuffer(read(img_f), dtype=np.uint8, offset=16) \
        .reshape(-1, 28, 28, 1)
    labels = np.frombuffer(read(lbl_f), dtype=np.uint8, offset=8) \
        .astype(np.int32)
    images = (images.astype(np.float32) / 255.0 - 0.1307) / 0.3081
    return {"image": images, "label": labels}


def _make_image_loader(dataset: dict, batch_size: int, shuffle: bool,
                       drop_last: bool = False, seed: int = 0,
                       normalize: Optional[dict] = None,
                       shard: Optional[tuple] = None):
    """An ``ArrayDataLoader``, sharded by a ``ShardedSampler`` when
    ``shard`` (``(index, count)``; default the process group's rank and
    size) has more than one shard."""
    index, count = shard or (dist.process_index(), dist.process_count())
    sampler = None
    if count > 1:
        sampler = ShardedSampler(len(next(iter(dataset.values()))),
                                 num_shards=count, shard_index=index,
                                 shuffle=shuffle, seed=seed)
    return ArrayDataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                           sampler=sampler, drop_last=drop_last, seed=seed,
                           normalize=normalize)


@LOADERS.register("MnistDataLoader")
def mnist_loader(data_dir: str = "data/", batch_size: int = 128,
                 shuffle: bool = True, num_workers: int = 0,
                 training: bool = True, synthetic_n: int = 4096,
                 seed: int = 0, shard: Optional[tuple] = None):
    """MNIST loader with the reference's signature; synthetic fallback."""
    del num_workers  # no worker pool: the arrays are memory-resident
    data = _try_load_mnist(Path(data_dir), training)
    if data is None:
        logger.warning(
            "MNIST files not found under %s and nothing is downloaded; "
            "using deterministic synthetic MNIST (n=%d). Provide raw idx "
            "files to train on real data.", data_dir, synthetic_n)
        data = synthetic_mnist(n=synthetic_n, seed=seed, training=training)
    return _make_image_loader(data, batch_size, shuffle, seed=seed,
                              shard=shard)


def synthetic_lm(n: int = 2048, seq_len: int = 128, vocab_size: int = 50257,
                 seed: int = 0, training: bool = True):
    """Token sequences from a sparse bigram chain — learnable structure.

    The bigram table depends only on ``seed``; the sample stream is offset
    by split so train/val sequences differ but share the distribution."""
    tmpl_rng = np.random.Generator(np.random.Philox(key=seed))
    split = 0 if training else 1
    rng = np.random.Generator(
        np.random.Philox(np.random.SeedSequence((seed, split + 1)))
    )
    # each token deterministically prefers a few successors
    successors = tmpl_rng.integers(0, vocab_size, size=(vocab_size, 4))
    tokens = np.empty((n, seq_len), dtype=np.int32)
    tokens[:, 0] = rng.integers(0, vocab_size, size=n)
    choices = rng.integers(0, 4, size=(n, seq_len))
    noise = rng.random((n, seq_len)) < 0.1
    random_tok = rng.integers(0, vocab_size, size=(n, seq_len))
    for t in range(1, seq_len):
        nxt = successors[tokens[:, t - 1], choices[:, t]]
        tokens[:, t] = np.where(noise[:, t], random_tok[:, t], nxt)
    return {"tokens": tokens}


@LOADERS.register("SyntheticLMLoader")
def lm_loader(data_dir: str = "data/", batch_size: int = 8,
              shuffle: bool = True, num_workers: int = 0,
              training: bool = True, n: int = 2048, seq_len: int = 128,
              vocab_size: int = 50257, seed: int = 0,
              shard: Optional[tuple] = None):
    del data_dir, num_workers
    data = synthetic_lm(n=n, seq_len=seq_len, vocab_size=vocab_size,
                        seed=seed, training=training)
    return _make_image_loader(data, batch_size, shuffle, seed=seed,
                              shard=shard)


@LOADERS.register("ByteLMLoader")
def byte_lm_loader(data_dir: str = "data/", batch_size: int = 8,
                   shuffle: bool = True, num_workers: int = 0,
                   training: bool = True, file: str = "input.txt",
                   seq_len: int = 256, val_fraction: float = 0.1,
                   seed: int = 0, shard: Optional[tuple] = None):
    """Byte-level LM over any local file (vocab 256).

    The file is memory-mapped as uint8 and split by ``val_fraction`` (the
    tail is the validation text), then cut into non-overlapping
    ``seq_len`` windows; the tokens stay uint8 (the embedding lookup
    widens them). When the file is absent it falls back to the synthetic
    bigram stream (vocab 256), as the JAX loader does."""
    del num_workers
    path = Path(data_dir) / file
    if not path.exists():
        logger.warning(
            "ByteLMLoader: %s not found; using synthetic byte-LM data.",
            path)
        data = synthetic_lm(n=2048, seq_len=seq_len, vocab_size=256,
                            seed=seed, training=training)
        return _make_image_loader(data, batch_size, shuffle, seed=seed,
                                  shard=shard)
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    split = int(len(raw) * (1.0 - val_fraction))
    part = raw[:split] if training else raw[split:]
    n_chunks = len(part) // seq_len
    if n_chunks == 0:
        raise ValueError(
            f"ByteLMLoader: {path} too small for one {seq_len}-byte "
            f"{'train' if training else 'val'} sequence")
    tokens = part[: n_chunks * seq_len].reshape(n_chunks, seq_len)
    return _make_image_loader({"tokens": tokens}, batch_size, shuffle,
                              seed=seed, shard=shard)


@LOADERS.register("BpeLMLoader")
def bpe_lm_loader(data_dir: str = "data/", batch_size: int = 8,
                  shuffle: bool = True, num_workers: int = 0,
                  training: bool = True, file: str = "input.txt",
                  seq_len: int = 256, vocab_size: int = 1024,
                  val_fraction: float = 0.1, seed: int = 0,
                  shard: Optional[tuple] = None):
    """Subword LM over any local text file: a byte-level BPE tokenizer
    (data/tokenizer.py) fitted once per ``(file, vocab_size, train
    fraction)`` on the bytes before the ``1 - val_fraction`` cut, and the
    file's id stream, both cached beside the file (rank 0 builds them with
    atomic writes; the other ranks poll for them, so ``data_dir`` must be
    shared). The split falls at the token that covers the byte cut
    (``token_index_at_byte``); then non-overlapping ``seq_len`` windows,
    as ``ByteLMLoader``, with its synthetic fallback when the file is
    absent. ``loader.tokenizer_path`` names the tokenizer (the trainer
    pins a copy in the run directory)."""
    del num_workers
    from .tokenizer import BpeTokenizer, bpe_cache_path, token_index_at_byte

    path = Path(data_dir) / file
    if not path.exists():
        logger.warning("BpeLMLoader: %s not found; using synthetic LM "
                       "data.", path)
        data = synthetic_lm(n=2048, seq_len=seq_len, vocab_size=vocab_size,
                            seed=seed, training=training)
        return _make_image_loader(data, batch_size, shuffle, seed=seed,
                                  shard=shard)
    tok_path = bpe_cache_path(data_dir, file, vocab_size,
                              val_fraction=val_fraction)
    ids_path = tok_path.with_suffix(".npy")
    src_mtime = path.stat().st_mtime

    def caches_fresh():
        return (tok_path.exists() and ids_path.exists()
                and tok_path.stat().st_mtime >= src_mtime
                and ids_path.stat().st_mtime >= tok_path.stat().st_mtime)

    if not caches_fresh():
        if dist.is_main_process():
            logger.info("BpeLMLoader: training %d-vocab BPE on %s ...",
                        vocab_size, path)
            tok = BpeTokenizer.train_from_file(
                path, vocab_size, sample_until=1.0 - val_fraction)
            tok.save(tok_path)
            logger.info("BpeLMLoader: tokenizing %s ...", path)
            ids = tok.encode_file(path)
            dtype = np.uint16 if tok.vocab_size <= 65536 else np.int32
            tmp = ids_path.with_name(ids_path.name + f".tmp{os.getpid()}")
            with open(tmp, "wb") as f:   # a handle: np.save adds no suffix
                np.save(f, ids.astype(dtype))
            os.replace(tmp, ids_path)
        else:
            deadline = time.time() + 1800
            while not caches_fresh():
                if time.time() > deadline:
                    raise TimeoutError(
                        f"BpeLMLoader: timed out waiting for rank 0 to "
                        f"build {tok_path} / {ids_path}: every rank needs "
                        "data_dir on a filesystem it shares with rank 0")
                time.sleep(2.0)
    tok = BpeTokenizer.load(tok_path)
    ids = np.load(ids_path, mmap_mode="r")
    split = token_index_at_byte(
        tok, ids, int(path.stat().st_size * (1.0 - val_fraction)))
    part = ids[:split] if training else ids[split:]
    n_chunks = len(part) // seq_len
    if n_chunks == 0:
        raise ValueError(
            f"BpeLMLoader: {path} too small for one {seq_len}-token "
            f"{'train' if training else 'val'} sequence")
    tokens = np.asarray(part[: n_chunks * seq_len]).reshape(n_chunks,
                                                            seq_len)
    loader = _make_image_loader({"tokens": tokens}, batch_size, shuffle,
                                seed=seed, shard=shard)
    loader.tokenizer_path = tok_path
    return loader


@LOADERS.register("PyModuleClsLoader")
def py_module_cls_loader(data_dir: str = "data/", batch_size: int = 64,
                         shuffle: bool = True, num_workers: int = 0,
                         training: bool = True,
                         modules: tuple = ("asyncio", "email", "unittest",
                                           "xml", "multiprocessing",
                                           "importlib", "encodings",
                                           "http"),
                         seq_len: int = 128, vocab_size: int = 1024,
                         corpus_file: str = "pystdlib.txt",
                         val_fraction: float = 0.2,
                         max_chunks_per_module: int = 1000,
                         seed: int = 0, shard: Optional[tuple] = None):
    """Which standard-library package does a window of ``seq_len`` BPE
    tokens come from? The labelled companion of the ``pystdlib.txt``
    pretraining corpus, over the Python standard library installed here,
    tokenized with the BPE tokenizer ``BpeLMLoader`` caches for that
    corpus (``bpe_cache_path``, or the legacy ``<corpus>.bpe<V>.json``;
    fitted on the corpus's first 90% and cached there when neither
    exists), so a pretrained encoder's embeddings line up with the ids.

    As the JAX loader, array for array: per package, its ``.py`` files
    (the first 256 KiB of each) cut into whole windows; whole files go to
    validation in the order of the md5 of their stdlib-relative name
    until the package's share reaches ``val_fraction`` (stratified by
    package); each package thinned in proportion to ``max_chunks_per_
    module`` windows (every file keeps at least one); validation windows
    equal to a training window dropped. The windows are cached as
    ``pycls_<key>.npz`` in ``data_dir``, the key folding in the packages,
    the sizes, ``max_chunks_per_module`` and the md5 of the tokenizer's
    bytes (``v3``): a refit tokenizer misses the cache. Without a
    tokenizer or corpus, or without the standard library, it falls back
    to synthetic labelled rows whose token range depends on the class."""
    del num_workers
    import hashlib
    import sysconfig

    from .tokenizer import BpeTokenizer, bpe_cache_path

    modules = tuple(modules)
    stdlib = Path(sysconfig.get_paths()["stdlib"])
    tok_path = bpe_cache_path(data_dir, corpus_file, vocab_size)
    legacy_tok = Path(data_dir) / f"{corpus_file}.bpe{vocab_size}.json"
    corpus = Path(data_dir) / corpus_file
    if tok_path.exists():
        tok = BpeTokenizer.load(tok_path)
    elif legacy_tok.exists():
        tok = BpeTokenizer.load(legacy_tok)
    elif corpus.exists():
        tok = BpeTokenizer.train_from_file(corpus, vocab_size,
                                           sample_until=0.9)
        tok.save(tok_path)
    else:
        tok = None
    if tok is None or not stdlib.exists():
        logger.warning("PyModuleClsLoader: %s missing; using synthetic "
                       "labeled data.", tok_path if tok is None else stdlib)
        rng = np.random.default_rng(seed + (0 if training else 1))
        n = 512 if training else 128
        labels = rng.integers(0, len(modules), n)
        tokens = (rng.integers(0, vocab_size // 2, (n, seq_len))
                  + labels[:, None] * (vocab_size // (2 * len(modules))))
        return _make_image_loader(
            {"tokens": tokens.astype(np.int32),
             "label": labels.astype(np.int32)},
            batch_size, shuffle, seed=seed, shard=shard)

    tok_file = tok_path if tok_path.exists() else legacy_tok
    tok_fp = hashlib.md5(tok_file.read_bytes()).hexdigest()[:10]
    key = hashlib.md5(
        ("|".join(modules) + f"|{seq_len}|{vocab_size}|{val_fraction}"
         + f"|{max_chunks_per_module}|{tok_fp}|v3").encode()).hexdigest()[:10]
    cache = Path(data_dir) / f"pycls_{key}.npz"
    if not cache.exists():
        tok_rows, lab_rows, split_rows = [], [], []
        for li, mod in enumerate(modules):
            root = stdlib / mod
            files = (sorted(root.rglob("*.py")) if root.is_dir()
                     else [stdlib / f"{mod}.py"])
            files = [f for f in files
                     if f.exists() and "__pycache__" not in f.parts]
            encoded = []
            for f in files:
                rel = f.relative_to(stdlib).as_posix()
                ids = tok.encode(f.read_bytes()[: 256 << 10])
                k = len(ids) // seq_len
                if k == 0:
                    continue
                h = int(hashlib.md5(rel.encode()).hexdigest(), 16)
                encoded.append((h, ids[: k * seq_len].reshape(k, seq_len)))
            encoded.sort(key=lambda e: e[0])
            total_mod = sum(len(c) for _, c in encoded)
            chunks_per_file, val_seen = [], 0
            for _, c in encoded:
                is_val = val_seen < val_fraction * total_mod
                val_seen += len(c) if is_val else 0
                chunks_per_file.append((c, is_val))
            total = sum(len(c) for c, _ in chunks_per_file)
            frac = min(total, max_chunks_per_module) / max(total, 1)
            for c, is_val in chunks_per_file:
                c = c[:max(1, int(round(len(c) * frac)))]
                tok_rows.append(c)
                lab_rows.append(np.full(len(c), li, np.int32))
                split_rows.append(np.full(len(c), is_val, bool))
        tokens = np.concatenate(tok_rows).astype(np.int32)
        labels = np.concatenate(lab_rows)
        is_val = np.concatenate(split_rows)
        train_keys = {r.tobytes() for r in tokens[~is_val]}
        dup = np.array([is_val[i] and tokens[i].tobytes() in train_keys
                        for i in range(len(tokens))])
        if dup.any():
            logger.info("PyModuleClsLoader: dropping %d val windows "
                        "duplicated in train files", int(dup.sum()))
            tokens, labels, is_val = tokens[~dup], labels[~dup], \
                is_val[~dup]
        tmp = cache.with_name(cache.name + f".tmp{os.getpid()}")
        with open(tmp, "wb") as fh:
            np.savez(fh, tokens=tokens, labels=labels, is_val=is_val)
        os.replace(tmp, cache)
        logger.info("PyModuleClsLoader: cached %d windows (%d val) over %d "
                    "classes to %s", len(labels), int(is_val.sum()),
                    len(modules), cache)
    data = np.load(cache)
    sel = ~data["is_val"] if training else data["is_val"]
    loader = _make_image_loader(
        {"tokens": data["tokens"][sel], "label": data["labels"][sel]},
        batch_size, shuffle, seed=seed, shard=shard)
    loader.window_cache = cache
    return loader


def _load_real_digits(training: bool, val_fraction: float, seed: int):
    """The UCI digits (``DIGITS_CSV``: 64 pixel columns of 0-16, then the
    label) as the JAX package's ``_load_real_digits`` gives them: a Philox
    permutation of ``seed`` splits train from validation, the 8x8 images
    go 3x nearest-upsampled to 24x24 and zero-padded to LeNet's 28x28,
    normalised by ``(x - 0.2243) / 0.3494`` (the whole upsampled set's
    statistics)."""
    with gzip.open(DIGITS_CSV, "rt") as f:
        data = np.loadtxt(f, delimiter=",")
    images = data[:, :-1].reshape(-1, 8, 8).astype(np.float32) / 16.0
    labels = data[:, -1].astype(int).astype(np.int32)
    perm = np.random.Generator(np.random.Philox(key=seed)).permutation(
        len(images))
    n_train = len(images) - int(len(images) * val_fraction)
    idx = perm[:n_train] if training else perm[n_train:]
    x = images[idx][..., None]                          # [n, 8, 8, 1]
    x = np.repeat(np.repeat(x, 3, axis=1), 3, axis=2)   # [n, 24, 24, 1]
    x = np.pad(x, ((0, 0), (2, 2), (2, 2), (0, 0)))     # [n, 28, 28, 1]
    x = (x - 0.2243) / 0.3494
    return {"image": x.astype(np.float32), "label": labels[idx]}


@LOADERS.register("DigitsDataLoader")
def digits_loader(data_dir: str = "data/", batch_size: int = 128,
                  shuffle: bool = True, num_workers: int = 0,
                  training: bool = True, val_fraction: float = 0.2,
                  seed: int = 0, shard: Optional[tuple] = None):
    """Real handwritten-digit classification (1,438 train and 359
    validation images at the default split) in MNIST's shapes, for
    LeNet. ``data_dir`` is accepted and ignored: the data ships with the
    package."""
    del num_workers, data_dir
    data = _load_real_digits(training, val_fraction, seed=seed)
    return _make_image_loader(data, batch_size, shuffle, seed=seed,
                              shard=shard)


@LOADERS.register("NpyDataLoader")
def npy_loader(data_dir: str = "data/", batch_size: int = 128,
               shuffle: bool = True, num_workers: int = 0,
               training: bool = True, files: Optional[dict] = None,
               mmap: bool = True, seed: int = 0,
               normalize: Optional[dict] = None,
               shard: Optional[tuple] = None):
    """Any dataset preprocessed into aligned ``.npy`` arrays. ``files``
    maps a batch key to a file under ``data_dir``; ``{split}`` in a name
    becomes ``train`` or ``val`` (default ``{"image":
    "{split}_images.npy", "label": "{split}_labels.npy"}``). ``mmap``
    memory-maps the arrays (the native gather copies out of the mapped
    pages); labels are cast to int32; a uint8 image array takes
    ``normalize`` (``ArrayDataLoader``)."""
    del num_workers
    split = "train" if training else "val"
    files = files or {"image": "{split}_images.npy",
                      "label": "{split}_labels.npy"}
    arrays = {}
    for key, fname in files.items():
        path = Path(data_dir) / fname.format(split=split)
        if not path.exists():
            raise FileNotFoundError(
                f"NpyDataLoader: {path} not found (key '{key}')")
        arr = np.load(path, mmap_mode="r" if mmap else None)
        if key == "label":
            arr = np.asarray(arr, dtype=np.int32)
        arrays[key] = arr
    return _make_image_loader(arrays, batch_size, shuffle, seed=seed,
                              normalize=normalize, shard=shard)


def _try_load_cifar10(data_dir: Path, training: bool):
    """The python-pickle CIFAR-10 batches anywhere under ``data_dir``
    (``data_batch_1``..``5`` or ``test_batch``), NHWC float32 normalised
    by the per-channel mean and std, or None when absent."""
    import pickle

    base = None
    for cand in data_dir.rglob("data_batch_1"):
        base = cand.parent
        break
    if base is None:
        return None
    files = ([base / f"data_batch_{i}" for i in range(1, 6)] if training
             else [base / "test_batch"])
    xs, ys = [], []
    for f in files:
        with open(f, "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        xs.append(np.asarray(d[b"data"], dtype=np.uint8))
        ys.append(np.asarray(d[b"labels"], dtype=np.int32))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    mean = np.array([0.4914, 0.4822, 0.4465], np.float32)
    std = np.array([0.2470, 0.2435, 0.2616], np.float32)
    x = (x.astype(np.float32) / 255.0 - mean) / std
    return {"image": x, "label": np.concatenate(ys)}


@LOADERS.register("Cifar10DataLoader")
def cifar10_loader(data_dir: str = "data/", batch_size: int = 128,
                   shuffle: bool = True, num_workers: int = 0,
                   training: bool = True, synthetic_n: int = 4096,
                   seed: int = 0, shard: Optional[tuple] = None):
    """CIFAR-10 from its pickle batches; the synthetic set without
    them."""
    del num_workers
    data = _try_load_cifar10(Path(data_dir), training)
    if data is None:
        logger.warning("CIFAR-10 files not found under %s; using synthetic "
                       "CIFAR-10.", data_dir)
        data = synthetic_cifar10(n=synthetic_n, seed=seed, training=training)
    return _make_image_loader(data, batch_size, shuffle, seed=seed,
                              shard=shard)


@LOADERS.register("ShardedImageNetLoader")
def sharded_imagenet_loader(data_dir: str = "data/imagenet_shards/",
                            batch_size: int = 128, shuffle: bool = True,
                            num_workers: int = 0, training: bool = True,
                            normalize: Optional[dict] = None,
                            synthetic_n: int = 1024,
                            image_size: int = 224, num_classes: int = 1000,
                            seed: int = 0, shard: Optional[tuple] = None):
    """ImageNet-scale training from uint8 mmap shards
    (``{split}_images_NNNN.npy`` / ``{split}_labels_NNNN.npy``, written by
    ``tools/make_image_shards.py``; ``data/sharded.py``): the batches are
    gathered out of the mapped pages by the native batcher. The default
    ``normalize`` is ImageNet's mean and std ``on_device``: uint8 crosses
    to the card and is normalised there. Without shards, the synthetic
    ImageNet in memory (``synthetic_n`` images)."""
    del num_workers
    from .sharded import open_sharded_split

    if normalize is None:
        normalize = {"mean": [0.485, 0.456, 0.406],
                     "std": [0.229, 0.224, 0.225], "on_device": True}
    pair = open_sharded_split(data_dir, training)
    if pair is None:
        logger.warning(
            "ShardedImageNetLoader: no shards under %s; using synthetic "
            "ImageNet (n=%d). Convert real data with "
            "tools/make_image_shards.py.", data_dir, synthetic_n)
        data = synthetic_imagenet(n=synthetic_n, image_size=image_size,
                                  seed=seed, training=training,
                                  num_classes=num_classes)
        return _make_image_loader(data, batch_size, shuffle, seed=seed,
                                  shard=shard)
    images, labels = pair
    return _make_image_loader({"image": images, "label": labels},
                              batch_size, shuffle, seed=seed,
                              normalize=normalize, shard=shard)


@LOADERS.register("SyntheticImageNetLoader")
def imagenet_loader(data_dir: str = "data/", batch_size: int = 128,
                    shuffle: bool = True, num_workers: int = 0,
                    training: bool = True, n: int = 1024,
                    image_size: int = 224, num_classes: int = 1000,
                    seed: int = 0, shard: Optional[tuple] = None):
    """The synthetic ImageNet in memory (``data_dir`` is not read)."""
    del num_workers, data_dir
    data = synthetic_imagenet(n=n, image_size=image_size, seed=seed,
                              training=training, num_classes=num_classes)
    return _make_image_loader(data, batch_size, shuffle, seed=seed,
                              shard=shard)
