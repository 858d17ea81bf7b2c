"""Byte-level BPE tokenizer: train / encode / decode / save, in-tree.

A copy of ``pytorch_distributed_template_tpu/data/tokenizer.py``
(``BpeTokenizer``, ``tokenizer_from_config``): that module is numpy-only,
but importing it goes through the JAX package's ``data/__init__``, which
imports JAX, so the port keeps its own copy. Tokenizer files are shared:
one written by either package loads in the other.

Design: classic byte-level BPE (GPT-2 family's scheme, minus the regex
pre-tokenizer — merges may cross whitespace, which is simpler and
slightly better for code/structured text). Ids 0..255 are the raw
bytes, so ANY input encodes (no <unk>) and any id sequence decodes.
Training is numpy-vectorized: each merge is one pass over the corpus
array (pair counting via a packed-key ``np.unique``), so a few hundred
merges over a multi-MB sample take seconds on one core.

Usage:
    tok = BpeTokenizer.train(Path("corpus.txt").read_bytes(), 1024)
    ids = tok.encode("hello world")
    tok.save("tok.json"); tok = BpeTokenizer.load("tok.json")

``BpeLMLoader`` (data/datasets.py) trains+caches one of these next to
the corpus and feeds the LM families; ``generate.py`` finds it back
through the run config for --prompt round-tripping.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Sequence, Union

import numpy as np

logger = logging.getLogger(__name__)


def _sample_bytes(source, max_train_bytes: int) -> bytes:
    """<= ``max_train_bytes`` of evenly-spaced slices from a sliceable
    byte source (bytes or a uint8 memmap) — the whole file's
    distribution, not just its head, without materializing it."""
    if len(source) <= max_train_bytes:
        return bytes(source[:])
    k = 16
    step = len(source) // k
    take = max_train_bytes // k
    return b"".join(
        bytes(source[i * step: i * step + take]) for i in range(k)
    )


def _pair_counts(ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Packed (a, b) adjacent-pair keys and their counts."""
    key = ids[:-1].astype(np.int64) << 21 | ids[1:].astype(np.int64)
    return np.unique(key, return_counts=True)


def _merge_once(ids: np.ndarray, a: int, b: int, new_id: int) -> np.ndarray:
    """Replace non-overlapping occurrences of (a, b) with ``new_id``.

    For a != b matches can never overlap (an overlap at i, i+1 would
    need ids[i+1] == b == a). For a == b, runs like ``aaa`` must merge
    greedily left-to-right — resolved with a short loop over the match
    positions only (rare case, tiny index arrays).
    """
    m = (ids[:-1] == a) & (ids[1:] == b)
    idx = np.flatnonzero(m)
    if idx.size == 0:
        return ids
    if a == b:
        # vectorized greedy: within each run of consecutive matches keep
        # every other one starting at the run head (a Python loop here
        # is hot-path — (space, space) dominates code corpora)
        order = np.arange(idx.size)
        is_start = np.empty(idx.size, bool)
        is_start[0] = True
        is_start[1:] = np.diff(idx) > 1
        run_head = idx[np.maximum.accumulate(np.where(is_start, order, 0))]
        idx = idx[((idx - run_head) % 2) == 0]
    out = ids.copy()
    out[idx] = new_id
    return np.delete(out, idx + 1)


class BpeTokenizer:
    """Ordered byte-level BPE merges + the derived id->bytes vocab."""

    def __init__(self, merges: Sequence[tuple[int, int]]):
        self.merges = [tuple(m) for m in merges]
        self.vocab: list[bytes] = [bytes([i]) for i in range(256)]
        for a, b in self.merges:
            self.vocab.append(self.vocab[a] + self.vocab[b])

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- training ------------------------------------------------------------

    @classmethod
    def train(cls, data: Union[bytes, str], vocab_size: int,
              max_train_bytes: int = 4 << 20,
              max_token_bytes: int = 16) -> "BpeTokenizer":
        """Learn ``vocab_size - 256`` merges from ``data``.

        ``max_train_bytes`` caps the training sample (evenly-spaced
        slices across the corpus, so the sample sees the whole file's
        distribution, not just its head) — merge quality saturates long
        before corpus size on natural text/code, and training cost is
        linear in the sample.

        ``max_token_bytes`` bounds merged token length (SentencePiece's
        default bound): without it, a corpus with long verbatim repeats
        (boilerplate, repeated phrases) collapses whole sentences into
        single giant tokens — each merge can double token length, so a
        phrase repeated N times degenerates the id stream toward one
        token and generalizes to nothing.
        """
        if isinstance(data, str):
            data = data.encode("utf-8")
        if vocab_size < 256:
            raise ValueError(f"vocab_size {vocab_size} < 256 (the byte "
                             "alphabet is the floor)")
        data = _sample_bytes(data, max_train_bytes)
        ids = np.frombuffer(data, dtype=np.uint8).astype(np.int32)
        lens = [1] * 256                   # id -> token byte length
        merges: list[tuple[int, int]] = []
        for new_id in range(256, vocab_size):
            if len(ids) < 2:
                break
            keys, counts = _pair_counts(ids)
            # most frequent pair whose merged token stays under the cap
            a = b = -1
            for j in np.argsort(-counts):
                if counts[j] < 2:
                    break                  # nothing left that repeats
                ka = int(keys[j]) >> 21
                kb = int(keys[j]) & ((1 << 21) - 1)
                if lens[ka] + lens[kb] <= max_token_bytes:
                    a, b = ka, kb
                    break
            if a < 0:
                break
            ids = _merge_once(ids, a, b, new_id)
            merges.append((a, b))
            lens.append(lens[a] + lens[b])
        return cls(merges)

    # -- inference -----------------------------------------------------------

    def encode(self, text: Union[str, bytes]) -> np.ndarray:
        """Text -> int32 ids (applies the merges in learned order)."""
        if isinstance(text, str):
            text = text.encode("utf-8")
        ids = np.frombuffer(text, dtype=np.uint8).astype(np.int32)
        for new_id, (a, b) in enumerate(self.merges, start=256):
            if len(ids) < 2:
                break
            ids = _merge_once(ids, a, b, new_id)
        return ids

    def decode(self, ids, errors: str = "strict") -> str:
        """Ids -> text (any id < vocab_size is valid; invalid UTF-8 from
        model sampling decodes with replacement characters).

        ``errors="replace"`` maps out-of-vocab ids to U+FFFD instead of
        raising — for sampling CLIs, where a model head larger than the
        learned vocab (BPE training can stop short of the requested
        size) must not crash after a full generation."""
        ids = np.asarray(ids).reshape(-1)
        bad = [int(i) for i in ids if not 0 <= int(i) < len(self.vocab)]
        if bad and errors != "replace":
            raise ValueError(f"ids outside vocab (size {len(self.vocab)}):"
                             f" {bad[:5]}")
        rep = "�".encode("utf-8")
        return b"".join(
            self.vocab[int(i)] if 0 <= int(i) < len(self.vocab) else rep
            for i in ids
        ).decode("utf-8", errors="replace")

    @classmethod
    def train_from_file(cls, path, vocab_size: int,
                        max_train_bytes: int = 4 << 20,
                        max_token_bytes: int = 16,
                        sample_until: float = 1.0) -> "BpeTokenizer":
        """``train`` over a file WITHOUT loading it whole: the <=
        ``max_train_bytes`` evenly-spaced sample is assembled from
        memmap slices, so a multi-GB corpus touches only the sampled
        pages (same beyond-RAM contract as ByteLMLoader).

        ``sample_until`` restricts sampling to the first fraction of the
        file: loaders that split a held-out tail off the SAME file pass
        their train fraction here so the tokenizer never fits on eval
        text (fitting on the full file leaks the val tail into the
        merges, mildly flattering held-out nats/token)."""
        if not 0.0 < sample_until <= 1.0:
            raise ValueError(f"sample_until {sample_until} not in (0, 1]")
        raw = np.memmap(Path(path), dtype=np.uint8, mode="r")
        end = max(int(len(raw) * sample_until), 1)
        return cls.train(_sample_bytes(raw[:end], max_train_bytes),
                         vocab_size,
                         max_train_bytes=max_train_bytes,
                         max_token_bytes=max_token_bytes)

    def encode_file(self, path, chunk_bytes: int = 4 << 20) -> np.ndarray:
        """Tokenize a whole file in bounded memory: memmap the source
        and encode ``chunk_bytes`` slices independently (a merge that
        would span a chunk boundary is skipped — on multi-MB chunks the
        effect on the id stream is a few tokens per chunk, and training
        data does not need boundary-exact tokenization)."""
        raw = np.memmap(Path(path), dtype=np.uint8, mode="r")
        parts = [
            self.encode(raw[i: i + chunk_bytes].tobytes())
            for i in range(0, len(raw), chunk_bytes)
        ]
        return np.concatenate(parts) if parts else np.zeros(0, np.int32)

    # -- persistence ---------------------------------------------------------

    def save(self, path) -> None:
        # atomic (tmp + rename): concurrent readers — other hosts of a
        # multi-process run — never see a partial file
        import os

        path = Path(path)
        tmp = path.with_name(path.name + f".tmp{os.getpid()}")
        tmp.write_text(json.dumps({
            "format": "bpe-bytelevel-v1",
            "merges": [list(m) for m in self.merges],
        }))
        os.replace(tmp, path)

    @classmethod
    def load(cls, path) -> "BpeTokenizer":
        spec = json.loads(Path(path).read_text())
        if spec.get("format") != "bpe-bytelevel-v1":
            raise ValueError(f"{path}: not a bpe-bytelevel-v1 tokenizer")
        return cls([tuple(m) for m in spec["merges"]])


def tokenizer_from_config(config) -> "BpeTokenizer | None":
    """Recover the run's tokenizer from its config, if the experiment
    trained through ``BpeLMLoader`` (the loader caches the tokenizer
    next to the corpus — same derivation as the loader's own path).
    Used by generate.py to round-trip ``--prompt`` text for subword
    models.

    Resolution order: (1) the run-pinned ``tokenizer.json`` next
    to/above the checkpoint — authoritative, because the corpus-side
    cache is shared mutable state a later run can rewrite with
    different merges; (2) the corpus-side keyed cache; (3) the legacy
    (pre-train-fraction-key) cache name."""
    resume = getattr(config, "resume", None)
    if resume is not None:
        d = Path(resume)
        for _ in range(3):   # ckpt dir -> run dir -> artifact nesting
            pinned = d / "tokenizer.json"
            if pinned.exists():
                return BpeTokenizer.load(pinned)
            d = d.parent
    for block in ("train_loader", "valid_loader", "test_loader"):
        spec = config.get(block, None)
        if spec and spec.get("type") == "BpeLMLoader":
            args = spec.get("args", {})
            keyed = bpe_cache_path(
                args.get("data_dir", "data/"),
                args.get("file", "input.txt"),
                int(args.get("vocab_size", 1024)),
                val_fraction=float(args.get("val_fraction", 0.1)),
            )
            # legacy fallback: caches written before the train-fraction
            # key (fitted on the full file) keep round-tripping old runs
            legacy = (
                Path(args.get("data_dir", "data/"))
                / f"{args.get('file', 'input.txt')}"
                  f".bpe{int(args.get('vocab_size', 1024))}.json"
            )
            for path in (keyed, legacy):
                if path.exists():
                    return BpeTokenizer.load(path)
            logger.warning("BpeLMLoader tokenizer %s not found", keyed)
    return None


def bpe_cache_path(data_dir, file: str, vocab_size: int,
                   val_fraction: float = 0.1) -> Path:
    """Where ``BpeLMLoader`` persists the tokenizer for a corpus.

    The name carries the TRAIN fraction (in percent) the merges were
    fitted on (``t90`` for the default 10% held-out tail): a
    ``val_fraction`` change must refit, not silently reuse merges
    fitted at the old cut — reusing them can leak eval text into the
    tokenizer."""
    # "p" stands in for the decimal point (t90, t90p5) so the keyed
    # stem stays a single path suffix and ``with_suffix`` derives the
    # sibling id-stream cache. %g keeps 6 significant digits: cuts
    # that differ only beyond that collide on one cache — accepted,
    # val fractions are human-chosen round numbers
    pct = f"{(1.0 - float(val_fraction)) * 100:g}".replace(".", "p")
    return Path(data_dir) / f"{file}.bpe{vocab_size}.t{pct}.json"
