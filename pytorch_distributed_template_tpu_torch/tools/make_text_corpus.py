"""Build a real-text byte-LM corpus from the local Python standard library.

The port's own copy of the repository's ``scripts/make_text_corpus.py``:
the same output bytes for the same interpreter and ``--max-mb``. The
standard library's sources (tests and site-packages left out) are written
in sorted order, each after a header line with its path, skipping any file
that would push the total past ``--max-mb`` (a later, smaller file may
still fit). Deterministic, so ``ByteLMLoader``'s tail validation split is
stable across runs. Needs nothing but the interpreter and no network.

    python -m pytorch_distributed_template_tpu_torch.tools.make_text_corpus \\
        [--out data/pystdlib.txt] [--max-mb 64]
"""
from __future__ import annotations

import argparse
import json
import sysconfig
from pathlib import Path

EXCLUDE_DIRS = {"site-packages", "dist-packages", "__pycache__",
                "test", "tests", "idle_test"}


def iter_source_files(root: Path):
    for p in sorted(root.rglob("*.py")):
        if any(part in EXCLUDE_DIRS for part in p.parts):
            continue
        yield p


def build(out: Path, max_bytes: int) -> dict:
    """Write the corpus to ``out``; returns its file count and size."""
    root = Path(sysconfig.get_paths()["stdlib"])
    n_files = total = 0
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "wb") as f:
        for p in iter_source_files(root):
            try:
                data = p.read_bytes()
            except OSError:
                continue
            header = f"\n# ==== {p.relative_to(root)} ====\n".encode()
            if total + len(header) + len(data) > max_bytes:
                continue
            f.write(header)
            f.write(data)
            total += len(header) + len(data)
            n_files += 1
    return {"out": str(out), "files": n_files, "bytes": total,
            "source": str(root)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="data/pystdlib.txt")
    ap.add_argument("--max-mb", type=float, default=64.0)
    args = ap.parse_args(argv)
    info = build(Path(args.out), int(args.max_mb * 1e6))
    print(json.dumps(info))
    return info


if __name__ == "__main__":
    main()
