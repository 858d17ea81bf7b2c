"""Which part bounds B4's decode arm: its time at phase 2b's decode shapes
in four builds of ``csrc/paged_attn.cu``, timed in turns in one process.

    python -m pytorch_distributed_template_tpu_torch.tools.paged_decode_parts

- ``shipped``: the kernel as the path runs it;
- ``loads``: ``-DPDT_DEC_NOCOMPUTE``, the page ring without the products
  (each consumer warp releases a page as soon as it lands);
- ``products``: ``-DPDT_DEC_NOLOAD``, the products (and int8 widening)
  without reading any page;
- ``neither``: both flags, what is left: launch, table scan, merge and the
  split combine.

The three timing builds give garbage outputs and are used for nothing
else; they are built into ``build/kernels/`` beside the shipped library.
One JSON line per decode shape: ``{"shape", "<build>_ms", ...,
"card"}``. Needs a CUDA device and the repository's ``chip_smoke.py``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

BUILDS = {"shipped": [], "loads": ["-DPDT_DEC_NOCOMPUTE"],
          "products": ["-DPDT_DEC_NOLOAD"],
          "neither": ["-DPDT_DEC_NOLOAD", "-DPDT_DEC_NOCOMPUTE"]}


def build_variants(flash, build) -> dict:
    """The timing builds, one nvcc each, all started together."""
    lib = flash.PAGED_ATTN
    digest = build.source_digest(lib.source)
    procs = {}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name, flags in BUILDS.items():
        if not flags:
            continue
        out = build.BUILD_DIR / f"lib{lib.name}-{name}-{digest}.so"
        if out.is_file():
            procs[name] = (None, out)
            continue
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", str(out),
               str(lib.source), *build.LINK_FLAGS]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {"shipped": lib.load()}
    for name, (proc, out) in procs.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        handle = ctypes.CDLL(str(out))
        flash._declare_paged(handle)
        libs[name] = handle
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_decode_parts: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs

    from pytorch_distributed_template_tpu_torch.ops import build, flash

    libs = build_variants(flash, build)
    card = cs.card_line()
    gen = torch.Generator(device="cuda").manual_seed(1)
    shipped = flash.PAGED_ATTN._lib
    try:
        for shape in cs.PAGED_SHAPES:
            if not shape[0].startswith("decode"):
                continue
            q, kp, vp, ks, vs, tables, starts, pads = cs._paged_case(
                *shape, gen)
            row = {"shape": shape[0]}
            for name, handle in libs.items():
                flash.PAGED_ATTN._lib = handle
                row[f"{name}_ms"] = cs.cuda_ms(
                    lambda: flash._paged_cuda(q, kp, vp, tables, starts,
                                              pads, shape[8], ks, vs), 30)
            row["card"] = card
            print(json.dumps(row), flush=True)
    finally:
        flash.PAGED_ATTN._lib = shipped
    return 0


if __name__ == "__main__":
    sys.exit(main())
