"""Kernel B4 (paged attention) of two trees of the repository on one card,
in turns, so that their times compare within one run.

    python -m pytorch_distributed_template_tpu_torch.tools.paged_ab \\
        --tree parent=build/parent --tree change=. --order 0,1,1,0 \\
        [--serve | --host-only] [--out build/paged_ab.log]

Each turn runs in a fresh process from the root of its tree (a checkout,
or a ``git archive`` unpacked into a directory ``.gitignore`` lists):

- phase 2b of that tree's ``chip_smoke.py``: B4 against its plain version
  at the main path's shapes, with kernel, plain, SDPA and bound times;
- the wrapper's host time per call at each of those shapes (the median
  over 7 batches of the mean enqueue time of 100 back-to-back calls, the
  card idle when each batch starts), measured the same way for every tree;
- with ``--host-only``, the host times alone (phase 2b is skipped);
- with ``--serve``, phase 5 of that tree (slice 2's main path over HTTP:
  the TTFT of every request of (e) and (f), and B4's device time and share
  in the profiled request), on one random-init Mistral-7B artifact that
  the first tree's tool makes once.

Every line a turn prints goes to the output with its tree's label in
front; ``--out`` also keeps them in a file. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

CHILD = r"""
import json, sys, time
from pathlib import Path
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from pytorch_distributed_template_tpu_torch.ops.flash import paged_attention

cs.phase_build()
if sys.argv[3] == "kernels":
    cs.phase_paged_kernel()
gen = torch.Generator(device="cuda").manual_seed(1)
for shape in cs.PAGED_SHAPES:
    q, kp, vp, ks, vs, tables, starts, pads = cs._paged_case(*shape, gen)
    call = lambda: paged_attention(q, kp, vp, tables, starts, pads,
                                   window=shape[8], k_scale=ks, v_scale=vs)
    call()
    means = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            call()
        means.append((time.perf_counter() - t0) * 1e3 / 100)
    torch.cuda.synchronize()
    host = sorted(means)[3]
    print("[host] " + json.dumps({"shape": shape[0],
                                  "host_ms_per_call": host}), flush=True)
    del q, kp, vp, ks, vs
    torch.cuda.empty_cache()


def profiled(fn, device, top_n=8):
    # the tree's own profile row, plus B4's device time and its share of
    # the busy time, summed the same way for every tree
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, b4_us = [], 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        if "paged_attn" in e.name or "paged_combine" in e.name:
            b4_us += e.time_range.elapsed_us()
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1 - busy / wall_us,
            "device_ops": len(spans), "paged_attn_ms": b4_us / 1e3,
            "paged_attn_share_of_busy": b4_us / busy, "top": []}


art = sys.argv[1]
if art:
    cs._profiled = profiled
    cs.phase_serve(cs.card_line(), Path(art), work=Path(sys.argv[2]))
"""


def make_artifact(tree: Path, work: Path) -> Path:
    """A random-init Mistral-7B params-only artifact (the port's tool)."""
    cmd = [sys.executable, "-m",
           "pytorch_distributed_template_tpu_torch.tools."
           "make_serving_artifact", "-o", str(work / "art"), "--arch",
           "Mistral", "--seed", "0", "--device", "cuda"]
    subprocess.run(cmd, cwd=tree, check=True)
    return work / "art" / "model"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="label=path of a tree's root (repeatable)")
    ap.add_argument("--order", default="0,1,1,0",
                    help="tree indices in the order they run")
    ap.add_argument("--serve", action="store_true",
                    help="also run phase 5 in every turn")
    ap.add_argument("--host-only", action="store_true",
                    help="only the host time per call (no phase 2b)")
    ap.add_argument("--out", default="", help="also write the lines here")
    args = ap.parse_args(argv)
    trees = []
    for spec in args.tree:
        label, _, path = spec.partition("=")
        trees.append((label, Path(path).resolve()))
    out = open(args.out, "w") if args.out else None
    work = Path(trees[0][1]) / "build" / "paged_ab"
    art = ""
    if args.serve:
        t0 = time.perf_counter()
        art = str(make_artifact(trees[0][1], work))
        print(f"[ab] artifact in {time.perf_counter() - t0:.1f} s",
              flush=True)
    rc = 0
    for turn, idx in enumerate(int(i) for i in args.order.split(",")):
        label, root = trees[idx]
        env = dict(os.environ, PYTHONPATH=str(root))
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-c", CHILD, art, str(work / f"turn{turn}"),
             "host" if args.host_only else "kernels"],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            text = f"[{turn}:{label}] {line.rstrip()}"
            print(text, flush=True)
            if out:
                out.write(text + "\n")
        proc.wait()
        print(f"[ab] turn {turn} ({label}) rc {proc.returncode} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        rc = rc or proc.returncode
    if out:
        out.close()
    print(json.dumps({"ok": rc == 0, "turns": args.order}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
