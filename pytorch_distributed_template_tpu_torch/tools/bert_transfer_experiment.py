"""BERT transfer experiment on the port: does MLM pretraining beat a fresh
init? The port of the repository's ``scripts/bert_transfer_experiment.py``,
driving the port's ``train.py``.

    python -m pytorch_distributed_template_tpu_torch.tools.\\
bert_transfer_experiment [--out DIR] [--work DIR] [--seeds 1,2,3] \\
        [--device cpu] [--reuse]

1. pretrain ``BertMLM`` on the BPE ids of the standard-library corpus
   (``configs/bert_mlm_stdlib.json``);
2. fine-tune ``BertClassifier`` on ``PyModuleClsLoader``'s package
   classification (``configs/bert_cls_stdlib.json``, held-out files as
   validation) twice per seed at the same budget: warm
   (``trainer.init_from`` the pretraining run's ``model_best``) and fresh;
3. write ``curves.json`` (each run's per-epoch logs from its
   ``info.log``), the runs' configs and logs, and ``verdict.json`` (best
   ``val_accuracy`` per arm and seed, the gaps, a cross-seed collision
   check) under ``--out``.

The configs run as they are, over ``data/pystdlib.txt`` (the port's
``tools/make_text_corpus.py`` writes it). Whether warm beats fresh is the
experiment's finding: the tool reports it and exits 0 either way; a seed
collision (two seeds with bit-identical curves) exits 1.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
MLM_CONFIG = REPO / "configs" / "bert_mlm_stdlib.json"
CLS_CONFIG = REPO / "configs" / "bert_cls_stdlib.json"


def train_argv(config, save_dir, seed: int, sets=(), device=None) -> list:
    """The port's ``train.py`` arguments of one run into ``save_dir``;
    ``sets`` are ``(chain, value)`` pairs (values JSON-encoded here)."""
    argv = ["-c", str(config), "--seed", str(seed), "-s", str(save_dir)]
    if device is not None:
        argv += ["--device", str(device)]
    for chain, value in sets:
        argv += ["--set", chain, json.dumps(value)]
    return argv


def newest_run(save_dir) -> Path:
    """The newest run directory under ``save_dir`` (one phase per
    ``save_dir``, so the newest is the phase's)."""
    runs = sorted(Path(save_dir).glob("*/train/*"),
                  key=lambda p: p.stat().st_mtime)
    if not runs:
        raise SystemExit(f"no run dir under {save_dir}")
    return runs[-1]


def run_train(argv) -> Path:
    """One ``train.py`` run in a child process; returns its run dir."""
    cmd = [sys.executable, "-m", "pytorch_distributed_template_tpu_torch"
           ".train", *argv]
    print("+", " ".join(cmd), flush=True)
    r = subprocess.run(cmd, cwd=REPO)
    if r.returncode != 0:
        raise SystemExit(f"train.py failed ({r.returncode}): {cmd}")
    return newest_run(argv[argv.index("-s") + 1])


def parse_curves(run_dir) -> list:
    """Per-epoch metric dicts from the run's ``info.log``: the trainer's
    ``key : value`` lines after the logging prefix, a new dict at each
    ``epoch``."""
    txt = (Path(run_dir) / "info.log").read_text(errors="replace")
    curves, cur = [], None
    for m in re.finditer(
            r"- INFO -\s+(\w+)\s*:\s*(-?\d+(?:\.\d+(?:e[+-]?\d+)?)?)\s*$",
            txt, re.M):
        k, v = m.group(1), float(m.group(2))
        if k == "epoch":
            cur = {"epoch": int(v)}
            curves.append(cur)
        elif cur is not None:
            cur[k] = v
    return curves


def best_accuracy(run_dir) -> float:
    return max((e.get("val_accuracy", 0.0) for e in parse_curves(run_dir)),
               default=0.0)


def summarize(pre, warms: dict, freshes: dict, out) -> dict:
    """Write the evidence under ``out`` and return the verdict."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    seeds = sorted(warms)
    curves = {"pretrain": parse_curves(pre),
              "finetune_warm": {s: parse_curves(warms[s]) for s in seeds},
              "finetune_fresh": {s: parse_curves(freshes[s])
                                 for s in seeds}}
    (out / "curves.json").write_text(json.dumps(curves, indent=2))
    for name, src in (("pretrain_summary.json", "summary.json"),
                      ("pretrain_config.json", "config.json"),
                      ("pretrain.log", "info.log")):
        shutil.copyfile(Path(pre) / src, out / name)
    for s in seeds:
        for tag, rd in ((f"warm_s{s}", warms[s]),
                        (f"fresh_s{s}", freshes[s])):
            shutil.copyfile(Path(rd) / "config.json",
                            out / f"finetune_{tag}_config.json")
            shutil.copyfile(Path(rd) / "info.log",
                            out / f"finetune_{tag}.log")
    per_seed = [{"seed": s, "warm": best_accuracy(warms[s]),
                 "fresh": best_accuracy(freshes[s])} for s in seeds]
    for p in per_seed:
        p["gap"] = round(p["warm"] - p["fresh"], 6)
    gaps = [p["gap"] for p in per_seed]

    def collision(curve_map):
        vals = [json.dumps(curve_map[s]) for s in seeds]
        return len(set(vals)) != len(vals)

    verdict = {
        "per_seed": per_seed, "gap_mean": round(sum(gaps) / len(gaps), 6),
        "gap_min": min(gaps), "gap_max": max(gaps),
        "pretraining_helps": all(p["warm"] > p["fresh"] for p in per_seed),
        "fresh_seed_collision": collision(curves["finetune_fresh"]),
        "warm_seed_collision": collision(curves["finetune_warm"]),
        "seeds": seeds,
        "matched_budget_epochs": len(curves["finetune_warm"][seeds[0]])}
    (out / "verdict.json").write_text(json.dumps(verdict, indent=2))
    return verdict


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="artifacts/bert_port")
    ap.add_argument("--work", default="build/bert_transfer")
    ap.add_argument("--seeds", default="1,2,3",
                    help="comma-separated fine-tune seeds")
    ap.add_argument("--device", default=None,
                    help="device of every run (default cuda)")
    ap.add_argument("--reuse", action="store_true",
                    help="summarize the runs already under --work")
    args = ap.parse_args(argv)
    work, out = REPO / args.work, REPO / args.out
    seeds = tuple(int(s) for s in args.seeds.split(","))

    def run_or_reuse(phase, config, seed, sets=()):
        save_dir = work / phase
        if any(save_dir.glob("*/train/*")):
            return newest_run(save_dir)
        if args.reuse:
            raise SystemExit(f"--reuse: no prior run under {save_dir}")
        return run_train(train_argv(config, save_dir, seed, sets,
                                    args.device))

    pre = run_or_reuse("pretrain", MLM_CONFIG, seeds[0])
    warms, freshes = {}, {}
    for s in seeds:
        warms[s] = run_or_reuse(
            f"warm_s{s}", CLS_CONFIG, s,
            [("trainer;init_from", str(pre / "model_best"))])
        freshes[s] = run_or_reuse(f"fresh_s{s}", CLS_CONFIG, s)
    verdict = summarize(pre, warms, freshes, out)
    print(json.dumps(verdict, indent=2))
    if verdict["fresh_seed_collision"] or verdict["warm_seed_collision"]:
        raise SystemExit("seed collision: two seeds produced bit-identical "
                         "curves")
    return verdict


if __name__ == "__main__":
    main()
