"""What training observability costs per step on the card, and where.

    python -m pytorch_distributed_template_tpu_torch.tools.obs_overhead \\
        [--turns 2] [--out build/obs_overhead.log]

Runs the port's ``train.py`` in this process on one card, one epoch per
run, with ``chip_smoke.py``'s phase 6 and phase 10 configs and cuts
(``TRAIN_CONFIG``/``TRAIN_SETS``, ``OBS_CONFIG``/``OBS_SETS``; no
checkpoints, no best-model monitor), in three variants:

- ``phase6``: the stripped config (no health summary, no flight
  recorder, no TensorBoard);
- ``phase10``: ``configs/gpt2_small.json`` with phase 10's extras;
- ``phase10_nohealth``: the same with ``trainer.health.enabled`` false.

Each variant runs in two modes, in turns (``a b c c b a`` per mode):
``free``, the trainer as a user runs it, and ``synced``, a
``cuda.synchronize`` before and after each train step, as
``chip_smoke.py``'s ``TrainRun`` times a step. A run's number is the
median interval between the starts of consecutive train steps over its
steady steps (the run's first two steps and each profiler window left
out), and its mean over those steps.

Then the train step alone on the last run's model, in turns of 8 steps
back to back after a warm step (one read per ``skip_nonfinite`` step):
``off`` (no ``skip_nonfinite``, no health), ``counted`` (health, the
gradients counted on the device every step, as without
``skip_nonfinite``) and ``on_read`` (``skip_nonfinite`` and health, the
counts taken only when the step's one read says it was not finite).

Every line goes to the output and, with ``--out``, to a file. Needs a
CUDA device and the repository's ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
STEP_VARIANTS = {"off": dict(), "counted": dict(health=True),
                 "on_read": dict(skip_nonfinite=True, health=True)}
STEP_TURN_STEPS = 8


def _variants(cs) -> dict:
    quiet = [("trainer;epochs", 1), ("trainer;save_period", 1000),
             ("trainer;monitor", "off")]
    obs = [s for s in cs.OBS_SETS if s[0] not in dict(quiet)] + quiet
    six = [s for s in cs.TRAIN_SETS if s[0] not in dict(quiet)] + quiet
    return {"phase6": (cs.TRAIN_CONFIG, six),
            "phase10": (cs.OBS_CONFIG, obs),
            "phase10_nohealth": (cs.OBS_CONFIG, obs + [
                ("trainer;health", {"enabled": False})])}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _run(config, sets, synced: bool, root: Path, device="cuda") -> tuple:
    """One epoch through ``train.py``; returns (the trainer, the starts
    of its train steps in seconds, the profiler window's steps)."""
    from pytorch_distributed_template_tpu_torch import train as train_cli
    from pytorch_distributed_template_tpu_torch.observability.trace import (
        get_recorder,
    )

    get_recorder().clear()
    argv = ["-c", str(config), "-s", str(root), "--device", str(device),
            "--seed", "0"]
    for chain, value in sets:
        argv += ["--set", chain, json.dumps(value)]
    box, starts = {}, []

    def hook(trainer):
        box["trainer"] = trainer
        step = trainer.train_step

        def timed(batch):
            if synced:
                _sync(device)
            starts.append(time.perf_counter())
            m = step(batch)
            if synced:
                _sync(device)
            return m

        trainer.train_step = timed

    train_cli.main(argv, on_trainer=hook)
    trainer = box["trainer"]
    window = (set(range(trainer.trace.start_step,
                        trainer.trace.start_step + trainer.trace.num_steps))
              if trainer.profile_enabled else set())
    return trainer, starts, window


def _interval_stats(starts, window) -> dict:
    ms = [(b - a) * 1e3 for i, (a, b) in enumerate(zip(starts, starts[1:]))
          if i >= 2 and i not in window and i + 1 not in window]
    return {"iter_ms_median": float(np.median(ms)),
            "iter_ms_mean": float(np.mean(ms)), "steps": len(ms)}


def _step_turns(trainer, turns, device="cuda") -> dict:
    """ms per train step of :data:`STEP_VARIANTS` on ``trainer``'s model
    and optimizer, :data:`STEP_TURN_STEPS` steps a turn, one
    ``cuda.synchronize`` at the end of each."""
    from pytorch_distributed_template_tpu_torch.engine.steps import (
        make_train_step,
    )

    batches = [trainer._to_device(b) for b, _ in zip(
        trainer.train_loader, range(STEP_TURN_STEPS))]
    clip = trainer.config["trainer"].get("grad_clip_norm", 0.0)
    times = {}
    for name in turns:
        step = make_train_step(
            trainer.model, trainer.optimizer, trainer.criterion,
            trainer.metric_ftns, input_key=trainer.input_key,
            target_key=trainer.target_key, grad_clip_norm=clip,
            lr_fn=trainer.lr_fn, **STEP_VARIANTS[name])
        step(batches[0])
        _sync(device)
        t0 = time.perf_counter()
        for b in batches:
            step(b)
        _sync(device)
        times.setdefault(name, []).append(
            (time.perf_counter() - t0) * 1e3 / len(batches))
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=2,
                    help="passes of a b c c b a per mode (default 2)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("obs_overhead: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    return measure(cs, cs.card_line(), _variants(cs), args.turns,
                   args.out, REPO / "build" / "obs_overhead")


def measure(cs, card: str, variants: dict, turns: int, out_path, root,
            device="cuda") -> int:
    """The runs and the step turns (see the module docstring); every
    line printed, and written to ``out_path`` when given."""

    out = out_path.open("w") if out_path else None

    def emit(line: str) -> None:
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    emit(f"[card] {card}")
    if torch.device(device).type == "cuda":
        cs.phase_build()
    names = list(variants)
    order = (names + names[::-1]) * turns
    results = {}
    trainer = None
    for mode in ("free", "synced"):
        for name in order:
            config, sets = variants[name]
            trainer = None
            gc.collect()
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
            if root.exists():
                shutil.rmtree(root)
            trainer, starts, window = _run(config, sets, mode == "synced",
                                           root, device)
            row = dict(_interval_stats(starts, window), variant=name,
                       mode=mode, card=card)
            results.setdefault((mode, name), []).append(row)
            emit("[run] " + json.dumps(row))
    summary = {}
    for (mode, name), rows in results.items():
        summary[f"{mode}/{name}"] = {
            k: float(np.mean([r[k] for r in rows]))
            for k in ("iter_ms_median", "iter_ms_mean")}
    for mode in ("free", "synced"):
        base = summary[f"{mode}/phase6"]["iter_ms_median"]
        for name in names[1:]:
            got = summary[f"{mode}/{name}"]["iter_ms_median"]
            summary[f"{mode}/{name}"]["over_phase6_ms"] = got - base
            summary[f"{mode}/{name}"]["over_phase6_pct"] = \
                100.0 * (got / base - 1)
    emit("[summary] " + json.dumps(dict(summary, card=card)))
    step_order = list(STEP_VARIANTS) + list(STEP_VARIANTS)[::-1]
    times = _step_turns(trainer, step_order * turns, device)
    shutil.rmtree(root)
    emit("[step] " + json.dumps({
        **{f"{k}_ms": float(np.mean(v)) for k, v in times.items()},
        "turns": times, "card": card}))
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
