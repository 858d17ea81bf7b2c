"""Supervised training: the counterpart of the repository's
``scripts/supervise.py``, on the port's own supervisor
(``resilience/supervisor.py``).

Spawns ``python -m pytorch_distributed_template_tpu_torch.train
--auto-resume ...`` as a child, classifies every exit (clean / preemption
/ crash / hang), restarts within an exponential-backoff budget, detects
hangs through the trainer's heartbeat file and logs every lifecycle event
to ``supervisor.jsonl``.

    # every argument the supervisor does not know goes to train.py,
    # --device included (default cuda; --device cpu on a CPU box)
    python -m pytorch_distributed_template_tpu_torch.supervise \\
        -c configs/gpt2_small.json

    # chaos: SIGKILL the first attempt before step 20, watch it resume
    PDT_FAULTS="kill@step:20" \\
        python -m pytorch_distributed_template_tpu_torch.supervise \\
        --max-restarts 3 -c configs/lm_debug.json --device cpu

    # an arbitrary command
    python -m pytorch_distributed_template_tpu_torch.supervise --raw -- \\
        python my_job.py

Flags and environment defaults as in ``scripts/supervise.py``:
``MAX_RESTARTS`` and ``RESTART_DELAY_S`` seed ``--max-restarts`` and
``--restart-delay``. The child's environment carries ``PDT_ATTEMPT``
(1-based; the fault plan's attempt gate), ``PDT_HEARTBEAT_FILE`` and
``PDT_SUPERVISOR_EVENTS``; it runs in the supervisor's working directory,
so it imports the package from where the supervisor did.

Exit codes: 0 on clean completion (or a drained stop), otherwise the last
child failure code (signals as 128+N) once the budget or the crash-loop
window gives up.
"""
from __future__ import annotations

import argparse
import os
import sys

from .resilience.supervisor import Supervisor, SupervisorConfig


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="supervised training: spawn/classify/backoff/resume",
        epilog="all unrecognized arguments are passed to train.py",
    )
    p.add_argument("--max-restarts", type=int,
                   default=_env_int("MAX_RESTARTS", 10),
                   help="crash/hang restart budget (preemption restarts "
                        "are free; env MAX_RESTARTS)")
    p.add_argument("--restart-delay", type=float,
                   default=_env_float("RESTART_DELAY_S", 10.0),
                   metavar="S",
                   help="backoff base seconds (env RESTART_DELAY_S); "
                        "doubles per consecutive crash up to --max-delay")
    p.add_argument("--max-delay", type=float, default=300.0, metavar="S",
                   help="backoff cap")
    p.add_argument("--jitter", type=float, default=0.25,
                   help="fractional random stretch on each delay")
    p.add_argument("--hang-timeout", type=float, default=0.0, metavar="S",
                   help="restart the child when its heartbeat file goes "
                        "stale this long (0 disables). Must comfortably "
                        "exceed startup and the first step (the kernels' "
                        "build, when they are not built yet)")
    p.add_argument("--term-grace", type=float, default=10.0, metavar="S",
                   help="SIGTERM→SIGKILL grace when draining a hung child")
    p.add_argument("--stable-runtime", type=float, default=600.0,
                   metavar="S",
                   help="a child that ran at least this long resets "
                        "the consecutive-crash counter (backoff and "
                        "budget); 0 disables")
    p.add_argument("--crash-loop-window", type=float, default=600.0,
                   metavar="S",
                   help="rolling window for crash-loop detection "
                        "(crash/hang restarts only — preemptions "
                        "never trip it)")
    p.add_argument("--crash-loop-max", type=int, default=5,
                   help="give up after this many restarts inside the "
                        "window, regardless of remaining budget")
    p.add_argument("--events-file", type=str, default="supervisor.jsonl",
                   help="lifecycle JSONL path")
    p.add_argument("--heartbeat-file", type=str, default=None,
                   help="heartbeat path exported to the child "
                        "(default: 'heartbeat' next to --events-file)")
    p.add_argument("--poll", type=float, default=0.5, metavar="S",
                   help="child poll interval")
    p.add_argument("--no-auto-resume", action="store_true",
                   help="do NOT pass --auto-resume to train.py (each "
                        "attempt starts fresh)")
    p.add_argument("--raw", action="store_true",
                   help="treat the remaining arguments as the COMPLETE "
                        "child command instead of train.py arguments")
    return p


def main(argv=None) -> int:
    args, rest = build_parser().parse_known_args(argv)
    if rest and rest[0] == "--":
        rest = rest[1:]
    if args.raw:
        if not rest:
            print("supervise: --raw needs a command after --",
                  file=sys.stderr)
            return 2
        cmd = rest
    else:
        cmd = [sys.executable, "-m",
               "pytorch_distributed_template_tpu_torch.train"]
        if not args.no_auto_resume and "--auto-resume" not in rest:
            cmd.append("--auto-resume")
        cmd += rest
    cfg = SupervisorConfig(
        max_restarts=args.max_restarts,
        restart_delay_s=args.restart_delay,
        max_delay_s=args.max_delay,
        jitter=args.jitter,
        hang_timeout_s=args.hang_timeout,
        term_grace_s=args.term_grace,
        crash_loop_window_s=args.crash_loop_window,
        crash_loop_max=args.crash_loop_max,
        stable_runtime_s=args.stable_runtime,
        poll_s=args.poll,
        events_path=args.events_file,
        heartbeat_path=args.heartbeat_file,
    )
    return Supervisor(cmd, cfg).run()


if __name__ == "__main__":
    sys.exit(main())
