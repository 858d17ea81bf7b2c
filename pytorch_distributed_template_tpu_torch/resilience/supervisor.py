"""In-process training supervisor: spawn, classify, back off, resume (a
copy of the JAX package's ``resilience/supervisor.py``, same behaviour and
the same ``supervisor.jsonl`` schema; the port keeps its own, since it
imports nothing of the JAX package).

A process manager that understands what happened to its child:

- **exit classification** — ``clean`` (rc 0), ``preemption`` (the
  trainer's SIGTERM-drain exit code :data:`EXIT_PREEMPTED`, or the
  child dying to an external SIGTERM), ``crash`` (any other nonzero
  exit or signal), ``hang`` (heartbeat went stale and the supervisor
  had to SIGTERM-drain then SIGKILL the child);
- **restart policy** — crashes and hangs burn a bounded restart
  budget with exponential backoff + jitter; preemptions restart at
  the base delay without burning budget (they are routine fleet
  events, not bugs); a rolling crash-loop window gives up early when
  restarts cluster (the classic mis-config loop that a plain
  ``MAX_RESTARTS=10`` would grind through for an hour);
- **hang detection** — the trainer touches a heartbeat file every
  step (``utils/watchdog.StepWatchdog``, wired off the same beat the
  in-process watchdog uses; the supervisor exports
  ``PDT_HEARTBEAT_FILE``). A stale heartbeat ⇒ SIGTERM (grace period
  for the preemption checkpoint path) ⇒ SIGKILL ⇒ restart;
- **drain** — SIGTERM/SIGINT to the supervisor forwards SIGTERM to
  the child (its preemption handler checkpoints and exits), waits,
  and exits without restarting — so preempting the supervisor
  preempts the training, cleanly;
- **evidence** — every lifecycle event is one JSONL line in
  ``supervisor.jsonl`` (FlightRecorder-style: ``v``/``t``/``event``
  plus event fields), which :func:`read_supervisor_stats` folds into
  restart counters.

Stdlib-only: this module imports in milliseconds and never touches
torch — it manages training processes, it is not one. The child's
environment carries ``PDT_ATTEMPT`` (the fault plan's attempt gate),
``PDT_HEARTBEAT_FILE`` (the trainer's watchdog touches it every step) and
``PDT_SUPERVISOR_EVENTS``.
"""
from __future__ import annotations

import collections
import json
import os
import random
import shlex
import signal
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

# The trainer exits with this code when it stopped because of a
# preemption notice (checkpointed + drained, work NOT finished): 75 is
# BSD EX_TEMPFAIL — "try again later", which is exactly the semantic.
# The supervisor restarts these without burning the crash budget.
EXIT_PREEMPTED = 75

SCHEMA_VERSION = 1

ENV_EVENTS = "PDT_SUPERVISOR_EVENTS"
ENV_HEARTBEAT = "PDT_HEARTBEAT_FILE"
ENV_ATTEMPT = "PDT_ATTEMPT"


def classify_exit(returncode: int, hang: bool = False) -> str:
    """Map a child's exit to ``clean|preemption|crash|hang``.

    ``hang=True`` (the supervisor killed the child after a stale
    heartbeat) wins over the resulting signal code. A child dying to
    SIGTERM (rc ``-15``) counts as preemption: cloud maintenance
    SIGTERMs the process directly, and the trainer's graceful path
    exits :data:`EXIT_PREEMPTED` instead.
    """
    if hang:
        return "hang"
    if returncode == 0:
        return "clean"
    if returncode == EXIT_PREEMPTED or returncode == -signal.SIGTERM:
        return "preemption"
    return "crash"


def compute_backoff(failures: int, base_s: float, max_s: float,
                    jitter: float, rand=random.random) -> float:
    """Delay before restart ``failures`` (1-based consecutive crash
    count): ``min(base * 2^(n-1), max)`` stretched by up to
    ``jitter`` fraction — the jitter decorrelates a fleet of
    supervisors restarting into the same shared service."""
    if base_s <= 0:
        return 0.0
    delay = min(base_s * (2.0 ** max(failures - 1, 0)), max_s)
    return delay * (1.0 + max(jitter, 0.0) * rand())


def _exit_code(returncode: int) -> int:
    """Shell-safe supervisor exit code for a child rc (signals map to
    the conventional 128+N)."""
    return 128 - returncode if returncode < 0 else returncode


class EventLog:
    """Append-only JSONL lifecycle log (``supervisor.jsonl``).

    Line-buffered + per-line flush: the log is the post-mortem record,
    and the supervisor itself can be killed at any point."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._file = open(self.path, "a", buffering=1)

    def log(self, event: str, **fields) -> dict:
        rec = {"v": SCHEMA_VERSION, "t": round(time.time(), 3),
               "event": event}
        rec.update({k: v for k, v in fields.items() if v is not None})
        try:
            self._file.write(json.dumps(rec, default=repr) + "\n")
            self._file.flush()
        except (OSError, ValueError):
            pass  # a full disk must not take the supervisor down too
        return rec

    def close(self) -> None:
        try:
            self._file.close()
        except OSError:
            pass


def read_supervisor_stats(path) -> dict:
    """Fold a ``supervisor.jsonl`` into the counters the serving
    endpoints and the telemetry analyzer expose."""
    restarts = 0
    causes: collections.Counter = collections.Counter()
    last_cause = None
    attempts = 0
    gave_up = clean = False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail line
            ev = rec.get("event")
            attempts = max(attempts, int(rec.get("attempt", 0) or 0))
            if ev == "restart":
                restarts += 1
                last_cause = rec.get("cause")
                causes[rec.get("cause", "?")] += 1
            elif ev == "give_up":
                gave_up = True
            elif ev == "clean":
                clean = True
    return {
        "restarts_total": restarts,
        "last_restart_cause": last_cause,
        "causes": dict(causes),
        "attempts": attempts,
        "gave_up": gave_up,
        "clean": clean,
    }


@dataclass
class SupervisorConfig:
    max_restarts: int = 10          # consecutive crash/hang budget
    #                                 (preemptions free; a stable run
    #                                 resets the streak)
    restart_delay_s: float = 10.0   # backoff base
    max_delay_s: float = 300.0      # backoff cap
    jitter: float = 0.25            # fractional jitter on the delay
    hang_timeout_s: float = 0.0     # heartbeat staleness; 0 disables
    term_grace_s: float = 10.0      # SIGTERM→SIGKILL grace on a hang
    crash_loop_window_s: float = 600.0
    crash_loop_max: int = 5         # crash/hang restarts in window ⇒ give up
    stable_runtime_s: float = 600.0  # a run this long resets the
    #                                  consecutive-crash counter/backoff
    poll_s: float = 0.5
    events_path: str = "supervisor.jsonl"
    heartbeat_path: Optional[str] = None  # default: next to events_path
    child_output_path: Optional[str] = None  # append child stdout+stderr
    #                                 here (fleet replicas get one log
    #                                 file each); None inherits ours
    child_env: Optional[dict] = None  # extra env for the child, merged
    #                                 over ours (fleet chaos: one
    #                                 replica gets its own PDT_FAULTS
    #                                 plan while its siblings run clean)
    rand: object = field(default=random.random, repr=False)


class Supervisor:
    """Run ``cmd`` until it exits cleanly or the budget is spent.

    :param cmd: full child argv (``supervise.py`` builds the
        ``python -m pytorch_distributed_template_tpu_torch.train
        --auto-resume ...`` default).
    :param cfg: :class:`SupervisorConfig`.
    """

    def __init__(self, cmd: List[str], cfg: SupervisorConfig):
        self.cmd = list(cmd)
        self.cfg = cfg
        self.events = EventLog(cfg.events_path)
        hb = cfg.heartbeat_path or str(
            Path(cfg.events_path).with_name("heartbeat")
        )
        self.heartbeat_path = Path(hb)
        self.restarts_total = 0          # every relaunch
        self.crash_restarts = 0          # budget-burning relaunches
        self._restart_times: collections.deque = collections.deque()
        self._child: Optional[subprocess.Popen] = None
        self._drain = False

    # -- signal forwarding --------------------------------------------------

    def _install_signals(self) -> None:
        def handler(signum, frame):  # noqa: ARG001
            self._drain = True

        try:
            signal.signal(signal.SIGTERM, handler)
            signal.signal(signal.SIGINT, handler)
        except ValueError:
            pass  # not the main thread (tests)

    # -- child lifecycle ----------------------------------------------------

    def _spawn(self, attempt: int) -> subprocess.Popen:
        env = dict(os.environ)
        if self.cfg.child_env:
            env.update({str(k): str(v)
                        for k, v in self.cfg.child_env.items()})
        env[ENV_ATTEMPT] = str(attempt)
        env[ENV_EVENTS] = str(self.events.path)
        env[ENV_HEARTBEAT] = str(self.heartbeat_path)
        # a stale heartbeat from the previous attempt must not mask a
        # child that hangs before its first beat
        try:
            self.heartbeat_path.unlink()
        except OSError:
            pass
        if self.cfg.child_output_path:
            # per-child log file (fleet replicas): APPEND so restarts
            # extend one history; the fd is the child's after spawn
            out = open(self.cfg.child_output_path, "ab", buffering=0)
            try:
                child = subprocess.Popen(self.cmd, env=env, stdout=out,
                                         stderr=subprocess.STDOUT)
            finally:
                out.close()
        else:
            child = subprocess.Popen(self.cmd, env=env)
        self.events.log("spawn", attempt=attempt, pid=child.pid,
                        cmd=shlex.join(self.cmd) if attempt == 1 else None)
        return child

    # -- external control (embedders) ----------------------------------------

    def request_drain(self) -> None:
        """Ask the supervisor to stop: same effect as SIGTERM to it —
        the current child is SIGTERM-drained (its preemption handler
        runs) and the run loop exits without restarting. Thread-safe
        and callable from embedders (one supervisor per replica, each in
        a thread, where POSIX signals cannot be delivered
        per-instance)."""
        self._drain = True

    def signal_child(self, sig: int) -> bool:
        """Deliver ``sig`` to the CURRENT child, if one is running
        (chaos injection / rolling restarts: SIGKILL ⇒ classified
        crash, SIGTERM ⇒ the child's own drain path ⇒ preemption —
        either way the run loop restarts it within policy). Returns
        whether a live child was signalled."""
        child = self._child
        if child is None or child.poll() is not None:
            return False
        try:
            child.send_signal(sig)
        except OSError:
            return False
        return True

    def _heartbeat_age_s(self, spawned_at: float) -> float:
        try:
            mtime = self.heartbeat_path.stat().st_mtime
        except OSError:
            mtime = spawned_at  # no beat yet: age from spawn
        return time.time() - max(mtime, spawned_at)

    def _wait(self, child: subprocess.Popen, attempt: int):
        """Block until the child exits; returns ``(rc, hang)``.

        Polls for exit, heartbeat staleness (⇒ SIGTERM-drain then
        SIGKILL) and the supervisor's own drain flag (⇒ forward
        SIGTERM, wait, no restart)."""
        spawned_at = time.time()
        term_sent_at = None
        while True:
            rc = child.poll()
            if rc is not None:
                return rc, False
            if self._drain and term_sent_at is None:
                self.events.log("drain", attempt=attempt, pid=child.pid)
                child.terminate()
                term_sent_at = time.time()
            if term_sent_at is not None:
                # draining (supervisor preempted): bounded wait, then kill
                if time.time() - term_sent_at > max(self.cfg.term_grace_s,
                                                    1.0) * 6:
                    child.kill()
                time.sleep(min(self.cfg.poll_s, 0.1))
                continue
            if (self.cfg.hang_timeout_s > 0
                    and self._heartbeat_age_s(spawned_at)
                    > self.cfg.hang_timeout_s):
                self.events.log(
                    "hang", attempt=attempt, pid=child.pid,
                    heartbeat_age_s=round(
                        self._heartbeat_age_s(spawned_at), 1),
                )
                child.terminate()          # drain: preemption handler may
                try:                       # still land a checkpoint
                    child.wait(timeout=max(self.cfg.term_grace_s, 0.1))
                except subprocess.TimeoutExpired:
                    child.kill()
                    child.wait()
                return child.returncode, True
            time.sleep(self.cfg.poll_s)

    # -- the loop -----------------------------------------------------------

    def run(self) -> int:
        cfg = self.cfg
        self._install_signals()
        self.events.log(
            "start", max_restarts=cfg.max_restarts,
            restart_delay_s=cfg.restart_delay_s,
            hang_timeout_s=cfg.hang_timeout_s,
            crash_loop=(f"{cfg.crash_loop_max}/"
                        f"{cfg.crash_loop_window_s:g}s"),
        )
        attempt = 0
        while True:
            attempt += 1
            child = self._child = self._spawn(attempt)
            t0 = time.monotonic()
            rc, hang = self._wait(child, attempt)
            runtime_s = round(time.monotonic() - t0, 3)
            cause = classify_exit(rc, hang=hang)
            self.events.log("exit", attempt=attempt, returncode=rc,
                            cause=cause, runtime_s=runtime_s)
            if self._drain:
                # supervisor was told to stop: report the child's state
                # and get out of the way — no restart
                self.events.log("stopped", attempt=attempt,
                                returncode=rc, cause=cause)
                return 0 if rc in (0, EXIT_PREEMPTED) else _exit_code(rc)
            if cause == "clean":
                self.events.log("clean", attempt=attempt,
                                restarts_total=self.restarts_total)
                return 0
            burns = cause in ("crash", "hang")
            if burns:
                if (cfg.stable_runtime_s > 0
                        and runtime_s >= cfg.stable_runtime_s
                        and self.crash_restarts):
                    # a long healthy run before this crash: treat it as
                    # a fresh failure, not the Nth of a streak — a
                    # multi-week job with a rare crash per day must not
                    # creep to max backoff and exhaust the budget
                    self.events.log(
                        "stable_reset", attempt=attempt,
                        runtime_s=runtime_s,
                        crash_restarts=self.crash_restarts,
                    )
                    self.crash_restarts = 0
                self.crash_restarts += 1
                if self.crash_restarts > cfg.max_restarts:
                    self.events.log(
                        "give_up", attempt=attempt, reason="budget",
                        returncode=rc, cause=cause,
                        restarts_total=self.restarts_total,
                    )
                    return _exit_code(rc)
                # crash-loop window counts ONLY budget-burning causes:
                # preemption churn is routine fleet weather and must
                # never trip the give-up heuristic
                now = time.monotonic()
                self._restart_times.append(now)
                while (self._restart_times
                       and now - self._restart_times[0]
                       > cfg.crash_loop_window_s):
                    self._restart_times.popleft()
                if len(self._restart_times) > cfg.crash_loop_max:
                    self.events.log(
                        "give_up", attempt=attempt, reason="crash_loop",
                        window_s=cfg.crash_loop_window_s,
                        restarts_in_window=len(self._restart_times),
                        returncode=rc, cause=cause,
                    )
                    return _exit_code(rc)
            delay = (
                compute_backoff(self.crash_restarts, cfg.restart_delay_s,
                                cfg.max_delay_s, cfg.jitter, cfg.rand)
                if burns else
                compute_backoff(1, cfg.restart_delay_s, cfg.max_delay_s,
                                cfg.jitter, cfg.rand)
            )
            self.restarts_total += 1
            self.events.log(
                "restart", attempt=attempt, cause=cause,
                delay_s=round(delay, 3),
                restarts_total=self.restarts_total,
                crash_restarts=self.crash_restarts,
                budget_left=max(cfg.max_restarts - self.crash_restarts, 0),
            )
            # sleep in poll_s slices so a drain signal during backoff
            # exits promptly instead of after a multi-minute delay
            end = time.monotonic() + delay
            while time.monotonic() < end:
                if self._drain:
                    self.events.log("stopped", attempt=attempt,
                                    cause="drain_during_backoff")
                    return 0
                time.sleep(min(cfg.poll_s, max(end - time.monotonic(), 0)))
