"""The port's supervisor (``resilience/supervisor.py``, its own copy of
the JAX package's) and ``python -m
pytorch_distributed_template_tpu_torch.supervise``.

The fast cases of tests/test_supervisor.py against the port's copy:
exit classification, backoff, budgets, free preemptions, the crash-loop
window, signal deaths, hang detection and the child's environment, with
FAKE children (``python -c`` scripts that read ``PDT_ATTEMPT``), and the
CLI in ``--raw`` mode. Then one golden run with real children on the CPU:
``configs/lm_debug.json`` cut to 2 epochs of 8 steps with interval saves
every 3 steps, supervised with ``kill@step:5`` (between the slots after
batches 3 and 6): exactly one restart, cause ``crash``; the resumed run
replays steps 3 and 4 and ends with params equal (``torch.equal``) to an
uninterrupted run's, every logged loss equal at its step, and
``global_step`` 16 in the last sidecar. Under a minute on a CPU box.
"""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from pytorch_distributed_template_tpu_torch.resilience.supervisor import (
    EXIT_PREEMPTED, Supervisor, SupervisorConfig, classify_exit,
    compute_backoff, read_supervisor_stats,
)

REPO = Path(__file__).resolve().parent.parent
MODULE = "pytorch_distributed_template_tpu_torch.supervise"


@pytest.fixture(autouse=True, scope="module")
def _process_signal_handlers():
    """``Supervisor.run`` installs its SIGTERM and SIGINT handlers in this
    process; the handlers the module found come back after it, for the
    modules that run next in this process."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, handler in saved.items():
        signal.signal(s, handler)


def test_classify_exit():
    assert classify_exit(0) == "clean"
    assert classify_exit(EXIT_PREEMPTED) == "preemption"
    assert classify_exit(-signal.SIGTERM) == "preemption"
    assert classify_exit(1) == "crash"
    assert classify_exit(137) == "crash"
    assert classify_exit(-signal.SIGKILL) == "crash"
    assert classify_exit(-signal.SIGSEGV) == "crash"
    assert classify_exit(-signal.SIGKILL, hang=True) == "hang"
    assert classify_exit(0, hang=True) == "hang"


def test_compute_backoff_growth_cap_and_jitter():
    no_jitter = [compute_backoff(n, 2.0, 60.0, 0.0) for n in range(1, 8)]
    assert no_jitter == [2.0, 4.0, 8.0, 16.0, 32.0, 60.0, 60.0]
    assert compute_backoff(3, 0.0, 60.0, 0.5) == 0.0
    lo = compute_backoff(2, 2.0, 60.0, 0.25, rand=lambda: 0.0)
    hi = compute_backoff(2, 2.0, 60.0, 0.25, rand=lambda: 1.0)
    assert lo == 4.0 and hi == 5.0


def _fake_child(body: str):
    return [sys.executable, "-c",
            "import os, sys, time\n"
            "attempt = int(os.environ.get('PDT_ATTEMPT', '1'))\n" + body]


def _cfg(tmp_path, **kw):
    kw.setdefault("restart_delay_s", 0.05)
    kw.setdefault("jitter", 0.0)
    kw.setdefault("poll_s", 0.05)
    kw.setdefault("events_path", str(tmp_path / "supervisor.jsonl"))
    return SupervisorConfig(**kw)


def _events(path):
    return [json.loads(ln) for ln in open(path) if ln.strip()]


def test_crash_then_clean(tmp_path):
    cfg = _cfg(tmp_path, max_restarts=3)
    sup = Supervisor(_fake_child("sys.exit(3 if attempt == 1 else 0)"), cfg)
    assert sup.run() == 0
    stats = read_supervisor_stats(cfg.events_path)
    assert stats["restarts_total"] == 1
    assert stats["last_restart_cause"] == "crash"
    assert stats["attempts"] == 2
    assert stats["clean"] and not stats["gave_up"]
    assert [e["event"] for e in _events(cfg.events_path)] == [
        "start", "spawn", "exit", "restart", "spawn", "exit", "clean"]


def test_budget_exhaustion_preserves_exit_code(tmp_path):
    cfg = _cfg(tmp_path, max_restarts=2)
    assert Supervisor(_fake_child("sys.exit(7)"), cfg).run() == 7
    stats = read_supervisor_stats(cfg.events_path)
    assert stats["gave_up"] and not stats["clean"]
    assert stats["restarts_total"] == 2
    give_up = next(e for e in _events(cfg.events_path)
                   if e["event"] == "give_up")
    assert give_up["reason"] == "budget"


def test_preemption_restarts_do_not_burn_budget(tmp_path):
    cfg = _cfg(tmp_path, max_restarts=0)
    sup = Supervisor(_fake_child(
        f"sys.exit({EXIT_PREEMPTED} if attempt < 3 else 0)"), cfg)
    assert sup.run() == 0
    stats = read_supervisor_stats(cfg.events_path)
    assert stats["restarts_total"] == 2
    assert stats["causes"] == {"preemption": 2}
    assert sup.crash_restarts == 0 and stats["clean"]


def test_preemption_churn_never_trips_crash_loop(tmp_path):
    cfg = _cfg(tmp_path, max_restarts=5, crash_loop_max=1,
               crash_loop_window_s=600.0)
    sup = Supervisor(_fake_child(
        f"sys.exit({EXIT_PREEMPTED} if attempt < 4 else 0)"), cfg)
    assert sup.run() == 0
    stats = read_supervisor_stats(cfg.events_path)
    assert stats["restarts_total"] == 3 and stats["clean"]
    assert not stats["gave_up"]


def test_stable_runtime_resets_crash_streak(tmp_path):
    cfg = _cfg(tmp_path, max_restarts=1, stable_runtime_s=0.3)
    body = ("if attempt == 1: sys.exit(3)\n"
            "if attempt == 2:\n"
            "    time.sleep(0.5)\n"
            "    sys.exit(3)\n"
            "sys.exit(0)\n")
    assert Supervisor(_fake_child(body), cfg).run() == 0
    stats = read_supervisor_stats(cfg.events_path)
    assert stats["restarts_total"] == 2 and stats["clean"]
    assert any(e["event"] == "stable_reset"
               for e in _events(cfg.events_path))


def test_crash_loop_window_gives_up_early(tmp_path):
    cfg = _cfg(tmp_path, max_restarts=100, crash_loop_window_s=60.0,
               crash_loop_max=2)
    assert Supervisor(_fake_child("sys.exit(1)"), cfg).run() == 1
    give_up = next(e for e in _events(cfg.events_path)
                   if e["event"] == "give_up")
    assert give_up["reason"] == "crash_loop"
    assert read_supervisor_stats(cfg.events_path)["restarts_total"] <= 3


def test_signal_death_maps_to_128_plus(tmp_path):
    cfg = _cfg(tmp_path, max_restarts=0)
    sup = Supervisor(_fake_child(
        "import signal\nos.kill(os.getpid(), signal.SIGKILL)"), cfg)
    assert sup.run() == 128 + signal.SIGKILL
    assert read_supervisor_stats(cfg.events_path)["causes"] == {}


def test_hang_detection_drains_and_restarts(tmp_path):
    cfg = _cfg(tmp_path, max_restarts=2, hang_timeout_s=1.0,
               term_grace_s=0.5, poll_s=0.1)
    body = ("hb = os.environ['PDT_HEARTBEAT_FILE']\n"
            "if attempt == 1:\n"
            "    open(hb, 'w').write('beat')\n"
            "    time.sleep(60)\n"
            "sys.exit(0)\n")
    t0 = time.monotonic()
    assert Supervisor(_fake_child(body), cfg).run() == 0
    assert time.monotonic() - t0 < 30
    stats = read_supervisor_stats(cfg.events_path)
    assert stats["restarts_total"] == 1
    assert stats["last_restart_cause"] == "hang" and stats["clean"]
    assert any(e["event"] == "hang" for e in _events(cfg.events_path))


def test_child_env_contract(tmp_path):
    out = tmp_path / "env.json"
    cfg = _cfg(tmp_path, max_restarts=0)
    body = ("import json\n"
            f"json.dump({{k: os.environ.get(k) for k in"
            f" ('PDT_ATTEMPT', 'PDT_HEARTBEAT_FILE',"
            f" 'PDT_SUPERVISOR_EVENTS')}}, open({str(out)!r}, 'w'))\n"
            "sys.exit(0)\n")
    Supervisor(_fake_child(body), cfg).run()
    env = json.loads(out.read_text())
    assert env == {"PDT_ATTEMPT": "1",
                   "PDT_SUPERVISOR_EVENTS": str(cfg.events_path),
                   "PDT_HEARTBEAT_FILE": str(tmp_path / "heartbeat")}


def test_supervise_cli_raw_and_env_defaults(tmp_path):
    """``python -m ...supervise --raw``, with the ``MAX_RESTARTS`` /
    ``RESTART_DELAY_S`` environment defaults."""
    events = tmp_path / "sup.jsonl"
    r = subprocess.run(
        [sys.executable, "-m", MODULE, "--events-file", str(events),
         "--jitter", "0", "--raw", "--", sys.executable, "-c",
         "import os, sys; "
         "sys.exit(5 if os.environ['PDT_ATTEMPT'] == '1' else 0)"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "MAX_RESTARTS": "2", "RESTART_DELAY_S": "0.05"})
    assert r.returncode == 0, r.stderr[-2000:]
    stats = read_supervisor_stats(events)
    assert stats["restarts_total"] == 1 and stats["clean"]
    start = next(e for e in _events(events) if e["event"] == "start")
    assert start["max_restarts"] == 2 and start["restart_delay_s"] == 0.05


# the golden run: lm_debug cut to 2 epochs of 8 steps, slots every 3 steps
GOLDEN = ["-c", str(REPO / "configs" / "lm_debug.json"), "--device", "cpu",
          "--set", "trainer;epochs", "2",
          "--set", "trainer;save_interval_steps", "3"]
KILL_STEP = 5


def _runs(root):
    return sorted((root / "TinyLM_Debug" / "train").iterdir())


def _losses(root):
    """Logged loss per step over the runs under ``root``, later runs
    overwriting the steps they replayed."""
    out = {}
    for run in _runs(root):
        for line in (run / "telemetry.jsonl").read_text().splitlines():
            rec = json.loads(line)
            if "loss" in rec:
                out[rec["step"]] = rec["loss"]
    return out


def test_supervised_kill_resume_golden(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PDT_FAULTS"}
    env["OMP_NUM_THREADS"] = "2"
    r = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_template_tpu_torch."
         "train", "-s", str(tmp_path / "base")] + GOLDEN,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    events = tmp_path / "supervisor.jsonl"
    r = subprocess.run(
        [sys.executable, "-m", MODULE, "--max-restarts", "3",
         "--restart-delay", "1.1", "--jitter", "0", "--events-file",
         str(events), "-s", str(tmp_path / "chaos")] + GOLDEN,
        cwd=REPO, env={**env, "PDT_FAULTS": f"kill@step:{KILL_STEP}"},
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    stats = read_supervisor_stats(events)
    assert stats["restarts_total"] == 1, stats
    assert stats["causes"] == {"crash": 1}
    assert stats["clean"] and not stats["gave_up"]

    (base,) = _runs(tmp_path / "base")
    first, last = _runs(tmp_path / "chaos")
    spawn = [e for e in _events(events) if e["event"] == "spawn"][0]
    assert "--auto-resume" in spawn["cmd"] and "--device cpu" in spawn["cmd"]
    assert "checkpoint-interval-a" in (last / "info.log").read_text()
    ds = json.loads((last / "checkpoint-epoch2.data_state.json")
                    .read_text())
    assert ds["global_step"] == 2 * 8
    want = torch.load(base / "checkpoint-epoch2" / "model.pt")
    got = torch.load(last / "checkpoint-epoch2" / "model.pt")
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the killed attempt's last log window never flushed: every logged
    # loss equals the uninterrupted run's, and every step after the kill
    # is logged
    base_losses, chaos = _losses(tmp_path / "base"), _losses(
        tmp_path / "chaos")
    assert {s: base_losses[s] for s in chaos} == chaos
    assert {s for s in base_losses if s >= KILL_STEP} <= set(chaos)
    replayed = [rec["step"] for rec in map(json.loads, (
        last / "telemetry.jsonl").read_text().splitlines())
        if "event" not in rec and rec["step"] < KILL_STEP]
    assert replayed == [3, 4]
