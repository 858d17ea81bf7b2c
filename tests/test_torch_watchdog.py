"""The port's step watchdog and preemption.

- ``StepWatchdog`` alarms on a stall (its report: the active spans, the
  recorder's tail, memory) and stays quiet while the beat arrives.
- SIGTERM sets the preemption flag; two gloo ranks (subprocesses with the
  launcher's environment, each with a timeout) reach the same consensus
  whichever rank was signalled.
- The trainer on ``configs/lm_debug.json`` (CPU), signalled in epoch 1,
  breaks at that batch, skips validation, checkpoints epoch 1, stops, and
  ``train.main`` exits with the preemption status 75.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from pytorch_distributed_template_tpu_torch import train as ttrain
from pytorch_distributed_template_tpu_torch.observability import (
    telemetry, trace,
)
from pytorch_distributed_template_tpu_torch.utils import preemption
from pytorch_distributed_template_tpu_torch.utils.watchdog import (
    StepWatchdog,
)

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120


def test_watchdog_alarms_on_a_stall_with_its_report(tmp_path):
    rec = telemetry.FlightRecorder(run_dir=None, memory_every=0)
    for step in range(4):
        rec.record(step, wall_ms=1.0)
    spans = trace.SpanRecorder()
    wd = StepWatchdog(0.2, dump_stacks=False, recorder=rec, spans=spans,
                      dump_path=tmp_path / "stall_dump.json", dump_last_n=2)
    wd.start()
    try:
        with spans.span("train/step", step=4):
            time.sleep(0.7)
    finally:
        wd.stop()
    assert wd.alarms >= 1
    dump = json.loads((tmp_path / "stall_dump.json").read_text())
    assert [s["name"] for s in dump["active_spans"]] == ["train/step"]
    assert [r["step"] for r in dump["last_records"]] == [2, 3]
    assert dump["stalled_s"] >= 0.2 and dump["host_rss_mb"] > 0


def test_watchdog_quiet_while_beating_and_off_at_zero(tmp_path):
    wd = StepWatchdog(0.3, dump_stacks=False)
    wd.start()
    try:
        for _ in range(12):
            time.sleep(0.05)
            wd.beat()
    finally:
        wd.stop()
    assert wd.alarms == 0
    off = StepWatchdog(0, heartbeat_path=tmp_path / "hb")
    off.start()
    assert off._thread is None and (tmp_path / "hb").is_file()


def test_sigterm_sets_the_flag():
    preemption.reset()
    old = signal.getsignal(signal.SIGTERM)
    try:
        preemption._installed = False
        preemption.install()
        assert not preemption.requested()
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert preemption.requested() and preemption.sync_requested()
    finally:
        signal.signal(signal.SIGTERM, old)
        preemption._installed = False
        preemption.reset()


CONSENSUS = r"""
import json, sys
from pytorch_distributed_template_tpu_torch.parallel import dist
from pytorch_distributed_template_tpu_torch.utils import preemption

signalled = int(sys.argv[1])
dist.initialize("cpu")
if dist.process_index() == signalled:
    preemption.set_local()
first = preemption.sync_requested()
preemption.reset()
second = preemption.sync_requested()
print(json.dumps({"rank": dist.process_index(), "first": first,
                  "second": second}))
dist.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(code: str, args=(), world: int = 2, env_per_rank=None):
    """``code`` in ``world`` gloo ranks (subprocesses with the launcher's
    environment); returns each rank's last stdout line as JSON."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), JAX_PLATFORMS="cpu")
        env.update((env_per_rank or {}).get(rank, {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, *map(str, args)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


@pytest.mark.parametrize("signalled", [0, 1, -1])
def test_two_ranks_reach_the_same_consensus(signalled):
    outs = run_ranks(CONSENSUS, (signalled,))
    assert [o["rank"] for o in outs] == [0, 1]
    assert all(o["first"] == (signalled >= 0) for o in outs)
    assert not any(o["second"] for o in outs)


class _SignalAt:
    """The train step, setting the preemption flag (as the SIGTERM handler
    does) during its ``n``-th call; other attributes pass through."""

    def __init__(self, inner, n):
        self.inner, self.n, self.calls = inner, n, []

    def __call__(self, batch):
        self.calls.append(1)
        if len(self.calls) == self.n:
            preemption.set_local()
        return self.inner(batch)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_trainer_checkpoints_stops_and_returns_the_status(tmp_path):
    preemption.reset()
    box = {}

    def hook(trainer):
        box["trainer"] = trainer
        real_valid = trainer._valid_epoch
        trainer.train_step = _SignalAt(trainer.train_step, 3)

        def valid(epoch):
            box["validated"] = epoch
            return real_valid(epoch)

        trainer._valid_epoch = valid
        box["calls"] = trainer.train_step.calls

    argv = ["-c", str(REPO / "configs" / "lm_debug.json"), "--device", "cpu",
            "-s", str(tmp_path)]
    try:
        with pytest.raises(SystemExit) as exc:
            ttrain.main(argv, on_trainer=hook)
    finally:
        preemption.reset()
    assert exc.value.code == preemption.EXIT_PREEMPTED == 75
    run = box["trainer"].config.save_dir
    assert len(box["calls"]) == 3                  # broke at that batch
    assert "validated" not in box                  # no validation
    assert (run / "checkpoint-epoch1" / "model.pt").is_file()
    assert not (run / "checkpoint-epoch2").exists()
    summary = json.loads((run / "summary.json").read_text())
    assert summary["epoch"] == 1
    assert box["trainer"].train_step.state_dict()["step"] == 3
