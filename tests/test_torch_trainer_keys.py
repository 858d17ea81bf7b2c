"""The four trainer keys of fault C1 through the port's ``train.py`` on
the CPU, against the JAX package's ``Trainer`` where it has the key:
``progress`` (a bar or the plain iterable) and ``host_prefetch`` (0 and 3
give the same run, bit for bit), ``debug.nan_check`` (both packages stop
with a ``FloatingPointError`` at the step ``nan_grad@step:N`` poisons,
after the same 3 steps), and ``debug.disable_jit`` / ``aot_warmup``
accepted and logged.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from pytorch_distributed_template_tpu_torch import train as ttrain

from test_torch_accum_ema import _process_signal_handlers  # noqa: F401
from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401
from test_torch_real_configs import _cut, _port_run

REPO = Path(__file__).resolve().parent.parent
# the JAX Trainer on a config file until it raises; prints the exception's
# type and the steps its state took
JAX_NAN_RUN = """
import json, sys
from pathlib import Path
sys.path.insert(0, "tests")
import jax
from test_torch_real_configs import _jax_run
box = {}
try:
    _jax_run(json.loads(Path(sys.argv[1]).read_text()), Path(sys.argv[2]),
             box)
    out = {"error": None}
except Exception as exc:
    out = {"error": type(exc).__name__,
           "steps": int(jax.device_get(box["trainer"].state.step))}
print(json.dumps(out))
"""

LENET_DEBUG = {"trainer;epochs": 1, "train_loader;args;synthetic_n": 128,
               "valid_loader;args;synthetic_n": 64}


def test_host_prefetch_and_progress_change_nothing(tmp_path):
    """``host_prefetch`` 0 (inline) and 3, with ``progress`` on and off:
    the same epoch log, bit for bit (examples_per_sec aside)."""
    logs = []
    for depth, progress in ((0, False), (3, True)):
        cfg = _cut("mnist_debug.json", dict(
            LENET_DEBUG, **{"trainer;host_prefetch": depth,
                            "trainer;progress": progress}))
        t, _ = _port_run(cfg, tmp_path / f"d{depth}")
        logs.append({k: v for k, v in t[0].items()
                     if k != "examples_per_sec"})
    assert logs[0] == logs[1]


def test_nan_check_stops_both_packages_at_the_poisoned_step(tmp_path):
    sets = dict(LENET_DEBUG, **{"trainer;debug": {"nan_check": True},
                                "trainer;faults": "nan_grad@step:3",
                                "train_loader;args;synthetic_n": 512})
    cfg = _cut("mnist_debug.json", sets)
    path = tmp_path / "nan.json"
    path.write_text(json.dumps(cfg))
    # the JAX run in a fresh process: jax_debug_nans is process-wide, and
    # a process whose earlier tests compiled the same step may let a NaN
    # through it unchecked (the run then stops only at its eval step)
    r = subprocess.run(
        [sys.executable, "-c", JAX_NAN_RUN, str(path), str(tmp_path)],
        cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    jax_run = json.loads(r.stdout.strip().splitlines()[-1])
    # jax_debug_nans raises FloatingPointError, or its internal form when
    # the NaN surfaces inside the compiled step's dispatch
    assert "FloatingPointError" in jax_run["error"], jax_run
    box = {}

    def keep(trainer):
        box["t"] = trainer

    with pytest.raises(FloatingPointError, match="step 3"):
        ttrain.main(["-c", str(path), "--device", "cpu", "-s",
                     str(tmp_path / "port")], on_trainer=keep)
    # steps 0-2 ran on both sides, step 3 raised before its update
    assert box["t"].train_step.step == jax_run["steps"] == 3
    import torch

    assert not torch.is_anomaly_enabled()   # the run put it back


def test_disable_jit_and_aot_warmup_are_accepted_and_logged(tmp_path):
    cfg = _cut("mnist_debug.json", dict(
        LENET_DEBUG, **{"trainer;debug": {"disable_jit": True},
                        "trainer;aot_warmup": True}))
    _, trainer = _port_run(cfg, tmp_path)
    text = (trainer.config.log_dir / "info.log").read_text()
    assert "aot_warmup has no meaning" in text
    assert "disable_jit has no meaning" in text
