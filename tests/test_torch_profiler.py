"""The port's ``observability/profiler.py``: the throughput meter and
``mfu`` against the JAX package's, the H100 peak table and the
``PDT_TPU_PEAK_FLOPS`` override, the analytic step FLOPs, and
``TraceCapture``'s ``torch.profiler`` window on the CPU (a Chrome trace in
``log_dir/profile``, ``request`` re-arming a consumed window, SIGUSR2).
"""
import json
import os
import signal
import time

import pytest
import torch

from pytorch_distributed_template_tpu.observability import profiler as jprof

import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch.config.registry import MODELS
from pytorch_distributed_template_tpu_torch.observability import (
    health, profiler, telemetry,
)


def test_throughput_meter_rates():
    m = profiler.ThroughputMeter()
    for _ in range(4):
        m.update(8)
    time.sleep(0.05)
    r = m.rate()
    assert r["examples_per_sec"] == pytest.approx(8 * r["steps_per_sec"])
    assert 0 < r["steps_per_sec"] < 4 / 0.05
    assert m.rate()["steps_per_sec"] == 0.0   # a new window


@pytest.mark.parametrize("flops, sps, peak", [
    (1e12, 2.0, 4e12), (None, 2.0, 4e12), (1e12, 0.0, 4e12),
    (3.3e12, 7.5, 989e12)])
def test_mfu_equals_the_jax_formula(flops, sps, peak):
    assert profiler.mfu(flops, sps, peak) == jprof.mfu(flops, sps, peak)


@pytest.mark.parametrize("name, peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H100 NVL", 835e12), ("NVIDIA A100-SXM4-80GB", None)])
def test_peak_table_by_device_name(name, peak, monkeypatch):
    monkeypatch.delenv("PDT_TPU_PEAK_FLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert profiler.peak_flops_per_device() == peak
    assert profiler.mfu(1e12, 1.0) == (None if peak is None
                                       else 1e12 / peak)


def test_peak_env_override_and_cpu(monkeypatch):
    monkeypatch.delenv("PDT_TPU_PEAK_FLOPS", raising=False)
    assert profiler.peak_flops_per_device("cpu") is None
    assert profiler.mfu(1e12, 1.0) is None or torch.cuda.is_available()
    monkeypatch.setenv("PDT_TPU_PEAK_FLOPS", "1e12")
    assert profiler.peak_flops_per_device("cpu") == 1e12
    assert profiler.mfu(5e11, 1.0) == 0.5


def test_train_step_flops_analytic():
    model = MODELS.get("TinyLM")(vocab_size=64, n_layer=2, n_head=2,
                                 d_model=32, max_len=16, device="cpu")
    n = sum(p.numel() for name, p in model.named_parameters()
            if name != "wpe")
    keys = 16 * 17 // 2                     # causal: 1 + 2 + ... + 16
    want = 6.0 * n * 4 * 16 + 12.0 * 32 * keys * 4 * 2
    assert profiler.train_step_flops(model, 4, 16) == want
    assert profiler.train_step_flops(torch.nn.Linear(2, 2), 4, 16) is None


def _step(t, step):
    t.before_step(step)
    torch.ones(64, 64) @ torch.ones(64, 64)
    t.after_step(step)


def test_trace_capture_window_writes_a_chrome_trace(tmp_path):
    health.reset_counters()
    rec = telemetry.FlightRecorder(run_dir=None, memory_every=0)
    t = profiler.TraceCapture(tmp_path, start_step=2, num_steps=2)
    t.attach_recorder(rec)
    for step in range(6):
        _step(t, step)
        assert t._active == (step == 2)
    traces = list((tmp_path / "profile").glob("*.pt.trace.json"))
    assert len(traces) == 1 and t.captures == 1
    assert json.loads(traces[0].read_text())["traceEvents"]
    assert rec.last()[-1]["event"] == "profile_capture"
    assert rec.last()[-1]["profile_steps"] == 2
    assert health.health_counters()["profile_captures_total"] == 1
    health.reset_counters()


def test_trace_capture_request_rearms(tmp_path):
    t = profiler.TraceCapture(tmp_path, start_step=0, num_steps=0)
    for step in range(3):
        _step(t, step)
    assert not (tmp_path / "profile").exists()     # nothing scheduled
    t.request(2)
    t.before_step(3)
    assert t._active
    t.request(5)                                   # ignored while active
    t.after_step(3)
    _step(t, 4)
    assert not t._active and t.captures == 1 and t._requested is None
    t.request(1)
    _step(t, 5)
    assert t.captures == 2
    assert len(list((tmp_path / "profile").glob("*.pt.trace.json"))) == 2


def test_close_flushes_an_open_window(tmp_path):
    t = profiler.TraceCapture(tmp_path, start_step=0, num_steps=10)
    t.before_step(0)
    t.close()
    assert t.captures == 1 and not t._active
    assert list((tmp_path / "profile").glob("*.pt.trace.json"))


@pytest.mark.skipif(not hasattr(signal, "SIGUSR2"), reason="no SIGUSR2")
def test_sigusr2_arms_a_capture(tmp_path, monkeypatch):
    monkeypatch.setenv("PDT_PROFILE_STEPS", "3")
    t = profiler.TraceCapture(tmp_path)
    old = signal.getsignal(signal.SIGUSR2)
    try:
        assert profiler.install_sigusr2(t)
        os.kill(os.getpid(), signal.SIGUSR2)
        time.sleep(0.05)
        assert t._requested == 3
    finally:
        signal.signal(signal.SIGUSR2, old)
