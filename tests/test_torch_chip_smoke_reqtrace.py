"""chip_smoke.py's phase 23 (request tracing, deadlines, SLOs, brownout,
``/metrics``, ``POST /profile`` and the shadow auditor on the port's
serve.py) and the tracing checks of phases 5 and 22, driven on the CPU at a
tiny size. On the card B4 and B1 run and count their launches; here their
plain versions run under counting stand-ins, so the phases' exact counts
hold here too (``tests/test_torch_chip_smoke_ship.py`` runs phase 22 with
its tracing checks, ``tests/test_torch_chip_smoke_serving.py`` phase 5).

- phase 23 passes over the tiny ring Llama artifact;
- it fails when a request's path skips B4 (the plain paged attention not
  counted);
- phase 5 fails when the engine stops recording ``complete`` events.
"""
import pytest

import chip_smoke
from test_torch_chip_smoke_serving import (  # noqa: F401
    SERVE, TINY_RING, _one_intra_op_thread, counted_paged, counted_plain,
    tiny_serving,
)

OBSERVE = dict(SERVE, burst=16, burst_prompt=10, burst_new=6, spec=2,
               audit_new=4, corrupt_prompt=40, deadline_ms=500,
               slow_ms=1000, deadline_new=40, profile_steps=100000,
               profile_timeout_s=2, brownout_dwell_s=1.0)


def _phase(tiny_serving, tmp_path):
    model_path, config = tiny_serving
    return chip_smoke.phase_serve_observe(
        "cpu", model_path, config=config, device="cpu",
        work=tmp_path / "work", sizes=OBSERVE, arch="Llama",
        arch_args=TINY_RING, audit_arch={})


def test_observe_phase_on_cpu(counted_paged, counted_plain, tiny_serving,
                              tmp_path):
    out = _phase(tiny_serving, tmp_path)
    n = TINY_RING["n_layer"]
    assert out["paged_attn"] > 0 and out["paged_attn"] % n == 0
    assert out["flash_fwd"] > 0 and out["flash_fwd"] % n == 0


def test_observe_phase_fails_when_b4_is_skipped(counted_plain, tiny_serving,
                                                tmp_path):
    with pytest.raises(AssertionError, match="paged_attn launched 0"):
        _phase(tiny_serving, tmp_path)


def test_serve_phase_fails_without_complete_events(
        counted_paged, counted_plain, tiny_serving, tmp_path, monkeypatch):
    from pytorch_distributed_template_tpu_torch.observability import (
        reqtrace,
    )

    event = reqtrace.RequestTracer.event

    def dropped(self, rid, name, **attrs):
        if name != "complete":
            event(self, rid, name, **attrs)

    monkeypatch.setattr(reqtrace.RequestTracer, "event", dropped)
    monkeypatch.setattr(chip_smoke, "check_traced", _quick(
        chip_smoke.check_traced))
    model_path, config = tiny_serving
    with pytest.raises(AssertionError, match="without a complete event"):
        chip_smoke.phase_serve("cpu", model_path, config=config,
                               device="cpu", sizes=SERVE,
                               work=tmp_path / "work")


def _quick(check):
    def quick(run, results, label, timeout=30.0):
        return check(run, results, label, timeout=1.0)
    return quick
