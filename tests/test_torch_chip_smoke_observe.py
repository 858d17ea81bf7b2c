"""chip_smoke.py's phases of slice 6 (training observability), driven on
the CPU at a tiny size. On the card the kernels run and count their
launches; here their plain versions run, so counting stand-ins for the
plain versions show that every step went through the kernels as often as
the phase asserts, and that the script fails a run whose path skipped them.
"""
import pytest

import chip_smoke
from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401
from test_torch_accum_ema import _process_signal_handlers  # noqa: F401
from test_torch_chip_smoke_serving import counted_plain  # noqa: F401
from test_torch_chip_smoke_training import (  # noqa: F401
    TINY_TRAIN_SETS, counted_bwd,
)


# slice 6 at a tiny size: configs/gpt2_small.json as it is but for the
# model and the data narrowed (--set), with phase 10's observability
# extras; the NaN lands at step 5 of the second run's 8
TINY_OBS_SETS = TINY_TRAIN_SETS + [
    ("trainer;profiler", {"enabled": True, "trace_start_step": 2,
                          "trace_steps": 3}),
    ("trainer;watchdog_secs", 600), ("trainer;log_grad_norm", True)]
TINY_NAN_SETS = TINY_TRAIN_SETS + [("trainer;epochs", 1)]


def test_observe_phase_on_cpu(counted_plain, counted_bwd, tmp_path):
    launches = chip_smoke.phase_observe(
        "cpu", device="cpu", sets=TINY_OBS_SETS, nan_sets=TINY_NAN_SETS,
        nan_step=5, work=tmp_path / "work")
    # main: 2 epochs x 8 steps + the resumed epoch's 8; nan run: 8
    layers, train_steps, eval_steps = 2, 16 + 8 + 8, 4 + 2 + 2
    assert launches == {
        "flash_fwd": layers * (2 * train_steps + eval_steps),
        "flash_bwd_dkv": layers * train_steps,
        "flash_bwd_dq": layers * train_steps, "expert_ffn": 0}
    stats = chip_smoke.PATH_STATS["observe"]
    assert stats["steps"] > 0 and stats["ms_per_step_median"] > 0
    assert stats["span_step_ms_median"] > 0
    assert stats["span_loop_ms_median"] > 0
    assert not (tmp_path / "work" / "observe").exists()
    assert not (tmp_path / "work" / "observe_nan").exists()


def test_observe_phase_fails_without_the_anomaly_dump(
        counted_plain, counted_bwd, monkeypatch, tmp_path):
    from pytorch_distributed_template_tpu_torch.observability import health

    monkeypatch.setattr(health.HealthMonitor, "_write_dump",
                        lambda self, step, anomaly: None)
    with pytest.raises(AssertionError, match="anomaly_5.json"):
        chip_smoke.phase_observe(
            "cpu", device="cpu", sets=TINY_OBS_SETS,
            nan_sets=TINY_NAN_SETS, nan_step=5, work=tmp_path / "work")


def test_observe_config_is_the_repositorys_own():
    assert chip_smoke.OBS_CONFIG == chip_smoke.REPO / "configs" / \
        "gpt2_small.json"
    cut = {chain.split(";")[-1] for chain, _ in chip_smoke.OBS_SETS}
    assert cut == {"n", "epochs", "save_period", "profiler",
                   "watchdog_secs", "log_grad_norm"}
