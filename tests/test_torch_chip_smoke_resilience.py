"""chip_smoke.py's phases of slice 7 (resume and the supervisor), driven on
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


# slice 7 at a tiny size: phase 11's cuts on the tiny GPT-2 (8 steps per
# epoch): slots every 4 batches; attempt 1 killed before step 7 (batch 7),
# 3 steps after the slot of batch 4 with no slot between and a 1 s stall
# before step 6 (the card's 15 steps, 2.0 s, against its 0.6-1.2 s write:
# the slot's write is done), so attempt 2 must start at step 4; attempt 2
# raising before step 14 (epoch 2, batch 6, after its batch-4 slot)
TINY_RES_SETS = TINY_TRAIN_SETS + [
    ("trainer;save_interval_steps", 4), ("trainer;keep_last", 1),
    ("trainer;grad_accum_steps", 2), ("trainer;ema_decay", 0.999)]
TINY_RES_FAULTS = "slow_host@step:6:1s;kill@step:7;crash@step:14@attempt:2"


def test_resilience_phase_on_cpu(counted_plain, counted_bwd, tmp_path):
    launches = chip_smoke.phase_resilience(
        "cpu", device="cpu", sets=TINY_RES_SETS, faults=TINY_RES_FAULTS,
        work=tmp_path / "work")
    # the uninterrupted run: 2 epochs x 8 steps of 2 microbatches, 2 eval
    # steps per epoch (the supervised children are other processes)
    layers, micro_steps, eval_steps = 2, 2 * 16, 2 * 2
    assert launches == {
        "flash_fwd": layers * (2 * micro_steps + eval_steps),
        "flash_bwd_dkv": layers * micro_steps,
        "flash_bwd_dq": layers * micro_steps, "expert_ffn": 0}
    assert not (tmp_path / "work" / "resilience").exists()


def test_resilience_phase_fails_without_step_accurate_resume(
        counted_plain, counted_bwd, tmp_path):
    """Resuming at epoch granularity skips the killed epoch's tail: the
    phase must fail."""
    with pytest.raises(AssertionError, match="not at the newest"):
        chip_smoke.phase_resilience(
            "cpu", device="cpu", faults=TINY_RES_FAULTS,
            sets=TINY_RES_SETS + [("trainer;step_accurate_resume", False)],
            work=tmp_path / "work")


def test_resilience_config_is_the_repositorys_own():
    """Phase 11 runs configs/gpt2_small.json itself, cut by --set; the kill
    falls 15 steps after the slot of batch 16 (none between), and attempt
    2 must start at that slot's step."""
    assert chip_smoke.RES_CONFIG == chip_smoke.REPO / "configs" / \
        "gpt2_small.json"
    cut = dict(chip_smoke.RES_SETS)
    assert cut == {
        "train_loader;args;n": 256, "valid_loader;args;n": 64,
        "trainer;epochs": 2, "trainer;save_period": 1,
        "trainer;save_interval_steps": 16, "trainer;keep_last": 1,
        "trainer;grad_accum_steps": 2, "trainer;ema_decay": 0.999}
    assert chip_smoke.RES_FAULTS == "kill@step:31;crash@step:46@attempt:2"
    assert chip_smoke._pre_kill_slot(chip_smoke.RES_FAULTS, 16, 32) == 16
    assert chip_smoke._pre_kill_slot(TINY_RES_FAULTS, 4, 8) == 4
