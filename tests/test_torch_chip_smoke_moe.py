"""chip_smoke.py's phases of slice 4 (MoE LM training), driven on the CPU
at a tiny size. On the card the kernels run and count their launches; here
their plain versions run, so counting stand-ins for the plain versions show
that every step went through the kernels as often as the phase asserts, and
that the script fails a run whose path skipped them.
"""
import pytest

import chip_smoke
from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401
from test_torch_accum_ema import _process_signal_handlers  # noqa: F401
from test_torch_chip_smoke_serving import counted_plain  # noqa: F401
from test_torch_chip_smoke_training import counted_bwd  # noqa: F401


# slice 4 at a tiny size: configs/moelm_stdlib.json with the model, the
# sequence and the batch narrowed (--set) over a 10 kB corpus, the same
# code path as the full-width run
TINY_MOE_SETS = [
    ("arch;args;n_layer", 2), ("arch;args;d_model", 64),
    ("arch;args;n_head", 2), ("arch;args;d_ff", 128),
    ("arch;args;max_len", 32), ("arch;args;num_experts", 4),
    ("train_loader;args;seq_len", 32), ("valid_loader;args;seq_len", 32),
    ("train_loader;args;batch_size", 16),
    ("valid_loader;args;batch_size", 16),
    ("optimizer;args;lr", 0.003), ("trainer;epochs", 2),
    ("trainer;save_period", 1), ("trainer;health", {"enabled": False}),
    ("trainer;telemetry", {"enabled": False}),
]


@pytest.fixture()
def counted_ffn(monkeypatch):
    from pytorch_distributed_template_tpu_torch.ops import expert_ffn as ffn

    ref = ffn.expert_ffn_ref

    def counted(*args, **kw):
        ffn.EXPERT_FFN.launches += 1
        return ref(*args, **kw)

    monkeypatch.setattr(ffn, "expert_ffn_ref", counted)


def test_moe_train_phase_on_cpu(counted_plain, counted_bwd, counted_ffn,
                                tmp_path):
    launches = chip_smoke.phase_moe_train(
        "cpu", device="cpu", sets=TINY_MOE_SETS, corpus_mb=0.01,
        work=tmp_path / "work")
    # 9,000 train bytes = 281 windows of 32: 18 steps of 16 per epoch, 2
    # epochs on the main run and epoch 2 again on the resumed one; 1,000
    # val bytes: 2 eval steps per epoch; both layers are MoE layers
    layers, train_steps, eval_steps = 2, 18 * 3, 2 * 3
    assert launches == {
        "flash_fwd": layers * (train_steps + eval_steps),
        "flash_bwd_dkv": layers * train_steps,
        "flash_bwd_dq": layers * train_steps,
        "expert_ffn": layers * (train_steps + eval_steps)}
    assert not (tmp_path / "work" / "moe_train").exists()
    assert not (tmp_path / "work" / "moe_data").exists()


def test_moe_train_phase_fails_when_the_expert_kernel_is_skipped(
        counted_plain, counted_bwd, tmp_path):
    with pytest.raises(AssertionError, match="train step launched"):
        chip_smoke.phase_moe_train("cpu", device="cpu", sets=TINY_MOE_SETS,
                                   corpus_mb=0.01, work=tmp_path / "work")


def test_moe_config_is_the_repositorys_own():
    """Slice 4 runs configs/moelm_stdlib.json itself; every cut is a --set
    (MOE_SETS, the corpus size), and the observability that slice 6 turned
    on by default stays off, as in phase 6's config."""
    assert chip_smoke.MOE_CONFIG == chip_smoke.REPO / "configs" / \
        "moelm_stdlib.json"
    assert dict(chip_smoke.MOE_SETS) == {
        "trainer;epochs": 2, "trainer;save_period": 1,
        "trainer;health": {"enabled": False},
        "trainer;telemetry": {"enabled": False}}
