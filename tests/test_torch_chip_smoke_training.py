"""chip_smoke.py's phases of slice 3 (LM training), driven on the CPU at a
tiny size. On the card the kernels run and count their launches; here their
plain versions run, so counting stand-ins for the plain versions show that
every step went through the kernels as often as the phase asserts, and that
the script fails a run whose path skipped them.
"""
import pytest

import chip_smoke
from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401
from pytorch_distributed_template_tpu_torch.ops import flash
from test_torch_accum_ema import _process_signal_handlers  # noqa: F401
from test_torch_chip_smoke_serving import counted_plain  # noqa: F401


# slice 3 at a tiny size: the GPT-2 training config with the model and the
# data narrowed (--set), the same code path as the full-width run
TINY_TRAIN_SETS = [
    ("arch;args;n_layer", 2), ("arch;args;d_model", 64),
    ("arch;args;n_head", 2), ("arch;args;vocab_size", 128),
    ("arch;args;max_len", 32),
    ("train_loader;args;vocab_size", 128), ("train_loader;args;seq_len", 32),
    ("valid_loader;args;vocab_size", 128), ("valid_loader;args;seq_len", 32),
    ("train_loader;args;n", 64), ("valid_loader;args;n", 16),
    ("optimizer;args;lr", 0.003), ("trainer;epochs", 2),
    ("trainer;save_period", 1),
]


@pytest.fixture()
def counted_bwd(monkeypatch):
    ref = flash.flash_attention_bwd_ref

    def counted(*args, **kw):
        flash.FLASH_BWD_DKV.launches += 1
        flash.FLASH_BWD_DQ.launches += 1
        return ref(*args, **kw)

    monkeypatch.setattr(flash, "flash_attention_bwd_ref", counted)


def test_train_config_loads_with_every_key_but_the_later_slices():
    import json

    port = json.loads(chip_smoke.TRAIN_CONFIG.read_text())
    jax_cfg = json.loads((chip_smoke.REPO / "configs" /
                          "gpt2_small.json").read_text())
    # phase 6's copy: the repository's config with every observability
    # key off (phase 10 runs the repository's own file)
    assert "compile_cache" not in port
    for key in ("health", "telemetry"):
        assert port["trainer"][key] == {"enabled": False}
    assert port["trainer"]["tensorboard"] is False
    jax_cfg.pop("compile_cache")
    for key in ("health", "telemetry"):
        jax_cfg["trainer"][key] = {"enabled": False}
    jax_cfg["trainer"]["tensorboard"] = False
    assert port == jax_cfg


def test_train_reference_phase_on_cpu():
    chip_smoke.phase_train_reference(device="cpu")


def test_train_phase_on_cpu(counted_plain, counted_bwd, tmp_path):
    launches = chip_smoke.phase_train("cpu", device="cpu",
                                      sets=TINY_TRAIN_SETS,
                                      work=tmp_path / "work")
    # 2 epochs x 8 steps on the main run, 8 more on the resumed epoch 2;
    # eval: 2 x 2 + 2 batches
    layers, train_steps, eval_steps = 2, 16 + 8, 4 + 2
    assert launches == {
        "flash_fwd": layers * (2 * train_steps + eval_steps),
        "flash_bwd_dkv": layers * train_steps,
        "flash_bwd_dq": layers * train_steps, "expert_ffn": 0}
    assert not (tmp_path / "work" / "train").exists()


def test_train_phase_fails_when_the_backward_kernels_are_skipped(
        counted_plain, tmp_path):
    with pytest.raises(AssertionError, match="train step launched"):
        chip_smoke.phase_train("cpu", device="cpu", sets=TINY_TRAIN_SETS,
                               work=tmp_path / "work")
