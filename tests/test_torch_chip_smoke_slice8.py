"""chip_smoke.py's phases 3e (the other optimizers on the card against
the CPU, and their state at GPT-2 small's widths) and 13 (the real
digits), driven on the CPU at a tiny size, each also failing when what it
checks goes wrong. Phase 12 is in tests/test_torch_chip_smoke_lm.py.
"""
import json

import pytest

import chip_smoke
from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401
from test_torch_accum_ema import _process_signal_handlers  # noqa: F401
from pytorch_distributed_template_tpu_torch.data import native
from pytorch_distributed_template_tpu_torch.engine import optim

# phase 3e's full-width part at a tiny width: the GPT-2 small config with
# the arch narrowed (its qkv / MLP kernels still factor under Adafactor)
TINY_FULL_ARCH = {"n_layer": 2, "d_model": 128, "n_head": 2,
                  "vocab_size": 512, "max_len": 64}


@pytest.fixture()
def tiny_full_config(tmp_path):
    cfg = json.loads(chip_smoke.OPTIM_FULL_CONFIG.read_text())
    cfg["arch"]["args"].update(TINY_FULL_ARCH)
    cfg["train_loader"]["args"]["batch_size"] = 2
    path = tmp_path / "gpt2_tiny.json"
    path.write_text(json.dumps(cfg))
    return path


def test_optim_reference_phase_on_cpu():
    chip_smoke.phase_optim_reference(device="cpu")


def test_optim_reference_phase_fails_when_trainable_freezes_nothing(
        monkeypatch):
    monkeypatch.setattr(optim, "Trainable",
                        lambda model, patterns: model)
    trainable = [c for c in chip_smoke.OPTIM_REF if c[0] == "AdamW_trainable"]
    with pytest.raises(AssertionError, match="froze nothing"):
        chip_smoke.phase_optim_reference(device="cpu", configs=trainable)


def test_optim_full_phase_on_cpu(tiny_full_config):
    rows = chip_smoke.phase_optim_full("cpu", device="cpu",
                                       config=tiny_full_config)
    by = {r["optimizer"]: r for r in rows}
    assert set(by) == {"AdamW", "Adafactor", "Lion", "Adam_mu_bf16"}
    n = by["AdamW"]["params"]
    assert by["AdamW"]["state_bytes"] == 8 * n
    assert by["Lion"]["state_bytes"] == 4 * n
    assert by["Adam_mu_bf16"]["state_bytes"] == 6 * n
    assert by["Adafactor"]["state_bytes"] < n


def test_optim_full_phase_fails_when_the_state_outgrows_the_shapes(
        tiny_full_config, monkeypatch):
    real = optim.Lion._init

    def two_buffers(self, p, group):
        st = real(self, p, group)
        st["extra"] = st["mu"].clone()
        return st

    monkeypatch.setattr(optim.Lion, "_init", two_buffers)
    with pytest.raises(AssertionError, match="Lion at full width"):
        chip_smoke.phase_optim_full("cpu", device="cpu",
                                    config=tiny_full_config)


def test_digits_phase_on_cpu(tmp_path):
    native.CALLS.reset()
    row = chip_smoke.phase_digits(
        "cpu", device="cpu", work=tmp_path, min_val_acc=0.5,
        sets=[("trainer;epochs", 3), ("trainer;save_period", 1)])
    assert native.CALLS.calls > 0
    assert row["epochs_run"] == 3 and row["steps"] == 3 * 23
    assert row["final"]["val_accuracy"] >= 0.5
    assert row["tested"] == "model_best"
    assert not (tmp_path / "digits").exists()


def test_digits_phase_fails_under_its_bar(tmp_path):
    with pytest.raises(AssertionError, match="is under"):
        chip_smoke.phase_digits(
            "cpu", device="cpu", work=tmp_path, min_val_acc=1.01,
            sets=[("trainer;epochs", 1), ("trainer;save_period", 1)])


def test_digits_config_is_the_repositorys_own():
    assert chip_smoke.DIGITS_CONFIG == chip_smoke.REPO / "configs" / \
        "digits.json"
    assert chip_smoke.DIGITS_MIN_VAL_ACC == 0.95
