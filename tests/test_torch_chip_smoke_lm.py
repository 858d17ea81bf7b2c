"""chip_smoke.py's phase 12 (configs/bytelm_stdlib.json and
configs/bpelm_stdlib.json through the port's train.py), driven on the CPU
at a tiny size. On the card the flash kernels run and count their
launches; here their plain versions run under counting stand-ins, so the
phase's exact per-step counts hold here too; it fails when the BPE
tokenizer is fitted more than once.
"""
import pytest

import chip_smoke
from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401
from test_torch_accum_ema import _process_signal_handlers  # noqa: F401
from pytorch_distributed_template_tpu_torch.data import native
from test_torch_chip_smoke_serving import counted_plain  # noqa: F401
from test_torch_chip_smoke_training import counted_bwd  # noqa: F401


# phase 12 at a tiny size: both LM configs with the model, the sequence
# and the batch narrowed (--set), the BPE vocab 300, over a 12 kB corpus
TINY_LM = [("arch;args;n_layer", 2), ("arch;args;d_model", 64),
           ("arch;args;n_head", 2), ("arch;args;max_len", 32),
           ("train_loader;args;seq_len", 32),
           ("valid_loader;args;seq_len", 32),
           ("train_loader;args;batch_size", 16),
           ("valid_loader;args;batch_size", 16)]
TINY_BYTE_SETS = list(chip_smoke.BYTELM_SETS) + TINY_LM
TINY_BPE_SETS = list(chip_smoke.BPELM_SETS) + TINY_LM + [
    ("arch;args;vocab_size", 300), ("train_loader;args;vocab_size", 300),
    ("valid_loader;args;vocab_size", 300)]


def _lm_phase(tmp_path, **kw):
    return chip_smoke.phase_lm_configs(
        "cpu", device="cpu", byte_sets=TINY_BYTE_SETS,
        bpe_sets=TINY_BPE_SETS, corpus_mb=0.012, work=tmp_path / "work",
        **kw)


def test_lm_configs_phase_on_cpu(counted_plain, counted_bwd, tmp_path):
    native.CALLS.reset()
    launches = _lm_phase(tmp_path)
    assert native.CALLS.calls > 0
    layers = 2
    # every train step: B1, B2, B3 once per layer; every eval step B1
    assert launches["flash_bwd_dkv"] == launches["flash_bwd_dq"] > 0
    assert launches["flash_bwd_dkv"] % layers == 0
    assert launches["flash_fwd"] > launches["flash_bwd_dkv"]
    assert launches["expert_ffn"] == 0
    assert not (tmp_path / "work" / "lm_data").exists()


def test_lm_configs_phase_fails_when_the_tokenizer_is_refitted(
        counted_plain, counted_bwd, tmp_path, monkeypatch):
    from pytorch_distributed_template_tpu_torch.data import tokenizer

    real, calls = tokenizer.bpe_cache_path, []

    def fresh(*args, **kw):    # every loader its own cache: a refit each
        calls.append(1)
        path = real(*args, **kw)
        return path.with_name(f"r{len(calls)}.{path.name}")

    monkeypatch.setattr(tokenizer, "bpe_cache_path", fresh)
    with pytest.raises(AssertionError, match="fitted [2-9] times"):
        _lm_phase(tmp_path, byte_config=None)


def test_lm_configs_are_the_repositorys_own():
    assert chip_smoke.BYTELM_CONFIG == chip_smoke.REPO / "configs" / \
        "bytelm_stdlib.json"
    assert chip_smoke.BPELM_CONFIG == chip_smoke.REPO / "configs" / \
        "bpelm_stdlib.json"
    assert dict(chip_smoke.BYTELM_SETS) == {"trainer;epochs": 1}
    assert dict(chip_smoke.BPELM_SETS) == {"trainer;epochs": 2,
                                           "trainer;save_period": 1}
    # the corpus cut to 1 MB (2 MB before) to pay for phase 22's time
    assert chip_smoke.LM_CORPUS_MB == 1.0
