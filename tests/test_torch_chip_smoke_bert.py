"""chip_smoke.py's phase 16 (slice 11: BERT, LoRA, soups) driven on the
CPU at a tiny size: 16a's card-against-CPU comparison (and its failure
when a gradient differs), 16c-16e's MLM runs (xla and flash), ``test.py``
checks, soups, the loader's timing and the warm and fresh classifier
runs over a few standard-library packages, and 16f-16g's LoRA runs (a
GPT-2 base from phase 6's path, the merge, ``generate.py`` on the merged
Llama, Mistral's code path at a tiny width). On the card the flash
kernels count their launches; here the plain versions run under counting
stand-ins, so the phases' exact per-step counts hold here too.
"""
import pytest

import chip_smoke
from test_torch_accum_ema import _process_signal_handlers  # noqa: F401
from test_torch_chip_smoke_serving import (  # noqa: F401
    _one_intra_op_thread, counted_plain,
)
from test_torch_chip_smoke_training import (  # noqa: F401
    TINY_TRAIN_SETS, counted_bwd,
)

# the BERT configs narrowed by --set: 2 layers of d_model 64, 32 tokens,
# batches of 16, a 300-id BPE over a 50 kB corpus
TINY_BERT = [("arch;args;n_layer", 2), ("arch;args;d_model", 64),
             ("arch;args;n_head", 2), ("arch;args;max_len", 32),
             ("arch;args;vocab_size", 301)] + [
    (f"{split}_loader;args;{key}", value)
    for split in ("train", "valid")
    for key, value in (("seq_len", 32), ("batch_size", 16),
                       ("vocab_size", 300))]
TINY_CLS = TINY_BERT + [
    (f"{split}_loader;args;{key}", value)
    for split in ("train", "valid")
    for key, value in (("modules", ["json", "tomllib", "email"]),
                       ("max_chunks_per_module", 40))] + [
    ("arch;args;num_classes", 3), ("trainer;epochs", 2)]
TINY_MISTRAL = [("arch;args;n_layer", 2), ("arch;args;d_model", 64),
                ("arch;args;n_head", 2), ("arch;args;n_kv_head", 1),
                ("arch;args;d_ff", 128), ("arch;args;vocab_size", 256),
                ("arch;args;window", 16), ("arch;args;max_len", 64)] + [
    (f"{split}_loader;args;{key}", value)
    for split in ("train", "valid")
    for key, value in (("seq_len", 32), ("vocab_size", 256))]


def test_bert_reference_phase_on_cpu():
    chip_smoke.phase_bert_reference(device="cpu")


def test_bert_reference_phase_fails_on_a_gradient(monkeypatch):
    real, calls = chip_smoke._bert_ref_run, []

    def run(*args, **kw):
        losses, grads, state = real(*args, **kw)
        calls.append(1)
        if len(calls) == 1:
            name = next(iter(grads))
            grads[name] = grads[name] + 1e-3
        return losses, grads, state

    monkeypatch.setattr(chip_smoke, "_bert_ref_run", run)
    with pytest.raises(AssertionError, match="differs from the CPU"):
        chip_smoke.phase_bert_reference(device="cpu")


def test_bert_phases_on_cpu(counted_plain, counted_bwd, tmp_path):
    launches = chip_smoke.phase_bert_mlm(
        "cpu", device="cpu", sets=TINY_BERT + chip_smoke.BERT_MLM_SETS,
        corpus_mb=0.05, work=tmp_path)
    layers = 2
    # flash: every train step B1, B2, B3 once per layer, eval B1
    assert launches["flash_bwd_dkv"] == launches["flash_bwd_dq"] > 0
    assert launches["flash_bwd_dkv"] % layers == 0
    assert launches["flash_fwd"] > launches["flash_bwd_dkv"]
    keep = tmp_path / "bert_keep"
    assert (keep / "model_best" / "model.pt").is_file()
    assert not (tmp_path / "bert_flash").exists()
    # a 2-layer model on ~100 windows stays near chance: the bar above
    # chance is the card's, at the config's width
    cls = chip_smoke.phase_bert_cls("cpu", device="cpu", sets=TINY_CLS,
                                    work=tmp_path, chance=0.0)
    assert cls == dict.fromkeys(chip_smoke.TRAIN_KERNELS, 0)    # xla
    assert not keep.exists()


def test_lora_phases_on_cpu(counted_plain, counted_bwd, tmp_path):
    base = tmp_path / "gpt2_base"
    chip_smoke.phase_train("cpu", device="cpu", sets=TINY_TRAIN_SETS,
                           work=tmp_path, keep=base)
    sets = [s for s in TINY_TRAIN_SETS if s[0] != "trainer;epochs"] + \
        chip_smoke.LORA_GPT2_SETS[2:]
    gpt2 = chip_smoke.phase_lora_gpt2("cpu", device="cpu", sets=sets,
                                      base=base, work=tmp_path)
    # 8 steps of 2 layers under remat, 2 eval batches
    assert gpt2 == {"flash_fwd": 2 * (2 * 8 + 2), "flash_bwd_dkv": 16,
                    "flash_bwd_dq": 16, "expert_ffn": 0}
    assert not base.exists()
    llama = chip_smoke.phase_lora_llama("cpu", device="cpu",
                                        mistral_sets=TINY_MISTRAL,
                                        work=tmp_path)
    # the tiny Mistral: 6 steps of 2 layers under remat, one eval batch
    assert llama == {"flash_fwd": 2 * (2 * 6 + 1), "flash_bwd_dkv": 12,
                     "flash_bwd_dq": 12, "expert_ffn": 0}
