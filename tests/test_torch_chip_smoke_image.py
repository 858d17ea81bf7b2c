"""chip_smoke.py's phase 15 (slice 10: the image configs) driven on the
CPU at a tiny size: 15a's card-against-CPU comparison (and its failure
when a BN running average differs), 15c's CIFAR path with its exact
resume and ``test.py`` check, 15d's two ResNet-50 runs (the synthetic
fallback, then uint8 shards from the port's tool through the native
gather and the on-device normalize), 15e's two ViT runs, and 15f's
ranks-against-one-rank comparison with 2 gloo ranks under ``torchrun``.
The phases' kernel launch counts are the card's: on the CPU every count
is 0 and so is what the phases expect there.
"""
import json

import pytest
import torch

import chip_smoke
from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401
from test_torch_accum_ema import _process_signal_handlers  # noqa: F401

# small enough for the CPU; a lower learning rate, so that 8 steps of 16
# move the loss down as the full config's 32 steps of 256 do on the card
CIFAR_TINY = [("train_loader;args;synthetic_n", 64),
              ("valid_loader;args;synthetic_n", 32),
              ("train_loader;args;batch_size", 16),
              ("valid_loader;args;batch_size", 16),
              ("optimizer;args;lr", 0.02), ("trainer;tensorboard", False)]
IMAGENET_TINY = [("arch;args;num_classes", 10)] + [
    (f"{split}_loader;args;{key}", value)
    for split in ("train", "valid")
    for key, value in (("image_size", 32), ("num_classes", 10),
                       ("batch_size", 8))] + [("trainer;tensorboard", False)]


def test_image_reference_phase_on_cpu():
    chip_smoke.phase_image_reference(device="cpu")


def test_image_reference_phase_fails_on_a_bn_buffer(monkeypatch):
    real = chip_smoke._image_ref_run
    calls = []

    def run(spec, state, batches, device):
        losses, out = real(spec, state, batches, device)
        calls.append(1)
        if len(calls) == 1 and "bn_init.running_var" in out:
            out["bn_init.running_var"] += 1e-3
        return losses, out

    monkeypatch.setattr(chip_smoke, "_image_ref_run", run)
    with pytest.raises(AssertionError, match="differs from the CPU"):
        chip_smoke.phase_image_reference(device="cpu")


def test_cifar_phase_on_cpu(tmp_path):
    chip_smoke.phase_cifar("cpu", device="cpu",
                           sets=CIFAR_TINY + chip_smoke.CIFAR_SETS,
                           work=tmp_path)


def test_resnet50_phase_on_cpu(tmp_path):
    # the tool's synthetic shards hold ImageNet's 1000 classes
    sets = IMAGENET_TINY + [("arch;args;input_shape", [32, 32, 3]),
                            ("arch;args;num_classes", 1000)] + [
        (f"{split}_loader;args;{key}", value)
        for split in ("train", "valid")
        for key, value in (("synthetic_n", 16), ("num_classes", 1000))]
    out = chip_smoke.phase_resnet50(
        "cpu", device="cpu", sets=sets + chip_smoke.RESNET50_SETS,
        shards={"train": 16, "val": 8}, image_size=32, work=tmp_path)
    assert out["shards"]["native_gathers"] > 0
    assert out["shards"]["on_device_normalize"]
    assert out["synthetic"]["steps"] == out["shards"]["steps"] == 2
    assert out["synthetic"]["model_flops_per_step"] > 0


def test_vit_phase_on_cpu(tmp_path):
    sets = IMAGENET_TINY + [
        ("arch;args;n_layer", 2), ("arch;args;d_model", 64),
        ("arch;args;n_head", 2), ("arch;args;image_size", 32),
        ("arch;args;patch_size", 8)] + [
        (f"{split}_loader;args;n", 16) for split in ("train", "valid")]
    launches = chip_smoke.phase_vit(
        "cpu", device="cpu", sets=sets + [("trainer;epochs", 2),
                                          ("trainer;save_period", 10),
                                          ("trainer;grad_accum_steps", 2)],
        work=tmp_path)
    assert launches == {"flash_fwd": 0, "flash_bwd_dkv": 0,
                        "flash_bwd_dq": 0}


def test_image_nccl_phase_with_two_gloo_ranks(tmp_path):
    runs = [("cifar10_resnet18", chip_smoke.CIFAR_CONFIG,
             [("train_loader;args;batch_size", 4),
              ("valid_loader;args;batch_size", 4)],
             [("train_loader;args;batch_size", 8),
              ("valid_loader;args;batch_size", 8)])]
    common = chip_smoke.IMAGE_NCCL_COMMON + [
        ("train_loader;args;synthetic_n", 32),
        ("valid_loader;args;synthetic_n", 16)]
    out = chip_smoke.phase_seq_nccl(
        "cpu", device="cpu", work=tmp_path, runs=runs, common=common,
        nproc=2, corpus_bytes=0, timeout=600.0, tag="image_nccl")
    row = out["cifar10_resnet18"]
    assert row["world"] == 2 and row["backend"] == "gloo"
    assert len(row["losses"]) == chip_smoke.SEQ_NCCL_STEPS
    # the mixup roll's partner rows: one ppermute for the inputs and one
    # for the labels on a step whose shift is odd
    assert any(s["ppermute"] for s in row["p2p_per_step"])
    json.dumps(row)


def test_image_nccl_phase_says_it_did_not_run(capsys):
    if torch.cuda.device_count() >= 4:
        pytest.skip("four cards: the phase runs")
    assert chip_smoke.phase_seq_nccl(
        "cpu", device="cuda", runs=chip_smoke.IMAGE_NCCL,
        common=chip_smoke.IMAGE_NCCL_COMMON, corpus_bytes=0,
        tag="image_nccl") == {}
    line = capsys.readouterr().out.strip().splitlines()[-1]
    got = json.loads(line.split(" ", 1)[1])
    assert got["image_nccl"] == (f"not run: {torch.cuda.device_count()} "
                                 "card(s)")
