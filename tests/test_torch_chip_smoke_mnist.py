"""chip_smoke.py's phases of slice 5 (LeNet/MNIST with DDP), driven on the
CPU at a tiny size. On the card the kernels run and count their launches;
here their plain versions run, so counting stand-ins for the plain versions
show that every step went through the kernels as often as the phase
asserts, and that the script fails a run whose path skipped them.
"""
import pytest

import chip_smoke
from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401
from test_torch_accum_ema import _process_signal_handlers  # noqa: F401


# slice 5 at a small size: configs/mnist.json with the sample counts and
# the epochs cut (--set) and a larger lr so 3 short epochs learn; gloo
# stands in for NCCL on the CPU, the same code path otherwise
TINY_MNIST_SETS = list(chip_smoke.MNIST_SETS) + [
    ("train_loader;args;synthetic_n", 512),
    ("valid_loader;args;synthetic_n", 200),
    ("test_loader;args;synthetic_n", 200),
    ("train_loader;args;batch_size", 64), ("trainer;epochs", 3),
    ("optimizer;args;lr", 0.003)]


def test_lenet_reference_phase_on_cpu(tmp_path):
    chip_smoke.phase_lenet_reference(device="cpu", work=tmp_path)
    assert not (tmp_path / "lenet_ref").exists()


def test_mnist_phase_on_cpu(tmp_path):
    import os

    from pytorch_distributed_template_tpu_torch.parallel import dist

    out = chip_smoke.phase_mnist("cpu", device="cpu", sets=TINY_MNIST_SETS,
                                 work=tmp_path)
    assert out["backend"] == "gloo" and out["ddp"]
    assert out["steps"] == 3 * 8
    assert out["allreduce_per_step"]["calls"] >= 1
    # LeNet's 21,840 f32 parameters cross in the all-reduce every step
    assert out["allreduce_per_step"]["bytes"] == 4 * 21840 * \
        out["allreduce_per_step"]["calls"]
    assert out["final"]["val_accuracy"] > chip_smoke.MNIST_MIN_VAL_ACC
    assert out["torchrun"]["exit"] == 0
    assert not dist.in_group() and "WORLD_SIZE" not in os.environ
    assert not (tmp_path / "mnist").exists()


def test_mnist_phase_fails_without_ddp(monkeypatch, tmp_path):
    from pytorch_distributed_template_tpu_torch.engine import trainer

    monkeypatch.setattr(trainer.dist, "in_group", lambda: False)
    with pytest.raises(AssertionError, match="not wrapped"):
        chip_smoke.phase_mnist("cpu", device="cpu", sets=TINY_MNIST_SETS,
                               work=tmp_path)


def test_mnist_phase_fails_when_the_allreduce_hook_never_fires(
        monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.nn.parallel.DistributedDataParallel,
                        "register_comm_hook", lambda self, state, hook: None)
    with pytest.raises(AssertionError, match="no gradient all-reduce"):
        chip_smoke.phase_mnist("cpu", device="cpu", sets=TINY_MNIST_SETS,
                               work=tmp_path)
