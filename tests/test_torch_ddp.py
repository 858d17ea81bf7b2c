"""Data parallelism on the CPU: ``configs/mnist_debug.json`` trained by the
port's ``train.py`` in 2 processes (gloo, DDP, per-rank batch 32, each
process a subprocess with the launcher's environment) against the same run
in 1 process with batch 64.

The two runs see the same samples in every step, since shard ``k`` takes
the global order's positions ``k::2``, so they differ by float32
summation order only: epoch logs rtol 1e-5, final params atol 1e-5, and
every rank logs the same global numbers. The sizes are ragged on purpose:
449 training samples put one real row in rank 0's last batch and none in
rank 1's, so a step that averaged each rank's own mean (a textbook DDP
loop) would halve that step's gradient and fail the comparison; 250
validation samples end both ranks on a partly padded batch, and the
logged validation metrics must equal the same model scored on the 250
samples in one batch (rtol 1e-6). A checkpoint written by the 2-rank run
resumes in one process and reproduces its epoch 2 (rtol 1e-5).

The same comparison runs on the card with 4 NCCL ranks (per-rank batch
16, one card each; marked ``cuda``, skipped without 4 CUDA devices), TF32
off in every process, so the runs differ by float32 summation order only;
there a logit within that order of a tie can flip one example's
``accuracy`` or ``top_k_acc`` (1 of 449 flips on four NVIDIA H100 80GB
HBM3 at 700 W), so those are held to one example of their split. The
losses keep rtol 1e-5. The params are held to atol 1e-3, one amsgrad
update (lr):
the card's convs sum batches of 16 and 64 in other orders, and the
update ``m / sqrt(v)`` of a weight whose gradient is small amplifies
that difference from step to step (up to 1.08e-4 after 16 steps on the
same cards).

Every process gets a free port, its own timeout and is killed on it: a
hung rank fails the test, it never waits.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_distributed_template_tpu_torch import train as ttrain
from pytorch_distributed_template_tpu_torch.data.datasets import (
    synthetic_mnist,
)
from pytorch_distributed_template_tpu_torch.engine import (
    losses, metrics,
)
from pytorch_distributed_template_tpu_torch.models.lenet import LeNet

REPO = Path(__file__).resolve().parent.parent
CONFIG = REPO / "configs" / "mnist_debug.json"
SETS = [("train_loader;args;synthetic_n", 449),
        ("valid_loader;args;synthetic_n", 250)]
KEYS = ("loss", "accuracy", "top_k_acc", "val_loss", "val_accuracy",
        "val_top_k_acc")
TIMEOUT_S = 240

CHILD = r"""
import json, sys
import torch
from pytorch_distributed_template_tpu_torch import train
from pytorch_distributed_template_tpu_torch.parallel import dist

argv, out = json.loads(sys.argv[1]), sys.argv[2]
logs, box = [], {}
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def hook(trainer):
    box["trainer"] = trainer
    for mod in (trainer.model.Dropout_0, trainer.model.Dropout_1):
        mod.p = 0.0
    real = trainer._train_epoch

    def record(epoch):
        log = real(epoch)
        logs.append(dict(log))
        return log

    trainer._train_epoch = record


try:
    train.main(argv, on_trainer=hook)
    t = box["trainer"]
    rank = dist.process_index()
    if rank == 0:
        torch.save({k: v.cpu() for k, v in t.model.state_dict().items()},
                   out + ".pt")
    import torch.distributed as tdist
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump({"logs": logs, "ddp": t.ddp is not None,
                   "world": dist.process_count(),
                   "backend": tdist.get_backend(),
                   "steps": len(t.train_loader),
                   "save_dir": str(t.config.save_dir)}, f)
finally:
    dist.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _argv(save_dir, batch, device="cpu"):
    argv = ["-c", str(CONFIG), "--device", device, "-s", str(save_dir),
            "--bs", str(batch)]
    for chain, value in SETS:
        argv += ["--set", chain, json.dumps(value)]
    return argv


def _launch(argv, out, world: int):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD, json.dumps(argv), str(out)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, text in zip(procs, outputs):
        assert p.returncode == 0, text[-3000:]
    return [json.loads(Path(f"{out}.rank{r}.json").read_text())
            for r in range(world)]


def _port_run(argv):
    box, logs = {}, []

    def hook(trainer):
        box["trainer"] = trainer
        for mod in (trainer.model.Dropout_0, trainer.model.Dropout_1):
            mod.p = 0.0
        real = trainer._train_epoch

        def record(epoch):
            log = real(epoch)
            logs.append(dict(log))
            return log

        trainer._train_epoch = record

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ttrain.main(argv, on_trainer=hook)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return logs, box["trainer"]


def _check_ranks_equal_one_process(ranks, params, one_logs, one, world,
                                   backend, steps=8, one_example=False,
                                   param_atol=1e-5):
    for r in ranks:
        assert r["ddp"] and r["world"] == world and r["backend"] == backend
        assert r["steps"] == steps == len(one.train_loader)
        # global numbers on every rank (examples/s is each rank's own)
        assert [{k: log[k] for k in KEYS} for log in r["logs"]] == [
            {k: log[k] for k in KEYS} for log in ranks[0]["logs"]]
    assert one.ddp is None
    assert len(one_logs) == len(ranks[0]["logs"]) == 2
    n = {key: dict(SETS)[f"{'valid' if key.startswith('val_') else 'train'}"
                         f"_loader;args;synthetic_n"] for key in KEYS}
    for got, want in zip(ranks[0]["logs"], one_logs):
        for key in KEYS:
            if one_example and "acc" in key:
                assert abs(got[key] - want[key]) <= 1 / n[key] + 1e-9, key
            else:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                           err_msg=key)
    for name, p in one.model.state_dict().items():
        np.testing.assert_allclose(params[name].numpy(), p.cpu().numpy(),
                                   atol=param_atol, err_msg=name)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    ranks = _launch(_argv(tmp / "two", 32), tmp / "two_out", world=2)
    one_logs, one = _port_run(_argv(tmp / "one", 64))
    return tmp, ranks, torch.load(str(tmp / "two_out") + ".pt"), one_logs, one


def test_two_ranks_equal_one_process(runs):
    _, ranks, two_params, one_logs, one = runs
    _check_ranks_equal_one_process(ranks, two_params, one_logs, one, 2,
                                   "gloo")


def four_ranks_equal_one_process(tmp, device="cuda"):
    """4 ranks (per-rank batch 16) against 1 process (batch 64), both on
    ``device``: NCCL on 4 cards, or gloo on the CPU."""
    ranks = _launch(_argv(tmp / "four", 16, device), tmp / "four_out",
                    world=4)
    one_logs, one = _port_run(_argv(tmp / "one", 64, device))
    _check_ranks_equal_one_process(
        ranks, torch.load(str(tmp / "four_out") + ".pt"), one_logs, one, 4,
        "nccl" if device == "cuda" else "gloo", one_example=True,
        param_atol=1e-3)


@pytest.mark.cuda
def test_four_nccl_ranks_equal_one_process(tmp_path):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices (one NCCL rank per card)")
    four_ranks_equal_one_process(tmp_path)


def test_ragged_validation_gives_exact_global_metrics(runs):
    _, ranks, two_params, _, _ = runs
    model = LeNet(device="cpu")
    model.load_state_dict(two_params)
    model.eval()
    data = synthetic_mnist(n=250, training=False)
    with torch.no_grad():
        out = model(torch.from_numpy(data["image"]))
    label = torch.from_numpy(data["label"])
    want = {"val_loss": losses.nll_loss(out, label).mean(),
            "val_accuracy": metrics.accuracy(out, label).mean(),
            "val_top_k_acc": metrics.top_k_acc(out, label).mean()}
    last = ranks[0]["logs"][-1]
    for key, value in want.items():
        np.testing.assert_allclose(last[key], float(value), rtol=1e-6,
                                   err_msg=key)


def test_two_rank_checkpoint_resumes_in_one_process(runs):
    tmp, ranks, _, _, _ = runs
    ckpt = Path(ranks[0]["save_dir"]) / "checkpoint-epoch1"
    assert ckpt.is_dir() and not any(
        k.startswith("module.") for k in torch.load(ckpt / "model.pt"))
    logs, resumed = _port_run(["-r", str(ckpt), "--device", "cpu", "-s",
                               str(tmp / "resumed"), "--bs", "64"])
    assert resumed.start_epoch == 2 and len(logs) == 1
    for key in KEYS:
        np.testing.assert_allclose(logs[0][key], ranks[0]["logs"][1][key],
                                   rtol=1e-5, err_msg=key)
