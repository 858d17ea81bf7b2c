"""Slice 10's gate on the CPU: the three image configs through the port's
``train.py --device cpu`` against the JAX package's ``Trainer``, and the
train step's augment, mixup and BatchNorm state.

- ``configs/cifar10_resnet18.json`` (ResNet-18 at full width),
  ``imagenet_resnet50.json`` (ResNet-50 at full width, float32, 32 px
  synthetic images of 10 classes) and ``imagenet_vit_b16.json`` (ViT cut
  to 2 layers of d_model 64 by ``arch.args`` overrides, 32 px, patch 8,
  dropout 0, float32), each cut by ``--set`` to a few steps of 8 (the
  JAX run shards a batch over the 8 host devices of the tests) with
  ``augment`` and ``mixup_alpha`` off, from the JAX run's initial params
  and ``batch_stats``: epoch logs rtol 1e-4, final params atol 1e-4 and
  BN running averages atol 1e-5 against the JAX state.
- Mixup: for a given ``lam`` and ``shift`` the port's step gives JAX's
  mixed loss (rtol 1e-5) and gradients (atol 1e-5 x the leaf's largest
  |grad| + 1e-7), computed as the JAX step computes them
  (``engine/steps.py:173-196``: the global roll of inputs and labels,
  ``lam L(y) + (1 - lam) L(y_rolled)``).
- ``skip_nonfinite`` with ``nan_grad@step:1`` leaves the BN buffers,
  params and optimizer state bit-identical on the skipped step.
- Checkpoints carry the BN buffers: a resume from ``checkpoint-epoch1``
  and one from the last interval slot both end bitwise equal to the
  uninterrupted run (augment and mixup on, one intra-op thread); the
  emergency save holds them; ``init_from`` grafts the params and leaves
  the buffers at their init, as the JAX warm start leaves
  ``batch_stats``; ``test.py`` on ``model_best`` equals the best epoch's
  validation (rtol 1e-6) and ``--save-outputs`` writes its rows.
- Data parallelism: 2 gloo ranks (one spawn of subprocesses, batch 4
  each) equal 1 process (batch 8) with augment and mixup on: global BN
  statistics, the global roll's ``ppermute``, the augment draws sliced
  per rank. Logs rtol 1e-5, params and buffers atol 1e-5.
- ``global_roll``'s index arithmetic against ``np.roll`` of the global
  batch for every shard count up to 4 and every shift.
"""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_template_tpu.config import (
    ConfigParser as JConfigParser, LOADERS as JLOADERS,
    METRICS as JMETRICS, MODELS as JMODELS,
)
import pytorch_distributed_template_tpu.data  # noqa: F401  (register)
import pytorch_distributed_template_tpu.engine  # noqa: F401
import pytorch_distributed_template_tpu.models  # noqa: F401
from pytorch_distributed_template_tpu.engine import Trainer as JTrainer
from pytorch_distributed_template_tpu.engine.losses import (
    resolve_loss as jresolve_loss,
)
from pytorch_distributed_template_tpu.models import resnet as jres
from pytorch_distributed_template_tpu.parallel import mesh_from_config

from pytorch_distributed_template_tpu_torch import test as ttest
from pytorch_distributed_template_tpu_torch import train as ttrain
from pytorch_distributed_template_tpu_torch.engine import losses, optim, steps
from pytorch_distributed_template_tpu_torch.models import (
    convert, resnet as tres,
)

REPO = Path(__file__).resolve().parent.parent
KEYS = ("loss", "accuracy", "top_k_acc", "val_loss", "val_accuracy",
        "val_top_k_acc")
OFF = [("trainer;augment", None), ("trainer;mixup_alpha", 0.0),
       ("trainer;tensorboard", False), ("trainer;save_period", 1)]
CONFIGS = {
    "cifar10_resnet18": [
        ("train_loader;args;synthetic_n", 16),
        ("valid_loader;args;synthetic_n", 8),
        ("train_loader;args;batch_size", 8),
        ("valid_loader;args;batch_size", 8), ("trainer;epochs", 1)],
    "imagenet_resnet50": [
        ("arch;args;num_classes", 10), ("arch;args;bfloat16", False),
        ("arch;args;input_shape", [32, 32, 3])] + [
        (f"{split}_loader;args;{key}", value)
        for split in ("train", "valid")
        for key, value in (("synthetic_n", 16), ("image_size", 32),
                           ("num_classes", 10), ("batch_size", 8),
                           ("data_dir", "no_shards/"))] + [
        ("trainer;epochs", 1)],
    "imagenet_vit_b16": [
        ("arch;args;num_classes", 10), ("arch;args;bfloat16", False),
        ("arch;args;dropout", 0.0), ("arch;args;image_size", 32),
        ("arch;args;patch_size", 8), ("arch;args;n_layer", 2),
        ("arch;args;d_model", 64), ("arch;args;n_head", 2)] + [
        (f"{split}_loader;args;{key}", value)
        for split in ("train", "valid")
        for key, value in (("n", 16), ("image_size", 32),
                           ("num_classes", 10), ("batch_size", 8))] + [
        ("trainer;epochs", 2)],
}
TIMEOUT_S = 300


def _apply_sets(cfg, sets):
    for chain, value in sets:
        node = cfg
        *head, last = chain.split(";")
        for k in head:
            node = node[k]
        node[last] = value
    return cfg


def _jax_run(name, tmp):
    cfg = json.loads((REPO / "configs" / f"{name}.json").read_text())
    cfg["trainer"]["save_dir"] = str(tmp / "jax")
    _apply_sets(cfg, OFF + CONFIGS[name])
    config = JConfigParser(cfg, run_id="jax", training=True)
    logs = []
    trainer = JTrainer(
        config.init_obj("arch", JMODELS), jresolve_loss(config["loss"]),
        [JMETRICS.get(m) for m in config["metrics"]], config=config,
        train_loader=config.init_obj("train_loader", JLOADERS),
        valid_loader=config.init_obj("valid_loader", JLOADERS),
        mesh=mesh_from_config(config), seed=0)
    state = jax.device_get(trainer.state)
    init = convert.params_from_flax(state.params)
    init.update(convert.batch_stats_from_flax(state.batch_stats or {}))
    real_epoch = trainer._train_epoch

    def record(epoch):
        log = real_epoch(epoch)
        logs.append(dict(log))
        return log

    trainer._train_epoch = record
    trainer.train()
    state = jax.device_get(trainer.state)
    final = convert.params_from_flax(state.params)
    final.update(convert.batch_stats_from_flax(state.batch_stats or {}))
    return init, final, logs


def _argv(config, save_dir, sets):
    argv = ["-c", str(config), "--device", "cpu", "-s", str(save_dir)]
    for chain, value in sets:
        argv += ["--set", chain, json.dumps(value)]
    return argv


def _port_run(argv, state=None):
    box, logs = {}, []

    def hook(trainer):
        box["trainer"] = trainer
        if state is not None:
            trainer.model.load_state_dict(state)
        real = trainer._train_epoch

        def record(epoch):
            log = real(epoch)
            logs.append(dict(log))
            return log

        trainer._train_epoch = record

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ttrain.main(argv, on_trainer=hook)
    finally:
        torch.set_num_threads(threads)
    return logs, box["trainer"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_trajectory_matches_jax_trainer(name, tmp_path):
    init, final, jlogs = _jax_run(name, tmp_path)
    cfg = REPO / "configs" / f"{name}.json"
    tlogs, trainer = _port_run(
        _argv(cfg, tmp_path / "port", OFF + CONFIGS[name]), init)
    assert len(tlogs) == len(jlogs) >= 1
    for j, t in zip(jlogs, tlogs):
        for key in KEYS:
            np.testing.assert_allclose(t[key], j[key], rtol=1e-4,
                                       err_msg=key)
    got = trainer.model.state_dict()
    assert set(got) == set(final)
    for key, want in final.items():
        atol = 1e-5 if key.endswith(("running_mean", "running_var")) \
            else 1e-4
        np.testing.assert_allclose(got[key].numpy(), want.numpy(),
                                   atol=atol, err_msg=key)


def _small_resnet():
    jm = jres.ResNet(stage_sizes=(1, 1), block_cls=jres.BasicBlock,
                     num_classes=5, num_filters=4, cifar_stem=True,
                     input_shape=(8, 8, 3))
    x = np.random.default_rng(0).normal(size=(6, 8, 8, 3)).astype(
        np.float32)
    v = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    tm = tres.ResNet((1, 1), tres.BasicBlock, num_classes=5, num_filters=4,
                     cifar_stem=True, input_shape=(8, 8, 3))
    state = convert.params_from_flax(v["params"])
    state.update(convert.batch_stats_from_flax(v["batch_stats"]))
    tm.load_state_dict(state)
    return jm, tm, v, x


@pytest.mark.parametrize("lam,shift", [(0.3, 1), (0.9, 4)])
def test_mixed_loss_and_grads_equal_jax(lam, shift, monkeypatch):
    jm, tm, v, x = _small_resnet()
    y = np.array([0, 3, 1, 4, 2, 2], np.int32)
    mask = np.array([1, 1, 1, 1, 1, 0], bool)
    lam32 = np.float32(lam)

    def jloss(params):
        xm = lam32 * jnp.asarray(x) + (1.0 - lam32) * jnp.roll(
            jnp.asarray(x), shift, axis=0)
        out, mut = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, xm,
                            train=True, mutable=["batch_stats"])
        nll = lambda t: -jnp.take_along_axis(  # noqa: E731
            out, t[:, None], axis=1)[:, 0]
        per = lam32 * nll(jnp.asarray(y)) + (1.0 - lam32) * nll(
            jnp.roll(jnp.asarray(y), shift))
        return jnp.sum(per * mask) / mask.sum(), mut["batch_stats"]

    (want, new_stats), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        v["params"])
    monkeypatch.setattr(steps, "draw_mixup",
                        lambda seed, alpha, b: (lam32, shift))
    opt = optim.OPTIMIZERS.get("SGD")(tm, lr=0.0)
    step = steps.make_train_step(tm, opt, losses.nll_loss,
                                 mixup_alpha=0.2)
    m = step({"image": torch.from_numpy(x), "label": torch.from_numpy(y),
              "mask": torch.from_numpy(mask)})
    np.testing.assert_allclose(float(m["loss_sum"]) / float(m["count"]),
                               float(want), rtol=1e-5)
    ref = convert.params_from_flax(jax.device_get(jgrads))
    for name, p in tm.named_parameters():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r,
                                   atol=1e-5 * np.abs(r).max() + 1e-7,
                                   err_msg=name)
    stats = convert.batch_stats_from_flax(jax.device_get(new_stats))
    for name, t in stats.items():
        np.testing.assert_allclose(tm.state_dict()[name].numpy(),
                                   t.numpy(), atol=1e-6, err_msg=name)


def test_skip_nonfinite_keeps_bn_buffers_bit_identical():
    _, tm, _, x = _small_resnet()
    batch = {"image": torch.from_numpy(x),
             "label": torch.arange(6, dtype=torch.int32) % 5,
             "mask": torch.ones(6, dtype=torch.bool)}
    opt = optim.OPTIMIZERS.get("SGD")(tm, lr=0.1, momentum=0.9)
    step = steps.make_train_step(tm, opt, losses.nll_loss,
                                 skip_nonfinite=True,
                                 inject_nan_grad_step=1, health=True)
    step(batch)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    moments = [s["momentum_buffer"].clone() for s in opt.state.values()]
    m = step(batch)
    assert float(m["skipped_sum"]) == 6.0
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    for a, s in zip(moments, opt.state.values()):
        assert torch.equal(a, s["momentum_buffer"])
    step(batch)
    assert not torch.equal(tm.BasicBlock_0.BatchNorm_0.running_mean,
                           before["BasicBlock_0.BatchNorm_0.running_mean"])


CIFAR = REPO / "configs" / "cifar10_resnet18.json"
CIFAR_SETS = [("train_loader;args;synthetic_n", 32),
              ("valid_loader;args;synthetic_n", 16),
              ("train_loader;args;batch_size", 8),
              ("valid_loader;args;batch_size", 8),
              ("trainer;tensorboard", False), ("trainer;epochs", 2),
              ("trainer;save_period", 1), ("trainer;mixup_alpha", 0.4),
              ("trainer;augment", {"flip": True, "crop_padding": 4,
                                   "cutout": 8})]


@pytest.fixture(scope="module")
def cifar_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cifar")
    sets = CIFAR_SETS + [("trainer;save_interval_steps", 2)]
    logs, trainer = _port_run(_argv(CIFAR, tmp / "a", sets))
    return tmp, logs, trainer


def _bn_state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def test_checkpoints_carry_bn_buffers_and_resume_exactly(cifar_run):
    tmp, logs, trainer = cifar_run
    final = _bn_state(trainer.model)
    run = trainer.config.save_dir
    saved = torch.load(run / "checkpoint-epoch2" / "model.pt")
    assert "bn_init.running_mean" in saved
    for k, v in final.items():
        assert torch.equal(saved[k], v), k
    # the epoch edge, then epoch 2's first interval slot (batch 2 of 4)
    slot = json.loads((run / "checkpoint-interval-a.data_state.json")
                      .read_text())
    assert (slot["epoch"], slot["next_batch"]) == (2, 2)
    for ckpt, n_logs in (("checkpoint-epoch1", 1),
                         ("checkpoint-interval-a", 1)):
        time.sleep(1.1)     # a run id per second
        rlogs, resumed = _port_run(
            ["-r", str(run / ckpt), "--device", "cpu", "-s",
             str(tmp / ckpt)])
        assert len(rlogs) == n_logs
        got = resumed.model.state_dict()
        for k, v in final.items():
            assert torch.equal(got[k], v), (ckpt, k)
        if ckpt.endswith("epoch1"):
            for key in KEYS:
                assert rlogs[0][key] == logs[1][key], key


def test_test_py_equals_best_validation(cifar_run, tmp_path):
    _, logs, trainer = cifar_run
    got = ttest.main(["-r", str(trainer.config.save_dir / "model_best"),
                      "--device", "cpu", "-s", str(tmp_path),
                      "--save-outputs", str(tmp_path / "dump")])
    # monitor "max val_accuracy": the last epoch at the best value
    best = [log for log in logs
            if log["val_accuracy"] == max(x["val_accuracy"]
                                          for x in logs)][-1]
    np.testing.assert_allclose(got["loss"], best["val_loss"], rtol=1e-6)
    assert np.load(tmp_path / "dump" / "outputs_p0.npy").shape == (16, 10)


def test_init_from_leaves_buffers_and_emergency_save_holds_them(
        cifar_run, tmp_path):
    _, _, trainer = cifar_run
    src = trainer.config.save_dir / "checkpoint-epoch1"
    sets = CIFAR_SETS[:5] + [("trainer;epochs", 1),
                             ("trainer;init_from", str(src)),
                             ("trainer;faults", "crash@step:1")]
    box = {}
    with pytest.raises(Exception):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            ttrain.main(_argv(CIFAR, tmp_path, sets),
                        on_trainer=lambda t: box.update(
                            t=t, first=_bn_state(t.model)))
        finally:
            torch.set_num_threads(threads)
    disk = torch.load(src / "model.pt")
    first = box["first"]
    for k, v in first.items():
        if k.endswith("running_mean"):
            assert torch.equal(v, torch.zeros_like(v)), k
        elif k.endswith("running_var"):
            assert torch.equal(v, torch.ones_like(v)), k
        else:
            assert torch.equal(v, disk[k]), k
    emergency = box["t"].config.save_dir / "checkpoint-emergency"
    saved = torch.load(emergency / "model.pt")
    live = box["t"].model.state_dict()
    assert "BasicBlock_0.BatchNorm_0.running_var" in saved
    for k, v in live.items():
        assert torch.equal(saved[k], v), k


@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_global_roll_index_arithmetic(count, monkeypatch):
    """Each shard's rows of ``roll(global, shift)``, with the ppermute
    replaced by a lookup of the partner shard's rows in this process."""
    b = 3
    glob = torch.arange(b * count * 2).view(b * count, 2)
    shards = [glob[i::count] for i in range(count)]
    for shift in range(1, b * count):
        want = torch.roll(glob, shift, 0)
        for index in range(count):
            monkeypatch.setattr(
                steps, "ppermute",
                lambda x, group, hop, index=index:
                    shards[(index - hop) % count])
            got = steps.global_roll(shards[index], shift, (index, count))
            assert torch.equal(got, want[index::count]), (shift, index)


CHILD = r"""
import json, sys
import torch
torch.set_num_threads(1)
from pytorch_distributed_template_tpu_torch import train
from pytorch_distributed_template_tpu_torch.parallel import dist
from pytorch_distributed_template_tpu_torch.parallel import collectives

argv, out = json.loads(sys.argv[1]), sys.argv[2]
logs, box = [], {}


def hook(trainer):
    box["t"] = trainer
    real = trainer._train_epoch

    def record(epoch):
        log = real(epoch)
        logs.append(dict(log))
        return log

    trainer._train_epoch = record


try:
    train.main(argv, on_trainer=hook)
    rank = dist.process_index()
    if rank == 0:
        torch.save(box["t"].model.state_dict(), out + ".pt")
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump({"logs": logs, "world": dist.process_count(),
                   "ppermute": collectives.P2P["ppermute"]}, f)
finally:
    dist.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_equal_one_process(tmp_path):
    sets = CIFAR_SETS + [("trainer;epochs", 1)]
    one_logs, one = _port_run(_argv(CIFAR, tmp_path / "one", sets))
    argv = _argv(CIFAR, tmp_path / "two", [
        (k, 4 if k.endswith("batch_size") else v) for k, v in sets])
    port, world, out = _free_port(), 2, tmp_path / "rank"
    procs = []
    for rank in range(world):
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD, json.dumps(argv), str(out)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, text in zip(procs, texts):
        assert p.returncode == 0, text[-3000:]
    ranks = [json.loads(Path(f"{out}.rank{r}.json").read_text())
             for r in range(world)]
    shifts = [steps.draw_mixup(steps.fold_in(0, s), 0.4, 8)[1]
              for s in range(4)]
    for r in ranks:
        assert r["world"] == 2
        assert r["ppermute"] == 2 * sum(s % 2 for s in shifts) > 0
        for got, want in zip(r["logs"], one_logs):
            for key in KEYS:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                           err_msg=key)
    two = torch.load(f"{out}.pt")
    for k, v in one.model.state_dict().items():
        np.testing.assert_allclose(two[k].numpy(), v.numpy(), atol=1e-5,
                                   err_msg=k)
