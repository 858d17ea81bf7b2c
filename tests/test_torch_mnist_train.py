"""Slice 5's gate on the CPU: ``configs/mnist_debug.json`` (LeNet, Adam
with amsgrad, StepLR, synthetic MNIST) through the port's ``train.py
--device cpu`` against the JAX package's ``Trainer``, with dropout off on
both sides (flax's ``nn.Dropout`` replaced by an identity for the JAX run
inside this process, the port's ``Dropout`` modules set to ``p = 0``).

The port starts from the JAX run's initial params (``params_from_flax``)
through ``train.main``'s ``on_trainer`` hook; the data is byte-identical
(tests/test_torch_mnist_data.py). Tolerances, float32 on both sides:
epoch logs (``loss``, ``accuracy``, ``top_k_acc`` and their ``val_``
forms) rtol 1e-4, final params atol 1e-4. A run resumed from
``checkpoint-epoch1`` reproduces epoch 2 (rtol 1e-6); the port's
``test.py`` on ``model_best`` equals the JAX ``evaluate`` on its own
``model_best`` (loss rtol 1e-4; the accuracies within one example of the
256). ``trainer.len_epoch`` (iteration-based epochs over an endless,
reshuffling loader) matches the JAX trainer's logs the same way.
"""
import json
from pathlib import Path

import flax.linen as fnn
import jax
import numpy as np
import pytest

from pytorch_distributed_template_tpu.config import (
    ConfigParser as JConfigParser, LOADERS as JLOADERS,
    METRICS as JMETRICS, MODELS as JMODELS,
)
import pytorch_distributed_template_tpu.data  # noqa: F401  (register)
import pytorch_distributed_template_tpu.engine  # noqa: F401
import pytorch_distributed_template_tpu.models  # noqa: F401
from pytorch_distributed_template_tpu.engine import Trainer as JTrainer
from pytorch_distributed_template_tpu.engine.evaluator import (
    evaluate as jevaluate,
)
from pytorch_distributed_template_tpu.engine.losses import (
    resolve_loss as jresolve_loss,
)
from pytorch_distributed_template_tpu.parallel import mesh_from_config

from pytorch_distributed_template_tpu_torch import test as ttest
from pytorch_distributed_template_tpu_torch import train as ttrain
from pytorch_distributed_template_tpu_torch.models.convert import (
    params_from_flax,
)

REPO = Path(__file__).resolve().parent.parent
CONFIG = REPO / "configs" / "mnist_debug.json"
KEYS = ("loss", "accuracy", "top_k_acc", "val_loss", "val_accuracy",
        "val_top_k_acc")


class _NoDropout(fnn.Dropout):
    def __call__(self, inputs, deterministic=None, rng=None):
        return inputs


def _jax_run(tmp, sets=()):
    cfg = json.loads(CONFIG.read_text())
    cfg["trainer"]["save_dir"] = str(tmp / "jax")
    for chain, value in sets:
        node = cfg
        *head, last = chain.split(";")
        for k in head:
            node = node[k]
        node[last] = value
    config = JConfigParser(cfg, run_id="jax", training=True)
    logs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn, "Dropout", _NoDropout)
        trainer = JTrainer(
            config.init_obj("arch", JMODELS), jresolve_loss(config["loss"]),
            [JMETRICS.get(m) for m in config["metrics"]], config=config,
            train_loader=config.init_obj("train_loader", JLOADERS),
            valid_loader=config.init_obj("valid_loader", JLOADERS),
            mesh=mesh_from_config(config), seed=0)
        init = params_from_flax(jax.device_get(trainer.state.params))
        real_epoch = trainer._train_epoch

        def record(epoch):
            log = real_epoch(epoch)
            logs.append(dict(log))
            return log

        trainer._train_epoch = record
        trainer.train()
    final = params_from_flax(jax.device_get(trainer.state.params))
    return init, final, logs, config


def _port_run(argv, params=None):
    """``train.main`` with dropout off and the epoch logs recorded;
    returns (logs, trainer)."""
    box, logs = {}, []

    def hook(trainer):
        box["trainer"] = trainer
        for mod in (trainer.model.Dropout_0, trainer.model.Dropout_1):
            mod.p = 0.0
        if params is not None:
            trainer.model.load_state_dict(params)
        real_epoch = trainer._train_epoch

        def record(epoch):
            log = real_epoch(epoch)
            logs.append(dict(log))
            return log

        trainer._train_epoch = record

    ttrain.main(argv, on_trainer=hook)
    return logs, box["trainer"]


def _close(got, want, keys=KEYS, rtol=1e-4):
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   err_msg=key)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mnist")
    init, final, jlogs, jconfig = _jax_run(tmp)
    tlogs, trainer = _port_run(["-c", str(CONFIG), "--device", "cpu", "-s",
                                str(tmp / "port")], init)
    return tmp, final, jlogs, jconfig, tlogs, trainer


def test_epoch_logs_and_params_match_jax_trainer(runs):
    _, final, jlogs, _, tlogs, trainer = runs
    assert len(jlogs) == len(tlogs) == 2
    for j, t in zip(jlogs, tlogs):
        _close(t, j)
    assert tlogs[-1]["loss"] < tlogs[0]["loss"]
    got = trainer.model.state_dict()
    for name, want in final.items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                   atol=1e-4, err_msg=name)


def test_resume_reproduces_epoch_2(runs):
    tmp, _, _, _, tlogs, trainer = runs
    ckpt = trainer.config.save_dir / "checkpoint-epoch1"
    logs, resumed = _port_run(["-r", str(ckpt), "--device", "cpu", "-s",
                               str(tmp / "resumed")])
    assert resumed.start_epoch == 2 and len(logs) == 1
    _close(logs[0], tlogs[1], rtol=1e-6)
    assert resumed.train_step.state_dict() == {"step": 16, "applied": 16}


def test_port_test_py_equals_jax_evaluate(runs, tmp_path):
    tmp, _, _, jconfig, tlogs, trainer = runs
    cfg = json.loads(CONFIG.read_text())
    cfg["trainer"]["save_dir"] = str(tmp / "jax_eval")
    jbest = jconfig.save_dir / "model_best"
    want = jevaluate(JConfigParser(cfg, resume=jbest, run_id="e",
                                   training=False))
    got = ttest.main(["-r", str(trainer.config.save_dir / "model_best"),
                      "--device", "cpu", "-s", str(tmp_path),
                      "--save-outputs", str(tmp_path / "dump")])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    for key in ("accuracy", "top_k_acc"):
        assert abs(got[key] - want[key]) <= 1 / 256 + 1e-9, key
    # model_best is the epoch with the lowest val_loss; the test set is
    # the validation set
    best = min(tlogs, key=lambda log: log["val_loss"])
    np.testing.assert_allclose(got["loss"], best["val_loss"], rtol=1e-6)
    outs = np.load(tmp_path / "dump" / "outputs_p0.npy")
    tgts = np.load(tmp_path / "dump" / "targets_p0.npy")
    assert outs.shape == (256, 10) and tgts.shape == (256,)
    np.testing.assert_allclose((outs.argmax(1) == tgts).mean(),
                               got["accuracy"], atol=1e-7)


def test_iteration_mode_matches_jax_trainer(tmp_path):
    """``trainer.len_epoch`` 3 over 2 epochs: 6 steps through the endless
    loader (the 8-batch pass is not finished), no validation."""
    sets = [("trainer;len_epoch", 3), ("trainer;epochs", 2),
            ("trainer;save_period", 10)]
    init, final, jlogs, _ = _jax_run(tmp_path, sets)
    argv = ["-c", str(CONFIG), "--device", "cpu", "-s", str(tmp_path / "p"),
            "--no-validate"]
    for chain, value in sets:
        argv += ["--set", chain, json.dumps(value)]
    tlogs, trainer = _port_run(argv, init)
    assert trainer.len_epoch == 3 and len(tlogs) == 2
    for j, t in zip(jlogs, tlogs):
        _close(t, j, keys=("loss", "accuracy", "top_k_acc"))
    got = trainer.model.state_dict()
    for name, want in final.items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                   atol=1e-4, err_msg=name)
