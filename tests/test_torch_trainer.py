"""The port's ``train.py`` on ``configs/lm_debug.json`` (TinyLM) and
``configs/llama_debug.json`` (TinyLlama, GQA) on the CPU, against the JAX
package's ``Trainer`` on the same config.

The JAX trainer initialises its params from seed 0; the port's run gets
the same params (``params_from_flax``) through ``train.main``'s
``on_trainer`` hook before its first epoch. The data is byte-identical
(tests/test_torch_lm_train.py), so the two runs see the same batches in
the same order. Epoch logs must agree within float32 tolerance: ``loss``
and ``val_loss`` rtol 1e-4 over 24 AdamW steps; the token accuracies atol
2e-3 (an argmax near a tie may flip a few of the 7,936 / 1,984 counted
tokens). Then: the checkpoint files and ``summary.json`` are written, and
a run resumed from ``checkpoint-epoch2`` reproduces epoch 3 of the
uninterrupted run.
"""
import json
from pathlib import Path

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
from pytorch_distributed_template_tpu.engine.losses import (
    resolve_loss as jresolve_loss,
)
from pytorch_distributed_template_tpu.parallel import mesh_from_config

from pytorch_distributed_template_tpu_torch import train as ttrain
from pytorch_distributed_template_tpu_torch.models.convert import (
    params_from_flax,
)

REPO = Path(__file__).resolve().parent.parent
CONFIGS = ["lm_debug.json", "llama_debug.json"]
KEYS = ("loss", "val_loss", "lm_token_accuracy", "val_lm_token_accuracy")


def _jax_run(name, tmp_path):
    cfg = json.loads((REPO / "configs" / name).read_text())
    cfg["trainer"]["save_dir"] = str(tmp_path / "jax")
    config = JConfigParser(cfg, run_id="jax", training=True)
    trainer = JTrainer(
        config.init_obj("arch", JMODELS), jresolve_loss(config["loss"]),
        [JMETRICS.get(m) for m in config["metrics"]], config=config,
        train_loader=config.init_obj("train_loader", JLOADERS),
        valid_loader=config.init_obj("valid_loader", JLOADERS),
        mesh=mesh_from_config(config), seed=0)
    params = params_from_flax(jax.device_get(trainer.state.params))
    logs = []
    real_epoch = trainer._train_epoch

    def record(epoch):
        log = real_epoch(epoch)
        logs.append(dict(log))
        return log

    trainer._train_epoch = record
    trainer.train()
    return params, logs


def _port_run(argv, params=None):
    """``train.main`` with the epoch logs recorded; returns (logs,
    trainer)."""
    box, logs = {}, []

    def hook(trainer):
        box["trainer"] = trainer
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


@pytest.fixture(scope="module", params=CONFIGS)
def runs(request, tmp_path_factory):
    name = request.param
    tmp = tmp_path_factory.mktemp(name.split(".")[0])
    params, jlogs = _jax_run(name, tmp)
    argv = ["-c", str(REPO / "configs" / name), "--device", "cpu", "-s",
            str(tmp / "port")]
    tlogs, trainer = _port_run(argv, params)
    return name, tmp, params, jlogs, tlogs, trainer


def test_epoch_logs_match_jax_trainer(runs):
    name, _, _, jlogs, tlogs, _ = runs
    assert len(jlogs) == len(tlogs) == 3
    for e, (j, t) in enumerate(zip(jlogs, tlogs), start=1):
        for key in KEYS:
            if "accuracy" in key:
                np.testing.assert_allclose(t[key], j[key], atol=2e-3,
                                           err_msg=f"{name} epoch {e} {key}")
            else:
                np.testing.assert_allclose(t[key], j[key], rtol=1e-4,
                                           err_msg=f"{name} epoch {e} {key}")
    assert tlogs[-1]["loss"] < tlogs[0]["loss"]


def test_checkpoints_and_summary_are_written(runs):
    _, _, _, _, tlogs, trainer = runs
    run_dir = trainer.config.save_dir
    for n in (1, 2, 3):
        ckpt = run_dir / f"checkpoint-epoch{n}"
        for f in ("model.pt", "optimizer.pt", "train_state.json"):
            assert (ckpt / f).is_file(), ckpt / f
        meta = json.loads((run_dir / f"checkpoint-epoch{n}.meta.json")
                          .read_text())
        assert meta["epoch"] == n and meta["config"]["name"]
    assert (run_dir / "model_best" / "model.pt").is_file()
    assert (run_dir / "model_best.meta.json").is_file()
    summary = json.loads((run_dir / "summary.json").read_text())
    assert summary["epoch"] == 3 and summary["monitor"] == "min val_loss"
    assert summary["monitor_best"] == pytest.approx(
        min(log["val_loss"] for log in tlogs))
    state = json.loads((run_dir / "checkpoint-epoch2" / "train_state.json")
                       .read_text())
    assert state == {"step": 16, "applied": 16}


def test_resume_equals_the_uninterrupted_run(runs):
    _, tmp, _, _, tlogs, trainer = runs
    ckpt = trainer.config.save_dir / "checkpoint-epoch2"
    logs, resumed = _port_run(["-r", str(ckpt), "--device", "cpu", "-s",
                               str(tmp / "resumed")])
    assert resumed.start_epoch == 3 and len(logs) == 1
    for key in KEYS:
        np.testing.assert_allclose(logs[0][key], tlogs[2][key], rtol=1e-6,
                                   atol=1e-7, err_msg=key)
    assert resumed.train_step.state_dict() == {"step": 24, "applied": 24}


def test_cli_defaults_to_cuda_and_refuses_later_slices(tmp_path):
    import torch

    cfg = str(REPO / "configs" / "lm_debug.json")
    base = ["-c", cfg, "-s", str(tmp_path)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.main(base)
    with pytest.raises(NotImplementedError, match="slice 4"):
        ttrain.main(base + ["--device", "cpu", "--auto-resume"])
    for chain, value in (("trainer;tensorboard", "true"),
                         ("trainer;grad_accum_steps", "2"),
                         ("trainer;ema_decay", "0.99"),
                         ("mesh;axes", '{"data": 2, "tensor": 2}')):
        with pytest.raises(NotImplementedError, match="slice"):
            ttrain.main(base + ["--device", "cpu", "--set", chain, value])
