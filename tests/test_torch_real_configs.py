"""Slice 8's repository configs through the port's ``train.py`` on the CPU against the JAX package's
``Trainer`` (the same params through ``train.main``'s ``on_trainer``
hook, the same data, dropout off on both sides, float32).

- ``configs/digits.json`` as it is but for ``--set trainer;epochs 2``
  (LeNet, Adam with amsgrad, StepLR, the real digits): epoch logs rtol
  1e-4 (the accuracies within one image of 359 / 1,438).
- ``configs/bytelm_stdlib.json`` and ``configs/bpelm_stdlib.json`` at a
  tiny width (2 layers, d_model 32, 2 heads, sequences of 32, batches of
  8, bf16 and dropout off, BPE vocab 300) over a 12 kB corpus made by the
  port's ``tools/make_text_corpus.py``, 2 epochs: losses and the byte /
  nat metrics rtol 1e-4, token accuracies atol 2e-3; the BPE run pins its
  tokenizer in the run directory and logs ``val_lm_nll`` equal to
  ``val_loss`` (rtol 1e-5: both the mean next-token NLL).
The four trainer keys of fault C1 are in tests/test_torch_trainer_keys.py.
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
from pytorch_distributed_template_tpu.engine.losses import (
    resolve_loss as jresolve_loss,
)
from pytorch_distributed_template_tpu.parallel import mesh_from_config

from pytorch_distributed_template_tpu_torch import train as ttrain
from pytorch_distributed_template_tpu_torch.data import native
from pytorch_distributed_template_tpu_torch.models.layers import Dropout
from pytorch_distributed_template_tpu_torch.models.convert import (
    params_from_flax,
)
from pytorch_distributed_template_tpu_torch.tools import make_text_corpus

from test_torch_accum_ema import _process_signal_handlers  # noqa: F401
from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TINY_LM = {"arch;args;n_layer": 2, "arch;args;d_model": 32,
           "arch;args;n_head": 2, "arch;args;max_len": 32,
           "arch;args;bfloat16": False, "arch;args;dropout": 0.0,
           "train_loader;args;seq_len": 32, "valid_loader;args;seq_len": 32,
           "train_loader;args;batch_size": 8,
           "valid_loader;args;batch_size": 8,
           "trainer;epochs": 2, "trainer;save_period": 1}


class _NoDropout(fnn.Dropout):
    def __call__(self, inputs, deterministic=None, rng=None):
        return inputs


def _cut(name: str, sets: dict) -> dict:
    cfg = json.loads((REPO / "configs" / name).read_text())
    for chain, value in sets.items():
        node = cfg
        *head, last = chain.split(";")
        for k in head:
            node = node[k]
        node[last] = value
    return cfg


def _jax_run(cfg, tmp: Path, box=None):
    """The JAX ``Trainer`` on ``cfg`` (flax's Dropout an identity): the
    initial params as a port state dict, the epoch logs; ``box["trainer"]``
    the trainer, when a ``box`` is given."""
    cfg = json.loads(json.dumps(cfg))
    cfg["trainer"]["save_dir"] = str(tmp / "jax")
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
        if box is not None:
            box["trainer"] = trainer
        params = params_from_flax(jax.device_get(trainer.state.params))
        real = trainer._train_epoch

        def record(epoch):
            log = real(epoch)
            logs.append(dict(log))
            return log

        trainer._train_epoch = record
        trainer.train()
    return params, logs


def _port_run(cfg, tmp: Path, params=None, extra=()):
    """The port's ``train.main`` on ``cfg`` (written to a file), dropout
    modules at p = 0; returns (epoch logs, trainer)."""
    tmp.mkdir(parents=True, exist_ok=True)
    path = tmp / "port_config.json"
    path.write_text(json.dumps(cfg))
    box, logs = {}, []

    def hook(trainer):
        box["trainer"] = trainer
        for mod in trainer.model.modules():
            if isinstance(mod, Dropout):
                mod.p = 0.0
        if params is not None:
            trainer.model.load_state_dict(params)
        real = trainer._train_epoch

        def record(epoch):
            log = real(epoch)
            logs.append(dict(log))
            return log

        trainer._train_epoch = record

    ttrain.main(["-c", str(path), "--device", "cpu", "-s", str(tmp / "port"),
                 *extra], on_trainer=hook)
    return logs, box["trainer"]


def _close(tlogs, jlogs, keys, acc_atol):
    assert len(tlogs) == len(jlogs)
    for e, (t, j) in enumerate(zip(tlogs, jlogs), start=1):
        for key in keys:
            if "accuracy" in key or "top_k" in key:
                np.testing.assert_allclose(t[key], j[key], atol=acc_atol,
                                           err_msg=f"epoch {e} {key}")
            else:
                np.testing.assert_allclose(t[key], j[key], rtol=1e-4,
                                           err_msg=f"epoch {e} {key}")


def test_digits_config_matches_jax_trainer(tmp_path):
    cfg = _cut("digits.json", {"trainer;epochs": 2})
    params, jlogs = _jax_run(cfg, tmp_path)
    before = native.CALLS.calls
    tlogs, trainer = _port_run(cfg, tmp_path, params)
    assert native.CALLS.calls > before          # the native gather ran
    assert trainer.train_loader.n_samples == 1438
    assert trainer.valid_loader.n_samples == 359
    _close(tlogs, jlogs, ("loss", "accuracy", "top_k_acc", "val_loss",
                          "val_accuracy", "val_top_k_acc"),
           acc_atol=1 / 359 + 1e-9)
    assert tlogs[-1]["val_accuracy"] > 0.5


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("lmdata")
    make_text_corpus.build(d / "pystdlib.txt", 12000)
    return d


def _lm_cut(name, corpus_dir, **sets):
    base = dict(TINY_LM, **{"train_loader;args;data_dir": str(corpus_dir),
                            "valid_loader;args;data_dir": str(corpus_dir)})
    return _cut(name, dict(base, **sets))


def test_bytelm_config_matches_jax_trainer(tmp_path, corpus_dir):
    cfg = _lm_cut("bytelm_stdlib.json", corpus_dir)
    params, jlogs = _jax_run(cfg, tmp_path)
    tlogs, _ = _port_run(cfg, tmp_path, params)
    _close(tlogs, jlogs, ("loss", "lm_bits_per_byte", "val_loss",
                          "val_lm_bits_per_byte", "lm_token_accuracy",
                          "val_lm_token_accuracy"), acc_atol=2e-3)


def test_bpelm_config_matches_jax_trainer(tmp_path, corpus_dir):
    cfg = _lm_cut("bpelm_stdlib.json", corpus_dir,
                  **{"arch;args;vocab_size": 300,
                     "train_loader;args;vocab_size": 300,
                     "valid_loader;args;vocab_size": 300})
    params, jlogs = _jax_run(cfg, tmp_path)     # builds the caches
    tlogs, trainer = _port_run(cfg, tmp_path, params)
    _close(tlogs, jlogs, ("loss", "lm_nll", "val_loss", "val_lm_nll",
                          "lm_token_accuracy", "val_lm_token_accuracy"),
           acc_atol=2e-3)
    for log in tlogs:
        np.testing.assert_allclose(log["val_lm_nll"], log["val_loss"],
                                   rtol=1e-5)
    pinned = trainer.config.save_dir / "tokenizer.json"
    assert pinned.read_bytes() == trainer.train_loader.tokenizer_path \
        .read_bytes()
