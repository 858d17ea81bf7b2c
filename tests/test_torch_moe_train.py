"""Slice 4 end to end on the CPU: the port's ``train.py`` on
``configs/moelm_stdlib.json`` cut to a tiny size, against the JAX
package's ``Trainer`` on the same config and the same text file.

The config keeps every key of ``configs/moelm_stdlib.json``; only values
change: widths, depth, sequence, batch, epochs and ``save_period``
(sizes), ``data_dir`` (a corpus of 8 kB made by the port's
``tools/make_text_corpus.py``), and ``bfloat16: false`` and ``dropout:
0`` (the two frameworks round bf16 and draw dropout masks differently;
float32 without dropout is the comparable setting). The last train and
eval batches are padded, so ``example_mask`` reaches the MoE blocks; the
capacity factor of 1.25 drops tokens.

The JAX trainer initialises its params from seed 0; the port's run gets
the same params (``params_from_flax``) through ``train.main``'s
``on_trainer`` hook. Epoch logs must agree: ``loss`` (the aux loss
included), ``val_loss`` and ``val_lm_bits_per_byte`` rtol 1e-4 over the
run's AdamW steps; the token accuracies atol 2e-3 (an argmax near a tie
may flip a few tokens). A run resumed from ``checkpoint-epoch2``
reproduces epoch 3.
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
from pytorch_distributed_template_tpu_torch.tools import make_text_corpus

REPO = Path(__file__).resolve().parent.parent
ARCH = dict(n_layer=2, n_head=2, d_model=32, d_ff=64, max_len=32,
            num_experts=4, bfloat16=False, dropout=0.0)
KEYS = ("loss", "val_loss", "val_lm_bits_per_byte", "lm_bits_per_byte",
        "lm_token_accuracy", "val_lm_token_accuracy")


def _config(tmp: Path) -> dict:
    cfg = json.loads((REPO / "configs" / "moelm_stdlib.json").read_text())
    cfg["arch"]["args"].update(ARCH)
    for split in ("train_loader", "valid_loader"):
        cfg[split]["args"].update(data_dir=str(tmp / "data"), batch_size=8,
                                  seq_len=32)
    cfg["trainer"].update(epochs=3, save_period=1,
                          save_dir=str(tmp / "jax"))
    return cfg


def _jax_run(cfg):
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moelm")
    make_text_corpus.build(tmp / "data" / "pystdlib.txt", 8000)
    cfg = _config(tmp)
    params, jlogs = _jax_run(cfg)
    cfg_path = tmp / "moelm_tiny.json"
    cfg_path.write_text(json.dumps(cfg))
    tlogs, trainer = _port_run(["-c", str(cfg_path), "--device", "cpu",
                                "-s", str(tmp / "port")], params)
    return tmp, jlogs, tlogs, trainer


def test_config_keeps_every_key_of_moelm_stdlib(tmp_path):
    base = json.loads((REPO / "configs" / "moelm_stdlib.json").read_text())
    cut = _config(tmp_path)

    def keys(d, prefix=""):
        out = set()
        for k, v in d.items():
            out.add(prefix + k)
            if isinstance(v, dict):
                out |= keys(v, prefix + k + ".")
        return out

    assert keys(cut) == keys(base)


def test_epoch_logs_match_jax_trainer(runs):
    _, jlogs, tlogs, trainer = runs
    assert type(trainer.model).__name__ == "TransformerLM"
    assert trainer.model.moe_experts == 4
    assert len(jlogs) == len(tlogs) == 3
    for e, (j, t) in enumerate(zip(jlogs, tlogs), start=1):
        for key in KEYS:
            if "accuracy" in key:
                np.testing.assert_allclose(t[key], j[key], atol=2e-3,
                                           err_msg=f"epoch {e} {key}")
            else:
                np.testing.assert_allclose(t[key], j[key], rtol=1e-4,
                                           err_msg=f"epoch {e} {key}")
    assert tlogs[-1]["loss"] < tlogs[0]["loss"]
    # the logged train loss carries the aux term: above the plain CE
    assert all(t["loss"] > t["lm_bits_per_byte"] * np.log(2) for t in tlogs)


def test_checkpoints_summary_and_monitor(runs):
    _, _, tlogs, trainer = runs
    run_dir = trainer.config.save_dir
    for n in (1, 2, 3):
        assert (run_dir / f"checkpoint-epoch{n}" / "model.pt").is_file()
    summary = json.loads((run_dir / "summary.json").read_text())
    assert summary["monitor"] == "min val_lm_bits_per_byte"
    assert summary["monitor_best"] == pytest.approx(
        min(log["val_lm_bits_per_byte"] for log in tlogs))


def test_resume_equals_the_uninterrupted_run(runs):
    tmp, _, tlogs, trainer = runs
    ckpt = trainer.config.save_dir / "checkpoint-epoch2"
    logs, resumed = _port_run(["-r", str(ckpt), "--device", "cpu", "-s",
                               str(tmp / "resumed")])
    assert resumed.start_epoch == 3 and len(logs) == 1
    for key in KEYS:
        np.testing.assert_allclose(logs[0][key], tlogs[2][key], rtol=1e-6,
                                   atol=1e-7, err_msg=key)
