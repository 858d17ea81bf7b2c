"""``optimizer.args.trainable`` and ``ReduceLROnPlateau`` in the port
against the JAX package, on the CPU.

- ``trainable`` (regexes over the JAX paths): the TinyLM of
  tests/test_torch_lm_train.py, AdamW + clip 0.05 + ``log_grad_norm``, 3
  steps against ``make_train_step`` with the same patterns and the JAX
  ``build_optimizer``'s ``_trainable_only``: the logged norm is the
  trainable leaves' (rtol 1e-5), the trainable params match (rtol 1e-5,
  atol 1e-5), the frozen ones are bitwise unchanged and hold no optimizer
  state.
- ``PlateauController`` against the JAX one over fixed metric sequences
  (the same scale after every epoch, exactly), and ``build_optimizer``'s
  ``min_lr`` / ``eps`` in scale units.
- ``configs/mnist_debug.json`` for 3 epochs with ``--set lr_scheduler``
  ``ReduceLROnPlateau`` (patience 0, threshold 0.5: the scale halves
  after epochs 2 and 3) through the port's ``train.py`` against the JAX
  ``Trainer`` (tests/test_torch_mnist_train.py's harness, dropout off):
  epoch logs rtol 1e-4, params atol 1e-4; the resume from
  ``checkpoint-epoch2`` restores the scale and reproduces epoch 3 (rtol
  1e-6).
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_distributed_template_tpu.models  # noqa: F401  (register)
from pytorch_distributed_template_tpu.config.registry import MODELS as JM
from pytorch_distributed_template_tpu.engine import losses as jlosses
from pytorch_distributed_template_tpu.engine import optim as joptim
from pytorch_distributed_template_tpu.engine import state as jstate
from pytorch_distributed_template_tpu.engine import steps as jsteps

import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TM,
)
from pytorch_distributed_template_tpu_torch.engine import losses as tlosses
from pytorch_distributed_template_tpu_torch.engine import optim as toptim
from pytorch_distributed_template_tpu_torch.engine import steps as tsteps
from pytorch_distributed_template_tpu_torch.models.convert import (
    flax_path, params_from_flax,
)

from test_torch_accum_ema import _process_signal_handlers  # noqa: F401
from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401
from test_torch_lm_train import MODEL, STEP_CFG
from test_torch_mnist_train import CONFIG as MNIST_DEBUG
from test_torch_mnist_train import _close, _jax_run, _port_run

TRAINABLE = ["h_1/", "ln_f"]


def test_trainable_matches_make_train_step():
    cfg = json.loads(json.dumps(STEP_CFG))
    cfg["optimizer"]["args"]["trainable"] = TRAINABLE
    kw = dict(input_key="tokens", target_key="tokens", grad_clip_norm=0.05,
              log_grad_norm=True, trainable_patterns=TRAINABLE)
    jmodel = JM.get("TinyLM")(**MODEL)
    tx, _, _ = joptim.build_optimizer(cfg, steps_per_epoch=2)
    state = jstate.create_train_state(jmodel, tx,
                                      jnp.zeros((1, 16), jnp.int32))
    before = params_from_flax(jax.device_get(state.params))
    tmodel = TM.get("TinyLM")(**MODEL, device="cpu")
    tmodel.load_state_dict(before)
    opt, lr_fn, _ = toptim.build_optimizer(cfg, 2, tmodel)
    jstep = jax.jit(jsteps.make_train_step(jmodel, tx,
                                           jlosses.lm_cross_entropy, **kw))
    tstep = tsteps.make_train_step(tmodel, opt, tlosses.lm_cross_entropy,
                                   lr_fn=lr_fn, **kw)
    rng = np.random.default_rng(3)
    for _ in range(3):
        batch = {"tokens": rng.integers(0, 64, (8, 16)).astype(np.int32),
                 "mask": np.ones(8, bool)}
        state, jm = jstep(state, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
        tm = tstep({k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["grad_norm_sum"]),
                                   float(jm["grad_norm_sum"]), rtol=1e-5)
    want = params_from_flax(jax.device_get(state.params))
    frozen = 0
    for name, p in tmodel.named_parameters():
        path = flax_path(name)
        if any(t in path for t in TRAINABLE):
            assert not torch.equal(p.detach(), before[name]), name
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
            assert opt.state[p], name
        else:
            frozen += 1
            assert torch.equal(p.detach(), before[name]), name
            assert torch.equal(want[name], before[name]), name
            assert p not in opt.state and p.grad is None, name
    assert frozen > 0


SEQUENCES = [
    ({"patience": 1}, [1.0, 0.9, 0.95, 0.97, 0.96, 0.5, 0.6, 0.7, 0.8]),
    ({"mode": "max", "patience": 0, "factor": 0.5, "cooldown": 2,
      "threshold_mode": "abs", "threshold": 0.01},
     [0.1, 0.2, 0.205, 0.3, 0.3, 0.3, 0.31, 0.2, 0.1, 0.1]),
    ({"patience": 0, "factor": 0.5, "min_scale": 0.2},
     [3.0, 3.0, 3.0, 3.0, 3.0, float("nan"), 2.0]),
    ({"patience": 0, "factor": 0.9, "eps_scale": 0.2},
     [3.0, 3.1, 3.2, 3.3]),
]


@pytest.mark.parametrize("args, values", SEQUENCES,
                         ids=[str(i) for i in range(len(SEQUENCES))])
def test_plateau_controller_matches_jax(args, values):
    jc, tc = joptim.PlateauController(**args), \
        toptim.PlateauController(**args)
    for v in values:
        assert tc.step(v) == jc.step(v)
        assert (tc.best == jc.best or (math.isnan(tc.best)
                                       and math.isnan(jc.best)))
        assert tc.num_bad_epochs == jc.num_bad_epochs
    assert tc.scale == jc.scale


def test_build_optimizer_turns_min_lr_and_eps_into_scale_units():
    cfg = {"optimizer": {"type": "SGD", "args": {"lr": 0.5}},
           "lr_scheduler": {"type": "ReduceLROnPlateau", "args": {
               "min_lr": [0.01], "eps": 0.001, "patience": 3,
               "monitor": "val_accuracy", "mode": "max"}}}
    _, jlr, jp = joptim.build_optimizer(cfg, steps_per_epoch=4)
    _, lr_fn, tp = toptim.build_optimizer(
        cfg, 4, TM.get("TinyLM")(**MODEL, device="cpu"))
    assert vars(tp) == vars(jp)
    assert lr_fn(7) == float(jlr(7)) == 0.5
    cfg["lr_scheduler"]["unit"] = "step"
    for build in (lambda: joptim.build_optimizer(cfg, steps_per_epoch=4),
                  lambda: toptim.build_optimizer(
                      cfg, 4, TM.get("TinyLM")(**MODEL, device="cpu"))):
        with pytest.raises(ValueError, match="metric-driven"):
            build()


PLATEAU = ("lr_scheduler", {"type": "ReduceLROnPlateau", "args": {
    "patience": 0, "factor": 0.5, "threshold": 0.5,
    "monitor": "val_loss"}})


def test_plateau_mnist_run_matches_jax_trainer_and_resumes(tmp_path):
    sets = [PLATEAU, ("trainer;epochs", 3)]
    init, final, jlogs, _ = _jax_run(tmp_path, [(k, v) for k, v in sets])
    argv = ["-c", str(MNIST_DEBUG), "--device", "cpu", "-s",
            str(tmp_path / "port")]
    for chain, value in sets:
        argv += ["--set", chain, json.dumps(value)]
    tlogs, trainer = _port_run(argv, init)
    assert len(tlogs) == len(jlogs) == 3
    for j, t in zip(jlogs, tlogs):
        _close(t, j)
    assert trainer.train_step.lr_scale == trainer.plateau.scale == 0.25
    got = trainer.model.state_dict()
    for name, want in final.items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                   atol=1e-4, err_msg=name)
    ckpt = trainer.config.save_dir / "checkpoint-epoch2"
    state = json.loads((ckpt / "train_state.json").read_text())
    assert state["lr_scale"] == 0.5
    logs, resumed = _port_run(["-r", str(ckpt), "--device", "cpu", "-s",
                               str(tmp_path / "resumed")])
    assert resumed.start_epoch == 3 and len(logs) == 1
    _close(logs[0], tlogs[2], rtol=1e-6)
    # the scale came back; the counters restarted (the first epoch after
    # the resume improves on an infinite best, so the scale holds)
    assert resumed.train_step.lr_scale == resumed.plateau.scale == 0.5
    assert resumed.plateau.best == logs[0]["val_loss"]
