"""Faults C2 and C3 of the port, pinned on the CPU.

C2: a loss scaled by 1e30 (the TinyLM of tests/test_torch_lm_train.py,
AdamW, one step) overflows the global gradient norm while every gradient
stays finite. The JAX step clips first (scale 0: finite zero gradients),
tests the leaves and applies the step (AdamW's decay); the port must do
the same, with the clip on and off and with ``log_grad_norm`` on:
``skipped_sum`` and ``loss_sum`` equal (rtol 1e-5), the largest parameter
change equal (rtol 1e-4, float32 both sides) and the update applied.

C3: the writer puts a slot's ``data_state`` cursor before its meta, so a
write cut between them leaves a slot without meta, which
``find_latest_checkpoint`` ranks at epoch 0; and a slot that has its meta
and no cursor (a sidecar lost, or a slot from before this order) resumes
at the start of its own epoch with a warning, never at ``epoch + 1``.
"""
import json
import os
from pathlib import Path

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
from pytorch_distributed_template_tpu_torch import train as ttrain
from pytorch_distributed_template_tpu_torch.checkpoint import manager
from pytorch_distributed_template_tpu_torch.config.parser import (
    find_latest_checkpoint,
)
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TM,
)
from pytorch_distributed_template_tpu_torch.engine import losses as tlosses
from pytorch_distributed_template_tpu_torch.engine import optim as toptim
from pytorch_distributed_template_tpu_torch.engine import steps as tsteps
from pytorch_distributed_template_tpu_torch.models.convert import (
    params_from_flax,
)

from test_torch_accum_ema import _process_signal_handlers  # noqa: F401
from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401
from test_torch_lm_train import MODEL, STEP_CFG

CONFIG = Path(__file__).resolve().parent.parent / "configs" / "lm_debug.json"


class _Scaled:
    """The loss times 1e30: finite, but the squared gradients overflow."""

    def __init__(self, base):
        self.base = base
        self.__name__ = "scaled"

    def __call__(self, output, target):
        return self.base(output, target) * 1e30


@pytest.mark.parametrize("clip, log_grad_norm", [
    (0.05, False), (0.05, True), (0.0, True), (0.0, False)])
def test_overflowed_norm_with_finite_gradients_applies_as_jax(
        clip, log_grad_norm):
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 64, (8, 16)).astype(np.int32),
             "mask": np.ones(8, bool)}
    jmodel = JM.get("TinyLM")(**MODEL)
    tx, _, _ = joptim.build_optimizer(STEP_CFG, steps_per_epoch=2)
    state = jstate.create_train_state(jmodel, tx,
                                      jnp.zeros((1, 16), jnp.int32))
    before = params_from_flax(jax.device_get(state.params))
    tmodel = TM.get("TinyLM")(**MODEL, device="cpu")
    tmodel.load_state_dict(before)
    opt, lr_fn, _ = toptim.build_optimizer(STEP_CFG, 2, tmodel)
    kw = dict(input_key="tokens", target_key="tokens", grad_clip_norm=clip,
              skip_nonfinite=True, log_grad_norm=log_grad_norm)
    jstep = jsteps.make_train_step(jmodel, tx,
                                   _Scaled(jlosses.lm_cross_entropy), **kw)
    tstep = tsteps.make_train_step(tmodel, opt,
                                   _Scaled(tlosses.lm_cross_entropy),
                                   lr_fn=lr_fn, **kw)
    state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
    tm = tstep({k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(tm["skipped_sum"]) == float(jm["skipped_sum"]) == 0.0
    np.testing.assert_allclose(float(tm["loss_sum"]), float(jm["loss_sum"]),
                               rtol=1e-5)
    assert tstep.applied == 1
    after = params_from_flax(jax.device_get(state.params))
    jdelta = max(float((after[n] - before[n]).abs().max()) for n in before)
    tdelta = max(float((p.detach() - before[n]).abs().max())
                 for n, p in tmodel.named_parameters())
    assert jdelta > 0
    np.testing.assert_allclose(tdelta, jdelta, rtol=1e-4)
    if log_grad_norm:
        assert np.isinf(float(tm["grad_norm_sum"]))
        assert np.isinf(float(jm["grad_norm_sum"]))


def test_a_slot_cut_before_its_meta_ranks_below_the_epoch_edge(tmp_path):
    """The writer's new order leaves a cut slot with its cursor and no
    meta: it ranks at epoch 0, below an older epoch edge; once its meta
    lands it ranks by it."""
    run = tmp_path / "save" / "Exp" / "train" / "0101_000000"
    edge = run / "checkpoint-epoch1"
    edge.mkdir(parents=True)
    os.utime(edge, (1, 1))
    (run / "checkpoint-interval-a").mkdir()
    (run / "checkpoint-interval-a.data_state.json").write_text(
        json.dumps({"epoch": 2, "next_batch": 4}))
    cfg = {"name": "Exp", "trainer": {"save_dir": str(tmp_path / "save")}}
    assert find_latest_checkpoint(cfg) == edge
    (run / "checkpoint-interval-a.meta.json").write_text(json.dumps(
        {"arch": "TinyLM", "epoch": 2, "step": 4, "monitor_best": None,
         "config": {}}))
    assert find_latest_checkpoint(cfg).name == "checkpoint-interval-a"


def test_the_writer_puts_the_cursor_before_the_meta(tmp_path, monkeypatch):
    order = []
    real = manager._write_json

    def spy(path, obj):
        order.append(path.name)
        real(path, obj)

    monkeypatch.setattr(manager, "_write_json", spy)
    manager._write_checkpoint(tmp_path / "checkpoint-interval-a",
                              {"train_state.json": {"step": 1}},
                              {"epoch": 1}, {"epoch": 1, "next_batch": 2})
    assert order == ["checkpoint-interval-a.data_state.json",
                     "checkpoint-interval-a.meta.json"]


def test_resuming_a_slot_without_its_cursor_restarts_its_epoch(tmp_path):
    """lm_debug cut to 1 epoch of 4 steps with slots every 2 batches; the
    last slot's cursor then removed (a write cut before it): the resume
    restarts epoch 1, with a warning, rather than going on at epoch 2."""
    box = {}

    def keep(trainer):
        box["t"] = trainer

    argv = ["-c", str(CONFIG), "--device", "cpu", "-s", str(tmp_path),
            "--set", "trainer;epochs", "1",
            "--set", "train_loader;args;n", "128",
            "--set", "valid_loader;args;n", "32",
            "--set", "trainer;save_interval_steps", "2"]
    ttrain.main(argv, on_trainer=keep)
    slot = box["t"].config.save_dir / "checkpoint-interval-a"
    (slot.parent / f"{slot.name}.data_state.json").unlink()
    box.clear()
    ttrain.main(["-r", str(slot), "--device", "cpu", "-s",
                 str(tmp_path / "resumed"), "--set", "trainer;epochs", "1"],
                on_trainer=keep)
    assert box["t"].start_epoch == 1
    assert "no data_state sidecar" in (box["t"].config.log_dir /
                                       "info.log").read_text()


@pytest.mark.parametrize("where", ["loss", "gradient"])
def test_nan_check_raises_floating_point_error(where):
    """``debug.nan_check``: a NaN loss (anomaly mode names the backward
    function that made it) or a NaN gradient (``nan_grad``) stops the
    step with ``FloatingPointError`` before any update."""
    from pytorch_distributed_template_tpu_torch.utils.debug import (
        configure_debug,
    )

    class _NanLoss:
        __name__ = "nan_loss"

        def __call__(self, output, target):
            return tlosses.lm_cross_entropy(output, target) * float("nan")

    tmodel = TM.get("TinyLM")(**MODEL, device="cpu")
    before = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    opt, lr_fn, _ = toptim.build_optimizer(STEP_CFG, 2, tmodel)
    crit = _NanLoss() if where == "loss" else tlosses.lm_cross_entropy
    step = tsteps.make_train_step(
        tmodel, opt, crit, lr_fn=lr_fn, input_key="tokens",
        target_key="tokens", nan_check=True,
        inject_nan_grad_step=0 if where == "gradient" else None)
    batch = {"tokens": torch.zeros(2, 16, dtype=torch.int32),
             "mask": torch.ones(2, dtype=torch.bool)}
    was = torch.is_anomaly_enabled()
    try:
        assert configure_debug({"nan_check": True})
        with pytest.raises(FloatingPointError, match="step 0"):
            step(batch)
    finally:
        torch.autograd.set_detect_anomaly(was)
    assert step.applied == 0
    for n, p in tmodel.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
