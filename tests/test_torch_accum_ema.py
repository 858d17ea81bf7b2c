"""Gradient accumulation and EMA in the port against the JAX package's
``make_train_step``, on the CPU.

A TinyLM (2 layers, d_model 32, no dropout) trains with AdamW +
WarmupCosine + clipping on batches of 8 sequences, some rows masked out,
from the same params on both sides. Tolerances (float32 both sides):
``grad_accum_steps=2`` against the JAX step with the same option, losses
and gradient norms rtol 1e-5 and the params after 3 steps rtol 1e-5 with
atol 1e-5 (tests/test_torch_lm_train.py's trajectory tolerance: Adam's
normalised update turns a last-bit difference in a near-zero gradient
into up to ~lr x 1e-3); the port's k = 2 against its own k = 1 rtol 1e-6
(the sums run in another order); the EMA after each of 5 steps (one of
them skipped by ``skip_nonfinite``) rtol 1e-5 with atol 1e-5. Then: a batch that k does not divide
raises as in JAX; a skipped step leaves the EMA and the optimizer state
bitwise untouched; EMA checkpoints load in both directions; validation
and ``test.py`` evaluate the EMA's weights (``eval_with_ema``); and 2 gloo
ranks with k = 2 equal 1 process with k = 2 (the epoch logs' losses rtol
1e-5, their argmax metrics within one predicted token per epoch, params
atol 1e-4, ``PARAM_ATOL_DDP``).
"""
import json
import logging
import os
import signal
import socket
import subprocess
import sys
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
from pytorch_distributed_template_tpu.utils import (
    preemption as jpreemption,
)

import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch import test as ttest
from pytorch_distributed_template_tpu_torch import train as ttrain
from pytorch_distributed_template_tpu_torch.checkpoint import (
    CheckpointManager,
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
from pytorch_distributed_template_tpu_torch.utils import (
    preemption as tpreemption,
)

REPO = Path(__file__).resolve().parent.parent
CONFIG = REPO / "configs" / "lm_debug.json"
STEP_CFG = {
    "optimizer": {"type": "AdamW", "args": {
        "lr": 0.01, "betas": [0.9, 0.95], "weight_decay": 0.1,
        "weight_decay_exclude": ["bias$", "ln_", "wpe"]}},
    "lr_scheduler": {"type": "WarmupCosine",
                     "args": {"warmup_epochs": 2, "total_epochs": 5}},
}
MODEL = dict(vocab_size=64, n_layer=2, n_head=2, d_model=32, max_len=16,
             attn_impl="xla")
KW = dict(input_key="tokens", target_key="tokens", grad_clip_norm=0.05,
          log_grad_norm=True)
EMA_DECAY = 0.9
TIMEOUT_S = 240
# 2 ranks against 1 process after 16 AdamW steps at lr 3e-3: the ranks sum
# each gradient in another order, and the normalised update of a weight
# whose gradient is near zero turns that into a few percent of lr (3.2e-5
# at most when this bound was set)
PARAM_ATOL_DDP = 1e-4
# argmax metrics of those runs: their weights may differ by PARAM_ATOL_DDP,
# so a logit pair that close flips a prediction; a flip moves the epoch's
# token accuracy by one predicted token of the 256 x 31 an lm_debug epoch
# scores (both sides are deterministic run against run)
ARGMAX_METRICS = ("lm_token_accuracy", "accuracy", "top_k_acc")
TOKENS_PER_EPOCH = 256 * 31
MAX_FLIPPED_TOKENS = 1


@pytest.fixture(autouse=True, scope="module")
def _process_signal_handlers():
    """The trainers this module runs in-process install their SIGTERM
    handler (each package's ``utils.preemption``, which then remembers
    that it did); afterwards the handlers the module found come back and
    both modules forget, so the modules that run next in this process
    install their own again."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, handler in saved.items():
        signal.signal(s, handler)
    jpreemption._installed = tpreemption._installed = False


class _Poison:
    """A criterion whose loss turns NaN while ``on`` (the same flag drives
    both packages' steps)."""

    def __init__(self, base):
        self.base, self.on = base, False
        self.__name__ = "poisoned"

    def __call__(self, output, target):
        per_ex = self.base(output, target)
        return per_ex + float("nan") if self.on else per_ex


def _batches(n, rows=8):
    rng = np.random.default_rng(11)
    out = []
    for i in range(n):
        mask = np.ones(rows, bool)
        if i % 2 == 1:
            mask[rows - 3:] = False     # the second microbatch part-padded
        out.append({"tokens": rng.integers(0, 64, (rows, 16)).astype(
            np.int32), "mask": mask})
    return out


def _pair(with_ema=False):
    """The JAX state and a port model with the same params."""
    jmodel = JM.get("TinyLM")(**MODEL)
    tx, _, _ = joptim.build_optimizer(STEP_CFG, steps_per_epoch=2)
    state = jstate.create_train_state(jmodel, tx,
                                      jnp.zeros((1, 16), jnp.int32),
                                      with_ema=with_ema)
    tmodel = TM.get("TinyLM")(**MODEL, device="cpu")
    tmodel.load_state_dict(params_from_flax(jax.device_get(state.params)))
    return jmodel, tx, state, tmodel


def _port_step(tmodel, crit=None, **kw):
    opt, lr_fn, _ = toptim.build_optimizer(STEP_CFG, 2, tmodel)
    return tsteps.make_train_step(
        tmodel, opt, crit or tlosses.lm_cross_entropy, lr_fn=lr_fn,
        **KW, **kw)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_params(tmodel, flax_params, rtol, atol=1e-5):
    want = params_from_flax(jax.device_get(flax_params))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)


def test_accumulation_matches_jax():
    jmodel, tx, state, tmodel = _pair()
    jstep = jax.jit(jsteps.make_train_step(
        jmodel, tx, jlosses.lm_cross_entropy, grad_accum_steps=2, **KW))
    tstep = _port_step(tmodel, grad_accum_steps=2)
    for batch in _batches(3):
        state, jm = jstep(state, _j(batch))
        tm = tstep(_t(batch))
        for key in ("loss_sum", "count", "grad_norm_sum"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
    assert (tstep.step, tstep.applied) == (3, 3)
    _assert_params(tmodel, state.params, rtol=1e-5)


def test_accumulation_equals_the_whole_batch():
    batches = _batches(3)
    models = [_pair()[3] for _ in range(2)]
    steps = [_port_step(m, grad_accum_steps=k)
             for m, k in zip(models, (1, 2))]
    for batch in batches:
        one, two = (s(_t(batch)) for s in steps)
        for key in ("loss_sum", "count", "grad_norm_sum"):
            np.testing.assert_allclose(float(two[key]), float(one[key]),
                                       rtol=1e-6, err_msg=key)
        scale = max(float(p.grad.abs().max())
                    for p in models[0].parameters())
        for (name, a), b in zip(models[0].named_parameters(),
                                models[1].parameters()):
            np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(),
                                       rtol=1e-6, atol=1e-6 * scale,
                                       err_msg=name)
    for (name, a), b in zip(models[0].named_parameters(),
                            models[1].parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_indivisible_batch_raises_as_in_jax():
    jmodel, tx, state, tmodel = _pair()
    batch = _batches(1, rows=7)[0]
    text = "batch size 7 not divisible by grad_accum_steps 2"
    with pytest.raises(ValueError, match=text):
        _port_step(tmodel, grad_accum_steps=2)(_t(batch))
    with pytest.raises(ValueError, match=text):
        jsteps.make_train_step(jmodel, tx, jlosses.lm_cross_entropy,
                               grad_accum_steps=2, **KW)(state, _j(batch))


def test_ema_trajectory_matches_jax():
    """5 steps with ``ema_decay`` 0.9 and ``skip_nonfinite``, step 2
    poisoned: the EMA after every step, and the params at the end."""
    jmodel, tx, state, tmodel = _pair(with_ema=True)
    jcrit = _Poison(jlosses.lm_cross_entropy)
    tcrit = _Poison(tlosses.lm_cross_entropy)
    jstep = jsteps.make_train_step(jmodel, tx, jcrit, ema_decay=EMA_DECAY,
                                   skip_nonfinite=True, **KW)
    tstep = _port_step(tmodel, tcrit, ema_decay=EMA_DECAY,
                       skip_nonfinite=True)
    for i, batch in enumerate(_batches(5)):
        jcrit.on = tcrit.on = i == 2
        state, jm = jstep(state, _j(batch))
        tm = tstep(_t(batch))
        assert float(tm["skipped_sum"]) == float(jm["skipped_sum"])
        want = params_from_flax(jax.device_get(state.ema_params))
        for name, shadow in tstep.ema.items():
            np.testing.assert_allclose(shadow.numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {i} {name}")
    assert (tstep.step, tstep.applied) == (5, 4)
    _assert_params(tmodel, state.params, rtol=1e-5)


def test_skipped_step_leaves_ema_and_optimizer_untouched():
    tmodel = _pair()[3]
    crit = _Poison(tlosses.lm_cross_entropy)
    step = _port_step(tmodel, crit, ema_decay=EMA_DECAY,
                      skip_nonfinite=True, grad_accum_steps=2)
    batches = _batches(2)
    step(_t(batches[0]))
    ema = {k: v.clone() for k, v in step.ema.items()}
    opt = {i: {k: torch.as_tensor(v).clone() for k, v in st.items()}
           for i, st in step.optimizer.state_dict()["state"].items()}
    params = [p.detach().clone() for p in tmodel.parameters()]
    crit.on = True
    m = step(_t(batches[1]))
    assert float(m["skipped_sum"]) > 0
    for k, v in step.ema.items():
        assert torch.equal(v, ema[k]), k
    for i, st in step.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v), opt[i][k]), (i, k)
    for a, b in zip(tmodel.parameters(), params):
        assert torch.equal(a.detach(), b)


def test_ema_checkpoints_load_both_ways(tmp_path, caplog):
    """A checkpoint with an EMA loads into a run without one (a warning,
    the shadow weights dropped); one without loads into a run with one
    (a warning, the EMA seeded from the restored params)."""
    tmodel = _pair()[3]
    with_ema = _port_step(tmodel, ema_decay=EMA_DECAY)
    for batch in _batches(2):
        with_ema(_t(batch))
    manager = CheckpointManager(tmp_path)
    meta = dict(arch="TransformerLM", config=STEP_CFG, monitor_best=0.0)
    manager.save(1, tmodel, with_ema.optimizer, with_ema.state_dict(),
                 ema=with_ema.ema, **meta)
    without = _port_step(tmodel)
    manager.save(2, tmodel, without.optimizer, without.state_dict(),
                 **meta)
    saved = torch.load(tmp_path / "checkpoint-epoch1" / "ema.pt")
    assert not (tmp_path / "checkpoint-epoch2" / "ema.pt").exists()

    fresh = _pair()[3]
    target = _port_step(fresh, ema_decay=EMA_DECAY)
    caplog.set_level(logging.WARNING)
    manager.restore(tmp_path / "checkpoint-epoch1", fresh, target.optimizer,
                    STEP_CFG, "TransformerLM", ema=target.ema)
    for name, shadow in target.ema.items():
        assert torch.equal(shadow, saved[name]), name
    assert not any(shadow.equal(p) for shadow, p in zip(
        target.ema.values(), fresh.parameters()))

    plain = _port_step(_pair()[3])
    manager.restore(tmp_path / "checkpoint-epoch1", plain.model,
                    plain.optimizer, STEP_CFG, "TransformerLM",
                    ema=plain.ema)
    assert "shadow weights discarded" in caplog.text

    manager.restore(tmp_path / "checkpoint-epoch2", fresh, target.optimizer,
                    STEP_CFG, "TransformerLM", ema=target.ema)
    assert "seeding EMA from the restored params" in caplog.text
    for (name, p) in fresh.named_parameters():
        assert torch.equal(target.ema[name], p.detach()), name


def _lm_run(argv):
    box = {}
    ttrain.main(argv, on_trainer=lambda t: box.__setitem__("t", t))
    return box["t"]


@pytest.mark.parametrize("eval_with_ema", [True, False])
def test_validation_and_test_py_use_the_ema(tmp_path, eval_with_ema):
    """One epoch with ``ema_decay`` 0.5: the epoch's ``val_loss`` is the
    EMA's (or the live params' with ``eval_with_ema`` false), and so is
    ``test.py``'s loss on the checkpoint."""
    argv = ["-c", str(CONFIG), "--device", "cpu", "-s", str(tmp_path),
            "--set", "trainer;epochs", "1", "--set", "trainer;ema_decay",
            "0.5", "--set", "trainer;eval_with_ema",
            json.dumps(eval_with_ema)]
    trainer = _lm_run(argv)
    assert trainer.use_ema == eval_with_ema
    trainer.use_ema = False
    live = trainer._valid_epoch(1)["loss"]
    with tsteps.ema_weights(trainer.model, trainer.train_step.ema):
        shadow = trainer._valid_epoch(1)["loss"]
    trainer.use_ema = True
    assert trainer._valid_epoch(1)["loss"] == shadow != live
    summary = json.loads((trainer.config.save_dir / "summary.json")
                         .read_text())
    want = shadow if eval_with_ema else live
    np.testing.assert_allclose(summary["val_loss"], want, rtol=1e-6)
    result = ttest.main(["-r", str(trainer.config.save_dir
                                   / "checkpoint-epoch1"),
                         "--device", "cpu", "-s", str(tmp_path / "test")])
    np.testing.assert_allclose(result["loss"], want, rtol=1e-6)


CHILD = r"""
import json, sys
from pytorch_distributed_template_tpu_torch import train
from pytorch_distributed_template_tpu_torch.parallel import dist

argv, out = json.loads(sys.argv[1]), sys.argv[2]
logs, box = [], {}


def hook(trainer):
    box["trainer"] = trainer
    real = trainer._train_epoch

    def record(epoch):
        log = real(epoch)
        logs.append({k: log[k] for k in ("loss", "val_loss",
                                         "lm_token_accuracy")})
        return log

    trainer._train_epoch = record


try:
    train.main(argv, on_trainer=hook)
    t = box["trainer"]
    rank = dist.process_index()
    if rank == 0:
        import torch
        torch.save(t.model.state_dict(), out + ".pt")
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump({"logs": logs, "ddp": t.ddp is not None,
                   "world": dist.process_count()}, f)
finally:
    dist.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(argv, out, world):
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


def test_two_gloo_ranks_with_accumulation_equal_one_process(tmp_path):
    """``lm_debug`` (2 epochs of 8 steps) with k = 2: 2 ranks of 16 rows
    per step (microbatches of 8) against 1 process of 32 (microbatches of
    16); the same 32 samples make each step."""
    def argv(save, bs):
        return ["-c", str(CONFIG), "--device", "cpu", "-s", str(save),
                "--bs", str(bs), "--set", "trainer;epochs", "2",
                "--set", "trainer;grad_accum_steps", "2"]

    ranks = _launch(argv(tmp_path / "two", 16), tmp_path / "two", 2)
    logs = []

    def hook(trainer):
        box["trainer"] = trainer
        real = trainer._train_epoch

        def record(epoch):
            log = real(epoch)
            logs.append(log)
            return log

        trainer._train_epoch = record

    box = {}
    ttrain.main(argv(tmp_path / "one", 32), on_trainer=hook)
    one = box["trainer"]
    for r in ranks:
        assert r["ddp"] and r["world"] == 2
        assert r["logs"] == ranks[0]["logs"]
    assert one.ddp is None and len(logs) == 2
    for got, want in zip(ranks[0]["logs"], logs):
        for key in got:
            if key in ARGMAX_METRICS:
                flipped = abs(got[key] - want[key]) * TOKENS_PER_EPOCH
                assert flipped <= MAX_FLIPPED_TOKENS + 1e-3, (key, flipped)
            else:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                           err_msg=key)
    a = torch.load(f"{tmp_path / 'two'}.pt")
    for name, value in one.model.state_dict().items():
        np.testing.assert_allclose(a[name].numpy(), value.numpy(),
                                   atol=PARAM_ATOL_DDP, err_msg=name)
