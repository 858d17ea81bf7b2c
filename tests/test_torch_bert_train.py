"""Slice 11's BERT gate on the CPU: ``configs/bert_debug.json`` through the
port's ``train.py --device cpu`` against the JAX package's ``Trainer``,
and the fine-tune path around it.

- The trajectory: both trainers on ``bert_debug.json`` with dropout 0
  (``--set``), from the JAX run's initial params, with the MLM draws
  replaced on both sides by one deterministic function of the global
  batch's tokens (``_token_draws``: JAX's threefry and the port's Philox
  cannot give the same numbers; the test feeds both the same, as
  ``tests/test_torch_image_train.py`` does for mixup): per-epoch losses
  and metrics rtol 1e-4, final params atol 1e-4.
- ``trainer.init_from`` an MLM checkpoint into a ``BertClassifier``: the
  restored and skipped paths are JAX's ``warm_start_params``' (every
  ``encoder/...`` leaf restored, ``classifier_head`` skipped).
- ``test.py --seed`` is reproducible and differs from the deterministic
  eval; without ``--seed`` it equals the best epoch's validation (rtol
  1e-6); ``--save-outputs`` writes the logits, the targets and the bool
  mask, and the loss recomputed from them is the evaluated one.
- 2 gloo ranks (one spawn, batch 8 each) equal one process (batch 16)
  with the port's own MLM draws on (the global batch's, sliced per rank):
  logs rtol 1e-5, params atol 1e-5.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_template_tpu.checkpoint.manager import (
    warm_start_params as jwarm_start,
)
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
from pytorch_distributed_template_tpu.models import bert as jbert
from pytorch_distributed_template_tpu.parallel import mesh_from_config

from pytorch_distributed_template_tpu_torch import test as ttest
from pytorch_distributed_template_tpu_torch import train as ttrain
from pytorch_distributed_template_tpu_torch.checkpoint import (
    warm_start_params,
)
from pytorch_distributed_template_tpu_torch.engine import losses
from pytorch_distributed_template_tpu_torch.models import bert as tbert
from pytorch_distributed_template_tpu_torch.models import convert
from test_torch_accum_ema import _process_signal_handlers  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
CONFIG = REPO / "configs" / "bert_debug.json"
KEYS = ("loss", "mlm_accuracy", "val_loss", "val_mlm_accuracy")
SETS = [("arch;args;dropout", 0.0)]
TIMEOUT_S = 300


def _token_draws(tokens, rows, pos, vocab: int, f32):
    """sel, mix, rand_tok of a batch from its tokens, global row indices
    and positions alone (integer arithmetic, one float32 division;
    ``f32`` casts to float32)."""
    rows, pos = rows[:, None], pos[None, :]
    h = (tokens * 37 + rows * 11 + pos * 7) % 101
    mix = f32((h * 13) % 100) / 100.0
    return h < 15, mix, (tokens * 5 + pos * 3 + rows) % (vocab - 1)


class _TokenMaskedBertMLM(jbert.BertMLM):
    """The JAX ``BertMLM`` with its train draws from :func:`_token_draws`
    (its own arithmetic otherwise, written out)."""

    @nn.compact
    def __call__(self, tokens, train: bool = False):
        mask_id = self.vocab_size - 1
        if train:
            sel, mix, rand_tok = _token_draws(
                tokens, jnp.arange(tokens.shape[0]),
                jnp.arange(tokens.shape[1]), self.vocab_size,
                lambda x: x.astype(jnp.float32))
            rand_tok = rand_tok + (rand_tok >= mask_id).astype(jnp.int32)
            corrupted = jnp.where(sel & (mix < 0.8), mask_id,
                                  jnp.where(sel & (mix >= 0.9), rand_tok,
                                            tokens))
        else:
            sel = (jnp.arange(tokens.shape[1]) % 7 == 3)[None, :]
            sel = jnp.broadcast_to(sel, tokens.shape)
            corrupted = jnp.where(sel, mask_id, tokens)
        h, embed = jbert.BertEncoder(
            self.vocab_size, self.n_layer, self.n_head, self.d_model,
            self.d_ff, self.max_len, self.dropout, self.dtype,
            self.attn_impl, self.mesh, name="encoder")(corrupted, train)
        logits = embed.attend(h.astype(self.dtype))
        return logits.astype(jnp.float32), sel.astype(jnp.float32)


def _port_token_draws(self, seed, tokens, shard=(0, 1)):
    index, count = shard
    rows = torch.arange(tokens.shape[0]) * count + index
    sel, mix, rand_tok = _token_draws(
        tokens.long(), rows, torch.arange(tokens.shape[1]), self.vocab_size,
        lambda x: x.float())
    return {"sel": sel, "mix": mix, "rand_tok": rand_tok}


def _apply(cfg, sets):
    for chain, value in sets:
        node = cfg
        *head, last = chain.split(";")
        for k in head:
            node = node[k]
        node[last] = value
    return cfg


def _argv(save_dir, sets, config=CONFIG):
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX ``Trainer`` and the port's ``train.py`` on bert_debug.json
    with the token draws, from the same initial params."""
    tmp = tmp_path_factory.mktemp("bert")
    cfg = _apply(json.loads(CONFIG.read_text()), SETS)
    cfg["trainer"]["save_dir"] = str(tmp / "jax")
    config = JConfigParser(cfg, run_id="jax", training=True)
    jlogs = []
    model = _TokenMaskedBertMLM(**{
        f: getattr(config.init_obj("arch", JMODELS), f)
        for f in ("vocab_size", "n_layer", "n_head", "d_model", "d_ff",
                  "max_len", "dropout", "dtype", "attn_impl", "mask_rate",
                  "mask_id")})
    trainer = JTrainer(
        model, jresolve_loss(config["loss"]),
        [JMETRICS.get(m) for m in config["metrics"]], config=config,
        train_loader=config.init_obj("train_loader", JLOADERS),
        valid_loader=config.init_obj("valid_loader", JLOADERS),
        mesh=mesh_from_config(config), seed=0)
    init = convert.params_from_flax(jax.device_get(trainer.state.params))
    real = trainer._train_epoch

    def record(epoch):
        log = real(epoch)
        jlogs.append(dict(log))
        return log

    trainer._train_epoch = record
    trainer.train()
    final = convert.params_from_flax(jax.device_get(trainer.state.params))
    mp = pytest.MonkeyPatch()
    mp.setattr(tbert.BertMLM, "mask_draws", _port_token_draws)
    try:
        tlogs, ptrainer = _port_run(_argv(tmp / "port", SETS), init)
    finally:
        mp.undo()
    return {"tmp": tmp, "jlogs": jlogs, "tlogs": tlogs, "final": final,
            "port": ptrainer, "jax_run": Path(config.save_dir)}


def test_trajectory_matches_jax_trainer(runs):
    jlogs, tlogs = runs["jlogs"], runs["tlogs"]
    assert len(jlogs) == len(tlogs) == 3
    for j, t in zip(jlogs, tlogs):
        for key in KEYS:
            np.testing.assert_allclose(t[key], j[key], rtol=1e-4,
                                       err_msg=key)
    got = runs["port"].model.state_dict()
    assert set(got) == set(runs["final"])
    for key, want in runs["final"].items():
        np.testing.assert_allclose(got[key].numpy(), want.numpy(),
                                   atol=1e-4, err_msg=key)


def test_init_from_grafts_the_encoder_as_jax_does(runs):
    args = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64,
                max_len=64, num_classes=3)
    jm = JMODELS.get("BertClassifier")(**args)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 16), jnp.int32))["params"]
    _, jrestored, jskipped = jwarm_start(
        runs["jax_run"] / "checkpoint-epoch1", params)
    tm = tbert.bert_classifier(**args)
    restored, skipped = warm_start_params(
        runs["port"].config.save_dir / "checkpoint-epoch1", tm)
    assert {convert.flax_path(n) for n in restored} == set(jrestored)
    assert {convert.flax_path(n) for n in skipped} == set(jskipped) == {
        "classifier_head/kernel", "classifier_head/bias"}
    disk = torch.load(runs["port"].config.save_dir / "checkpoint-epoch1" /
                      "model.pt")
    for n in restored:
        assert torch.equal(tm.state_dict()[n], disk[n]), n


def test_test_py_seed_and_saved_outputs(runs, tmp_path):
    run = runs["port"].config.save_dir
    tlogs = runs["tlogs"]

    def evaluate(*extra):
        return ttest.main(["-r", str(run / "model_best"), "--device", "cpu",
                           "-s", str(tmp_path / "log"), *extra])

    best = [e for e in tlogs
            if e["val_loss"] == min(x["val_loss"] for x in tlogs)][-1]
    plain = evaluate()
    np.testing.assert_allclose(plain["loss"], best["val_loss"], rtol=1e-6)
    np.testing.assert_allclose(plain["mlm_accuracy"],
                               best["val_mlm_accuracy"], rtol=1e-6)
    a = evaluate("--seed", "3", "--save-outputs", str(tmp_path / "out"))
    b = evaluate("--seed", "3")
    assert a == b
    assert a["loss"] != plain["loss"]
    out = np.load(tmp_path / "out" / "outputs_p0.npy")
    tgt = np.load(tmp_path / "out" / "targets_p0.npy")
    msk = np.load(tmp_path / "out" / "masks_p0.npy")
    assert out.shape == (64, 32, 256) and tgt.shape == msk.shape == (64, 32)
    assert msk.dtype == bool and 0 < msk.mean() < 0.5
    per = losses.mlm_cross_entropy(
        (torch.from_numpy(out), torch.from_numpy(msk).float()),
        torch.from_numpy(tgt))
    np.testing.assert_allclose(float(per.mean()), a["loss"], rtol=1e-5)


CHILD = r"""
import json, sys
import torch
torch.set_num_threads(1)
from pytorch_distributed_template_tpu_torch import train
from pytorch_distributed_template_tpu_torch.parallel import dist

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
        json.dump({"logs": logs, "world": dist.process_count()}, f)
finally:
    dist.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_equal_one_process(tmp_path):
    sets = SETS + [("train_loader;args;n", 64), ("valid_loader;args;n", 32),
                   ("valid_loader;args;batch_size", 16),
                   ("trainer;epochs", 2)]
    one_logs, one = _port_run(_argv(tmp_path / "one", sets + [
        ("train_loader;args;batch_size", 16)]))
    argv = _argv(tmp_path / "two", sets + [
        ("train_loader;args;batch_size", 8),
        ("valid_loader;args;batch_size", 8)])
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
    for r in ranks:
        assert r["world"] == 2
        assert len(r["logs"]) == len(one_logs) == 2
        for got, want in zip(r["logs"], one_logs):
            for key in KEYS:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                           err_msg=key)
    two = torch.load(f"{out}.pt")
    for k, v in one.model.state_dict().items():
        np.testing.assert_allclose(two[k].numpy(), v.numpy(), atol=1e-5,
                                   err_msg=k)
