"""Step-accurate resume in the port against the JAX package, on the CPU:
``configs/lm_debug.json`` (TinyLM, 8 steps per epoch, 3 epochs, no
dropout) with ``save_interval_steps`` 3 and ``keep_last`` 1 (``--set``),
the port's ``train.py`` started from the JAX ``Trainer``'s initial params.

- The ``data_state`` sidecars of the interval slots and the last epoch
  checkpoint equal the JAX ``Trainer``'s field for field (the RNG
  fingerprint apart: each hashes its own generator's state), and
  ``keep_last`` leaves the same checkpoint files as the JAX ``prune``.
- A run stopped by a ``crash`` fault in epoch 2 and resumed with
  ``--auto-resume`` (from the epoch-2 slot, or from the emergency save)
  ends with params and optimizer state equal (``torch.equal``) to the
  uninterrupted run's, logs its later epochs identically, and matches the
  JAX run's epoch logs (loss rtol 1e-4, token accuracy atol 2e-3, as
  tests/test_torch_trainer.py).
- The emergency save: written on a ``crash`` with ``emergency: true`` in
  both sidecars, skipped for ``ckpt_write_fail`` and for
  ``emergency_checkpoint: false``; the original exception propagates.
- ``find_latest_checkpoint`` chooses as the JAX package's does on
  generated run trees; the fallbacks to epoch granularity warn; a warm
  start grafts by key and shape; ``init_ftn``.
"""
import json
import os
import signal
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_template_tpu.config import (
    ConfigParser as JConfigParser, LOADERS as JLOADERS,
    METRICS as JMETRICS, MODELS as JMODELS,
)
from pytorch_distributed_template_tpu.config.parser import (
    find_latest_checkpoint as jfind_latest,
)
import pytorch_distributed_template_tpu.data  # noqa: F401  (register)
import pytorch_distributed_template_tpu.engine  # noqa: F401
import pytorch_distributed_template_tpu.models  # noqa: F401
from pytorch_distributed_template_tpu.engine import Trainer as JTrainer
from pytorch_distributed_template_tpu.engine.losses import (
    resolve_loss as jresolve_loss,
)
from pytorch_distributed_template_tpu.parallel import mesh_from_config
from pytorch_distributed_template_tpu.utils import (
    preemption as jpreemption,
)

from pytorch_distributed_template_tpu_torch import train as ttrain
from pytorch_distributed_template_tpu_torch.config import (
    LOADERS as TLOADERS, MODELS as TMODELS, ConfigParser,
    find_latest_checkpoint,
)
from pytorch_distributed_template_tpu_torch.models.convert import (
    params_from_flax,
)
from pytorch_distributed_template_tpu_torch.resilience.faults import (
    FaultInjected,
)
from pytorch_distributed_template_tpu_torch.utils import (
    preemption as tpreemption,
)

REPO = Path(__file__).resolve().parent.parent
CONFIG = REPO / "configs" / "lm_debug.json"
SETS = {"trainer;save_interval_steps": 3, "trainer;keep_last": 1}
KEYS = ("loss", "val_loss", "lm_token_accuracy", "val_lm_token_accuracy")
SIDECARS = ("checkpoint-interval-a", "checkpoint-interval-b",
            "checkpoint-epoch3")
CRASH_STEP = 13      # epoch 2, batch 5: after the epoch-2 slot at batch 3


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


def _check_logs(got, want, keys=KEYS):
    for key in keys:
        if "accuracy" in key:
            np.testing.assert_allclose(got[key], want[key], atol=2e-3,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       err_msg=key)


def _jax_run(tmp):
    cfg = json.loads(CONFIG.read_text())
    for chain, value in SETS.items():
        section, key = chain.split(";")
        cfg[section][key] = value
    cfg["trainer"]["save_dir"] = str(tmp / "jax")
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
    return params, logs, config.save_dir


def _argv(save_dir, *extra, sets=SETS):
    argv = ["-c", str(CONFIG), "--device", "cpu", "-s", str(save_dir)]
    for chain, value in sets.items():
        argv += ["--set", chain, json.dumps(value)]
    return argv + list(extra)


def _port(argv, params=None, raises=None):
    """``train.main`` with the epoch logs recorded (and ``params`` loaded
    before the first epoch); returns ``(logs, trainer)``. With ``raises``,
    the run must end in that exception."""
    box, logs = {}, []

    def hook(trainer):
        box["trainer"] = trainer
        if params is not None:
            trainer.model.load_state_dict(params)
        real_epoch = trainer._train_epoch

        def record(epoch):
            log = real_epoch(epoch)
            logs.append(dict(log, epoch=epoch))
            return log

        trainer._train_epoch = record

    if raises is None:
        ttrain.main(argv, on_trainer=hook)
    else:
        with pytest.raises(raises):
            ttrain.main(argv, on_trainer=hook)
    return logs, box["trainer"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resume")
    params, jlogs, jdir = _jax_run(tmp)
    tlogs, trainer = _port(_argv(tmp / "port"), params)
    return tmp, params, jlogs, jdir, tlogs, trainer


def _state(trainer):
    return ({k: v.detach().clone() for k, v in
             trainer.model.state_dict().items()},
            trainer.optimizer.state_dict())


def _assert_same_state(a, b):
    (pa, oa), (pb, ob) = _state(a), _state(b)
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert oa["param_groups"] == ob["param_groups"]
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(ob["state"][i][k])), (i, k)


@pytest.mark.parametrize("name", SIDECARS)
def test_data_state_sidecars_match_jax(runs, name):
    _, _, _, jdir, _, trainer = runs
    pdir = trainer.config.save_dir
    got = json.loads((pdir / f"{name}.data_state.json").read_text())
    want = json.loads((jdir / f"{name}.data_state.json").read_text())
    assert got.pop("rng_fingerprint") and want.pop("rng_fingerprint")
    assert got == want
    pm = json.loads((pdir / f"{name}.meta.json").read_text())
    jm = json.loads((jdir / f"{name}.meta.json").read_text())
    assert {k: pm.get(k) for k in ("arch", "epoch", "step")} == {
        k: jm.get(k) for k in ("arch", "epoch", "step")}


def test_keep_last_leaves_the_files_jax_prune_leaves(runs):
    _, _, _, jdir, _, trainer = runs

    def kept(d):
        return sorted(p.name for p in d.iterdir()
                      if p.name.startswith(("checkpoint-", "model_best")))

    assert kept(trainer.config.save_dir) == kept(jdir)
    assert "checkpoint-epoch1" not in kept(jdir)
    assert "model_best" in kept(jdir)


@pytest.mark.parametrize("emergency", [False, True],
                         ids=["from_slot", "from_emergency_save"])
def test_crash_and_auto_resume_is_exact(runs, emergency):
    """Crash at step 13; ``--auto-resume`` takes the epoch-2 slot (steps
    11 and 12 replayed) or, when written, the emergency save (no step
    replayed); the resumed run ends where the uninterrupted one does."""
    tmp, params, jlogs, _, tlogs, trainer = runs
    save = tmp / f"crash_{emergency}"
    sets = dict(SETS, **{"trainer;emergency_checkpoint": emergency})
    _port(_argv(save, "--set", "trainer;faults",
                json.dumps(f"crash@step:{CRASH_STEP}"), sets=sets),
          params, raises=FaultInjected)
    (crashed,) = list((save / "TinyLM_Debug" / "train").iterdir())
    assert (crashed / "checkpoint-emergency").is_dir() == emergency
    time.sleep(1.1)   # the resumed run gets its own run id (seconds)
    logs, resumed = _port(_argv(save, "--auto-resume", sets=sets))
    source = "checkpoint-emergency" if emergency else "checkpoint-interval-a"
    assert resumed.config.resume == (crashed / source).resolve()
    assert resumed.start_epoch == 2
    assert resumed._resume_next_batch == (5 if emergency else 3)
    assert [log["epoch"] for log in logs] == [2, 3]
    _assert_same_state(resumed, trainer)
    assert resumed.train_step.state_dict() == trainer.train_step.state_dict()
    assert {k: logs[1][k] for k in KEYS} == {k: tlogs[2][k] for k in KEYS}
    assert logs[0]["val_loss"] == tlogs[1]["val_loss"]
    _check_logs(logs[1], jlogs[2])
    _check_logs(logs[0], jlogs[1],
                keys=[k for k in KEYS if k.startswith("val_")])


@pytest.mark.parametrize("fault, sets, written", [
    ("crash@step:13", {}, True),
    ("ckpt_write_fail@epoch:1", {}, False),
    ("crash@step:13", {"trainer;emergency_checkpoint": False}, False),
], ids=["crash", "ckpt_write_fail", "disabled"])
def test_emergency_save(tmp_path, fault, sets, written):
    _, trainer = _port(_argv(tmp_path, "--set", "trainer;faults",
                             json.dumps(fault), sets=dict(SETS, **sets)),
                       raises=FaultInjected)
    run = trainer.config.save_dir
    assert (run / "checkpoint-emergency").is_dir() == written
    if written:
        meta = json.loads((run / "checkpoint-emergency.meta.json")
                          .read_text())
        ds = json.loads((run / "checkpoint-emergency.data_state.json")
                        .read_text())
        assert meta["emergency"] is True and ds["emergency"] is True
        assert (meta["epoch"], ds["epoch"], ds["next_batch"],
                ds["global_step"]) == (2, 2, 5, 13)
        saved = torch.load(run / "checkpoint-emergency" / "model.pt")
        for k, v in trainer.model.state_dict().items():
            assert torch.equal(saved[k], v), k


def _tree(base, runs):
    """``runs``: {run: [(name, sidecar epoch or None, mtime)]}; a name
    starting with '.' is a temporary directory (no sidecar)."""
    cfg = {"name": "Exp", "trainer": {"save_dir": str(base)}}
    for run, entries in runs.items():
        root = base / "Exp" / "train" / run
        root.mkdir(parents=True)
        for name, epoch, mtime in entries:
            (root / name).mkdir()
            (root / name / "model.pt").write_bytes(b"")
            if epoch is not None:
                (root / f"{name}.meta.json").write_text(
                    json.dumps({"epoch": epoch}))
            os.utime(root / name, (mtime, mtime))
    return cfg


TREES = {
    "epoch_edge_beats_slot_of_its_epoch": (
        {"r": [("checkpoint-epoch2", 2, 100), ("checkpoint-interval-a", 2,
                                               200)]},
        "r/checkpoint-epoch2"),
    "slot_of_a_later_epoch_wins": (
        {"r": [("checkpoint-epoch2", 2, 100), ("checkpoint-interval-b", 3,
                                               150)]},
        "r/checkpoint-interval-b"),
    "newest_emergency_save_wins": (
        {"r": [("checkpoint-epoch1", 1, 100),
               ("checkpoint-interval-a", 2, 150),
               ("checkpoint-emergency", 2, 160)]},
        "r/checkpoint-emergency"),
    "slot_with_a_lost_sidecar_ranks_at_epoch_0": (
        {"r": [("checkpoint-epoch1", 1, 100),
               ("checkpoint-interval-a", None, 300)]},
        "r/checkpoint-epoch1"),
    "two_runs_by_mtime": (
        {"old": [("checkpoint-epoch5", 5, 100)],
         "new": [("checkpoint-epoch1", 1, 200)]},
        "new/checkpoint-epoch1"),
    "temporary_directories_ignored": (
        {"r": [("checkpoint-epoch1", 1, 100),
               (".checkpoint-epoch2.tmp", None, 300),
               (".checkpoint-interval-a.tmp", None, 300)]},
        "r/checkpoint-epoch1"),
    "never_checkpointed": ({"r": []}, None),
}


@pytest.mark.parametrize("case", sorted(TREES))
def test_find_latest_checkpoint_chooses_as_jax(tmp_path, case):
    runs, want = TREES[case]
    cfg = _tree(tmp_path, runs)
    got, jgot = find_latest_checkpoint(cfg), jfind_latest(cfg)
    rel = (lambda p: None if p is None else
           str(p.relative_to(tmp_path / "Exp" / "train")))
    assert rel(got) == rel(jgot) == want


@pytest.mark.parametrize("chain, value, warning", [
    ("train_loader;args;batch_size", 16, "data_state geometry mismatch"),
    ("trainer;len_epoch", 8, "len_epoch (iteration-based)"),
], ids=["geometry_changed", "len_epoch"])
def test_resume_falls_back_to_epoch_granularity(runs, tmp_path, chain,
                                                value, warning):
    _, _, _, _, _, trainer = runs
    slot = trainer.config.save_dir / "checkpoint-interval-a"
    ds = json.loads((slot.parent / f"{slot.name}.data_state.json")
                    .read_text())
    assert ds["next_batch"] == 3
    _, resumed = _port(["-r", str(slot), "--device", "cpu", "-s",
                        str(tmp_path), "--set", chain, json.dumps(value),
                        "--set", "trainer;epochs", "0"])
    assert resumed.start_epoch == ds["epoch"] + 1
    assert resumed._resume_next_batch == 0
    assert warning in (resumed.config.save_dir / "info.log").read_text()


def test_init_from_grafts_by_key_and_shape(runs, tmp_path):
    """A TinyLM with a larger vocabulary starts from the run's last
    checkpoint: every tensor of matching key and shape is grafted, the
    embedding and the head keep their init; the optimizer, the counters
    and the epoch start fresh."""
    _, _, _, _, _, trainer = runs
    ckpt = trainer.config.save_dir / "checkpoint-epoch3"
    saved = torch.load(ckpt / "model.pt")
    box = {}

    def hook(t):
        box["params"] = {k: v.clone() for k, v in
                         t.model.state_dict().items()}
        box["start"] = (t.start_epoch, t.train_step.state_dict(),
                        len(t.optimizer.state))

    ttrain.main(["-c", str(CONFIG), "--device", "cpu", "-s", str(tmp_path),
                 "--set", "arch;args;vocab_size", "80", "--set",
                 "trainer;init_from", json.dumps(str(ckpt)), "--set",
                 "trainer;epochs", "0"], on_trainer=hook)
    fresh = TMODELS.get("TinyLM")(vocab_size=80, d_model=64, max_len=64,
                                  device="cpu", param_dtype=torch.float32)
    fresh.init_weights(torch.Generator().manual_seed(0))
    fresh = fresh.state_dict()
    skipped = sorted(k for k in fresh if fresh[k].shape != saved[k].shape)
    assert skipped and len(skipped) < len(fresh)
    for k, v in box["params"].items():
        want = fresh[k] if k in skipped else saved[k]
        assert torch.equal(v, want), k
    assert box["start"] == (1, {"step": 0, "applied": 0}, 0)
    log = (next((tmp_path / "TinyLM_Debug" / "train").iterdir())
           / "info.log").read_text()
    assert (f"{len(fresh) - len(skipped)} param tensors restored, "
            f"{len(skipped)} kept their init") in log


def test_init_ftn(tmp_path):
    cfg = json.loads(CONFIG.read_text())
    cfg["trainer"]["save_dir"] = str(tmp_path)
    config = ConfigParser(cfg, run_id="ftn")
    fn = config.init_ftn("train_loader", TLOADERS, seed=3)
    jfn = JConfigParser(json.loads(json.dumps(cfg)), run_id="jftn"
                        ).init_ftn("train_loader", JLOADERS, seed=3)
    assert fn.keywords == jfn.keywords
    loader = fn()
    assert (loader.batch_size, loader.seed, len(loader)) == (32, 3, 8)
    with pytest.raises(ValueError, match="Overwriting kwargs"):
        config.init_ftn("train_loader", TLOADERS, batch_size=4)
