"""The slice gate of training observability: ``configs/lm_debug.json`` with
TensorBoard, the health monitor, telemetry, a profiler window,
``log_grad_norm``, the watchdog, ``skip_nonfinite`` and the fault
``nan_grad@step:12`` (past the health warmup), 2 epochs, through the
port's ``train.py`` on the CPU and through the JAX package's ``Trainer``
from the same params (``params_from_flax``) and the same batches.

Checked: the epoch logs (rtol 1e-4; the token accuracies atol 2e-3, as in
tests/test_torch_trainer.py); ``telemetry.jsonl`` (the same step ids in the
same order, the same keys per record, ``loss``/``lr``/``grad_norm`` at rtol
1e-4); ``anomaly_12.json`` on both sides with the same reasons and the same
``nonfinite/<group>`` keys and counts; no ``model_best`` from the poisoned
epoch; the same TensorBoard tags; the same span names in ``trace.json``.

What the comparison leaves out, and why: record timestamps and timings;
``compile_events`` (XLA compiles on one side, none on the other: the port
builds no kernel on the CPU); the JAX-only spans of its compiled-step
instrumentation (``train_step/*``, ``eval_step/*``); step anatomy, which
the port does not have
(ROADMAP A14; ``PDT_ANATOMY=0`` for the JAX run). The ``update_norm`` of
the two summaries is compared at rtol 1e-4: the port measures it as
``p_new - p_old`` in float32.
"""
import json
from pathlib import Path

import jax
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
from pytorch_distributed_template_tpu.observability import health as jhealth
from pytorch_distributed_template_tpu.observability import trace as jtrace
from pytorch_distributed_template_tpu.parallel import mesh_from_config
from pytorch_distributed_template_tpu.resilience import faults as jfaults

from pytorch_distributed_template_tpu_torch import train as ttrain
from pytorch_distributed_template_tpu_torch.models.convert import (
    params_from_flax,
)
from pytorch_distributed_template_tpu_torch.observability import (
    health as thealth, trace as ttrace,
)
from pytorch_distributed_template_tpu_torch.resilience import (
    faults as tfaults,
)

REPO = Path(__file__).resolve().parent.parent
NAN_STEP = 12
SETS = {
    "trainer;epochs": 2,
    "trainer;tensorboard": True,
    "trainer;health": {"warmup_steps": 3, "pause_best_promotion": True},
    "trainer;telemetry": {"enabled": True},
    "trainer;profiler": {"enabled": True, "trace_start_step": 2,
                         "trace_steps": 2},
    "trainer;log_grad_norm": True,
    "trainer;watchdog_secs": 300,
    "trainer;skip_nonfinite": True,
    "trainer;faults": f"nan_grad@step:{NAN_STEP}",
}
RTOL = 1e-4
ACC_ATOL = 2e-3
JAX_ONLY_SPANS = ("train_step/", "eval_step/")


def _config(tmp):
    cfg = json.loads((REPO / "configs" / "lm_debug.json").read_text())
    for chain, value in SETS.items():
        node = cfg
        keys = chain.split(";")
        for k in keys[:-1]:
            node = node[k]
        node[keys[-1]] = value
    cfg["trainer"]["save_dir"] = str(tmp / "jax")
    return cfg


def _jax_run(tmp):
    config = JConfigParser(_config(tmp), run_id="jax", training=True)
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
    trainer.writer.flush()   # the JAX trainer leaves its writer open
    return params, logs, config.save_dir, config.log_dir


def _port_run(tmp, params):
    argv = ["-c", str(REPO / "configs" / "lm_debug.json"), "--device", "cpu",
            "-s", str(tmp / "port")]
    for chain, value in SETS.items():
        argv += ["--set", chain, json.dumps(value)]
    box, logs = {}, []

    def hook(trainer):
        box["trainer"] = trainer
        trainer.model.load_state_dict(params)
        real_epoch = trainer._train_epoch

        def record(epoch):
            log = real_epoch(epoch)
            logs.append(dict(log))
            return log

        trainer._train_epoch = record

    ttrain.main(argv, on_trainer=hook)
    run_dir = box["trainer"].config.save_dir
    return logs, run_dir


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("PDT_ANATOMY", "0")
    mp.delenv("PDT_FAULTS", raising=False)
    tmp = tmp_path_factory.mktemp("obs_train")
    try:
        jhealth.reset_counters()
        jtrace.get_recorder().clear()
        params, jlogs, jsave, jlog_dir = _jax_run(tmp)
        thealth.reset_counters()
        ttrace.get_recorder().clear()
        tlogs, trun = _port_run(tmp, params)
    finally:
        jfaults.reset()
        tfaults.reset()
        mp.undo()
    return {"jax": (jlogs, jsave, jlog_dir), "port": (tlogs, trun)}


def test_epoch_logs_match(runs):
    jlogs, _, _ = runs["jax"]
    tlogs, _ = runs["port"]
    assert len(jlogs) == len(tlogs) == 2
    for j, t in zip(jlogs, tlogs):
        keys = set(j) - {"examples_per_sec"}
        assert keys == set(t) - {"examples_per_sec"}
        for k in keys:
            if "accuracy" in k:
                np.testing.assert_allclose(t[k], j[k], atol=ACC_ATOL,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(t[k], j[k], rtol=RTOL, err_msg=k)
    assert tlogs[1]["skipped"] == jlogs[1]["skipped"] > 0


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_telemetry_records_match(runs):
    _, jsave, _ = runs["jax"]
    _, trun = runs["port"]
    jrec = _records(jsave / "telemetry.jsonl")
    trec = _records(trun / "telemetry.jsonl")
    assert [r["step"] for r in jrec] == [r["step"] for r in trec]
    drop = {"t", "compile_events"}
    for j, t in zip(jrec, trec):
        assert set(j) - drop == set(t) - drop, (j, t)
        for key in ("loss", "lr", "grad_norm"):
            if key in j:
                np.testing.assert_allclose(t[key], j[key], rtol=RTOL,
                                           err_msg=f"{key} at {j['step']}")
    steps = [r["step"] for r in trec if "event" not in r]
    assert sorted(steps) == list(range(16))
    assert any(r.get("event") == "anomaly" for r in trec)
    assert any(r.get("event") == "profile_capture" for r in trec)


def test_anomaly_dumps_match(runs):
    _, _, jlog_dir = runs["jax"]
    _, trun = runs["port"]
    jdumps = sorted(p.name for p in Path(jlog_dir).glob("anomaly_*.json"))
    tdumps = sorted(p.name for p in trun.glob("anomaly_*.json"))
    assert jdumps == tdumps == [f"anomaly_{NAN_STEP}.json"]
    j = json.loads((Path(jlog_dir) / jdumps[0]).read_text())
    t = json.loads((trun / tdumps[0]).read_text())
    assert [r["kind"] for r in j["reasons"]] == \
        [r["kind"] for r in t["reasons"]]
    groups = sorted(k for k in j["summary"] if k.startswith("nonfinite/"))
    assert groups == sorted(k for k in t["summary"]
                            if k.startswith("nonfinite/"))
    assert len(groups) > 1
    for k in groups + ["nonfinite_grads", "nonfinite_params"]:
        assert t["summary"][k] == j["summary"][k], k
    # every gradient element of the poisoned step counted
    state = torch.load(trun / "checkpoint-epoch2" / "model.pt")
    assert t["summary"]["nonfinite_grads"] == sum(
        v.numel() for v in state.values())
    for k in ("loss", "update_norm"):
        np.testing.assert_allclose(t["summary"][k], j["summary"][k],
                                   rtol=RTOL, err_msg=k)
    assert (t["epoch"], t["batch_idx"]) == (j["epoch"], j["batch_idx"])


def test_no_model_best_from_the_poisoned_epoch(runs):
    _, jsave, _ = runs["jax"]
    _, trun = runs["port"]
    meta = json.loads((trun / "model_best.meta.json").read_text())
    assert meta["epoch"] == 1
    jmeta = json.loads((Path(jsave) / "model_best.meta.json").read_text())
    assert jmeta["epoch"] == 1


def _tags(run_dir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    tags = set()
    for events in Path(run_dir).glob("events.out.tfevents.*"):
        acc = EventAccumulator(str(events))
        acc.Reload()
        tags |= set(acc.Tags()["scalars"]) | set(acc.Tags()["images"])
    return tags


def test_tensorboard_tags_match(runs):
    _, _, jlog_dir = runs["jax"]
    _, trun = runs["port"]
    jtags = _tags(jlog_dir)
    assert "loss/train" in jtags and "loss/valid" in jtags
    assert _tags(trun) == jtags


def test_trace_span_names_match(runs):
    _, _, jlog_dir = runs["jax"]
    _, trun = runs["port"]

    def names(path, drop=()):
        events = json.loads(Path(path).read_text())["traceEvents"]
        return {e["name"] for e in events
                if not e["name"].startswith(drop)}

    jnames = names(Path(jlog_dir) / "trace.json", JAX_ONLY_SPANS)
    tnames = names(trun / "trace.json")
    assert {"data/next_batch", "train/step", "train/log",
            "train/validate"} <= tnames
    assert tnames == jnames
    assert (trun / "profile").is_dir() and any((trun / "profile").iterdir())
