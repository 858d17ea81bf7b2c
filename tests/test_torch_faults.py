"""The port's copy of ``resilience/faults.py`` against the JAX package's:
the same plans parse to the same specs (the grammar of tests/test_faults.py,
rejects included), ``PDT_FAULTS`` wins over ``trainer.faults``, attempt
gating, and the training hooks the port wires: ``slow_host``/``crash`` at
``on_step``, ``loader_raise`` in the port's loader, ``ckpt_write_fail`` in
the port's checkpoint manager and ``nan_grad`` in the port's train step
(skipped by ``skip_nonfinite``, params untouched, the next step clean).
"""
import time

import numpy as np
import pytest
import torch

from pytorch_distributed_template_tpu.resilience import faults as jfaults

from pytorch_distributed_template_tpu_torch.checkpoint.manager import (
    CheckpointManager,
)
from pytorch_distributed_template_tpu_torch.data.loader import (
    ArrayDataLoader,
)
from pytorch_distributed_template_tpu_torch.engine import losses, steps
from pytorch_distributed_template_tpu_torch.config.registry import MODELS
import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch.resilience import faults
from pytorch_distributed_template_tpu_torch.resilience.faults import (
    FaultInjected, FaultPlan,
)

PLANS = [
    "kill@step:120;nan_grad@step:40;slow_host@step:30:2.5s;"
    "loader_raise@batch:7;ckpt_write_fail@epoch:2",
    "slow_host@step:1:250ms;kill@step:9@attempt:2;crash@step:3@attempt:any",
    "", " ; ;",
    "slow_decode@tick:3:20ms;hang@tick:9;pool_exhaust@tick:2:1s;"
    "stall_stream@req:1;proxy_latency@req:2:5ms;proxy_blackhole@req:3;"
    "ckpt_corrupt@load:1",
    "slow_spill@evt:1:10ms;corrupt_spill@evt:2;tier_exhaust@evt:8:300ms;"
    "peer_pull_timeout@pull:1;corrupt_page@evt:1",
]
BAD = ["frobnicate@step:3", "kill@epoch:3", "kill@step", "kill",
       "slow_host@step:1:fast", "kill@step:1@retries:2", "kill@step:1:x:y"]


@pytest.fixture(autouse=True)
def _clean_plan(monkeypatch):
    monkeypatch.delenv(faults.ENV_PLAN, raising=False)
    monkeypatch.delenv(faults.ENV_ATTEMPT, raising=False)
    faults.reset()
    yield
    faults.reset()


def _fields(plan):
    return [(s.kind, s.unit, s.at, s.arg, s.attempt, s.describe())
            for s in plan.specs]


@pytest.mark.parametrize("text", PLANS)
def test_plans_parse_as_in_the_jax_package(text):
    got, want = FaultPlan.parse(text), jfaults.FaultPlan.parse(text)
    assert _fields(got) == _fields(want)
    assert bool(got) == bool(want)
    for attempt in (1, 2):
        assert [s.describe() for s in got.active(attempt)] == \
            [s.describe() for s in want.active(attempt)]
    for a, b in zip(got.specs, want.specs):
        if a.arg is not None and a.kind in faults._DURATION_KINDS:
            assert a.duration_s == b.duration_s


@pytest.mark.parametrize("bad", BAD)
def test_bad_plans_are_refused_by_both(bad):
    with pytest.raises(ValueError):
        jfaults.FaultPlan.parse(bad)
    with pytest.raises(ValueError):
        FaultPlan.parse(bad)


def test_kinds_and_units_are_the_jax_packages():
    assert faults.KINDS == jfaults.KINDS
    assert faults._DURATION_KINDS == jfaults._DURATION_KINDS
    assert (faults.ENV_PLAN, faults.ENV_ATTEMPT) == (jfaults.ENV_PLAN,
                                                     jfaults.ENV_ATTEMPT)


def test_env_wins_over_config(monkeypatch):
    monkeypatch.setenv(faults.ENV_PLAN, "crash@step:9")
    faults.install_from_env_or_config("kill@step:1;nan_grad@step:4")
    assert faults.nan_grad_step() is None
    with pytest.raises(FaultInjected, match="step 9"):
        faults.on_step(9)
    faults.on_step(1)  # the config-text kill must not be active


def test_attempt_gating(monkeypatch):
    monkeypatch.setenv(faults.ENV_ATTEMPT, "2")
    faults.configure("crash@step:5")          # default attempt 1
    faults.on_step(5)                          # gated off: no raise
    faults.configure("crash@step:5@attempt:2")
    with pytest.raises(FaultInjected):
        faults.on_step(5)
    faults.on_step(5)                          # once per process


def test_slow_host_fires_once_at_its_step():
    faults.configure("slow_host@step:2:200ms")
    t0 = time.perf_counter()
    faults.on_step(1)
    assert time.perf_counter() - t0 < 0.1
    t0 = time.perf_counter()
    faults.on_step(2)
    assert time.perf_counter() - t0 >= 0.2
    t0 = time.perf_counter()
    faults.on_step(2)
    assert time.perf_counter() - t0 < 0.1


def test_loader_raise_in_the_ports_loader():
    faults.configure("loader_raise@batch:2")
    loader = ArrayDataLoader({"x": np.arange(40, dtype=np.float32)},
                             batch_size=4, shuffle=False)
    other = ArrayDataLoader({"x": np.arange(40, dtype=np.float32)},
                            batch_size=4, shuffle=False)
    faults.watch_loader(loader)
    assert len(list(other)) == 10            # not the watched loader
    it = iter(loader)
    next(it), next(it)
    with pytest.raises(FaultInjected, match="batch 2") as ei:
        next(it)
    assert not ei.value.is_checkpoint_fault


def test_ckpt_write_fail_in_the_ports_manager(tmp_path):
    faults.configure("ckpt_write_fail@epoch:2")
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    mgr = CheckpointManager(tmp_path)
    mgr.save(epoch=1, model=model, optimizer=opt, train_state={},
             arch="Linear", config={}, monitor_best=0.0)
    with pytest.raises(FaultInjected) as ei:
        mgr.save(epoch=2, model=model, optimizer=opt, train_state={},
                 arch="Linear", config={}, monitor_best=0.0)
    assert ei.value.is_checkpoint_fault
    assert (tmp_path / "checkpoint-epoch1").is_dir()
    assert not (tmp_path / "checkpoint-epoch2").exists()


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_nan_grad_in_the_ports_step(clip):
    """``nan_grad@step:1``: step 1 is skipped (params bit-identical), its
    health summary counts every gradient element, steps 0 and 2 apply."""
    faults.configure("nan_grad@step:1")
    torch.manual_seed(0)
    model = MODELS.get("TinyLM")(vocab_size=32, d_model=16, max_len=8,
                                 device="cpu")
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    step = steps.make_train_step(
        model, opt, losses.lm_cross_entropy, input_key="tokens",
        target_key="tokens", grad_clip_norm=clip, skip_nonfinite=True,
        health=True, inject_nan_grad_step=faults.nan_grad_step())
    rng = np.random.default_rng(0)
    n = sum(p.numel() for p in model.parameters())
    for i in range(3):
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, 32, (4, 8)).astype(np.int64)),
            "mask": torch.ones(4, dtype=torch.bool)}
        before = [p.detach().clone() for p in model.parameters()]
        m = step(batch)
        same = all(torch.equal(a, p) for a, p in zip(before,
                                                     model.parameters()))
        grads = m["health"][4:].sum().item()
        assert float(m["skipped_sum"]) == (4.0 if i == 1 else 0.0)
        assert same == (i == 1)
        assert grads == (n if i == 1 else 0)
        assert all(torch.isfinite(p).all() for p in model.parameters())
    assert (step.step, step.applied) == (3, 2)
