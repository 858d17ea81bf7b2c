"""The port's ``observability/health.py`` against the JAX package's.

- ``EwmaDetector`` and ``HealthMonitor`` fed the same series give the same
  z-scores, fire at the same steps with the same reasons, and respect the
  same cooldown and dump cap (the dumps' reasons, summaries and detector
  states equal).
- The packed summary of one train step of a small TinyLM (the JAX params
  loaded with ``params_from_flax``) equals the JAX step's
  ``pack_health_summary`` output to rtol 1e-5 (float32 on both sides; the
  port's update norm is ``p_new - p_old`` in float32), on a clean step and
  on a ``nan_grad`` step, with the same layout (group keys in the same
  order) and the same counts, with and without ``skip_nonfinite``; and
  when only one group's gradient is NaN, with and without clipping, the
  counts name that group alone (they are taken before the clip, whose NaN
  scale would poison every group).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_distributed_template_tpu.models  # noqa: F401
from pytorch_distributed_template_tpu.config.registry import MODELS as JM
from pytorch_distributed_template_tpu.engine import losses as jlosses
from pytorch_distributed_template_tpu.engine import optim as joptim
from pytorch_distributed_template_tpu.engine import state as jstate
from pytorch_distributed_template_tpu.engine import steps as jsteps
from pytorch_distributed_template_tpu.observability import health as jhealth

import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TM,
)
from pytorch_distributed_template_tpu_torch.engine import losses as tlosses
from pytorch_distributed_template_tpu_torch.engine import optim as toptim
from pytorch_distributed_template_tpu_torch.engine import steps as tsteps
from pytorch_distributed_template_tpu_torch.models.convert import (
    params_from_flax,
)
from pytorch_distributed_template_tpu_torch.observability import health

STEP_CFG = {
    "optimizer": {"type": "AdamW", "args": {
        "lr": 0.01, "betas": [0.9, 0.95], "weight_decay": 0.1,
        "weight_decay_exclude": ["bias$", "ln_", "wpe"]}},
}
MODEL = dict(vocab_size=64, n_layer=2, n_head=2, d_model=32, max_len=16,
             attn_impl="xla")
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_counters():
    jhealth.reset_counters()
    health.reset_counters()
    yield
    jhealth.reset_counters()
    health.reset_counters()


def _series(seed=0, n=120):
    rng = np.random.default_rng(seed)
    loss = 3.0 - np.linspace(0, 1, n) + rng.normal(0, 0.02, n)
    gnorm = 1.0 + rng.normal(0, 0.1, n)
    loss[40] = 30.0          # soft: loss z-score
    gnorm[60] = 80.0         # soft: grad-norm explosion
    loss[70] = np.nan        # hard: non-finite loss
    gnorm[71] = np.inf       # hard: non-finite norm
    out = []
    for i in range(n):
        s = {"loss": float(loss[i]), "grad_norm": float(gnorm[i]),
             "update_norm": 0.01, "nonfinite_params": 0.0,
             "nonfinite/h_0": 0.0, "nonfinite/wte": 0.0,
             "nonfinite_grads": 0.0}
        if i in (90, 91, 100):   # hard: counts, inside the cooldown
            s["nonfinite/h_0"] = s["nonfinite_grads"] = 12.0
        out.append(s)
    return out


@pytest.mark.parametrize("one_sided", [True, False])
def test_ewma_detector_matches(one_sided):
    rng = np.random.default_rng(3)
    xs = list(rng.normal(2.0, 0.3, 80)) + [float("nan"), 40.0, 0.1, None]
    a = jhealth.EwmaDetector(0.1, 10, one_sided=one_sided)
    b = health.EwmaDetector(0.1, 10, one_sided=one_sided)
    for x in xs:
        za, zb = a.update(x), b.update(x)
        assert (za is None) == (zb is None)
        if za is not None:
            assert za == zb
    assert a.state() == b.state()


@pytest.mark.parametrize("cfg", [
    {"warmup_steps": 10, "cooldown_steps": 25, "max_dumps": 8},
    {"warmup_steps": 5, "cooldown_steps": 0, "max_dumps": 2,
     "z_threshold": 4.0, "pause_best_promotion": True},
    {"enabled": False},
])
def test_monitor_fires_like_the_jax_monitor(cfg, tmp_path):
    mons = {name: mod.HealthMonitor(cfg, log_dir=tmp_path / name)
            for name, mod in (("jax", jhealth), ("port", health))}
    fired = {"jax": [], "port": []}
    for step, s in enumerate(_series()):
        for name, mon in mons.items():
            out = mon.observe(step, dict(s), meta={"epoch": 1})
            if out is not None:
                fired[name].append(
                    (step, [r["kind"] for r in out["reasons"]]))
    assert fired["jax"] == fired["port"]
    assert bool(fired["port"]) == cfg.get("enabled", True)
    jd = sorted(p.name for p in (tmp_path / "jax").glob("*.json")) \
        if (tmp_path / "jax").exists() else []
    td = sorted(p.name for p in (tmp_path / "port").glob("*.json")) \
        if (tmp_path / "port").exists() else []
    assert jd == td
    for name in td:
        a = json.loads((tmp_path / "jax" / name).read_text())
        b = json.loads((tmp_path / "port" / name).read_text())
        for key in ("step", "reasons", "summary", "zscores", "detector",
                    "config", "epoch"):
            assert a[key] == b[key], key
    assert mons["jax"].promotion_allowed() == \
        mons["port"].promotion_allowed()
    assert jhealth.health_counters() == health.health_counters()


def test_layout_groups_are_the_flax_top_level_keys():
    jm = JM.get("GPT2")(size="gpt2-small", vocab_size=64, max_len=16,
                        n_layer=12, d_model=32, n_head=2)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))[
        "params"]
    tm = TM.get("GPT2")(size="gpt2-small", vocab_size=64, max_len=16,
                        n_layer=12, d_model=32, n_head=2, device="cpu")
    groups = health.parameter_groups(tm)
    assert health.health_layout(groups) == jhealth.health_layout(params)
    assert "nonfinite/h_10" in health.health_layout(groups)


@jax.custom_vjp
def _nan_cotangent(x):
    return x


_nan_cotangent.defvjp(lambda x: (x, None),
                      lambda _, g: (jnp.full_like(g, jnp.nan),))


class _NanGradGroup:
    """The JAX model with one top-level group's gradient NaN: its params
    go through an identity whose cotangent is NaN."""

    def __init__(self, model, group):
        self.model, self.group = model, group

    def __getattr__(self, name):
        return getattr(self.model, name)

    def apply(self, variables, *args, **kw):
        params = dict(variables["params"])
        params[self.group] = jax.tree.map(_nan_cotangent,
                                          params[self.group])
        return self.model.apply(dict(variables, params=params), *args, **kw)


def _steps(skip, nan_step=None, nan_group=None, clip=0.05):
    """Three steps of the JAX and the port's train step on the same
    batches; ``nan_group``'s gradient is NaN at step 1."""
    rng = np.random.default_rng(7)
    batches = [{"tokens": rng.integers(0, 64, (8, 16)).astype(np.int32),
                "mask": np.ones(8, bool)} for _ in range(3)]
    jmodel = JM.get("TinyLM")(**MODEL)
    tx, _, _ = joptim.build_optimizer(STEP_CFG, steps_per_epoch=2)
    state = jstate.create_train_state(jmodel, tx,
                                      jnp.zeros((1, 16), jnp.int32))
    layout = jhealth.health_layout(state.params)
    tmodel = TM.get("TinyLM")(**MODEL, device="cpu")
    tmodel.load_state_dict(params_from_flax(jax.device_get(state.params)))
    opt, lr_fn, _ = toptim.build_optimizer(STEP_CFG, 2, tmodel)
    kw = dict(input_key="tokens", target_key="tokens", grad_clip_norm=clip,
              skip_nonfinite=skip, health=True,
              inject_nan_grad_step=nan_step)
    jstep = jax.jit(jsteps.make_train_step(
        jmodel, tx, jlosses.lm_cross_entropy, **kw))
    jsteps_by_index = [jstep] * len(batches)
    if nan_group is not None:
        jsteps_by_index[1] = jax.jit(jsteps.make_train_step(
            _NanGradGroup(jmodel, nan_group), tx, jlosses.lm_cross_entropy,
            **kw))
    tstep = tsteps.make_train_step(tmodel, opt, tlosses.lm_cross_entropy,
                                   lr_fn=lr_fn, **kw)
    assert health.health_layout(tstep._groups) == layout
    if nan_group is not None:
        for p in tstep._groups[nan_group]:
            p.register_hook(lambda g: torch.full_like(g, float("nan"))
                            if tstep.step == 1 else g)
    out = []
    for batch, step in zip(batches, jsteps_by_index):
        state, jm = step(state, {k: jnp.asarray(v)
                                 for k, v in batch.items()})
        tm = tstep({k: torch.from_numpy(v) for k, v in batch.items()})
        out.append((np.asarray(jm["health"]), tm["health"].numpy()))
    return layout, out


def _assert_equal_summaries(out):
    for i, (want, got) in enumerate(out):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0,
                                   err_msg=f"step {i}")


@pytest.mark.parametrize("skip", [True, False])
def test_packed_summary_matches_pack_health_summary(skip):
    layout, out = _steps(skip, nan_step=1)
    assert [k for k in layout if k.startswith("nonfinite/")] == [
        f"nonfinite/{g}" for g in ("h_0", "h_1", "ln_f", "wpe", "wte")]
    _assert_equal_summaries(out)
    clean = health.unpack_health_summary(out[0][1], layout)
    assert clean["nonfinite_grads"] == 0
    assert np.isfinite(clean["grad_norm"])
    poisoned = health.unpack_health_summary(out[1][1], layout)
    assert not np.isfinite(poisoned["grad_norm"])
    assert poisoned["nonfinite_grads"] == sum(
        v for k, v in poisoned.items() if k.startswith("nonfinite/"))
    assert all(poisoned[f"nonfinite/{g}"] > 0
               for g in ("h_0", "h_1", "ln_f"))
    assert (poisoned["nonfinite_params"] == 0) == skip


@pytest.mark.parametrize("skip, clip", [(False, 0.05), (False, 0.0),
                                        (True, 0.05), (True, 0.0)])
def test_one_nan_group_is_counted_alone(skip, clip):
    """Only ``ln_f``'s gradient is NaN (at step 1): the counts name
    ``ln_f`` alone,
    equal to the JAX step's, even where the NaN global norm then makes
    the clip poison every group's gradient and the update."""
    layout, out = _steps(skip, nan_group="ln_f", clip=clip)
    _assert_equal_summaries(out)
    tmodel = TM.get("TinyLM")(**MODEL, device="cpu")
    ln_f = sum(p.numel() for p in health.parameter_groups(tmodel)["ln_f"])
    clean = health.unpack_health_summary(out[0][1], layout)
    assert clean["nonfinite_grads"] == 0
    bad = health.unpack_health_summary(out[1][1], layout)
    assert {k: v for k, v in bad.items() if k.startswith("nonfinite/")
            and v} == {"nonfinite/ln_f": ln_f}
    assert not np.isfinite(bad["grad_norm"])
    # unclipped, only ln_f's own update is NaN; clipped, every update is
    params = sum(p.numel() for p in tmodel.parameters())
    assert bad["nonfinite_params"] == (
        0 if skip else params if clip else ln_f)


def test_deferred_fetch_on_the_cpu():
    t = {"a": torch.tensor([1.0, 2.0]), "b": torch.tensor(3.0)}
    got = health.DeferredFetch(t).get()
    assert got["a"].tolist() == [1.0, 2.0] and float(got["b"]) == 3.0
    mon = health.HealthMonitor({"warmup_steps": 0},
                               layout=["loss", "grad_norm"])
    mon.enqueue(0, health.DeferredFetch(
        {"health": torch.tensor([1.0, float("nan")])}))
    assert mon.anomalies == 0                  # observed one step later
    mon.drain()
    assert mon.anomalies == 1 and mon.last_anomaly_step == 0
