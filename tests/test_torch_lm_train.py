"""The port's LM training pieces against the JAX package's, on the CPU:
the synthetic LM data and its loader (byte-identical), the losses and
``lm_token_accuracy`` (value and gradient), the weight-decay exemption
sets, and K train steps of AdamW + WarmupCosine + clipping +
``skip_nonfinite`` (one step poisoned with a NaN) against
``make_train_step``.

Inputs come from seeded numpy generators. Tolerances (float32 on both
sides): losses and metrics atol 1e-5; gradients atol 1e-6 + rtol 1e-5;
the train-step trajectory 1e-5 on per-step losses and final params.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_distributed_template_tpu.data  # noqa: F401  (register)
import pytorch_distributed_template_tpu.models  # noqa: F401
from pytorch_distributed_template_tpu.config.registry import (
    LOADERS as JLOADERS, MODELS as JM,
)
from pytorch_distributed_template_tpu.data import datasets as jdata
from pytorch_distributed_template_tpu.engine import losses as jlosses
from pytorch_distributed_template_tpu.engine import metrics as jmetrics
from pytorch_distributed_template_tpu.engine import optim as joptim
from pytorch_distributed_template_tpu.engine import state as jstate
from pytorch_distributed_template_tpu.engine import steps as jsteps
from pytorch_distributed_template_tpu.parallel.sharding import path_str

import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch.config.registry import (
    LOADERS as TLOADERS, MODELS as TM,
)
from pytorch_distributed_template_tpu_torch.data import datasets as tdata
from pytorch_distributed_template_tpu_torch.engine import losses as tlosses
from pytorch_distributed_template_tpu_torch.engine import metrics as tmetrics
from pytorch_distributed_template_tpu_torch.engine import optim as toptim
from pytorch_distributed_template_tpu_torch.engine import steps as tsteps
from pytorch_distributed_template_tpu_torch.models.convert import (
    flax_path, params_from_flax,
)


@pytest.mark.parametrize("training", [True, False])
def test_synthetic_lm_is_byte_identical(training):
    a = jdata.synthetic_lm(n=37, seq_len=19, vocab_size=300, seed=4,
                           training=training)
    b = tdata.synthetic_lm(n=37, seq_len=19, vocab_size=300, seed=4,
                           training=training)
    assert a["tokens"].dtype == b["tokens"].dtype == np.int32
    assert np.array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_order_and_padded_masks_match(shuffle):
    """n = 70 over batches of 32: the last batch is padded by wraparound
    and masked, epoch by epoch in the same permuted order."""
    args = dict(batch_size=32, shuffle=shuffle, n=70, seq_len=8,
                vocab_size=50, seed=3)
    jl = JLOADERS.get("SyntheticLMLoader")(**args)
    tl = TLOADERS.get("SyntheticLMLoader")(**args)
    assert len(jl) == len(tl) == 3
    for epoch in (1, 2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb)
        for x, y in zip(jb, tb):
            assert sorted(x) == sorted(y) == ["mask", "tokens"]
            assert np.array_equal(np.asarray(x["tokens"]), y["tokens"])
            assert np.array_equal(np.asarray(x["mask"]), y["mask"])
        assert tb[-1]["mask"].sum() == 70 - 64


def test_lm_losses_and_accuracy_match_in_value_and_grad():
    rng = np.random.default_rng(0)
    b, t, d, v = 3, 21, 16, 40
    logits = rng.normal(size=(b, t, v)).astype(np.float32)
    h = rng.normal(size=(b, t, d)).astype(np.float32)
    w = rng.normal(size=(d, v)).astype(np.float32)
    toks = rng.integers(0, v, (b, t)).astype(np.int32)
    tt = torch.from_numpy(toks)
    fused_j, fused_t = (jlosses.fused_lm_cross_entropy(8),
                        tlosses.fused_lm_cross_entropy(8))
    cot = rng.normal(size=(b,)).astype(np.float32)

    # plain: value and d/dlogits
    jv, jvjp = jax.vjp(lambda x: jlosses.lm_cross_entropy(x, toks), logits)
    x = torch.from_numpy(logits).requires_grad_()
    tv = tlosses.lm_cross_entropy(x, tt)
    tv.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jvjp(cot)[0]),
                               atol=1e-6, rtol=1e-5)
    # fused (chunk 8 over T - 1 = 20: a padded last chunk): value and
    # d/dh, d/dw
    jv, jvjp = jax.vjp(lambda a, c: fused_j((a, c), toks), h, w)
    xs = [torch.from_numpy(a).requires_grad_() for a in (h, w)]
    tv = fused_t(tuple(xs), tt)
    tv.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               atol=1e-5)
    for got, want in zip(xs, jvjp(cot)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-5)
    # the fused loss equals the plain one on the head's logits
    plain = tlosses.lm_cross_entropy(torch.from_numpy(h @ w), tt)
    torch.testing.assert_close(fused_t(tuple(xs), tt), plain, atol=1e-5,
                               rtol=0)
    # lm_token_accuracy, both forms
    np.testing.assert_allclose(
        tmetrics.lm_token_accuracy(torch.from_numpy(logits), tt).numpy(),
        np.asarray(jmetrics.lm_token_accuracy(logits, toks)), atol=1e-6)
    np.testing.assert_allclose(
        tmetrics.lm_token_accuracy(
            (torch.from_numpy(h), torch.from_numpy(w)), tt).numpy(),
        np.asarray(jmetrics.lm_token_accuracy((h, w), toks)), atol=1e-6)


@pytest.mark.parametrize("name, args, exclude", [
    ("GPT2", dict(size="gpt2-small", vocab_size=64, max_len=16, n_layer=2,
                  d_model=32, n_head=2, tie_embeddings=False),
     ["bias$", "ln_", "wpe"]),
    ("TinyLlama", dict(vocab_size=64, d_model=32, n_head=4, n_kv_head=2,
                       max_len=16), ["layernorm", "norm/weight"]),
])
def test_decay_mask_sets_are_equal(name, args, exclude):
    jm = JM.get(name)(**args)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))[
        "params"]
    mask = joptim._decay_mask(exclude)(params)
    leaves = jax.tree_util.tree_flatten_with_path(mask)[0]
    want = {path_str(p) for p, decayed in leaves if not decayed}
    assert want and len(want) < len(leaves)
    tm = TM.get(name)(**args, device="cpu")
    groups = toptim.decay_groups(tm, 0.1, exclude)
    names = {id(p): n for n, p in tm.named_parameters()}
    exempt = {flax_path(names[id(p)]) for p in groups[1]["params"]}
    decayed = {flax_path(names[id(p)]) for p in groups[0]["params"]}
    assert exempt == want
    assert decayed | exempt == {path_str(p) for p, _ in leaves}
    assert groups[1]["weight_decay"] == 0.0


STEP_CFG = {
    "optimizer": {"type": "AdamW", "args": {
        "lr": 0.01, "betas": [0.9, 0.95], "weight_decay": 0.1,
        "weight_decay_exclude": ["bias$", "ln_", "wpe"]}},
    "lr_scheduler": {"type": "WarmupCosine",
                     "args": {"warmup_epochs": 2, "total_epochs": 5}},
}
MODEL = dict(vocab_size=64, n_layer=2, n_head=2, d_model=32, max_len=16,
             attn_impl="xla")


class _Poison:
    """A criterion that turns the loss of one chosen step into NaN (the
    same Python flag drives both packages' eager steps)."""

    def __init__(self, base):
        self.base, self.on = base, False
        self.__name__ = "poisoned"

    def __call__(self, output, target):
        per_ex = self.base(output, target)
        return per_ex + float("nan") if self.on else per_ex


def test_train_steps_match_make_train_step():
    """8 steps, 2 per epoch of the schedule (so the warmup and the cosine
    both move the lr), clipping at 0.05 (active), a padded batch, and a NaN
    at step 3 that ``skip_nonfinite`` must skip on both sides: per-step
    losses, the skipped counts and the final params agree."""
    rng = np.random.default_rng(7)
    batches = []
    for i in range(8):
        mask = np.ones(8, bool)
        if i == 5:
            mask[6:] = False
        batches.append({"tokens": rng.integers(0, 64, (8, 16)).astype(
            np.int32), "mask": mask})
    jmodel = JM.get("TinyLM")(**MODEL)
    tx, _, _ = joptim.build_optimizer(STEP_CFG, steps_per_epoch=2)
    state = jstate.create_train_state(jmodel, tx,
                                      jnp.zeros((1, 16), jnp.int32))
    tmodel = TM.get("TinyLM")(**MODEL, device="cpu")
    tmodel.load_state_dict(params_from_flax(jax.device_get(state.params)))
    opt, lr_fn = toptim.build_optimizer(STEP_CFG, 2, tmodel)
    jcrit = _Poison(jlosses.lm_cross_entropy)
    tcrit = _Poison(tlosses.lm_cross_entropy)
    kw = dict(input_key="tokens", target_key="tokens", grad_clip_norm=0.05,
              skip_nonfinite=True)
    jstep = jsteps.make_train_step(jmodel, tx, jcrit, **kw)
    tstep = tsteps.make_train_step(tmodel, opt, tcrit, lr_fn=lr_fn, **kw)
    for i, batch in enumerate(batches):
        jcrit.on = tcrit.on = i == 3
        state, jm = jstep(state, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
        tm = tstep({k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(tm["skipped_sum"]) == float(jm["skipped_sum"]) == (
            8.0 if i == 3 else 0.0)
        assert float(tm["count"]) == float(jm["count"])
        np.testing.assert_allclose(float(tm["loss_sum"]),
                                   float(jm["loss_sum"]), atol=1e-5,
                                   rtol=1e-5)
    assert (tstep.step, tstep.applied) == (8, 7)
    want = params_from_flax(jax.device_get(state.params))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_schedule_is_epoch_indexed_from_zero():
    model = TM.get("TinyLM")(**MODEL, device="cpu")
    _, lr_fn = toptim.build_optimizer(STEP_CFG, 4, model)
    _, jlr, _ = joptim.build_optimizer(STEP_CFG, steps_per_epoch=4)
    for step in range(24):
        np.testing.assert_allclose(lr_fn(step), float(jlr(step)),
                                   rtol=1e-6)
    assert lr_fn(0) == pytest.approx(0.01 / 2)   # the first epoch: base/2
    cfg = dict(STEP_CFG, lr_scheduler=dict(STEP_CFG["lr_scheduler"],
                                           unit="step"))
    _, lr_fn = toptim.build_optimizer(cfg, 4, model)
    _, jlr, _ = joptim.build_optimizer(cfg, steps_per_epoch=4)
    for step in range(8):
        np.testing.assert_allclose(lr_fn(step), float(jlr(step)),
                                   rtol=1e-6)


@pytest.mark.parametrize("kind, name", [
    ("optimizer", "RMSprop"), ("optimizer", "Lion"),
    ("lr_scheduler", "ReduceLROnPlateau"), ("optimizer", "Adafactor")])
def test_later_optimizers_and_schedules_refuse(kind, name):
    cfg = {"optimizer": {"type": "AdamW", "args": {"lr": 0.1}}}
    cfg[kind] = {"type": name, "args": {}}
    model = TM.get("TinyLM")(**MODEL, device="cpu")
    with pytest.raises(NotImplementedError, match="A17"):
        toptim.build_optimizer(cfg, 4, model)
