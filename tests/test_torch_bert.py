"""The port's BERT family (``models/bert.py``) against the JAX package's
flax modules on the CPU, float32, with the same numpy inputs and the
converted params (``models/convert.py``):

- attention is bidirectional: a change of the last token moves the first
  position's output (the JAX package's ``test_attention_is_bidirectional``),
  which the port's ``causal`` flag on ``SelfAttention``/``Block`` gives;
- ``BertMLM`` and ``BertClassifier`` logits equal flax's (atol 1e-5): in
  eval mode (the every-7th mask) and in train mode with JAX's own draws
  (``sel``, ``mix``, ``rand_tok``, recorded from the flax module) fed to
  the port's apply, whose corrupted tokens equal JAX's exactly;
- ``mlm_cross_entropy``, ``mlm_accuracy`` and the gradients equal the JAX
  package's and ``jax.grad``'s (rtol 1e-5; gradients atol 1e-5 x the
  leaf's largest |grad| + 1e-7), with a row that has no masked position;
- ``attn_impl "flash"`` equals ``"xla"`` through the plain versions;
- the param tree round-trips flax -> port -> flax, the ``encoder`` scope
  and ``classifier_head`` included; the seeded eval draws and the train
  draws keep a data shard's rows of the global batch.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_template_tpu.engine import losses as jlosses
from pytorch_distributed_template_tpu.engine import metrics as jmetrics
from pytorch_distributed_template_tpu.models import bert as jbert

from pytorch_distributed_template_tpu_torch.engine import losses, metrics
from pytorch_distributed_template_tpu_torch.models import bert, convert

ARGS = dict(vocab_size=64, n_layer=2, n_head=4, d_model=32, max_len=24,
            dropout=0.0)
B, T = 4, 24


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(
        0, ARGS["vocab_size"] - 1, (B, T)).astype(np.int32)


def _pair(kind="mlm", **kw):
    args = dict(ARGS, **kw)
    if kind == "mlm":
        jm, tm = jbert.bert_mlm(**args), bert.bert_mlm(**args)
    else:
        jm = jbert.bert_classifier(num_classes=3, **args)
        tm = bert.bert_classifier(num_classes=3, **args)
    v = jax.device_get(jm.init(jax.random.PRNGKey(1),
                               jnp.asarray(_tokens())))
    tm.load_state_dict(convert.params_from_flax(v["params"]))
    return jm, tm, v


class _Recorder:
    """Stands in for the ``jax`` name of the JAX bert module: records the
    draws of ``bernoulli``, ``uniform`` and ``randint``, or hands out the
    given ones instead."""

    def __init__(self, given=None):
        self.given, self.seen = given, {}
        real = jax.random

        def wrap(name, fn):
            def call(*a, **kw):
                out = fn(*a, **kw)
                if self.given is not None:
                    out = jnp.asarray(self.given[name])
                self.seen[name] = np.asarray(out)
                return out
            return call

        self.random = types.SimpleNamespace(
            split=real.split, fold_in=real.fold_in,
            bernoulli=wrap("sel", real.bernoulli),
            uniform=wrap("mix", real.uniform),
            randint=wrap("rand_tok", real.randint))


def test_attention_is_bidirectional():
    jm, tm, v = _pair()
    x = _tokens()
    y = x.copy()
    y[:, -1] = (y[:, -1] + 1) % (ARGS["vocab_size"] - 1)
    tm.eval()
    for m in (tm.encoder,):
        a, b = m(torch.from_numpy(x)), m(torch.from_numpy(y))
        assert (a[:, 0] - b[:, 0]).abs().max() > 1e-6
    # the causal default of the GPT-2 block leaves position 0 alone
    from pytorch_distributed_template_tpu_torch.models.transformer import (
        Block,
    )

    blk = Block(32, 4, 64, 0.0, torch.float32, "xla", 1e-5)
    h = torch.randn(1, 6, 32)
    h2 = h.clone()
    h2[:, -1] += 1.0
    assert torch.equal(blk(h)[0][:, 0], blk(h2)[0][:, 0])
    bi = Block(32, 4, 64, 0.0, torch.float32, "xla", 1e-5, causal=False)
    bi.load_state_dict(blk.state_dict())
    assert not torch.equal(bi(h)[0][:, 0], bi(h2)[0][:, 0])


@pytest.mark.parametrize("kind", ["mlm", "cls"])
def test_eval_logits_equal_flax(kind):
    jm, tm, v = _pair(kind)
    x = _tokens(1)
    want = jm.apply(v, jnp.asarray(x), train=False)
    tm.eval()
    got = tm(torch.from_numpy(x))
    if kind == "mlm":
        (want, jsel), (got, sel) = want, got
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
        assert sel[0].sum() == len(range(3, T, 7))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


def test_train_logits_on_jax_draws_equal_flax(monkeypatch):
    jm, tm, v = _pair()
    x = _tokens(2)
    rec = _Recorder()
    monkeypatch.setattr(jbert, "jax", rec)
    want, jsel = jm.apply(v, jnp.asarray(x), train=True,
                          rngs={"dropout": jax.random.PRNGKey(5)})
    draws = {k: torch.from_numpy(np.asarray(a)) for k, a in rec.seen.items()}
    # the corruption alone, exact: JAX's rule written out on its draws
    mask_id = ARGS["vocab_size"] - 1
    sel, mix, rt = rec.seen["sel"], rec.seen["mix"], rec.seen["rand_tok"]
    rt = rt + (rt >= mask_id)
    jcor = np.where(sel & (mix < 0.8), mask_id,
                    np.where(sel & (mix >= 0.9), rt, x))
    got_cor = bert.corrupt(torch.from_numpy(x), draws["sel"], draws["mix"],
                           draws["rand_tok"], mask_id)
    np.testing.assert_array_equal(got_cor.numpy(), jcor)
    assert (jcor == mask_id).any() and (jcor != x).sum() > (jcor ==
                                                            mask_id).sum()
    tm.train()
    got, tsel = tm(torch.from_numpy(x), mask_draws=draws)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


def test_loss_metric_and_grads_equal_jax(monkeypatch):
    jm, tm, v = _pair()
    x = _tokens(3)
    rng = np.random.default_rng(4)
    given = {"sel": rng.random((B, T)) < 0.3,
             "mix": rng.random((B, T), dtype=np.float32),
             "rand_tok": rng.integers(0, ARGS["vocab_size"] - 1, (B, T))}
    given["sel"][1] = False             # a row with no masked position
    monkeypatch.setattr(jbert, "jax", _Recorder(given))
    key = {"dropout": jax.random.PRNGKey(0)}

    def jloss(params):
        out = jm.apply({"params": params}, jnp.asarray(x), train=True,
                       rngs=key)
        return jlosses.mlm_cross_entropy(out, jnp.asarray(x)).mean(), out

    (want, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        v["params"])
    tm.train()
    out = tm(torch.from_numpy(x), mask_draws={
        k: torch.from_numpy(np.asarray(a)) for k, a in given.items()})
    per = losses.mlm_cross_entropy(out, torch.from_numpy(x))
    assert per[1] == 0.0
    np.testing.assert_allclose(
        per.detach().numpy(),
        np.asarray(jlosses.mlm_cross_entropy(jout, jnp.asarray(x))),
        rtol=1e-5)
    per.mean().backward()
    np.testing.assert_allclose(float(per.mean()), float(want), rtol=1e-5)
    np.testing.assert_allclose(
        metrics.mlm_accuracy(out, torch.from_numpy(x)).numpy(),
        np.asarray(jmetrics.mlm_accuracy(jout, jnp.asarray(x))), rtol=1e-6)
    ref = convert.params_from_flax(jax.device_get(jgrads))
    for name, p in tm.named_parameters():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r,
                                   atol=1e-5 * np.abs(r).max() + 1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["mlm", "cls"])
def test_flash_equals_xla_through_the_plain_versions(kind):
    _, xla, _ = _pair(kind)
    _, fl, _ = _pair(kind, attn_impl="flash")
    x = torch.from_numpy(_tokens(5))
    xla.eval()
    fl.eval()
    a, b = xla(x), fl(x)
    if kind == "mlm":
        a, b = a[0], b[0]
    np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["mlm", "cls"])
def test_param_tree_round_trips(kind):
    _, tm, v = _pair(kind)
    back = convert.flax_from_params(tm.state_dict())
    want = jax.device_get(v["params"])
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    paths = {convert.flax_path(n) for n, _ in tm.named_parameters()}
    assert "encoder/wpe" in paths and "encoder/wte/embedding" in paths
    assert ("classifier_head/kernel" in paths) == (kind == "cls")


def test_draws_keep_a_shards_rows_of_the_global_batch():
    m = bert.bert_mlm(**ARGS)
    x = torch.zeros(6, T, dtype=torch.long)
    whole = m.mask_draws(9, x)
    ev = m.eval_draws(9, x)
    for index in range(3):
        part = m.mask_draws(9, x[index::3], (index, 3))
        for k in whole:
            assert torch.equal(part[k], whole[k][index::3]), k
        assert torch.equal(m.eval_draws(9, x[index::3], (index, 3))["sel"],
                           ev["sel"][index::3])
    assert not torch.equal(m.mask_draws(10, x)["sel"], whole["sel"])
    assert int(whole["rand_tok"].max()) < ARGS["vocab_size"] - 1
    with pytest.raises(ValueError, match="mask_draws"):
        m.train()(x)
    with pytest.raises(NotImplementedError, match="A12b"):
        bert.bert_mlm(**dict(ARGS, attn_impl="ring"))
