"""The port's ResNet (``models/resnet.py``) and its layers
(``models/layers.py``: ``BatchNorm``, ``SameConv2d``, ``max_pool_same``)
against the JAX package's flax modules, in float32 on the CPU.

The flax params and ``batch_stats`` (perturbed away from their init, so
that every scale, bias and running average matters) go into the port
through ``models/convert.py``. Held, each at the stated tolerance:

- train-mode log-probabilities (atol 5e-5) and the mutated
  ``batch_stats`` (atol 1e-5), back through ``flax_batch_stats`` with
  flax's tree;
- the gradients of a fixed linear function of the train-mode output
  with respect to every param (atol 1e-4 x the leaf's largest |grad|
  + 1e-6): the port's BatchNorm has its own backward;
- eval-mode log-probabilities on the running averages (atol 5e-5);

for ResNet-18 with the CIFAR stem, ResNet-50's bottleneck blocks with the
ImageNet stem at reduced ``num_filters`` (through the class, as the
factory has no such argument) on even and odd inputs, and
``space_to_depth``. The ``SAME`` pads are pinned at even and odd sizes
(3x3/2 on 112 pads (0, 1); the 7x7/2 conv on 224 (2, 3); 4x4/1 (1, 2)),
and the conv and pool equal flax's there (atol 1e-5; the pool exactly).
"""
import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from pytorch_distributed_template_tpu.models import resnet as jres
from pytorch_distributed_template_tpu_torch.config.registry import MODELS
from pytorch_distributed_template_tpu_torch.models import (
    convert, layers, resnet as tres,
)
from pytorch_distributed_template_tpu_torch.observability.health import (
    parameter_groups,
)

torch.set_num_threads(1)

CASES = {
    "resnet18_cifar": ((2, 2, 2, 2), "BasicBlock", dict(cifar_stem=True),
                       (32, 32, 3), 16),
    "resnet50_imagenet": ((3, 4, 6, 3), "BottleneckBlock", {}, (32, 32, 3),
                          8),
    "resnet50_imagenet_odd": ((1, 1, 1, 1), "BottleneckBlock", {},
                              (35, 33, 3), 8),
    "space_to_depth": ((1, 1, 1, 1), "BottleneckBlock",
                       dict(space_to_depth=True), (32, 32, 3), 8),
}


def _perturb(tree, seed, scale=0.1, positive=False):
    rng = np.random.default_rng(seed)

    def f(a):
        b = np.asarray(a) + scale * rng.normal(size=a.shape).astype(
            np.float32)
        return np.abs(b) if positive else b

    return jax.tree.map(f, tree)


def _pair(name):
    stages, block, kw, shape, filters = CASES[name]
    jm = jres.ResNet(stage_sizes=stages, block_cls=getattr(jres, block),
                     num_classes=10, num_filters=filters, input_shape=shape,
                     **kw)
    x = np.random.default_rng(1).normal(size=(4,) + shape).astype(
        np.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    params = _perturb(v["params"], 2)
    stats = _perturb(v["batch_stats"], 3, positive=True)
    tm = tres.ResNet(stages, getattr(tres, block), num_classes=10,
                     num_filters=filters, input_shape=shape, **kw)
    state = convert.params_from_flax(params)
    state.update(convert.batch_stats_from_flax(stats))
    tm.load_state_dict(state)
    return jm, tm, params, stats, state, x


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_mode_logits_stats_and_grads_match_flax(name):
    jm, tm, params, stats, _, x = _pair(name)
    w = np.random.default_rng(4).normal(size=(4, 10)).astype(np.float32)

    def loss(p):
        out, mut = jm.apply({"params": p, "batch_stats": stats},
                            jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mut["batch_stats"])

    (_, (want, new_stats)), jgrads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    tm.train()
    out = tm(torch.from_numpy(x))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=5e-5)
    got_stats = convert.flax_batch_stats(tm.state_dict())
    assert (jax.tree.structure(got_stats)
            == jax.tree.structure(jax.device_get(new_stats)))
    for a, b in zip(jax.tree.leaves(got_stats),
                    jax.tree.leaves(jax.device_get(new_stats))):
        np.testing.assert_allclose(a, b, atol=1e-5)
    want_grads = convert.params_from_flax(jax.device_get(jgrads))
    for pname, p in tm.named_parameters():
        ref = want_grads[pname].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), ref, atol=1e-4 * np.abs(ref).max() + 1e-6,
            err_msg=pname)


@pytest.mark.parametrize("name", sorted(CASES))
def test_eval_mode_uses_the_running_averages(name):
    jm, tm, params, stats, _, x = _pair(name)
    want = jm.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(x), train=False)
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_params_round_trip_and_health_groups_are_flax_top_level_keys():
    jm, tm, params, stats, state, _ = _pair("resnet18_cifar")
    back = convert.flax_from_params(tm.state_dict())
    assert (jax.tree.structure(back)
            == jax.tree.structure(jax.device_get(params)))
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(jax.device_get(params))):
        np.testing.assert_array_equal(a, b)
    assert sorted(parameter_groups(tm)) == sorted(params)
    assert "conv_init" in params and "BasicBlock_7" in params
    assert set(params["BasicBlock_2"]) == {
        "Conv_0", "BatchNorm_0", "Conv_1", "BatchNorm_1", "conv_proj",
        "norm_proj"}
    # the JAX module's ImageNet stem has no conv: bn_init on the pixels
    _, _, p50, _, _, _ = _pair("resnet50_imagenet")
    assert "conv_init" not in p50 and p50["bn_init"]["scale"].shape == (3,)


@pytest.mark.parametrize("size,k,s,want", [
    (112, 3, 2, (0, 1)), (113, 3, 2, (1, 1)), (224, 7, 2, (2, 3)),
    (225, 7, 2, (3, 3)), (56, 4, 1, (1, 2)), (32, 3, 1, (1, 1)),
    (56, 1, 2, (0, 0)), (57, 1, 2, (0, 0)), (112, 3, 2, (0, 1)),
])
def test_same_pads_pinned(size, k, s, want):
    assert layers.same_pads(size, k, s) == want


@pytest.mark.parametrize("size,k,s", [(16, 7, 2), (17, 7, 2), (12, 3, 2),
                                      (13, 3, 2), (10, 4, 1), (9, 1, 2)])
def test_same_conv_and_pool_equal_flax(size, k, s):
    rng = np.random.default_rng(size * 10 + k)
    x = rng.normal(size=(2, size, size + 1, 3)).astype(np.float32)
    conv = fnn.Conv(5, (k, k), (s, s), use_bias=False)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(v, jnp.asarray(x)))
    tconv = layers.SameConv2d(3, 5, k, s)
    tconv.load_state_dict(
        {"weight": convert.params_from_flax({"c": v["params"]})["c.weight"]})
    got = tconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    pooled = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                     padding="SAME"))
    tp = layers.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2)
    np.testing.assert_array_equal(tp.permute(0, 2, 3, 1).numpy(), pooled)


def test_factories_and_their_checks():
    for name in ("ResNet18", "ResNet34", "ResNet50", "ResNet101",
                 "ResNet152"):
        assert MODELS.get(name) is not None
    with pytest.raises(ValueError, match="space_to_depth"):
        MODELS.get("ResNet18")(cifar_stem=True, space_to_depth=True)
    m = MODELS.get("ResNet50")(num_classes=10, space_to_depth=True)
    with pytest.raises(ValueError, match="even spatial"):
        m(torch.zeros(1, 33, 32, 3))
    with pytest.raises(ValueError, match="float32 params"):
        MODELS.get("ResNet18")(param_dtype=torch.bfloat16)
    r18 = MODELS.get("ResNet18")(num_classes=10, cifar_stem=True)
    assert r18.input_shape == (32, 32, 3)
    assert sum(p.numel() for p in r18.parameters()) == 11_173_962
    # zero-gamma: every residual branch's last norm starts at scale 0
    r18.init_weights(torch.Generator().manual_seed(0))
    for block in r18.blocks():
        assert torch.equal(block.BatchNorm_1.weight,
                           torch.zeros_like(block.BatchNorm_1.weight))
        assert torch.equal(block.BatchNorm_0.weight,
                           torch.ones_like(block.BatchNorm_0.weight))


def test_flops_per_example_counts_every_conv():
    """2 k² C_in C_out H_out W_out per conv, counted by forward hooks on
    a real forward, plus the head."""
    for kw, shape in ((dict(cifar_stem=True), (32, 32, 3)),
                      ({}, (64, 64, 3)),
                      (dict(space_to_depth=True), (64, 64, 3))):
        model = tres.ResNet((1, 1, 1, 1), tres.BottleneckBlock,
                            num_classes=7, num_filters=8, input_shape=shape,
                            **kw)
        seen = []

        def hook(mod, inp, out):
            k = mod.kernel_size[0]
            seen.append(2.0 * k * k * mod.in_channels * mod.out_channels
                        * out.shape[2] * out.shape[3])

        for mod in model.modules():
            if isinstance(mod, torch.nn.Conv2d):
                mod.register_forward_hook(hook)
        model.eval()
        with torch.no_grad():
            model(torch.zeros((1,) + shape))
        head = 2.0 * model.head.in_features * 7
        assert model.flops_per_example() == pytest.approx(sum(seen) + head)
