"""The port's ViT (``models/vit.py``) against the JAX package's flax
module, in float32 on the CPU, from the same params
(``models/convert.py``; perturbed away from the init, whose head is 0).

Held: the log-probabilities with ``pool`` ``"cls"`` and ``"mean"``, with
``remat`` (and the gradients of a fixed linear function of the output
with respect to every param, atol 1e-5 x the leaf's largest |grad| +
1e-7), with ``attn_impl "xla"`` against JAX's einsum attention and
``"flash"`` (the port's plain flash version on the CPU) against JAX's
flash (its Pallas kernel in interpret mode) at a ragged token count (40
px, patch 8: 25 patches + cls = 26 tokens); atol 2e-5 on the outputs.
The port's dropout masks are redrawn identically under remat, and the
model FLOP count is taken on the cls-token sequence (197 tokens at 224 px,
patch 16).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_template_tpu_torch.config.registry import MODELS
from pytorch_distributed_template_tpu_torch.models import convert
from pytorch_distributed_template_tpu_torch.observability import profiler

jvit = importlib.import_module("pytorch_distributed_template_tpu.models.vit")
tvit = importlib.import_module(
    "pytorch_distributed_template_tpu_torch.models.vit")

torch.set_num_threads(1)
ARCH = dict(num_classes=10, n_layer=2, n_head=2, d_model=64)


def _pair(pool, attn_impl, remat=False, image=32, patch=8):
    jm = jvit.ViT(image_size=image, patch_size=patch, pool=pool,
                  attn_impl=attn_impl, remat=remat, **ARCH)
    x = np.random.default_rng(0).normal(size=(3, image, image, 3)).astype(
        np.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(
            np.float32), v["params"])
    tm = tvit.ViT(image_size=image, patch_size=patch, pool=pool,
                  attn_impl=attn_impl, remat=remat, **ARCH)
    tm.load_state_dict(convert.params_from_flax(params))
    return jm, tm, params, x


@pytest.mark.parametrize("pool,attn_impl,remat,image", [
    ("cls", "xla", False, 32), ("mean", "xla", False, 32),
    ("cls", "xla", True, 32), ("cls", "flash", False, 40),
    ("mean", "flash", True, 40)])
def test_logits_and_grads_match_flax(pool, attn_impl, remat, image):
    jm, tm, params, x = _pair(pool, attn_impl, remat, image)
    w = np.random.default_rng(2).normal(size=(3, 10)).astype(np.float32)

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), train=True)
        return jnp.sum(out * w), out

    (_, want), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    tm.train()
    out = tm(torch.from_numpy(x))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=2e-5)
    ref = convert.params_from_flax(jax.device_get(jgrads))
    for name, p in tm.named_parameters():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r,
                                   atol=1e-5 * np.abs(r).max() + 1e-7,
                                   err_msg=name)
    n = (image // 8) ** 2 + (pool == "cls")
    assert tm.num_tokens() == n == tm.pos_embed.shape[1]


def test_params_round_trip_and_tree():
    _, tm, params, _ = _pair("cls", "xla")
    back = convert.flax_from_params(tm.state_dict())
    assert (jax.tree.structure(back)
            == jax.tree.structure(jax.device_get(params)))
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(jax.device_get(params))):
        np.testing.assert_array_equal(a, b)


def test_dropout_masks_repeat_under_remat():
    """With dropout on, a remat model's forward and gradients equal the
    same model's without remat (the recompute redraws each mask)."""
    kw = dict(image_size=32, patch_size=8, dropout=0.3, **ARCH)
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    outs = []
    for remat in (False, True):
        m = tvit.ViT(remat=remat, **kw)
        m.init_weights(torch.Generator().manual_seed(3))
        with torch.no_grad():
            m.head.weight.normal_(generator=torch.Generator().manual_seed(4))
        m.train()
        out = m(x, dropout_seed=77)
        out.sum().backward()
        outs.append((out.detach(), [p.grad.clone() for p in m.parameters()]))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    m = tvit.ViT(**kw)
    m.train()
    with pytest.raises(ValueError, match="seed"):
        m(x)


def test_factory_sizes_and_flops_on_197_tokens():
    m = MODELS.get("ViT")(size="vit-ti", num_classes=1000)
    assert (m.n_layer, m.d_model, m.num_tokens()) == (12, 192, 197)
    with pytest.raises(ValueError, match="attn_impl"):
        MODELS.get("ViT")(size="vit-ti", attn_impl="ring")
    t, d, f = 197, 192, 4 * 192
    want = (2.0 * 16 * 16 * 3 * d * 196
            + 12 * (2.0 * (4 * d * d + 2 * d * f) * t + 4.0 * t * t * d)
            + 2.0 * d * 1000)
    assert m.flops_per_example() == pytest.approx(want)
    assert profiler.train_step_flops(m, 8, 224) == pytest.approx(
        3 * 8 * want)
    # an image model with no count of its own gets none
    lenet = MODELS.get("LeNet")()
    assert profiler.train_step_flops(lenet, 8, 0) is None
