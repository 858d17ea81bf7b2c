"""The port's ``LeNet`` against the JAX package's through the converter:
log-probabilities and the gradients of every parameter on the same NHWC
batch (float32: atol 1e-5 on outputs, 1e-5 + rtol 1e-4 on gradients,
summation order only), which pins the NHWC flatten order of ``Dense_0``'s
320 rows; the round trip ``flax_from_params(params_from_flax(p)) == p``;
the alias ``MnistModel``; and the seeded dropout (the same seed draws the
same masks, ``p = 0`` is the identity)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_distributed_template_tpu.models  # noqa: F401
from pytorch_distributed_template_tpu.config.registry import MODELS as JM
from pytorch_distributed_template_tpu.engine import losses as jlosses

import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TM,
)
from pytorch_distributed_template_tpu_torch.engine import losses as tlosses
from pytorch_distributed_template_tpu_torch.models.base import (
    describe, param_count,
)
from pytorch_distributed_template_tpu_torch.models.convert import (
    flax_from_params, params_from_flax,
)


@pytest.fixture(scope="module")
def pair():
    jm = JM.get("LeNet")()
    params = jm.init(jax.random.key(3), jnp.zeros((1, 28, 28, 1)))["params"]
    params = jax.device_get(params)
    tm = TM.get("LeNet")(device="cpu")
    tm.load_state_dict(params_from_flax(params))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, 6).astype(np.int32)
    return jm, params, tm, x, y


def test_log_probs_and_grads_match_jax(pair):
    jm, params, tm, x, y = pair

    def loss(p):
        out = jm.apply({"params": p}, x)
        return jlosses.nll_loss(out, y).sum(), out

    (_, jout), jgrad = jax.value_and_grad(loss, has_aux=True)(params)
    tm.eval()
    tout = tm(torch.from_numpy(x))
    tlosses.nll_loss(tout, torch.from_numpy(y)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=1e-5)
    want = params_from_flax(jgrad)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
    assert param_count(tm) == 21840 == sum(
        np.prod(v.shape) for v in jax.tree_util.tree_leaves(params))
    assert describe(tm) == "LeNet\nTrainable parameters: 21840"


def test_converter_round_trip_and_layouts(pair):
    _, params, tm, _, _ = pair
    back = flax_from_params(tm.state_dict())
    flat_j = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_j, flat_b):
        assert np.array_equal(np.asarray(a), b)
    assert tuple(tm.Conv_0.weight.shape) == (10, 1, 5, 5)      # OIHW
    assert params["Conv_0"]["kernel"].shape == (5, 5, 1, 10)   # HWIO
    assert tuple(tm.Dense_0.weight.shape) == (50, 320)


def test_alias_and_seeded_dropout():
    assert TM.get("MnistModel") is TM.get("LeNet")
    m = TM.get("MnistModel")(device="cpu")
    m.init_weights(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 28, 28, 1)).astype(np.float32))
    m.train()
    a, b, c = m(x, dropout_seed=5), m(x, dropout_seed=5), m(x, dropout_seed=6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="seed"):
        m(x)
    for d in (m.Dropout_0, m.Dropout_1):
        d.p = 0.0
    off = m(x, dropout_seed=5)
    m.eval()
    assert torch.equal(off, m(x))
