"""The port's image losses (``nll_loss``, ``cross_entropy``, ``mse_loss``,
``smooth_cross_entropy``) and metrics (``accuracy``, ``top_k_acc``)
against the JAX package's on the same numpy inputs. Losses: value atol
1e-6 and the gradient atol 1e-6 + rtol 1e-5 (float32, summation order
only). Metrics: exact, on inputs with ties at the arg-max and at the k-th
place, where both sides must prefer the lower index."""
import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_template_tpu.engine import losses as jlosses
from pytorch_distributed_template_tpu.engine import metrics as jmetrics

from pytorch_distributed_template_tpu_torch.config.registry import LOSSES
from pytorch_distributed_template_tpu_torch.engine import losses as tlosses
from pytorch_distributed_template_tpu_torch.engine import metrics as tmetrics

RNG = np.random.default_rng(11)
LOGITS = RNG.normal(size=(9, 10)).astype(np.float32)
LABELS = RNG.integers(0, 10, 9).astype(np.int32)


@pytest.mark.parametrize("name", ["nll_loss", "cross_entropy", "mse_loss",
                                  "smooth_cross_entropy"])
def test_losses_match_jax_in_value_and_grad(name):
    if name == "smooth_cross_entropy":
        jfn = jlosses.smooth_cross_entropy(0.2)
        tfn = tlosses.resolve_loss({"type": name, "args": {"smoothing": 0.2}})
    else:
        jfn, tfn = getattr(jlosses, name), LOSSES.get(name)
    x = LOGITS
    if name == "nll_loss":
        x = np.asarray(jax.nn.log_softmax(LOGITS))
    target = LABELS
    if name == "mse_loss":
        target = RNG.normal(size=LOGITS.shape).astype(np.float32)
    cot = RNG.normal(size=(9,)).astype(np.float32)
    jv, vjp = jax.vjp(lambda a: jfn(a, target), x)
    xt = torch.from_numpy(x).requires_grad_()
    tv = tfn(xt, torch.from_numpy(target))
    tv.backward(torch.from_numpy(cot))
    assert tv.shape == (9,)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(cot)[0]),
                               atol=1e-6, rtol=1e-5)


def test_smooth_cross_entropy_is_a_factory():
    with pytest.raises(ValueError, match="dict form"):
        tlosses.resolve_loss("smooth_cross_entropy")
    with pytest.raises(ValueError, match="smoothing"):
        tlosses.smooth_cross_entropy(1.0)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_accuracy_and_top_k_match_jax_with_ties(k):
    out = np.round(RNG.normal(size=(64, 10)), 0).astype(np.float32)
    out[:8] = 0.0                      # every class tied
    out[8:16, :4] = 2.0                # four tied at the top
    target = RNG.integers(0, 10, 64).astype(np.int32)
    target[:8] = np.arange(8)
    target[8:16] = np.arange(8) % 5
    t_out, t_tgt = torch.from_numpy(out), torch.from_numpy(target)
    np.testing.assert_array_equal(
        tmetrics.accuracy(t_out, t_tgt).numpy(),
        np.asarray(jmetrics.accuracy(out, target)))
    got = tmetrics.top_k_acc(t_out, t_tgt, k=k).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jmetrics.top_k_acc(out, target, k=k)))
    # all tied: the lowest k indices are the top k
    np.testing.assert_array_equal(got[:8], (np.arange(8) < k).astype(
        np.float32))
