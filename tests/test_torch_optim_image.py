"""The port's image-config optimizers and schedules against the JAX
package's (optax):

- ``Adam`` with ``amsgrad: true`` (with and without coupled weight decay)
  on ROADMAP A8's case, one large gradient then four small ones at lr
  1e-3: the port's ``AmsGrad`` equals optax's ``amsgrad`` to float32
  rounding (atol 1e-7 on parameters of order 1), and
  ``torch.optim.Adam(amsgrad=True)`` is shown to drift by about one
  update (> 5e-4);
- ``SGD`` with momentum, nesterov and coupled decay: the same trace from
  the first step (atol 1e-6 over 6 steps);
- the eight closed-form schedules over epochs 0-200 for several argument
  sets (rtol 1e-5, atol 1e-6: JAX evaluates them in float32);
- ``ReduceLROnPlateau`` and the ten other optimizers still refuse, naming
  their slice.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_template_tpu.config.registry import (
    SCHEDULERS as JSCHED,
)
from pytorch_distributed_template_tpu.engine import optim as joptim

from pytorch_distributed_template_tpu_torch.config.registry import (
    OPTIMIZERS, SCHEDULERS,
)
from pytorch_distributed_template_tpu_torch.engine import optim  # noqa: F401

LR = 1e-3


def _grads():
    rng = np.random.default_rng(5)
    big = rng.normal(size=(4, 3)).astype(np.float32) * 10.0
    return [big] + [rng.normal(size=(4, 3)).astype(np.float32) * 0.01
                    for _ in range(4)]


def _optax_run(tx, p0, grads):
    params = {"w": jnp.asarray(p0)}
    state = tx.init(params)
    for g in grads:
        upd, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, upd)
    return np.asarray(params["w"])


def _torch_run(opt_fn, p0, grads):
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = opt_fn(model)
    for g in grads:
        model.w.grad = torch.from_numpy(g.copy())
        opt.step()
    return model.w.detach().numpy()


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_amsgrad_matches_optax_and_torch_builtin_does_not(wd):
    p0 = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)
    grads = _grads()
    want = _optax_run(joptim.adam(lr=LR, amsgrad=True, weight_decay=wd),
                      p0, grads)
    got = _torch_run(lambda m: OPTIMIZERS.get("Adam")(
        m, lr=LR, amsgrad=True, weight_decay=wd), p0, grads)
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    builtin = _torch_run(lambda m: torch.optim.Adam(
        m.parameters(), lr=LR, amsgrad=True, weight_decay=wd), p0, grads)
    assert np.abs(builtin - want).max() > 5e-4


@pytest.mark.parametrize("momentum, nesterov, wd", [
    (0.0, False, 0.0), (0.9, False, 0.0), (0.9, True, 5e-4),
    (0.5, False, 1e-2)])
def test_sgd_matches_optax_from_the_first_step(momentum, nesterov, wd):
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(5, 2)).astype(np.float32)
    grads = [rng.normal(size=(5, 2)).astype(np.float32) for _ in range(6)]
    args = dict(lr=0.1, momentum=momentum, nesterov=nesterov,
                weight_decay=wd)
    want = _optax_run(joptim.sgd(**args), p0, grads)
    got = _torch_run(lambda m: OPTIMIZERS.get("SGD")(m, **args), p0, grads)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    got1 = _torch_run(lambda m: OPTIMIZERS.get("SGD")(m, **args), p0,
                      grads[:1])
    np.testing.assert_allclose(got1, _optax_run(joptim.sgd(**args), p0,
                                                grads[:1]), atol=1e-7)


SCHEDULES = [
    ("StepLR", dict(step_size=50, gamma=0.1)),
    ("StepLR", dict(step_size=7, gamma=0.5)),
    ("MultiStepLR", dict(milestones=[30, 80, 150], gamma=0.2)),
    ("ExponentialLR", dict(gamma=0.97)),
    ("CosineAnnealingLR", dict(T_max=100)),
    ("CosineAnnealingLR", dict(T_max=37, eta_min_ratio=0.1)),
    ("LinearLR", dict(start_factor=0.25, end_factor=1.0, total_iters=20)),
    ("ConstantLR", dict(factor=0.5, total_iters=10)),
    ("PolynomialLR", dict(total_iters=150, power=2.0)),
    ("CosineAnnealingWarmRestarts", dict(T_0=10, T_mult=1)),
    ("CosineAnnealingWarmRestarts", dict(T_0=5, T_mult=2)),
    ("CosineAnnealingWarmRestarts", dict(T_0=3, T_mult=3)),
]


@pytest.mark.parametrize("name, args", SCHEDULES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCHEDULES)])
def test_schedules_match_jax(name, args):
    jf = JSCHED.get(name)(**args)
    tf = SCHEDULERS.get(name)(**args)
    for epoch in range(201):
        np.testing.assert_allclose(tf(epoch), float(jf(jnp.int32(epoch))),
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name} epoch {epoch}")


@pytest.mark.parametrize("kind, name", [
    ("optimizer", n) for n in ("RMSprop", "Adagrad", "Adadelta", "Adamax",
                               "NAdam", "RAdam", "Adafactor", "LARS",
                               "LAMB", "Lion")] + [
    ("scheduler", "ReduceLROnPlateau")])
def test_later_optimizers_refuse_naming_their_slice(kind, name):
    reg = OPTIMIZERS if kind == "optimizer" else SCHEDULERS
    with pytest.raises(NotImplementedError, match="A17"):
        reg.get(name)()
