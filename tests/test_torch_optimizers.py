"""The port's optimizers against optax, through each package's
``build_optimizer``, on the CPU.

A 1-layer GPT-2 at d_model 128 (vocab 64) holds every kind of parameter:
embeddings, LayerNorm scales and biases, dense kernels of 128 x 384,
128 x 512 and a square 128 x 128 (Adafactor factors the first three
in the JAX layout, and the square one by the JAX array's axes), and
biases. Both sides start from the same params and take 10 updates from
the same gradients (random, from a numpy seed, in each package's layout),
with ``weight_decay_exclude`` ``["bias$", "ln_", "wpe"]`` and a decay of
0.1 where the optimizer takes one. Tolerance: float32 both sides, params
atol 2e-6 with rtol 1e-5 after the 10 updates (XLA's ``rsqrt``, ``pow``
and reductions differ from torch's in the last bit; the normalised
updates carry that into the params at ~lr x 1e-6). ``mu_dtype``
``bfloat16`` is held to the same tolerance and its moment must be stored
in bf16, bitwise equal to optax's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pytorch_distributed_template_tpu.models  # noqa: F401  (register)
from pytorch_distributed_template_tpu.config.registry import MODELS as JM
from pytorch_distributed_template_tpu.engine import optim as joptim

import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TM,
)
from pytorch_distributed_template_tpu_torch.engine import optim as toptim
from pytorch_distributed_template_tpu_torch.models.convert import (
    params_from_flax,
)
from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401

MODEL = dict(vocab_size=64, n_layer=1, n_head=2, d_model=128, max_len=16,
             attn_impl="xla")
EXCLUDE = ["bias$", "ln_", "wpe"]
STEPS = 10
ATOL, RTOL = 2e-6, 1e-5
# each optimizer's args: the learning rate and, where it takes one, decay
CASES = {
    "RMSprop": dict(lr=1e-3, momentum=0.9, weight_decay=0.1),
    "Adagrad": dict(lr=1e-2, weight_decay=0.1),
    "Adadelta": dict(lr=1.0, weight_decay=0.1),
    "Adamax": dict(lr=2e-3, weight_decay=0.1),
    "NAdam": dict(lr=2e-3, weight_decay=0.1),
    "RAdam": dict(lr=1e-3, weight_decay=0.1),
    "Adafactor": dict(lr=1e-2, weight_decay=0.1),
    "LARS": dict(lr=0.5, momentum=0.9, weight_decay=0.1),
    "LAMB": dict(lr=1e-2, weight_decay=0.1),
    "Lion": dict(lr=1e-3, weight_decay=0.1),
}


@functools.lru_cache(maxsize=None)
def _init(d_model: int):
    """The JAX model's initial params at ``d_model`` (numpy leaves)."""
    jmodel = JM.get("GPT2")(**dict(MODEL, d_model=d_model))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 16), jnp.int32))["params"]
    return jax.device_get(params)


def _params():
    """The JAX param tree and the port's model with the same params."""
    params = _init(MODEL["d_model"])
    tmodel = TM.get("GPT2")(**MODEL, device="cpu")
    tmodel.load_state_dict(params_from_flax(params))
    return params, tmodel


def _grads(params, step):
    rng = np.random.default_rng(100 + step)
    return jax.tree.map(
        lambda p: (rng.standard_normal(np.shape(p)) * 0.05).astype(
            np.float32), params)


def _run(cfg, steps=STEPS, scales=None):
    """``steps`` updates of the config's optimizer on both sides; returns
    the JAX params, the port model and the port optimizer."""
    scales = scales or [1.0] * steps
    params, tmodel = _params()
    tx, jlr, _ = joptim.build_optimizer(cfg, steps_per_epoch=4)
    opt, lr_fn, _ = toptim.build_optimizer(cfg, 4, tmodel)
    state = tx.init(params)
    named = dict(tmodel.named_parameters())
    for step in range(steps):
        g = _grads(params, step)
        updates, state = tx.update(g, state, params)
        updates = jax.tree.map(lambda u, s=scales[step]: u * jnp.float32(s),
                               updates)
        params = optax.apply_updates(params, updates)
        for name, value in params_from_flax(g).items():
            named[name].grad = value
        toptim.set_lr(opt, lr_fn(step), scales[step])
        opt.step()
    return params, tmodel, opt, state


def _assert_close(params, tmodel, atol=ATOL, rtol=RTOL):
    want = params_from_flax(jax.device_get(params))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=atol, rtol=rtol, err_msg=name)


def _cfg(name, **args):
    return {"optimizer": {"type": name, "args": dict(
        args, weight_decay_exclude=EXCLUDE)}}


@pytest.mark.parametrize("name", sorted(CASES))
def test_optimizer_matches_optax(name):
    params, tmodel, _, _ = _run(_cfg(name, **CASES[name]))
    _assert_close(params, tmodel)


def test_decay_groups_exempt_what_the_jax_mask_exempts():
    params, tmodel = _params()
    opt, _, _ = toptim.build_optimizer(_cfg("Lion", **CASES["Lion"]), 4,
                                       tmodel)
    mask = joptim._decay_mask(EXCLUDE)(params)
    want = {"/".join(str(getattr(k, "key", k)) for k in path)
            for path, decayed in jax.tree_util.tree_leaves_with_path(mask)
            if not decayed}
    from pytorch_distributed_template_tpu_torch.models.convert import (
        flax_path,
    )

    exempt = {id(p) for g in opt.param_groups if g["weight_decay"] == 0.0
              for p in g["params"]}
    got = {flax_path(n) for n, p in tmodel.named_parameters()
           if id(p) in exempt}
    assert got == want and len(got) >= 5


@pytest.mark.parametrize("d_model, factored", [(128, True), (64, False)])
def test_adafactor_factored_and_unfactored_arms(d_model, factored):
    """d_model 128: the dense kernels factor (a row and a column moment,
    O(n + m)); d_model 64: nothing reaches 128 in two dims, every
    parameter keeps a full moment. Both against optax."""
    global MODEL
    saved = MODEL
    MODEL = dict(saved, d_model=d_model)
    try:
        params, tmodel, opt, _ = _run(_cfg("Adafactor",
                                          **CASES["Adafactor"]))
    finally:
        MODEL = saved
    _assert_close(params, tmodel)
    qkv = dict(tmodel.named_parameters())["h.0.attn.qkv.weight"]
    st = opt.state[qkv]
    if factored:
        assert set(st) == {"step", "v_row", "v_col"}
        assert st["v_row"].numel() + st["v_col"].numel() == sum(qkv.shape)
    else:
        assert set(st) == {"step", "v"} and st["v"].shape == qkv.shape


def test_adafactor_relative_step_mode():
    """``lr: null`` without a schedule: optax's relative-step Adafactor
    (no learning-rate factor, the parameter scale sets the size); the
    logged lr is NaN on both sides. A schedule with lr null is refused by
    both packages."""
    cfg = {"optimizer": {"type": "Adafactor", "args": {"lr": None}}}
    # each update is about the parameter's own rms: 3 of them, before
    # the growth makes last-bit differences visible
    params, tmodel, opt, _ = _run(cfg, steps=3)
    _assert_close(params, tmodel)
    _, lr_fn, _ = toptim.build_optimizer(cfg, 4, _params()[1])
    _, jlr, _ = joptim.build_optimizer(cfg, steps_per_epoch=4)
    assert np.isnan(lr_fn(3)) and np.isnan(jlr(3))
    cfg["lr_scheduler"] = {"type": "StepLR", "args": {"step_size": 1}}
    with pytest.raises(ValueError, match="explicit numeric optimizer lr"):
        joptim.build_optimizer(cfg, steps_per_epoch=4)
    with pytest.raises(ValueError, match="explicit numeric optimizer lr"):
        toptim.build_optimizer(cfg, 4, _params()[1])


@pytest.mark.parametrize("name", ["Adam", "AdamW", "AmsGrad"])
def test_mu_dtype_bfloat16_matches_optax(name):
    """The first moment stored in bf16 and rounded each step as optax
    rounds it: params within the f32 tolerance, the moment bf16 and
    equal to optax's to one bf16 ulp."""
    args = dict(lr=1e-2, mu_dtype="bfloat16")
    if name == "AmsGrad":
        name, args = "Adam", dict(args, amsgrad=True)
    if name == "AdamW":
        args["weight_decay"] = 0.1
    params, tmodel, opt, state = _run(_cfg(name, **args))
    _assert_close(params, tmodel)
    mus = [s.mu for s in jax.tree.leaves(
        state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")]
    assert all(m.dtype == jnp.bfloat16 for m in jax.tree.leaves(mus[0]))
    want = params_from_flax(jax.tree.map(
        lambda m: np.asarray(m, np.float32), jax.device_get(mus[0])))
    for n, p in tmodel.named_parameters():
        mu = opt.state[p]["mu"]
        assert mu.dtype == torch.bfloat16, n
        np.testing.assert_allclose(mu.float().numpy(),
                                   want[n].float().numpy(),
                                   rtol=2 ** -8, atol=1e-12, err_msg=n)
        assert opt.state[p]["nu"].dtype == torch.float32


@pytest.mark.parametrize("name", ["AdamW", "Adam", "Adafactor", "Adadelta",
                                  "LARS", "RMSprop"])
def test_lr_scale_multiplies_the_final_update(name):
    """``lr_scale`` 0.3 from the fourth update, as the JAX step multiplies
    its updates: for Adafactor (decay after the lr), LARS and RMSprop with
    momentum (the lr before the trace) this is not a scaled lr."""
    args = dict(CASES.get(name, dict(lr=1e-2, weight_decay=0.1)))
    params, tmodel, _, _ = _run(_cfg(name, **args),
                                scales=[1.0] * 3 + [0.3] * (STEPS - 3))
    _assert_close(params, tmodel)


@pytest.mark.parametrize("name", sorted(CASES) + ["AdamW", "Adam"])
def test_state_bytes_follow_the_parameter_shapes(name):
    """What phase 3e prints: Adam-type 2 x 4 B per parameter element,
    Lion 4 B, Adafactor a row and a column per factored matrix."""
    _, tmodel = _params()
    opt, lr_fn, _ = toptim.build_optimizer(_cfg(name, **CASES.get(
        name, {"lr": 1e-3})), 4, tmodel)
    for p in tmodel.parameters():
        p.grad = torch.ones_like(p)
    toptim.set_lr(opt, lr_fn(0))
    opt.step()
    n = sum(p.numel() for p in tmodel.parameters())
    want = toptim.expected_state_bytes(opt)
    assert toptim.state_bytes(opt) == want
    if name in ("Adam", "AdamW", "NAdam", "RAdam", "Adamax", "LAMB"):
        assert want == 8 * n
    elif name in ("Lion", "LARS", "Adagrad") or (
            name == "RMSprop" and not CASES[name].get("momentum")):
        assert want == 4 * n
    elif name == "Adafactor":
        assert want < n
