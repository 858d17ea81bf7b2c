"""The port's MoE layer and MoE LM (models/moe.py) against the JAX
package's, on the CPU.

Params come from the flax modules' init and cross with
``models.convert.params_from_flax``; inputs come from a seeded numpy
generator. Checked in float32: the layer's output and its weighted
load-balancing loss for top-1 and top-2, both dispatch arms and a capacity
that drops tokens; input and parameter gradients against ``jax.grad``; the
masked-padding exactness of the train step; ``TinyMoeLM``'s logits and
summed aux loss with remat off and on; the converter's round trip.
Tolerances: forward atol 2e-5 + rtol 1e-4, gradients atol 2e-5 + rtol
2e-4 (float32 on both sides, summation orders differ). Routing is exact:
the same tokens are dropped on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import pytorch_distributed_template_tpu.models  # noqa: F401  (register)
import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu.config.registry import MODELS as JM
from pytorch_distributed_template_tpu.models.moe import MoeMlp as JMoeMlp
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TM,
)
from pytorch_distributed_template_tpu_torch.engine import losses as tlosses
from pytorch_distributed_template_tpu_torch.engine.steps import (
    make_train_step,
)
from pytorch_distributed_template_tpu_torch.models import moe as tmoe
from pytorch_distributed_template_tpu_torch.models.convert import (
    flax_from_params, params_from_flax,
)

FWD = dict(atol=2e-5, rtol=1e-4)
GRAD = dict(atol=2e-5, rtol=2e-4)
D, F_, E = 32, 48, 4


def _x(b=2, t=12, d=D, seed=0):
    return np.random.default_rng(seed).normal(size=(b, t, d)).astype(
        np.float32)


def _layer_pair(top_k, cf, dispatch, aux_w=0.1, seed=0):
    """(flax MoeMlp, its params, a port module holding ``moe`` with the
    same params)."""
    jl = JMoeMlp(d_model=D, d_ff=F_, num_experts=E, top_k=top_k,
                 capacity_factor=cf, aux_loss_weight=aux_w,
                 dispatch_impl=dispatch)
    params = jl.init(jax.random.key(seed), jnp.asarray(_x()), False)[
        "params"]
    # non-zero biases so the bias epilogue is exercised
    rng = np.random.default_rng(seed + 1)
    params = jax.device_get(params)
    params = dict(params, bi=rng.normal(size=(E, F_)).astype(np.float32)
                  * 0.1, bo=rng.normal(size=(E, D)).astype(np.float32) * 0.1)
    holder = nn.Module()
    holder.moe = tmoe.MoeMlp(D, F_, E, top_k=top_k, capacity_factor=cf,
                             aux_loss_weight=aux_w, dispatch_impl=dispatch)
    holder.load_state_dict(params_from_flax({"moe": params}), strict=True)
    return jl, params, holder.moe


def _jax_apply(jl, params, x, mask=None):
    y, mut = jl.apply({"params": params}, jnp.asarray(x), True,
                      None if mask is None else jnp.asarray(mask),
                      mutable=["losses"])
    return np.asarray(y), float(mut["losses"]["moe_aux"])


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("cf", [4.0, 0.5], ids=["ample", "drops"])
def test_moe_mlp_matches_jax(top_k, cf, dispatch):
    jl, params, tl = _layer_pair(top_k, cf, dispatch)
    x = _x()
    y_j, aux_j = _jax_apply(jl, params, x)
    tl.train()
    y_t, aux_t = tl(torch.from_numpy(x))
    np.testing.assert_allclose(y_t.detach().numpy(), y_j, **FWD)
    np.testing.assert_allclose(float(aux_t.detach()), aux_j, rtol=1e-5)


@pytest.mark.parametrize("top_k", [1, 2])
def test_gather_and_einsum_route_the_same(top_k):
    """Both arms on the same params give the same output, dropped tokens
    included (capacity 0.5 drops some)."""
    _, _, gather = _layer_pair(top_k, 0.5, "gather")
    _, _, einsum = _layer_pair(top_k, 0.5, "einsum")
    x = torch.from_numpy(_x(seed=3))
    y_g, _ = gather(x)
    y_e, _ = einsum(x)
    torch.testing.assert_close(y_g, y_e, atol=1e-6, rtol=1e-5)


def test_capacity_drops_tokens_like_jax():
    """At capacity factor 0.25 with top-1 most tokens find their expert
    full: their output rows are exactly zero on both sides."""
    jl, params, tl = _layer_pair(1, 0.25, "gather")
    x = _x(b=2, t=16)
    y_j, _ = _jax_apply(jl, params, x)
    y_t, _ = tl(torch.from_numpy(x))
    y_t = y_t.detach().numpy()
    dropped_j = np.all(y_j == 0.0, axis=-1)
    dropped_t = np.all(y_t == 0.0, axis=-1)
    assert dropped_j.sum() > 0
    np.testing.assert_array_equal(dropped_t, dropped_j)
    cap = tmoe.capacity(32, E, 1, 0.25)
    assert (~dropped_t).sum() <= E * cap


def test_example_mask_keeps_padding_out():
    """Padded examples claim no slot and move no statistic: the real rows'
    output and the aux loss equal those of the real examples alone (ample
    capacity), on both sides."""
    jl, params, tl = _layer_pair(2, 8.0, "gather")
    real = _x(b=2, t=8, seed=5)
    junk = _x(b=2, t=8, seed=6)
    padded = np.concatenate([real, junk])
    mask = np.array([True, True, False, False])
    y_ref, aux_ref = tl(torch.from_numpy(real))
    y_pad, aux_pad = tl(torch.from_numpy(padded),
                        torch.from_numpy(mask))
    torch.testing.assert_close(y_pad[:2], y_ref, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(float(aux_pad.detach()), float(aux_ref.detach()),
                               rtol=1e-5)
    y_j, aux_j = _jax_apply(jl, params, padded, mask)
    np.testing.assert_allclose(y_pad.detach().numpy(), y_j, **FWD)
    np.testing.assert_allclose(float(aux_pad.detach()), aux_j, rtol=1e-5)


@pytest.mark.parametrize("top_k", [1, 2])
def test_gradients_match_jax(top_k):
    """d/d(x, params) of sum(y * G) + aux, against jax.grad."""
    jl, params, tl = _layer_pair(top_k, 0.5, "gather")
    x = _x(seed=7)
    g = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, mut = jl.apply({"params": p}, xx, True, mutable=["losses"])
        return jnp.sum(y * g) + mut["losses"]["moe_aux"]

    gp, gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params,
                                                      jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    tl.zero_grad()
    y, aux = tl(xt)
    ((y * torch.from_numpy(g)).sum() + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD)
    want = params_from_flax({"moe": jax.device_get(gp)})
    for name, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   want[f"moe.{name}"].numpy(), **GRAD,
                                   err_msg=name)


def test_switch_router_gets_the_task_gradient():
    _, _, tl = _layer_pair(1, 4.0, "gather", aux_w=0.0)
    y, aux = tl(torch.from_numpy(_x()))
    assert aux is None
    (y ** 2).sum().backward()
    assert tl.router.weight.grad.abs().max() > 1e-6


TINY = dict(vocab_size=64, n_layer=2, n_head=2, d_model=32, max_len=16,
            num_experts=4, top_k=2, capacity_factor=0.75,
            aux_loss_weight=0.1)


def _tokens(b=4, t=16, seed=0):
    return np.random.default_rng(seed).integers(0, 64, (b, t)).astype(
        np.int32)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_tiny_moe_lm_matches_jax(remat):
    """Logits and the summed aux loss in training mode (a padded example
    in the batch), then the gradients of loss + aux, against the flax
    model; with remat the aux loss is counted once."""
    jm = JM.get("TinyMoeLM")(**TINY, remat=remat)
    toks = _tokens()
    mask = np.array([True, True, True, False])
    params = jm.init(jax.random.key(0), jnp.asarray(toks))["params"]
    tm = TM.get("TinyMoeLM")(**TINY, remat=remat, device="cpu")
    tm.load_state_dict(params_from_flax(jax.device_get(params)),
                       strict=True)

    def jloss(p):
        logits, mut = jm.apply({"params": p}, jnp.asarray(toks), True,
                               jnp.asarray(mask), mutable=["losses"])
        aux = sum(jax.tree.leaves(mut["losses"]))
        return jnp.mean(logits ** 2) + aux, (logits, aux)

    (_, (logits_j, aux_j)), gp = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    tm.train()
    logits_t = tm(torch.from_numpy(toks), example_mask=torch.from_numpy(
        mask))
    aux_t = tm.aux_loss
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), **FWD)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    ((logits_t ** 2).mean() + aux_t).backward()
    want = params_from_flax(jax.device_get(gp))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   **GRAD, err_msg=name)
    tm.eval()
    with torch.no_grad():
        tm(torch.from_numpy(toks))
    assert tm.aux_loss is None


def test_remat_counts_the_aux_loss_once():
    """The same model with and without remat: equal aux loss and equal
    gradients through the train step's loss (aux x count included)."""
    out = []
    state = None
    for remat in (False, True):
        model = TM.get("TinyMoeLM")(**TINY, remat=remat, device="cpu")
        if state is None:
            model.init_weights(torch.Generator().manual_seed(1))
            state = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(state)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        step = make_train_step(model, opt, tlosses.lm_cross_entropy,
                               input_key="tokens", target_key="tokens")
        m = step({"tokens": torch.from_numpy(_tokens(seed=2)),
                  "mask": torch.ones(4, dtype=torch.bool)})
        out.append((float(m["loss_sum"]), float(model.aux_loss),
                    {k: v.clone() for k, v in model.state_dict().items()}))
    (l0, a0, p0), (l1, a1, p1) = out
    assert a0 > 0
    assert l1 == pytest.approx(l0, rel=1e-6) and a1 == pytest.approx(
        a0, rel=1e-6)
    for k in p0:
        torch.testing.assert_close(p1[k], p0[k], atol=1e-6, rtol=1e-5)


def test_masked_padding_is_exact_in_the_train_step():
    """The port's step over a padded batch (4 real + 4 masked junk rows)
    equals the step over the real rows alone: loss and updated params
    (tests/test_moe.py's contract, ample capacity)."""
    args = dict(vocab_size=64, n_layer=2, d_model=32, n_head=2, max_len=8,
                num_experts=4, top_k=2, capacity_factor=4.0,
                aux_loss_weight=0.1)
    rng = np.random.default_rng(7)
    real = rng.integers(0, 64, (4, 8)).astype(np.int32)
    junk = rng.integers(0, 64, (4, 8)).astype(np.int32)
    results = []
    state = None
    for toks, mask in ((real, [True] * 4),
                       (np.concatenate([real, junk]), [True] * 4
                        + [False] * 4)):
        model = TM.get("TinyMoeLM")(**args, device="cpu")
        if state is None:
            model.init_weights(torch.Generator().manual_seed(0))
            state = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(state)
        step = make_train_step(
            model, torch.optim.SGD(model.parameters(), lr=0.1),
            tlosses.lm_cross_entropy, input_key="tokens",
            target_key="tokens")
        m = step({"tokens": torch.from_numpy(toks),
                  "mask": torch.tensor(mask)})
        results.append((m, model.state_dict()))
    (m_ref, p_ref), (m_pad, p_pad) = results
    assert float(m_pad["count"]) == 4.0
    assert float(m_pad["loss_sum"]) == pytest.approx(
        float(m_ref["loss_sum"]), rel=1e-5)
    for k in p_ref:
        torch.testing.assert_close(p_pad[k], p_ref[k], atol=1e-6, rtol=1e-4)


def test_convert_round_trip():
    jm = JM.get("TinyMoeLM")(**TINY)
    params = jax.device_get(jm.init(jax.random.key(3), jnp.asarray(
        _tokens()))["params"])
    back = flax_from_params(params_from_flax(params))
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf))


def test_refuses_later_slices_by_name():
    """What stays refused: an unknown expert activation, and MoE blocks on
    a seq or a tensor axis (ROADMAP A11d's remainder). The swiglu expert
    and the expert axis beside data are ported (tests/test_torch_mixtral.py,
    tests/test_torch_moe_ranks.py)."""
    with pytest.raises(ValueError, match="expert_act"):
        tmoe.MoeMlp(D, F_, E, expert_act="relu")
    assert "wg" in dict(tmoe.MoeMlp(D, F_, E, expert_act="swiglu")
                        .named_parameters())
    # a data-axis mesh is ported (DDP, slice 5; the trainer gives every
    # model its mesh); MoE blocks on a seq axis wait for A11d's remainder
    from pytorch_distributed_template_tpu_torch.parallel.mesh import Mesh

    TM.get("MoeLM")(n_layer=1, d_model=32, n_head=2,
                    mesh=Mesh({"data": 2}), device="cpu")
    model = TM.get("MoeLM")(n_layer=1, d_model=32, n_head=2,
                            attn_impl="ring", mesh=Mesh({"seq": 2}),
                            device="cpu")
    with pytest.raises(NotImplementedError, match="A11d's remainder"):
        model(torch.zeros((1, 8), dtype=torch.long))
    with pytest.raises(NotImplementedError, match="A11d's remainder"):
        model.use_tensor_axis(Mesh({"tensor": 2}))


def test_row_gather_backward_equals_index_autograd():
    """RowGather's gather-based backward against autograd of plain
    advanced indexing, with a zero row read many times (empty slots) and
    rows read twice (top-2)."""
    rng = np.random.default_rng(11)
    src = torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32))
    idx = torch.tensor([3, 6, 0, 6, 3, 5, 6, 1, 0])     # 6: the zero row
    rev = torch.full((6, 2), len(idx))
    for pos, row in enumerate(idx.tolist()):
        if row < 6:
            j = int((rev[row] < len(idx)).sum())
            rev[row, j] = pos
    g = torch.from_numpy(rng.normal(size=(9, 5)).astype(np.float32))
    a = src.clone().requires_grad_()
    out = tmoe.RowGather.apply(a, idx, rev)
    out.backward(g)
    b = src.clone().requires_grad_()
    want = torch.cat([b, b.new_zeros(1, 5)])[idx]
    want.backward(g)
    torch.testing.assert_close(out, want.detach())
    torch.testing.assert_close(a.grad, b.grad)


def test_top_k_breaks_ties_like_jax():
    """Ties go to the lower expert index (jax.lax.top_k's order), values
    keep their gradient."""
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.4, 0.1, 0.4, 0.1],
                          [0.25, 0.25, 0.25, 0.25], [0.1, 0.2, 0.3, 0.4]],
                         requires_grad=True)
    vals, idx = tmoe.top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.detach().numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.detach().numpy(), np.asarray(jv))
    vals.sum().backward()
    want = np.zeros((4, 4), np.float32)
    np.put_along_axis(want, np.asarray(ji), 1.0, axis=1)
    np.testing.assert_array_equal(probs.grad.numpy(), want)
