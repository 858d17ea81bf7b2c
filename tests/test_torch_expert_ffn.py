"""The port's fused expert FFN (ops/expert_ffn.py) on the CPU against the
JAX side: ``scripts/debug_moe_pallas_ffn.py``'s ``xla_expert_ffn`` (the
einsums the TPU kernel is held against), its Pallas kernel
``pallas_expert_ffn`` in interpret mode, and the biased form of the JAX
``MoeMlp``'s gelu arm (models/moe.py). The CUDA kernel B5 is held against
the plain version on the card by tests/test_torch_kernels_cuda.py and
chip_smoke.py.

Inputs come from a seeded numpy generator and go to both sides as the same
arrays. Tolerances: float32 atol 1e-5 + rtol 1e-5 (summation order), and
where ``xla_expert_ffn`` rounds its output to bf16, atol 1e-5 + rtol 2^-7
(one bf16 rounding of each side); bf16 inputs: both sides round the hidden
and the output to bf16 at the same places, so they agree to
``0.01 max|ref| + 1e-4`` (the probe's own gate). Gradients: atol 1e-5 +
rtol 1e-4 in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scripts.debug_moe_pallas_ffn as probe
from pytorch_distributed_template_tpu_torch.ops import expert_ffn as ffn

E, C, D, F_ = 3, 24, 32, 48
F32 = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed=0, e=E, c=C, d=D, f=F_):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(e, c, d)).astype(np.float32)
    wi = (rng.normal(size=(e, d, f)) * d ** -0.5).astype(np.float32)
    wo = (rng.normal(size=(e, f, d)) * f ** -0.5).astype(np.float32)
    bi = (rng.normal(size=(e, f)) * 0.1).astype(np.float32)
    bo = (rng.normal(size=(e, d)) * 0.1).astype(np.float32)
    return x, wi, wo, bi, bo


def _jax_gelu_arm(x, wi, wo, bi, bo):
    """The JAX MoeMlp's gelu expert (models/moe.py), float32."""
    h = jax.nn.gelu(jnp.einsum("ecd,edf->ecf", x, wi) + bi[:, None])
    return jnp.einsum("ecf,efd->ecd", h, wo) + bo[:, None]


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def test_ref_matches_xla_expert_ffn_f32():
    """No biases: the probe's einsums in float32 end in one bf16 cast."""
    x, wi, wo, _, _ = _inputs(1)
    want = np.asarray(probe.xla_expert_ffn(x, wi, wo), np.float32)
    got = ffn.expert_ffn_ref(*_t(x, wi, wo))
    np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(), want,
                               atol=1e-5, rtol=2 ** -7)


def test_ref_matches_xla_expert_ffn_bf16():
    """bf16 inputs: both round the hidden to bf16 before the second
    product and the result to bf16."""
    x, wi, wo, _, _ = _inputs(2)
    xb, wib, wob = (jnp.asarray(a, jnp.bfloat16) for a in (x, wi, wo))
    want = np.asarray(probe.xla_expert_ffn(xb, wib, wob), np.float32)
    got = ffn.expert_ffn_ref(*_t(x, wi, wo, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 0.01 * np.abs(want).max() + 1e-4


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ref_matches_the_jax_gelu_arm_with_biases(dtype):
    x, wi, wo, bi, bo = _inputs(3)
    want = np.asarray(_jax_gelu_arm(x, wi, wo, bi, bo))
    if dtype == "f32":
        got = ffn.expert_ffn_ref(*_t(x, wi, wo, bi, bo))
        np.testing.assert_allclose(got.numpy(), want, **F32)
    else:
        got = ffn.expert_ffn_ref(*_t(x, wi, wo, bi, bo,
                                     dtype=torch.bfloat16)).float().numpy()
        assert np.abs(got - want).max() <= 0.01 * np.abs(want).max() + 1e-4


def test_ref_matches_the_pallas_kernel_in_interpret_mode(monkeypatch):
    """``pallas_expert_ffn`` reads its grid from the probe's module
    constants: a small shape is set for this test only."""
    e, c, bc, d, f = 2, 16, 8, 32, 64
    for name, val in dict(E=e, C=c, BC=bc, D=d, F=f).items():
        monkeypatch.setattr(probe, name, val)
    x, wi, wo, _, _ = _inputs(4, e, c, d, f)
    xb, wib, wob = (jnp.asarray(a, jnp.bfloat16) for a in (x, wi, wo))
    want = np.asarray(probe.pallas_expert_ffn(xb, wib, wob, interpret=True),
                      np.float32)
    got = ffn.expert_ffn(*_t(x, wi, wo, dtype=torch.bfloat16))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 0.01 * np.abs(want).max() + 1e-4


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_expert_ffn_gradients_match_torch_autograd(bias):
    """ExpertFFN's backward (recomputed hidden, bmm) against autograd of
    the plain version."""
    arrays = _inputs(5)
    if not bias:
        arrays = arrays[:3] + (None, None)
    g = torch.from_numpy(np.random.default_rng(6).normal(
        size=(E, C, D)).astype(np.float32))
    a = [None if v is None else torch.from_numpy(v).requires_grad_()
         for v in arrays]
    b = [None if v is None else torch.from_numpy(v).requires_grad_()
         for v in arrays]
    ffn.expert_ffn(*a).backward(g)
    ffn.expert_ffn_ref(*b).backward(g)
    for name, x, y in zip(("x", "wi", "wo", "bi", "bo"), a, b):
        if x is not None:
            np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(),
                                       atol=1e-5, rtol=1e-4, err_msg=name)


def test_expert_ffn_gradients_match_jax_grad():
    """Against jax.grad of the JAX gelu arm (float32), every input."""
    arrays = _inputs(7)
    g = np.random.default_rng(8).normal(size=(E, C, D)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(_jax_gelu_arm(*a) * g),
                    argnums=(0, 1, 2, 3, 4))(*arrays)
    ts = [torch.from_numpy(v).requires_grad_() for v in arrays]
    ffn.expert_ffn(*ts).backward(torch.from_numpy(g))
    for name, t, w in zip(("x", "wi", "wo", "bi", "bo"), ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def test_wrapper_checks_shapes():
    x, wi, wo, bi, bo = _t(*_inputs(9))
    with pytest.raises(ValueError, match="do not fit"):
        ffn.expert_ffn(x, wi[:, :-1], wo)
    with pytest.raises(ValueError, match="do not fit"):
        ffn.expert_ffn(x, wi, wo[:-1])
    with pytest.raises(ValueError, match=r"bi must be \[E, F\]"):
        ffn.expert_ffn(x, wi, wo, bi[:, :-1], bo)
    with pytest.raises(ValueError, match=r"bo must be \[E, D\]"):
        ffn.expert_ffn(x, wi, wo, bi, bo[:-1])
    with pytest.raises(ValueError, match="takes x"):
        ffn.expert_ffn(x[0], wi, wo)


def test_bound_counts_flops_and_bytes():
    """The main path's shape (E 8, C 5120, D 512, F 1024, bf16): 85.9
    GFLOP on 100.7 MB, bound by the arithmetic on an H100."""
    s, by = ffn.expert_ffn_bound_seconds(8, 5120, 512, 1024, 2, False,
                                         989e12, 3.35e12)
    assert by == "operations"
    assert s == pytest.approx(4 * 8 * 5120 * 512 * 1024 / 989e12)
    s, by = ffn.expert_ffn_bound_seconds(1, 4, 16, 16, 2, True, 989e12,
                                         3.35e12)
    assert by == "bytes"
    assert s == pytest.approx(2 * (2 * 4 * 16 + 2 * 16 * 16 + 32) / 3.35e12)
