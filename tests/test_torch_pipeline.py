"""The port's pipeline schedule (parallel/pipeline.py) against the JAX
package's, on the CPU.

``pipeline_apply`` without a pipe axis, GPipe (``n_chunks`` 1) and
circular (``n_chunks`` 2), with a partial last round (M = 6 microbatches
over S = 4 stages), forward and gradients, against the port's plain
sequential loop over the stages and against JAX's ``pipeline_apply`` on a
pipe axis of 4 fake CPU devices (as ``tests/test_pipeline.py`` runs it).
The schedule on a real pipe axis (4 gloo ranks, the tick loop with its
permutes) is held against the same JAX results in
``tests/test_torch_pipe_ranks.py``. Then the layouts:
``regroup_for_pipeline`` and ``models.pipelined._stacked_lead`` equal to
JAX's. Tolerances: forward rtol/atol 1e-6, gradients rtol 1e-4, atol 1e-5
(float32; JAX's scan and the port's loop sum in different orders), the
layouts exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_template_tpu.models import pipelined as jpipelined
from pytorch_distributed_template_tpu.parallel import pipeline as jpipeline
from pytorch_distributed_template_tpu.parallel.mesh import build_mesh
from pytorch_distributed_template_tpu_torch.models import pipelined
from pytorch_distributed_template_tpu_torch.parallel import pipeline

FWD_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# (n_chunks, microbatches): GPipe and circular, each with a partial round
CASES = [(1, 6), (2, 6), (1, 8)]


def stage_stack(S: int, V: int, d: int = 16, seed: int = 0):
    """Stacked stage params ``(W [S(, V), d, d], b [S(, V), d])``."""
    rng = np.random.default_rng(seed)
    lead = (S, V) if V > 1 else (S,)
    return (rng.normal(size=lead + (d, d)).astype(np.float32) * 0.3,
            rng.normal(size=lead + (d,)).astype(np.float32) * 0.1)


def microbatches(m: int, seed: int = 1):
    return np.random.default_rng(seed).normal(size=(m, 3, 16)).astype(
        np.float32)


def jax_stage(p, x, r):
    W, b = p
    return jnp.tanh(x @ W + b)


def torch_stage(p, x, r):
    W, b = p
    return torch.tanh(x @ W + b)


def jax_reference(V: int, m: int):
    """JAX's pipeline_apply on a pipe axis of 4 devices: the outputs and
    the gradients of ``sum(y ** 2)``, as numpy."""
    params = tuple(jnp.asarray(a) for a in stage_stack(4, V))
    x = jnp.asarray(microbatches(m))
    mesh = build_mesh({"pipe": 4}, jax.devices()[:4])

    def run(p):
        return jpipeline.pipeline_apply(jax_stage, p, x, mesh, n_chunks=V)

    y = jax.jit(run)(params)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(run(p) ** 2)))(params)
    return np.asarray(y), [np.asarray(g) for g in grads]


def _sequential(params, x, V):
    """The stages in virtual order ``g = v*S + s``, one microbatch at a
    time: the plain loop."""
    W, b = params
    if V > 1:
        W = W.transpose(0, 1).reshape((-1,) + tuple(W.shape[2:]))
        b = b.transpose(0, 1).reshape((-1,) + tuple(b.shape[2:]))
    out = []
    for mb in x:
        for g in range(W.shape[0]):
            mb = torch.tanh(mb @ W[g] + b[g])
        out.append(mb)
    return torch.stack(out)


@pytest.mark.parametrize("V, m", CASES)
def test_no_pipe_axis_equals_sequential_and_jax(V, m):
    want_y, want_g = jax_reference(V, m)
    x = torch.tensor(microbatches(m))
    outs, grads = [], []
    for fn in (lambda p: pipeline.pipeline_apply(torch_stage, p, x, None,
                                                 n_chunks=V),
               lambda p: _sequential(p, x, V)):
        params = tuple(torch.tensor(a, requires_grad=True)
                       for a in stage_stack(4, V))
        y = fn(params)
        (y ** 2).sum().backward()
        outs.append(y.detach().numpy())
        grads.append([p.grad.numpy() for p in params])
    np.testing.assert_array_equal(outs[0], outs[1])
    for got, ref in zip(grads[0], grads[1]):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(outs[0], want_y, **FWD_TOL)
    for got, ref in zip(grads[0], want_g):
        np.testing.assert_allclose(got, ref, **GRAD_TOL)


def test_no_pipe_axis_folds_the_stage_seeds():
    """Without a pipe axis each virtual stage gets ``_stage_rng(rng, g,
    0)``; none without ``rng``."""
    seen = []

    def fn(p, x, r):
        seen.append(r)
        return x

    x = torch.zeros((2, 1, 4))
    params = torch.zeros((2, 3, 4))      # S 2, V 3
    pipeline.pipeline_apply(fn, params, x, None, rng=7, n_chunks=3)
    assert seen == [pipeline._stage_rng(7, g, 0) for g in range(6)] * 2
    seen.clear()
    pipeline.pipeline_apply(fn, params, x, None, n_chunks=3)
    assert seen == [None] * 12


@pytest.mark.parametrize("S, V", [(4, 1), (2, 2), (4, 3), (2, 3)])
def test_regroup_and_stacked_lead_equal_jax(S, V):
    L = 12
    a = np.arange(L * 2 * 3, dtype=np.float32).reshape(L, 2, 3)
    want = np.asarray(jpipeline.regroup_for_pipeline(jnp.asarray(a), S, V))
    got = pipeline.regroup_for_pipeline(torch.tensor(a), S, V)
    np.testing.assert_array_equal(got.numpy(), want)
    assert pipelined._stacked_lead(L, S, V) == jpipelined._stacked_lead(
        L, S, V)
    # the dense stacking's interleave is the regroup's
    dense = {f"h.{i}.w": torch.tensor(a[i]) for i in range(L)}
    stacked = pipelined._stacked_layers(dense, "h", lambda p: dense[p + "w"],
                                        S, V)
    np.testing.assert_array_equal(stacked.numpy(),
                                  a if V == 1 else want)


def test_layout_refusals_equal_jax():
    for fn in (lambda: pipeline.regroup_for_pipeline(torch.zeros(6, 2), 4),
               lambda: pipelined._stacked_lead(6, 4, 1),
               lambda: pipelined._stacked_lead(8, 2, 3)):
        with pytest.raises(ValueError, match="not divisible"):
            fn()
    with pytest.raises(ValueError, match="not divisible"):
        jpipelined._stacked_lead(8, 2, 3)
    with pytest.raises(ValueError, match="n_chunks"):
        pipeline.pipeline_apply(torch_stage, torch.zeros(1), torch.zeros(
            (1, 1)), None, n_chunks=0)
