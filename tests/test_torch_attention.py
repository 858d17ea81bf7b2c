"""The port's plain attention (ops/attention.py) against the JAX package's
``multihead_attention`` and ``grouped_query_attention`` on the same numpy
inputs: causal and windowed masks, an explicit decode-style mask, GQA at
stored K/V width. Tolerance: atol 1e-5 (float32, summation order only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_template_tpu.ops import attention as jatt
from pytorch_distributed_template_tpu_torch.ops import attention as tatt

ATOL = 1e-5


def _arrays(b, tq, tk, h, kvh, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, tq, h, d)).astype(np.float32),
            rng.normal(size=(b, tk, kvh, d)).astype(np.float32),
            rng.normal(size=(b, tk, kvh, d)).astype(np.float32))


@pytest.mark.parametrize("causal, window", [(True, 0), (True, 5),
                                            (False, 0), (False, 5)])
def test_multihead_attention_matches_jax(causal, window):
    q, k, v = _arrays(2, 12, 12, 4, 4, 8, seed=window + causal)
    j = jatt.multihead_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 window=window)
    t = tatt.multihead_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 window=window)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


@pytest.mark.parametrize("kvh", [4, 2, 1])
@pytest.mark.parametrize("mask_dims", [2, 3, 4])
def test_grouped_query_attention_matches_jax(kvh, mask_dims):
    """A decode step: 3 new queries over a 10-slot cache, keys visible up
    to each query's position (the last ones empty for row 1)."""
    q, k, v = _arrays(2, 3, 10, 4, kvh, 8, seed=kvh)
    pos = np.arange(6, 9)[:, None]
    mask = np.arange(10)[None, :] <= pos                      # [T, L]
    if mask_dims == 3:
        mask = np.stack([mask, mask & (np.arange(10) < 7)])  # [B, T, L]
    elif mask_dims == 4:
        mask = mask[None, None]
    j = jatt.grouped_query_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), mask=jnp.asarray(mask))
    t = tatt.grouped_query_attention(torch.from_numpy(q),
                                     torch.from_numpy(k),
                                     torch.from_numpy(v),
                                     mask=torch.from_numpy(mask))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


def test_grouped_query_attention_refuses_bad_heads():
    q, k, v = (torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 3, 8),
               torch.zeros(1, 2, 3, 8))
    with pytest.raises(ValueError, match="multiple"):
        tatt.grouped_query_attention(q, k, v)
