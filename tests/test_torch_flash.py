"""The port's flash attention (plain version, CPU) against the JAX
package's ``flash_attention`` / ``flash_attention_lse`` (Pallas kernel in
interpret mode on the CPU). The CUDA kernel itself is held against the
plain version on the card by tests/test_torch_kernels_cuda.py and
chip_smoke.py.

Inputs come from a seeded numpy generator and go to both packages as the
same float32 arrays. Tolerance: atol 1e-5 on out and lse (float32, the two
sides differ only in summation order).
"""
import numpy as np
import pytest
import torch

from pytorch_distributed_template_tpu.ops import flash as jflash
from pytorch_distributed_template_tpu_torch.ops import flash as tflash

ATOL = 1e-5
B, H, D = 2, 4, 16


def _qkv(t, kv_heads=H, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, t, H, D)).astype(np.float32)
    k = rng.normal(size=(B, t, kv_heads, D)).astype(np.float32)
    v = rng.normal(size=(B, t, kv_heads, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [16, 40, 64])
def test_flash_lse_matches_jax(t, causal, window):
    q, k, v = _qkv(t, seed=t)
    j_out, j_lse = jflash.flash_attention_lse(q, k, v, causal=causal,
                                              window=window)
    t_out, t_lse = tflash.flash_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window)
    assert t_out.shape == (B, t, H, D) and t_lse.shape == (B, H, t)
    assert t_lse.dtype == torch.float32
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=ATOL)


def test_flash_banded_grid_matches_jax():
    """Blocks of 8 at T=64 with window 8 make the JAX side take its banded
    grid (only the KV tiles of each q block's band are visited)."""
    q, k, v = _qkv(64, seed=3)
    j_out = jflash.flash_attention(q, k, v, causal=True, block_q=8,
                                   block_k=8, window=8)
    j_out2, j_lse = jflash.flash_attention_lse(q, k, v, causal=True,
                                               block_q=8, block_k=8,
                                               window=8)
    t_out, t_lse = tflash.flash_attention_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True, window=8)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out2), atol=ATOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=ATOL)


@pytest.mark.parametrize("window", [0, 8])
def test_flash_attention_gqa_matches_repeated_jax(window):
    """k/v at 2 kv heads in the port == the JAX function on the repeated
    (4-head) k/v: query head h reads kv head h // 2."""
    q, k, v = _qkv(40, kv_heads=2, seed=11)
    kr, vr = np.repeat(k, 2, axis=2), np.repeat(v, 2, axis=2)
    j_out = jflash.flash_attention(q, kr, vr, causal=True, window=window)
    t_out = tflash.flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True,
        window=window)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL)


def test_flash_rejects_bad_shapes():
    q, k, v = (torch.zeros(1, 8, 4, 16) for _ in range(3))
    with pytest.raises(ValueError):
        tflash.flash_attention(q, k[:, :4], v[:, :4])      # Tq != Tk
    with pytest.raises(ValueError):
        tflash.flash_attention(q, k[:, :, :3], v[:, :, :3])  # 4 % 3 heads


def test_bound_counts_visible_keys():
    assert tflash.visible_keys(4, causal=True, window=0) == 10
    assert tflash.visible_keys(4, causal=True, window=2) == 7
    assert tflash.visible_keys(4, causal=False, window=0) == 16
    secs, by = tflash.flash_bound_seconds(1, 1024, 32, 8, 128, True, 4096,
                                          2, 989e12, 3.35e12)
    assert by == "operations"
    assert secs == pytest.approx(4 * 32 * 128 * (1024 * 1025 // 2) / 989e12)


@pytest.mark.parametrize("t, causal, window", [
    (1, True, 0), (1024, True, 0), (1000, True, 100), (6144, True, 4096),
    (300, False, 77), (257, False, 0),
])
def test_phase_profile_counts_the_tiles_the_kernel_walks(t, causal,
                                                         window):
    """The B1 phase tool's per-tile normalisation: the kernel walks, per
    (batch, head), exactly the 128 x 128 blocks of the score matrix that
    hold a visible key."""
    from pytorch_distributed_template_tpu_torch.tools import flash_fwd_phases

    tile = flash_fwd_phases.BQ
    n = -(-t // tile)
    mask = tflash.visible_mask(t, t, causal, window)
    mask = torch.nn.functional.pad(mask, (0, n * tile - t, 0, n * tile - t))
    blocks = mask.reshape(n, tile, n, tile).any(dim=3).any(dim=1)
    assert flash_fwd_phases.kv_tiles(t, causal, window) == int(blocks.sum())
