"""The port's flash backward (plain version and autograd, CPU) against the
JAX package's: the Pallas backward kernels in interpret mode
(``_bwd_pallas_3d``), their blockwise oracle (``_bwd_3d``) and
``jax.grad`` through ``flash_attention`` / ``flash_attention_lse`` (GQA
through ``jnp.repeat``). The CUDA kernels B2/B3 are held against the plain
version on the card by tests/test_torch_kernels_cuda.py and chip_smoke.py.

Inputs come from a seeded numpy generator and go to both packages as the
same float32 arrays. Tolerance: atol = rtol = 1e-4 (float32 on both sides,
summation orders differ; the JAX package's own Pallas-vs-oracle test uses
the same).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_template_tpu.ops import flash as jflash
from pytorch_distributed_template_tpu_torch.ops import flash as tflash

TOL = dict(atol=1e-4, rtol=1e-4)


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("causal, window, t_valid", [
    (True, 0, 128), (False, 0, 128), (True, 32, 128), (False, 24, 128),
    (True, 0, 100), (False, 0, 100),
])
def test_bwd_ref_matches_pallas_backward_and_oracle(causal, window, t_valid):
    """JAX layout [BH, T, D] (T padded to the block lcm, ``t_valid`` real
    rows) vs the port's [1, T, BH, D] on the ``t_valid`` rows."""
    rng = np.random.default_rng(10 + window + t_valid)
    bh, t, d = 4, 128, 32
    q, k, v, g = (_rand(rng, bh, t, d) for _ in range(4))
    if t_valid < t:   # padded rows are zeros, as the JAX wrappers pad
        for x in (q, k, v, g):
            x[:, t_valid:] = 0.0
    out, lse = jflash._flash_fwd_3d(
        q, k, v, causal=causal, block_q=64, block_k=32, t_valid=t_valid,
        interpret=True, window=window)
    res = (q, k, v, out, lse)
    oracle = jflash._bwd_3d(causal, 32, t_valid, res, g, window=window)
    pallas = jflash._bwd_pallas_3d(causal, 64, 32, t_valid, True, res, g,
                                   window=window)

    def port(x):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(x)[:, :t_valid].transpose(1, 0, 2)[None]))

    got = tflash.flash_attention_bwd_ref(
        port(q), port(k), port(v), port(out),
        torch.from_numpy(np.asarray(lse)[None, :, :t_valid].copy()),
        port(g), causal=causal, window=window)
    for mine, o, p in zip(got, oracle, pallas):
        mine = mine[0].numpy().transpose(1, 0, 2)
        _close(mine, np.asarray(o)[:, :t_valid])
        _close(mine, np.asarray(p)[:, :t_valid])


def _jax_grads(fn, args, cot):
    _, vjp = jax.vjp(fn, *args)
    return vjp(cot)


@pytest.mark.parametrize("window", [0, 12])
def test_gqa_grads_match_jax_grad_through_repeat(window):
    """dK/dV at the kv-head width, summed over each group: exactly what
    ``jnp.repeat``'s VJP gives (the JAX Llama's GQA)."""
    rng = np.random.default_rng(3 + window)
    b, t, h, kvh, d = 2, 40, 6, 2, 16
    q, g = _rand(rng, b, t, h, d), _rand(rng, b, t, h, d)
    k, v = _rand(rng, b, t, kvh, d), _rand(rng, b, t, kvh, d)
    groups = h // kvh

    def jfn(q, k, v):
        return jflash.flash_attention(
            q, jnp.repeat(k, groups, axis=2), jnp.repeat(v, groups, axis=2),
            causal=True, block_q=16, block_k=16, window=window)

    want = _jax_grads(jfn, (q, k, v), g)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = tflash.flash_attention_ref(tq, tk, tv, causal=True,
                                          window=window)
    got = tflash.flash_attention_bwd_ref(tq, tk, tv, out, lse,
                                         torch.from_numpy(g), causal=True,
                                         window=window)
    for mine, ref in zip(got, want):
        assert mine.shape == ref.shape
        _close(mine.numpy(), ref)
    # the autograd path (FlashAttention on CPU tensors) gives the same
    xs = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    tflash.flash_attention(*xs, causal=True, window=window).backward(
        torch.from_numpy(g))
    for x, ref in zip(xs, want):
        _close(x.grad.numpy(), ref)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_cotangent_matches_jax_grad(causal):
    """Gradients through both outputs of ``flash_attention_lse``: the lse
    cotangent folds into delta (``delta - g_lse``)."""
    rng = np.random.default_rng(21)
    b, t, h, d = 1, 48, 4, 16
    q, k, v, g = (_rand(rng, b, t, h, d) for _ in range(4))
    g_lse = _rand(rng, b, h, t)

    def jfn(q, k, v):
        return jflash.flash_attention_lse(q, k, v, causal=causal,
                                          block_q=16, block_k=16)

    want = _jax_grads(jfn, (q, k, v), (g, g_lse))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, lse = tflash.flash_attention_lse(*xs, causal=causal)
    torch.autograd.backward((out, lse), (torch.from_numpy(g),
                                         torch.from_numpy(g_lse)))
    for x, ref in zip(xs, want):
        _close(x.grad.numpy(), ref)


@pytest.mark.parametrize("causal, window, kvh", [
    (True, 0, 4), (True, 9, 2), (False, 0, 1), (False, 7, 4)])
def test_autograd_matches_autograd_through_plain_forward(causal, window,
                                                         kvh):
    """The autograd.Function's CPU backward (the plain backward) against
    torch autograd through ``flash_attention_ref``."""
    rng = np.random.default_rng(kvh + window)
    b, t, h, d = 2, 33, 4, 8
    arrays = (_rand(rng, b, t, h, d), _rand(rng, b, t, kvh, d),
              _rand(rng, b, t, kvh, d))
    g = torch.from_numpy(_rand(rng, b, t, h, d))
    g_lse = torch.from_numpy(_rand(rng, b, h, t))
    grads = []
    for fn in (tflash.flash_attention_lse, tflash.flash_attention_ref):
        xs = [torch.from_numpy(x).requires_grad_() for x in arrays]
        out, lse = fn(*xs, causal=causal, window=window)
        torch.autograd.backward((out, lse), (g, g_lse))
        grads.append([x.grad.numpy() for x in xs])
    for a, b_ in zip(*grads):
        _close(a, b_)


def test_bwd_bound_counts_the_visible_work():
    """B2 does 8 and B3 6 FLOPs per (query, visible key, head dim); bytes
    are each input read once and each output written once: B3 reads q, g,
    out, k, v, lse (and the lse cotangent) and writes dq and delta."""
    from pytorch_distributed_template_tpu_torch.ops.flash import (
        flash_bwd_bound_seconds, visible_keys,
    )

    b, t, h, kvh, d = 2, 64, 4, 2, 32
    vis = visible_keys(t, True, 0)
    assert vis == t * (t + 1) // 2
    s, by = flash_bwd_bound_seconds("flash_bwd_dkv", b, t, h, kvh, d, True,
                                    0, 2, 1.0, 1e30)
    assert by == "operations" and s == 8.0 * b * h * d * vis
    s, by = flash_bwd_bound_seconds("flash_bwd_dq", b, t, h, kvh, d, True,
                                    0, 2, 1e30, 1.0)
    q_bytes, kv_bytes = 2 * b * t * h * d, 2 * b * t * kvh * d
    assert by == "bytes"
    assert s == 4 * q_bytes + 2 * kv_bytes + 8 * b * h * t
    s, _ = flash_bwd_bound_seconds("flash_bwd_dq", b, t, h, kvh, d, True,
                                   0, 2, 1e30, 1.0, lse_cotangent=True)
    assert s == 4 * q_bytes + 2 * kv_bytes + 12 * b * h * t
    s, _ = flash_bwd_bound_seconds("flash_bwd_dkv", b, t, h, kvh, d, True,
                                   0, 2, 1e30, 1.0)
    assert s == 2 * q_bytes + 4 * kv_bytes + 8 * b * h * t


def test_pair_bound_counts_the_function_once():
    """The whole backward's bound: 10 FLOPs per (query, visible key, head
    dim), less than B2's 8 plus B3's 6 (B3 recomputes S and dP); q, g,
    out, k, v, lse (and the lse cotangent) read and dq, dk, dv written
    once (delta, passed from B3 to B2, is not the function's)."""
    from pytorch_distributed_template_tpu_torch.ops.flash import (
        flash_bwd_bound_seconds, visible_keys,
    )
    b, t, h, kvh, d = 2, 100, 8, 2, 64
    vis = visible_keys(t, True, 0)
    s, by = flash_bwd_bound_seconds("flash_bwd_pair", b, t, h, kvh, d, True,
                                    0, 2, 1.0, 1e30)
    assert by == "operations" and s == 10.0 * b * h * d * vis
    q_bytes, kv_bytes = 2 * b * t * h * d, 2 * b * t * kvh * d
    for with_lse, rows in ((False, 1), (True, 2)):
        s, by = flash_bwd_bound_seconds("flash_bwd_pair", b, t, h, kvh, d,
                                        True, 0, 2, 1e30, 1.0,
                                        lse_cotangent=with_lse)
        assert by == "bytes"
        assert s == 4 * q_bytes + 4 * kv_bytes + rows * 4 * b * h * t
    pair = flash_bwd_bound_seconds("flash_bwd_pair", b, t, h, kvh, d, True,
                                   0, 2, 1.0, 1.0)[0]
    both = sum(flash_bwd_bound_seconds(kern, b, t, h, kvh, d, True, 0, 2,
                                       1.0, 1.0)[0]
               for kern in ("flash_bwd_dkv", "flash_bwd_dq"))
    assert pair < both


# ---------------------------------------------------------------------------
# what the bf16 kernels walk, written out on the host: a specification of
# DqWork and DkvWork in csrc/flash_bwd.cu, to be kept in step with them
# ---------------------------------------------------------------------------

TILE_ROWS = 64   # the rows of a streamed tile (keys in B3, queries in B2)


def dq_key_tiles(q0: int, t: int, causal: bool, window: int) -> range:
    """The key-tile starts that B3's item of the 128 queries from ``q0``
    walks (``DqWork``): from the band's lower edge, floored to a tile, to
    the diagonal (causal) or T."""
    k_lo = max(0, q0 - window + 1) if window > 0 else 0
    k_lo = k_lo // TILE_ROWS * TILE_ROWS
    k_hi = min(t, q0 + tflash.BWD_ITEM_ROWS) if causal else t
    return range(k_lo, k_hi, TILE_ROWS)


def dkv_query_tiles(k0: int, t: int, causal: bool, window: int) -> range:
    """The query-tile starts that B2's item of the 128 keys from ``k0``
    walks per query head (``DkvWork``): from the diagonal (causal) or 0 to
    the last query whose band reaches the item's last key, or T."""
    q_lo = k0 // TILE_ROWS * TILE_ROWS if causal else 0
    k_last = min(k0 + tflash.BWD_ITEM_ROWS, t) - 1
    q_hi = min(t, k_last + window) if window > 0 else t
    return range(q_lo, q_hi, TILE_ROWS)

@pytest.mark.parametrize("t", [1, 63, 64, 65, 200, 1000, 1024])
@pytest.mark.parametrize("window", [0, 1, 17, 64, 512])
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_tiles_cover_every_visible_pair_once(t, window, causal):
    """Every visible (query, key) pair lies in exactly one tile that B3's
    item of its query walks and in exactly one that B2's item of its key
    walks; no walked tile holds no visible pair."""
    ok = tflash.visible_mask(t, t, causal, window).numpy()
    item, tile = tflash.BWD_ITEM_ROWS, TILE_ROWS
    for by_query in (True, False):
        seen = np.zeros((t, t), np.int32)
        for r0 in range(0, t, item):
            rows = slice(r0, min(t, r0 + item))
            walk = (dq_key_tiles if by_query
                    else dkv_query_tiles)(r0, t, causal, window)
            for c0 in walk:
                cols = slice(c0, min(t, c0 + tile))
                if by_query:
                    block, counts = ok[rows, cols], seen[rows, cols]
                else:
                    block, counts = ok[cols, rows], seen[cols, rows]
                assert block.any(), (by_query, r0, c0)
                counts += block
        np.testing.assert_array_equal(seen, ok.astype(np.int32))


@pytest.mark.parametrize("b, t, h, kvh, causal, window, want", [
    (8, 1024, 12, 12, True, 0, 1),     # GPT-2 small: no groups
    (32, 512, 8, 8, True, 0, 1),       # the MoE LM
    (1, 2048, 32, 8, True, 0, 2),      # Mistral GQA: 128 uneven items
    (2, 2048, 16, 4, True, 512, 1),    # a band evens the items out
    (1, 300, 8, 2, False, 0, 1),       # so does no causal mask
    (1, 300, 8, 2, True, 300, 4),      # a band as wide as T is no band
    (1, 33 * 128, 16, 4, True, 0, 1),  # 132 items: one per SM
    (1, 131 * 128, 4, 1, True, 0, 2),  # 131 items: one short
    (1, 300, 8, 2, True, 0, 4),        # none reaches: the whole group
    (1, 256, 6, 1, True, 0, 6),
])
def test_bwd_splits(b, t, h, kvh, causal, window, want):
    got = tflash.bwd_splits(b, t, h, kvh, causal, window, 132)
    assert got == want
    assert (h // kvh) % got == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_kernels_refuse_other_head_dims(dtype):
    """Both arms take the head dims of ``HEAD_DIMS``; the wrapper refuses
    any other before it builds or launches anything."""
    q, k, v, g = (torch.zeros(1, 8, 2, 16, dtype=dtype) for _ in range(4))
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="head_dim"):
        tflash._flash_bwd_cuda(q, k, v, q, g, lse, None, True, 0)


def test_cuda_backward_computes_delta_in_the_kernel(monkeypatch):
    """On a CUDA tensor ``flash_attention_bwd`` goes straight to the
    kernels (B3 computes delta): no eager ``_delta``; the plain backward
    still uses it."""
    rng = np.random.default_rng(5)
    q, k, v, g = (torch.from_numpy(_rand(rng, 1, 8, 2, 16))
                  for _ in range(4))
    out, lse = tflash.flash_attention_ref(q, k, v)
    seen = {}

    def kernels(q_, k_, v_, out_, g_, lse_, g_lse, causal, window):
        seen.update(out=out_, g_lse=g_lse, causal=causal)
        return torch.zeros_like(q_), torch.zeros_like(k_), \
            torch.zeros_like(v_), None

    def no_delta(*args, **kw):
        raise AssertionError("eager delta on the kernel path")

    monkeypatch.setattr(tflash, "_device_kind", lambda x: "cuda")
    monkeypatch.setattr(tflash, "_flash_bwd_cuda", kernels)
    monkeypatch.setattr(tflash, "_delta", no_delta)
    tflash.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    assert torch.equal(seen["out"], out) and seen["g_lse"] is None
    monkeypatch.undo()
    calls = []
    real = tflash._delta
    monkeypatch.setattr(tflash, "_delta",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tflash.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    assert calls == [1]
