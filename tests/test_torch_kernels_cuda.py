"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here needs a CUDA device and skips
without one; the file imports nothing of JAX, so on a machine without JAX
it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_kernels_cuda.py

B1 (``csrc/flash_fwd.cu``) is held against ``flash_attention_ref`` and B4
(``csrc/paged_attn.cu``, both its single-block and its split-over-pages
arms) against ``paged_attention_ref``, valid query lanes only (pad lanes
must be exactly 0).

Tolerances: against the plain version computed in float32 from the same
inputs. bfloat16: ``|out - ref| <= 1e-2 + 1.6e-2 |ref|`` (torch.testing's
bf16 rtol): the output is rounded to bf16 once (2^-8 relative) and the
tensor-core kernel rounds the probabilities to bf16 for P.V (2^-9
relative each). float32 outputs (CUDA cores) and lse (f32 sums of exact
bf16 products) differ by summation order only.
"""
import pytest
import torch

from pytorch_distributed_template_tpu_torch.ops import flash

pytestmark = pytest.mark.cuda
TOL_OUT = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-2, 1.6e-2)}
TOL_LSE = 1e-3


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash_fwd kernel has no CPU "
                    "mode (chip_smoke.py runs it on the card)")
    return torch.device("cuda")


def _qkv(device, b, t, h, kvh, d, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(heads):
        return torch.randn(b, t, heads, d, generator=gen,
                           device=device).to(dtype)

    return rnd(h), rnd(kvh), rnd(kvh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t, causal, window", [
    (200, True, 64), (200, True, 0), (77, False, 0), (130, False, 32),
    (1, True, 0),
])
def test_flash_fwd_matches_plain(cuda, d, dtype, t, causal, window):
    q, k, v = _qkv(cuda, 2, t, 8, 2, d, dtype, seed=d + t)
    before = flash.FLASH_FWD.launches
    out, lse = flash.flash_attention_lse(q, k, v, causal=causal,
                                         window=window)
    torch.cuda.synchronize()
    assert flash.FLASH_FWD.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (2, 8, t)
    ref_out, ref_lse = flash.flash_attention_ref(
        q.float(), k.float(), v.float(), causal=causal, window=window)
    atol, rtol = TOL_OUT[dtype]
    torch.testing.assert_close(out.float(), ref_out, atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=TOL_LSE, rtol=0.0)


def test_flash_fwd_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 16, 4, 4, 16, torch.float32, seed=0)
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_attention(q, k, v)
    q, k, v = _qkv(cuda, 1, 16, 4, 4, 64, torch.float16, seed=0)
    with pytest.raises(TypeError):
        flash.flash_attention(q, k, v)
    q, k, v = _qkv(cuda, 1, 16, 4, 4, 64, torch.float32, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_attention(q[:, ::2], k[:, ::2], v[:, ::2])
    with pytest.raises(TypeError):
        flash.flash_attention(q, k.bfloat16(), v)
    # the bf16 kernel reads 16-byte vectors
    flat = torch.zeros(1 + 16 * 4 * 64, device=cuda, dtype=torch.bfloat16)
    q = flat[1:].view(1, 16, 4, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        flash.flash_attention(q, q, q)


# ---------------------------------------------------------------------------
# B4: paged attention (csrc/paged_attn.cu) against paged_attention_ref
# ---------------------------------------------------------------------------


def _paged_inputs(device, *, b, t, hq, kvh, d, bt, nb, window, dtype,
                  quant, seed, pads=None):
    """Random pools, shuffled tables and positions. Flat tables hold
    ``lens[i] = starts[i] + t`` tokens (trailing lanes -1); ring tables
    are full rings at deep positions (row 0 leaves its last slot
    unallocated)."""
    from pytorch_distributed_template_tpu_torch.models.quant import (
        quantize_kv,
    )

    gen = torch.Generator().manual_seed(seed)
    pool = b * nb + 2
    q = torch.randn(b, t, hq, d, generator=gen)
    kp = torch.randn(pool, bt, kvh, d, generator=gen)
    vp = torch.randn(pool, bt, kvh, d, generator=gen)
    ks = vs = None
    if quant:
        kp, ks = quantize_kv(kp)
        vp, vs = quantize_kv(vp)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    tables = (torch.randperm(pool - 1, generator=gen)[:b * nb] + 1).view(
        b, nb).int()
    if window > 0:
        starts = torch.randint(300, 6000, (b,), generator=gen).int()
        tables[0, -1] = -1
    else:
        lens = torch.randint(t, nb * bt + 1, (b,), generator=gen)
        starts = (lens - t).int()
        for i in range(b):
            tables[i, -(-int(lens[i]) // bt):] = -1
    pads = (torch.zeros(b, dtype=torch.int32) if pads is None
            else torch.tensor(pads, dtype=torch.int32))
    out = [q.to(dtype), kp, vp, tables, starts, pads]
    out = [x.to(device).contiguous() for x in out]
    if quant:
        ks, vs = ks.to(device), vs.to(device)
    return out, ks, vs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("d,bt", [(64, 8), (128, 16), (128, 32)])
@pytest.mark.parametrize("t,window,pads", [
    (1, 0, None), (1, 64, None), (8, 0, [0, 3, 7]), (8, 48, [2, 0, 0]),
    (37, 0, [5, 0, 36]), (37, 64, [0, 1, 0]),
])
@pytest.mark.parametrize("splits", [None, 1, 3], ids=["auto", "s1", "s3"])
@pytest.mark.parametrize("arm", ["auto", "cuda_cores"])
def test_paged_attn_matches_plain(cuda, dtype, quant, d, bt, t, window,
                                  pads, splits, arm):
    (q, kp, vp, tables, starts, pad_lens), ks, vs = _paged_inputs(
        cuda, b=3, t=t, hq=8, kvh=2, d=d, bt=bt, nb=64 // bt + 3,
        window=window, dtype=dtype, quant=quant, seed=d + t + bt + window)
    if pads is not None:
        pad_lens = torch.tensor(pads, dtype=torch.int32, device=cuda)
    before = flash.PAGED_ATTN.launches
    if splits is None and arm == "auto":
        out = flash.paged_attention(q, kp, vp, tables, starts, pad_lens,
                                    window=window, k_scale=ks, v_scale=vs)
    else:
        # force the split count and/or the CUDA-core arm (bf16 with 16- or
        # 32-token pages otherwise runs on the tensor cores)
        out = flash._paged_cuda(
            q, kp, vp, tables, starts, pad_lens, window, ks, vs,
            splits=splits, tensor_cores=False if arm == "cuda_cores"
            else None)
    torch.cuda.synchronize()
    assert flash.PAGED_ATTN.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    f32 = (lambda x: x) if quant else (lambda x: x.float())
    ref = flash.paged_attention_ref(q.float(), f32(kp), f32(vp), tables,
                                    starts, pad_lens, window=window,
                                    k_scale=ks, v_scale=vs)
    atol, rtol = TOL_OUT[dtype]
    for i, p in enumerate(pad_lens.tolist()):
        torch.testing.assert_close(out[i, p:].float(), ref[i, p:],
                                   atol=atol, rtol=rtol)
        # a lane that sees no key (a pad lane) gives exactly 0
        assert not out[i, :p].float().abs().any()


def test_paged_attn_refuses_what_it_does_not_take(cuda):
    (q, kp, vp, tables, starts, pads), _, _ = _paged_inputs(
        cuda, b=2, t=1, hq=4, kvh=2, d=64, bt=8, nb=4, window=0,
        dtype=torch.float32, quant=False, seed=0)
    with pytest.raises(TypeError, match="int32"):
        flash.paged_attention(q, kp, vp, tables.long(), starts, pads)
    with pytest.raises(TypeError):
        flash.paged_attention(q.half(), kp.half(), vp.half(), tables,
                              starts, pads)
    with pytest.raises(TypeError):
        flash.paged_attention(q, kp.bfloat16(), vp.bfloat16(), tables,
                              starts, pads)
    with pytest.raises(ValueError, match="head_dim"):
        flash.paged_attention(q[..., :32].contiguous(),
                              kp[..., :32].contiguous(),
                              vp[..., :32].contiguous(), tables, starts,
                              pads)
    with pytest.raises(ValueError, match="contiguous"):
        flash.paged_attention(q, kp, vp, tables.t().contiguous().t(),
                              starts, pads)


# ---------------------------------------------------------------------------
# B2/B3: the flash backward (csrc/flash_bwd.cu) against flash_attention_bwd_ref
# ---------------------------------------------------------------------------
# Tolerances, against the plain backward in float32 on the same inputs
# (lse and out from the kernel's forward): |got - ref| <= a * max|ref| +
# r * |ref| + 1e-5. bf16 (a, r) = (1e-2, 1.6e-2): the kernels round P and dS
# to bf16 as operands of their products (2^-9 relative each) and the
# gradients to bf16 once (2^-8). float32 (1e-5, 1e-4): summation order
# only. The 1e-5 floor covers gradients that are exactly 0 in exact
# arithmetic (T = 1: dS = P (dP - delta) with dP = delta), where both sides
# hold f32 rounding noise of ~1e-7.
TOL_BWD = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 1.6e-2)}


def _assert_grad_close(got, ref, dtype, what):
    a, r = TOL_BWD[dtype]
    ref = ref.float()
    err = (got.float() - ref).abs()
    limit = a * ref.abs().max() + r * ref.abs() + 1e-5
    assert bool((err <= limit).all()), (
        f"{what}: max err {err.max().item():.3e} (max |ref| "
        f"{ref.abs().max().item():.3e})")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("b, h, kvh, t, causal, window", [
    (2, 4, 4, 200, True, 0), (1, 8, 2, 200, True, 64),
    (2, 4, 1, 77, False, 0), (1, 4, 2, 130, False, 32),
    (1, 2, 2, 1, True, 0), (1, 6, 3, 257, True, 0),
])
def test_flash_bwd_matches_plain(cuda, d, dtype, b, h, kvh, t, causal,
                                 window):
    q, k, v = _qkv(cuda, b, t, h, kvh, d, dtype, seed=3 * d + t)
    out, lse = flash.flash_attention_lse(q, k, v, causal=causal,
                                         window=window)
    g = torch.randn(out.shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(t)
                    ).to(dtype)
    dkv0, dq0 = flash.FLASH_BWD_DKV.launches, flash.FLASH_BWD_DQ.launches
    dq, dk, dv = flash.flash_attention_bwd(q, k, v, out, lse, g,
                                           causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash.FLASH_BWD_DKV.launches == dkv0 + 1
    assert flash.FLASH_BWD_DQ.launches == dq0 + 1
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    ref = flash.flash_attention_bwd_ref(
        q.float(), k.float(), v.float(), out.float(), lse, g.float(),
        causal=causal, window=window)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        _assert_grad_close(got, want, dtype, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_autograd_with_lse_cotangent(cuda, dtype):
    """Gradients through both outputs: autograd over FlashAttention (B1,
    B2, B3) against the plain backward with the same cotangents."""
    q, k, v = _qkv(cuda, 2, 96, 8, 2, 64, dtype, seed=11)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out, lse = flash.flash_attention_lse(q, k, v, causal=True, window=40)
    gen = torch.Generator(device=cuda).manual_seed(5)
    g = torch.randn(out.shape, device=cuda, generator=gen).to(dtype)
    g_lse = torch.randn(lse.shape, device=cuda, generator=gen)
    torch.autograd.backward((out, lse), (g, g_lse))
    ref = flash.flash_attention_bwd_ref(
        q.detach().float(), k.detach().float(), v.detach().float(),
        out.detach().float(), lse.detach(), g.float(), causal=True,
        window=40, g_lse=g_lse)
    for name, x, want in zip(("dq", "dk", "dv"), (q, k, v), ref):
        _assert_grad_close(x.grad, want, dtype, name)


def test_flash_bwd_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 16, 4, 4, 64, torch.float32, seed=0)
    out, lse = flash.flash_attention_lse(q, k, v)
    with pytest.raises(TypeError):
        flash.flash_attention_bwd(q, k, v, out, lse, out.bfloat16())
    q16 = q[..., :16].contiguous()
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_attention_bwd(q16, q16, q16, q16, lse, q16)
