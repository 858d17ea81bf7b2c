"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here needs a CUDA device and skips
without one; the file imports nothing of JAX, so on a machine without JAX
it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_kernels_cuda.py

B1 (``csrc/flash_fwd.cu``) is held against ``flash_attention_ref``, B2
and B3 (``csrc/flash_bwd.cu``: bf16 TMA/wgmma arms, split GQA items,
bitwise repeatability; f32 CUDA-core arms) against
``flash_attention_bwd_ref``, B5
(``csrc/expert_ffn.cu``) against ``expert_ffn_ref`` and B4
(``csrc/paged_attn.cu``: its wgmma, decode and CUDA-core arms, each
single-block and split over pages) against ``paged_attention_ref``, valid
query lanes only (pad lanes must be exactly 0). B4 alone:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_kernels_cuda.py -k paged Before them, one-tile probes (``csrc/wgmma_probe.cu``)
hold each wgmma operand layout that B1 and B5 use (K-major and MN-major,
64- and 128-byte swizzle, A from shared memory or registers) against
``torch.matmul``.

Tolerances: against the plain version computed in float32 from the same
inputs. bfloat16: ``|out - ref| <= 1e-2 + 1.6e-2 |ref|`` (torch.testing's
bf16 rtol): the output is rounded to bf16 once (2^-8 relative) and the
tensor-core kernel rounds the probabilities to bf16 for P.V (2^-9
relative each). float32 outputs (CUDA cores) and lse (f32 sums of exact
bf16 products) differ by summation order only.
"""
import ctypes

import pytest
import torch

from pytorch_distributed_template_tpu_torch.ops import build, flash

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


# ---------------------------------------------------------------------------
# wgmma operand layouts: one tile through the kernels' descriptors
# ---------------------------------------------------------------------------


def _declare_probe(lib):
    ptr = ctypes.c_void_p
    lib.pdt_wgmma_probe.argtypes = [ctypes.c_int, ptr, ptr, ptr, ptr]
    lib.pdt_wgmma_probe.restype = ctypes.c_int


#: the probe library (tests only; not a kernel of any path)
WGMMA_PROBE = build.CudaLibrary("wgmma_probe", _declare_probe)
# id: (N, K, B MN-major): the table of csrc/wgmma_probe.cu
PROBES = {0: (128, 128, False), 1: (128, 64, False), 2: (128, 32, False),
          3: (128, 64, True), 4: (128, 128, True), 5: (64, 128, True),
          6: (32, 128, True)}
PROBE_IDS = ["scores_d128", "scores_d64", "scores_d32_sw64", "ffn_kstep",
             "pv_d128_rs", "pv_d64_rs", "pv_d32_rs_sw64"]


@pytest.mark.parametrize("probe", sorted(PROBES), ids=PROBE_IDS)
def test_wgmma_descriptor_probe_matches_matmul(cuda, probe):
    """C = A B on one 64-row tile through TMA, the shared-memory
    descriptors and the wgmma wrappers of csrc/hopper.cuh. bf16 products
    are exact in f32, so only the summation order differs."""
    n, k, b_mn = PROBES[probe]
    gen = torch.Generator(device=cuda).manual_seed(probe)
    a = torch.randn(64, k, generator=gen, device=cuda).bfloat16()
    b = torch.randn(k, n, generator=gen, device=cuda).bfloat16()
    b_stored = b.contiguous() if b_mn else b.t().contiguous()
    c = torch.full((64, n), float("nan"), device=cuda)
    lib = WGMMA_PROBE.load()
    err = lib.pdt_wgmma_probe(probe, a.data_ptr(), b_stored.data_ptr(),
                              c.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"probe launch failed: CUDA error {err}"
    torch.cuda.synchronize()
    torch.testing.assert_close(c, a.float() @ b.float(), atol=1e-3,
                               rtol=1e-4)


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


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("h, kvh", [(4, 4), (8, 2), (12, 2)],
                         ids=["gqa1", "gqa4", "gqa6"])
@pytest.mark.parametrize("t, causal, window", [
    (1, True, 0), (127, True, 0), (129, True, 0), (1000, True, 0),
    (1000, True, 100), (300, True, 200), (129, False, 0),
    (1000, False, 300),
])
def test_flash_fwd_bf16_tile_edges(cuda, d, h, kvh, t, causal, window):
    """The bf16 kernel's edges: T of 1, one short of and one past a
    128-row tile, ragged 1000; band lower edges inside a K tile (window
    100, 200, 300); GQA ratios 1, 4 and 6."""
    q, k, v = _qkv(cuda, 2, t, h, kvh, d, torch.bfloat16,
                   seed=d + t + h + window)
    out, lse = flash.flash_attention_lse(q, k, v, causal=causal,
                                         window=window)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash.flash_attention_ref(
        q.float(), k.float(), v.float(), causal=causal, window=window)
    atol, rtol = TOL_OUT[torch.bfloat16]
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
        # 32-token pages otherwise runs on a Hopper arm)
        out = flash._paged_cuda(
            q, kp, vp, tables, starts, pad_lens, window, ks, vs,
            splits=splits, arm="cuda_cores" if arm == "cuda_cores"
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


def _ring_or_flat(device, *, b, t, group, kvh, d, bt, layout, quant,
                  seed, pads):
    """Inputs for windows of many lanes, as the engine lays them out.
    ``ring``: a full ring of window 256 at deep positions (wrapped many
    times); ``ring_edge``: the same with every row starting 5 tokens
    before a page edge, so lane tiles straddle page edges; ``ring_fill``:
    a ring not yet wrapped (its last slots -1); ``flat``: shuffled pages,
    each row's unallocated last slots -1."""
    from pytorch_distributed_template_tpu_torch.models.quant import (
        quantize_kv,
    )

    gen = torch.Generator().manual_seed(seed)
    window = 256 if layout.startswith("ring") else 0
    nb = (window + t) // bt + 2 if window else (3 * t) // bt + 4
    pool = b * nb + 2
    q = torch.randn(b, t, group * kvh, d, generator=gen)
    kp = torch.randn(pool, bt, kvh, d, generator=gen)
    vp = torch.randn(pool, bt, kvh, d, generator=gen)
    ks = vs = None
    if quant:
        kp, ks = quantize_kv(kp)
        vp, vs = quantize_kv(vp)
    else:
        kp, vp = kp.bfloat16(), vp.bfloat16()
    tables = (torch.randperm(pool - 1, generator=gen)[:b * nb] + 1).view(
        b, nb).int()
    if layout in ("ring", "ring_edge"):
        starts = torch.randint(3000, 6000, (b,), generator=gen)
        if layout == "ring_edge":
            starts = starts // bt * bt + bt - 5
    elif layout == "ring_fill":
        starts = torch.randint(0, nb * bt - t - bt, (b,), generator=gen)
    else:
        starts = torch.randint(0, nb * bt - t + 1, (b,), generator=gen)
    if layout in ("ring_fill", "flat"):
        for i in range(b):
            tables[i, -(-(int(starts[i]) + t) // bt):] = -1
    pads = torch.tensor(pads or [0] * b, dtype=torch.int32)
    out = [q.bfloat16(), kp, vp, tables, starts.int(), pads]
    out = [x.to(device).contiguous() for x in out]
    if quant:
        ks, vs = ks.to(device), vs.to(device)
    return out, ks, vs, window


# (group, D, bt, int8, T, layout, pads): windows of many lanes (prefill
# chunks, admission feeds) and two decode-sized ones, at groups 1, 4, 8
PAGED_WIDE = [
    (4, 128, 32, False, 64, "ring", None),
    (4, 128, 32, True, 64, "ring", [0, 17, 63]),
    (4, 128, 16, False, 200, "ring_edge", [3, 0, 0]),
    (1, 128, 32, False, 200, "flat", [0, 0, 199]),
    (8, 128, 16, True, 200, "ring_fill", None),
    (4, 128, 32, False, 512, "ring", None),
    (4, 128, 32, True, 512, "flat", None),
    (8, 128, 32, False, 64, "flat", [5, 0, 63]),
    (1, 128, 16, True, 64, "ring_edge", None),
    (4, 64, 32, False, 64, "flat", [0, 9, 0]),
    (4, 64, 16, True, 200, "ring", None),
    (4, 128, 32, False, 1, "ring", None),
    (8, 128, 16, True, 2, "flat", [0, 1, 0]),
]


@pytest.mark.parametrize("case", PAGED_WIDE, ids=[
    f"g{c[0]}-d{c[1]}-bt{c[2]}-{'int8' if c[3] else 'bf16'}-t{c[4]}-{c[5]}"
    for c in PAGED_WIDE])
@pytest.mark.parametrize("splits", [None, 1, 3], ids=["auto", "s1", "s3"])
@pytest.mark.parametrize("arm", ["auto", "wgmma", "decode"])
def test_paged_attn_matches_plain_many_lanes(cuda, case, splits, arm):
    """test_paged_attn_matches_plain at the widths of prefill chunks and
    admission feeds, with the arm and the split count forced both ways."""
    group, d, bt, quant, t, layout, pads = case
    (q, kp, vp, tables, starts, pad_lens), ks, vs, window = _ring_or_flat(
        cuda, b=3, t=t, group=group, kvh=2, d=d, bt=bt, layout=layout,
        quant=quant, seed=group + d + bt + t, pads=pads)
    before = flash.PAGED_ATTN.launches
    chosen = flash.paged_arm(q.dtype, bt, t * group) if arm == "auto" \
        else arm
    arm_before = flash.PAGED_ARM_LAUNCHES[chosen]
    out = flash._paged_cuda(q, kp, vp, tables, starts, pad_lens, window,
                            ks, vs, splits=splits,
                            arm=None if arm == "auto" else arm)
    torch.cuda.synchronize()
    assert flash.PAGED_ATTN.launches == before + 1
    assert flash.PAGED_ARM_LAUNCHES[chosen] == arm_before + 1
    f32 = (lambda x: x) if quant else (lambda x: x.float())
    ref = flash.paged_attention_ref(q.float(), f32(kp), f32(vp), tables,
                                    starts, pad_lens, window=window,
                                    k_scale=ks, v_scale=vs)
    atol, rtol = TOL_OUT[torch.bfloat16]
    for i, p in enumerate(pad_lens.tolist()):
        torch.testing.assert_close(out[i, p:].float(), ref[i, p:],
                                   atol=atol, rtol=rtol)
        assert not out[i, :p].float().abs().any()


def test_paged_lanes_match_the_kernel(cuda):
    lib = flash.PAGED_ATTN.load()
    for arm, code in flash._ARM_CODES.items():
        for group in (1, 2, 3, 4, 8, 16, 32):
            assert lib.pdt_paged_lanes(code, group) == \
                flash.paged_lanes(arm, group), (arm, group)


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
    # T at and around the 64- and 128-row tiles, and under one tile
    (2, 4, 4, 63, True, 0), (2, 4, 4, 64, True, 0), (1, 4, 2, 65, True, 0),
    (1, 4, 4, 127, True, 0), (2, 2, 2, 128, False, 0),
    (1, 4, 2, 129, True, 0), (1, 2, 1, 20, True, 0),
    # windows narrower than a tile
    (1, 8, 2, 200, True, 17), (1, 4, 4, 130, False, 5),
    (2, 4, 4, 300, True, 1),
    # a group of 8 (split over items: few items)
    (1, 8, 1, 150, True, 0),
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
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_autograd_with_lse_cotangent(cuda, dtype, d):
    """Gradients through both outputs: autograd over FlashAttention (B1,
    B2, B3) against the plain backward with the same cotangents."""
    q, k, v = _qkv(cuda, 2, 96, 8, 2, d, dtype, seed=11)
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


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("splits", [1, 2, None], ids=["s1", "s2", "auto"])
def test_flash_bwd_gqa_splits_match_plain_and_repeat_bitwise(cuda, d,
                                                             splits):
    """bf16 GQA: dK/dV summed over the group inside one item, or split
    over items whose f32 partials a second launch adds in a fixed order
    (auto: 3 key tiles x 2 kv heads are few items, so 4 splits), within
    tolerance of the plain backward; two runs are bitwise equal."""
    b, h, kvh, t = 1, 8, 2, 300
    q, k, v = _qkv(cuda, b, t, h, kvh, d, torch.bfloat16, seed=d + 7)
    out, lse = flash.flash_attention_lse(q, k, v, causal=True)
    gen = torch.Generator(device=cuda).manual_seed(d)
    g = torch.randn(out.shape, device=cuda, generator=gen).bfloat16()
    runs = [flash._flash_bwd_cuda(q, k, v, out, g, lse, None, True, 0,
                                  splits=splits)[:3] for _ in range(2)]
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(x, y), f"{name} differs between two runs"
    ref = flash.flash_attention_bwd_ref(
        q.float(), k.float(), v.float(), out.float(), lse, g.float(),
        causal=True)
    for name, got, want in zip(("dq", "dk", "dv"), runs[0], ref):
        _assert_grad_close(got, want, torch.bfloat16, name)


def test_flash_bwd_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 16, 4, 4, 64, torch.float32, seed=0)
    out, lse = flash.flash_attention_lse(q, k, v)
    with pytest.raises(TypeError):
        flash.flash_attention_bwd(q, k, v, out, lse, out.bfloat16())
    q16 = q[..., :16].contiguous()
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_attention_bwd(q16, q16, q16, q16, lse, q16)


# ---------------------------------------------------------------------------
# B5: the fused expert FFN (csrc/expert_ffn.cu) against expert_ffn_ref
# ---------------------------------------------------------------------------
# Tolerances, against the plain version on the same inputs on the card:
# bf16 |got - ref| <= 0.01 max|ref| + 1e-4 (the TPU probe's own gate,
# scripts/debug_moe_pallas_ffn.py: both sides round the hidden and the
# output to bf16, so a hidden value whose f32 sum lands on the other side
# of a bf16 rounding boundary moves the output by ~2^-8 of one term);
# float32 <= 1e-4 max|ref| + 1e-5 (summation order only).


def _ffn_inputs(device, e, c, d, f, dtype, bias, seed):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    x = rnd(e, c, d)
    wi, wo = rnd(e, d, f, scale=d ** -0.5), rnd(e, f, d, scale=f ** -0.5)
    bi = rnd(e, f, scale=0.1) if bias else None
    bo = rnd(e, d, scale=0.1) if bias else None
    return x, wi, wo, bi, bo


def _assert_ffn_close(got, ref, dtype):
    ref = ref.float()
    err = (got.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    limit = (0.01 * scale + 1e-4 if dtype == torch.bfloat16
             else 1e-4 * scale + 1e-5)
    assert err <= limit, f"max err {err:.3e} > {limit:.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("e, c, d, f", [
    (2, 64, 64, 128), (3, 77, 128, 48), (2, 100, 256, 272),
    (2, 33, 512, 1024), (1, 19, 768, 1536), (2, 40, 1024, 64),
    (1, 1, 16, 16),
])
def test_expert_ffn_matches_plain(cuda, dtype, bias, e, c, d, f):
    from pytorch_distributed_template_tpu_torch.ops import expert_ffn as ffn

    x, wi, wo, bi, bo = _ffn_inputs(cuda, e, c, d, f, dtype, bias,
                                    seed=e + c + d + f)
    before = ffn.EXPERT_FFN.launches
    out = ffn.expert_ffn(x, wi, wo, bi, bo)
    torch.cuda.synchronize()
    assert ffn.EXPERT_FFN.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    assert bool(torch.isfinite(out).all())
    _assert_ffn_close(out, ffn.expert_ffn_ref(x, wi, wo, bi, bo), dtype)


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("e, c, d, f", [
    (2, 1, 256, 528), (2, 77, 512, 528), (2, 1000, 768, 528),
    (1, 5120, 512, 1024), (3, 77, 768, 1536), (2, 1000, 256, 1024),
])
def test_expert_ffn_bf16_tile_edges(cuda, bias, e, c, d, f):
    """The bf16 grouped GEMMs' edges: capacities of 1, 77, 1000 and 5120
    rows (ragged against the 128-row tile), F 528 (not a multiple of the
    128-column tile or the 64-deep k-step), D 256, 512 and 768."""
    from pytorch_distributed_template_tpu_torch.ops import expert_ffn as ffn

    x, wi, wo, bi, bo = _ffn_inputs(cuda, e, c, d, f, torch.bfloat16, bias,
                                    seed=7 * e + c + d + f)
    out = ffn.expert_ffn(x, wi, wo, bi, bo)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert bool(torch.isfinite(out).all())
    _assert_ffn_close(out, ffn.expert_ffn_ref(x, wi, wo, bi, bo),
                      torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_expert_ffn_autograd_on_the_card(cuda, dtype):
    """Gradients of ExpertFFN (forward B5, backward bmm) against autograd
    of the plain version in float32 on the same inputs."""
    from pytorch_distributed_template_tpu_torch.ops import expert_ffn as ffn

    inputs = _ffn_inputs(cuda, 2, 45, 64, 96, dtype, True, seed=5)
    got = [t.clone().requires_grad_() for t in inputs]
    want = [t.float().requires_grad_() for t in inputs]
    gen = torch.Generator(device=cuda).manual_seed(6)
    g = torch.randn((2, 45, 64), generator=gen, device=cuda)
    ffn.expert_ffn(*got).backward(g.to(dtype))
    ffn.expert_ffn_ref(*want).backward(g)
    a = 1e-2 if dtype == torch.bfloat16 else 1e-5
    for name, x, w in zip(("x", "wi", "wo", "bi", "bo"), got, want):
        err = (x.grad.float() - w.grad).abs().max().item()
        assert err <= a * w.grad.abs().max().item() + 1e-5, (name, err)


def test_expert_ffn_refuses_what_it_does_not_take(cuda):
    from pytorch_distributed_template_tpu_torch.ops import expert_ffn as ffn

    x, wi, wo, _, _ = _ffn_inputs(cuda, 2, 8, 64, 64, torch.float32, False,
                                  seed=0)
    with pytest.raises(ValueError, match="multiples of 16"):
        ffn.expert_ffn(x[..., :40].contiguous(), wi[:, :40].contiguous(),
                       wo[..., :40].contiguous())
    with pytest.raises(ValueError, match="multiples of 16"):
        ffn.expert_ffn(x, wi[..., :24].contiguous(),
                       wo[:, :24].contiguous())
    with pytest.raises(ValueError, match="D <="):
        big = _ffn_inputs(cuda, 1, 4, 1040, 16, torch.float32, False, 0)
        ffn.expert_ffn(*big[:3])
    with pytest.raises(TypeError):
        ffn.expert_ffn(x.half(), wi.half(), wo.half())
    with pytest.raises(TypeError):
        ffn.expert_ffn(x, wi.bfloat16(), wo)
    with pytest.raises(ValueError, match="contiguous"):
        ffn.expert_ffn(x, wi.transpose(1, 2).contiguous().transpose(1, 2),
                       wo)


def test_embedding_lookup_backward_is_deterministic(cuda):
    """The models' embedding lookup (models/layers.py::embed, an index) at
    the byte LM's shape, 32 x 512 tokens over 256 rows: two backward
    passes give bit-identical gradients, which an exact resume of a
    training run needs (F.embedding's backward does not guarantee it at a
    small vocabulary with many repeated rows)."""
    from pytorch_distributed_template_tpu_torch.models.layers import embed

    gen = torch.Generator(device=cuda).manual_seed(0)
    w = torch.randn(256, 512, generator=gen, device=cuda,
                    requires_grad=True)
    toks = torch.randint(0, 256, (32, 512), generator=gen,
                         device=cuda).to(torch.uint8)
    g = torch.randn(32, 512, 512, generator=gen, device=cuda).bfloat16()
    grads = []
    for _ in range(2):
        w.grad = None
        embed(w, toks, torch.bfloat16).backward(g)
        grads.append(w.grad.clone())
    assert torch.equal(grads[0], grads[1])
