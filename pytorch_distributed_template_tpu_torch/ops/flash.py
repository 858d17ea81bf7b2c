"""Flash attention (forward and backward) and paged attention: the
hand-written CUDA kernels and their plain versions.

Counterpart of ``pytorch_distributed_template_tpu/ops/flash.py``
(``flash_attention``, ``flash_attention_lse`` and their ``custom_vjp``).
The forward kernel (``csrc/flash_fwd.cu``, replacing the Pallas
``_fwd_kernel``; in bf16 a Hopper kernel with TMA loads into a ring of
shared-memory stages, mbarriers, wgmma and a producer warpgroup feeding two
consumer warpgroups, in float32 a CUDA-core kernel) and the two backward
kernels (``csrc/flash_bwd.cu``:
``flash_bwd_dkv`` replacing ``_bwd_dkv_kernel``, ``flash_bwd_dq`` replacing
``_bwd_dq_kernel``; in bf16 Hopper kernels of the same design, in float32
CUDA-core kernels) run for tensors on a CUDA device;
``flash_attention_ref`` and
``flash_attention_bwd_ref`` compute the same functions in plain PyTorch
and are used for CPU tensors and as the kernels' oracles. There is no
fallback: on a CUDA tensor a wrapper launches its kernel or raises.

``flash_attention`` and ``flash_attention_lse`` are differentiable through
one ``torch.autograd.Function`` (:class:`FlashAttention`): it saves
``(q, k, v, out, lse)``, and its backward runs the backward kernels (or the
plain backward on the CPU). ``delta = rowsum(dO * out)`` (minus the lse
cotangent when the caller used lse) is computed by the dQ kernel, which
therefore runs before the dK/dV kernel; the plain backward computes it in
plain torch. dK and dV come back at the stored kv-head width, summed over
each group's query heads in a fixed order (bitwise repeatable).

The paged half (``paged_attention``, ``paged_attention_ref``,
``csrc/paged_attn.cu`` replacing the Pallas ``_paged_kernel``) reads K/V in
place from the KV block pool through per-row block tables; see
:func:`paged_attention`.

Layout is the JAX package's: q ``[B, T, H, D]``, k/v ``[B, T, KVH, D]``
with ``KVH`` dividing ``H`` (query head ``h`` reads kv head
``h // (H // KVH)``), out ``[B, T, H, D]`` in the input dtype, lse
``[B, H, T]`` float32. Scores, softmax state and the sum are float32 for
every input dtype. ``window > 0`` keeps only keys with
``q_pos - k_pos < window`` (combined with ``causal``).
"""
from __future__ import annotations

import ctypes

import torch

from .build import COUNT_LOCK, CudaLibrary

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pdt_flash_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr,
                                  i32, i32, i32, i32, i32, i32, i32, i32,
                                  ctypes.c_float, ptr]
    lib.pdt_flash_fwd.restype = i32
    lib.pdt_cuda_error_string.argtypes = [i32]
    lib.pdt_cuda_error_string.restype = ctypes.c_char_p


#: the B1 kernel library; ``FLASH_FWD.launches`` counts its launches
FLASH_FWD = CudaLibrary("flash_fwd", _declare)


def _check_gqa(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, T, heads, D] tensors")
    b, t, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if k.shape[1] != t:
        raise ValueError(f"flash attention needs Tq == Tk; {t} vs "
                         f"{k.shape[1]}")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")


def visible_mask(tq: int, tk: int, causal: bool, window: int,
                 device=None) -> torch.Tensor:
    """``[tq, tk]`` bool: key ``j`` visible from query ``i`` (same origin)."""
    q_pos = torch.arange(tq, device=device)[:, None]
    k_pos = torch.arange(tk, device=device)[None, :]
    ok = torch.ones((tq, tk), dtype=torch.bool, device=device)
    if causal:
        ok = q_pos >= k_pos
    if window > 0:
        ok = ok & (q_pos - k_pos < window)
    return ok


def flash_attention_ref(q, k, v, causal: bool = True, window: int = 0):
    """Plain PyTorch version of the kernel: ``(out, lse)``.

    Same arithmetic as the kernel's online softmax, done in one pass:
    masked scores are NEG_INF and contribute exactly 0, ``l`` is clamped
    at 1e-30, ``lse = m + log(l)``."""
    _check_gqa(q, k, v)
    b, t, h, d = q.shape
    groups = h // k.shape[2]
    qf = q.float() * (d ** -0.5)
    kf, vf = k.float(), v.float()
    if groups > 1:
        kf = kf.repeat_interleave(groups, dim=2)
        vf = vf.repeat_interleave(groups, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    ok = visible_mask(t, t, causal, window, q.device)
    s = s.masked_fill(~ok, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~ok, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    out = out / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l)).squeeze(-1)
    return out.to(q.dtype), lse


def _flash_fwd_cuda(q, k, v, causal: bool, window: int):
    """Launch the B1 kernel on PyTorch's current stream."""
    dtype = q.dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_fwd kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    if k.dtype != dtype or v.dtype != dtype:
        raise TypeError("q, k, v must share one dtype")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous()
            and v.is_contiguous()):
        raise ValueError("flash_fwd kernel needs contiguous q, k, v")
    b, t, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_fwd kernel takes head_dim in {HEAD_DIMS},"
                         f" got {d}")
    if int(window) < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if dtype == torch.bfloat16 and any(x.data_ptr() % 16
                                       for x in (q, k, v)):
        raise ValueError("flash_fwd's bf16 kernel loads q, k, v by TMA: "
                         "they must start 16-byte aligned")
    lib = FLASH_FWD.load()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        FLASH_FWD.count(q.device)
        err = lib.pdt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, t, h, k.shape[2], d, _DTYPE_CODES[dtype],
            int(bool(causal)), int(window), float(d ** -0.5), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_fwd launch failed: CUDA error {err} "
            f"({lib.pdt_cuda_error_string(err).decode()})")
    return out, lse


def _device_kind(q) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda, not "
                         f"{q.device}")
    return q.device.type


def _flash_forward(q, k, v, causal: bool, window: int):
    if _device_kind(q) == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    return _flash_fwd_cuda(q, k, v, causal, window)


class FlashAttention(torch.autograd.Function):
    """``(q, k, v) -> (out, lse)`` with the flash backward (the JAX
    package's ``_flash_3d_lse`` and its ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = _flash_forward(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = bool(causal), int(window)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g is None:
            g = torch.zeros_like(out)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, ctx.causal,
                                         ctx.window, g_lse)
        return dq, dk, dv, None, None


def flash_attention_lse(q, k, v, causal: bool = False, window: int = 0):
    """Fused attention returning ``(out [B, T, H, D], lse [B, H, T] f32)``,
    differentiable in both outputs.

    CPU tensors take the plain versions; CUDA tensors take the kernels (or
    raise)."""
    _check_gqa(q, k, v)
    _device_kind(q)
    return FlashAttention.apply(q, k, v, causal, window)


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """Fused attention ``[B, T, H, D] -> [B, T, H, D]`` (k/v may carry
    fewer heads: GQA at stored width)."""
    return flash_attention_lse(q, k, v, causal=causal, window=window)[0]


# ---------------------------------------------------------------------------
# Backward (kernels B2, B3)
# ---------------------------------------------------------------------------

def _declare_bwd(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pdt_flash_bwd_dq.argtypes = [ptr] * 9 + [i32] * 8 + [
        ctypes.c_float, ptr]
    lib.pdt_flash_bwd_dq.restype = i32
    lib.pdt_flash_bwd_dkv.argtypes = [ptr] * 9 + [i32] * 9 + [
        ctypes.c_float, ptr]
    lib.pdt_flash_bwd_dkv.restype = i32
    lib.pdt_flash_bwd_error_string.argtypes = [i32]
    lib.pdt_flash_bwd_error_string.restype = ctypes.c_char_p


#: launch order: B3 (dQ) computes delta, which B2 (dK, dV) reads
BWD_KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")
#: the B2/B3 kernel library; each kernel counts its own launches
FLASH_BWD = CudaLibrary("flash_bwd", _declare_bwd, kernels=BWD_KERNELS)
FLASH_BWD_DKV = FLASH_BWD.kernels["flash_bwd_dkv"]
FLASH_BWD_DQ = FLASH_BWD.kernels["flash_bwd_dq"]
#: rows one item of the bf16 kernels owns (queries in B3, keys in B2), 64
#: per consumer warpgroup; it streams tiles of 64 rows of the other side
BWD_ITEM_ROWS = 128


def bwd_splits(b: int, t: int, h: int, kvh: int, causal: bool, window: int,
               sms: int) -> int:
    """How many of B2's bf16 items share one (batch, kv head, 128-key
    tile)'s query heads. A split pays only where the unsplit items are
    fewer than ``sms`` and uneven: under a causal mask with no band
    narrower than T, the first key tile's item walks every query tile and
    the last one a single tile, so the longest item sets the time. Then
    the smallest divisor of the group that brings the items to ``sms``
    (the whole group when none does); else 1. Split items write f32
    partials that a second launch adds in a fixed order, which costs more
    than it gains once every SM has an item or the items are even (B2's
    times per split count on an H100, ``tools/kernel_ab.py --phase
    bwd``)."""
    groups = h // kvh
    items = -(-t // BWD_ITEM_ROWS) * b * kvh
    uneven = causal and not 0 < window < t
    if groups == 1 or items >= sms or not uneven:
        return 1
    for s in range(2, groups + 1):
        if groups % s == 0 and items * s >= sms:
            return s
    return groups


def _delta(g, out, g_lse=None):
    """``[B, H, T]`` f32: ``rowsum(g * out)``, minus the lse cotangent
    (``d lse / d s = p`` folds into the backward as ``delta - g_lse``).
    The plain backward's; on the card B3 computes it."""
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta.contiguous()


def flash_attention_bwd_ref(q, k, v, out, lse, g, causal: bool = True,
                            window: int = 0, g_lse=None,
                            block_k: int = 512):
    """Plain PyTorch backward of :func:`flash_attention_lse`: ``(dq, dk,
    dv)`` in the input dtypes, dk/dv at the kv-head width.

    The JAX package's ``_bwd_3d`` blockwise over key blocks of
    ``block_k``: per block, ``P = exp(q k^T * scale - lse)`` (0 where
    masked), ``dV = P^T g``, ``dP = g v^T``, ``dS = P (dP - delta) *
    scale``, ``dQ += dS k``, ``dK = dS^T q``; all in float32."""
    _check_gqa(q, k, v)
    b, t, h, d = q.shape
    kvh = k.shape[2]
    groups = h // kvh
    scale = d ** -0.5
    qf, gf = q.float(), g.float()
    kf = k.float().repeat_interleave(groups, dim=2)
    vf = v.float().repeat_interleave(groups, dim=2)
    delta = _delta(g, out, g_lse)                          # [B, H, T]
    lse = lse.float()
    ok_all = visible_mask(t, t, causal, window, q.device)
    dq = torch.zeros_like(qf)
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    for k0 in range(0, t, block_k):
        sl = slice(k0, min(t, k0 + block_k))
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, sl]) * scale
        ok = ok_all[:, sl]
        p = torch.exp(s - lse[..., None]).masked_fill_(~ok, 0.0)
        dv[:, sl] = torch.einsum("bhqk,bqhd->bkhd", p, gf)
        dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf[:, sl])
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.einsum("bhqk,bkhd->bqhd", ds, kf[:, sl])
        dk[:, sl] = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    if groups > 1:
        dk = dk.view(b, t, kvh, groups, d).sum(3)
        dv = dv.view(b, t, kvh, groups, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_cuda(q, k, v, out, g, lse, g_lse, causal: bool, window: int,
                    kernels=BWD_KERNELS, delta=None, splits=None):
    """Launch B3 (dQ and delta) then B2 (dK, dV) on PyTorch's current
    stream: ``(dq, dk, dv, delta)``. ``kernels``, ``delta`` and ``splits``
    are for timing and tests: ``kernels`` launches a subset (the gradients
    it skips come back uninitialised; B2 alone reads ``delta`` as B3 wrote
    it), ``delta`` is the ``[B, H, T]`` f32 buffer B3 writes, and
    ``splits`` overrides :func:`bwd_splits`."""
    dtype = q.dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_bwd kernels take float32 or bfloat16, got "
                        f"{dtype}")
    if any(x.dtype != dtype for x in (k, v, out, g)):
        raise TypeError("q, k, v, the output and its gradient must share "
                        "one dtype")
    b, t, h, d = q.shape
    kvh = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_bwd kernels take head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if delta is None:
        delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    tensors = [q, k, v, out, g, lse, delta]
    if g_lse is not None:
        tensors.append(g_lse)
    if any(x.dtype != torch.float32 for x in tensors[5:]):
        raise TypeError("lse, delta and the lse cotangent must be float32")
    if any(x.device != q.device for x in tensors):
        raise ValueError("flash backward inputs must be on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("flash_bwd kernels need contiguous inputs")
    if out.shape != q.shape or g.shape != q.shape:
        raise ValueError(f"out and its gradient must be {tuple(q.shape)}")
    if any(tuple(x.shape) != (b, h, t) for x in tensors[5:]):
        raise ValueError(f"lse, delta and the lse cotangent must be "
                         f"[B, H, T] = {(b, h, t)}")
    if int(window) < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if dtype == torch.bfloat16 and any(x.data_ptr() % 16
                                       for x in (q, k, v, out, g)):
        raise ValueError("flash_bwd's bf16 kernels load by TMA and read "
                         "16-byte vectors: q, k, v, the output and its "
                         "gradient must start 16-byte aligned")
    lib = FLASH_BWD.load()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    if dtype == torch.float32:
        splits = 1
    elif splits is None:
        splits = bwd_splits(b, t, h, kvh, causal, window,
                            _sm_count(q.device))
    part = (torch.empty((2, splits, b, t, kvh, d), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    tail = (b, t, h, kvh, d, _DTYPE_CODES[dtype], int(bool(causal)),
            int(window))
    err = 0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if "flash_bwd_dq" in kernels:
            FLASH_BWD_DQ.count(q.device)
            err = lib.pdt_flash_bwd_dq(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                out.data_ptr(), lse.data_ptr(),
                None if g_lse is None else g_lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), *tail, float(d ** -0.5),
                stream)
        if err == 0 and "flash_bwd_dkv" in kernels:
            FLASH_BWD_DKV.count(q.device)
            err = lib.pdt_flash_bwd_dkv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), None if part is None else part.data_ptr(),
                *tail, int(splits), float(d ** -0.5), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_bwd launch failed: CUDA error {err} "
            f"({lib.pdt_flash_bwd_error_string(err).decode()})")
    return dq, dk, dv, delta


def flash_attention_bwd(q, k, v, out, lse, g, causal: bool = True,
                        window: int = 0, g_lse=None):
    """``(dq, dk, dv)`` of :func:`flash_attention_lse` for the output
    cotangent ``g`` (and ``g_lse``, or None): the plain backward for CPU
    tensors, kernels B3 then B2 for CUDA tensors (or raise)."""
    if _device_kind(q) == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, g, causal=causal,
                                       window=window, g_lse=g_lse)
    if g_lse is not None:
        g_lse = g_lse.float().contiguous()
    return _flash_bwd_cuda(q, k, v, out.contiguous(), g.contiguous(),
                           lse.contiguous(), g_lse, causal, window)[:3]


def visible_keys(t: int, causal: bool, window: int) -> int:
    """Sum over queries of the keys each one sees (same origin)."""
    total = 0
    for i in range(t):
        lo = max(0, i - window + 1) if window > 0 else 0
        hi = i + 1 if causal else t
        total += hi - lo
    return total


def flash_bound_seconds(b: int, t: int, h: int, kvh: int, d: int,
                        causal: bool, window: int, itemsize: int,
                        peak_flops: float, peak_bytes: float):
    """The least time the card could take for one forward call:
    ``(seconds, "operations" | "bytes")``.

    FLOPs = 4·B·H·D·Σ(visible keys per query) (two matrix products);
    bytes = q + k + v + out + lse, each read or written once."""
    flops = 4.0 * b * h * d * visible_keys(t, causal, window)
    nbytes = itemsize * (2 * b * t * h * d + 2 * b * t * kvh * d) \
        + 4 * b * h * t
    by_ops, by_bytes = flops / peak_flops, nbytes / peak_bytes
    if by_ops >= by_bytes:
        return by_ops, "operations"
    return by_bytes, "bytes"


def flash_bwd_bound_seconds(kernel: str, b: int, t: int, h: int, kvh: int,
                            d: int, causal: bool, window: int,
                            itemsize: int, peak_flops: float,
                            peak_bytes: float, lse_cotangent: bool = False):
    """The least time the card could take for one backward call:
    ``(seconds, "operations" | "bytes")``.

    ``flash_bwd_dkv`` (B2): FLOPs = 8·B·H·D·Σvisible (S recompute, dV, dP,
    dK); bytes = q, g, k, v, lse, delta read and dk, dv written, once.
    ``flash_bwd_dq`` (B3): FLOPs = 6·B·H·D·Σvisible (S recompute, dP, dQ;
    delta's 2·B·H·T·D is left out); bytes = q, g, out, k, v, lse (and the
    lse cotangent with ``lse_cotangent``) read, dq and delta written,
    once. ``flash_bwd_pair`` (the whole backward, whatever its kernels
    recompute or pass between them): FLOPs = 10·B·H·D·Σvisible (S, dV, dP,
    dK, dQ once each); bytes = q, g, out, k, v, lse (and the lse
    cotangent) read and dq, dk, dv written, once."""
    per = {"flash_bwd_dkv": 8.0, "flash_bwd_dq": 6.0,
           "flash_bwd_pair": 10.0}[kernel]
    flops = per * b * h * d * visible_keys(t, causal, window)
    q_bytes = itemsize * b * t * h * d
    kv_bytes = itemsize * b * t * kvh * d
    row_bytes = 4 * b * h * t   # one [B, H, T] f32 array
    lse_bytes = row_bytes if lse_cotangent else 0
    if kernel == "flash_bwd_dkv":
        nbytes = 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes
    elif kernel == "flash_bwd_dq":
        nbytes = 4 * q_bytes + 2 * kv_bytes + 2 * row_bytes + lse_bytes
    else:
        nbytes = 4 * q_bytes + 4 * kv_bytes + row_bytes + lse_bytes
    by_ops, by_bytes = flops / peak_flops, nbytes / peak_bytes
    if by_ops >= by_bytes:
        return by_ops, "operations"
    return by_bytes, "bytes"


# ---------------------------------------------------------------------------
# Paged attention (kernel B4): decode and prefill straight from the KV pool
# ---------------------------------------------------------------------------

PAGED_HEAD_DIMS = (64, 128)
PAGED_BLOCK_TOKENS = (8, 16, 32)
PAGED_MAX_GROUP = 32       # query heads per kv head one block can serve
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _declare_paged(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pdt_paged_attn.argtypes = [ptr] * 10 + [i32] * 13 + [
        ctypes.c_float, ptr]
    lib.pdt_paged_attn.restype = i32
    lib.pdt_paged_lanes.argtypes = [i32, i32]
    lib.pdt_paged_lanes.restype = i32
    lib.pdt_paged_error_string.argtypes = [i32]
    lib.pdt_paged_error_string.restype = ctypes.c_char_p


#: the B4 kernel library; ``PAGED_ATTN.launches`` counts its launches
PAGED_ATTN = CudaLibrary("paged_attn", _declare_paged)


def _check_paged(q, k_pool, v_pool, tables, row_starts, pad_lens,
                 k_scale, v_scale):
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"paged attention takes q [B, T, Hq, D] and "
                         f"pools [P, bt, KVH, D]; got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    b, _, hq, d = q.shape
    kvh = k_pool.shape[2]
    if k_pool.shape[3] != d or hq % kvh:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pool.shape)} (head_dim, or query "
                         f"heads not a multiple of kv heads)")
    if tables.dim() != 2 or tables.shape[0] != b:
        raise ValueError(f"tables must be [B, NB]; got "
                         f"{tuple(tables.shape)} for B={b}")
    if tuple(row_starts.shape) != (b,) or tuple(pad_lens.shape) != (b,):
        raise ValueError("row_starts and pad_lens must be [B]")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if k_scale is not None and (
            tuple(k_scale.shape) != tuple(k_pool.shape[:3])
            or tuple(v_scale.shape) != tuple(k_pool.shape[:3])):
        raise ValueError(f"scales must be [P, bt, KVH] = "
                         f"{tuple(k_pool.shape[:3])}")


def paged_visible(tables, row_starts, pad_lens, t: int, bt: int,
                  window: int = 0):
    """``[B, T, NB*bt]`` bool: key lane ``j*bt + o`` of row ``b``'s table
    is visible from query lane ``i`` (the kernel's mask, written out).

    Flat tables: ``k_pos = j*bt + o <= q_pos``. Ring tables (``window >
    0``): slot ``j`` holds the newest logical block congruent to ``j``
    mod NB at or below the query's own block, ``j_log = jq - (jq - j) mod
    NB``, and the key is visible iff ``0 <= k_pos <= q_pos`` and
    ``q_pos - k_pos < window``. Pad lanes (``i < pad_lens[b]``) and
    ``-1`` table lanes see nothing."""
    dev = tables.device
    b, nb = tables.shape
    lane = torch.arange(t, device=dev)
    q_pos = row_starts.long()[:, None] + lane[None, :]            # [B, T]
    used = (tables >= 0).repeat_interleave(bt, dim=1)[:, None, :]
    valid = (lane[None, :] >= pad_lens.long()[:, None])[:, :, None]
    qp = q_pos[:, :, None]
    if window > 0:
        jq = torch.div(q_pos, bt, rounding_mode="floor")[:, :, None]
        slot = torch.arange(nb, device=dev)[None, None, :]
        j_log = jq - torch.remainder(jq - slot, nb)               # [B,T,NB]
        k_pos = (j_log[..., None] * bt + torch.arange(bt, device=dev)
                 ).reshape(b, t, nb * bt)
        ok = (k_pos >= 0) & (k_pos <= qp) & (qp - k_pos < window)
    else:
        ok = torch.arange(nb * bt, device=dev)[None, None, :] <= qp
    return ok & valid & used


def paged_gather(pool, tables, scale=None, dtype=None):
    """Row ``b``'s pages laid end to end: ``[B, NB*bt, ...]`` (``-1``
    lanes read page 0, the scratch page). With ``scale`` (int8 pools) the
    rows are dequantized to ``dtype``."""
    b, nb = tables.shape
    safe = tables.long().clamp_min(0)
    arr = pool[safe].reshape(b, nb * pool.shape[1], *pool.shape[2:])
    if scale is not None:
        s = scale[safe].reshape(b, nb * pool.shape[1], *scale.shape[2:])
        arr = (arr.float() * s[..., None]).to(dtype)
    return arr


def paged_attention_ref(q, k_pool, v_pool, tables, row_starts, pad_lens,
                        window: int = 0, k_scale=None, v_scale=None):
    """Plain PyTorch version of the B4 kernel (the JAX package's
    ``paged_attention_ref``): gather every row's pages, mask, and run the
    grouped-query einsum in f32. A lane that sees no key (an invalid lane,
    ``i < pad_lens[b]``) gives 0, as the kernel's does (the JAX oracle
    leaves such lanes undefined): an idle or padded row's MoE route
    depends on it, so the card and the CPU must agree there too."""
    from .attention import grouped_query_attention

    _check_paged(q, k_pool, v_pool, tables, row_starts, pad_lens,
                 k_scale, v_scale)
    k_all = paged_gather(k_pool, tables, k_scale, q.dtype)
    v_all = paged_gather(v_pool, tables, v_scale, q.dtype)
    ok = paged_visible(tables, row_starts, pad_lens, q.shape[1],
                       k_pool.shape[1], window)
    out = grouped_query_attention(q, k_all, v_all, mask=ok[:, None])
    seen = ok.any(dim=-1)[:, :, None, None]
    return torch.where(seen, out, torch.zeros_like(out))


#: B4's arms (``csrc/paged_attn.cu``): the query rows one block (or
#: wgmma item) serves, over the query heads of its kv head
PAGED_ARM_ROWS = {"cuda_cores": 32, "decode": 16, "wgmma": 128}
_ARM_CODES = {"cuda_cores": 0, "decode": 1, "wgmma": 2}
#: launches of each arm (the path's count is ``PAGED_ATTN.launches``)
PAGED_ARM_LAUNCHES = {arm: 0 for arm in PAGED_ARM_ROWS}


def paged_arm(dtype, block_tokens: int, rows: int) -> str:
    """Which arm of B4 serves a call: ``rows`` is T x (Hq / KVH), the
    query rows of one kv head. bf16 queries over 16- or 32-token pages
    run on the Hopper arms: ``"decode"`` (TMA page ring, mma.sync, a
    block's 16 rows) up to 16 rows, ``"wgmma"`` (TMA + wgmma, 128-row
    items: prefill chunks and admission feeds) above; f32 queries and
    8-token pages on ``"cuda_cores"``."""
    if dtype != torch.bfloat16 or block_tokens % 16:
        return "cuda_cores"
    return "decode" if rows <= PAGED_ARM_ROWS["decode"] else "wgmma"


def paged_lanes(arm: str, group: int) -> int:
    """Query lanes one block (or wgmma item) of ``arm`` serves at
    ``group`` query heads per kv head (0: the group is too wide)."""
    return PAGED_ARM_ROWS[arm] // group


#: blocks per SM a split aims at, by arm: a wgmma item fills an SM, a
#: decode block half of one (two are resident), a CUDA-core block a quarter
PAGED_ARM_BLOCKS = {"cuda_cores": 4, "decode": 2, "wgmma": 1}


def paged_splits(arm: str, units: int, nb: int, sms: int) -> int:
    """How many blocks or items share one row's table, from the ``units``
    (lane tiles x rows x kv heads) of an unsplit call: 1 once the units
    fill half of the ``PAGED_ARM_BLOCKS[arm] x sms`` the arm aims at, else
    enough to reach it; at most 16, and at least 8 table slots per
    split."""
    per_sm = PAGED_ARM_BLOCKS[arm]
    if 2 * units >= per_sm * sms:
        return 1
    return max(1, min(16, per_sm * sms // max(units, 1), nb // 8))


_SMS = {}


def _sm_count(device) -> int:
    """The device's SM count, read once per device."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SMS[idx]


def _paged_cuda(q, k_pool, v_pool, tables, row_starts, pad_lens,
                window: int, k_scale, v_scale, splits=None, arm=None):
    """Launch the B4 kernel on PyTorch's current stream. ``splits`` and
    ``arm`` (tests only) override :func:`paged_splits` and
    :func:`paged_arm`."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged_attn kernel takes float32 or bfloat16 "
                        f"queries, got {q.dtype}")
    quant = k_scale is not None
    if quant:
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise TypeError("scales are given: pools must be int8")
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise TypeError("int8 pool scales must be float32")
    elif k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"pools ({k_pool.dtype}) must match q ({q.dtype}) "
                        f"or be int8 with scales")
    for name, x in (("tables", tables), ("row_starts", row_starts),
                    ("pad_lens", pad_lens)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    tensors = [q, k_pool, v_pool, tables, row_starts, pad_lens]
    if quant:
        tensors += [k_scale, v_scale]
    if any(x.device != q.device for x in tensors):
        raise ValueError("paged attention inputs must be on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("paged_attn kernel needs contiguous inputs")
    b, t, hq, d = q.shape
    bt, kvh = k_pool.shape[1], k_pool.shape[2]
    group = hq // kvh
    if d not in PAGED_HEAD_DIMS:
        raise ValueError(f"paged_attn kernel takes head_dim in "
                         f"{PAGED_HEAD_DIMS}, got {d}")
    if bt not in PAGED_BLOCK_TOKENS:
        raise ValueError(f"paged_attn kernel takes block_tokens in "
                         f"{PAGED_BLOCK_TOKENS}, got {bt}")
    if group > PAGED_MAX_GROUP:
        raise ValueError(f"paged_attn kernel serves at most "
                         f"{PAGED_MAX_GROUP} query heads per kv head")
    if int(window) < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_attn reads 16-byte vectors: the pools "
                         "must start 16-byte aligned")
    if arm is None:
        arm = paged_arm(q.dtype, bt, t * group)
    lanes = paged_lanes(arm, group)
    if lanes < 1:
        raise ValueError(f"the {arm} arm serves at most "
                         f"{PAGED_ARM_ROWS[arm]} query heads per kv head")
    lib = PAGED_ATTN.load()
    nb = tables.shape[1]
    if splits is None:
        splits = paged_splits(arm, -(-t // lanes) * kvh * b, nb,
                              _sm_count(q.device))
    splits = max(1, min(int(splits), nb))
    out = torch.empty_like(q)
    # the split partials: [B, T, Hq, splits, D + 2] (acc, m, l)
    part = (torch.empty((b, t, hq, splits, d + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        PAGED_ATTN.count(q.device)
        with COUNT_LOCK:
            PAGED_ARM_LAUNCHES[arm] += 1
        err = lib.pdt_paged_attn(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            tables.data_ptr(), row_starts.data_ptr(), pad_lens.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(),
            b, t, hq, kvh, d, nb, bt, k_pool.shape[0],
            _DTYPE_CODES[q.dtype], _KV_CODES[k_pool.dtype], int(window),
            splits, _ARM_CODES[arm], float(d ** -0.5), stream)
    if err != 0:
        raise RuntimeError(
            f"paged_attn launch failed: CUDA error {err} "
            f"({lib.pdt_paged_error_string(err).decode()})")
    return out


def paged_attention(q, k_pool, v_pool, tables, row_starts, pad_lens,
                    window: int = 0, k_scale=None, v_scale=None):
    """Attention of a query window over the KV block pool, in place.

    :param q: ``[B, T, Hq, D]`` query rows, RoPE already applied at their
        row-local positions.
    :param k_pool / v_pool: ``[P, bt, KVH, D]`` pool leaves (page 0 is
        the scratch page); int8 with ``k_scale``/``v_scale``
        ``[P, bt, KVH]`` f32 for the int8-KV layout.
    :param tables: ``[B, NB]`` int32 block table, ``-1`` = unallocated.
    :param row_starts: ``[B]`` int32 position of query lane 0.
    :param pad_lens: ``[B]`` int32 leading invalid lanes.
    :param window: ``> 0`` switches the table to ring semantics with the
        sliding band (see :func:`paged_visible`).
    :returns: ``[B, T, Hq, D]`` in q's dtype; the call's own K/V must
        already be written into the pool.

    CPU tensors take :func:`paged_attention_ref`; CUDA tensors launch the
    B4 kernel or raise."""
    _check_paged(q, k_pool, v_pool, tables, row_starts, pad_lens,
                 k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, tables, row_starts,
                                   pad_lens, window=window,
                                   k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged attention runs on cpu or cuda, not "
                         f"{q.device}")
    return _paged_cuda(q, k_pool, v_pool, tables, row_starts, pad_lens,
                       window, k_scale, v_scale)


def paged_bound_seconds(q, k_pool, tables, row_starts, pad_lens,
                        window: int, quant: bool, peak_flops: float,
                        peak_bytes: float):
    """The least time the card could take for one paged-attention call
    on these inputs: ``(seconds, "operations" | "bytes")``.

    FLOPs = 4·Hq·D·Σ(visible keys per valid query lane), from this
    call's tables and positions; bytes = the distinct pages any lane can
    see (K and V at every kv head, plus their scales when int8), q and
    out, each read or written once."""
    b, t, hq, d = q.shape
    bt, kvh = k_pool.shape[1], k_pool.shape[2]
    tables, row_starts, pad_lens = (x.cpu() for x in
                                    (tables, row_starts, pad_lens))
    ok = paged_visible(tables, row_starts, pad_lens, t, bt, window)
    flops = 4.0 * hq * d * int(ok.sum())
    seen = ok.any(dim=1).reshape(b, tables.shape[1], bt).any(dim=-1)
    pages = int(torch.unique(tables[seen]).numel())
    page_bytes = 2 * bt * kvh * (d * k_pool.element_size()
                                 + (4 if quant else 0))
    nbytes = pages * page_bytes + 2 * q.numel() * q.element_size()
    by_ops, by_bytes = flops / peak_flops, nbytes / peak_bytes
    if by_ops >= by_bytes:
        return by_ops, "operations"
    return by_bytes, "bytes"
