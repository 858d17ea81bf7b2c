"""Flash-attention forward: the hand-written CUDA kernel and its plain
version.

Counterpart of ``pytorch_distributed_template_tpu/ops/flash.py``
(``flash_attention``, ``flash_attention_lse``), forward only. The kernel
(``csrc/flash_fwd.cu``, replacing the Pallas ``_fwd_kernel``: bf16 on the
tensor cores, float32 on the CUDA cores) runs for tensors on a CUDA
device; ``flash_attention_ref`` computes the same function in plain
PyTorch and is used for CPU tensors and as the kernel's oracle. There is no fallback: on a CUDA tensor the wrapper launches the
kernel or raises.

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

from .build import CudaLibrary

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
    p = torch.exp(s - m).masked_fill_(~ok, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min_(1e-30)
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
        raise ValueError("flash_fwd's bf16 kernel reads 16-byte vectors: "
                         "q, k, v must start 16-byte aligned")
    lib = FLASH_FWD.load()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        FLASH_FWD.launches += 1
        err = lib.pdt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, t, h, k.shape[2], d, _DTYPE_CODES[dtype],
            int(bool(causal)), int(window), float(d ** -0.5), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_fwd launch failed: CUDA error {err} "
            f"({lib.pdt_cuda_error_string(err).decode()})")
    return out, lse


def flash_attention_lse(q, k, v, causal: bool = False, window: int = 0):
    """Fused attention returning ``(out [B, T, H, D], lse [B, H, T] f32)``.

    CPU tensors take :func:`flash_attention_ref`; CUDA tensors take the
    kernel (or raise)."""
    _check_gqa(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not "
                         f"{q.device}")
    return _flash_fwd_cuda(q, k, v, causal, window)


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """Fused attention ``[B, T, H, D] -> [B, T, H, D]`` (k/v may carry
    fewer heads: GQA at stored width)."""
    return flash_attention_lse(q, k, v, causal=causal, window=window)[0]


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
