"""The fused expert FFN of the MoE layer: the hand-written CUDA kernel B5
and its plain version.

Counterpart of ``scripts/debug_moe_pallas_ffn.py`` (``pallas_expert_ffn``,
the Pallas kernel ``_ffn_kernel``, and ``xla_expert_ffn``, the einsums it
is held against), which computes the expert FFN of the JAX ``MoeMlp``'s
``"gelu"`` arm (``pytorch_distributed_template_tpu/models/moe.py``)::

    out[e] = gelu_tanh(x[e] @ wi[e] + bi[e]) @ wo[e] + bo[e]

with ``x [E, C, D]``, ``wi [E, D, F]``, ``wo [E, F, D]`` and the optional
biases ``bi [E, F]``, ``bo [E, D]`` (without them it is the TPU kernel's
contract exactly). Products accumulate in float32, the biases and the
tanh-gelu are float32, the hidden is rounded to the input dtype before the
second product and the result once to the input dtype.

For a CUDA tensor :func:`expert_ffn` launches the kernel or raises; for a
CPU tensor it runs :func:`expert_ffn_ref`. There is no fallback. The kernel
(``csrc/expert_ffn.cu``) is, in bf16, two launches of one hand-written
grouped GEMM for Hopper (TMA, mbarriers, wgmma): the first writes the
hidden ``bf16(gelu(x wi + bi))`` into an ``[E, C, F]`` scratch that the
wrapper allocates, the second ``hidden wo + bo``. Unlike the TPU kernel the
hidden goes through device memory: an accumulator big enough to stop the
weights being re-read per row tile does not fit a block's registers (see
the source note). In float32 it is one fused launch on the CUDA cores.

It is differentiable through :class:`ExpertFFN`: the forward is the kernel
(or the plain version), the backward recomputes the hidden and takes the
five gradients with ``torch.bmm`` and elementwise ops, as XLA
differentiates the JAX package's einsums (it has no backward kernel).
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.nn import functional as F

from .build import CudaLibrary

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 1024          # widest model dimension the kernel takes
_GELU_C = math.sqrt(2.0 / math.pi)


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pdt_expert_ffn.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
    lib.pdt_expert_ffn.restype = i32
    lib.pdt_expert_ffn_rows.argtypes = [i32, i32]
    lib.pdt_expert_ffn_rows.restype = i32
    lib.pdt_expert_ffn_error_string.argtypes = [i32]
    lib.pdt_expert_ffn_error_string.restype = ctypes.c_char_p


#: the B5 kernel library; ``EXPERT_FFN.launches`` counts its calls, one
#: per forward (the bf16 arm's two GEMM launches count once)
EXPERT_FFN = CudaLibrary("expert_ffn", _declare)


def _check(x, wi, wo, bi, bo):
    if x.dim() != 3 or wi.dim() != 3 or wo.dim() != 3:
        raise ValueError("expert FFN takes x [E, C, D], wi [E, D, F], "
                         "wo [E, F, D]")
    e, _, d = x.shape
    f = wi.shape[2]
    if tuple(wi.shape) != (e, d, f) or tuple(wo.shape) != (e, f, d):
        raise ValueError(f"wi {tuple(wi.shape)} / wo {tuple(wo.shape)} do "
                         f"not fit x {tuple(x.shape)}")
    if bi is not None and tuple(bi.shape) != (e, f):
        raise ValueError(f"bi must be [E, F] = {(e, f)}, got "
                         f"{tuple(bi.shape)}")
    if bo is not None and tuple(bo.shape) != (e, d):
        raise ValueError(f"bo must be [E, D] = {(e, d)}, got "
                         f"{tuple(bo.shape)}")


def expert_ffn_ref(x, wi, wo, bi=None, bo=None):
    """Plain PyTorch version: ``bmm`` -> tanh-gelu -> ``bmm`` in float32,
    the hidden rounded to ``x``'s dtype before the second product (as the
    TPU kernel and ``xla_expert_ffn`` do), the result in ``x``'s dtype."""
    _check(x, wi, wo, bi, bo)
    h = torch.bmm(x.float(), wi.float())
    if bi is not None:
        h = h + bi.float()[:, None]
    h = F.gelu(h, approximate="tanh").to(x.dtype)
    out = torch.bmm(h.float(), wo.float())
    if bo is not None:
        out = out + bo.float()[:, None]
    return out.to(x.dtype)


def _expert_ffn_cuda(x, wi, wo, bi, bo):
    """Launch the B5 kernel on PyTorch's current stream (bf16: its two
    GEMMs, through a hidden scratch allocated here)."""
    dtype = x.dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"expert_ffn kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    tensors = [t for t in (x, wi, wo, bi, bo) if t is not None]
    if any(t.dtype != dtype for t in tensors):
        raise TypeError("x, wi, wo and the biases must share one dtype")
    if any(t.device != x.device for t in tensors):
        raise ValueError("expert FFN inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("expert_ffn kernel needs contiguous inputs")
    e, c, d = x.shape
    f = wi.shape[2]
    if d % 16 or f % 16:
        raise ValueError(f"expert_ffn kernel takes D and F multiples of 16, "
                         f"got D={d} F={f}")
    if d > MAX_D:
        raise ValueError(f"expert_ffn kernel takes D <= {MAX_D}, got {d}")
    if min(e, c) <= 0:
        raise ValueError(f"expert_ffn kernel needs E, C >= 1, got "
                         f"{tuple(x.shape)}")
    if dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                       for t in (x, wi, wo)):
        raise ValueError("expert_ffn's bf16 kernel loads x, wi and wo by "
                         "TMA: they must start 16-byte aligned")
    lib = EXPERT_FFN.load()
    out = torch.empty_like(x)
    hidden = (torch.empty((e, c, f), dtype=dtype, device=x.device)
              if dtype == torch.bfloat16 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        EXPERT_FFN.count(x.device)
        err = lib.pdt_expert_ffn(
            x.data_ptr(), wi.data_ptr(), wo.data_ptr(),
            None if bi is None else bi.data_ptr(),
            None if bo is None else bo.data_ptr(),
            None if hidden is None else hidden.data_ptr(), out.data_ptr(),
            e, c, d, f, _DTYPE_CODES[dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"expert_ffn launch failed: CUDA error {err} "
            f"({lib.pdt_expert_ffn_error_string(err).decode()})")
    return out


def _forward(x, wi, wo, bi, bo):
    if x.device.type == "cpu":
        return expert_ffn_ref(x, wi, wo, bi, bo)
    if x.device.type != "cuda":
        raise ValueError(f"expert FFN runs on cpu or cuda, not {x.device}")
    return _expert_ffn_cuda(x, wi, wo, bi, bo)


class ExpertFFN(torch.autograd.Function):
    """``(x, wi, wo, bi, bo) -> out``: the forward is B5 (or the plain
    version on the CPU); the backward recomputes ``pre = x wi + bi`` and
    returns dx, dwi, dbi, dwo, dbo. The products run in the input dtype
    (f32 accumulation in cuBLAS), the gelu derivative in float32."""

    @staticmethod
    def forward(ctx, x, wi, wo, bi, bo):
        ctx.save_for_backward(x, wi, wo, bi, bo)
        return _forward(x, wi, wo, bi, bo)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, wi, wo, bi, bo = ctx.saved_tensors
        dt = x.dtype
        g = g.to(dt)
        pre = torch.bmm(x, wi).float()
        if bi is not None:
            pre = pre + bi.float()[:, None]
        u = _GELU_C * (pre + 0.044715 * pre ** 3)
        t = torch.tanh(u)
        h = (0.5 * pre * (1.0 + t)).to(dt)
        dgelu = 0.5 * (1.0 + t) + 0.5 * pre * (1.0 - t * t) * _GELU_C * (
            1.0 + 3 * 0.044715 * pre * pre)
        del u, t, pre
        dpre = torch.bmm(g, wo.transpose(1, 2)).float() * dgelu
        del dgelu
        dbi = None if bi is None else dpre.sum(1).to(bi.dtype)
        dpre = dpre.to(dt)
        dx = torch.bmm(dpre, wi.transpose(1, 2))
        dwi = torch.bmm(x.transpose(1, 2), dpre)
        dwo = torch.bmm(h.transpose(1, 2), g)
        dbo = None if bo is None else g.float().sum(1).to(bo.dtype)
        return dx, dwi, dwo, dbi, dbo


def expert_ffn(x, wi, wo, bi=None, bo=None):
    """The expert FFN ``[E, C, D] -> [E, C, D]``, differentiable in every
    input. CPU tensors take :func:`expert_ffn_ref`; CUDA tensors launch
    kernel B5 or raise."""
    _check(x, wi, wo, bi, bo)
    return ExpertFFN.apply(x, wi, wo, bi, bo)


def expert_ffn_bound_seconds(e: int, c: int, d: int, f: int, itemsize: int,
                             bias: bool, peak_flops: float,
                             peak_bytes: float):
    """The least time the card could take for one forward call:
    ``(seconds, "operations" | "bytes")``.

    FLOPs = 4·E·C·D·F (two products); bytes = x, wi, wo (and the biases)
    read once and out written once."""
    flops = 4.0 * e * c * d * f
    nbytes = itemsize * (2 * e * c * d + 2 * e * d * f)
    if bias:
        nbytes += itemsize * e * (d + f)
    by_ops, by_bytes = flops / peak_flops, nbytes / peak_bytes
    if by_ops >= by_bytes:
        return by_ops, "operations"
    return by_bytes, "bytes"
