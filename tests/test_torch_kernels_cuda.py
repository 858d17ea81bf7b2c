"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here needs a CUDA device and skips
without one; the file imports nothing of JAX, so on a machine without JAX
it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_kernels_cuda.py

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
