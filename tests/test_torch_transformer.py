"""The port's training models against the JAX package's, on the CPU: GPT2 /
TinyLM (models/transformer.py) and the Llama family's training path
(fused head, remat, differentiable flash with GQA and a window).

Params come from the JAX module's init and cross with
``models.convert.params_from_flax``; tokens come from a seeded numpy
generator. Checked in float32: logits, the fused ``(hidden, head_w)`` pair,
and the gradients of the next-token loss against ``jax.grad``.
Tolerances: forward atol 2e-5; gradients atol 2e-5 + rtol 2e-4 (float32,
summation orders differ through two layers, attention and the loss). The
JAX flash path runs its Pallas kernels in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_distributed_template_tpu.models  # noqa: F401  (register)
import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu.config.registry import MODELS as JM
from pytorch_distributed_template_tpu.engine import losses as jlosses
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TM,
)
from pytorch_distributed_template_tpu_torch.engine import losses as tlosses
from pytorch_distributed_template_tpu_torch.models.convert import (
    params_from_flax,
)

FWD_ATOL = 2e-5
GRAD_TOL = dict(atol=2e-5, rtol=2e-4)
TINY = dict(vocab_size=96, n_layer=2, n_head=4, d_model=64, max_len=32)
LLAMA = dict(vocab_size=96, n_layer=2, n_head=4, n_kv_head=2, d_model=64,
             max_len=32)


def _tokens(b=2, t=24, vocab=96, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def _pair(name, args, seed=0):
    """(flax module, params, port module with the same params)."""
    jm = JM.get(name)(**args)
    params = jm.init(jax.random.key(seed), jnp.asarray(_tokens()))["params"]
    tm = TM.get(name)(**args, device="cpu")
    tm.load_state_dict(params_from_flax(jax.device_get(params)),
                       strict=True)
    return jm, params, tm


def _jax_loss(jm, fused, chunk=8):
    crit = (jlosses.fused_lm_cross_entropy(chunk) if fused
            else jlosses.lm_cross_entropy)

    def loss(params, toks):
        return crit(jm.apply({"params": params}, toks), toks).mean()

    return loss


def _port_loss(tm, fused, chunk=8):
    crit = (tlosses.fused_lm_cross_entropy(chunk) if fused
            else tlosses.lm_cross_entropy)
    return lambda toks, **kw: crit(tm(toks, **kw), toks).mean()


def _check_grads(tm, jgrads):
    want = params_from_flax(jax.device_get(jgrads))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_tinylm_logits_and_grads_match_jax(attn_impl, tie):
    args = dict(TINY, attn_impl=attn_impl, tie_embeddings=tie)
    jm, params, tm = _pair("TinyLM", args)
    toks = _tokens()
    want = jm.apply({"params": params}, jnp.asarray(toks))
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        got = tm(tt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FWD_ATOL)
    jgrads = jax.grad(_jax_loss(jm, False))(params, jnp.asarray(toks))
    _port_loss(tm, False)(tt).backward()
    _check_grads(tm, jgrads)


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_fused_head_pair_and_grads_match_jax(tie):
    args = dict(TINY, attn_impl="flash", fused_head=True,
                tie_embeddings=tie)
    jm, params, tm = _pair("TinyLM", args, seed=1)
    toks = _tokens(seed=1)
    jh, jw = jm.apply({"params": params}, jnp.asarray(toks))
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        th, tw = tm(tt)
    assert tuple(tw.shape) == (TINY["d_model"], TINY["vocab_size"])
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=FWD_ATOL)
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw), atol=0)
    # chunk 8 over T - 1 = 23: a padded last chunk on both sides
    jgrads = jax.grad(_jax_loss(jm, True))(params, jnp.asarray(toks))
    _port_loss(tm, True)(tt).backward()
    _check_grads(tm, jgrads)


def test_gpt2_registry_builds_the_family():
    args = dict(size="gpt2-small", vocab_size=96, max_len=32, n_layer=2,
                d_model=64, n_head=4, dropout=0.0, fused_head=True,
                attn_impl="flash")
    jm, params, tm = _pair("GPT2", args)
    assert (tm.n_layer, tm.d_model, tm.d_ff) == (2, 64, 256)
    toks = _tokens(seed=2)
    jgrads = jax.grad(_jax_loss(jm, True))(params, jnp.asarray(toks))
    _port_loss(tm, True)(torch.from_numpy(toks)).backward()
    _check_grads(tm, jgrads)
    full = TM.get("GPT2")(device="meta")
    assert (full.n_layer, full.n_head, full.d_model, full.vocab_size,
            full.max_len) == (12, 12, 768, 50257, 1024)
    assert 124e6 < sum(p.numel() for p in full.parameters()) < 125e6


@pytest.mark.parametrize("fused, window", [(False, 0), (True, 10)])
def test_llama_training_path_matches_jax(fused, window):
    """TinyLlama with flash attention (GQA 4:2, optionally windowed) and
    the fused head: the loss gradients match ``jax.grad``."""
    args = dict(LLAMA, attn_impl="flash", fused_head=fused, window=window)
    jm, params, tm = _pair("TinyLlama", args, seed=3)
    toks = _tokens(seed=3)
    jgrads = jax.grad(_jax_loss(jm, fused))(params, jnp.asarray(toks))
    _port_loss(tm, fused)(torch.from_numpy(toks)).backward()
    _check_grads(tm, jgrads)


def _grads(tm, toks, **kw):
    tm.zero_grad(set_to_none=True)
    _port_loss(tm, True)(toks, **kw).backward()
    return {n: p.grad.clone() for n, p in tm.named_parameters()}


@pytest.mark.parametrize("name, args", [
    ("TinyLM", dict(TINY, attn_impl="flash", fused_head=True, dropout=0.0)),
    ("TinyLlama", dict(LLAMA, attn_impl="flash", fused_head=True,
                       window=10)),
])
def test_remat_on_equals_remat_off(name, args):
    off = TM.get(name)(**args, device="cpu")
    off.init_weights(torch.Generator().manual_seed(4))
    on = TM.get(name)(**args, remat=True, device="cpu")
    on.load_state_dict(off.state_dict())
    toks = torch.from_numpy(_tokens(seed=4))
    g_off, g_on = _grads(off, toks), _grads(on, toks)
    for n in g_off:
        torch.testing.assert_close(g_on[n], g_off[n], atol=1e-6, rtol=1e-5)


def test_dropout_grads_equal_under_remat():
    """Dropout > 0 in training mode: each mask is drawn from a generator
    seeded by (seed, layer, site) inside the block, so the checkpointed
    recompute redraws the same masks and the gradients equal the
    no-remat run's; another seed gives other masks."""
    args = dict(TINY, attn_impl="flash", fused_head=True, dropout=0.3)
    off = TM.get("TinyLM")(**args, device="cpu")
    off.init_weights(torch.Generator().manual_seed(5))
    on = TM.get("TinyLM")(**args, remat=True, device="cpu")
    on.load_state_dict(off.state_dict())
    off.train(), on.train()
    toks = torch.from_numpy(_tokens(seed=5))
    g_off = _grads(off, toks, dropout_seed=11)
    g_on = _grads(on, toks, dropout_seed=11)
    for n in g_off:
        torch.testing.assert_close(g_on[n], g_off[n], atol=1e-6, rtol=1e-5)
    g_other = _grads(on, toks, dropout_seed=12)
    assert not torch.allclose(g_other["h.0.mlp.up.weight"],
                              g_on["h.0.mlp.up.weight"])
    with pytest.raises(ValueError, match="dropout_seed"):
        on(toks)


def test_init_law():
    m = TM.get("TinyLM")(**dict(TINY, n_layer=8, d_model=256,
                                vocab_size=512), device="cpu")
    m.init_weights(torch.Generator().manual_seed(0))
    sd = m.state_dict()
    assert abs(sd["wte.weight"].std().item() - 0.02) < 2e-3
    assert abs(sd["wpe"].std().item() - 0.01) < 1e-3
    assert abs(sd["h.0.attn.out.weight"].std().item() - 0.005) < 5e-4
    assert abs(sd["h.3.mlp.down.weight"].std().item() - 0.005) < 5e-4
    assert not sd["h.1.attn.qkv.bias"].any()
    assert (sd["h.1.ln_2.weight"] == 1).all() and not sd["ln_f.bias"].any()


@pytest.mark.parametrize("arg, value", [
    ("attn_impl", "ring_flash"), ("quant", "w8a16"), ("kv_quant", "int8"),
    ("lora_rank", 4), ("seq_layout", "zigzag")])
def test_later_slices_refuse_by_name(arg, value):
    if arg in ("attn_impl", "seq_layout"):
        # sequence parallelism is ported: the model builds; a ring impl
        # needs a mesh (as in JAX), a zigzag layout without one is natural
        model = TM.get("TinyLM")(**{arg: value}, device="cpu")
        tokens = torch.zeros((1, 8), dtype=torch.long)
        if arg == "attn_impl":
            with pytest.raises(ValueError, match="requires a mesh"):
                model(tokens)
        else:
            plain = TM.get("TinyLM")(device="cpu")
            plain.load_state_dict(model.state_dict())
            torch.testing.assert_close(model(tokens), plain(tokens),
                                       rtol=0, atol=0)
    elif arg == "lora_rank":
        # ported with LoRA: qkv, out, up and down take adapters
        model = TM.get("TinyLM")(lora_rank=value, device="cpu")
        assert sum(n.endswith("lora_a")
                   for n, _ in model.named_parameters()) == 2 * 4
    elif arg == "quant":
        # ported with w8a16 serving weights: the biased projections hold
        # int8 kernels; the tied head stays the float embedding
        from pytorch_distributed_template_tpu_torch.models.quant import (
            W8A16Dense,
        )

        model = TM.get("TinyLM")(quant=value, device="cpu")
        assert sum(isinstance(m, W8A16Dense)
                   for m in model.modules()) == 2 * 4
    else:
        # ported with the decode caches: int8 rows with f32 scales
        cache = TM.get("TinyLM")(**{arg: value}, device="cpu").new_cache(
            1, 8)
        assert cache.layers[0].k.dtype == torch.int8
        assert cache.layers[0].k_scale.shape == (1, 8, 4)
    # the decode cache is ported: [B, L, H, D] per layer
    cache = TM.get("TinyLM")(device="cpu").new_cache(1, 8)
    assert cache.layers[0].k.shape == (1, 8, 4, 16)
