"""The port's Llama (models/llama.py, models/convert.py) against the JAX
package's, on the same weights.

A TinyLlama-sized ``Llama`` (2 layers, d_model 64, 4 heads, 2 KV heads,
vocab 256) in float32 with ``attn_impl="flash"``: the JAX params are
initialised from a seed, converted to the port's state dict, and both
models get the same numpy token batches. Tolerances: logits atol 1e-4
(float32, different summation orders over two layers); greedy tokens
identical; the converter round trip exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_distributed_template_tpu.models  # noqa: F401
from pytorch_distributed_template_tpu.config.registry import MODELS as JMODELS
from pytorch_distributed_template_tpu.engine import generate as jgen
import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TMODELS,
)
from pytorch_distributed_template_tpu_torch.engine import generate as tgen
from pytorch_distributed_template_tpu_torch.models.convert import (
    flax_from_params, params_from_flax,
)

ATOL = 1e-4
KW = dict(vocab_size=256, n_layer=2, n_head=4, n_kv_head=2, d_model=64,
          max_len=128, attn_impl="flash")


def _pair(window):
    jmodel = JMODELS.get("Llama")(**KW, window=window)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))[
        "params"]
    params = jax.tree.map(np.asarray, params)
    tmodel = TMODELS.get("Llama")(**KW, window=window, device="cpu")
    tmodel.load_state_dict(params_from_flax(params))
    return jmodel, params, tmodel.eval()


@pytest.fixture(scope="module", params=[0, 8], ids=["full", "window8"])
def pair(request):
    return (request.param,) + _pair(request.param)


def _tokens(b, t, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, t)).astype(
        np.int32)


def test_plain_forward_logits_match(pair):
    window, jmodel, params, tmodel = pair
    toks = _tokens(2, 24, seed=1)
    j = np.asarray(jmodel.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        t = tmodel(torch.from_numpy(toks).long())
    assert t.dtype == torch.float32 and t.shape == (2, 24, 256)
    np.testing.assert_allclose(t.numpy(), j, atol=ATOL)


def test_prefill_last_logits_match(pair):
    window, jmodel, params, tmodel = pair
    toks = _tokens(2, 12, seed=2)
    total = 12 + 12
    j_last, _ = jgen._prefill_fresh(jmodel, total)(params,
                                                   jnp.asarray(toks))
    with torch.no_grad():
        t_last, cache = tgen._prefill_fresh(
            tmodel, torch.from_numpy(toks).long(), total)
    assert cache.pos_index == 12
    assert cache.layers[0].k.shape[1] == tmodel.cache_len(total)
    np.testing.assert_allclose(t_last.numpy(), np.asarray(j_last),
                               atol=ATOL)


@pytest.mark.parametrize("t0, new", [(10, 12), (3, 4)],
                         ids=["long", "short"])
def test_greedy_decode_tokens_identical(pair, t0, new):
    """Twelve greedy steps from a 10-token prompt: with window 8 the total
    (22) exceeds the window, so the rolling ring cache and the band-masked
    history read run; the short case (total 7 < 8) keeps the contiguous
    windowed cache."""
    window, jmodel, params, tmodel = pair
    toks = _tokens(2, t0, seed=3)
    j = np.asarray(jgen.generate(jmodel, params, jnp.asarray(toks), new,
                                 temperature=0.0))
    t = tgen.generate(tmodel, torch.from_numpy(toks).long(), new,
                      temperature=0.0)
    if window and t0 + new > window:
        assert tmodel.cache_len(t0 + new) == window
    np.testing.assert_array_equal(t.numpy(), j)


def test_converter_round_trip_exact():
    _, params, tmodel = _pair(0)
    back = flax_from_params(params_from_flax(params))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    sd = tmodel.state_dict()
    again = params_from_flax(flax_from_params(sd))
    assert set(again) == set(sd)
    for name, tensor in sd.items():
        assert torch.equal(again[name], tensor), name
    # layout: kernels [in, out] become nn.Linear weights [out, in]
    q_kernel = params["layers_0"]["self_attn"]["q_proj"]["kernel"]
    assert sd["layers.0.self_attn.q_proj.weight"].shape == q_kernel.T.shape


def test_prefill_needs_fresh_cache():
    _, _, tmodel = _pair(0)
    toks = torch.from_numpy(_tokens(1, 4)).long()
    with torch.no_grad():
        _, cache = tgen._prefill_fresh(tmodel, toks, 8)
        with pytest.raises(ValueError, match="fresh cache"):
            tmodel(toks, cache=cache, prefill=True)


@pytest.mark.parametrize("arg, value", [
    ("quant", "w8a16"), ("kv_quant", "int8"), ("lora_rank", 4),
    ("attn_impl", "ring_flash"),
])
def test_later_slices_refuse(arg, value):
    if (arg, value) == ("kv_quant", "int8"):
        # ported with the paged pool: the int8 KV cache builds int8 rows
        # with f32 scales instead of refusing
        cache = TMODELS.get("TinyLlama")(kv_quant="int8",
                                         device="cpu").new_cache(1, 8)
        assert cache.layers[0].k.dtype == torch.int8
        assert cache.layers[0].k_scale.dtype == torch.float32
        return
    with pytest.raises(NotImplementedError):
        TMODELS.get("TinyLlama")(**{arg: value}, device="cpu")


def test_mistral_registry_defaults_are_published_shape():
    model = TMODELS.get("Mistral")(device="meta")
    assert (model.vocab_size, model.n_layer, model.n_head, model.n_kv_head,
            model.d_model, model.d_ff, model.window, model.head_dim) == (
        32000, 32, 32, 8, 4096, 14336, 4096, 128)
    assert model.dtype == torch.bfloat16
    n = sum(p.numel() for p in model.parameters())
    assert 7.2e9 < n < 7.3e9
