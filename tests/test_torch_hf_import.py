"""The port's HF weight import and export (models/hf_import.py) against the
JAX package's, on the CPU. Nothing is downloaded: the HF-layout state
dicts are made here from a seeded numpy generator, and the ``transformers``
models (where the package is installed) are built from local random-init
configs.

- ``import_hf_gpt2`` / ``import_hf_llama`` (tied and untied heads, with
  and without the ``transformer.`` / ``model.`` prefixes) equal
  ``params_from_flax`` of the JAX import, exactly.
- ``export_hf_gpt2`` / ``export_hf_llama`` equal the JAX export of the
  same weights (``flax_from_params``), exactly, and export(import(sd))
  gives ``sd`` back, bit for bit.
- The port's ``TinyLM`` / ``TinyLlama`` loaded through the import give
  ``GPT2LMHeadModel``'s / ``LlamaForCausalLM``'s logits within atol 1e-4
  (float32, different kernels and summation orders; skipped without
  ``transformers``), and the exported state dict loads into a fresh HF
  model that gives the same logits.
- The refusals, as in JAX: a missing key, more blocks than ``n_layer``,
  and an untied head on the GPT-2 export.
"""
import numpy as np
import pytest
import torch

from pytorch_distributed_template_tpu.models import hf_import as jhf
import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TM,
)
from pytorch_distributed_template_tpu_torch.models import hf_import as thf
from pytorch_distributed_template_tpu_torch.models.convert import (
    flax_from_params, params_from_flax,
)

V, D, H, KVH, F, L, T = 96, 64, 4, 2, 128, 2, 32
LOGIT_ATOL = 1e-4


def hf_gpt2_state(seed=0, prefix="transformer.", n_layer=L):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.05

    sd = {"wte.weight": w(V, D), "wpe.weight": w(T, D),
          "ln_f.weight": 1 + w(D), "ln_f.bias": w(D)}
    for i in range(n_layer):
        p = f"h.{i}."
        sd.update({p + "ln_1.weight": 1 + w(D), p + "ln_1.bias": w(D),
                   p + "ln_2.weight": 1 + w(D), p + "ln_2.bias": w(D),
                   p + "attn.c_attn.weight": w(D, 3 * D),
                   p + "attn.c_attn.bias": w(3 * D),
                   p + "attn.c_proj.weight": w(D, D),
                   p + "attn.c_proj.bias": w(D),
                   p + "mlp.c_fc.weight": w(D, 4 * D),
                   p + "mlp.c_fc.bias": w(4 * D),
                   p + "mlp.c_proj.weight": w(4 * D, D),
                   p + "mlp.c_proj.bias": w(D)})
    return {prefix + k: v for k, v in sd.items()}


def hf_llama_state(seed=0, tied=False, prefix="model.", n_layer=L):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.05

    hd = D // H
    sd = {"embed_tokens.weight": w(V, D), "norm.weight": 1 + w(D)}
    for i in range(n_layer):
        p = f"layers.{i}."
        sd.update({p + "input_layernorm.weight": 1 + w(D),
                   p + "post_attention_layernorm.weight": 1 + w(D),
                   p + "self_attn.q_proj.weight": w(D, D),
                   p + "self_attn.k_proj.weight": w(KVH * hd, D),
                   p + "self_attn.v_proj.weight": w(KVH * hd, D),
                   p + "self_attn.o_proj.weight": w(D, D),
                   p + "mlp.gate_proj.weight": w(F, D),
                   p + "mlp.up_proj.weight": w(F, D),
                   p + "mlp.down_proj.weight": w(D, F)})
    out = {prefix + k: v for k, v in sd.items()}
    if not tied:
        out["lm_head.weight"] = w(V, D)
    return out


def _equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def _as_torch(sd):
    return {k: torch.tensor(v) for k, v in sd.items()}


@pytest.mark.parametrize("prefix", ["transformer.", ""])
def test_gpt2_import_and_export_equal_jax(prefix):
    sd = hf_gpt2_state(prefix=prefix)
    got = thf.import_hf_gpt2(_as_torch(sd), L)
    _equal(got, params_from_flax(jhf.import_hf_gpt2(sd, L)))
    exported = thf.export_hf_gpt2(got)
    _equal(exported, jhf.export_hf_gpt2(flax_from_params(got)))
    _equal(exported, {("transformer." + k if not prefix else k): v
                      for k, v in sd.items()} | {
        "lm_head.weight": sd[prefix + "wte.weight"]})
    _equal(thf.import_hf_gpt2(exported, L), got)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("prefix", ["model.", ""])
def test_llama_import_and_export_equal_jax(tied, prefix):
    sd = hf_llama_state(tied=tied, prefix=prefix)
    got = thf.import_hf_llama(_as_torch(sd), L)
    _equal(got, params_from_flax(jhf.import_hf_llama(sd, L)))
    exported = thf.export_hf_llama(got)
    _equal(exported, jhf.export_hf_llama(flax_from_params(got)))
    head = sd["lm_head.weight"] if not tied \
        else sd[prefix + "embed_tokens.weight"]
    _equal(exported, {("model." + k if not prefix and k != "lm_head.weight"
                       else k): v for k, v in sd.items()}
           | {"lm_head.weight": head})
    _equal(thf.import_hf_llama(exported, L), got)


def test_refusals_equal_jax():
    gpt2, llama = hf_gpt2_state(), hf_llama_state()
    for imp, jimp, sd, name in (
            (thf.import_hf_gpt2, jhf.import_hf_gpt2, gpt2,
             "transformer.h.1.mlp.c_fc.bias"),
            (thf.import_hf_llama, jhf.import_hf_llama, llama,
             "model.layers.0.self_attn.k_proj.weight")):
        short = {k: v for k, v in sd.items() if k != name}
        for fn in (imp, jimp):
            with pytest.raises(KeyError, match="missing"):
                fn(short, L)
            with pytest.raises(ValueError, match="more than n_layer"):
                fn(sd, L - 1)
    untied = dict(thf.import_hf_gpt2(gpt2, L),
                  **{"lm_head.weight": torch.zeros(V, D)})
    with pytest.raises(ValueError, match="untied lm_head"):
        thf.export_hf_gpt2(untied)
    with pytest.raises(ValueError, match="untied lm_head"):
        jhf.export_hf_gpt2(dict(flax_from_params(
            {k: v for k, v in untied.items() if k != "lm_head.weight"}),
            lm_head={"kernel": np.zeros((D, V), np.float32)}))


def _tokens():
    return torch.tensor(np.random.default_rng(3).integers(0, V, (2, 24)))


def test_gpt2_logits_equal_transformers():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = transformers.GPT2Config(vocab_size=V, n_positions=T, n_embd=D,
                                  n_layer=L, n_head=H, resid_pdrop=0.0,
                                  embd_pdrop=0.0, attn_pdrop=0.0)
    hf = transformers.GPT2LMHeadModel(cfg).eval()
    port = TM.get("TinyLM")(vocab_size=V, n_layer=L, n_head=H, d_model=D,
                            max_len=T, device="cpu").eval()
    port.load_state_dict(thf.import_hf_gpt2(hf.state_dict(), L))
    toks = _tokens()
    with torch.no_grad():
        want = hf(toks).logits
        np.testing.assert_allclose(port(toks).numpy(), want.numpy(),
                                   atol=LOGIT_ATOL)
        fresh = transformers.GPT2LMHeadModel(cfg).eval()
        fresh.load_state_dict(_as_torch(thf.export_hf_gpt2(
            port.state_dict())), strict=False)
        np.testing.assert_array_equal(fresh(toks).logits.numpy(),
                                      want.numpy())


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_llama_logits_equal_transformers(tied):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(
        vocab_size=V, hidden_size=D, intermediate_size=F,
        num_hidden_layers=L, num_attention_heads=H, num_key_value_heads=KVH,
        max_position_embeddings=T, rms_norm_eps=1e-6, rope_theta=10000.0,
        tie_word_embeddings=tied, attn_implementation="eager")
    hf = transformers.LlamaForCausalLM(cfg).eval()
    sd = hf.state_dict()
    if tied:
        sd = {k: v for k, v in sd.items() if k != "lm_head.weight"}
    port = TM.get("TinyLlama")(vocab_size=V, n_layer=L, n_head=H,
                               n_kv_head=KVH, d_model=D, d_ff=F, max_len=T,
                               device="cpu").eval()
    port.load_state_dict(thf.import_hf_llama(sd, L))
    toks = _tokens()
    with torch.no_grad():
        want = hf(toks).logits
        np.testing.assert_allclose(port(toks).numpy(), want.numpy(),
                                   atol=LOGIT_ATOL)
        fresh = transformers.LlamaForCausalLM(cfg).eval()
        fresh.load_state_dict(_as_torch(thf.export_hf_llama(
            port.state_dict())), strict=False)
        np.testing.assert_array_equal(fresh(toks).logits.numpy(),
                                      want.numpy())
