"""Serving quantization in the port (models/quant.py: ``W8A16Dense``,
``quantize_kernel_w8``, ``quantize_params_w8``, ``dequantize_params_w8``,
``validate_quant_config``; models/convert.py's quant trees;
tools/quantize_checkpoint.py) against the JAX package's
(``tests/test_quant.py``'s contracts) on the CPU.

Kernels and scales must be bit-equal to JAX's on the same f32 kernel, and
the converted trees must cross both ways unchanged. The quant model must
compute the dense model on the dequantized weights (atol and rtol 1e-4,
JAX's own bound) and the JAX quant model on the same tree (rtol 1e-5, atol
1e-5: one product order apart). Refusals carry JAX's messages.
"""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_distributed_template_tpu.models  # noqa: F401  (register)
import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu.config.registry import MODELS as JM
from pytorch_distributed_template_tpu.engine import generate as jgen
from pytorch_distributed_template_tpu.models import quant as jq
from pytorch_distributed_template_tpu_torch import generate as tcli
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TM,
)
from pytorch_distributed_template_tpu_torch.engine import generate as tgen
from pytorch_distributed_template_tpu_torch.models import quant as tq
from pytorch_distributed_template_tpu_torch.models.convert import (
    flax_from_params, params_from_flax,
)
from pytorch_distributed_template_tpu_torch.tools import quantize_checkpoint

LLAMA = dict(vocab_size=128, n_layer=2, n_head=4, n_kv_head=2, d_model=64,
             max_len=64, window=16)
TINYLM = dict(vocab_size=128, n_layer=2, n_head=4, d_model=64, max_len=64,
              tie_embeddings=False)


def _tok(b=2, t=12, vocab=128, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def _params(name, args, seed=0):
    jm = JM.get(name)(**args)
    return jm, jax.device_get(jm.init(jax.random.key(seed),
                                      jnp.asarray(_tok()))["params"])


def _port(name, args, state):
    m = TM.get(name)(**args, device="cpu").eval()
    m.load_state_dict(state)
    return m


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_kernels_and_scales_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(1)
    w = rng.normal(size=(48, 24)).astype(np.float32)
    w[:, 5] = 0.0                               # an all-zero column
    w = np.array(jnp.asarray(w, dtype).astype(jnp.float32))
    want = jq.quantize_kernel_w8(jnp.asarray(w, dtype))
    got = tq.quantize_kernel_w8(torch.from_numpy(w).to(
        torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32))
    assert got["kernel_q"].dtype == torch.int8
    np.testing.assert_array_equal(got["kernel_q"].numpy(),
                                  np.asarray(want["kernel_q"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    # the column maxima map to +-127, the zero column to scale 1
    assert (got["kernel_q"].abs().amax(0)[[0, 1, 23]] == 127).all()
    assert got["scale"][5] == 1.0 and not got["kernel_q"][:, 5].any()
    # reconstruction within half a step per entry
    recon = got["kernel_q"].float() * got["scale"]
    assert ((recon - torch.from_numpy(w)).abs()
            <= got["scale"] / 2 + 1e-7).all()


@pytest.mark.parametrize("name, args", [("Llama", LLAMA),
                                        ("TinyLM", TINYLM)])
def test_converter_tree_matches_jax_and_the_quant_model(name, args):
    _, params = _params(name, args)
    qparams = jax.device_get(jq.quantize_params_w8(params))
    got = tq.quantize_params_w8(params_from_flax(params))
    want = params_from_flax(qparams)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    # the tree is exactly the quant model's state dict, and crosses back
    qm = TM.get(name)(**args, quant="w8a16", device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in qm.state_dict().items()}
    back = flax_from_params(got)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), back, jax.tree.map(np.asarray,
                                                          qparams))
    assert jax.tree.leaves(back)[0].dtype in (np.float32, np.int8)
    # the embedding and the norms pass through untouched
    emb = "embed_tokens.weight" if name == "Llama" else "wte.weight"
    assert torch.equal(got[emb], params_from_flax(params)[emb])


@pytest.mark.parametrize("name, args", [("Llama", LLAMA),
                                        ("TinyLM", TINYLM)])
def test_quant_model_equals_dense_and_jax(name, args):
    jm, params = _params(name, args)
    jmq = JM.get(name)(**args, quant="w8a16")
    qparams = jax.device_get(jq.quantize_params_w8(params))
    tok = _tok(seed=2)
    state = params_from_flax(qparams)
    qm = _port(name, dict(args, quant="w8a16"), state)
    dm = _port(name, args, tq.dequantize_params_w8(state))
    x = torch.from_numpy(tok).long()
    with torch.no_grad():
        lq, ld = qm(x).numpy(), dm(x).numpy()
    np.testing.assert_allclose(lq, ld, atol=1e-4, rtol=1e-4)
    want = np.asarray(jmq.apply({"params": qparams}, jnp.asarray(tok),
                                train=False))
    np.testing.assert_allclose(lq, want, rtol=1e-5, atol=1e-5)
    # and the error against the original dense model is small
    lo = np.asarray(jm.apply({"params": params}, jnp.asarray(tok),
                             train=False))
    assert np.abs(lq - lo).max() / np.abs(lo).max() < 0.05


def test_dequantized_tree_matches_jax():
    _, params = _params("Llama", LLAMA)
    qparams = jq.quantize_params_w8(params)
    want = params_from_flax(jax.device_get(jq.dequantize_params_w8(
        qparams)))
    got = tq.dequantize_params_w8(params_from_flax(jax.device_get(qparams)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)


def test_w8a16_with_int8_kv_generate_matches_jax():
    """The whole int8 serving stack (w8a16 weights, int8 KV, the rolling
    window) decodes JAX's greedy ids."""
    _, params = _params("Llama", LLAMA)
    qparams = jax.device_get(jq.quantize_params_w8(params))
    args = dict(LLAMA, quant="w8a16", kv_quant="int8")
    jmq = JM.get("Llama")(**args)
    tok = _tok(seed=3)[:, :6]
    want = np.asarray(jgen.generate(jmq, qparams, jnp.asarray(tok), 12,
                                    temperature=0.0))
    tm = _port("Llama", args, params_from_flax(qparams))
    got = tgen.generate(tm, torch.from_numpy(tok), 12, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gpt2_family_biased_denses_and_tied_head():
    _, params = _params("TinyLM", TINYLM)
    qstate = tq.quantize_params_w8(params_from_flax(params))
    # the biases pass through, f32, beside the int8 kernels
    np.testing.assert_array_equal(
        qstate["h.0.attn.qkv.bias"].numpy(),
        np.asarray(params["h_0"]["attn"]["qkv"]["bias"]))
    assert qstate["h.0.mlp.up.kernel_q"].shape == (64, 256)
    assert qstate["lm_head.kernel_q"].shape == (64, 128)
    # the tied head keeps attending through the float embedding
    tied = dict(TINYLM, tie_embeddings=True, n_layer=1)
    _, p1 = _params("TinyLM", tied, seed=1)
    q1 = tq.quantize_params_w8(params_from_flax(p1))
    assert "lm_head.kernel_q" not in q1 and q1["wte.weight"].dtype == \
        torch.float32
    qm = _port("TinyLM", dict(tied, quant="w8a16"), q1)
    jout = JM.get("TinyLM")(**tied, quant="w8a16").apply(
        {"params": jq.quantize_params_w8(p1)}, jnp.asarray(_tok()),
        train=False)
    with torch.no_grad():
        np.testing.assert_allclose(qm(torch.from_numpy(_tok()).long()),
                                   np.asarray(jout), rtol=1e-5, atol=1e-5)


def _jax_refusal(model):
    with pytest.raises(ValueError) as e:
        model.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    return str(e.value)


def test_unsupported_quant_combos_rejected_with_jax_messages():
    from pytorch_distributed_template_tpu.models.transformer import (
        TransformerLM as JTransformer,
    )
    from pytorch_distributed_template_tpu_torch.models.transformer import (
        TransformerLM as TTransformer,
    )

    fused = dict(vocab_size=64, n_layer=1, n_head=4, d_model=64, max_len=32,
                 fused_head=True, quant="w8a16")
    msg = _jax_refusal(JM.get("Llama")(**fused))
    with pytest.raises(ValueError) as e:
        TM.get("Llama")(**fused, device="meta")
    assert str(e.value) == msg
    moe = dict(vocab_size=64, n_layer=2, n_head=4, d_model=64, max_len=32,
               moe_experts=2, moe_every=1, quant="w8a16")
    msg = _jax_refusal(JTransformer(**moe))
    with pytest.raises(ValueError) as e:
        TTransformer(**moe, device="meta")
    assert str(e.value) == msg
    with pytest.raises(ValueError, match="MoE"):
        TM.get("MixtralMoE")(vocab_size=64, n_layer=1, n_head=4,
                             n_kv_head=2, d_model=64, d_ff=128, max_len=32,
                             quant="w8a16", fused_head=False, device="meta")
    with pytest.raises(ValueError, match="FINE-TUNING"):
        TM.get("TinyLlama")(quant="w8a16", lora_rank=4, device="meta")
    # the converter leaves a router untouched even when handed one
    state = {"h.0.moe.router.weight": torch.ones(4, 8),
             "h.0.moe.router.bias": torch.zeros(4)}
    assert tq.quantize_params_w8(state) == state


def _run(tmp_path, config, args, ckpt="model_best"):
    """A training run's layout: ``config.json`` beside ``<ckpt>/model.pt``
    of a random-init model."""
    cfg = json.loads(open(config).read())
    cfg["arch"]["args"].update(args)
    run = tmp_path / "run"
    (run / ckpt).mkdir(parents=True)
    (run / "config.json").write_text(json.dumps(cfg))
    model = TM.get(cfg["arch"]["type"])(**cfg["arch"]["args"], device="cpu")
    model.init_weights(torch.Generator().manual_seed(4))
    torch.save(model.state_dict(), run / ckpt / "model.pt")
    return run / ckpt, cfg


TINY_BYTE = {"n_layer": 2, "n_head": 2, "d_model": 64, "max_len": 96}


def test_quantize_checkpoint_tool_then_generate(tmp_path):
    ckpt, cfg = _run(tmp_path, "configs/bytelm_stdlib.json", TINY_BYTE)
    with contextlib.redirect_stdout(io.StringIO()):
        art = quantize_checkpoint.main(["-r", str(ckpt), "-s",
                                        str(tmp_path / "log"),
                                        "--device", "cpu"])
    assert art == ckpt.parent / "serving_w8a16" / "model_w8a16"
    scfg = json.loads((art.parent / "config.json").read_text())
    assert scfg["arch"]["args"]["quant"] == "w8a16"
    assert scfg["arch"]["args"]["fused_head"] is False
    state = torch.load(ckpt / "model.pt")
    meta = json.loads((art.parent / "model_w8a16.meta.json").read_text())
    assert meta["quant"] == "w8a16" and meta["params_only"]
    assert meta["w8a16_bytes"] < meta["dense_bytes"]
    # the port's generate.py builds the quant model from the artifact's
    # config: the same ids as the quant model built by hand
    argv = ["-r", str(art), "--prompt", "def main(", "--max-new-tokens",
            "8", "--device", "cpu", "-s", str(tmp_path / "gen")]
    with contextlib.redirect_stdout(io.StringIO()):
        resp = tcli.main(argv)
        spec = tcli.main(argv + ["--speculative", "3"])
    args = dict(cfg["arch"]["args"], quant="w8a16", fused_head=False)
    qm = _port("GPT2", args, tq.quantize_params_w8(state))
    want = tgen.generate(qm, torch.tensor([list(b"def main(")]), 8,
                         temperature=0.0)[0, 9:].tolist()
    assert resp["ids"] == want == spec["ids"]
    assert spec["speculative"]["tokens_emitted"] == 8
    # re-quantizing an artifact is refused, as in JAX
    with pytest.raises(SystemExit, match="already a w8a16"):
        quantize_checkpoint.main(["-r", str(art), "-s",
                                  str(tmp_path / "log"), "--device", "cpu"])


def test_quantize_checkpoint_refuses_moe(tmp_path):
    ckpt, _ = _run(tmp_path, "configs/moelm_stdlib.json",
                   {"n_layer": 2, "n_head": 2, "d_model": 64, "d_ff": 128,
                    "max_len": 32})
    with pytest.raises(ValueError) as e:
        quantize_checkpoint.main(["-r", str(ckpt), "-s",
                                  str(tmp_path / "log"), "--device", "cpu"])
    with pytest.raises(ValueError) as je:
        jq.validate_quant_config("w8a16", False, 8)
    assert str(e.value) == str(je.value)


def test_quantize_checkpoint_defaults_to_the_card(tmp_path, monkeypatch):
    """Like the port's other entry points, the tool runs on cuda unless
    asked for the CPU, and says so instead of dropping to the host."""
    ckpt, _ = _run(tmp_path, "configs/bytelm_stdlib.json", TINY_BYTE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert quantize_checkpoint.build_parser().parse_args(
        ["-r", "x"]).device is None
    with pytest.raises(RuntimeError, match="--device cpu"):
        quantize_checkpoint.main(["-r", str(ckpt), "-s",
                                  str(tmp_path / "log")])
    assert not (ckpt.parent / "serving_w8a16").exists()


def test_unmerged_lora_checkpoint_is_refused_by_name(tmp_path):
    ckpt, _ = _run(tmp_path, "configs/bytelm_stdlib.json",
                   dict(TINY_BYTE, lora_rank=4))
    with pytest.raises(NotImplementedError, match="A4's remainder"):
        tcli.main(["-r", str(ckpt), "--prompt", "def", "--device", "cpu",
                   "-s", str(tmp_path / "gen")])
