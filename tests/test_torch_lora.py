"""LoRA in the port (``models/lora.py``, ``models/quant.py::dense_factory``,
``tools/merge_lora.py``) against the JAX package on the CPU, float32:

- identity at init: ``lora_b`` starts at zero, so a LoRA model gives its
  dense base's logits (atol 1e-6: the bias is added after the product,
  as in JAX's ``LoRADense``);
- the frozen base gets zero gradients, not none: two AdamW steps without
  ``trainable`` move every base weight by weight decay alone, as optax's
  AdamW moves JAX's (atol 1e-7), and the adapters as JAX's (atol 1e-6);
  with ``trainable: ["lora_"]`` the base stays bitwise fixed and only the
  adapters carry optimizer state;
- the merge (``merge_lora_params``) equals JAX's on the same arrays (atol
  1e-6) and its dense model gives the adapted model's logits (atol 1e-5);
- GPT2, TinyLM (untied head), TinyLlama, Llama with a fused head, Mistral
  and MoeLM with ``lora_rank`` give flax's logits (atol 1e-5) from the
  converted params, adapters moved off zero; ``lora_rank`` with ``quant``
  is refused with the JAX package's message;
- the workflow end to end through the CLIs: a base run, a LoRA fine-tune
  with ``init_from`` and ``trainable``, ``tools/merge_lora.py``, then
  ``generate.py`` on the merged artifact gives the adapted model's greedy
  tokens.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_template_tpu.config import MODELS as JMODELS
import pytorch_distributed_template_tpu.models  # noqa: F401  (register)
from pytorch_distributed_template_tpu.engine import losses as jlosses
from pytorch_distributed_template_tpu.models.lora import (
    merge_lora_params as jmerge,
)

import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch import generate, train
from pytorch_distributed_template_tpu_torch.config.registry import MODELS
from pytorch_distributed_template_tpu_torch.engine import losses, optim, steps
from pytorch_distributed_template_tpu_torch.engine.serving import (
    GenerationService,
)
from pytorch_distributed_template_tpu_torch.models import convert, lora
from pytorch_distributed_template_tpu_torch.tools import merge_lora
from test_torch_accum_ema import _process_signal_handlers  # noqa: F401

FAMILIES = {
    "GPT2": dict(size="gpt2-small", n_layer=2, n_head=2, d_model=32,
                 vocab_size=96, max_len=32, dropout=0.0),
    "TinyLM": dict(tie_embeddings=False),
    "TinyLlama": {},
    "Llama": dict(vocab_size=96, n_layer=2, n_head=4, n_kv_head=2,
                  d_model=64, max_len=32, fused_head=True),
    "Mistral": dict(vocab_size=96, n_layer=2, n_head=4, n_kv_head=2,
                    d_model=64, d_ff=96, max_len=32, window=8,
                    bfloat16=False, attn_impl="xla", remat=False),
    "MoeLM": dict(vocab_size=96, n_layer=2, n_head=2, d_model=32,
                  max_len=32, num_experts=4, dropout=0.0),
}


def _tokens(vocab=96, b=2, t=16, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def _pair(name, rank=4, moved=True):
    """(flax module, its params with the adapters moved off zero, the
    port's model holding the same)."""
    args = dict(FAMILIES[name], lora_rank=rank)
    jm = JMODELS.get(name)(**args)
    v = jax.device_get(jm.init(jax.random.PRNGKey(1),
                               jnp.asarray(_tokens())))
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(x) + (
            0.05 * rng.normal(size=np.shape(x)).astype(np.float32)
            if moved and "lora_b" in jax.tree_util.keystr(p) else 0.0),
        v["params"])
    tm = MODELS.get(name)(**args, param_dtype=torch.float32)
    tm.load_state_dict(convert.params_from_flax(params))
    return jm, params, tm.eval()


def _logits(out):
    if isinstance(out, tuple):
        h, w = out
        out = h @ w
    return np.asarray(out, np.float32) if not torch.is_tensor(out) else \
        out.detach().float().numpy()


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_lora_forward_equals_flax(name):
    jm, params, tm = _pair(name)
    x = _tokens()
    assert any(n.endswith("lora_a") for n, _ in tm.named_parameters())
    want = jm.apply({"params": params}, jnp.asarray(x), train=False)
    np.testing.assert_allclose(_logits(tm(torch.from_numpy(x))),
                               _logits(want), atol=1e-5)
    back = convert.flax_from_params(tm.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)


@pytest.mark.parametrize("name", ["TinyLM", "TinyLlama"])
def test_identity_at_init(name):
    lora_model = MODELS.get(name)(lora_rank=4, param_dtype=torch.float32)
    lora_model.init_weights(torch.Generator().manual_seed(0))
    assert all(torch.equal(p, torch.zeros_like(p))
               for n, p in lora_model.named_parameters()
               if n.endswith("lora_b"))
    dense = MODELS.get(name)(param_dtype=torch.float32)
    dense.load_state_dict({k: v for k, v in lora_model.state_dict().items()
                           if k.rsplit(".", 1)[-1] not in lora.ADAPTER_LEAVES})
    x = torch.from_numpy(_tokens(256))
    np.testing.assert_allclose(_logits(lora_model.eval()(x)),
                               _logits(dense.eval()(x)), atol=1e-6)


def _batch(x):
    return {"tokens": torch.from_numpy(x),
            "mask": torch.ones(x.shape[0], dtype=torch.bool)}


def test_adamw_without_trainable_decays_the_base_as_optax(monkeypatch):
    jm, params, tm = _pair("TinyLM", moved=False)
    # a small lr: Adam's normalised step of a near-zero gradient follows
    # its rounding, and its size is the lr's
    lr, wd = 1e-3, 0.1
    xs = [_tokens(seed=s) for s in (5, 6)]
    tx = optax.adamw(lr, weight_decay=wd)
    p, state = params, tx.init(params)
    for x in xs:
        g = jax.grad(lambda q: jlosses.lm_cross_entropy(
            jm.apply({"params": q}, jnp.asarray(x), train=True),
            jnp.asarray(x)).mean())(p)
        upd, state = tx.update(g, state, p)
        p = optax.apply_updates(p, upd)
    want = convert.params_from_flax(jax.device_get(p))
    base0 = {k: v.clone() for k, v in tm.state_dict().items()}
    opt = optim.OPTIMIZERS.get("AdamW")(tm, lr=lr, weight_decay=wd)
    step = steps.make_train_step(tm, opt, losses.lm_cross_entropy,
                                 input_key="tokens", target_key="tokens")
    for x in xs:
        step(_batch(x))
        grads = {n: q.grad for n, q in tm.named_parameters()}
        assert all(g is not None for g in grads.values())
    for n, g in grads.items():
        if n.endswith(".weight") and ".h." in n and "ln_" not in n:
            assert torch.equal(g, torch.zeros_like(g)), n
    got = tm.state_dict()
    for k, w in want.items():
        # a LoRA layer's frozen base moves by the decay alone; the rest
        # take Adam's steps, whose rounding is the step's
        frozen = f"{k.rpartition('.')[0]}.lora_a" in got
        atol = 1e-7 if frozen and not k.endswith(lora.ADAPTER_LEAVES) \
            else 1e-6
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=atol,
                                   err_msg=k)
    frozen = "h.0.attn.qkv.weight"
    np.testing.assert_allclose(got[frozen].numpy(),
                               base0[frozen].numpy() * (1 - lr * wd) ** 2,
                               atol=1e-7)
    assert not torch.equal(got[frozen], base0[frozen])


def test_trainable_keeps_the_base_bitwise_fixed():
    _, _, tm = _pair("TinyLlama", moved=False)
    base0 = {k: v.clone() for k, v in tm.state_dict().items()}
    assert optim.freeze_untrainable(tm, ["lora_"]) == sum(
        1 for n, _ in tm.named_parameters()
        if n.rsplit(".", 1)[-1] not in lora.ADAPTER_LEAVES)
    opt = optim.OPTIMIZERS.get("AdamW")(optim.Trainable(tm, ["lora_"]),
                                        lr=1e-2, weight_decay=0.1)
    step = steps.make_train_step(tm, opt, losses.lm_cross_entropy,
                                 input_key="tokens", target_key="tokens",
                                 grad_clip_norm=1.0)
    for s in (5, 6):
        step(_batch(_tokens(256, seed=s)))
    got = tm.state_dict()
    adapters = 0
    for k, v in base0.items():
        if k.rsplit(".", 1)[-1] in lora.ADAPTER_LEAVES:
            adapters += v.numel()
            if k.endswith("lora_b"):
                assert not torch.equal(got[k], v), k
        else:
            assert torch.equal(got[k], v), k
            assert dict(tm.named_parameters())[k].grad is None
    assert optim.state_bytes(opt) == optim.expected_state_bytes(opt) == \
        adapters * 8


def test_merge_equals_jax_and_the_adapted_model():
    jm, params, tm = _pair("TinyLlama")
    want = convert.params_from_flax(jax.device_get(jmerge(params,
                                                          alpha=16.0)))
    merged = lora.merge_lora_params(tm.state_dict(), alpha=16.0)
    assert set(merged) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(merged[k].numpy(), w.numpy(), atol=1e-6,
                                   err_msg=k)
    dense = MODELS.get("TinyLlama")(param_dtype=torch.float32)
    dense.load_state_dict(merged)
    x = torch.from_numpy(_tokens(256))
    np.testing.assert_allclose(_logits(dense.eval()(x)), _logits(tm(x)),
                               atol=1e-5)


@pytest.mark.parametrize("name", ["TinyLM", "TinyLlama", "GPT2", "MoeLM"])
def test_lora_with_quant_is_refused(name):
    with pytest.raises(ValueError, match="FINE-TUNING mode"):
        MODELS.get(name)(**dict(FAMILIES[name], lora_rank=4,
                                quant="w8a16"))


def test_workflow_end_to_end(tmp_path):
    cfg = "configs/llama_debug.json"
    box = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train.main(["-c", cfg, "--device", "cpu", "-s", str(tmp_path / "b"),
                    "--set", "trainer;epochs", "1"],
                   on_trainer=lambda t: box.update(base=t))
        base = box["base"].config.save_dir / "model_best"
        argv = ["-c", cfg, "--device", "cpu", "-s", str(tmp_path / "ft")]
        for chain, value in (("arch;args;lora_rank", 4),
                             ("optimizer;args;trainable", ["lora_"]),
                             ("trainer;init_from", str(base)),
                             ("trainer;epochs", 1)):
            argv += ["--set", chain, json.dumps(value)]
        train.main(argv, on_trainer=lambda t: box.update(ft=t))
    finally:
        torch.set_num_threads(threads)
    ft = box["ft"]
    disk = torch.load(base / "model.pt")
    live = ft.model.state_dict()
    assert all(torch.equal(live[k], v) for k, v in disk.items())
    run = ft.config.save_dir
    path = merge_lora.main(["-r", str(run / "model_best"), "-s",
                            str(tmp_path / "m")])
    cfg_out = json.loads((path.parent / "config.json").read_text())
    assert "lora_rank" not in cfg_out["arch"]["args"]
    assert "trainable" not in cfg_out["optimizer"]["args"]
    assert "init_from" not in cfg_out["trainer"]
    prompt = [1, 2, 3, 4, 5]
    want = GenerationService.from_model(ft.model, device="cpu").generate(
        prompt_ids=prompt, max_new_tokens=12)["ids"]
    got = generate.main(["-r", str(path), "--prompt-ids",
                         ",".join(map(str, prompt)), "--max-new-tokens",
                         "12", "--device", "cpu", "-s",
                         str(tmp_path / "g")])["ids"]
    assert got == want
