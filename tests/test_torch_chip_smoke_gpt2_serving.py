"""chip_smoke.py's phase 21 (serving the repository's own LMs: the GPT-2
family's decode caches, int8 KV, w8a16, speculative decoding, the static
micro-batcher) driven on the CPU at a tiny size. On the card B1, B4 and B5
run and count their launches; here their plain versions run under
counting stand-ins, so the phases' exact counts hold here too.

- 21a on the CPU (both sides the CPU): the checks and the batcher run;
- 21b over a tiny GPT-2 checkpoint in the training layout: generate.py
  cold, speculative and int8, the timings, then serve.py with
  ``--scheduler auto`` (the static batcher) and the scatter arm;
- 21c / 21d: the quantize-then-generate workflow on a tiny byte LM, and a
  tiny MoE LM through generate.py (B5 n_moe times per model call);
- 21e: a tiny Llama artifact quantized, its logits against the
  dequantized model, then served over the paged pool (B4).
"""
import json

import pytest
import torch

import chip_smoke
from test_torch_chip_smoke_serving import (  # noqa: F401
    SERVE, TINY_RING, _one_intra_op_thread, counted_paged, counted_plain,
    tiny_serving,
)
from test_torch_chip_smoke_moe import counted_ffn  # noqa: F401
from pytorch_distributed_template_tpu_torch.config.registry import MODELS
import pytorch_distributed_template_tpu_torch.models  # noqa: F401


def _checkpoint(tmp_path, config, arch_args, ckpt="checkpoint"):
    """A run directory in the trainer's layout: ``config.json`` (the
    repository's config with ``arch_args`` over its arch) beside
    ``<ckpt>/model.pt`` of a random-init model."""
    cfg = json.loads(config.read_text())
    cfg["arch"]["args"].update(arch_args)
    run = tmp_path / "run"
    (run / ckpt).mkdir(parents=True)
    (run / "config.json").write_text(json.dumps(cfg))
    model = MODELS.get(cfg["arch"]["type"])(**cfg["arch"]["args"],
                                            device="cpu")
    model.init_weights(torch.Generator().manual_seed(3))
    torch.save(model.state_dict(), run / ckpt / "model.pt")
    return run


TINY_GPT2 = {"n_layer": 2, "n_head": 2, "d_model": 64, "vocab_size": 512,
             "max_len": 256}
TINY_BYTE = {"n_layer": 2, "n_head": 2, "d_model": 64, "max_len": 128}
TINY_MOE = {"n_layer": 2, "n_head": 2, "d_model": 64, "d_ff": 128,
            "max_len": 64}
STATIC = {"prompt": 40, "others": [36, 44], "new": 8, "batch": 8,
          "window_ms": 400.0}


def test_reference_phase_on_cpu(counted_plain, counted_ffn):
    out = chip_smoke.phase_gpt2_serve_reference(device="cpu")
    assert set(out) == {"GPT2", "TinyMoeLM"}
    assert out["GPT2"]["static_stats"]["max_batch_size"] == 4


def test_gpt2_generate_and_static_serve_on_cpu(counted_plain, tmp_path):
    base = _checkpoint(tmp_path, chip_smoke.TRAIN_CONFIG, TINY_GPT2,
                       "checkpoint-epoch1")
    out = chip_smoke.phase_gpt2_generate("cpu", base=base, device="cpu",
                                         work=tmp_path / "work")
    # cold and int8: one cold prefill each (n_layer launches); the
    # speculative run's prefill and its phase split add more
    assert out["launches"]["flash_fwd"] >= 2 * TINY_GPT2["n_layer"]
    assert out["timing"]["speculative"]["tokens_per_verify_call"] >= 1.0
    launches = chip_smoke.phase_gpt2_static_serve(
        "cpu", base=base, device="cpu", work=tmp_path / "work",
        sizes=STATIC)
    assert launches["flash_fwd"] > 0 and launches["expert_ffn"] == 0


def test_static_serve_fails_without_the_scatter_arm(counted_plain, tmp_path,
                                                    monkeypatch):
    from pytorch_distributed_template_tpu_torch.engine import kvcache

    base = _checkpoint(tmp_path, chip_smoke.TRAIN_CONFIG, TINY_GPT2,
                       "checkpoint-epoch1")
    monkeypatch.setattr(kvcache.PrefixCache, "lookup",
                        lambda self, ids, record=True: ([], [], 0))
    with pytest.raises(AssertionError, match="did not hit the scatter"):
        chip_smoke.phase_gpt2_static_serve(
            "cpu", base=base, device="cpu", work=tmp_path / "work",
            sizes=STATIC)


def test_bytelm_quantize_and_generate_on_cpu(counted_plain, tmp_path):
    keep = _checkpoint(tmp_path, chip_smoke.BYTELM_CONFIG, TINY_BYTE)
    counts = chip_smoke.phase_bytelm_quant("cpu", keep=keep, device="cpu",
                                           work=tmp_path / "work")
    assert counts["flash_fwd"] % TINY_BYTE["n_layer"] == 0
    assert counts["flash_fwd"] > 0


def test_moelm_generate_on_cpu(counted_plain, counted_ffn, tmp_path):
    keep = _checkpoint(tmp_path, chip_smoke.MOE_CONFIG, TINY_MOE)
    counts = chip_smoke.phase_moelm_generate("cpu", keep=keep, device="cpu",
                                             work=tmp_path / "work", new=6)
    # moe_every 1: every block is MoE; 6 model calls
    assert counts["expert_ffn"] == TINY_MOE["n_layer"] * 6
    assert counts["flash_fwd"] == TINY_MOE["n_layer"]


def test_moelm_generate_fails_when_the_experts_are_skipped(counted_plain,
                                                           tmp_path):
    keep = _checkpoint(tmp_path, chip_smoke.MOE_CONFIG, TINY_MOE)
    with pytest.raises(AssertionError, match="B5 launched 0 times"):
        chip_smoke.phase_moelm_generate("cpu", keep=keep, device="cpu",
                                        work=tmp_path / "work", new=6)


def test_mistral_w8a16_phase_on_cpu(counted_paged, counted_plain,
                                    tiny_serving, tmp_path):
    model_path, config = tiny_serving
    launches = chip_smoke.phase_mistral_w8a16(
        "cpu", model_path, config=config, device="cpu",
        work=tmp_path / "work", sizes=SERVE, arch="Llama",
        arch_args=TINY_RING)
    assert launches > 0 and launches % TINY_RING["n_layer"] == 0


def test_mistral_w8a16_phase_fails_when_the_scale_is_dropped(
        counted_paged, counted_plain, tiny_serving, tmp_path, monkeypatch):
    from pytorch_distributed_template_tpu_torch.models.quant import (
        W8A16Dense,
    )

    def no_scale(self, x):
        y = x.to(self.compute_dtype) @ self.kernel_q.to(self.compute_dtype)
        return y if self.bias is None else y + self.bias.to(y.dtype)

    monkeypatch.setattr(W8A16Dense, "forward", no_scale)
    model_path, config = tiny_serving
    with pytest.raises(AssertionError, match="21e: the w8a16 prefill"):
        chip_smoke.phase_mistral_w8a16(
            "cpu", model_path, config=config, device="cpu",
            work=tmp_path / "work", sizes=SERVE, arch="Llama",
            arch_args=TINY_RING)


def test_phase_21_shapes():
    # B1 at GPT-2 small's heads, B5 at the decode capacities C 1, 3, 8
    assert {(s[0], s[3]) for s in chip_smoke.GPT2_SERVE_KERNEL_SHAPES} == {
        (1, 37), (1, 512), (8, 37), (8, 512)}
    assert all(s[1:3] == (12, 12) and s[4] == 64
               for s in chip_smoke.GPT2_SERVE_KERNEL_SHAPES)
    assert sorted({s[2] for s in chip_smoke.FFN_DECODE_SHAPES}) == [1, 3, 8]
    assert {s[6] for s in chip_smoke.FFN_DECODE_SHAPES} == {
        torch.bfloat16, torch.float32}
