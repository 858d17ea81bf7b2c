"""The port's copy of the BPE tokenizer (data/tokenizer.py) against the JAX
package's: the same merges from the same text, the same ids and text, and
tokenizer files that load in either package; plus the service's text path
for a subword model (``encode_prompt`` / ``decode_text`` / ``encode_stop``).
"""
import numpy as np
import pytest

from pytorch_distributed_template_tpu.data import tokenizer as jtok
from pytorch_distributed_template_tpu_torch.data import tokenizer as ttok

TEXT = ("the quick brown fox jumps over the lazy dog. " * 20
        + "pack my box with five dozen liquor jugs! " * 15
        + "héllo wörld, ünïcode bytes 123 456 789\n" * 5)


@pytest.fixture(scope="module")
def pair():
    return (jtok.BpeTokenizer.train(TEXT, 300),
            ttok.BpeTokenizer.train(TEXT, 300))


def test_training_gives_the_same_merges(pair):
    j, t = pair
    assert t.merges == j.merges and t.vocab_size == j.vocab_size == 300


@pytest.mark.parametrize("text", [
    "the lazy fox", "five dozen jugs!", "héllo wörld", "", "zzz qqq 000",
])
def test_encode_decode_match(pair, text):
    j, t = pair
    ids = t.encode(text)
    np.testing.assert_array_equal(ids, j.encode(text))
    assert t.decode(ids) == j.decode(ids) == text


def test_files_load_across_packages(pair, tmp_path):
    j, t = pair
    j.save(tmp_path / "j.json")
    t.save(tmp_path / "t.json")
    assert ttok.BpeTokenizer.load(tmp_path / "j.json").merges == j.merges
    assert jtok.BpeTokenizer.load(tmp_path / "t.json").merges == t.merges


def test_pinned_tokenizer_found_from_artifact(pair, tmp_path):
    _, t = pair
    model_dir = tmp_path / "art" / "model"
    model_dir.mkdir(parents=True)
    t.save(tmp_path / "art" / "tokenizer.json")

    class Cfg(dict):
        resume = model_dir

    found = ttok.tokenizer_from_config(Cfg())
    assert found is not None and found.merges == t.merges
    assert ttok.tokenizer_from_config(type("C", (dict,), {})()) is None
    assert ttok.bpe_cache_path("d", "f.txt", 512) == \
        jtok.bpe_cache_path("d", "f.txt", 512)


def test_service_text_path_with_subword_vocab(pair):
    from pytorch_distributed_template_tpu_torch.config.registry import MODELS
    from pytorch_distributed_template_tpu_torch.engine.serving import (
        GenerationService,
    )

    _, tok = pair
    model = MODELS.get("TinyLlama")(vocab_size=300, device="cpu")
    svc = GenerationService.from_model(model, tokenizer=tok, device="cpu")
    ids = svc.encode_prompt(prompt="the lazy dog")
    assert ids == [int(i) for i in tok.encode("the lazy dog")]
    assert svc.decode_text(ids) == "the lazy dog"
    assert svc.encode_stop(["q", 7]) == [ord("q"), 7]   # a byte token
    with pytest.raises(ValueError, match="single-token"):
        svc.encode_stop(["the quick brown fox"])
    resp = svc.generate(prompt="the lazy dog", max_new_tokens=4)
    assert len(resp["ids"]) == 4 and isinstance(resp["text"], str)
    bare = GenerationService.from_model(model, device="cpu")
    with pytest.raises(ValueError, match="tokenizer"):
        bare.encode_prompt(prompt="text without a tokenizer")
