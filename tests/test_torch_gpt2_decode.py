"""The GPT-2 family's decode path in the port (models/transformer.py
``new_cache`` / ``forward(cache=...)``, ``MoeLM``'s caches, the int8 KV
cache, engine/generate.py over them) against the JAX package's
``decode=True`` path on the CPU.

Params come from the JAX module's init and cross with
``models.convert.params_from_flax``; prompts from a seeded numpy
generator. float32: per-step logits within rtol 1e-5, atol 1e-5 (summation
orders differ; the JAX prefill's flash runs its plain reference here, the
port's the plain attention); greedy ids identical. Sampled ids cannot match
across packages (threefry against Philox): top-k 1 must give the greedy
ids, and a seeded request must repeat itself.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_distributed_template_tpu.models  # noqa: F401  (register)
import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu.config.registry import MODELS as JM
from pytorch_distributed_template_tpu.engine import generate as jgen
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TM,
)
from pytorch_distributed_template_tpu_torch.engine import generate as tgen
from pytorch_distributed_template_tpu_torch.models.convert import (
    params_from_flax,
)

TOL = dict(rtol=1e-5, atol=1e-5)
# (registry name, args): GPT-2 at a tiny size, TinyMoeLM as registered,
# and MoeLM at TinyMoeLM's size (the JAX TinyMoeLM takes no kv_quant)
FAMILIES = {
    "GPT2": dict(size="gpt2-small", vocab_size=128, max_len=64, n_layer=2,
                 n_head=4, d_model=64, dropout=0.0),
    "TinyMoeLM": dict(max_len=64),
    "MoeLM": dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, d_ff=128,
                  max_len=64, num_experts=4, moe_every=1,
                  capacity_factor=2.0, dropout=0.0),
}


def _pair(name, **extra):
    args = dict(FAMILIES[name], **extra)
    jm = JM.get(name)(**args)
    tok = jnp.zeros((1, 8), jnp.int32)
    params = jax.device_get(jm.init(jax.random.key(3), tok)["params"])
    tm = TM.get(name)(**args, device="cpu").eval()
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm


def _prompt(vocab, b=2, t=9, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def _jax_steps(jm, params, prompt, steps):
    """The JAX decode path: prefill then ``steps`` greedy single-token
    calls; every call's last logits ``[B, steps + 1, V]``."""
    cache = jgen.fresh_cache(jm, params, prompt.shape[0],
                             prompt.shape[1] + steps)
    logits, vs = jm.apply({"params": params, "cache": cache},
                          jnp.asarray(prompt), decode=True, prefill=True,
                          mutable=["cache"])
    out = [np.asarray(logits[:, -1])]
    cache = vs["cache"]
    for _ in range(steps):
        tok = jnp.asarray(out[-1].argmax(-1)[:, None], jnp.int32)
        logits, vs = jm.apply({"params": params, "cache": cache}, tok,
                              decode=True, mutable=["cache"])
        cache = vs["cache"]
        out.append(np.asarray(logits[:, -1]))
    return np.stack(out, 1)


def _port_steps(tm, prompt, steps):
    with torch.no_grad():
        cache = tm.new_cache(prompt.shape[0], prompt.shape[1] + steps)
        out = [tm(torch.from_numpy(prompt).long(), cache=cache,
                  prefill=True)[:, -1]]
        for _ in range(steps):
            tok = out[-1].argmax(-1, keepdim=True)
            out.append(tm(tok, cache=cache)[:, -1])
    return torch.stack(out, 1).numpy()


@pytest.mark.parametrize("name, kvq", [
    ("GPT2", ""), ("GPT2", "int8"), ("TinyMoeLM", ""), ("MoeLM", "int8")])
def test_cached_decode_logits_match_jax(name, kvq):
    extra = {"kv_quant": kvq} if kvq else {}
    jm, params, tm = _pair(name, **extra)
    prompt = _prompt(tm.vocab_size)
    np.testing.assert_allclose(_port_steps(tm, prompt, 6),
                               _jax_steps(jm, params, prompt, 6), **TOL)


@pytest.mark.parametrize("name", ["GPT2", "TinyMoeLM"])
def test_cache_layout_and_int8_rows(name):
    tm = TM.get(name)(**FAMILIES[name], device="cpu")
    cache = tm.new_cache(3, 20)
    layer = cache.layers[0]
    assert layer.k.shape == (3, 20, tm.n_head, tm.head_dim)
    assert layer.k.dtype == torch.float32 and layer.k_scale is None
    assert len(cache.layers) == tm.n_layer and cache.pos_index == 0
    q = TM.get("GPT2")(**FAMILIES["GPT2"], kv_quant="int8",
                       device="cpu").new_cache(1, 5)
    assert q.layers[1].v.dtype == torch.int8
    assert q.layers[1].v_scale.shape == (1, 5, 4)
    assert q.layers[1].v_scale.dtype == torch.float32


@pytest.mark.parametrize("name", ["GPT2", "TinyMoeLM"])
def test_greedy_and_seeded_ids_match_jax_generate(name):
    jm, params, tm = _pair(name)
    prompt = _prompt(tm.vocab_size, seed=1)
    want = np.asarray(jgen.generate(jm, params, jnp.asarray(prompt), 12,
                                    temperature=0.0))
    got = tgen.generate(tm, torch.from_numpy(prompt), 12, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), want)
    # top-k 1 samples the argmax: every generator gives the greedy ids
    gens = [torch.Generator().manual_seed(s) for s in (5, 6)]
    topk1 = tgen.generate(tm, torch.from_numpy(prompt), 12,
                          temperature=0.7, top_k=1, generators=gens)
    np.testing.assert_array_equal(topk1.numpy(), want)
    # a seeded sampled request repeats itself
    runs = [tgen.generate(tm, torch.from_numpy(prompt), 12, temperature=1.0,
                          generators=[torch.Generator().manual_seed(s)
                                      for s in (7, 8)]) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


def test_greedy_ids_with_stops_match_jax():
    jm, params, tm = _pair("GPT2")
    prompt = _prompt(128, seed=2)
    plain = np.asarray(jgen.generate(jm, params, jnp.asarray(prompt), 10,
                                     temperature=0.0))
    stops = [[int(plain[0, 12])], [int(plain[1, 15])]]
    jout, jlen = jgen.generate(jm, params, jnp.asarray(prompt), 10,
                               temperature=0.0, stop_tokens=stops,
                               return_lengths=True)
    tout, tlen = tgen.generate(tm, torch.from_numpy(prompt), 10,
                               temperature=0.0, stop_tokens=stops,
                               return_lengths=True)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))


def test_max_len_guard_matches_jax():
    jm, params, tm = _pair("GPT2")
    prompt = _prompt(128, t=60)
    with pytest.raises(ValueError, match="exceeds model.max_len") as je:
        jgen.generate(jm, params, jnp.asarray(prompt), 8, temperature=0.0)
    with pytest.raises(ValueError, match="exceeds model.max_len") as te:
        tgen.generate(tm, torch.from_numpy(prompt), 8, temperature=0.0)
    assert str(je.value) == str(te.value)
    cache = tm.new_cache(2, 10)
    with torch.no_grad():
        tm(torch.zeros((2, 10), dtype=torch.long), cache=cache,
           prefill=True)
        with pytest.raises(ValueError, match="past the cache"):
            tm(torch.zeros((2, 1), dtype=torch.long), cache=cache)
        with pytest.raises(ValueError, match="fresh cache"):
            tm(torch.zeros((2, 1), dtype=torch.long), cache=cache,
               prefill=True)


@pytest.mark.parametrize("name, extra", [
    ("GPT2", {}), ("GPT2", {"kv_quant": "int8"}), ("TinyMoeLM", {}),
    ("MoeLM", {"kv_quant": "int8"})])
def test_kv_cache_spec_matches_jax(name, extra):
    args = dict(FAMILIES[name], **extra)
    assert TM.get(name)(**args, device="meta").kv_cache_spec() == \
        JM.get(name)(**args).kv_cache_spec()


def test_moe_decode_routes_over_the_calls_tokens():
    """A decode step's capacity is the call's own: C = ceil(k B cf / E),
    1 at batch 1 (k 2, cf 2.0, E 4 gives 1) and 3 at batch 5; the step's
    logits equal JAX's at both batch sizes."""
    from pytorch_distributed_template_tpu_torch.models.moe import capacity

    assert capacity(1, 4, 2, 2.0) == 1 and capacity(5, 4, 2, 2.0) == 5
    assert capacity(1, 8, 2, 1.25) == 1 and capacity(8, 8, 2, 1.25) == 3
    jm, params, tm = _pair("TinyMoeLM")
    for b in (1, 5):
        prompt = _prompt(tm.vocab_size, b=b, t=6, seed=b)
        np.testing.assert_allclose(_port_steps(tm, prompt, 3),
                                   _jax_steps(jm, params, prompt, 3), **TOL)
