"""Speculative decoding in the port (engine/generate.py
``generate_speculative`` / ``speculative_from_cache``, the service's
acceptance probe ``_adaptive_speculative``, ``speculative > 0`` through
the continuous engine) on the CPU: the contracts of the JAX package's
``tests/test_generate.py`` and ``tests/test_serving_adaptive.py``, and the
JAX ``generate_speculative`` itself on the same weights.

Greedy speculation must emit the plain greedy ids bit for bit (for both
families, with the n-gram and the early-exit drafter, padded to a bucket,
from a warm prefix-pool cache, with stops); sampled speculation at top-k 1
must emit the greedy ids; the distribution check uses JAX's sample count
(300 seeds) and bound (total variation < 0.22). Against JAX: the same
greedy ids and the same number of verify calls (the drafts follow JAX's
token buffer).
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
from pytorch_distributed_template_tpu_torch.engine.generate import (
    generate, generate_speculative, speculative_from_cache,
)
from pytorch_distributed_template_tpu_torch.engine.kvcache import (
    PrefixCache,
)
from pytorch_distributed_template_tpu_torch.engine.serving import (
    GenerationService,
)
from pytorch_distributed_template_tpu_torch.models.convert import (
    params_from_flax,
)

VOCAB = 64
FAMILIES = {
    "Llama": dict(vocab_size=VOCAB, n_layer=2, n_head=4, n_kv_head=2,
                  d_model=32, max_len=128),
    "TinyLM": dict(vocab_size=VOCAB, n_layer=2, n_head=4, d_model=32,
                   max_len=128),
}


def _model(family, seed=0, **kw):
    m = TM.get(family)(**dict(FAMILIES.get(family, {}), **kw),
                       device="cpu").eval()
    m.init_weights(torch.Generator().manual_seed(seed))
    return m


def _prompt():
    base = np.random.default_rng(5).integers(0, VOCAB, 6).tolist()
    return torch.tensor([base * 3])                  # length 18


@pytest.mark.parametrize("family", ["Llama", "TinyLM"])
def test_speculative_matches_greedy_exactly(family):
    model, prompt = _model(family), _prompt()
    ref = generate(model, prompt, 40, temperature=0.0)
    out, stats = generate_speculative(model, prompt, 40, draft_len=4,
                                      return_stats=True)
    assert torch.equal(ref, out)
    assert stats["model_calls"] <= 40 and stats["tokens_per_call"] > 1.0


@pytest.mark.parametrize("family", ["Llama", "TinyLM"])
def test_greedy_ids_and_calls_match_jax(family):
    jm = JM.get(family)(**FAMILIES[family])
    prompt = _prompt()
    params = jax.device_get(jm.init(jax.random.key(0),
                                    jnp.asarray(prompt.numpy()))["params"])
    tm = TM.get(family)(**FAMILIES[family], device="cpu").eval()
    tm.load_state_dict(params_from_flax(params))
    jout, jstats = jgen.generate_speculative(
        jm, params, jnp.asarray(prompt.numpy(), jnp.int32), 40, draft_len=4,
        return_stats=True)
    tout, tstats = generate_speculative(tm, prompt, 40, draft_len=4,
                                        return_stats=True)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert tstats == jstats


def test_speculative_sampled_topk1_equals_greedy():
    model, prompt = _model("Llama"), _prompt()
    ref = generate(model, prompt, 40, temperature=0.0)
    out, stats = generate_speculative(
        model, prompt, 40, draft_len=4, return_stats=True, temperature=0.7,
        top_k=1, generator=torch.Generator().manual_seed(3))
    assert torch.equal(ref, out) and stats["tokens_per_call"] > 1.0


def test_speculative_sampled_distribution_exact():
    """Rejection sampling's exactness over 300 seeds (JAX's count): the
    second generated token's marginal equals plain sampling's within JAX's
    total-variation bound 0.22."""
    model = _model("TinyLM", vocab_size=16, n_layer=1, n_head=2,
                   d_model=16, max_len=32)
    base = np.random.default_rng(1).integers(0, 16, 4).tolist()
    prompt = torch.tensor([base * 3])
    n, t = 300, 0.9
    spec, plain = np.zeros(16), np.zeros(16)
    for s in range(n):
        o = generate_speculative(model, prompt, 2, draft_len=2,
                                 temperature=t,
                                 generator=torch.Generator().manual_seed(s))
        spec[int(o[0, -1])] += 1
        o = generate(model, prompt, 2, temperature=t,
                     generators=[torch.Generator().manual_seed(10_000 + s)])
        plain[int(o[0, -1])] += 1
    tv = 0.5 * np.abs(spec / n - plain / n).sum()
    assert tv < 0.22, (tv, spec, plain)


def test_speculative_pad_to_bucket_matches_unpadded():
    model, prompt = _model("Llama"), _prompt()
    ref = generate_speculative(model, prompt, 24, draft_len=4)
    out, stats = generate_speculative(model, prompt, 24, draft_len=4,
                                      pad_to=32, return_stats=True)
    assert torch.equal(ref, out) and stats["tokens_per_call"] > 1.0
    with pytest.raises(ValueError, match="pad_to"):
        generate_speculative(_model("TinyLM"), prompt, 8, pad_to=32)


def test_speculative_stop_tokens_truncate_like_vanilla():
    model, prompt = _model("Llama"), _prompt()
    ref = generate(model, prompt, 40, temperature=0.0)[0, 18:].numpy()
    sid = int(ref[10])
    first = int(np.argmax(ref == sid))
    out, stats = generate_speculative(model, prompt, 40, draft_len=4,
                                      return_stats=True, stop_tokens=[sid])
    out = out[0, 18:].numpy()
    assert stats["stopped"] and stats["tokens_emitted"] == first + 1
    np.testing.assert_array_equal(out[:first + 1], ref[:first + 1])
    np.testing.assert_array_equal(out[first + 1:], 0)
    assert stats["model_calls"] <= first + 1
    unused = next(i for i in range(VOCAB) if i not in set(ref.tolist()))
    assert torch.equal(
        generate_speculative(model, prompt, 40, draft_len=4),
        generate_speculative(model, prompt, 40, draft_len=4,
                             stop_tokens=[unused]))


def test_speculative_guards():
    model = _model("TinyLM", max_len=64)
    with pytest.raises(ValueError, match="batch size 1"):
        generate_speculative(model, torch.zeros((2, 8), dtype=torch.long), 8)
    with pytest.raises(ValueError, match="ngram"):
        generate_speculative(model, torch.zeros((1, 1), dtype=torch.long), 8)
    rolling = _model("Llama", n_layer=1, window=16)
    with pytest.raises(ValueError, match="non-rolling"):
        generate_speculative(rolling, torch.zeros((1, 8), dtype=torch.long),
                             16)
    with pytest.raises(ValueError, match="draft slack"):
        generate_speculative(model, torch.zeros((1, 8), dtype=torch.long),
                             60)


def test_speculative_draft_layers_matches_greedy_exactly():
    model = _model("Llama", n_layer=4, max_len=256)
    prompt = _prompt()
    ref = generate(model, prompt, 40, temperature=0.0)
    for dl in (1, 2, 3):
        out = generate_speculative(model, prompt, 40, draft_len=4,
                                   draft_layers=dl)
        assert torch.equal(ref, out), dl
    out = generate_speculative(model, prompt, 40, draft_len=4,
                               temperature=0.7, top_k=1, draft_layers=2,
                               generator=torch.Generator().manual_seed(3))
    assert torch.equal(ref, out)


def test_speculative_draft_layers_guards():
    model = _model("TinyLM", max_len=64)
    prompt = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="draft_layers"):
        generate_speculative(_model("Llama"), prompt, 8, draft_layers=2)
    with pytest.raises(ValueError, match="draft_layers"):
        generate_speculative(_model("Llama"), prompt, 8, draft_layers=-1)
    with pytest.raises(ValueError, match="exit_layer"):
        generate_speculative(model, prompt, 8, draft_layers=1)


@pytest.mark.parametrize("family", ["Llama", "TinyLM"])
def test_speculative_from_cache_matches_cold_spec(family):
    """The pool-shared entry: a cache warm-prefilled through the prefix
    pool (the paged pool's pages for Llama, the scatter arm's for the
    GPT-2 family) continues into the cold speculative ids."""
    model = _model(family, n_layer=4, max_len=256)
    ids = (np.random.default_rng(5).integers(1, VOCAB, 6).tolist()) * 3
    pc = PrefixCache(model, block_tokens=8, pool_blocks=64)
    new, d = 24, 4
    total = len(ids) + new + 2 * (d + 1)
    for dl in ((0, 2) if family == "Llama" else (0,)):
        ref = generate_speculative(model, torch.tensor([ids]), new,
                                   draft_len=d, draft_layers=dl)
        for _ in range(2):          # the first populates, the second hits
            last, cache, hit = pc.warm_prefill(ids, total)
            out, stats = speculative_from_cache(
                model, ids, cache, last, total, new, draft_len=d,
                draft_layers=dl)
        assert hit > 0
        assert torch.equal(ref[0, :len(ids) + new], out[0]), dl
        assert stats["tokens_emitted"] == new
    with pytest.raises(ValueError, match="overshoot slack"):
        speculative_from_cache(model, ids, cache, last, len(ids) + new, new)


def _service(**kw):
    return GenerationService.from_model(_model("Llama", max_len=192),
                                        device="cpu", **kw)


def _ref(svc, n=48):
    return generate(svc.model, _prompt(), n, temperature=0.0)[0, 18:] \
        .tolist()


def test_probe_keeps_speculating_on_accepting_workload():
    svc = _service()
    ids, stats = svc._adaptive_speculative(_prompt()[0].tolist(), 48, 4,
                                           0.0, 0, 0.0, 0, [])
    assert not stats["speculation_disabled"]
    assert stats["probe_tokens_per_call"] >= svc.SPEC_MIN_TOKENS_PER_CALL
    assert ids == _ref(svc) and stats["tokens_emitted"] == 48
    assert stats["model_calls"] < 48


def test_probe_disables_and_plain_fallback_is_exact():
    svc = _service()
    svc.SPEC_MIN_TOKENS_PER_CALL = 1e9
    ids, stats = svc._adaptive_speculative(_prompt()[0].tolist(), 48, 4,
                                           0.0, 0, 0.0, 0, [])
    assert stats["speculation_disabled"]
    assert ids == _ref(svc) and stats["tokens_emitted"] == 48
    assert stats["model_calls"] >= 48 - svc.SPEC_PROBE


def test_probe_stop_short_circuits_and_continuation_stops():
    svc = _service()
    ref = np.asarray(_ref(svc))
    sid = int(ref[5])
    first = int(np.argmax(ref == sid))
    ids, stats = svc._adaptive_speculative(_prompt()[0].tolist(), 48, 4,
                                           0.0, 0, 0.0, 0, [sid])
    assert stats["stopped"] and stats["tokens_emitted"] == first + 1
    assert ids == ref[:first + 1].tolist()
    fresh = [t for t in np.unique(ref[svc.SPEC_PROBE:])
             if t not in ref[:svc.SPEC_PROBE]]
    if fresh:
        sid = int(fresh[0])
        first = int(np.argmax(ref == sid))
        ids, stats = svc._adaptive_speculative(_prompt()[0].tolist(), 48,
                                               4, 0.0, 0, 0.0, 0, [sid])
        assert stats["stopped"] and ids == ref[:first + 1].tolist()


def test_service_request_reports_stats_and_uses_the_pool():
    svc = _service(prefix_cache={"enabled": True, "block_tokens": 8,
                                 "pool_blocks": 96})
    prompt = _prompt()[0].tolist()
    cold = svc.generate(prompt_ids=prompt, max_new_tokens=24)["ids"]
    resp = svc.generate(prompt_ids=prompt, max_new_tokens=24,
                        speculative=4)
    assert resp["ids"] == cold
    assert resp["speculative"]["prefix_hit_tokens"] > 0
    assert resp["speculative"]["tokens_emitted"] == 24


def test_continuous_engine_serves_speculative_requests_batch_1():
    from pytorch_distributed_template_tpu_torch.engine.continuous import (
        ContinuousBatchingService,
    )

    model = _model("Llama", max_len=192)
    svc = ContinuousBatchingService.from_model(
        model, device="cpu", slots=2,
        prefix_cache={"enabled": True, "block_tokens": 8,
                      "pool_blocks": 96})
    try:
        prompt = _prompt()[0].tolist()
        plain = svc.generate(prompt_ids=prompt, max_new_tokens=20)
        spec = svc.generate(prompt_ids=prompt, max_new_tokens=20,
                            speculative=3)
        assert spec["ids"] == plain["ids"]
        assert spec["speculative"]["tokens_emitted"] == 20
        # the engine still serves after the batch-1 request
        assert svc.generate(prompt_ids=prompt, max_new_tokens=20)["ids"] \
            == plain["ids"]
    finally:
        svc.close()
