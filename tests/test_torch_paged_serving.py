"""The port's batch-1 paged ``GenerationService`` (engine/serving.py over
engine/kvcache.py) against the JAX package's batch-1 paged service, on
the same weights (``params_from_flax``), float32, TinyLlama size.

Three requests share a 3-block prefix: the first misses, the others
reserve the cached blocks as table entries and prefill only their
suffix. Greedy ids must be identical to JAX's, and both pools must show
the same hit / adoption counters with zero warm-admit copy bytes — for
the flat layout, the ring layout (window 32: prompts longer than the ring
slack stream their prefill, one request wraps) and the int8-KV layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pytorch_distributed_template_tpu.models  # noqa: F401
from pytorch_distributed_template_tpu.config.registry import MODELS as JMODELS
from pytorch_distributed_template_tpu.engine.serving import (
    GenerationService as JService,
)
import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TMODELS,
)
from pytorch_distributed_template_tpu_torch.engine.serving import (
    GenerationService as TService,
)
from pytorch_distributed_template_tpu_torch.models.convert import (
    params_from_flax,
)

BT = 8
POOL = {"enabled": True, "block_tokens": BT, "pool_blocks": 48,
        "paged": True}
SAME = ("prefix_lookups", "prefix_hit_requests", "prefix_hit_tokens",
        "prefix_adopted_blocks", "warm_admit_copy_bytes",
        "prefix_pool_blocks_used", "batch1_paged_requests",
        "pool_fallback_total")


def _services(window=0, kv_quant="", pool=POOL):
    kw = dict(window=window, kv_quant=kv_quant)
    jmodel = JMODELS.get("TinyLlama")(**kw)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.key(3), jnp.zeros((1, 8), jnp.int32))["params"])
    tmodel = TMODELS.get("TinyLlama")(**kw, device="cpu")
    tmodel.load_state_dict(params_from_flax(params))
    return (JService.from_model(jmodel, params, prefix_cache=dict(pool)),
            TService.from_model(tmodel, device="cpu",
                                prefix_cache=dict(pool)))


def _prompts(suffix, n=3, seed=0):
    rng = np.random.default_rng(seed)
    prefix = [int(x) for x in rng.integers(1, 256, 3 * BT)]
    return [prefix + [int(x) for x in rng.integers(1, 256, suffix)]
            for _ in range(n)]


def _serve_both(jsvc, tsvc, prompts, new):
    for ids in prompts:
        j = jsvc.generate(prompt_ids=ids, max_new_tokens=new)
        t = tsvc.generate(prompt_ids=ids, max_new_tokens=new)
        assert t["ids"] == j["ids"] and len(t["ids"]) == new
    js, ts = jsvc.prefix_cache_stats(), tsvc.prefix_cache_stats()
    for key in SAME:
        assert ts[key] == js[key], key
    assert ts["prefix_hit_tokens"] > 0
    assert ts["prefix_adopted_blocks"] > 0
    assert ts["warm_admit_copy_bytes"] == 0
    return ts


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["f32", "int8"])
def test_batch1_paged_matches_jax(kv_quant):
    jsvc, tsvc = _services(kv_quant=kv_quant)
    ts = _serve_both(jsvc, tsvc, _prompts(6), new=6)
    assert ts["prefix_pool_kv_quant"] == (1 if kv_quant else 0)
    # an exact repeat hits every cached full block of the prompt
    ids = _prompts(6)[0]
    before = ts["prefix_hit_tokens"]
    again = tsvc.generate(prompt_ids=ids, max_new_tokens=6)
    assert again["ids"] == jsvc.generate(prompt_ids=ids,
                                         max_new_tokens=6)["ids"]
    assert tsvc.prefix_cache_stats()["prefix_hit_tokens"] - before == \
        (len(ids) - 1) // BT * BT


def test_batch1_paged_ring_matches_jax():
    """window 32, bt 8: the ring is 9 pages (4 in-band + 1 + 4 slack
    pages for the 32-token slack). 44-token prompts exceed the slack, so
    their suffix prefill streams in 32-token chunks; an 80-token prompt
    with 8 new tokens wraps the ring (shares and adopts nothing)."""
    jsvc, tsvc = _services(window=32)
    assert tsvc._prefix.nb_max == 9 and tsvc._prefix.ring_slack_tokens == 32
    _serve_both(jsvc, tsvc, _prompts(20), new=8)
    wrap = _prompts(56, n=1, seed=1)[0]
    j = jsvc.generate(prompt_ids=wrap, max_new_tokens=8)
    t = tsvc.generate(prompt_ids=wrap, max_new_tokens=8)
    assert t["ids"] == j["ids"]


def test_dry_or_unpaged_pool_serves_cold_and_counts():
    """A pool that is not paged (configured off) serves every request
    cold without counting a fallback (a choice, not a degradation); a
    pool too small for a request's chain counts ``dry_pool``."""
    cold = TService.from_model(_services()[1].model, device="cpu")
    ids = _prompts(6)[0]
    ref = cold.generate(prompt_ids=ids, max_new_tokens=4)["ids"]
    off = TService.from_model(cold.model, device="cpu",
                              prefix_cache=dict(POOL, paged=False))
    assert off.generate(prompt_ids=ids, max_new_tokens=4)["ids"] == ref
    assert off.prefix_cache_stats()["pool_fallback_total"] == 0
    tiny = TService.from_model(cold.model, device="cpu",
                               prefix_cache=dict(POOL, pool_blocks=18))
    busy = tiny._prefix.alloc_chain(15)          # leaves 2 free pages
    assert tiny.generate(prompt_ids=ids, max_new_tokens=4)["ids"] == ref
    st = tiny.prefix_cache_stats()
    assert st["pool_fallback_dry_pool"] == 1
    assert st["batch1_scatter_requests"] == 1
    tiny._prefix.free_blocks(busy)
