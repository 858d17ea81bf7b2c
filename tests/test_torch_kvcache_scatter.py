"""The prefix pool's scatter arm in the port (engine/kvcache.py
``PrefixCache.warm_prefill`` / ``capture``, a pool that is not paged)
against the JAX package on the CPU: the contracts of the JAX package's
``tests/test_kvcache.py`` (the GPT-2 family's batch-1 path; the paged,
scatter and cold arms agreeing) and the pool's counters, which must equal
JAX's on the same request sequence.

Greedy and seeded sampled ids: warm = cold within the port (one
generator per request); greedy ids = JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_distributed_template_tpu.models  # noqa: F401  (register)
import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu.config.registry import MODELS as JM
from pytorch_distributed_template_tpu.engine import kvcache as jkv
from pytorch_distributed_template_tpu.engine.serving import (
    GenerationService as JService,
)
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TM,
)
from pytorch_distributed_template_tpu_torch.engine import kvcache as tkv
from pytorch_distributed_template_tpu_torch.engine.serving import (
    GenerationService as TService,
)
from pytorch_distributed_template_tpu_torch.models.convert import (
    params_from_flax,
)

VOCAB = 64
BLOCK = 8
FAMILIES = {
    "TinyLM": dict(vocab_size=VOCAB, n_layer=2, n_head=2, d_model=32,
                   max_len=128),
    "Llama": dict(vocab_size=VOCAB, n_layer=2, n_head=4, n_kv_head=2,
                  d_model=32, max_len=128),
}
# the port's counter names (the JAX pool has more: spill tiers, shipping)
COUNTERS = ("prefix_lookups", "prefix_hit_requests", "prefix_hit_tokens",
            "prefix_inserted_blocks", "prefix_evictions",
            "prefix_dropped_inserts", "warm_admit_copy_bytes",
            "prefix_adopted_blocks", "batch1_paged_requests",
            "batch1_scatter_requests", "pool_fallback_gpt2_layout",
            "pool_fallback_dry_pool", "prefix_pool_blocks_used",
            "prefix_pool_blocks_resident", "prefix_page_bytes",
            "prefix_paged")


def _ids(n, seed=0, lo=1):
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.integers(lo, VOCAB, n)]


def _stack(name, seed=1):
    jm = JM.get(name)(**FAMILIES[name])
    params = jax.device_get(jm.init(jax.random.key(seed),
                                    jnp.zeros((1, 8), jnp.int32))["params"])
    tm = TM.get(name)(**FAMILIES[name], device="cpu").eval()
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm


def _pool(paged=True, blocks=16):
    return {"enabled": True, "block_tokens": BLOCK, "pool_blocks": blocks,
            "paged": paged}


def test_gpt2_family_batch1_path():
    """The non-rotary layout: the GPT-2 family's blocks are reused
    verbatim through the scatter arm, greedy and sampled ids equal the
    cold path's, greedy ids equal JAX's warm service's."""
    jm, params, tm = _stack("TinyLM")
    solo = TService.from_model(tm, device="cpu")
    warm = TService.from_model(tm, device="cpu", prefix_cache=_pool())
    jwarm = JService.from_model(jm, params, prefix_cache=_pool())
    prefix = _ids(2 * BLOCK, seed=7)
    for i in range(2):
        ids = prefix + _ids(4, seed=30 + i)
        for kw in ({"temperature": 0.0}, {"temperature": 0.9, "top_k": 8}):
            a = solo.generate(prompt_ids=ids, max_new_tokens=8, seed=i,
                              **kw)
            b = warm.generate(prompt_ids=ids, max_new_tokens=8, seed=i,
                              **kw)
            assert a["ids"] == b["ids"], (i, kw)
        j = jwarm.generate(prompt_ids=ids, max_new_tokens=8, seed=i)
        assert j["ids"] == warm.generate(prompt_ids=ids,
                                         max_new_tokens=8)["ids"]
    st = warm.prefix_cache_stats()
    assert st["prefix_hit_tokens"] > 0 and st["prefix_paged"] is False
    assert st["warm_admit_copy_bytes"] > 0
    assert st["pool_fallback_gpt2_layout"] == st["batch1_scatter_requests"]


def test_batch1_paged_vs_scatter_vs_cold():
    """Greedy and sampled ids identical across the paged arm, the scatter
    arm (``paged: false``) and the cold path; the paged arm copies 0
    bytes at its warm admits and adopts pages, the scatter arm copies."""
    _, _, tm = _stack("Llama", seed=0)
    solo = TService.from_model(tm, device="cpu")
    paged = TService.from_model(tm, device="cpu",
                                prefix_cache=_pool(True, 32))
    scatter = TService.from_model(tm, device="cpu",
                                  prefix_cache=_pool(False, 32))
    assert paged.prefix_cache_stats()["prefix_paged"] is True
    assert scatter.prefix_cache_stats()["prefix_paged"] is False
    prefix = _ids(3 * BLOCK, seed=40)
    for i in range(3):
        ids = prefix + _ids(5, seed=50 + i)
        for kw in ({"temperature": 0.0}, {"temperature": 0.9, "top_k": 8}):
            a = solo.generate(prompt_ids=ids, max_new_tokens=10, seed=i,
                              **kw)
            b = paged.generate(prompt_ids=ids, max_new_tokens=10, seed=i,
                               **kw)
            c = scatter.generate(prompt_ids=ids, max_new_tokens=10, seed=i,
                                 **kw)
            assert a["ids"] == b["ids"] == c["ids"], (i, kw)
    ps, ss = paged.prefix_cache_stats(), scatter.prefix_cache_stats()
    assert ps["prefix_hit_tokens"] > 0 and ss["prefix_hit_tokens"] > 0
    assert ps["warm_admit_copy_bytes"] == 0
    assert ss["warm_admit_copy_bytes"] > 0
    assert ps["prefix_adopted_blocks"] > 0


@pytest.mark.parametrize("name, paged, blocks", [
    ("TinyLM", True, 16), ("TinyLM", True, 5), ("Llama", False, 16)])
def test_pool_counters_match_jax(name, paged, blocks):
    """The same request sequence (shared prefixes, a repeat, a miss, and
    with 5 pages LRU evictions) through both packages' batch-1 services:
    the pool's counters equal."""
    jm, params, tm = _stack(name)
    jsvc = JService.from_model(jm, params,
                               prefix_cache=_pool(paged, blocks))
    tsvc = TService.from_model(tm, device="cpu",
                               prefix_cache=_pool(paged, blocks))
    prefix = _ids(2 * BLOCK + 3, seed=9)
    seq = [prefix + _ids(6, seed=s) for s in (1, 2)] + [
        prefix + _ids(6, seed=1), _ids(20, seed=3), _ids(3 * BLOCK, seed=4),
        prefix + _ids(9, seed=5)]
    for ids in seq:
        j = jsvc.generate(prompt_ids=ids, max_new_tokens=6)
        t = tsvc.generate(prompt_ids=ids, max_new_tokens=6)
        assert j["ids"] == t["ids"]
    js, ts = jsvc.prefix_cache_stats(), tsvc.prefix_cache_stats()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    if blocks == 5:
        assert ts["prefix_evictions"] > 0


def test_warm_prefill_copies_and_captures_rows_verbatim():
    """The scatter arm at batch 1 needs no rotation: the cached blocks
    land in cache slots 0.. byte for byte, and the prompt's new full
    blocks are captured from the cache byte for byte (int8 rows and
    scales included)."""
    tm = TM.get("TinyLM")(**FAMILIES["TinyLM"], kv_quant="int8",
                          device="cpu").eval()
    tm.init_weights(torch.Generator().manual_seed(2))
    pc = tkv.PrefixCache(tm, block_tokens=BLOCK, pool_blocks=16)
    assert not pc.paged and pc.fallback_reason == "gpt2_layout"
    ids = _ids(3 * BLOCK + 2, seed=11)
    _, cold, c0 = pc.warm_prefill(ids, len(ids) + 4)
    assert c0 == 0
    nodes, blocks, c = pc.lookup(ids, record=False)
    pc.release(nodes)
    assert c == 3 * BLOCK and len(blocks) == 3
    for layer, pages in zip(cold.layers, pc.pool.layers):
        for j, bid in enumerate(blocks):
            rows = slice(j * BLOCK, (j + 1) * BLOCK)
            assert torch.equal(pages.k[bid], layer.k[0, rows])
            assert torch.equal(pages.v_scale[bid], layer.v_scale[0, rows])
    _, warm, hit = pc.warm_prefill(ids, len(ids) + 4)
    assert hit == 3 * BLOCK and warm.pos_index == len(ids)
    for a, b in zip(cold.layers, warm.layers):
        assert torch.equal(a.k[0, :hit], b.k[0, :hit])
        assert torch.equal(a.k_scale[0, :hit], b.k_scale[0, :hit])


def test_window_layout_refuses_the_scatter_arm_like_jax():
    args = dict(FAMILIES["Llama"], window=16)
    jm = JM.get("Llama")(**args)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))[
        "params"]
    with pytest.raises(jkv.PoolUnsupported) as je:
        jkv.PrefixCache(jm, params, block_tokens=BLOCK, pool_blocks=16,
                        paged=False)
    with pytest.raises(tkv.PoolUnsupported) as te:
        tkv.PrefixCache(TM.get("Llama")(**args, device="cpu"),
                        block_tokens=BLOCK, pool_blocks=16, paged=False)
    assert je.value.reason == te.value.reason == "window"
    assert str(je.value) == str(te.value)
