"""The port's ``RadixIndex`` and paged ``PrefixCache`` (engine/kvcache.py)
driven beside the JAX package's through one scripted sequence of
``paged_plan`` / ``adopt`` / ``paged_finish`` / eviction: the same block
ids, cached-token counts, ``ring_wrap`` verdicts, ``used_blocks`` and
stats counters at every step. Host bookkeeping only (the pools are
allocated but never read here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pytorch_distributed_template_tpu.models  # noqa: F401
from pytorch_distributed_template_tpu.config.registry import MODELS as JMODELS
from pytorch_distributed_template_tpu.engine import kvcache as jkv
import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TMODELS,
)
from pytorch_distributed_template_tpu_torch.engine import kvcache as tkv

BT = 8
KW = dict(vocab_size=64, n_layer=2, n_head=2, n_kv_head=2, d_model=32,
          max_len=96)
STAT_KEYS = ("prefix_lookups", "prefix_hit_requests", "prefix_hit_tokens",
             "prefix_evictions", "prefix_dropped_inserts",
             "warm_admit_copy_bytes", "prefix_adopted_blocks",
             "prefix_pool_blocks", "prefix_pool_blocks_used",
             "prefix_pool_blocks_resident", "prefix_pool_blocks_referenced",
             "prefix_hit_rate", "prefix_pool_window",
             "prefix_pool_kv_quant")


def _ids(n, seed):
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.integers(1, 64, n)]


def _pair(pool_blocks, window=0, slack=512):
    jm = JMODELS.get("Llama")(**KW, window=window)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))[
        "params"]
    jpc = jkv.PrefixCache(jm, params, block_tokens=BT,
                          pool_blocks=pool_blocks, ring_slack_tokens=slack)
    tm = TMODELS.get("Llama")(**KW, window=window, device="cpu")
    tpc = tkv.PrefixCache(tm, block_tokens=BT, pool_blocks=pool_blocks,
                          ring_slack_tokens=slack)
    assert (tpc.nb_max, tpc.paged, tpc.ring_slack_tokens) == (
        jpc.nb_max, jpc.paged, jpc.ring_slack_tokens)
    return jpc, tpc


def _same_plan(jp, tp):
    if jp is None or tp is None:
        assert jp is None and tp is None
        return
    for key in ("ids", "c", "blocks", "private", "ring_wrap"):
        assert jp[key] == tp[key], key


def _same_state(jpc, tpc):
    js, ts = jpc.stats_snapshot(), tpc.stats_snapshot()
    for key in STAT_KEYS:
        assert js[key] == ts[key], key
    assert jpc.used_blocks() == tpc.used_blocks()
    assert sorted(jpc._free) == sorted(tpc._free)
    assert jpc._private == tpc._private


def test_radix_index_matches_jax_through_insert_match_evict():
    j, t = jkv.RadixIndex(4), tkv.RadixIndex(4)
    jfree, tfree = iter(range(1, 100)), iter(range(1, 100))
    script = [list(range(11)), list(range(16)), [9, 9, 9, 9] * 3,
              list(range(4)) + [63] * 8]
    for ids in script:
        jn, jb, js = j.insert(ids, lambda: next(jfree))
        tn, tb, ts = t.insert(ids, lambda: next(tfree))
        assert (jb, js, len(jn)) == (tb, ts, len(tn))
        assert j.match(ids)[1] == t.match(ids)[1]
    assert j.nodes == t.nodes
    jnodes, _ = j.match(script[1])
    tnodes, _ = t.match(script[1])
    j.acquire(jnodes)
    t.acquire(tnodes)
    evicted = []
    while True:
        jb, tb = j.evict_lru(), t.evict_lru()
        assert jb == tb
        if jb is None:
            break
        evicted.append(jb)
    assert evicted and j.nodes == t.nodes > 0      # pinned chain survives
    j.release(jnodes)
    t.release(tnodes)
    assert j.evict_lru() == t.evict_lru() is not None


def test_paged_pool_script_matches_jax():
    jpc, tpc = _pair(pool_blocks=14)
    both = (jpc, tpc)
    a = _ids(3 * BT + 3, seed=1)
    # cold plan: no hit, a private chain for prompt + budget
    plans = [pc.paged_plan(a, 6) for pc in both]
    _same_plan(*plans)
    assert plans[1]["c"] == 0 and len(plans[1]["private"]) == 5
    _same_state(*both)
    out = _ids(6, seed=2)
    for pc, p in zip(both, plans):
        pc.paged_finish(p, out, 6)
    _same_state(*both)
    assert tpc.stats["prefix_adopted_blocks"] == 4
    # warm plan sharing the 3-block prefix (the final prompt token is
    # never served from cache)
    b = a[:3 * BT] + _ids(5, seed=3)
    plans = [pc.paged_plan(b, 4) for pc in both]
    _same_plan(*plans)
    assert plans[1]["c"] == 3 * BT
    _same_state(*both)
    # a mid-prefill adoption, ref-pinned, then the plan's finish
    streamed = b[:4 * BT]
    got = [pc.adopt(streamed, dict(p["private"]), acquire=True)
           for pc, p in zip(both, plans)]
    assert got[0][0] == got[1][0]
    for pc, p, (adopted, nodes) in zip(both, plans, got):
        p["adopt_nodes"].extend(nodes)
        for i in [i for i, bid in p["private"].items() if bid in adopted]:
            del p["private"][i]
    _same_state(*both)
    for pc, p in zip(both, plans):
        pc.paged_finish(p, _ids(4, seed=4), 4)
    _same_state(*both)
    # pressure: chains larger than the free list evict LRU leaves
    big = [pc.paged_plan(_ids(9 * BT, seed=5), 8) for pc in both]
    _same_plan(*big)
    assert tpc.stats["prefix_evictions"] > 0
    _same_state(*both)
    # dry pool: all-or-nothing, the lookup refs released
    dry = [pc.paged_plan(_ids(9 * BT, seed=6), 8, record=False)
           for pc in both]
    _same_plan(*dry)
    assert dry[1] is None
    _same_state(*both)
    for pc, p in zip(both, big):
        pc.paged_finish(p, [], 0, written=0)
    _same_state(*both)
    assert tpc.stats_snapshot()["prefix_pool_blocks_referenced"] == 0


def test_ring_plans_match_jax():
    """window 32 at bt 8 with slack 16: a 7-page ring (4 in-band + 1 +
    2 slack). A request past the ring span wraps: it shares nothing and
    holds exactly nb_max private pages."""
    jpc, tpc = _pair(pool_blocks=24, window=32, slack=16)
    assert tpc.nb_max == 32 // BT + 1 + 16 // BT
    both = (jpc, tpc)
    short = _ids(2 * BT + 1, seed=7)
    plans = [pc.paged_plan(short, 4) for pc in both]
    _same_plan(*plans)
    assert not plans[1]["ring_wrap"]
    for pc, p in zip(both, plans):
        pc.paged_finish(p, _ids(4, seed=8), 4)
    wrap = short + _ids(4 * BT, seed=9)
    plans = [pc.paged_plan(wrap, 8) for pc in both]
    _same_plan(*plans)
    assert plans[1]["ring_wrap"] and plans[1]["c"] == 0
    assert len(plans[1]["private"]) == tpc.nb_max
    for pc, p in zip(both, plans):
        pc.paged_finish(p, _ids(8, seed=10), 8)
    _same_state(*both)


@pytest.mark.parametrize("kw, reason", [
    (dict(window=12), "window"),            # not a multiple of bt
    (dict(window=32, pool=4), "undersized"),
])
def test_pool_refusals_match_jax(kw, reason):
    window, pool = kw["window"], kw.get("pool", 64)
    jm = JMODELS.get("Llama")(**KW, window=window)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))[
        "params"]
    with pytest.raises(jkv.PoolUnsupported) as je:
        jkv.PrefixCache(jm, params, block_tokens=BT, pool_blocks=pool)
    tm = TMODELS.get("Llama")(**KW, window=window, device="cpu")
    with pytest.raises(tkv.PoolUnsupported) as te:
        tkv.PrefixCache(tm, block_tokens=BT, pool_blocks=pool)
    assert je.value.reason == te.value.reason == reason


def test_spill_tiers_name_the_later_slice():
    tm = TMODELS.get("Llama")(**KW, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        tkv.PrefixCache(tm, block_tokens=BT, pool_blocks=8,
                        host_spill_blocks=4)
