"""The port's KV spill tiers (engine/kvcache.py ``SpillTier``, the pool's
demote-on-evict and promote-on-hit) held against the JAX package's on
JAX's fixture (Llama, 2 layers, d_model 32, 4/2 heads, block 8, f32; the
port's weights through ``params_from_flax``).

- ``SpillTier`` host invariants and its checksum, the same ``digest`` as
  JAX's;
- the fault hooks the tiers fire (``slow_spill``, ``corrupt_spill``,
  ``tier_exhaust``, ``corrupt_page``, ``peer_pull_timeout``);
- demote / promote through the batch-1 service: greedy ids equal to the
  cache-less path and to JAX's, and the pool counters equal to JAX's over
  the same request sequence, with a corrupt spill and an exhausted tier;
- the export / evict audit (refs pin a chain against eviction and demote),
  the coalescing prefill export, and exports of spilled chains.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pytorch_distributed_template_tpu.models  # noqa: F401
from pytorch_distributed_template_tpu.config.registry import MODELS as JMODELS
from pytorch_distributed_template_tpu.engine import kvcache as jkv
from pytorch_distributed_template_tpu.engine.serving import (
    GenerationService as JService,
)
from pytorch_distributed_template_tpu.resilience import faults as jfaults
import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TMODELS,
)
from pytorch_distributed_template_tpu_torch.engine.continuous import (
    ContinuousBatchingService,
)
from pytorch_distributed_template_tpu_torch.engine.kvcache import (
    SpillTier, page_origin_flags,
)
from pytorch_distributed_template_tpu_torch.engine.serving import (
    GenerationService,
)
from pytorch_distributed_template_tpu_torch.models.convert import (
    params_from_flax,
)
from pytorch_distributed_template_tpu_torch.resilience import faults

VOCAB = 64
BLOCK = 8
ARCH = dict(vocab_size=VOCAB, n_layer=2, n_head=4, n_kv_head=2, d_model=32,
            max_len=128)
TIER = {"enabled": True, "block_tokens": BLOCK, "pool_blocks": 18,
        "host_spill_blocks": 64}
SAME = ("tier_demoted_blocks", "tier_demote_bytes", "tier_promoted_blocks",
        "tier_promote_bytes", "tier_checksum_failures", "tier_exhaust_drops",
        "tier_demote_errors", "tier_host_blocks", "tier_host_bytes",
        "prefix_evictions", "prefix_hit_tokens", "prefix_adopted_blocks",
        "prefix_pool_blocks_used", "prefix_dropped_inserts")


@pytest.fixture(scope="module")
def stack():
    jm = JMODELS.get("Llama")(**ARCH)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tm = TMODELS.get("Llama")(**ARCH, device="cpu")
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv(faults.ENV_PLAN, raising=False)
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _ids(n, seed=0):
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.integers(1, VOCAB, n)]


def _leaves(seed=0, nbytes=64):
    rng = np.random.default_rng(seed)
    return {"layers_0/k": rng.bytes(nbytes), "layers_0/v": rng.bytes(nbytes)}


def _svc(tm, cfg=TIER, role="both"):
    return GenerationService.from_model(tm, device="cpu", role=role,
                                        prefix_cache=dict(cfg))


# ---------------------------------------------------------------------------
# SpillTier: bounds and the checksum contract
# ---------------------------------------------------------------------------


def test_spill_tier_roundtrip_and_the_jax_digest():
    tier = SpillTier(host_blocks=4)
    leaves = _leaves(0)
    sha = SpillTier.digest(leaves)
    assert sha == jkv.SpillTier.digest(leaves)
    assert tier.put(("k1",), leaves, sha) == "host"
    got, verdict = tier.get(("k1",))
    assert verdict == "verified" and got == leaves
    assert tier.get(("nope",)) == (None, "miss")


def test_spill_tier_corrupt_entry_reads_as_corrupt_then_miss():
    tier = SpillTier(host_blocks=4)
    leaves = _leaves(1)
    tier.put(("k",), leaves, SpillTier.digest(leaves))
    assert tier.corrupt_latest()
    assert tier.get(("k",)) == (None, "corrupt")
    assert tier.get(("k",)) == (None, "miss")


def test_spill_tier_host_overflow_spills_to_disk(tmp_path):
    tier = SpillTier(host_blocks=2, disk_dir=str(tmp_path), disk_blocks=2)
    entries = {}
    for i in range(4):
        entries[i] = _leaves(i)
        tier.put((i,), entries[i], SpillTier.digest(entries[i]))
    occ = tier.occupancy()
    assert (occ["tier_host_blocks"], occ["tier_disk_blocks"]) == (2, 2)
    got, verdict = tier.get((0,))
    assert verdict == "verified" and got == entries[0]
    assert tier.disk_hits == 1
    path = tier._disk[(1,)]["path"]
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    assert tier.get((1,)) == (None, "corrupt")


def test_spill_tier_garbage_disk_file_reads_as_corrupt(tmp_path):
    tier = SpillTier(host_blocks=1, disk_dir=str(tmp_path), disk_blocks=2)
    tier.put(("a",), _leaves(3), SpillTier.digest(_leaves(3)))
    tier.put(("b",), _leaves(4), SpillTier.digest(_leaves(4)))  # spills a
    path = tier._disk[("a",)]["path"]
    raw = bytearray(open(path, "rb").read())
    raw[4:8] = b"\xff\xff\xff\xff"          # wreck the path string
    open(path, "wb").write(bytes(raw))
    assert tier.get(("a",)) == (None, "corrupt")
    assert tier.get(("a",)) == (None, "miss")


def test_spill_tier_without_disk_drops_overflow_and_full_window_refuses():
    tier = SpillTier(host_blocks=1)
    for i in range(3):
        tier.put((i,), _leaves(i), SpillTier.digest(_leaves(i)))
    assert tier.occupancy()["tier_host_blocks"] == 1
    assert tier.get((0,)) == (None, "miss")
    assert tier.get((2,))[1] == "verified"
    tier.full_until = time.monotonic() + 60.0
    assert tier.put(("k",), _leaves(0), "x") is None
    tier.full_until = 0.0
    assert tier.put(("k",), _leaves(0), SpillTier.digest(_leaves(0))) \
        == "host"


# ---------------------------------------------------------------------------
# the fault hooks, as JAX's
# ---------------------------------------------------------------------------


def test_tier_fault_hooks_fire_as_jaxs():
    plan = "corrupt_spill@evt:2;tier_exhaust@evt:3:1s"
    for mod in (faults, jfaults):
        mod.configure(plan)
        assert mod.on_tier_event() == {"corrupt": None, "exhaust": None}
        fired = mod.on_tier_event()
        assert fired["corrupt"] is not None and fired["exhaust"] is None
        assert mod.on_tier_event()["exhaust"] is not None
        assert mod.on_tier_event() == {"corrupt": None, "exhaust": None}
        mod.configure("peer_pull_timeout@pull:2:10ms")
        assert mod.on_peer_pull() is None
        assert mod.on_peer_pull().kind == "peer_pull_timeout"
        assert mod.on_peer_pull() is None


def test_peer_pull_timeout_drops_a_pulled_import(stack):
    _, _, tm = stack
    src = _svc(tm, {"enabled": True, "block_tokens": BLOCK,
                    "pool_blocks": 48})
    ids = _ids(24, seed=9)
    ref = src.generate(prompt_ids=ids, max_new_tokens=4)["ids"]
    payload = src._prefix.export_pages(ids)
    dst = _svc(tm, {"enabled": True, "block_tokens": BLOCK,
                    "pool_blocks": 48})
    faults.configure("peer_pull_timeout@pull:1:10ms")
    receipt = dst.import_remote_pages(payload, origin="pull")
    assert receipt["dropped"] and dst.stats["peer_pull_timeouts"] == 1
    receipt = dst.import_remote_pages(payload, origin="pull")
    assert receipt["imported_blocks"] == 3
    assert page_origin_flags(dst._prefix.index.match(ids)[0]) == {
        "pull": True}
    assert dst.generate(prompt_ids=ids, max_new_tokens=4)["ids"] == ref


def test_corrupt_page_overwrites_an_adopted_block_as_jaxs(stack):
    jm, params, tm = stack
    cfg = {"enabled": True, "block_tokens": BLOCK, "pool_blocks": 48}
    outs = []
    for mod, svc in ((faults, _svc(tm, cfg)),
                     (jfaults, JService.from_model(jm, params,
                                                   prefix_cache=cfg))):
        mod.configure("corrupt_page@evt:1")
        ids = _ids(24, seed=11)
        svc.generate(prompt_ids=ids, max_new_tokens=2)
        bid = svc._prefix._corrupt_block
        assert bid is not None
        svc.generate(prompt_ids=_ids(9, seed=12), max_new_tokens=2)
        assert svc._prefix._corrupt_block is None
        outs.append(bid)
        if mod is faults:
            for t in svc._prefix.leaves.values():
                assert bool((t[bid] == 1).all())
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# demote on evict, promote on hit: ids and counters against JAX's
# ---------------------------------------------------------------------------


def _rounds(svc, groups, new=6):
    first = [svc.generate(prompt_ids=g, max_new_tokens=new,
                          seed=0)["ids"] for g in groups]
    second = [svc.generate(prompt_ids=g, max_new_tokens=new,
                           seed=0)["ids"] for g in groups]
    return first, second, svc.prefix_cache_stats()


@pytest.mark.parametrize("plan", ["", "corrupt_spill@evt:2",
                                  "tier_exhaust@evt:1:60s"],
                         ids=["clean", "corrupt_spill", "tier_exhaust"])
def test_demote_promote_ids_and_counters_equal_jaxs(stack, plan):
    jm, params, tm = stack
    groups = [_ids(40, seed=s) for s in range(5)]
    cold = GenerationService.from_model(tm, device="cpu")
    refs = [cold.generate(prompt_ids=g, max_new_tokens=6, seed=0)["ids"]
            for g in groups]
    if plan:
        faults.configure(plan)
        jfaults.configure(plan)
    t1, t2, ts = _rounds(_svc(tm), groups)
    j1, j2, js = _rounds(JService.from_model(jm, params,
                                             prefix_cache=dict(TIER)),
                         groups)
    assert t1 == t2 == j1 == j2 == refs
    for key in SAME:
        assert ts[key] == js[key], key
    if plan == "":
        assert ts["tier_demoted_blocks"] > 0 and ts["tier_host_blocks"] > 0
        assert ts["tier_promoted_blocks"] > 0
        assert ts["tier_checksum_failures"] == 0
        assert ts["tier_promote_bytes"] == \
            ts["tier_promoted_blocks"] * ts["prefix_page_bytes"]
    elif plan.startswith("corrupt"):
        assert ts["tier_checksum_failures"] >= 1
    else:
        assert ts["tier_exhaust_drops"] > 0
        assert ts["tier_demoted_blocks"] == 0


def test_disk_tier_demotes_and_promotes(stack, tmp_path):
    jm, params, tm = stack
    groups = [_ids(40, seed=s) for s in range(5)]
    cfg = dict(TIER, host_spill_blocks=2, disk_spill_dir=str(tmp_path / "t"),
               disk_spill_blocks=64)
    svc = _svc(tm, cfg)
    first, second, snap = _rounds(svc, groups)
    assert first == second
    assert snap["tier_disk_blocks"] > 0 or snap["tier_promoted_blocks"] > 0
    assert snap["tier_promoted_blocks"] > 0
    # promotions read verified pages back from disk, not only from host
    assert svc._prefix.spill.disk_hits > 0
    assert snap["tier_checksum_failures"] == 0
    # the same sequence through JAX's disk tier: the same counters
    _, _, js = _rounds(JService.from_model(
        jm, params, prefix_cache=dict(cfg, disk_spill_dir=str(
            tmp_path / "j"))), groups)
    for key in SAME + ("tier_disk_blocks", "tier_disk_bytes"):
        assert snap[key] == js[key], key


def test_dp_groups_sharing_a_spill_dir_keep_their_own_entries(stack,
                                                             tmp_path):
    """Two DP groups under one ``disk_spill_dir`` demote the same blocks
    (their seq numbers alike): each tier writes its own directory, so one
    group's promotion (which unlinks its files) leaves the other's entries
    verified."""
    from pytorch_distributed_template_tpu_torch.engine.dp import (
        DataParallelService,
    )

    _, _, tm = stack
    groups = [_ids(40, seed=s) for s in range(5)]
    cfg = dict(TIER, host_spill_blocks=2, disk_spill_dir=str(tmp_path),
               disk_spill_blocks=64)
    svc = DataParallelService.from_model_factory(
        lambda g: tm, dp=2, tp=1, service_cls=GenerationService,
        device="cpu", service_kw=dict(prefix_cache=cfg))
    try:
        e0, e1 = svc._engines
        assert {e0._prefix.spill.disk_dir, e1._prefix.spill.disk_dir} == {
            str(tmp_path / "g0"), str(tmp_path / "g1")}
        for e in (e0, e1):      # both demote the same blocks to disk
            for g in groups:
                e.generate(prompt_ids=g, max_new_tokens=6, seed=0)
        on_disk = set(e1._prefix.spill._disk)
        assert on_disk and on_disk == set(e0._prefix.spill._disk)
        r0 = [e0.generate(prompt_ids=g, max_new_tokens=6, seed=0)["ids"]
              for g in groups]
        r1 = [e1.generate(prompt_ids=g, max_new_tokens=6, seed=0)["ids"]
              for g in groups]
        assert r0 == r1
        for e in (e0, e1):
            snap = e.prefix_cache_stats()
            assert snap["tier_checksum_failures"] == 0
            assert e._prefix.spill.disk_hits > 0
    finally:
        svc.close()


def test_continuous_engine_promotes_at_its_tick(stack):
    _, _, tm = stack
    groups = [_ids(40, seed=s) for s in range(5)]
    cold = GenerationService.from_model(tm, device="cpu")
    refs = [cold.generate(prompt_ids=g, max_new_tokens=6)["ids"]
            for g in groups]
    svc = ContinuousBatchingService.from_model(
        tm, device="cpu", slots=2, chunk=4, window_ms=1.0,
        prefix_cache=dict(TIER, pool_blocks=20))
    try:
        for _ in range(2):
            assert [svc.generate(prompt_ids=g, max_new_tokens=6)["ids"]
                    for g in groups] == refs
        snap = svc.prefix_cache_stats()
        assert snap["tier_demoted_blocks"] > 0
        assert snap["tier_promoted_blocks"] > 0
    finally:
        svc.close()


def test_pool_without_spill_is_the_classic_pool(stack):
    _, _, tm = stack
    svc = _svc(tm, {"enabled": True, "block_tokens": BLOCK,
                    "pool_blocks": 18})
    assert svc._prefix.spill is None
    for s in range(4):
        svc.generate(prompt_ids=_ids(40, seed=s), max_new_tokens=4)
    snap = svc.prefix_cache_stats()
    assert snap["tier_enabled"] is False
    assert snap["tier_demoted_blocks"] == 0 and snap["prefix_evictions"] > 0


# ---------------------------------------------------------------------------
# the export / evict audit, coalesced exports, spilled chains
# ---------------------------------------------------------------------------


def test_export_refs_pin_chain_against_demote(stack):
    _, _, tm = stack
    svc = _svc(tm)
    pf = svc._prefix
    hot = _ids(40, seed=100)
    svc.generate(prompt_ids=hot, max_new_tokens=4, seed=0)
    nodes, blocks, c = pf.lookup(hot, record=False, promote=False)
    assert c > 0 and blocks
    try:
        for s in range(101, 107):
            svc.generate(prompt_ids=_ids(40, seed=s), max_new_tokens=4)
        for i in range(len(blocks)):
            assert tuple(hot[:(i + 1) * BLOCK]) not in pf.spill
        nodes2, blocks2, c2 = pf.lookup(hot, record=False, promote=False)
        pf.release(nodes2)
        assert blocks2 == blocks and c2 == c
    finally:
        pf.release(nodes)
    for s in range(107, 114):
        svc.generate(prompt_ids=_ids(40, seed=s), max_new_tokens=4)
    assert any(tuple(hot[:(i + 1) * BLOCK]) in pf.spill for i in range(5))


def test_concurrent_export_and_eviction_pressure(stack):
    _, _, tm = stack
    svc = _svc(tm)
    hot = _ids(40, seed=200)
    svc.generate(prompt_ids=hot, max_new_tokens=4)
    errs, payloads = [], []

    def exporter():
        try:
            for _ in range(4):
                payloads.append(svc.export_cached_pages(prompt_ids=hot))
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append(repr(e))

    def pressure():
        try:
            for s in range(201, 209):
                svc.generate(prompt_ids=_ids(40, seed=s), max_new_tokens=4)
        except Exception as e:  # noqa: BLE001
            errs.append(repr(e))

    ts = [threading.Thread(target=exporter),
          threading.Thread(target=pressure)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not errs, errs
    for p in payloads:
        assert len(p["token_ids"]) == p["n_blocks"] * BLOCK
        for leaf in p["leaves"].values():
            assert leaf.shape[0] >= p["n_blocks"]


def test_prefill_export_coalesces_concurrent_calls(stack):
    _, _, tm = stack
    svc = _svc(tm, {"enabled": True, "block_tokens": BLOCK,
                    "pool_blocks": 64}, role="prefill")
    prompts = [_ids(40, seed=300 + i) for i in range(6)]
    res, errs = [None] * 6, []
    gate = threading.Barrier(6)

    def run(i):
        try:
            gate.wait(30)
            res[i] = svc.prefill_export(prompt_ids=prompts[i])
        except Exception as e:  # noqa: BLE001
            errs.append(repr(e))

    with svc._lock:     # hold the service: the six calls queue up
        ts = [threading.Thread(target=run, args=(i,)) for i in range(6)]
        for t in ts:
            t.start()
        time.sleep(0.3)
    for t in ts:
        t.join(120)
    assert not errs, errs
    assert all(r is not None and r["n_blocks"] == 5 for r in res)
    assert svc.stats["prefill_exports"] == 6
    assert 1 <= svc.stats["prefill_export_batches"] < 6
    assert svc.stats["prefill_export_max_batch"] >= 2


def test_prefill_export_single_caller_still_works(stack):
    _, _, tm = stack
    svc = _svc(tm, {"enabled": True, "block_tokens": BLOCK,
                    "pool_blocks": 64}, role="prefill")
    assert svc.prefill_export(prompt_ids=_ids(40, seed=400))["n_blocks"] == 5
    assert svc.prefill_export(prompt_ids=_ids(4))["n_blocks"] == 0
    with pytest.raises(ValueError):
        svc.prefill_export(prompt_ids=[VOCAB + 5])
    assert svc.prefill_export(prompt_ids=_ids(40, seed=400))["n_blocks"] == 5


def test_export_cached_pages_ships_spilled_chains(stack):
    _, _, tm = stack
    svc = _svc(tm)
    hot = _ids(40, seed=500)
    svc.generate(prompt_ids=hot, max_new_tokens=4)
    for s in range(501, 508):
        svc.generate(prompt_ids=_ids(40, seed=s), max_new_tokens=4)
    pf = svc._prefix
    assert any(tuple(hot[:(i + 1) * BLOCK]) in pf.spill for i in range(5))
    payload = svc.export_cached_pages(prompt_ids=hot)
    assert payload["n_blocks"] == 5
    peer = _svc(tm, {"enabled": True, "block_tokens": BLOCK,
                     "pool_blocks": 64})
    assert peer.import_remote_pages(payload)["imported_blocks"] > 0
    cold = GenerationService.from_model(tm, device="cpu")
    assert peer.generate(prompt_ids=hot, max_new_tokens=6)["ids"] == \
        cold.generate(prompt_ids=hot, max_new_tokens=6)["ids"]

