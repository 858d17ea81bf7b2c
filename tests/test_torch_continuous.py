"""The port's ``ContinuousBatchingService`` (engine/continuous.py) over the
paged pool, float32, TinyLlama size, 3 slots, 4-step chunks.

- Concurrent mixed traffic sharing a prefix: greedy requests give the JAX
  package's batch-1 paged ids on the same weights; sampled requests give
  what the port's solo service samples with the same seed (one
  ``torch.Generator`` per request, so batching never changes a draw).
- Every decode chunk runs through the block table; warm admits copy
  nothing.
- Window 32 with 16-token prefill chunks: a long prompt streams across
  ticks and still equals the solo result.
- A pool too small for all chains at once defers admissions and still
  completes every request exactly; a cancelled request frees its pages;
  without a paged pool the engine refuses to build.
"""
import threading

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
from pytorch_distributed_template_tpu_torch.engine.continuous import (
    ContinuousBatchingService,
)
from pytorch_distributed_template_tpu_torch.engine.serving import (
    GenerationService as TService,
)
from pytorch_distributed_template_tpu_torch.models.convert import (
    params_from_flax,
)

BT = 8
POOL = {"enabled": True, "block_tokens": BT, "pool_blocks": 64,
        "paged": True}


def _model(window=0):
    jmodel = JMODELS.get("TinyLlama")(window=window)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.key(5), jnp.zeros((1, 8), jnp.int32))["params"])
    tmodel = TMODELS.get("TinyLlama")(window=window, device="cpu")
    tmodel.load_state_dict(params_from_flax(params))
    return jmodel, params, tmodel


def _engine(tmodel, **kw):
    pool = dict(POOL, **kw.pop("pool", {}))
    return ContinuousBatchingService.from_model(
        tmodel, device="cpu", slots=3, chunk=4, window_ms=20.0,
        prefix_cache=pool, **kw)


def _concurrent(svc, reqs):
    out, errs = [None] * len(reqs), []

    def call(i):
        try:
            out[i] = svc.generate(**reqs[i])
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append((i, e))

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    return out


def test_concurrent_mixed_traffic_matches_jax_and_solo():
    jmodel, params, tmodel = _model()
    rng = np.random.default_rng(60)
    prefix = [int(x) for x in rng.integers(1, 256, 2 * BT + 3)]
    reqs = [{"prompt_ids": prefix + [int(x) for x in rng.integers(
                1, 256, 3 + i % 3)],
             "max_new_tokens": 5 + i, "temperature": [0.0, 0.8][i % 2],
             "top_k": [0, 5][i % 2], "seed": i} for i in range(5)]
    svc = _engine(tmodel)
    try:
        out = _concurrent(svc, reqs)
        jsvc = JService.from_model(jmodel, params, prefix_cache=dict(POOL))
        solo = TService.from_model(tmodel, device="cpu")
        for r, got in zip(reqs, out):
            if r["temperature"] > 0:
                want = solo.generate(**r)["ids"]
            else:
                want = jsvc.generate(**r)["ids"]
            assert got["ids"] == want and len(want) == r["max_new_tokens"]
        # a second, fully warm wave is still exact
        again = _concurrent(svc, reqs)
        assert [a["ids"] for a in again] == [o["ids"] for o in out]
        st, pst = svc.stats, svc.prefix_cache_stats()
        assert st["paged_chunks"] == st["chunks"] > 0
        assert st["paged_admissions"] == st["admissions"] == 10
        assert pst["warm_admit_copy_bytes"] == 0
        assert pst["prefix_hit_tokens"] > 0
        assert pst["prefix_pool_blocks_referenced"] == 0     # all released
    finally:
        svc.close()


def test_streamed_long_prompt_on_the_ring_equals_solo():
    _, _, tmodel = _model(window=32)
    svc = _engine(tmodel, prefill_chunk_tokens=16)
    try:
        rng = np.random.default_rng(7)
        long = [int(x) for x in rng.integers(1, 256, 60)]
        short = [int(x) for x in rng.integers(1, 256, 10)]
        reqs = [{"prompt_ids": long, "max_new_tokens": 8},
                {"prompt_ids": short, "max_new_tokens": 12},
                {"prompt_ids": long[:40], "max_new_tokens": 30}]
        out = _concurrent(svc, reqs)
        solo = TService.from_model(tmodel, device="cpu")
        for r, got in zip(reqs, out):
            assert got["ids"] == solo.generate(**r)["ids"]
        st = svc.stats
        assert st["prefill_chunks"] >= 3 and st["streamed_requests"] >= 1
    finally:
        svc.close()


def test_pool_exhaustion_defers_and_completes():
    """4 requests x 7 blocks (6 prompt + budget) cannot co-reside in 17
    usable pages: admissions defer until completions free pages."""
    _, _, tmodel = _model()
    svc = _engine(tmodel, pool={"pool_blocks": 18})
    try:
        rng = np.random.default_rng(80)
        reqs = [{"prompt_ids": [int(x) for x in rng.integers(1, 256,
                                                              6 * BT)],
                 "max_new_tokens": 8, "seed": i} for i in range(4)]
        out = _concurrent(svc, reqs)
        solo = TService.from_model(tmodel, device="cpu")
        for r, got in zip(reqs, out):
            assert got["ids"] == solo.generate(**r)["ids"]
        assert svc.stats["deferred_admissions"] > 0
    finally:
        svc.close()


def test_cancelled_request_frees_its_pages():
    _, _, tmodel = _model()
    svc = _engine(tmodel)
    try:
        cancel = threading.Event()
        out = svc.generate(prompt_ids=list(range(1, 30)),
                           max_new_tokens=90,
                           on_tokens=lambda ids: cancel.set(),
                           cancel=cancel)
        assert out["stop_reason"] == "cancelled"
        assert 0 < len(out["ids"]) < 90
        assert svc.stats["cancelled"] == 1
        pf = svc._prefix
        assert not pf._private
        assert pf.stats_snapshot()["prefix_pool_blocks_referenced"] == 0
        # the written full blocks were adopted, the rest freed
        assert pf.used_blocks() == pf.index.nodes > 0
    finally:
        svc.close()


def test_engine_without_a_paged_pool_refuses():
    _, _, tmodel = _model()
    for pool in (None, dict(POOL, paged=False)):
        with pytest.raises(NotImplementedError, match="later slice"):
            ContinuousBatchingService.from_model(
                tmodel, device="cpu", prefix_cache=pool)
