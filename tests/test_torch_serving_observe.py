"""Request tracing, deadlines, SLOs, brownout and the serving fault hooks
of the port's continuous engine (engine/continuous.py), held against the
JAX package's ``ContinuousBatchingService`` over a paged pool on the same
float32 weights (carried across with ``models/convert.py::
params_from_flax``), a tracer and an SLO watcher each.

- cold, warm-adopt, chunked-stream, ring-wrap and int8-pool requests, one
  at a time: identical greedy ids, identical serve-path fingerprints and
  an identical ordered sequence of span and event names per request
  (times apart), and identical SLO breach counts with a TTFT threshold of
  1 ns (every request breaches) and an e2e threshold of infinity (none);
- a queued request whose deadline expired is dropped in both;
- ``slow_decode`` with a deadline truncates at the same token count in
  both (the same chunk size);
- a flood under brownout strips a speculative request's speculation in
  both, and its fingerprint carries ``b<level>``;
- the ``pool_exhaust`` window defers admissions, then the request
  completes with the ids it gives without the fault, in both.

Token ids are compared exactly (f32 on both sides, greedy).
"""
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_distributed_template_tpu.models  # noqa: F401
from pytorch_distributed_template_tpu.config.registry import MODELS as JMODELS
from pytorch_distributed_template_tpu.engine.continuous import (
    ContinuousBatchingService as JEngine,
)
from pytorch_distributed_template_tpu.observability import reqtrace as jrt
from pytorch_distributed_template_tpu.resilience import faults as jfaults
import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TMODELS,
)
from pytorch_distributed_template_tpu_torch.engine.continuous import (
    ContinuousBatchingService as TEngine,
)
from pytorch_distributed_template_tpu_torch.models.convert import (
    params_from_flax,
)
from pytorch_distributed_template_tpu_torch.observability import (
    reqtrace as trt,
)
from pytorch_distributed_template_tpu_torch.resilience import (
    faults as tfaults,
)

ARCH = dict(vocab_size=256, n_layer=2, n_head=4, n_kv_head=2, d_model=32,
            max_len=256)
BT = 8
# the prefill chunk is the ring's slack too: a window-32 ring spans 7 pages
POOL = {"enabled": True, "block_tokens": BT, "pool_blocks": 96,
        "paged": True, "prefill_chunk_tokens": 16}
ENGINE = dict(slots=3, chunk=4, window_ms=5.0, prefill_chunk_tokens=16)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_faults():
    jfaults.reset()
    tfaults.reset()
    yield
    jfaults.reset()
    tfaults.reset()


def _ids(rng, n):
    return [int(x) for x in rng.integers(1, ARCH["vocab_size"], n)]


class Pair:
    """The JAX engine and the port's on the same weights, each with its
    own tracer and SLO watcher (TTFT 1 ns, e2e infinite)."""

    def __init__(self, tmp, **arch):
        jm = JMODELS.get("Llama")(**ARCH, **arch)
        params = jax.tree.map(np.asarray, jm.init(
            jax.random.key(3), jnp.zeros((1, 8), jnp.int32))["params"])
        tm = TMODELS.get("Llama")(**ARCH, **arch, device="cpu")
        tm.load_state_dict(params_from_flax(params))
        self.paths = {"jax": tmp / "jax" / "spans.jsonl",
                      "torch": tmp / "torch" / "spans.jsonl"}
        self.tracers = {"jax": jrt.RequestTracer(self.paths["jax"]),
                        "torch": trt.RequestTracer(self.paths["torch"])}
        self.slo = {
            "jax": jrt.SloWatcher(ttft_s=1e-9, e2e_s=float("inf")),
            "torch": trt.SloWatcher(ttft_s=1e-9, e2e_s=float("inf"))}
        self.jm, self.params, self.tm = jm, params, tm

    def build(self, **kw):
        self.engines = {
            "jax": JEngine.from_model(
                self.jm, self.params, prefix_cache=dict(POOL),
                tracer=self.tracers["jax"], slo=self.slo["jax"], **ENGINE,
                **kw),
            "torch": TEngine.from_model(
                self.tm, device="cpu", prefix_cache=dict(POOL),
                tracer=self.tracers["torch"], slo=self.slo["torch"],
                **ENGINE, **kw)}
        return self

    def both(self, **req):
        return {k: e.generate(**req) for k, e in self.engines.items()}

    def names(self) -> dict:
        """side -> rid -> the ordered span and event names."""
        out = {}
        for side, tr in self.tracers.items():
            tr.flush()
            recs = [json.loads(line) for line in
                    self.paths[side].read_text().splitlines()]
            per = out.setdefault(side, {})
            for r in recs:
                if r.get("rid"):
                    per.setdefault(r["rid"], []).append(r["name"])
        return out

    def close(self):
        self.engines["torch"].close()
        for tr in self.tracers.values():
            tr.close()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    p = Pair(tmp_path_factory.mktemp("observe")).build()
    yield p
    p.close()


def _settle(pair, n_complete):
    """The engines finish a request's bookkeeping (its ``complete`` event)
    just after the caller wakes: wait for it."""
    end = time.monotonic() + 30
    while time.monotonic() < end:
        names = pair.names()
        if all(sum("complete" in v for v in per.values()) >= n_complete
               for per in names.values()):
            return names
        time.sleep(0.02)
    raise AssertionError(f"the engines did not complete: {pair.names()}")


def _paths_match(pair, reqs, want_modes):
    rids = []
    for i, r in enumerate(reqs):
        rid = f"{want_modes[i]}-{i}-{id(pair)}"
        rids.append(rid)
        got = pair.both(request_id=rid, **r)
        assert got["jax"]["ids"] == got["torch"]["ids"]
        assert len(got["torch"]["ids"]) == r["max_new_tokens"]
        assert got["jax"]["serve_path"] == got["torch"]["serve_path"] \
            == want_modes[i], (i, got)
    names = _settle(pair, len(rids))
    for rid in rids:
        assert names["jax"][rid] == names["torch"][rid], rid
        assert names["torch"][rid][-1] == "complete"
    n = len(rids)
    for side in ("jax", "torch"):
        st = pair.slo[side].stats()
        assert st["slo_breach_total"] == st["slo_ttft_breach_total"] >= n
        assert st["slo_e2e_breach_total"] == 0
    assert pair.slo["jax"].stats() == pair.slo["torch"].stats()
    return names


def test_cold_warm_and_streamed_paths_match_jax(pair):
    rng = np.random.default_rng(11)
    prefix = _ids(rng, 20)
    reqs = [{"prompt_ids": prefix[:12], "max_new_tokens": 9},
            {"prompt_ids": prefix + [5, 6], "max_new_tokens": 6},
            {"prompt_ids": _ids(rng, 40), "max_new_tokens": 5}]
    names = _paths_match(pair, reqs, ["paged", "paged_adopt", "stream"])
    stream = names["torch"][f"stream-2-{id(pair)}"]
    # 40 tokens: two 16-token chunks streamed, the last 8 admitted
    assert stream[:4] == ["prefill_chunk", "prefill_chunk", "queue_wait",
                          "admit"]


def test_int8_ring_paths_match_jax(tmp_path):
    """A window-32 model over an int8 pool: a cold request, a warm one
    adopting its block, and a 60-token prompt that wraps the 7-page ring
    (streamed in 16-token chunks)."""
    p = Pair(tmp_path, kv_quant="int8", window=32).build()
    try:
        prompt = list(range(3, 17))
        _paths_match(p, [
            {"prompt_ids": prompt, "max_new_tokens": 6},
            {"prompt_ids": prompt + [7], "max_new_tokens": 6},
            {"prompt_ids": list(range(3, 63)), "max_new_tokens": 8}],
            ["paged_int8_ring", "paged_int8_ring_adopt",
             "stream_int8_ring_wrap"])
    finally:
        p.close()


def test_expired_queued_request_is_dropped_in_both(pair):
    out = {}
    for side, eng in pair.engines.items():
        before = eng.stats["deadline_expired"]
        mod = jrt if side == "jax" else trt
        out[side] = eng.generate(prompt_ids=[4, 5, 6], max_new_tokens=8,
                                 deadline=mod.Deadline(1e-6))
        assert eng.stats["deadline_expired"] == before + 1
    assert out["jax"]["ids"] == out["torch"]["ids"] == []
    assert out["jax"]["stop_reason"] == out["torch"]["stop_reason"] \
        == "deadline"


def test_slow_decode_deadline_truncates_at_the_same_token(pair):
    prompt = list(range(9, 21))       # the cold test's prompt length
    got = {}
    for side, eng in pair.engines.items():
        faults, mod = ((jfaults, jrt) if side == "jax"
                       else (tfaults, trt))
        # the third round of this request sleeps past its deadline: the
        # chunk that round dispatches is the last one absorbed
        faults.configure(f"slow_decode@tick:{eng.stats['chunks'] + 2}:1500ms")
        try:
            got[side] = eng.generate(prompt_ids=prompt, max_new_tokens=40,
                                     deadline=mod.Deadline(0.75),
                                     request_id=f"slow-{side}")
        finally:
            faults.reset()
    chunk = ENGINE["chunk"]
    for side in got:
        assert got[side]["stop_reason"] == "deadline"
        assert len(got[side]["ids"]) == 1 + 3 * chunk
    assert got["jax"]["ids"] == got["torch"]["ids"]


def test_pool_exhaust_defers_then_recovers_in_both(pair):
    prompt = list(range(30, 47))
    clean = pair.both(prompt_ids=prompt, max_new_tokens=5)
    got = {}
    for side, eng in pair.engines.items():
        faults = jfaults if side == "jax" else tfaults
        deferred = eng.stats["deferred_admissions"]
        faults.configure(f"pool_exhaust@tick:{eng.stats['chunks']}:300ms")
        try:
            t0 = time.monotonic()
            got[side] = eng.generate(prompt_ids=prompt, max_new_tokens=5)
            waited = time.monotonic() - t0
        finally:
            faults.reset()
        assert eng.stats["deferred_admissions"] > deferred
        assert waited >= 0.25
    assert got["jax"]["ids"] == got["torch"]["ids"] \
        == clean["torch"]["ids"] == clean["jax"]["ids"]


def test_brownout_flood_strips_speculation_in_both(tmp_path):
    p = Pair(tmp_path).build(brownout={"enabled": True, "queue_norm": 0.1,
                                       "dwell_s": 600.0})
    try:
        rng = np.random.default_rng(5)
        flood = [{"prompt_ids": _ids(rng, 10), "max_new_tokens": 6}
                 for _ in range(6)]
        for side, eng in p.engines.items():
            threads = [threading.Thread(target=eng.generate, kwargs=r)
                       for r in flood]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert eng.brownout_level >= 1
        levels = {k: e.brownout_level for k, e in p.engines.items()}
        spec = p.both(prompt_ids=_ids(rng, 14), max_new_tokens=6,
                      speculative=3)
        for side, out in spec.items():
            assert "speculative" not in out
            assert out["serve_path"].endswith(f"_b{levels[side]}")
        assert spec["jax"]["ids"] == spec["torch"]["ids"]
        assert levels["jax"] == levels["torch"]
    finally:
        p.close()
