"""Tensor-parallel and DP x TP serving across processes on the CPU: the
port's rank groups (``parallel/serving_ranks.py``, gloo) behind both
engines, held against the JAX package's services on its 8 fake devices.

JAX's test shape (vocab 64, 2 layers, 4 heads over 2 KV heads, d_model
32, float32), its weights converted (``models/convert.py::
params_from_flax``) into a serving artifact the ranks load their slices
from. At most 4 rank processes live at a time:

- tp 2 and dp 2 x tp 2: two groups of 2 ranks. The plain
  ``GenerationService`` (contiguous cache, and the paged pool) and the
  ``ContinuousBatchingService`` over one group, then the
  ``DataParallelService`` over both (each engine kind), cold and then warm.
- tp 4 with 4 KV heads and a 16-token window (the rolling cache and the
  ring of pages): one group of 4 ranks, both engines, cold and warm.
- ``serve.py --tp 2``: the HTTP path, its ``/metrics`` keys, and a rank
  killed mid-service: the next request gets an error at once and the
  server exits with an error, its ranks gone.

Held, each exactly: greedy ids for seeds 0 and 1 equal JAX's one-device
service and JAX's tensor-parallel service (tp 2, or tp 4); sampled ids
(temperature 0.8, top_k 8, top_p 0.9, seed 5) equal the port's own tp-1
service of the same engine kind (the port's RNG is torch's:
tests/test_torch_continuous.py); warm admits copy 0 bytes and hit the
pool; one decode step issues at least 2 x n_layer all-reduces whose bytes
lie within [floor, 1.5 x floor], the floor equal to JAX's
``analytic_decode_floor_bytes``; each rank holds its share of the
parameters and of the pool's bytes. Every rank process has the group's
timeout and is killed at the end.
"""
import gc
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_distributed_template_tpu.models  # noqa: F401
from pytorch_distributed_template_tpu.config.registry import MODELS as JMODELS
from pytorch_distributed_template_tpu.engine.serving import (
    GenerationService as JService,
)
from pytorch_distributed_template_tpu.parallel import tp as jtp

import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch import serve
from pytorch_distributed_template_tpu_torch.checkpoint import (
    save_serving_params,
)
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TMODELS,
)
from pytorch_distributed_template_tpu_torch.engine.continuous import (
    ContinuousBatchingService,
)
from pytorch_distributed_template_tpu_torch.engine.dp import (
    DataParallelService,
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
from pytorch_distributed_template_tpu_torch.parallel import tp
from pytorch_distributed_template_tpu_torch.parallel.serving_ranks import (
    RankFailure, TensorParallelModel,
)

VOCAB = 64
KW = dict(vocab_size=VOCAB, n_layer=2, n_head=4, n_kv_head=2, d_model=32,
          max_len=128)
KW4 = dict(KW, n_kv_head=4, window=16)
POOL = {"enabled": True, "block_tokens": 8, "pool_blocks": 64}
ENGINE = dict(slots=2, chunk=4, window_ms=2.0)
BUDGET = 10
SAMPLED = dict(temperature=0.8, top_k=8, top_p=0.9, seed=5)
TIMEOUT_S = 300
# the prompts of JAX's own tests (tests/test_serving_tp.py)
PROMPT_SEEDS = {"plain": 3, "continuous": 4, "tp4": 6, "dp": 7}


def _ids(n, seed):
    return [int(x) for x in np.random.default_rng(seed).integers(1, VOCAB,
                                                                  n)]


def _artifact(root, kw, params):
    """A serving artifact of the converted JAX weights, and its arch."""
    arch = {"type": "Llama", "args": dict(kw)}
    state = params_from_flax(jax.tree.map(np.asarray, params))
    tmodel = TMODELS.get("Llama")(**kw, device="meta")
    save_serving_params(root / "model", state, meta={
        "arch": "Llama", "tp_geometry": tp.model_geometry(tmodel)})
    cfg = {"name": "TpServing", "arch": arch,
           "serving": {"prefix_cache": POOL},
           "trainer": {"save_dir": str(root / "saved"), "verbosity": 1}}
    (root / "config.json").write_text(json.dumps(cfg))
    return arch, root / "model", state


def _jax_greedy(kw, params, degree, prompts):
    """``{prompt seed: ids}`` of JAX's one-device service, after checking
    that JAX's service on ``degree`` fake devices gives the same ids for
    seeds 0 and 1."""
    jmodel = JMODELS.get("Llama")(**kw)
    solo = JService.from_model(jmodel, params)
    mesh = jtp.serving_mesh(degree)
    jmodel_tp = JMODELS.get("Llama")(**kw, mesh=mesh)
    wide = JService.from_model(jmodel_tp, jtp.shard_serving_params(
        jmodel_tp, params, mesh))
    out = {}
    for s in prompts:
        ids = _ids(24, PROMPT_SEEDS[s])
        got = [svc.generate(prompt_ids=ids, max_new_tokens=BUDGET,
                            seed=seed)["ids"]
               for svc in (solo, wide) for seed in (0, 1)]
        assert all(g == got[0] for g in got), got
        out[s] = got[0]
    return out, jtp.analytic_decode_floor_bytes(jmodel_tp)


def _local(kw, state):
    model = TMODELS.get("Llama")(**kw, device="cpu")
    model.load_state_dict(state)
    return model.eval()


def _check_parity(svc, solo, ids, want):
    """Greedy for seeds 0 and 1 = JAX's ids; sampled = the port's tp-1
    service of the same kind."""
    for seed in (0, 1):
        got = svc.generate(prompt_ids=ids, max_new_tokens=BUDGET,
                           seed=seed)["ids"]
        assert got == want, f"greedy (seed {seed}): {got} vs JAX {want}"
    a = solo.generate(prompt_ids=ids, max_new_tokens=BUDGET, **SAMPLED)
    b = svc.generate(prompt_ids=ids, max_new_tokens=BUDGET, **SAMPLED)
    assert a["ids"] == b["ids"], f"sampled: {b['ids']} vs tp 1 {a['ids']}"


def _check_collectives(svc, n_layer, floor):
    st = svc.tp_stats()
    assert st["analytic_floor_bytes"] == floor > 0
    assert st["counts"]["all-reduce"] >= 2 * n_layer
    assert floor <= st["bytes"]["all-reduce"] <= 1.5 * floor
    assert st["counts"]["all-gather"] == 1         # the vocab's logits
    assert st["collective_count_per_step"] == sum(st["counts"].values())


def _check_shares(group, kw, state, pool):
    """Each rank: the placement's share of the parameter bytes, and of the
    pool's bytes (its KV heads of every page)."""
    whole = _local(kw, state)
    degree = group.tensor_parallel
    placed = tp.serving_placements(whole, degree)
    share = sum(p.numel() * p.element_size()
                // (degree if any(placed[n]) else 1)
                for n, p in whole.named_parameters())
    whole_pool = PrefixCache(whole, block_tokens=POOL["block_tokens"],
                             pool_blocks=POOL["pool_blocks"])
    pool_bytes = whole_pool.page_bytes * POOL["pool_blocks"]
    stats = group.rank_stats()
    assert [s["rank"] for s in stats] == list(range(degree))
    for s in stats:
        assert s["param_bytes"] == share
        assert s["pool_bytes"][pool.pool.cid] * degree == pool_bytes
    assert pool.page_bytes * degree == whole_pool.page_bytes


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_serving")
    out = {}
    for name, kw, key in (("kv2", KW, 0), ("kv4", KW4, 1)):
        jmodel = JMODELS.get("Llama")(**kw)
        params = jmodel.init(jax.random.key(key),
                             jnp.zeros((1, 8), jnp.int32))["params"]
        (root / name).mkdir()
        out[name] = (params,) + _artifact(root / name, kw, params)
    return out


def _start(box, key, *args, **kw):
    try:
        box[key] = TensorParallelModel(*args, device="cpu",
                                       timeout=TIMEOUT_S, **kw)
    except BaseException as e:  # noqa: BLE001 — raised by the fixture
        box[key + "_error"] = e


def _started(threads, box, keys):
    for th in threads:
        th.join(TIMEOUT_S)
    errors = [box.get(k + "_error", RuntimeError(f"group {k} not started"))
              for k in keys if k not in box]
    if errors:
        for k in keys:
            if k in box:
                box[k].close()
        raise errors[0]
    return [box[k] for k in keys]


class TestTp2AndDp2:
    """Two groups of 2 ranks: tp 2 on one, dp 2 x tp 2 over both."""

    @pytest.fixture(scope="class")
    def groups(self, weights):
        params, arch, path, state = weights["kv2"]
        box = {}
        threads = [threading.Thread(target=_start,
                                    args=(box, f"g{g}", arch, path, 2),
                                    kwargs={"first": 2 * g})
                   for g in range(2)]
        for th in threads:     # the ranks start while JAX compiles
            th.start()
        want, floor = _jax_greedy(KW, params, 2, ("plain", "continuous",
                                                  "dp"))
        groups = _started(threads, box, ["g0", "g1"])
        yield groups, want, floor, state
        for g in groups:
            g.close()
        assert all(p.poll() is not None for g in groups for p in g._procs)

    def test_tp2_plain_service_contiguous_and_paged(self, groups):
        (g0, _), want, _, state = groups
        ids = _ids(24, PROMPT_SEEDS["plain"])
        local = _local(KW, state)
        cold = GenerationService.from_model(g0, device="cpu")
        _check_parity(cold, GenerationService.from_model(local, device="cpu"),
                      ids, want["plain"])
        paged = GenerationService.from_model(g0, device="cpu",
                                             prefix_cache=dict(POOL))
        solo = GenerationService.from_model(local, device="cpu",
                                            prefix_cache=dict(POOL))
        _check_parity(paged, solo, ids, want["plain"])       # cold
        _check_parity(paged, solo, ids, want["plain"])       # warm
        st = paged.prefix_cache_stats()
        assert st["prefix_paged"] and st["warm_admit_copy_bytes"] == 0
        assert st["prefix_hit_tokens"] > 0
        assert st["batch1_paged_requests"] == 6
        assert paged.tp == 2 and paged.device == torch.device("cpu")

    def test_tp2_continuous_paged_cold_and_warm(self, groups):
        (g0, _), want, floor, state = groups
        ids = _ids(24, PROMPT_SEEDS["continuous"])
        svc = ContinuousBatchingService.from_model(
            g0, device="cpu", prefix_cache=dict(POOL), **ENGINE)
        solo = ContinuousBatchingService.from_model(
            _local(KW, state), device="cpu", prefix_cache=dict(POOL),
            **ENGINE)
        try:
            _check_parity(svc, solo, ids, want["continuous"])
            _check_parity(svc, solo, ids, want["continuous"])   # warm
            assert svc.prefix_cache_stats()["warm_admit_copy_bytes"] == 0
            assert svc.prefix_cache_stats()["prefix_hit_tokens"] > 0
            assert svc.stats["tp_degree"] == 2
            assert svc.stats["decode_calls"] > 0
            _check_collectives(svc, KW["n_layer"], floor)
            _check_shares(g0, KW, state, svc._prefix)
        finally:
            svc.close()
            solo.close()
        assert not g0._closed       # a model handed in stays its caller's

    @pytest.mark.parametrize("kind", ["continuous", "plain"])
    def test_dp2_tp2_both_engines(self, groups, kind):
        (g0, g1), want, floor, state = groups
        cls = (ContinuousBatchingService if kind == "continuous"
               else GenerationService)
        kw = ENGINE if kind == "continuous" else {}
        svc = DataParallelService.from_model_factory(
            lambda g: (g0, g1)[g], dp=2, tp=2, service_cls=cls,
            device="cpu", service_kw=dict(prefix_cache=dict(POOL), **kw))
        solo = cls.from_model(_local(KW, state), device="cpu",
                              prefix_cache=dict(POOL), **kw)
        try:
            # picks 0-5 (ties rotate from group 0, then the prefix pins its
            # group), one more on group 0, then the second prompt's first
            # pick (the 8th) finds no prefix: group 1, which it then pins
            ids = _ids(24, PROMPT_SEEDS["continuous"])
            _check_parity(svc, solo, ids, want["continuous"])
            _check_parity(svc, solo, ids, want["continuous"])   # warm
            svc.generate(prompt_ids=_ids(24, 8), max_new_tokens=1)
            ids = _ids(24, PROMPT_SEEDS["dp"])
            _check_parity(svc, solo, ids, want["dp"])
            _check_parity(svc, solo, ids, want["dp"])           # warm
            pst = svc.prefix_cache_stats()
            assert pst["warm_admit_copy_bytes"] == 0
            assert pst["prefix_hit_tokens"] > 0
            per_group = [e.prefix_cache_stats()["prefix_hit_requests"]
                         for e in svc._engines]
            assert all(n > 0 for n in per_group), per_group
            assert svc.stats["dp_groups"] == 2 and svc.tp == 2
            _check_collectives(svc, KW["n_layer"], floor)
            assert [e.model.devices for e in svc._engines] == \
                [[torch.device("cpu")] * 2] * 2
        finally:
            if kind == "continuous":
                for e in svc._engines:
                    e.close()
                solo.close()


class TestTp4:
    """One group of 4 ranks, 4 KV heads, a 16-token window."""

    @pytest.fixture(scope="class")
    def group(self, weights):
        params, arch, path, state = weights["kv4"]
        box = {}
        th = threading.Thread(target=_start, args=(box, "g", arch, path, 4))
        th.start()
        want, floor = _jax_greedy(KW4, params, 4, ("tp4",))
        (group,) = _started([th], box, ["g"])
        yield group, want, floor, state
        group.close()

    def test_tp4_both_engines_rolling_and_ring(self, group):
        g, want, floor, state = group
        ids = _ids(24, PROMPT_SEEDS["tp4"])     # 24 + 10 > the window
        local = _local(KW4, state)
        _check_parity(GenerationService.from_model(g, device="cpu"),
                      GenerationService.from_model(local, device="cpu"),
                      ids, want["tp4"])
        paged = GenerationService.from_model(g, device="cpu",
                                             prefix_cache=dict(POOL))
        solo = GenerationService.from_model(local, device="cpu",
                                            prefix_cache=dict(POOL))
        _check_parity(paged, solo, ids, want["tp4"])
        _check_parity(paged, solo, ids, want["tp4"])
        cont = ContinuousBatchingService.from_model(
            g, device="cpu", prefix_cache=dict(POOL), **ENGINE)
        csolo = ContinuousBatchingService.from_model(
            local, device="cpu", prefix_cache=dict(POOL), **ENGINE)
        try:
            _check_parity(cont, csolo, ids, want["tp4"])
            _check_parity(cont, csolo, ids, want["tp4"])
            assert cont.prefix_cache_stats()["warm_admit_copy_bytes"] == 0
            _check_collectives(cont, KW4["n_layer"], floor)
            _check_shares(g, KW4, state, cont._prefix)
            assert g.kv_cache_spec()["kv_heads"] == 1
        finally:
            cont.close()
            csolo.close()


def _post(url, body, timeout=60):
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode())
    return json.loads(urllib.request.urlopen(req, timeout=timeout).read())


def test_serve_tp2_metrics_and_a_failing_rank(weights, tmp_path):
    """``serve.py --tp 2``: its ranks start with it; a rank killed
    mid-service fails the next request at once and ends the server with
    an error, its ranks gone."""
    _, _, path, _ = weights["kv2"]
    box, ready = {}, threading.Event()

    def on_ready(server, service):
        box.update(server=server, service=service)
        ready.set()

    def target():
        try:
            serve.main(["-r", str(path), "-c",
                        str(path.parent / "config.json"), "--device", "cpu",
                        "--tp", "2", "--max-batch", "2", "--port", "0",
                        "-s", str(tmp_path / "run")], on_ready)
        except BaseException as e:  # noqa: BLE001 — asserted below
            box["error"] = e
        ready.set()

    th = threading.Thread(target=target, daemon=True)
    th.start()
    assert ready.wait(TIMEOUT_S) and "error" not in box, box.get("error")
    url = f"http://127.0.0.1:{box['server'].server_address[1]}"
    group = box["service"].model
    try:
        ids = _ids(24, PROMPT_SEEDS["continuous"])
        assert len(_post(url, {"prompt_ids": ids,
                               "max_new_tokens": BUDGET})["ids"]) == BUDGET
        m = json.loads(urllib.request.urlopen(
            url + "/metrics?format=json", timeout=60).read())
        assert m["dp_groups"] == 1 and m["tp_degree"] == 2
        assert m["stats"]["tp_degree"] == 2
        assert m["tp_all_reduce_count_per_step"] == 2 * KW["n_layer"] + 1
        assert m["tp_collective_floor_bytes"] <= \
            m["tp_all_reduce_bytes_per_step"]
        assert m["tp_collective_bytes_per_step"] == (
            m["tp_all_reduce_bytes_per_step"]
            + m["tp_all_gather_bytes_per_step"])
        group._procs[1].kill()
        t0 = time.monotonic()
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, {"prompt_ids": ids, "max_new_tokens": BUDGET})
        assert e.value.code == 500
        assert "RankFailure" in json.loads(e.value.read())["error"]
        th.join(60)
        assert not th.is_alive(), "the server kept serving"
        assert time.monotonic() - t0 < 30
        assert isinstance(box.get("error"), RuntimeError)
        assert "serving rank failed" in str(box["error"])
        assert all(p.poll() is not None for p in group._procs)
    finally:
        if th.is_alive():
            box["server"].shutdown()
        group.close()
        gc.collect()
