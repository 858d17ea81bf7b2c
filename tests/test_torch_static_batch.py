"""The static micro-batch scheduler in the port (engine/serving.py
``BatchedGenerationService``) and ``serve.py --scheduler auto`` on the
CPU, against the JAX package's rules.

- concurrent requests give each request's solo ids (greedy, and sampled
  with the request's own seed), for the GPT-2 family (one exact prompt
  length per group) and the Llama family (left-padded within a 128-token
  bucket, pad slots masked), stops included;
- the group keys equal the JAX service's ``_group_key``;
- ``stats`` count requests, batches, shared requests and the largest
  batch; ``/healthz`` and ``/metrics?format=json`` report them;
- ``--scheduler auto`` picks what JAX's rule picks (GPT-2: static; Llama
  with and without a pool: continuous; ``--max-batch 1``: none).
"""
import contextlib
import io
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_distributed_template_tpu.models  # noqa: F401  (register)
import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu.config.registry import MODELS as JM
from pytorch_distributed_template_tpu.engine.serving import (
    BatchedGenerationService as JBatched, GenerationService as JService,
)
from pytorch_distributed_template_tpu_torch import serve
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TM,
)
from pytorch_distributed_template_tpu_torch.engine.serving import (
    BatchedGenerationService, GenerationService,
)
from pytorch_distributed_template_tpu_torch.tools import (
    make_serving_artifact as tool,
)

FAMILIES = {
    "TinyLM": dict(vocab_size=128, n_layer=2, n_head=4, d_model=64,
                   max_len=128),
    "TinyLlama": dict(vocab_size=128, n_layer=2, n_head=4, n_kv_head=2,
                      d_model=64, max_len=192),
}


def _model(name):
    m = TM.get(name)(**FAMILIES[name], device="cpu").eval()
    m.init_weights(torch.Generator().manual_seed(7))
    return m


def _concurrent(svc, reqs):
    out = [None] * len(reqs)

    def run(i):
        out[i] = svc.generate(**reqs[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(reqs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    return out


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, n).tolist() for n in lengths]


@pytest.mark.parametrize("name, lengths", [
    ("TinyLM", [12, 12, 12, 12, 20]),
    ("TinyLlama", [12, 20, 31, 40, 140])])
def test_concurrent_requests_equal_solo(name, lengths):
    model = _model(name)
    solo = GenerationService.from_model(model, device="cpu")
    svc = BatchedGenerationService.from_model(model, device="cpu",
                                              max_batch=8, window_ms=300.0)
    try:
        reqs = [dict(prompt_ids=p, max_new_tokens=10)
                for p in _prompts(lengths)]
        reqs[1].update(temperature=0.9, top_k=20, seed=3)
        reqs[2].update(temperature=0.9, top_k=20, seed=4)
        want = [solo.generate(**r) for r in reqs]
        # a stop that fires mid-budget for one row of a shared batch
        stop = want[3]["ids"][4]
        reqs[3]["stop"] = [stop]
        want[3] = solo.generate(**reqs[3])
        assert want[3]["stop_reason"] == "stop"
        got = _concurrent(svc, reqs)
        assert got == want
        # the greedy requests of one key shared one batch
        assert svc.stats["max_batch_size"] >= 2
        assert svc.stats["requests"] == len(reqs)
    finally:
        svc.close()


def _jax_service(name, cls):
    jm = JM.get(name)(**FAMILIES[name])
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))[
        "params"]
    svc = cls.__new__(cls)
    JService._setup(svc, jm, params)     # the rule's state, no worker
    return svc


@pytest.mark.parametrize("name", ["TinyLM", "TinyLlama"])
def test_group_keys_match_jax(name):
    jsvc = _jax_service(name, JBatched)
    tsvc = BatchedGenerationService.from_model(_model(name), device="cpu")
    try:
        assert tsvc._pad_ok == jsvc._pad_ok == (name == "TinyLlama")
        for n in (1, 12, 127, 128, 129, 170):
            req = {"ids": list(range(n)), "max_new_tokens": 8,
                   "temperature": 0.5, "top_k": 3, "top_p": 0.9}
            assert tsvc._group_key(req) == JBatched._group_key(jsvc, req)
    finally:
        tsvc.close()


def test_stats_count_batches():
    svc = BatchedGenerationService.from_model(_model("TinyLM"),
                                              device="cpu", max_batch=3,
                                              window_ms=300.0)
    try:
        p = _prompts([10, 10, 10, 10, 14])
        _concurrent(svc, [dict(prompt_ids=x, max_new_tokens=4) for x in p])
        st = svc.stats
        assert st["requests"] == 5 and st["max_batch_size"] == 3
        # 4 of one key over max_batch 3 (a 3 and a 1) and the other alone
        assert st["batches"] == 3 and st["batched_requests"] == 3
        assert st["tokens_generated"] == 20
        # speculative requests bypass the batcher: no batch counted
        resp = svc.generate(prompt_ids=p[0] * 2, max_new_tokens=6,
                            speculative=2)
        assert "speculative" in resp and svc.stats["batches"] == 3
    finally:
        svc.close()


def _jax_auto(name, pool: bool, max_batch: int) -> str:
    """JAX serve.py's ``--scheduler auto`` rule on the JAX probe."""
    probe = _jax_service(name, JService)
    ring_ok = (int(getattr(probe.model, "window", 0) or 0) > 0 and pool)
    if (probe._pad_ok or ring_ok) and max_batch > 1:
        return "continuous"
    return "static" if max_batch > 1 else "none"


@pytest.mark.parametrize("name, pool, max_batch", [
    ("TinyLM", True, 8), ("TinyLM", False, 8), ("TinyLlama", True, 8),
    ("TinyLlama", False, 8), ("TinyLM", False, 1), ("TinyLlama", True, 1)])
def test_auto_scheduler_matches_jax(name, pool, max_batch):
    model = TM.get(name)(**FAMILIES[name], device="meta")
    assert serve.auto_scheduler(model, {"enabled": pool}, max_batch) == \
        _jax_auto(name, pool, max_batch)


@pytest.fixture(scope="module")
def tlm_artifact(tmp_path_factory):
    out = tmp_path_factory.mktemp("tlm")
    assert tool.main(["-o", str(out), "--arch", "TinyLM", "--max-len",
                      "128", "--seed", "2", "--device", "cpu"]) == 0
    return out / "model"


@pytest.mark.parametrize("flags, want", [
    ([], "BatchedGenerationService"),
    (["--max-batch", "1"], "GenerationService"),
    (["--scheduler", "static"], "BatchedGenerationService")])
def test_serve_builds_the_scheduler(tlm_artifact, tmp_path, flags, want):
    from pytorch_distributed_template_tpu_torch.config import ConfigParser

    args, config = ConfigParser.from_args(
        serve.build_parser(), (), training=False,
        argv=["-r", str(tlm_artifact), "--device", "cpu", "-s",
              str(tmp_path)] + flags)
    svc = serve.build_service(args, config)
    try:
        assert type(svc).__name__ == want
    finally:
        svc.close()


def test_serve_auto_turns_the_pool_on_for_the_continuous_engine(tmp_path):
    from pytorch_distributed_template_tpu_torch.config import ConfigParser

    out = tmp_path / "art"
    assert tool.main(["-o", str(out), "--arch", "TinyLlama", "--max-len",
                      "128", "--device", "cpu"]) == 0
    args, config = ConfigParser.from_args(
        serve.build_parser(), (), training=False,
        argv=["-r", str(out / "model"), "--device", "cpu", "-s",
              str(tmp_path)])
    svc = serve.build_service(args, config)
    try:
        assert type(svc).__name__ == "ContinuousBatchingService"
        assert svc.prefix_cache_stats()["prefix_paged"]
    finally:
        svc.close()


def test_healthz_and_metrics_report_the_static_stats(tlm_artifact,
                                                     tmp_path):
    box, ready = {}, threading.Event()

    def on_ready(server, service):
        box.update(server=server, service=service)
        ready.set()

    argv = ["-r", str(tlm_artifact), "--device", "cpu", "--port", "0",
            "-s", str(tmp_path), "--prefix-cache", "on",
            "--batch-window-ms", "200"]
    th = threading.Thread(target=lambda: serve.main(argv, on_ready),
                          daemon=True)
    with contextlib.redirect_stdout(io.StringIO()):
        th.start()
        assert ready.wait(120)
    url = "http://127.0.0.1:%d" % box["server"].server_address[1]
    try:
        body = json.dumps({"prompt_ids": list(range(40)),
                           "max_new_tokens": 5}).encode()
        for _ in range(2):
            with urllib.request.urlopen(urllib.request.Request(
                    url + "/generate", data=body, method="POST"),
                    timeout=60) as r:
                ids = json.loads(r.read())["ids"]
        solo = GenerationService.from_model(box["service"].model,
                                            device="cpu")
        assert ids == solo.generate(prompt_ids=list(range(40)),
                                    max_new_tokens=5)["ids"]
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(url + "/metrics?format=json",
                                    timeout=60) as r:
            metrics = json.loads(r.read())
        assert health["scheduler"] == "BatchedGenerationService"
        assert health["batching"]["batches"] == 2
        assert metrics["stats"]["requests"] == 2
        assert metrics["stats"]["max_batch_size"] == 1
        # the second request hit the scatter arm (the GPT-2 family's pool)
        pool = metrics["prefix_cache"]
        assert pool["batch1_scatter_requests"] == 2
        assert pool["prefix_hit_tokens"] == 32
    finally:
        box["server"].shutdown()
        th.join(60)
