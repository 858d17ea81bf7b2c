"""Page shipping in the port (engine/kvcache.py ``serialize_pages`` /
``export_pages`` / ``import_pages``, the services' roles, the DP facade and
serve.py's ``/prefill``, ``/admit_pages``, ``/export_pages``) held against
the JAX package's on JAX's fixture: Llama, 2 layers, d_model 32, 4/2 heads,
block 8, f32, the port's weights through ``params_from_flax``.

- the wire bytes: ``serialize_pages`` of the same leaves (f32, bf16, int8)
  is byte-equal to JAX's, and each side reads the other's;
- payloads cross both ways between the packages, the receiving side
  decodes JAX's greedy ids, and the receiving pools' counters agree;
- the port's own contracts, as JAX's tests state them
  (``tests/test_disagg.py``): token identity greedy and sampled, dedup,
  geometry refusals, private pages unevictable, imports under pressure,
  the dry-pool drop, the device arm, the role gates and the continuous
  engine's handoff; the DP facade at tp 1 (and its tp > 1 refusal);
- an HTTP round trip through the port's serve.py on the CPU: a prefill-role
  and a decode-role server on one set of weights.
"""
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_distributed_template_tpu.models  # noqa: F401
from pytorch_distributed_template_tpu.config.registry import MODELS as JMODELS
from pytorch_distributed_template_tpu.engine import kvcache as jkv
from pytorch_distributed_template_tpu.engine.serving import (
    GenerationService as JService,
)
import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch import serve
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TMODELS,
)
from pytorch_distributed_template_tpu_torch.engine import kvcache as tkv
from pytorch_distributed_template_tpu_torch.engine.continuous import (
    ContinuousBatchingService,
)
from pytorch_distributed_template_tpu_torch.engine.dp import (
    DataParallelService,
)
from pytorch_distributed_template_tpu_torch.engine.serving import (
    GenerationService,
)
from pytorch_distributed_template_tpu_torch.models.convert import (
    params_from_flax, pool_leaf_path, pool_leaf_slot,
)

VOCAB = 64
BLOCK = 8
ARCH = dict(vocab_size=VOCAB, n_layer=2, n_head=4, n_kv_head=2, d_model=32,
            max_len=128)
SHIP_KEYS = ("pages_imported", "page_ship_in_bytes", "warm_admit_copy_bytes",
             "page_ship_dropped", "prefix_adopted_blocks",
             "prefix_pool_blocks_used", "prefix_pool_blocks_resident")


@pytest.fixture(scope="module")
def params():
    model = JMODELS.get("Llama")(**ARCH)
    return jax.tree.map(np.asarray, model.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])


def _jmodel(kv_quant=""):
    return JMODELS.get("Llama")(**ARCH, kv_quant=kv_quant)


def _tmodel(params, kv_quant=""):
    m = TMODELS.get("Llama")(**ARCH, kv_quant=kv_quant, device="cpu")
    m.load_state_dict(params_from_flax(params))
    return m


@pytest.fixture(scope="module")
def model(params):
    return _tmodel(params)


def _ids(n, seed=0):
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.integers(1, VOCAB, n)]


def _pool(pool_blocks=48, paged=True):
    return {"enabled": True, "block_tokens": BLOCK,
            "pool_blocks": pool_blocks, "paged": paged}


def _svc(model, role="both", pool_blocks=48, paged=True):
    return GenerationService.from_model(
        model, device="cpu", role=role,
        prefix_cache=_pool(pool_blocks, paged))


# ---------------------------------------------------------------------------
# the wire format
# ---------------------------------------------------------------------------


def test_pool_leaf_paths_map_both_ways():
    for scope, layer, attr, path in (
            ("layers", 0, "k", "layers_0/self_attn/cached_key"),
            ("layers", 11, "v_scale", "layers_11/self_attn/cached_value_scale"),
            ("h", 3, "v", "h_3/attn/cached_value")):
        assert pool_leaf_path(scope, layer, attr) == path
        assert pool_leaf_slot(path) == (scope, layer, attr)
    for bad in ("layers_0/attn/cached_key", "h_0/attn/pos_index", "wte"):
        with pytest.raises(KeyError):
            pool_leaf_slot(bad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_serialize_pages_is_byte_equal_to_jax(dtype):
    rng = np.random.default_rng(1)
    shapes = {"layers_0/self_attn/cached_key": (5, BLOCK, 2, 8),
              "layers_0/self_attn/cached_value": (5, BLOCK, 2, 8),
              "layers_10/self_attn/cached_key": (5, BLOCK, 2, 8),
              "layers_2/self_attn/cached_value": (5, BLOCK, 2, 8)}
    if dtype == "int8":
        shapes["layers_0/self_attn/cached_key_scale"] = (5, BLOCK, 2)
    jleaves, tleaves = {}, {}
    for ps, shape in shapes.items():
        if ps.endswith("_scale"):
            arr = rng.random(shape, dtype=np.float32)
        elif dtype == "int8":
            arr = rng.integers(-127, 128, shape, dtype=np.int8)
        else:
            arr = rng.standard_normal(shape).astype(np.float32)
        if dtype == "bfloat16":
            jleaves[ps] = np.asarray(jnp.asarray(arr, jnp.bfloat16))
            tleaves[ps] = torch.from_numpy(arr).to(torch.bfloat16)
        else:
            jleaves[ps], tleaves[ps] = arr, torch.from_numpy(arr)
    meta = {"version": 1, "block_tokens": BLOCK, "n_blocks": 3,
            "token_ids": list(range(3 * BLOCK)), "tp_geometry": {"tp": 1}}
    jblob = jkv.serialize_pages(dict(meta, leaves=jleaves))
    assert tkv.serialize_pages(dict(meta, leaves=tleaves)) == jblob
    # numpy leaves (as the JAX package hands them over) serialize the same
    assert tkv.serialize_pages(dict(meta, leaves=jleaves)) == jblob
    back = tkv.deserialize_pages(jblob)
    assert {k: back[k] for k in meta} == meta
    for ps, t in tleaves.items():
        assert back["leaves"][ps].dtype == t.dtype
        assert torch.equal(back["leaves"][ps], t[:3])
    jback = jkv.deserialize_pages(jblob)
    assert str(jback["leaves"][next(iter(shapes))].dtype) == dtype


def test_serialize_roundtrip_and_refusals(model):
    src = _svc(model)
    ids = _ids(40, seed=1)
    src.generate(prompt_ids=ids, max_new_tokens=4)
    payload = src._prefix.export_pages(ids)
    assert payload["n_blocks"] == 5          # 40 tokens / block 8
    assert payload["tp_geometry"]["tp"] == 1
    blob = tkv.serialize_pages(payload)
    assert blob.startswith(tkv.PAGE_MAGIC) and tkv.PAGE_MAGIC == \
        jkv.PAGE_MAGIC
    back = tkv.deserialize_pages(blob)
    assert back["token_ids"] == payload["token_ids"]
    for ps, t in payload["leaves"].items():
        assert torch.equal(back["leaves"][ps], t[:5])
    for torn in (b"NOPE" + blob, blob[: len(blob) // 2], blob[:12],
                 tkv.PAGE_MAGIC + b"\x00\x00\x00\x05{bad}"):
        with pytest.raises(ValueError):
            tkv.deserialize_pages(torn)


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["f32", "int8"])
def test_payloads_cross_between_the_packages(params, kv_quant):
    jm = _jmodel(kv_quant)
    tm = _tmodel(params, kv_quant)
    ids = _ids(44, seed=2)
    jsrc = JService.from_model(jm, params, prefix_cache=_pool())
    ref = jsrc.generate(prompt_ids=ids, max_new_tokens=6)["ids"]
    # JAX's bytes into the port
    jblob = jkv.serialize_pages(jsrc._prefix.export_pages(ids))
    tdst = GenerationService.from_model(tm, device="cpu",
                                        prefix_cache=_pool())
    receipt = tdst.import_remote_pages(jblob)
    assert receipt["imported_blocks"] == 5
    assert tdst.generate(prompt_ids=ids, max_new_tokens=6)["ids"] == ref
    # the port's bytes into JAX, equal to JAX's own bytes for the chain
    tsrc = GenerationService.from_model(tm, device="cpu",
                                        prefix_cache=_pool())
    assert tsrc.generate(prompt_ids=ids, max_new_tokens=6)["ids"] == ref
    tblob = tkv.serialize_pages(tsrc._prefix.export_pages(ids))
    jdst = JService.from_model(jm, params, prefix_cache=_pool())
    assert jdst.import_remote_pages(tblob)["imported_blocks"] == 5
    assert jdst.generate(prompt_ids=ids, max_new_tokens=6)["ids"] == ref
    # the receiving pools count the same handoff
    js, ts = jdst._prefix.stats_snapshot(), tdst._prefix.stats_snapshot()
    for key in SHIP_KEYS:
        assert ts[key] == js[key], key
    assert ts["page_ship_in_bytes"] == 5 * tdst._prefix.page_bytes
    assert tdst._prefix.page_bytes == jdst._prefix.page_bytes
    js, ts = jsrc._prefix.stats_snapshot(), tsrc._prefix.stats_snapshot()
    assert ts["pages_exported"] == js["pages_exported"] == 5
    assert ts["page_ship_out_bytes"] == js["page_ship_out_bytes"]


# ---------------------------------------------------------------------------
# export / import in the port (JAX's tests/test_disagg.py contracts)
# ---------------------------------------------------------------------------


def test_import_token_identical_greedy_and_sampled(model):
    src = _svc(model)
    ids = _ids(48, seed=2)
    greedy = src.generate(prompt_ids=ids, max_new_tokens=6, seed=3)["ids"]
    sampled = src.generate(prompt_ids=ids, max_new_tokens=6,
                           temperature=0.9, top_k=8, seed=3)["ids"]
    dst = _svc(model)
    receipt = dst.import_remote_pages(
        tkv.serialize_pages(src._prefix.export_pages(ids)))
    assert receipt["imported_blocks"] == 6
    # the imported nodes carry the handoff's origin
    nodes, _ = dst._prefix.index.match(ids)
    assert tkv.page_origin_flags(nodes) == {"ship": True}
    assert dst.generate(prompt_ids=ids, max_new_tokens=6,
                        seed=3)["ids"] == greedy
    assert dst.generate(prompt_ids=ids, max_new_tokens=6, temperature=0.9,
                        top_k=8, seed=3)["ids"] == sampled
    snap = dst._prefix.stats_snapshot()
    assert snap["warm_admit_copy_bytes"] == snap["page_ship_in_bytes"] == \
        receipt["imported_blocks"] * dst._prefix.page_bytes


def test_reimport_dedups_already_cached_blocks(model):
    src = _svc(model)
    ids = _ids(32, seed=4)
    src.generate(prompt_ids=ids, max_new_tokens=2)
    payload = src._prefix.export_pages(ids)
    dst = _svc(model)
    assert dst.import_remote_pages(payload)["imported_blocks"] == 4
    again = dst.import_remote_pages(payload)
    assert again["imported_blocks"] == 0 and again["cached_tokens"] == 32


def test_import_geometry_refusals(model):
    src = _svc(model)
    ids = _ids(24, seed=5)
    src.generate(prompt_ids=ids, max_new_tokens=2)
    payload = src._prefix.export_pages(ids)
    dst = _svc(model)
    bad_shape = dict(payload, leaves={ps: t[:, :, :1] for ps, t in
                                      payload["leaves"].items()})
    for bad in (dict(payload, block_tokens=BLOCK * 2),
                dict(payload, leaves={}), bad_shape):
        with pytest.raises(ValueError):
            dst.import_remote_pages(bad)


def test_inflight_import_pages_are_not_evictable(model):
    pf = tkv.PrefixCache(model, block_tokens=BLOCK, pool_blocks=8)
    got = pf.alloc_chain(7)                   # every allocatable page
    assert got is not None and len(got) == 7
    assert pf.index.evict_lru() is None       # nothing evictable
    assert pf.alloc_chain(1) is None          # the pool is dry
    pf.free_blocks(got)


def test_import_under_eviction_pressure_token_identical(model):
    src = _svc(model)
    ids = _ids(48, seed=6)
    ref = src.generate(prompt_ids=ids, max_new_tokens=6)["ids"]
    payload = src._prefix.export_pages(ids)
    dst = _svc(model, pool_blocks=20)
    for s in range(4):
        dst.generate(prompt_ids=_ids(40, seed=100 + s), max_new_tokens=2)
    ev0 = dst._prefix.counter("prefix_evictions")
    assert dst.import_remote_pages(payload)["imported_blocks"] > 0
    assert dst._prefix.counter("prefix_evictions") > ev0
    assert dst.generate(prompt_ids=ids, max_new_tokens=6)["ids"] == ref


def test_import_dropped_on_dry_pool_decodes_cold(params, model):
    src = _svc(model)
    ids = _ids(48, seed=7)
    ref = src.generate(prompt_ids=ids, max_new_tokens=4)["ids"]
    blob = tkv.serialize_pages(src._prefix.export_pages(ids))
    # the same drop on JAX's pool: the counters agree
    jdst = JService.from_model(_jmodel(), params,
                               prefix_cache=_pool(4, paged=False))
    dst = _svc(model, pool_blocks=4, paged=False)
    held = [jdst._prefix.alloc_chain(3), dst._prefix.alloc_chain(3)]
    receipt = dst.import_remote_pages(blob)
    assert jdst.import_remote_pages(blob) == receipt
    assert receipt.get("dropped") and receipt["imported_blocks"] == 0
    js, ts = jdst._prefix.stats_snapshot(), dst._prefix.stats_snapshot()
    for key in SHIP_KEYS:
        assert ts[key] == js[key], key
    assert ts["page_ship_dropped"] == 1
    dst._prefix.free_blocks(held[1])
    assert dst.generate(prompt_ids=ids, max_new_tokens=4)["ids"] == ref


def test_ship_pages_device_arm(model):
    src = _svc(model)
    ids = _ids(40, seed=9)
    ref = src.generate(prompt_ids=ids, max_new_tokens=5)["ids"]
    dst = _svc(model)
    assert tkv.ship_pages(src._prefix, dst._prefix,
                          ids)["imported_blocks"] == 5
    assert dst.generate(prompt_ids=ids, max_new_tokens=5)["ids"] == ref


# ---------------------------------------------------------------------------
# roles and the continuous engine's handoff
# ---------------------------------------------------------------------------


def test_prefill_role_refuses_decode_budgets(model):
    pre = _svc(model, role="prefill")
    with pytest.raises(ValueError, match="prefill-role"):
        pre.generate(prompt_ids=_ids(16), max_new_tokens=8)
    with pytest.raises(ValueError, match="prefill-role"):
        pre.validate_request({"prompt_ids": _ids(16), "max_new_tokens": 8})
    assert len(pre.generate(prompt_ids=_ids(16),
                            max_new_tokens=1)["ids"]) == 1


def test_role_requires_prefix_cache(model):
    with pytest.raises(ValueError, match="prefix cache"):
        GenerationService.from_model(model, device="cpu", role="prefill")
    with pytest.raises(ValueError, match="unknown serving role"):
        GenerationService.from_model(model, device="cpu", role="wat")


def test_prefill_export_short_prompt_ships_nothing(model):
    pre = _svc(model, role="prefill")
    payload = pre.prefill_export(prompt_ids=_ids(BLOCK - 1))
    assert payload["n_blocks"] == 0 and payload["leaves"] == {}


def test_continuous_engine_handoff_token_identical(params, model):
    """A prefill-role continuous engine exports, a decode-role one imports,
    and the decode equals a colocated engine's, greedy and sampled; the
    greedy ids are JAX's batch-1 ids."""
    def cont(role):
        return ContinuousBatchingService.from_model(
            model, device="cpu", slots=2, chunk=4, window_ms=2.0, role=role,
            prefix_cache={"enabled": True, "block_tokens": BLOCK,
                          "pool_blocks": 64})

    jsvc = JService.from_model(_jmodel(), params, prefix_cache=_pool())
    colo, pre, dec = cont("both"), cont("prefill"), cont("decode")
    try:
        for i in range(2):
            ids = _ids(40 + BLOCK * i, seed=20 + i)
            g_ref = colo.generate(prompt_ids=ids, max_new_tokens=6,
                                  seed=i)["ids"]
            assert g_ref == jsvc.generate(prompt_ids=ids,
                                          max_new_tokens=6)["ids"]
            s_ref = colo.generate(prompt_ids=ids, max_new_tokens=6,
                                  temperature=0.8, top_k=8, seed=i)["ids"]
            payload = pre.prefill_export(prompt_ids=ids)
            assert payload["n_blocks"] > 0
            assert dec.import_remote_pages(
                tkv.serialize_pages(payload))["imported_blocks"] > 0
            assert dec.generate(prompt_ids=ids, max_new_tokens=6,
                                seed=i)["ids"] == g_ref
            assert dec.generate(prompt_ids=ids, max_new_tokens=6,
                                temperature=0.8, top_k=8,
                                seed=i)["ids"] == s_ref
        assert dec.stats["remote_admits"] == 2
        assert pre.stats["prefill_exports"] == 2
        snap = dec.prefix_cache_stats()
        assert snap["warm_admit_copy_bytes"] == snap["page_ship_in_bytes"]
        assert snap["prefix_hit_requests"] >= 2
    finally:
        for s in (colo, pre, dec):
            s.close()


# ---------------------------------------------------------------------------
# the DP facade
# ---------------------------------------------------------------------------


def test_dp_facade_ships_at_tp1(params, model):
    svc = DataParallelService.from_model_factory(
        lambda g: _tmodel(params), dp=2, tp=1,
        service_cls=ContinuousBatchingService, device="cpu",
        service_kw=dict(slots=2, chunk=4, prefix_cache=_pool()))
    try:
        src = _svc(model)
        ids = _ids(40, seed=40)
        ref = src.generate(prompt_ids=ids, max_new_tokens=5)["ids"]
        receipt = svc.import_remote_pages(src._prefix.export_pages(ids))
        g = receipt["dp_group"]
        assert receipt["imported_blocks"] == 5
        hits0 = svc._engines[g]._prefix.counter("prefix_hit_requests")
        assert svc.generate(prompt_ids=ids, max_new_tokens=5)["ids"] == ref
        assert svc._engines[g]._prefix.counter(
            "prefix_hit_requests") > hits0
        assert svc.prefix_cache_stats()["pages_imported"] == 5
        # export-only reads the group holding the chain
        assert svc.export_cached_pages(prompt_ids=ids)["n_blocks"] == 5
        assert svc.prefill_export(prompt_ids=_ids(24, seed=41))[
            "n_blocks"] == 3
        payload = src._prefix.export_pages(ids)
        for e in svc._engines:
            e._prefix.tp = 2                  # what a TP group's pool reports
        for call, arg in ((svc.import_remote_pages, {"payload": payload}),
                          (svc.export_cached_pages, {"prompt_ids": ids}),
                          (svc.prefill_export,
                           {"prompt_ids": _ids(24, seed=42)})):
            with pytest.raises(NotImplementedError, match="A3a.4"):
                call(**arg)
    finally:
        for e in svc._engines:
            e._prefix.tp = 1
        svc.close()


# ---------------------------------------------------------------------------
# HTTP through the port's serve.py
# ---------------------------------------------------------------------------


class _Server:
    def __init__(self, argv, model):
        ready, box = threading.Event(), {}

        def on_ready(srv, svc):
            box.update(server=srv, service=svc)
            ready.set()

        self.thread = threading.Thread(
            target=serve.main, args=(argv, on_ready),
            kwargs={"model": model}, daemon=True)
        self.thread.start()
        assert ready.wait(120), "serve.main never became ready"
        self.server, self.service = box["server"], box["service"]
        host, port = self.server.server_address[:2]
        self.url = f"http://{host}:{port}"

    def post(self, path, body, headers=None):
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        req = urllib.request.Request(self.url + path, data=data,
                                     method="POST", headers=headers or {})
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()

    def close(self):
        self.server.shutdown()
        self.thread.join(60)
        assert not self.thread.is_alive()


def test_http_prefill_admit_generate_round_trip(tmp_path, model):
    from pytorch_distributed_template_tpu_torch.tools import (
        make_serving_artifact as tool,
    )

    tool.main(["-o", str(tmp_path / "art"), "--arch", "TinyLlama",
               "--seed", "2", "--device", "cpu"])
    base = ["-r", str(tmp_path / "art" / "model"), "--port", "0",
            "--device", "cpu", "--prefix-cache", "on", "--max-batch", "2",
            "--decode-chunk", "4", "--batch-window-ms", "5"]
    from pytorch_distributed_template_tpu_torch.engine.serving import (
        load_generation_stack,
    )
    from pytorch_distributed_template_tpu_torch.config import ConfigParser

    _, config = ConfigParser.from_args(
        serve.build_parser(), (), training=False,
        argv=base + ["-s", str(tmp_path / "cfg")])
    tiny, _ = load_generation_stack(config, device="cpu")
    pre = _Server(base + ["--role", "prefill", "-s", str(tmp_path / "p")],
                  tiny)
    dec = _Server(base + ["--role", "decode", "--spill-blocks", "16",
                          "-s", str(tmp_path / "d")], tiny)
    colo = _Server(base + ["-s", str(tmp_path / "c")], tiny)
    try:
        ids = list(range(3, 3 + 3 * 32 + 5))
        body = {"prompt_ids": ids, "max_new_tokens": 8}
        _, _, raw = colo.post("/generate", body)
        cold = json.loads(raw)["ids"]
        warm = json.loads(colo.post("/generate", body)[2])["ids"]
        code, hdrs, blob = pre.post("/prefill", {"prompt_ids": ids})
        assert code == 200 and hdrs["Content-Type"] == \
            "application/octet-stream"
        assert int(hdrs["X-Ship-Blocks"]) == 3
        code, _, receipt = dec.post("/admit_pages", blob)
        receipt = json.loads(receipt)
        assert code == 200 and receipt["imported_blocks"] == 3
        shipped = json.loads(dec.post("/generate", body)[2])["ids"]
        assert shipped == warm == cold
        # the export-only endpoint answers from any role with a pool
        _, hdrs, blob2 = dec.post("/export_pages", {"prompt_ids": ids})
        assert int(hdrs["X-Ship-Blocks"]) >= 3
        assert tkv.deserialize_pages(blob2)["n_blocks"] >= 3
        with urllib.request.urlopen(pre.url + "/metrics?format=json") as r:
            pm = json.loads(r.read())
        with urllib.request.urlopen(dec.url + "/metrics?format=json") as r:
            dm = json.loads(r.read())
        assert (pm["role"], dm["role"]) == ("prefill", "decode")
        assert pm["pages_shipped_total"] == 3
        assert pm["page_ship_out_bytes_total"] == \
            dm["page_ship_in_bytes_total"] > 0
        assert dm["remote_admits_total"] == 1
        assert dm["page_ship_dropped_total"] == 0
        assert "tier_demoted_blocks_total" in dm and \
            dm["prefix_cache"]["tier_enabled"] is True
        # the wrong role is a 403, a torn payload a 400, a long budget on
        # the prefill role a 400
        for srv, path, payload, code in (
                (dec, "/prefill", {"prompt_ids": ids}, 403),
                (pre, "/admit_pages", blob, 403),
                (dec, "/admit_pages", blob[:40], 400),
                (pre, "/generate", body, 400)):
            with pytest.raises(urllib.error.HTTPError) as e:
                srv.post(path, payload)
            assert e.value.code == code, path
    finally:
        for s in (pre, dec, colo):
            s.close()


def test_build_service_refuses_a_model_the_config_does_not_serve(tmp_path):
    """A model handed to ``serve.build_service`` stands in for the load
    the config asks for: another KV quantization, another depth or a
    several-group layout is refused; the model the config loads is
    served."""
    from pytorch_distributed_template_tpu_torch.config import ConfigParser
    from pytorch_distributed_template_tpu_torch.engine.serving import (
        load_generation_stack,
    )
    from pytorch_distributed_template_tpu_torch.tools import (
        make_serving_artifact as tool,
    )

    tool.main(["-o", str(tmp_path / "art"), "--arch", "TinyLlama",
               "--seed", "2", "--device", "cpu"])
    base = ["-r", str(tmp_path / "art" / "model"), "--port", "0",
            "--device", "cpu", "--prefix-cache", "on", "--max-batch", "2"]

    def parsed(*extra):
        return ConfigParser.from_args(
            serve.build_parser(), (), training=False,
            argv=base + ["-s", str(tmp_path / f"s{len(extra)}")]
            + list(extra))

    plain = parsed()
    int8 = parsed("--set", "serving;kv_quant", "int8")
    tiny, _ = load_generation_stack(plain[1], device="cpu")
    tiny8, _ = load_generation_stack(int8[1], device="cpu")
    assert (tiny.kv_quant, tiny8.kv_quant) == ("", "int8")
    shallow = TMODELS.get("TinyLlama")(n_layer=1, device="cpu")
    for (args, config), model, match in (
            (int8, tiny, "kv_quant 'int8'"),
            (plain, tiny8, "kv_quant 'int8'"),
            (plain, shallow, "other parameters"),
            (parsed("--dp", "2"), tiny, "one group at tp 1")):
        with pytest.raises(ValueError, match=match):
            serve.build_service(args, config, model=model)
    svc = serve.build_service(*int8, model=tiny8)
    try:
        assert svc.model is tiny8 and svc._prefix.pool.layers[0].k_scale \
            is not None
    finally:
        svc.close()
