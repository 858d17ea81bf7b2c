"""Tensor-parallel and DP x TP serving, what one process can check
(``parallel/tp.py``, ``engine/dp.py``, the artifact's ``tp_geometry``),
held against the JAX package (whose tests see 8 fake CPU devices).

- The geometry refusals, with JAX's messages word for word: too few
  devices, every dimension tp does not divide, a model without partition
  rules, DP geometries; a pool whose KV heads tp does not split
  (``kv_heads``).
- ``model_geometry`` and ``analytic_decode_floor_bytes`` of Llama, Mistral
  and TinyLlama at the registry's defaults and of the test shape, at batch
  1 and 8: equal to JAX's.
- ``shard_serving_params``: each leaf's placement equals JAX's
  ``apply_rules`` on the serving mesh (axis and flax dimension), each
  rank's slice shape equals the shard shape JAX's sharding gives it, and
  the slices of every rank join back to the whole tensor exactly.
- The KV-head placement of cache, pool and int8 scale leaves equals JAX's
  ``kv_pool_pspec``; a tp-1 model's collective accounting equals JAX's
  zeros.
- Artifacts: the recorded ``tp_geometry`` equals what JAX's tool records
  for the same shape; a restore at a tp the geometry cannot shard is
  refused before a weight is read, and so is producing one.
- ``DataParallelService``: the same fake group engines behind JAX's facade
  and the port's take the same group for every request of a sequence
  (affinity, the load spread, least-loaded with rotating ties), merge the
  same stats and pool snapshots, and keep a counter written through a
  stats snapshot; page shipping refuses naming A3a.4.

Everything here is exact (integers, shapes, placements, messages); the
token-level parity across processes is tests/test_torch_tp_serving_ranks.py.
"""
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_distributed_template_tpu.models  # noqa: F401
from pytorch_distributed_template_tpu.config.registry import MODELS as JMODELS
from pytorch_distributed_template_tpu.engine.dp import (
    DataParallelService as JDataParallel,
)
from pytorch_distributed_template_tpu.parallel import tp as jtp
from pytorch_distributed_template_tpu.parallel.sharding import (
    apply_rules as japply_rules, path_str as jpath_str,
)

import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch.checkpoint import (
    check_artifact_tp_geometry, load_serving_meta,
)
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TMODELS,
)
from pytorch_distributed_template_tpu_torch.engine.dp import (
    DataParallelService,
)
from pytorch_distributed_template_tpu_torch.engine.kvcache import (
    TP_LATER, PrefixCache,
)
from pytorch_distributed_template_tpu_torch.models.convert import (
    flax_path, params_from_flax,
)
from pytorch_distributed_template_tpu_torch.parallel import tp
from pytorch_distributed_template_tpu_torch.parallel.sharding import (
    Placement, flax_order, join,
)
from pytorch_distributed_template_tpu_torch.tools.make_serving_artifact \
    import make_artifact

REPO = Path(__file__).resolve().parent.parent
VOCAB = 64
# JAX's own test shape (tests/test_serving_tp.py)
KW = dict(vocab_size=VOCAB, n_layer=2, n_head=4, n_kv_head=2, d_model=32,
          max_len=128)
REGISTRY = ["Llama", "Mistral", "TinyLlama"]


def _message(fn, *args):
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def test_geometry_refusals_match_jax_word_for_word():
    jmodel, tmodel = (JMODELS.get("Llama")(**KW),
                      TMODELS.get("Llama")(**KW, device="meta"))
    tp.validate_tp_geometry(tmodel, 2)
    assert _message(tp.validate_tp_geometry, tmodel, 4) == _message(
        jtp.validate_tp_geometry, jmodel, 4)
    assert "n_kv_head=2" in _message(tp.validate_tp_geometry, tmodel, 4)
    bad = dict(KW, n_head=6, n_kv_head=3, vocab_size=66)
    msg = _message(tp.validate_tp_geometry,
                   TMODELS.get("Llama")(**bad, device="meta"), 4)
    assert msg == _message(jtp.validate_tp_geometry,
                           JMODELS.get("Llama")(**bad), 4)
    for dim in ("n_head=6", "n_kv_head=3", "vocab_size=66"):
        assert dim in msg
    # tp 1 always passes, even for a model without rules; tp > 1 refuses it
    tp.validate_tp_geometry(object(), 1)
    assert _message(tp.validate_tp_geometry, object(), 2) == _message(
        jtp.validate_tp_geometry, object(), 2)


def test_device_and_dp_geometry_refusals():
    assert tp.serving_devices(2, "cpu") == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="needs .* devices, found"):
        tp.serving_devices(10 ** 6, "cuda")
    with pytest.raises(ValueError, match="devices"):
        jtp.serving_mesh(10 ** 6)
    for port, jax_ in ((tp.validate_dp_geometry, jtp.validate_dp_geometry),):
        assert _message(port, 0, 1) == _message(jax_, 0, 1)
        assert _message(port, 2, 0) == _message(jax_, 2, 0)
        port(1, 1, "cpu")
        port(4, 2, "cpu")          # gloo ranks: no card count to run out of
    with pytest.raises(ValueError, match="dp=2 x tp=2 needs 4 devices"):
        tp.validate_dp_geometry(2, 2, "cuda")
    assert tp.dp_group_devices(1, 2, "cpu") == [torch.device("cpu")] * 2


def test_prefix_cache_refuses_kv_heads_tp_does_not_split():
    wide = TMODELS.get("Llama")(**KW, device="meta",
                                mesh=tp.serving_mesh(4))
    assert tp.tp_degree(wide) == 4
    with pytest.raises(ValueError, match="kv_heads"):
        PrefixCache(wide, block_tokens=8, pool_blocks=16)


@pytest.mark.parametrize("name", REGISTRY + ["test_shape"])
def test_geometry_and_floor_equal_jax(name):
    arch, kw = ("Llama", KW) if name == "test_shape" else (name, {})
    jmodel = JMODELS.get(arch)(**kw)
    tmodel = TMODELS.get(arch)(**kw, device="meta")
    assert tp.model_geometry(tmodel) == jtp.model_geometry(jmodel)
    for batch in (1, 8):
        assert tp.analytic_decode_floor_bytes(tmodel, batch) == \
            jtp.analytic_decode_floor_bytes(jmodel, batch) > 0


def test_geometry_takes_each_familys_d_ff_default():
    class Shape:
        n_head, d_model, vocab_size, d_ff = 4, 64, 256, 0

    class GqaShape(Shape):
        n_kv_head = 2

    for shape in (Shape(), GqaShape()):
        assert tp.model_geometry(shape) == jtp.model_geometry(shape)
    assert tp.model_geometry(GqaShape())["d_ff"] == 176
    assert tp.model_geometry(Shape())["d_ff"] == 256


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------


def _jax_params(kw):
    jmodel = JMODELS.get("Llama")(**kw)
    return jmodel, jmodel.init(jax.random.key(0),
                               jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.mark.parametrize("degree", [2, 4])
def test_shard_serving_params_equals_jax_apply_rules(degree):
    kw = dict(KW, n_kv_head=4)
    jmodel, params = _jax_params(kw)
    mesh = jtp.serving_mesh(degree)
    shardings = japply_rules(params, mesh, jmodel.partition_rules())
    jleaves = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    want, shard_shapes = {}, {}
    for path, sh in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        key = jpath_str(path)
        shard_shapes[key] = sh.shard_shape(jleaves[path].shape)
        for dim, entry in enumerate(sh.spec):
            if entry is not None:
                want[key] = (entry, dim)
    whole = params_from_flax(jax.tree.map(np.asarray, params))
    specs = tp.serving_placements(
        TMODELS.get("Llama")(**kw, device="meta"), degree)
    got = {}
    for name, spec in specs.items():
        for dim, entry in enumerate(spec):
            if entry is not None:
                got[flax_path(name)] = (
                    entry, flax_order(name, whole[name].dim()).index(dim))
    assert got == want and len(got) == 2 + 2 * 7
    slices = []
    for rank in range(degree):
        model = TMODELS.get("Llama")(**kw, device="meta")
        part = tp.shard_serving_params(model, dict(whole),
                                       tp.serving_mesh(degree, rank))
        assert model.tp.size == degree and model.tp.index == rank
        for name, t in part.items():
            order = flax_order(name, t.dim())
            assert tuple(t.shape[d] for d in order) == \
                shard_shapes[flax_path(name)], name
        slices.append(part)
    for name, t in whole.items():
        if name in model.placements:
            stacked = torch.stack([s[name] for s in slices])
            assert torch.equal(join(stacked, model.placements[name],
                                    t.shape), t), name
        else:
            assert all(s[name] is t for s in slices)


def test_kv_placement_equals_jax():
    """The KV-head placement of cache, pool and int8 scale leaves is JAX's,
    and a rank's pool holds its heads of every page (int8 scales too)."""
    for ndim in (3, 4):
        assert tuple(tp.kv_pool_pspec(ndim)) == \
            tuple(jtp.kv_pool_pspec(ndim))
    model = TMODELS.get("Llama")(**dict(KW, n_kv_head=4), kv_quant="int8",
                                 device="cpu")
    tp.shard_serving_params(model, {}, tp.serving_mesh(2, 1))
    layer = model.new_paged_cache(4, 8).layers[0]
    assert layer.k.shape == (4, 8, 2, 8) and layer.k.dtype == torch.int8
    assert layer.k_scale.shape == (4, 8, 2)
    assert model.new_cache(1, 8).layers[0].v.shape == (1, 8, 2, 8)


def test_tp1_accounting_equals_jax_zeros():
    jmodel, params = _jax_params(KW)
    model = TMODELS.get("Llama")(**KW, device="cpu")
    assert tp.decode_step_collectives(model) == \
        jtp.decode_step_collectives(jmodel, params) == {
            "tp_degree": 1, "collective_count_per_step": 0,
            "collective_bytes_per_step": 0, "analytic_floor_bytes": 0,
            "counts": {}, "bytes": {}}
    assert tp.tp_degree(None) == tp.tp_degree(model) == 1
    assert tp.tp_degree(tp.serving_mesh(2)) == 2


def test_placement_math_is_the_training_placement():
    """A serving rank's slice is the training slice (parallel/sharding.py):
    the same ``Placement`` on the same dimension."""
    model = TMODELS.get("Llama")(**KW, device="meta")
    tp.shard_serving_params(model, {}, tp.serving_mesh(2, 1))
    assert model.placements["layers.0.self_attn.q_proj.weight"] == \
        Placement("tensor", 0)
    assert model.placements["layers.1.mlp.down_proj.weight"] == \
        Placement("tensor", 1)
    assert "norm.weight" not in model.placements


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------


def _jax_make_artifact():
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        from make_serving_artifact import make_artifact as jmake
    finally:
        sys.path.remove(str(REPO / "scripts"))
    return jmake


def test_artifact_records_geometry_and_refuses_undividable_tp(tmp_path):
    args = dict(vocab_size=256, d_model=64, n_layer=2, n_head=4,
                n_kv_head=2, max_len=256)
    jpath = _jax_make_artifact()(tmp_path / "jax", **args)
    path = make_artifact(tmp_path / "port", arch="TinyLlama",
                         arch_args=args, device="cpu")
    from pytorch_distributed_template_tpu.checkpoint.manager import (
        load_serving_meta as jload_meta,
    )

    geom = load_serving_meta(path)["tp_geometry"]
    assert geom == jload_meta(jpath)["tp_geometry"]
    assert geom["n_kv_head"] == 2
    check_artifact_tp_geometry(path, 1)
    check_artifact_tp_geometry(path, 2)
    with pytest.raises(ValueError, match="n_kv_head=2"):
        check_artifact_tp_geometry(path, 4)
    # the serving entry refuses before any rank starts or weight loads
    from pytorch_distributed_template_tpu_torch import generate as gen_cli
    from pytorch_distributed_template_tpu_torch.config import ConfigParser
    from pytorch_distributed_template_tpu_torch.engine.serving import (
        load_generation_stack,
    )

    _, config = ConfigParser.from_args(
        gen_cli.build_parser(), (), training=False,
        argv=["-r", str(path), "-s", str(tmp_path / "run")])
    with pytest.raises(ValueError, match="n_kv_head=2"):
        load_generation_stack(config, device="cpu", tensor_parallel=4)


def test_artifact_production_refuses_bad_intended_tp(tmp_path):
    with pytest.raises(ValueError, match="n_kv_head") as e:
        make_artifact(tmp_path / "bad", arch="TinyLlama",
                      arch_args={"n_kv_head": 2}, device="cpu",
                      tensor_parallel=4)
    with pytest.raises(ValueError) as j:
        _jax_make_artifact()(tmp_path / "jbad", n_kv_head=2,
                             tensor_parallel=4)
    assert str(e.value) == str(j.value)
    assert not (tmp_path / "bad").exists()
    path = make_artifact(tmp_path / "good", arch="TinyLlama",
                         arch_args={"n_kv_head": 2}, device="cpu",
                         tensor_parallel=2)
    assert load_serving_meta(path)["tensor_parallel"] == 2
    cfg = json.loads((tmp_path / "good" / "config.json").read_text())
    assert cfg["serving"]["tensor_parallel"] == 2


# ---------------------------------------------------------------------------
# the DP facade
# ---------------------------------------------------------------------------


class _Pool:
    def __init__(self, depth):
        self.depth = depth

    def cached_block_count(self, ids):
        return self.depth.get(tuple(ids[:2]), 0)


class _Engine:
    """A group engine as both facades read it."""
    STREAM_DELTAS = True
    model = arch = tokenizer = None
    vocab, tp, role, device, pool_refusal_reason = VOCAB, 1, "both", "cpu", ""

    def __init__(self, g, depth):
        self.g, self._prefix = g, _Pool(depth)
        self._slots = 2
        self.queued = self.live = 0
        self.stats = {"requests": 10 * g, "completed": 3 + g,
                      "model_calls": 100 + g, "warm": True}
        self._latencies = [0.1 * (g + 1), 0.2 * (g + 1)]
        self._ttfts = [0.01 * (g + 1)]

    def encode_prompt(self, prompt=None, prompt_ids=None):
        if not prompt_ids:
            raise ValueError("empty")
        return list(prompt_ids)

    def queue_depth(self):
        return self.queued

    def live_slots(self):
        return self.live

    def generate(self, **kw):
        return {"group": self.g}

    def prefix_cache_stats(self):
        return {"prefix_lookups": 4 + self.g, "prefix_hit_requests": self.g,
                "warm_admit_copy_bytes": 0, "prefix_paged": True}

    def tp_stats(self):
        return {"tp_degree": 1}

    def _ship(self, *args, **kw):
        # a group's pool refuses page shipping at tp > 1
        if self.tp > 1:
            raise NotImplementedError(TP_LATER)
        return {"group": self.g}

    prefill_export = export_cached_pages = import_remote_pages = _ship


def _facades(loads):
    depth = [{(1, 2): 3}, {(1, 2): 5, (7, 7): 1}, {}]
    out = []
    for cls in (JDataParallel, DataParallelService):
        engines = [_Engine(g, depth[g]) for g in range(3)]
        for e, (q, live) in zip(engines, loads):
            e.queued, e.live = q, live
        out.append((cls(engines), engines))
    return out


def test_dp_pick_and_stats_equal_jax_step_by_step():
    steps = [
        ([(0, 0), (0, 0), (0, 0)], [1, 2, 9]),    # deepest prefix: group 1
        ([(0, 0), (3, 2), (0, 0)], [1, 2, 9]),    # 5 - 0 > 4: least-
        ([(0, 0), (2, 2), (0, 0)], [1, 2, 9]),    # loaded; 4 - 0 <= 4
        ([(1, 0), (0, 0), (0, 0)], [9, 9]),       # no match: ties rotate
        ([(0, 0), (0, 0), (0, 0)], [9, 9]),       # (the counter counts
        ([(0, 0), (0, 0), (0, 0)], [9, 9]),       # every pick)
        ([(0, 2), (0, 1), (0, 3)], [7, 7, 1]),    # shallow match wins
        ([(0, 0), (0, 0), (0, 0)], None),         # a bad prompt: no ids
    ]
    (jsvc, jeng), (svc, eng) = _facades(steps[0][0])
    picks = []
    for loads, ids in steps:
        for engines in (jeng, eng):
            for e, (q, live) in zip(engines, loads):
                e.queued, e.live = q, live
        j = jsvc.generate(prompt_ids=ids)["group"]
        assert svc.generate(prompt_ids=ids)["group"] == j
        picks.append(j)
    assert picks == [1, 2, 1, 2, 1, 2, 1, 1]
    assert dict(svc.stats) == dict(jsvc.stats)
    assert svc.stats["dp_groups"] == 3
    assert svc.prefix_cache_stats() == jsvc.prefix_cache_stats()
    assert svc.latency_percentiles() == jsvc.latency_percentiles()
    assert (svc.queue_depth(), svc.live_slots()) == (
        jsvc.queue_depth(), jsvc.live_slots())
    # a counter written through a snapshot survives into the next one
    for s in (svc, jsvc):
        snap = s.stats
        snap["deadline_expired"] = snap.get("deadline_expired", 0) + 1
        snap = s.stats
        snap["deadline_expired"] += 1
    assert svc.stats["deadline_expired"] == jsvc.stats[
        "deadline_expired"] == 2
    assert svc.tp_stats() == {"tp_degree": 1}


def test_dp_gauges_are_not_summed_and_shipping_refuses():
    (_, _), (svc, engines) = _facades([(0, 0)] * 3)
    for e in engines:
        # shipping refuses at tp > 1 (A3a.4's TP remainder; served at tp 1:
        # tests/test_torch_disagg.py)
        e.stats["tp_degree"] = e.tp = 2
    assert svc.stats["tp_degree"] == 2
    for call, kw in ((svc.prefill_export, {"prompt_ids": [1, 2]}),
                     (svc.export_cached_pages, {"prompt_ids": [1, 2]}),
                     (svc.import_remote_pages, {"payload": b""})):
        with pytest.raises(NotImplementedError, match="A3a.4"):
            call(**kw)
    with pytest.raises(ValueError, match="needs >= 1 engine"):
        DataParallelService([])
