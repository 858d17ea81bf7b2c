"""The ``tensor`` and ``fsdp`` mesh axes in one process: placements and
rank layout against the JAX package, the refusals, and chip_smoke.py's
phase 18c rehearsed on the CPU.

- Placement: the port's ``parallel.sharding.plan_placements`` on
  TinyLM, TinyLlama, Mistral-shaped (2 layers at Mistral-7B's widths,
  built on the meta device) and small ViT models names, for every leaf,
  the same mesh axis and the same logical (flax) dimension as JAX's
  ``apply_rules`` on the flax tree (``jax.eval_shape`` of its init)
  over 8 fake devices, on ``{"data": 2, "tensor": 4}``, ``{"data": 2,
  "fsdp": 4}``, ``{"fsdp": 2, "tensor": 2}``, ``{"fsdp": 8}`` and
  ``{"fsdp": 4, "tensor": 1}`` (a named axis of
  size 1 keeps a rule's spec, so no fallback: JAX's quirk).
- Ranks: ``Mesh.axis_index`` equals the position of each device id in
  JAX's ``build_mesh`` for meshes mixing pipe, data, fsdp, seq and tensor,
  and ``Mesh.data_shard`` the batch slice JAX's ``batch_sharding`` hands
  the device.
- GPT-2's fused ``qkv`` on tensor: each slice holds the q, k and v of its
  head group, and the gather undoes the slice bit for bit.
- Refusals, each by name: the expert axis (A11d), tensor or fsdp beside
  pipe or seq, MoE blocks on tensor (A11d), models without Megatron layers
  on tensor, LoRA on either axis, a pool whose KV heads the tensor axis
  does not split (decoding on tensor itself is served), LARS / LAMB /
  Adafactor on fsdp or tensor, and what does not split (GPT-2's vocab
  50257, 2 KV heads on tensor 4).
- Phase 18c at a tiny width: one spawn of 4 gloo ranks trains
  ``configs/mistral_7b_fsdp.json`` cut to 2 layers of d_model 256 in bf16
  on fsdp 4 and then tensor 4: finite losses, the two meshes within the
  phase's bf16 limit, B1-B3 (their plain versions, counted) on every
  rank, and the step's MFU, memory and collective bytes reported.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_distributed_template_tpu.models  # noqa: F401
from pytorch_distributed_template_tpu.config.registry import MODELS as JMODELS
from pytorch_distributed_template_tpu.parallel.mesh import (
    build_mesh as jbuild_mesh,
)
from pytorch_distributed_template_tpu.parallel.sharding import (
    apply_rules as japply_rules, batch_sharding, path_str as jpath_str,
)

import chip_smoke
import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TMODELS,
)
from pytorch_distributed_template_tpu_torch.engine.kvcache import (
    PrefixCache,
)
from pytorch_distributed_template_tpu_torch.models.convert import flax_path
from pytorch_distributed_template_tpu_torch.parallel.mesh import (
    Mesh, mesh_from_config,
)
from pytorch_distributed_template_tpu_torch.parallel.sharding import (
    _cut, flax_order, join, plan_placements, shard_params,
)
from test_torch_accum_ema import _process_signal_handlers  # noqa: F401
from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401
from test_torch_chip_smoke_tp import TINY_MISTRAL

# name: (JAX registry kwargs, the port's); Mistral at its widths, 2 layers
VIT = {"num_classes": 10, "image_size": 32, "patch_size": 8, "n_layer": 2,
       "n_head": 2, "d_model": 32}
MODELS = {
    "TinyLM": ({"vocab_size": 256}, {"vocab_size": 256}),
    "TinyLlama": ({}, {}),
    "Mistral": ({"n_layer": 2}, {"n_layer": 2,
                                 "param_dtype": torch.float32}),
    "ViT": (VIT, VIT),
}
MESHES = [{"data": 2, "tensor": 4}, {"data": 2, "fsdp": 4},
          {"fsdp": 2, "tensor": 2}, {"fsdp": 8}, {"fsdp": 4, "tensor": 1}]
RANK_MESHES = [{"pipe": 2, "data": 2, "fsdp": 2},
               {"data": 2, "fsdp": 2, "tensor": 2},
               {"fsdp": 2, "seq": 2, "tensor": 2},
               {"pipe": 2, "seq": 2, "tensor": 2},
               {"data": 2, "fsdp": 2, "seq": 2}]


def _n(axes) -> int:
    return int(np.prod(list(axes.values())))


def _jax_placements(name, axes) -> dict:
    """``{flax path: (axis, dim)}`` of every leaf JAX's ``apply_rules``
    splits over an axis of size > 1."""
    jmodel = JMODELS.get(name)(**MODELS[name][0])
    x = (jnp.zeros((1, 32, 32, 3)) if name == "ViT"
         else jnp.zeros((1, 8), jnp.int32))
    params = jax.eval_shape(
        lambda: jmodel.init(jax.random.key(0), x))["params"]
    mesh = jbuild_mesh(axes, jax.devices()[:_n(axes)])
    shardings = japply_rules(params, mesh, jmodel.partition_rules())
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        for dim, entry in enumerate(sh.spec):
            if entry is not None and axes[entry] > 1:
                out[jpath_str(path)] = (entry, dim)
    return out


def _port_placements(name, axes) -> dict:
    model = TMODELS.get(name)(**MODELS[name][1], device="meta")
    out = {}
    for key, pl in plan_placements(model, Mesh(axes)).items():
        p = dict(model.named_parameters())[key]
        out[flax_path(key)] = (pl.axis,
                               flax_order(key, p.dim()).index(pl.dim))
    return out


@pytest.mark.parametrize("axes", MESHES, ids=json.dumps)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_placements_equal_jax_apply_rules(name, axes):
    want = _jax_placements(name, axes)
    assert want      # every mesh here splits something
    assert _port_placements(name, axes) == want


def test_fsdp_fallback_breaks_a_square_tie_as_jax():
    """TinyLlama's q_proj is 64 x 64: JAX shards the flax kernel's first
    dimension (its input features), the torch weight's second."""
    got = _port_placements("TinyLlama", {"fsdp": 8})
    assert got["layers_0/self_attn/q_proj/kernel"] == ("fsdp", 0)
    model = TMODELS.get("TinyLlama")(device="meta")
    pl = plan_placements(model, Mesh({"fsdp": 8}))[
        "layers.0.self_attn.q_proj.weight"]
    assert pl.dim == 1


@pytest.mark.parametrize("axes", RANK_MESHES, ids=json.dumps)
def test_rank_layout_and_data_shard_equal_jax_build_mesh(axes):
    jmesh = jbuild_mesh(axes, jax.devices()[:8])
    rows = 2 * 8
    slices = batch_sharding(jmesh).devices_indices_map((rows,))
    shards = axes.get("data", 1) * axes.get("fsdp", 1)
    for pos in np.ndindex(jmesh.devices.shape):
        dev = jmesh.devices[pos]
        mesh = Mesh(axes, rank=dev.id)
        assert mesh.rank == dev.id
        for axis, i in zip(jmesh.axis_names, pos):
            assert mesh.axis_index(axis) == i, (axes, dev.id, axis)
        start = slices[dev][0].start or 0
        assert mesh.data_shard() == (start // (rows // shards), shards)


def test_mesh_keeps_named_axes_of_size_one():
    assert Mesh({"fsdp": 4, "tensor": 1}).axis_names == ("fsdp", "tensor")
    assert Mesh({"data": 2}).axis_names == ("data",)
    assert not Mesh({"data": 4, "seq": 1}).model_parallel()
    assert Mesh({"fsdp": 2}).model_parallel()


def test_gpt2_qkv_tensor_slice_is_a_head_group():
    """The fused ``[3D, D]`` qkv split 4 ways on ``tensor``: slice i holds
    the q, k and v rows of heads ``[i H/4, (i + 1) H/4)``; joining the four
    slices gives the whole tensor back, bit for bit."""
    model = TMODELS.get("TinyLM")(n_head=8, d_model=64, device="cpu")
    pl = plan_placements(model, Mesh({"tensor": 4}))["h.0.attn.qkv.weight"]
    assert (pl.axis, pl.dim, pl.view, pl.vdim) == ("tensor", 0,
                                                   (3, 8, 8, 64), 1)
    w = torch.randn(192, 64)
    parts = [_cut(w, pl, 4, i) for i in range(4)]
    heads = w.view(3, 8, 8, 64)
    for i, part in enumerate(parts):
        assert part.shape == (48, 64)
        assert torch.equal(part.view(3, 2, 8, 64),
                           heads[:, 2 * i:2 * i + 2])
    assert torch.equal(join(torch.stack(parts), pl, (192, 64)), w)


def _mesh_cfg(axes):
    return {"mesh": {"axes": axes}}


@pytest.mark.parametrize("axes,match", [
    ({"expert": 2, "data": 2}, "A11d"),
    ({"fsdp": 2, "pipe": 2}, "A11b's remainder"),
    ({"tensor": 2, "seq": 2}, "A11b's remainder"),
])
def test_mesh_refusals_name_their_roadmap_item(axes, match):
    with pytest.raises(NotImplementedError, match=match):
        mesh_from_config(_mesh_cfg(axes), world_size=4)


@pytest.mark.parametrize("name,kw,axes,error,match", [
    ("TinyMoeLM", {}, {"tensor": 2}, NotImplementedError, "A11d"),
    ("LeNet", {}, {"tensor": 2}, NotImplementedError, "A11b's remainder"),
    ("ViT", {"num_classes": 10, "image_size": 32, "patch_size": 8,
             "n_layer": 1, "n_head": 2, "d_model": 32}, {"tensor": 2},
     NotImplementedError, "A11b's remainder"),
    ("BertMLM", {"vocab_size": 64, "n_layer": 1, "n_head": 2,
                 "d_model": 32, "max_len": 16}, {"tensor": 2},
     NotImplementedError, "A11b's remainder"),
    ("TinyLM", {"lora_rank": 4}, {"tensor": 2}, NotImplementedError,
     "LoRA"),
    ("TinyLlama", {"lora_rank": 4}, {"fsdp": 2}, NotImplementedError,
     "LoRA"),
    ("GPT2", {}, {"tensor": 4}, ValueError, "vocab_size 50257"),
    ("TinyLlama", {}, {"tensor": 4}, ValueError, "n_kv_head 2"),
])
def test_model_refusals_name_what_they_refuse(name, kw, axes, error, match):
    model = TMODELS.get(name)(**kw, device="meta")
    with pytest.raises(error, match=match):
        shard_params(model, Mesh(axes))


def test_decoding_on_a_tensor_axis_refuses():
    """Decoding on a tensor axis is served (tests/test_torch_tp_serving*.py):
    a rank's caches hold its KV heads. What stays refused is a pool whose
    KV heads the axis does not split."""
    model = TMODELS.get("TinyLlama")(n_head=4, n_kv_head=2, device="cpu")
    model.use_tensor_axis(Mesh({"tensor": 2}))
    assert model.new_cache(1, 8).layers[0].k.shape[2] == 1
    assert model.kv_cache_spec()["kv_heads"] == 1
    wide = TMODELS.get("TinyLlama")(n_head=4, n_kv_head=2, device="meta",
                                    mesh=Mesh({"tensor": 4}))
    with pytest.raises(ValueError, match="kv_heads"):
        PrefixCache(wide, block_tokens=8, pool_blocks=16)


@pytest.mark.parametrize("optimizer", ["LARS", "LAMB", "Adafactor"])
@pytest.mark.parametrize("axes", [{"fsdp": 2}, {"tensor": 2}],
                         ids=json.dumps)
def test_whole_norm_optimizers_refuse_split_axes(tmp_path, optimizer, axes):
    from pytorch_distributed_template_tpu_torch.config import (
        ConfigParser, LOADERS,
    )
    from pytorch_distributed_template_tpu_torch.engine.trainer import Trainer
    from pytorch_distributed_template_tpu_torch.engine.losses import (
        resolve_loss,
    )

    cfg = json.loads((chip_smoke.REPO / "configs" / "lm_debug.json")
                     .read_text())
    cfg["trainer"]["save_dir"] = str(tmp_path)
    cfg["optimizer"] = {"type": optimizer, "args": {"lr": 1e-3}}
    cfg["mesh"] = {"axes": axes}
    config = ConfigParser(cfg, run_id="refuse", training=True)
    mesh = Mesh(axes)
    loader = config.init_obj("train_loader", LOADERS,
                             shard=mesh.data_shard())
    model = TMODELS.get("TinyLM")(vocab_size=64, device="cpu")
    with pytest.raises(NotImplementedError, match=optimizer):
        Trainer(model, resolve_loss(cfg["loss"]), [], config, loader,
                device="cpu", mesh=mesh)


def test_phase_18c_on_cpu(tmp_path):
    rows = chip_smoke.phase_tp_full(
        "cpu", device="cpu", work=tmp_path,
        common=TINY_MISTRAL + [("arch;args;n_layer", 2)], timeout=600)
    assert sorted(rows) == ["fsdp4", "tensor4"]
    for name, row in rows.items():
        assert row["dtype"] == "bfloat16" and len(row["losses"]) == 5
        assert all(np.isfinite(row["losses"]))
        assert row["tokens_per_step"] == 4 * 32 and row["mfu"] > 0
        assert all(all(n > 0 for n in r) for r in row["launches_per_rank"])
        step = row["collectives_per_step"][-1]
        if name == "fsdp4":
            assert step["all_gather_bytes"] > 0
            assert step["reduce_scatter_bytes"] > 0
        else:
            assert step["all_reduce_bytes"] > 0
