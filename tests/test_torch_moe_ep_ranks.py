"""Expert parallelism (the ``expert`` mesh axis) on 4 gloo ranks against
the JAX package's ``make_train_step`` on 4 fake CPU devices, and its
placements and checkpoints.

- ``MixtralMoE`` (the tiny model of JAX's ``TestSparseLlama._make``) on
  ``{"expert": 4}`` and ``{"data": 2, "expert": 2}``, ``TinyMoeLM`` on
  ``{"expert": 4}`` and ``{"data": 4}``: 3 Adam steps at capacity 1.0 with
  top-2 (tokens drop), aux weight 0.01, the last batch padded; each step's
  loss and aux loss ``rtol=1e-4`` and the params after 3 steps ``rtol=2e-3,
  atol=1e-5`` (JAX's tolerances, ``tests/test_moe.py``); every rank holds
  ``E / X`` experts of each MoE block and the whole of every other leaf;
  no DDP on an expert axis; the expert group's all-reduces per step.
- Placements equal JAX's ``apply_rules`` leaf by leaf (axis and logical
  dimension) for both models on both expert meshes.
- The port's ``train.py`` on ``configs/llama_debug.json`` with the tiny
  Mixtral (capacity 4.0: batching cannot change a route) on ``{"expert":
  4}``, 2 epochs of 2 steps; its ``checkpoint-epoch1`` (whole tensors)
  resumed on ``{"data": 2, "expert": 2}`` on the ranks and in one process
  reproduces epoch 2 (rtol 1e-5).

One spawn of 4 ranks (the child script of tests/test_torch_moe_ranks.py).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pytorch_distributed_template_tpu.models  # noqa: F401  (register)
from pytorch_distributed_template_tpu.config.registry import (
    MODELS as JMODELS,
)
from pytorch_distributed_template_tpu.parallel.mesh import (
    build_mesh as jbuild_mesh,
)
from pytorch_distributed_template_tpu.parallel.sharding import (
    apply_rules as japply_rules, path_str as jpath_str,
)

import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TMODELS,
)
from pytorch_distributed_template_tpu_torch.models.convert import flax_path
from pytorch_distributed_template_tpu_torch.parallel.mesh import Mesh
from pytorch_distributed_template_tpu_torch.parallel.sharding import (
    flax_order, plan_placements,
)

from test_torch_accum_ema import _process_signal_handlers  # noqa: F401
from test_torch_moe_ranks import (
    MODELS, STEPS, assert_matches_jax, jax_run, launch, step_spec,
)
from test_torch_real_configs import _cut, _port_run

WORLD = 4
# tag: (model, mesh)
STEP_RUNS = {"mixtral_expert4": ("mixtral", {"expert": 4}),
             "mixtral_data2_expert2": ("mixtral", {"data": 2, "expert": 2}),
             "tiny_moe_expert4": ("tiny_moe", {"expert": 4}),
             "tiny_moe_data4": ("tiny_moe", {"data": 4})}
TRAIN_ARCH = {"type": "MixtralMoE", "args": dict(
    MODELS["mixtral"][1], vocab_size=256, capacity_factor=4.0)}


def _train_cfg(axes, batch):
    return _cut("llama_debug.json", {
        "arch": TRAIN_ARCH, "mesh;axes": axes,
        "train_loader;args;n": 16, "train_loader;args;batch_size": batch,
        "valid_loader;args;n": 8, "valid_loader;args;batch_size": batch,
        "trainer;epochs": 2, "trainer;save_period": 1})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep_ranks")
    want, spec = {}, {"runs": []}
    for tag, (name, axes) in STEP_RUNS.items():
        want[tag] = jax_run(name, axes)
        spec["runs"].append(step_spec(name, tag, axes, tmp, want[tag][0]))
    path = tmp / "ep_train.json"
    path.write_text(json.dumps(_train_cfg({"expert": 4}, 8)))
    spec["runs"].append({"name": "ep_train", "argv": [
        "-c", str(path), "--device", "cpu", "-s", str(tmp / "ep_train")]})
    spec["runs"].append({"name": "ep_resumed", "argv": [
        "-r", "@ep_train", "--device", "cpu", "-s", str(tmp / "ep_resumed"),
        "--set", "mesh;axes", json.dumps({"data": 2, "expert": 2}),
        "--set", "train_loader;args;batch_size", "4",
        "--set", "valid_loader;args;batch_size", "4"]})
    return tmp, want, launch(spec, tmp / "ranks", WORLD)


@pytest.mark.parametrize("tag", sorted(STEP_RUNS))
def test_ranks_equal_jax_step(runs, tag):
    tmp, want, ranks = runs
    assert_matches_jax(ranks, tag, want[tag], tmp)
    name, axes = STEP_RUNS[tag]
    first = want[tag][0]
    experts = MODELS[name][1]["num_experts"]
    x = axes.get("expert", 1)
    for r in ranks:
        run = r[tag]
        assert run["ddp"] == (x == 1)
        assert sorted(run["shapes"]) == sorted(first)
        for key, whole in first.items():
            shape = list(whole.shape)
            if ".moe.w" in key or ".moe.b" in key:
                if x > 1:
                    assert run["placements"][key] == ["expert", 0]
                    shape[0] = experts // x
            else:
                assert key not in run["placements"], key
            assert run["shapes"][key] == shape, (tag, key)
        if x > 1:
            # per MoE layer and step: the gates' and the inputs' copy_to
            # backward, the output's reduce_from forward
            assert run["p2p"]["all_reduce"] >= STEPS * 2 * 3


def _jax_placements(reg, kw, axes) -> dict:
    jmodel = JMODELS.get(reg)(**kw)
    params = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    n = int(np.prod(list(axes.values())))
    mesh = jbuild_mesh(axes, jax.devices()[:n])
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(
            japply_rules(params, mesh, jmodel.partition_rules()))[0]:
        for dim, entry in enumerate(sh.spec):
            if entry is not None and axes.get(entry, 1) > 1:
                out[jpath_str(path)] = (entry, dim)
    return out


@pytest.mark.parametrize("axes", [{"expert": 4}, {"data": 2, "expert": 2}],
                         ids=json.dumps)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_placements_equal_jax_apply_rules(name, axes):
    reg, kw, extra, _, _ = MODELS[name]
    want = _jax_placements(reg, kw, axes)
    assert want and all(a == "expert" for a, _ in want.values())
    kw = dict(kw, **{k: getattr(__import__("torch"), v)
                     for k, v in extra.items()})
    model = TMODELS.get(reg)(**kw, device="meta")
    params = dict(model.named_parameters())
    got = {flax_path(key): (pl.axis,
                            flax_order(key, params[key].dim()).index(pl.dim))
           for key, pl in plan_placements(model, Mesh(axes)).items()}
    assert got == want


def test_expert_checkpoint_resumes_on_other_meshes(runs, tmp_path):
    """``{"expert": 4}``'s checkpoint-epoch1 holds whole tensors; resumed on
    data 2 x expert 2 and in one process, epoch 2 repeats."""
    _, _, ranks = runs
    original = ranks[0]["ep_train"]
    assert len(original["steps"]) == 4 and not original["ddp"]
    for r in ranks:
        assert r["ep_train"]["steps"] == original["steps"]
        resumed = r["ep_resumed"]
        assert resumed["start_epoch"] == 2
        assert resumed["mesh"]["data"] == 2 and resumed["mesh"]["expert"] == 2
        np.testing.assert_allclose(resumed["steps"], original["steps"][2:],
                                   rtol=1e-5)
    ckpt = original["run_dir"] + "/checkpoint-epoch1"
    logs, trainer = _port_run(_train_cfg({"data": 1}, 8), tmp_path,
                              extra=("-r", ckpt, "--set", "mesh;axes",
                                     json.dumps({"data": 1})))
    assert trainer.start_epoch == 2 and not trainer.model.placements
    assert trainer.model.layers[0].moe.wi.shape[0] == 4
    np.testing.assert_allclose(logs[0]["loss"],
                               np.mean(original["steps"][2:]), rtol=1e-5)
