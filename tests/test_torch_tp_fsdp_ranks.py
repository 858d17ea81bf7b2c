"""Tensor parallelism and ZeRO-3 across processes on the CPU: one spawn of 4
gloo ranks.

In that spawn each rank first runs the differentiable collectives of the
``fsdp`` and ``tensor`` axes (``parallel/collectives.py``: ``all_gather``
with its reduce-scatter backward, ``gather_replicated`` with its slice
backward, Megatron's ``copy_to`` and ``reduce_from``) on a seeded tensor of
its own, forward and backward, and reports them. Then the port's
``train.py`` trains ``configs/lm_debug.json`` (TinyLM) and
``configs/llama_debug.json`` (TinyLlama, GQA: 8 heads over 4 KV heads) cut
by ``--set`` (2 epochs of 2 steps over a global batch of 16, float32) on
``{"tensor": 4}``, ``{"data": 2, "fsdp": 2}`` and ``{"fsdp": 2, "tensor":
2}``, the fused head on in half of the six runs, an EMA in two,
accumulation over 2 microbatches in one, ``skip_nonfinite``,
``log_grad_norm`` and a clip at 0.1 in another; then two legs resume a
run's ``checkpoint-epoch1`` on another mesh (TinyLM from tensor 4 onto data
2 x fsdp 2, TinyLlama from data 2 x fsdp 2 onto tensor 4), the port's
``test.py --save-outputs`` evaluates the TinyLlama tensor-4 run's
``model_best``, TinyLM with dropout 0.1 trains on tensor 4, data 2 x fsdp 2
and data 4, and ``configs/mnist_debug.json`` (LeNet, dropout off) resumes a
one-process run's ``checkpoint-epoch1`` onto ``{"data": 2, "fsdp": 2}``.

Held against one process (the collectives: their plain forms on the
concatenated tensors, atol 1e-6) and against the JAX package's ``Trainer``
on the same mesh of 4 fake devices, from its initial params
(``models/convert.py::params_from_flax``): each step's loss within JAX's
own ``rtol=2e-4, atol=2e-5`` (``tests/test_mesh_sharding.py``), and so each
logged grad norm, the params after the last step (gathered whole, rank 0's
checkpoint) and the EMA's shadows within ``PARAM_ATOL_DDP``; every rank
logs the same losses; each rank holds the placement's share of every
tensor; a checkpoint holds the one-process state dict's names and shapes
and resumes on another mesh and in one process with the ranks' epoch-2
losses (rtol 1e-5); ``test.py`` writes full-vocab rows equal to one
process's (atol 1e-5); dropout on tensor 4 gives one process's losses and
on data x fsdp data 4's (rtol 1e-5, every rank of a tensor row drawing the
same masks); LeNet resumed onto data x fsdp ends within JAX's ``rtol=2e-3,
atol=2e-4`` of the straight one-process run (``tests/test_e2e_mnist.py::
test_resume_across_mesh_shapes``). Each process has its own timeout and is
killed on it.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_template_tpu.config import (
    ConfigParser as JConfigParser, LOADERS as JLOADERS,
    METRICS as JMETRICS, MODELS as JMODELS,
)
import pytorch_distributed_template_tpu.data  # noqa: F401  (register)
import pytorch_distributed_template_tpu.engine  # noqa: F401
import pytorch_distributed_template_tpu.models  # noqa: F401
from pytorch_distributed_template_tpu.engine import Trainer as JTrainer
from pytorch_distributed_template_tpu.engine.losses import (
    resolve_loss as jresolve_loss,
)
from pytorch_distributed_template_tpu.parallel.mesh import (
    build_mesh as jbuild_mesh,
)

from pytorch_distributed_template_tpu_torch.models.convert import (
    params_from_flax,
)
from test_torch_accum_ema import (  # noqa: F401
    PARAM_ATOL_DDP, _process_signal_handlers,
)
from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401
from test_torch_ddp import _free_port
from test_torch_real_configs import _cut, _port_run

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 420
WORLD = 4
GLOBAL_BATCH = 16
STEP_TOL = dict(rtol=2e-4, atol=2e-5)     # JAX's own (test_mesh_sharding)
CUTS = {"train_loader;args;n": 32, "valid_loader;args;n": 16,
        "trainer;epochs": 2, "trainer;tensorboard": False}
MODELS = {"lm": ("lm_debug.json", {}),
          "llama": ("llama_debug.json", {"arch;args;n_head": 8,
                                         "arch;args;n_kv_head": 4})}
MESHES = {"tensor4": {"tensor": 4}, "data2_fsdp2": {"data": 2, "fsdp": 2},
          "fsdp2_tensor2": {"fsdp": 2, "tensor": 2}, "data4": {"data": 4}}
# name: (model, mesh, fused head)
RUNS = {"lm_tensor4": ("lm", "tensor4", False),
        "lm_data2_fsdp2": ("lm", "data2_fsdp2", True),
        "lm_fsdp2_tensor2": ("lm", "fsdp2_tensor2", False),
        "llama_tensor4": ("llama", "tensor4", True),
        "llama_data2_fsdp2": ("llama", "data2_fsdp2", False),
        "llama_fsdp2_tensor2": ("llama", "fsdp2_tensor2", True)}
# the runs that keep an EMA (per-slice shadows, gathered whole on save)
EMA = {"llama_fsdp2_tensor2": 0.9, "lm_data2_fsdp2": 0.9}
# more trainer keys per run: accumulation (the sums once per update), the
# clip at a norm it acts at, the skip test and the logged norm (read over
# the mesh)
EXTRA = {"llama_data2_fsdp2": {"trainer;grad_accum_steps": 2},
         "lm_fsdp2_tensor2": {"trainer;skip_nonfinite": True,
                              "trainer;log_grad_norm": True,
                              "trainer;grad_clip_norm": 0.1}}
# name: (the run whose checkpoint-epoch1 it resumes, the mesh it runs on)
RESUMES = {"lm_resumed": ("lm_tensor4", "data2_fsdp2"),
           "llama_resumed": ("llama_data2_fsdp2", "tensor4")}
# TinyLM with dropout 0.1: name -> mesh (a tensor row draws one process's
# masks; data x fsdp draws data 4's)
DROPOUT = {"dropout_tensor4": "tensor4", "dropout_data2_fsdp2": "data2_fsdp2",
           "dropout_data4": "data4"}
LENET = {"mesh;axes": {"data": 2, "fsdp": 2},
         "train_loader;args;batch_size": 16,
         "valid_loader;args;batch_size": 16,
         "test_loader;args;batch_size": 16, "trainer;epochs": 2}

CHILD = r"""
import json, sys
import numpy as np
import torch
from pytorch_distributed_template_tpu_torch import test as test_cli
from pytorch_distributed_template_tpu_torch import train
from pytorch_distributed_template_tpu_torch.models.layers import Dropout
from pytorch_distributed_template_tpu_torch.parallel import collectives as c
from pytorch_distributed_template_tpu_torch.parallel import dist
from pytorch_distributed_template_tpu_torch.parallel.sharding import (
    slice_placed)

torch.set_num_threads(1)
spec, out = json.loads(sys.argv[1]), sys.argv[2]
dist.initialize("cpu")
rank = dist.process_index()


def collectives():
    x = torch.tensor(np.random.default_rng(rank).standard_normal(
        (4, 6)).astype(np.float32), requires_grad=True)
    w = torch.tensor(np.random.default_rng(9).standard_normal(
        (16, 6)).astype(np.float32))
    got = {}
    for name in ("all_gather", "gather_replicated"):
        for dim in (0, 1):
            y = getattr(c, name)(x, dim, None)
            g = torch.arange(y.numel(), dtype=torch.float32).view_as(y)
            (y * g).sum().backward()
            got[f"{name}{dim}"] = [y.tolist(), x.grad.tolist()]
            x.grad = None
    y = c.copy_to(x, None)
    (y * (rank + 1)).sum().backward()
    got["copy_to"] = [y.tolist(), x.grad.tolist()]
    x.grad = None
    y = c.reduce_from(x, None)
    (y * w[:4]).sum().backward()
    got["reduce_from"] = [y.tolist(), x.grad.tolist()]
    return got


result = {"rank": rank, "collectives": collectives()}
for name, argv, params in spec["runs"]:
    steps, box = [], {}
    # "@run": that run's checkpoint-epoch1
    argv = [result[a[1:]]["run_dir"] + "/checkpoint-epoch1"
            if a.startswith("@") else a for a in argv]

    def hook(trainer):
        box["trainer"] = trainer
        for mod in trainer.model.modules():
            if isinstance(mod, Dropout):
                mod.p = 0.0
        if params is not None:
            trainer.model.load_state_dict(slice_placed(
                trainer.model, torch.load(params)))
            trainer.train_step.seed_ema()   # the shadows from them too
        real = trainer.train_step

        class Step:
            def __call__(self, batch):
                m = real(batch)
                count = max(float(m["count"]), 1.0)
                steps.append(float(m["loss_sum"]) / count)
                if "grad_norm_sum" in m:
                    norms.append(float(m["grad_norm_sum"]) / count)
                return m

            def __getattr__(self, key):
                return getattr(real, key)

        trainer.train_step = Step()

    norms = []
    train.main(argv, on_trainer=hook)
    t = box["trainer"]
    result[name] = {
        "steps": steps, "grad_norms": norms, "mesh": t.mesh.sizes,
        "ddp": t.ddp is not None, "shard": list(t.mesh.data_shard()),
        "placements": {k: [pl.axis, pl.dim]
                       for k, pl in t.model.placements.items()},
        "shapes": {k: list(p.shape) for k, p in
                   t.model.named_parameters()},
        "run_dir": str(t.config.save_dir)}
    if name in spec["evaluate"]:
        result[name]["test"] = test_cli.main([
            "-r", str(t.config.save_dir / "model_best"), "--device", "cpu",
            "--save-outputs", spec["evaluate"][name]])
with open(f"{out}.rank{rank}.json", "w") as f:
    json.dump(result, f)
dist.shutdown()
"""


class _NoDropout(fnn.Dropout):
    def __call__(self, inputs, deterministic=None, rng=None):
        return inputs


def _config(name, mesh=None, ranks=True):
    model, mesh_name, fused = RUNS.get(name) or ("lm", DROPOUT[name], False)
    file, cuts = MODELS[model]
    axes = MESHES[mesh or mesh_name]
    shards = axes.get("data", 1) * axes.get("fsdp", 1) if ranks else 1
    sets = dict(CUTS, **cuts, **{
        "mesh;axes": axes if ranks else {"data": 1},
        "train_loader;args;batch_size": GLOBAL_BATCH // shards,
        "valid_loader;args;batch_size": GLOBAL_BATCH // shards})
    if name in DROPOUT:
        sets["arch;args;dropout"] = 0.1
    if name in EMA:
        sets["trainer;ema_decay"] = EMA[name]
    sets.update(EXTRA.get(name, {}))
    if fused:
        sets.update({"arch;args;fused_head": True,
                     "loss": {"type": "fused_lm_cross_entropy",
                              "args": {"chunk": 8}}})
    return _cut(file, sets)


def _jax_run(cfg, axes, tmp):
    """The JAX ``Trainer`` on ``cfg`` over a mesh of 4 fake devices: the
    initial and final params as port state dicts, each step's loss."""
    cfg = json.loads(json.dumps(cfg))
    cfg["mesh"] = {"axes": axes}
    cfg["trainer"]["save_dir"] = str(tmp / "jax")
    config = JConfigParser(cfg, run_id="jax", training=True)
    steps, norms = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn, "Dropout", _NoDropout)
        mp.setenv("PDT_ANATOMY", "0")
        trainer = JTrainer(
            config.init_obj("arch", JMODELS), jresolve_loss(config["loss"]),
            [JMETRICS.get(m) for m in config["metrics"]], config=config,
            train_loader=config.init_obj("train_loader", JLOADERS),
            valid_loader=config.init_obj("valid_loader", JLOADERS),
            mesh=jbuild_mesh(axes, jax.devices()[:4]), seed=0)
        first = params_from_flax(jax.device_get(trainer.state.params))
        real = trainer._train_step

        class Step:
            def __call__(self, state, batch):
                state, m = real(state, batch)
                count = max(float(m["count"]), 1.0)
                steps.append(float(m["loss_sum"]) / count)
                if "grad_norm_sum" in m:
                    norms.append(float(m["grad_norm_sum"]) / count)
                return state, m

            def __getattr__(self, key):
                return getattr(real, key)

        trainer._train_step = Step()
        trainer.train()
    ema = trainer.state.ema_params
    return (first, params_from_flax(jax.device_get(trainer.state.params)),
            steps, None if ema is None else params_from_flax(
                jax.device_get(ema)), norms)


def _launch(spec, out):
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, WORLD_SIZE=str(WORLD), RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD, json.dumps(spec), str(out)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, text in zip(procs, outputs):
        assert p.returncode == 0, text[-3000:]
    return [json.loads(Path(f"{out}.rank{r}.json").read_text())
            for r in range(WORLD)]


def _lenet_cfg(sets):
    return _cut("mnist_debug.json", dict({"trainer;tensorboard": False},
                                         **sets))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tpfsdp")
    jax_out, spec = {}, {"runs": [], "evaluate": {
        "llama_tensor4": str(tmp / "outputs")}}
    for name, (_, mesh, _) in RUNS.items():
        jax_out[name] = _jax_run(_config(name, ranks=False), MESHES[mesh],
                                 tmp / name)
        torch.save(jax_out[name][0], tmp / f"{name}.init.pt")
        path = tmp / f"{name}.json"
        path.write_text(json.dumps(_config(name)))
        spec["runs"].append((name, ["-c", str(path), "--device", "cpu",
                                    "-s", str(tmp / f"ranks_{name}")],
                             str(tmp / f"{name}.init.pt")))
    for name, (source, mesh) in RESUMES.items():
        axes = MESHES[mesh]
        batch = GLOBAL_BATCH // (axes.get("data", 1) * axes.get("fsdp", 1))
        spec["runs"].append((name, [
            "-r", f"@{source}", "--device", "cpu", "-s",
            str(tmp / f"ranks_{name}"), "--set", "mesh;axes",
            json.dumps(axes), "--set", "train_loader;args;batch_size",
            str(batch), "--set", "valid_loader;args;batch_size", str(batch)],
            None))
    for name in DROPOUT:
        path = tmp / f"{name}.json"
        path.write_text(json.dumps(_config(name)))
        spec["runs"].append((name, ["-c", str(path), "--device", "cpu", "-s",
                                    str(tmp / f"ranks_{name}")],
                             str(tmp / "lm_tensor4.init.pt")))
    # LeNet: a straight one-process run of 2 epochs (its epoch-1
    # checkpoint is what the ranks resume)
    straight_logs, straight = _port_run(
        _lenet_cfg({"mesh;axes": {"data": 1}}), tmp / "lenet_one")
    ckpt = straight.config.save_dir / "checkpoint-epoch1"
    path = tmp / "lenet.json"
    path.write_text(json.dumps(_lenet_cfg(LENET)))
    spec["runs"].append(("lenet", ["-c", str(path), "--device", "cpu", "-s",
                                   str(tmp / "ranks_lenet"), "-r",
                                   str(ckpt)], None))
    ranks = _launch(spec, tmp / "ranks")
    lenet = {k: v.detach().clone() for k, v in
             straight.model.state_dict().items()}
    return tmp, jax_out, ranks, lenet


def _gather_expected(xs, dim):
    return torch.cat([torch.tensor(x) for x in xs], dim=dim)


def test_collectives_equal_one_process(runs):
    _, _, ranks, _ = runs
    xs = [np.random.default_rng(r).standard_normal((4, 6)).astype(np.float32)
          for r in range(WORLD)]
    w = np.random.default_rng(9).standard_normal((16, 6)).astype(np.float32)
    tol = dict(atol=1e-6, rtol=0)
    for r in ranks:
        got, i = r["collectives"], r["rank"]
        for dim in (0, 1):
            whole = _gather_expected(xs, dim)
            g = torch.arange(whole.numel(), dtype=torch.float32).view_as(
                whole)
            mine = g.chunk(WORLD, dim=dim)[i]
            for name, grad in (("all_gather", WORLD * mine),
                               ("gather_replicated", mine)):
                # every rank's cotangent is g: the reduce-scatter sums
                # the four, the slice backward takes one
                y, gx = got[f"{name}{dim}"]
                np.testing.assert_allclose(y, whole.numpy(), **tol)
                np.testing.assert_allclose(gx, grad.numpy(), **tol)
        y, gx = got["copy_to"]
        np.testing.assert_allclose(y, xs[i], **tol)
        np.testing.assert_allclose(gx, np.full((4, 6), 1 + 2 + 3 + 4.0),
                                   **tol)
        y, gx = got["reduce_from"]
        np.testing.assert_allclose(y, sum(xs), atol=1e-5)
        np.testing.assert_allclose(gx, w[:4], **tol)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_ranks_equal_jax_trainer_per_step(runs, name):
    """Each step's loss on every rank equals the JAX ``Trainer``'s on the
    same mesh of fake devices; the whole params after the last step (the
    checkpoint rank 0 wrote) equal JAX's; each rank holds its share."""
    tmp, jax_out, ranks, _ = runs
    first, last, want, ema, norms = jax_out[name]
    axes = MESHES[RUNS[name][1]]
    assert len(want) == 4
    for r in ranks:
        run = r[name]
        assert run["mesh"] == {"pipe": 1, "data": axes.get("data", 1),
                               "fsdp": axes.get("fsdp", 1), "seq": 1,
                               "expert": 1, "tensor": axes.get("tensor", 1)}
        assert not run["ddp"]
        np.testing.assert_allclose(run["steps"], want, **STEP_TOL,
                                   err_msg=f"{name} rank {r['rank']}")
        assert len(run["grad_norms"]) == len(norms)
        np.testing.assert_allclose(run["grad_norms"], norms, **STEP_TOL)
    if "trainer;log_grad_norm" in EXTRA.get(name, {}):
        assert len(norms) == 4 and min(norms) > 0.1     # the clip acted
        assert run["steps"] == ranks[0][name]["steps"]
        # the placement's share of every tensor
        assert sorted(run["shapes"]) == sorted(first)
        for key, whole in first.items():
            shape = list(whole.shape)
            if key in run["placements"]:
                axis, dim = run["placements"][key]
                shape[dim] //= axes[axis]
            assert run["shapes"][key] == shape, (name, key)
    assert any(a == "tensor" for a, _ in ranks[0][name]["placements"]
               .values()) == ("tensor" in axes)
    assert any(a == "fsdp" for a, _ in ranks[0][name]["placements"]
               .values()) == ("fsdp" in axes)
    disk = torch.load(Path(ranks[0][name]["run_dir"]) / "checkpoint-epoch2"
                      / "model.pt")
    assert {k: tuple(v.shape) for k, v in disk.items()} == {
        k: tuple(v.shape) for k, v in first.items()}
    for key, p in last.items():
        np.testing.assert_allclose(disk[key].numpy(), p.numpy(),
                                   atol=PARAM_ATOL_DDP, err_msg=key)
    shadow = Path(ranks[0][name]["run_dir"]) / "checkpoint-epoch2" / "ema.pt"
    assert shadow.exists() == (name in EMA)
    if name in EMA:
        # the per-slice shadows, gathered whole: JAX's EMA
        shadow = torch.load(shadow)
        assert sorted(shadow) == sorted(ema)
        for key, p in ema.items():
            np.testing.assert_allclose(shadow[key].numpy(), p.numpy(),
                                       atol=PARAM_ATOL_DDP, err_msg=key)


@pytest.mark.parametrize("name", sorted(RESUMES))
def test_checkpoint_resumes_on_another_mesh(runs, name):
    _, _, ranks, _ = runs
    source, mesh = RESUMES[name]
    for r in ranks:
        assert r[name]["mesh"]["fsdp"] == MESHES[mesh].get("fsdp", 1)
        np.testing.assert_allclose(r[name]["steps"],
                                   ranks[0][source]["steps"][2:], rtol=1e-5)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_checkpoint_resumes_in_one_process(runs, name):
    tmp, _, ranks, _ = runs
    ckpt = Path(ranks[0][name]["run_dir"]) / "checkpoint-epoch1"
    from pytorch_distributed_template_tpu_torch import train as ttrain

    steps = []

    def hook(trainer):
        real = trainer.train_step

        class Step:
            def __call__(self, batch):
                m = real(batch)
                steps.append(float(m["loss_sum"]) / max(float(m["count"]),
                                                        1.0))
                return m

            def __getattr__(self, key):
                return getattr(real, key)

        trainer.train_step = Step()
        assert trainer.ddp is None and not trainer.model.placements

    ttrain.main(["-r", str(ckpt), "--device", "cpu", "-s",
                 str(tmp / f"one_{name}"), "--set", "mesh;axes",
                 json.dumps({"data": 1}), "--set",
                 "train_loader;args;batch_size", str(GLOBAL_BATCH), "--set",
                 "valid_loader;args;batch_size", str(GLOBAL_BATCH)],
                on_trainer=hook)
    np.testing.assert_allclose(steps, ranks[0][name]["steps"][2:],
                               rtol=1e-5)


def test_save_outputs_on_tensor_writes_full_vocab_rows(runs):
    from pytorch_distributed_template_tpu_torch import test as test_cli

    tmp, _, ranks, _ = runs
    out = tmp / "outputs"
    # one data shard: written once, by tensor index 0
    assert sorted(p.name for p in out.iterdir()) == [
        "outputs_p0.npy", "targets_p0.npy"]
    best = Path(ranks[0]["llama_tensor4"]["run_dir"]) / "model_best"
    one = test_cli.main(["-r", str(best), "--device", "cpu",
                         "--set", "mesh;axes", json.dumps({"data": 1}),
                         "--save-outputs", str(tmp / "one_outputs")])
    for r in ranks:
        np.testing.assert_allclose(r["llama_tensor4"]["test"]["loss"],
                                   one["loss"], rtol=1e-5)
    got = np.load(out / "outputs_p0.npy")
    want = np.load(tmp / "one_outputs" / "outputs_p0.npy")
    assert got.shape == want.shape and got.shape[-1] == 256
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(np.load(out / "targets_p0.npy"),
                                  np.load(tmp / "one_outputs"
                                          / "targets_p0.npy"))


def test_lenet_resumes_onto_data_fsdp(runs):
    _, _, ranks, straight = runs
    run = ranks[0]["lenet"]
    assert run["mesh"]["fsdp"] == 2 and run["shard"] == [0, 4]
    assert [r["lenet"]["shard"] for r in ranks] == [[i, 4] for i in
                                                    range(WORLD)]
    assert {a for a, _ in run["placements"].values()} == {"fsdp"}
    assert len(run["steps"]) == 512 // 64
    disk = torch.load(Path(run["run_dir"]) / "checkpoint-epoch2"
                      / "model.pt")
    assert sorted(disk) == sorted(straight)
    for key, p in straight.items():
        np.testing.assert_allclose(disk[key].numpy(), p.numpy(), rtol=2e-3,
                                   atol=2e-4, err_msg=key)


def test_dropout_masks_follow_the_batch_rows(runs):
    """Dropout 0.1: every rank of a tensor row draws the masks one process
    draws over the whole batch (the same losses); a data x fsdp rank draws
    the masks of the data-4 rank at its batch index."""
    tmp, _, ranks, _ = runs
    from pytorch_distributed_template_tpu_torch import train as ttrain

    steps = []

    def hook(trainer):
        trainer.model.load_state_dict(torch.load(tmp / "lm_tensor4.init.pt"))
        real = trainer.train_step

        class Step:
            def __call__(self, batch):
                m = real(batch)
                steps.append(float(m["loss_sum"]) / max(float(m["count"]),
                                                        1.0))
                return m

            def __getattr__(self, key):
                return getattr(real, key)

        trainer.train_step = Step()

    path = tmp / "dropout_one.json"
    path.write_text(json.dumps(_config("dropout_tensor4", ranks=False)))
    ttrain.main(["-c", str(path), "--device", "cpu", "-s",
                 str(tmp / "dropout_one")], on_trainer=hook)
    undropped = ranks[0]["lm_tensor4"]["steps"]
    for r in ranks:
        got = r["dropout_tensor4"]["steps"]
        np.testing.assert_allclose(got, steps, rtol=1e-5)
        np.testing.assert_allclose(r["dropout_data2_fsdp2"]["steps"],
                                   r["dropout_data4"]["steps"], rtol=1e-5)
        assert r["dropout_data4"]["ddp"]
    # the masks acted
    assert max(abs(a - b) for a, b in zip(steps, undropped)) > 1e-4
