"""MoE routing over a sharded batch: 2 gloo ranks on ``{"data": 2}``
against the JAX package's ``make_train_step`` on 2 fake CPU devices with
``batch_sharding``.

JAX's ``MoeMlp`` runs under SPMD on the global array: its capacity ``C =
ceil(k S cf / E)``, its slot-order fill and the aux loss's means are over
the global batch. The port routes each rank's tokens as one piece of that
batch (models/moe.py): the global ``S``, every rank's per-row,
per-expert counts all-gathered, each row's fill offset by the global rows
before it, the aux statistics summed over the batch group. Before that repair each rank
routed its own tokens alone; with dropped tokens and an aux loss the ranks
drifted from JAX.

Both ``TinyMoeLM`` (gelu experts, B5's plain version) and the tiny
``MixtralMoE`` of JAX's ``TestSparseLlama._make`` (swiglu experts) run 3
Adam steps at capacity factor 1.0 with top-2 (tokens drop) and aux weight
0.01, a padded example in the last batch; rank ``i`` of ``n`` holds the
global rows ``i::n``, as the port's sampler shards (so the global token
order is the one-process batch's, JAX's on one host). Held to JAX's
tolerances (``tests/test_moe.py``): each step's loss ``rtol=1e-4``, the
aux loss of each step's forward ``rtol=1e-4``, the params after 3 steps
``rtol=2e-3, atol=1e-5``. One spawn of 2 ranks; the
child script is shared with ``tests/test_torch_moe_ep_ranks.py``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pytorch_distributed_template_tpu.models  # noqa: F401  (register)
from pytorch_distributed_template_tpu.config.registry import (
    LOSSES as JLOSSES, MODELS as JMODELS,
)
from pytorch_distributed_template_tpu.engine.state import create_train_state
from pytorch_distributed_template_tpu.engine.steps import (
    make_train_step as jmake_train_step,
)
from pytorch_distributed_template_tpu.parallel.mesh import (
    build_mesh as jbuild_mesh,
)
from pytorch_distributed_template_tpu.parallel.sharding import (
    apply_rules as japply_rules, batch_sharding,
)

from pytorch_distributed_template_tpu_torch.models.convert import (
    params_from_flax,
)
from test_torch_ddp import _free_port

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 420
STEPS = 3
LR = 1e-3
LOSS_TOL = dict(rtol=1e-4)                  # JAX's own (tests/test_moe.py)
PARAM_TOL = dict(rtol=2e-3, atol=1e-5)
# name: (registry name, JAX kwargs, the port's extra kwargs, batch, seq)
MODELS = {
    "tiny_moe": ("TinyMoeLM", dict(vocab_size=128, n_layer=2, d_model=32,
                                   n_head=2, max_len=16, num_experts=4,
                                   top_k=2, capacity_factor=1.0,
                                   aux_loss_weight=0.01), {}, 8, 16),
    "mixtral": ("MixtralMoE", dict(vocab_size=64, n_layer=2, n_head=4,
                                   n_kv_head=2, d_model=32, d_ff=64,
                                   max_len=32, window=0, num_experts=4,
                                   top_k=2, capacity_factor=1.0,
                                   aux_loss_weight=0.01, bfloat16=False,
                                   attn_impl="xla", remat=False,
                                   fused_head=False),
                {"param_dtype": "float32"}, 8, 16),
}

CHILD = r"""
import json, sys
import numpy as np
import torch
import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch import train
from pytorch_distributed_template_tpu_torch.config.registry import (
    LOSSES, MODELS)
from pytorch_distributed_template_tpu_torch.engine.steps import (
    make_train_step)
from pytorch_distributed_template_tpu_torch.models.base import inject_mesh
from pytorch_distributed_template_tpu_torch.parallel import collectives
from pytorch_distributed_template_tpu_torch.parallel import dist
from pytorch_distributed_template_tpu_torch.parallel.mesh import (
    build_mesh, mesh_from_config)
from pytorch_distributed_template_tpu_torch.parallel.sharding import (
    gather_placed)

torch.set_num_threads(1)
spec, out = json.loads(sys.argv[1]), sys.argv[2]
dist.initialize("cpu")
rank = dist.process_index()
result = {"rank": rank}


def step_run(run):
    # the train step on explicit global batches: this rank's data shard
    # holds the global rows index::count, as the port's loaders shard
    mesh = build_mesh(mesh_from_config({"mesh": {"axes": run["axes"]}}))
    kw = dict(run["kw"])
    if "param_dtype" in kw:
        kw["param_dtype"] = getattr(torch, kw["param_dtype"])
    model = MODELS.get(run["model"])(**kw, device="cpu")
    model.load_state_dict(torch.load(run["params"]))
    inject_mesh(model, mesh)
    net = model
    if not mesh.model_parallel():
        net = torch.nn.parallel.DistributedDataParallel(
            model, broadcast_buffers=False)
    opt = torch.optim.Adam(model.parameters(), lr=run["lr"])
    step = make_train_step(net, opt, LOSSES.get("lm_cross_entropy"),
                           input_key="tokens", target_key="tokens",
                           lr_fn=lambda s: run["lr"], mesh=mesh)
    data = np.load(run["batches"])
    index, count = mesh.data_shard()
    steps, aux = [], []
    collectives.reset_counts()
    for tokens, mask in zip(data["tokens"], data["mask"]):
        part = slice(index, None, count)
        m = step({"tokens": torch.from_numpy(tokens[part]).long(),
                  "mask": torch.from_numpy(mask[part])})
        steps.append(float(m["loss_sum"]) / max(float(m["count"]), 1.0))
        aux.append(float(model.aux_loss))
    p2p = dict(collectives.P2P)
    whole = gather_placed(model, {k: v.detach() for k, v in
                                  model.state_dict().items()},
                          keep=rank == 0)
    if rank == 0:
        torch.save(whole, run["save"])
    return {"steps": steps, "aux": aux, "mesh": mesh.sizes,
            "ddp": net is not model, "p2p": p2p,
            "placements": {k: [pl.axis, pl.dim]
                           for k, pl in model.placements.items()},
            "shapes": {k: list(p.shape)
                       for k, p in model.named_parameters()}}


def train_run(argv):
    # the port's train.py; "@name": that run's checkpoint-epoch1
    argv = [result[a[1:]]["run_dir"] + "/checkpoint-epoch1"
            if a.startswith("@") else a for a in argv]
    steps, box = [], {}

    def hook(trainer):
        box["trainer"] = trainer
        real = trainer.train_step

        class Step:
            def __call__(self, batch):
                m = real(batch)
                steps.append(float(m["loss_sum"])
                             / max(float(m["count"]), 1.0))
                return m

            def __getattr__(self, key):
                return getattr(real, key)

        trainer.train_step = Step()

    train.main(argv, on_trainer=hook)
    t = box["trainer"]
    return {"steps": steps, "run_dir": str(t.config.save_dir),
            "mesh": t.mesh.sizes, "ddp": t.ddp is not None,
            "start_epoch": t.start_epoch}


for run in spec["runs"]:
    result[run["name"]] = (step_run(run) if "argv" not in run
                           else train_run(run["argv"]))
with open(f"{out}.rank{rank}.json", "w") as f:
    json.dump(result, f)
dist.shutdown()
"""


def launch(spec, out, world):
    """Run ``CHILD`` on ``world`` gloo ranks (one spawn; each process has
    its own timeout and is killed on it); every rank's result."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(rank),
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
            for r in range(world)]


def batches(name, seed=0):
    """``STEPS`` global batches of the model's shape; the last one's final
    example is padding."""
    _, kw, _, b, t = MODELS[name]
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, kw["vocab_size"], (STEPS, b, t)).astype(
        np.int32)
    mask = np.ones((STEPS, b), bool)
    mask[-1, -1] = False
    return tokens, mask


def jax_run(name, axes):
    """JAX's train step on a mesh of fake devices over the global batches:
    the initial and final params (port state dicts), each step's loss
    and the aux loss of each step's forward."""
    reg, kw, _, _, _ = MODELS[name]
    n = int(np.prod(list(axes.values())))
    mesh = jbuild_mesh(axes, jax.devices()[:n])
    model = JMODELS.get(reg)(**kw, mesh=mesh)
    tx = optax.adam(LR)
    state = create_train_state(model, tx, jnp.zeros((1, 16), jnp.int32),
                               seed=0)
    first = params_from_flax(jax.device_get(state.params))
    state = jax.device_put(state, japply_rules(state, mesh,
                                               model.partition_rules()))
    step = jax.jit(jmake_train_step(
        model, tx, JLOSSES.get("lm_cross_entropy"), input_key="tokens",
        target_key="tokens"))
    bs = batch_sharding(mesh)
    losses, aux = [], []
    for tokens, mask in zip(*batches(name)):
        batch = {"tokens": jax.device_put(tokens, bs),
                 "mask": jax.device_put(mask, bs)}
        _, coll = model.apply({"params": state.params}, batch["tokens"],
                              train=True, example_mask=batch["mask"],
                              mutable=["losses"])
        aux.append(sum(float(jnp.sum(a))
                       for a in jax.tree.leaves(coll["losses"])))
        state, m = step(state, batch)
        losses.append(float(m["loss_sum"]) / float(m["count"]))
    return first, params_from_flax(jax.device_get(state.params)), losses, \
        aux


def step_spec(name, tag, axes, tmp, first):
    """The child's spec of one step run: the initial params and batches
    written under ``tmp``."""
    reg, kw, extra, _, _ = MODELS[name]
    torch.save(first, tmp / f"{name}.init.pt")
    tokens, mask = batches(name)
    np.savez(tmp / f"{name}.batches.npz", tokens=tokens, mask=mask)
    return {"name": tag, "model": reg, "kw": dict(kw, **extra),
            "axes": axes, "params": str(tmp / f"{name}.init.pt"),
            "batches": str(tmp / f"{name}.batches.npz"), "lr": LR,
            "save": str(tmp / f"{tag}.final.pt")}


def assert_matches_jax(ranks, tag, want, tmp):
    """Every rank's losses and aux losses equal JAX's; rank 0's whole
    params after the last step equal JAX's."""
    _, last, losses, aux = want
    for r in ranks:
        got = r[tag]
        np.testing.assert_allclose(got["steps"], losses, **LOSS_TOL,
                                   err_msg=f"{tag} rank {r['rank']}")
        np.testing.assert_allclose(got["aux"], aux, **LOSS_TOL,
                                   err_msg=f"{tag} rank {r['rank']} aux")
    final = torch.load(tmp / f"{tag}.final.pt")
    assert sorted(final) == sorted(last)
    for key, value in last.items():
        np.testing.assert_allclose(final[key].numpy(), value.numpy(),
                                   **PARAM_TOL, err_msg=f"{tag} {key}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ranks")
    want, spec = {}, {"runs": []}
    for name in MODELS:
        want[name] = jax_run(name, {"data": 2})
        spec["runs"].append(step_spec(name, name, {"data": 2}, tmp,
                                      want[name][0]))
    return tmp, want, launch(spec, tmp / "ranks", 2)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_data_two_routes_globally_like_jax(runs, name):
    tmp, want, ranks = runs
    assert_matches_jax(ranks, name, want[name], tmp)
    for r in ranks:
        run = r[name]
        assert run["ddp"] and run["mesh"]["data"] == 2
        # one gather of the counts per MoE layer call (and its remat-free
        # backward none); the aux statistics' psum, forward and backward
        assert run["p2p"]["all_gather"] == STEPS * 2
        assert run["p2p"]["psum"] == STEPS * 2 * 2


def test_one_rank_alone_would_route_differently(runs):
    """The fault the repair removed, shown on the same data: routing each
    rank's rows alone (its own ``S``, fill and means) gives another loss
    or aux loss than JAX's global routing at this capacity."""
    from pytorch_distributed_template_tpu_torch.config.registry import (
        LOSSES as TLOSSES, MODELS as TMODELS,
    )

    _, want, _ = runs
    reg, kw, extra, _, _ = MODELS["tiny_moe"]
    first, _, losses, aux = want["tiny_moe"]
    model = TMODELS.get(reg)(**kw, device="cpu")
    model.load_state_dict(first)
    tokens, mask = batches("tiny_moe")
    crit = TLOSSES.get("lm_cross_entropy")
    total, count, aux_mean = 0.0, 0.0, 0.0
    model.train()
    with torch.no_grad():
        for half in (slice(0, None, 2), slice(1, None, 2)):
            x = torch.from_numpy(tokens[0][half]).long()
            m = torch.from_numpy(mask[0][half])
            out = model(x, example_mask=m)
            total += float((crit(out, x) * m.float()).sum()
                           + model.aux_loss * m.float().sum())
            count += float(m.float().sum())
            aux_mean += float(model.aux_loss) / 2
    local = total / count
    assert abs(local - losses[0]) > 1e-4 * abs(losses[0]) or \
        abs(aux_mean - aux[0]) > 1e-4 * aux[0]
