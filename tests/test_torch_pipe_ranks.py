"""Pipeline parallelism across processes on the CPU: one spawn of 4 gloo
ranks.

In that spawn each rank first runs ``parallel.pipeline.pipeline_apply`` on
a pipe axis of 4 (GPipe and circular, M = 6 with a partial last round,
and M = 8) over the same seeded inputs, forward and backward (each rank's
loss ``sum(y ** 2) / S``: the output sum's backward adds the S ranks'
cotangents), and reports the outputs, its stage's gradients and the
permutes it made. Then the port's ``train.py`` trains
``configs/gpt2_pp.json`` cut by ``--set`` to a tiny width (4 layers,
d_model 64, 4 heads, vocab 256, T 32, float32, 2 epochs of 6 steps over a
global batch of 8 with the config's ``grad_accum_steps`` 2, the clip
lowered to 0.1 so that it acts, ``skip_nonfinite``, ``log_grad_norm``,
``ema_decay`` 0.9, an interval save every 4 steps, the health summary
on): once on ``{"pipe": 4, "data": 1}`` (GPipe), once on ``{"pipe": 2,
"data": 2}`` (``n_chunks`` 2, ``n_stages`` 2); after the second, the
port's ``test.py --save-outputs`` on its ``model_best``. Then two short
legs on ``{"pipe": 2, "data": 2}`` with the GPipe layout: one
warm-started (``trainer.init_from``) from the pipe-4 run's
``model_best``, and one whose fault plan crashes every rank at step 3.

Held against JAX's ``pipeline_apply`` on 4 fake devices (outputs rtol/atol
1e-6, gradients rtol 1e-4, atol 1e-5), and against the same configs in
one process without a pipe axis (batch 8): per-step losses and grad norms
rtol 1e-5; the replicated parameters (``wte``, ``wpe``, ``lnf_*``)
bit-equal on every rank after every step; every rank of a data column
(one DDP group: the ranks sharing a pipe index) holding the same stage
slices, bit for bit, the two stages different; each rank holding 1/S of
each stacked tensor; the checkpoint the ranks wrote (whole tensors, one
process's files) resuming in one process at epoch 2 with the ranks'
epoch-2 losses (rtol 1e-5); ``test.py`` on 4 ranks writing one output file
per data shard equal to the one-process evaluation's rows (atol 1e-5) and
its loss (rtol 1e-5); the warm start giving each rank its slice of the
pipe-4 weights, bit for bit; the crash writing ``checkpoint-emergency``
with whole tensors (every rank gathers, rank 0 writes) equal to the one
a one-process run with the same fault writes (atol ``PARAM_ATOL_DDP``). Each process has
its own timeout and is killed on it.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_accum_ema import (  # noqa: F401
    PARAM_ATOL_DDP, _process_signal_handlers,
)
from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401
from test_torch_ddp import _free_port
from test_torch_pipeline import (
    CASES, FWD_TOL, GRAD_TOL, jax_reference,
)
from test_torch_real_configs import _cut

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 300
WORLD = 4
TINY = {"arch;args;n_layer": 4, "arch;args;d_model": 64,
        "arch;args;n_head": 4, "arch;args;vocab_size": 256,
        "arch;args;max_len": 32, "arch;args;n_microbatches": 4,
        "arch;args;bfloat16": False,
        "train_loader;args;n": 48, "valid_loader;args;n": 16,
        "train_loader;args;seq_len": 32, "valid_loader;args;seq_len": 32,
        "train_loader;args;vocab_size": 256,
        "valid_loader;args;vocab_size": 256,
        "trainer;epochs": 2, "trainer;save_period": 1,
        "trainer;tensorboard": False, "trainer;grad_clip_norm": 0.1,
        "trainer;skip_nonfinite": True, "trainer;log_grad_norm": True,
        "trainer;ema_decay": 0.9, "trainer;save_interval_steps": 4}
# name: (mesh, n_stages, n_chunks)
RUNS = {"pipe4": ({"pipe": 4, "data": 1}, 4, 1),
        "pipe2_data2": ({"pipe": 2, "data": 2}, 2, 2)}
# the short legs after them: pipe 2 x data 2, GPipe, one epoch
LEGS = {"warm": {"trainer;epochs": 1},
        "crash": {"trainer;epochs": 1, "trainer;faults": "crash@step:3"}}
REPLICATED = ("wte", "wpe", "lnf_g", "lnf_b")

CHILD = r"""
import hashlib, json, sys
import numpy as np
import torch
import torch.distributed as tdist
from pytorch_distributed_template_tpu_torch import test as test_cli
from pytorch_distributed_template_tpu_torch import train
from pytorch_distributed_template_tpu_torch.parallel import collectives, dist
from pytorch_distributed_template_tpu_torch.parallel.mesh import build_mesh
from pytorch_distributed_template_tpu_torch.parallel.pipeline import (
    pipeline_apply)

torch.set_num_threads(1)
spec, out = json.loads(sys.argv[1]), sys.argv[2]
dist.initialize("cpu")
rank = dist.process_index()
REPLICATED = ("wte", "wpe", "lnf_g", "lnf_b")


def sha(t):
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()
                          ).hexdigest()


def schedule():
    mesh = build_mesh({"pipe": 4})
    s = mesh.axis_index("pipe")
    got = []
    for (V, m), (W, b, x) in zip(spec["cases"], spec["inputs"]):
        W, b, x = (torch.tensor(np.asarray(a, np.float32)) for a in (W, b, x))
        W.requires_grad_(), b.requires_grad_()
        collectives.reset_counts()
        y = pipeline_apply(lambda p, v, r: torch.tanh(v @ p[0] + p[1]),
                           (W, b), x, mesh, n_chunks=V)
        fwd = collectives.P2P["ppermute"]
        ((y ** 2).sum() / 4).backward()
        got.append({"y": y.detach().tolist(), "gW": W.grad[s].tolist(),
                    "gb": b.grad[s].tolist(), "stage": s,
                    "ppermute_fwd": fwd,
                    "ppermute_bwd": collectives.P2P["ppermute"] - fwd,
                    "psum": collectives.P2P["psum"]})
    return got


result = {"rank": rank, "schedule": schedule()}
for name, argv in spec["runs"]:
    steps, box = [], {}
    if name == "warm":
        best = result["pipe4"]["run_dir"] + "/model_best"
        argv = argv + ["--set", "trainer;init_from", json.dumps(best)]

    def hook(trainer):
        box["trainer"] = trainer
        real = trainer.train_step
        params = dict(trainer.model.named_parameters())
        box["init"] = {k: sha(p) for k, p in params.items()}

        class Step:
            def __call__(self, batch):
                m = real(batch)
                count = max(float(m["count"]), 1.0)
                steps.append({
                    "loss": float(m["loss_sum"]) / count,
                    "grad_norm": float(m["grad_norm_sum"]) / count,
                    "replicated": {k: sha(params[k]) for k in REPLICATED}})
                return m

            def __getattr__(self, key):
                return getattr(real, key)

        trainer.train_step = Step()

    try:
        train.main(argv, on_trainer=hook)
    except RuntimeError as exc:       # the crash leg's injected fault
        result[name + "_error"] = type(exc).__name__
    t = box["trainer"]
    mesh = t.mesh
    result[name] = {
        "steps": steps, "mesh": mesh.sizes,
        "pipe": mesh.axis_index("pipe"), "data": mesh.axis_index("data"),
        "placements": sorted(t.model.placements),
        "shapes": {k: list(p.shape) for k, p in
                   t.model.named_parameters()},
        "stage_sha": {k: sha(p) for k, p in t.model.named_parameters()
                      if k in t.model.placements},
        "ddp_ranks": (None if t.ddp is None else
                      tdist.get_process_group_ranks(t.ddp.process_group)),
        "init_sha": box["init"], "run_dir": str(t.config.save_dir)}
    if name in spec["evaluate"]:
        result[name]["test"] = test_cli.main([
            "-r", str(t.config.save_dir / "model_best"), "--device", "cpu",
            "--save-outputs", spec["evaluate"][name]])
with open(f"{out}.rank{rank}.json", "w") as f:
    json.dump(result, f)
dist.shutdown()
"""


def _config(name, ranks: bool):
    mesh, stages, chunks = RUNS.get(name, RUNS["pipe2_data2"])
    if name in LEGS:
        chunks = 1
    data = mesh["data"] if ranks else 1
    return _cut("gpt2_pp.json", dict(
        TINY, **{"mesh;axes": mesh if ranks else {"data": 1},
                 "arch;args;n_stages": stages, "arch;args;n_chunks": chunks,
                 "train_loader;args;batch_size": 8 // data,
                 "valid_loader;args;batch_size": 8 // data},
        **LEGS.get(name, {})))


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


def _recorded(cfg, tmp, extra=()):
    """A one-process run of ``cfg`` (or of the argv ``extra``) recording
    each step's loss and grad norm."""
    from pytorch_distributed_template_tpu_torch import train as ttrain

    steps = []

    def hook(trainer):
        real = trainer.train_step

        class Step:
            def __call__(self, batch):
                m = real(batch)
                count = max(float(m["count"]), 1.0)
                steps.append({"loss": float(m["loss_sum"]) / count,
                              "grad_norm": float(m["grad_norm_sum"])
                              / count})
                return m

            def __getattr__(self, key):
                return getattr(real, key)

        trainer.train_step = Step()

    tmp.mkdir(parents=True, exist_ok=True)
    if cfg is not None:
        path = tmp / "config.json"
        path.write_text(json.dumps(cfg))
        extra = ["-c", str(path)]
    ttrain.main(list(extra) + ["--device", "cpu", "-s", str(tmp / "run")],
                on_trainer=hook)
    return steps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("piperanks")
    inputs, want = [], []
    from test_torch_pipeline import microbatches, stage_stack

    for V, m in CASES:
        W, b = stage_stack(4, V)
        inputs.append((W.tolist(), b.tolist(), microbatches(m).tolist()))
        want.append(jax_reference(V, m))
    spec = {"cases": CASES, "inputs": inputs, "runs": [],
            "evaluate": {"pipe2_data2": str(tmp / "outputs")}}
    for name in list(RUNS) + list(LEGS):
        path = tmp / f"{name}.json"
        path.write_text(json.dumps(_config(name, True)))
        spec["runs"].append((name, ["-c", str(path), "--device", "cpu",
                                    "-s", str(tmp / f"ranks_{name}")]))
    ranks = _launch(spec, tmp / "ranks")
    one = {name: _recorded(_config(name, False), tmp / f"one_{name}")
           for name in RUNS}
    return tmp, want, ranks, one


def test_schedule_on_four_ranks_equals_jax(runs):
    _, want, ranks, _ = runs
    for i, (V, m) in enumerate(CASES):
        y, (gW, gb) = want[i]
        ticks = -(-m // 4) * 4 * V + 3
        for r in ranks:
            got = r["schedule"][i]
            s = got["stage"]
            assert s == r["rank"]
            np.testing.assert_allclose(np.asarray(got["y"]), y, **FWD_TOL)
            np.testing.assert_allclose(np.asarray(got["gW"]), gW[s],
                                       **GRAD_TOL)
            np.testing.assert_allclose(np.asarray(got["gb"]), gb[s],
                                       **GRAD_TOL)
            # one permute per tick; the backward reverses every one whose
            # output a later tick read (all but the last)
            assert (got["ppermute_fwd"], got["ppermute_bwd"],
                    got["psum"]) == (ticks, ticks - 1, 2), (V, m, got)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_ranks_equal_one_process(runs, name):
    _, _, ranks, one = runs
    mesh, stages, _ = RUNS[name]
    want = one[name]
    assert len(want) == 12
    for r in ranks:
        run = r[name]
        assert run["mesh"] == dict(mesh, fsdp=1, seq=1, expert=1, tensor=1)
        got = run["steps"]
        assert len(got) == len(want)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose([s[key] for s in got],
                                       [s[key] for s in want], rtol=1e-5,
                                       err_msg=f"{name} rank {r['rank']}")
        # the clip acted
        assert min(s["grad_norm"] for s in got) > 0.1
        # every step's replicated params are the same bits on every rank
        assert [s["replicated"] for s in got] == [
            s["replicated"] for s in ranks[0][name]["steps"]]
        # this rank holds 1/S of each stacked tensor
        assert run["placements"] == sorted(
            k for k in run["shapes"] if k not in REPLICATED)
        assert run["shapes"]["qkv_k"][0] == (4 // stages if stages == 4
                                             else 1)


def test_ddp_averages_only_within_each_data_column(runs):
    """On pipe 2 x data 2 DDP runs over the data group (the ranks sharing
    a pipe index): a data column's ranks end with the same stage slices,
    bit for bit, and the two stages' slices differ. DDP over the world
    would average the stages' equal-shaped weights."""
    _, _, ranks, _ = runs
    by_stage = {}
    for r in ranks:
        run = r["pipe2_data2"]
        want = [q["rank"] for q in ranks
                if q["pipe2_data2"]["pipe"] == run["pipe"]]
        assert run["ddp_ranks"] == want
        by_stage.setdefault(run["pipe"], []).append(run["stage_sha"])
        assert r["pipe4"]["ddp_ranks"] is None      # data axis 1: no DDP
    for stage, shas in by_stage.items():
        assert len(shas) == 2 and shas[0] == shas[1], stage
    assert by_stage[0][0] != by_stage[1][0]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_ranks_checkpoint_resumes_in_one_process(runs, name):
    tmp, _, ranks, _ = runs
    run_dir = Path(ranks[0][name]["run_dir"])
    ckpt = run_dir / "checkpoint-epoch1"
    import torch

    state = torch.load(ckpt / "model.pt")
    assert tuple(state["qkv_k"].shape[:1]) == (
        (4,) if RUNS[name][2] == 1 else (RUNS[name][1],))
    steps = _recorded(None, tmp / f"resume_{name}", extra=[
        "-r", str(ckpt), "--set", "mesh;axes", json.dumps({"data": 1}),
        "--set", "train_loader;args;batch_size", "8",
        "--set", "valid_loader;args;batch_size", "8"])
    want = ranks[0][name]["steps"][6:]
    np.testing.assert_allclose([s["loss"] for s in steps],
                               [s["loss"] for s in want], rtol=1e-5)


def test_test_py_on_ranks_writes_one_file_per_data_shard(runs):
    from pytorch_distributed_template_tpu_torch import test as test_cli

    tmp, _, ranks, _ = runs
    out = tmp / "outputs"
    assert sorted(p.name for p in out.iterdir()) == [
        "outputs_p0.npy", "outputs_p1.npy", "targets_p0.npy",
        "targets_p1.npy"]
    best = Path(ranks[0]["pipe2_data2"]["run_dir"]) / "model_best"
    one = test_cli.main(["-r", str(best), "--device", "cpu",
                         "--set", "mesh;axes", json.dumps({"data": 1}),
                         "--set", "valid_loader;args;batch_size", "8",
                         "--save-outputs", str(tmp / "one_outputs")])
    for r in ranks:
        assert r["pipe2_data2"]["test"] == ranks[0]["pipe2_data2"]["test"]
        np.testing.assert_allclose(r["pipe2_data2"]["test"]["loss"],
                                   one["loss"], rtol=1e-5)
    # data shard i holds the rows i::2 of the evaluation order
    whole = np.load(tmp / "one_outputs" / "outputs_p0.npy")
    targets = np.load(tmp / "one_outputs" / "targets_p0.npy")
    for i in range(2):
        np.testing.assert_allclose(np.load(out / f"outputs_p{i}.npy"),
                                   whole[i::2], atol=1e-5)
        np.testing.assert_array_equal(np.load(out / f"targets_p{i}.npy"),
                                      targets[i::2])


def _sha(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()
                          ).hexdigest()


def test_init_from_gives_each_rank_its_slice(runs):
    """``init_from`` a pipe-4 run's whole tensors into pipe 2 x data 2:
    each rank starts from its stage's slice of them, bit for bit."""
    import torch

    _, _, ranks, _ = runs
    disk = torch.load(Path(ranks[0]["pipe4"]["run_dir"]) / "model_best"
                      / "model.pt")
    for r in ranks:
        run = r["warm"]
        stage = run["pipe"]
        for name, t in disk.items():
            if name in REPLICATED:
                want = t
            else:
                n = t.shape[0] // 2
                want = t[stage * n:(stage + 1) * n]
            assert run["init_sha"][name] == _sha(want), (r["rank"], name)


def test_crash_writes_a_whole_emergency_checkpoint(runs):
    """A fault that crashes every rank at step 3: every rank gathers,
    rank 0 writes ``checkpoint-emergency`` with the whole tensors, which
    hold the three steps taken (steps 0-2): a one-process run with the
    same fault writes the same tensors."""
    import torch

    from pytorch_distributed_template_tpu_torch import train as ttrain

    tmp, _, ranks, _ = runs
    assert all(r.get("crash_error") == "FaultInjected" for r in ranks)
    path = Path(ranks[0]["crash"]["run_dir"]) / "checkpoint-emergency"
    got = torch.load(path / "model.pt")
    state = json.loads((path.parent / "checkpoint-emergency.data_state.json"
                        ).read_text())
    assert state["global_step"] == 3 and state["emergency"]
    cfg_path = tmp / "crash_one.json"
    cfg_path.write_text(json.dumps(_config("crash", False)))
    from pytorch_distributed_template_tpu_torch.resilience import faults

    with pytest.raises(faults.FaultInjected):
        ttrain.main(["-c", str(cfg_path), "--device", "cpu",
                     "-s", str(tmp / "crash_one")])
    want = torch.load(next((tmp / "crash_one").rglob(
        "checkpoint-emergency")) / "model.pt")
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        assert got[name].shape == t.shape, name
        np.testing.assert_allclose(got[name].numpy(), t.numpy(),
                                   atol=PARAM_ATOL_DDP, err_msg=name)
