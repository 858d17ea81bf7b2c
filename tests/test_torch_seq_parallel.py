"""Sequence parallelism across processes on the CPU: one spawn of 4 gloo
ranks on a ``{"data": 2, "seq": 2}`` mesh (rank = data x 2 + seq).

In that spawn, each rank first runs the ring (contiguous flash, banded
flash with an edge block, zigzag einsum) and Ulysses (flash) over its seq
group on its shard of a seeded input, forward and backward, and holds the
output and the q/k/v gradients of its shard against the one-process path
over all the row's shards (the same per-step work, the exchange a list
rotation): the ``ppermute`` and ``all_to_all`` gradients, atol 1e-6. Then
the port's ``train.py`` trains ``configs/llama_swa_long.json`` and
``configs/gpt2_long.json``, each cut by ``--set`` to a tiny model (2
layers, d_model 64, 4 heads, 2 kv heads for Llama; T 64, window 16, so the
ring runs its band-edge tier; dropout 0, float32; per-data-shard batch 4
with the configs' ``grad_accum_steps`` 4) over a 1,720-byte corpus: 3
train steps and one validation pass, the mesh's seq axis 2 and data axis 2.

Held against the JAX package's ``Trainer`` with ``build_mesh({"data": 2,
"seq": 2}, jax.devices()[:4])`` on the same config (batch 8, its ring on
the fake devices), from the same params (``models/convert.py::
params_from_flax``, loaded through ``train.main``'s ``on_trainer`` hook):
the epoch's losses and metrics rtol 1e-5, the params after it atol
``PARAM_ATOL_DDP``; and against the same port config in one process with
a seq axis of 1 (batch 8): the same tolerances. Every rank logs the same
global numbers. Each process has its own timeout and is killed on it.

Then, in one process: the shards' parts of the LM losses and metrics
(plain and fused head, contig and zigzag shards) add up to JAX's values
(rtol 1e-5); the eval step counts a batch's examples at seq index 0 only;
the dropout masks of a row's shards differ, and a seq axis of 1 draws
them as without a mesh.
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
from pytorch_distributed_template_tpu.parallel.mesh import build_mesh

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
TIMEOUT_S = 300
WORLD = 4
CORPUS_BYTES = 1720      # 24 train rows of 64 (3 steps of 8), 2 val rows
TINY = {"arch;args;n_layer": 2, "arch;args;d_model": 64,
        "arch;args;n_head": 4, "arch;args;max_len": 64,
        "arch;args;bfloat16": False,
        "train_loader;args;seq_len": 64, "valid_loader;args;seq_len": 64,
        "trainer;epochs": 1, "trainer;tensorboard": False}
# name: (file, model cuts, the mesh cuts of the 4-rank run, of 1 process)
CONFIGS = {
    "llama_swa_long": ("llama_swa_long.json", {
        "arch;args;n_kv_head": 2, "arch;args;window": 16},
        {"mesh;axes;seq": 2}, {"mesh;axes;seq": 1}),
    "gpt2_long": ("gpt2_long.json", {"arch;args;dropout": 0.0},
                  {"mesh;axes;seq": 2},
                  {"mesh;axes;seq": 1, "mesh;axes;data": 1}),
}
KEYS = ("loss", "lm_token_accuracy", "val_loss", "val_lm_token_accuracy")

CHILD = r"""
import json, sys
import numpy as np
import torch
from pytorch_distributed_template_tpu_torch import train
from pytorch_distributed_template_tpu_torch.ops import attention as att
from pytorch_distributed_template_tpu_torch.parallel import dist
from pytorch_distributed_template_tpu_torch.parallel.mesh import build_mesh

torch.set_num_threads(1)
spec, out = json.loads(sys.argv[1]), sys.argv[2]
dist.initialize("cpu")
rank = dist.process_index()
mesh = build_mesh({"data": 2, "seq": 2})
d, s = mesh.axis_index("data"), mesh.axis_index("seq")
assert rank == d * 2 + s and mesh.axis_size("seq") == 2


def collectives():
    errors = {}
    rng = np.random.default_rng(5)
    full = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((2, 16, 4, 8), (2, 16, 2, 8), (2, 16, 2, 8), (2, 16, 4, 8))]
    for name, kw in (
            ("ring_flash", dict(block_impl="flash")),
            ("ring_flash_band", dict(block_impl="flash", window=5)),
            ("ring_zigzag", dict(layout="zigzag")),
            ("ulysses_flash", None)):
        row = [torch.tensor(x[d:d + 1]) for x in full]
        if kw is not None and kw.get("layout") == "zigzag":
            perm = att.zigzag_perm(16, 2)
            row = [x[:, perm] for x in row]
        leaves = [x.clone().requires_grad_() for x in row[:3]]
        shards = [list(x.chunk(2, dim=1)) for x in leaves]
        if kw is None:
            ref = att.ulysses_attention_shards(*shards, inner="flash")
        else:
            ref = att.ring_attention_shards(*shards, **kw)
        g = list(row[3].chunk(2, dim=1))
        torch.autograd.backward(ref, g)
        mine = [x.chunk(2, dim=1)[s].detach().clone().requires_grad_()
                for x in row[:3]]
        if kw is None:
            got = att.ulysses_attention(*mine, mesh, inner="flash")
        else:
            got = att.ring_attention(*mine, mesh, **kw)
        got.backward(g[s])
        errs = [float((got - ref[s]).abs().max())]
        for m, leaf in zip(mine, leaves):
            errs.append(float((m.grad - leaf.grad.chunk(2, dim=1)[s])
                              .abs().max()))
        errors[name] = errs
    return errors


result = {"rank": rank, "collectives": collectives()}
for name, argv, params in spec:
    logs, box = [], {}

    def hook(trainer):
        box["trainer"] = trainer
        trainer.model.load_state_dict(torch.load(params))
        real = trainer._train_epoch

        def record(epoch):
            log = real(epoch)
            logs.append(dict(log))
            return log

        trainer._train_epoch = record

    train.main(argv, on_trainer=hook)
    t = box["trainer"]
    if rank == 0:
        torch.save(t.model.state_dict(), f"{out}.{name}.pt")
    result[name] = {"logs": logs, "mesh": t.mesh.sizes,
                    "ddp": t.ddp is not None,
                    "shards": t.train_loader.sampler.state()["num_shards"],
                    "steps": len(t.train_loader)}
with open(f"{out}.rank{rank}.json", "w") as f:
    json.dump(result, f)
dist.shutdown()
"""


class _NoDropout(fnn.Dropout):
    def __call__(self, inputs, deterministic=None, rng=None):
        return inputs


def _config(name, corpus, ranks: bool, batch):
    file, sets, mesh_ranks, mesh_one = CONFIGS[name]
    return _cut(file, dict(TINY, **sets, **(mesh_ranks if ranks
                                             else mesh_one), **{
        "train_loader;args;data_dir": str(corpus),
        "valid_loader;args;data_dir": str(corpus),
        "train_loader;args;batch_size": batch,
        "valid_loader;args;batch_size": batch}))


def _jax_run(cfg, tmp):
    """The JAX ``Trainer`` on a data 2 x seq 2 mesh of 4 CPU devices: the
    initial and final params as port state dicts, the epoch log."""
    cfg = json.loads(json.dumps(cfg))
    cfg["trainer"]["save_dir"] = str(tmp / "jax")
    config = JConfigParser(cfg, run_id="jax", training=True)
    logs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn, "Dropout", _NoDropout)
        trainer = JTrainer(
            config.init_obj("arch", JMODELS), jresolve_loss(config["loss"]),
            [JMETRICS.get(m) for m in config["metrics"]], config=config,
            train_loader=config.init_obj("train_loader", JLOADERS),
            valid_loader=config.init_obj("valid_loader", JLOADERS),
            mesh=build_mesh({"data": 2, "seq": 2}, jax.devices()[:4]),
            seed=0)
        first = params_from_flax(jax.device_get(trainer.state.params))
        real = trainer._train_epoch

        def record(epoch):
            log = real(epoch)
            logs.append(dict(log))
            return log

        trainer._train_epoch = record
        trainer.train()
    return first, params_from_flax(jax.device_get(trainer.state.params)), \
        logs


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seqpar")
    corpus = tmp / "data"
    corpus.mkdir()
    rng = np.random.default_rng(0)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 7)))
             for _ in range(40)]
    text = b" ".join(words[i] for i in rng.integers(0, 40, 600))
    (corpus / "input.txt").write_bytes(text[:CORPUS_BYTES])
    jax_out, spec = {}, []
    for name in CONFIGS:
        first, last, logs = _jax_run(_config(name, corpus, True, 8), tmp)
        torch.save(first, tmp / f"{name}.init.pt")
        jax_out[name] = (first, last, logs)
        cfg_path = tmp / f"{name}.json"
        cfg_path.write_text(json.dumps(_config(name, corpus, True, 4)))
        spec.append((name, ["-c", str(cfg_path), "--device", "cpu", "-s",
                            str(tmp / f"ranks_{name}")],
                     str(tmp / f"{name}.init.pt")))
    ranks = _launch(spec, tmp / "ranks")
    one = {}
    for name in CONFIGS:
        cfg = _config(name, corpus, False, 8)
        logs, trainer = _port_run(cfg, tmp / f"one_{name}",
                                  jax_out[name][0])
        one[name] = (logs, {k: v.detach().clone() for k, v in
                            trainer.model.state_dict().items()})
    params = {name: torch.load(str(tmp / "ranks") + f".{name}.pt")
              for name in CONFIGS}
    return jax_out, ranks, params, one


def _close_logs(got, want, what):
    assert len(got) == len(want) == 1, what
    for key in KEYS:
        np.testing.assert_allclose(got[0][key], want[0][key], rtol=1e-5,
                                   err_msg=f"{what} {key}")


def _close_params(got, want, what):
    for name, p in want.items():
        np.testing.assert_allclose(got[name].numpy(), p.numpy(),
                                   atol=PARAM_ATOL_DDP,
                                   err_msg=f"{what} {name}")


def test_collectives_gradients_equal_one_process_path(runs):
    _, ranks, _, _ = runs
    for r in ranks:
        for name, errs in r["collectives"].items():
            assert max(errs) <= 1e-6, (r["rank"], name, errs)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_four_gloo_ranks_equal_jax_trainer(runs, name):
    jax_out, ranks, params, _ = runs
    for r in ranks:
        run = r[name]
        assert run["ddp"]
        assert run["mesh"] == {"pipe": 1, "data": 2, "fsdp": 1, "seq": 2,
                               "expert": 1, "tensor": 1}
        assert run["shards"] == 2 and run["steps"] == 3
        # every rank logs the same global numbers
        assert [{k: log[k] for k in KEYS} for log in run["logs"]] == [
            {k: log[k] for k in KEYS} for log in ranks[0][name]["logs"]]
    _close_logs(ranks[0][name]["logs"], jax_out[name][2], f"{name} vs JAX")
    _close_params(params[name], jax_out[name][1], f"{name} vs JAX")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_four_gloo_ranks_equal_one_process(runs, name):
    _, ranks, params, one = runs
    logs, state = one[name]
    _close_logs(ranks[0][name]["logs"], logs, f"{name} vs one process")
    _close_params(params[name], state, f"{name} vs one process")


# ---------------------------------------------------------------------------
# what a seq-sharded step must get right, one process
# ---------------------------------------------------------------------------

def _shards(t, s, layout):
    from pytorch_distributed_template_tpu_torch.ops.attention import (
        SeqShard, seq_positions,
    )

    return [SeqShard(torch.as_tensor(seq_positions(t, s, i, layout)), t, i)
            for i in range(s)]


@pytest.mark.parametrize("layout", ["contig", "zigzag"])
def test_shard_losses_add_up_to_jax(layout):
    """A shard's labels come from the whole row at global
    position + 1 (on a zigzag shard the next position is elsewhere), the
    row's last position has none and the divisor is the row's T - 1: the
    shards' parts of each example's loss and metrics add up to JAX's, on
    plain logits and on the fused head's (hidden, head_w)."""
    import jax.numpy as jnp

    from pytorch_distributed_template_tpu.engine import losses as jl
    from pytorch_distributed_template_tpu.engine import metrics as jm
    from pytorch_distributed_template_tpu_torch.engine import losses as tl
    from pytorch_distributed_template_tpu_torch.engine import metrics as tm

    b, t, v, d, s = 3, 32, 11, 6, 4
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    hidden = rng.standard_normal((b, t, d)).astype(np.float32)
    head = rng.standard_normal((d, v)).astype(np.float32)
    tokens = rng.integers(0, v, (b, t)).astype(np.int32)
    target = torch.tensor(tokens).long()
    fused_j, fused_t = jl.fused_lm_cross_entropy(8), \
        tl.fused_lm_cross_entropy(8)
    cases = {
        "lm_cross_entropy": (jl.lm_cross_entropy, tl.lm_cross_entropy,
                             False),
        "fused_lm_cross_entropy": (fused_j, fused_t, True),
        "lm_token_accuracy": (jm.lm_token_accuracy, tm.lm_token_accuracy,
                              False),
        "lm_token_accuracy_fused": (jm.lm_token_accuracy,
                                    tm.lm_token_accuracy, True),
        "lm_nll_fused": (jm.lm_nll, tm.lm_nll, True),
    }
    for name, (jfn, tfn, fused) in cases.items():
        if fused:
            want = jfn((jnp.asarray(hidden), jnp.asarray(head)),
                       jnp.asarray(tokens))
        else:
            want = jfn(jnp.asarray(logits), jnp.asarray(tokens))
        got = torch.zeros(b)
        for shard in _shards(t, s, layout):
            pos = shard.positions
            out = ((torch.tensor(hidden)[:, pos], torch.tensor(head))
                   if fused else torch.tensor(logits)[:, pos])
            got += tfn(out, target, shard=shard)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_example_count_is_the_data_axis():
    """Only the rank at seq index 0 counts a batch's real rows;
    the loss and metric sums stay every rank's."""
    from pytorch_distributed_template_tpu_torch.engine import losses as tl
    from pytorch_distributed_template_tpu_torch.engine import metrics as tm
    from pytorch_distributed_template_tpu_torch.engine.steps import (
        make_eval_step,
    )

    class Sharded(torch.nn.Module):
        def __init__(self, shard):
            super().__init__()
            self.shard = shard

        def seq_shard(self, t):
            return self.shard

        def forward(self, tokens):
            pos = self.shard.positions
            return torch.nn.functional.one_hot(tokens[:, pos], 5).float()

    tokens = torch.tensor([[1, 2, 3, 4, 0, 1, 2, 3]] * 3)
    batch = {"tokens": tokens, "mask": torch.tensor([True, True, False])}
    sums = []
    for shard in _shards(8, 2, "zigzag"):
        step = make_eval_step(Sharded(shard), tl.lm_cross_entropy,
                              [tm.lm_token_accuracy], input_key="tokens",
                              target_key="tokens")
        sums.append(step(batch))
    assert [float(m["count"]) for m in sums] == [2.0, 0.0]
    whole = tm.lm_token_accuracy(torch.nn.functional.one_hot(
        tokens, 5).float(), tokens)
    np.testing.assert_allclose(
        sum(float(m["lm_token_accuracy_sum"]) for m in sums),
        float(whole[:2].sum()), rtol=1e-6)


def test_dropout_masks_differ_per_seq_shard(monkeypatch):
    """Each seq rank folds its index into the dropout seed, so
    the shards of one row draw different masks; a seq axis of 1 leaves
    the seeds as without a mesh."""
    from pytorch_distributed_template_tpu_torch.config.registry import (
        MODELS,
    )
    from pytorch_distributed_template_tpu_torch.models import transformer
    from pytorch_distributed_template_tpu_torch.parallel.mesh import Mesh

    seeds = []
    real = transformer.dropout

    def record(x, rate, seed, training):
        seeds.append(seed)
        return real(x, rate, seed, training)

    monkeypatch.setattr(transformer, "dropout", record)
    # the attention itself is not under test here: no process group
    monkeypatch.setattr(transformer, "sequence_attention",
                        lambda q, k, v, *a, **kw: q)
    tokens = torch.zeros((1, 16), dtype=torch.long)
    runs = {}
    for label, mesh in (("none", None), ("seq1", Mesh({"seq": 1})),
                        ("rank0", Mesh({"seq": 2}, rank=0)),
                        ("rank1", Mesh({"seq": 2}, rank=1))):
        model = MODELS.get("TinyLM")(attn_impl="ring", dropout=0.5,
                                     mesh=mesh, device="cpu")
        model.train()
        seeds.clear()
        if mesh is None:
            model.attn_impl = "xla"
            for block in model.h:
                block.attn.attn_impl = "xla"
        model(tokens, dropout_seed=123)
        runs[label] = list(seeds)
    assert runs["seq1"] == runs["none"]
    assert len(runs["rank0"]) == len(runs["none"])
    assert not set(runs["rank0"]) & set(runs["rank1"])
    assert not set(runs["rank0"]) & set(runs["none"])
