"""Checkpoint soups (``checkpoint/average.py``) against the JAX package's
``average_checkpoints`` on the CPU:

- uniform and weighted soups of three checkpoints built from the same
  arrays (a small ResNet's params and BatchNorm statistics, and an EMA)
  equal JAX's soup of its orbax checkpoints bit for bit (float64 sums in
  the same order, cast back to float32);
- mismatched trees, bad weights and an existing output are refused;
  every other file and the sidecars come from the last checkpoint, with
  the provenance in the meta;
- a soup of a real run (CIFAR's ResNet-18 cut tiny, with an EMA)
  evaluates through ``test.py`` with its BN buffers and EMA averaged, and
  a soup of one checkpoint evaluates exactly as that checkpoint (the CLI
  writes it).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from pytorch_distributed_template_tpu.checkpoint.average import (
    average_checkpoints as javerage,
)
from pytorch_distributed_template_tpu.models import resnet as jres

from pytorch_distributed_template_tpu_torch import test as ttest
from pytorch_distributed_template_tpu_torch import train as ttrain
from pytorch_distributed_template_tpu_torch.checkpoint import average
from pytorch_distributed_template_tpu_torch.models import convert
from test_torch_accum_ema import _process_signal_handlers  # noqa: F401
from test_torch_image_train import CIFAR, CIFAR_SETS, _argv


def _trees(n=3):
    jm = jres.ResNet(stage_sizes=(1,), block_cls=jres.BasicBlock,
                     num_classes=3, num_filters=4, cifar_stem=True,
                     input_shape=(8, 8, 3))
    v = jax.device_get(jm.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 8, 8, 3))))
    rng = np.random.default_rng(1)

    def moved(tree):
        return jax.tree.map(lambda x: (np.asarray(x) + rng.normal(
            size=np.shape(x))).astype(np.float32), tree)

    return [{"params": moved(v["params"]),
             "batch_stats": moved(v["batch_stats"]),
             "ema_params": moved(v["params"]), "step": np.int32(10 * i)}
            for i in range(n)]


def _write(trees, tmp):
    """The same trees as JAX orbax checkpoints and as port checkpoint
    directories (with sidecars and the files that are not averaged)."""
    ckptr = ocp.StandardCheckpointer()
    jpaths, tpaths = [], []
    for i, tree in enumerate(trees):
        jp = tmp / "jax" / f"checkpoint-epoch{i + 1}"
        ckptr.save(jp.resolve(), tree)
        ckptr.wait_until_finished()
        tp = tmp / "port" / f"checkpoint-epoch{i + 1}"
        tp.mkdir(parents=True)
        model = convert.params_from_flax(tree["params"])
        model.update(convert.batch_stats_from_flax(tree["batch_stats"]))
        torch.save(model, tp / "model.pt")
        torch.save(convert.params_from_flax(tree["ema_params"]),
                   tp / "ema.pt")
        torch.save({"marker": i}, tp / "optimizer.pt")
        (tp / "train_state.json").write_text(json.dumps({"step": 10 * i}))
        (tp.parent / f"{tp.name}.meta.json").write_text(json.dumps(
            {"epoch": i + 1, "arch": "ResNet"}))
        (tp.parent / f"{tp.name}.data_state.json").write_text(json.dumps(
            {"epoch": i + 1, "next_batch": 0}))
        jpaths.append(jp)
        tpaths.append(tp)
    return jpaths, tpaths


@pytest.mark.parametrize("weights", [None, [1.0, 3.0, 0.5]],
                         ids=["uniform", "weighted"])
def test_soup_equals_jax_bitwise(tmp_path, weights):
    trees = _trees()
    jpaths, tpaths = _write(trees, tmp_path)
    jout = javerage(jpaths, tmp_path / "jax" / "soup", weights)
    soup = ocp.StandardCheckpointer().restore(jout.resolve())
    out = average.average_checkpoints(tpaths, tmp_path / "port" / "soup",
                                      weights)
    want = convert.params_from_flax(jax.device_get(soup["params"]))
    want.update(convert.batch_stats_from_flax(
        jax.device_get(soup["batch_stats"])))
    got = torch.load(out / "model.pt")
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
        assert got[k].dtype == torch.float32
    ema = torch.load(out / "ema.pt")
    for k, w in convert.params_from_flax(
            jax.device_get(soup["ema_params"])).items():
        assert torch.equal(ema[k], w), k
    # every other file and the cursor are the last checkpoint's
    assert torch.load(out / "optimizer.pt") == {"marker": 2}
    assert json.loads((out / "train_state.json").read_text())["step"] == 20
    assert json.loads((out.parent / "soup.data_state.json").read_text())[
        "epoch"] == 3
    meta = json.loads((out.parent / "soup.meta.json").read_text())
    assert meta["epoch"] == 3 and len(meta["averaged_from"]) == 3
    np.testing.assert_allclose(sum(meta["average_weights"]), 1.0)


def test_refusals(tmp_path):
    trees = _trees(2)
    _, tpaths = _write(trees, tmp_path)
    with pytest.raises(FileExistsError):
        average.average_checkpoints(tpaths, tpaths[0])
    with pytest.raises(ValueError, match="bad weights"):
        average.average_checkpoints(tpaths, tmp_path / "w", [1.0, -1.0])
    with pytest.raises(ValueError, match="at least one"):
        average.average_checkpoints([], tmp_path / "none")
    model = torch.load(tpaths[0] / "model.pt")
    key = next(iter(model))
    model[key] = torch.zeros(3, 3)
    torch.save(model, tpaths[0] / "model.pt")
    with pytest.raises(ValueError, match="different 'model.pt' tree"):
        average.average_checkpoints(tpaths, tmp_path / "mismatch")
    assert not (tmp_path / "mismatch").exists()


def test_a_soup_of_a_run_evaluates(tmp_path):
    sets = CIFAR_SETS[:6] + [("trainer;save_period", 1),
                             ("trainer;ema_decay", 0.5)]
    box = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ttrain.main(_argv(CIFAR, tmp_path / "run", sets),
                    on_trainer=lambda t: box.update(t=t))
        run = box["t"].config.save_dir
        a, b = run / "checkpoint-epoch1", run / "checkpoint-epoch2"
        average.main([str(a), str(b), "-o", str(run / "soup")])
        average.main([str(b), "-o", str(run / "soup1")])

        def evaluate(ckpt):
            return ttest.main(["-r", str(ckpt), "--device", "cpu", "-s",
                               str(tmp_path / "t")])

        soup, one, two = (evaluate(run / "soup"), evaluate(run / "soup1"),
                          evaluate(b))
    finally:
        torch.set_num_threads(threads)
    assert one == two
    assert np.isfinite(soup["loss"]) and soup != two
    sa, sb = (torch.load(p / "model.pt") for p in (a, b))
    st = torch.load(run / "soup" / "model.pt")
    var = "bn_init.running_var"
    assert not torch.equal(sa[var], sb[var])
    torch.testing.assert_close(st[var], ((sa[var].double() + sb[var].double())
                                         / 2).float(), rtol=0, atol=0)
    ea, eb, es = (torch.load(p / "ema.pt") for p in (a, b, run / "soup"))
    k = next(iter(ea))
    torch.testing.assert_close(es[k], ((ea[k].double() + eb[k].double())
                                       / 2).float(), rtol=0, atol=0)
