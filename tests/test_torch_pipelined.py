"""The port's pipelined LMs (models/pipelined.py) against the JAX package's,
on the CPU, without a pipe axis (the sequential trunk; the schedule over
ranks is tests/test_torch_pipe_ranks.py).

- ``TinyPipeLM`` (GPipe and circular, remat), ``GPT2Pipelined`` cut by
  overrides (circular, fused head) and ``LlamaPipelined`` (4/2 GQA heads,
  plain and fused head): params from the flax module's init through
  ``models/convert.py::params_from_flax``; logits (or the fused pair) and
  the gradients of the next-token loss against ``jax.grad``. Tolerances:
  forward atol 2e-5; gradients atol 2e-5 + rtol 2e-4 (float32, summation
  orders differ through four layers, attention and the loss), the init
  law's standard deviations within 5%.
- ``stack_dense_params`` / ``stack_dense_llama_params`` over the port's
  dense ``TinyLM`` / ``TinyLlama`` state dicts: equal to the JAX
  functions on the same weights (exact), the pipelined model's loss equal
  to the dense model's (rtol 1e-5), and JAX's refusals (an untied head,
  non-contiguous layers, ``n_layer % (S * V)``).
- The port's ``Trainer`` on ``configs/gpt2_pp.json`` cut by ``--set`` to a
  tiny width (4 layers, d_model 64, 4 heads, vocab 256, T 32, float32,
  n_stages 2 x n_chunks 2, batch 8 with the config's ``grad_accum_steps``
  2: pieces of 4 in 4 microbatches; remat and the fused head as the config
  has them; the mesh cut to one data rank) against the JAX ``Trainer`` on
  the same cut config and one device: one epoch of 4 steps and a
  validation pass, epoch logs rtol 1e-5, final params atol
  ``PARAM_ATOL_DDP``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_template_tpu.config import (
    ConfigParser as JConfigParser, LOADERS as JLOADERS,
    METRICS as JMETRICS, MODELS as JM,
)
import pytorch_distributed_template_tpu.data  # noqa: F401  (register)
import pytorch_distributed_template_tpu.engine  # noqa: F401
import pytorch_distributed_template_tpu.models  # noqa: F401
from pytorch_distributed_template_tpu.engine import Trainer as JTrainer
from pytorch_distributed_template_tpu.engine import losses as jlosses
from pytorch_distributed_template_tpu.engine.losses import (
    resolve_loss as jresolve_loss,
)
from pytorch_distributed_template_tpu.models import pipelined as jpipelined
from pytorch_distributed_template_tpu.parallel.mesh import build_mesh
import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TM,
)
from pytorch_distributed_template_tpu_torch.engine import losses as tlosses
from pytorch_distributed_template_tpu_torch.models import pipelined
from pytorch_distributed_template_tpu_torch.models.convert import (
    flax_from_params, params_from_flax,
)

from test_torch_accum_ema import (  # noqa: F401
    PARAM_ATOL_DDP, _process_signal_handlers,
)
from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401
from test_torch_real_configs import _cut, _port_run

FWD_ATOL = 2e-5
GRAD_TOL = dict(atol=2e-5, rtol=2e-4)
TINY = dict(vocab_size=96, n_layer=4, n_head=4, d_model=64, max_len=32,
            n_stages=2, n_microbatches=2)
MODELS = {
    "tiny": ("TinyPipeLM", dict(TINY)),
    "tiny_circular_remat": ("TinyPipeLM", dict(TINY, n_chunks=2,
                                               remat=True)),
    "gpt2_circular_fused": ("GPT2Pipelined", dict(
        vocab_size=96, max_len=32, n_stages=2, n_microbatches=4,
        n_chunks=2, bfloat16=False, remat=False, n_layer=4, n_head=4,
        d_model=64)),
    "llama_gqa": ("LlamaPipelined", dict(
        vocab_size=96, n_layer=4, n_head=4, n_kv_head=2, d_model=64,
        max_len=32, n_stages=2, n_microbatches=2, remat=False,
        fused_head=False, bfloat16=False)),
    "llama_gqa_fused_circular": ("LlamaPipelined", dict(
        vocab_size=96, n_layer=4, n_head=4, n_kv_head=2, d_model=64,
        max_len=32, n_stages=2, n_microbatches=2, n_chunks=2,
        bfloat16=False)),
}
PP_CUT = {"arch;args;n_layer": 4, "arch;args;d_model": 64,
          "arch;args;n_head": 4, "arch;args;vocab_size": 256,
          "arch;args;max_len": 32, "arch;args;n_stages": 2,
          "arch;args;n_chunks": 2, "arch;args;n_microbatches": 4,
          "arch;args;bfloat16": False, "mesh;axes": {"data": 1},
          "train_loader;args;n": 32, "valid_loader;args;n": 16,
          "train_loader;args;seq_len": 32, "valid_loader;args;seq_len": 32,
          "train_loader;args;vocab_size": 256,
          "valid_loader;args;vocab_size": 256,
          "train_loader;args;batch_size": 8,
          "valid_loader;args;batch_size": 8,
          "trainer;epochs": 1, "trainer;tensorboard": False}
KEYS = ("loss", "lm_token_accuracy", "val_loss", "val_lm_token_accuracy")


def _tokens(b=4, t=24, vocab=96, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def _pair(name, args, seed=0):
    jm = JM.get(name)(**args)
    params = jm.init(jax.random.key(seed), jnp.asarray(_tokens()))["params"]
    tm = TM.get(name)(**args, device="cpu")
    tm.load_state_dict(params_from_flax(jax.device_get(params)),
                       strict=True)
    return jm, params, tm


@pytest.mark.parametrize("key", sorted(MODELS))
def test_logits_and_grads_match_flax(key):
    name, args = MODELS[key]
    jm, params, tm = _pair(name, args)
    fused = bool(tm.fused_head)
    toks = _tokens()
    jcrit = jlosses.fused_lm_cross_entropy(8) if fused \
        else jlosses.lm_cross_entropy
    tcrit = tlosses.fused_lm_cross_entropy(8) if fused \
        else tlosses.lm_cross_entropy
    jout = jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        params, jnp.asarray(toks))
    tout = tm(torch.tensor(toks))
    for j, t in zip(jout if fused else (jout,), tout if fused else (tout,)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=FWD_ATOL)
    jgrads = jax.jit(jax.grad(lambda p: jcrit(
        jm.apply({"params": p}, jnp.asarray(toks)),
        jnp.asarray(toks)).mean()))(params)
    tcrit(tout, torch.tensor(toks).long()).mean().backward()
    want = params_from_flax(jax.device_get(jgrads))
    for pname, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[pname].numpy(),
                                   err_msg=pname, **GRAD_TOL)


@pytest.mark.parametrize("name, args", [
    ("TinyPipeLM", dict(n_chunks=2)),
    ("LlamaPipelined", dict(n_layer=4, d_model=64, n_head=4, n_kv_head=2,
                            vocab_size=96, n_stages=2, n_chunks=2))])
def test_init_law_and_names_equal_flax(name, args):
    """The same parameter names, shapes and init scales as the flax
    module (tested on the standard deviation of each draw)."""
    jm = JM.get(name)(**args)
    want = jax.device_get(jm.init(jax.random.key(0), jnp.asarray(
        _tokens()))["params"])
    tm = TM.get(name)(**args, device="cpu")
    tm.init_weights(torch.Generator().manual_seed(0))
    got = flax_from_params(tm.state_dict())
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        sd_want, sd_got = float(np.std(v)), float(np.std(got[k]))
        assert abs(sd_got - sd_want) <= 0.05 * max(sd_want, 1e-12), k
        if sd_want == 0:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def _dense(name, args, seed=1):
    m = TM.get(name)(**args, device="cpu")
    m.init_weights(torch.Generator().manual_seed(seed))
    return m


@pytest.mark.parametrize("family, S, V", [("gpt2", 1, 1), ("gpt2", 2, 2),
                                          ("llama", 1, 1), ("llama", 2, 2)])
def test_stack_dense_equals_jax_and_keeps_the_loss(family, S, V):
    toks = torch.tensor(_tokens(b=4, t=16))
    if family == "gpt2":
        dense = _dense("TinyLM", dict(vocab_size=96, n_layer=4, n_head=4,
                                      d_model=64, max_len=32))
        got = pipelined.stack_dense_params(dense.state_dict(), S, V)
        want = jpipelined.stack_dense_params(
            flax_from_params(dense.state_dict()), S, V)
        pipe = TM.get("TinyPipeLM")(vocab_size=96, n_layer=4, n_head=4,
                                    d_model=64, max_len=32, n_stages=S,
                                    n_chunks=V, device="cpu")
    else:
        dense = _dense("TinyLlama", dict(vocab_size=96, n_layer=4, n_head=4,
                                         n_kv_head=2, d_model=64,
                                         max_len=32))
        got = pipelined.stack_dense_llama_params(dense.state_dict(), S, V)
        want = jpipelined.stack_dense_llama_params(
            flax_from_params(dense.state_dict()), S, V)
        pipe = TM.get("LlamaPipelined")(
            vocab_size=96, n_layer=4, n_head=4, n_kv_head=2, d_model=64,
            max_len=32, n_stages=S, n_chunks=V, fused_head=False,
            bfloat16=False, remat=False, device="cpu")
    want = params_from_flax(jax.device_get(want))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    pipe.load_state_dict(got)
    with torch.no_grad():
        a = tlosses.lm_cross_entropy(dense(toks), toks.long()).mean()
        b = tlosses.lm_cross_entropy(pipe(toks), toks.long()).mean()
    np.testing.assert_allclose(float(b), float(a), rtol=1e-5)


def test_stack_dense_refusals_equal_jax():
    untied = _dense("TinyLM", dict(vocab_size=96, n_layer=4, n_head=4,
                                   d_model=64, max_len=32,
                                   tie_embeddings=False)).state_dict()
    with pytest.raises(ValueError, match="untied lm_head"):
        pipelined.stack_dense_params(untied)
    with pytest.raises(ValueError, match="untied lm_head"):
        jpipelined.stack_dense_params(flax_from_params(untied))
    sd = _dense("TinyLM", dict(vocab_size=96, n_layer=4, n_head=4,
                               d_model=64, max_len=32)).state_dict()
    gap = {k: v for k, v in sd.items() if not k.startswith("h.1.")}
    with pytest.raises(ValueError, match="non-contiguous"):
        pipelined.stack_dense_params(gap)
    with pytest.raises(ValueError, match="non-contiguous"):
        jpipelined.stack_dense_params(flax_from_params(gap))
    with pytest.raises(ValueError, match="not divisible"):
        pipelined.stack_dense_params(sd, 4, 3)
    llama = _dense("TinyLlama", dict(vocab_size=96, n_layer=4, n_head=4,
                                     n_kv_head=2, d_model=64,
                                     max_len=32)).state_dict()
    with pytest.raises(ValueError, match="not divisible"):
        pipelined.stack_dense_llama_params(llama, 4, 3)
    with pytest.raises(ValueError, match="non-contiguous"):
        pipelined.stack_dense_llama_params(
            {k: v for k, v in llama.items() if not k.startswith("layers.0.")})


def _jax_trainer_run(cfg, tmp):
    cfg = json.loads(json.dumps(cfg))
    cfg["trainer"]["save_dir"] = str(tmp / "jax")
    config = JConfigParser(cfg, run_id="jax", training=True)
    logs = []
    trainer = JTrainer(
        config.init_obj("arch", JM), jresolve_loss(config["loss"]),
        [JMETRICS.get(m) for m in config["metrics"]], config=config,
        train_loader=config.init_obj("train_loader", JLOADERS),
        valid_loader=config.init_obj("valid_loader", JLOADERS),
        mesh=build_mesh({"data": 1}, jax.devices()[:1]), seed=0)
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


def test_gpt2_pp_config_trains_as_the_jax_trainer(tmp_path):
    cfg = _cut("gpt2_pp.json", PP_CUT)
    first, last, jlogs = _jax_trainer_run(cfg, tmp_path)
    logs, trainer = _port_run(cfg, tmp_path / "port", first)
    assert trainer.ddp is None and not trainer.model.placements
    assert trainer.train_step.grad_accum_steps == 2
    assert trainer.model.remat and trainer.model.fused_head
    assert len(logs) == len(jlogs) == 1
    for key in KEYS:
        np.testing.assert_allclose(logs[0][key], jlogs[0][key], rtol=1e-5,
                                   err_msg=key)
    state = trainer.model.state_dict()
    for name, p in last.items():
        np.testing.assert_allclose(state[name].numpy(), p.numpy(),
                                   atol=PARAM_ATOL_DDP, err_msg=name)
