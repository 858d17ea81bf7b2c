"""The port's generation stack (engine/generate.py, engine/serving.py,
generate.py, tools/make_serving_artifact.py, checkpoint/serving.py) on the
CPU, held against the JAX package's ``GenerationService`` on the same
weights.

Greedy ids and ``stop_reason`` must be identical; ``filter_logits`` masks
must be equal on the same numpy logits. Sampled tokens cannot match across
packages (threefry vs Philox), so sampling is held to reproducibility
within the port.
"""
import contextlib
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_distributed_template_tpu.models  # noqa: F401
from pytorch_distributed_template_tpu.config.registry import MODELS as JMODELS
from pytorch_distributed_template_tpu.engine import generate as jgen
from pytorch_distributed_template_tpu.engine.serving import (
    GenerationService as JService,
)
import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch import generate as tcli
from pytorch_distributed_template_tpu_torch.checkpoint import ArtifactCorrupt
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TMODELS,
)
from pytorch_distributed_template_tpu_torch.engine import generate as tgen
from pytorch_distributed_template_tpu_torch.engine.serving import (
    GenerationService as TService,
)
from pytorch_distributed_template_tpu_torch.models.convert import (
    params_from_flax,
)
from pytorch_distributed_template_tpu_torch.tools import (
    make_serving_artifact as tool,
)

KW = dict(vocab_size=256, n_layer=2, n_head=4, n_kv_head=2, d_model=64,
          max_len=128, attn_impl="flash", window=8)
PROMPT = [int(x) for x in np.random.default_rng(5).integers(0, 256, 10)]


@pytest.fixture(scope="module")
def services():
    jmodel = JMODELS.get("Llama")(**KW)
    params = jmodel.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))[
        "params"]
    params = jax.tree.map(np.asarray, params)
    tmodel = TMODELS.get("Llama")(**KW, device="cpu")
    tmodel.load_state_dict(params_from_flax(params))
    return (JService.from_model(jmodel, params),
            TService.from_model(tmodel, device="cpu"))


def test_service_greedy_matches_jax(services):
    jsvc, tsvc = services
    j = jsvc.generate(prompt_ids=PROMPT, max_new_tokens=12)
    t = tsvc.generate(prompt_ids=PROMPT, max_new_tokens=12)
    assert t["ids"] == j["ids"] and len(t["ids"]) == 12
    assert t["stop_reason"] == j["stop_reason"] == "length"
    assert t["text"] == j["text"]          # byte vocab: text round-trips


def test_service_greedy_with_stop_matches_jax(services):
    jsvc, tsvc = services
    free = tsvc.generate(prompt_ids=PROMPT, max_new_tokens=12)["ids"]
    stop = free[4]
    j = jsvc.generate(prompt_ids=PROMPT, max_new_tokens=12, stop=[stop])
    t = tsvc.generate(prompt_ids=PROMPT, max_new_tokens=12, stop=[stop])
    assert t["ids"] == j["ids"] == free[:free.index(stop)]
    assert t["stop_reason"] == j["stop_reason"] == "stop"


def test_generate_row_budgets_and_lengths(services):
    _, tsvc = services
    prompt = torch.tensor([PROMPT, PROMPT[::-1]])
    out, lengths = tgen.generate(tsvc.model, prompt, 6, temperature=0.0,
                                 row_budgets=[2, 6], pad_id=0,
                                 return_lengths=True)
    free = tgen.generate(tsvc.model, prompt, 6, temperature=0.0)
    assert lengths.tolist() == [2, 6]
    assert out[0, 10:12].tolist() == free[0, 10:12].tolist()
    assert out[0, 12:].tolist() == [0] * 4
    assert out[1].tolist() == free[1].tolist()


@pytest.mark.parametrize("temperature, top_k, top_p", [
    (1.0, 5, 0.0), (0.7, 0, 0.9), (1.3, 10, 0.8), (0.5, 0, 0.5),
])
def test_filter_logits_masks_match_jax(temperature, top_k, top_p):
    logits = np.random.default_rng(7).normal(size=(4, 64)).astype(
        np.float32) * 3
    j = np.asarray(jgen.filter_logits(jnp.asarray(logits), temperature,
                                      top_k, top_p))
    t = tgen.filter_logits(torch.from_numpy(logits), temperature, top_k,
                           top_p).numpy()
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j))
    np.testing.assert_allclose(t[np.isfinite(t)], j[np.isfinite(j)],
                               rtol=1e-6)


def test_seeded_sampled_request_is_reproducible(services):
    _, tsvc = services
    kw = dict(prompt_ids=PROMPT, max_new_tokens=12, temperature=0.8,
              top_p=0.95, seed=1)
    a, b = tsvc.generate(**kw), tsvc.generate(**kw)
    assert a == b
    assert all(0 <= i < 256 for i in a["ids"]) and len(a["ids"]) == 12


def test_service_refuses_later_slices(services):
    _, tsvc = services
    # speculative decoding is ported: a rolling-window cache (window 8)
    # cannot rewind a rejected draft, as in JAX
    with pytest.raises(ValueError, match="non-rolling cache"):
        tsvc.generate(prompt_ids=PROMPT, speculative=3)
    with pytest.raises(ValueError, match="max_len"):
        tsvc.generate(prompt_ids=PROMPT, max_new_tokens=200)
    with pytest.raises(ValueError):
        tsvc.generate(prompt_ids=[1, 999])


def test_device_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    model = TMODELS.get("TinyLlama")(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TService.from_model(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.make_artifact("/nonexistent-never-written", arch="TinyLlama")


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    out = tmp_path_factory.mktemp("art")
    assert tool.main(["-o", str(out), "--arch", "TinyLlama", "--d-model",
                      "64", "--window", "8", "--seed", "3", "--device",
                      "cpu"]) == 0
    return out


def test_generate_cli_runs_on_cpu(artifact, tmp_path):
    # stdout is redirected rather than taken with capsys: the CLI's logging
    # setup shuts down absl's handler (installed by the JAX import), which
    # closes the stream it holds unless that is the current sys.stderr
    argv = ["-r", str(artifact / "model"), "--prompt-ids",
            ",".join(map(str, PROMPT)), "--max-new-tokens", "12",
            "--device", "cpu", "-s", str(tmp_path)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        resp = tcli.main(argv)
    printed = buf.getvalue().strip().splitlines()[-1]
    assert printed == ",".join(str(i) for i in resp["ids"])
    assert len(resp["ids"]) == 12
    # same artifact, same request: the CLI is deterministic when greedy
    assert tcli.main(argv)["ids"] == resp["ids"]
    text = tcli.main(["-r", str(artifact / "model"), "--prompt", "hi",
                      "--max-new-tokens", "4", "--device", "cpu", "-s",
                      str(tmp_path)])
    assert len(text["ids"]) == 4 and "text" in text


def test_generate_cli_default_device_raises_without_cuda(artifact,
                                                         tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["-r", str(artifact / "model"), "--prompt-ids", "1,2",
                   "-s", str(tmp_path)])


def test_artifact_round_trip_and_corruption(artifact, tmp_path):
    import json
    import shutil

    from pytorch_distributed_template_tpu_torch.checkpoint import (
        load_serving_meta, restore_serving_params,
    )

    meta = load_serving_meta(artifact / "model")
    assert meta["params_only"] and meta["arch"] == "TinyLlama"
    cfg = json.loads((artifact / "config.json").read_text())
    assert cfg["arch"] == {"type": "TinyLlama",
                           "args": {"d_model": 64, "window": 8}}
    state = restore_serving_params(artifact / "model", "cpu")
    assert state["embed_tokens.weight"].shape == (256, 64)
    bad = tmp_path / "bad"
    shutil.copytree(artifact, bad)
    params = bad / "model" / "params.pt"
    params.write_bytes(params.read_bytes()[:-16])
    with pytest.raises(ArtifactCorrupt, match="params.pt"):
        restore_serving_params(bad / "model", "cpu")


def test_prefix_cache_config_serves_cold(services, caplog):
    _, tsvc = services
    with caplog.at_level("WARNING"):
        svc = TService.from_model(tsvc.model, device="cpu",
                                  prefix_cache={"enabled": True})
    assert "prefix cache disabled" in caplog.text
    assert svc.generate(prompt_ids=PROMPT, max_new_tokens=12)["ids"] == \
        tsvc.generate(prompt_ids=PROMPT, max_new_tokens=12)["ids"]
