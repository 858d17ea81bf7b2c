"""The sparse Llama family (``MixtralMoE``: swiglu experts in the Llama
blocks) of the port against the JAX package's, on the CPU, float32.

- ``MoeMlp(expert_act="swiglu")`` against JAX's, both dispatch arms, top-1
  and top-2, at a capacity that drops tokens: outputs and the aux loss
  (atol 2e-5 + rtol 1e-4), gradients of the input and of every leaf
  (atol 2e-5 + rtol 2e-4); the stacked gate ``wg`` exists and the gelu
  biases do not.
- The tiny ``MixtralMoE`` of JAX's ``TestSparseLlama._make`` (capacity 1.0
  so that tokens drop): logits, the summed aux loss (remat off and on),
  and a 3-step trajectory through both ``Trainer``s on
  ``configs/llama_debug.json`` with the model swapped (epoch losses rtol
  1e-4, final params atol 1e-4).
- Cached decode with a rolling window of 8 equal to the full forward (JAX's
  ``test_cached_decode_logit_parity``, atol 1e-5).
- Greedy ids of the batch-1 service (capacity 1.0: prefill drops tokens)
  and of the continuous engine over the paged pool (concurrent requests
  sharing a prefix; capacity 4.0, JAX's own test model, where batching
  cannot change a route) identical to JAX's services; at capacities that
  drop tokens (0.5, and Mixtral's 1.25), requests one after another with
  idle rows give JAX's continuous engine's ids (admissions padded to its
  shape; the padding rows write nothing).
- The converter's round trip bit-equal; the registry's defaults equal to
  JAX's ``mixtral_moe``; the artifact tool makes a Mixtral artifact the
  ``generate`` CLI serves; tensor-parallel serving of the sparse family
  refuses by name (ROADMAP A6c.3's remainder).
"""
import inspect
import json
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import pytorch_distributed_template_tpu.models  # noqa: F401  (register)
from pytorch_distributed_template_tpu.config.registry import MODELS as JM
from pytorch_distributed_template_tpu.engine.continuous import (
    ContinuousBatchingService as JContinuous,
)
from pytorch_distributed_template_tpu.engine.serving import (
    GenerationService as JService,
)
from pytorch_distributed_template_tpu.models.moe import MoeMlp as JMoeMlp
import pytorch_distributed_template_tpu_torch.models  # noqa: F401
from pytorch_distributed_template_tpu_torch.config.registry import (
    MODELS as TM,
)
from pytorch_distributed_template_tpu_torch.engine.continuous import (
    ContinuousBatchingService,
)
from pytorch_distributed_template_tpu_torch.engine.serving import (
    GenerationService as TService,
)
from pytorch_distributed_template_tpu_torch.models import moe as tmoe
from pytorch_distributed_template_tpu_torch.models.convert import (
    flax_from_params, params_from_flax,
)

from test_torch_accum_ema import _process_signal_handlers  # noqa: F401
from test_torch_real_configs import _cut, _jax_run, _port_run

FWD = dict(atol=2e-5, rtol=1e-4)
GRAD = dict(atol=2e-5, rtol=2e-4)
D, F_, E = 32, 48, 4
# JAX's TestSparseLlama._make, at a capacity that drops tokens
TINY = dict(vocab_size=64, n_layer=2, n_head=4, n_kv_head=2, d_model=32,
            d_ff=64, max_len=32, window=0, num_experts=4, top_k=2,
            capacity_factor=1.0, bfloat16=False, attn_impl="xla",
            remat=False, fused_head=False)


def _x(b=2, t=12, d=D, seed=0):
    return np.random.default_rng(seed).normal(size=(b, t, d)).astype(
        np.float32)


def _layer_pair(top_k, cf, dispatch, aux_w=0.1, seed=0):
    jl = JMoeMlp(d_model=D, d_ff=F_, num_experts=E, top_k=top_k,
                 capacity_factor=cf, aux_loss_weight=aux_w,
                 dispatch_impl=dispatch, expert_act="swiglu")
    params = jax.device_get(jl.init(jax.random.key(seed),
                                    jnp.asarray(_x()), False)["params"])
    holder = nn.Module()
    holder.moe = tmoe.MoeMlp(D, F_, E, top_k=top_k, capacity_factor=cf,
                             aux_loss_weight=aux_w, dispatch_impl=dispatch,
                             expert_act="swiglu")
    holder.load_state_dict(params_from_flax({"moe": params}), strict=True)
    return jl, params, holder.moe


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_swiglu_moe_matches_jax(top_k, dispatch):
    """Outputs, the aux loss and the gradients of x and every leaf at a
    capacity of 0.5 (tokens dropped on both sides alike)."""
    jl, params, tl = _layer_pair(top_k, 0.5, dispatch)
    assert "wg" in params and "bi" not in params and "bo" not in params
    assert sorted(n for n, _ in tl.named_parameters()) == [
        "router.bias", "router.weight", "wg", "wi", "wo"]
    x = _x(seed=7)
    g = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, mut = jl.apply({"params": p}, xx, True, mutable=["losses"])
        return jnp.sum(y * g) + mut["losses"]["moe_aux"], (
            y, mut["losses"]["moe_aux"])

    (_, (y_j, aux_j)), (gp, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    tl.train()
    y, aux = tl(xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **FWD)
    np.testing.assert_allclose(float(aux.detach()), float(aux_j),
                               rtol=1e-5)
    assert np.all(np.asarray(y_j) == 0.0, axis=-1).sum() > 0 or top_k == 2
    ((y * torch.from_numpy(g)).sum() + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD)
    want = params_from_flax({"moe": jax.device_get(gp)})
    for name, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   want[f"moe.{name}"].numpy(), **GRAD,
                                   err_msg=name)


def _tiny_pair(seed=0, **kw):
    args = dict(TINY, **kw)
    jmodel = JM.get("MixtralMoE")(**args)
    params = jax.device_get(jmodel.init(
        jax.random.key(seed), jnp.zeros((1, 16), jnp.int32))["params"])
    tmodel = TM.get("MixtralMoE")(**args, device="cpu",
                                  param_dtype=torch.float32)
    tmodel.load_state_dict(params_from_flax(params), strict=True)
    return jmodel, params, tmodel


def _tokens(b=4, t=16, seed=0, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_tiny_mixtral_logits_and_aux_match_jax(remat):
    """Eval logits, and the training forward's logits and summed aux loss
    (counted once under remat)."""
    jmodel, params, tmodel = _tiny_pair(remat=remat)
    tokens = _tokens()
    mask = np.array([True, True, True, False])
    want = jmodel.apply({"params": params}, jnp.asarray(tokens))
    tmodel.eval()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    assert tmodel.aux_loss is None
    logits_j, mut = jmodel.apply(
        {"params": params}, jnp.asarray(tokens), train=True,
        example_mask=jnp.asarray(mask), mutable=["losses"])
    aux_j = sum(float(jnp.sum(a)) for a in jax.tree.leaves(mut["losses"]))
    tmodel.train()
    logits_t = tmodel(torch.from_numpy(tokens).long(),
                      example_mask=torch.from_numpy(mask))
    if remat:
        logits_t.sum().backward()    # the recompute adds no aux twice
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), **FWD)
    assert aux_j > 0
    np.testing.assert_allclose(float(tmodel.aux_loss.detach()), aux_j,
                               rtol=1e-5)


TRAIN_SETS = {
    "arch": {"type": "MixtralMoE", "args": dict(
        TINY, vocab_size=256, max_len=32, capacity_factor=1.0)},
    "train_loader;args;n": 8, "train_loader;args;batch_size": 8,
    "valid_loader;args;n": 8, "valid_loader;args;batch_size": 8,
    "trainer;epochs": 3, "trainer;save_period": 10,
}


def test_tiny_mixtral_trains_like_the_jax_trainer(tmp_path):
    """Three steps (one per epoch) of ``llama_debug.json`` with the tiny
    Mixtral through both trainers: the logged losses (the aux loss
    included) and validation, and the params after the last step."""
    cfg = _cut("llama_debug.json", TRAIN_SETS)
    box = {}
    params, jlogs = _jax_run(cfg, tmp_path / "jax", box)
    tlogs, trainer = _port_run(cfg, tmp_path / "port", params)
    assert type(trainer.model).__name__ == "LlamaLM"
    assert trainer.model.moe_experts == 4
    assert len(jlogs) == len(tlogs) == 3
    for e, (j, t) in enumerate(zip(jlogs, tlogs), start=1):
        for key in ("loss", "val_loss"):
            np.testing.assert_allclose(t[key], j[key], rtol=1e-4,
                                       err_msg=f"epoch {e} {key}")
    assert tlogs[-1]["loss"] < tlogs[0]["loss"]
    final = params_from_flax(jax.device_get(box["trainer"].state.params))
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   atol=1e-4, err_msg=name)


def test_cached_decode_logit_parity():
    """JAX's ``test_cached_decode_logit_parity`` on the port: a rolling
    cache of window 8 fed 12 tokens at once equals the full forward, and
    both equal JAX's full forward."""
    jmodel, params, tmodel = _tiny_pair(window=8, capacity_factor=4.0)
    tokens = _tokens(b=1, t=12, seed=5)
    full_j = jmodel.apply({"params": params}, jnp.asarray(tokens))
    tmodel.eval()
    with torch.no_grad():
        full = tmodel(torch.from_numpy(tokens).long())
        cache = tmodel.new_cache(1, 16)
        out = tmodel(torch.from_numpy(tokens).long(), cache=cache)
    np.testing.assert_allclose(out.numpy(), full.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(full.numpy(), np.asarray(full_j), **FWD)


def test_batch1_service_greedy_ids_match_jax():
    """The batch-1 ``GenerationService`` (contiguous cache, window 8: the
    ring wraps) at capacity 1.0: the prompt's prefill drops tokens, the
    same ones on both sides; greedy ids identical to JAX's."""
    jmodel, params, tmodel = _tiny_pair(window=8)
    jsvc = JService.from_model(jmodel, params)
    tsvc = TService.from_model(tmodel, device="cpu")
    rng = np.random.default_rng(9)
    for n in (6, 11, 14):
        ids = [int(x) for x in rng.integers(0, 64, n)]
        want = jsvc.generate(prompt_ids=ids, max_new_tokens=7)["ids"]
        got = tsvc.generate(prompt_ids=ids, max_new_tokens=7)["ids"]
        assert got == want and len(got) == 7


def test_paged_engine_greedy_ids_match_jax():
    """The continuous engine over the paged pool (3 slots, 4-step chunks,
    concurrent requests sharing a prefix, a second warm wave) gives JAX's
    batch-1 paged service's greedy ids."""
    pool = {"enabled": True, "block_tokens": 8, "pool_blocks": 64,
            "paged": True}
    jmodel, params, tmodel = _tiny_pair(capacity_factor=4.0)
    rng = np.random.default_rng(61)
    prefix = [int(x) for x in rng.integers(1, 64, 19)]
    reqs = [{"prompt_ids": prefix + [int(x) for x in rng.integers(
                1, 64, 3 + i % 3)], "max_new_tokens": 5 + i}
            for i in range(4)]
    svc = ContinuousBatchingService.from_model(
        tmodel, device="cpu", slots=3, chunk=4, window_ms=20.0,
        prefix_cache=dict(pool))
    try:
        for _ in range(2):
            out = [None] * len(reqs)

            def call(i):
                out[i] = svc.generate(**reqs[i])

            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(len(reqs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            jsvc = JService.from_model(jmodel, params,
                                       prefix_cache=dict(pool))
            for r, got in zip(reqs, out):
                assert got is not None
                assert got["ids"] == jsvc.generate(**r)["ids"]
        assert svc.stats["paged_chunks"] == svc.stats["chunks"] > 0
    finally:
        svc.close()


@pytest.mark.parametrize("capacity", [0.5, 1.25])
def test_paged_engine_at_a_dropping_capacity_matches_jax(capacity):
    """Requests one after another through 3 slots, so every call has idle
    rows, at a capacity that drops tokens (1.25 is Mixtral's): admissions
    take JAX's shape (the suffix bucket wide, ``slots`` rows), idle and
    padding rows claim capacity as JAX's do, and the greedy ids equal JAX's
    continuous engine's. The capacity binds: one slot gives other ids."""
    pool = {"enabled": True, "block_tokens": 8, "pool_blocks": 64,
            "paged": True}
    jmodel, params, tmodel = _tiny_pair(capacity_factor=capacity)
    rng = np.random.default_rng(61)
    reqs = [{"prompt_ids": [int(x) for x in rng.integers(1, 64, 5 + 3 * i)],
             "max_new_tokens": 12} for i in range(6)]

    def port(slots):
        svc = ContinuousBatchingService.from_model(
            tmodel, device="cpu", slots=slots, chunk=4, window_ms=5.0,
            prefix_cache=dict(pool))
        try:
            return [svc.generate(**r)["ids"] for r in reqs]
        finally:
            svc.close()

    jsvc = JContinuous.from_model(jmodel, params, slots=3, chunk=4,
                                  window_ms=5.0, prefix_cache=dict(pool))
    got = port(3)
    assert got == [jsvc.generate(**r)["ids"] for r in reqs]
    assert got != port(1)


def test_padding_rows_write_to_the_scratch_page():
    """``write_rows``: the rows after it (an admission's copies of its last
    request) read their tables but put every lane in the scratch page."""
    from pytorch_distributed_template_tpu_torch.engine.kvcache import (
        SCRATCH_BLOCK,
    )
    from pytorch_distributed_template_tpu_torch.models.llama import (
        paged_placement,
    )

    tables = torch.tensor([[3, 4], [3, 4], [3, 4]], dtype=torch.int32)
    starts = torch.tensor([-2, -2, -2], dtype=torch.int32)
    pads = torch.tensor([2, 2, 2], dtype=torch.int32)
    at = paged_placement(tables, starts, pads, 8, 4, 0, 8, 1e4,
                         write_rows=1)
    flat = at.flat.view(3, 8)
    assert flat[0, 2:].tolist() == [12, 13, 14, 15, 16, 17]
    assert (flat[0, :2] // 4 == SCRATCH_BLOCK).all()
    assert (flat[1:] // 4 == SCRATCH_BLOCK).all()


def test_convert_round_trip_is_bit_equal():
    _, params, tmodel = _tiny_pair()
    back = flax_from_params(tmodel.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf))
    assert set(back["layers_0"]["moe"]) == {"router", "wi", "wg", "wo"}


def test_registry_defaults_equal_jax():
    """Every default of JAX's ``mixtral_moe`` letter for letter (rope base
    1e6, fused head, every block sparse, capacity 1.25, aux 0.01), and the
    published widths on the meta device."""
    want = inspect.signature(JM.get("MixtralMoE")).parameters
    got = inspect.signature(TM.get("MixtralMoE")).parameters
    for name, p in want.items():
        if p.kind is inspect.Parameter.VAR_KEYWORD:
            continue
        assert got[name].default == p.default, name
    model = TM.get("MixtralMoE")(device="meta")
    assert model.rope_base == 1e6 and model.fused_head and model.remat
    assert model.moe_experts == 8 and model.moe_every == 1
    assert all(hasattr(b, "moe") for b in model.layers)
    moe = model.layers[0].moe
    assert (moe.top_k, moe.capacity_factor, moe.aux_loss_weight) == (
        2, 1.25, 0.01)
    assert tuple(moe.wg.shape) == (8, 4096, 14336)
    assert model.dtype == torch.bfloat16 and model.window == 4096
    rules = dict(model.partition_rules())
    assert rules[r"moe/wg"] == tmoe.MoeMlp.partition_rules()[1][1]


def test_configs_hold_mixtral_published_widths():
    root = Path(__file__).resolve().parent.parent / \
        "pytorch_distributed_template_tpu_torch" / "configs"
    for name, mesh in (("mixtral_8x7b_ep.json", {"expert": 4}),
                       ("mixtral_8x7b_serve_paged.json", None)):
        cfg = json.loads((root / name).read_text())
        assert cfg["arch"]["type"] == "MixtralMoE"
        args = cfg["arch"]["args"]
        for key in ("vocab_size", "n_head", "n_kv_head", "d_model", "d_ff",
                    "window", "num_experts", "top_k", "rope_base"):
            want = inspect.signature(TM.get("MixtralMoE")).parameters[
                key].default
            assert args.get(key, want) == want, (name, key)
        if mesh is not None:
            assert cfg["mesh"]["axes"] == mesh


def test_artifact_serves_and_tensor_parallel_refuses(tmp_path):
    import contextlib
    import io

    from pytorch_distributed_template_tpu_torch import generate as tcli
    from pytorch_distributed_template_tpu_torch.parallel.tp import (
        validate_tp_geometry,
    )
    from pytorch_distributed_template_tpu_torch.tools import (
        make_serving_artifact as tool,
    )

    arch = dict(n_layer=2, d_model=32, n_head=4, n_kv_head=2, d_ff=64,
                vocab_size=64, num_experts=4, window=8, attn_impl="xla",
                bfloat16=False)
    tool.make_artifact(tmp_path / "art", arch="MixtralMoE", arch_args=arch,
                       device="cpu")
    argv = ["-r", str(tmp_path / "art" / "model"), "--prompt-ids",
            "1,2,3,4,5", "--max-new-tokens", "5", "--device", "cpu", "-s",
            str(tmp_path / "gen")]
    with contextlib.redirect_stdout(io.StringIO()):
        first = tcli.main(argv)["ids"]
        assert tcli.main(argv)["ids"] == first and len(first) == 5
    with pytest.raises(NotImplementedError, match="A6c.3"):
        tool.make_artifact(tmp_path / "tp", arch="MixtralMoE",
                           arch_args=arch, device="cpu", tensor_parallel=2)
    with pytest.raises(NotImplementedError, match="A6c.3"):
        validate_tp_geometry(TM.get("MixtralMoE")(device="meta"), 4)


def test_plain_paged_attention_zeroes_lanes_that_see_no_key():
    """An idle or padded row's MoE route depends on its attention output,
    so the plain B4 gives what the kernel gives on a lane that sees no key
    (an invalid lane): exactly 0; valid lanes are unchanged."""
    from pytorch_distributed_template_tpu_torch.ops import flash

    g = torch.Generator().manual_seed(4)
    q = torch.randn(2, 3, 4, 8, generator=g)
    kp = torch.randn(6, 4, 2, 8, generator=g)
    vp = torch.randn(6, 4, 2, 8, generator=g)
    tables = torch.tensor([[1, 2], [3, -1]], dtype=torch.int32)
    starts = torch.tensor([2, 0], dtype=torch.int32)
    pads = torch.tensor([1, 3], dtype=torch.int32)
    out = flash.paged_attention_ref(q, kp, vp, tables, starts, pads)
    assert torch.equal(out[0, :1], torch.zeros_like(out[0, :1]))
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    assert out[0, 1:].abs().sum() > 0
