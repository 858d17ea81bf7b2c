#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (1, 2, 2b, 2c, 2d, 3, 3b, 3c, 3d, 4, 5, 6, 7, 8, 9, 10,
11);
any failure exits non-zero and no phase's exception is caught:

1. build: compile every CUDA source of the port with nvcc (one process per
   source, all started together) and print the build time and the ptxas
   register report; B4's Hopper arms and B2's and B3's must use 0 bytes of
   stack and spills;
2. kernel against plain: the flash-attention forward kernel against its
   plain PyTorch version on the card, at the main path's prefill shapes,
   a ragged f32 and a non-causal case, and the training paths' shapes
   (GPT-2 small and the MoE LM), with kernel / plain / library
   (``scaled_dot_product_attention``, timed only) times and the card's
   bound;
3. reference: a small float32 Llama served on the card (kernel path) and
   on the CPU (plain path) gives the same prefill logits and the same
   greedy tokens;
4. main path of slice 1: a random-init Mistral-7B artifact at full
   width, made by the port's tool, served through ``GenerationService``,
   the ``generate`` CLI and ``engine.generate.generate``: (a) a 1024-token
   prompt, 32 greedy tokens, twice, identical; (b) a 6144-token prompt,
   past the 4096-token window (rolling cache, banded kernel); (c) a
   sampled request with a stop id; (d) a batch of 4 x 2048-token prompts.
   The flash launch count is set to 0 before each request and must read
   exactly ``n_layer`` per prefill after it. Then request (a) runs under
   ``torch.profiler`` (prefill alone, then the whole request) for the
   device's busy time and top kernels.

Slice 2 (continuous paged serving, kernel B4) adds:

2b. the paged-attention kernel against its plain version at the main
    path's shapes (decode over the 145-page ring, bf16 and int8 pools,
    flat decode with shuffled tables, a 512-lane prefill chunk deep in
    the ring and a long prompt's first chunk at position 0, a 64-lane
    admission feed with pad lanes, an f32 case at D 64), with the arm
    each takes, kernel / plain / library (SDPA on K/V gathered in
    advance) times, the card's bound and the wrapper's host time per
    call;
3b. the small f32 Llama served by the continuous engine over the paged
    pool on the card and on the CPU: same greedy tokens for 6 concurrent
    requests, with the f32 and the int8 pool;
5.  main path of slice 2: the same artifact served by the port's
    ``serve.py`` (in this process, a free port) with
    ``configs/mistral_7b_serve_paged.json``, driven over HTTP with
    streamed responses: (e) 8 concurrent greedy requests of 256-2048
    tokens, half sharing a 1024-token prefix, 64 new tokens each; one of
    them alone, twice, identical; (f) a 6144-token prompt streamed in
    512-token chunks while 4 short requests decode; (g) the mix of (e)
    again over an int8 pool. Before each wave both launch counts are set
    to 0; after it the paged kernel's count must equal ``n_layer`` x the
    engine's model calls and the flash kernel's must be 0, B4's wgmma arm
    must have taken ``n_layer`` x (prefill chunks + admission calls) of
    them and its decode arm ``n_layer`` x the decode calls, every id in
    range, warm admits copying nothing, and prefix hits > 0 after (e).
    The paged batch-1 prefill's last logits are held against slice 1's
    flash prefill on a 1024-token prompt, and one request of (e) runs
    alone under ``torch.profiler`` (outside the counted waves).

Slice 3 (LM training, kernels B2 and B3) adds:

2c. the flash backward kernels (B3 dQ and delta, then B2 dK/dV) against
    the plain backward at the training main paths' shapes (GPT-2 small: 8
    x 12 heads x 1024, D 64; the MoE LM: 32 x 8 x 512, D 64), a
    Mistral-width GQA shape, a banded, a ragged f32 and a non-causal
    banded case, and an lse-cotangent case, with the arm each takes,
    kernel / plain / library (the backward of
    ``scaled_dot_product_attention``, timed only) times and the card's
    bound per kernel, and a ``flash_bwd_pair`` row per shape: the whole
    ``flash_attention_bwd`` (B3 with delta, then B2) against the SDPA
    backward, with the whole backward's own bound (10 FLOPs per visible
    pair and head dim, each array moved once);
3c. a small f32 GPT2 (flash, fused head, remat) and a small windowed GQA
    Llama (flash) train 5 steps on the card (kernels) and on the CPU
    (plain versions) from the same weights and batches: the same per-step
    losses and final params;
6.  main path of slice 3: the port's ``train.py`` with
    ``configs/gpt2_small_train.json`` (the repository's
    ``configs/gpt2_small.json`` with every observability key off) at full
    width (GPT-2 small: 12
    layers, d_model 768, vocab 50257, seq 1024, batch 8, bf16, remat,
    flash, fused head chunk 256, dropout 0.1), cut to 256 training and 64
    validation sequences and 2 epochs (``--set``): every train step must
    launch B1 2 x 12 times and B2, B3 12 times each, every eval step B1 12
    times and no B2/B3; losses finite and falling; checkpoints and
    ``summary.json`` written; a run resumed from ``checkpoint-epoch1``
    reproduces epoch 2. Then 5 train steps run under ``torch.profiler``
    (with B2's and B3's device ms per step).

Slice 4 (MoE LM training, kernel B5) adds:

2d. the fused expert FFN kernel B5 against its plain version at the MoE
    main path's shape (E 8, C 5120, D 512, F 1024, with biases), the TPU
    probe's shape (E 8, C 2560, D 768, F 1536, no biases), a ragged
    capacity and a small f32 case, with kernel / plain / library (the
    three cuBLAS calls bmm -> gelu -> bmm, timed only) times and the
    card's bound;
3d. a small f32 TinyMoeLM (flash, D 64, fused head, top-2, a capacity that
    drops tokens, one padded example per batch) trains 5 steps on the card
    and on the CPU from the same weights and batches: the same per-step
    losses (the aux loss included) and final params;
7.  main path of slice 4: a corpus built by the port's
    ``tools/make_text_corpus.py``, then the port's ``train.py`` with
    ``configs/moelm_stdlib.json`` at full width (8 layers, d_model 512,
    d_ff 1024, 8 heads, 8 experts top-2, seq 512, batch 32, bf16, flash,
    fused head), cut to a 2 MB corpus and 2 epochs, with the health
    summary and the flight recorder off (on by default since slice 6; off,
    the step is the one slice 4 ran): every train step must
    launch B5, B1, B2 and B3 8 times each, every eval step B5 and B1 8
    times and no B2/B3; losses finite and falling; ``val_lm_bits_per_
    byte`` logged; checkpoints and ``summary.json`` written; a resume from
    ``checkpoint-epoch1`` reproduces epoch 2. Then 5 steps under the
    profiler (with B2's and B3's device ms per step).

Slice 5 (the source paper's main path: LeNet/MNIST with DDP; no TPU
kernel, the convs, pools and dense layers run on cuDNN/cuBLAS) adds:

8.  ``configs/mnist_debug.json`` trains one epoch in f32 through the
    port's ``train.py`` on the card and on the CPU from the same weights,
    dropout off: the same per-step losses and final params, with TF32 off
    on the card for this comparison only (each run's setting printed);
9.  main path of slice 5: the port's ``train.py`` with
    ``configs/mnist.json`` as it is (LeNet at full width, batch 128, 10
    epochs, TensorBoard on, synthetic MNIST without idx files) in this
    process with the launcher's environment set for
    one rank: the process group must be NCCL, the model must train
    wrapped in ``DistributedDataParallel``, and a communication hook on
    the wrapper must count a gradient all-reduce in every train step;
    losses finite and falling; the final validation accuracy above 0.5
    (chance 0.1); checkpoints, ``model_best`` and ``summary.json``
    written; a resume from ``checkpoint-epoch1`` reproduces epoch 2
    exactly; the port's ``test.py`` on ``model_best`` gives the best
    epoch's validation loss and metrics (rtol 1e-6) and ``--save-outputs``
    writes one row per validation sample; then ``torchrun --standalone
    --nproc_per_node=1 -m pytorch_distributed_template_tpu_torch.train -c
    configs/mnist_debug.json`` (one epoch) exits 0 and writes its
    checkpoint. Prints ms/step, examples/s, a 5-step profile (device busy
    and idle share, top ops), peak memory and the all-reduce calls and
    bytes per step, each beside the card line.

Slice 6 (training observability; no TPU kernel, the health summary's
reductions are plain PyTorch) adds:

10. main path of slice 6: the port's ``train.py`` with the repository's
    ``configs/gpt2_small.json`` as it is (``compile_cache``, TensorBoard,
    health with ``pause_best_promotion``, telemetry, ``skip_nonfinite``),
    cut only by ``--set``: train ``n`` 256, valid ``n`` 64, 2 epochs,
    ``save_period`` 1, a profiler window of 3 steps, ``watchdog_secs``
    600, ``log_grad_norm``. Phase 6's checks (exact launches per step,
    losses, checkpoints, summary, resume, profile) and: one flight record
    per step, ``trace.json``, a ``torch.profiler`` trace in ``profile/``,
    TB events (or the backend's absence printed), ``grad_norm`` and
    ``mfu`` in the epoch logs; phase 6's and phase 10's train step timed
    in turns on one model;
    the median ms/step, iteration ms, span breakdown and synchronising
    calls per non-log step (``torch.cuda.set_sync_debug_mode``) beside
    phase 6's, failing if phase 10 makes more. Then one epoch with
    ``trainer.faults "nan_grad@step:24"``: ``anomaly_24.json`` written,
    the step skipped, the params finite, the per-group counts summing to
    the number of gradient elements, no ``model_best``.

Slice 7 (step-accurate resume and the supervisor, ROADMAP A17; no new
kernel) adds:

11. main path of slice 7: ``configs/gpt2_small.json`` at full width cut
    by ``--set`` to phase 10's sizes (train ``n`` 256, valid ``n`` 64, 2
    epochs, ``save_period`` 1) with ``save_interval_steps`` 12,
    ``keep_last`` 1, ``grad_accum_steps`` 2 (microbatches of 4) and
    ``ema_decay`` 0.999. Once without a fault through the port's
    ``train.py`` in this process (every train step must launch B1 2 x 2 x
    12 times and B2, B3 2 x 12 times each), then once through the port's
    ``supervise.py`` (a child process per attempt) with
    ``PDT_FAULTS="kill@step:20;crash@step:46@attempt:2"``: attempt 1 is
    killed between the slots after batches 12 and 24 and resumes from the
    first (when the slot's write, 0.6-1.2 s on the card, was done within
    the 8 steps before the kill; else from the last checkpoint before it);
    attempt 2 raises in epoch 2 after its batch-12 slot and writes
    ``checkpoint-emergency``; attempt 3 resumes from it and finishes.
    Hard checks: 2 restarts, both ``crash``, a clean end; each attempt
    resuming at the newest checkpoint the attempt before it completed (no
    step replayed after the crash); ``global_step`` 64 in the last
    sidecar; the final
    ``checkpoint-epoch2``'s model, optimizer and EMA tensors bitwise equal
    to the uninterrupted run's; every logged loss equal at its step;
    ``keep_last`` 1 leaving no ``checkpoint-epoch1`` beside
    ``model_best``. Prints each interval save's stop of the loop and its
    write (time, bytes), each attempt's restart to its first step and the
    steps replayed, beside the card line.

The last three lines of standard output are the card's name and power
limit as nvidia-smi gives them, the ``kernels`` JSON line (flash_fwd with
the launches of slices 1, 3, 4, 6 and 7, paged_attn with slice 2's,
flash_bwd_dkv and flash_bwd_dq with slices 3, 4, 6 and 7, expert_ffn with
slice 4's) and the device line ``{"ok": true, "device": {...}}``. Every kernel
row also carries ``pct_of_bound`` (100 x bound / kernel time) and
``x_library`` (kernel time / library time); kernel times are device times
(:func:`cuda_ms`). The script needs a CUDA device and the repository
beside it; it imports nothing of JAX.
"""
from __future__ import annotations

import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense tensor-core bf16
              torch.float32: 67e12}     # f32 outside the tensor cores
KERNEL_SOURCE = "pytorch_distributed_template_tpu_torch/csrc/flash_fwd.cu"
KERNEL_REPLACES = "pytorch_distributed_template_tpu/ops/flash.py:109"
# (B, H, KVH, T, D, causal, window, dtype): the main path's prefill shapes
# (Mistral-7B: 32/8 heads, D 128, window 4096: requests a, b and d), a
# ragged f32 case, a non-causal banded case, and the training paths'
# shapes (GPT-2 small: 8 x 12 heads x 1024; the MoE LM: 32 x 8 x 512)
KERNEL_SHAPES = [
    (1, 32, 8, 1024, 128, True, 4096, torch.bfloat16),
    (1, 32, 8, 6144, 128, True, 4096, torch.bfloat16),
    (4, 32, 8, 2048, 128, True, 4096, torch.bfloat16),
    (1, 16, 4, 1000, 64, True, 0, torch.float32),
    (2, 8, 8, 512, 32, False, 128, torch.bfloat16),
    (8, 12, 12, 1024, 64, True, 0, torch.bfloat16),
    (32, 8, 8, 512, 64, True, 0, torch.bfloat16),
]
# (atol, rtol, lse atol) against the plain version computed in f32 from the
# same inputs, |out - ref| <= atol + rtol |ref|. bf16: the output is rounded
# to bf16 once (2^-8 relative) and the tensor-core kernel rounds the
# probabilities to bf16 for P.V (2^-9 relative each); rtol is
# torch.testing's bf16 default. f32 (CUDA cores) and every lse (f32 sums of
# exact products) differ only by summation order.
TOL = {torch.bfloat16: (1e-2, 1.6e-2, 1e-3),
       torch.float32: (1e-4, 0.0, 1e-4)}
# the main path: Mistral at the registry's (published) widths and depth
MAIN_ARCH = "Mistral"
MAIN_SIZES = {"prompt_a": 1024, "prompt_b": 6144, "batch_d": 4,
              "prompt_d": 2048, "new": 32}
# phase 3: small enough for the CPU, D = 64 so the kernel takes it, window
# 16 < prompt so the rolling cache and the band both run
REF_ARCH = {"vocab_size": 512, "n_layer": 2, "n_head": 4, "n_kv_head": 2,
            "d_model": 256, "max_len": 128, "window": 16,
            "attn_impl": "flash"}
REF_LOGIT_ATOL = 1e-3   # f32 on both sides, two layers, summation order


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls.

    The stream first spins on the card (``torch.cuda._sleep``) for longer
    than the host takes to enqueue all the calls, so the calls run back to
    back and the host's time between launches is not counted (a small
    kernel's wrapper can take longer on the host than the kernel on the
    card). A ``fn`` that synchronises is timed with its host gaps."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    enqueue_s = min(1.0, 1.5 * reps * (time.perf_counter() - t0))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * enqueue_s))   # cycles, at <= 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def with_ratios(row: dict) -> dict:
    """``row`` with ``pct_of_bound`` (100 x bound / kernel time) and
    ``x_library`` (kernel time / library time, None without a library
    call) added."""
    lib = row.get("library_ms")
    row["pct_of_bound"] = 100.0 * row["bound_ms"] / row["kernel_ms"]
    row["x_library"] = None if lib is None else row["kernel_ms"] / lib
    return row


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_build() -> None:
    # importing a kernel's module registers its library for build_all
    from pytorch_distributed_template_tpu_torch.ops import (
        build, expert_ffn, flash,
    )

    assert {flash.FLASH_FWD, flash.PAGED_ATTN, flash.FLASH_BWD,
            expert_ffn.EXPERT_FFN} <= set(build.LIBRARIES)
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"[build] {len(build.LIBRARIES)} libraries in "
        f"{time.perf_counter() - t0:.2f} s (built now: {built})")
    for lib in build.LIBRARIES:
        lib.load()
        for line in ptxas_report(lib.build_log):
            log(f"[build] {lib.name}: {line}")
    if flash.PAGED_ATTN.build_log:
        check_no_spills(flash.PAGED_ATTN.build_log,
                        ("paged_attn_wgmma", "paged_attn_decode"))
    if flash.FLASH_BWD.build_log:
        check_no_spills(flash.FLASH_BWD.build_log,
                        ("flash_bwd_dkv_wgmma", "flash_bwd_dq_wgmma"))


def check_no_spills(build_log: str, kernels) -> None:
    """Fail when ptxas gave a kernel whose name holds one of ``kernels``
    a stack frame or spills, or reported none of them."""
    seen = 0
    for line in ptxas_report(build_log):
        if not any(k in line for k in kernels) or "spill" not in line:
            continue
        seen += 1
        if any(int(n) for n in re.findall(r"(\d+) bytes", line)):
            raise AssertionError(f"stack or spills: {line}")
    if not seen:
        raise AssertionError(f"ptxas reported none of {kernels}")


def ptxas_report(build_log: str) -> list:
    """The lines of an ``nvcc -Xptxas -v`` log worth printing: each
    kernel's stack and spills and its registers, after the kernel's name,
    and ptxas's notes on shared memory, performance and warnings."""
    lines, kernel = [], ""
    for line in build_log.splitlines():
        props = re.search(r"Function properties for (\S+)", line)
        if props:
            # the mangled name less its anonymous namespace and arguments
            kernel = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "",
                            props.group(1)).split("Ev", 1)[0]
        elif "bytes spill" in line or "Used" in line and "registers" in line:
            lines.append(f"{kernel}: {line.strip()}")
        elif "ptxas" in line and ("smem" in line or "Performance" in line
                                  or "warning" in line or "C75" in line):
            lines.append(line.strip())
    return lines


def _sdpa_ms(q, k, v, causal: bool, window: int, reps: int):
    """Time of one ``scaled_dot_product_attention`` call on the same
    inputs (yardstick only; the port never calls it)."""
    import torch.nn.functional as F

    from pytorch_distributed_template_tpu_torch.ops.flash import (
        visible_mask,
    )

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    t = q.shape[1]
    kw = {"enable_gqa": True} if k.shape[2] != q.shape[2] else {}
    if 0 < window < t:
        kw["attn_mask"] = visible_mask(t, t, causal, window, q.device)
    else:
        kw["is_causal"] = causal
    return cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw),
                   reps)


def phase_kernel() -> list:
    from pytorch_distributed_template_tpu_torch.ops.flash import (
        FLASH_FWD, flash_attention_lse, flash_attention_ref,
        flash_bound_seconds,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for (b, h, kvh, t, d, causal, window, dtype) in KERNEL_SHAPES:
        def rnd(heads):
            return torch.randn((b, t, heads, d), generator=gen,
                               device="cuda", dtype=torch.float32).to(dtype)

        q, k, v = rnd(h), rnd(kvh), rnd(kvh)
        out, lse = flash_attention_lse(q, k, v, causal=causal,
                                       window=window)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_ref(q.float(), k.float(),
                                               v.float(), causal=causal,
                                               window=window)
        diff = (out.float() - ref_out).abs()
        err_out = diff.max().item()
        atol, rtol, tol_lse = TOL[dtype]
        excess = (diff - rtol * ref_out.abs()).max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"non-finite kernel output at {t=}")
        if excess > atol or err_lse > tol_lse:
            raise AssertionError(
                f"flash_fwd disagrees with its plain version at "
                f"B={b} H={h} KVH={kvh} T={t} D={d} causal={causal} "
                f"window={window} {dtype}: out max err {err_out:.3e}, "
                f"max(err - {rtol}|ref|) {excess:.3e} (atol {atol}), lse "
                f"{err_lse:.3e} (tol {tol_lse})")
        del diff
        del ref_out, ref_lse
        reps = 20 if t <= 2048 else 5
        kernel_ms = cuda_ms(
            lambda: flash_attention_lse(q, k, v, causal, window), reps)
        ref_ms = cuda_ms(
            lambda: flash_attention_ref(q, k, v, causal, window),
            max(2, reps // 4), warmup=1)
        library_ms = _sdpa_ms(q, k, v, causal, window, reps)
        bound_s, bound_by = flash_bound_seconds(
            b, t, h, kvh, d, causal, window, q.element_size(),
            PEAK_FLOPS[dtype], PEAK_BYTES)
        row = {"B": b, "H": h, "KVH": kvh, "T": t, "D": d,
               "causal": causal, "window": window,
               "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err_out, "lse_max_abs_err": err_lse,
               "atol_rtol_lse": [atol, rtol, tol_lse],
               "kernel_ms": kernel_ms, "ref_ms": ref_ms,
               "library_ms": library_ms, "bound_ms": bound_s * 1e3,
               "bound_by": bound_by}
        rows.append(with_ratios(row))
        log("[kernel] " + json.dumps(row))
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    FLASH_FWD.launches = 0
    return rows


def phase_reference(device="cuda") -> None:
    """A small f32 Llama on ``device`` (kernel path) against the same
    weights on the CPU (plain path): prefill logits within
    ``REF_LOGIT_ATOL``, greedy tokens identical."""
    import pytorch_distributed_template_tpu_torch.models  # noqa: F401
    from pytorch_distributed_template_tpu_torch.config.registry import MODELS
    from pytorch_distributed_template_tpu_torch.engine import (
        generate as gen,
    )
    from pytorch_distributed_template_tpu_torch.engine.serving import (
        GenerationService,
    )

    cpu_model = MODELS.get("Llama")(**REF_ARCH, device="cpu")
    cpu_model.init_weights(torch.Generator().manual_seed(2))
    dev_model = MODELS.get("Llama")(**REF_ARCH, device=device)
    dev_model.load_state_dict(cpu_model.state_dict())
    prompt = np.random.default_rng(4).integers(
        0, REF_ARCH["vocab_size"], (2, 40))
    with torch.inference_mode():
        cpu_last, _ = gen._prefill_fresh(
            cpu_model, torch.from_numpy(prompt), 64)
        dev_last, _ = gen._prefill_fresh(
            dev_model, torch.from_numpy(prompt).to(device), 64)
    err = (dev_last.cpu() - cpu_last).abs().max().item()
    if not err <= REF_LOGIT_ATOL:
        raise AssertionError(f"prefill logits on {device} differ from the "
                             f"CPU by {err:.3e} > {REF_LOGIT_ATOL}")
    ids = [int(i) for i in prompt[0]]
    on_dev = GenerationService.from_model(dev_model, device=device).generate(
        prompt_ids=ids, max_new_tokens=24)
    on_cpu = GenerationService.from_model(cpu_model, device="cpu").generate(
        prompt_ids=ids, max_new_tokens=24)
    if on_dev["ids"] != on_cpu["ids"]:
        raise AssertionError(f"greedy tokens differ: {device} "
                             f"{on_dev['ids']} vs cpu {on_cpu['ids']}")
    log(f"[reference] small f32 Llama (D=64, window 16, 40-token prompt "
        f"+ 24): logits max err {err:.3e} (atol {REF_LOGIT_ATOL}), greedy "
        f"tokens identical on {device} and cpu")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class MainRun:
    """Runs and checks the main path's requests; every request starts
    with the flash launch count at 0 and must end with ``n_layer`` per
    prefill."""

    def __init__(self, n_layer: int, device, card: str):
        self.n_layer, self.device, self.card = n_layer, device, card
        self.launches = 0

    def timed(self, fn, prefills: int):
        from pytorch_distributed_template_tpu_torch.ops.flash import (
            FLASH_FWD as counter,
        )

        is_cuda = torch.device(self.device).type == "cuda"
        if is_cuda:
            torch.cuda.reset_peak_memory_stats()
        _sync(self.device)
        counter.launches = 0
        t0 = time.perf_counter()
        out = fn()
        _sync(self.device)
        secs = time.perf_counter() - t0
        got = counter.launches
        if got != self.n_layer * prefills:
            raise AssertionError(
                f"flash_fwd launched {got} times for {prefills} prefill(s) "
                f"of {self.n_layer} layers")
        self.launches += got
        peak = torch.cuda.max_memory_allocated() if is_cuda else 0
        return out, secs, peak

    def report(self, name, batch, prompt_len, new, first_s, full_s, peak):
        decode_ms = (full_s - first_s) * 1e3 / max(new - 1, 1)
        row = {"request": name, "batch": batch, "prompt_len": prompt_len,
               "new_tokens": new, "prefill_ms": first_s * 1e3,
               "decode_ms_per_token": decode_ms,
               "tokens_per_s": batch * new / full_s,
               "decode_tokens_per_s": batch * 1e3 / decode_ms,
               "request_s": full_s, "peak_mem_gib": peak / 2 ** 30,
               "flash_launches_per_prefill": self.n_layer,
               "card": self.card}
        log("[main] " + json.dumps(row))


def profile_request(service, ids, new: int, label: str, card: str) -> None:
    """One request under ``torch.profiler``: wall time (host clock to
    ``cuda.synchronize``), the device's busy time (union of kernel and copy
    intervals), its idle share, the device ops per generated token and the
    kernels that take most of the time. Launches here are outside the main
    path's counts."""
    device = service.device
    row = _profiled(lambda: service.generate(prompt_ids=ids,
                                             max_new_tokens=new), device)
    row = {"profile": label, "prompt_len": len(ids), "new_tokens": new,
           **row, "device_ops_per_token": row["device_ops"] / new,
           "card": card}
    log("[profile] " + json.dumps(row))


def _profiled(fn, device, top_n: int = 8, sums=()) -> dict:
    """Run ``fn`` under ``torch.profiler``: wall time (host clock to
    ``cuda.synchronize``), the device's busy time (union of kernel and copy
    intervals; user annotations left out), its idle share, the device op count and the kernels that
    take most of the time; ``<name>_ms`` for each name of ``sums``: the
    device time of the kernels whose names hold it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        # user annotations (the optimizer's and DDP's record_function
        # ranges) sit on the device timeline but span the gaps between
        # kernels: only kernels and copies count as busy
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy = 0.0
    end = None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    b4_us = sum(us for k, (us, _) in by_name.items()
                if "paged_attn" in k or "paged_combine" in k)
    named = {f"{name}_ms": sum(us for k, (us, _) in by_name.items()
                               if name in k) / 1e3 for name in sums}
    return {"wall_ms": wall_us / 1e3, **named,
            "paged_attn_ms": b4_us / 1e3,
            "paged_attn_share_of_busy": b4_us / busy if busy else
            "not measured",
            "device_busy_ms": busy / 1e3 if spans else "not measured",
            "device_idle_share": 1 - busy / wall_us if spans
            else "not measured",
            "device_ops": len(spans),
            "top": [{"kernel": k[:90], "ms": us / 1e3, "count": n}
                    for k, (us, n) in top]}


def _check_ids(ids, vocab: int, n: int, what: str) -> None:
    if len(ids) != n or not all(0 <= int(i) < vocab for i in ids):
        raise AssertionError(f"{what}: expected {n} ids in [0, {vocab}), "
                             f"got {ids}")


def phase_main(card: str, device="cuda", arch=MAIN_ARCH, arch_args=None,
               sizes=None, work=WORK, seed: int = 0,
               keep_artifact: bool = False) -> int:
    """Make the artifact with the port's tool, serve requests (a)-(d) and
    the CLI on it; returns the flash launches of the whole path. The work
    directory is removed at the end unless ``keep_artifact`` (slice 2's
    phase serves the same artifact)."""
    from pytorch_distributed_template_tpu_torch import generate as gen_cli
    from pytorch_distributed_template_tpu_torch.config import ConfigParser
    from pytorch_distributed_template_tpu_torch.engine import generate as eg
    from pytorch_distributed_template_tpu_torch.engine.serving import (
        GenerationService,
    )
    from pytorch_distributed_template_tpu_torch.tools import (
        make_serving_artifact as tool,
    )

    sizes = dict(MAIN_SIZES, **(sizes or {}))
    new = sizes["new"]
    if work.exists():
        shutil.rmtree(work)
    art, run_dir = work / "art", work / "run"
    argv = ["-o", str(art), "--arch", arch, "--seed", str(seed),
            "--device", str(device)]
    for key, val in (arch_args or {}).items():
        argv += ["--" + key.replace("_", "-"), json.dumps(val)
                 if isinstance(val, bool) else str(val)]
    t0 = time.perf_counter()
    tool.main(argv)
    _sync(device)
    log(f"[main] artifact {arch} made in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    serve_argv = ["-r", str(art / "model"), "-s", str(run_dir)]
    _, config = ConfigParser.from_args(gen_cli.build_parser(), (),
                                       training=False, argv=serve_argv)
    service = GenerationService(config, device=device)
    model = service.model
    vocab = model.vocab_size
    log(f"[main] {arch} loaded on {service.device} in "
        f"{time.perf_counter() - t0:.1f} s: vocab {vocab}, {model.n_layer} "
        f"layers, {model.n_head}/{model.n_kv_head} heads, d_model "
        f"{model.d_model}, d_ff {model.d_ff}, window {model.window}, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, "
        f"{model.dtype}; card: {card}")
    run = MainRun(model.n_layer, device, card)
    rng = torch.Generator().manual_seed(seed + 1)

    def prompt(n, batch=1):
        return torch.randint(0, vocab, (batch, n), generator=rng)

    def serve(ids, n, **kw):
        return service.generate(prompt_ids=ids, max_new_tokens=n, **kw)

    # (a) 1024-token prompt, greedy, twice: identical ids
    a = prompt(sizes["prompt_a"])[0].tolist()
    first, first_s, _ = run.timed(lambda: serve(a, 1), 1)
    a1, full_s, peak = run.timed(lambda: serve(a, new), 1)
    a2, _, _ = run.timed(lambda: serve(a, new), 1)
    _check_ids(a1["ids"], vocab, new, "(a)")
    if a1["ids"] != a2["ids"] or first["ids"] != a1["ids"][:1]:
        raise AssertionError(f"(a) greedy runs differ: {a1['ids']} vs "
                             f"{a2['ids']} (first token {first['ids']})")
    run.report("a_greedy", 1, len(a), new, first_s, full_s, peak)

    # the generate CLI on the same artifact and request: same tokens
    cli_argv = serve_argv + ["--prompt-ids", ",".join(map(str, a)),
                             "--max-new-tokens", str(new),
                             "--device", str(device)]
    cli, cli_s, _ = run.timed(lambda: gen_cli.main(cli_argv), 1)
    if cli["ids"] != a1["ids"]:
        raise AssertionError(f"generate CLI {cli['ids']} != service "
                             f"{a1['ids']}")
    log(f"[main] generate CLI (loads the artifact itself): same {new} "
        f"tokens as the service, {cli_s:.1f} s")
    gc.collect()

    # (b) past the window: rolling cache, banded kernel
    b = prompt(sizes["prompt_b"])[0].tolist()
    total_b = len(b) + new
    if model.window and total_b > model.window:
        assert model.cache_len(total_b) == model.window
    first, first_s, _ = run.timed(lambda: serve(b, 1), 1)
    b1, full_s, peak = run.timed(lambda: serve(b, new), 1)
    _check_ids(b1["ids"], vocab, new, "(b)")
    if first["ids"] != b1["ids"][:1]:
        raise AssertionError("(b) first token differs between requests")
    run.report("b_past_window", 1, len(b), new, first_s, full_s, peak)

    # (c) sampled with a stop id: the stopped request is the free one cut
    # at the stop token's first appearance
    sample = dict(temperature=0.8, top_p=0.95, seed=1)
    free, full_s, peak = run.timed(lambda: serve(a, new, **sample), 1)
    _check_ids(free["ids"], vocab, new, "(c)")
    stop = free["ids"][new // 3]
    cut = free["ids"].index(stop)
    stopped, stop_s, _ = run.timed(
        lambda: serve(a, new, stop=[stop], **sample), 1)
    if stopped["ids"] != free["ids"][:cut] or \
            stopped["stop_reason"] != "stop":
        raise AssertionError(f"(c) stop request {stopped} is not the free "
                             f"one {free['ids']} cut at {stop}")
    first, first_s, _ = run.timed(lambda: serve(a, 1, **sample), 1)
    run.report("c_sampled", 1, len(a), new, first_s, full_s, peak)
    log(f"[main] (c) stop id {stop}: {len(stopped['ids'])} tokens, "
        f"stop_reason {stopped['stop_reason']}, {stop_s:.3f} s")

    # (d) a batch through engine.generate.generate
    d = prompt(sizes["prompt_d"], sizes["batch_d"]).to(service.device)
    _, first_s, _ = run.timed(
        lambda: eg.generate(model, d, 1, temperature=0.0), 1)
    out, full_s, peak = run.timed(
        lambda: eg.generate(model, d, new, temperature=0.0), 1)
    if out.shape != (d.shape[0], d.shape[1] + new) or \
            not torch.equal(out[:, :d.shape[1]], d):
        raise AssertionError(f"(d) output shape {tuple(out.shape)}")
    for row in out[:, d.shape[1]:].tolist():
        _check_ids(row, vocab, new, "(d)")
    run.report("d_batch", d.shape[0], d.shape[1], new, first_s, full_s,
               peak)

    # where the time goes: the prefill alone, then prefill + decode
    profile_request(service, a, 1, "a_prefill", card)
    profile_request(service, a, new, "a_request", card)
    del service, model
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    if not keep_artifact:
        shutil.rmtree(work)
    return run.launches

# ---------------------------------------------------------------------------
# slice 2: continuous paged serving, kernel B4
# ---------------------------------------------------------------------------

PAGED_SOURCE = "pytorch_distributed_template_tpu_torch/csrc/paged_attn.cu"
PAGED_REPLACES = "pytorch_distributed_template_tpu/ops/flash.py:620"
# (name, B, T, Hq, KVH, D, bt, NB, window, layout, dtype, quant): the main
# path's launches (Mistral-7B: 32/8 heads, D 128, bt 32, the 145-page ring
# of window 4096 + 1 + 512/32 slack; a long prompt's first chunk sees a flat
# table of 16 pages) and one f32 case at D 64
PAGED_SHAPES = [
    ("decode_ring", 8, 1, 32, 8, 128, 32, 145, 4096, "ring",
     torch.bfloat16, False),
    ("decode_ring_int8", 8, 1, 32, 8, 128, 32, 145, 4096, "ring",
     torch.bfloat16, True),
    ("decode_flat", 8, 1, 32, 8, 128, 32, 64, 0, "flat",
     torch.bfloat16, False),
    ("prefill_chunk", 1, 512, 32, 8, 128, 32, 145, 4096, "chunk",
     torch.bfloat16, False),
    ("prefill_first", 1, 512, 32, 8, 128, 32, 145, 0, "first",
     torch.bfloat16, False),
    ("admit_feed", 8, 64, 32, 8, 128, 32, 145, 4096, "feed",
     torch.bfloat16, False),
    ("f32_d64", 4, 16, 16, 4, 64, 16, 40, 0, "flat", torch.float32, False),
]
PAGED_POOL_PAGES = 1280
# slice 2's main path: Mistral at full width served by the port's serve.py
# over configs/mistral_7b_serve_paged.json (32-token blocks, 1280 pages,
# 512-token prefill chunks)
SERVE_CONFIG = REPO / "pytorch_distributed_template_tpu_torch" / "configs" \
    / "mistral_7b_serve_paged.json"
SERVE_SIZES = {"prefix": 1024, "shared_suffix": [128, 384, 640, 1024],
               "alone": [256, 512, 1024, 1536], "new": 64, "long": 6144,
               "long_new": 64, "short": 128, "short_new": 128,
               "logit_prompt": 1024, "slots": 8, "chunk": 8}
# last-position logits of the paged batch-1 prefill against slice 1's
# flash prefill, bf16 at 32 layers: the two paths round K/V, P and the
# residual stream at different places, so they agree to a few bf16 ulps
# of the logits' scale: max |diff| <= 5% of max |logit|
SERVE_LOGIT_RTOL = 0.05
# phase 3b: the small f32 model with block 8 and 16-token prefill chunks
PAGED_REF_POOL = {"enabled": True, "block_tokens": 8, "pool_blocks": 96,
                  "paged": True}


def _paged_case(name, b, t, hq, kvh, d, bt, nb, window, layout, dtype,
                quant, gen):
    """Inputs of one B4 shape on the card: random pools of
    ``PAGED_POOL_PAGES`` pages and each row's table as the engine lays it
    (distinct random pages; ``-1`` past a row's allocation)."""
    from pytorch_distributed_template_tpu_torch.models.quant import (
        quantize_kv,
    )

    dev = "cuda"
    pages = PAGED_POOL_PAGES
    q = torch.randn((b, t, hq, d), generator=gen, device=dev).to(dtype)
    kp = torch.randn((pages, bt, kvh, d), generator=gen, device=dev)
    vp = torch.randn((pages, bt, kvh, d), generator=gen, device=dev)
    ks = vs = None
    if quant:
        kp, ks = quantize_kv(kp)
        vp, vs = quantize_kv(vp)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    cpu = torch.Generator().manual_seed(b * 1000 + t)
    tables = torch.full((b, nb), -1, dtype=torch.int32)
    pads = torch.zeros((b,), dtype=torch.int32)
    if layout == "chunk":
        starts = torch.tensor([5120], dtype=torch.int32)
    elif layout == "first":
        starts = torch.tensor([0], dtype=torch.int32)
    elif layout == "flat":
        lens = torch.randint(500, 2001, (b,), generator=cpu)
        lens = lens.clamp(max=nb * bt)
        starts = (lens - t).int()
    elif layout == "feed":
        starts = torch.randint(64, 2000, (b,), generator=cpu).int()
        pads = torch.randint(0, t, (b,), generator=cpu).int()
    else:                                         # decode ring
        starts = torch.randint(300, 6001, (b,), generator=cpu).int()
    for i in range(b):
        end = int(starts[i]) + t                  # tokens written so far
        n = min(nb, -(-end // bt))
        perm = torch.randperm(pages - 1, generator=cpu)[:n] + 1
        if layout in ("flat", "first") or end <= nb * bt:
            tables[i, :n] = perm.int()
        else:
            tables[i] = perm.int()                # a full (wrapped) ring
    if layout not in ("chunk", "first"):
        tables[0, -1] = -1                        # one unallocated lane
    to = [x.to(dev) for x in (tables, starts, pads)]
    return q, kp, vp, ks, vs, *to


def _sdpa_paged_ms(q, kp, vp, ks, vs, tables, starts, pads, window, reps):
    """``scaled_dot_product_attention`` on K/V gathered contiguously in
    advance (the gather is not timed), with the same boolean mask: the
    yardstick, since no single PyTorch call reads a block table."""
    import torch.nn.functional as F

    from pytorch_distributed_template_tpu_torch.ops.flash import (
        paged_gather, paged_visible,
    )

    k_all = paged_gather(kp, tables, ks, q.dtype).transpose(1, 2)
    v_all = paged_gather(vp, tables, vs, q.dtype).transpose(1, 2)
    k_all, v_all = k_all.contiguous(), v_all.contiguous()
    mask = paged_visible(tables, starts, pads, q.shape[1], kp.shape[1],
                         window)[:, None]
    qt = q.transpose(1, 2).contiguous()
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, k_all, v_all, attn_mask=mask, enable_gqa=True), reps)


def _host_ms(fn, calls: int = 100, batches: int = 7) -> float:
    """Host time of one call of ``fn``: the median over ``batches`` of the
    mean enqueue time of ``calls`` back-to-back calls, the card idle when
    each batch starts (the median, since the host is shared)."""
    fn()
    means = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        means.append((time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    return sorted(means)[batches // 2]


def phase_paged_kernel() -> list:
    """B4 against its plain version on the card at the main path's
    shapes: the arm each takes, max error over valid lanes (pad lanes must
    be exactly 0), kernel / plain / SDPA times, the card's bound and the
    wrapper's host time per call (the enqueue of back-to-back calls)."""
    from pytorch_distributed_template_tpu_torch.ops.flash import (
        PAGED_ARM_LAUNCHES, PAGED_ATTN, paged_arm, paged_attention,
        paged_attention_ref, paged_bound_seconds,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for shape in PAGED_SHAPES:
        (name, b, t, hq, kvh, d, bt, nb, window, layout, dtype,
         quant) = shape
        q, kp, vp, ks, vs, tables, starts, pads = _paged_case(*shape, gen)
        args = (q, kp, vp, tables, starts, pads)
        kw = dict(window=window, k_scale=ks, v_scale=vs)
        arm = paged_arm(dtype, bt, t * (hq // kvh))
        before = PAGED_ARM_LAUNCHES[arm]
        out = paged_attention(*args, **kw)
        torch.cuda.synchronize()
        if PAGED_ARM_LAUNCHES[arm] != before + 1:
            raise AssertionError(f"B4 {name}: the {arm} arm did not launch")
        f32 = (lambda x: x) if quant else (lambda x: x.float())
        ref = paged_attention_ref(q.float(), f32(kp), f32(vp), tables,
                                  starts, pads, **kw)
        atol, rtol, _ = TOL[dtype]
        err, excess = 0.0, 0.0
        for i, p in enumerate(pads.tolist()):
            diff = (out[i, p:].float() - ref[i, p:]).abs()
            err = max(err, diff.max().item())
            excess = max(excess,
                         (diff - rtol * ref[i, p:].abs()).max().item())
            if p and out[i, :p].float().abs().max().item() != 0.0:
                raise AssertionError(f"B4 {name}: pad lanes not zero")
        if not torch.isfinite(out).all():
            raise AssertionError(f"B4 {name}: non-finite output")
        if excess > atol:
            raise AssertionError(
                f"paged_attn disagrees with its plain version at {name}: "
                f"max err {err:.3e}, max(err - {rtol}|ref|) {excess:.3e} "
                f"(atol {atol})")
        del ref
        reps = 20 if t > 64 else 50
        kernel_ms = cuda_ms(lambda: paged_attention(*args, **kw), reps)
        ref_ms = cuda_ms(lambda: paged_attention_ref(*args, **kw),
                         max(2, reps // 10), warmup=1)
        library_ms = _sdpa_paged_ms(q, kp, vp, ks, vs, tables, starts, pads,
                                    window, reps)
        host_ms = _host_ms(lambda: paged_attention(*args, **kw))
        bound_s, bound_by = paged_bound_seconds(
            q, kp, tables, starts, pads, window, quant, PEAK_FLOPS[dtype],
            PEAK_BYTES)
        row = {"shape": name, "arm": arm, "B": b, "T": t, "Hq": hq,
               "KVH": kvh, "D": d, "bt": bt, "NB": nb, "window": window,
               "dtype": str(dtype).replace("torch.", ""),
               "kv": "int8" if quant else str(dtype).replace("torch.", ""),
               "max_abs_err": err, "atol_rtol": [atol, rtol],
               "kernel_ms": kernel_ms, "ref_ms": ref_ms,
               "library_ms": library_ms, "bound_ms": bound_s * 1e3,
               "bound_by": bound_by, "host_ms_per_call": host_ms,
               "library": "scaled_dot_product_attention on K/V gathered "
                          "in advance (gather not timed), same mask"}
        rows.append(with_ratios(row))
        log("[paged] " + json.dumps(row))
        del q, kp, vp, ks, vs, out
        torch.cuda.empty_cache()
    PAGED_ATTN.launches = 0
    return rows


def _concurrent(fn, items, timeout=600.0):
    """``fn(item)`` for every item in its own thread; results in order.
    Raises the first error; fails when a thread is still running at the
    timeout."""
    import threading

    out, errs = [None] * len(items), []

    def call(i):
        try:
            out[i] = fn(items[i])
        except Exception as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=call, args=(i,), daemon=True)
               for i in range(len(items))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout)
    if any(th.is_alive() for th in threads):
        raise AssertionError("requests still running after the timeout")
    if errs:
        raise errs[0]
    return out


def phase_paged_reference(device="cuda") -> None:
    """The small f32 Llama (D 64, window 16, block 8) served by the
    continuous engine over the paged pool on ``device`` (B4) and on the
    CPU (plain version): 6 concurrent greedy requests, some streamed and
    some wrapping the ring, give the same tokens; also with the int8
    pool."""
    import pytorch_distributed_template_tpu_torch.models  # noqa: F401
    from pytorch_distributed_template_tpu_torch.config.registry import MODELS
    from pytorch_distributed_template_tpu_torch.engine.continuous import (
        ContinuousBatchingService,
    )

    rng = np.random.default_rng(9)
    reqs = [{"prompt_ids": [int(x) for x in rng.integers(
        0, REF_ARCH["vocab_size"], n)], "max_new_tokens": 24}
        for n in (5, 12, 20, 33, 47, 70)]
    for kv_quant in ("", "int8"):
        results = []
        cpu_model = MODELS.get("Llama")(**REF_ARCH, kv_quant=kv_quant,
                                        device="cpu")
        cpu_model.init_weights(torch.Generator().manual_seed(2))
        for dev in (device, "cpu"):
            model = MODELS.get("Llama")(**REF_ARCH, kv_quant=kv_quant,
                                        device=dev)
            model.load_state_dict(cpu_model.state_dict())
            svc = ContinuousBatchingService.from_model(
                model, device=dev, slots=4, chunk=4, window_ms=20.0,
                prefix_cache=PAGED_REF_POOL, prefill_chunk_tokens=16)
            try:
                results.append([r["ids"] for r in _concurrent(
                    lambda r: svc.generate(**r), reqs)])
            finally:
                svc.close()
        if results[0] != results[1]:
            raise AssertionError(f"paged reference ({kv_quant or 'f32'} "
                                 f"pool): {device} {results[0]} vs cpu "
                                 f"{results[1]}")
        log(f"[paged-reference] small f32 Llama (D=64, window 16, block 8, "
            f"{kv_quant or 'f32'} pool), 6 concurrent requests of 5-70 "
            f"tokens + 24: greedy tokens identical on {device} and cpu")


class ServeRun:
    """The port's ``serve.py`` running in this process: ``main`` in a
    thread on a free port, stopped by :meth:`close`."""

    def __init__(self, argv, timeout=900.0):
        import threading

        from pytorch_distributed_template_tpu_torch import serve

        ready, self.errors, box = threading.Event(), [], {}

        def on_ready(server, service):
            box.update(server=server, service=service)
            ready.set()

        def target():
            try:
                serve.main(argv, on_ready)
            except BaseException as e:  # noqa: BLE001 — raised below
                self.errors.append(e)
                ready.set()

        self.thread = threading.Thread(target=target, daemon=True,
                                       name="serve-main")
        self.thread.start()
        if not ready.wait(timeout):
            raise AssertionError("serve.py did not become ready")
        if self.errors:
            raise self.errors[0]
        self.server, self.service = box["server"], box["service"]
        host, port = self.server.server_address[:2]
        self.host, self.port = host, port

    def close(self) -> None:
        self.server.shutdown()
        self.thread.join(300)
        if self.thread.is_alive():
            raise AssertionError("serve.py did not stop")
        if self.errors:
            raise self.errors[0]
        self.server = self.service = None


def stream_request(run: ServeRun, body: dict) -> dict:
    """One ``POST /generate`` with ``"stream": true`` over HTTP: the ids,
    the time to the first delta (TTFT) and to the last event, and the
    size of the first delta. The deltas must concatenate to the final
    ids."""
    import http.client

    conn = http.client.HTTPConnection(run.host, run.port, timeout=1200)
    t0 = time.perf_counter()
    conn.request("POST", "/generate", body=json.dumps(dict(body,
                                                           stream=True)),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        raise AssertionError(f"POST /generate: {resp.status} "
                             f"{resp.read()[:500]!r}")
    ttft, first_n, deltas, final = None, 0, [], None
    while True:
        line = resp.readline()
        if not line:
            break
        line = line.strip()
        if not line.startswith(b"data: "):
            continue
        event = json.loads(line[len(b"data: "):])
        if event.get("done"):
            final = event
            break
        if ttft is None:
            ttft, first_n = time.perf_counter() - t0, len(event["ids"])
        deltas.extend(event["ids"])
    total = time.perf_counter() - t0
    conn.close()
    if final is None or "error" in final:
        raise AssertionError(f"stream ended without a result: {final}")
    if deltas != final["ids"]:
        raise AssertionError("SSE deltas do not concatenate to the ids")
    return {"ids": final["ids"], "ttft_s": ttft, "total_s": total,
            "first_delta": first_n, "prompt_len": len(body["prompt_ids"])}


class ServeWave:
    """Counts and checks one wave of requests on slice 2's path: B4 and
    B1 launch counts set to 0 before, B4 launches == n_layer x the
    engine's model calls and B1 == 0 after, every id in range, warm admits
    copying nothing."""

    def __init__(self, card: str, device):
        self.card, self.device = card, device
        self.b4_launches = 0

    def run(self, label, service, drive, n_new: int):
        from pytorch_distributed_template_tpu_torch.ops.flash import (
            FLASH_FWD, PAGED_ARM_LAUNCHES, PAGED_ATTN,
        )

        is_cuda = torch.device(self.device).type == "cuda"
        _sync(self.device)
        if is_cuda:
            torch.cuda.reset_peak_memory_stats()
        FLASH_FWD.launches = PAGED_ATTN.launches = 0
        for arm in PAGED_ARM_LAUNCHES:
            PAGED_ARM_LAUNCHES[arm] = 0
        calls0 = service.stats["model_calls"]
        kinds = ("prefill_chunks", "admit_calls", "decode_calls")
        kinds0 = {k: service.stats[k] for k in kinds}
        t0 = time.perf_counter()
        results = drive()
        wall = time.perf_counter() - t0
        _sync(self.device)
        calls = service.stats["model_calls"] - calls0
        n_layer = service.model.n_layer
        if PAGED_ATTN.launches != n_layer * calls or calls == 0:
            raise AssertionError(
                f"({label}) paged_attn launched {PAGED_ATTN.launches} times "
                f"for {calls} model calls of {n_layer} layers")
        if FLASH_FWD.launches:
            raise AssertionError(f"({label}) flash_fwd launched "
                                 f"{FLASH_FWD.launches} times on the paged "
                                 "path")
        self.b4_launches += PAGED_ATTN.launches
        kind = {k: service.stats[k] - kinds0[k] for k in kinds}
        arms = dict(PAGED_ARM_LAUNCHES)
        if is_cuda:
            want = {"wgmma": n_layer * (kind["prefill_chunks"]
                                        + kind["admit_calls"]),
                    "decode": n_layer * kind["decode_calls"],
                    "cuda_cores": 0}
        else:
            want = {"wgmma": 0, "decode": 0, "cuda_cores": 0}
        if arms != want:
            raise AssertionError(f"({label}) B4 arms {arms} for engine "
                                 f"calls {kind}: expected {want}")
        vocab = service.model.vocab_size
        for r in results:
            _check_ids(r["ids"], vocab, r.get("new", n_new), f"({label})")
        pool = service.prefix_cache_stats()
        if pool["warm_admit_copy_bytes"] != 0:
            raise AssertionError(f"({label}) warm admits copied "
                                 f"{pool['warm_admit_copy_bytes']} bytes")
        peak = torch.cuda.max_memory_allocated() if is_cuda else 0
        for i, r in enumerate(results):
            n = len(r["ids"])
            decode = ((r["total_s"] - r["ttft_s"]) * 1e3
                      / (n - r["first_delta"])
                      if n > r["first_delta"] else "not measured")
            log("[serve] " + json.dumps({
                "wave": label, "request": i, "prompt_len": r["prompt_len"],
                "new_tokens": n, "ttft_ms": r["ttft_s"] * 1e3,
                "decode_ms_per_token": decode,
                "request_s": r["total_s"]}))
        log("[serve] " + json.dumps({
            "wave": label, "requests": len(results),
            "new_tokens": sum(len(r["ids"]) for r in results),
            "wall_s": wall,
            "tokens_per_s": sum(len(r["ids"]) for r in results) / wall,
            "model_calls": calls, "paged_attn_launches": PAGED_ATTN.launches,
            "paged_attn_arms": arms, "engine_calls": kind,
            "flash_fwd_launches": FLASH_FWD.launches,
            "peak_mem_gib": peak / 2 ** 30,
            "pool_blocks": pool["prefix_pool_blocks"],
            "pool_blocks_used": pool["prefix_pool_blocks_used"],
            "pool_blocks_resident": pool["prefix_pool_blocks_resident"],
            "pool_blocks_referenced": pool["prefix_pool_blocks_referenced"],
            "prefix_hit_tokens": pool["prefix_hit_tokens"],
            "warm_admit_copy_bytes": pool["warm_admit_copy_bytes"],
            "engine": {k: service.stats[k] for k in (
                "admissions", "chunks", "paged_chunks", "prefill_chunks",
                "deferred_admissions")},
            "card": self.card}))
        return results


def _wait_for(cond, what: str, timeout: float = 600.0) -> None:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def _mix_e(run: ServeRun, waves: ServeWave, label: str, sizes, prompts):
    """(e): 8 concurrent greedy requests, half sharing a prefix. The first
    sharing request goes first; the other 7 are sent once its streamed
    prefix has been adopted into the radix index, so they can hit it."""
    import threading

    svc = run.service
    pf = svc._prefix
    need = pf.counter("prefix_adopted_blocks") + sizes["prefix"] // pf.block
    bodies = [{"prompt_ids": p, "max_new_tokens": sizes["new"]}
              for p in prompts]

    def drive():
        first = {}
        th = threading.Thread(target=lambda: first.update(
            r=stream_request(run, bodies[0])), daemon=True)
        th.start()
        _wait_for(lambda: pf.counter("prefix_adopted_blocks") >= need
                  or not th.is_alive(), "the shared prefix's adoption")
        rest = _concurrent(lambda b: stream_request(run, b), bodies[1:])
        th.join(1200)
        if "r" not in first:
            raise AssertionError(f"({label}) first request failed")
        return [first["r"]] + rest

    out = waves.run(label, svc, drive, sizes["new"])
    hit = svc.prefix_cache_stats()["prefix_hit_tokens"]
    if hit <= 0:
        raise AssertionError(f"({label}) no prefix hit tokens after the "
                             "shared-prefix wave")
    return out


def _logit_check(service, n: int, seed: int) -> dict:
    """Last-position logits of an ``n``-token prompt through the paged
    batch-1 prefill (its own small pool; B4) against slice 1's fresh-cache
    flash prefill (B1), within ``SERVE_LOGIT_RTOL`` of the logits'
    scale."""
    from pytorch_distributed_template_tpu_torch.engine.kvcache import (
        PrefixCache,
    )

    model = service.model
    block = service._prefix.block
    ids = torch.randint(0, model.vocab_size, (n,),
                        generator=torch.Generator().manual_seed(seed))
    pc = PrefixCache(model, block_tokens=block,
                     pool_blocks=service._prefix.nb_max + 2,
                     ring_slack_tokens=service._prefix.ring_slack_tokens
                     or 512)
    with torch.no_grad():
        paged, _, plan = pc.paged_prefill(ids.tolist(), 1)
        pc.paged_finish(plan, [], 0)
        cache = model.new_cache(1, n + 1)
        flash = model(ids[None].to(model.device), cache=cache,
                      prefill=True)[:, -1]
    _sync(model.device)
    err = (paged - flash).abs().max().item()
    scale = flash.abs().max().item()
    row = {"prompt_len": n, "logits_max_abs_diff": err,
           "logits_mean_abs_diff": (paged - flash).abs().mean().item(),
           "logits_max_abs": scale, "rtol": SERVE_LOGIT_RTOL,
           "same_argmax": bool(paged.argmax() == flash.argmax())}
    if not (torch.isfinite(paged).all() and err <= SERVE_LOGIT_RTOL * scale):
        raise AssertionError(f"paged prefill logits differ from the flash "
                             f"prefill: {row}")
    del pc, cache
    return row


def phase_serve(card: str, model_path, config=SERVE_CONFIG, device="cuda",
                sizes=None, work=WORK, seed: int = 0) -> int:
    """Slice 2's main path: the port's ``serve.py`` on the artifact with
    the paged config, driven over HTTP. (e) 8 concurrent greedy requests
    of 256-2048 tokens, half sharing a 1024-token prefix; one of them
    alone, twice; (f) a 6144-token prompt streamed in 512-token chunks
    while 4 short requests decode; (g) the mix of (e) again with an int8
    pool. Returns B4's launches on the path."""
    sizes = dict(SERVE_SIZES, **(sizes or {}))
    run_dir = work / "serve_run"
    base = ["-r", str(model_path), "-c", str(config), "-s", str(run_dir),
            "--port", "0", "--max-batch", str(sizes["slots"]),
            "--decode-chunk", str(sizes["chunk"]), "--device", str(device)]
    gen = torch.Generator().manual_seed(seed + 7)
    t0 = time.perf_counter()
    run = ServeRun(base)
    svc = run.service
    vocab = svc.model.vocab_size

    def rand(n):
        return torch.randint(0, vocab, (n,), generator=gen).tolist()

    prefix = rand(sizes["prefix"])
    prompts = ([prefix + rand(n) for n in sizes["shared_suffix"]]
               + [rand(n) for n in sizes["alone"]])
    log(f"[serve] serve.py up in {time.perf_counter() - t0:.1f} s: "
        f"{type(svc).__name__} on {svc.device}, {svc.model.n_layer} layers, "
        f"pool {svc._prefix.pool_blocks} x {svc._prefix.block} tokens "
        f"({svc._prefix.page_bytes / 2 ** 20:.2f} MiB/page), ring "
        f"{svc._prefix.nb_max} pages, prefill chunk {svc._prefill_chunk}")
    waves = ServeWave(card, device)
    try:
        e_out = _mix_e(run, waves, "e", sizes, prompts)
        solo = [waves.run(f"e_alone_{i}", svc, lambda: [stream_request(
            run, {"prompt_ids": prompts[-1],
                  "max_new_tokens": sizes["new"]})], sizes["new"])[0]
            for i in range(2)]
        if solo[0]["ids"] != solo[1]["ids"]:
            raise AssertionError("a request served alone twice gave "
                                 f"{solo[0]['ids']} then {solo[1]['ids']}")
        log(f"[serve] (e) request served alone twice: identical ids; equal "
            f"to its batched run: {solo[0]['ids'] == e_out[-1]['ids']}")
        # where a decode step's time goes on this path (outside the
        # counted waves)
        profile_request(svc, prompts[-1], sizes["new"], "serve_alone", card)

        def drive_f():
            import threading

            shorts = [{"prompt_ids": rand(sizes["short"]),
                       "max_new_tokens": sizes["short_new"]}
                      for _ in range(4)]
            box = {}
            th = threading.Thread(target=lambda: box.update(r=_concurrent(
                lambda b: stream_request(run, b), shorts)), daemon=True)
            th.start()
            _wait_for(lambda: svc.live_slots() >= 4 or not th.is_alive(),
                      "the short requests to decode")
            long = stream_request(run, {"prompt_ids": rand(sizes["long"]),
                                        "max_new_tokens": sizes["long_new"]})
            long["new"] = sizes["long_new"]
            th.join(1200)
            if "r" not in box:
                raise AssertionError("(f) short requests failed")
            return box["r"] + [long]

        chunks0 = svc.stats["prefill_chunks"]
        waves.run("f", svc, drive_f, sizes["short_new"])
        if svc.stats["prefill_chunks"] - chunks0 < \
                sizes["long"] // max(svc._prefill_chunk, 1) - 1:
            raise AssertionError("(f) the long prompt did not stream")
        logits = _logit_check(svc, sizes["logit_prompt"], seed + 11)
        log("[serve] logits " + json.dumps(dict(logits, card=card)))
    finally:
        run.close()
    del run, svc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    run = ServeRun(base + ["--set", "serving;kv_quant", "int8"])
    try:
        if run.service.model.kv_quant != "int8":
            raise AssertionError("(g) the int8 pool was not configured")
        _mix_e(run, waves, "g_int8", sizes, prompts)
    finally:
        run.close()
    del run
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return waves.b4_launches


# ---------------------------------------------------------------------------
# slice 3: LM training, kernels B2 and B3
# ---------------------------------------------------------------------------

BWD_SOURCE = "pytorch_distributed_template_tpu_torch/csrc/flash_bwd.cu"
BWD_REPLACES = {"flash_bwd_dkv":
                "pytorch_distributed_template_tpu/ops/flash.py:280",
                "flash_bwd_dq":
                "pytorch_distributed_template_tpu/ops/flash.py:365"}
# (name, B, H, KVH, T, D, causal, window, dtype, lse cotangent): the
# training main path's shape first (GPT-2 small: 12 heads, D 64, T 1024,
# batch 8), Mistral's head shape with GQA, a banded, a ragged f32 and a
# non-causal banded case, and one case through both outputs of
# flash_attention_lse
BWD_SHAPES = [
    ("gpt2_small", 8, 12, 12, 1024, 64, True, 0, torch.bfloat16, False),
    ("moe_lm", 32, 8, 8, 512, 64, True, 0, torch.bfloat16, False),
    ("mistral_gqa", 1, 32, 8, 2048, 128, True, 0, torch.bfloat16, False),
    ("banded", 2, 16, 4, 2048, 128, True, 512, torch.bfloat16, False),
    ("ragged_f32", 1, 16, 4, 1000, 64, True, 0, torch.float32, False),
    ("noncausal_banded", 2, 8, 8, 512, 32, False, 128, torch.bfloat16,
     False),
    ("lse_cotangent", 2, 12, 12, 512, 64, True, 0, torch.bfloat16, True),
]
# |got - ref| <= a * max|ref| + r * |ref| + 1e-5 against the plain backward
# in f32 on the same inputs. bf16 (1e-2, 1.6e-2): the kernels round P and dS
# to bf16 as operands (2^-9 relative each) and the gradients to bf16 once
# (2^-8). f32 (1e-5, 1e-4): summation order only. The 1e-5 floor covers
# gradients that are 0 in exact arithmetic.
BWD_TOL = {torch.bfloat16: (1e-2, 1.6e-2), torch.float32: (1e-5, 1e-4)}
# phase 3c: small f32 models, head_dim 64 so the kernels take them
TRAIN_REF = {
    "GPT2": {"size": "gpt2-small", "vocab_size": 512, "max_len": 64,
             "n_layer": 2, "n_head": 2, "d_model": 128, "dropout": 0.0,
             "attn_impl": "flash", "fused_head": True, "remat": True},
    "Llama": {"vocab_size": 512, "n_layer": 2, "n_head": 4, "n_kv_head": 2,
              "d_model": 256, "max_len": 64, "window": 16,
              "attn_impl": "flash"},
}
TRAIN_REF_STEPS = 5
# per-step losses rtol 1e-5; final params atol 1e-4: float32 on both sides
# (cuBLAS f32 GEMMs without TF32, the kernels' f32 arms), so the runs
# differ by summation order, which Adam's normalised updates keep small
TRAIN_REF_TOL = {"loss_rtol": 1e-5, "param_atol": 1e-4}
# slice 3's main path: GPT-2 small at full width through the port's
# train.py; only the sample counts and the epochs are cut
TRAIN_CONFIG = REPO / "pytorch_distributed_template_tpu_torch" / "configs" \
    / "gpt2_small_train.json"
TRAIN_SETS = [("train_loader;args;n", 256), ("valid_loader;args;n", 64),
              ("trainer;epochs", 2), ("trainer;save_period", 1)]
# resumed epoch 2 against the uninterrupted one, bf16: the same batches,
# dropout masks and updates; the embedding gradient's scatter-add may sum
# in another order, which the relative 1e-3 covers
RESUME_RTOL = 1e-3


def _grad_error(got, ref, dtype):
    """(max abs err, max(err - limit)): the check passes when the second
    is <= 0."""
    a, r = BWD_TOL[dtype]
    ref = ref.float()
    err = (got.float() - ref).abs()
    limit = a * ref.abs().max() + r * ref.abs() + 1e-5
    return err.max().item(), (err - limit).max().item()


def _sdpa_bwd_ms(q, k, v, g, causal: bool, window: int, reps: int):
    """Time of the backward of one ``scaled_dot_product_attention`` call on
    the same inputs (yardstick only; the port never calls it)."""
    import torch.nn.functional as F

    from pytorch_distributed_template_tpu_torch.ops.flash import (
        visible_mask,
    )

    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    t = q.shape[1]
    kw = {"enable_gqa": True} if k.shape[2] != q.shape[2] else {}
    if 0 < window < t:
        kw["attn_mask"] = visible_mask(t, t, causal, window, q.device)
    else:
        kw["is_causal"] = causal
    out = F.scaled_dot_product_attention(qt, kt, vt, **kw)
    gt = g.transpose(1, 2).contiguous()
    ms = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                             retain_graph=True), reps)
    del out
    return ms


def phase_bwd_kernel() -> list:
    """B2 and B3 against the plain backward on the card: max errors, the
    arm, kernel / plain / SDPA-backward times and the card's bound per
    kernel, one row each per shape, and a ``flash_bwd_pair`` row per shape
    (``flash_attention_bwd`` whole: B3 with delta, then B2) whose bound is
    the whole backward's, each product and array counted once. Returns
    the kernels' rows, then the pairs'."""
    from pytorch_distributed_template_tpu_torch.ops import flash

    gen = torch.Generator(device="cuda").manual_seed(3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, pairs = [], []
    for (name, b, h, kvh, t, d, causal, window, dtype,
         with_lse) in BWD_SHAPES:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.float32)

        q = rnd(b, t, h, d).to(dtype)
        k, v = rnd(b, t, kvh, d).to(dtype), rnd(b, t, kvh, d).to(dtype)
        g = rnd(b, t, h, d).to(dtype)
        g_lse = rnd(b, h, t) if with_lse else None
        out, lse = flash.flash_attention_lse(q, k, v, causal=causal,
                                             window=window)
        got = flash.flash_attention_bwd(q, k, v, out, lse, g, causal,
                                        window, g_lse)
        torch.cuda.synchronize()
        ref = flash.flash_attention_bwd_ref(
            q.float(), k.float(), v.float(), out.float(), lse, g.float(),
            causal=causal, window=window, g_lse=g_lse)
        errs = {}
        for gname, x, want in zip(("dq", "dk", "dv"), got, ref):
            if not torch.isfinite(x).all():
                raise AssertionError(f"B2/B3 {name}: non-finite {gname}")
            err, excess = _grad_error(x, want, dtype)
            if excess > 0:
                raise AssertionError(
                    f"flash backward disagrees with its plain version at "
                    f"{name}: {gname} max err {err:.3e} exceeds the limit "
                    f"by {excess:.3e} (tol {BWD_TOL[dtype]} + 1e-5)")
            errs[gname] = err
        del got, ref
        reps = 20
        arm = "wgmma" if dtype == torch.bfloat16 else "cuda_cores"
        splits = 1 if arm == "cuda_cores" else flash.bwd_splits(
            b, t, h, kvh, causal, window, sms)
        # B3 alone writes delta, which B2 alone then reads
        delta = torch.empty((b, h, t), dtype=torch.float32, device="cuda")
        args = (q, k, v, out, g, lse, g_lse, causal, window)
        ms = {kern: cuda_ms(lambda kern=kern: flash._flash_bwd_cuda(
            *args, kernels=(kern,), delta=delta), reps)
            for kern in flash.BWD_KERNELS}
        pair_ms = cuda_ms(lambda: flash.flash_attention_bwd(
            q, k, v, out, lse, g, causal, window, g_lse), reps)
        plain_ms = cuda_ms(lambda: flash.flash_attention_bwd_ref(
            q, k, v, out, lse, g, causal, window, g_lse), 3, warmup=1)
        library_ms = _sdpa_bwd_ms(q, k, v, g, causal, window, reps)
        head = {"shape": name, "B": b, "H": h, "KVH": kvh, "T": t, "D": d,
                "causal": causal, "window": window,
                "dtype": str(dtype).replace("torch.", ""),
                "lse_cotangent": with_lse, "arm": arm,
                "tol": list(BWD_TOL[dtype]), "ref_ms": plain_ms,
                "library_ms": library_ms,
                "plain": "flash_attention_bwd_ref (dq, dk, dv together)",
                "library": "backward of scaled_dot_product_attention "
                           "(dq, dk, dv together)"}
        bounds = {}
        for kern, gnames in (("flash_bwd_dkv", ("dk", "dv")),
                             ("flash_bwd_dq", ("dq",))):
            bounds[kern] = flash.flash_bwd_bound_seconds(
                kern, b, t, h, kvh, d, causal, window, q.element_size(),
                PEAK_FLOPS[dtype], PEAK_BYTES, lse_cotangent=with_lse)
            row = {"kernel": kern, **head,
                   "max_abs_err": max(errs[n] for n in gnames),
                   "kernel_ms": ms[kern], "bound_ms": bounds[kern][0] * 1e3,
                   "bound_by": bounds[kern][1]}
            if kern == "flash_bwd_dkv":
                row["splits"] = splits
            rows.append(with_ratios(row))
            log("[bwd] " + json.dumps(row))
        pair_bound = flash.flash_bwd_bound_seconds(
            "flash_bwd_pair", b, t, h, kvh, d, causal, window,
            q.element_size(), PEAK_FLOPS[dtype], PEAK_BYTES,
            lse_cotangent=with_lse)
        pair = {"kernel": "flash_bwd_pair", **head,
                "max_abs_err": max(errs.values()), "kernel_ms": pair_ms,
                "bound_ms": pair_bound[0] * 1e3, "bound_by": pair_bound[1],
                "splits": splits}
        pairs.append(with_ratios(pair))
        log("[bwd] " + json.dumps(pair))
        del q, k, v, g, out, lse, delta
        torch.cuda.empty_cache()
    flash.FLASH_BWD_DKV.launches = flash.FLASH_BWD_DQ.launches = 0
    flash.FLASH_FWD.launches = 0
    return rows + pairs


def _train_ref_run(name, args, state, batches, device):
    """``TRAIN_REF_STEPS`` AdamW steps of a ``name`` model on ``device``
    from ``state``: (per-step losses, final params on the CPU)."""
    import pytorch_distributed_template_tpu_torch.models  # noqa: F401
    from pytorch_distributed_template_tpu_torch.config.registry import (
        MODELS,
    )
    from pytorch_distributed_template_tpu_torch.engine import (
        losses, optim, steps,
    )

    model = MODELS.get(name)(**args, device=device,
                             param_dtype=torch.float32)
    model.load_state_dict(state)
    opt = optim.OPTIMIZERS.get("AdamW")(
        model, lr=1e-3, betas=(0.9, 0.95), weight_decay=0.1,
        weight_decay_exclude=["bias$", "ln_", "wpe", "norm"])
    crit = (losses.fused_lm_cross_entropy(16) if args.get("fused_head")
            else losses.lm_cross_entropy)
    step = steps.make_train_step(model, opt, crit, input_key="tokens",
                                 target_key="tokens", grad_clip_norm=1.0)
    out = []
    for batch in batches:
        m = step({k: torch.from_numpy(v).to(device)
                  for k, v in batch.items()})
        out.append(float(m["loss_sum"]) / float(m["count"]))
    return out, {k: v.detach().cpu() for k, v in model.state_dict().items()}


def phase_train_reference(device="cuda") -> None:
    """Small f32 GPT2 (flash, fused head, remat) and windowed GQA Llama
    (flash) trained ``TRAIN_REF_STEPS`` steps on ``device`` (kernels) and on
    the CPU (plain versions) from the same converted weights and batches:
    per-step losses and final params within ``TRAIN_REF_TOL``."""
    import pytorch_distributed_template_tpu_torch.models  # noqa: F401
    from pytorch_distributed_template_tpu_torch.config.registry import (
        MODELS,
    )
    from pytorch_distributed_template_tpu_torch.data.datasets import (
        synthetic_lm,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, args in TRAIN_REF.items():
        cpu = MODELS.get(name)(**args, device="cpu")
        cpu.init_weights(torch.Generator().manual_seed(7))
        state = cpu.state_dict()
        toks = synthetic_lm(n=4 * TRAIN_REF_STEPS, seq_len=args["max_len"],
                            vocab_size=args["vocab_size"], seed=1)["tokens"]
        batches = [{"tokens": toks[4 * i:4 * i + 4],
                    "mask": np.ones(4, bool)}
                   for i in range(TRAIN_REF_STEPS)]
        dev_loss, dev_p = _train_ref_run(name, args, state, batches, device)
        cpu_loss, cpu_p = _train_ref_run(name, args, state, batches, "cpu")
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(dev_loss,
                                                           cpu_loss))
        param_err = max((dev_p[k] - cpu_p[k]).abs().max().item()
                        for k in cpu_p)
        row = {"model": name, "steps": TRAIN_REF_STEPS,
               "losses_device": dev_loss, "losses_cpu": cpu_loss,
               "loss_max_rel_err": loss_err, "param_max_abs_err": param_err,
               "tol": TRAIN_REF_TOL, "device": str(device)}
        log("[train-reference] " + json.dumps(row))
        if not (loss_err <= TRAIN_REF_TOL["loss_rtol"]
                and param_err <= TRAIN_REF_TOL["param_atol"]):
            raise AssertionError(f"small f32 {name} training on {device} "
                                 f"differs from the CPU: {row}")


TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                 "expert_ffn")


class TrainRun:
    """Wraps a trainer's train and eval steps: counts the kernels'
    launches of each step from 0 and checks them exactly (a train step: B1
    n_layer, twice that with remat, B2 and B3 n_layer each, B5 once per
    MoE layer, all of it once per microbatch with ``grad_accum_steps``;
    an eval step: B1 n_layer, B5 once per MoE layer, no B2/B3),
    times each step (host clock to ``cuda.synchronize``) and keeps its
    loss.

    With ``warns`` (the list of a ``warnings.catch_warnings(record=True)``
    around the run) it also counts the synchronising calls of each train
    step with ``torch.cuda.set_sync_debug_mode("warn")`` on everywhere but
    in its own ``cuda.synchronize`` calls: a step's count covers the step
    and the trainer's loop work up to the next step (flight record, spans,
    health, logging), and so does its iteration time (from one step's
    start to the next's). :meth:`steady` reads both over the steady-state
    non-log steps (not the run's first step, not an epoch's last)."""

    def __init__(self, trainer, device, card: str, label: str, warns=None):
        from pytorch_distributed_template_tpu_torch.observability.profiler \
            import train_step_flops
        from pytorch_distributed_template_tpu_torch.ops import (
            expert_ffn, flash,
        )

        self.counters = (flash.FLASH_FWD, flash.FLASH_BWD_DKV,
                         flash.FLASH_BWD_DQ, expert_ffn.EXPERT_FFN)
        self.device, self.card, self.label = device, card, label
        self.launches = [0] * len(self.counters)
        self.steps, self.epoch_logs = [], []
        model = trainer.model
        layers = model.n_layer
        moe = sum(hasattr(block, "moe") for block in model.h)
        fwd = 2 if model.remat else 1     # remat recomputes each forward
        k = trainer.train_step.grad_accum_steps   # microbatches per step
        self.want = {"train": (k * fwd * layers, k * layers, k * layers,
                               k * fwd * moe),
                     "eval": (layers, 0, 0, moe)}
        loader = trainer.train_loader
        tokens = loader.arrays["tokens"].shape[1]
        self.tokens = loader.batch_size * tokens
        self.flops = train_step_flops(model, loader.batch_size, tokens)
        self.warns, self.log_step = warns, trainer.log_step
        self.marks = []   # per train step: (epoch, batch, start s, warns)
        self._epoch, self._batch = 0, 0
        trainer.train_step = self._wrap(trainer.train_step, "train")
        trainer.eval_step = self._wrap(trainer.eval_step, "eval")
        real_epoch = trainer._train_epoch

        def epoch(e):
            self._epoch, self._batch = e, 0
            out = real_epoch(e)
            self.epoch_logs.append(dict(out, epoch=e))
            log(f"[train] ({self.label}) epoch " + json.dumps(
                dict(out, epoch=e, card=card)))
            return out

        trainer._train_epoch = epoch

    def _wrap(self, fn, kind):
        """``fn`` counted and timed; other attributes (the train step's
        ``state_dict`` for checkpoints) pass through."""
        is_cuda = torch.device(self.device).type == "cuda"

        def mode(on: bool) -> None:
            # counting ends with the run (``warns`` set to None after it)
            if is_cuda and self.warns is not None:
                torch.cuda.set_sync_debug_mode("warn" if on else 0)

        def call(batch):
            mode(False)
            if kind == "train":
                self.marks.append((self._epoch, self._batch,
                                   time.perf_counter(),
                                   len(self.warns or ())))
                self._batch += 1
            _sync(self.device)
            for c in self.counters:
                c.launches = 0
            if is_cuda:
                torch.cuda.reset_peak_memory_stats()
            mode(True)
            t0 = time.perf_counter()
            m = fn(batch)
            mode(False)
            _sync(self.device)
            secs = time.perf_counter() - t0
            got = tuple(c.launches for c in self.counters)
            if got != self.want[kind]:
                raise AssertionError(
                    f"({self.label}) a {kind} step launched "
                    f"{TRAIN_KERNELS} = {got}, not {self.want[kind]}")
            self.launches = [a + b for a, b in zip(self.launches, got)]
            if kind == "train":
                loss = float(m["loss_sum"]) / max(float(m["count"]), 1.0)
                peak = torch.cuda.max_memory_allocated() if is_cuda else 0
                row = {"step": len(self.steps), "loss": loss,
                       "ms": secs * 1e3, "tokens_per_s": self.tokens / secs,
                       "mfu": self.flops / secs / PEAK_FLOPS[torch.bfloat16],
                       "peak_mem_gib": peak / 2 ** 30}
                self.steps.append(row)
                log(f"[train] ({self.label}) step " + json.dumps(row))
            mode(True)
            return m

        return _Wrapped(fn, call)

    def steady(self) -> dict:
        """Over the steady-state non-log train steps: the median
        iteration ms (a step's start to the next step's, the loop's work
        included) and the synchronising calls per step (mean and max);
        the first step of the run and each epoch's last have no window."""
        iters, syncs = [], []
        for (e0, b0, t0, n0), (e1, _, t1, n1) in zip(self.marks[1:],
                                                      self.marks[2:]):
            if e0 == e1 and b0 % self.log_step != 0:
                iters.append((t1 - t0) * 1e3)
                syncs.append(n1 - n0)
        return {"steps": len(iters),
                "iter_ms_median": float(np.median(iters)) if iters else None,
                "syncs_per_step_mean": (float(np.mean(syncs)) if syncs
                                        else None),
                "syncs_per_step_max": max(syncs) if syncs else None}


def _loop_spans(trainer) -> dict:
    """Medians over the steady non-log train steps of ``trace.json``'s
    spans: ``data/next_batch`` (waiting for the batch), ``train/step``
    (the step, with :class:`TrainRun`'s syncs) and the loop's own work from
    a step's end to the next batch's wait (records, health, spans), per
    step of one epoch."""
    path = trainer.config.log_dir / "trace.json"
    if not path.is_file():
        return {}
    events = json.loads(path.read_text())["traceEvents"]
    steps = sorted((e for e in events if e["name"] == "train/step"),
                   key=lambda e: e["ts"])
    waits = sorted((e for e in events if e["name"] == "data/next_batch"),
                   key=lambda e: e["ts"])
    parts = {"wait": [], "step": [], "loop": []}
    for e, nxt in zip(steps, steps[1:]):
        batch = e["args"]["step"] % trainer.len_epoch
        if (nxt["args"]["step"] != e["args"]["step"] + 1 or batch == 0
                or batch % trainer.log_step == 0):
            continue
        end = e["ts"] + e["dur"]
        wait = next((w for w in waits if end <= w["ts"] < nxt["ts"]), None)
        if wait is None:
            continue
        before = [w for w in waits if w["ts"] < e["ts"]]
        parts["wait"].append(before[-1]["dur"] / 1e3 if before else 0.0)
        parts["step"].append(e["dur"] / 1e3)
        parts["loop"].append((wait["ts"] - end) / 1e3)
    if not parts["step"]:
        return {}
    return {f"span_{k}_ms_median": float(np.median(v))
            for k, v in parts.items()}


class _Wrapped:
    def __init__(self, inner, call):
        self._inner, self._call = inner, call

    def __call__(self, batch):
        return self._call(batch)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def phase_train(card: str, device="cuda", config=TRAIN_CONFIG,
                sets=TRAIN_SETS, work=WORK, seed: int = 0) -> dict:
    """Slice 3's main path: the port's ``train.py`` with the GPT-2 small
    config at full width (only sample counts and epochs cut), exact launch
    counts per step, losses finite and falling, checkpoints and summary
    written, a resume from ``checkpoint-epoch1`` reproducing epoch 2, then
    a profile of 5 train steps. Returns the path's launches per kernel."""
    return _train_path(card, device, config, sets, work / "train", seed)


#: the steady-state numbers of each training path's main run, by label
PATH_STATS: dict = {}


def _train_path(card: str, device, config, sets, run_root, seed: int,
                label: str = "train", check=None) -> dict:
    """One training main path through the port's ``train.py`` (see
    :func:`phase_train`); ``check(trainer, run)`` runs after the main run,
    before the resume; ``run_root`` is removed at the end. The main run's
    steady-state step numbers (:meth:`TrainRun.steady`) land in
    ``PATH_STATS[label]``."""
    import warnings

    from pytorch_distributed_template_tpu_torch import train as train_cli
    from pytorch_distributed_template_tpu_torch.observability.trace import (
        get_recorder,
    )

    if run_root.exists():
        shutil.rmtree(run_root)
    get_recorder().clear()   # this run's trace.json: this run's spans
    argv = ["-c", str(config), "-s", str(run_root / "main"), "--device",
            str(device), "--seed", str(seed)]
    for chain, value in sets:
        argv += ["--set", chain, json.dumps(value)]
    box = {}

    def hook(trainer):
        box["trainer"] = trainer
        box["run"] = TrainRun(trainer, device, card, "main", warns=warns)
        m = trainer.model
        moe = ""
        if m.moe_experts:
            mlp = next(b.moe for b in m.h if hasattr(b, "moe"))
            moe = (f", {m.moe_experts} experts top-{mlp.top_k} in every "
                   f"{m.moe_every}. block (capacity factor "
                   f"{mlp.capacity_factor})")
        log(f"[{label}] {type(m).__name__} on {trainer.device}: "
            f"{m.n_layer} layers, {m.n_head} heads, d_model {m.d_model}, "
            f"d_ff {m.d_ff}, vocab {m.vocab_size}, seq {m.max_len}, batch "
            f"{trainer.train_loader.batch_size}, {m.dtype}, remat "
            f"{m.remat}, {m.attn_impl}, fused head {m.fused_head}, dropout "
            f"{m.rate}{moe}, "
            f"{sum(p.numel() for p in m.parameters()) / 1e6:.2f} M params; "
            f"{len(trainer.train_loader)} steps per epoch; cuts: {sets}")

    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as warns:
        warnings.simplefilter("always")
        try:
            train_cli.main(argv, on_trainer=hook)
        finally:
            if torch.device(device).type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
    wall = time.perf_counter() - t0
    trainer, run = box["trainer"], box["run"]
    steady_stats = run.steady()
    run.warns = None
    losses = [r["loss"] for r in run.steps]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training losses: {losses}")
    head, tail = np.mean(losses[:5]), np.mean(losses[-5:])
    if not tail < head:
        raise AssertionError(f"the loss did not fall: first 5 steps "
                             f"{head:.4f}, last 5 {tail:.4f}")
    monitored = trainer.mnt_metric if trainer.mnt_mode != "off" else "loss"
    for e in run.epoch_logs:
        if not np.isfinite(e.get(monitored, np.nan)):
            raise AssertionError(f"epoch {e['epoch']} logged no finite "
                                 f"{monitored}: {e}")
    run_dir = trainer.config.save_dir
    epochs = trainer.epochs
    for path in ([run_dir / f"checkpoint-epoch{e}" / "model.pt"
                  for e in range(1, epochs + 1)]
                 + [run_dir / "model_best" / "model.pt",
                    run_dir / "summary.json"]):
        if not path.is_file():
            raise AssertionError(f"{path} was not written")
    summary = json.loads((run_dir / "summary.json").read_text())
    steady = run.steps[1:] or run.steps
    PATH_STATS[label] = {
        "ms_per_step_median": float(np.median([r["ms"] for r in steady])),
        **steady_stats, **_loop_spans(trainer)}
    log(f"[{label}] steady " + json.dumps(dict(PATH_STATS[label],
                                               card=card)))
    if check is not None:
        check(trainer, run)
    log(f"[{label}] " + json.dumps({
        "run": "main", "steps": len(run.steps), "epochs": epochs,
        "wall_s": wall, "loss_first5": head, "loss_last5": tail,
        "ms_per_step_median": float(np.median([r["ms"] for r in steady])),
        "tokens_per_s_median": float(np.median(
            [r["tokens_per_s"] for r in steady])),
        "mfu_median": float(np.median([r["mfu"] for r in steady])),
        "peak_mem_gib_max": max(r["peak_mem_gib"] for r in run.steps),
        "model_flops_per_step": run.flops,
        "launches": dict(zip(TRAIN_KERNELS, run.launches)),
        "summary": summary, "card": card}))

    # resume from the first epoch's checkpoint: epoch 2 again
    resume_box = {}

    def resume_hook(trainer):
        resume_box["run"] = TrainRun(trainer, device, card, "resume")

    train_cli.main(["-r", str(run_dir / "checkpoint-epoch1"), "-s",
                    str(run_root / "resume"), "--device", str(device)],
                   on_trainer=resume_hook)
    resumed = resume_box["run"]
    if [e["epoch"] for e in resumed.epoch_logs] != list(
            range(2, epochs + 1)):
        raise AssertionError(f"the resumed run ran epochs "
                             f"{[e['epoch'] for e in resumed.epoch_logs]}")
    again, first = resumed.epoch_logs[0], run.epoch_logs[1]
    keys = sorted({"loss", "val_loss", monitored})
    diffs = {k: abs(again[k] - first[k]) / abs(first[k]) for k in keys}
    log(f"[{label}] resume " + json.dumps({
        "epoch": 2, "uninterrupted": {k: first[k] for k in diffs},
        "resumed": {k: again[k] for k in diffs}, "rel_diff": diffs,
        "rtol": RESUME_RTOL}))
    if max(diffs.values()) > RESUME_RTOL:
        raise AssertionError(f"resume does not reproduce epoch 2: {diffs}")
    launches = [a + b for a, b in zip(run.launches, resumed.launches)]

    # where a train step's time goes (outside the counted runs)
    batches = [trainer._to_device(b) for b, _ in zip(
        trainer.train_loader, range(5))]
    row = _profiled(lambda: [trainer.train_step(b) for b in batches],
                    device, top_n=12, sums=("flash_bwd_dkv", "flash_bwd_dq"))
    per_step = {f"{k}_per_step": row[f"{k}_ms"] / len(batches)
                for k in ("flash_bwd_dkv", "flash_bwd_dq")}
    log("[profile] " + json.dumps({"profile": f"{label}_steps", "steps": 5,
                                   **row, **per_step, "card": card}))
    del trainer, box, resume_box, batches
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(run_root)
    return dict(zip(TRAIN_KERNELS, launches))


# ---------------------------------------------------------------------------
# slice 4: MoE LM training, kernel B5
# ---------------------------------------------------------------------------

FFN_SOURCE = "pytorch_distributed_template_tpu_torch/csrc/expert_ffn.cu"
FFN_REPLACES = "scripts/debug_moe_pallas_ffn.py:46"
# (name, E, C, D, F, biases, dtype): the MoE main path's shape (E 8, C =
# ceil(2 x 16384 x 1.25 / 8) = 5120, D 512, F 1024, MoeMlp's biases), the
# TPU probe's own shape (scripts/debug_moe_pallas_ffn.py, no biases), a
# ragged capacity (C not a multiple of the kernel's row tile) and a small
# f32 case (the CUDA-core arm)
FFN_SHAPES = [
    ("moelm_main", 8, 5120, 512, 1024, True, torch.bfloat16),
    ("probe", 8, 2560, 768, 1536, False, torch.bfloat16),
    ("ragged", 4, 1000, 256, 512, True, torch.bfloat16),
    ("f32", 4, 77, 64, 128, True, torch.float32),
]
# |got - ref| <= a max|ref| + b against the plain version on the same
# inputs. bf16 (0.01, 1e-4): the probe's own gate; both sides round the
# hidden and the output to bf16, and a hidden value whose f32 sum lands on
# the other side of a rounding boundary moves the output by ~2^-8 of one
# term. f32 (1e-4, 1e-5): summation order only.
FFN_TOL = {torch.bfloat16: (0.01, 1e-4), torch.float32: (1e-4, 1e-5)}
# phase 3d: a small f32 TinyMoeLM, head_dim 64 so the flash kernels take
# it; capacity factor 0.5 drops tokens; the last example of every batch
# is padding
MOE_REF = {"vocab_size": 256, "n_layer": 2, "n_head": 2, "d_model": 128,
           "d_ff": 256, "max_len": 64, "num_experts": 4, "top_k": 2,
           "capacity_factor": 0.5, "aux_loss_weight": 0.01,
           "attn_impl": "flash", "fused_head": True}
# slice 4's main path: the repository's MoE config at full width through the
# port's train.py; only the corpus size (a few MB of the standard library),
# the epochs and the checkpoint period are cut
MOE_CONFIG = REPO / "configs" / "moelm_stdlib.json"
MOE_CORPUS_MB = 2.0
# the health summary and the flight recorder, on by default, turned off as
# in phase 6's config: slice 4's path runs the step it ran before slice 6
MOE_SETS = [("trainer;epochs", 2), ("trainer;save_period", 1),
            ("trainer;health", {"enabled": False}),
            ("trainer;telemetry", {"enabled": False})]


def _ffn_library(x, wi, wo, bi, bo):
    """The cuBLAS yardstick, three PyTorch calls: bmm (baddbmm with the
    bias) -> tanh-gelu -> bmm (baddbmm). Timed only; the port never calls
    it."""
    import torch.nn.functional as F

    h = torch.bmm(x, wi) if bi is None else torch.baddbmm(bi[:, None], x, wi)
    h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, wo) if bo is None else torch.baddbmm(bo[:, None], h,
                                                             wo)


def phase_expert_ffn_kernel() -> list:
    """B5 against its plain version on the card: max error, kernel /
    plain / library times and the card's bound, one row per shape."""
    from pytorch_distributed_template_tpu_torch.ops import expert_ffn as ffn

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    lib = ffn.EXPERT_FFN.load()
    rows = []
    for name, e, c, d, f, bias, dtype in FFN_SHAPES:
        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device="cuda")
                    * scale).to(dtype)

        # the probe's inputs: x ~ N(0, 1), weights ~ N(0, 0.02^2)
        x, wi, wo = rnd(e, c, d), rnd(e, d, f, scale=0.02), rnd(
            e, f, d, scale=0.02)
        bi = rnd(e, f, scale=0.1) if bias else None
        bo = rnd(e, d, scale=0.1) if bias else None
        args = (x, wi, wo, bi, bo)
        out = ffn.expert_ffn(*args)
        torch.cuda.synchronize()
        ref = ffn.expert_ffn_ref(*args).float()
        if not torch.isfinite(out).all():
            raise AssertionError(f"B5 {name}: non-finite output")
        err = (out.float() - ref).abs().max().item()
        a, b = FFN_TOL[dtype]
        limit = a * ref.abs().max().item() + b
        if err > limit:
            raise AssertionError(
                f"expert_ffn disagrees with its plain version at {name}: "
                f"max err {err:.3e} > {limit:.3e}")
        del out, ref
        kernel_ms = cuda_ms(lambda: ffn._expert_ffn_cuda(*args), 20)
        ref_ms = cuda_ms(lambda: ffn.expert_ffn_ref(*args), 5, warmup=1)
        library_ms = cuda_ms(lambda: _ffn_library(*args), 20)
        bound_s, bound_by = ffn.expert_ffn_bound_seconds(
            e, c, d, f, x.element_size(), bias, PEAK_FLOPS[dtype],
            PEAK_BYTES)
        row = {"shape": name, "E": e, "C": c, "D": d, "F": f,
               "biases": bias, "dtype": str(dtype).replace("torch.", ""),
               "rows_per_tile": lib.pdt_expert_ffn_rows(
                   d, ffn._DTYPE_CODES[dtype]),
               "max_abs_err": err, "limit": limit,
               "kernel_ms": kernel_ms, "ref_ms": ref_ms,
               "library_ms": library_ms, "bound_ms": bound_s * 1e3,
               "bound_by": bound_by,
               "plain": "expert_ffn_ref (f32 bmm, gelu, f32 bmm)",
               "library": "3 calls: bmm/baddbmm -> gelu(tanh) -> "
                          "bmm/baddbmm (cuBLAS, same dtype)"}
        rows.append(with_ratios(row))
        log("[ffn] " + json.dumps(row))
        del x, wi, wo, bi, bo, args
        torch.cuda.empty_cache()
    ffn.EXPERT_FFN.launches = 0
    return rows


def phase_moe_train_reference(device="cuda") -> None:
    """A small f32 TinyMoeLM (``MOE_REF``) trained ``TRAIN_REF_STEPS``
    steps on ``device`` (kernels B1-B3, B5) and on the CPU (plain
    versions) from the same weights and batches, one padded example in
    each: per-step losses (the aux loss included) and final params within
    ``TRAIN_REF_TOL``."""
    import pytorch_distributed_template_tpu_torch.models  # noqa: F401
    from pytorch_distributed_template_tpu_torch.config.registry import (
        MODELS,
    )
    from pytorch_distributed_template_tpu_torch.data.datasets import (
        synthetic_lm,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = MODELS.get("TinyMoeLM")(**MOE_REF, device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(8))
    state = {k: v.clone() for k, v in cpu.state_dict().items()}
    toks = synthetic_lm(n=4 * TRAIN_REF_STEPS, seq_len=MOE_REF["max_len"],
                        vocab_size=MOE_REF["vocab_size"], seed=2)["tokens"]
    mask = np.array([True, True, True, False])
    batches = [{"tokens": toks[4 * i:4 * i + 4], "mask": mask}
               for i in range(TRAIN_REF_STEPS)]
    dev_loss, dev_p = _train_ref_run("TinyMoeLM", MOE_REF, state, batches,
                                     device)
    cpu_loss, cpu_p = _train_ref_run("TinyMoeLM", MOE_REF, state, batches,
                                     "cpu")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(dev_loss, cpu_loss))
    param_err = max((dev_p[k] - cpu_p[k]).abs().max().item() for k in cpu_p)
    row = {"model": "TinyMoeLM", "steps": TRAIN_REF_STEPS,
           "losses_device": dev_loss, "losses_cpu": cpu_loss,
           "loss_max_rel_err": loss_err, "param_max_abs_err": param_err,
           "tol": TRAIN_REF_TOL, "device": str(device)}
    log("[moe-reference] " + json.dumps(row))
    if not (loss_err <= TRAIN_REF_TOL["loss_rtol"]
            and param_err <= TRAIN_REF_TOL["param_atol"]):
        raise AssertionError(f"small f32 TinyMoeLM training on {device} "
                             f"differs from the CPU: {row}")


def phase_moe_train(card: str, device="cuda", config=MOE_CONFIG,
                    sets=MOE_SETS, corpus_mb: float = MOE_CORPUS_MB,
                    work=WORK, seed: int = 0) -> dict:
    """Slice 4's main path: a corpus of ``corpus_mb`` MB from the port's
    ``tools/make_text_corpus.py``, then :func:`_train_path` with the MoE
    config reading it. Returns the path's launches per kernel."""
    from pytorch_distributed_template_tpu_torch.tools import (
        make_text_corpus,
    )

    data_dir = work / "moe_data"
    info = make_text_corpus.build(data_dir / "pystdlib.txt",
                                  int(corpus_mb * 1e6))
    log(f"[moe] corpus: {info['files']} files, {info['bytes']} bytes from "
        f"{info['source']}")
    sets = list(sets) + [(f"{split};args;data_dir", str(data_dir))
                         for split in ("train_loader", "valid_loader")]
    launches = _train_path(card, device, config, sets, work / "moe_train",
                           seed, label="moe")
    shutil.rmtree(data_dir)
    return launches


# ---------------------------------------------------------------------------
# slice 5: the source paper's main path (LeNet/MNIST, DDP over NCCL); no TPU
# kernel runs on it (convs, pools and dense layers are cuDNN/cuBLAS)
# ---------------------------------------------------------------------------

# PyTorch's own TF32 settings, read before any phase changes them: the main
# path runs with these; phase 8 turns TF32 off for its comparison only
TF32_DEFAULTS = {"matmul": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn": torch.backends.cudnn.allow_tf32}
MNIST_DEBUG = REPO / "configs" / "mnist_debug.json"
MNIST_CONFIG = REPO / "configs" / "mnist.json"
# phase 8: one epoch of mnist_debug (8 steps of 64) in f32 on the card and
# on the CPU from the same weights, dropout off: per-step losses rtol 1e-5
# and final params atol 1e-4, as TRAIN_REF_TOL (summation order only,
# with TF32 off: cuDNN's TF32 convs would move the losses by ~1e-3)
LENET_REF_SETS = [("trainer;epochs", 1), ("trainer;save_period", 10)]
# phase 9: configs/mnist.json as it is (LeNet's full width, batch 128, 10
# epochs, TensorBoard on)
MNIST_SETS = []
# the torchrun launch: mnist_debug for one epoch
TORCHRUN_SETS = [("trainer;epochs", 1)]
MNIST_MIN_VAL_ACC = 0.5          # chance is 0.1
MNIST_KEYS = ("loss", "accuracy", "top_k_acc", "val_loss", "val_accuracy",
              "val_top_k_acc")
TEST_RTOL = 1e-6


class _TF32:
    """Set cuBLAS's and cuDNN's TF32 switches for a block; restore after."""

    def __init__(self, matmul: bool, cudnn: bool):
        self.want = (matmul, cudnn)

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.want
        return {"matmul_tf32": self.want[0], "cudnn_tf32": self.want[1]}

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def _lenet_run(device, state, work, sets=LENET_REF_SETS):
    """One epoch of mnist_debug through the port's ``train.py`` on
    ``device`` from ``state``, dropout off: (per-step losses, final params
    on the CPU)."""
    from pytorch_distributed_template_tpu_torch import train as train_cli

    losses, box = [], {}

    def hook(trainer):
        box["trainer"] = trainer
        for mod in (trainer.model.Dropout_0, trainer.model.Dropout_1):
            mod.p = 0.0
        trainer.model.load_state_dict(state)
        inner = trainer.train_step

        def step(batch):
            m = inner(batch)
            losses.append(float(m["loss_sum"]) / float(m["count"]))
            return m

        trainer.train_step = _Wrapped(inner, step)

    argv = ["-c", str(MNIST_DEBUG), "-s", str(work), "--device",
            str(device), "--no-validate"]
    for chain, value in sets:
        argv += ["--set", chain, json.dumps(value)]
    train_cli.main(argv, on_trainer=hook)
    params = {k: v.detach().cpu()
              for k, v in box["trainer"].model.state_dict().items()}
    return losses, params


def phase_lenet_reference(device="cuda", work=WORK) -> None:
    """Phase 8: one epoch of ``configs/mnist_debug.json`` in f32 on
    ``device`` and on the CPU through the port's ``train.py``, from the
    same weights (a CPU LeNet drawn from seed 0) with dropout off: the
    per-step losses and final params within ``TRAIN_REF_TOL``, TF32 off
    on the card for this comparison only."""
    from pytorch_distributed_template_tpu_torch.models.lenet import LeNet

    cpu = LeNet(device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in cpu.state_dict().items()}
    root = work / "lenet_ref"
    with _TF32(False, False) as tf32:
        dev_loss, dev_p = _lenet_run(device, state, root / "device")
    cpu_loss, cpu_p = _lenet_run("cpu", state, root / "cpu")
    shutil.rmtree(root)
    if len(dev_loss) != len(cpu_loss) or not dev_loss:
        raise AssertionError(f"step counts differ: {len(dev_loss)} on "
                             f"{device}, {len(cpu_loss)} on the CPU")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(dev_loss, cpu_loss))
    param_err = max((dev_p[k] - cpu_p[k]).abs().max().item() for k in cpu_p)
    row = {"model": "LeNet", "config": "mnist_debug", "steps": len(dev_loss),
           "losses_device": dev_loss, "losses_cpu": cpu_loss,
           "loss_max_rel_err": loss_err, "param_max_abs_err": param_err,
           "tol": TRAIN_REF_TOL, "device": str(device),
           "device_run": tf32, "cpu_run": "float32 (no TF32 on the CPU)"}
    log("[lenet-reference] " + json.dumps(row))
    if not (loss_err <= TRAIN_REF_TOL["loss_rtol"]
            and param_err <= TRAIN_REF_TOL["param_atol"]):
        raise AssertionError(f"LeNet training on {device} differs from the "
                             f"CPU: {row}")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class MnistRun:
    """Hooks one run of the port's trainer: checks that it trains under
    ``DistributedDataParallel`` on a process group of ``backend``, counts
    DDP's gradient all-reduces with a communication hook (calls and bytes,
    per train step), and times each train step (host clock to
    ``cuda.synchronize``)."""

    def __init__(self, trainer, device, backend: str, label: str, card: str):
        import torch.distributed as tdist
        from torch.distributed.algorithms.ddp_comm_hooks import (
            default_hooks,
        )

        self.device, self.label, self.card = device, label, card
        self.backend = tdist.get_backend()
        if self.backend != backend:
            raise AssertionError(f"({label}) the process group runs "
                                 f"{self.backend}, not {backend}")
        ddp = trainer.ddp
        if not isinstance(ddp, torch.nn.parallel.DistributedDataParallel):
            raise AssertionError(f"({label}) the model is not wrapped in "
                                 f"DistributedDataParallel")
        self.allreduce = {"calls": 0, "bytes": 0}

        def counted(state, bucket):
            buf = bucket.buffer()
            state["calls"] += 1
            state["bytes"] += buf.numel() * buf.element_size()
            return default_hooks.allreduce_hook(None, bucket)

        ddp.register_comm_hook(self.allreduce, counted)
        self.steps, self.epoch_logs = [], []
        self.batch = trainer.train_loader.batch_size
        inner = trainer.train_step
        trainer.train_step = _Wrapped(inner, self._step(inner))
        real_epoch = trainer._train_epoch

        def epoch(e):
            out = real_epoch(e)
            self.epoch_logs.append(dict(out, epoch=e))
            log(f"[mnist] ({label}) epoch " + json.dumps(
                dict(out, epoch=e, card=card)))
            return out

        trainer._train_epoch = epoch

    def _step(self, inner):
        is_cuda = torch.device(self.device).type == "cuda"

        def call(batch):
            calls = self.allreduce["calls"]
            _sync(self.device)
            t0 = time.perf_counter()
            m = inner(batch)
            _sync(self.device)
            secs = time.perf_counter() - t0
            if self.allreduce["calls"] == calls:
                raise AssertionError(
                    f"({self.label}) a train step ran no gradient "
                    f"all-reduce through the DDP hook")
            self.steps.append({
                "loss": float(m["loss_sum"]) / max(float(m["count"]), 1.0),
                "ms": secs * 1e3, "examples_per_s": self.batch / secs,
                "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                                 if is_cuda else 0.0)})
            return m

        return call


def phase_mnist(card: str, device="cuda", config=MNIST_CONFIG,
                sets=MNIST_SETS, work=WORK, seed: int = 0,
                torchrun_sets=TORCHRUN_SETS) -> dict:
    """Phase 9, slice 5's main path: the port's ``train.py`` with
    ``configs/mnist.json`` (LeNet, Adam amsgrad, StepLR, batch 128, 10
    epochs; synthetic MNIST without idx files) in this process with the
    launcher's environment set for one rank, so ``dist.initialize`` builds
    an NCCL group (gloo on the CPU) and the trainer runs DDP. Checks the
    backend, the DDP wrapper and a gradient all-reduce in every step (a
    communication hook), finite and falling losses, validation accuracy
    well above chance, the checkpoints and summary, a resume from
    ``checkpoint-epoch1`` reproducing epoch 2 exactly, the port's
    ``test.py`` on ``model_best`` equal to the best epoch's validation
    (rtol ``TEST_RTOL``) with ``--save-outputs``; then ``torchrun``
    launches ``train.py`` on ``configs/mnist_debug.json`` for one epoch.
    Prints step time, examples/s, a 5-step profile, peak memory and the
    all-reduce calls and bytes per step. Returns the run's numbers."""
    import os

    from pytorch_distributed_template_tpu_torch import test as test_cli
    from pytorch_distributed_template_tpu_torch import train as train_cli
    from pytorch_distributed_template_tpu_torch.parallel import dist

    is_cuda = torch.device(device).type == "cuda"
    backend = "nccl" if is_cuda else "gloo"
    root = work / "mnist"
    if root.exists():
        shutil.rmtree(root)
    launch = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
              "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    saved_env = {k: os.environ.get(k) for k in launch}
    os.environ.update(launch)
    if is_cuda:
        torch.cuda.reset_peak_memory_stats()
    try:
        with _TF32(TF32_DEFAULTS["matmul"], TF32_DEFAULTS["cudnn"]) as tf32:
            out = _mnist_path(card, device, config, sets, root, seed,
                              backend, tf32, train_cli, test_cli)
    finally:
        dist.shutdown()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["torchrun"] = _torchrun(device, root / "torchrun", torchrun_sets)
    shutil.rmtree(root)
    log("[mnist] torchrun " + json.dumps(out["torchrun"]))
    return out


def _mnist_path(card, device, config, sets, root, seed, backend, tf32,
                train_cli, test_cli) -> dict:
    from pytorch_distributed_template_tpu_torch.parallel import dist

    argv = ["-c", str(config), "-s", str(root / "main"), "--device",
            str(device), "--seed", str(seed)]
    for chain, value in sets:
        argv += ["--set", chain, json.dumps(value)]
    box = {}

    def hook(trainer):
        box["trainer"] = trainer
        box["run"] = MnistRun(trainer, device, backend, "main", card)
        log(f"[mnist] {type(trainer.model).__name__} on {trainer.device} "
            f"under DDP ({box['run'].backend}, world "
            f"{dist.process_count()}): batch {trainer.train_loader.batch_size}, "
            f"{len(trainer.train_loader)} steps per epoch, "
            f"{trainer.train_loader.n_samples} training and "
            f"{trainer.valid_loader.n_samples} validation samples, "
            f"{trainer.epochs} epochs, optimizer "
            f"{type(trainer.optimizer).__name__}, TF32 {tf32}; cuts: {sets}")

    t0 = time.perf_counter()
    train_cli.main(argv, on_trainer=hook)
    wall = time.perf_counter() - t0
    trainer, run = box["trainer"], box["run"]
    losses = [r["loss"] for r in run.steps]
    if not losses or not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training losses: {losses}")
    head, tail = np.mean(losses[:5]), np.mean(losses[-5:])
    if not tail < head:
        raise AssertionError(f"the loss did not fall: first 5 steps "
                             f"{head:.4f}, last 5 {tail:.4f}")
    final = run.epoch_logs[-1]
    for e in run.epoch_logs:
        if not all(np.isfinite(e[k]) for k in MNIST_KEYS):
            raise AssertionError(f"epoch {e['epoch']} logged a non-finite "
                                 f"value: {e}")
    if not final["val_accuracy"] > MNIST_MIN_VAL_ACC:
        raise AssertionError(f"val_accuracy {final['val_accuracy']} is not "
                             f"above {MNIST_MIN_VAL_ACC}")
    run_dir = trainer.config.save_dir
    epochs = trainer.epochs
    for path in ([run_dir / f"checkpoint-epoch{e}" / "model.pt"
                  for e in range(1, epochs + 1)]
                 + [run_dir / "model_best" / "model.pt",
                    run_dir / "summary.json"]):
        if not path.is_file():
            raise AssertionError(f"{path} was not written")
    steady = run.steps[1:] or run.steps
    ms = float(np.median([r["ms"] for r in steady]))
    per_step = {"calls": run.allreduce["calls"] / len(run.steps),
                "bytes": run.allreduce["bytes"] / len(run.steps)}
    row = {"run": "main", "config": str(config.relative_to(REPO)),
           "backend": run.backend, "ddp": True, "steps": len(run.steps),
           "epochs": epochs, "wall_s": wall, "loss_first5": head,
           "loss_last5": tail, "final": final,
           "ms_per_step_median": ms,
           "examples_per_s_median": run.batch * 1e3 / ms,
           "peak_mem_gib_max": max(r["peak_mem_gib"] for r in run.steps),
           "allreduce_per_step": per_step, "tf32": tf32, "card": card}
    log("[mnist] " + json.dumps(row))

    # resume from the first epoch's checkpoint: epoch 2 again, exactly
    resume_box = {}

    def resume_hook(trainer):
        resume_box["run"] = MnistRun(trainer, device, backend, "resume",
                                     card)

    train_cli.main(["-r", str(run_dir / "checkpoint-epoch1"), "-s",
                    str(root / "resume"), "--device", str(device), "--set",
                    "trainer;epochs", "2"], on_trainer=resume_hook)
    again = resume_box["run"].epoch_logs
    if [e["epoch"] for e in again] != [2]:
        raise AssertionError(f"the resumed run ran epochs "
                             f"{[e['epoch'] for e in again]}")
    first = run.epoch_logs[1]
    diffs = {k: abs(again[0][k] - first[k]) for k in MNIST_KEYS}
    log("[mnist] resume " + json.dumps({
        "epoch": 2, "uninterrupted": {k: first[k] for k in MNIST_KEYS},
        "resumed": {k: again[0][k] for k in MNIST_KEYS},
        "abs_diff": diffs}))
    if max(diffs.values()) > 0:
        raise AssertionError(f"resume does not reproduce epoch 2: {diffs}")

    # the port's test.py on model_best: the best epoch's validation
    best = min(run.epoch_logs, key=lambda e: e["val_loss"])
    dump = root / "outputs"
    result = test_cli.main(["-r", str(run_dir / "model_best"), "-s",
                            str(root / "test"), "--device", str(device),
                            "--save-outputs", str(dump)])
    errs = {k: abs(result[k] - best[f"val_{k}"]) / abs(best[f"val_{k}"])
            for k in ("loss", "accuracy", "top_k_acc")}
    rows = {name: np.load(dump / f"{name}_p0.npy").shape
            for name in ("outputs", "targets")}
    n_test = trainer.valid_loader.n_samples
    log("[mnist] test.py " + json.dumps({
        "best_epoch": best["epoch"], "test": result,
        "rel_err_vs_best_val": errs, "rtol": TEST_RTOL,
        "saved_rows": {k: list(v) for k, v in rows.items()}}))
    if max(errs.values()) > TEST_RTOL:
        raise AssertionError(f"test.py differs from the best epoch's "
                             f"validation: {errs}")
    if rows["outputs"] != (n_test, 10) or rows["targets"] != (n_test,):
        raise AssertionError(f"--save-outputs wrote {rows}, not {n_test} "
                             f"rows")

    # where a train step's time goes (outside the checked runs)
    batches = [trainer._to_device(b) for b, _ in zip(trainer.train_loader,
                                                     range(5))]
    inner = trainer.train_step._inner
    prof = _profiled(lambda: [inner(b) for b in batches], device, top_n=8)
    log("[profile] " + json.dumps({"profile": "mnist_steps", "steps": 5,
                                   **prof, "card": card}))
    row.update(profile=prof, resume_abs_diff=diffs, test=result)
    return row


def _torchrun(device, save_dir, sets, timeout: float = 600.0) -> dict:
    """``torchrun --standalone --nproc_per_node=1 -m
    pytorch_distributed_template_tpu_torch.train -c
    configs/mnist_debug.json`` (``torch.distributed.run``, the program
    behind ``torchrun``) in a subprocess: it must exit 0 and write its
    checkpoint."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1", "-m",
           "pytorch_distributed_template_tpu_torch.train", "-c",
           str(MNIST_DEBUG), "-s", str(save_dir), "--device", str(device)]
    for chain, value in sets:
        cmd += ["--set", chain, json.dumps(value)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=timeout)
    secs = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"torchrun exited {r.returncode}: "
                             f"{r.stdout[-2000:]}{r.stderr[-3000:]}")
    ckpts = sorted(save_dir.rglob("checkpoint-epoch1/model.pt"))
    if not ckpts:
        raise AssertionError(f"torchrun wrote no checkpoint under "
                             f"{save_dir}")
    return {"cmd": " ".join(cmd[1:]), "exit": r.returncode, "wall_s": secs,
            "checkpoint": str(ckpts[0].relative_to(save_dir))}


# ---------------------------------------------------------------------------
# slice 6: training observability, configs/gpt2_small.json as it is
# ---------------------------------------------------------------------------

# phase 10: the repository's GPT-2 small config with every key it has
# (compile_cache, TensorBoard, health, telemetry); the cuts, all by --set:
# the sample counts, the epochs and the checkpoint period as phase 6's, and
# the observability extras the config leaves at their defaults
OBS_CONFIG = REPO / "configs" / "gpt2_small.json"
OBS_SETS = [("train_loader;args;n", 256), ("valid_loader;args;n", 64),
            ("trainer;epochs", 2), ("trainer;save_period", 1),
            ("trainer;profiler", {"enabled": True, "trace_steps": 3}),
            ("trainer;watchdog_secs", 600),
            ("trainer;log_grad_norm", True)]
# the second run: one epoch with every gradient element NaN at step 24
NAN_STEP = 24
NAN_SETS = [("train_loader;args;n", 256), ("valid_loader;args;n", 64),
            ("trainer;epochs", 1), ("trainer;save_period", 1)]
# the train step's variants on the run's model, timed in turns: phase 6's
# (skip_nonfinite, clip, no health) against phase 10's (with the health
# summary and log_grad_norm)
STEP_VARIANTS = {
    "phase6": dict(skip_nonfinite=True),
    "phase10": dict(skip_nonfinite=True, health=True, log_grad_norm=True),
}
STEP_TURNS = ("phase6", "phase10", "phase10", "phase6")
STEP_TURN_STEPS = 8


def phase_observe(card: str, device="cuda", config=OBS_CONFIG,
                  sets=OBS_SETS, nan_sets=NAN_SETS, nan_step=NAN_STEP,
                  work=WORK, seed: int = 0) -> dict:
    """Phase 10, slice 6's main path: the port's ``train.py`` with
    ``configs/gpt2_small.json`` as it is, cut only by ``sets``. The checks
    of :func:`_train_path` (exact launch counts per step, losses finite
    and falling, checkpoints, summary, the resume reproducing epoch 2, a
    5-step profile), then: one flight record per train step in
    ``telemetry.jsonl`` (``loss``, ``lr``, ``grad_norm`` on log steps),
    ``trace.json``, a ``torch.profiler`` trace in ``profile/``, TB events
    or the backend's absence printed, ``grad_norm`` and ``mfu`` in the
    epoch logs; phase 6's and phase 10's train step timed in turns on the
    run's model (:func:`_step_variants`); the median ms/step, iteration ms and
    synchronising calls per non-log step beside phase 6's when phase 6 ran
    in this process, failing when phase 10 makes more; then the
    ``nan_grad`` run (:func:`_nan_run`). Returns the kernels' launches of
    both runs."""

    def check(trainer, run):
        _check_observability(trainer, run, device)
        _step_variants(trainer, device, card)

    launches = _train_path(card, device, config, sets, work / "observe",
                           seed, label="observe", check=check)
    six, ten = PATH_STATS.get("train"), PATH_STATS.get("observe")
    if six is not None:
        row = {"phase6": six, "phase10": ten,
               "overhead_ms": ten["ms_per_step_median"]
               - six["ms_per_step_median"],
               "overhead_pct": 100.0 * (ten["ms_per_step_median"]
                                        / six["ms_per_step_median"] - 1)}
        if six["iter_ms_median"] and ten["iter_ms_median"]:
            row["iter_overhead_ms"] = (ten["iter_ms_median"]
                                       - six["iter_ms_median"])
            row["iter_overhead_pct"] = 100.0 * (
                ten["iter_ms_median"] / six["iter_ms_median"] - 1)
        log("[observe] overhead " + json.dumps(dict(row, card=card)))
        if (six["syncs_per_step_mean"] is not None
                and ten["syncs_per_step_mean"]
                > six["syncs_per_step_mean"]):
            raise AssertionError(
                f"phase 10 makes more synchronising calls per non-log "
                f"train step than phase 6: {ten} against {six}")
    nan = _nan_run(card, device, config, nan_sets, nan_step,
                   work / "observe_nan", seed)
    return {k: launches[k] + nan[k] for k in launches}


def _check_observability(trainer, run, device) -> None:
    """The run directory's observability artifacts (see
    :func:`phase_observe`)."""
    run_dir = trainer.config.save_dir
    records = [json.loads(line) for line in
               (run_dir / "telemetry.jsonl").read_text().splitlines()]
    steps = sorted(r["step"] for r in records if "event" not in r)
    if steps != list(range(len(run.steps))):
        raise AssertionError(f"telemetry.jsonl has step records "
                             f"{steps}, not one per step of "
                             f"{len(run.steps)}")
    logged = [r for r in records if "loss" in r]
    if not logged or not all(
            {"loss", "lr", "grad_norm", "steps_per_sec"} <= set(r)
            for r in logged if r["step"] > 0):
        raise AssertionError(f"log-step records lack fields: {logged}")
    spans = {e["name"] for e in json.loads(
        (run_dir / "trace.json").read_text())["traceEvents"]}
    if not {"data/next_batch", "train/step", "train/log"} <= spans:
        raise AssertionError(f"trace.json spans: {sorted(spans)}")
    traces = sorted((run_dir / "profile").glob("*.pt.trace.json"))
    if not traces:
        raise AssertionError("no torch.profiler trace in profile/")
    events = sorted(run_dir.glob("events.out.tfevents.*"))
    backend = trainer.writer.selected_module
    if backend and not events:
        raise AssertionError(f"TensorBoard ({backend}) wrote no events")
    for e in run.epoch_logs:
        if not np.isfinite(e.get("grad_norm", np.nan)):
            raise AssertionError(f"epoch {e['epoch']} logged no finite "
                                 f"grad_norm: {e}")
        if torch.device(device).type == "cuda" and "mfu" not in e:
            raise AssertionError(f"epoch {e['epoch']} logged no mfu: {e}")
    memory = [r["devices"] for r in records if "devices" in r]
    log("[observe] artifacts " + json.dumps({
        "records": len(records), "step_records": len(steps),
        "log_records": len(logged), "events": sorted(
            {r["event"] for r in records if "event" in r}),
        "spans": sorted(spans), "profile_traces": len(traces),
        "profile_bytes": sum(t.stat().st_size for t in traces),
        "tensorboard": backend or "no backend (torch.utils.tensorboard "
                                  "and tensorboardX do not import)",
        "tb_event_files": len(events),
        "memory_record": memory[-1] if memory else None,
        "epoch_mfu": [e.get("mfu") for e in run.epoch_logs],
        "epoch_grad_norm": [e["grad_norm"] for e in run.epoch_logs]}))


def _step_variants(trainer, device, card: str) -> dict:
    """ms per train step of :data:`STEP_VARIANTS` on the run's model and
    optimizer, in :data:`STEP_TURNS`, each turn
    :data:`STEP_TURN_STEPS` steps issued back to back after a warm step,
    with one ``cuda.synchronize`` at the end (the clip of the config in
    every variant)."""
    from pytorch_distributed_template_tpu_torch.engine.steps import (
        make_train_step,
    )

    batches = [trainer._to_device(b) for b, _ in zip(
        trainer.train_loader, range(STEP_TURN_STEPS))]
    net = trainer.ddp if trainer.ddp is not None else trainer.model
    clip = trainer.config["trainer"].get("grad_clip_norm", 0.0)
    times = {}
    for name in STEP_TURNS:
        step = make_train_step(
            net, trainer.optimizer, trainer.criterion, trainer.metric_ftns,
            input_key=trainer.input_key, target_key=trainer.target_key,
            grad_clip_norm=clip, lr_fn=trainer.lr_fn,
            **STEP_VARIANTS[name])
        step(batches[0])
        _sync(device)
        t0 = time.perf_counter()
        for b in batches:
            step(b)
        _sync(device)
        times.setdefault(name, []).append(
            (time.perf_counter() - t0) * 1e3 / len(batches))
    row = {f"{k}_ms": float(np.mean(v)) for k, v in times.items()}
    row["turns"] = times
    log("[observe] step variants " + json.dumps(dict(row, card=card)))
    return row


def _nan_run(card: str, device, config, sets, nan_step: int, root,
             seed: int) -> dict:
    """One epoch of the config with ``nan_grad@step:<nan_step>``:
    ``anomaly_<step>.json`` written, the step skipped, the params finite,
    the per-group counts summing to the number of gradient elements, no
    ``model_best`` from the poisoned epoch. Returns the launches."""
    from pytorch_distributed_template_tpu_torch import train as train_cli

    if root.exists():
        shutil.rmtree(root)
    argv = ["-c", str(config), "-s", str(root), "--device", str(device),
            "--seed", str(seed)]
    for chain, value in [*sets, ("trainer;faults",
                                 f"nan_grad@step:{nan_step}")]:
        argv += ["--set", chain, json.dumps(value)]
    box = {}

    def hook(trainer):
        box["trainer"] = trainer
        box["run"] = TrainRun(trainer, device, card, "nan_grad")

    train_cli.main(argv, on_trainer=hook)
    trainer, run = box["trainer"], box["run"]
    run_dir = trainer.config.save_dir
    dump = run_dir / f"anomaly_{nan_step}.json"
    if not dump.is_file():
        raise AssertionError(f"{dump.name} was not written: "
                             f"{sorted(p.name for p in run_dir.iterdir())}")
    anomaly = json.loads(dump.read_text())
    summary = anomaly["summary"]
    groups = {k: v for k, v in summary.items() if k.startswith("nonfinite/")}
    elements = sum(p.numel() for p in trainer.model.parameters())
    finite = all(bool(torch.isfinite(p).all())
                 for p in trainer.model.parameters())
    skipped = run.epoch_logs[0].get("skipped", 0.0)
    row = {"anomaly": dump.name, "reasons": [r["kind"] for r in
                                             anomaly["reasons"]],
           "skipped": skipped, "params_finite": finite,
           "nonfinite_grads": summary["nonfinite_grads"],
           "gradient_elements": elements, "groups": len(groups),
           "update_norm": summary["update_norm"],
           "model_best": (run_dir / "model_best").exists(), "card": card}
    log("[observe] nan_grad " + json.dumps(row))
    if not (skipped > 0 and finite and sum(groups.values()) == elements
            == summary["nonfinite_grads"] and not row["model_best"]):
        raise AssertionError(f"the nan_grad run: {row}")
    launches = dict(zip(TRAIN_KERNELS, run.launches))
    del trainer, box
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(root)
    return launches


# ---------------------------------------------------------------------------
# slice 7: step-accurate resume and the supervisor (ROADMAP A17)
# ---------------------------------------------------------------------------

# phase 11: the repository's GPT-2 small config (phase 10's file) cut by
# --set to phase 6's sizes, with interval saves into the A/B slots every
# 12 batches, keep_last 1, two microbatches of 4 per step and an EMA
RES_CONFIG = REPO / "configs" / "gpt2_small.json"
RES_SETS = [("train_loader;args;n", 256), ("valid_loader;args;n", 64),
            ("trainer;epochs", 2), ("trainer;save_period", 1),
            ("trainer;save_interval_steps", 12), ("trainer;keep_last", 1),
            ("trainer;grad_accum_steps", 2), ("trainer;ema_decay", 0.999)]
# attempt 1 is killed before step 20 (epoch 1, between the slots after
# batches 12 and 24); attempt 2 raises before step 46 (epoch 2, batch 14,
# after its batch-12 slot) and writes the emergency save; attempt 3 ends
RES_FAULTS = "kill@step:20;crash@step:46@attempt:2"
RES_TIMEOUT_S = 900
_INTERVAL_LINE = re.compile(
    r"Interval checkpoint: (\S+) \(the loop stopped ([\d.]+) ms; "
    r"written in ([\d.]+) s, (\d+) bytes\)")


def phase_resilience(card: str, device="cuda", config=RES_CONFIG,
                     sets=RES_SETS, faults=RES_FAULTS, work=WORK,
                     seed: int = 0) -> dict:
    """Phase 11, slice 7's main path: the config run once without a fault
    through the port's ``train.py`` (launches counted per step), then once
    through the port's ``supervise.py`` with ``PDT_FAULTS=faults``. Hard
    checks: 2 restarts, both ``crash``, a clean end; each attempt resumes
    at the newest checkpoint the one before it completed (the slot before
    the kill, when its write was done before the kill; the emergency save
    after the crash, so none of its steps is replayed); ``global_step``
    epochs x steps in the
    last sidecar; the last ``checkpoint-epochN``'s model, optimizer and
    EMA tensors bitwise equal to the uninterrupted run's; every logged
    loss equal at its step; ``keep_last`` 1 leaving no
    ``checkpoint-epoch1`` beside ``model_best``. Prints each interval
    save's stop of the loop and its write, each attempt's restart to its
    first step and the steps it replayed, beside the card line. Returns
    the uninterrupted run's launches."""
    from pytorch_distributed_template_tpu_torch import train as train_cli
    from pytorch_distributed_template_tpu_torch.resilience.supervisor \
        import read_supervisor_stats

    root = work / "resilience"
    if root.exists():
        shutil.rmtree(root)
    common = ["-c", str(config), "--device", str(device), "--seed",
              str(seed)]
    for chain, value in sets:
        common += ["--set", chain, json.dumps(value)]
    box = {}

    def hook(trainer):
        box["trainer"] = trainer
        box["run"] = TrainRun(trainer, device, card, "uninterrupted")

    t0 = time.perf_counter()
    train_cli.main(common + ["-s", str(root / "base")], on_trainer=hook)
    base_wall = time.perf_counter() - t0
    trainer, run = box["trainer"], box["run"]
    base = trainer.config.save_dir
    epochs, per_epoch = trainer.epochs, trainer.len_epoch
    interval = trainer.save_interval_steps
    k = trainer.train_step.grad_accum_steps
    saves = [dict(r) for r in trainer.ckpt_manager.interval_saves]
    launches = dict(zip(TRAIN_KERNELS, run.launches))
    log("[resilience] uninterrupted " + json.dumps({
        "steps": len(run.steps), "epochs": epochs, "wall_s": base_wall,
        "grad_accum_steps": k, "launches": launches,
        "launches_per_train_step": dict(zip(TRAIN_KERNELS,
                                            run.want["train"])),
        "ms_per_step_median": float(np.median(
            [r["ms"] for r in run.steps[1:] or run.steps])),
        "interval_saves": saves,
        "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn": torch.backends.cudnn.allow_tf32}, "card": card}))
    del trainer, run, box
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    events = root / "supervisor.jsonl"
    cmd = [sys.executable, "-m",
           "pytorch_distributed_template_tpu_torch.supervise",
           "--max-restarts", "3", "--restart-delay", "1", "--jitter", "0",
           "--events-file", str(events)] + common + [
               "-s", str(root / "supervised")]
    out_path = root / "supervised.log"
    t0 = time.perf_counter()
    with open(out_path, "w") as out:
        r = subprocess.run(cmd, cwd=REPO, env=dict(os.environ,
                                                   PDT_FAULTS=faults),
                           stdout=out, stderr=subprocess.STDOUT,
                           timeout=RES_TIMEOUT_S)
    sup_wall = time.perf_counter() - t0
    output = out_path.read_text()
    if r.returncode != 0:
        raise AssertionError(f"the supervised run exited {r.returncode}: "
                             f"{output[-4000:]}")
    stats = read_supervisor_stats(events)
    if not (stats["restarts_total"] == 2 and stats["causes"] == {"crash": 2}
            and stats["clean"]):
        raise AssertionError(f"supervisor.jsonl: {stats}")
    attempts = _attempts(root / "supervised", events)
    if len(attempts) != 3:
        raise AssertionError(f"{len(attempts)} run directories for 3 "
                             f"attempts: {attempts}")
    for prev, att in zip(attempts, attempts[1:]):
        if att["first_step"] != prev["saved_step"]:
            raise AssertionError(
                f"attempt {att['attempt']} resumed at step "
                f"{att['first_step']}, not at the newest checkpoint that "
                f"attempt {prev['attempt']} completed (step "
                f"{prev['saved_step']})")
    if attempts[2]["replayed"] != 0:
        raise AssertionError(f"steps replayed after the emergency save: "
                             f"{attempts[2]['replayed']}")
    last = Path(attempts[-1]["run"])
    ds = json.loads((last / f"checkpoint-epoch{epochs}.data_state.json")
                    .read_text())
    if ds["global_step"] != epochs * per_epoch:
        raise AssertionError(f"the last sidecar: {ds}")
    compared = 0
    for name in ("model.pt", "optimizer.pt", "ema.pt"):
        want = torch.load(base / f"checkpoint-epoch{epochs}" / name,
                          map_location="cpu")
        got = torch.load(last / f"checkpoint-epoch{epochs}" / name,
                         map_location="cpu")
        compared += _assert_bitwise(got, want, name)
    base_losses = _logged_losses([base])
    sup_losses = _logged_losses([Path(a["run"]) for a in attempts])
    differ = {s: (v, base_losses.get(s)) for s, v in sup_losses.items()
              if base_losses.get(s) != v}
    if differ or len(sup_losses) < len(base_losses) // 2:
        raise AssertionError(f"logged losses differ from the "
                             f"uninterrupted run's: {differ}; "
                             f"{len(sup_losses)} of {len(base_losses)}")
    pruned = sorted(p.name for p in base.glob("checkpoint-epoch1*"))
    if pruned or not (base / "model_best").is_dir():
        raise AssertionError(f"keep_last 1: {pruned} left, model_best "
                             f"{(base / 'model_best').is_dir()}")
    child_saves = [{"slot": m.group(1).rsplit("/", 1)[-1],
                    "stop_ms": float(m.group(2)),
                    "write_s": float(m.group(3)), "bytes": int(m.group(4))}
                   for m in _INTERVAL_LINE.finditer(output)]
    log("[resilience] supervised " + json.dumps({
        "faults": faults, "restarts_total": stats["restarts_total"],
        "causes": stats["causes"], "clean": stats["clean"],
        "wall_s": sup_wall, "attempts": attempts,
        "last_data_state": ds, "interval_saves": child_saves,
        "card": card}))
    log("[resilience] check " + json.dumps({
        "bitwise_equal_tensors": compared,
        "losses_equal": len(sup_losses), "losses_uninterrupted":
        len(base_losses), "global_step": ds["global_step"],
        "model_best": True, "checkpoint_epoch1_pruned": True,
        "card": card}))
    shutil.rmtree(root)
    return launches


def _attempts(save_root: Path, events: Path) -> list:
    """One row per supervised attempt (its run directory, run ids sort by
    start): the first step, the step after the last one it finished, the
    steps it replayed, the newest checkpoint it completed (``saved_step``:
    the highest ``global_step`` of its ``data_state`` sidecars, 0 without
    one; a slot still being written when the process died has none), its
    restart-to-first-step time from its spawn and from the previous
    attempt's exit (the first step's end: the next step's flight record
    time less its iteration), its exit code."""
    evts = [json.loads(line) for line in events.read_text().splitlines()
            if line.strip()]
    spawns = [e for e in evts if e["event"] == "spawn"]
    exits = [e for e in evts if e["event"] == "exit"]
    runs = sorted(p for p in save_root.glob("*/train/*") if p.is_dir())
    rows = []
    for i, run in enumerate(runs):
        recs = sorted((json.loads(line) for line in
                       (run / "telemetry.jsonl").read_text().splitlines()),
                      key=lambda r: r.get("step", -1))
        steps = [r for r in recs if "event" not in r]
        saved = [json.loads(p.read_text())["global_step"]
                 for p in run.glob("checkpoint-*.data_state.json")]
        row = {"attempt": i + 1, "run": str(run), "first_step": None,
               "next_step": None, "replayed": None,
               "saved_step": max(saved, default=0),
               "returncode": exits[i]["returncode"],
               "runtime_s": exits[i]["runtime_s"]}
        if steps:   # an attempt that resumed past the last epoch has none
            first = steps[0]["step"]
            nxt = next((r for r in steps if r["step"] == first + 1
                        and "loss" not in r), None)
            end = (nxt["t"] - nxt["wall_ms"] / 1e3) if nxt \
                else steps[0]["t"]
            row.update(first_step=first, next_step=steps[-1]["step"] + 1,
                       spawn_to_first_step_s=end - spawns[i]["t"])
            if i:
                row["exit_to_first_step_s"] = end - exits[i - 1]["t"]
                if rows[-1]["next_step"] is not None:
                    row["replayed"] = rows[-1]["next_step"] - first
        rows.append(row)
    return rows


def _logged_losses(runs) -> dict:
    """Step -> logged loss over ``runs`` in order (a later run's record of
    a step it replayed wins)."""
    out = {}
    for run in runs:
        for line in (run / "telemetry.jsonl").read_text().splitlines():
            rec = json.loads(line)
            if "loss" in rec:
                out[rec["step"]] = rec["loss"]
    return out


def _assert_bitwise(got, want, where: str) -> int:
    """``got`` equal to ``want`` (nested state dicts): tensors bitwise,
    the rest by ``==``; returns the tensors compared."""
    if torch.is_tensor(want):
        if not (torch.is_tensor(got) and got.dtype == want.dtype
                and torch.equal(got, want)):
            raise AssertionError(f"{where} differs from the uninterrupted "
                                 f"run's")
        return 1
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{where}: keys {sorted(got)} against "
                                 f"{sorted(want)}")
        return sum(_assert_bitwise(got[k], want[k], f"{where}/{k}")
                   for k in want)
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"{where}: lengths differ")
        return sum(_assert_bitwise(a, b, f"{where}/{i}")
                   for i, (a, b) in enumerate(zip(got, want)))
    if got != want:
        raise AssertionError(f"{where}: {got!r} against {want!r}")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name} | nvidia-smi: {card}")
    t_start = time.perf_counter()
    phase_build()
    rows = phase_kernel()
    paged_rows = phase_paged_kernel()
    bwd_rows = phase_bwd_kernel()
    ffn_rows = phase_expert_ffn_kernel()
    phase_reference()
    phase_paged_reference()
    phase_train_reference()
    phase_moe_train_reference()
    flash_launches = phase_main(card, keep_artifact=True)
    paged_launches = phase_serve(card, WORK / "art" / "model")
    train_launches = phase_train(card)
    moe_launches = phase_moe_train(card)
    phase_lenet_reference()
    phase_mnist(card)
    obs_launches = phase_observe(card)
    res_launches = phase_resilience(card)
    shutil.rmtree(WORK)
    log(f"[device] all phases in {time.perf_counter() - t_start:.1f} s")
    kernels = []
    for kern in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        train_launches[kern] += obs_launches[kern] + res_launches[kern]
    flash_launches += train_launches["flash_fwd"] + moe_launches["flash_fwd"]
    for kernel, source, replaces, launches, shapes in (
            ("flash_fwd", KERNEL_SOURCE, KERNEL_REPLACES, flash_launches,
             rows),
            ("paged_attn", PAGED_SOURCE, PAGED_REPLACES, paged_launches,
             paged_rows),
            *((kern, BWD_SOURCE, BWD_REPLACES[kern],
               train_launches[kern] + moe_launches[kern],
               [r for r in bwd_rows if r["kernel"] == kern])
              for kern in ("flash_bwd_dkv", "flash_bwd_dq")),
            ("expert_ffn", FFN_SOURCE, FFN_REPLACES,
             moe_launches["expert_ffn"], ffn_rows)):
        head = shapes[0]
        kernels.append({
            "name": kernel, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            "ms": head["kernel_ms"], "plain_ms": head["ref_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "pct_of_bound": head["pct_of_bound"],
            "x_library": head["x_library"], "shapes": shapes})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
