#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase's exception is
caught:

1. build: compile every CUDA source of the port with nvcc (one process per
   source, all started together) and print the build time and the ptxas
   register report;
2. kernel against plain: the flash-attention forward kernel against its
   plain PyTorch version on the card, at the main path's prefill shapes
   and at a ragged f32 and a non-causal case, with kernel / plain /
   library (``scaled_dot_product_attention``, timed only) times and the
   card's bound;
3. reference: a small float32 Llama served on the card (kernel path) and
   on the CPU (plain path) gives the same prefill logits and the same
   greedy tokens;
4. main path: a random-init Mistral-7B artifact at full width, made by the
   port's tool, served through ``GenerationService``, the ``generate`` CLI
   and ``engine.generate.generate``: (a) a 1024-token prompt, 32 greedy
   tokens, twice, identical; (b) a 6144-token prompt, past the 4096-token
   window (rolling cache, banded kernel); (c) a sampled request with a stop
   id; (d) a batch of 4 x 2048-token prompts. The flash launch count is set
   to 0 before each request and must read exactly ``n_layer`` per prefill
   after it. Then request (a) runs under ``torch.profiler`` (prefill alone,
   then the whole request) for the device's busy time and top kernels.

The last three lines of standard output are the card's name and power
limit as nvidia-smi gives them, the ``kernels`` JSON line and the device
line ``{"ok": true, "device": {...}}``. The script needs a CUDA device and
the repository beside it; it imports nothing of JAX.
"""
from __future__ import annotations

import gc
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

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
# ragged f32 case and a non-causal banded case
KERNEL_SHAPES = [
    (1, 32, 8, 1024, 128, True, 4096, torch.bfloat16),
    (1, 32, 8, 6144, 128, True, 4096, torch.bfloat16),
    (4, 32, 8, 2048, 128, True, 4096, torch.bfloat16),
    (1, 16, 4, 1000, 64, True, 0, torch.float32),
    (2, 8, 8, 512, 32, False, 128, torch.bfloat16),
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
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_build() -> None:
    # importing a kernel's module registers its library for build_all
    from pytorch_distributed_template_tpu_torch.ops import build, flash

    assert flash.FLASH_FWD in build.LIBRARIES
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"[build] {len(build.LIBRARIES)} libraries in "
        f"{time.perf_counter() - t0:.2f} s (built now: {built})")
    for lib in build.LIBRARIES:
        lib.load()
        for line in lib.build_log.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line
                                    or "smem" in line):
                log(f"[build] {lib.name}: {line.strip()}")


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
        rows.append(row)
        log("[kernel] " + json.dumps(row))
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    FLASH_FWD.launches = 0
    return rows


def phase_reference(device="cuda") -> None:
    """A small f32 Llama on ``device`` (kernel path) against the same
    weights on the CPU (plain path): prefill logits within
    ``REF_LOGIT_ATOL``, greedy tokens identical."""
    import numpy as np

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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if service.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(service.device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        service.generate(prompt_ids=ids, max_new_tokens=new)
        _sync(service.device)
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    row = {"profile": label, "prompt_len": len(ids), "new_tokens": new,
           "wall_ms": wall_us / 1e3,
           "device_busy_ms": busy / 1e3 if spans else "not measured",
           "device_idle_share": 1 - busy / wall_us if spans
           else "not measured",
           "device_ops": len(spans),
           "device_ops_per_token": len(spans) / new,
           "top": [{"kernel": k[:90], "ms": us / 1e3, "count": n}
                   for k, (us, n) in top],
           "card": card}
    log("[profile] " + json.dumps(row))


def _check_ids(ids, vocab: int, n: int, what: str) -> None:
    if len(ids) != n or not all(0 <= int(i) < vocab for i in ids):
        raise AssertionError(f"{what}: expected {n} ids in [0, {vocab}), "
                             f"got {ids}")


def phase_main(card: str, device="cuda", arch=MAIN_ARCH, arch_args=None,
               sizes=None, work=WORK, seed: int = 0) -> int:
    """Make the artifact with the port's tool, serve requests (a)-(d) and
    the CLI on it; returns the flash launches of the whole path."""
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
    shutil.rmtree(work)
    return run.launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name} | nvidia-smi: {card}")
    phase_build()
    rows = phase_kernel()
    phase_reference()
    launches = phase_main(card)
    head = rows[0]
    kernel = {
        "name": "flash_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": head["kernel_ms"], "plain_ms": head["ref_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "shapes": rows,
    }
    print(card, flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
