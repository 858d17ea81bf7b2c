"""Profiling: throughput, MFU, and step-windowed ``torch.profiler``
capture (the port of the JAX package's ``observability/profiler.py``).

- ``ThroughputMeter``: steps/sec + examples/sec over timing windows (a
  copy of the JAX class).
- ``train_step_flops``: the model FLOPs of one train step, counted
  analytically (PERF.md §2): an LM's from its params and tokens, an
  image model's from its own count; None for any other model, so that
  ``mfu`` never applies the LM formula to an image batch. The JAX module reads the compiled step's
  FLOPs from XLA's cost analysis (``executable_flops``); eager PyTorch
  has no compiled program to ask, and ``torch.utils.flop_counter`` does
  not see the hand-written kernels the attention runs on. The two counts
  differ: XLA counts what the compiled program executes, the remat
  recompute of the forward included, while this count is the model's
  forward and backward once. An ``mfu`` of the port is therefore not
  comparable one for one with an ``mfu`` of the JAX package.
- ``mfu``: model FLOPs utilisation against one card's peak dense bf16
  rate, from a table keyed on ``torch.cuda.get_device_name`` (override:
  ``PDT_TPU_PEAK_FLOPS``, the JAX module's variable, or the trainer's
  ``profiler.peak_flops_per_device``).
- ``TraceCapture``: a step-windowed ``torch.profiler`` trace (host ops and,
  on CUDA, kernels) into ``<log_dir>/profile`` as a Chrome trace, started
  and stopped by the trainer's step counter so it covers steady-state
  steps; ``request`` arms an on-demand window and :func:`install_sigusr2`
  wires it to SIGUSR2.

- ``OnDemandProfiler``: the serving counterpart (``serve.py``'s ``POST
  /profile?steps=N``): a ``torch.profiler`` capture windowed on the
  scheduler's progress counter, one at a time, written as a Chrome trace
  under the run's save dir.
"""
from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Optional

import torch

# Peak dense bf16 FLOPs per card by ``torch.cuda.get_device_name``
# substring (lowercase, first match wins: the PCIe and NVL cards before
# the SXM card, whose name is "NVIDIA H100 80GB HBM3"). NVIDIA's H100
# datasheet, dense (without sparsity).
PEAK_FLOPS_TABLE = (
    ("h100 pcie", 756e12),
    ("h100 nvl", 835e12),
    ("h100", 989e12),
)


def peak_flops_per_device(device=None) -> Optional[float]:
    """Peak FLOPs/s of one card, or None when unknown (e.g. the CPU)."""
    env = os.environ.get("PDT_TPU_PEAK_FLOPS")
    if env:
        return float(env)
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, val in PEAK_FLOPS_TABLE:
        if key in name:
            return val
    return None


def train_step_flops(model, batch: int, t: int) -> Optional[float]:
    """Model FLOPs of one train step (forward + backward, no remat
    recompute), or None for a model without a count.

    An image model counts itself: 3 x ``batch`` x its
    ``flops_per_example()`` (ResNet: 2 k² C_in C_out H_out W_out per conv
    and the head; ViT: its Dense layers and non-causal attention over its
    own tokens, 197 at 224 px with patch 16). An LM (``d_model`` and
    ``n_layer``, ``t`` tokens per row): 6 x active params x tokens for
    the dense work (the tied head counted
    once, the position table ``wpe`` excluded; an MoE layer's stacked
    expert weights count ``top_k / E`` of their size, what one token uses,
    not the capacity padding; a LoRA layer's frozen base weight counts 4
    x, its weight gradient never computed) plus 12 x d_model x (visible
    keys summed over the queries) x batch per layer for the attention
    (two matmuls, forward and twice that backward), causal unless the
    model says ``causal = False`` (the BERT family)."""
    from ..models.lora import LoRADense
    from ..models.moe import MoeMlp
    from ..ops.flash import visible_keys

    model = getattr(model, "module", model)
    if hasattr(model, "flops_per_example"):
        return 3.0 * batch * model.flops_per_example()
    if not (hasattr(model, "d_model") and hasattr(model, "n_layer")) \
            or t <= 0:
        return None
    n = sum(p.numel() for name, p in model.named_parameters()
            if name.rsplit(".", 1)[-1] != "wpe")
    frozen = 0
    for mod in model.modules():
        if isinstance(mod, MoeMlp):
            idle = 1 - min(mod.top_k, mod.num_experts) / mod.num_experts
            n -= idle * sum(getattr(mod, leaf).numel()
                            for leaf in ("wi", "wg", "wo", "bi", "bo")
                            if hasattr(mod, leaf))
        elif isinstance(mod, LoRADense):
            frozen += mod.weight.numel()
    window = int(getattr(model, "window", 0) or 0)
    causal = bool(getattr(model, "causal", True))
    attn = 12.0 * model.d_model * visible_keys(t, causal, window) * batch \
        * model.n_layer
    return (6.0 * n - 2.0 * frozen) * batch * t + attn


def mfu(flops_per_step: Optional[float], steps_per_sec: float,
        peak_per_device: Optional[float] = None) -> Optional[float]:
    """Model FLOPs utilisation in [0, 1]; None when peak or FLOPs are
    unknown. ``flops_per_step`` is one process's (one card's) step."""
    if not flops_per_step or not steps_per_sec:
        return None
    if peak_per_device is None:
        peak_per_device = peak_flops_per_device()
    if peak_per_device is None:
        return None
    return (flops_per_step * steps_per_sec) / peak_per_device


class ThroughputMeter:
    """Windowed steps/sec + examples/sec.

    ``update(n_examples)`` once per step; ``rate()`` returns the rates since
    the last ``rate()``/``reset()`` call and opens a new window. The trainer
    resets it after the run's first step, which carries the kernel builds.
    """

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0
        self._examples = 0

    def update(self, n_examples: int = 0) -> None:
        self._steps += 1
        self._examples += int(n_examples)

    def rate(self) -> dict:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        out = {
            "steps_per_sec": self._steps / dt,
            "examples_per_sec": self._examples / dt,
        }
        self.reset()
        return out


class TraceCapture:
    """Step-windowed ``torch.profiler`` trace into ``<log_dir>/profile``.

    :param log_dir: run log dir; traces land in its ``profile/`` subdir
        (``tensorboard_trace_handler``: one ``*.pt.trace.json`` per window).
    :param start_step: first step included in the capture (global step).
    :param num_steps: how many steps to capture (0: nothing scheduled --
        but ``request()`` can still arm a capture at runtime).

    Call ``before_step(step)`` / ``after_step(step)`` around each train
    step; a no-op while no window is armed. ``request(n)`` arms an
    on-demand n-step capture from the next step (a single attribute
    write, safe from a signal handler). Each completed capture bumps the
    ``profile_captures_total`` counter (observability/health) and, with a
    recorder attached, lands an ``event: "profile_capture"`` record.
    """

    def __init__(self, log_dir, start_step: int = 10, num_steps: int = 0):
        self.dir = str(Path(log_dir) / "profile")
        self.start_step = int(start_step)
        self.num_steps = int(num_steps)
        self._active = False
        self._done = self.num_steps <= 0
        self._requested: Optional[int] = None
        self._prof = None
        self.captures = 0
        self.recorder = None

    def attach_recorder(self, recorder) -> None:
        """Optional FlightRecorder that capture completions get noted on."""
        self.recorder = recorder

    def request(self, num_steps: int = 5) -> None:
        """Arm an on-demand capture of ``num_steps`` steps from the next
        ``before_step``; ignored while a capture is in flight."""
        if self._active:
            return
        self._requested = max(int(num_steps), 1)

    def _start(self) -> None:
        from torch.profiler import (
            ProfilerActivity, profile, tensorboard_trace_handler,
        )

        Path(self.dir).mkdir(parents=True, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities,
                             on_trace_ready=tensorboard_trace_handler(
                                 self.dir))
        self._prof.start()

    def _stop(self) -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            # the captured steps were only enqueued: let them finish
            torch.cuda.synchronize()
        self._prof.stop()
        self._prof = None

    def before_step(self, step: int) -> None:
        if self._active:
            return
        if self._requested is not None:
            # runtime trigger: re-arm regardless of the config-scheduled
            # window having been consumed
            self.num_steps = self._requested
            self._requested = None
            self._done = False
            self.start_step = step
        if not self._done and step >= self.start_step:
            self._start()
            self._active = True
            self._until = step + self.num_steps

    def after_step(self, step: int) -> None:
        if self._active and step + 1 >= self._until:
            self._stop()
            self._active = False
            self._done = True
            self._note_capture(step)

    def _note_capture(self, step: int) -> None:
        self.captures += 1
        from .health import bump_counter

        bump_counter("profile_captures_total")
        if self.recorder is not None:
            try:
                self.recorder.record(
                    step, event="profile_capture",
                    profile_dir=self.dir, profile_steps=self.num_steps,
                )
            except Exception:  # noqa: BLE001
                pass

    def close(self) -> None:
        if self._active:
            self._stop()
            self._active = False
            self._done = True
            self._note_capture(self.start_step + self.num_steps)


def install_sigusr2(trace: TraceCapture, default_steps: int = 5) -> bool:
    """SIGUSR2 -> ``trace.request(n)``: on-demand profiling of a live
    training run (``kill -USR2 <pid>``). ``PDT_PROFILE_STEPS`` overrides
    the window length. Returns False on platforms without SIGUSR2 or
    when not called from the main thread."""
    import signal

    if not hasattr(signal, "SIGUSR2"):
        return False

    def _handler(signum, frame):
        try:
            n = int(os.environ.get("PDT_PROFILE_STEPS", default_steps))
        except ValueError:
            n = default_steps
        trace.request(n)

    try:
        signal.signal(signal.SIGUSR2, _handler)
        return True
    except ValueError:  # not the main thread
        return False


class OnDemandProfiler:
    """Progress-windowed on-demand capture for step-less processes
    (``serve.py``'s ``POST /profile?steps=N``; the JAX package's class of
    the same name, over ``torch.profiler``).

    The serving schedulers have no global step counter, but they have
    monotonic progress counters (continuous engine: ``chunks``; static:
    ``batches``). ``capture()`` starts a ``torch.profiler`` trace (host ops
    and, on CUDA, every kernel the process launches, the engine thread's
    included), waits until ``progress_fn`` has advanced by ``steps`` (or
    ``timeout_s`` passes: an idle server must not pin a request thread
    forever), stops, and writes ``<out_dir>/profile/serve_<n>.pt.trace.
    json``. One capture at a time: a concurrent caller gets ``busy``.
    """

    def __init__(self, out_dir):
        import threading

        self.dir = str(Path(out_dir) / "profile")
        self._lock = threading.Lock()
        self.captures = 0

    def capture(self, steps: int = 0, progress_fn=None,
                timeout_s: float = 30.0, poll_s: float = 0.05) -> dict:
        from torch.profiler import ProfilerActivity, profile

        if not self._lock.acquire(blocking=False):
            return {"busy": True,
                    "error": "a profile capture is already running"}
        prof = None
        try:
            Path(self.dir).mkdir(parents=True, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
            if cuda:
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
            t0 = time.monotonic()
            base = progress_fn() if (progress_fn and steps > 0) else 0
            seen, timed_out = 0, False
            while progress_fn is not None and steps > 0:
                seen = progress_fn() - base
                if seen >= steps:
                    break
                if time.monotonic() - t0 > timeout_s:
                    timed_out = True
                    break
                time.sleep(poll_s)
            if cuda:
                # the window's kernels were only enqueued: let them land
                torch.cuda.synchronize()
            prof.stop()
            self.captures += 1
            path = Path(self.dir) / f"serve_{self.captures}.pt.trace.json"
            prof.export_chrome_trace(str(path))
            prof = None
            from .health import bump_counter

            bump_counter("profile_captures_total")
            return {
                "profile_dir": self.dir,
                "trace_file": str(path),
                "steps_requested": int(steps),
                "steps_observed": int(seen),
                "duration_s": round(time.monotonic() - t0, 3),
                "timed_out": timed_out,
                "captures_total": self.captures,
            }
        except Exception as e:  # noqa: BLE001 — surface, don't kill serve
            if prof is not None:
                try:
                    prof.stop()
                except Exception:  # noqa: BLE001
                    pass
            return {"error": f"{type(e).__name__}: {e}"}
        finally:
            self._lock.release()
