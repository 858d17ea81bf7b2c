"""Where the bf16 flash-forward kernel (B1) spends its time, by phase.

    python -m pytorch_distributed_template_tpu_torch.tools.flash_fwd_phases

A kernel profiler such as Nsight Compute is not needed: the kernel counts
its own cycles. Built with ``-DPDT_FWD_PROFILE``,
``csrc/flash_fwd.cu`` reads ``clock()`` at the edges of each phase in
thread 0 of each consumer warpgroup and in the producer thread, and sums
the cycles over the blocks. This tool builds that variant beside the
normal library, runs it once at each bf16 shape of the main paths, and
prints one JSON line per shape: the consumers' cycles per K/V tile and
their shares by phase, and the producer's share spent waiting for a free
stage. Consumer phases:

- ``wait_load``: waiting for the item's Q and the tile's K (or the last
  tile's V) to land;
- ``issue``: a turn on the tensor cores (waiting for the other consumer's
  hand-over, below D 128) and the issue of the scores' and the previous
  tile's P V products, with the wait for that V; a wgmma issue also waits
  while the tensor cores are busy;
- ``wait_scores``: the scores' products still running after the issue;
- ``softmax``: masking, the online softmax, the rescale of the output and
  the packing of P to bf16, on the CUDA cores;
- ``wait_pv``: P V still running after the softmax, and each item's last
  P V;
- ``epilogue``: the stores of out and lse.

Reading ``clock()`` adds a few instructions per phase (and may add
spills), so the instrumented kernel runs a little slower than the normal
one; its shares, not its times, are the result. Needs the card and
``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from ..ops import build
from ..ops.flash import FLASH_FWD

BQ = BK = 128  # the kernel's query and key tiles
# (B, H, KVH, T, D, causal, window): the main paths' bf16 shapes (slice 1
# prefills at Mistral-7B width, GPT-2 small and the MoE LM training)
SHAPES = [
    (1, 32, 8, 1024, 128, True, 4096),
    (1, 32, 8, 6144, 128, True, 4096),
    (4, 32, 8, 2048, 128, True, 4096),
    (8, 12, 12, 1024, 64, True, 0),
    (32, 8, 8, 512, 64, True, 0),
]
PHASES = ["wait_load", "issue", "wait_scores", "softmax", "wait_pv",
          "epilogue"]


def kv_tiles(t: int, causal: bool, window: int) -> int:
    """K/V tiles the kernel walks for one (batch, head): for each query
    tile, from the tile holding its band's first key to the diagonal
    (causal) or the end."""
    total = 0
    for q0 in range(0, t, BQ):
        k_lo = max(0, q0 - window + 1) // BK * BK if window > 0 else 0
        k_hi = min(t, q0 + BQ) if causal else t
        total += -(-(k_hi - k_lo) // BK)
    return total


def build_profiled() -> ctypes.CDLL:
    """``csrc/flash_fwd.cu`` built with ``-DPDT_FWD_PROFILE``."""
    src = FLASH_FWD.source
    out = build.BUILD_DIR / (f"libflash_fwd_profile-"
                             f"{build.source_digest(src)}.so")
    if not out.is_file():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS,
                        "-DPDT_FWD_PROFILE", "-o", str(out), str(src),
                        *build.LINK_FLAGS], check=True,
                       capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pdt_flash_fwd.argtypes = [ptr] * 5 + [i32] * 8 + [ctypes.c_float,
                                                          ptr]
    lib.pdt_flash_fwd_profile.argtypes = [ptr]
    return lib


def profile_shape(lib, shape, gen) -> dict:
    b, h, kvh, t, d, causal, window = shape

    def rnd(heads):
        return torch.randn((b, t, heads, d), generator=gen,
                           device="cuda").bfloat16()

    q, k, v = rnd(h), rnd(kvh), rnd(kvh)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), device="cuda")
    cycles = (ctypes.c_ulonglong * 8)()

    def run():
        err = lib.pdt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, t, h, kvh, d, 1, int(causal), window,
            d ** -0.5, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
        torch.cuda.synchronize()
        err = lib.pdt_flash_fwd_profile(ctypes.addressof(cycles))
        if err:
            raise RuntimeError(f"reading the profile failed: {err}")

    run()  # warm-up; reading the profile zeroes it
    run()
    cons, prod = list(cycles[:6]), list(cycles[6:])
    tiles = b * h * kv_tiles(t, causal, window)
    return {"B": b, "H": h, "KVH": kvh, "T": t, "D": d, "causal": causal,
            "window": window, "kv_tiles": tiles,
            "consumer_cycles_per_tile": sum(cons) / (2 * tiles),
            "share": {p: c / sum(cons) for p, c in zip(PHASES, cons)},
            "producer_wait_share": prod[0] / sum(prod)}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_phases: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    lib = build_profiled()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in SHAPES:
        print(json.dumps(profile_shape(lib, shape, gen)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
