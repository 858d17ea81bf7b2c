"""chip_smoke.py's phases of slices 1 and 2 (serving), driven on the CPU at
a tiny size. On the card the kernels run and count their launches; here
their plain versions run, so counting stand-ins for the plain versions show
that every step went through the kernels as often as the phase asserts, and
that the script fails a run whose path skipped them.
"""
import pytest
import torch

import chip_smoke
from pytorch_distributed_template_tpu_torch.ops import flash

@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The module's torch work on one intra-op thread, the process's
    count put back after it: several test workers share the host's
    cores, and OpenMP teams of every core's width in each of them spin
    against one another (the phases' CPU runs were ~10x slower so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TINY = dict(vocab_size=512, n_layer=2, n_head=4, n_kv_head=2, d_model=64,
            d_ff=128, window=16, bfloat16=False, max_len=256)
# prompt b (40) + new (6) passes the window (16): the rolling cache runs
SIZES = dict(prompt_a=20, prompt_b=40, prompt_d=24, batch_d=2, new=6)


@pytest.fixture()
def counted_plain(monkeypatch):
    ref = flash.flash_attention_ref

    def counted(*args, **kw):
        flash.FLASH_FWD.launches += 1
        return ref(*args, **kw)

    monkeypatch.setattr(flash, "flash_attention_ref", counted)


def test_reference_phase_on_cpu(counted_plain):
    chip_smoke.phase_reference(device="cpu")


def test_main_path_on_cpu(counted_plain, tmp_path):
    launches = chip_smoke.phase_main(
        "cpu", device="cpu", arch_args=TINY, sizes=SIZES,
        work=tmp_path / "smoke")
    # prefills: (a) 3 + the CLI 1, (b) 2, (c) 3, (d) 2
    assert launches == TINY["n_layer"] * (4 + 2 + 3 + 2)
    assert not (tmp_path / "smoke").exists()


def test_main_path_fails_when_flash_is_skipped(tmp_path):
    with pytest.raises(AssertionError, match="launched 0 times"):
        chip_smoke.phase_main("cpu", device="cpu", arch_args=TINY,
                              sizes=SIZES, work=tmp_path / "smoke")


# slice 2 at a tiny size: window 64 (an 11-page ring of 8-token blocks with
# 16-token prefill chunks), so the shared prefix stays inside the ring and
# the 120-token prompt of (f) wraps it
TINY_RING = dict(TINY, window=64)
SERVE = dict(prefix=32, shared_suffix=[4, 8, 12, 16],
             alone=[8, 16, 24, 40], new=6, long=120, long_new=6, short=10,
             short_new=12, logit_prompt=30, slots=8, chunk=4)


@pytest.fixture()
def counted_paged(monkeypatch):
    ref = flash.paged_attention_ref

    def counted(*args, **kw):
        flash.PAGED_ATTN.launches += 1
        return ref(*args, **kw)

    monkeypatch.setattr(flash, "paged_attention_ref", counted)


@pytest.fixture()
def tiny_serving(tmp_path):
    import json

    from pytorch_distributed_template_tpu_torch.tools import (
        make_serving_artifact as tool,
    )

    args = ["-o", str(tmp_path / "art"), "--arch", "Llama", "--device",
            "cpu", "--seed", "1"]
    for key, val in TINY_RING.items():
        args += ["--" + key.replace("_", "-"),
                 json.dumps(val) if isinstance(val, bool) else str(val)]
    tool.main(args)
    cfg = json.loads(chip_smoke.SERVE_CONFIG.read_text())
    cfg["arch"] = {"type": "Llama", "args": TINY_RING}
    cfg["serving"]["prefix_cache"].update(block_tokens=8, pool_blocks=160)
    cfg["serving"]["prefill_chunk_tokens"] = 16
    path = tmp_path / "tiny_paged.json"
    path.write_text(json.dumps(cfg))
    return tmp_path / "art" / "model", path


def test_paged_reference_phase_on_cpu():
    chip_smoke.phase_paged_reference(device="cpu")


def test_serve_phase_on_cpu(counted_paged, counted_plain, tiny_serving,
                            tmp_path):
    model_path, config = tiny_serving
    launches = chip_smoke.phase_serve("cpu", model_path, config=config,
                                      device="cpu", sizes=SERVE,
                                      work=tmp_path / "work")
    assert launches > 0 and launches % TINY["n_layer"] == 0
    # the logit check and the (e)-(g) waves left B1 out of the counted
    # windows: the waves assert it launched 0 times


def test_serve_phase_fails_when_paged_attention_is_skipped(tiny_serving,
                                                           tmp_path):
    model_path, config = tiny_serving
    with pytest.raises(AssertionError, match="paged_attn launched 0"):
        chip_smoke.phase_serve("cpu", model_path, config=config,
                               device="cpu", sizes=SERVE,
                               work=tmp_path / "work")


def test_ptxas_report_names_each_kernels_spills_and_registers():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__b96386b7"
        "_12_flash_fwd_cu_ccad3abb2tc15flash_fwd_wgmmaILi128EEEv14CUtensor"
        "Map_st' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN45_GLOBAL__N__b96386b7_"
        "12_flash_fwd_cu_ccad3abb2tc15flash_fwd_wgmmaILi128EEEv14CUtensorM"
        "ap_st",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 16 barriers",
        "ptxas info    : (C7514) Potential Performance Loss: wgmma.mma_async"
        " instructions are serialized",
        "ptxas info    : Compile time = 812.345 ms",
    ])
    assert chip_smoke.ptxas_report(log) == [
        "2tc15flash_fwd_wgmmaILi128EE: 0 bytes stack frame, 0 bytes spill "
        "stores, 0 bytes spill loads",
        "2tc15flash_fwd_wgmmaILi128EE: ptxas info    : Used 168 registers, "
        "used 16 barriers",
        "ptxas info    : (C7514) Potential Performance Loss: wgmma.mma_async"
        " instructions are serialized",
    ]
