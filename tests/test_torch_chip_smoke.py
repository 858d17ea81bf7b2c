"""chip_smoke.py's reference and main-path phases, driven on the CPU at a
tiny size. On the card the flash kernel runs and counts its launches;
here its plain version runs, so a counting stand-in for the plain version
shows that every request went through flash attention exactly ``n_layer``
times per prefill, and that the script fails a run whose path skipped it.
"""
import pytest

import chip_smoke
from pytorch_distributed_template_tpu_torch.ops import flash

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
