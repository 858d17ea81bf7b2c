"""chip_smoke.py's phase 22 (page shipping between a prefill and a decode
server, the KV spill tiers) driven on the CPU at a tiny size. On the card
B4 runs and counts its launches; here its plain version runs under a
counting stand-in, so the phase's exact counts hold here too.

- 22a with both sides on the CPU: payloads cross between pools and decode
  the colocated ids, ``serialize_pages`` agrees across devices, B4 over
  imported pages equals its plain version;
- 22b / 22c over a tiny ring Llama artifact: the handoff's ids equal the
  colocated warm repeat's, the bytes balance, the int8 pools ship their
  scales, evicted pages are promoted with the first ids, and a corrupt
  spill gives the ids of a server holding only the verified blocks.
"""
import pytest

import chip_smoke
from test_torch_chip_smoke_serving import (  # noqa: F401
    SERVE, TINY_RING, _one_intra_op_thread, counted_paged, counted_plain,
    tiny_serving,
)

# the tiny ring's 11-page rows fit a 14-page pool; its 19 pages of prompts
# do not
SHIP = dict(SERVE, small_pool=14, host_spill=4, disk_spill=64, first=2,
            ttft_prompt=40)


def test_ship_reference_phase_on_cpu(counted_paged):
    errs = chip_smoke.phase_ship_reference(device="cpu")
    assert errs == {"f32": 0.0, "int8": 0.0}


def test_ship_phase_on_cpu(counted_paged, counted_plain, tiny_serving,
                           tmp_path):
    model_path, config = tiny_serving
    launches = chip_smoke.phase_ship(
        "cpu", model_path, config=config, device="cpu",
        work=tmp_path / "work", sizes=SHIP, arch="Llama",
        arch_args=TINY_RING)
    assert launches > 0 and launches % TINY_RING["n_layer"] == 0


def test_ship_phase_fails_when_imports_skip_their_pages(
        counted_paged, counted_plain, tiny_serving, tmp_path, monkeypatch):
    from pytorch_distributed_template_tpu_torch.engine.kvcache import (
        PrefixCache,
    )

    monkeypatch.setattr(PrefixCache, "_write_pages",
                        lambda self, ids, content: None)
    model_path, config = tiny_serving
    with pytest.raises(AssertionError):
        chip_smoke.phase_ship(
            "cpu", model_path, config=config, device="cpu",
            work=tmp_path / "work", sizes=SHIP, arch="Llama",
            arch_args=TINY_RING)
