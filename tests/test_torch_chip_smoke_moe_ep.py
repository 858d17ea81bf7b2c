"""chip_smoke.py's phase 20 (slice 15: the sparse Llama family and the
expert axis) driven on the CPU at a tiny width. On the card the kernels run
and count their launches; here counting stand-ins for their plain versions
do (the phases' ``count_plain`` in the ranks, the fixtures here), so the
phases' own checks hold here too.

- 20a: the card-vs-CPU check (both "devices" the CPU here) and cell (e)'s
  wave through the continuous engine with ServeWave's exact B4 / B1
  counts, on a tiny ``MixtralMoE`` (d_model 64, 4 experts, window 64).
- 20b: one spawn of 4 gloo ranks (``torchrun`` of ``chip_smoke.py
  --tp-child``) trains ``mixtral_8x7b_ep.json`` cut to that width (T 32,
  float32, capacity 1.0) on ``{"expert": 4}``, ``{"data": 2, "expert":
  2}`` and ``{"data": 4}`` against one process, and the expert-4
  checkpoint resumed in one process: the phase's own limits.
- 20b and 20c with fewer than 4 cards print that they did not run.
"""
import json

import pytest

import chip_smoke
from pytorch_distributed_template_tpu_torch.ops import flash
from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401
from test_torch_chip_smoke_tp import _process_signal_handlers  # noqa: F401

TINY = {"d_model": 64, "n_head": 4, "n_kv_head": 2, "d_ff": 64,
        "vocab_size": 256, "num_experts": 4, "max_len": 256, "window": 64}
TINY_SETS = [(f"arch;args;{k}", v) for k, v in TINY.items()] + [
    ("train_loader;args;seq_len", 32), ("valid_loader;args;seq_len", 32),
    ("train_loader;args;vocab_size", 256),
    ("valid_loader;args;vocab_size", 256)]
SERVE = dict(prefix=32, shared_suffix=[4, 8, 12, 16], alone=[8, 16, 24, 40],
             new=6, slots=8, chunk=4)


@pytest.fixture()
def counted_plain(monkeypatch):
    fwd, paged = flash.flash_attention_ref, flash.paged_attention_ref

    def counted_fwd(*args, **kw):
        flash.FLASH_FWD.launches += 1
        return fwd(*args, **kw)

    def counted_paged(*args, **kw):
        flash.PAGED_ATTN.launches += 1
        return paged(*args, **kw)

    monkeypatch.setattr(flash, "flash_attention_ref", counted_fwd)
    monkeypatch.setattr(flash, "paged_attention_ref", counted_paged)


def test_phase_20a_serves_the_sparse_family(counted_plain, capsys):
    out = chip_smoke.phase_moe_serve("cpu", device="cpu", sizes=SERVE,
                                     arch_over=TINY)
    row = out["row"]
    assert row["n_layer"] == 16 and row["requests"] == 8
    assert out["paged_attn"] == row["paged_attn_launches"] > 0
    assert out["paged_attn"] % 16 == 0
    ref = out["reference"]
    assert ref["layers"] == 2 and len(ref["batch1_ids"]) == 2
    assert all(len(ids) == chip_smoke.MOE_REF_NEW
               for ids in ref["paged_ids"])
    assert "[moe_serve]" in capsys.readouterr().out


def test_phase_20a_fails_when_the_paged_kernel_is_skipped():
    with pytest.raises(AssertionError, match="paged_attn launched 0"):
        chip_smoke.phase_moe_serve("cpu", device="cpu", sizes=SERVE,
                                   arch_over=TINY)


def test_phase_20b_meshes_equal_one_process(tmp_path):
    rows = chip_smoke.phase_ep_nccl(
        "cpu", device="cpu", work=tmp_path,
        common=chip_smoke.EP_NCCL_COMMON + TINY_SETS, timeout=600)
    assert set(rows) == {"expert4", "data2_expert2", "data4"}
    for name, mesh in chip_smoke.EP_NCCL_MESHES:
        row = rows[name]
        assert {k: row["sizes"][k] for k in mesh} == mesh
        assert max(row["rel_diff"]) <= chip_smoke.SEQ_NCCL_RTOL
        if "expert" in mesh:
            # the experts' Megatron pair, and the routing's psum with
            # data > 1
            assert all(s["all_reduce"] > 0
                       for s in row["collectives_per_step"])
        if mesh.get("data", 1) > 1:
            assert all(s["psum"] > 0 and s["all_gather"] > 0
                       for s in row["collectives_per_step"])
    # each expert-4 rank holds a quarter of the experts
    e4 = rows["expert4"]["param_bytes_per_rank"]
    assert len(set(e4)) == 1 and e4[0] < rows["data4"][
        "param_bytes_per_rank"][0]


def test_phases_20b_20c_need_four_cards(capsys):
    if chip_smoke.torch.cuda.device_count() >= 4:
        pytest.skip("four cards present: the phases run")
    assert chip_smoke.phase_ep_nccl("card", device="cuda") == {}
    assert chip_smoke.phase_ep_full("card", device="cuda") == {}
    lines = [json.loads(line.split("] ", 1)[1]) for line in
             capsys.readouterr().out.splitlines() if "not run" in line]
    assert [line["moe_ep"] for line in lines] == [
        f"not run: {chip_smoke.torch.cuda.device_count()} card(s)"] * 2
