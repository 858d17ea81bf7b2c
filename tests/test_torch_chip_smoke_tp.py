"""chip_smoke.py's phase 18 (slice 13, tensor parallelism and ZeRO-3)
driven on the CPU at a tiny width. On the card the flash kernels run and
count their launches; here the ranks count their plain versions instead
(the phase's ``count_plain`` on a CPU device), so its checks hold here too.

- 18b: one spawn of 4 gloo ranks (``torchrun`` of ``chip_smoke.py
  --tp-child``) trains ``configs/mistral_7b_fsdp.json`` cut to a tiny width
  (2 layers, d_model 256, 8 heads over 4 KV heads, d_ff 128, vocab 256, T
  32, window 16; float32) on ``{"fsdp": 4}``, ``{"tensor": 4}``,
  ``{"fsdp": 2, "tensor": 2}`` and ``{"data": 2, "fsdp": 2}``, then
  resumes the fsdp-4 checkpoint on ``{"tensor": 4}``, against one process
  and that checkpoint resumed in one process: the phase's own limits.
- 18b and 18c with fewer than 4 cards print that they did not run.
- The cuda-marked test runs 18b at the same tiny width on four cards over
  NCCL (on a host with four cards: ``python -m pytest --noconftest -p
  no:cacheprovider -q tests/test_torch_chip_smoke_tp.py -m cuda``).
"""
import json
import signal

import pytest
import torch

import chip_smoke
from pytorch_distributed_template_tpu_torch.utils import preemption
from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401

# the module imports nothing of JAX: its cuda test runs on the card with
# --noconftest

# head_dim 32: the smallest the flash kernels take on the card
TINY_MISTRAL = [("arch;args;d_model", 256), ("arch;args;n_head", 8),
                ("arch;args;n_kv_head", 4), ("arch;args;d_ff", 128),
                ("arch;args;vocab_size", 256), ("arch;args;max_len", 64),
                ("arch;args;window", 16),
                ("train_loader;args;seq_len", 32),
                ("valid_loader;args;seq_len", 32),
                ("train_loader;args;vocab_size", 256),
                ("valid_loader;args;vocab_size", 256)]


@pytest.fixture(autouse=True, scope="module")
def _process_signal_handlers():
    """The trainers run here install the port's SIGTERM handler; the
    handlers the module found come back after it."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, handler in saved.items():
        signal.signal(s, handler)
    preemption._installed = False


@pytest.fixture(scope="module")
def nccl_rows(tmp_path_factory):
    return chip_smoke.phase_tp_nccl(
        "cpu", device="cpu", work=tmp_path_factory.mktemp("tp"),
        common=chip_smoke.TP_NCCL_COMMON + TINY_MISTRAL, timeout=600)


def test_phase_18b_meshes_equal_one_process(nccl_rows):
    assert sorted(nccl_rows) == sorted(
        [m for m, _ in chip_smoke.TP_NCCL_MESHES] + ["resumed_tensor4"])
    for name, mesh in chip_smoke.TP_NCCL_MESHES:
        row = nccl_rows[name]
        assert {k: row["sizes"][k] for k in mesh} == mesh
        assert row["backend"] == "gloo" and row["world"] == 4
        assert max(row["rel_diff"]) <= chip_smoke.SEQ_NCCL_RTOL
        # B1, B3 and B2 (their plain versions here) on every rank
        assert all(all(n > 0 for n in r) for r in row["launches_per_rank"])


def test_phase_18b_shares_and_collectives(nccl_rows):
    """Each rank holds a quarter on fsdp 4 and tensor 4 (every Mistral leaf
    splits 4 ways; the norms replicate on tensor 4); the gathers run on
    the fsdp meshes, the Megatron all-reduces on the tensor ones."""
    fsdp, tensor = nccl_rows["fsdp4"], nccl_rows["tensor4"]
    assert len(set(fsdp["param_bytes_per_rank"])) == 1
    assert len(set(tensor["param_bytes_per_rank"])) == 1
    one = fsdp["param_bytes_per_rank"][0] * 4
    assert tensor["param_bytes_per_rank"][0] * 4 > one   # replicated norms
    for step in fsdp["collectives_per_step"]:
        # forward gathers (root once, 2 blocks, the remat re-gathers) and
        # their reduce-scatters; no Megatron all-reduce
        assert step["all_gather"] == 1 + 2 + 2
        assert step["reduce_scatter"] == 1 + 2
        assert step["all_reduce"] == 0
    for step in tensor["collectives_per_step"]:
        assert step["all_gather"] >= 1 and step["reduce_scatter"] == 0
        assert step["all_reduce"] > 0
    # the fsdp-4 checkpoint resumed on tensor 4: its epoch 2
    resumed = nccl_rows["resumed_tensor4"]
    assert len(resumed["losses"]) == chip_smoke.TP_NCCL_STEPS
    assert max(resumed["rel_diff"]) <= chip_smoke.SEQ_NCCL_RTOL


def test_phase_18_says_it_did_not_run(capsys):
    if torch.cuda.device_count() >= 4:
        pytest.skip("four cards: the phases run (the cuda test below)")
    assert chip_smoke.phase_tp_nccl("cpu", device="cuda") == {}
    assert chip_smoke.phase_tp_full("cpu", device="cuda") == {}
    lines = [json.loads(line.split(" ", 1)[1]) for line in
             capsys.readouterr().out.splitlines() if line.startswith("[tp_")]
    assert [r["tp_fsdp"] for r in lines] == [
        f"not run: {torch.cuda.device_count()} card(s)"] * 2


def test_phase_18_config_is_mistral_at_its_published_widths():
    cfg = json.loads(chip_smoke.MISTRAL_FSDP_CONFIG.read_text())
    assert cfg["arch"]["type"] == "Mistral"
    assert cfg["mesh"]["axes"] == {"fsdp": 4}
    assert cfg["arch"]["args"] == {"bfloat16": True, "remat": True,
                                   "attn_impl": "flash"}
    assert cfg["train_loader"]["args"]["seq_len"] == 4096
    # the global batch of 4 over the fsdp axis
    assert cfg["train_loader"]["args"]["batch_size"] * 4 == \
        chip_smoke.TP_GLOBAL_BATCH
    assert not cfg["trainer"]["health"]["enabled"]
    assert not cfg["trainer"]["telemetry"]["enabled"]


@pytest.mark.cuda
def test_four_nccl_ranks_equal_one_process(tmp_path):
    """18b at the tiny width on four cards (NCCL), against one rank."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 cards, found {torch.cuda.device_count()}")
    rows = chip_smoke.phase_tp_nccl(
        "cuda-test", device="cuda", work=tmp_path,
        common=chip_smoke.TP_NCCL_COMMON + TINY_MISTRAL)
    for name, _ in chip_smoke.TP_NCCL_MESHES:
        assert rows[name]["backend"] == "nccl"
        assert max(rows[name]["rel_diff"]) <= chip_smoke.SEQ_NCCL_RTOL
