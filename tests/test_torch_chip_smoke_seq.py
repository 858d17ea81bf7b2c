"""chip_smoke.py's phase 14 (slice 9, sequence parallelism) driven on the
CPU at a tiny size. On the card the flash kernels run and count their
launches; here their plain versions run under counting stand-ins, so the
phase's exact counts hold here too.

- 14a: the one-process ring (contiguous banded, contiguous full, zigzag)
  and Ulysses paths against the whole sequence's flash attention, with
  the flash blocks the schedule predicts in the forward and the backward;
  it fails when a block bypasses ``flash_attention_lse`` (here: computed
  by the einsum block, which gives the same numbers and launches nothing).
  The full-width schedule counts are the ones the slice states: zigzag at
  S 4 36 blocks, the banded contiguous ring at T 16384 and window 2048 4.
  At T 2048 in bf16 the zigzag ring stays within the phase's limits, and
  one block mis-weighted 1.3x fails them while every launch is made.
- The plain forward in pieces (the large rows of phases 2/14a) equals it
  whole; the SDPA yardstick's expanded K/V give the same attention.
- 14b: ``configs/llama_swa_long.json`` through the port's ``train.py``
  at a tiny width, the seq axis 1, exact launches per step.
- 14c: with fewer than 4 cards the phase prints that it did not run; its
  4-card leg is the ``cuda``-marked test below (4 NCCL ranks, seq 4, the
  tiny configs, against one rank), run on four cards.
"""
import json
import math
import signal

import pytest
import torch

import chip_smoke
from pytorch_distributed_template_tpu_torch.ops import attention as att
from pytorch_distributed_template_tpu_torch.ops import flash
from pytorch_distributed_template_tpu_torch.utils import preemption
from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401
from test_torch_chip_smoke_serving import counted_plain  # noqa: F401


# the module imports nothing of JAX: its cuda test runs on the card with
# --noconftest


@pytest.fixture(autouse=True, scope="module")
def _process_signal_handlers():
    """The trainers run here install the port's SIGTERM handler; the
    handlers the module found come back after it."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, handler in saved.items():
        signal.signal(s, handler)
    preemption._installed = False


@pytest.fixture()
def counted_bwd(monkeypatch):
    ref = flash.flash_attention_bwd_ref

    def counted(*args, **kw):
        flash.FLASH_BWD_DKV.launches += 1
        flash.FLASH_BWD_DQ.launches += 1
        return ref(*args, **kw)

    monkeypatch.setattr(flash, "flash_attention_bwd_ref", counted)

# (name, impl, layout, B, T, H, KVH, D, window, S): tl 16 at S 4, so window
# 16 runs the diagonal and one edge block per shard
TINY_OPS = [
    ("banded", "ring_flash", "contig", 1, 64, 4, 2, 8, 16, 4),
    ("contig", "ring_flash", "contig", 2, 32, 4, 4, 8, 0, 4),
    ("zigzag", "ring_flash", "zigzag", 1, 64, 4, 2, 8, 0, 4),
    ("ulysses", "ulysses_flash", "contig", 1, 64, 4, 2, 8, 16, 4),
]
TINY_LLAMA = [("arch;args;n_layer", 2), ("arch;args;d_model", 64),
              ("arch;args;n_head", 4), ("arch;args;n_kv_head", 2),
              ("arch;args;max_len", 64), ("arch;args;window", 16),
              ("train_loader;args;seq_len", 64),
              ("valid_loader;args;seq_len", 64),
              ("trainer;tensorboard", False)]
TINY_GPT2 = [("arch;args;n_layer", 2), ("arch;args;d_model", 64),
             ("arch;args;n_head", 4), ("arch;args;max_len", 64),
             ("train_loader;args;seq_len", 64),
             ("valid_loader;args;seq_len", 64)]
TINY_CORPUS = 8 * 4 * 64 * 10 // 9 + 200     # 8 steps of 4 rows, 3 eval


def _ops(**kw):
    return chip_smoke.phase_seq_ops("cpu", device="cpu", cases=TINY_OPS,
                                    dtype=torch.float32, **kw)


def test_seq_ops_phase_on_cpu(counted_plain, counted_bwd):
    rows = _ops()
    assert [r["case"] for r in rows] == [c[0] for c in TINY_OPS]
    want = {"banded": 4, "contig": 16, "zigzag": 36, "ulysses": 4}
    for r in rows:
        n = want[r["case"]]
        assert r["schedule_blocks"] == n
        assert r["launches_fwd_B1_B3_B2"] == (n, 0, 0)
        assert r["launches_bwd_B1_B3_B2"] == (0, n, n)
        assert max(r["max_abs_err"].values()) < 1e-5


def test_seq_ops_phase_fails_when_a_block_bypasses_flash(
        counted_plain, counted_bwd, monkeypatch):
    def bypass(q, k, v, causal=False, window=0):
        g = q.shape[2] // k.shape[2]
        t = q.shape[1]
        out, lse = att._einsum_block_lse(
            q, att._expand_kv(k, g), att._expand_kv(v, g),
            flash.visible_mask(t, t, causal, window, q.device))
        return out.to(q.dtype), lse

    monkeypatch.setattr(flash, "flash_attention_lse", bypass)
    with pytest.raises(AssertionError, match="launches"):
        _ops()


# the zigzag ring at a bf16-like size: T 2048, where the late positions'
# outputs are ~0.02-0.04, as at the configs' width
BF16_ZIGZAG = [("zigzag_2048", "ring_flash", "zigzag", 1, 2048, 4, 2, 64, 0,
                4)]


def test_seq_ops_phase_bf16_within_its_limits(counted_plain, counted_bwd):
    rows = chip_smoke.phase_seq_ops("cpu", device="cpu", cases=BF16_ZIGZAG,
                                    dtype=torch.bfloat16)
    assert rows[0]["launches_fwd_B1_B3_B2"] == (36, 0, 0)
    assert rows[0]["launches_bwd_B1_B3_B2"] == (0, 36, 36)


def test_seq_ops_phase_fails_on_a_misweighted_block(
        counted_plain, counted_bwd, monkeypatch, capsys):
    """One merge weighting its block 1.3x (every launch still made): the
    outputs move by ~0.02 and the gradients by ~0.03, which the limits
    scaled by the whole tensor's largest value let pass, and phase 14a's
    limits catch."""
    real, calls = att._merge_blocks, [0]

    def misweighted(o, lse, o_b, lse_b):
        calls[0] += 1
        if calls[0] == 5:
            lse_b = lse_b + math.log(1.3)
        return real(o, lse, o_b, lse_b)

    monkeypatch.setattr(att, "_merge_blocks", misweighted)
    with pytest.raises(AssertionError, match="beyond the limit") as err:
        chip_smoke.phase_seq_ops("cpu", device="cpu", cases=BF16_ZIGZAG,
                                 dtype=torch.bfloat16)
    for name in ("out", "dq", "dk", "dv"):
        assert f"'{name}'" in str(err.value)
    row = json.loads(capsys.readouterr().out.split("[seq] ", 1)[1])
    assert row["launches_fwd_B1_B3_B2"] == [36, 0, 0]
    assert row["launches_bwd_B1_B3_B2"] == [0, 36, 36]
    assert max(row["max_abs_err"].values()) < 0.035


def test_plain_forward_in_pieces_equals_whole(monkeypatch):
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, 32, h, 8), generator=gen) for h in (6, 2, 2))
    want = flash.flash_attention_ref(q, k, v, causal=True, window=9)
    # one batch row and one kv head (3 query heads) per piece
    monkeypatch.setattr(chip_smoke, "PLAIN_SCORE_BYTES", 3 * 32 * 32 * 4)
    got = chip_smoke.plain_forward(q, k, v, True, 9)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)


def test_sdpa_yardstick_expands_gqa_past_the_limit(monkeypatch):
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn((1, 32, h, 8), generator=gen) for h in (6, 2, 2))
    want, _ = flash.flash_attention_ref(q, k, v, causal=True, window=9)
    outs = []
    for limit in (1 << 30, 1):
        monkeypatch.setattr(chip_smoke, "PLAIN_SCORE_BYTES", limit)
        (qt, kt, vt), kw = chip_smoke._sdpa_args(q, k, v, True, 9)
        assert kt.shape[1] == (2 if limit > 1 else 6)
        assert kw.get("enable_gqa", False) == (limit > 1)
        outs.append(F.scaled_dot_product_attention(qt, kt, vt, **kw)
                    .transpose(1, 2))
    for out in outs:
        torch.testing.assert_close(out, want, rtol=0, atol=1e-5)


def test_full_width_schedule_counts():
    by_name = {c[0]: c for c in chip_smoke.SEQ_OPS}
    counts = {}
    for name, (_, impl, layout, b, t, h, kvh, d, window, s) in \
            by_name.items():
        counts[name] = chip_smoke.seq_schedule(impl, layout, s, t // s,
                                               window)
    assert counts == {"llama_swa_long": 4, "gpt2_long": 36,
                      "llama_swa_long_ulysses": 4}
    assert att._ring_steps_needed(4096, 4, 2048) == 2


def test_seq_train_phase_on_cpu(counted_plain, counted_bwd, tmp_path):
    launches = chip_smoke.phase_seq_train(
        "cpu", device="cpu", work=tmp_path,
        sets=list(chip_smoke.SEQ_TRAIN_SETS) + TINY_LLAMA,
        corpus_bytes=TINY_CORPUS)
    layers, k = 2, 4          # grad_accum_steps 4 of the config
    n = chip_smoke.PATH_STATS["seq_train"]
    assert n["steps"] >= 8 and n["eval_steps"] >= 1
    # a train step: B1 2 x layers x k (remat), B2, B3 layers x k; an eval
    # step B1 layers
    assert launches == {
        "flash_fwd": n["steps"] * 2 * layers * k + n["eval_steps"] * layers,
        "flash_bwd_dkv": n["steps"] * layers * k,
        "flash_bwd_dq": n["steps"] * layers * k, "expert_ffn": 0}
    assert not (tmp_path / "seq_train").exists()


def test_seq_nccl_phase_says_it_did_not_run(capsys):
    if torch.cuda.device_count() >= 4:
        pytest.skip("four cards: the phase runs (the cuda test below)")
    assert chip_smoke.phase_seq_nccl("cpu", device="cuda") == {}
    line = capsys.readouterr().out.strip().splitlines()[-1]
    got = json.loads(line.split(" ", 1)[1])
    assert got["sp_nccl"] == f"not run: {torch.cuda.device_count()} card(s)"


def test_seq_configs_are_the_repositorys_own():
    for path in (chip_smoke.LLAMA_LONG_CONFIG, chip_smoke.GPT2_LONG_CONFIG):
        assert path.parent == chip_smoke.REPO / "configs"
    assert dict(chip_smoke.SEQ_TRAIN_SETS)["mesh;axes;seq"] == 1


@pytest.mark.cuda
def test_four_nccl_ranks_equal_one_process(tmp_path):
    """Phase 14c's legs at the tiny width on 4 cards: 4 NCCL ranks (seq 4;
    gpt2_long zigzag) against one rank (seq 1), float32, the first 3
    losses within rtol 1e-4."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices (one NCCL rank per card)")
    # head_dim 32: the flash kernels take 32, 64 and 128
    wide = [("arch;args;d_model", 128)]
    tiny = {"llama_swa_long": TINY_LLAMA + wide, "gpt2_long": TINY_GPT2 + wide}
    runs = [(name, config, list(ranks) + tiny[name], list(one) + tiny[name])
            for name, config, ranks, one in chip_smoke.SEQ_NCCL]
    out = chip_smoke.phase_seq_nccl("cuda-test", device="cuda",
                                    work=tmp_path, runs=runs,
                                    corpus_bytes=TINY_CORPUS * 2)
    assert set(out) == {"llama_swa_long", "gpt2_long"}
    for row in out.values():
        assert row["mesh"]["seq"] == 4 and row["backend"] == "nccl"
        assert all(p["ppermute"] > 0 for p in row["p2p_per_step"])
