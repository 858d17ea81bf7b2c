"""chip_smoke.py's phase 19 (slice 14, tensor-parallel and DP x TP
serving) driven on the CPU at a tiny width, where the ranks run on gloo
and the kernels' plain versions count no launch.

- 19b: Mistral cut to a tiny width (2 layers, d_model 512, 8 heads of D 64
  over 4 KV heads, d_ff 256, vocab 512, window 64; float32), served by the
  port's ``serve.py`` in this process over cell (e)'s traffic cut to short
  prompts, on one "card", then tp 4, dp 2 x tp 2 and dp 4 x tp 1: every
  request's greedy ids equal the one card's, each rank holds its share of
  the parameters, one decode step's all-reduces lie within [floor, 1.5 x
  floor] (the phase's own checks).
- 19c at the same tiny width on tp 2: the prefill logits within
  ``TP_LOGIT_RTOL`` of the one card's while the control (the last rank's
  row-parallel part left out) lands outside 2 x ``TP_LOGIT_RTOL``, each
  rank's time per call split into its parts, the traced second wave's
  summary on rank 0.
- 19b and 19c with fewer than 4 cards print that they did not run; 19a's
  shapes are Mistral-7B's per-rank heads.
- The cuda-marked test runs 19b's tp-2 path (tp 2 and dp 2 x tp 2) at the
  same tiny width on four cards over NCCL (on a host with four cards:
  ``python -m pytest --noconftest -p no:cacheprovider -q
  tests/test_torch_chip_smoke_tp_serving.py -m cuda``).
"""
import json

import pytest
import torch

import chip_smoke
from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401

# the module imports nothing of JAX: its cuda test runs on the card with
# --noconftest

# head_dim 64: what B4 takes on the card
TINY = {"d_model": 512, "n_head": 8, "n_kv_head": 4, "d_ff": 256,
        "vocab_size": 512, "max_len": 512, "window": 64}
SIZES = {"prefix": 32, "shared_suffix": [4, 12, 20, 28],
         "alone": [8, 16, 24, 40], "new": 8, "slots": 8, "chunk": 4}


def _config(tmp_path):
    """The paged serving config at a tiny pool: 8-token pages, 16-token
    prefill chunks."""
    cfg = json.loads(chip_smoke.SERVE_CONFIG.read_text())
    cfg["serving"] = {"prefix_cache": {"enabled": True, "block_tokens": 8,
                                       "pool_blocks": 256, "paged": True},
                      "prefill_chunk_tokens": 16}
    path = tmp_path / "tiny_serve.json"
    path.write_text(json.dumps(cfg))
    return path


def test_phase_19b_geometries_equal_one_card(tmp_path):
    rows = chip_smoke.phase_tp_serve(
        "cpu", device="cpu", work=tmp_path, arch_args=TINY,
        config=_config(tmp_path), sizes=SIZES)
    assert sorted(rows) == sorted(
        ["one"] + [g for g, _, _ in chip_smoke.TP_SERVE_GEOMETRIES])
    for name, dp, degree in chip_smoke.TP_SERVE_GEOMETRIES:
        row = rows[name]
        assert (row["dp"], row["tp"]) == (dp, degree)
        assert all(row["identical_to_one_card"])
        assert len(row["ids"]) == 8 and row["prefix_hit_tokens"] > 0
        if degree > 1:
            # dp groups of degree ranks, each holding its share
            assert [len(r) for r in row["param_bytes_per_rank"]] == \
                [degree] * dp
            assert row["param_bytes_share"] < row["param_bytes_whole"]
            assert row["tp_stats"]["tp_degree"] == degree
            assert all(n > 0 for rs in row["all_reduce_per_rank_wave"]
                       for n in rs)
        else:
            assert row["engine_devices"] == ["cpu"] * dp
    # the kernels line's launches: none counted by the plain versions
    assert chip_smoke._rank0_launches(list(rows.values())) == {
        "flash_fwd": 0, "paged_attn": 0}


def test_phase_19c_logits_control_and_time_split(tmp_path):
    from pytorch_distributed_template_tpu_torch.tools import (
        make_serving_artifact as tool,
    )

    arch = dict(chip_smoke.TP_SERVE_ARCH, **TINY)
    argv = ["-o", str(tmp_path / "art"), "--arch", chip_smoke.MAIN_ARCH,
            "--seed", "0", "--device", "cpu"]
    for key, val in arch.items():
        argv += ["--" + key.replace("_", "-"),
                 json.dumps(val) if isinstance(val, bool) else str(val)]
    tool.main(argv)
    cfg = chip_smoke._serve_config(_config(tmp_path), arch,
                                   tmp_path / "serve.json")
    rows = chip_smoke.phase_tp_serve_full(
        "cpu", tmp_path / "art" / "model", device="cpu", work=tmp_path,
        config=cfg, sizes=dict(SIZES, logit_prompt=48),
        geometries=[("tp2", 1, 2)])
    row = rows["tp2"]
    logits = row["prefill_logits"]
    assert logits["rel"] <= chip_smoke.TP_LOGIT_RTOL / 100    # f32 here
    assert logits["control_rel"] >= 2 * chip_smoke.TP_LOGIT_RTOL
    assert all(row["identical_to_one_card"])
    split = row["rank_split_ms_per_call"][0]
    assert all(set(s) == {"launch_s", "wait_s", "reply_s"} for s in split)
    assert split[1]["wait_s"] == split[1]["reply_s"] == 0   # rank 0 replies
    assert row["round_trip_ms_per_call"][0] > 0
    prof = row["profile"]
    assert prof["calls"] == chip_smoke.TP_PROFILE_CALLS
    assert prof["top_host"] and prof["nccl_ms"] == 0    # no card here


def test_phase_19_says_it_did_not_run(capsys):
    if torch.cuda.device_count() >= 4:
        pytest.skip("four cards: the phases run (the cuda test below)")
    assert chip_smoke.phase_tp_serve("cpu", device="cuda") == {}
    assert chip_smoke.phase_tp_serve_full("cpu", "unused",
                                          device="cuda") == {}
    lines = [json.loads(line.split(" ", 1)[1]) for line in
             capsys.readouterr().out.splitlines()
             if line.startswith("[tp_serve")]
    assert [r.get("tp_serve", r.get("tp_serve_full")) for r in lines] == [
        f"not run: {torch.cuda.device_count()} card(s)"] * 2


def test_phase_19a_shapes_are_mistral_per_rank_heads():
    """32/8 heads split 4 ways (8/2) and 2 ways (16/4), D 128, the window
    4096; B4's decode rows and prefill chunk on the 145-page ring, bf16
    and int8 pages."""
    heads = {(h, kvh) for _, h, kvh, *_ in chip_smoke.TP_SERVE_KERNEL_SHAPES}
    assert heads == {(8, 2), (16, 4)}
    assert all(s[3] == 1024 and s[4] == 128 and s[6] == 4096
               for s in chip_smoke.TP_SERVE_KERNEL_SHAPES)
    paged = {s[0]: s[1:] for s in chip_smoke.TP_PAGED_SHAPES}
    assert {s[2:4] for s in paged.values()} == {(8, 2)}
    assert paged["prefill_chunk_tp4"][:2] == (1, 512)
    assert [s[-1] for s in paged.values()] == [False, True, False]


@pytest.mark.cuda
def test_four_cards_tp2_paths_equal_one_card(tmp_path):
    """19b's tp-2 path at the tiny width on four cards (NCCL ranks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 cards, found {torch.cuda.device_count()}")
    rows = chip_smoke.phase_tp_serve(
        "cuda-test", device="cuda", work=tmp_path, arch_args=TINY,
        config=_config(tmp_path), sizes=SIZES,
        geometries=[("tp2", 1, 2), ("dp2_tp2", 2, 2)])
    for name in ("tp2", "dp2_tp2"):
        assert all(rows[name]["identical_to_one_card"])
        assert all(r["paged_attn"] > 0 for rs in
                   rows[name]["launches_per_rank"] for r in rs)
        assert rows[name]["rank_devices"][-1][-1] == (
            "cuda:1" if name == "tp2" else "cuda:3")
