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


# slice 3 at a tiny size: the GPT-2 training config with the model and the
# data narrowed (--set), the same code path as the full-width run
TINY_TRAIN_SETS = [
    ("arch;args;n_layer", 2), ("arch;args;d_model", 64),
    ("arch;args;n_head", 2), ("arch;args;vocab_size", 128),
    ("arch;args;max_len", 32),
    ("train_loader;args;vocab_size", 128), ("train_loader;args;seq_len", 32),
    ("valid_loader;args;vocab_size", 128), ("valid_loader;args;seq_len", 32),
    ("train_loader;args;n", 64), ("valid_loader;args;n", 16),
    ("optimizer;args;lr", 0.003), ("trainer;epochs", 2),
    ("trainer;save_period", 1),
]


@pytest.fixture()
def counted_bwd(monkeypatch):
    ref = flash.flash_attention_bwd_ref

    def counted(*args, **kw):
        flash.FLASH_BWD_DKV.launches += 1
        flash.FLASH_BWD_DQ.launches += 1
        return ref(*args, **kw)

    monkeypatch.setattr(flash, "flash_attention_bwd_ref", counted)


def test_train_config_loads_with_every_key_but_the_later_slices():
    import json

    port = json.loads(chip_smoke.TRAIN_CONFIG.read_text())
    jax_cfg = json.loads((chip_smoke.REPO / "configs" /
                          "gpt2_small.json").read_text())
    # phase 6's copy: the repository's config with every observability
    # key off (phase 10 runs the repository's own file)
    assert "compile_cache" not in port
    for key in ("health", "telemetry"):
        assert port["trainer"][key] == {"enabled": False}
    assert port["trainer"]["tensorboard"] is False
    jax_cfg.pop("compile_cache")
    for key in ("health", "telemetry"):
        jax_cfg["trainer"][key] = {"enabled": False}
    jax_cfg["trainer"]["tensorboard"] = False
    assert port == jax_cfg


def test_train_reference_phase_on_cpu():
    chip_smoke.phase_train_reference(device="cpu")


def test_train_phase_on_cpu(counted_plain, counted_bwd, tmp_path):
    launches = chip_smoke.phase_train("cpu", device="cpu",
                                      sets=TINY_TRAIN_SETS,
                                      work=tmp_path / "work")
    # 2 epochs x 8 steps on the main run, 8 more on the resumed epoch 2;
    # eval: 2 x 2 + 2 batches
    layers, train_steps, eval_steps = 2, 16 + 8, 4 + 2
    assert launches == {
        "flash_fwd": layers * (2 * train_steps + eval_steps),
        "flash_bwd_dkv": layers * train_steps,
        "flash_bwd_dq": layers * train_steps, "expert_ffn": 0}
    assert not (tmp_path / "work" / "train").exists()


def test_train_phase_fails_when_the_backward_kernels_are_skipped(
        counted_plain, tmp_path):
    with pytest.raises(AssertionError, match="train step launched"):
        chip_smoke.phase_train("cpu", device="cpu", sets=TINY_TRAIN_SETS,
                               work=tmp_path / "work")


# slice 4 at a tiny size: configs/moelm_stdlib.json with the model, the
# sequence and the batch narrowed (--set) over a 10 kB corpus, the same
# code path as the full-width run
TINY_MOE_SETS = [
    ("arch;args;n_layer", 2), ("arch;args;d_model", 64),
    ("arch;args;n_head", 2), ("arch;args;d_ff", 128),
    ("arch;args;max_len", 32), ("arch;args;num_experts", 4),
    ("train_loader;args;seq_len", 32), ("valid_loader;args;seq_len", 32),
    ("train_loader;args;batch_size", 16),
    ("valid_loader;args;batch_size", 16),
    ("optimizer;args;lr", 0.003), ("trainer;epochs", 2),
    ("trainer;save_period", 1), ("trainer;health", {"enabled": False}),
    ("trainer;telemetry", {"enabled": False}),
]


@pytest.fixture()
def counted_ffn(monkeypatch):
    from pytorch_distributed_template_tpu_torch.ops import expert_ffn as ffn

    ref = ffn.expert_ffn_ref

    def counted(*args, **kw):
        ffn.EXPERT_FFN.launches += 1
        return ref(*args, **kw)

    monkeypatch.setattr(ffn, "expert_ffn_ref", counted)


def test_moe_train_reference_phase_on_cpu():
    chip_smoke.phase_moe_train_reference(device="cpu")


def test_moe_train_phase_on_cpu(counted_plain, counted_bwd, counted_ffn,
                                tmp_path):
    launches = chip_smoke.phase_moe_train(
        "cpu", device="cpu", sets=TINY_MOE_SETS, corpus_mb=0.01,
        work=tmp_path / "work")
    # 9,000 train bytes = 281 windows of 32: 18 steps of 16 per epoch, 2
    # epochs on the main run and epoch 2 again on the resumed one; 1,000
    # val bytes: 2 eval steps per epoch; both layers are MoE layers
    layers, train_steps, eval_steps = 2, 18 * 3, 2 * 3
    assert launches == {
        "flash_fwd": layers * (train_steps + eval_steps),
        "flash_bwd_dkv": layers * train_steps,
        "flash_bwd_dq": layers * train_steps,
        "expert_ffn": layers * (train_steps + eval_steps)}
    assert not (tmp_path / "work" / "moe_train").exists()
    assert not (tmp_path / "work" / "moe_data").exists()


def test_moe_train_phase_fails_when_the_expert_kernel_is_skipped(
        counted_plain, counted_bwd, tmp_path):
    with pytest.raises(AssertionError, match="train step launched"):
        chip_smoke.phase_moe_train("cpu", device="cpu", sets=TINY_MOE_SETS,
                                   corpus_mb=0.01, work=tmp_path / "work")


def test_moe_config_is_the_repositorys_own():
    """Slice 4 runs configs/moelm_stdlib.json itself; every cut is a --set
    (MOE_SETS, the corpus size), and the observability that slice 6 turned
    on by default stays off, as in phase 6's config."""
    assert chip_smoke.MOE_CONFIG == chip_smoke.REPO / "configs" / \
        "moelm_stdlib.json"
    assert dict(chip_smoke.MOE_SETS) == {
        "trainer;epochs": 2, "trainer;save_period": 1,
        "trainer;health": {"enabled": False},
        "trainer;telemetry": {"enabled": False}}


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


# slice 5 at a small size: configs/mnist.json with the sample counts and
# the epochs cut (--set) and a larger lr so 3 short epochs learn; gloo
# stands in for NCCL on the CPU, the same code path otherwise
TINY_MNIST_SETS = list(chip_smoke.MNIST_SETS) + [
    ("train_loader;args;synthetic_n", 512),
    ("valid_loader;args;synthetic_n", 200),
    ("test_loader;args;synthetic_n", 200),
    ("train_loader;args;batch_size", 64), ("trainer;epochs", 3),
    ("optimizer;args;lr", 0.003)]


def test_lenet_reference_phase_on_cpu(tmp_path):
    chip_smoke.phase_lenet_reference(device="cpu", work=tmp_path)
    assert not (tmp_path / "lenet_ref").exists()


def test_mnist_phase_on_cpu(tmp_path):
    import os

    from pytorch_distributed_template_tpu_torch.parallel import dist

    out = chip_smoke.phase_mnist("cpu", device="cpu", sets=TINY_MNIST_SETS,
                                 work=tmp_path)
    assert out["backend"] == "gloo" and out["ddp"]
    assert out["steps"] == 3 * 8
    assert out["allreduce_per_step"]["calls"] >= 1
    # LeNet's 21,840 f32 parameters cross in the all-reduce every step
    assert out["allreduce_per_step"]["bytes"] == 4 * 21840 * \
        out["allreduce_per_step"]["calls"]
    assert out["final"]["val_accuracy"] > chip_smoke.MNIST_MIN_VAL_ACC
    assert out["torchrun"]["exit"] == 0
    assert not dist.in_group() and "WORLD_SIZE" not in os.environ
    assert not (tmp_path / "mnist").exists()


def test_mnist_phase_fails_without_ddp(monkeypatch, tmp_path):
    from pytorch_distributed_template_tpu_torch.engine import trainer

    monkeypatch.setattr(trainer.dist, "in_group", lambda: False)
    with pytest.raises(AssertionError, match="not wrapped"):
        chip_smoke.phase_mnist("cpu", device="cpu", sets=TINY_MNIST_SETS,
                               work=tmp_path)


def test_mnist_phase_fails_when_the_allreduce_hook_never_fires(
        monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.nn.parallel.DistributedDataParallel,
                        "register_comm_hook", lambda self, state, hook: None)
    with pytest.raises(AssertionError, match="no gradient all-reduce"):
        chip_smoke.phase_mnist("cpu", device="cpu", sets=TINY_MNIST_SETS,
                               work=tmp_path)


# slice 6 at a tiny size: configs/gpt2_small.json as it is but for the
# model and the data narrowed (--set), with phase 10's observability
# extras; the NaN lands at step 5 of the second run's 8
TINY_OBS_SETS = TINY_TRAIN_SETS + [
    ("trainer;profiler", {"enabled": True, "trace_start_step": 2,
                          "trace_steps": 3}),
    ("trainer;watchdog_secs", 600), ("trainer;log_grad_norm", True)]
TINY_NAN_SETS = TINY_TRAIN_SETS + [("trainer;epochs", 1)]


def test_observe_phase_on_cpu(counted_plain, counted_bwd, tmp_path):
    launches = chip_smoke.phase_observe(
        "cpu", device="cpu", sets=TINY_OBS_SETS, nan_sets=TINY_NAN_SETS,
        nan_step=5, work=tmp_path / "work")
    # main: 2 epochs x 8 steps + the resumed epoch's 8; nan run: 8
    layers, train_steps, eval_steps = 2, 16 + 8 + 8, 4 + 2 + 2
    assert launches == {
        "flash_fwd": layers * (2 * train_steps + eval_steps),
        "flash_bwd_dkv": layers * train_steps,
        "flash_bwd_dq": layers * train_steps, "expert_ffn": 0}
    stats = chip_smoke.PATH_STATS["observe"]
    assert stats["steps"] > 0 and stats["ms_per_step_median"] > 0
    assert stats["span_step_ms_median"] > 0
    assert stats["span_loop_ms_median"] > 0
    assert not (tmp_path / "work" / "observe").exists()
    assert not (tmp_path / "work" / "observe_nan").exists()


def test_observe_phase_fails_without_the_anomaly_dump(
        counted_plain, counted_bwd, monkeypatch, tmp_path):
    from pytorch_distributed_template_tpu_torch.observability import health

    monkeypatch.setattr(health.HealthMonitor, "_write_dump",
                        lambda self, step, anomaly: None)
    with pytest.raises(AssertionError, match="anomaly_5.json"):
        chip_smoke.phase_observe(
            "cpu", device="cpu", sets=TINY_OBS_SETS,
            nan_sets=TINY_NAN_SETS, nan_step=5, work=tmp_path / "work")


def test_observe_config_is_the_repositorys_own():
    assert chip_smoke.OBS_CONFIG == chip_smoke.REPO / "configs" / \
        "gpt2_small.json"
    cut = {chain.split(";")[-1] for chain, _ in chip_smoke.OBS_SETS}
    assert cut == {"n", "epochs", "save_period", "profiler",
                   "watchdog_secs", "log_grad_norm"}


# slice 7 at a tiny size: phase 11's cuts on the tiny GPT-2 (8 steps per
# epoch): slots every 3 batches; attempt 1 killed before step 5 (batch 5,
# between the slots after batches 3 and 6), attempt 2 raising before step
# 12 (epoch 2, batch 4, after its batch-3 slot)
TINY_RES_SETS = TINY_TRAIN_SETS + [
    ("trainer;save_interval_steps", 3), ("trainer;keep_last", 1),
    ("trainer;grad_accum_steps", 2), ("trainer;ema_decay", 0.999)]
TINY_RES_FAULTS = "kill@step:5;crash@step:12@attempt:2"


def test_resilience_phase_on_cpu(counted_plain, counted_bwd, tmp_path):
    launches = chip_smoke.phase_resilience(
        "cpu", device="cpu", sets=TINY_RES_SETS, faults=TINY_RES_FAULTS,
        work=tmp_path / "work")
    # the uninterrupted run: 2 epochs x 8 steps of 2 microbatches, 2 eval
    # steps per epoch (the supervised children are other processes)
    layers, micro_steps, eval_steps = 2, 2 * 16, 2 * 2
    assert launches == {
        "flash_fwd": layers * (2 * micro_steps + eval_steps),
        "flash_bwd_dkv": layers * micro_steps,
        "flash_bwd_dq": layers * micro_steps, "expert_ffn": 0}
    assert not (tmp_path / "work" / "resilience").exists()


def test_resilience_phase_fails_without_step_accurate_resume(
        counted_plain, counted_bwd, tmp_path):
    """Resuming at epoch granularity skips the killed epoch's tail: the
    phase must fail."""
    with pytest.raises(AssertionError, match="not at the newest"):
        chip_smoke.phase_resilience(
            "cpu", device="cpu", faults=TINY_RES_FAULTS,
            sets=TINY_RES_SETS + [("trainer;step_accurate_resume", False)],
            work=tmp_path / "work")


def test_resilience_config_is_the_repositorys_own():
    assert chip_smoke.RES_CONFIG == chip_smoke.REPO / "configs" / \
        "gpt2_small.json"
    cut = dict(chip_smoke.RES_SETS)
    assert cut == {
        "train_loader;args;n": 256, "valid_loader;args;n": 64,
        "trainer;epochs": 2, "trainer;save_period": 1,
        "trainer;save_interval_steps": 12, "trainer;keep_last": 1,
        "trainer;grad_accum_steps": 2, "trainer;ema_decay": 0.999}
