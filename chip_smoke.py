#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (1, 2, 2b, 2c, 2d, 3, 3b, 3c, 3d, 3e, 4, 5, 6, 7, 8, 9,
10, 11, 12, 13, 14a, 14b, 14c, 15a-15f, 16a-16g, 17a-17d, 18a-18c,
19a-19c, 20a-20c, 21a-21e, 22a, 22), each
one's time
printed beside the card line; any failure exits non-zero and no phase's
exception is caught:

1. build: compile every CUDA source of the port with nvcc (one process per
   source, all started together) and print the build time and the ptxas
   register report; B4's Hopper arms and B2's and B3's must use 0 bytes of
   stack and spills;
2. kernel against plain: the flash-attention forward kernel against its
   plain PyTorch version on the card, at the main path's prefill shapes,
   a ragged f32 and a non-causal case, and the training paths' shapes
   (GPT-2 small and the MoE LM), with kernel / plain / library
   (``scaled_dot_product_attention``, timed only) times and the card's
   bound;
3. reference: a small float32 Llama served on the card (kernel path) and
   on the CPU (plain path) gives the same prefill logits and the same
   greedy tokens;
4. main path of slice 1: a random-init Mistral-7B artifact at full
   width (12 of its 32 layers: ``MAIN_ARGS``), made by the port's tool,
   served through ``GenerationService``,
   the ``generate`` CLI and ``engine.generate.generate``: (a) a 1024-token
   prompt, 32 greedy tokens, twice, identical; (b) a 6144-token prompt,
   past the 4096-token window (rolling cache, banded kernel); (c) a
   sampled request with a stop id; (d) a batch of 4 x 2048-token prompts.
   The flash launch count is set to 0 before each request and must read
   exactly ``n_layer`` per prefill after it. Then request (a) runs under
   ``torch.profiler`` (prefill alone, then the whole request) for the
   device's busy time and top kernels.

Slice 2 (continuous paged serving, kernel B4) adds:

2b. the paged-attention kernel against its plain version at the main
    path's shapes (decode over the 145-page ring, bf16 and int8 pools,
    flat decode with shuffled tables, a 512-lane prefill chunk deep in
    the ring and a long prompt's first chunk at position 0, a 64-lane
    admission feed with pad lanes, an f32 case at D 64), with the arm
    each takes, kernel / plain / library (SDPA on K/V gathered in
    advance) times, the card's bound and the wrapper's host time per
    call;
3b. the small f32 Llama served by the continuous engine over the paged
    pool on the card and on the CPU: same greedy tokens for 6 concurrent
    requests, with the f32 and the int8 pool;
5.  main path of slice 2: the same artifact served by the port's
    ``serve.py`` (in this process, a free port) with
    ``configs/mistral_7b_serve_paged.json``, driven over HTTP with
    streamed responses: (e) 8 concurrent greedy requests of 256-2048
    tokens, half sharing a 1024-token prefix, 64 new tokens each; one of
    them alone, twice, identical; (f) a 6144-token prompt streamed in
    512-token chunks while 4 short requests decode; (g) the mix of (e)
    again over an int8 pool. Before each wave both launch counts are set
    to 0; after it the paged kernel's count must equal ``n_layer`` x the
    engine's model calls and the flash kernel's must be 0, B4's wgmma arm
    must have taken ``n_layer`` x (prefill chunks + admission calls) of
    them and its decode arm ``n_layer`` x the decode calls, every id in
    range, warm admits copying nothing, and prefix hits > 0 after (e).
    The paged batch-1 prefill's last logits are held against slice 1's
    flash prefill on a 1024-token prompt, and one request of (e) runs
    alone under ``torch.profiler`` (outside the counted waves).

Slice 3 (LM training, kernels B2 and B3) adds:

2c. the flash backward kernels (B3 dQ and delta, then B2 dK/dV) against
    the plain backward at the training main paths' shapes (GPT-2 small: 8
    x 12 heads x 1024, D 64; the MoE LM: 32 x 8 x 512, D 64), a
    Mistral-width GQA shape, a banded, a ragged f32 and a non-causal
    banded case, and an lse-cotangent case, with the arm each takes,
    kernel / plain / library (the backward of
    ``scaled_dot_product_attention``, timed only) times and the card's
    bound per kernel, and a ``flash_bwd_pair`` row per shape: the whole
    ``flash_attention_bwd`` (B3 with delta, then B2) against the SDPA
    backward, with the whole backward's own bound (10 FLOPs per visible
    pair and head dim, each array moved once);
3c. a small f32 GPT2 (flash, fused head, remat) and a small windowed GQA
    Llama (flash) train 5 steps on the card (kernels) and on the CPU
    (plain versions) from the same weights and batches: the same per-step
    losses and final params;
6.  main path of slice 3: the port's ``train.py`` with
    ``configs/gpt2_small_train.json`` (the repository's
    ``configs/gpt2_small.json`` with every observability key off) at full
    width (GPT-2 small: 12
    layers, d_model 768, vocab 50257, seq 1024, batch 8, bf16, remat,
    flash, fused head chunk 256, dropout 0.1), cut to 256 training and 64
    validation sequences and 2 epochs (``--set``): every train step must
    launch B1 2 x 12 times and B2, B3 12 times each, every eval step B1 12
    times and no B2/B3; losses finite and falling; checkpoints and
    ``summary.json`` written; a run resumed from ``checkpoint-epoch1``
    reproduces epoch 2. Then 5 train steps run under ``torch.profiler``
    (with B2's and B3's device ms per step).

Slice 4 (MoE LM training, kernel B5) adds:

2d. the fused expert FFN kernel B5 against its plain version at the MoE
    main path's shape (E 8, C 5120, D 512, F 1024, with biases), the TPU
    probe's shape (E 8, C 2560, D 768, F 1536, no biases), a ragged
    capacity and a small f32 case, with kernel / plain / library (the
    three cuBLAS calls bmm -> gelu -> bmm, timed only) times and the
    card's bound;
3d. a small f32 TinyMoeLM (flash, D 64, fused head, top-2, a capacity that
    drops tokens, one padded example per batch) trains 5 steps on the card
    and on the CPU from the same weights and batches: the same per-step
    losses (the aux loss included) and final params;
7.  main path of slice 4: a corpus built by the port's
    ``tools/make_text_corpus.py``, then the port's ``train.py`` with
    ``configs/moelm_stdlib.json`` at full width (8 layers, d_model 512,
    d_ff 1024, 8 heads, 8 experts top-2, seq 512, batch 32, bf16, flash,
    fused head), cut to a 1 MB corpus and 2 epochs, with the health
    summary and the flight recorder off (on by default since slice 6; off,
    the step is the one slice 4 ran): every train step must
    launch B5, B1, B2 and B3 8 times each, every eval step B5 and B1 8
    times and no B2/B3; losses finite and falling; ``val_lm_bits_per_
    byte`` logged; checkpoints and ``summary.json`` written; a resume from
    ``checkpoint-epoch1`` reproduces epoch 2. Then 5 steps under the
    profiler (with B2's and B3's device ms per step).

Slice 5 (the source paper's main path: LeNet/MNIST with DDP; no TPU
kernel, the convs, pools and dense layers run on cuDNN/cuBLAS) adds:

8.  ``configs/mnist_debug.json`` trains one epoch in f32 through the
    port's ``train.py`` on the card and on the CPU from the same weights,
    dropout off: the same per-step losses and final params, with TF32 off
    on the card for this comparison only (each run's setting printed);
9.  main path of slice 5: the port's ``train.py`` with
    ``configs/mnist.json`` (LeNet at full width, batch 128, 5 of its 10
    epochs, TensorBoard on, synthetic MNIST without idx files) in this
    process with the launcher's environment set for
    one rank: the process group must be NCCL, the model must train
    wrapped in ``DistributedDataParallel``, and a communication hook on
    the wrapper must count a gradient all-reduce in every train step;
    losses finite and falling; the final validation accuracy above 0.5
    (chance 0.1); checkpoints, ``model_best`` and ``summary.json``
    written; a resume from ``checkpoint-epoch1`` reproduces epoch 2
    exactly; the port's ``test.py`` on ``model_best`` gives the best
    epoch's validation loss and metrics (rtol 1e-6) and ``--save-outputs``
    writes one row per validation sample; then ``torchrun --standalone
    --nproc_per_node=1 -m pytorch_distributed_template_tpu_torch.train -c
    configs/mnist_debug.json`` (one epoch) exits 0 and writes its
    checkpoint. Prints ms/step, examples/s, a 5-step profile (device busy
    and idle share, top ops), peak memory and the all-reduce calls and
    bytes per step, each beside the card line.

Slice 6 (training observability; no TPU kernel, the health summary's
reductions are plain PyTorch) adds:

10. main path of slice 6: the port's ``train.py`` with the repository's
    ``configs/gpt2_small.json`` as it is (``compile_cache``, TensorBoard,
    health with ``pause_best_promotion``, telemetry, ``skip_nonfinite``),
    cut only by ``--set``: train ``n`` 256, valid ``n`` 64, 2 epochs,
    ``save_period`` 1, a profiler window of 3 steps, ``watchdog_secs``
    600, ``log_grad_norm``. Phase 6's checks (exact launches per step,
    losses, checkpoints, summary, resume, profile) and: one flight record
    per step, ``trace.json``, a ``torch.profiler`` trace in ``profile/``,
    TB events (or the backend's absence printed), ``grad_norm`` and
    ``mfu`` in the epoch logs; phase 6's and phase 10's train step timed
    in turns on one model;
    the median ms/step, iteration ms, span breakdown and synchronising
    calls per non-log step (``torch.cuda.set_sync_debug_mode``) beside
    phase 6's, failing if phase 10 makes more. Then one epoch with
    ``trainer.faults "nan_grad@step:24"``: ``anomaly_24.json`` written,
    the step skipped, the params finite, the per-group counts summing to
    the number of gradient elements, no ``model_best``.

Slice 7 (step-accurate resume and the supervisor, ROADMAP A17; no new
kernel) adds:

11. main path of slice 7: ``configs/gpt2_small.json`` at full width cut
    by ``--set`` to phase 10's sizes (train ``n`` 256, valid ``n`` 64, 2
    epochs, ``save_period`` 1) with ``save_interval_steps`` 16,
    ``keep_last`` 1, ``grad_accum_steps`` 2 (microbatches of 4) and
    ``ema_decay`` 0.999. Once without a fault through the port's
    ``train.py`` in this process (every train step must launch B1 2 x 2 x
    12 times and B2, B3 2 x 12 times each), then once through the port's
    ``supervise.py`` (a child process per attempt) with
    ``PDT_FAULTS="kill@step:31;crash@step:46@attempt:2"``: attempt 1 is
    killed 15 steps (2.0 s) after the slot of batch 16, with no slot
    between, so that slot's write (0.6-1.2 s on the card) is done, and
    attempt 2 must start at its batch; attempt 2 raises in epoch 2 before
    its batch-16 slot and writes ``checkpoint-emergency``; attempt 3
    resumes from it and finishes.
    Hard checks: 2 restarts, both ``crash``, a clean end; each attempt
    resuming at the newest checkpoint the attempt before it completed (no
    step replayed after the crash); ``global_step`` 64 in the last
    sidecar; the final
    ``checkpoint-epoch2``'s model, optimizer and EMA tensors bitwise equal
    to the uninterrupted run's; every logged loss equal at its step;
    ``keep_last`` 1 leaving no ``checkpoint-epoch1`` beside
    ``model_best``. Prints each interval save's stop of the loop and its
    write (time, bytes), each attempt's restart to its first step and the
    steps replayed, beside the card line.

Slice 8 (the other optimizers, ``mu_dtype``, ``trainable``,
``ReduceLROnPlateau``, the Digits / BPE loaders, ``lm_nll`` and the native
batcher, ROADMAP A17's tail and A18; no new kernel) adds:

3e. the small f32 GPT2 of phase 3c (d_model 128: Adafactor factors its
    kernels) takes 5 steps under each of the ten optimizers, Adam with a
    bf16 ``mu``, AdamW with ``trainable`` and AdamW under a forced plateau
    scale, on the card and on the CPU from the same weights and batches,
    TF32 off for this comparison only: losses rtol 1e-5, params atol 1e-4
    (Lion at lr 1e-5, where a flipped sign moves a weight 2e-5), frozen
    params unchanged; then cell (h)'s model (GPT-2 small, bf16, remat,
    flash, fused head, batch 8 x 1024) takes 3 steps under AdamW,
    Adafactor, Lion and Adam with a bf16 ``mu``: the optimizer-state bytes
    must equal the count the parameter shapes give; step ms and peak
    memory printed;
12. main path of slice 8's LMs: a 2 MB corpus from the port's
    ``tools/make_text_corpus.py``; ``configs/bytelm_stdlib.json`` as it
    is for 1 epoch (``--set`` the data_dir and the epochs), then
    ``configs/bpelm_stdlib.json`` at full width (GPT2, 8 layers, d_model
    512, 8 heads, vocab 1024, seq 512, batch 32, bf16, flash, fused head
    chunk 256, AdamW, WarmupCosine, clip 1.0) for 2 epochs with
    ``save_period`` 1: every train step must launch B1, B2 and B3 8 times
    each, every eval step B1 8 times and no B2/B3; losses finite and
    falling; the BPE tokenizer fitted once (the validation loader and the
    resume reuse its caches, mtimes unchanged) and pinned in the run
    directory; ``val_lm_nll`` equal to ``val_loss`` (rtol 1e-5); a resume
    from ``checkpoint-epoch1`` reproducing epoch 2;
13. ``configs/digits.json`` as it is (LeNet, Adam with amsgrad, StepLR, 40
    epochs, early stop 15) on the real UCI digits (1,438 train, 359
    validation images): the last epoch's held-out ``val_accuracy`` at
    least 0.95; the port's ``test.py`` on ``model_best`` gives the
    validation loss and metrics of the epoch it holds (rtol 1e-6). The
    native batcher must have gathered in phases 12 and 13 (its call
    count, reset before each).

Slice 9 (sequence parallelism, ROADMAP A11a: the ``seq`` mesh axis, ring
and Ulysses attention on B1-B3, the zigzag layout; no new kernel) adds:

14a. the one-process ring and Ulysses paths (S = 4 shards in this process,
    the K/V exchange a list rotation; the same per-step work as the
    process-group path) forward and backward against ``flash_attention``
    over the whole sequence, at the configs' full width in bf16:
    ``llama_swa_long``'s attention (B 1, T 16384, 12/4 heads, D 64,
    window 2048, contiguous: one banded diagonal flash block per shard
    and one masked einsum block at the band's edge), ``gpt2_long``'s (B 1,
    T 8192, 12 heads, causal, zigzag, then the inverse permutation: 3 + 2
    (S - 1) = 9 quarter blocks per shard) and ``ulysses_flash`` at llama's
    shape; the max errors of out, dq, dk, dv, and B1's forward and B2's
    and B3's backward launches equal to the schedule's count; then the
    new block shapes through phases 2 and 2c's rows (kernel / bound /
    plain / SDPA);
14b. main path of slice 9 on one card: the port's ``train.py`` with
    ``configs/llama_swa_long.json`` (Llama, 12 layers, d_model 768, 12/4
    heads, window 2048, seq 16384, batch 4, ``grad_accum_steps`` 4, bf16,
    remat, ``ring_flash``, fused head) cut by ``--set`` only: the seq axis
    1 (the ring computes the whole attention on B1-B3), one epoch of 8
    steps over a 600 kB corpus, a 2-step warm-up; exact launches per
    step (B1 96, B2 48, B3 48; eval B1 12), finite and falling losses, ms
    per step and peak memory;
14c. with 4 cards: ``torchrun --nproc_per_node=4`` (this script's
    ``--sp-child`` mode per rank) of ``llama_swa_long.json`` as it is
    (seq 4) and ``gpt2_long.json`` with data 1 (seq 4, zigzag), float32
    and dropout off by ``--set``, against one rank with seq 1 in this
    process: the first 3 losses within rtol 1e-4, the ring's P2P calls
    and bytes and ms per step. With fewer cards it prints ``"sp_nccl":
    "not run: N card(s)"``.

Slice 10 (image training, ROADMAP A12's image half: ResNet and ViT with
BatchNorm state, augment and mixup in the step, the CIFAR and ImageNet
loaders; no new kernel: convs, BN and pools are cuDNN and plain PyTorch,
ViT's flash attention B1-B3) adds:

15a. a small f32 ResNet (CIFAR stem, one block per stage, BatchNorm) and a
    small ViT (d 64, 2 layers, 32 px, patch 8, flash) train 5 steps on the
    card and on the CPU from the same weights and batches with augment
    (flip, crop 4, cutout 8) and mixup 0.2 on, TF32 off: the same per-step
    losses, final params and BN running averages (phase 3c's limits);
15b. B1, and B3 then B2, against their plain versions at ViT-B/16's
    attention (12 heads x 197 tokens, D 64, bf16, non-causal: the train
    microbatch 256 and the eval batch 1024), with phases 2 and 2c's
    limits and rows (phases 2 and 2c also hold a batch of 8 at that shape);
15c. ``configs/cifar10_resnet18.json`` as it is (synthetic CIFAR-10), 2
    epochs with a checkpoint each: losses finite and falling, the last
    ``val_accuracy`` above chance, a resume from ``checkpoint-epoch1``
    reproducing epoch 2 and every tensor of the final state (BN buffers
    included) exactly, ``test.py`` on ``model_best`` equal to the best
    epoch's validation (rtol 1e-6), and a 5-step profile;
15d. ``configs/imagenet_resnet50.json`` (batch 256, bf16, the synthetic
    fallback cut to 1280 and 256 images), 1 epoch; then the same from
    uint8 shards of those counts written
    by the port's ``tools/make_image_shards.py --synthetic`` (the native
    gather, the ``on_device`` normalize): images/s, MFU with its count,
    peak memory and a 5-step profile for each;
15e. ``configs/imagenet_vit_b16.json`` (global batch 1024 in 4
    microbatches of 256: one card does not hold the batch's activations),
    3 epochs, once as it is (``xla``) and once with ``attn_impl
    "flash"``: exact launches (flash: per train step B1, B2, B3 48 each,
    per eval step B1 12; xla none), images/s and peak memory;
15f. with 4 cards: the CIFAR config in f32 with ``mixup_alpha`` 0.2, 3
    steps on 4 NCCL ranks (64 rows each: global BN statistics, the global
    mixup roll, the augment draws sliced per rank) against one rank (256)
    within rtol 1e-4 (phase 14c's machinery, ``"image_nccl"``); with fewer
    cards it prints ``"image_nccl": "not run: N card(s)"``.

Slice 11 (BERT MLM pretraining and classifier transfer, LoRA and its
merge, checkpoint soups, ROADMAP A12b; no new kernel: BERT's attention is
B1-B3 without the causal mask) adds:

16a. small f32 ``BertMLM`` and ``BertClassifier`` (flash) and LoRA'd
    GPT2 and Llama (flash, the adapters trained alone) take 5 AdamW steps
    on the card and on the CPU from the same weights and batches, TF32
    off: losses, first-step gradients and final params within phase 3c's
    limits, the frozen base bitwise fixed; the 80/10/10 corruption on the
    card equals the CPU's on the same draws bit for bit; the merge on the
    card equals the CPU's;
16b. B1, and B3 then B2, at ``bert_mlm_stdlib.json``'s attention (128 x 6
    heads x 128 tokens, D 64, bf16, non-causal) with phases 2 and 2c's
    limits and rows;
16c. ``configs/bert_mlm_stdlib.json`` as it is on phase 12's 2 MB corpus
    and its cached 1024-id BPE, 2 epochs with a checkpoint each, once
    with ``xla`` attention and once with ``attn_impl "flash"`` (exact
    launches: per train step B1, B2, B3 6 each, per eval step B1 6),
    losses finite and falling, a resume from ``checkpoint-epoch1``
    reproducing epoch 2; ``test.py --seed 3`` twice equal, ``test.py``
    equal to the best epoch's validation (rtol 1e-6), ``--save-outputs``
    writing the logits and the bool mask;
16d. the soup of 16c's two checkpoints through the port's
    ``checkpoint.average`` and ``test.py`` (its ``val_loss`` beside both
    inputs'); a soup of one checkpoint evaluates bitwise as that
    checkpoint;
16e. ``configs/bert_cls_stdlib.json`` (``PyModuleClsLoader`` over this
    machine's standard library, 8 classes; 3 of its 6 epochs; the
    loader's windows and its cold and warm seconds first), warm (``init_from``
    16c's ``model_best``: exactly the ``encoder.*`` tensors restored,
    ``classifier_head.*`` skipped) and fresh, through
    ``tools/bert_transfer_experiment.py``'s functions: the warm run's best
    ``val_accuracy`` above chance (0.125); warm against fresh is reported;
16f. LoRA rank 8 on cell (h)'s GPT-2 small from phase 6's epoch-1 weights,
    one epoch of 32 steps (cell (h)'s exact launches): the base bitwise
    fixed, the optimizer state = the adapters' elements x 8 B, the
    artifact of ``tools/merge_lora.py`` a dense GPT-2 whose logits equal
    the adapted model's within phase 2c's bf16 limits; ms per step beside
    cell (h)'s;
16g. LoRA rank 4 at ``llama_debug.json``'s width in f32 (one head of D
    64), merged, then the port's ``generate.py`` on the artifact: greedy
    tokens identical to the adapted model's; then
    ``configs/mistral_7b_lora.json`` (Mistral-7B's widths and depth over
    a random-init float32 base, bf16 compute, remat, flash, seq 1024,
    batch 1, rank 8, the adapters alone): peak memory under 80 GiB, every
    loss finite, every base tensor's checksums unchanged, ms per step and
    MFU.

Slice 12 (pipeline parallelism, ROADMAP A11c: the ``pipe`` axis, GPipe
and circular schedules, the pipelined GPT-2 / Llama; and the HF weight
import, A12b's rest; no TPU kernel on this path: the pipelined trunk's
attention is the plain einsum attention, as in the JAX trunk) adds:

17a. a small f32 ``TinyPipeLM`` in the circular layout (``[S 2, V 2, Lc
    1]``, remat, fused head) trains 5 steps on the card and on the CPU from
    the same weights and batches, TF32 off: phase 3c's limits;
17b. ``configs/gpt2_pp.json`` on one card, the mesh cut to ``{"data":
    -1}`` by ``--set`` (the sequential trunk over the ``[S 4, V 3, Lc 1]``
    stacks; no kernel launched, every count held at 0), train ``n`` 256,
    valid ``n`` 64, 2 epochs, ``save_period`` 1: losses finite and
    falling, checkpoints and ``summary.json``, a resume from
    ``checkpoint-epoch1`` reproducing epoch 2, ms/step, peak memory and a
    5-step profile;
17c. with 4 cards: ``torchrun --nproc_per_node=4`` (``--sp-child``) of
    ``gpt2_pp.json`` with its pipe axis of 4, 2 epochs of 3 steps in f32
    without TF32, against one rank in this process without a pipe axis
    (losses within ``SEQ_NCCL_RTOL``, every rank the same; each rank's
    parameter bytes a quarter of the trunk's plus the replicated ones;
    the permutes per step 2 x (27 + 26), the output sums 4), the ranks'
    ``checkpoint-epoch1`` resumed in this process reproducing their epoch
    2; then one bf16 epoch of the config as it is: ms/step and the P2P
    calls and bytes per step. With fewer cards it prints ``"pp_nccl":
    "not run: N card(s)"``;
17d. phase 6's GPT-2 small exported to an HF ``GPT2LMHeadModel`` state
    dict and imported again (``models/hf_import.py``): every tensor and
    the logits of 2 x 1024 tokens bit-equal;
18a. B1 and B2/B3 against their plain versions at Mistral-7B's per-rank
    shapes on a tensor axis (``TP_KERNEL_SHAPES``, ``TP_BWD_SHAPES``);
18b. with 4 cards: one ``torchrun --nproc_per_node=4`` (``--tp-child``)
    trains ``configs/mistral_7b_fsdp.json`` cut to 2 layers in f32 on
    ``{"fsdp": 4}``, ``{"tensor": 4}``, ``{"fsdp": 2, "tensor": 2}`` and
    ``{"data": 2, "fsdp": 2}`` against one rank (``phase_tp_nccl``);
18c. with 4 cards: the config as it is, Mistral-7B at full width and
    depth in bf16, 5 steps on ``{"fsdp": 4}`` and 5 on ``{"tensor": 4}``:
    ms/step, MFU, peak memory and collective bytes per rank
    (``phase_tp_full``). With fewer cards 18b and 18c print ``"tp_fsdp":
    "not run: N card(s)"``.

Slice 14 (tensor-parallel and DP x TP serving, ROADMAP A11b's serving
half: ``serve.py --tp/--dp`` start one rank process per card; B1 and B4
run on each rank's local heads, no new kernel) adds:

19a. B1 and B4 against their plain versions at Mistral-7B's per-rank
    serving shapes (``TP_SERVE_KERNEL_SHAPES``: the 1024-token prefill at
    8/2 and 16/4 heads; ``TP_PAGED_SHAPES``: 8 decode rows over the ring
    on bf16 and int8 pages and a 512-token chunk at 8/2 heads);
19b. with 4 cards: a 2-layer Mistral at its published widths in f32,
    made by the port's tool, served by the port's ``serve.py`` (in this
    process; it starts its own ranks) over cell (e)'s traffic on one
    card, then on tp 4, dp 2 x tp 2 and dp 4 x tp 1: every request's
    greedy ids identical to one card's, B4 launched on every rank and B1
    on none, each rank's parameter bytes its share, the tp-1 groups'
    engines on distinct cards, one decode step's all-reduces within
    [floor, 1.5 x floor] (``phase_tp_serve``);
19c. with 4 cards: phase 4's Mistral-7B artifact in bf16 over
    ``configs/mistral_7b_serve_paged.json`` and cell (e)'s traffic on one
    card, tp 4 and dp 2 x tp 2: TTFT and ms/token per request beside the
    one card's, each rank's peak memory and bytes, one decode step's
    collectives at batch 1 and 8 (``phase_tp_serve_full``). With fewer
    cards 19b and 19c print ``"tp_serve": "not run: N card(s)"`` and
    ``"tp_serve_full": ...``.

Slice 15 (the sparse Llama family, ``MixtralMoE`` with swiglu experts,
and the ``expert`` mesh axis, ROADMAP A6c.1 and A11d; the experts' three
products are ``torch.bmm``, as JAX's are einsums outside any Pallas
kernel; B1-B4 run at Mistral's attention shapes, no new kernel) adds:

20a. ``MixtralMoE`` at its published widths cut to 2 layers in f32 (TF32
    off), random weights on the card and the same on the CPU: greedy ids
    of the batch-1 service and of the continuous engine over a paged pool
    identical on both devices; then ``mixtral_8x7b_serve_paged.json`` (16
    of 32 layers, bf16, ~47 GB of random weights drawn on the card) in the
    continuous engine over the config's pool with cell (e)'s traffic:
    ServeWave's exact B4 / B1 counts, TTFT, decode ms/token and peak
    memory (``phase_moe_serve``);
20b. with 4 cards: ``mixtral_8x7b_ep.json`` cut to 2 layers in f32 at a
    capacity factor of 1.0 on ``{"expert": 4}``, ``{"data": 2, "expert":
    2}`` and ``{"data": 4}`` (each in a ``torchrun`` of its own) against
    one rank, the expert-4 checkpoint of one epoch resumed in one process
    (``phase_ep_nccl``);
20c. with 4 cards: the config as it is (8 layers, bf16), 5 steps on
    ``{"expert": 4}``: ms/step, MFU (active experts at top_k / E), peak
    memory, collectives per rank (``phase_ep_full``). With fewer cards 20b
    and 20c print ``"moe_ep": "not run: N card(s)"``.
    ``chip_smoke.py --moe-ep`` runs the build and 20a-20c alone.

Slice 16 (serving the repository's own LMs, ROADMAP A6a.5, A6c.3's
caches, A3a.1's batch-1 scatter arm, A3a.2 and A4: the GPT-2 family's
decode caches with int8 KV, w8a16 weights, prompt-lookup speculative
decoding and the static micro-batcher; B1, B4 and B5 on new paths, no
new kernel) adds, after 20c and before the work directory goes:

21a. B1 at the GPT-2 family's prefill shapes (``GPT2_SERVE_KERNEL_SHAPES``:
    B 1 and 8, 12 heads of 64, T 37 and 512) and B5 at MoeLM's decode
    capacities (``FFN_DECODE_SHAPES``: E 8, C 1, 3, 8, D 512, F 1024, bf16
    and f32) against their plain versions; then small f32 ``GPT2`` and
    ``TinyMoeLM`` on the card and the CPU, TF32 off: cached-decode and
    int8-KV logits card = CPU, the w8a16 model = the dense one on the
    dequantized weights, speculative greedy ids = plain greedy ids, the
    static batcher's ids = each request's solo ids;
21b. phase 6's GPT-2 small checkpoint (kept with its config) through the
    port's ``generate.py`` in f32: cold, ``--speculative 4`` and
    ``--set "arch;args;kv_quant" int8``; speculative ids = plain ids and
    card ids = CPU ids for 32 tokens, B1 12 per cold prefill; in bf16 the
    service's TTFT, ms/token, acceptance rate and tokens per verify call;
    then the port's ``serve.py`` with ``--scheduler auto`` (it must pick
    ``BatchedGenerationService``) and ``--prefix-cache on`` in f32: 8
    concurrent 128-token greedy requests of one length and 2 of other
    lengths, each one's ids = its solo ids, a prompt sent alone twice
    hitting the scatter arm with warm = cold, the scheduler's ``stats``;
21c. phase 12's ``bytelm_stdlib`` model through
    ``tools/quantize_checkpoint.py`` and ``generate.py --prompt "def
    main(" --speculative 4``: weight bytes dense and w8a16, acceptance;
21d. phase 7's ``moelm_stdlib`` model through ``generate.py`` in f32: B5
    8 x model calls (C 1 at decode), B1 8 per cold prefill, card ids =
    CPU ids for 16 tokens;
21e. phase 4's Mistral-7B artifact (``MAIN_ARGS``) quantized to w8a16:
    its bf16 prefill logits within ``W8A16_LOGIT_RTOL`` of the dense
    model on the dequantized weights, then cell (e)'s traffic on the
    continuous engine over the paged pool (ServeWave's exact B4 / B1
    counts): weight bytes, peak memory, TTFT and ms/token beside phase
    5's. Phase 21's total time is printed.

Slice 17 (page shipping between a prefill-role and a decode-role server,
the KV spill tiers, the SIGTERM drain; B4 over pages that came in by a
host-to-device copy, no new kernel) adds:

22a. phase 3b's small f32 Llama (its window off) on the card and the CPU,
    f32 and int8 pools: pages exported on the card import into a CPU pool
    and the other way, each decoding the colocated greedy ids; the card's
    ``serialize_pages`` of a set of leaves byte-equal to the CPU's (f32,
    bf16, int8); B4 over the imported pages against its plain version;
22. phase 4's Mistral-7B artifact (loaded once for the bf16 pools, once
    for the int8 ones) served by the port's ``serve.py`` as a ``--role
    prefill``, a ``--role decode`` and a colocated server, each with its
    own pool. 22b: cell (e)'s 8 prompts
    ``POST /prefill`` -> ``/admit_pages``, then one ordered wave on the
    decode server whose ids must equal the colocated warm repeat's (the
    colocated pool computed with ``/prefill``); agreement with a cold (e)
    wave reported; the prefill server's shipped bytes against the decode
    server's imported plus already pooled ones, exactly; the TTFT of a
    shipped 1024-token prompt against a colocated cold one; then the same
    over int8 pools (cell (g); the first int8 server loads through
    ``--set serving;kv_quant int8``, the other two serve its weights).
    22c: a decode server of ``small_pool`` pages over a host tier and a
    disk tier: the first prompts' pages, evicted to the tiers by the
    others' imports, promote when those prompts come again, with their
    first ids, some read back from disk and none failing its checksum; a
    ``corrupt_spill`` fault
    makes the tier's newest entry read as a miss, and the request gives
    the ids of a server holding only the blocks that verified. Every wave
    counts B4 = n_layer x model calls and B1 = 0, every prefill B4 on the
    wgmma arm; demote and promote ms per block printed.

The last three lines of standard output are the card's name and power
limit as nvidia-smi gives them, the ``kernels`` JSON line (flash_fwd with
the launches of slices 1, 3, 4, 6, 7, 8, 9, 10, 11 and 13 (rank 0's of
18b/18c and 20b/20c), 14 and 16 (21b-21d), paged_attn with slice 2's,
14's (the card-0 process's of 19b/19c: this process for the tp-1 runs,
rank 0 of group 0 for the others), 15's (20a), 16's (21e) and 17's
(22),
flash_bwd_dkv and flash_bwd_dq with slices 3, 4, 6, 7, 8, 9, 10, 11, 13
and 15, expert_ffn with slice 4's and 16's (21d); phase 14a's block
shapes, phase 15b's ViT shapes, phase 16b's BERT shape, phase 18a's
tensor-parallel shapes, phase 19a's per-rank serving shapes and phase
21a's GPT-2 serving and B5 decode shapes among the rows) and the device
line ``{"ok": true, "device": {...}}``.
Every kernel row also carries ``pct_of_bound`` (100 x bound / kernel time) and
``x_library`` (kernel time / library time); kernel times are device times
(:func:`cuda_ms`). The script needs a CUDA device and the repository
beside it; it imports nothing of JAX.
"""
from __future__ import annotations

import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense tensor-core bf16
              torch.float32: 67e12}     # f32 outside the tensor cores
KERNEL_SOURCE = "pytorch_distributed_template_tpu_torch/csrc/flash_fwd.cu"
KERNEL_REPLACES = "pytorch_distributed_template_tpu/ops/flash.py:109"
# (B, H, KVH, T, D, causal, window, dtype): the main path's prefill shapes
# (Mistral-7B: 32/8 heads, D 128, window 4096: requests a, b and d), a
# ragged f32 case, a non-causal banded case, the training paths'
# shapes (GPT-2 small: 8 x 12 heads x 1024; the MoE LM: 32 x 8 x 512) and
# ViT-B/16's attention at a small batch (bf16, non-causal, T 197: ragged
# with B > 1 through the 4-D TMA maps; phase 15b runs its full batches)
KERNEL_SHAPES = [
    (1, 32, 8, 1024, 128, True, 4096, torch.bfloat16),
    (1, 32, 8, 6144, 128, True, 4096, torch.bfloat16),
    (4, 32, 8, 2048, 128, True, 4096, torch.bfloat16),
    (1, 16, 4, 1000, 64, True, 0, torch.float32),
    (2, 8, 8, 512, 32, False, 128, torch.bfloat16),
    (8, 12, 12, 1024, 64, True, 0, torch.bfloat16),
    (32, 8, 8, 512, 64, True, 0, torch.bfloat16),
    (8, 12, 12, 197, 64, False, 0, torch.bfloat16),
]
# (atol, rtol, lse atol) against the plain version computed in f32 from the
# same inputs, |out - ref| <= atol + rtol |ref|. bf16: the output is rounded
# to bf16 once (2^-8 relative) and the tensor-core kernel rounds the
# probabilities to bf16 for P.V (2^-9 relative each); rtol is
# torch.testing's bf16 default. f32 (CUDA cores) and every lse (f32 sums of
# exact products) differ only by summation order.
TOL = {torch.bfloat16: (1e-2, 1.6e-2, 1e-3),
       torch.float32: (1e-4, 0.0, 1e-4)}
# the main path: Mistral at the registry's (published) widths, cut to 12
# of its 32 layers in the full script (phases 4, 5, 21e, 22 and, with four
# cards, 19c serve this artifact) to pay for phases 20 and 21 within the
# time limit (16 layers before; the full script from git archive took
# 1,184 s of its 1,200 on a slow host with 16 on an H100)
MAIN_ARCH = "Mistral"
MAIN_ARGS = {"n_layer": 12}
MAIN_SIZES = {"prompt_a": 1024, "prompt_b": 6144, "batch_d": 4,
              "prompt_d": 2048, "new": 32}
# phase 3: small enough for the CPU, D = 64 so the kernel takes it, window
# 16 < prompt so the rolling cache and the band both run
REF_ARCH = {"vocab_size": 512, "n_layer": 2, "n_head": 4, "n_kv_head": 2,
            "d_model": 256, "max_len": 128, "window": 16,
            "attn_impl": "flash"}
REF_LOGIT_ATOL = 1e-3   # f32 on both sides, two layers, summation order
# the plain forward holds [B, H, T, T] f32 scores (and as many again for the
# masks and probabilities); past this many bytes of scores it runs one
# batch row and as many kv heads (with their query heads) as fit at a time
PLAIN_SCORE_BYTES = 6 << 30


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls.

    The stream first spins on the card (``torch.cuda._sleep``) for longer
    than the host takes to enqueue all the calls, so the calls run back to
    back and the host's time between launches is not counted (a small
    kernel's wrapper can take longer on the host than the kernel on the
    card). A ``fn`` that synchronises is timed with its host gaps."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    enqueue_s = min(1.0, 1.5 * reps * (time.perf_counter() - t0))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * enqueue_s))   # cycles, at <= 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def with_ratios(row: dict) -> dict:
    """``row`` with ``pct_of_bound`` (100 x bound / kernel time) and
    ``x_library`` (kernel time / library time, None without a library
    call) added."""
    lib = row.get("library_ms")
    row["pct_of_bound"] = 100.0 * row["bound_ms"] / row["kernel_ms"]
    row["x_library"] = None if lib is None else row["kernel_ms"] / lib
    return row


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_build() -> None:
    # importing a kernel's module registers its library for build_all
    from pytorch_distributed_template_tpu_torch.ops import (
        build, expert_ffn, flash,
    )

    assert {flash.FLASH_FWD, flash.PAGED_ATTN, flash.FLASH_BWD,
            expert_ffn.EXPERT_FFN} <= set(build.LIBRARIES)
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"[build] {len(build.LIBRARIES)} libraries in "
        f"{time.perf_counter() - t0:.2f} s (built now: {built})")
    for lib in build.LIBRARIES:
        lib.load()
        for line in ptxas_report(lib.build_log):
            log(f"[build] {lib.name}: {line}")
    if flash.PAGED_ATTN.build_log:
        check_no_spills(flash.PAGED_ATTN.build_log,
                        ("paged_attn_wgmma", "paged_attn_decode"))
    if flash.FLASH_BWD.build_log:
        check_no_spills(flash.FLASH_BWD.build_log,
                        ("flash_bwd_dkv_wgmma", "flash_bwd_dq_wgmma"))


def check_no_spills(build_log: str, kernels) -> None:
    """Fail when ptxas gave a kernel whose name holds one of ``kernels``
    a stack frame or spills, or reported none of them."""
    seen = 0
    for line in ptxas_report(build_log):
        if not any(k in line for k in kernels) or "spill" not in line:
            continue
        seen += 1
        if any(int(n) for n in re.findall(r"(\d+) bytes", line)):
            raise AssertionError(f"stack or spills: {line}")
    if not seen:
        raise AssertionError(f"ptxas reported none of {kernels}")


def ptxas_report(build_log: str) -> list:
    """The lines of an ``nvcc -Xptxas -v`` log worth printing: each
    kernel's stack and spills and its registers, after the kernel's name,
    and ptxas's notes on shared memory, performance and warnings."""
    lines, kernel = [], ""
    for line in build_log.splitlines():
        props = re.search(r"Function properties for (\S+)", line)
        if props:
            # the mangled name less its anonymous namespace and arguments
            kernel = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "",
                            props.group(1)).split("Ev", 1)[0]
        elif "bytes spill" in line or "Used" in line and "registers" in line:
            lines.append(f"{kernel}: {line.strip()}")
        elif "ptxas" in line and ("smem" in line or "Performance" in line
                                  or "warning" in line or "C75" in line):
            lines.append(line.strip())
    return lines


def _sdpa_args(q, k, v, causal: bool, window: int):
    """``scaled_dot_product_attention``'s ``[B, H, T, D]`` inputs and
    keywords for the same attention. A GQA call passes ``enable_gqa``;
    past ``PLAIN_SCORE_BYTES`` of scores it gets K/V expanded to the query
    heads instead (before the timing), as the backends that take
    ``enable_gqa`` with a mask hold the whole scores."""
    from pytorch_distributed_template_tpu_torch.ops.flash import (
        visible_mask,
    )

    b, t, h, _ = q.shape
    kw = {}
    if k.shape[2] != h:
        if b * h * t * t * 4 > PLAIN_SCORE_BYTES:
            k, v = (x.repeat_interleave(h // k.shape[2], dim=2)
                    for x in (k, v))
        else:
            kw["enable_gqa"] = True
    if 0 < window < t:
        kw["attn_mask"] = visible_mask(t, t, causal, window, q.device)
    else:
        kw["is_causal"] = causal
    return [x.transpose(1, 2).contiguous() for x in (q, k, v)], kw


def _sdpa_ms(q, k, v, causal: bool, window: int, reps: int):
    """Time of one ``scaled_dot_product_attention`` call on the same
    inputs (yardstick only; the port never calls it)."""
    import torch.nn.functional as F

    (qt, kt, vt), kw = _sdpa_args(q, k, v, causal, window)
    return cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw),
                   reps)


def plain_forward(q, k, v, causal: bool, window: int):
    """``flash_attention_ref(q, k, v, causal, window)``, computed in pieces
    (a batch row and a group of kv heads with their query heads) when its
    scores would exceed ``PLAIN_SCORE_BYTES``: the same arithmetic, as the
    heads and rows are independent."""
    from pytorch_distributed_template_tpu_torch.ops.flash import (
        flash_attention_ref,
    )

    b, t, h, _ = q.shape
    kvh = k.shape[2]
    if b * h * t * t * 4 <= PLAIN_SCORE_BYTES:
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    r = h // kvh
    per = max(1, PLAIN_SCORE_BYTES // (r * t * t * 4))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    for i in range(b):
        for j in range(0, kvh, per):
            kv, qh = slice(j, j + per), slice(j * r, (j + per) * r)
            out[i:i + 1, :, qh], lse[i:i + 1, qh] = flash_attention_ref(
                q[i:i + 1, :, qh], k[i:i + 1, :, kv], v[i:i + 1, :, kv],
                causal=causal, window=window)
    return out, lse


def phase_kernel(shapes=None) -> list:
    from pytorch_distributed_template_tpu_torch.ops.flash import (
        FLASH_FWD, flash_attention_lse, flash_bound_seconds,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for (b, h, kvh, t, d, causal, window, dtype) in (shapes
                                                      or KERNEL_SHAPES):
        def rnd(heads):
            return torch.randn((b, t, heads, d), generator=gen,
                               device="cuda", dtype=torch.float32).to(dtype)

        q, k, v = rnd(h), rnd(kvh), rnd(kvh)
        out, lse = flash_attention_lse(q, k, v, causal=causal,
                                       window=window)
        torch.cuda.synchronize()
        ref_out, ref_lse = plain_forward(q.float(), k.float(), v.float(),
                                         causal, window)
        diff = (out.float() - ref_out).abs()
        err_out = diff.max().item()
        atol, rtol, tol_lse = TOL[dtype]
        excess = (diff - rtol * ref_out.abs()).max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"non-finite kernel output at {t=}")
        if excess > atol or err_lse > tol_lse:
            raise AssertionError(
                f"flash_fwd disagrees with its plain version at "
                f"B={b} H={h} KVH={kvh} T={t} D={d} causal={causal} "
                f"window={window} {dtype}: out max err {err_out:.3e}, "
                f"max(err - {rtol}|ref|) {excess:.3e} (atol {atol}), lse "
                f"{err_lse:.3e} (tol {tol_lse})")
        del diff
        del ref_out, ref_lse
        reps = 20 if t <= 2048 else 5
        kernel_ms = cuda_ms(
            lambda: flash_attention_lse(q, k, v, causal, window), reps)
        ref_ms = cuda_ms(lambda: plain_forward(q, k, v, causal, window),
                         max(2, reps // 4), warmup=1)
        library_ms = _sdpa_ms(q, k, v, causal, window, reps)
        bound_s, bound_by = flash_bound_seconds(
            b, t, h, kvh, d, causal, window, q.element_size(),
            PEAK_FLOPS[dtype], PEAK_BYTES)
        row = {"B": b, "H": h, "KVH": kvh, "T": t, "D": d,
               "causal": causal, "window": window,
               "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err_out, "lse_max_abs_err": err_lse,
               "atol_rtol_lse": [atol, rtol, tol_lse],
               "kernel_ms": kernel_ms, "ref_ms": ref_ms,
               "library_ms": library_ms, "bound_ms": bound_s * 1e3,
               "bound_by": bound_by}
        rows.append(with_ratios(row))
        log("[kernel] " + json.dumps(row))
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    FLASH_FWD.launches = 0
    return rows


def phase_reference(device="cuda") -> None:
    """A small f32 Llama on ``device`` (kernel path) against the same
    weights on the CPU (plain path): prefill logits within
    ``REF_LOGIT_ATOL``, greedy tokens identical."""
    import pytorch_distributed_template_tpu_torch.models  # noqa: F401
    from pytorch_distributed_template_tpu_torch.config.registry import MODELS
    from pytorch_distributed_template_tpu_torch.engine import (
        generate as gen,
    )
    from pytorch_distributed_template_tpu_torch.engine.serving import (
        GenerationService,
    )

    cpu_model = MODELS.get("Llama")(**REF_ARCH, device="cpu")
    cpu_model.init_weights(torch.Generator().manual_seed(2))
    dev_model = MODELS.get("Llama")(**REF_ARCH, device=device)
    dev_model.load_state_dict(cpu_model.state_dict())
    prompt = np.random.default_rng(4).integers(
        0, REF_ARCH["vocab_size"], (2, 40))
    with torch.inference_mode():
        cpu_last, _ = gen._prefill_fresh(
            cpu_model, torch.from_numpy(prompt), 64)
        dev_last, _ = gen._prefill_fresh(
            dev_model, torch.from_numpy(prompt).to(device), 64)
    err = (dev_last.cpu() - cpu_last).abs().max().item()
    if not err <= REF_LOGIT_ATOL:
        raise AssertionError(f"prefill logits on {device} differ from the "
                             f"CPU by {err:.3e} > {REF_LOGIT_ATOL}")
    ids = [int(i) for i in prompt[0]]
    on_dev = GenerationService.from_model(dev_model, device=device).generate(
        prompt_ids=ids, max_new_tokens=24)
    on_cpu = GenerationService.from_model(cpu_model, device="cpu").generate(
        prompt_ids=ids, max_new_tokens=24)
    if on_dev["ids"] != on_cpu["ids"]:
        raise AssertionError(f"greedy tokens differ: {device} "
                             f"{on_dev['ids']} vs cpu {on_cpu['ids']}")
    log(f"[reference] small f32 Llama (D=64, window 16, 40-token prompt "
        f"+ 24): logits max err {err:.3e} (atol {REF_LOGIT_ATOL}), greedy "
        f"tokens identical on {device} and cpu")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class MainRun:
    """Runs and checks the main path's requests; every request starts
    with the flash launch count at 0 and must end with ``n_layer`` per
    prefill."""

    def __init__(self, n_layer: int, device, card: str):
        self.n_layer, self.device, self.card = n_layer, device, card
        self.launches = 0

    def timed(self, fn, prefills: int):
        from pytorch_distributed_template_tpu_torch.ops.flash import (
            FLASH_FWD as counter,
        )

        is_cuda = torch.device(self.device).type == "cuda"
        if is_cuda:
            torch.cuda.reset_peak_memory_stats()
        _sync(self.device)
        counter.launches = 0
        t0 = time.perf_counter()
        out = fn()
        _sync(self.device)
        secs = time.perf_counter() - t0
        got = counter.launches
        if got != self.n_layer * prefills:
            raise AssertionError(
                f"flash_fwd launched {got} times for {prefills} prefill(s) "
                f"of {self.n_layer} layers")
        self.launches += got
        peak = torch.cuda.max_memory_allocated() if is_cuda else 0
        return out, secs, peak

    def report(self, name, batch, prompt_len, new, first_s, full_s, peak):
        decode_ms = (full_s - first_s) * 1e3 / max(new - 1, 1)
        row = {"request": name, "batch": batch, "prompt_len": prompt_len,
               "new_tokens": new, "prefill_ms": first_s * 1e3,
               "decode_ms_per_token": decode_ms,
               "tokens_per_s": batch * new / full_s,
               "decode_tokens_per_s": batch * 1e3 / decode_ms,
               "request_s": full_s, "peak_mem_gib": peak / 2 ** 30,
               "flash_launches_per_prefill": self.n_layer,
               "card": self.card}
        log("[main] " + json.dumps(row))


def profile_request(service, ids, new: int, label: str, card: str) -> None:
    """One request under ``torch.profiler``: wall time (host clock to
    ``cuda.synchronize``), the device's busy time (union of kernel and copy
    intervals), its idle share, the device ops per generated token and the
    kernels that take most of the time. Launches here are outside the main
    path's counts."""
    device = service.device
    row = _profiled(lambda: service.generate(prompt_ids=ids,
                                             max_new_tokens=new), device)
    row = {"profile": label, "prompt_len": len(ids), "new_tokens": new,
           **row, "device_ops_per_token": row["device_ops"] / new,
           "card": card}
    log("[profile] " + json.dumps(row))


def _profiled(fn, device, top_n: int = 8, sums=()) -> dict:
    """Run ``fn`` under ``torch.profiler``: wall time (host clock to
    ``cuda.synchronize``), the device's busy time (union of kernel and copy
    intervals; user annotations left out), its idle share, the device op count and the kernels that
    take most of the time; ``<name>_ms`` for each name of ``sums``: the
    device time of the kernels whose names hold it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        # user annotations (the optimizer's and DDP's record_function
        # ranges) sit on the device timeline but span the gaps between
        # kernels: only kernels and copies count as busy
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy = 0.0
    end = None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    b4_us = sum(us for k, (us, _) in by_name.items()
                if "paged_attn" in k or "paged_combine" in k)
    named = {f"{name}_ms": sum(us for k, (us, _) in by_name.items()
                               if name in k) / 1e3 for name in sums}
    return {"wall_ms": wall_us / 1e3, **named,
            "paged_attn_ms": b4_us / 1e3,
            "paged_attn_share_of_busy": b4_us / busy if busy else
            "not measured",
            "device_busy_ms": busy / 1e3 if spans else "not measured",
            "device_idle_share": 1 - busy / wall_us if spans
            else "not measured",
            "device_ops": len(spans),
            "top": [{"kernel": k[:90], "ms": us / 1e3, "count": n}
                    for k, (us, n) in top]}


def _check_ids(ids, vocab: int, n: int, what: str) -> None:
    if len(ids) != n or not all(0 <= int(i) < vocab for i in ids):
        raise AssertionError(f"{what}: expected {n} ids in [0, {vocab}), "
                             f"got {ids}")


def phase_main(card: str, device="cuda", arch=MAIN_ARCH, arch_args=None,
               sizes=None, work=WORK, seed: int = 0,
               keep_artifact: bool = False) -> int:
    """Make the artifact with the port's tool, serve requests (a)-(d) and
    the CLI on it; returns the flash launches of the whole path. The work
    directory is removed at the end unless ``keep_artifact`` (slice 2's
    phase serves the same artifact)."""
    from pytorch_distributed_template_tpu_torch import generate as gen_cli
    from pytorch_distributed_template_tpu_torch.config import ConfigParser
    from pytorch_distributed_template_tpu_torch.engine import generate as eg
    from pytorch_distributed_template_tpu_torch.engine.serving import (
        GenerationService,
    )
    from pytorch_distributed_template_tpu_torch.tools import (
        make_serving_artifact as tool,
    )

    sizes = dict(MAIN_SIZES, **(sizes or {}))
    new = sizes["new"]
    if work.exists():
        shutil.rmtree(work)
    art, run_dir = work / "art", work / "run"
    argv = ["-o", str(art), "--arch", arch, "--seed", str(seed),
            "--device", str(device)]
    for key, val in (arch_args or {}).items():
        argv += ["--" + key.replace("_", "-"), json.dumps(val)
                 if isinstance(val, bool) else str(val)]
    t0 = time.perf_counter()
    tool.main(argv)
    _sync(device)
    log(f"[main] artifact {arch} made in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    serve_argv = ["-r", str(art / "model"), "-s", str(run_dir)]
    _, config = ConfigParser.from_args(gen_cli.build_parser(), (),
                                       training=False, argv=serve_argv)
    service = GenerationService(config, device=device)
    model = service.model
    vocab = model.vocab_size
    log(f"[main] {arch} loaded on {service.device} in "
        f"{time.perf_counter() - t0:.1f} s: vocab {vocab}, {model.n_layer} "
        f"layers, {model.n_head}/{model.n_kv_head} heads, d_model "
        f"{model.d_model}, d_ff {model.d_ff}, window {model.window}, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, "
        f"{model.dtype}; card: {card}")
    run = MainRun(model.n_layer, device, card)
    rng = torch.Generator().manual_seed(seed + 1)

    def prompt(n, batch=1):
        return torch.randint(0, vocab, (batch, n), generator=rng)

    def serve(ids, n, **kw):
        return service.generate(prompt_ids=ids, max_new_tokens=n, **kw)

    # (a) 1024-token prompt, greedy, twice: identical ids
    a = prompt(sizes["prompt_a"])[0].tolist()
    first, first_s, _ = run.timed(lambda: serve(a, 1), 1)
    a1, full_s, peak = run.timed(lambda: serve(a, new), 1)
    a2, _, _ = run.timed(lambda: serve(a, new), 1)
    _check_ids(a1["ids"], vocab, new, "(a)")
    if a1["ids"] != a2["ids"] or first["ids"] != a1["ids"][:1]:
        raise AssertionError(f"(a) greedy runs differ: {a1['ids']} vs "
                             f"{a2['ids']} (first token {first['ids']})")
    run.report("a_greedy", 1, len(a), new, first_s, full_s, peak)

    # the generate CLI on the same artifact and request: same tokens
    cli_argv = serve_argv + ["--prompt-ids", ",".join(map(str, a)),
                             "--max-new-tokens", str(new),
                             "--device", str(device)]
    cli, cli_s, _ = run.timed(lambda: gen_cli.main(cli_argv), 1)
    if cli["ids"] != a1["ids"]:
        raise AssertionError(f"generate CLI {cli['ids']} != service "
                             f"{a1['ids']}")
    log(f"[main] generate CLI (loads the artifact itself): same {new} "
        f"tokens as the service, {cli_s:.1f} s")
    gc.collect()

    # (b) past the window: rolling cache, banded kernel
    b = prompt(sizes["prompt_b"])[0].tolist()
    total_b = len(b) + new
    if model.window and total_b > model.window:
        assert model.cache_len(total_b) == model.window
    first, first_s, _ = run.timed(lambda: serve(b, 1), 1)
    b1, full_s, peak = run.timed(lambda: serve(b, new), 1)
    _check_ids(b1["ids"], vocab, new, "(b)")
    if first["ids"] != b1["ids"][:1]:
        raise AssertionError("(b) first token differs between requests")
    run.report("b_past_window", 1, len(b), new, first_s, full_s, peak)

    # (c) sampled with a stop id: the stopped request is the free one cut
    # at the stop token's first appearance
    sample = dict(temperature=0.8, top_p=0.95, seed=1)
    free, full_s, peak = run.timed(lambda: serve(a, new, **sample), 1)
    _check_ids(free["ids"], vocab, new, "(c)")
    stop = free["ids"][new // 3]
    cut = free["ids"].index(stop)
    stopped, stop_s, _ = run.timed(
        lambda: serve(a, new, stop=[stop], **sample), 1)
    if stopped["ids"] != free["ids"][:cut] or \
            stopped["stop_reason"] != "stop":
        raise AssertionError(f"(c) stop request {stopped} is not the free "
                             f"one {free['ids']} cut at {stop}")
    first, first_s, _ = run.timed(lambda: serve(a, 1, **sample), 1)
    run.report("c_sampled", 1, len(a), new, first_s, full_s, peak)
    log(f"[main] (c) stop id {stop}: {len(stopped['ids'])} tokens, "
        f"stop_reason {stopped['stop_reason']}, {stop_s:.3f} s")

    # (d) a batch through engine.generate.generate
    d = prompt(sizes["prompt_d"], sizes["batch_d"]).to(service.device)
    _, first_s, _ = run.timed(
        lambda: eg.generate(model, d, 1, temperature=0.0), 1)
    out, full_s, peak = run.timed(
        lambda: eg.generate(model, d, new, temperature=0.0), 1)
    if out.shape != (d.shape[0], d.shape[1] + new) or \
            not torch.equal(out[:, :d.shape[1]], d):
        raise AssertionError(f"(d) output shape {tuple(out.shape)}")
    for row in out[:, d.shape[1]:].tolist():
        _check_ids(row, vocab, new, "(d)")
    run.report("d_batch", d.shape[0], d.shape[1], new, first_s, full_s,
               peak)

    # where the time goes: the prefill alone, then prefill + decode
    profile_request(service, a, 1, "a_prefill", card)
    profile_request(service, a, new, "a_request", card)
    del service, model
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    if not keep_artifact:
        shutil.rmtree(work)
    return run.launches

# ---------------------------------------------------------------------------
# slice 2: continuous paged serving, kernel B4
# ---------------------------------------------------------------------------

PAGED_SOURCE = "pytorch_distributed_template_tpu_torch/csrc/paged_attn.cu"
PAGED_REPLACES = "pytorch_distributed_template_tpu/ops/flash.py:620"
# (name, B, T, Hq, KVH, D, bt, NB, window, layout, dtype, quant): the main
# path's launches (Mistral-7B: 32/8 heads, D 128, bt 32, the 145-page ring
# of window 4096 + 1 + 512/32 slack; a long prompt's first chunk sees a flat
# table of 16 pages) and one f32 case at D 64
PAGED_SHAPES = [
    ("decode_ring", 8, 1, 32, 8, 128, 32, 145, 4096, "ring",
     torch.bfloat16, False),
    ("decode_ring_int8", 8, 1, 32, 8, 128, 32, 145, 4096, "ring",
     torch.bfloat16, True),
    ("decode_flat", 8, 1, 32, 8, 128, 32, 64, 0, "flat",
     torch.bfloat16, False),
    ("prefill_chunk", 1, 512, 32, 8, 128, 32, 145, 4096, "chunk",
     torch.bfloat16, False),
    ("prefill_first", 1, 512, 32, 8, 128, 32, 145, 0, "first",
     torch.bfloat16, False),
    ("admit_feed", 8, 64, 32, 8, 128, 32, 145, 4096, "feed",
     torch.bfloat16, False),
    ("f32_d64", 4, 16, 16, 4, 64, 16, 40, 0, "flat", torch.float32, False),
]
PAGED_POOL_PAGES = 1280
# slice 2's main path: Mistral at full width served by the port's serve.py
# over configs/mistral_7b_serve_paged.json (32-token blocks, 1280 pages,
# 512-token prefill chunks)
SERVE_CONFIG = REPO / "pytorch_distributed_template_tpu_torch" / "configs" \
    / "mistral_7b_serve_paged.json"
SERVE_SIZES = {"prefix": 1024, "shared_suffix": [128, 384, 640, 1024],
               "alone": [256, 512, 1024, 1536], "new": 64, "long": 6144,
               "long_new": 64, "short": 128, "short_new": 128,
               "logit_prompt": 1024, "slots": 8, "chunk": 8}
# last-position logits of the paged batch-1 prefill against slice 1's
# flash prefill, bf16 (read at 32 layers; the full script's artifact has
# 12, MAIN_ARGS): the two paths round K/V, P and the
# residual stream at different places, so they agree to a few bf16 ulps
# of the logits' scale: max |diff| <= 5% of max |logit|
SERVE_LOGIT_RTOL = 0.05
# phase 3b: the small f32 model with block 8 and 16-token prefill chunks
PAGED_REF_POOL = {"enabled": True, "block_tokens": 8, "pool_blocks": 96,
                  "paged": True}


def _paged_case(name, b, t, hq, kvh, d, bt, nb, window, layout, dtype,
                quant, gen):
    """Inputs of one B4 shape on the card: random pools of
    ``PAGED_POOL_PAGES`` pages and each row's table as the engine lays it
    (distinct random pages; ``-1`` past a row's allocation)."""
    from pytorch_distributed_template_tpu_torch.models.quant import (
        quantize_kv,
    )

    dev = "cuda"
    pages = PAGED_POOL_PAGES
    q = torch.randn((b, t, hq, d), generator=gen, device=dev).to(dtype)
    kp = torch.randn((pages, bt, kvh, d), generator=gen, device=dev)
    vp = torch.randn((pages, bt, kvh, d), generator=gen, device=dev)
    ks = vs = None
    if quant:
        kp, ks = quantize_kv(kp)
        vp, vs = quantize_kv(vp)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    cpu = torch.Generator().manual_seed(b * 1000 + t)
    tables = torch.full((b, nb), -1, dtype=torch.int32)
    pads = torch.zeros((b,), dtype=torch.int32)
    if layout == "chunk":
        starts = torch.tensor([5120], dtype=torch.int32)
    elif layout == "first":
        starts = torch.tensor([0], dtype=torch.int32)
    elif layout == "flat":
        lens = torch.randint(500, 2001, (b,), generator=cpu)
        lens = lens.clamp(max=nb * bt)
        starts = (lens - t).int()
    elif layout == "feed":
        starts = torch.randint(64, 2000, (b,), generator=cpu).int()
        pads = torch.randint(0, t, (b,), generator=cpu).int()
    else:                                         # decode ring
        starts = torch.randint(300, 6001, (b,), generator=cpu).int()
    for i in range(b):
        end = int(starts[i]) + t                  # tokens written so far
        n = min(nb, -(-end // bt))
        perm = torch.randperm(pages - 1, generator=cpu)[:n] + 1
        if layout in ("flat", "first") or end <= nb * bt:
            tables[i, :n] = perm.int()
        else:
            tables[i] = perm.int()                # a full (wrapped) ring
    if layout not in ("chunk", "first"):
        tables[0, -1] = -1                        # one unallocated lane
    to = [x.to(dev) for x in (tables, starts, pads)]
    return q, kp, vp, ks, vs, *to


def _sdpa_paged_ms(q, kp, vp, ks, vs, tables, starts, pads, window, reps):
    """``scaled_dot_product_attention`` on K/V gathered contiguously in
    advance (the gather is not timed), with the same boolean mask: the
    yardstick, since no single PyTorch call reads a block table."""
    import torch.nn.functional as F

    from pytorch_distributed_template_tpu_torch.ops.flash import (
        paged_gather, paged_visible,
    )

    k_all = paged_gather(kp, tables, ks, q.dtype).transpose(1, 2)
    v_all = paged_gather(vp, tables, vs, q.dtype).transpose(1, 2)
    k_all, v_all = k_all.contiguous(), v_all.contiguous()
    mask = paged_visible(tables, starts, pads, q.shape[1], kp.shape[1],
                         window)[:, None]
    qt = q.transpose(1, 2).contiguous()
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, k_all, v_all, attn_mask=mask, enable_gqa=True), reps)


def _host_ms(fn, calls: int = 100, batches: int = 7) -> float:
    """Host time of one call of ``fn``: the median over ``batches`` of the
    mean enqueue time of ``calls`` back-to-back calls, the card idle when
    each batch starts (the median, since the host is shared)."""
    fn()
    means = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        means.append((time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    return sorted(means)[batches // 2]


def phase_paged_kernel(shapes=None) -> list:
    """B4 against its plain version on the card at the main path's
    shapes: the arm each takes, max error over valid lanes (pad lanes must
    be exactly 0), kernel / plain / SDPA times, the card's bound and the
    wrapper's host time per call (the enqueue of back-to-back calls)."""
    from pytorch_distributed_template_tpu_torch.ops.flash import (
        PAGED_ARM_LAUNCHES, PAGED_ATTN, paged_arm, paged_attention,
        paged_attention_ref, paged_bound_seconds,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for shape in shapes or PAGED_SHAPES:
        (name, b, t, hq, kvh, d, bt, nb, window, layout, dtype,
         quant) = shape
        q, kp, vp, ks, vs, tables, starts, pads = _paged_case(*shape, gen)
        args = (q, kp, vp, tables, starts, pads)
        kw = dict(window=window, k_scale=ks, v_scale=vs)
        arm = paged_arm(dtype, bt, t * (hq // kvh))
        before = PAGED_ARM_LAUNCHES[arm]
        out = paged_attention(*args, **kw)
        torch.cuda.synchronize()
        if PAGED_ARM_LAUNCHES[arm] != before + 1:
            raise AssertionError(f"B4 {name}: the {arm} arm did not launch")
        f32 = (lambda x: x) if quant else (lambda x: x.float())
        ref = paged_attention_ref(q.float(), f32(kp), f32(vp), tables,
                                  starts, pads, **kw)
        atol, rtol, _ = TOL[dtype]
        err, excess = 0.0, 0.0
        for i, p in enumerate(pads.tolist()):
            diff = (out[i, p:].float() - ref[i, p:]).abs()
            err = max(err, diff.max().item())
            excess = max(excess,
                         (diff - rtol * ref[i, p:].abs()).max().item())
            if p and out[i, :p].float().abs().max().item() != 0.0:
                raise AssertionError(f"B4 {name}: pad lanes not zero")
        if not torch.isfinite(out).all():
            raise AssertionError(f"B4 {name}: non-finite output")
        if excess > atol:
            raise AssertionError(
                f"paged_attn disagrees with its plain version at {name}: "
                f"max err {err:.3e}, max(err - {rtol}|ref|) {excess:.3e} "
                f"(atol {atol})")
        del ref
        reps = 20 if t > 64 else 50
        kernel_ms = cuda_ms(lambda: paged_attention(*args, **kw), reps)
        ref_ms = cuda_ms(lambda: paged_attention_ref(*args, **kw),
                         max(2, reps // 10), warmup=1)
        library_ms = _sdpa_paged_ms(q, kp, vp, ks, vs, tables, starts, pads,
                                    window, reps)
        host_ms = _host_ms(lambda: paged_attention(*args, **kw))
        bound_s, bound_by = paged_bound_seconds(
            q, kp, tables, starts, pads, window, quant, PEAK_FLOPS[dtype],
            PEAK_BYTES)
        row = {"shape": name, "arm": arm, "B": b, "T": t, "Hq": hq,
               "KVH": kvh, "D": d, "bt": bt, "NB": nb, "window": window,
               "dtype": str(dtype).replace("torch.", ""),
               "kv": "int8" if quant else str(dtype).replace("torch.", ""),
               "max_abs_err": err, "atol_rtol": [atol, rtol],
               "kernel_ms": kernel_ms, "ref_ms": ref_ms,
               "library_ms": library_ms, "bound_ms": bound_s * 1e3,
               "bound_by": bound_by, "host_ms_per_call": host_ms,
               "library": "scaled_dot_product_attention on K/V gathered "
                          "in advance (gather not timed), same mask"}
        rows.append(with_ratios(row))
        log("[paged] " + json.dumps(row))
        del q, kp, vp, ks, vs, out
        torch.cuda.empty_cache()
    PAGED_ATTN.launches = 0
    return rows


def _concurrent(fn, items, timeout=600.0):
    """``fn(item)`` for every item in its own thread; results in order.
    Raises the first error; fails when a thread is still running at the
    timeout."""
    import threading

    out, errs = [None] * len(items), []

    def call(i):
        try:
            out[i] = fn(items[i])
        except Exception as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=call, args=(i,), daemon=True)
               for i in range(len(items))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout)
    if any(th.is_alive() for th in threads):
        raise AssertionError("requests still running after the timeout")
    if errs:
        raise errs[0]
    return out


def phase_paged_reference(device="cuda") -> None:
    """The small f32 Llama (D 64, window 16, block 8) served by the
    continuous engine over the paged pool on ``device`` (B4) and on the
    CPU (plain version): 6 concurrent greedy requests, some streamed and
    some wrapping the ring, give the same tokens; also with the int8
    pool."""
    import pytorch_distributed_template_tpu_torch.models  # noqa: F401
    from pytorch_distributed_template_tpu_torch.config.registry import MODELS
    from pytorch_distributed_template_tpu_torch.engine.continuous import (
        ContinuousBatchingService,
    )

    rng = np.random.default_rng(9)
    reqs = [{"prompt_ids": [int(x) for x in rng.integers(
        0, REF_ARCH["vocab_size"], n)], "max_new_tokens": 24}
        for n in (5, 12, 20, 33, 47, 70)]
    for kv_quant in ("", "int8"):
        results = []
        cpu_model = MODELS.get("Llama")(**REF_ARCH, kv_quant=kv_quant,
                                        device="cpu")
        cpu_model.init_weights(torch.Generator().manual_seed(2))
        for dev in (device, "cpu"):
            model = MODELS.get("Llama")(**REF_ARCH, kv_quant=kv_quant,
                                        device=dev)
            model.load_state_dict(cpu_model.state_dict())
            svc = ContinuousBatchingService.from_model(
                model, device=dev, slots=4, chunk=4, window_ms=20.0,
                prefix_cache=PAGED_REF_POOL, prefill_chunk_tokens=16)
            try:
                results.append([r["ids"] for r in _concurrent(
                    lambda r: svc.generate(**r), reqs)])
            finally:
                svc.close()
        if results[0] != results[1]:
            raise AssertionError(f"paged reference ({kv_quant or 'f32'} "
                                 f"pool): {device} {results[0]} vs cpu "
                                 f"{results[1]}")
        log(f"[paged-reference] small f32 Llama (D=64, window 16, block 8, "
            f"{kv_quant or 'f32'} pool), 6 concurrent requests of 5-70 "
            f"tokens + 24: greedy tokens identical on {device} and cpu")


class ServeRun:
    """The port's ``serve.py`` running in this process: ``main`` in a
    thread on a free port, stopped by :meth:`close`."""

    def __init__(self, argv, timeout=900.0, model=None):
        import threading

        from pytorch_distributed_template_tpu_torch import serve

        ready, self.errors, box = threading.Event(), [], {}

        def on_ready(server, service):
            box.update(server=server, service=service)
            ready.set()

        def target():
            try:
                serve.main(argv, on_ready, model=model)
            except BaseException as e:  # noqa: BLE001 — raised below
                self.errors.append(e)
                ready.set()

        self.thread = threading.Thread(target=target, daemon=True,
                                       name="serve-main")
        self.thread.start()
        if not ready.wait(timeout):
            raise AssertionError("serve.py did not become ready")
        if self.errors:
            raise self.errors[0]
        self.server, self.service = box["server"], box["service"]
        host, port = self.server.server_address[:2]
        self.host, self.port = host, port
        self.run_dir = Path(argv[argv.index("-s") + 1])

    def spans(self, tag=None) -> list:
        """The span records this server's tracer wrote (``spans.jsonl``
        under its ``-s`` directory); ``tag`` is appended to each record's
        ``pid``: servers in this process share one, and the stitcher keys
        a process on ``(proc, pid)``."""
        from pytorch_distributed_template_tpu_torch.observability import (
            reqtrace,
        )

        spans = reqtrace.load_spans(reqtrace.discover_span_files(
            self.run_dir))
        if tag:
            spans = [dict(r, pid=f"{r.get('pid')}/{tag}") for r in spans]
        return spans

    def close(self) -> None:
        self.server.shutdown()
        self.thread.join(300)
        if self.thread.is_alive():
            raise AssertionError("serve.py did not stop")
        if self.errors:
            raise self.errors[0]
        self.server = self.service = None


def stream_request(run: ServeRun, body: dict, headers=None) -> dict:
    """One ``POST /generate`` with ``"stream": true`` over HTTP: the ids,
    the time to the first delta (TTFT) and to the last event, the size of
    the first delta, the request id the server echoed and the serve path
    of the done event. The deltas must concatenate to the final ids."""
    import http.client

    conn = http.client.HTTPConnection(run.host, run.port, timeout=1200)
    t0 = time.perf_counter()
    conn.request("POST", "/generate", body=json.dumps(dict(body,
                                                           stream=True)),
                 headers={"Content-Type": "application/json",
                          **(headers or {})})
    resp = conn.getresponse()
    if resp.status != 200:
        raise AssertionError(f"POST /generate: {resp.status} "
                             f"{resp.read()[:500]!r}")
    rid = resp.getheader("X-Request-Id")
    ttft, first_n, deltas, final = None, 0, [], None
    while True:
        line = resp.readline()
        if not line:
            break
        line = line.strip()
        if not line.startswith(b"data: "):
            continue
        event = json.loads(line[len(b"data: "):])
        if event.get("done"):
            final = event
            break
        if ttft is None:
            ttft, first_n = time.perf_counter() - t0, len(event["ids"])
        deltas.extend(event["ids"])
    total = time.perf_counter() - t0
    conn.close()
    if final is None or "error" in final:
        raise AssertionError(f"stream ended without a result: {final}")
    if deltas != final["ids"]:
        raise AssertionError("SSE deltas do not concatenate to the ids")
    return {"ids": final["ids"], "ttft_s": ttft, "total_s": total,
            "first_delta": first_n, "prompt_len": len(body["prompt_ids"]),
            "rid": rid, "serve_path": final.get("serve_path"),
            "stop_reason": final.get("stop_reason")}


def check_traced(run: ServeRun, results, label: str,
                 timeout: float = 30.0) -> dict:
    """Every request of a wave has its id's ``complete`` event and a
    ``serve_path`` event in the server's spans, whose fingerprint is the
    one the response carried. Returns rid -> the ordered span names."""
    want = {r["rid"]: r["serve_path"] for r in results}
    if not all(want) or not all(want.values()):
        raise AssertionError(f"({label}) a response lacks its request id or "
                             f"serve path: {want}")
    t0 = time.perf_counter()
    while True:
        names, paths = {}, {}
        for rec in run.spans():
            if rec.get("rid") in want:
                names.setdefault(rec["rid"], []).append(rec["name"])
                if rec["name"] == "serve_path":
                    paths[rec["rid"]] = rec["attrs"]["fingerprint"]
        if all("complete" in names.get(rid, ()) for rid in want):
            break
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"({label}) requests without a complete "
                                 f"event: {sorted(set(want) - set(names))} "
                                 f"{names}")
        time.sleep(0.05)
    if paths != want:
        raise AssertionError(f"({label}) traced fingerprints {paths} differ "
                             f"from the responses' {want}")
    return names


class ServeWave:
    """Counts and checks one wave of requests on slice 2's path: B4 and
    B1 launch counts set to 0 before, B4 launches == n_layer x the
    engine's model calls and B1 == 0 after, every id in range, warm admits
    copying nothing."""

    def __init__(self, card: str, device):
        self.card, self.device = card, device
        self.b4_launches = 0

    def run(self, label, service, drive, n_new: int, copy_bytes: int = 0):
        """``copy_bytes``: the warm-admit copy bytes the pool must show
        after the wave (a decode server's: its imported pages' bytes)."""
        from pytorch_distributed_template_tpu_torch.ops.flash import (
            FLASH_FWD, PAGED_ARM_LAUNCHES, PAGED_ATTN,
        )

        is_cuda = torch.device(self.device).type == "cuda"
        _sync(self.device)
        if is_cuda:
            torch.cuda.reset_peak_memory_stats()
        FLASH_FWD.launches = PAGED_ATTN.launches = 0
        for arm in PAGED_ARM_LAUNCHES:
            PAGED_ARM_LAUNCHES[arm] = 0
        calls0 = service.stats["model_calls"]
        kinds = ("prefill_chunks", "admit_calls", "decode_calls")
        kinds0 = {k: service.stats[k] for k in kinds}
        t0 = time.perf_counter()
        results = drive()
        wall = time.perf_counter() - t0
        _sync(self.device)
        calls = service.stats["model_calls"] - calls0
        n_layer = service.model.n_layer
        if PAGED_ATTN.launches != n_layer * calls or calls == 0:
            raise AssertionError(
                f"({label}) paged_attn launched {PAGED_ATTN.launches} times "
                f"for {calls} model calls of {n_layer} layers")
        if FLASH_FWD.launches:
            raise AssertionError(f"({label}) flash_fwd launched "
                                 f"{FLASH_FWD.launches} times on the paged "
                                 "path")
        self.b4_launches += PAGED_ATTN.launches
        kind = {k: service.stats[k] - kinds0[k] for k in kinds}
        arms = dict(PAGED_ARM_LAUNCHES)
        if is_cuda:
            want = {"wgmma": n_layer * (kind["prefill_chunks"]
                                        + kind["admit_calls"]),
                    "decode": n_layer * kind["decode_calls"],
                    "cuda_cores": 0}
        else:
            want = {"wgmma": 0, "decode": 0, "cuda_cores": 0}
        if arms != want:
            raise AssertionError(f"({label}) B4 arms {arms} for engine "
                                 f"calls {kind}: expected {want}")
        vocab = service.model.vocab_size
        for r in results:
            _check_ids(r["ids"], vocab, r.get("new", n_new), f"({label})")
        pool = service.prefix_cache_stats()
        if pool["warm_admit_copy_bytes"] != copy_bytes:
            raise AssertionError(f"({label}) warm admits copied "
                                 f"{pool['warm_admit_copy_bytes']} bytes "
                                 f"(expected {copy_bytes})")
        peak = torch.cuda.max_memory_allocated() if is_cuda else 0
        for i, r in enumerate(results):
            n = len(r["ids"])
            decode = ((r["total_s"] - r["ttft_s"]) * 1e3
                      / (n - r["first_delta"])
                      if n > r["first_delta"] else "not measured")
            log("[serve] " + json.dumps({
                "wave": label, "request": i, "prompt_len": r["prompt_len"],
                "new_tokens": n, "ttft_ms": r["ttft_s"] * 1e3,
                "decode_ms_per_token": decode,
                "request_s": r["total_s"]}))
        log("[serve] " + json.dumps({
            "wave": label, "requests": len(results),
            "new_tokens": sum(len(r["ids"]) for r in results),
            "wall_s": wall,
            "tokens_per_s": sum(len(r["ids"]) for r in results) / wall,
            "model_calls": calls, "paged_attn_launches": PAGED_ATTN.launches,
            "paged_attn_arms": arms, "engine_calls": kind,
            "flash_fwd_launches": FLASH_FWD.launches,
            "peak_mem_gib": peak / 2 ** 30,
            "pool_blocks": pool["prefix_pool_blocks"],
            "pool_blocks_used": pool["prefix_pool_blocks_used"],
            "pool_blocks_resident": pool["prefix_pool_blocks_resident"],
            "pool_blocks_referenced": pool["prefix_pool_blocks_referenced"],
            "prefix_hit_tokens": pool["prefix_hit_tokens"],
            "warm_admit_copy_bytes": pool["warm_admit_copy_bytes"],
            "engine": {k: service.stats[k] for k in (
                "admissions", "chunks", "paged_chunks", "prefill_chunks",
                "deferred_admissions")},
            "card": self.card}))
        return results


def _wait_for(cond, what: str, timeout: float = 600.0) -> None:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def _mix_e(run: ServeRun, waves: ServeWave, label: str, sizes, prompts):
    """(e): 8 concurrent greedy requests, half sharing a prefix. The first
    sharing request goes first; the other 7 are sent once its streamed
    prefix has been adopted into the radix index, so they can hit it."""
    import threading

    svc = run.service
    pf = svc._prefix
    need = pf.counter("prefix_adopted_blocks") + sizes["prefix"] // pf.block
    bodies = [{"prompt_ids": p, "max_new_tokens": sizes["new"]}
              for p in prompts]

    def drive():
        first = {}
        th = threading.Thread(target=lambda: first.update(
            r=stream_request(run, bodies[0])), daemon=True)
        th.start()
        _wait_for(lambda: pf.counter("prefix_adopted_blocks") >= need
                  or not th.is_alive(), "the shared prefix's adoption")
        rest = _concurrent(lambda b: stream_request(run, b), bodies[1:])
        th.join(1200)
        if "r" not in first:
            raise AssertionError(f"({label}) first request failed")
        return [first["r"]] + rest

    out = waves.run(label, svc, drive, sizes["new"])
    hit = svc.prefix_cache_stats()["prefix_hit_tokens"]
    if hit <= 0:
        raise AssertionError(f"({label}) no prefix hit tokens after the "
                             "shared-prefix wave")
    check_traced(run, out, label)
    log(f"[serve] ({label}) traced: every request has its complete event; "
        "fingerprints " + json.dumps(sorted({r["serve_path"] for r in out})))
    return out


def _logit_check(service, n: int, seed: int) -> dict:
    """Last-position logits of an ``n``-token prompt through the paged
    batch-1 prefill (its own small pool; B4) against slice 1's fresh-cache
    flash prefill (B1), within ``SERVE_LOGIT_RTOL`` of the logits'
    scale."""
    from pytorch_distributed_template_tpu_torch.engine.kvcache import (
        PrefixCache,
    )

    model = service.model
    block = service._prefix.block
    ids = torch.randint(0, model.vocab_size, (n,),
                        generator=torch.Generator().manual_seed(seed))
    pc = PrefixCache(model, block_tokens=block,
                     pool_blocks=service._prefix.nb_max + 2,
                     ring_slack_tokens=service._prefix.ring_slack_tokens
                     or 512)
    with torch.no_grad():
        paged, _, plan = pc.paged_prefill(ids.tolist(), 1)
        pc.paged_finish(plan, [], 0)
        cache = model.new_cache(1, n + 1)
        flash = model(ids[None].to(model.device), cache=cache,
                      prefill=True)[:, -1]
    _sync(model.device)
    err = (paged - flash).abs().max().item()
    scale = flash.abs().max().item()
    row = {"prompt_len": n, "logits_max_abs_diff": err,
           "logits_mean_abs_diff": (paged - flash).abs().mean().item(),
           "logits_max_abs": scale, "rtol": SERVE_LOGIT_RTOL,
           "same_argmax": bool(paged.argmax() == flash.argmax())}
    if not (torch.isfinite(paged).all() and err <= SERVE_LOGIT_RTOL * scale):
        raise AssertionError(f"paged prefill logits differ from the flash "
                             f"prefill: {row}")
    del pc, cache
    return row


def phase_serve(card: str, model_path, config=SERVE_CONFIG, device="cuda",
                sizes=None, work=WORK, seed: int = 0, record=None) -> int:
    """Slice 2's main path: the port's ``serve.py`` on the artifact with
    the paged config, driven over HTTP. (e) 8 concurrent greedy requests
    of 256-2048 tokens, half sharing a 1024-token prefix; one of them
    alone, twice; (f) a 6144-token prompt streamed in 512-token chunks
    while 4 short requests decode; (g) the mix of (e) again with an int8
    pool (``--set serving;kv_quant int8``). ``record``: a dict
    that gets (e)'s ids (``"e_ids"``; phase 22's cold run). Returns B4's
    launches on the path."""
    sizes = dict(SERVE_SIZES, **(sizes or {}))
    run_dir = work / "serve_run"
    base = ["-r", str(model_path), "-c", str(config), "-s", str(run_dir),
            "--port", "0", "--max-batch", str(sizes["slots"]),
            "--decode-chunk", str(sizes["chunk"]), "--device", str(device)]
    gen = torch.Generator().manual_seed(seed + 7)
    t0 = time.perf_counter()
    run = ServeRun(base)
    svc = run.service
    vocab = svc.model.vocab_size

    def rand(n):
        return torch.randint(0, vocab, (n,), generator=gen).tolist()

    prefix = rand(sizes["prefix"])
    prompts = ([prefix + rand(n) for n in sizes["shared_suffix"]]
               + [rand(n) for n in sizes["alone"]])
    log(f"[serve] serve.py up in {time.perf_counter() - t0:.1f} s: "
        f"{type(svc).__name__} on {svc.device}, {svc.model.n_layer} layers, "
        f"pool {svc._prefix.pool_blocks} x {svc._prefix.block} tokens "
        f"({svc._prefix.page_bytes / 2 ** 20:.2f} MiB/page), ring "
        f"{svc._prefix.nb_max} pages, prefill chunk {svc._prefill_chunk}")
    waves = ServeWave(card, device)
    try:
        e_out = _mix_e(run, waves, "e", sizes, prompts)
        if record is not None:
            record["e_ids"] = [r["ids"] for r in e_out]
        solo = [waves.run(f"e_alone_{i}", svc, lambda: [stream_request(
            run, {"prompt_ids": prompts[-1],
                  "max_new_tokens": sizes["new"]})], sizes["new"])[0]
            for i in range(2)]
        if solo[0]["ids"] != solo[1]["ids"]:
            raise AssertionError("a request served alone twice gave "
                                 f"{solo[0]['ids']} then {solo[1]['ids']}")
        log(f"[serve] (e) request served alone twice: identical ids; equal "
            f"to its batched run: {solo[0]['ids'] == e_out[-1]['ids']}")
        # where a decode step's time goes on this path (outside the
        # counted waves)
        profile_request(svc, prompts[-1], sizes["new"], "serve_alone", card)

        def drive_f():
            import threading

            shorts = [{"prompt_ids": rand(sizes["short"]),
                       "max_new_tokens": sizes["short_new"]}
                      for _ in range(4)]
            box = {}
            th = threading.Thread(target=lambda: box.update(r=_concurrent(
                lambda b: stream_request(run, b), shorts)), daemon=True)
            th.start()
            _wait_for(lambda: svc.live_slots() >= 4 or not th.is_alive(),
                      "the short requests to decode")
            long = stream_request(run, {"prompt_ids": rand(sizes["long"]),
                                        "max_new_tokens": sizes["long_new"]})
            long["new"] = sizes["long_new"]
            th.join(1200)
            if "r" not in box:
                raise AssertionError("(f) short requests failed")
            return box["r"] + [long]

        chunks0 = svc.stats["prefill_chunks"]
        waves.run("f", svc, drive_f, sizes["short_new"])
        if svc.stats["prefill_chunks"] - chunks0 < \
                sizes["long"] // max(svc._prefill_chunk, 1) - 1:
            raise AssertionError("(f) the long prompt did not stream")
        logits = _logit_check(svc, sizes["logit_prompt"], seed + 11)
        log("[serve] logits " + json.dumps(dict(logits, card=card)))
    finally:
        run.close()
    del run, svc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    run = ServeRun(base + ["--set", "serving;kv_quant", "int8"])
    try:
        if run.service.model.kv_quant != "int8":
            raise AssertionError("(g) the int8 pool was not configured")
        _mix_e(run, waves, "g_int8", sizes, prompts)
    finally:
        run.close()
    del run
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return waves.b4_launches


# ---------------------------------------------------------------------------
# slice 3: LM training, kernels B2 and B3
# ---------------------------------------------------------------------------

BWD_SOURCE = "pytorch_distributed_template_tpu_torch/csrc/flash_bwd.cu"
BWD_REPLACES = {"flash_bwd_dkv":
                "pytorch_distributed_template_tpu/ops/flash.py:280",
                "flash_bwd_dq":
                "pytorch_distributed_template_tpu/ops/flash.py:365"}
# (name, B, H, KVH, T, D, causal, window, dtype, lse cotangent): the
# training main path's shape first (GPT-2 small: 12 heads, D 64, T 1024,
# batch 8), Mistral's head shape with GQA, a banded, a ragged f32 and a
# non-causal banded case, one case through both outputs of
# flash_attention_lse, and ViT-B/16's attention at a small batch (bf16,
# non-causal, ragged T 197, B > 1; phase 15b runs its microbatch)
BWD_SHAPES = [
    ("gpt2_small", 8, 12, 12, 1024, 64, True, 0, torch.bfloat16, False),
    ("moe_lm", 32, 8, 8, 512, 64, True, 0, torch.bfloat16, False),
    ("mistral_gqa", 1, 32, 8, 2048, 128, True, 0, torch.bfloat16, False),
    ("banded", 2, 16, 4, 2048, 128, True, 512, torch.bfloat16, False),
    ("ragged_f32", 1, 16, 4, 1000, 64, True, 0, torch.float32, False),
    ("noncausal_banded", 2, 8, 8, 512, 32, False, 128, torch.bfloat16,
     False),
    ("lse_cotangent", 2, 12, 12, 512, 64, True, 0, torch.bfloat16, True),
    ("vit_b16_b8", 8, 12, 12, 197, 64, False, 0, torch.bfloat16, False),
]
# |got - ref| <= a * max|ref| + r * |ref| + 1e-5 against the plain backward
# in f32 on the same inputs. bf16 (1e-2, 1.6e-2): the kernels round P and dS
# to bf16 as operands (2^-9 relative each) and the gradients to bf16 once
# (2^-8). f32 (1e-5, 1e-4): summation order only. The 1e-5 floor covers
# gradients that are 0 in exact arithmetic.
BWD_TOL = {torch.bfloat16: (1e-2, 1.6e-2), torch.float32: (1e-5, 1e-4)}
# phase 3c: small f32 models, head_dim 64 so the kernels take them
TRAIN_REF = {
    "GPT2": {"size": "gpt2-small", "vocab_size": 512, "max_len": 64,
             "n_layer": 2, "n_head": 2, "d_model": 128, "dropout": 0.0,
             "attn_impl": "flash", "fused_head": True, "remat": True},
    "Llama": {"vocab_size": 512, "n_layer": 2, "n_head": 4, "n_kv_head": 2,
              "d_model": 256, "max_len": 64, "window": 16,
              "attn_impl": "flash"},
}
TRAIN_REF_STEPS = 5
# per-step losses rtol 1e-5; final params atol 1e-4: float32 on both sides
# (cuBLAS f32 GEMMs without TF32, the kernels' f32 arms), so the runs
# differ by summation order, which Adam's normalised updates keep small
TRAIN_REF_TOL = {"loss_rtol": 1e-5, "param_atol": 1e-4}
# slice 3's main path: GPT-2 small at full width through the port's
# train.py; only the sample counts and the epochs are cut
TRAIN_CONFIG = REPO / "pytorch_distributed_template_tpu_torch" / "configs" \
    / "gpt2_small_train.json"
TRAIN_SETS = [("train_loader;args;n", 256), ("valid_loader;args;n", 64),
              ("trainer;epochs", 2), ("trainer;save_period", 1)]
# resumed epoch 2 against the uninterrupted one, bf16: the same batches,
# dropout masks and updates; the embedding gradient's scatter-add may sum
# in another order, which the relative 1e-3 covers
RESUME_RTOL = 1e-3


def _grad_error(got, ref, dtype):
    """(max abs err, max(err - limit)): the check passes when the second
    is <= 0."""
    a, r = BWD_TOL[dtype]
    ref = ref.float()
    err = (got.float() - ref).abs()
    limit = a * ref.abs().max() + r * ref.abs() + 1e-5
    return err.max().item(), (err - limit).max().item()


def _sdpa_bwd_ms(q, k, v, g, causal: bool, window: int, reps: int):
    """Time of the backward of one ``scaled_dot_product_attention`` call on
    the same inputs (yardstick only; the port never calls it)."""
    import torch.nn.functional as F

    leaves, kw = _sdpa_args(q, k, v, causal, window)
    qt, kt, vt = (x.requires_grad_() for x in leaves)
    out = F.scaled_dot_product_attention(qt, kt, vt, **kw)
    gt = g.transpose(1, 2).contiguous()
    ms = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                             retain_graph=True), reps)
    del out
    return ms


def phase_bwd_kernel(shapes=None) -> list:
    """B2 and B3 against the plain backward on the card: max errors, the
    arm, kernel / plain / SDPA-backward times and the card's bound per
    kernel, one row each per shape, and a ``flash_bwd_pair`` row per shape
    (``flash_attention_bwd`` whole: B3 with delta, then B2) whose bound is
    the whole backward's, each product and array counted once. Returns
    the kernels' rows, then the pairs'."""
    from pytorch_distributed_template_tpu_torch.ops import flash

    gen = torch.Generator(device="cuda").manual_seed(3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, pairs = [], []
    for (name, b, h, kvh, t, d, causal, window, dtype,
         with_lse) in (shapes or BWD_SHAPES):
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.float32)

        q = rnd(b, t, h, d).to(dtype)
        k, v = rnd(b, t, kvh, d).to(dtype), rnd(b, t, kvh, d).to(dtype)
        g = rnd(b, t, h, d).to(dtype)
        g_lse = rnd(b, h, t) if with_lse else None
        out, lse = flash.flash_attention_lse(q, k, v, causal=causal,
                                             window=window)
        got = flash.flash_attention_bwd(q, k, v, out, lse, g, causal,
                                        window, g_lse)
        torch.cuda.synchronize()
        ref = flash.flash_attention_bwd_ref(
            q.float(), k.float(), v.float(), out.float(), lse, g.float(),
            causal=causal, window=window, g_lse=g_lse)
        errs = {}
        for gname, x, want in zip(("dq", "dk", "dv"), got, ref):
            if not torch.isfinite(x).all():
                raise AssertionError(f"B2/B3 {name}: non-finite {gname}")
            err, excess = _grad_error(x, want, dtype)
            if excess > 0:
                raise AssertionError(
                    f"flash backward disagrees with its plain version at "
                    f"{name}: {gname} max err {err:.3e} exceeds the limit "
                    f"by {excess:.3e} (tol {BWD_TOL[dtype]} + 1e-5)")
            errs[gname] = err
        del got, ref
        reps = 20
        arm = "wgmma" if dtype == torch.bfloat16 else "cuda_cores"
        splits = 1 if arm == "cuda_cores" else flash.bwd_splits(
            b, t, h, kvh, causal, window, sms)
        # B3 alone writes delta, which B2 alone then reads
        delta = torch.empty((b, h, t), dtype=torch.float32, device="cuda")
        args = (q, k, v, out, g, lse, g_lse, causal, window)
        ms = {kern: cuda_ms(lambda kern=kern: flash._flash_bwd_cuda(
            *args, kernels=(kern,), delta=delta), reps)
            for kern in flash.BWD_KERNELS}
        pair_ms = cuda_ms(lambda: flash.flash_attention_bwd(
            q, k, v, out, lse, g, causal, window, g_lse), reps)
        plain_ms = cuda_ms(lambda: flash.flash_attention_bwd_ref(
            q, k, v, out, lse, g, causal, window, g_lse), 3, warmup=1)
        library_ms = _sdpa_bwd_ms(q, k, v, g, causal, window, reps)
        head = {"shape": name, "B": b, "H": h, "KVH": kvh, "T": t, "D": d,
                "causal": causal, "window": window,
                "dtype": str(dtype).replace("torch.", ""),
                "lse_cotangent": with_lse, "arm": arm,
                "tol": list(BWD_TOL[dtype]), "ref_ms": plain_ms,
                "library_ms": library_ms,
                "plain": "flash_attention_bwd_ref (dq, dk, dv together)",
                "library": "backward of scaled_dot_product_attention "
                           "(dq, dk, dv together)"}
        bounds = {}
        for kern, gnames in (("flash_bwd_dkv", ("dk", "dv")),
                             ("flash_bwd_dq", ("dq",))):
            bounds[kern] = flash.flash_bwd_bound_seconds(
                kern, b, t, h, kvh, d, causal, window, q.element_size(),
                PEAK_FLOPS[dtype], PEAK_BYTES, lse_cotangent=with_lse)
            row = {"kernel": kern, **head,
                   "max_abs_err": max(errs[n] for n in gnames),
                   "kernel_ms": ms[kern], "bound_ms": bounds[kern][0] * 1e3,
                   "bound_by": bounds[kern][1]}
            if kern == "flash_bwd_dkv":
                row["splits"] = splits
            rows.append(with_ratios(row))
            log("[bwd] " + json.dumps(row))
        pair_bound = flash.flash_bwd_bound_seconds(
            "flash_bwd_pair", b, t, h, kvh, d, causal, window,
            q.element_size(), PEAK_FLOPS[dtype], PEAK_BYTES,
            lse_cotangent=with_lse)
        pair = {"kernel": "flash_bwd_pair", **head,
                "max_abs_err": max(errs.values()), "kernel_ms": pair_ms,
                "bound_ms": pair_bound[0] * 1e3, "bound_by": pair_bound[1],
                "splits": splits}
        pairs.append(with_ratios(pair))
        log("[bwd] " + json.dumps(pair))
        del q, k, v, g, out, lse, delta
        torch.cuda.empty_cache()
    flash.FLASH_BWD_DKV.launches = flash.FLASH_BWD_DQ.launches = 0
    flash.FLASH_FWD.launches = 0
    return rows + pairs


def _train_ref_run(name, args, state, batches, device):
    """``TRAIN_REF_STEPS`` AdamW steps of a ``name`` model on ``device``
    from ``state``: (per-step losses, final params on the CPU)."""
    import pytorch_distributed_template_tpu_torch.models  # noqa: F401
    from pytorch_distributed_template_tpu_torch.config.registry import (
        MODELS,
    )
    from pytorch_distributed_template_tpu_torch.engine import (
        losses, optim, steps,
    )

    model = MODELS.get(name)(**args, device=device,
                             param_dtype=torch.float32)
    model.load_state_dict(state)
    opt = optim.OPTIMIZERS.get("AdamW")(
        model, lr=1e-3, betas=(0.9, 0.95), weight_decay=0.1,
        weight_decay_exclude=["bias$", "ln_", "wpe", "norm"])
    crit = (losses.fused_lm_cross_entropy(16) if args.get("fused_head")
            else losses.lm_cross_entropy)
    step = steps.make_train_step(model, opt, crit, input_key="tokens",
                                 target_key="tokens", grad_clip_norm=1.0)
    out = []
    for batch in batches:
        m = step({k: torch.from_numpy(v).to(device)
                  for k, v in batch.items()})
        out.append(float(m["loss_sum"]) / float(m["count"]))
    return out, {k: v.detach().cpu() for k, v in model.state_dict().items()}


def phase_train_reference(device="cuda") -> None:
    """Small f32 GPT2 (flash, fused head, remat) and windowed GQA Llama
    (flash) trained ``TRAIN_REF_STEPS`` steps on ``device`` (kernels) and on
    the CPU (plain versions) from the same converted weights and batches:
    per-step losses and final params within ``TRAIN_REF_TOL``."""
    import pytorch_distributed_template_tpu_torch.models  # noqa: F401
    from pytorch_distributed_template_tpu_torch.config.registry import (
        MODELS,
    )
    from pytorch_distributed_template_tpu_torch.data.datasets import (
        synthetic_lm,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, args in TRAIN_REF.items():
        cpu = MODELS.get(name)(**args, device="cpu")
        cpu.init_weights(torch.Generator().manual_seed(7))
        state = cpu.state_dict()
        toks = synthetic_lm(n=4 * TRAIN_REF_STEPS, seq_len=args["max_len"],
                            vocab_size=args["vocab_size"], seed=1)["tokens"]
        batches = [{"tokens": toks[4 * i:4 * i + 4],
                    "mask": np.ones(4, bool)}
                   for i in range(TRAIN_REF_STEPS)]
        dev_loss, dev_p = _train_ref_run(name, args, state, batches, device)
        cpu_loss, cpu_p = _train_ref_run(name, args, state, batches, "cpu")
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(dev_loss,
                                                           cpu_loss))
        param_err = max((dev_p[k] - cpu_p[k]).abs().max().item()
                        for k in cpu_p)
        row = {"model": name, "steps": TRAIN_REF_STEPS,
               "losses_device": dev_loss, "losses_cpu": cpu_loss,
               "loss_max_rel_err": loss_err, "param_max_abs_err": param_err,
               "tol": TRAIN_REF_TOL, "device": str(device)}
        log("[train-reference] " + json.dumps(row))
        if not (loss_err <= TRAIN_REF_TOL["loss_rtol"]
                and param_err <= TRAIN_REF_TOL["param_atol"]):
            raise AssertionError(f"small f32 {name} training on {device} "
                                 f"differs from the CPU: {row}")


TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                 "expert_ffn")


class TrainRun:
    """Wraps a trainer's train and eval steps: counts the kernels'
    launches of each step from 0 and checks them exactly (a train step: B1
    n_layer, twice that with remat, B2 and B3 n_layer each, B5 once per
    MoE layer, all of it once per microbatch with ``grad_accum_steps``;
    an eval step: B1 n_layer, B5 once per MoE layer, no B2/B3),
    times each step (host clock to ``cuda.synchronize``) and keeps its
    loss.

    With ``warns`` (the list of a ``warnings.catch_warnings(record=True)``
    around the run) it also counts the synchronising calls of each train
    step with ``torch.cuda.set_sync_debug_mode("warn")`` on everywhere but
    in its own ``cuda.synchronize`` calls: a step's count covers the step
    and the trainer's loop work up to the next step (flight record, spans,
    health, logging), and so does its iteration time (from one step's
    start to the next's). :meth:`steady` reads both over the steady-state
    non-log steps (not the run's first step, not an epoch's last)."""

    def __init__(self, trainer, device, card: str, label: str, warns=None):
        from pytorch_distributed_template_tpu_torch.observability.profiler \
            import train_step_flops
        from pytorch_distributed_template_tpu_torch.ops import (
            expert_ffn, flash,
        )

        self.counters = (flash.FLASH_FWD, flash.FLASH_BWD_DKV,
                         flash.FLASH_BWD_DQ, expert_ffn.EXPERT_FFN)
        self.device, self.card, self.label = device, card, label
        self.launches = [0] * len(self.counters)
        self.steps, self.epoch_logs = [], []
        model = trainer.model
        layers = model.n_layer
        # a pipelined trunk (stacked tensors) has no block modules
        blocks = getattr(model, "h", None) or getattr(model, "layers", ())
        moe = sum(hasattr(block, "moe") for block in blocks)
        fwd = 2 if model.remat else 1     # remat recomputes each forward
        k = trainer.train_step.grad_accum_steps   # microbatches per step
        # an attention off the flash kernels (``xla``, the pipelined
        # trunk's einsum attention) launches none
        attn = layers if "flash" in getattr(model, "attn_impl", "") else 0
        self.want = {"train": (k * fwd * attn, k * attn, k * attn,
                               k * fwd * moe),
                     "eval": (attn, 0, 0, moe)}
        loader = trainer.train_loader
        tokens = loader.arrays["tokens"].shape[1]
        self.tokens = loader.batch_size * tokens
        self.flops = train_step_flops(model, loader.batch_size, tokens)
        self.warns, self.log_step = warns, trainer.log_step
        self.marks = []   # per train step: (epoch, batch, start s, warns)
        self._epoch, self._batch = 0, 0
        trainer.train_step = self._wrap(trainer.train_step, "train")
        trainer.eval_step = self._wrap(trainer.eval_step, "eval")
        real_epoch = trainer._train_epoch

        def epoch(e):
            self._epoch, self._batch = e, 0
            out = real_epoch(e)
            self.epoch_logs.append(dict(out, epoch=e))
            log(f"[train] ({self.label}) epoch " + json.dumps(
                dict(out, epoch=e, card=card)))
            return out

        trainer._train_epoch = epoch

    def _wrap(self, fn, kind):
        """``fn`` counted and timed; other attributes (the train step's
        ``state_dict`` for checkpoints) pass through."""
        is_cuda = torch.device(self.device).type == "cuda"

        def mode(on: bool) -> None:
            # counting ends with the run (``warns`` set to None after it)
            if is_cuda and self.warns is not None:
                torch.cuda.set_sync_debug_mode("warn" if on else 0)

        def call(batch):
            mode(False)
            if kind == "train":
                self.marks.append((self._epoch, self._batch,
                                   time.perf_counter(),
                                   len(self.warns or ())))
                self._batch += 1
            _sync(self.device)
            for c in self.counters:
                c.launches = 0
            if is_cuda:
                torch.cuda.reset_peak_memory_stats()
            mode(True)
            t0 = time.perf_counter()
            m = fn(batch)
            mode(False)
            _sync(self.device)
            secs = time.perf_counter() - t0
            got = tuple(c.launches for c in self.counters)
            if got != self.want[kind]:
                raise AssertionError(
                    f"({self.label}) a {kind} step launched "
                    f"{TRAIN_KERNELS} = {got}, not {self.want[kind]}")
            self.launches = [a + b for a, b in zip(self.launches, got)]
            if kind == "train":
                loss = float(m["loss_sum"]) / max(float(m["count"]), 1.0)
                peak = torch.cuda.max_memory_allocated() if is_cuda else 0
                row = {"step": len(self.steps), "loss": loss,
                       "ms": secs * 1e3, "tokens_per_s": self.tokens / secs,
                       "mfu": self.flops / secs / PEAK_FLOPS[torch.bfloat16],
                       "peak_mem_gib": peak / 2 ** 30}
                self.steps.append(row)
                log(f"[train] ({self.label}) step " + json.dumps(row))
            mode(True)
            return m

        return _Wrapped(fn, call)

    def steady(self) -> dict:
        """Over the steady-state non-log train steps: the median
        iteration ms (a step's start to the next step's, the loop's work
        included) and the synchronising calls per step (mean and max);
        the first step of the run and each epoch's last have no window."""
        iters, syncs = [], []
        for (e0, b0, t0, n0), (e1, _, t1, n1) in zip(self.marks[1:],
                                                      self.marks[2:]):
            if e0 == e1 and b0 % self.log_step != 0:
                iters.append((t1 - t0) * 1e3)
                syncs.append(n1 - n0)
        return {"steps": len(iters),
                "iter_ms_median": float(np.median(iters)) if iters else None,
                "syncs_per_step_mean": (float(np.mean(syncs)) if syncs
                                        else None),
                "syncs_per_step_max": max(syncs) if syncs else None}


def _loop_spans(trainer) -> dict:
    """Medians over the steady non-log train steps of ``trace.json``'s
    spans: ``data/next_batch`` (waiting for the batch), ``train/step``
    (the step, with :class:`TrainRun`'s syncs) and the loop's own work from
    a step's end to the next batch's wait (records, health, spans), per
    step of one epoch."""
    path = trainer.config.log_dir / "trace.json"
    if not path.is_file():
        return {}
    events = json.loads(path.read_text())["traceEvents"]
    steps = sorted((e for e in events if e["name"] == "train/step"),
                   key=lambda e: e["ts"])
    waits = sorted((e for e in events if e["name"] == "data/next_batch"),
                   key=lambda e: e["ts"])
    parts = {"wait": [], "step": [], "loop": []}
    for e, nxt in zip(steps, steps[1:]):
        batch = e["args"]["step"] % trainer.len_epoch
        if (nxt["args"]["step"] != e["args"]["step"] + 1 or batch == 0
                or batch % trainer.log_step == 0):
            continue
        end = e["ts"] + e["dur"]
        wait = next((w for w in waits if end <= w["ts"] < nxt["ts"]), None)
        if wait is None:
            continue
        before = [w for w in waits if w["ts"] < e["ts"]]
        parts["wait"].append(before[-1]["dur"] / 1e3 if before else 0.0)
        parts["step"].append(e["dur"] / 1e3)
        parts["loop"].append((wait["ts"] - end) / 1e3)
    if not parts["step"]:
        return {}
    return {f"span_{k}_ms_median": float(np.median(v))
            for k, v in parts.items()}


class _Wrapped:
    def __init__(self, inner, call):
        self._inner, self._call = inner, call

    def __call__(self, batch):
        return self._call(batch)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def phase_train(card: str, device="cuda", config=TRAIN_CONFIG,
                sets=TRAIN_SETS, work=WORK, seed: int = 0,
                keep=None) -> dict:
    """Slice 3's main path: the port's ``train.py`` with the GPT-2 small
    config at full width (only sample counts and epochs cut), exact launch
    counts per step, losses finite and falling, checkpoints and summary
    written, a resume from ``checkpoint-epoch1`` reproducing epoch 2, then
    a profile of 5 train steps. ``keep``: a directory that receives
    ``checkpoint-epoch1/model.pt`` and the run's ``config.json`` (phase
    16f's base, phase 21b's checkpoint). Returns the path's launches per
    kernel."""
    def check(trainer, run):
        if keep is not None:
            dst = Path(keep) / "checkpoint-epoch1"
            dst.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(trainer.config.save_dir / "checkpoint-epoch1"
                            / "model.pt", dst / "model.pt")
            shutil.copyfile(trainer.config.save_dir / "config.json",
                            Path(keep) / "config.json")

    return _train_path(card, device, config, sets, work / "train", seed,
                       check=check)


#: the steady-state numbers of each training path's main run, by label
PATH_STATS: dict = {}


def _train_path(card: str, device, config, sets, run_root, seed: int,
                label: str = "train", check=None,
                resume: bool = True, falling: bool = True) -> dict:
    """One training main path through the port's ``train.py`` (see
    :func:`phase_train`); ``check(trainer, run)`` runs after the main run,
    before the resume (``resume`` False: none; the checkpoints expected
    are those of the config's ``save_period``); ``run_root`` is removed at
    the end. ``falling`` False drops the falling-loss check (a fine-tune
    from trained weights). The main run's steady-state step numbers
    (:meth:`TrainRun.steady`) land in ``PATH_STATS[label]``."""
    import warnings

    from pytorch_distributed_template_tpu_torch import train as train_cli
    from pytorch_distributed_template_tpu_torch.observability.trace import (
        get_recorder,
    )

    if run_root.exists():
        shutil.rmtree(run_root)
    get_recorder().clear()   # this run's trace.json: this run's spans
    argv = ["-c", str(config), "-s", str(run_root / "main"), "--device",
            str(device), "--seed", str(seed)]
    for chain, value in sets:
        argv += ["--set", chain, json.dumps(value)]
    box = {}

    def hook(trainer):
        box["trainer"] = trainer
        box["run"] = TrainRun(trainer, device, card, "main", warns=warns)
        m = trainer.model
        moe = ""
        if getattr(m, "moe_experts", 0):
            mlp = next(b.moe for b in m.h if hasattr(b, "moe"))
            moe = (f", {m.moe_experts} experts top-{mlp.top_k} in every "
                   f"{m.moe_every}. block (capacity factor "
                   f"{mlp.capacity_factor})")
        log(f"[{label}] {type(m).__name__} on {trainer.device}: "
            f"{m.n_layer} layers, {m.n_head} heads, d_model {m.d_model}, "
            f"d_ff {m.d_ff}, vocab {m.vocab_size}, seq {m.max_len}, batch "
            f"{trainer.train_loader.batch_size}, {m.dtype}, remat "
            f"{m.remat}, {getattr(m, 'attn_impl', 'einsum trunk')}, fused "
            f"head {m.fused_head}, dropout {getattr(m, 'rate', 0.0)}{moe}, "
            f"{sum(p.numel() for p in m.parameters()) / 1e6:.2f} M params; "
            f"{len(trainer.train_loader)} steps per epoch; cuts: {sets}")

    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as warns:
        warnings.simplefilter("always")
        try:
            train_cli.main(argv, on_trainer=hook)
        finally:
            if torch.device(device).type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
    wall = time.perf_counter() - t0
    trainer, run = box["trainer"], box["run"]
    steady_stats = run.steady()
    run.warns = None
    losses = [r["loss"] for r in run.steps]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training losses: {losses}")
    head, tail = np.mean(losses[:5]), np.mean(losses[-5:])
    if falling and not tail < head:
        raise AssertionError(f"the loss did not fall: first 5 steps "
                             f"{head:.4f}, last 5 {tail:.4f}")
    monitored = trainer.mnt_metric if trainer.mnt_mode != "off" else "loss"
    for e in run.epoch_logs:
        if not np.isfinite(e.get(monitored, np.nan)):
            raise AssertionError(f"epoch {e['epoch']} logged no finite "
                                 f"{monitored}: {e}")
    run_dir = trainer.config.save_dir
    epochs = trainer.epochs
    saved = [run_dir / f"checkpoint-epoch{e}" / "model.pt"
             for e in range(1, epochs + 1) if e % trainer.save_period == 0]
    for path in saved + ([run_dir / "model_best" / "model.pt"] if saved
                         else []) + [run_dir / "summary.json"]:
        if not path.is_file():
            raise AssertionError(f"{path} was not written")
    summary = json.loads((run_dir / "summary.json").read_text())
    steady = run.steps[1:] or run.steps
    PATH_STATS[label] = {
        "ms_per_step_median": float(np.median([r["ms"] for r in steady])),
        **steady_stats, **_loop_spans(trainer)}
    log(f"[{label}] steady " + json.dumps(dict(PATH_STATS[label],
                                               card=card)))
    if check is not None:
        check(trainer, run)
    log(f"[{label}] " + json.dumps({
        "run": "main", "steps": len(run.steps), "epochs": epochs,
        "wall_s": wall, "loss_first5": head, "loss_last5": tail,
        "ms_per_step_median": float(np.median([r["ms"] for r in steady])),
        "tokens_per_s_median": float(np.median(
            [r["tokens_per_s"] for r in steady])),
        "mfu_median": float(np.median([r["mfu"] for r in steady])),
        "peak_mem_gib_max": max(r["peak_mem_gib"] for r in run.steps),
        "model_flops_per_step": run.flops,
        "launches": dict(zip(TRAIN_KERNELS, run.launches)),
        "summary": summary, "card": card}))

    launches = run.launches
    resume_box = {}
    if resume:
        # resume from the first epoch's checkpoint: epoch 2 again
        def resume_hook(trainer):
            resume_box["run"] = TrainRun(trainer, device, card, "resume")

        train_cli.main(["-r", str(run_dir / "checkpoint-epoch1"), "-s",
                        str(run_root / "resume"), "--device", str(device)],
                       on_trainer=resume_hook)
        resumed = resume_box["run"]
        if [e["epoch"] for e in resumed.epoch_logs] != list(
                range(2, epochs + 1)):
            raise AssertionError(
                f"the resumed run ran epochs "
                f"{[e['epoch'] for e in resumed.epoch_logs]}")
        again, first = resumed.epoch_logs[0], run.epoch_logs[1]
        keys = sorted({"loss", "val_loss", monitored})
        diffs = {k: abs(again[k] - first[k]) / abs(first[k]) for k in keys}
        log(f"[{label}] resume " + json.dumps({
            "epoch": 2, "uninterrupted": {k: first[k] for k in diffs},
            "resumed": {k: again[k] for k in diffs}, "rel_diff": diffs,
            "rtol": RESUME_RTOL}))
        if max(diffs.values()) > RESUME_RTOL:
            raise AssertionError(f"resume does not reproduce epoch 2: "
                                 f"{diffs}")
        launches = [a + b for a, b in zip(run.launches, resumed.launches)]

    # where a train step's time goes (outside the counted runs)
    batches = [trainer._to_device(b) for b, _ in zip(
        trainer.train_loader, range(5))]
    row = _profiled(lambda: [trainer.train_step(b) for b in batches],
                    device, top_n=12, sums=("flash_bwd_dkv", "flash_bwd_dq"))
    per_step = {f"{k}_per_step": row[f"{k}_ms"] / len(batches)
                for k in ("flash_bwd_dkv", "flash_bwd_dq")}
    log("[profile] " + json.dumps({"profile": f"{label}_steps", "steps": 5,
                                   **row, **per_step, "card": card}))
    del trainer, box, resume_box, batches
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(run_root)
    return dict(zip(TRAIN_KERNELS, launches))


# ---------------------------------------------------------------------------
# slice 4: MoE LM training, kernel B5
# ---------------------------------------------------------------------------

FFN_SOURCE = "pytorch_distributed_template_tpu_torch/csrc/expert_ffn.cu"
FFN_REPLACES = "scripts/debug_moe_pallas_ffn.py:46"
# (name, E, C, D, F, biases, dtype): the MoE main path's shape (E 8, C =
# ceil(2 x 16384 x 1.25 / 8) = 5120, D 512, F 1024, MoeMlp's biases), the
# TPU probe's own shape (scripts/debug_moe_pallas_ffn.py, no biases), a
# ragged capacity (C not a multiple of the kernel's row tile) and a small
# f32 case (the CUDA-core arm)
FFN_SHAPES = [
    ("moelm_main", 8, 5120, 512, 1024, True, torch.bfloat16),
    ("probe", 8, 2560, 768, 1536, False, torch.bfloat16),
    ("ragged", 4, 1000, 256, 512, True, torch.bfloat16),
    ("f32", 4, 77, 64, 128, True, torch.float32),
]
# |got - ref| <= a max|ref| + b against the plain version on the same
# inputs. bf16 (0.01, 1e-4): the probe's own gate; both sides round the
# hidden and the output to bf16, and a hidden value whose f32 sum lands on
# the other side of a rounding boundary moves the output by ~2^-8 of one
# term. f32 (1e-4, 1e-5): summation order only.
FFN_TOL = {torch.bfloat16: (0.01, 1e-4), torch.float32: (1e-4, 1e-5)}
# phase 3d: a small f32 TinyMoeLM, head_dim 64 so the flash kernels take
# it; capacity factor 0.5 drops tokens; the last example of every batch
# is padding
MOE_REF = {"vocab_size": 256, "n_layer": 2, "n_head": 2, "d_model": 128,
           "d_ff": 256, "max_len": 64, "num_experts": 4, "top_k": 2,
           "capacity_factor": 0.5, "aux_loss_weight": 0.01,
           "attn_impl": "flash", "fused_head": True}
# slice 4's main path: the repository's MoE config at full width through the
# port's train.py; only the corpus size (a few MB of the standard library),
# the epochs and the checkpoint period are cut
MOE_CONFIG = REPO / "configs" / "moelm_stdlib.json"
# 1 MB since slice 11 (2 MB before): the script's time limit
MOE_CORPUS_MB = 1.0
# the health summary and the flight recorder, on by default, turned off as
# in phase 6's config: slice 4's path runs the step it ran before slice 6
MOE_SETS = [("trainer;epochs", 2), ("trainer;save_period", 1),
            ("trainer;health", {"enabled": False}),
            ("trainer;telemetry", {"enabled": False})]


def _ffn_library(x, wi, wo, bi, bo):
    """The cuBLAS yardstick, three PyTorch calls: bmm (baddbmm with the
    bias) -> tanh-gelu -> bmm (baddbmm). Timed only; the port never calls
    it."""
    import torch.nn.functional as F

    h = torch.bmm(x, wi) if bi is None else torch.baddbmm(bi[:, None], x, wi)
    h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, wo) if bo is None else torch.baddbmm(bo[:, None], h,
                                                             wo)


def phase_expert_ffn_kernel(shapes=None) -> list:
    """B5 against its plain version on the card: max error, kernel /
    plain / library times and the card's bound, one row per shape
    (``FFN_SHAPES`` by default)."""
    from pytorch_distributed_template_tpu_torch.ops import expert_ffn as ffn

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    lib = ffn.EXPERT_FFN.load()
    rows = []
    for name, e, c, d, f, bias, dtype in (shapes or FFN_SHAPES):
        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device="cuda")
                    * scale).to(dtype)

        # the probe's inputs: x ~ N(0, 1), weights ~ N(0, 0.02^2)
        x, wi, wo = rnd(e, c, d), rnd(e, d, f, scale=0.02), rnd(
            e, f, d, scale=0.02)
        bi = rnd(e, f, scale=0.1) if bias else None
        bo = rnd(e, d, scale=0.1) if bias else None
        args = (x, wi, wo, bi, bo)
        out = ffn.expert_ffn(*args)
        torch.cuda.synchronize()
        ref = ffn.expert_ffn_ref(*args).float()
        if not torch.isfinite(out).all():
            raise AssertionError(f"B5 {name}: non-finite output")
        err = (out.float() - ref).abs().max().item()
        a, b = FFN_TOL[dtype]
        limit = a * ref.abs().max().item() + b
        if err > limit:
            raise AssertionError(
                f"expert_ffn disagrees with its plain version at {name}: "
                f"max err {err:.3e} > {limit:.3e}")
        del out, ref
        kernel_ms = cuda_ms(lambda: ffn._expert_ffn_cuda(*args), 20)
        ref_ms = cuda_ms(lambda: ffn.expert_ffn_ref(*args), 5, warmup=1)
        library_ms = cuda_ms(lambda: _ffn_library(*args), 20)
        bound_s, bound_by = ffn.expert_ffn_bound_seconds(
            e, c, d, f, x.element_size(), bias, PEAK_FLOPS[dtype],
            PEAK_BYTES)
        row = {"shape": name, "E": e, "C": c, "D": d, "F": f,
               "biases": bias, "dtype": str(dtype).replace("torch.", ""),
               "rows_per_tile": lib.pdt_expert_ffn_rows(
                   d, ffn._DTYPE_CODES[dtype]),
               "max_abs_err": err, "limit": limit,
               "kernel_ms": kernel_ms, "ref_ms": ref_ms,
               "library_ms": library_ms, "bound_ms": bound_s * 1e3,
               "bound_by": bound_by,
               "plain": "expert_ffn_ref (f32 bmm, gelu, f32 bmm)",
               "library": "3 calls: bmm/baddbmm -> gelu(tanh) -> "
                          "bmm/baddbmm (cuBLAS, same dtype)"}
        rows.append(with_ratios(row))
        log("[ffn] " + json.dumps(row))
        del x, wi, wo, bi, bo, args
        torch.cuda.empty_cache()
    ffn.EXPERT_FFN.launches = 0
    return rows


def phase_moe_train_reference(device="cuda") -> None:
    """A small f32 TinyMoeLM (``MOE_REF``) trained ``TRAIN_REF_STEPS``
    steps on ``device`` (kernels B1-B3, B5) and on the CPU (plain
    versions) from the same weights and batches, one padded example in
    each: per-step losses (the aux loss included) and final params within
    ``TRAIN_REF_TOL``."""
    import pytorch_distributed_template_tpu_torch.models  # noqa: F401
    from pytorch_distributed_template_tpu_torch.config.registry import (
        MODELS,
    )
    from pytorch_distributed_template_tpu_torch.data.datasets import (
        synthetic_lm,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = MODELS.get("TinyMoeLM")(**MOE_REF, device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(8))
    state = {k: v.clone() for k, v in cpu.state_dict().items()}
    toks = synthetic_lm(n=4 * TRAIN_REF_STEPS, seq_len=MOE_REF["max_len"],
                        vocab_size=MOE_REF["vocab_size"], seed=2)["tokens"]
    mask = np.array([True, True, True, False])
    batches = [{"tokens": toks[4 * i:4 * i + 4], "mask": mask}
               for i in range(TRAIN_REF_STEPS)]
    dev_loss, dev_p = _train_ref_run("TinyMoeLM", MOE_REF, state, batches,
                                     device)
    cpu_loss, cpu_p = _train_ref_run("TinyMoeLM", MOE_REF, state, batches,
                                     "cpu")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(dev_loss, cpu_loss))
    param_err = max((dev_p[k] - cpu_p[k]).abs().max().item() for k in cpu_p)
    row = {"model": "TinyMoeLM", "steps": TRAIN_REF_STEPS,
           "losses_device": dev_loss, "losses_cpu": cpu_loss,
           "loss_max_rel_err": loss_err, "param_max_abs_err": param_err,
           "tol": TRAIN_REF_TOL, "device": str(device)}
    log("[moe-reference] " + json.dumps(row))
    if not (loss_err <= TRAIN_REF_TOL["loss_rtol"]
            and param_err <= TRAIN_REF_TOL["param_atol"]):
        raise AssertionError(f"small f32 TinyMoeLM training on {device} "
                             f"differs from the CPU: {row}")


def phase_moe_train(card: str, device="cuda", config=MOE_CONFIG,
                    sets=MOE_SETS, corpus_mb: float = MOE_CORPUS_MB,
                    work=WORK, seed: int = 0, keep=None) -> dict:
    """Slice 4's main path: a corpus of ``corpus_mb`` MB from the port's
    ``tools/make_text_corpus.py``, then :func:`_train_path` with the MoE
    config reading it. ``keep``: where the trained model goes
    (:func:`keep_run`; phase 21d serves it). Returns the path's launches
    per kernel."""
    from pytorch_distributed_template_tpu_torch.tools import (
        make_text_corpus,
    )

    data_dir = work / "moe_data"
    info = make_text_corpus.build(data_dir / "pystdlib.txt",
                                  int(corpus_mb * 1e6))
    log(f"[moe] corpus: {info['files']} files, {info['bytes']} bytes from "
        f"{info['source']}")
    sets = list(sets) + [(f"{split};args;data_dir", str(data_dir))
                         for split in ("train_loader", "valid_loader")]
    launches = _train_path(card, device, config, sets, work / "moe_train",
                           seed, label="moe",
                           check=None if keep is None else (
                               lambda trainer, run: keep_run(trainer, keep)))
    shutil.rmtree(data_dir)
    return launches


# ---------------------------------------------------------------------------
# slice 5: the source paper's main path (LeNet/MNIST, DDP over NCCL); no TPU
# kernel runs on it (convs, pools and dense layers are cuDNN/cuBLAS)
# ---------------------------------------------------------------------------

# PyTorch's own TF32 settings, read before any phase changes them: the main
# path runs with these; phase 8 turns TF32 off for its comparison only
TF32_DEFAULTS = {"matmul": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn": torch.backends.cudnn.allow_tf32}
MNIST_DEBUG = REPO / "configs" / "mnist_debug.json"
MNIST_CONFIG = REPO / "configs" / "mnist.json"
# phase 8: one epoch of mnist_debug (8 steps of 64) in f32 on the card and
# on the CPU from the same weights, dropout off: per-step losses rtol 1e-5
# and final params atol 1e-4, as TRAIN_REF_TOL (summation order only,
# with TF32 off: cuDNN's TF32 convs would move the losses by ~1e-3)
LENET_REF_SETS = [("trainer;epochs", 1), ("trainer;save_period", 10)]
# phase 9: configs/mnist.json (LeNet's full width, batch 128, TensorBoard
# on) cut to 5 of its 10 epochs since slice 15 (the script's time limit)
MNIST_SETS = [("trainer;epochs", 5)]
# the torchrun launch: mnist_debug for one epoch
TORCHRUN_SETS = [("trainer;epochs", 1)]
MNIST_MIN_VAL_ACC = 0.5          # chance is 0.1
MNIST_KEYS = ("loss", "accuracy", "top_k_acc", "val_loss", "val_accuracy",
              "val_top_k_acc")
TEST_RTOL = 1e-6


class _TF32:
    """Set cuBLAS's and cuDNN's TF32 switches for a block; restore after."""

    def __init__(self, matmul: bool, cudnn: bool):
        self.want = (matmul, cudnn)

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.want
        return {"matmul_tf32": self.want[0], "cudnn_tf32": self.want[1]}

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def _lenet_run(device, state, work, sets=LENET_REF_SETS):
    """One epoch of mnist_debug through the port's ``train.py`` on
    ``device`` from ``state``, dropout off: (per-step losses, final params
    on the CPU)."""
    from pytorch_distributed_template_tpu_torch import train as train_cli

    losses, box = [], {}

    def hook(trainer):
        box["trainer"] = trainer
        for mod in (trainer.model.Dropout_0, trainer.model.Dropout_1):
            mod.p = 0.0
        trainer.model.load_state_dict(state)
        inner = trainer.train_step

        def step(batch):
            m = inner(batch)
            losses.append(float(m["loss_sum"]) / float(m["count"]))
            return m

        trainer.train_step = _Wrapped(inner, step)

    argv = ["-c", str(MNIST_DEBUG), "-s", str(work), "--device",
            str(device), "--no-validate"]
    for chain, value in sets:
        argv += ["--set", chain, json.dumps(value)]
    train_cli.main(argv, on_trainer=hook)
    params = {k: v.detach().cpu()
              for k, v in box["trainer"].model.state_dict().items()}
    return losses, params


def phase_lenet_reference(device="cuda", work=WORK) -> None:
    """Phase 8: one epoch of ``configs/mnist_debug.json`` in f32 on
    ``device`` and on the CPU through the port's ``train.py``, from the
    same weights (a CPU LeNet drawn from seed 0) with dropout off: the
    per-step losses and final params within ``TRAIN_REF_TOL``, TF32 off
    on the card for this comparison only."""
    from pytorch_distributed_template_tpu_torch.models.lenet import LeNet

    cpu = LeNet(device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in cpu.state_dict().items()}
    root = work / "lenet_ref"
    with _TF32(False, False) as tf32:
        dev_loss, dev_p = _lenet_run(device, state, root / "device")
    cpu_loss, cpu_p = _lenet_run("cpu", state, root / "cpu")
    shutil.rmtree(root)
    if len(dev_loss) != len(cpu_loss) or not dev_loss:
        raise AssertionError(f"step counts differ: {len(dev_loss)} on "
                             f"{device}, {len(cpu_loss)} on the CPU")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(dev_loss, cpu_loss))
    param_err = max((dev_p[k] - cpu_p[k]).abs().max().item() for k in cpu_p)
    row = {"model": "LeNet", "config": "mnist_debug", "steps": len(dev_loss),
           "losses_device": dev_loss, "losses_cpu": cpu_loss,
           "loss_max_rel_err": loss_err, "param_max_abs_err": param_err,
           "tol": TRAIN_REF_TOL, "device": str(device),
           "device_run": tf32, "cpu_run": "float32 (no TF32 on the CPU)"}
    log("[lenet-reference] " + json.dumps(row))
    if not (loss_err <= TRAIN_REF_TOL["loss_rtol"]
            and param_err <= TRAIN_REF_TOL["param_atol"]):
        raise AssertionError(f"LeNet training on {device} differs from the "
                             f"CPU: {row}")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class MnistRun:
    """Hooks one run of the port's trainer: checks that it trains under
    ``DistributedDataParallel`` on a process group of ``backend``, counts
    DDP's gradient all-reduces with a communication hook (calls and bytes,
    per train step), and times each train step (host clock to
    ``cuda.synchronize``)."""

    def __init__(self, trainer, device, backend: str, label: str, card: str):
        import torch.distributed as tdist
        from torch.distributed.algorithms.ddp_comm_hooks import (
            default_hooks,
        )

        self.device, self.label, self.card = device, label, card
        self.backend = tdist.get_backend()
        if self.backend != backend:
            raise AssertionError(f"({label}) the process group runs "
                                 f"{self.backend}, not {backend}")
        ddp = trainer.ddp
        if not isinstance(ddp, torch.nn.parallel.DistributedDataParallel):
            raise AssertionError(f"({label}) the model is not wrapped in "
                                 f"DistributedDataParallel")
        self.allreduce = {"calls": 0, "bytes": 0}

        def counted(state, bucket):
            buf = bucket.buffer()
            state["calls"] += 1
            state["bytes"] += buf.numel() * buf.element_size()
            return default_hooks.allreduce_hook(None, bucket)

        ddp.register_comm_hook(self.allreduce, counted)
        self.steps, self.epoch_logs = [], []
        self.batch = trainer.train_loader.batch_size
        inner = trainer.train_step
        trainer.train_step = _Wrapped(inner, self._step(inner))
        real_epoch = trainer._train_epoch

        def epoch(e):
            out = real_epoch(e)
            self.epoch_logs.append(dict(out, epoch=e))
            log(f"[mnist] ({label}) epoch " + json.dumps(
                dict(out, epoch=e, card=card)))
            return out

        trainer._train_epoch = epoch

    def _step(self, inner):
        is_cuda = torch.device(self.device).type == "cuda"

        def call(batch):
            calls = self.allreduce["calls"]
            _sync(self.device)
            t0 = time.perf_counter()
            m = inner(batch)
            _sync(self.device)
            secs = time.perf_counter() - t0
            if self.allreduce["calls"] == calls:
                raise AssertionError(
                    f"({self.label}) a train step ran no gradient "
                    f"all-reduce through the DDP hook")
            self.steps.append({
                "loss": float(m["loss_sum"]) / max(float(m["count"]), 1.0),
                "ms": secs * 1e3, "examples_per_s": self.batch / secs,
                "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                                 if is_cuda else 0.0)})
            return m

        return call


def phase_mnist(card: str, device="cuda", config=MNIST_CONFIG,
                sets=MNIST_SETS, work=WORK, seed: int = 0,
                torchrun_sets=TORCHRUN_SETS) -> dict:
    """Phase 9, slice 5's main path: the port's ``train.py`` with
    ``configs/mnist.json`` (LeNet, Adam amsgrad, StepLR, batch 128, 10
    epochs; synthetic MNIST without idx files) in this process with the
    launcher's environment set for one rank, so ``dist.initialize`` builds
    an NCCL group (gloo on the CPU) and the trainer runs DDP. Checks the
    backend, the DDP wrapper and a gradient all-reduce in every step (a
    communication hook), finite and falling losses, validation accuracy
    well above chance, the checkpoints and summary, a resume from
    ``checkpoint-epoch1`` reproducing epoch 2 exactly, the port's
    ``test.py`` on ``model_best`` equal to the best epoch's validation
    (rtol ``TEST_RTOL``) with ``--save-outputs``; then ``torchrun``
    launches ``train.py`` on ``configs/mnist_debug.json`` for one epoch.
    Prints step time, examples/s, a 5-step profile, peak memory and the
    all-reduce calls and bytes per step. Returns the run's numbers."""
    import os

    from pytorch_distributed_template_tpu_torch import test as test_cli
    from pytorch_distributed_template_tpu_torch import train as train_cli
    from pytorch_distributed_template_tpu_torch.parallel import dist

    is_cuda = torch.device(device).type == "cuda"
    backend = "nccl" if is_cuda else "gloo"
    root = work / "mnist"
    if root.exists():
        shutil.rmtree(root)
    launch = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
              "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    saved_env = {k: os.environ.get(k) for k in launch}
    os.environ.update(launch)
    if is_cuda:
        torch.cuda.reset_peak_memory_stats()
    try:
        with _TF32(TF32_DEFAULTS["matmul"], TF32_DEFAULTS["cudnn"]) as tf32:
            out = _mnist_path(card, device, config, sets, root, seed,
                              backend, tf32, train_cli, test_cli)
    finally:
        dist.shutdown()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["torchrun"] = _torchrun(device, root / "torchrun", torchrun_sets)
    shutil.rmtree(root)
    log("[mnist] torchrun " + json.dumps(out["torchrun"]))
    return out


def _mnist_path(card, device, config, sets, root, seed, backend, tf32,
                train_cli, test_cli) -> dict:
    from pytorch_distributed_template_tpu_torch.parallel import dist

    argv = ["-c", str(config), "-s", str(root / "main"), "--device",
            str(device), "--seed", str(seed)]
    for chain, value in sets:
        argv += ["--set", chain, json.dumps(value)]
    box = {}

    def hook(trainer):
        box["trainer"] = trainer
        box["run"] = MnistRun(trainer, device, backend, "main", card)
        log(f"[mnist] {type(trainer.model).__name__} on {trainer.device} "
            f"under DDP ({box['run'].backend}, world "
            f"{dist.process_count()}): batch {trainer.train_loader.batch_size}, "
            f"{len(trainer.train_loader)} steps per epoch, "
            f"{trainer.train_loader.n_samples} training and "
            f"{trainer.valid_loader.n_samples} validation samples, "
            f"{trainer.epochs} epochs, optimizer "
            f"{type(trainer.optimizer).__name__}, TF32 {tf32}; cuts: {sets}")

    t0 = time.perf_counter()
    train_cli.main(argv, on_trainer=hook)
    wall = time.perf_counter() - t0
    trainer, run = box["trainer"], box["run"]
    losses = [r["loss"] for r in run.steps]
    if not losses or not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training losses: {losses}")
    head, tail = np.mean(losses[:5]), np.mean(losses[-5:])
    if not tail < head:
        raise AssertionError(f"the loss did not fall: first 5 steps "
                             f"{head:.4f}, last 5 {tail:.4f}")
    final = run.epoch_logs[-1]
    for e in run.epoch_logs:
        if not all(np.isfinite(e[k]) for k in MNIST_KEYS):
            raise AssertionError(f"epoch {e['epoch']} logged a non-finite "
                                 f"value: {e}")
    if not final["val_accuracy"] > MNIST_MIN_VAL_ACC:
        raise AssertionError(f"val_accuracy {final['val_accuracy']} is not "
                             f"above {MNIST_MIN_VAL_ACC}")
    run_dir = trainer.config.save_dir
    epochs = trainer.epochs
    for path in ([run_dir / f"checkpoint-epoch{e}" / "model.pt"
                  for e in range(1, epochs + 1)]
                 + [run_dir / "model_best" / "model.pt",
                    run_dir / "summary.json"]):
        if not path.is_file():
            raise AssertionError(f"{path} was not written")
    steady = run.steps[1:] or run.steps
    ms = float(np.median([r["ms"] for r in steady]))
    per_step = {"calls": run.allreduce["calls"] / len(run.steps),
                "bytes": run.allreduce["bytes"] / len(run.steps)}
    row = {"run": "main", "config": str(config.relative_to(REPO)),
           "backend": run.backend, "ddp": True, "steps": len(run.steps),
           "epochs": epochs, "wall_s": wall, "loss_first5": head,
           "loss_last5": tail, "final": final,
           "ms_per_step_median": ms,
           "examples_per_s_median": run.batch * 1e3 / ms,
           "peak_mem_gib_max": max(r["peak_mem_gib"] for r in run.steps),
           "allreduce_per_step": per_step, "tf32": tf32, "card": card}
    log("[mnist] " + json.dumps(row))

    # resume from the first epoch's checkpoint: epoch 2 again, exactly
    resume_box = {}

    def resume_hook(trainer):
        resume_box["run"] = MnistRun(trainer, device, backend, "resume",
                                     card)

    train_cli.main(["-r", str(run_dir / "checkpoint-epoch1"), "-s",
                    str(root / "resume"), "--device", str(device), "--set",
                    "trainer;epochs", "2"], on_trainer=resume_hook)
    again = resume_box["run"].epoch_logs
    if [e["epoch"] for e in again] != [2]:
        raise AssertionError(f"the resumed run ran epochs "
                             f"{[e['epoch'] for e in again]}")
    first = run.epoch_logs[1]
    diffs = {k: abs(again[0][k] - first[k]) for k in MNIST_KEYS}
    log("[mnist] resume " + json.dumps({
        "epoch": 2, "uninterrupted": {k: first[k] for k in MNIST_KEYS},
        "resumed": {k: again[0][k] for k in MNIST_KEYS},
        "abs_diff": diffs}))
    if max(diffs.values()) > 0:
        raise AssertionError(f"resume does not reproduce epoch 2: {diffs}")

    # the port's test.py on model_best: the best epoch's validation
    best = min(run.epoch_logs, key=lambda e: e["val_loss"])
    dump = root / "outputs"
    result = test_cli.main(["-r", str(run_dir / "model_best"), "-s",
                            str(root / "test"), "--device", str(device),
                            "--save-outputs", str(dump)])
    errs = {k: abs(result[k] - best[f"val_{k}"]) / abs(best[f"val_{k}"])
            for k in ("loss", "accuracy", "top_k_acc")}
    rows = {name: np.load(dump / f"{name}_p0.npy").shape
            for name in ("outputs", "targets")}
    n_test = trainer.valid_loader.n_samples
    log("[mnist] test.py " + json.dumps({
        "best_epoch": best["epoch"], "test": result,
        "rel_err_vs_best_val": errs, "rtol": TEST_RTOL,
        "saved_rows": {k: list(v) for k, v in rows.items()}}))
    if max(errs.values()) > TEST_RTOL:
        raise AssertionError(f"test.py differs from the best epoch's "
                             f"validation: {errs}")
    if rows["outputs"] != (n_test, 10) or rows["targets"] != (n_test,):
        raise AssertionError(f"--save-outputs wrote {rows}, not {n_test} "
                             f"rows")

    # where a train step's time goes (outside the checked runs)
    batches = [trainer._to_device(b) for b, _ in zip(trainer.train_loader,
                                                     range(5))]
    inner = trainer.train_step._inner
    prof = _profiled(lambda: [inner(b) for b in batches], device, top_n=8)
    log("[profile] " + json.dumps({"profile": "mnist_steps", "steps": 5,
                                   **prof, "card": card}))
    row.update(profile=prof, resume_abs_diff=diffs, test=result)
    return row


def _torchrun(device, save_dir, sets, timeout: float = 600.0) -> dict:
    """``torchrun --standalone --nproc_per_node=1 -m
    pytorch_distributed_template_tpu_torch.train -c
    configs/mnist_debug.json`` (``torch.distributed.run``, the program
    behind ``torchrun``) in a subprocess: it must exit 0 and write its
    checkpoint."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1", "-m",
           "pytorch_distributed_template_tpu_torch.train", "-c",
           str(MNIST_DEBUG), "-s", str(save_dir), "--device", str(device)]
    for chain, value in sets:
        cmd += ["--set", chain, json.dumps(value)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=timeout)
    secs = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"torchrun exited {r.returncode}: "
                             f"{r.stdout[-2000:]}{r.stderr[-3000:]}")
    ckpts = sorted(save_dir.rglob("checkpoint-epoch1/model.pt"))
    if not ckpts:
        raise AssertionError(f"torchrun wrote no checkpoint under "
                             f"{save_dir}")
    return {"cmd": " ".join(cmd[1:]), "exit": r.returncode, "wall_s": secs,
            "checkpoint": str(ckpts[0].relative_to(save_dir))}


# ---------------------------------------------------------------------------
# slice 6: training observability, configs/gpt2_small.json as it is
# ---------------------------------------------------------------------------

# phase 10: the repository's GPT-2 small config with every key it has
# (compile_cache, TensorBoard, health, telemetry); the cuts, all by --set:
# the sample counts, the epochs and the checkpoint period as phase 6's, and
# the observability extras the config leaves at their defaults
OBS_CONFIG = REPO / "configs" / "gpt2_small.json"
OBS_SETS = [("train_loader;args;n", 256), ("valid_loader;args;n", 64),
            ("trainer;epochs", 2), ("trainer;save_period", 1),
            ("trainer;profiler", {"enabled": True, "trace_steps": 3}),
            ("trainer;watchdog_secs", 600),
            ("trainer;log_grad_norm", True)]
# the second run: one epoch with every gradient element NaN at step 24
NAN_STEP = 24
NAN_SETS = [("train_loader;args;n", 256), ("valid_loader;args;n", 64),
            ("trainer;epochs", 1), ("trainer;save_period", 1)]
# the train step's variants on the run's model, timed in turns: phase 6's
# (skip_nonfinite, clip, no health) against phase 10's (with the health
# summary and log_grad_norm)
STEP_VARIANTS = {
    "phase6": dict(skip_nonfinite=True),
    "phase10": dict(skip_nonfinite=True, health=True, log_grad_norm=True),
}
STEP_TURNS = ("phase6", "phase10", "phase10", "phase6")
STEP_TURN_STEPS = 8


def phase_observe(card: str, device="cuda", config=OBS_CONFIG,
                  sets=OBS_SETS, nan_sets=NAN_SETS, nan_step=NAN_STEP,
                  work=WORK, seed: int = 0) -> dict:
    """Phase 10, slice 6's main path: the port's ``train.py`` with
    ``configs/gpt2_small.json`` as it is, cut only by ``sets``. The checks
    of :func:`_train_path` (exact launch counts per step, losses finite
    and falling, checkpoints, summary, the resume reproducing epoch 2, a
    5-step profile), then: one flight record per train step in
    ``telemetry.jsonl`` (``loss``, ``lr``, ``grad_norm`` on log steps),
    ``trace.json``, a ``torch.profiler`` trace in ``profile/``, TB events
    or the backend's absence printed, ``grad_norm`` and ``mfu`` in the
    epoch logs; phase 6's and phase 10's train step timed in turns on the
    run's model (:func:`_step_variants`); the median ms/step, iteration ms and
    synchronising calls per non-log step beside phase 6's when phase 6 ran
    in this process, failing when phase 10 makes more; then the
    ``nan_grad`` run (:func:`_nan_run`). Returns the kernels' launches of
    both runs."""

    def check(trainer, run):
        _check_observability(trainer, run, device)
        _step_variants(trainer, device, card)

    launches = _train_path(card, device, config, sets, work / "observe",
                           seed, label="observe", check=check)
    six, ten = PATH_STATS.get("train"), PATH_STATS.get("observe")
    if six is not None:
        row = {"phase6": six, "phase10": ten,
               "overhead_ms": ten["ms_per_step_median"]
               - six["ms_per_step_median"],
               "overhead_pct": 100.0 * (ten["ms_per_step_median"]
                                        / six["ms_per_step_median"] - 1)}
        if six["iter_ms_median"] and ten["iter_ms_median"]:
            row["iter_overhead_ms"] = (ten["iter_ms_median"]
                                       - six["iter_ms_median"])
            row["iter_overhead_pct"] = 100.0 * (
                ten["iter_ms_median"] / six["iter_ms_median"] - 1)
        log("[observe] overhead " + json.dumps(dict(row, card=card)))
        if (six["syncs_per_step_mean"] is not None
                and ten["syncs_per_step_mean"]
                > six["syncs_per_step_mean"]):
            raise AssertionError(
                f"phase 10 makes more synchronising calls per non-log "
                f"train step than phase 6: {ten} against {six}")
    nan = _nan_run(card, device, config, nan_sets, nan_step,
                   work / "observe_nan", seed)
    return {k: launches[k] + nan[k] for k in launches}


def _check_observability(trainer, run, device) -> None:
    """The run directory's observability artifacts (see
    :func:`phase_observe`)."""
    run_dir = trainer.config.save_dir
    records = [json.loads(line) for line in
               (run_dir / "telemetry.jsonl").read_text().splitlines()]
    steps = sorted(r["step"] for r in records if "event" not in r)
    if steps != list(range(len(run.steps))):
        raise AssertionError(f"telemetry.jsonl has step records "
                             f"{steps}, not one per step of "
                             f"{len(run.steps)}")
    logged = [r for r in records if "loss" in r]
    if not logged or not all(
            {"loss", "lr", "grad_norm", "steps_per_sec"} <= set(r)
            for r in logged if r["step"] > 0):
        raise AssertionError(f"log-step records lack fields: {logged}")
    spans = {e["name"] for e in json.loads(
        (run_dir / "trace.json").read_text())["traceEvents"]}
    if not {"data/next_batch", "train/step", "train/log"} <= spans:
        raise AssertionError(f"trace.json spans: {sorted(spans)}")
    traces = sorted((run_dir / "profile").glob("*.pt.trace.json"))
    if not traces:
        raise AssertionError("no torch.profiler trace in profile/")
    events = sorted(run_dir.glob("events.out.tfevents.*"))
    backend = trainer.writer.selected_module
    if backend and not events:
        raise AssertionError(f"TensorBoard ({backend}) wrote no events")
    for e in run.epoch_logs:
        if not np.isfinite(e.get("grad_norm", np.nan)):
            raise AssertionError(f"epoch {e['epoch']} logged no finite "
                                 f"grad_norm: {e}")
        if torch.device(device).type == "cuda" and "mfu" not in e:
            raise AssertionError(f"epoch {e['epoch']} logged no mfu: {e}")
    memory = [r["devices"] for r in records if "devices" in r]
    log("[observe] artifacts " + json.dumps({
        "records": len(records), "step_records": len(steps),
        "log_records": len(logged), "events": sorted(
            {r["event"] for r in records if "event" in r}),
        "spans": sorted(spans), "profile_traces": len(traces),
        "profile_bytes": sum(t.stat().st_size for t in traces),
        "tensorboard": backend or "no backend (torch.utils.tensorboard "
                                  "and tensorboardX do not import)",
        "tb_event_files": len(events),
        "memory_record": memory[-1] if memory else None,
        "epoch_mfu": [e.get("mfu") for e in run.epoch_logs],
        "epoch_grad_norm": [e["grad_norm"] for e in run.epoch_logs]}))


def _step_variants(trainer, device, card: str) -> dict:
    """ms per train step of :data:`STEP_VARIANTS` on the run's model and
    optimizer, in :data:`STEP_TURNS`, each turn
    :data:`STEP_TURN_STEPS` steps issued back to back after a warm step,
    with one ``cuda.synchronize`` at the end (the clip of the config in
    every variant)."""
    from pytorch_distributed_template_tpu_torch.engine.steps import (
        make_train_step,
    )

    batches = [trainer._to_device(b) for b, _ in zip(
        trainer.train_loader, range(STEP_TURN_STEPS))]
    net = trainer.ddp if trainer.ddp is not None else trainer.model
    clip = trainer.config["trainer"].get("grad_clip_norm", 0.0)
    times = {}
    for name in STEP_TURNS:
        step = make_train_step(
            net, trainer.optimizer, trainer.criterion, trainer.metric_ftns,
            input_key=trainer.input_key, target_key=trainer.target_key,
            grad_clip_norm=clip, lr_fn=trainer.lr_fn,
            **STEP_VARIANTS[name])
        step(batches[0])
        _sync(device)
        t0 = time.perf_counter()
        for b in batches:
            step(b)
        _sync(device)
        times.setdefault(name, []).append(
            (time.perf_counter() - t0) * 1e3 / len(batches))
    row = {f"{k}_ms": float(np.mean(v)) for k, v in times.items()}
    row["turns"] = times
    log("[observe] step variants " + json.dumps(dict(row, card=card)))
    return row


def _nan_run(card: str, device, config, sets, nan_step: int, root,
             seed: int) -> dict:
    """One epoch of the config with ``nan_grad@step:<nan_step>``:
    ``anomaly_<step>.json`` written, the step skipped, the params finite,
    the per-group counts summing to the number of gradient elements, no
    ``model_best`` from the poisoned epoch. Returns the launches."""
    from pytorch_distributed_template_tpu_torch import train as train_cli

    if root.exists():
        shutil.rmtree(root)
    argv = ["-c", str(config), "-s", str(root), "--device", str(device),
            "--seed", str(seed)]
    for chain, value in [*sets, ("trainer;faults",
                                 f"nan_grad@step:{nan_step}")]:
        argv += ["--set", chain, json.dumps(value)]
    box = {}

    def hook(trainer):
        box["trainer"] = trainer
        box["run"] = TrainRun(trainer, device, card, "nan_grad")

    train_cli.main(argv, on_trainer=hook)
    trainer, run = box["trainer"], box["run"]
    run_dir = trainer.config.save_dir
    dump = run_dir / f"anomaly_{nan_step}.json"
    if not dump.is_file():
        raise AssertionError(f"{dump.name} was not written: "
                             f"{sorted(p.name for p in run_dir.iterdir())}")
    anomaly = json.loads(dump.read_text())
    summary = anomaly["summary"]
    groups = {k: v for k, v in summary.items() if k.startswith("nonfinite/")}
    elements = sum(p.numel() for p in trainer.model.parameters())
    finite = all(bool(torch.isfinite(p).all())
                 for p in trainer.model.parameters())
    skipped = run.epoch_logs[0].get("skipped", 0.0)
    row = {"anomaly": dump.name, "reasons": [r["kind"] for r in
                                             anomaly["reasons"]],
           "skipped": skipped, "params_finite": finite,
           "nonfinite_grads": summary["nonfinite_grads"],
           "gradient_elements": elements, "groups": len(groups),
           "update_norm": summary["update_norm"],
           "model_best": (run_dir / "model_best").exists(), "card": card}
    log("[observe] nan_grad " + json.dumps(row))
    if not (skipped > 0 and finite and sum(groups.values()) == elements
            == summary["nonfinite_grads"] and not row["model_best"]):
        raise AssertionError(f"the nan_grad run: {row}")
    launches = dict(zip(TRAIN_KERNELS, run.launches))
    del trainer, box
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(root)
    return launches


# ---------------------------------------------------------------------------
# slice 7: step-accurate resume and the supervisor (ROADMAP A17)
# ---------------------------------------------------------------------------

# phase 11: the repository's GPT-2 small config (phase 10's file) cut by
# --set to phase 6's sizes, with interval saves into the A/B slots every
# 16 batches, keep_last 1, two microbatches of 4 per step and an EMA
RES_CONFIG = REPO / "configs" / "gpt2_small.json"
RES_SETS = [("train_loader;args;n", 256), ("valid_loader;args;n", 64),
            ("trainer;epochs", 2), ("trainer;save_period", 1),
            ("trainer;save_interval_steps", 16), ("trainer;keep_last", 1),
            ("trainer;grad_accum_steps", 2), ("trainer;ema_decay", 0.999)]
# attempt 1 is killed before step 31 (epoch 1, batch 31), 15 steps (2.0 s
# at 136.5 ms a step) after the slot of batch 16 and with no slot between,
# so that slot's write (0.6-1.2 s) is done and attempt 2 must start at its
# batch; attempt 2 raises before step 46 (epoch 2, batch 14, before its
# batch-16 slot) and writes the emergency save; attempt 3 ends
RES_FAULTS = "kill@step:31;crash@step:46@attempt:2"
RES_TIMEOUT_S = 900
_INTERVAL_LINE = re.compile(
    r"Interval checkpoint: (\S+) \(the loop stopped ([\d.]+) ms; "
    r"written in ([\d.]+) s, (\d+) bytes\)")


def phase_resilience(card: str, device="cuda", config=RES_CONFIG,
                     sets=RES_SETS, faults=RES_FAULTS, work=WORK,
                     seed: int = 0) -> dict:
    """Phase 11, slice 7's main path: the config run once without a fault
    through the port's ``train.py`` (launches counted per step), then once
    through the port's ``supervise.py`` with ``PDT_FAULTS=faults``. Hard
    checks: 2 restarts, both ``crash``, a clean end; each attempt resumes
    at the newest checkpoint the one before it completed (the slot before
    the kill, when its write was done before the kill; the emergency save
    after the crash, so none of its steps is replayed); ``global_step``
    epochs x steps in the
    last sidecar; the last ``checkpoint-epochN``'s model, optimizer and
    EMA tensors bitwise equal to the uninterrupted run's; every logged
    loss equal at its step; ``keep_last`` 1 leaving no
    ``checkpoint-epoch1`` beside ``model_best``. Prints each interval
    save's stop of the loop and its write, each attempt's restart to its
    first step and the steps it replayed, beside the card line. Returns
    the uninterrupted run's launches."""
    from pytorch_distributed_template_tpu_torch import train as train_cli
    from pytorch_distributed_template_tpu_torch.resilience.supervisor \
        import read_supervisor_stats

    root = work / "resilience"
    if root.exists():
        shutil.rmtree(root)
    common = ["-c", str(config), "--device", str(device), "--seed",
              str(seed)]
    for chain, value in sets:
        common += ["--set", chain, json.dumps(value)]
    box = {}

    def hook(trainer):
        box["trainer"] = trainer
        box["run"] = TrainRun(trainer, device, card, "uninterrupted")

    # on the CPU both sides run one intra-op thread: a weight gradient's
    # GEMM splits its reduction over the threads MKL takes, and in its
    # dynamic mode MKL may take fewer than asked, in one process and not
    # in another, which changes the last bits (the card's runs are
    # deterministic as they are)
    on_cpu = torch.device(device).type == "cpu"
    child_env = dict(os.environ, PDT_FAULTS=faults)
    threads = torch.get_num_threads()
    if on_cpu:
        child_env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        torch.set_num_threads(1)
    t0 = time.perf_counter()
    try:
        train_cli.main(common + ["-s", str(root / "base")], on_trainer=hook)
    finally:
        torch.set_num_threads(threads)
    base_wall = time.perf_counter() - t0
    trainer, run = box["trainer"], box["run"]
    base = trainer.config.save_dir
    epochs, per_epoch = trainer.epochs, trainer.len_epoch
    interval = trainer.save_interval_steps
    k = trainer.train_step.grad_accum_steps
    saves = [dict(r) for r in trainer.ckpt_manager.interval_saves]
    launches = dict(zip(TRAIN_KERNELS, run.launches))
    log("[resilience] uninterrupted " + json.dumps({
        "steps": len(run.steps), "epochs": epochs, "wall_s": base_wall,
        "grad_accum_steps": k, "launches": launches,
        "launches_per_train_step": dict(zip(TRAIN_KERNELS,
                                            run.want["train"])),
        "ms_per_step_median": float(np.median(
            [r["ms"] for r in run.steps[1:] or run.steps])),
        "interval_saves": saves,
        "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn": torch.backends.cudnn.allow_tf32}, "card": card}))
    del trainer, run, box
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    events = root / "supervisor.jsonl"
    cmd = [sys.executable, "-m",
           "pytorch_distributed_template_tpu_torch.supervise",
           "--max-restarts", "3", "--restart-delay", "1", "--jitter", "0",
           "--events-file", str(events)] + common + [
               "-s", str(root / "supervised")]
    out_path = root / "supervised.log"
    t0 = time.perf_counter()
    with open(out_path, "w") as out:
        r = subprocess.run(cmd, cwd=REPO, env=child_env, stdout=out,
                           stderr=subprocess.STDOUT, timeout=RES_TIMEOUT_S)
    sup_wall = time.perf_counter() - t0
    output = out_path.read_text()
    if r.returncode != 0:
        raise AssertionError(f"the supervised run exited {r.returncode}: "
                             f"{output[-4000:]}")
    stats = read_supervisor_stats(events)
    if not (stats["restarts_total"] == 2 and stats["causes"] == {"crash": 2}
            and stats["clean"]):
        raise AssertionError(f"supervisor.jsonl: {stats}")
    attempts = _attempts(root / "supervised", events)
    if len(attempts) != 3:
        raise AssertionError(f"{len(attempts)} run directories for 3 "
                             f"attempts: {attempts}")
    for prev, att in zip(attempts, attempts[1:]):
        if att["first_step"] != prev["saved_step"]:
            raise AssertionError(
                f"attempt {att['attempt']} resumed at step "
                f"{att['first_step']}, not at the newest checkpoint that "
                f"attempt {prev['attempt']} completed (step "
                f"{prev['saved_step']})")
    slot = _pre_kill_slot(faults, interval, per_epoch)
    if attempts[1]["first_step"] != slot:
        raise AssertionError(
            f"attempt 2 started at step {attempts[1]['first_step']}, not "
            f"at the batch of the slot before the kill (step {slot})")
    if attempts[2]["replayed"] != 0:
        raise AssertionError(f"steps replayed after the emergency save: "
                             f"{attempts[2]['replayed']}")
    last = Path(attempts[-1]["run"])
    ds = json.loads((last / f"checkpoint-epoch{epochs}.data_state.json")
                    .read_text())
    if ds["global_step"] != epochs * per_epoch:
        raise AssertionError(f"the last sidecar: {ds}")
    compared = 0
    for name in ("model.pt", "optimizer.pt", "ema.pt"):
        want = torch.load(base / f"checkpoint-epoch{epochs}" / name,
                          map_location="cpu")
        got = torch.load(last / f"checkpoint-epoch{epochs}" / name,
                         map_location="cpu")
        compared += _assert_bitwise(got, want, name)
    base_losses = _logged_losses([base])
    sup_losses = _logged_losses([Path(a["run"]) for a in attempts])
    differ = {s: (v, base_losses.get(s)) for s, v in sup_losses.items()
              if base_losses.get(s) != v}
    if differ or len(sup_losses) < len(base_losses) // 2:
        raise AssertionError(f"logged losses differ from the "
                             f"uninterrupted run's: {differ}; "
                             f"{len(sup_losses)} of {len(base_losses)}")
    pruned = sorted(p.name for p in base.glob("checkpoint-epoch1*"))
    if pruned or not (base / "model_best").is_dir():
        raise AssertionError(f"keep_last 1: {pruned} left, model_best "
                             f"{(base / 'model_best').is_dir()}")
    child_saves = [{"slot": m.group(1).rsplit("/", 1)[-1],
                    "stop_ms": float(m.group(2)),
                    "write_s": float(m.group(3)), "bytes": int(m.group(4))}
                   for m in _INTERVAL_LINE.finditer(output)]
    log("[resilience] supervised " + json.dumps({
        "faults": faults, "restarts_total": stats["restarts_total"],
        "causes": stats["causes"], "clean": stats["clean"],
        "wall_s": sup_wall, "attempts": attempts,
        "last_data_state": ds, "interval_saves": child_saves,
        "card": card}))
    log("[resilience] check " + json.dumps({
        "bitwise_equal_tensors": compared,
        "losses_equal": len(sup_losses), "losses_uninterrupted":
        len(base_losses), "global_step": ds["global_step"],
        "model_best": True, "checkpoint_epoch1_pruned": True,
        "card": card}))
    shutil.rmtree(root)
    return launches


def _pre_kill_slot(faults: str, interval: int, per_epoch: int) -> int:
    """The global step of the newest checkpoint before the plan's
    ``kill@step:K``: the last interval slot (or epoch edge) of K's
    epoch at or before K."""
    kill = int(re.search(r"kill@step:(\d+)", faults).group(1))
    epoch, batch = divmod(kill, per_epoch)
    return epoch * per_epoch + batch // interval * interval


def _attempts(save_root: Path, events: Path) -> list:
    """One row per supervised attempt (its run directory, run ids sort by
    start): the first step, the step after the last one it finished, the
    steps it replayed, the newest checkpoint it completed (``saved_step``:
    the highest ``global_step`` of its ``data_state`` sidecars, 0 without
    one; a slot still being written when the process died has none), its
    restart-to-first-step time from its spawn and from the previous
    attempt's exit (the first step's end: the next step's flight record
    time less its iteration), its exit code."""
    evts = [json.loads(line) for line in events.read_text().splitlines()
            if line.strip()]
    spawns = [e for e in evts if e["event"] == "spawn"]
    exits = [e for e in evts if e["event"] == "exit"]
    runs = sorted(p for p in save_root.glob("*/train/*") if p.is_dir())
    rows = []
    for i, run in enumerate(runs):
        recs = sorted((json.loads(line) for line in
                       (run / "telemetry.jsonl").read_text().splitlines()),
                      key=lambda r: r.get("step", -1))
        steps = [r for r in recs if "event" not in r]
        saved = [json.loads(p.read_text())["global_step"]
                 for p in run.glob("checkpoint-*.data_state.json")]
        row = {"attempt": i + 1, "run": str(run), "first_step": None,
               "next_step": None, "replayed": None,
               "saved_step": max(saved, default=0),
               "returncode": exits[i]["returncode"],
               "runtime_s": exits[i]["runtime_s"]}
        if steps:   # an attempt that resumed past the last epoch has none
            first = steps[0]["step"]
            nxt = next((r for r in steps if r["step"] == first + 1
                        and "loss" not in r), None)
            end = (nxt["t"] - nxt["wall_ms"] / 1e3) if nxt \
                else steps[0]["t"]
            row.update(first_step=first, next_step=steps[-1]["step"] + 1,
                       spawn_to_first_step_s=end - spawns[i]["t"])
            if i:
                row["exit_to_first_step_s"] = end - exits[i - 1]["t"]
                if rows[-1]["next_step"] is not None:
                    row["replayed"] = rows[-1]["next_step"] - first
        rows.append(row)
    return rows


def _logged_losses(runs) -> dict:
    """Step -> logged loss over ``runs`` in order (a later run's record of
    a step it replayed wins)."""
    out = {}
    for run in runs:
        for line in (run / "telemetry.jsonl").read_text().splitlines():
            rec = json.loads(line)
            if "loss" in rec:
                out[rec["step"]] = rec["loss"]
    return out


def _assert_bitwise(got, want, where: str) -> int:
    """``got`` equal to ``want`` (nested state dicts): tensors bitwise,
    the rest by ``==``; returns the tensors compared."""
    if torch.is_tensor(want):
        if not (torch.is_tensor(got) and got.dtype == want.dtype
                and torch.equal(got, want)):
            raise AssertionError(f"{where} differs from the uninterrupted "
                                 f"run's")
        return 1
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{where}: keys {sorted(got)} against "
                                 f"{sorted(want)}")
        return sum(_assert_bitwise(got[k], want[k], f"{where}/{k}")
                   for k in want)
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"{where}: lengths differ")
        return sum(_assert_bitwise(a, b, f"{where}/{i}")
                   for i, (a, b) in enumerate(zip(got, want)))
    if got != want:
        raise AssertionError(f"{where}: {got!r} against {want!r}")
    return 0


# ---------------------------------------------------------------------------
# slice 8: the other optimizers, mu_dtype, trainable, ReduceLROnPlateau; the
# byte and BPE LMs and the real digits through the repository's configs
# ---------------------------------------------------------------------------

# phase 3e: each optimizer config takes OPTIM_REF_STEPS steps of the small
# f32 GPT2 (d_model 128: the qkv, MLP and square projection kernels factor
# under Adafactor); (label, optimizer block, lr_scale of the final update)
OPTIM_DECAY = {"weight_decay": 0.1,
               "weight_decay_exclude": ["bias$", "ln_", "wpe"]}
OPTIM_REF = [
    ("RMSprop", {"type": "RMSprop", "args": dict(
        lr=1e-3, momentum=0.9, **OPTIM_DECAY)}, 1.0),
    ("Adagrad", {"type": "Adagrad", "args": dict(lr=1e-2, **OPTIM_DECAY)},
     1.0),
    ("Adadelta", {"type": "Adadelta", "args": dict(lr=1.0, **OPTIM_DECAY)},
     1.0),
    ("Adamax", {"type": "Adamax", "args": dict(lr=2e-3, **OPTIM_DECAY)},
     1.0),
    ("NAdam", {"type": "NAdam", "args": dict(lr=2e-3, **OPTIM_DECAY)}, 1.0),
    ("RAdam", {"type": "RAdam", "args": dict(lr=1e-3, **OPTIM_DECAY)}, 1.0),
    ("Adafactor", {"type": "Adafactor", "args": dict(lr=1e-2,
                                                     **OPTIM_DECAY)}, 1.0),
    ("LARS", {"type": "LARS", "args": dict(lr=0.5, momentum=0.9,
                                           **OPTIM_DECAY)}, 1.0),
    ("LAMB", {"type": "LAMB", "args": dict(lr=1e-2, **OPTIM_DECAY)}, 1.0),
    # a flipped sign moves a weight by 2 lr: at 1e-5, 2e-5 < the atol
    ("Lion", {"type": "Lion", "args": dict(lr=1e-5, **OPTIM_DECAY)}, 1.0),
    ("Adam_mu_bf16", {"type": "Adam", "args": {
        "lr": 1e-3, "mu_dtype": "bfloat16"}}, 1.0),
    ("AdamW_trainable", {"type": "AdamW", "args": dict(
        lr=1e-3, trainable=["h_1/", "ln_f"], **OPTIM_DECAY)}, 1.0),
    ("AdamW_plateau", {"type": "AdamW", "args": dict(lr=1e-3,
                                                     **OPTIM_DECAY)}, 0.25),
]
OPTIM_REF_STEPS = 5
# float32 on both sides, TF32 off: the card and the CPU differ by
# summation order (and the kernels' f32 arms), as in phase 3c
OPTIM_REF_TOL = {"loss_rtol": 1e-5, "param_atol": 1e-4}
# the full-width part: cell (h)'s model (configs/gpt2_small.json's arch),
# OPTIM_FULL_STEPS steps of each
OPTIM_FULL_CONFIG = REPO / "configs" / "gpt2_small.json"
OPTIM_FULL = [
    ("AdamW", {"type": "AdamW", "args": dict(lr=6e-4, **OPTIM_DECAY)}),
    ("Adafactor", {"type": "Adafactor", "args": dict(lr=1e-2,
                                                     **OPTIM_DECAY)}),
    ("Lion", {"type": "Lion", "args": dict(lr=1e-4, **OPTIM_DECAY)}),
    ("Adam_mu_bf16", {"type": "Adam", "args": {"lr": 6e-4,
                                               "mu_dtype": "bfloat16"}}),
]
OPTIM_FULL_STEPS = 3


def _optim_ref_run(opt_cfg, scale, state, batches, device):
    """``OPTIM_REF_STEPS`` train steps of the small GPT2 under ``opt_cfg``
    (through ``build_optimizer``) on ``device``: (per-step losses, final
    params on the CPU, the parameter names the optimizer holds)."""
    import pytorch_distributed_template_tpu_torch.models  # noqa: F401
    from pytorch_distributed_template_tpu_torch.config.registry import (
        MODELS,
    )
    from pytorch_distributed_template_tpu_torch.engine import (
        losses, optim, steps,
    )

    model = MODELS.get("GPT2")(**TRAIN_REF["GPT2"], device=device,
                               param_dtype=torch.float32)
    model.load_state_dict(state)
    opt, lr_fn, _ = optim.build_optimizer({"optimizer": opt_cfg}, 1, model)
    step = steps.make_train_step(
        model, opt, losses.fused_lm_cross_entropy(16), input_key="tokens",
        target_key="tokens", grad_clip_norm=1.0, lr_fn=lr_fn)
    step.lr_scale = scale
    out = []
    for batch in batches:
        m = step({k: torch.from_numpy(v).to(device)
                  for k, v in batch.items()})
        out.append(float(m["loss_sum"]) / float(m["count"]))
    held = {n for n, p in model.named_parameters() if p in opt.state}
    return out, {k: v.detach().cpu() for k, v in
                 model.state_dict().items()}, held


def phase_optim_reference(device="cuda", configs=OPTIM_REF) -> None:
    """Phase 3e, first part: the small f32 GPT2 of phase 3c takes
    ``OPTIM_REF_STEPS`` steps under each of ``OPTIM_REF`` (the ten
    optimizers, Adam with a bf16 ``mu``, AdamW with ``trainable``, AdamW
    under a forced plateau scale) on ``device`` and on the CPU from the
    same weights and batches, TF32 off for this comparison only: per-step
    losses and final params within ``OPTIM_REF_TOL``; the frozen params of
    the ``trainable`` run unchanged on both."""
    import pytorch_distributed_template_tpu_torch.models  # noqa: F401
    from pytorch_distributed_template_tpu_torch.config.registry import (
        MODELS,
    )
    from pytorch_distributed_template_tpu_torch.data.datasets import (
        synthetic_lm,
    )

    args = TRAIN_REF["GPT2"]
    cpu = MODELS.get("GPT2")(**args, device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(11))
    state = cpu.state_dict()
    toks = synthetic_lm(n=4 * OPTIM_REF_STEPS, seq_len=args["max_len"],
                        vocab_size=args["vocab_size"], seed=2)["tokens"]
    batches = [{"tokens": toks[4 * i:4 * i + 4], "mask": np.ones(4, bool)}
               for i in range(OPTIM_REF_STEPS)]
    t0 = time.perf_counter()
    with _TF32(False, False) as tf32:
        for label, opt_cfg, scale in configs:
            dev_loss, dev_p, dev_held = _optim_ref_run(
                opt_cfg, scale, state, batches, device)
            cpu_loss, cpu_p, cpu_held = _optim_ref_run(
                opt_cfg, scale, state, batches, "cpu")
            loss_err = max(abs(a - b) / abs(b)
                           for a, b in zip(dev_loss, cpu_loss))
            param_err = max((dev_p[k] - cpu_p[k]).abs().max().item()
                            for k in cpu_p)
            moved = max((cpu_p[k] - state[k]).abs().max().item()
                        for k in cpu_p)
            frozen = sorted(k for k in cpu_p if k not in cpu_held)
            row = {"optimizer": label, "config": opt_cfg,
                   "lr_scale": scale, "steps": OPTIM_REF_STEPS,
                   "losses_device": dev_loss, "losses_cpu": cpu_loss,
                   "loss_max_rel_err": loss_err,
                   "param_max_abs_err": param_err,
                   "param_max_abs_change": moved, "frozen": len(frozen),
                   "tol": OPTIM_REF_TOL, "device": str(device), **tf32}
            log("[optim-reference] " + json.dumps(row))
            if not (loss_err <= OPTIM_REF_TOL["loss_rtol"]
                    and param_err <= OPTIM_REF_TOL["param_atol"]
                    and moved > 0 and dev_held == cpu_held):
                raise AssertionError(f"{label} on {device} differs from the "
                                     f"CPU: {row}")
            for k in frozen:
                if not (torch.equal(dev_p[k], state[k])
                        and torch.equal(cpu_p[k], state[k])):
                    raise AssertionError(f"{label}: frozen {k} moved")
            if "trainable" in opt_cfg["args"] and not frozen:
                raise AssertionError(f"{label} froze nothing")
    log(f"[optim-reference] {len(configs)} optimizer configs in "
        f"{time.perf_counter() - t0:.1f} s")


def phase_optim_full(card: str, device="cuda",
                     config=OPTIM_FULL_CONFIG) -> list:
    """Phase 3e, second part: cell (h)'s model (the arch of
    ``configs/gpt2_small.json``: GPT-2 small, bf16, remat, flash, fused
    head) takes ``OPTIM_FULL_STEPS`` steps of its batch under each of
    ``OPTIM_FULL``. Prints the optimizer-state bytes, which must equal
    ``optim.expected_state_bytes`` (the parameter shapes' count), the step
    ms and the peak memory, beside the card line."""
    import pytorch_distributed_template_tpu_torch.models  # noqa: F401
    from pytorch_distributed_template_tpu_torch.config.registry import (
        MODELS,
    )
    from pytorch_distributed_template_tpu_torch.data.datasets import (
        synthetic_lm,
    )
    from pytorch_distributed_template_tpu_torch.engine import (
        losses, optim, steps,
    )

    cfg = json.loads(Path(config).read_text())
    args = cfg["arch"]["args"]
    bs = cfg["train_loader"]["args"]["batch_size"]
    toks = synthetic_lm(n=bs * OPTIM_FULL_STEPS, seq_len=args["max_len"],
                        vocab_size=args["vocab_size"], seed=3)["tokens"]
    rows = []
    for label, opt_cfg in OPTIM_FULL:
        model = MODELS.get("GPT2")(**args, device=device)
        model.init_weights(torch.Generator(device=device).manual_seed(0))
        opt, lr_fn, _ = optim.build_optimizer({"optimizer": opt_cfg}, 1,
                                              model)
        step = steps.make_train_step(
            model, opt, losses.fused_lm_cross_entropy(256),
            input_key="tokens", target_key="tokens", grad_clip_norm=1.0,
            lr_fn=lr_fn)
        _sync(device)
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ms, step_losses = [], []
        for i in range(OPTIM_FULL_STEPS):
            batch = {"tokens": torch.from_numpy(
                toks[bs * i:bs * (i + 1)]).to(device),
                "mask": torch.ones(bs, dtype=torch.bool, device=device)}
            _sync(device)
            t0 = time.perf_counter()
            m = step(batch)
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            step_losses.append(float(m["loss_sum"]) / float(m["count"]))
        n = sum(p.numel() for p in model.parameters())
        got, want = optim.state_bytes(opt), optim.expected_state_bytes(opt)
        row = {"optimizer": label, "params": n, "state_bytes": got,
               "expected_state_bytes": want,
               "state_bytes_per_param": got / n, "losses": step_losses,
               "step_ms": ms,
               "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                                if torch.device(device).type == "cuda"
                                else "not measured"),
               "card": card}
        log("[optim-full] " + json.dumps(row))
        if got != want or not all(np.isfinite(step_losses)):
            raise AssertionError(f"{label} at full width: {row}")
        rows.append(row)
        del model, opt, step
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return rows


# phase 12's corpus (and, kept, 16c-16d's): 1 MB since phase 22 (2 MB
# before; its BPE fit took ~15 s of the host's time)
LM_CORPUS_MB = 1.0
BYTELM_CONFIG = REPO / "configs" / "bytelm_stdlib.json"
BYTELM_SETS = [("trainer;epochs", 1)]
BPELM_CONFIG = REPO / "configs" / "bpelm_stdlib.json"
BPELM_SETS = [("trainer;epochs", 2), ("trainer;save_period", 1)]
NLL_RTOL = 1e-5     # val_lm_nll against val_loss: the same mean NLL


def phase_lm_configs(card: str, device="cuda", byte_config=BYTELM_CONFIG,
                     byte_sets=BYTELM_SETS, bpe_config=BPELM_CONFIG,
                     bpe_sets=BPELM_SETS, corpus_mb: float = LM_CORPUS_MB,
                     work=WORK, seed: int = 0, keep_data=None,
                     keep_byte=None) -> dict:
    """Phase 12, slice 8's LM path: a corpus of ``corpus_mb`` MB from the
    port's ``tools/make_text_corpus.py``; ``configs/bytelm_stdlib.json``
    for one epoch (no checkpoint at its ``save_period`` 2, so no resume;
    ``byte_config`` None skips it),
    then ``configs/bpelm_stdlib.json`` at full width for 2 epochs with a
    resume, each through :func:`_train_path` (exact launches per step,
    falling losses). Checks the BPE tokenizer is fitted once (the
    validation loader and the resume reuse its caches: their mtimes
    unchanged), the run pins it, and ``val_lm_nll`` equals ``val_loss``
    within ``NLL_RTOL``. ``keep_data``: where the corpus and its BPE caches
    move at the end (phase 16c trains on them), else they are removed;
    ``keep_byte``: where the byte LM's trained model goes
    (:func:`keep_run`; phase 21c quantizes and serves it).
    Returns the launches of both runs per kernel."""
    from pytorch_distributed_template_tpu_torch.data import tokenizer
    from pytorch_distributed_template_tpu_torch.tools import (
        make_text_corpus,
    )

    launches = dict.fromkeys(TRAIN_KERNELS, 0)
    data_dir = work / "lm_data"
    t0 = time.perf_counter()
    info = make_text_corpus.build(data_dir / "pystdlib.txt",
                                  int(corpus_mb * 1e6))
    log(f"[lm] corpus: {info['files']} files, {info['bytes']} bytes from "
        f"{info['source']} in {time.perf_counter() - t0:.1f} s")
    data_sets = [(f"{split};args;data_dir", str(data_dir))
                 for split in ("train_loader", "valid_loader")]
    if byte_config is not None:
        t0 = time.perf_counter()
        launches = _train_path(card, device, byte_config,
                               list(byte_sets) + data_sets, work / "bytelm",
                               seed, label="bytelm", resume=False,
                               check=None if keep_byte is None else (
                                   lambda trainer, run: keep_run(
                                       trainer, keep_byte)))
        log(f"[lm] bytelm phase in {time.perf_counter() - t0:.1f} s")

    fits = []
    fit = tokenizer.BpeTokenizer.train_from_file.__func__

    def counted(cls, *a, **kw):
        t = time.perf_counter()
        out = fit(cls, *a, **kw)
        fits.append(time.perf_counter() - t)
        return out

    stamps = {}

    def check(trainer, run):
        if len(fits) != 1:
            raise AssertionError(f"the tokenizer was fitted {len(fits)} "
                                 f"times for the train and valid loaders")
        tok = Path(trainer.train_loader.tokenizer_path)
        ids = tok.with_suffix(".npy")
        stamps["main"] = (tok.stat().st_mtime_ns, ids.stat().st_mtime_ns)
        stamps["paths"] = (tok, ids)
        pinned = trainer.config.save_dir / "tokenizer.json"
        if pinned.read_bytes() != tok.read_bytes():
            raise AssertionError("the run did not pin its tokenizer")
        for e in run.epoch_logs:
            rel = abs(e["val_lm_nll"] - e["val_loss"]) / abs(e["val_loss"])
            if rel > NLL_RTOL:
                raise AssertionError(f"epoch {e['epoch']}: val_lm_nll "
                                     f"{e['val_lm_nll']} against val_loss "
                                     f"{e['val_loss']}")
        log("[bpelm] tokenizer " + json.dumps({
            "path": tok.name, "vocab": trainer.model.vocab_size,
            "fits": len(fits), "fit_and_encode_s": fits,
            "train_tokens": int(trainer.train_loader.arrays["tokens"].size),
            "val_tokens": int(trainer.valid_loader.arrays["tokens"].size),
            "train_steps_per_epoch": len(trainer.train_loader),
            "val_steps_per_epoch": len(trainer.valid_loader),
            "val_lm_nll": [e["val_lm_nll"] for e in run.epoch_logs],
            "val_loss": [e["val_loss"] for e in run.epoch_logs],
            "card": card}))

    t0 = time.perf_counter()
    tokenizer.BpeTokenizer.train_from_file = classmethod(counted)
    try:
        bpe = _train_path(card, device, bpe_config,
                          list(bpe_sets) + data_sets, work / "bpelm", seed,
                          label="bpelm", check=check)
    finally:
        tokenizer.BpeTokenizer.train_from_file = classmethod(fit)
    tok, ids = stamps["paths"]
    after = (tok.stat().st_mtime_ns, ids.stat().st_mtime_ns)
    if len(fits) != 1 or after != stamps["main"]:
        raise AssertionError(f"the tokenizer was fitted {len(fits)} times; "
                             f"caches {stamps['main']} -> {after}")
    log(f"[lm] bpelm phase in {time.perf_counter() - t0:.1f} s")
    if keep_data is None:
        shutil.rmtree(data_dir)
    else:
        Path(keep_data).parent.mkdir(parents=True, exist_ok=True)
        shutil.move(str(data_dir), str(keep_data))
    return {k: launches[k] + bpe[k] for k in launches}


DIGITS_CONFIG = REPO / "configs" / "digits.json"
DIGITS_MIN_VAL_ACC = 0.95      # the JAX package's own bar
DIGITS_KEYS = ("loss", "accuracy", "top_k_acc", "val_loss", "val_accuracy",
               "val_top_k_acc")


def phase_digits(card: str, device="cuda", config=DIGITS_CONFIG, sets=(),
                 work=WORK, seed: int = 0,
                 min_val_acc: float = DIGITS_MIN_VAL_ACC) -> dict:
    """Phase 13: ``configs/digits.json`` as it is (LeNet, Adam with
    amsgrad, StepLR, 40 epochs, early stop 15) on the real UCI digits
    through the port's ``train.py``; the last epoch's held-out
    ``val_accuracy`` must reach ``min_val_acc`` (the JAX package's test
    reads the last epoch's too); then the port's ``test.py`` on
    ``model_best`` gives the validation loss and metrics of the epoch it
    holds (``TEST_RTOL``; it is written at ``save_period`` epochs that
    improved; without one, the last epoch checkpoint). Prints ms per step
    and the wall time."""
    from pytorch_distributed_template_tpu_torch import test as test_cli
    from pytorch_distributed_template_tpu_torch import train as train_cli

    root = work / "digits"
    if root.exists():
        shutil.rmtree(root)
    argv = ["-c", str(config), "-s", str(root / "main"), "--device",
            str(device), "--seed", str(seed)]
    for chain, value in sets:
        argv += ["--set", chain, json.dumps(value)]
    box, logs, step_ms = {}, [], []

    def hook(trainer):
        box["trainer"] = trainer
        real_epoch, real_step = trainer._train_epoch, trainer.train_step

        def epoch(e):
            out = real_epoch(e)
            logs.append(dict(out, epoch=e))
            return out

        def call(batch):
            _sync(device)
            t = time.perf_counter()
            m = real_step(batch)
            _sync(device)
            step_ms.append((time.perf_counter() - t) * 1e3)
            return m

        trainer._train_epoch = epoch
        trainer.train_step = _Wrapped(real_step, call)
        log(f"[digits] {type(trainer.model).__name__} on {trainer.device}: "
            f"{trainer.train_loader.n_samples} train and "
            f"{trainer.valid_loader.n_samples} validation images, batch "
            f"{trainer.train_loader.batch_size}, {trainer.epochs} epochs, "
            f"{type(trainer.optimizer).__name__}; cuts: {list(sets)}")

    t0 = time.perf_counter()
    train_cli.main(argv, on_trainer=hook)
    wall = time.perf_counter() - t0
    trainer = box["trainer"]
    for e in logs:
        if not all(np.isfinite(e[k]) for k in DIGITS_KEYS):
            raise AssertionError(f"epoch {e['epoch']}: {e}")
    best = None
    for e in logs:     # the trainer's rule: max val_accuracy, >= wins
        if best is None or e["val_accuracy"] >= best["val_accuracy"]:
            best = e
    # model_best is written at a save_period epoch that improved (the
    # epoch its meta names); without one, the last epoch checkpoint
    run_dir = trainer.config.save_dir
    ckpt = run_dir / "model_best"
    if not ckpt.is_dir():
        ckpt = max(run_dir.glob("checkpoint-epoch*[0-9]"),
                   key=lambda c: int(c.name.rsplit("epoch", 1)[1]))
    saved = json.loads((ckpt.parent / f"{ckpt.name}.meta.json").read_text())
    held = logs[int(saved["epoch"]) - 1]
    row = {"config": str(Path(config).relative_to(REPO)),
           "epochs_run": len(logs), "wall_s": wall,
           "ms_per_step_median": float(np.median(step_ms[1:] or step_ms)),
           "steps": len(step_ms), "best_epoch": best["epoch"],
           "best": {k: best[k] for k in DIGITS_KEYS},
           "tested": ckpt.name, "tested_epoch": held["epoch"],
           "final": {k: logs[-1][k] for k in DIGITS_KEYS},
           "min_val_accuracy": min_val_acc, "card": card}
    log("[digits] " + json.dumps(row))
    if logs[-1]["val_accuracy"] < min_val_acc:
        raise AssertionError(f"val_accuracy {logs[-1]['val_accuracy']} is "
                             f"under {min_val_acc}")
    result = test_cli.main(["-r", str(ckpt), "-s",
                            str(root / "test"), "--device", str(device)])
    errs = {k: abs(result[k] - held[f"val_{k}"]) / abs(held[f"val_{k}"])
            for k in ("loss", "accuracy", "top_k_acc")}
    log("[digits] test.py " + json.dumps({
        "tested": ckpt.name, "epoch": held["epoch"], "test": result,
        "rel_err_vs_its_val": errs, "rtol": TEST_RTOL}))
    if max(errs.values()) > TEST_RTOL:
        raise AssertionError(f"test.py differs from model_best's epoch's "
                             f"validation: {errs}")
    del trainer, box
    gc.collect()
    shutil.rmtree(root)
    row["test"] = result
    return row



# ---------------------------------------------------------------------------
# slice 9: sequence parallelism (ring and Ulysses attention on B1-B3)
# ---------------------------------------------------------------------------

# phase 14a: (name, impl, layout, B, T, H, KVH, D, window, S) of the ops at
# the configs' full width: llama_swa_long's attention (contiguous banded
# ring), gpt2_long's (zigzag ring), and Ulysses at llama's shape
SEQ_OPS = [
    ("llama_swa_long", "ring_flash", "contig", 1, 16384, 12, 4, 64, 2048,
     4),
    ("gpt2_long", "ring_flash", "zigzag", 1, 8192, 12, 12, 64, 0, 4),
    ("llama_swa_long_ulysses", "ulysses_flash", "contig", 1, 16384, 12, 4,
     64, 2048, 4),
]
# ring against whole, bf16 on both sides. The output: phase 2's forward
# limit, |ring - whole| <= 1e-2 + 1.6e-2 |whole| (the ring merges S bf16
# block outputs, each rounded once, in f32). The gradients: |ring - whole|
# <= a * max_row|whole| + r |whole| + 1e-5, the absolute term scaled by
# the largest |whole| of the element's own (position, head) row, as a
# gradient's rounding scales with its own row's size (B2/B3's limit, with
# the row for the tensor); doubled, as the ring adds one bf16 partial per
# block in bf16 (one rounding per addition)
SEQ_OUT_TOL = (1e-2, 1.6e-2)
SEQ_GRAD_TOL = (2e-2, 3.2e-2)
# the block shapes of B1-B3 on this slice's path, through phases 2 and 2c's
# rows: gpt2_long's zigzag quarter blocks (1024 x 1024, causal diagonal and
# maskless), llama_swa_long's banded diagonal block (4096, window 2048,
# 12/4 heads) and Ulysses' local attention (16384, 3/1 heads), the
# backward with the lse cotangent, as the ring merges by lse; and 14b's
# own (llama_swa_long whole at seq 1: 16384, 12/4 heads, window 2048, the
# train step's microbatch of 1 and the eval step's batch of 4), its
# backward without the lse cotangent as 14b runs it, and with it
SEQ_KERNEL_SHAPES = [
    (1, 12, 12, 1024, 64, True, 0, torch.bfloat16),
    (1, 12, 12, 1024, 64, False, 0, torch.bfloat16),
    (1, 12, 4, 4096, 64, True, 2048, torch.bfloat16),
    (1, 3, 1, 16384, 64, True, 2048, torch.bfloat16),
    (1, 12, 4, 16384, 64, True, 2048, torch.bfloat16),
    (4, 12, 4, 16384, 64, True, 2048, torch.bfloat16),
]
SEQ_BWD_SHAPES = [
    ("zigzag_diagonal", 1, 12, 12, 1024, 64, True, 0, torch.bfloat16, True),
    ("zigzag_quarter", 1, 12, 12, 1024, 64, False, 0, torch.bfloat16, True),
    ("swa_diagonal", 1, 12, 4, 4096, 64, True, 2048, torch.bfloat16, True),
    ("ulysses_local", 1, 3, 1, 16384, 64, True, 2048, torch.bfloat16, True),
    ("swa_whole", 1, 12, 4, 16384, 64, True, 2048, torch.bfloat16, False),
    ("swa_whole_lse", 1, 12, 4, 16384, 64, True, 2048, torch.bfloat16,
     True),
]
LLAMA_LONG_CONFIG = REPO / "configs" / "llama_swa_long.json"
GPT2_LONG_CONFIG = REPO / "configs" / "gpt2_long.json"
# phase 14b: llama_swa_long.json on one card, cut by --set: the seq axis 1,
# an epoch of 8 steps over a corpus of 8 x 4 rows of 16384 bytes (and 3
# validation rows), the warm-up to 2 steps so that 8 steps move the loss
SEQ_CORPUS_BYTES = 600_000
SEQ_TRAIN_SETS = [("mesh;axes;seq", 1), ("trainer;epochs", 1),
                  ("lr_scheduler;args;warmup_epochs", 2)]
# phase 14c: both configs on 4 cards (llama as it is, seq 4; gpt2 with
# data 1, so seq 4) against one rank (seq 1), float32 and dropout off on
# both sides (the seq index folds into the masks), TF32 off; the first
# SEQ_NCCL_STEPS losses within rtol 1e-4
SEQ_NCCL_STEPS = 3
SEQ_NCCL_RTOL = 1e-4
SEQ_NCCL = [
    ("llama_swa_long", LLAMA_LONG_CONFIG, [], [("mesh;axes;seq", 1)]),
    ("gpt2_long", GPT2_LONG_CONFIG, [("mesh;axes;data", 1),
                                     ("arch;args;dropout", 0.0)],
     [("mesh;axes;data", 1), ("mesh;axes;seq", 1),
      ("arch;args;dropout", 0.0)]),
]
SEQ_NCCL_COMMON = [("arch;args;bfloat16", False), ("trainer;epochs", 1),
                   ("trainer;len_epoch", SEQ_NCCL_STEPS),
                   ("trainer;tensorboard", False),
                   ("trainer;save_period", 100)]


def seq_schedule(impl: str, layout: str, s: int, tl: int,
                 window: int) -> int:
    """The flash blocks one layer call of ``impl`` runs over ``s`` shards
    of ``tl`` positions (causal): the zigzag ring 3 + 2 (S - 1) per shard,
    the contiguous ring one diagonal block and one per hop inside the band
    (the band's edge blocks are einsum), Ulysses one per shard. B2 and B3
    run once per forward block."""
    from pytorch_distributed_template_tpu_torch.ops.attention import (
        _ring_steps_needed,
    )

    if impl.startswith("ulysses"):
        return s
    if layout == "zigzag":
        return s * (3 + 2 * (s - 1))
    n = _ring_steps_needed(tl, s, window) if window > 0 else s
    full = [t for t in range(1, n) if not (window > 0
                                            and t * tl + tl - 1 >= window)]
    return s * (1 + len(full))


def _tol_excess(got, ref, tol, per_row: bool) -> tuple:
    """(max |got - ref|, max(|got - ref| - limit)): ``per_row`` the
    gradients' limit (``a`` x the largest |ref| of the element's [..., D]
    row + ``r`` |ref| + 1e-5), else the output's (``a`` + ``r`` |ref|)."""
    a, r = tol
    ref = ref.float()
    err = (got.float() - ref).abs()
    if per_row:
        limit = a * ref.abs().amax(-1, keepdim=True) + r * ref.abs() + 1e-5
    else:
        limit = a + r * ref.abs()
    return err.max().item(), (err - limit).max().item()


def phase_seq_ops(card: str, device="cuda", cases=SEQ_OPS,
                  dtype=torch.bfloat16) -> list:
    """Phase 14a: the one-process ring and Ulysses paths (S shards in this
    process, the exchange a list rotation) forward and backward against
    ``flash_attention`` over the whole sequence on ``device``, at the
    configs' full width. Per case: the max abs errors of out, dq, dk, dv
    (``SEQ_OUT_TOL``, ``SEQ_GRAD_TOL``), and the flash blocks launched in
    the forward (B1) and the backward (B3, B2), each equal to
    :func:`seq_schedule`'s count; the ring's and the whole attention's
    forward + backward ms (host clock to a sync)."""
    from pytorch_distributed_template_tpu_torch.ops import attention as att
    from pytorch_distributed_template_tpu_torch.ops import flash

    libs = (flash.FLASH_FWD, flash.FLASH_BWD_DQ, flash.FLASH_BWD_DKV)

    def reset():
        for lib in libs:
            lib.launches = 0

    def read():
        return tuple(lib.launches for lib in libs)

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(14)
    rows = []
    for (name, impl, layout, b, t, h, kvh, d, window, s) in cases:
        def rnd(heads):
            return torch.randn((b, t, heads, d), generator=gen, device=dev,
                               dtype=torch.float32).to(dtype)

        q, k, v, g = rnd(h), rnd(kvh), rnd(kvh), rnd(h)
        perm = (torch.as_tensor(att.zigzag_perm(t, s), device=dev)
                if layout == "zigzag" else torch.arange(t, device=dev))
        inv = torch.argsort(perm)

        def whole():
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            out = flash.flash_attention(*leaves, causal=True, window=window)
            out.backward(g)
            return [out.detach()] + [x.grad for x in leaves]

        def ring(count: bool = False):
            leaves = [x[:, perm].contiguous().requires_grad_()
                      for x in (q, k, v)]
            shards = [[c.contiguous() for c in x.chunk(s, dim=1)]
                      for x in leaves]
            if count:
                _sync(dev)
                reset()
            if impl.startswith("ulysses"):
                outs = att.ulysses_attention_shards(
                    *shards, causal=True, window=window,
                    inner="flash" if impl == "ulysses_flash" else "xla")
            else:
                outs = att.ring_attention_shards(
                    *shards, causal=True, layout=layout, window=window,
                    block_impl="flash" if impl == "ring_flash"
                    else "einsum")
            out = torch.cat(outs, dim=1)
            fwd = read() if count else None
            if count:
                reset()
            out.backward(g[:, perm])
            bwd = read() if count else None
            return ([out.detach()[:, inv]]
                    + [x.grad[:, inv] for x in leaves], fwd, bwd)

        ref = whole()
        got, fwd, bwd = ring(count=True)
        _sync(dev)
        errs, excess = {}, {}
        for gname, x, want in zip(("out", "dq", "dk", "dv"), got, ref):
            if not torch.isfinite(x).all():
                raise AssertionError(f"[seq] {name}: non-finite {gname}")
            tol = SEQ_OUT_TOL if gname == "out" else SEQ_GRAD_TOL
            errs[gname], excess[gname] = _tol_excess(x, want, tol,
                                                     gname != "out")
        blocks = seq_schedule(impl, layout, s, t // s, window)
        want_counts = {"fwd": (blocks, 0, 0), "bwd": (0, blocks, blocks)}
        del got, ref
        ring_ms = _host_ms(lambda: ring()) if dev.type == "cuda" else None
        whole_ms = _host_ms(whole) if dev.type == "cuda" else None
        row = {"case": name, "impl": impl, "layout": layout, "B": b, "T": t,
               "H": h, "KVH": kvh, "D": d, "window": window, "S": s,
               "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": errs, "tol_out": SEQ_OUT_TOL,
               "tol_grads": SEQ_GRAD_TOL,
               "launches_fwd_B1_B3_B2": fwd, "launches_bwd_B1_B3_B2": bwd,
               "schedule_blocks": blocks, "ring_fwd_bwd_ms": ring_ms,
               "whole_fwd_bwd_ms": whole_ms, "card": card}
        log("[seq] " + json.dumps(row))
        bad = {k: v for k, v in excess.items() if v > 0}
        if bad:
            raise AssertionError(f"[seq] {name}: ring against whole "
                                 f"attention beyond the limit by {bad}")
        if fwd != want_counts["fwd"] or bwd != want_counts["bwd"]:
            raise AssertionError(
                f"[seq] {name}: launches fwd {fwd}, bwd {bwd} (B1, B3, B2); "
                f"the schedule predicts {want_counts}")
        rows.append(row)
        del q, k, v, g
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    reset()
    return rows


def _host_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms of ``fn`` to a device sync."""
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def _seq_corpus(work: Path, n_bytes: int = SEQ_CORPUS_BYTES) -> Path:
    from pytorch_distributed_template_tpu_torch.tools import (
        make_text_corpus,
    )

    data_dir = work / "seq_data"
    info = make_text_corpus.build(data_dir / "input.txt", n_bytes)
    if info["bytes"] < 0.95 * n_bytes:
        raise AssertionError(f"the corpus holds {info['bytes']} bytes of "
                             f"the {n_bytes} asked for")
    return data_dir


def phase_seq_train(card: str, device="cuda", work=WORK,
                    config=LLAMA_LONG_CONFIG, sets=SEQ_TRAIN_SETS,
                    corpus_bytes: int = SEQ_CORPUS_BYTES) -> dict:
    """Phase 14b: ``configs/llama_swa_long.json`` through the port's
    ``train.py`` on one card, cut by ``--set`` only (the seq axis 1, one
    epoch over a corpus of ``corpus_bytes``, a 2-step warm-up): every train
    step launches B1 2 x 12 x 4 times (remat, 4 microbatches) and B2, B3
    12 x 4 each, every eval step B1 12 times (:class:`TrainRun`); the
    losses finite and falling; ms per step and peak memory printed; then
    3 train steps under ``torch.profiler`` (outside the counted run).
    Returns the run's launches per kernel."""
    from pytorch_distributed_template_tpu_torch import train as train_cli

    root = work / "seq_train"
    if root.exists():
        shutil.rmtree(root)
    argv = _seq_argv(config, sets, root / "run", device,
                     _seq_corpus(root, corpus_bytes))
    box = {}

    def hook(trainer):
        box["trainer"] = trainer
        box["run"] = TrainRun(trainer, device, card, "seq_train")
        m = trainer.model
        log(f"[seq_train] {type(m).__name__} on {trainer.device}: mesh "
            f"{trainer.mesh.sizes}, {m.n_layer} layers, {m.n_head}/"
            f"{m.n_kv_head} heads, d_model {m.d_model}, window {m.window}, "
            f"{m.attn_impl}, remat {m.remat}, fused head {m.fused_head}, "
            f"{m.dtype}; batch {trainer.train_loader.batch_size} x "
            f"{trainer.train_loader.arrays['tokens'].shape[1]}, "
            f"{len(trainer.train_loader)} train / "
            f"{len(trainer.valid_loader)} eval steps; cuts: {sets}")

    t0 = time.perf_counter()
    train_cli.main(argv, on_trainer=hook)
    wall = time.perf_counter() - t0
    trainer, run = box["trainer"], box["run"]
    losses = [r["loss"] for r in run.steps]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[seq_train] non-finite losses: {losses}")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise AssertionError(f"[seq_train] the loss did not fall: {losses}")
    if not np.isfinite(run.epoch_logs[-1].get("val_loss", np.nan)):
        raise AssertionError(f"[seq_train] no finite val_loss: "
                             f"{run.epoch_logs}")
    steady = run.steps[1:] or run.steps
    PATH_STATS["seq_train"] = {"steps": len(run.steps),
                               "eval_steps": len(trainer.valid_loader)}
    log("[seq_train] " + json.dumps({
        "steps": len(run.steps), "wall_s": wall, "losses": losses,
        "val_loss": run.epoch_logs[-1]["val_loss"],
        "ms_per_step_median": float(np.median([r["ms"] for r in steady])),
        "tokens_per_s_median": float(np.median(
            [r["tokens_per_s"] for r in steady])),
        "peak_mem_gib_max": max(r["peak_mem_gib"] for r in run.steps),
        "launches_per_train_step": dict(zip(TRAIN_KERNELS,
                                            run.want["train"])),
        "launches_per_eval_step": dict(zip(TRAIN_KERNELS,
                                           run.want["eval"])),
        "launches": dict(zip(TRAIN_KERNELS, run.launches)), "card": card}))
    launches = dict(zip(TRAIN_KERNELS, run.launches))
    # where a step's time goes (outside the counted run)
    batches = [trainer._to_device(b) for b, _ in zip(
        trainer.train_loader, range(3))]
    row = _profiled(lambda: [trainer.train_step(b) for b in batches],
                    device, top_n=12, sums=("flash_fwd", "flash_bwd_dkv",
                                            "flash_bwd_dq"))
    log("[profile] " + json.dumps({"profile": "seq_train_steps", "steps": 3,
                                   **row, "card": card}))
    del trainer, box, batches
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(root)
    return launches


def _seq_argv(config, sets, save_dir, device, data_dir) -> list:
    argv = ["-c", str(config), "-s", str(save_dir), "--device", str(device)]
    for chain, value in list(sets) + [
            (f"{split};args;data_dir", str(data_dir))
            for split in ("train_loader", "valid_loader")]:
        argv += ["--set", chain, json.dumps(value)]
    return argv


def _param_bytes(model, names) -> dict:
    """The bytes of ``model``'s parameters named in ``names`` (the pipe
    stages' slices) and of the others (replicated)."""
    out = {"stage": 0, "replicated": 0}
    for name, p in model.named_parameters():
        out["stage" if name in names else "replicated"] += \
            p.numel() * p.element_size()
    return out


def seq_child(spec_path: str) -> int:
    """One rank of phase 14c (``chip_smoke.py --sp-child SPEC`` under
    ``torchrun``): the port's ``train.py`` on the spec's argv (an epoch of
    ``trainer.len_epoch`` steps and a validation pass), TF32 off; writes
    each train step's loss, ms and the ring's P2P calls and bytes, and the
    mesh, to ``<out>.rank<R>.json``."""
    from pytorch_distributed_template_tpu_torch import train as train_cli
    from pytorch_distributed_template_tpu_torch.parallel import (
        collectives, dist,
    )

    spec = json.loads(Path(spec_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steps, box = [], {}

    def hook(trainer):
        box["trainer"] = trainer
        real = trainer.train_step

        def call(batch):
            _sync(trainer.device)
            collectives.reset_counts()
            t0 = time.perf_counter()
            m = real(batch)
            _sync(trainer.device)
            steps.append({"loss": float(m["loss_sum"])
                          / max(float(m["count"]), 1.0),
                          "ms": (time.perf_counter() - t0) * 1e3,
                          **collectives.P2P})
            return m

        trainer.train_step = _Wrapped(real, call)

    train_cli.main(spec["argv"], on_trainer=hook)
    rank = dist.process_index()
    t = box["trainer"]
    placed = getattr(t.model, "placements", None) or {}
    Path(f"{spec['out']}.rank{rank}.json").write_text(json.dumps({
        "rank": rank, "steps": steps, "mesh": t.mesh.sizes,
        "world": dist.process_count(), "backend": dist.backend(),
        "ddp": t.ddp is not None, "run_dir": str(t.config.save_dir),
        "placed": sorted(placed),
        "param_bytes": _param_bytes(t.model, placed)}))
    dist.shutdown()
    return 0


def phase_seq_nccl(card: str, device="cuda", work=WORK, runs=SEQ_NCCL,
                   common=SEQ_NCCL_COMMON, n_steps: int = SEQ_NCCL_STEPS,
                   nproc: int = 4, corpus_bytes: int = SEQ_CORPUS_BYTES,
                   timeout: float = 900.0, tag: str = "seq_nccl") -> dict:
    """Phase 14c: with ``nproc`` cards, ``torchrun --nproc_per_node=nproc``
    of each config (``chip_smoke.py --sp-child``) against one rank in this
    process with a seq axis of 1, both float32 without TF32 and dropout
    off, an epoch of ``n_steps`` steps (``SEQ_NCCL_COMMON``'s
    ``len_epoch``): the ``n_steps`` losses within ``SEQ_NCCL_RTOL``, every rank
    the same losses; prints the ring's P2P calls and bytes and ms per step.
    DDP's bucket all-reduces (the world group) interleave with the ring's
    permutes (the seq groups) with NCCL's watchdog on: a hang fails the
    phase at ``timeout``. With fewer cards it prints ``"sp_nccl": "not run:
    N card(s)"`` and returns {}. Phase 15f runs its image config through
    the same machinery (``tag`` ``"image_nccl"``, no corpus: the loaders'
    ``data_dir`` is an empty directory)."""
    from pytorch_distributed_template_tpu_torch import train as train_cli

    cards = torch.cuda.device_count() if device == "cuda" else nproc
    if device == "cuda" and cards < nproc:
        log(f"[{tag}] " + json.dumps({
            tag.replace("seq_", "sp_"): f"not run: {cards} card(s)",
            "card": card}))
        return {}
    root = work / tag
    if root.exists():
        shutil.rmtree(root)
    if corpus_bytes:
        data_dir = _seq_corpus(root, corpus_bytes)
    else:
        data_dir = root / "no_data"
        data_dir.mkdir(parents=True)
    out = {}
    for name, config, rank_sets, one_sets in runs:
        spec = {"argv": _seq_argv(config, list(common) + list(rank_sets),
                                  root / f"{name}_ranks", device, data_dir),
                "steps": n_steps, "out": str(root / f"{name}_out")}
        spec_path = root / f"{name}.json"
        spec_path.write_text(json.dumps(spec))
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={nproc}", str(REPO / "chip_smoke.py"),
               "--sp-child", str(spec_path)]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                           timeout=timeout)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            # the first rank's traceback, else the launcher's summary
            err = r.stderr + r.stdout
            at = err.find("Traceback")
            tail = err[at:at + 4000] if at >= 0 else err[-4000:]
            raise AssertionError(f"[{tag}] {name}: torchrun exited "
                                 f"{r.returncode}: {tail}")
        ranks = [json.loads(Path(f"{spec['out']}.rank{i}.json").read_text())
                 for i in range(nproc)]
        one, one_ms = [], []

        def hook(trainer):
            real = trainer.train_step

            def call(batch):
                _sync(trainer.device)
                t0 = time.perf_counter()
                m = real(batch)
                _sync(trainer.device)
                one_ms.append((time.perf_counter() - t0) * 1e3)
                one.append(float(m["loss_sum"]) / max(float(m["count"]),
                                                      1.0))
                return m

            trainer.train_step = _Wrapped(real, call)

        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            train_cli.main(_seq_argv(config, list(common) + list(one_sets),
                                     root / f"{name}_one", device, data_dir),
                           on_trainer=hook)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
        losses = [s["loss"] for s in ranks[0]["steps"]]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, one)]
        row = {"config": name, "mesh": ranks[0]["mesh"],
               "world": ranks[0]["world"], "backend": ranks[0]["backend"],
               "losses": losses, "one_rank_losses": one, "rel_diff": rel,
               "rtol": SEQ_NCCL_RTOL,
               "ms_per_step": [s["ms"] for s in ranks[0]["steps"]],
               "one_rank_ms_per_step": one_ms,
               "p2p_per_step": [{k: s[k] for k in (
                   "ppermute", "ppermute_bytes", "all_to_all",
                   "all_to_all_bytes")} for s in ranks[0]["steps"]],
               "torchrun_wall_s": wall, "card": card}
        log(f"[{tag}] " + json.dumps(row))
        for rk in ranks:
            if [s["loss"] for s in rk["steps"]] != losses:
                raise AssertionError(f"[{tag}] {name}: rank "
                                     f"{rk['rank']} logged other losses")
            if not (rk["ddp"] and rk["backend"] == ("nccl" if device ==
                                                    "cuda" else "gloo")):
                raise AssertionError(f"[{tag}] {name}: rank {rk}")
        if len(losses) != n_steps or len(one) != n_steps \
                or max(rel) > SEQ_NCCL_RTOL:
            raise AssertionError(f"[{tag}] {name}: {nproc} ranks' "
                                 f"losses {losses} against one rank's "
                                 f"{one}")
        out[name] = row
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    shutil.rmtree(root)
    return out


# ---------------------------------------------------------------------------
# slice 10: image training (ResNet and ViT with BatchNorm state, augment,
# mixup, the CIFAR and ImageNet loaders); B1-B3 at ViT-B/16's attention
# ---------------------------------------------------------------------------

CIFAR_CONFIG = REPO / "configs" / "cifar10_resnet18.json"
RESNET50_CONFIG = REPO / "configs" / "imagenet_resnet50.json"
VIT_CONFIG = REPO / "configs" / "imagenet_vit_b16.json"
# phase 15a: a small f32 ResNet (CIFAR stem, one block per stage) and a
# small ViT (d 64, 2 layers, 32 px, patch 8: 17 tokens, flash at D 32), 5
# steps of 16 with augment and mixup on, card against CPU, TF32 off; the
# tolerances of phase 3c (summation order only)
IMAGE_REF = {
    "ResNet": {"cls": "ResNet", "stage_sizes": (1, 1, 1, 1),
               "num_filters": 16, "num_classes": 10, "cifar_stem": True,
               "input_shape": (32, 32, 3)},
    "ViT": {"cls": "ViT", "num_classes": 10, "image_size": 32,
            "patch_size": 8, "n_layer": 2, "n_head": 2, "d_model": 64,
            "attn_impl": "flash"},
}
IMAGE_REF_AUGMENT = {"flip": True, "crop_padding": 4, "cutout": 8}
IMAGE_REF_MIXUP = 0.2
# phase 15b: ViT-B/16's attention (12 heads x 197 tokens, D 64, bf16,
# non-causal): the train microbatch (1024 / grad_accum_steps 4) and the
# eval batch for B1, the microbatch for B2/B3
VIT_KERNEL_SHAPES = [
    (256, 12, 12, 197, 64, False, 0, torch.bfloat16),
    (1024, 12, 12, 197, 64, False, 0, torch.bfloat16),
]
VIT_BWD_SHAPES = [
    ("vit_b16", 256, 12, 12, 197, 64, False, 0, torch.bfloat16, False),
]
# phase 15c: cifar10_resnet18.json as it is (synthetic CIFAR-10: 4096 and
# 4096), cut to 2 epochs with a checkpoint each
CIFAR_SETS = [("trainer;epochs", 2), ("trainer;save_period", 1)]
CIFAR_MIN_VAL_ACC = 0.1          # chance
IMAGE_KEYS = ("loss", "accuracy", "top_k_acc", "val_loss", "val_accuracy",
              "val_top_k_acc")
# phase 15d: imagenet_resnet50.json (batch 256, bf16, the synthetic
# fallback cut to 1280 and 256 images since slice 12 (2048 and 512 in slice
# 11), against the config's 4096 and 1024: the script's time limit; five
# steps, as many as the profile takes), 1 epoch; then from uint8 shards of
# the same counts
RESNET50_COUNTS = [("train_loader;args;synthetic_n", 1280),
                   ("valid_loader;args;synthetic_n", 256)]
RESNET50_SETS = [("trainer;epochs", 1)]
RESNET50_SHARDS = {"train": 1280, "val": 256}
# phase 15e: imagenet_vit_b16.json (global batch 1024, synthetic 1024 and
# 1024: one step per epoch), 3 epochs; one card does not hold a 1024-image
# step's activations (the xla path keeps f32 scores and probabilities of
# [B, 12, 197, 197] per layer), so 4 microbatches of 256 make the update
VIT_SETS = [("trainer;epochs", 3), ("trainer;save_period", 10),
            ("trainer;grad_accum_steps", 4)]
# phase 15f: the CIFAR config in f32 with mixup 0.2, 3 steps on 4 NCCL
# ranks (64 rows each) against one rank (256), TF32 off: rtol 1e-4
IMAGE_NCCL = [("cifar10_resnet18", CIFAR_CONFIG,
               [("train_loader;args;batch_size", 64),
                ("valid_loader;args;batch_size", 64)], [])]
IMAGE_NCCL_COMMON = [("trainer;mixup_alpha", 0.2), ("trainer;epochs", 1),
                     ("trainer;len_epoch", SEQ_NCCL_STEPS),
                     ("trainer;tensorboard", False),
                     ("trainer;save_period", 100),
                     ("valid_loader;args;synthetic_n", 512)]


def _image_ref_run(spec, state, batches, device):
    """``TRAIN_REF_STEPS`` steps of the small model ``spec`` on ``device``
    from ``state`` with augment and mixup on (the config's optimizer:
    nesterov SGD for the ResNet, AdamW for the ViT): (per-step losses,
    final state dict on the CPU, buffers included)."""
    from pytorch_distributed_template_tpu_torch.engine import (
        losses, optim, steps,
    )
    from pytorch_distributed_template_tpu_torch.models import resnet, vit
    from pytorch_distributed_template_tpu_torch.ops.augment import (
        build_augment,
    )

    kw = dict(spec)
    if kw.pop("cls") == "ResNet":
        model = resnet.ResNet(kw.pop("stage_sizes"), resnet.BasicBlock,
                              device=device, **kw)
        opt = optim.OPTIMIZERS.get("SGD")(
            model, lr=0.1, momentum=0.9, weight_decay=5e-4, nesterov=True)
    else:
        model = vit.ViT(device=device, **kw)
        opt = optim.OPTIMIZERS.get("AdamW")(model, lr=1e-3,
                                            betas=(0.9, 0.95),
                                            weight_decay=0.3)
    model.load_state_dict(state)
    step = steps.make_train_step(
        model, opt, losses.nll_loss, grad_clip_norm=1.0,
        augment=build_augment(IMAGE_REF_AUGMENT),
        mixup_alpha=IMAGE_REF_MIXUP, seed=5)
    out = []
    for batch in batches:
        m = step({k: torch.from_numpy(v).to(device)
                  for k, v in batch.items()})
        out.append(float(m["loss_sum"]) / float(m["count"]))
    return out, {k: v.detach().cpu() for k, v in model.state_dict().items()}


def phase_image_reference(device="cuda") -> None:
    """Phase 15a: a small f32 ResNet (CIFAR stem, BatchNorm) and a small
    ViT (flash) trained ``TRAIN_REF_STEPS`` steps on ``device`` and on the
    CPU from the same weights and batches, augment and mixup on (the
    draws are the host's, the same on both), TF32 off on the card for
    this comparison only: per-step losses, final params and BN running
    averages within ``TRAIN_REF_TOL``."""
    from pytorch_distributed_template_tpu_torch.data.datasets import (
        synthetic_cifar10,
    )
    from pytorch_distributed_template_tpu_torch.models import resnet, vit

    data = synthetic_cifar10(n=16 * TRAIN_REF_STEPS, seed=2)
    batches = [{"image": data["image"][16 * i:16 * i + 16],
                "label": data["label"][16 * i:16 * i + 16],
                "mask": np.ones(16, bool)} for i in range(TRAIN_REF_STEPS)]
    for name, spec in IMAGE_REF.items():
        kw = dict(spec)
        kw.pop("cls")
        cpu = (resnet.ResNet(kw.pop("stage_sizes"), resnet.BasicBlock, **kw)
               if name == "ResNet" else vit.ViT(**kw))
        cpu.init_weights(torch.Generator().manual_seed(7))
        if name == "ViT":       # its head starts at 0: give it a slope
            with torch.no_grad():
                cpu.head.weight.normal_(
                    0.0, 0.02, generator=torch.Generator().manual_seed(8))
        state = {k: v.clone() for k, v in cpu.state_dict().items()}
        with _TF32(False, False) as tf32:
            dev_loss, dev_s = _image_ref_run(spec, state, batches, device)
        cpu_loss, cpu_s = _image_ref_run(spec, state, batches, "cpu")
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(dev_loss,
                                                           cpu_loss))
        errs = {k: (dev_s[k] - cpu_s[k]).abs().max().item() for k in cpu_s}
        buffers = [k for k in errs if k.endswith(("running_mean",
                                                  "running_var"))]
        row = {"model": name, "steps": TRAIN_REF_STEPS,
               "augment": IMAGE_REF_AUGMENT, "mixup_alpha": IMAGE_REF_MIXUP,
               "losses_device": dev_loss, "losses_cpu": cpu_loss,
               "loss_max_rel_err": loss_err,
               "param_max_abs_err": max(v for k, v in errs.items()
                                        if k not in buffers),
               "bn_buffer_max_abs_err": max((errs[k] for k in buffers),
                                            default=None),
               "bn_buffers": len(buffers), "tol": TRAIN_REF_TOL,
               "device": str(device), "device_run": tf32}
        log("[image-reference] " + json.dumps(row))
        if not (loss_err <= TRAIN_REF_TOL["loss_rtol"]
                and max(errs.values()) <= TRAIN_REF_TOL["param_atol"]):
            raise AssertionError(f"small f32 {name} training on {device} "
                                 f"differs from the CPU: {row}")


class ImageRun:
    """Wraps an image trainer's train and eval steps: counts B1-B3's
    launches of each step from 0 and checks them exactly (a ViT with
    ``attn_impl "flash"``: per train step B1, B2 and B3 ``n_layer`` x
    microbatches, per eval step B1 ``n_layer`` and no B2/B3; every other
    image model none), times each step (host clock to
    ``cuda.synchronize``) and keeps its loss, images/s, MFU (the
    profiler's ``train_step_flops`` count over the card's peak) and peak
    memory."""

    def __init__(self, trainer, device, card: str, label: str):
        from pytorch_distributed_template_tpu_torch.observability.profiler \
            import train_step_flops
        from pytorch_distributed_template_tpu_torch.ops import flash

        self.counters = (flash.FLASH_FWD, flash.FLASH_BWD_DKV,
                         flash.FLASH_BWD_DQ)
        self.device, self.card, self.label = device, card, label
        self.launches = [0, 0, 0]
        self.steps, self.epoch_logs, self.eval_ms = [], [], []
        self.model = model = trainer.model
        k = trainer.train_step.grad_accum_steps
        # the kernels run on the card only (the CPU takes plain versions)
        layers = (model.n_layer if getattr(model, "h", None) is not None
                  and model.h[0].attn_impl == "flash"
                  and torch.device(device).type == "cuda" else 0)
        self.want = {"train": (k * layers, k * layers, k * layers),
                     "eval": (layers, 0, 0)}
        self.batch = trainer.train_loader.batch_size
        self.flops = train_step_flops(model, self.batch, 0)
        trainer.train_step = self._wrap(trainer.train_step, "train")
        trainer.eval_step = self._wrap(trainer.eval_step, "eval")
        real_epoch = trainer._train_epoch

        def epoch(e):
            out = real_epoch(e)
            self.epoch_logs.append(dict(out, epoch=e))
            log(f"[image] ({self.label}) epoch " + json.dumps(
                dict(out, epoch=e, card=card)))
            return out

        trainer._train_epoch = epoch

    def _wrap(self, fn, kind):
        is_cuda = torch.device(self.device).type == "cuda"

        def call(batch):
            _sync(self.device)
            for c in self.counters:
                c.launches = 0
            if is_cuda:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m = fn(batch)
            _sync(self.device)
            secs = time.perf_counter() - t0
            got = tuple(c.launches for c in self.counters)
            if got != self.want[kind]:
                raise AssertionError(
                    f"({self.label}) a {kind} step launched B1, B2, B3 = "
                    f"{got}, not {self.want[kind]}")
            self.launches = [a + b for a, b in zip(self.launches, got)]
            if kind == "eval":
                self.eval_ms.append(secs * 1e3)
                return m
            row = {"step": len(self.steps),
                   "loss": float(m["loss_sum"]) / max(float(m["count"]),
                                                      1.0),
                   "ms": secs * 1e3, "images_per_s": self.batch / secs,
                   "mfu": self.flops / secs / PEAK_FLOPS[torch.bfloat16],
                   "peak_mem_gib": (torch.cuda.max_memory_allocated()
                                    / 2 ** 30 if is_cuda else 0.0)}
            self.steps.append(row)
            return m

        return _Wrapped(fn, call)

    def summary(self) -> dict:
        steady = self.steps[1:] or self.steps
        return {"steps": len(self.steps),
                "ms_per_step_median": float(np.median(
                    [r["ms"] for r in steady])),
                "images_per_s_median": float(np.median(
                    [r["images_per_s"] for r in steady])),
                "mfu_median": float(np.median([r["mfu"] for r in steady])),
                "model_flops_per_step": self.flops,
                "peak_mem_gib_max": max(r["peak_mem_gib"]
                                        for r in self.steps),
                "eval_ms_median": (float(np.median(self.eval_ms))
                                   if self.eval_ms else None),
                "launches_b1_b2_b3": self.launches,
                "losses": [r["loss"] for r in self.steps]}


def _release(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _image_argv(config, save_dir, device, sets) -> list:
    argv = ["-c", str(config), "-s", str(save_dir), "--device", str(device)]
    for chain, value in sets:
        argv += ["--set", chain, json.dumps(value)]
    return argv


def _image_train(card, device, config, sets, save_dir, label):
    """The port's ``train.py`` on ``config`` cut by ``sets``, wrapped in an
    :class:`ImageRun`; returns ``(trainer, run, wall seconds)``."""
    from pytorch_distributed_template_tpu_torch import train as train_cli

    box = {}

    def hook(trainer):
        box["trainer"] = trainer
        box["run"] = ImageRun(trainer, device, card, label)
        m = trainer.model
        log(f"[image] ({label}) {type(m).__name__} on {trainer.device}, "
            f"{sum(p.numel() for p in m.parameters()) / 1e6:.2f} M params, "
            f"{m.dtype}; train {trainer.train_loader.n_samples} images in "
            f"batches of {trainer.train_loader.batch_size} "
            f"({trainer.train_step.grad_accum_steps} microbatches), "
            f"{len(trainer.train_loader)} steps per epoch; augment "
            f"{trainer.config['trainer'].get('augment')}, mixup "
            f"{trainer.train_step.mixup_alpha}; cuts: {sets}")

    t0 = time.perf_counter()
    train_cli.main(_image_argv(config, save_dir, device, sets),
                   on_trainer=hook)
    wall = time.perf_counter() - t0
    trainer, run = box["trainer"], box["run"]
    losses = [r["loss"] for r in run.steps]
    if not losses or not all(np.isfinite(losses)):
        raise AssertionError(f"({label}) training losses {losses}")
    for e in run.epoch_logs:
        if not all(np.isfinite(e[k]) for k in IMAGE_KEYS):
            raise AssertionError(f"({label}) epoch {e['epoch']}: {e}")
    return trainer, run, wall


def _image_profile(trainer, device, card: str, label: str) -> dict:
    """5 train steps under ``torch.profiler`` (outside the counted run),
    on batches as the trainer gets them (the loader's device transform
    applied)."""
    from pytorch_distributed_template_tpu_torch.data.loader import (
        prefetch_to_device,
    )

    loader = trainer.train_loader
    batches = [b for b, _ in zip(prefetch_to_device(
        loader, device, 2, getattr(loader, "device_transform", None)),
        range(5))]
    row = _profiled(lambda: [trainer.train_step(b) for b in batches],
                    device, top_n=10)
    row = {"profile": f"{label}_steps", "steps": len(batches), **row,
           "card": card}
    log("[profile] " + json.dumps(row))
    return row


def phase_cifar(card: str, device="cuda", config=CIFAR_CONFIG,
                sets=CIFAR_SETS, work=WORK) -> None:
    """Phase 15c: ``configs/cifar10_resnet18.json`` as it is (ResNet-18,
    CIFAR stem, batch 256, nesterov SGD, augment flip and crop 4; the
    synthetic CIFAR-10 without pickles), cut by ``sets`` to 2 epochs with a
    checkpoint each: losses finite and falling, the last ``val_accuracy``
    above chance; a resume from ``checkpoint-epoch1`` reproduces epoch 2
    exactly (the logs and every tensor of the final state, BN buffers
    included: the augment draws come from the step counter); the port's
    ``test.py`` on ``model_best`` gives the best epoch's validation
    (``TEST_RTOL``)."""
    from pytorch_distributed_template_tpu_torch import test as test_cli
    from pytorch_distributed_template_tpu_torch import train as train_cli

    root = work / "cifar"
    if root.exists():
        shutil.rmtree(root)
    trainer, run, wall = _image_train(card, device, config, sets,
                                      root / "main", "cifar")
    logs = run.epoch_logs
    row = {"config": str(Path(config).relative_to(REPO)), "wall_s": wall,
           **run.summary(), "epochs": [{k: e[k] for k in IMAGE_KEYS}
                                       for e in logs], "card": card}
    log("[image] (cifar) " + json.dumps(row))
    if not logs[-1]["loss"] < logs[0]["loss"]:
        raise AssertionError(f"the loss did not fall: {logs}")
    if not logs[-1]["val_accuracy"] > CIFAR_MIN_VAL_ACC:
        raise AssertionError(f"val_accuracy {logs[-1]['val_accuracy']} "
                             f"is not above chance")
    final = {k: v.detach().clone()
             for k, v in trainer.model.state_dict().items()}
    run_dir = trainer.config.save_dir
    box = {}

    def hook(t):
        box["run"] = ImageRun(t, device, card, "cifar-resume")

    train_cli.main(["-r", str(run_dir / "checkpoint-epoch1"), "-s",
                    str(root / "resume"), "--device", str(device)],
                   on_trainer=hook)
    resumed = box["run"]
    again = resumed.epoch_logs
    diffs = {k: again[0][k] - logs[1][k] for k in IMAGE_KEYS}
    resumed_state = resumed.model.state_dict()
    unequal = [k for k, v in final.items()
               if not torch.equal(v, resumed_state[k])]
    log("[image] (cifar) resume " + json.dumps({
        "epoch": 2, "diff": diffs, "state_tensors": len(final),
        "unequal_tensors": unequal[:5],
        "bn_buffers": sum(k.endswith("running_var") for k in final)}))
    if [e["epoch"] for e in again] != [2] or any(diffs.values()) \
            or unequal:
        raise AssertionError(f"the resume does not reproduce epoch 2: "
                             f"{diffs}, {unequal[:5]}")
    best = None
    for e in logs:     # monitor "max val_accuracy": >= wins
        if best is None or e["val_accuracy"] >= best["val_accuracy"]:
            best = e
    result = test_cli.main(["-r", str(run_dir / "model_best"), "-s",
                            str(root / "test"), "--device", str(device),
                            "--save-outputs", str(root / "outputs")])
    errs = {k: abs(result[k] - best[f"val_{k}"]) / abs(best[f"val_{k}"])
            for k in ("loss", "accuracy", "top_k_acc")}
    rows = np.load(root / "outputs" / "outputs_p0.npy").shape
    log("[image] (cifar) test.py " + json.dumps({
        "epoch": best["epoch"], "test": result, "rel_err_vs_its_val": errs,
        "rtol": TEST_RTOL, "saved_outputs": rows}))
    if max(errs.values()) > TEST_RTOL or rows[0] != \
            trainer.valid_loader.n_samples:
        raise AssertionError(f"test.py differs from model_best's epoch: "
                             f"{errs}, outputs {rows}")
    _image_profile(trainer, device, card, "cifar")
    del trainer, run, box, resumed
    _release(device)
    shutil.rmtree(root)


def phase_resnet50(card: str, device="cuda", config=RESNET50_CONFIG,
                   sets=RESNET50_COUNTS + RESNET50_SETS,
                   shards=RESNET50_SHARDS,
                   image_size: int = 224, work=WORK) -> dict:
    """Phase 15d: ``configs/imagenet_resnet50.json`` (ResNet-50, batch
    256, bf16, nesterov SGD, WarmupCosine, flip; no shards under its
    ``data_dir``: the synthetic ImageNet, cut by ``sets`` to 1280 and 256
    images), 1 epoch; then the same run from uint8 shards that the port's
    ``tools/make_image_shards.py --synthetic`` writes (the native
    batcher's gathers, the ``on_device`` normalize). Prints images/s, MFU
    with its count, peak memory and a 5-step profile per run."""
    from pytorch_distributed_template_tpu_torch.data import native

    root = work / "resnet50"
    if root.exists():
        shutil.rmtree(root)
    cfg = json.loads(Path(config).read_text())
    if any(any((REPO / cfg[f"{s}_loader"]["args"]["data_dir"])
               .glob("*.npy")) for s in ("train", "valid")):
        raise AssertionError("shards under the config's data_dir: the "
                             "synthetic fallback would not run")
    out = {}
    trainer, run, wall = _image_train(card, device, config, sets,
                                      root / "synthetic", "resnet50")
    out["synthetic"] = dict(run.summary(), wall_s=wall)
    log("[image] (resnet50) " + json.dumps(dict(
        out["synthetic"], data="synthetic fallback", card=card)))
    out["synthetic"]["profile"] = _image_profile(trainer, device, card,
                                                 "resnet50")
    del trainer, run
    _release(device)

    data_dir = root / "shards"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "pytorch_distributed_template_tpu_torch.tools.make_image_shards",
         "--synthetic", str(n), "--split", split, "--out", str(data_dir),
         "--image-size", str(image_size)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for split, n in shards.items()]
    for p in procs:
        text = p.communicate(timeout=600)[0]
        if p.returncode != 0:
            raise AssertionError(f"make_image_shards: {text[-2000:]}")
    shard_s = time.perf_counter() - t0
    shard_sets = list(sets) + [(f"{s}_loader;args;data_dir", str(data_dir))
                               for s in ("train", "valid")]
    native.CALLS.reset()
    trainer, run, wall = _image_train(card, device, config, shard_sets,
                                      root / "sharded", "resnet50-shards")
    loader = trainer.train_loader
    out["shards"] = dict(run.summary(), wall_s=wall,
                         shard_write_s=shard_s,
                         native_gathers=native.CALLS.calls,
                         images=type(loader.arrays["image"]).__name__,
                         on_device_normalize=loader.device_transform
                         is not None)
    log("[image] (resnet50) " + json.dumps(dict(
        out["shards"], data=f"uint8 shards {shards}", card=card)))
    if not (native.CALLS.calls and out["shards"]["on_device_normalize"]
            and out["shards"]["images"] == "ShardedU8Array"):
        raise AssertionError(f"the sharded run missed its path: "
                             f"{out['shards']}")
    out["shards"]["profile"] = _image_profile(trainer, device, card,
                                              "resnet50-shards")
    del trainer, run, loader
    _release(device)
    shutil.rmtree(root)
    return out


def phase_vit(card: str, device="cuda", config=VIT_CONFIG, sets=VIT_SETS,
              work=WORK) -> dict:
    """Phase 15e: ``configs/imagenet_vit_b16.json`` (ViT-B/16, global
    batch 1024 in 4 microbatches, bf16, AdamW, clip 1.0, flip, mixup 0.2,
    dropout 0.1; synthetic ImageNet, one step per epoch) for 3 epochs,
    once as it is (``attn_impl "xla"``) and once with ``attn_impl
    "flash"``: exact launches per step (flash: per train step B1, B2, B3
    12 x 4; per eval step B1 12; xla: none), images/s and peak memory,
    then a profile of one train step (the epoch's one batch; outside the
    counted run). Returns the flash run's launches per kernel."""
    root = work / "vit"
    if root.exists():
        shutil.rmtree(root)
    out = {}
    for impl in ("xla", "flash"):
        run_sets = list(sets) + ([("arch;args;attn_impl", impl)]
                                 if impl != "xla" else [])
        trainer, run, wall = _image_train(card, device, config, run_sets,
                                          root / impl, f"vit-{impl}")
        out[impl] = dict(run.summary(), wall_s=wall)
        log("[image] (vit) " + json.dumps(dict(out[impl], attn_impl=impl,
                                               card=card)))
        _image_profile(trainer, device, card, f"vit-{impl}")
        del trainer, run
        _release(device)
    shutil.rmtree(root)
    return dict(zip(("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"),
                    out["flash"]["launches_b1_b2_b3"]))


# ---------------------------------------------------------------------------
# slice 11: BERT MLM and classifier transfer, LoRA and its merge, soups
# ---------------------------------------------------------------------------

BERT_MLM_CONFIG = REPO / "configs" / "bert_mlm_stdlib.json"
BERT_CLS_CONFIG = REPO / "configs" / "bert_cls_stdlib.json"
# phase 16a: small f32 BERT models and LoRA'd GPT2 / Llama (head_dim 64 so
# the flash kernels take them), 5 AdamW steps card against CPU with phase
# 3c's limits; the LoRA runs train the adapters alone (``trainable``)
BERT_REF = {"vocab_size": 128, "n_layer": 2, "n_head": 2, "d_model": 128,
            "max_len": 32, "dropout": 0.0, "attn_impl": "flash"}
BERT_REF_CLASSES = 5
LORA_REF = {"GPT2": dict(TRAIN_REF["GPT2"], lora_rank=4),
            "Llama": dict(TRAIN_REF["Llama"], lora_rank=4)}
# phase 16b: bert_mlm_stdlib.json's attention (6 heads x 128 tokens, D 64,
# bf16, non-causal, batch 128): one 128 x 128 tile per (batch, head)
BERT_KERNEL_SHAPES = [(128, 6, 6, 128, 64, False, 0, torch.bfloat16)]
BERT_BWD_SHAPES = [
    ("bert_mlm", 128, 6, 6, 128, 64, False, 0, torch.bfloat16, False)]
# phase 16c: bert_mlm_stdlib.json as it is on phase 12's 2 MB corpus and
# its 1024-vocab BPE, cut to 2 epochs with a checkpoint each, once with
# xla and once with flash attention
BERT_CORPUS_MB = 2.0
BERT_MLM_SETS = [("trainer;epochs", 2), ("trainer;save_period", 1)]
BERT_EVAL_SEED = 3
# phase 16e: bert_cls_stdlib.json (8 classes: chance 0.125) cut to 3 of
# its 6 epochs since slice 15 (the script's time limit)
BERT_CLS_SETS = [("trainer;epochs", 3)]
BERT_CLS_CHANCE = 0.125
# phase 16f: LoRA on cell (h)'s GPT-2 small from phase 6's epoch-1 weights,
# one epoch of 32 steps; the merged dense model against the adapted one in
# bf16 with phase 2c's bf16 limits
LORA_GPT2_SETS = [("train_loader;args;n", 256), ("valid_loader;args;n", 64),
                  ("trainer;epochs", 1), ("trainer;save_period", 1),
                  ("arch;args;lora_rank", 8),
                  ("optimizer;args;trainable", ["lora_"])]
GPT2_BASE = WORK / "gpt2_base"
# phase 16g: llama_debug.json's width in f32 (one head of D 64: the paged
# pool of its serving section takes D 64 and 128), LoRA rank 4; then
# Mistral-7B's widths
LLAMA_DEBUG_CONFIG = REPO / "configs" / "llama_debug.json"
LORA_LLAMA_SETS = [("arch;args;n_head", 1), ("arch;args;n_kv_head", 1),
                   ("arch;args;lora_rank", 4),
                   ("optimizer;args;trainable", ["lora_"]),
                   ("trainer;epochs", 1), ("trainer;tensorboard", False)]
LORA_GREEDY = 16
MISTRAL_LORA_CONFIG = REPO / "pytorch_distributed_template_tpu_torch" \
    / "configs" / "mistral_7b_lora.json"
MISTRAL_LORA_SETS = []
MEMORY_LIMIT_GIB = 80.0


def _bert_ref_run(model, state, batches, device, crit, target_key,
                  trainable=None):
    """``TRAIN_REF_STEPS`` AdamW steps of ``model`` moved to ``device``
    from ``state`` (``trainable``: the adapters alone): (per-step losses,
    the first step's gradients, final state, optimizer) on the CPU."""
    from pytorch_distributed_template_tpu_torch.engine import optim, steps

    model = model.to(device)
    model.load_state_dict(state)
    target = model
    if trainable:
        optim.freeze_untrainable(model, trainable)
        target = optim.Trainable(model, trainable)
    opt = optim.OPTIMIZERS.get("AdamW")(
        target, lr=1e-3, betas=(0.9, 0.95), weight_decay=0.1,
        weight_decay_exclude=["bias$", "ln_", "wpe", "norm"])
    step = steps.make_train_step(model, opt, crit, input_key="tokens",
                                 target_key=target_key)
    losses, grads = [], None
    for batch in batches:
        m = step({k: torch.from_numpy(v).to(device)
                  for k, v in batch.items()})
        losses.append(float(m["loss_sum"]) / float(m["count"]))
        if grads is None:
            grads = {n: p.grad.detach().cpu() for n, p in
                     model.named_parameters() if p.grad is not None}
    return losses, grads, {k: v.detach().cpu()
                           for k, v in model.state_dict().items()}


def _ref_compare(label, dev, cpu, device, extra=None) -> dict:
    """Card against CPU for ``_bert_ref_run``'s results: losses and
    params within ``TRAIN_REF_TOL``, first-step gradients within phase
    2c's f32 limits; raises on a miss."""
    (dev_loss, dev_g, dev_p), (cpu_loss, cpu_g, cpu_p) = dev, cpu
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(dev_loss, cpu_loss))
    param_err = max((dev_p[k] - cpu_p[k]).abs().max().item() for k in cpu_p)
    grad = [_grad_error(dev_g[k], cpu_g[k], torch.float32) for k in cpu_g]
    row = {"model": label, "steps": TRAIN_REF_STEPS,
           "losses_device": dev_loss, "losses_cpu": cpu_loss,
           "loss_max_rel_err": loss_err, "param_max_abs_err": param_err,
           "grad_max_abs_err": max(g[0] for g in grad),
           "grads": len(grad), "tol": TRAIN_REF_TOL,
           "grad_tol": BWD_TOL[torch.float32], "device": str(device),
           **(extra or {})}
    log("[bert-reference] " + json.dumps(row))
    if not (set(dev_g) == set(cpu_g) and loss_err <= TRAIN_REF_TOL[
            "loss_rtol"] and param_err <= TRAIN_REF_TOL["param_atol"]
            and max(g[1] for g in grad) <= 0):
        raise AssertionError(f"small f32 {label} on {device} differs from "
                             f"the CPU: {row}")
    return row


def phase_bert_reference(device="cuda") -> None:
    """Phase 16a: small f32 ``BertMLM`` and ``BertClassifier`` (flash) and
    LoRA'd GPT2 and Llama (flash, the adapters trained alone) take
    ``TRAIN_REF_STEPS`` AdamW steps on ``device`` (kernels) and on the CPU
    (plain versions) from the same weights and batches, TF32 off: losses,
    first-step gradients and final params within phase 3c's limits (the
    MLM mask draws are the host's, the same on both); the frozen base
    bitwise fixed on both. The corruption applied on the device to the
    same draws equals the CPU's bit for bit, and ``merge_lora_params`` on
    the device equals the CPU's (f32, atol 1e-6 x the largest weight)."""
    import pytorch_distributed_template_tpu_torch.models  # noqa: F401
    from pytorch_distributed_template_tpu_torch.config.registry import (
        MODELS,
    )
    from pytorch_distributed_template_tpu_torch.data.datasets import (
        synthetic_lm,
    )
    from pytorch_distributed_template_tpu_torch.engine import losses
    from pytorch_distributed_template_tpu_torch.models import bert, lora

    with _TF32(False, False) as tf32:
        v = BERT_REF["vocab_size"]
        toks = synthetic_lm(n=8 * TRAIN_REF_STEPS, seq_len=BERT_REF[
            "max_len"], vocab_size=v - 1, seed=4)["tokens"]
        labels = (toks[:, 0] % BERT_REF_CLASSES).astype(np.int32)
        batches = [{"tokens": toks[8 * i:8 * i + 8],
                    "label": labels[8 * i:8 * i + 8],
                    "mask": np.ones(8, bool)}
                   for i in range(TRAIN_REF_STEPS)]
        for name, kw, crit, tgt in (
                ("BertMLM", {}, losses.mlm_cross_entropy, "tokens"),
                ("BertClassifier", {"num_classes": BERT_REF_CLASSES},
                 losses.cross_entropy, "label")):
            def build(dev, name=name, kw=kw):
                return MODELS.get(name)(**BERT_REF, **kw, device=dev)

            cpu = build("cpu")
            cpu.init_weights(torch.Generator().manual_seed(7))
            state = {k: t.clone() for k, t in cpu.state_dict().items()}
            _ref_compare(name, _bert_ref_run(build(device), state, batches,
                                             device, crit, tgt),
                         _bert_ref_run(cpu, state, batches, "cpu", crit,
                                       tgt), device, {"device_run": tf32})

        model = MODELS.get("BertMLM")(**BERT_REF)
        t = torch.from_numpy(toks[:8])
        draws = model.mask_draws(11, t)
        on_dev = {k: d.to(device) for k, d in draws.items()}
        got = bert.corrupt(t.to(device), on_dev["sel"], on_dev["mix"],
                           on_dev["rand_tok"], model.mask_id).cpu()
        want = bert.corrupt(t, draws["sel"], draws["mix"],
                            draws["rand_tok"], model.mask_id)
        row = {"corrupt": list(t.shape), "masked": int(draws["sel"].sum()),
               "changed": int((want != t.long()).sum()),
               "bit_exact": bool(torch.equal(got, want))}
        log("[bert-reference] " + json.dumps(row))
        if not row["bit_exact"]:
            raise AssertionError(f"the corruption on {device} differs from "
                                 f"the CPU's on the same draws: {row}")

        for name, args in LORA_REF.items():
            toks = synthetic_lm(n=4 * TRAIN_REF_STEPS, seq_len=args[
                "max_len"], vocab_size=args["vocab_size"], seed=1)["tokens"]
            batches = [{"tokens": toks[4 * i:4 * i + 4],
                        "mask": np.ones(4, bool)}
                       for i in range(TRAIN_REF_STEPS)]
            crit = (losses.fused_lm_cross_entropy(16)
                    if args.get("fused_head") else losses.lm_cross_entropy)

            def build(dev, name=name, args=args):
                return MODELS.get(name)(**args, device=dev,
                                        param_dtype=torch.float32)

            cpu = build("cpu")
            cpu.init_weights(torch.Generator().manual_seed(7))
            state = {k: t.clone() for k, t in cpu.state_dict().items()}
            dev = _bert_ref_run(build(device), state, batches, device, crit,
                                "tokens", trainable=["lora_"])
            ref = _bert_ref_run(cpu, state, batches, "cpu", crit, "tokens",
                                trainable=["lora_"])
            base = [k for k in state if k.rsplit(".", 1)[-1]
                    not in lora.ADAPTER_LEAVES]
            fixed = all(torch.equal(run[2][k], state[k]) for run in
                        (dev, ref) for k in base)
            merged_dev = lora.merge_lora_params(
                {k: t.to(device) for k, t in dev[2].items()})
            merged_cpu = lora.merge_lora_params(dev[2])
            merge_err = max((merged_dev[k].cpu() - merged_cpu[k]).abs().max()
                            .item() / max(merged_cpu[k].abs().max().item(),
                                          1e-30) for k in merged_cpu)
            _ref_compare(f"{name}+LoRA", dev, ref, device, {
                "base_bitwise_fixed": fixed, "base_tensors": len(base),
                "adapters": len(state) - len(base),
                "merge_max_rel_err": merge_err, "device_run": tf32})
            if not fixed or merge_err > 1e-6:
                raise AssertionError(f"{name}+LoRA: base fixed {fixed}, "
                                     f"merge error {merge_err}")


def _counted_run(card, device, argv, label, check=None):
    """The port's ``train.py`` with ``argv`` under a :class:`TrainRun`
    (exact launches per step, step times, MFU, peak memory); losses
    finite. Returns ``(trainer, run, wall seconds)``."""
    from pytorch_distributed_template_tpu_torch import train as train_cli

    box = {}

    def hook(trainer):
        box["trainer"] = trainer
        box["run"] = TrainRun(trainer, device, card, label)
        if check is not None:
            check(trainer)

    t0 = time.perf_counter()
    train_cli.main(argv, on_trainer=hook)
    wall = time.perf_counter() - t0
    trainer, run = box["trainer"], box["run"]
    losses = [r["loss"] for r in run.steps]
    if not losses or not all(np.isfinite(losses)):
        raise AssertionError(f"({label}) training losses {losses}")
    return trainer, run, wall


def _run_row(run, wall) -> dict:
    steady = run.steps[1:] or run.steps
    return {"steps": len(run.steps), "wall_s": wall,
            "ms_per_step_median": float(np.median([r["ms"] for r in steady])),
            "tokens_per_s_median": float(np.median(
                [r["tokens_per_s"] for r in steady])),
            "mfu_median": float(np.median([r["mfu"] for r in steady])),
            "model_flops_per_step": run.flops,
            "peak_mem_gib_max": max(r["peak_mem_gib"] for r in run.steps),
            "launches": dict(zip(TRAIN_KERNELS, run.launches)),
            "loss_first": run.steps[0]["loss"],
            "loss_last": run.steps[-1]["loss"]}


def _eval_checks(card, device, run_dir, logs, root) -> dict:
    """16c's ``test.py`` checks on ``model_best`` (seeded twice, unseeded
    against the best epoch's validation, ``--save-outputs``), then 16d:
    the soup of ``checkpoint-epoch1`` and ``-epoch2`` through the port's
    ``checkpoint.average`` CLI (its ``main``) and ``test.py``, and a soup of one
    checkpoint against that checkpoint (bitwise)."""
    from pytorch_distributed_template_tpu_torch import test as test_cli
    from pytorch_distributed_template_tpu_torch.checkpoint import average

    def evaluate(ckpt, *extra):
        return test_cli.main(["-r", str(ckpt), "-s", str(root / "test"),
                              "--device", str(device), *extra])

    best = None
    for e in logs:      # monitor "min val_loss": a later tie wins
        if best is None or e["val_loss"] <= best["val_loss"]:
            best = e
    seeded = [evaluate(run_dir / "model_best", "--seed",
                       str(BERT_EVAL_SEED)) for _ in range(2)]
    plain = evaluate(run_dir / "model_best", "--save-outputs",
                     str(root / "outputs"))
    errs = {k: abs(plain[k] - best[f"val_{k}"]) / abs(best[f"val_{k}"])
            for k in ("loss", "mlm_accuracy")}
    out = np.load(root / "outputs" / "outputs_p0.npy", mmap_mode="r")
    masks = np.load(root / "outputs" / "masks_p0.npy")
    row = {"best_epoch": best["epoch"], "test": plain,
           "rel_err_vs_its_val": errs, "rtol": TEST_RTOL,
           "seed": BERT_EVAL_SEED, "seeded": seeded,
           "outputs": list(out.shape), "masks": list(masks.shape),
           "masks_dtype": str(masks.dtype),
           "masked_per_row": float(masks.sum(-1).mean())}
    log("[bert] (mlm) test.py " + json.dumps(row))
    if (max(errs.values()) > TEST_RTOL or seeded[0] != seeded[1]
            or out.shape[:2] != masks.shape or masks.dtype != bool):
        raise AssertionError(f"test.py on model_best: {row}")
    shutil.rmtree(root / "outputs")

    t0 = time.perf_counter()
    soup = run_dir / "soup-epoch1-2"
    average.main([str(run_dir / "checkpoint-epoch1"),
                  str(run_dir / "checkpoint-epoch2"), "-o", str(soup)])
    soup_test = evaluate(soup)
    one = average.average_checkpoints([run_dir / "checkpoint-epoch2"],
                                      run_dir / "soup-epoch2")
    one_test, ckpt_test = evaluate(one), evaluate(run_dir /
                                                  "checkpoint-epoch2")
    soup_row = {"soup_val_loss": soup_test["loss"],
                "soup_val_mlm_accuracy": soup_test["mlm_accuracy"],
                "epoch1_val_loss": logs[0]["val_loss"],
                "epoch2_val_loss": logs[1]["val_loss"],
                "one_soup": one_test, "epoch2": ckpt_test,
                "one_soup_bitwise": one_test == ckpt_test,
                "seconds": time.perf_counter() - t0, "card": card}
    log("[bert] (soup) " + json.dumps(soup_row))
    if one_test != ckpt_test or not np.isfinite(soup_test["loss"]):
        raise AssertionError(f"the soups: {soup_row}")
    return {"test": row, "soup": soup_row}


def phase_bert_mlm(card: str, device="cuda", config=BERT_MLM_CONFIG,
                   sets=BERT_MLM_SETS, corpus_mb: float = BERT_CORPUS_MB,
                   work=WORK, seed: int = 0) -> dict:
    """Phases 16c and 16d: phase 12's corpus and its cached 1024-id BPE
    where phase 12 left them (``work / "bert_keep" / "data"``), else a
    corpus of ``corpus_mb`` MB from the port's
    ``tools/make_text_corpus.py``; then ``configs/bert_mlm_stdlib.json``
    as it is (6 layers, d_model 384, 6 heads, vocab 1025, seq 128, batch
    128, bf16, mask rate 0.15, dropout 0.1, AdamW, WarmupCosine, clip 1.0)
    cut by ``sets`` (2 epochs, a checkpoint each) through
    :func:`_train_path`: once with ``xla`` attention (no resume), once with
    ``attn_impl "flash"`` (exact B1/B2/B3 launches per step, losses finite
    and falling, a resume from ``checkpoint-epoch1`` reproducing epoch 2;
    then :func:`_eval_checks`: ``test.py`` and the soups). Keeps the flash
    run's ``model_best`` and logs, and the corpus with its BPE caches,
    under ``work / "bert_keep"`` for 16e. Returns the flash run's launches
    per kernel."""
    from pytorch_distributed_template_tpu_torch.tools import (
        make_text_corpus,
    )

    keep = work / "bert_keep"
    data_dir = keep / "data"
    if (data_dir / "pystdlib.txt").exists():
        log(f"[bert] phase 12's corpus and BPE caches: "
            f"{sorted(p.name for p in data_dir.iterdir())}")
    else:
        t0 = time.perf_counter()
        info = make_text_corpus.build(data_dir / "pystdlib.txt",
                                      int(corpus_mb * 1e6))
        log(f"[bert] corpus: {info['files']} files, {info['bytes']} bytes "
            f"from {info['source']} in {time.perf_counter() - t0:.1f} s")
    data_sets = [(f"{split};args;data_dir", str(data_dir))
                 for split in ("train_loader", "valid_loader")]
    out = {}

    def report(label):
        def check(trainer, run):
            out[label] = dict(_run_row(run, 0.0), epochs=[
                {k: e[k] for k in ("epoch", "loss", "mlm_accuracy",
                                   "val_loss", "val_mlm_accuracy")}
                for e in run.epoch_logs], card=card)
            log(f"[bert] ({label}) " + json.dumps(out[label]))
            if label == "flash":
                run_dir = trainer.config.save_dir
                out["eval"] = _eval_checks(card, device, run_dir,
                                           run.epoch_logs, work / "bert_eval")
                shutil.copytree(run_dir / "model_best", keep / "model_best")
                for name in ("info.log", "summary.json", "config.json"):
                    shutil.copyfile(run_dir / name, keep / name)
        return check

    _train_path(card, device, config, list(sets) + data_sets,
                work / "bert_xla", seed, label="bert_xla", resume=False,
                check=report("xla"))
    launches = _train_path(card, device, config, list(sets) + data_sets + [
        ("arch;args;attn_impl", "flash")], work / "bert_flash", seed,
        label="bert_flash", check=report("flash"))
    log("[bert] (mlm) " + json.dumps({
        "xla_ms": out["xla"]["ms_per_step_median"],
        "flash_ms": out["flash"]["ms_per_step_median"],
        "xla_peak_gib": out["xla"]["peak_mem_gib_max"],
        "flash_peak_gib": out["flash"]["peak_mem_gib_max"], "card": card}))
    if (work / "bert_eval").exists():
        shutil.rmtree(work / "bert_eval")
    return launches


def phase_bert_cls(card: str, device="cuda", config=BERT_CLS_CONFIG,
                   sets=BERT_CLS_SETS, work=WORK, seeds=(1,),
                   chance: float = BERT_CLS_CHANCE) -> dict:
    """Phase 16e: ``configs/bert_cls_stdlib.json`` as it is
    (``PyModuleClsLoader`` over this machine's standard library, 8
    classes, 6 epochs) through ``tools/bert_transfer_experiment.py``'s
    logic, per seed: a warm run (``trainer.init_from`` 16c's
    ``model_best``) and a fresh one at the same seed and budget, then the
    tool's ``summarize`` (curves, verdict). The loader's windows and its
    seconds with the cache cold and warm come first. Hard checks: the warm
    start restores exactly the ``encoder.*`` tensors and skips
    ``classifier_head.*``; the warm run's best ``val_accuracy`` is above
    ``chance``. Returns the runs' launches per kernel."""
    from pytorch_distributed_template_tpu_torch.data import datasets
    from pytorch_distributed_template_tpu_torch.engine import trainer as eng
    from pytorch_distributed_template_tpu_torch.tools import (
        bert_transfer_experiment as tool,
    )

    keep = work / "bert_keep"
    data_dir = keep / "data"
    args = dict(json.loads(Path(config).read_text())["train_loader"]["args"],
                data_dir=str(data_dir))
    args.update({chain.rsplit(";", 1)[1]: value for chain, value in sets
                 if chain.startswith("train_loader;args;")})
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        loader = datasets.py_module_cls_loader(**args)
        times.append(time.perf_counter() - t0)
    val = datasets.py_module_cls_loader(**dict(args, training=False,
                                               shuffle=False))
    counts = np.bincount(loader.arrays["label"], minlength=8).tolist()
    log("[bert] (cls) loader " + json.dumps({
        "train_windows": int(loader.n_samples),
        "val_windows": int(val.n_samples), "train_per_class": counts,
        "cold_s": times[0], "warm_s": times[1],
        "cache": loader.window_cache.name, "card": card}))
    data_sets = [(f"{split};args;data_dir", str(data_dir))
                 for split in ("train_loader", "valid_loader")]
    grafts = []
    real = eng.warm_start_params

    def recorded(*a, **kw):
        got = real(*a, **kw)
        grafts.append(got)
        return got

    launches = dict.fromkeys(TRAIN_KERNELS, 0)
    runs = {"warm": {}, "fresh": {}}
    eng.warm_start_params = recorded
    try:
        for s in seeds:
            for arm in ("warm", "fresh"):
                extra = ([("trainer;init_from", str(keep / "model_best"))]
                         if arm == "warm" else [])
                argv = tool.train_argv(config, work / f"bert_{arm}_s{s}", s,
                                       list(sets) + data_sets + extra,
                                       device)
                trainer, run, wall = _counted_run(card, device, argv,
                                                  f"cls-{arm}")
                row = dict(_run_row(run, wall), seed=s, arm=arm,
                           best_val_accuracy=max(
                               e["val_accuracy"] for e in run.epoch_logs),
                           card=card)
                log("[bert] (cls) " + json.dumps(row))
                runs[arm][s] = trainer.config.save_dir
                launches = {k: launches[k] + v
                            for k, v in row["launches"].items()}
                del trainer, run
                _release(device)
    finally:
        eng.warm_start_params = real
    restored, skipped = grafts[0]
    want = sorted(k for k in restored + skipped if k.startswith("encoder."))
    graft = {"restored": len(restored), "skipped": skipped,
             "exact": (restored == want and bool(skipped) and all(
                 k.startswith("classifier_head.") for k in skipped))}
    verdict = tool.summarize(keep, runs["warm"], runs["fresh"],
                             work / "bert_transfer")
    log("[bert] (cls) " + json.dumps({"graft": graft, "verdict": verdict,
                                      "chance": chance,
                                      "card": card}))
    if len(grafts) != len(seeds) or not graft["exact"]:
        raise AssertionError(f"the warm start grafted {graft}")
    if not all(p["warm"] > chance for p in verdict["per_seed"]):
        raise AssertionError(f"the warm runs stay at chance: {verdict}")
    for d in list(runs["warm"].values()) + list(runs["fresh"].values()):
        shutil.rmtree(d.parents[2])
    shutil.rmtree(keep)
    shutil.rmtree(work / "bert_transfer")
    return launches


def phase_lora_gpt2(card: str, device="cuda", config=TRAIN_CONFIG,
                    sets=LORA_GPT2_SETS, base=GPT2_BASE, work=WORK,
                    seed: int = 0, drop_base: bool = True) -> dict:
    """Phase 16f: LoRA (rank 8, the adapters alone) on cell (h)'s GPT-2
    small at full width, warm-started from phase 6's ``checkpoint-epoch1``
    (``base``), one epoch of 32 steps through :func:`_train_path` (cell
    (h)'s exact B1/B2/B3 launches per step). Hard checks: every base
    tensor bitwise equal to the checkpoint's after the run; the optimizer
    state's bytes = the adapters' elements x 2 moments x 4 B; the
    artifact of the port's ``tools/merge_lora.py`` builds a plain dense
    GPT-2 whose logits equal the adapted model's within phase 2c's bf16
    limits. Prints ms per step beside cell (h)'s (phase 6, this call).
    ``drop_base`` False keeps ``base`` for phase 17d. Returns the run's
    launches per kernel."""
    import pytorch_distributed_template_tpu_torch.models  # noqa: F401
    from pytorch_distributed_template_tpu_torch.checkpoint import (
        restore_serving_params,
    )
    from pytorch_distributed_template_tpu_torch.config.registry import (
        MODELS,
    )
    from pytorch_distributed_template_tpu_torch.engine import optim
    from pytorch_distributed_template_tpu_torch.models import lora
    from pytorch_distributed_template_tpu_torch.tools import merge_lora

    ckpt = Path(base) / "checkpoint-epoch1"
    if not (ckpt / "model.pt").is_file():
        raise AssertionError(f"no base weights at {ckpt} (phase 6 keeps "
                             f"them)")

    def check(trainer, run):
        disk = torch.load(ckpt / "model.pt", map_location="cpu")
        live = trainer.model.state_dict()
        moved = [k for k, t in disk.items() if not torch.equal(
            live[k].cpu(), t)]
        adapters = sum(p.numel() for n, p in trainer.model.named_parameters()
                       if n.rsplit(".", 1)[-1] in lora.ADAPTER_LEAVES)
        state = optim.state_bytes(trainer.optimizer)
        path = merge_lora.main(["-r", str(trainer.config.save_dir /
                                          "checkpoint-epoch1"),
                                "-s", str(work / "lora_merge_log")])
        cfg = json.loads((path.parent / "config.json").read_text())
        dense = MODELS.get(cfg["arch"]["type"])(
            **cfg["arch"]["args"], device=device, param_dtype=torch.float32)
        dense.load_state_dict(restore_serving_params(path, device))
        batch = next(iter(trainer.valid_loader))
        tokens = torch.from_numpy(np.asarray(batch["tokens"][:2])).to(device)
        with torch.no_grad():
            trainer.model.eval()
            dense.eval()
            h, w = trainer.model(tokens)
            hd, wd = dense(tokens)
            got, want = (hd @ wd).float(), (h @ w).float()
        err, excess = _grad_error(got, want, torch.bfloat16)
        row = {"base_tensors": len(disk), "base_moved": moved[:5],
               "adapter_elements": adapters, "state_bytes": state,
               "expected_state_bytes": adapters * 2 * 4,
               "merged_logit_max_abs_err": err,
               "merged_logit_tol": BWD_TOL[torch.bfloat16],
               "cell_h_ms_per_step": PATH_STATS.get("train", {}).get(
                   "ms_per_step_median", "not measured in this call"),
               "card": card}
        log("[lora] (gpt2) " + json.dumps(row))
        if moved or state != adapters * 8 or excess > 0:
            raise AssertionError(f"LoRA on GPT-2 small: {row}")
        del dense

    launches = _train_path(card, device, config, list(sets) + [
        ("trainer;init_from", str(ckpt))], work / "lora_gpt2", seed,
        label="lora_gpt2", check=check, resume=False, falling=False)
    log("[lora] (gpt2) " + json.dumps({
        "ms_per_step": PATH_STATS["lora_gpt2"]["ms_per_step_median"],
        "cell_h_ms_per_step": PATH_STATS.get("train", {}).get(
            "ms_per_step_median", "not measured in this call"),
        "card": card}))
    for d in ((Path(base),) if drop_base else ()) + (
            work / "lora_merge_log",):
        if d.exists():
            shutil.rmtree(d)
    return launches


def _checksums(model) -> dict:
    """Per base tensor an int64 sum of its bit patterns and of the bit
    patterns times their index: a moved bit changes one of them."""
    out = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in ("lora_a", "lora_b"):
                continue
            bits = p.detach().view(torch.int32).flatten().long()
            idx = torch.arange(bits.numel(), device=bits.device)
            out[name] = (int(bits.sum()), int((bits * (idx % 65521)).sum()))
    return out


def phase_lora_llama(card: str, device="cuda", config=LLAMA_DEBUG_CONFIG,
                     sets=LORA_LLAMA_SETS, mistral=MISTRAL_LORA_CONFIG,
                     mistral_sets=MISTRAL_LORA_SETS, work=WORK,
                     seed: int = 0) -> dict:
    """Phase 16g: LoRA on a Llama, merged, then served. At
    ``configs/llama_debug.json``'s width in f32 (``sets``): one epoch of
    LoRA steps, the port's ``tools/merge_lora.py``, then the port's
    ``generate.py -r <merged>``: its greedy tokens must equal the adapted
    model's (a ``GenerationService`` over the trained model). Then
    ``mistral`` (``configs/mistral_7b_lora.json``: Mistral-7B's widths and
    depth over a random-init base, float32 base params, bf16 compute,
    remat, flash, seq 1024, batch 1, synthetic tokens, rank 8, the
    adapters alone): peak memory under ``MEMORY_LIMIT_GIB``, every loss
    finite, every base tensor's checksums unchanged (:func:`_checksums`),
    ms per step and MFU. Returns the Mistral run's launches per kernel
    (the small run's attention is ``xla``)."""
    from pytorch_distributed_template_tpu_torch import generate as gen_cli
    from pytorch_distributed_template_tpu_torch.engine.serving import (
        GenerationService,
    )
    from pytorch_distributed_template_tpu_torch.tools import (
        bert_transfer_experiment as tool, merge_lora,
    )

    root = work / "lora_llama"
    with _TF32(False, False):
        trainer, run, wall = _counted_run(
            card, device, tool.train_argv(config, root / "small", seed, sets,
                                          device), "lora-llama")
        path = merge_lora.main(["-r", str(trainer.config.save_dir /
                                          "model_best"),
                                "-s", str(root / "merge_log")])
        prompt = [1, 2, 3, 4, 5, 6, 7, 8]
        # the adapted model served as generate.py serves the artifact
        # (the config's serving section: its paged prefix pool)
        want = GenerationService.from_model(
            trainer.model, device=device, prefix_cache=(
                trainer.config.config.get("serving") or {}).get(
                "prefix_cache")).generate(
            prompt_ids=prompt, max_new_tokens=LORA_GREEDY)["ids"]
        got = gen_cli.main(["-r", str(path), "--prompt-ids",
                            ",".join(map(str, prompt)), "--max-new-tokens",
                            str(LORA_GREEDY), "--device", str(device), "-s",
                            str(root / "gen_log")])["ids"]
    row = {"run": _run_row(run, wall), "adapted_greedy": want,
           "merged_generate_py": got, "identical": want == got,
           "card": card}
    log("[lora] (llama f32) " + json.dumps(row))
    if want != got:
        raise AssertionError(f"the merged artifact's greedy tokens differ "
                             f"from the adapted model's: {row}")
    del trainer, run
    _release(device)

    sums = {}

    def snapshot(trainer):
        m = trainer.model
        sums["before"] = _checksums(m)
        log(f"[lora] (mistral) {type(m).__name__}: {m.n_layer} layers, "
            f"d_model {m.d_model}, {m.n_head}/{m.n_kv_head} heads, "
            f"{sum(p.numel() for p in m.parameters()) / 1e9:.3f} B params "
            f"({sum(p.numel() for p in m.parameters() if p.requires_grad)}"
            f" trainable), {next(m.parameters()).dtype} params, {m.dtype} "
            f"compute, remat {m.remat}, {m.attn_impl}")

    trainer, run, wall = _counted_run(
        card, device, tool.train_argv(mistral, root / "mistral", seed,
                                      mistral_sets, device),
        "lora-mistral", check=snapshot)
    after = _checksums(trainer.model)
    moved = [k for k in after if after[k] != sums["before"][k]]
    mrow = dict(_run_row(run, wall), base_tensors=len(after),
                base_moved=moved[:5], memory_limit_gib=MEMORY_LIMIT_GIB,
                card=card)
    log("[lora] (mistral) " + json.dumps(mrow))
    if moved or mrow["peak_mem_gib_max"] >= MEMORY_LIMIT_GIB:
        raise AssertionError(f"LoRA at Mistral width: {mrow}")
    launches = mrow["launches"]
    del trainer, run
    _release(device)
    shutil.rmtree(root)
    return launches


# ---------------------------------------------------------------------------
# slice 12: pipeline parallelism (the pipe axis, GPipe and circular
# schedules, the pipelined GPT-2 / Llama) and the HF weight import; no TPU
# kernel on this path (the pipelined trunk's attention is the plain einsum
# attention, as in the JAX trunk)
# ---------------------------------------------------------------------------

GPT2_PP_CONFIG = REPO / "configs" / "gpt2_pp.json"
# phase 17a: a small f32 TinyPipeLM in the circular layout ([S 2, V 2, Lc
# 1]), remat and the fused head, card against CPU (phase 3c's limits)
PIPE_REF = {"vocab_size": 512, "n_layer": 4, "n_head": 4, "d_model": 128,
            "max_len": 64, "n_stages": 2, "n_chunks": 2,
            "n_microbatches": 2, "remat": True, "fused_head": True}
# phase 17b: gpt2_pp.json on one card: the mesh cut to the data axis (the
# sequential trunk over the [S 4, V 3, Lc 1] stacks), the sample counts and
# the epochs cut as phase 6's
PP_TRAIN_SETS = [("mesh;axes", {"data": -1}), ("train_loader;args;n", 256),
                 ("valid_loader;args;n", 64), ("trainer;epochs", 2),
                 ("trainer;save_period", 1)]
# phase 17c: gpt2_pp.json on 4 cards (pipe 4 as it is) against one rank
# without a pipe axis: 2 epochs of 3 steps (batch 16 in 2 accumulation
# pieces of 8 microbatches), a checkpoint each; float32 without TF32, then
# bf16 as the config has it for the step times
PP_NCCL_COMMON = [("train_loader;args;n", 48), ("valid_loader;args;n", 16),
                  ("trainer;epochs", 2), ("trainer;save_period", 1),
                  ("trainer;tensorboard", False)]
PP_NCCL_F32 = [("arch;args;bfloat16", False)]
PP_NCCL_BF16 = [("trainer;epochs", 1), ("trainer;save_period", 100)]
PP_ONE_RANK = [("mesh;axes", {"data": 1})]
PP_NCCL_STEPS = 6


def pp_ticks(m: int, s: int, v: int) -> int:
    """Ticks of one pipelined forward: ``ceil(M/S) S V + S - 1``."""
    return -(-m // s) * s * v + s - 1


def phase_pipe_reference(device="cuda") -> None:
    """Phase 17a: a small f32 ``TinyPipeLM`` (circular layout, remat,
    fused head) trained ``TRAIN_REF_STEPS`` steps on ``device`` and on the
    CPU from the same weights and batches, TF32 off: per-step losses and
    final params within ``TRAIN_REF_TOL``."""
    import pytorch_distributed_template_tpu_torch.models  # noqa: F401
    from pytorch_distributed_template_tpu_torch.config.registry import (
        MODELS,
    )
    from pytorch_distributed_template_tpu_torch.data.datasets import (
        synthetic_lm,
    )

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        args = PIPE_REF
        cpu = MODELS.get("TinyPipeLM")(**args, device="cpu")
        cpu.init_weights(torch.Generator().manual_seed(7))
        state = cpu.state_dict()
        toks = synthetic_lm(n=4 * TRAIN_REF_STEPS, seq_len=args["max_len"],
                            vocab_size=args["vocab_size"], seed=1)["tokens"]
        batches = [{"tokens": toks[4 * i:4 * i + 4],
                    "mask": np.ones(4, bool)}
                   for i in range(TRAIN_REF_STEPS)]
        dev_loss, dev_p = _train_ref_run("TinyPipeLM", args, state, batches,
                                         device)
        cpu_loss, cpu_p = _train_ref_run("TinyPipeLM", args, state, batches,
                                         "cpu")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(dev_loss, cpu_loss))
    param_err = max((dev_p[k] - cpu_p[k]).abs().max().item() for k in cpu_p)
    row = {"model": "TinyPipeLM", "layout": list(state["qkv_k"].shape[:3]),
           "steps": TRAIN_REF_STEPS, "losses_device": dev_loss,
           "losses_cpu": cpu_loss, "loss_max_rel_err": loss_err,
           "param_max_abs_err": param_err, "tol": TRAIN_REF_TOL,
           "device": str(device)}
    log("[pipe-reference] " + json.dumps(row))
    if not (loss_err <= TRAIN_REF_TOL["loss_rtol"]
            and param_err <= TRAIN_REF_TOL["param_atol"]):
        raise AssertionError(f"small f32 TinyPipeLM training on {device} "
                             f"differs from the CPU: {row}")


def phase_pp_train(card: str, device="cuda", config=GPT2_PP_CONFIG,
                   sets=PP_TRAIN_SETS, work=WORK) -> dict:
    """Phase 17b: ``configs/gpt2_pp.json`` through the port's ``train.py``
    on one card, the mesh cut to the data axis by ``--set`` (the
    sequential trunk over the config's ``[S 4, V 3, Lc 1]`` stacks, no
    kernel launched: :class:`TrainRun` holds every count at 0), train
    ``n`` 256, valid ``n`` 64, 2 epochs with a checkpoint each
    (:func:`_train_path`: losses finite and falling, checkpoints and
    ``summary.json``, a resume from ``checkpoint-epoch1`` reproducing
    epoch 2, ms/step, peak memory, a 5-step profile)."""
    def check(trainer, run):
        m = trainer.model
        lead = tuple(m.qkv_k.shape[:3])
        want = (m.n_stages, m.n_chunks, m.n_layer // (m.n_stages
                                                       * m.n_chunks))
        if lead != want or m.placements or trainer.mesh.axis_size(
                "pipe") != 1:
            raise AssertionError(f"[pp_train] trunk {lead}, placements "
                                 f"{m.placements}, mesh "
                                 f"{trainer.mesh.sizes}")
        log("[pp_train] " + json.dumps({
            "layout": list(lead), "grad_accum_steps":
            trainer.train_step.grad_accum_steps,
            "microbatches": m.n_microbatches, "card": card}))

    return _train_path(card, device, config, sets, work / "pp_train", 0,
                       label="pp_train", check=check)


def _pp_argv(config, sets, save_dir, device) -> list:
    argv = ["-c", str(config), "-s", str(save_dir), "--device", str(device)]
    for chain, value in sets:
        argv += ["--set", chain, json.dumps(value)]
    return argv


def _torchrun_child(flag, spec, spec_path, label, nproc, timeout):
    """``torchrun --nproc_per_node=nproc`` of this script's ``flag``
    child (``--sp-child`` or ``--tp-child``) on ``spec``, written to
    ``spec_path``: each rank's record (``<out>.rank<R>.json``) and the
    wall seconds."""
    spec_path.write_text(json.dumps(spec))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", str(REPO / "chip_smoke.py"),
           flag, str(spec_path)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=timeout)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        # the whole output beside the spec; the error quotes the ranks'
        # first traceback and the end of their stderr (a rank that aborts
        # leaves no Python traceback, only the watchdog's lines)
        log_path = spec_path.with_suffix(".log")
        log_path.write_text(r.stdout + "\n--- stderr ---\n" + r.stderr)
        err = r.stderr + r.stdout
        at = err.find("Traceback")
        head = err[at:at + 3000] if at >= 0 else ""
        raise AssertionError(f"[{label}] torchrun exited {r.returncode} "
                             f"(output: {log_path}): {head}\n...\n"
                             f"{r.stderr[-5000:]}")
    return [json.loads(Path(f"{spec['out']}.rank{i}.json").read_text())
            for i in range(nproc)], wall


def _pp_torchrun(tag, name, config, sets, root, device, nproc, timeout):
    """``torchrun --nproc_per_node=nproc`` of ``config`` cut by ``sets``
    (this script's ``--sp-child`` per rank): each rank's record."""
    spec = {"argv": _pp_argv(config, sets, root / f"{name}_ranks", device),
            "out": str(root / f"{name}_out")}
    return _torchrun_child("--sp-child", spec, root / f"{name}.json",
                           f"{tag}] [{name}", nproc, timeout)


def _one_rank(argv, device):
    """The port's ``train.py`` in this process: each train step's loss and
    ms, and the trainer."""
    from pytorch_distributed_template_tpu_torch import train as train_cli

    steps, box = [], {}

    def hook(trainer):
        box["trainer"] = trainer
        real = trainer.train_step

        def call(batch):
            _sync(trainer.device)
            t0 = time.perf_counter()
            m = real(batch)
            _sync(trainer.device)
            steps.append({"loss": float(m["loss_sum"])
                          / max(float(m["count"]), 1.0),
                          "ms": (time.perf_counter() - t0) * 1e3})
            return m

        trainer.train_step = _Wrapped(real, call)

    train_cli.main(argv, on_trainer=hook)
    return steps, box["trainer"]


def phase_pp_nccl(card: str, device="cuda", work=WORK,
                  config=GPT2_PP_CONFIG, nproc: int = 4,
                  timeout: float = 900.0, common=PP_NCCL_COMMON,
                  f32=PP_NCCL_F32, bf16=PP_NCCL_BF16,
                  n_steps: int = PP_NCCL_STEPS) -> dict:
    """Phase 17c: with ``nproc`` cards, ``torchrun --nproc_per_node=nproc``
    of ``configs/gpt2_pp.json`` with its pipe axis of 4 (``PP_NCCL_COMMON``:
    2 epochs of 3 steps, a checkpoint each), float32 without TF32, against
    one rank in this process without a pipe axis: the losses within
    ``SEQ_NCCL_RTOL``, every rank the same losses; each rank's parameter
    bytes a quarter of the trunk's plus the replicated parameters'; the
    permutes per train step ``grad_accum_steps`` x (the forward's ticks + the
    backward's, one fewer) and two output sums per piece; the ranks'
    ``checkpoint-epoch1`` resumed in this process without a pipe axis
    reproducing the ranks' epoch-2 losses within ``SEQ_NCCL_RTOL``. Then
    one bf16 run of the config as it is (``PP_NCCL_BF16``: one epoch):
    ms/step and the P2P calls and bytes per step. With fewer cards it
    prints ``"pp_nccl": "not run: N card(s)"`` and returns {}. ``common``,
    ``f32``, ``bf16`` and ``n_steps`` cut the runs (a tiny width on the
    CPU: the ``--sp-child`` ranks run on gloo with ``--device cpu``)."""
    cards = torch.cuda.device_count() if device == "cuda" else nproc
    if device == "cuda" and cards < nproc:
        log("[pp_nccl] " + json.dumps({
            "pp_nccl": f"not run: {cards} card(s)", "card": card}))
        return {}
    root = work / "pp_nccl"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    cfg = json.loads(Path(config).read_text())
    for chain, value in list(common) + list(f32):
        node = cfg
        *head, last = chain.split(";")
        for k in head:
            node = node[k]
        node[last] = value
    args = cfg["arch"]["args"]
    accum = int(cfg["trainer"].get("grad_accum_steps", 1))
    pieces = cfg["train_loader"]["args"]["batch_size"] // accum
    ticks = pp_ticks(min(args["n_microbatches"], pieces), args["n_stages"],
                     args["n_chunks"])
    want_permutes = accum * (ticks + ticks - 1)
    f32_sets = list(common) + list(f32)
    ranks, wall = _pp_torchrun("pp_nccl", "f32", config, f32_sets, root,
                               device, nproc, timeout)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        one, trainer = _one_rank(_pp_argv(config, f32_sets + PP_ONE_RANK,
                                          root / "one", device), device)
        one_bytes = _param_bytes(trainer.model, ranks[0]["placed"])
        del trainer
        resumed, _ = _one_rank([
            "-r", str(Path(ranks[0]["run_dir"]) / "checkpoint-epoch1"),
            "-s", str(root / "resume"), "--device", str(device),
            "--set", "mesh;axes", json.dumps({"data": 1})], device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    losses = [s["loss"] for s in ranks[0]["steps"]]
    one_losses = [s["loss"] for s in one]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, one_losses)]
    half = n_steps // 2
    rel_resume = [abs(a - b) / abs(b) for a, b in zip(
        [s["loss"] for s in resumed], losses[half:])]
    row = {"config": "gpt2_pp", "mesh": ranks[0]["mesh"],
           "world": ranks[0]["world"], "backend": ranks[0]["backend"],
           "ddp": ranks[0]["ddp"], "losses": losses,
           "one_rank_losses": one_losses, "rel_diff": rel,
           "resumed_epoch2_losses": [s["loss"] for s in resumed],
           "resume_rel_diff": rel_resume, "rtol": SEQ_NCCL_RTOL,
           "ticks_per_forward": ticks, "permutes_per_step_want":
           want_permutes,
           "param_bytes_per_rank": [r["param_bytes"] for r in ranks],
           "one_rank_param_bytes": one_bytes,
           "ms_per_step": [s["ms"] for s in ranks[0]["steps"]],
           "one_rank_ms_per_step": [s["ms"] for s in one],
           "p2p_per_step": [{k: s[k] for k in (
               "ppermute", "ppermute_bytes", "psum", "psum_bytes")}
               for s in ranks[0]["steps"]],
           "torchrun_wall_s": wall, "dtype": "float32", "card": card}
    log("[pp_nccl] " + json.dumps(row))
    for rk in ranks:
        if [s["loss"] for s in rk["steps"]] != losses:
            raise AssertionError(f"[pp_nccl] rank {rk['rank']} logged other "
                                 f"losses")
        if rk["ddp"] or rk["backend"] != ("nccl" if device == "cuda"
                                          else "gloo"):
            raise AssertionError(f"[pp_nccl] rank {rk['rank']}: ddp "
                                 f"{rk['ddp']}, {rk['backend']}")
        pb = rk["param_bytes"]
        if (pb["stage"] * nproc != one_bytes["stage"]
                or pb["replicated"] != one_bytes["replicated"]):
            raise AssertionError(f"[pp_nccl] rank {rk['rank']} holds "
                                 f"{pb}, not 1/{nproc} of {one_bytes}")
        for s in rk["steps"]:
            if (s["ppermute"], s["psum"]) != (want_permutes, 2 * accum):
                raise AssertionError(
                    f"[pp_nccl] rank {rk['rank']}: {s['ppermute']} permutes "
                    f"and {s['psum']} sums in a step, not {want_permutes} "
                    f"and {2 * accum}")
    if (len(losses) != n_steps or len(one_losses) != n_steps
            or len(rel_resume) != half or max(rel + rel_resume)
            > SEQ_NCCL_RTOL):
        raise AssertionError(f"[pp_nccl] {nproc} ranks against one rank: "
                             f"{row}")
    gc.collect()
    torch.cuda.empty_cache() if device == "cuda" else None
    half16, wall16 = _pp_torchrun("pp_nccl", "bf16", config,
                                  list(common) + list(bf16), root, device,
                                  nproc, timeout)
    steps = half16[0]["steps"]
    row16 = {"config": "gpt2_pp", "dtype": "bfloat16",
             "mesh": half16[0]["mesh"],
             "losses": [s["loss"] for s in steps],
             "ms_per_step": [s["ms"] for s in steps],
             "ms_per_step_median": float(np.median([s["ms"]
                                                    for s in steps[1:]])),
             "p2p_per_step": [{k: s[k] for k in (
                 "ppermute", "ppermute_bytes", "psum", "psum_bytes")}
                 for s in steps],
             "param_bytes_per_rank": [r["param_bytes"] for r in half16],
             "torchrun_wall_s": wall16, "card": card}
    log("[pp_nccl] " + json.dumps(row16))
    if not all(np.isfinite(row16["losses"])):
        raise AssertionError(f"[pp_nccl] bf16 losses: {row16['losses']}")
    shutil.rmtree(root)
    return {"f32": row, "bf16": row16}


def phase_hf_import(card: str, device="cuda", config=TRAIN_CONFIG,
                    base=GPT2_BASE, drop_base: bool = True) -> dict:
    """Phase 17d: phase 6's GPT-2 small (``base``'s ``checkpoint-epoch1``,
    cell (h)'s config) on the card, exported to an HF ``GPT2LMHeadModel``
    state dict and imported again (``models/hf_import.py``, numpy on the
    host): every tensor and the logits of 2 x 1024 tokens bit-equal to the
    model's; the export and import times printed. ``base`` is removed at
    the end unless ``drop_base`` is False (phase 21b serves it)."""
    import pytorch_distributed_template_tpu_torch.models  # noqa: F401
    from pytorch_distributed_template_tpu_torch.config.registry import (
        MODELS,
    )
    from pytorch_distributed_template_tpu_torch.models import hf_import

    ckpt = Path(base) / "checkpoint-epoch1" / "model.pt"
    if not ckpt.is_file():
        raise AssertionError(f"no base weights at {ckpt} (phase 6 keeps "
                             "them)")
    arch = json.loads(Path(config).read_text())["arch"]

    def build():
        return MODELS.get(arch["type"])(
            **arch["args"], device=device,
            param_dtype=torch.float32).eval()

    model = build()
    model.load_state_dict(torch.load(ckpt, map_location=device))
    toks = torch.from_numpy(np.random.default_rng(17).integers(
        0, model.vocab_size, (2, model.max_len))).to(device)

    def logits(m):
        with torch.no_grad():
            out = m(toks)
            if isinstance(out, tuple):
                out = out[0] @ out[1]
            return out.float()

    want = logits(model)
    t0 = time.perf_counter()
    exported = hf_import.export_hf_gpt2(model.state_dict())
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = hf_import.import_hf_gpt2(exported, model.n_layer)
    t_import = time.perf_counter() - t0
    again = build()
    again.load_state_dict(back)
    got = logits(again)
    tensors = model.state_dict()
    differ = [k for k in tensors if not torch.equal(
        tensors[k], again.state_dict()[k])]
    row = {"model": f"{arch['type']} {arch['args'].get('size')}",
           "hf_tensors": len(exported), "export_s": t_export,
           "import_s": t_import, "tensors_differing": differ,
           "logits_shape": list(got.shape),
           "logits_max_abs_err": float((got - want).abs().max()),
           "card": card}
    log("[hf_import] " + json.dumps(row))
    if differ or not torch.equal(got, want):
        raise AssertionError(f"[hf_import] the round trip changed the "
                             f"model: {row}")
    del model, again, tensors
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    if drop_base:
        shutil.rmtree(base)
    return row


# ---------------------------------------------------------------------------
# slice 13: tensor parallelism and ZeRO-3 (the tensor and fsdp mesh axes on
# the GPT-2 and Llama families); B1-B3 run on each tensor rank's local
# heads, no new kernel
# ---------------------------------------------------------------------------

MISTRAL_FSDP_CONFIG = REPO / "pytorch_distributed_template_tpu_torch" \
    / "configs" / "mistral_7b_fsdp.json"
# phase 18a: B1-B3 at the per-rank shapes of Mistral-7B on a tensor axis
# (32/8 heads split 4 or 2 ways; T 4096, D 128, the 4096-token band): one
# row under tensor 4, the four rows each tensor-4 rank runs at 18c's global
# batch (every rank of a tensor row reads the batch), and tensor 2
TP_KERNEL_SHAPES = [
    (1, 8, 2, 4096, 128, True, 4096, torch.bfloat16),
    (4, 8, 2, 4096, 128, True, 4096, torch.bfloat16),
    (1, 16, 4, 4096, 128, True, 4096, torch.bfloat16),
]
TP_BWD_SHAPES = [
    ("mistral_tensor4", 1, 8, 2, 4096, 128, True, 4096, torch.bfloat16,
     False),
    ("mistral_tensor2", 1, 16, 4, 4096, 128, True, 4096, torch.bfloat16,
     False),
]
# phase 18b: mistral_7b_fsdp.json cut to 2 layers (every width as it is),
# float32 without TF32, 3 steps of the global batch 4 on each mesh (the
# fsdp-4 run 2 epochs, a checkpoint each: the only run that saves),
# against one rank without a tensor or fsdp axis
TP_NCCL_COMMON = [("arch;args;n_layer", 2), ("arch;args;bfloat16", False),
                  ("train_loader;args;n", 12), ("valid_loader;args;n", 4)]
TP_NO_SAVE = [("trainer;save_period", 1000)]
TP_NCCL_MESHES = [("fsdp4", {"fsdp": 4}), ("tensor4", {"tensor": 4}),
                  ("fsdp2_tensor2", {"fsdp": 2, "tensor": 2}),
                  ("data2_fsdp2", {"data": 2, "fsdp": 2})]
TP_NCCL_STEPS = 3
TP_GLOBAL_BATCH = 4
# phase 18c: the config as it is (bf16, 32 layers), 5 steps on each mesh
TP_FULL_MESHES = [("fsdp4", {"fsdp": 4}), ("tensor4", {"tensor": 4})]
TP_FULL_COMMON: list = []
# the two meshes' bf16 losses from the same weights and rows: bf16's
# rounding of the same sums taken in other orders
TP_BF16_RTOL = 2e-2
GIB = 1 << 30
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
COLLECTIVE_KEYS = ("all_gather", "all_gather_bytes", "reduce_scatter",
                   "reduce_scatter_bytes", "all_reduce", "all_reduce_bytes",
                   "psum", "psum_bytes")


def _tp_sets(mesh: dict, batch: int = TP_GLOBAL_BATCH) -> list:
    """The mesh, and the loaders' per-shard batch of the global ``batch``."""
    shards = mesh.get("data", 1) * mesh.get("fsdp", 1)
    return [("mesh;axes", mesh),
            ("train_loader;args;batch_size", batch // shards),
            ("valid_loader;args;batch_size", batch // shards)]


def _flash_counts() -> list:
    from pytorch_distributed_template_tpu_torch.ops import flash

    return [flash.FLASH_FWD.launches, flash.FLASH_BWD_DKV.launches,
            flash.FLASH_BWD_DQ.launches]


def _count_plain_flash() -> None:
    """On the CPU (a rehearsal): the plain attention versions count as the
    kernels' launches, as the tests' ``counted_plain`` does."""
    from pytorch_distributed_template_tpu_torch.ops import flash

    fwd, bwd = flash.flash_attention_ref, flash.flash_attention_bwd_ref

    def counted_fwd(*args, **kw):
        flash.FLASH_FWD.launches += 1
        return fwd(*args, **kw)

    def counted_bwd(*args, **kw):
        flash.FLASH_BWD_DKV.launches += 1
        flash.FLASH_BWD_DQ.launches += 1
        return bwd(*args, **kw)

    flash.flash_attention_ref = counted_fwd
    flash.flash_attention_bwd_ref = counted_bwd


def tp_child(spec_path: str) -> int:
    """One rank of phases 18b/18c (``chip_smoke.py --tp-child SPEC`` under
    ``torchrun``): the port's ``train.py`` on each of the spec's argvs in
    turn, TF32 off;
    writes per run each train step's loss, ms and collective calls and
    bytes, the B1-B3 launches, the peak memory, the placements and the
    parameter bytes to ``<out>.rank<R>.json``."""
    from pytorch_distributed_template_tpu_torch import train as train_cli
    from pytorch_distributed_template_tpu_torch.parallel import (
        collectives, dist,
    )

    spec = json.loads(Path(spec_path).read_text())
    if spec.get("count_plain"):
        _count_plain_flash()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {}
    for name, argv in spec["runs"]:
        steps, box = [], {}

        def hook(trainer):
            box["trainer"] = trainer
            cuda = trainer.device.type == "cuda"
            box["peak_setup"] = (torch.cuda.max_memory_allocated() / GIB
                                 if cuda else 0.0)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            box["launches"] = _flash_counts()
            real = trainer.train_step

            def call(batch):
                _sync(trainer.device)
                collectives.reset_counts()
                t0 = time.perf_counter()
                m = real(batch)
                _sync(trainer.device)
                steps.append({"loss": float(m["loss_sum"])
                              / max(float(m["count"]), 1.0),
                              "ms": (time.perf_counter() - t0) * 1e3,
                              **{k: collectives.P2P[k]
                                 for k in COLLECTIVE_KEYS}})
                return m

            trainer.train_step = _Wrapped(real, call)

        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        train_cli.main(argv, on_trainer=hook)
        t = box["trainer"]
        cuda = t.device.type == "cuda"
        placed = t.model.placements
        result[name] = {
            "steps": steps, "mesh": t.mesh.sizes, "ddp": t.ddp is not None,
            "backend": dist.backend(), "world": dist.process_count(),
            "run_dir": str(t.config.save_dir),
            "launches": [b - a for a, b in zip(box["launches"],
                                               _flash_counts())],
            "peak_gib_setup": box["peak_setup"],
            "peak_gib_steps": (torch.cuda.max_memory_allocated() / GIB
                               if cuda else 0.0),
            "placements": {n: pl.axis for n, pl in placed.items()},
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in t.model.parameters()),
            "params_whole": sum(p.numel() * (t.mesh.axis_size(
                placed[n].axis) if n in placed else 1)
                for n, p in t.model.named_parameters())}
        del t
        box.clear()
        _release("cuda" if cuda else "cpu")
    rank = dist.process_index()
    Path(f"{spec['out']}.rank{rank}.json").write_text(json.dumps(
        {"rank": rank, "runs": result}))
    dist.shutdown()
    return 0


def _tp_torchrun(tag, runs, root, device, nproc, timeout):
    """``torchrun --nproc_per_node=nproc`` of this script's ``--tp-child``
    over ``runs`` (``[(name, argv)]``): each rank's record."""
    spec = {"runs": runs, "out": str(root / f"{tag}_out"),
            "count_plain": torch.device(device).type == "cpu"}
    return _torchrun_child("--tp-child", spec, root / f"{tag}.json", tag,
                           nproc, timeout)


def _not_run(tag, device, nproc, card, key="tp_fsdp") -> bool:
    cards = torch.cuda.device_count() if device == "cuda" else nproc
    if device == "cuda" and cards < nproc:
        log(f"[{tag}] " + json.dumps({key: f"not run: {cards} "
                                      "card(s)", "card": card}))
        return True
    return False


def _expected_bytes(model, placements: dict, mesh: dict) -> int:
    """A rank's parameter bytes under ``placements`` (``{name: axis}``) of
    the whole ``model``: a placed tensor's share, the others whole."""
    return sum(p.numel() * p.element_size()
               // mesh.get(placements.get(n), 1)
               for n, p in model.named_parameters())


def phase_tp_nccl(card: str, device="cuda", work=WORK,
                  config=MISTRAL_FSDP_CONFIG, nproc: int = 4,
                  timeout: float = 900.0, common=TP_NCCL_COMMON,
                  meshes=TP_NCCL_MESHES,
                  n_steps: int = TP_NCCL_STEPS, saver: str = "fsdp4",
                  resume_on=("resumed_tensor4", {"tensor": 4}),
                  tag: str = "tp_nccl", key: str = "tp_fsdp",
                  saver_epochs: int = 2) -> dict:
    """Phase 18b: with ``nproc`` cards, a ``torchrun`` for each mesh trains
    ``configs/mistral_7b_fsdp.json`` cut by ``TP_NCCL_COMMON`` (2 layers,
    float32 without TF32) for ``n_steps`` steps on each of
    ``TP_NCCL_MESHES`` (the fsdp-4 run two epochs, a checkpoint each), then
    one resumes the fsdp-4 run's ``checkpoint-epoch1`` on ``{"tensor": 4}``;
    against one rank in this process without those axes (two epochs),
    and that checkpoint resumed in this process: every mesh's losses within
    ``SEQ_NCCL_RTOL`` of the one rank's, every rank the same losses, no
    DDP, each rank's parameter bytes the placement's share of the one
    rank's, B1-B3 launched on every rank; the resumed runs' losses equal
    the fsdp-4 run's epoch 2. Prints the collectives' calls and bytes per
    step. With fewer cards it prints ``"tp_fsdp": "not run: N card(s)"``
    and returns {}. ``common``, ``meshes`` and ``n_steps`` cut it (a tiny
    width on the CPU: the ranks run on gloo with ``--device cpu``). Phase
    20b runs it on ``mixtral_8x7b_ep.json`` (``saver`` the mesh that writes
    the checkpoint, for ``saver_epochs`` 1 the one epoch whose checkpoint
    the one-process resume reads, its epoch 2 then held against the one
    rank's; ``resume_on`` None: no resume on the ranks; a mesh without a
    model-parallel axis runs DDP)."""
    if _not_run(tag, device, nproc, card, key):
        return {}
    root = work / tag
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    runs = []
    for name, mesh in meshes:
        saves = ([("trainer;epochs", saver_epochs),
                  ("trainer;save_period", 1)]
                 if name == saver else [("trainer;epochs", 1)]
                 + TP_NO_SAVE)
        runs.append((name, _pp_argv(config, list(common) + _tp_sets(mesh)
                                    + saves, root / name, device)))
    resumed_meshes = [] if resume_on is None else [resume_on]
    for name, mesh in resumed_meshes:
        runs.append((name, [
            "-r", f"@{saver}", "-s", str(root / "resumed"), "--device",
            str(device)] + sum((["--set", k, json.dumps(v)] for k, v in
                                _tp_sets(mesh) + TP_NO_SAVE), [])))
    # each mesh in a torchrun of its own, one process group per mesh: on
    # four H100s a second mesh in the ranks of a first that had written two
    # 38 GB checkpoints hung on NCCL, where gloo with the collective checker
    # (TORCH_DISTRIBUTED_DEBUG=DETAIL) finds every collective matched
    ranks, wall = [{"runs": {}} for _ in range(nproc)], 0.0
    for name, argv in runs:
        argv = [ranks[0]["runs"][a[1:]]["run_dir"] + "/checkpoint-epoch1"
                if a.startswith("@") else a for a in argv]
        part, secs = _tp_torchrun(f"{tag}_{name}", [(name, argv)], root,
                                  device, nproc, timeout)
        wall += secs
        ranks = [{**b, "runs": {**a["runs"], **b["runs"]}}
                 for a, b in zip(ranks, part)]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        one, trainer = _one_rank(_pp_argv(
            config, list(common) + _tp_sets({"data": 1})
            + [("trainer;epochs", 2)] + TP_NO_SAVE, root / "one", device),
            device)
        model = trainer.model
        expected = {name: _expected_bytes(
            model, ranks[0]["runs"][name]["placements"], mesh)
            for name, mesh in meshes}
        whole = sum(p.numel() for p in model.parameters())
        del trainer, model
        _release(device)
        resumed = _one_rank([
            "-r", str(Path(ranks[0]["runs"][saver]["run_dir"])
                      / "checkpoint-epoch1"),
            "-s", str(root / "resume_one"), "--device", str(device)]
            + sum((["--set", k, json.dumps(v)] for k, v in
                   _tp_sets({"data": 1}) + TP_NO_SAVE
                   + [("trainer;epochs", 2)]), []), device)[0]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    one_losses = [s["loss"] for s in one]
    out = {}
    for name, mesh in meshes + resumed_meshes:
        first = ranks[0]["runs"][name]
        losses = [s["loss"] for s in first["steps"]]
        want = (one_losses[n_steps:] if name.startswith("resumed")
                else one_losses[:len(losses)])
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
        row = {"mesh": name, "sizes": first["mesh"],
               "world": first["world"], "backend": first["backend"],
               "losses": losses, "one_rank_losses": want, "rel_diff": rel,
               "rtol": SEQ_NCCL_RTOL,
               "param_bytes_per_rank": [r["runs"][name]["param_bytes"]
                                        for r in ranks],
               "launches_per_rank": [r["runs"][name]["launches"]
                                     for r in ranks],
               "ms_per_step": [s["ms"] for s in first["steps"]],
               "collectives_per_step": [{k: s[k] for k in COLLECTIVE_KEYS}
                                        for s in first["steps"]],
               "peak_gib_steps_per_rank": [r["runs"][name]["peak_gib_steps"]
                                           for r in ranks],
               "dtype": "float32", "card": card}
        log(f"[{tag}] " + json.dumps(row))
        n_want = saver_epochs * n_steps if name == saver else n_steps
        if len(losses) != n_want or max(rel) > SEQ_NCCL_RTOL:
            raise AssertionError(f"[{tag}] {name}: {nproc} ranks' losses "
                                 f"{losses} against one rank's {want}")
        for rk in ranks:
            run = rk["runs"][name]
            if [s["loss"] for s in run["steps"]] != losses:
                raise AssertionError(f"[{tag}] {name}: rank {rk['rank']} "
                                     "logged other losses")
            split = any(mesh.get(a, 1) > 1 for a in
                        ("fsdp", "expert", "tensor"))
            if run["ddp"] == split or run["backend"] != (
                    "nccl" if device == "cuda" else "gloo"):
                raise AssertionError(f"[{tag}] {name}: rank {rk['rank']}: "
                                     f"ddp {run['ddp']}, {run['backend']}")
            if not all(run["launches"]):
                raise AssertionError(f"[{tag}] {name}: rank {rk['rank']} "
                                     f"launched B1-B3 {run['launches']}")
            if run["params_whole"] != whole or (
                    name in expected
                    and run["param_bytes"] != expected[name]):
                raise AssertionError(
                    f"[{tag}] {name}: rank {rk['rank']} holds "
                    f"{run['param_bytes']} bytes of {run['params_whole']} "
                    f"params, not {expected.get(name)} of {whole}")
        out[name] = row
    resumed_losses = [s["loss"] for s in resumed]
    fsdp_epoch2 = ([s["loss"] for s in
                    ranks[0]["runs"][saver]["steps"]][n_steps:]
                   if saver_epochs > 1 else one_losses[n_steps:])
    rel = [abs(a - b) / abs(b) for a, b in zip(resumed_losses, fsdp_epoch2)]
    log(f"[{tag}] " + json.dumps({
        "resumed_one_rank": resumed_losses, f"{saver}_epoch2": fsdp_epoch2,
        "rel_diff": rel, "torchrun_wall_s": wall, "card": card}))
    if len(resumed_losses) != n_steps or max(rel) > SEQ_NCCL_RTOL:
        raise AssertionError(f"[{tag}] the {saver} checkpoint resumed in "
                             f"one process: {resumed_losses} against "
                             f"{fsdp_epoch2}")
    shutil.rmtree(root)
    # the one-rank runs' cached blocks back to the card: the next phase's
    # rank on card 0 needs them
    _release(device)
    return out


def phase_tp_full(card: str, device="cuda", work=WORK,
                  config=MISTRAL_FSDP_CONFIG, nproc: int = 4,
                  timeout: float = 1200.0, common=TP_FULL_COMMON,
                  meshes=TP_FULL_MESHES,
                  peak_flops: float = PEAK_FLOPS[torch.bfloat16],
                  tag: str = "tp_full", key: str = "tp_fsdp",
                  flops_per_step=None) -> dict:
    """Phase 18c: with ``nproc`` cards, one ``torchrun`` trains
    ``configs/mistral_7b_fsdp.json`` as it is (Mistral-7B at its published
    widths and depth, bf16 over float32 master weights, remat, flash) for
    an epoch (5 steps of the global batch 4 x 4096 tokens) on ``{"fsdp":
    4}``, then on ``{"tensor": 4}``: every loss finite, the two meshes'
    losses within ``TP_BF16_RTOL`` of each other, every rank's peak memory
    under the card's, B1-B3 launched on every rank. Prints ms per step,
    MFU (6 N tokens per step, the remat recompute not counted, over
    ``nproc`` cards' bf16 peak), the peak memory and the collectives'
    calls and bytes per step per rank. With fewer cards it prints
    ``"tp_fsdp": "not run: N card(s)"`` and returns {}. Phase 20c runs it
    on ``mixtral_8x7b_ep.json`` over one mesh (no second to compare) with
    ``flops_per_step`` a callable giving the model's count
    (``train_step_flops``: the active experts' weights at top_k / E, the
    attention's visible keys)."""
    if _not_run(tag, device, nproc, card, key):
        return {}
    _release(device)    # card 0 is shared with this process
    root = work / tag
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    cfg = json.loads(Path(config).read_text())
    for chain, value in common:
        node = cfg
        *head, last = chain.split(";")
        for k in head:
            node = node[k]
        node[last] = value
    tokens = TP_GLOBAL_BATCH * cfg["train_loader"]["args"]["seq_len"]
    runs = [(name, _pp_argv(config, list(common) + _tp_sets(mesh),
                            root / name, device)) for name, mesh in meshes]
    ranks, wall = _tp_torchrun(tag, runs, root, device, nproc, timeout)
    cap = (torch.cuda.get_device_properties(0).total_memory / GIB
           if device == "cuda" else float("inf"))
    out = {}
    for name, _ in meshes:
        first = ranks[0]["runs"][name]
        steps = first["steps"]
        ms = [s["ms"] for s in steps]
        steady = float(np.median(ms[1:] or ms))
        flops = (6.0 * first["params_whole"] * tokens
                 if flops_per_step is None else flops_per_step())
        peaks = [max(r["runs"][name]["peak_gib_setup"],
                     r["runs"][name]["peak_gib_steps"]) for r in ranks]
        row = {"mesh": name, "sizes": first["mesh"],
               "params": first["params_whole"], "tokens_per_step": tokens,
               "losses": [s["loss"] for s in steps], "ms_per_step": ms,
               "ms_per_step_median": steady,
               "model_flops_per_step": flops,
               "mfu": flops / (steady / 1e3 * nproc * peak_flops),
               "param_gib_per_rank": [r["runs"][name]["param_bytes"] / GIB
                                      for r in ranks],
               "peak_gib_setup_per_rank": [r["runs"][name]["peak_gib_setup"]
                                           for r in ranks],
               "peak_gib_steps_per_rank": [r["runs"][name]["peak_gib_steps"]
                                           for r in ranks],
               "collectives_per_step": [{k: s[k] for k in COLLECTIVE_KEYS}
                                        for s in steps],
               "launches_per_rank": [r["runs"][name]["launches"]
                                     for r in ranks],
               "torchrun_wall_s": wall, "dtype": "bfloat16", "card": card}
        log(f"[{tag}] " + json.dumps(row))
        if not all(np.isfinite(row["losses"])) or max(peaks) >= cap:
            raise AssertionError(f"[{tag}] {name}: losses {row['losses']}, "
                                 f"peaks {peaks} GiB of {cap}")
        if not all(all(r["runs"][name]["launches"]) for r in ranks):
            raise AssertionError(f"[{tag}] {name}: B1-B3 launches "
                                 f"{row['launches_per_rank']}")
        out[name] = row
    if len(meshes) < 2:
        shutil.rmtree(root)
        return out
    a, b = (out[name]["losses"] for name, _ in meshes[:2])
    rel = [abs(x - y) / abs(y) for x, y in zip(a, b)]
    log(f"[{tag}] " + json.dumps({"meshes": [m for m, _ in meshes[:2]],
                                  "rel_diff": rel, "rtol": TP_BF16_RTOL,
                                  "card": card}))
    if len(a) != len(b) or max(rel) > TP_BF16_RTOL:
        raise AssertionError(f"[{tag}] the meshes' bf16 losses {a} and {b}")
    shutil.rmtree(root)
    return out


# ---------------------------------------------------------------------------
# slice 14: tensor-parallel and DP x TP serving (parallel/tp.py,
# parallel/serving_ranks.py, engine/dp.py, serve.py --tp/--dp); B1 and B4
# run on each rank's local heads, no new kernel
# ---------------------------------------------------------------------------

# phase 19a: B1 and B4 at Mistral-7B's per-rank serving shapes (32/8 heads
# split 4 ways: 8/2, 2 ways: 16/4; D 128): the plain service's 1024-token
# prefill (B1), the continuous engine's decode rows over the 145-page ring
# on bf16 and int8 pages and a 512-token prefill chunk (B4)
TP_SERVE_KERNEL_SHAPES = [
    (1, 8, 2, 1024, 128, True, 4096, torch.bfloat16),
    (1, 16, 4, 1024, 128, True, 4096, torch.bfloat16),
]
TP_PAGED_SHAPES = [
    ("decode_ring_tp4", 8, 1, 8, 2, 128, 32, 145, 4096, "ring",
     torch.bfloat16, False),
    ("decode_ring_int8_tp4", 8, 1, 8, 2, 128, 32, 145, 4096, "ring",
     torch.bfloat16, True),
    ("prefill_chunk_tp4", 1, 512, 8, 2, 128, 32, 145, 4096, "chunk",
     torch.bfloat16, False),
]
# phase 19b: Mistral at its published widths cut to 2 layers, float32
# (random weights from the seed), served by serve.py on each geometry
# (name, dp, tp) over cell (e)'s traffic against one card
TP_SERVE_ARCH = {"n_layer": 2, "bfloat16": False}
TP_SERVE_GEOMETRIES = [("tp4", 1, 4), ("dp2_tp2", 2, 2), ("dp4_tp1", 4, 1)]
# phase 19c: phase 4's Mistral-7B artifact as it is (bf16; 32 layers in
# ``--tp-serving``, ``MAIN_ARGS``' 12 in the full script on four cards)
TP_SERVE_FULL_GEOMETRIES = [("tp4", 1, 4), ("dp2_tp2", 2, 2)]
# 19c's bf16 prefill logits (1024 tokens, 32 layers) against one card's:
# max |diff| <= TP_LOGIT_RTOL x max |logit|. The readings it sits between:
# one card's own two paths (paged B4 against flash B1) differ by 4.2% of
# the scale, the tp-4 ranks by 5.0% (four cards, NVIDIA H100 80GB HBM3,
# 700 W); a rank's row-parallel part left out (the control, one card, in
# the same run) must land at >= 2 x TP_LOGIT_RTOL, or the check is blind
TP_LOGIT_RTOL = 0.10
# after 19c's tp-4 wave, a second wave of TP_PROFILE_NEW new tokens per
# request, rank 0's model calls TP_PROFILE_SKIP + 1 .. + TP_PROFILE_CALLS
# of it under torch.profiler (the measured wave runs untraced)
TP_PROFILE_NEW, TP_PROFILE_SKIP, TP_PROFILE_CALLS = 24, 4, 12


def _engines(service) -> list:
    return getattr(service, "_engines", None) or [service]


def _serve_config(config, arch_args, path) -> Path:
    """``config`` with the artifact's arch (``-c`` overlays ``arch``)."""
    cfg = json.loads(Path(config).read_text())
    cfg["arch"] = {"type": MAIN_ARCH, "args": dict(arch_args)}
    path.write_text(json.dumps(cfg))
    return path


def _cell_e_prompts(vocab: int, sizes, seed: int) -> list:
    gen = torch.Generator().manual_seed(seed + 7)

    def rand(n):
        return torch.randint(0, vocab, (n,), generator=gen).tolist()

    prefix = rand(sizes["prefix"])
    return ([prefix + rand(n) for n in sizes["shared_suffix"]]
            + [rand(n) for n in sizes["alone"]])


def _prefill_logits(model, ids, drop: int = 0):
    """``ids``' last-position logits (on the CPU) through a fresh-cache
    prefill (B1) of ``model``. ``drop`` > 1 is the control of a TP check:
    the input columns that the last of ``drop`` ranks would hold are
    zeroed at every row-parallel projection (``o_proj``, ``down_proj``),
    so that rank's part of each sum is left out."""
    def cut(module, args):
        x = args[0].clone()
        x[..., x.shape[-1] - x.shape[-1] // drop:] = 0
        return (x,) + tuple(args[1:])

    hooks = [m.register_forward_pre_hook(cut)
             for name, m in model.named_modules()
             if name.endswith(("o_proj", "down_proj"))] if drop > 1 else []
    try:
        with torch.no_grad():
            cache = model.new_cache(1, len(ids) + 1)
            return model(torch.tensor([ids], device=model.device),
                         cache=cache, prefill=True)[0, -1].float().cpu()
    finally:
        for h in hooks:
            h.remove()


def _serve_geometry(card, label, argv, sizes, prompts, block: int,
                    device, logit_ids=None, controls=(),
                    profile=False) -> dict:
    """serve.py with ``argv`` in this process over cell (e): the first
    shared-prefix request, the other 7 once its prefix is adopted (as
    :func:`_mix_e`). Every launch count (this process's and the ranks') is
    set to 0 just before the wave and read just after. After the wave,
    ``logit_ids``' last-position logits through a fresh-cache prefill
    (B1) of the service's model (group 0's) land in
    ``row["prefill_logits"]`` (on the CPU), and for each tp degree of
    ``controls`` the same with that degree's last rank left out in
    ``row["control_logits"][degree]``. ``profile``: a second wave traced
    on group 0's rank 0 (``TP_PROFILE_*``), its summary in
    ``row["profile"]``. Returns the row."""
    import threading

    from pytorch_distributed_template_tpu_torch import serve
    from pytorch_distributed_template_tpu_torch.ops import flash
    from pytorch_distributed_template_tpu_torch.parallel.tp import (
        decode_step_collectives,
    )

    t0 = time.perf_counter()
    run = ServeRun(argv)
    up_s = time.perf_counter() - t0
    svc = run.service
    groups = serve._groups(svc)
    engines = _engines(svc)
    try:
        cuda = torch.device(device).type == "cuda"
        _sync(device)
        if cuda:
            for d in range(torch.cuda.device_count()):
                torch.cuda.reset_peak_memory_stats(d)
        flash.FLASH_FWD.reset()
        flash.PAGED_ATTN.reset()
        for g in groups:
            g.reset_counts()
        calls0 = svc.stats["model_calls"]
        need = (svc.prefix_cache_stats()["prefix_adopted_blocks"]
                + sizes["prefix"] // block)
        bodies = [{"prompt_ids": p, "max_new_tokens": sizes["new"]}
                  for p in prompts]
        first = {}
        t0 = time.perf_counter()
        th = threading.Thread(target=lambda: first.update(
            r=stream_request(run, bodies[0])), daemon=True)
        th.start()
        _wait_for(lambda: svc.prefix_cache_stats()["prefix_adopted_blocks"]
                  >= need or not th.is_alive(), "the shared prefix")
        rest = _concurrent(lambda b: stream_request(run, b), bodies[1:])
        th.join(1200)
        if "r" not in first:
            raise AssertionError(f"[tp_serve] {label}: first request failed")
        results = [first["r"]] + rest
        wall = time.perf_counter() - t0
        _sync(device)
        local = {"flash_fwd": flash.FLASH_FWD.launches,
                 "paged_attn": flash.PAGED_ATTN.launches}
        per_card = {k: {str(d): n for d, n in lib.per_device.items()}
                    for k, lib in (("flash_fwd", flash.FLASH_FWD),
                                   ("paged_attn", flash.PAGED_ATTN))}
        trips = [g.round_trip_s for g in groups]
        ranks = [g.rank_stats() for g in groups]
        for r in results:
            _check_ids(r["ids"], svc.vocab, sizes["new"], f"({label})")
        pool = svc.prefix_cache_stats()
        if pool["warm_admit_copy_bytes"] != 0:
            raise AssertionError(f"({label}) warm admits copied bytes")
        tps = svc.tp_stats()
        # one decode step of the wave's 8 rows: the collectives a cell (e)
        # step issues, against the floor at that batch
        step8 = (decode_step_collectives(svc.model, sizes["slots"])
                 if groups else None)
        row = {
            "geometry": label, "dp": getattr(svc, "dp", 1), "tp": svc.tp,
            "serve_up_s": up_s, "wall_s": wall,
            "model_calls": svc.stats["model_calls"] - calls0,
            "ttft_ms": [r["ttft_s"] * 1e3 for r in results],
            "decode_ms_per_token": [
                (r["total_s"] - r["ttft_s"]) * 1e3
                / (len(r["ids"]) - r["first_delta"])
                for r in results if len(r["ids"]) > r["first_delta"]],
            "prompt_lens": [len(p) for p in prompts],
            "prefix_hit_tokens": pool["prefix_hit_tokens"],
            "launches_here": local, "launches_per_card_here": per_card,
            "launches_per_rank": [[s["launches"] for s in rs]
                                  for rs in ranks],
            "paged_arms_per_rank": [[s["paged_arms"] for s in rs]
                                    for rs in ranks],
            "param_bytes_per_rank": [[s["param_bytes"] for s in rs]
                                     for rs in ranks],
            "pool_bytes_per_rank": [[sum(s["pool_bytes"].values())
                                     for s in rs] for rs in ranks],
            "peak_gib_per_rank": [[s["peak_bytes"] / GIB for s in rs]
                                  for rs in ranks],
            "rank_devices": [[s["device"] for s in rs] for rs in ranks],
            "engine_devices": [str(e.model.device) if not hasattr(
                e.model, "devices") else [str(d) for d in e.model.devices]
                               for e in engines],
            "all_reduce_per_rank_wave": [[s["p2p"]["all_reduce"]
                                          for s in rs] for rs in ranks],
            "rank_busy_ms_per_call": [[s["busy_s"] * 1e3 / max(s["calls"], 1)
                                       for s in rs] for rs in ranks],
            # rank time per call: host launches / waiting for the device
            # (rank 0) / the reply
            "rank_split_ms_per_call": [[{k: v * 1e3 / max(s["calls"], 1)
                                         for k, v in s["split_s"].items()}
                                        for s in rs] for rs in ranks],
            # the serving process per group: a call's round trip, and the
            # wave's wall time outside round trips (the engine's own host
            # work: scheduling, tables, sampling), both per model call
            "round_trip_ms_per_call": [
                t * 1e3 / max(rs[0]["calls"], 1)
                for t, rs in zip(trips, ranks)],
            "outside_round_trips_ms_per_call": [
                (wall - t) * 1e3 / max(rs[0]["calls"], 1)
                for t, rs in zip(trips, ranks)],
            "tp_stats": tps, "decode_step_full_batch": step8, "card": card}
        if cuda and not groups:
            row["peak_gib_per_card"] = [
                torch.cuda.max_memory_allocated(d) / GIB
                for d in range(torch.cuda.device_count())]
        if not cuda:
            pass                # the plain versions count no launch
        elif groups:
            lead = ranks[0][0]["launches"]
            if lead["paged_attn"] == 0 or lead["flash_fwd"] != 0:
                raise AssertionError(f"[tp_serve] {label}: rank 0 launched "
                                     f"{lead}")
            if not all(s["launches"]["paged_attn"] > 0
                       for rs in ranks for s in rs):
                raise AssertionError(f"[tp_serve] {label}: a rank launched "
                                     "no B4")
        else:
            # every tp-1 group launched B4 on its own card
            cards = [str(e.model.device.index) for e in engines]
            if not all(per_card["paged_attn"].get(c, 0) > 0 for c in cards):
                raise AssertionError(f"[tp_serve] {label}: B4 launches per "
                                     f"card {per_card['paged_attn']}, "
                                     f"engines on cards {cards}")
        row["ids"] = [r["ids"] for r in results]
        if profile and groups:
            groups[0].profile(TP_PROFILE_SKIP, TP_PROFILE_CALLS)
            _concurrent(lambda b: stream_request(run, dict(
                b, max_new_tokens=TP_PROFILE_NEW)), bodies)
            row["profile"] = groups[0].rank_stats()[0]["profile"]
            if row["profile"] is None:
                raise AssertionError(f"[tp_serve] {label}: the traced wave "
                                     "ran fewer than "
                                     f"{TP_PROFILE_SKIP + TP_PROFILE_CALLS} "
                                     "model calls")
        if logit_ids is not None:
            row["prefill_logits"] = _prefill_logits(svc.model, logit_ids)
            row["control_logits"] = {
                d: _prefill_logits(svc.model, logit_ids, d)
                for d in controls}
        return row
    finally:
        run.close()
        del run, svc, groups, engines
        gc.collect()
        if torch.device(device).type == "cuda":
            for d in range(torch.cuda.device_count()):
                with torch.cuda.device(d):
                    torch.cuda.empty_cache()


def _rank0_launches(rows) -> dict:
    """The launches on card 0: this process's there for the tp-1 runs,
    rank 0 of group 0's for the others."""
    out = {"flash_fwd": 0, "paged_attn": 0}
    for row in rows:
        for k in out:
            out[k] += (row["launches_per_rank"][0][0][k]
                       if row["launches_per_rank"] else
                       row["launches_per_card_here"][k].get("0", 0))
    return out


def phase_tp_serve(card: str, device="cuda", work=WORK, nproc: int = 4,
                   arch_args=None, config=SERVE_CONFIG, sizes=None,
                   geometries=TP_SERVE_GEOMETRIES, seed: int = 0) -> dict:
    """Phase 19b: with ``nproc`` cards, a random-init Mistral at its widths
    cut to ``TP_SERVE_ARCH`` (2 layers, float32) made by the port's tool,
    served by the port's ``serve.py`` (in this process; it starts its own
    ranks) over cell (e)'s traffic on one card, then on each of
    ``TP_SERVE_GEOMETRIES`` (tp 4, dp 2 x tp 2, dp 4 x tp 1): every
    request's greedy ids identical to the one card's; each TP rank launched
    B4 and no B1; each rank's parameter bytes its placement's share; the
    tp-1 groups' engines on distinct cards. Prints TTFT and ms/token per
    request, per-rank bytes and peak memory, and one decode step's
    collectives against the floor. With fewer cards it prints
    ``"tp_serve": "not run: N card(s)"`` and returns {}. ``arch_args``,
    ``config`` and ``sizes`` cut it (a tiny width on the CPU, where the
    ranks run on gloo)."""
    from pytorch_distributed_template_tpu_torch.config.registry import (
        MODELS,
    )
    from pytorch_distributed_template_tpu_torch.parallel import tp
    from pytorch_distributed_template_tpu_torch.tools import (
        make_serving_artifact as tool,
    )

    tag = "tp_serve"
    if _not_run(tag, device, nproc, card, key=tag):
        return {}
    arch_args = dict(TP_SERVE_ARCH, **(arch_args or {}))
    sizes = dict(SERVE_SIZES, **(sizes or {}))
    root = work / tag
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    argv = ["-o", str(root / "art"), "--arch", MAIN_ARCH, "--seed",
            str(seed), "--device", str(device)]
    for key, val in arch_args.items():
        argv += ["--" + key.replace("_", "-"), json.dumps(val)
                 if isinstance(val, bool) else str(val)]
    tool.main(argv)
    _release(device)
    cfg = _serve_config(config, arch_args, root / "serve.json")
    block = json.loads(cfg.read_text())["serving"]["prefix_cache"][
        "block_tokens"]
    shape = MODELS.get(MAIN_ARCH)(**arch_args, device="meta")
    prompts = _cell_e_prompts(shape.vocab_size, sizes, seed)
    base = ["-r", str(root / "art" / "model"), "-c", str(cfg), "-s",
            str(root / "run"), "--port", "0", "--max-batch",
            str(sizes["slots"]), "--decode-chunk", str(sizes["chunk"]),
            "--device", str(device)]
    one = _serve_geometry(card, "one", base, sizes, prompts, block, device)
    log(f"[{tag}] " + json.dumps({k: v for k, v in one.items()
                                  if k != "ids"}))
    whole = sum(p.numel() * p.element_size() for p in shape.parameters())
    out = {"one": one}
    for name, dp, degree in geometries:
        row = _serve_geometry(card, name, base + ["--dp", str(dp), "--tp",
                                                  str(degree)],
                              sizes, prompts, block, device)
        same = [a == b for a, b in zip(row["ids"], one["ids"])]
        row["identical_to_one_card"] = same
        placed = tp.serving_placements(shape, degree)
        share = sum(p.numel() * p.element_size()
                    // (degree if any(placed[n]) else 1)
                    for n, p in shape.named_parameters())
        row["param_bytes_whole"], row["param_bytes_share"] = whole, share
        log(f"[{tag}] " + json.dumps({k: v for k, v in row.items()
                                      if k != "ids"}))
        if not all(same):
            raise AssertionError(f"[{tag}] {name}: greedy ids differ from "
                                 f"one card's on requests "
                                 f"{[i for i, s in enumerate(same) if not s]}")
        if degree > 1:
            if any(b != share for rs in row["param_bytes_per_rank"]
                   for b in rs):
                raise AssertionError(f"[{tag}] {name}: parameter bytes "
                                     f"{row['param_bytes_per_rank']}, not "
                                     f"{share} each")
            st = row["tp_stats"]
            floor = st["analytic_floor_bytes"]
            if not (st["counts"]["all-reduce"] >= 2 * shape.n_layer and
                    floor <= st["bytes"]["all-reduce"] <= 1.5 * floor):
                raise AssertionError(f"[{tag}] {name}: collectives {st}")
        elif torch.device(device).type == "cuda" and \
                row["engine_devices"] != [f"cuda:{g}" for g in range(dp)]:
            raise AssertionError(f"[{tag}] {name}: tp-1 groups on "
                                 f"{row['engine_devices']}")
        out[name] = row
    shutil.rmtree(root)
    return out


def phase_tp_serve_full(card: str, model_path, device="cuda", work=WORK,
                        nproc: int = 4, config=SERVE_CONFIG, sizes=None,
                        geometries=TP_SERVE_FULL_GEOMETRIES,
                        seed: int = 0) -> dict:
    """Phase 19c: with ``nproc`` cards, phase 4's Mistral-7B artifact (bf16,
    the published widths; 32 layers from ``--tp-serving``, ``MAIN_ARGS``'
    depth in the full script) served by the port's ``serve.py``
    with ``configs/mistral_7b_serve_paged.json`` over cell (e)'s traffic
    on one card, then ``--tp 4`` and ``--dp 2 --tp 2``: every request's ids
    in range, warm admits copying nothing, B4 on every rank, and one
    1024-token prefill's bf16 logits within ``TP_LOGIT_RTOL`` of the one
    card's while the control (the last rank's row-parallel part left out,
    on the one card) lands at 2 x ``TP_LOGIT_RTOL`` or more. Prints TTFT
    and ms/token per request beside the one card's, each rank's peak
    memory, parameter and pool bytes, its time per call split into host
    launches, waiting for the device and the reply, the serving process's
    round trips, a profiled second wave on tp 4's rank 0, and the
    all-reduces and bytes of one decode step (batch 1 and the wave's 8
    rows) against the floor; the share of requests whose bf16 greedy ids
    equal the one card's is reported, not held (the ranks sum the
    row-parallel products in another order). With fewer cards it prints
    ``"tp_serve_full": "not run: N card(s)"`` and returns {}."""
    tag = "tp_serve_full"
    if _not_run(tag, device, nproc, card, key=tag):
        return {}
    sizes = dict(SERVE_SIZES, **(sizes or {}))
    block = json.loads(Path(config).read_text())["serving"][
        "prefix_cache"]["block_tokens"]
    vocab = json.loads((Path(model_path).parent / "config.json")
                       .read_text())["arch"]["args"].get("vocab_size",
                                                         32000)
    prompts = _cell_e_prompts(vocab, sizes, seed)
    logit_ids = torch.randint(0, vocab, (sizes["logit_prompt"],),
                              generator=torch.Generator().manual_seed(
                                  seed + 11)).tolist()
    root = work / tag
    base = ["-r", str(model_path), "-c", str(config), "-s", str(root),
            "--port", "0", "--max-batch", str(sizes["slots"]),
            "--decode-chunk", str(sizes["chunk"]), "--device", str(device)]
    _release(device)
    one = _serve_geometry(card, "one", base, sizes, prompts, block, device,
                          logit_ids, controls=sorted({d for _, _, d in
                                                      geometries}))
    ref = one.pop("prefill_logits")
    controls = one.pop("control_logits")
    scale = ref.abs().max().item()
    log(f"[{tag}] " + json.dumps({k: v for k, v in one.items()
                                  if k != "ids"}))
    out = {"one": one}
    for name, dp, degree in geometries:
        argv = base + ["--dp", str(dp), "--tp", str(degree)]
        row = _serve_geometry(card, name, argv, sizes, prompts, block,
                              device, logit_ids, profile=dp == 1)
        got = row.pop("prefill_logits")
        row.pop("control_logits")
        row["identical_to_one_card"] = [
            a == b for a, b in zip(row["ids"], one["ids"])]
        row["first_diff"] = [next((i for i, (x, y) in enumerate(zip(a, b))
                                   if x != y), len(a))
                             for a, b in zip(row["ids"], one["ids"])]
        # the bf16 logits of one 1024-token prefill (B1 on the ranks' local
        # heads) against the one card's, and the control's distance
        err = (got - ref).abs().max().item()
        control = (controls[degree] - ref).abs().max().item()
        row["prefill_logits"] = {
            "prompt_len": len(logit_ids), "max_abs_diff": err,
            "mean_abs_diff": (got - ref).abs().mean().item(),
            "max_abs": scale, "rel": err / scale,
            "control_max_abs_diff": control, "control_rel": control / scale,
            "rtol": TP_LOGIT_RTOL,
            "same_argmax": bool(got.argmax() == ref.argmax())}
        for k in ("ttft_ms", "decode_ms_per_token"):
            row[k + "_median"] = float(np.median(row[k]))
            row[k + "_one_card_median"] = float(np.median(one[k]))
        log(f"[{tag}] " + json.dumps({k: v for k, v in row.items()
                                      if k != "ids"}))
        if (not torch.isfinite(got).all() or got.shape != ref.shape
                or err > TP_LOGIT_RTOL * scale):
            raise AssertionError(f"[{tag}] {name}: prefill logits "
                                 f"{row['prefill_logits']}")
        if control < 2 * TP_LOGIT_RTOL * scale:
            raise AssertionError(f"[{tag}] {name}: the control (rank "
                                 f"{degree - 1}'s row-parallel part left "
                                 f"out) is within 2 x TP_LOGIT_RTOL: "
                                 f"{row['prefill_logits']}")
        out[name] = row
    shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# slice 15: the sparse Llama family (MixtralMoE, swiglu experts: three
# torch.bmm, no Pallas kernel in JAX either) and the expert mesh axis; B1-B4
# run at Mistral's attention shapes, no new kernel
# ---------------------------------------------------------------------------

MIXTRAL_EP_CONFIG = REPO / "pytorch_distributed_template_tpu_torch" \
    / "configs" / "mixtral_8x7b_ep.json"
MIXTRAL_SERVE_CONFIG = REPO / "pytorch_distributed_template_tpu_torch" \
    / "configs" / "mixtral_8x7b_serve_paged.json"
# phase 20a's card-vs-CPU check: Mixtral at its published widths cut to 2
# layers in float32 (TF32 off); prompts and new tokens per engine
MOE_REF_LAYERS = 2
MOE_REF_PROMPTS = (37, 96)
MOE_REF_NEW = 6
# phase 20b: mixtral_8x7b_ep.json cut to 2 layers in float32 at a capacity
# factor of 1.0 (C 4096 of 16,384 tokens x 2 slots / 8 experts: an expert
# past its share drops tokens), 3 steps on each mesh against one rank
EP_NCCL_COMMON = [("arch;args;n_layer", 2), ("arch;args;bfloat16", False),
                  ("arch;args;capacity_factor", 1.0),
                  ("train_loader;args;n", 12), ("valid_loader;args;n", 4)]
EP_NCCL_MESHES = [("expert4", {"expert": 4}),
                  ("data2_expert2", {"data": 2, "expert": 2}),
                  ("data4", {"data": 4})]
# phase 20c: the config as it is (8 layers, bf16), 5 steps on expert 4
EP_FULL_MESHES = [("expert4", {"expert": 4})]


def _sequential(service, reqs) -> list:
    """Greedy ids of ``reqs`` served one after another (a fixed batch
    composition: at a capacity that drops tokens, the rows sharing a call
    decide which of them keep their experts)."""
    return [service.generate(**r)["ids"] for r in reqs]


def _moe_reference(card: str, device="cuda", arch_over=None) -> dict:
    """Phase 20a's check: ``MixtralMoE`` at its published widths cut to
    ``MOE_REF_LAYERS`` layers in float32 (TF32 off), random weights from
    seed 3 on the card, the same weights on the CPU; the batch-1 service
    and the continuous engine over a paged pool each serve
    ``MOE_REF_PROMPTS`` one after another: greedy ids identical on both
    devices, per engine. ``arch_over`` narrows the model (a CPU
    rehearsal)."""
    import pytorch_distributed_template_tpu_torch.models  # noqa: F401
    from pytorch_distributed_template_tpu_torch.config.registry import MODELS
    from pytorch_distributed_template_tpu_torch.engine.continuous import (
        ContinuousBatchingService,
    )
    from pytorch_distributed_template_tpu_torch.engine.serving import (
        GenerationService,
    )

    cfg = json.loads(MIXTRAL_SERVE_CONFIG.read_text())
    arch = dict(cfg["arch"]["args"], **(arch_over or {}),
                n_layer=MOE_REF_LAYERS, bfloat16=False)
    rng = np.random.default_rng(13)
    vocab = arch.get("vocab_size", 32000)
    reqs = [{"prompt_ids": [int(x) for x in rng.integers(
        1, vocab, n)], "max_new_tokens": MOE_REF_NEW}
        for n in MOE_REF_PROMPTS]
    # room for two requests' rings (145 pages each at window 4096)
    pool = {"enabled": True, "block_tokens": 32, "pool_blocks": 320,
            "paged": True}
    out, models = {}, {}
    with _TF32(False, False):
        t0 = time.perf_counter()
        model = MODELS.get("MixtralMoE")(**arch, device=device)
        model.init_weights(torch.Generator(device=device).manual_seed(3))
        cpu = MODELS.get("MixtralMoE")(**arch, device="meta")
        cpu.load_state_dict({k: v.cpu() for k, v in
                             model.state_dict().items()}, assign=True)
        models = {device: model, "cpu": cpu}
        setup_s = time.perf_counter() - t0
        for dev, m in models.items():
            t0 = time.perf_counter()
            with torch.no_grad():
                one = GenerationService.from_model(m, device=dev)
                batch1 = _sequential(one, reqs)
                del one
                eng = ContinuousBatchingService.from_model(
                    m, device=dev, slots=2, chunk=4, window_ms=5.0,
                    prefix_cache=dict(pool))
                try:
                    paged = _sequential(eng, reqs)
                finally:
                    eng.close()
            out[dev] = {"batch1": batch1, "paged": paged,
                        "s": time.perf_counter() - t0}
    row = {"layers": MOE_REF_LAYERS, "params": sum(
        p.numel() for p in model.parameters()),
        "prompts": list(MOE_REF_PROMPTS), "new": MOE_REF_NEW,
        "setup_s": setup_s, **{f"{dev}_s": o["s"] for dev, o in out.items()},
        "batch1_ids": out[device]["batch1"],
        "paged_ids": out[device]["paged"], "dtype": "float32",
        "tf32": False, "card": card}
    log("[moe_serve] reference " + json.dumps(row))
    for engine in ("batch1", "paged"):
        if out[device][engine] != out["cpu"][engine]:
            raise AssertionError(
                f"[moe_serve] {engine}: {device} ids {out[device][engine]} "
                f"against the CPU's {out['cpu'][engine]}")
    del model, cpu, models
    _release(device)
    return row


def _local_request(service, body: dict) -> dict:
    """One request to the in-process engine: ids, TTFT (submission to the
    first streamed delta) and total seconds, as ``stream_request``."""
    box = {}
    t0 = time.perf_counter()

    def on_tokens(ids):
        if "ttft" not in box and len(ids):
            box["ttft"] = time.perf_counter() - t0
            box["first"] = len(ids)

    r = service.generate(**body, on_tokens=on_tokens)
    return {"ids": r["ids"], "ttft_s": box.get("ttft", float("nan")),
            "total_s": time.perf_counter() - t0,
            "first_delta": box.get("first", 1),
            "prompt_len": len(body["prompt_ids"])}


def phase_moe_serve(card: str, device="cuda", config=MIXTRAL_SERVE_CONFIG,
                    sizes=None, seed: int = 0, arch_over=None) -> dict:
    """Phase 20a, slice 15's serving path on one card: first
    :func:`_moe_reference`; then ``mixtral_8x7b_serve_paged.json``
    (``MixtralMoE`` at Mixtral-8x7B's widths, its ``reduced`` depth of 16
    layers, bf16, random weights from ``seed`` drawn on the card: no
    artifact of ~47 GB written and read back) in the continuous engine
    over the config's paged pool (``ContinuousBatchingService.from_model``
    with ``serve.py``'s slots and decode chunk) with cell (e)'s traffic: 8
    concurrent greedy requests of 256-2048 tokens, 4 sharing a 1024-token
    prefix, 64 new each, through :class:`ServeWave` (B4 = n_layer x model
    calls and its arms exact, B1 0, ids in range, warm admits copying
    nothing). Prints TTFT and decode ms/token per request and the peak
    memory; returns ``{"paged_attn": B4 launches, "reference": row,
    "row": the wave's figures}``. ``sizes`` and ``arch_over`` cut it (a
    CPU rehearsal)."""
    import pytorch_distributed_template_tpu_torch.models  # noqa: F401
    from pytorch_distributed_template_tpu_torch.config.registry import MODELS
    from pytorch_distributed_template_tpu_torch.engine.continuous import (
        ContinuousBatchingService,
    )

    ref = _moe_reference(card, device, arch_over)
    sizes = dict(SERVE_SIZES, **(sizes or {}))
    cfg = json.loads(Path(config).read_text())
    arch = dict(cfg["arch"]["args"], **(arch_over or {}))
    t0 = time.perf_counter()
    model = MODELS.get("MixtralMoE")(**arch, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    _sync(device)
    build_s = time.perf_counter() - t0
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    svc = ContinuousBatchingService.from_model(
        model, device=device, slots=sizes["slots"], chunk=sizes["chunk"],
        window_ms=25.0, prefix_cache=dict(cfg["serving"]["prefix_cache"]),
        prefill_chunk_tokens=cfg["serving"]["prefill_chunk_tokens"])
    gen = torch.Generator().manual_seed(seed + 7)

    def rand(n):
        return torch.randint(0, model.vocab_size, (n,),
                             generator=gen).tolist()

    prefix = rand(sizes["prefix"])
    prompts = ([prefix + rand(n) for n in sizes["shared_suffix"]]
               + [rand(n) for n in sizes["alone"]])
    log("[moe_serve] " + json.dumps({
        "arch": "MixtralMoE", "n_layer": model.n_layer,
        "params": sum(p.numel() for p in model.parameters()),
        "weight_gib": weights / GIB, "build_s": build_s,
        "pool_blocks": svc._prefix.pool_blocks, "block": svc._prefix.block,
        "page_mib": svc._prefix.page_bytes / 2 ** 20,
        "prefill_chunk": svc._prefill_chunk, "card": card}))
    waves = ServeWave(card, device)
    pf = svc._prefix
    need = pf.counter("prefix_adopted_blocks") + sizes["prefix"] // pf.block
    bodies = [{"prompt_ids": p, "max_new_tokens": sizes["new"]}
              for p in prompts]

    def drive():
        import threading

        first = {}
        th = threading.Thread(target=lambda: first.update(
            r=_local_request(svc, bodies[0])), daemon=True)
        th.start()
        _wait_for(lambda: pf.counter("prefix_adopted_blocks") >= need
                  or not th.is_alive(), "the shared prefix's adoption")
        rest = _concurrent(lambda b: _local_request(svc, b), bodies[1:])
        th.join(1200)
        if "r" not in first:
            raise AssertionError("(moe_e) first request failed")
        return [first["r"]] + rest

    try:
        results = waves.run("moe_e", svc, drive, sizes["new"])
        if svc.prefix_cache_stats()["prefix_hit_tokens"] <= 0:
            raise AssertionError("(moe_e) no prefix hit tokens")
    finally:
        svc.close()
    peak = (torch.cuda.max_memory_allocated() / GIB
            if torch.device(device).type == "cuda" else 0.0)
    decode = [(r["total_s"] - r["ttft_s"]) * 1e3
              / (len(r["ids"]) - r["first_delta"]) for r in results
              if len(r["ids"]) > r["first_delta"]]
    row = {"n_layer": model.n_layer, "requests": len(results),
           "ttft_ms": [r["ttft_s"] * 1e3 for r in results],
           "ttft_ms_median": float(np.median([r["ttft_s"] * 1e3
                                              for r in results])),
           "decode_ms_per_token_median": float(np.median(decode)),
           "peak_gib": peak, "weight_gib": weights / GIB,
           "paged_attn_launches": waves.b4_launches, "flash_fwd_launches": 0,
           "card": card}
    log("[moe_serve] " + json.dumps(row))
    del svc, model
    _release(device)
    return {"paged_attn": waves.b4_launches, "reference": ref, "row": row}


def _mixtral_flops(config, batch: int) -> float:
    """``train_step_flops`` of the config's whole model (the meta device)
    at ``batch`` rows of its sequence."""
    import pytorch_distributed_template_tpu_torch.models  # noqa: F401
    from pytorch_distributed_template_tpu_torch.config.registry import MODELS
    from pytorch_distributed_template_tpu_torch.observability.profiler import (
        train_step_flops,
    )

    cfg = json.loads(Path(config).read_text())
    model = MODELS.get(cfg["arch"]["type"])(**cfg["arch"]["args"],
                                            device="meta")
    return train_step_flops(model, batch,
                            cfg["train_loader"]["args"]["seq_len"])


def phase_ep_nccl(card: str, device="cuda", work=WORK, nproc: int = 4,
                  timeout: float = 900.0, common=EP_NCCL_COMMON,
                  meshes=EP_NCCL_MESHES) -> dict:
    """Phase 20b: :func:`phase_tp_nccl` on ``mixtral_8x7b_ep.json`` cut by
    ``EP_NCCL_COMMON`` (2 layers, float32 without TF32, capacity 1.0):
    ``{"expert": 4}`` (one epoch and its checkpoint: 38 GB of f32
    params and Adam moments), ``{"data": 2, "expert": 2}`` and ``{"data":
    4}`` (DDP, the routing over the global batch on NCCL), each in a
    ``torchrun`` of its own, each within ``SEQ_NCCL_RTOL`` of one rank,
    each rank's parameter bytes its placement's share, the expert-4
    checkpoint resumed in one process reproducing the one rank's epoch 2;
    the all-reduces and psums per step printed. With fewer cards it prints ``"moe_ep": "not
    run: N card(s)"``."""
    return phase_tp_nccl(card, device=device, work=work,
                         config=MIXTRAL_EP_CONFIG, nproc=nproc,
                         timeout=timeout, common=common, meshes=meshes,
                         saver="expert4", resume_on=None, tag="ep_nccl",
                         key="moe_ep", saver_epochs=1)


def phase_ep_full(card: str, device="cuda", work=WORK, nproc: int = 4,
                  timeout: float = 1200.0, common=()) -> dict:
    """Phase 20c: :func:`phase_tp_full` on ``mixtral_8x7b_ep.json`` as it
    is (8 of Mixtral-8x7B's 32 layers at every published width, bf16 over
    float32 master weights, remat, flash, 4 x 4096 tokens per step, every
    rank reading the 4 rows) for 5 steps on ``{"expert": 4}``: ms per
    step, MFU over the model's FLOPs (``_mixtral_flops``), peak memory and
    collectives per rank, B1-B3 launches."""
    return phase_tp_full(card, device=device, work=work,
                         config=MIXTRAL_EP_CONFIG, nproc=nproc,
                         timeout=timeout, common=list(common),
                         meshes=EP_FULL_MESHES,
                         tag="ep_full", key="moe_ep",
                         flops_per_step=lambda: _mixtral_flops(
                             MIXTRAL_EP_CONFIG, TP_GLOBAL_BATCH))


def moe_ep_main() -> int:
    """``chip_smoke.py --moe-ep``: slice 15's phases alone: the build, 20a,
    and with four cards 20b and 20c. Prints each phase's rows and time;
    exits 0 when every check held."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()} | nvidia-smi: {card}")
    times = {}

    def timed(phase, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        times[phase] = time.perf_counter() - t0
        log(f"[time] phase {phase}: {times[phase]:.1f} s | {card}")
        return out

    timed("1", phase_build)
    timed("20a", phase_moe_serve, card)
    timed("20b", phase_ep_nccl, card)
    timed("20c", phase_ep_full, card)
    if WORK.exists():
        shutil.rmtree(WORK)
    print(json.dumps({"moe_ep": "ok", "phases_s": times, "card": card}),
          flush=True)
    return 0


def tp_serving_main() -> int:
    """``chip_smoke.py --tp-serving``: slice 14's phases alone, for four
    cards: the build, 19a, 19b, phase 4's Mistral-7B artifact (the port's
    tool, ``MAIN_ARCH`` at seed 0 as phase 4 makes it) and 19c. Prints
    each phase's rows and time and the launches on card 0; exits 0 when
    every check held."""
    from pytorch_distributed_template_tpu_torch.tools import (
        make_serving_artifact as tool,
    )

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()} | nvidia-smi: {card}")
    times = {}

    def timed(phase, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        times[phase] = time.perf_counter() - t0
        log(f"[time] phase {phase}: {times[phase]:.1f} s | {card}")
        return out

    timed("1", phase_build)
    timed("19a", phase_kernel, TP_SERVE_KERNEL_SHAPES)
    timed("19a-paged", phase_paged_kernel, TP_PAGED_SHAPES)
    rows = list(timed("19b", phase_tp_serve, card).values())
    if WORK.exists():
        shutil.rmtree(WORK / "art", ignore_errors=True)
    timed("artifact", tool.main, ["-o", str(WORK / "art"), "--arch",
                                  MAIN_ARCH, "--seed", "0", "--device",
                                  "cuda"])
    _release("cuda")
    rows += [r for r in timed("19c", phase_tp_serve_full, card,
                              WORK / "art" / "model").values()
             if "launches_here" in r]
    shutil.rmtree(WORK)
    log("[launches] card 0 " + json.dumps(_rank0_launches(rows)))
    print(json.dumps({"tp_serving": "ok", "phases_s": times, "card": card}),
          flush=True)
    return 0


# ---------------------------------------------------------------------------
# slice 16: serving the repository's own LMs (ROADMAP A6a.5, A6c.3's caches,
# A3a.1's batch-1 scatter arm, A3a.2, A4): the GPT-2 family's decode caches
# with int8 KV, w8a16 weights, prompt-lookup speculative decoding and the
# static micro-batcher; B1, B4 and B5 on new paths, no new kernel
# ---------------------------------------------------------------------------

# B1 at the GPT-2 family's prefill shapes: a short and a long prompt, alone
# and in a static batch of 8 (GPT-2 small's 12 heads of 64)
GPT2_SERVE_KERNEL_SHAPES = [(b, 12, 12, t, 64, True, 0, torch.bfloat16)
                            for b in (1, 8) for t in (37, 512)]
# B5 at MoeLM's decode capacities: C = ceil(2 B 1.25 / 8) is 1 at batch 1,
# 3 at batch 8 and 8 at a 25-token prefill; moelm_stdlib's D 512, F 1024
FFN_DECODE_SHAPES = [(f"decode_c{c}_{str(dt)[6:]}", 8, c, 512, 1024, True,
                      dt) for c in (1, 3, 8)
                     for dt in (torch.bfloat16, torch.float32)]
# 21a: small f32 models, head_dim 64 so B1 takes them
SERVE_REF = {
    "GPT2": {"size": "gpt2-small", "vocab_size": 512, "max_len": 128,
             "n_layer": 2, "n_head": 2, "d_model": 128, "dropout": 0.0},
    "TinyMoeLM": {"vocab_size": 256, "n_layer": 2, "n_head": 2,
                  "d_model": 128, "d_ff": 256, "max_len": 128},
}
# card against CPU, f32 without TF32: max |diff| <= SERVE_REF_RTOL x
# max |logit| (summation order only). Under int8 KV a K/V row that lands
# on the other side of a rounding boundary moves by one int8 step (1/127
# of the row's largest entry) on one side only: INT8_REF_RTOL. w8a16
# against the dense model on the dequantized weights: (x @ w8) s against
# x @ (w8 s), rounding only
SERVE_REF_RTOL = 1e-4
INT8_REF_RTOL = 2e-2
W8A16_REF_RTOL = 1e-4
# 21b: phase 6's GPT-2 small, the prompt a row of its synthetic bigram data
GPT2_GEN_PROMPT = 64
GPT2_GEN_NEW = 32          # the f32 hard checks
GPT2_TIME_NEW = 64         # the bf16 timings
GPT2_SPEC_DRAFT = 4
# 21b's server: 8 concurrent greedy requests of one length (128 tokens)
# and 2 of other lengths, 128 new tokens each; f32 without TF32 (each
# request's ids against its solo run). A full batch leaves at once; the
# window holds only the two lone lengths
STATIC_SERVE = {"prompt": 128, "others": [96, 160], "new": 128,
                "batch": 8, "window_ms": 200.0}
# 21e: the w8a16 Mistral's bf16 prefill logits (1024 tokens) against the
# dense model on its dequantized weights, max |diff| <= W8A16_LOGIT_RTOL x
# max |logit|: each layer's 7 products rounds twice where the
# dense one rounds once (the bf16 product of the int8 values, then its
# scaled output, against the product of the rounded dequantized weight),
# so the gap is a few bf16 ulps per layer. The limit sits between what
# this path reads and what wrong ones read (random weights, 12 layers,
# one NVIDIA H100 80GB HBM3, 700.00 W): sound 5.04% (5.1% at 16 layers);
# the dense model on the unquantized weights 13.2%; one projection's scale
# rolled by one channel 51.7%, zeroed 154%
W8A16_LOGIT_RTOL = 0.10
# 21e's control: layer 0's attention output projection; its scale zeroed
# drops that projection from the model and must read >= 2 x the limit
W8A16_CONTROL_PROJ = "layers.0.self_attn.o_proj"
BYTELM_KEEP = WORK / "bytelm_keep"
MOELM_KEEP = WORK / "moelm_keep"


def keep_run(trainer, dst) -> Path:
    """Copy a finished run's model into ``dst/checkpoint/model.pt`` beside
    its ``dst/config.json``: a checkpoint the port's ``generate.py`` and
    ``tools/quantize_checkpoint.py`` take with ``-r``."""
    dst = Path(dst)
    (dst / "checkpoint").mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in
                trainer.model.state_dict().items()},
               dst / "checkpoint" / "model.pt")
    shutil.copyfile(trainer.config.save_dir / "config.json",
                    dst / "config.json")
    return dst / "checkpoint"


def _empty_cache(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _launch_counts():
    from pytorch_distributed_template_tpu_torch.ops import expert_ffn as ffn
    from pytorch_distributed_template_tpu_torch.ops.flash import (
        FLASH_FWD, PAGED_ATTN,
    )

    return {"flash_fwd": FLASH_FWD.launches,
            "paged_attn": PAGED_ATTN.launches,
            "expert_ffn": ffn.EXPERT_FFN.launches}


def _zero_counts() -> None:
    from pytorch_distributed_template_tpu_torch.ops import expert_ffn as ffn
    from pytorch_distributed_template_tpu_torch.ops.flash import (
        FLASH_FWD, PAGED_ATTN,
    )

    FLASH_FWD.launches = PAGED_ATTN.launches = 0
    ffn.EXPERT_FFN.launches = 0


def _serve_ref_model(arch: str, device, **extra):
    from pytorch_distributed_template_tpu_torch.config.registry import (
        MODELS,
    )

    model = MODELS.get(arch)(**dict(SERVE_REF[arch], **extra),
                             device="cpu")
    if not extra.get("quant"):
        model.init_weights(torch.Generator().manual_seed(21))
    return model.to(device).eval()


def _decode_logits(model, prompt, steps: int):
    """The prefill's last logits and ``steps`` greedy decode steps' logits
    over a fresh cache: ``[B, steps + 1, V]`` on the CPU."""
    with torch.no_grad():
        cache = model.new_cache(prompt.shape[0], prompt.shape[1] + steps)
        out = [model(prompt, cache=cache, prefill=True)[:, -1]]
        for _ in range(steps):
            tok = out[-1].argmax(-1, keepdim=True)
            out.append(model(tok, cache=cache)[:, -1])
    return torch.stack(out, 1).float().cpu()


def phase_gpt2_serve_reference(device="cuda") -> dict:
    """21a: the GPT-2 family's decode paths on the card against the CPU in
    f32 without TF32 (small ``GPT2`` and ``TinyMoeLM``): cached-decode and
    int8-KV logits; the w8a16 model against the dense one on the
    dequantized weights; speculative greedy ids against plain greedy ids;
    the static micro-batcher's ids against each request served alone."""
    import threading

    from pytorch_distributed_template_tpu_torch.engine.generate import (
        generate, generate_speculative,
    )
    from pytorch_distributed_template_tpu_torch.engine.serving import (
        BatchedGenerationService, GenerationService,
    )
    from pytorch_distributed_template_tpu_torch.models.quant import (
        dequantize_params_w8, quantize_params_w8,
    )

    out = {}
    with _TF32(False, False):
        for arch in SERVE_REF:
            vocab = SERVE_REF[arch]["vocab_size"]
            gen = torch.Generator().manual_seed(5)
            prompt = torch.randint(0, vocab, (3, 20), generator=gen)
            row = {}
            for kvq in ("", "int8"):
                extra = {"kv_quant": kvq} if kvq else {}
                dev_m = _serve_ref_model(arch, device, **extra)
                cpu_m = _serve_ref_model(arch, "cpu", **extra)
                got = _decode_logits(dev_m, prompt.to(device), 8)
                ref = _decode_logits(cpu_m, prompt, 8)
                err = (got - ref).abs().max().item()
                scale = ref.abs().max().item()
                tol = (INT8_REF_RTOL if kvq else SERVE_REF_RTOL) * scale
                row[f"decode{'_int8' if kvq else ''}_max_abs_err"] = err
                if not (torch.isfinite(got).all() and err <= tol):
                    raise AssertionError(
                        f"21a {arch} kv_quant={kvq!r}: card decode logits "
                        f"differ from the CPU's by {err:.3e} (tol "
                        f"{tol:.3e})")
            model = _serve_ref_model(arch, device)
            # speculative greedy == plain greedy, on a repetitive prompt
            rep = torch.tensor([[7, 8, 9, 10] * 6], device=device)
            plain = generate(model, rep, 48, temperature=0.0)
            spec, stats = generate_speculative(model, rep, 48, draft_len=4,
                                               return_stats=True)
            if not torch.equal(plain, spec):
                raise AssertionError(f"21a {arch}: speculative greedy ids "
                                     "differ from plain greedy ids")
            row["speculative"] = stats
            # the static batcher against each request alone
            solo = GenerationService.from_model(model, device=device)
            batched = BatchedGenerationService.from_model(
                model, device=device, max_batch=4, window_ms=300.0)
            prompts = [torch.randint(0, vocab, (n,), generator=gen).tolist()
                       for n in (16, 16, 16, 16, 24)]
            box = [None] * len(prompts)
            threads = [threading.Thread(target=lambda i=i: box.__setitem__(
                i, batched.generate(prompt_ids=prompts[i],
                                    max_new_tokens=16)["ids"]))
                for i in range(len(prompts))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(600)
            alone = [solo.generate(prompt_ids=p, max_new_tokens=16)["ids"]
                     for p in prompts]
            if box != alone:
                raise AssertionError(f"21a {arch}: batched ids {box} differ "
                                     f"from solo ids {alone}")
            row["static_stats"] = dict(batched.stats)
            batched.close()
            if arch == "GPT2":
                # w8a16 against the dense model on the dequantized weights
                q = quantize_params_w8({k: v.cpu() for k, v in
                                        model.state_dict().items()})
                qm = _serve_ref_model(arch, "cpu", quant="w8a16")
                qm.load_state_dict(q)
                dm = _serve_ref_model(arch, "cpu")
                dm.load_state_dict(dequantize_params_w8(q))
                qm, dm = qm.to(device), dm.to(device)
                got = _decode_logits(qm, prompt.to(device), 8)
                ref = _decode_logits(dm, prompt.to(device), 8)
                err = (got - ref).abs().max().item()
                tol = W8A16_REF_RTOL * ref.abs().max().item()
                row["w8a16_max_abs_err"] = err
                if err > tol:
                    raise AssertionError(f"21a w8a16: {err:.3e} > {tol:.3e}"
                                         " against the dequantized model")
            out[arch] = row
            log("[gpt2_serve_ref] " + json.dumps({"arch": arch, **row}))
            del model, solo
    _zero_counts()
    return out


def _gen_cli(argv) -> tuple:
    """The port's ``generate.py`` in this process: ``(response, wall s,
    launches per kernel)``, the counts set to 0 just before."""
    from pytorch_distributed_template_tpu_torch import generate as gen_cli

    _zero_counts()
    t0 = time.perf_counter()
    resp = gen_cli.main([str(a) for a in argv])
    return resp, time.perf_counter() - t0, _launch_counts()


def _served_times(service, prompt, new: int, spec: int = 0) -> dict:
    """TTFT (a 1-token request) and decode ms/token (a ``new``-token
    request less the first token) of one greedy request on ``service``,
    host wall clock around synchronised calls; each request once after a
    warm-up."""
    dev = service.device

    def run(n):
        service.generate(prompt_ids=prompt, max_new_tokens=n,
                         speculative=spec)
        _sync(dev)
        t0 = time.perf_counter()
        resp = service.generate(prompt_ids=prompt, max_new_tokens=n,
                                speculative=spec)
        _sync(dev)
        return time.perf_counter() - t0, resp

    t1, _ = run(1)
    tn, resp = run(new)
    row = {"ttft_ms": t1 * 1e3, "ms_per_token": (tn - t1) * 1e3 / (new - 1),
           "new_tokens": new}
    if spec:
        st = resp["speculative"]
        row.update(draft=spec, tokens_per_verify_call=st["tokens_per_call"],
                   model_calls=st["model_calls"],
                   acceptance_rate=(st["tokens_emitted"] - st["model_calls"])
                   / max(st["model_calls"] * spec, 1),
                   speculation_disabled=st["speculation_disabled"])
    return row


def phase_gpt2_generate(card: str, base=GPT2_BASE, device="cuda",
                        work=WORK) -> dict:
    """21b, generate.py: phase 6's GPT-2 small checkpoint (full width, 12
    layers) through the port's ``generate.py``, cold, ``--speculative 4``
    and ``--set "arch;args;kv_quant" int8``. Hard in f32 without TF32:
    speculative ids == plain ids, card ids == CPU ids for
    ``GPT2_GEN_NEW`` tokens, B1 ``n_layer`` times per cold prefill.
    Reported in bf16 (the config's dtype): TTFT, ms/token, the speculative
    acceptance rate and tokens per verify call. Returns the launches."""
    from pytorch_distributed_template_tpu_torch.data.datasets import (
        synthetic_lm,
    )
    from pytorch_distributed_template_tpu_torch.engine.serving import (
        GenerationService, load_checkpoint_model,
    )

    ckpt = Path(base) / "checkpoint-epoch1"
    cfg = json.loads((Path(base) / "config.json").read_text())
    vocab = int(cfg["arch"]["args"].get("vocab_size", 50257))
    prompt = synthetic_lm(n=1, seq_len=GPT2_GEN_PROMPT, vocab_size=vocab,
                          training=False)["tokens"][0].tolist()
    argv = ["-r", ckpt, "-s", work / "gen_run", "--prompt-ids",
            ",".join(map(str, prompt)), "--max-new-tokens", GPT2_GEN_NEW,
            "--set", "arch;args;bfloat16", "false"]
    n_layer = int(cfg["arch"]["args"].get("n_layer", 12))
    launches = dict.fromkeys(("flash_fwd", "paged_attn", "expert_ffn"), 0)
    rows = {}
    with _TF32(False, False):
        for label, extra in (("cold", []), ("speculative",
                                            ["--speculative",
                                             GPT2_SPEC_DRAFT]),
                             ("kv_int8", ["--set", "arch;args;kv_quant",
                                          "int8"])):
            resp, wall, counts = _gen_cli(argv + extra + ["--device",
                                                          device])
            _check_ids(resp["ids"], vocab, GPT2_GEN_NEW, f"(21b {label})")
            if label != "speculative" and counts["flash_fwd"] != n_layer:
                raise AssertionError(f"21b {label}: B1 launched "
                                     f"{counts['flash_fwd']} times for one "
                                     f"cold prefill of {n_layer} layers")
            for k in launches:
                launches[k] += counts[k]
            rows[label] = {"ids": resp["ids"], "wall_s": wall,
                           "launches": counts,
                           "speculative": resp.get("speculative")}
        cpu, _, _ = _gen_cli(argv + ["--device", "cpu"])
    if rows["speculative"]["ids"] != rows["cold"]["ids"]:
        raise AssertionError("21b: generate.py --speculative 4 ids differ "
                             "from plain greedy ids")
    if cpu["ids"] != rows["cold"]["ids"]:
        raise AssertionError(f"21b: card ids {rows['cold']['ids']} differ "
                             f"from CPU ids {cpu['ids']}")
    log("[gpt2_generate] f32 " + json.dumps({
        k: {kk: v for kk, v in r.items() if kk != "ids"}
        for k, r in rows.items()}
        | {"int8_ids_equal_dense": rows["kv_int8"]["ids"]
           == rows["cold"]["ids"], "card_ids_equal_cpu": True,
           "speculative_ids_equal_plain": True, "card": card}))
    # bf16 (the config's dtype): the service's times
    arch = {"type": cfg["arch"]["type"], "args": cfg["arch"]["args"]}
    model = load_checkpoint_model(arch, ckpt, device)
    svc = GenerationService.from_model(model, device=device)
    _zero_counts()
    timing = {"plain": _served_times(svc, prompt, GPT2_TIME_NEW),
              "speculative": _served_times(svc, prompt, GPT2_TIME_NEW,
                                           spec=GPT2_SPEC_DRAFT)}
    counts = _launch_counts()
    for k in launches:
        launches[k] += counts[k]
    int8 = load_checkpoint_model(
        {"type": arch["type"], "args": dict(arch["args"], kv_quant="int8")},
        ckpt, device)
    timing["kv_int8"] = _served_times(
        GenerationService.from_model(int8, device=device), prompt,
        GPT2_TIME_NEW)
    log("[gpt2_generate] bf16 " + json.dumps(dict(
        timing, prompt_len=len(prompt), n_layer=n_layer,
        timer="host wall clock around synchronised requests", card=card)))
    del model, svc, int8
    gc.collect()
    _empty_cache(device)
    return {"launches": launches, "timing": timing}


def phase_gpt2_static_serve(card: str, base=GPT2_BASE, device="cuda",
                            work=WORK, sizes=None, seed: int = 0) -> dict:
    """21b, serve.py: the same checkpoint (f32 without TF32) behind the
    port's ``serve.py`` with ``--scheduler auto`` (which must pick
    ``BatchedGenerationService``, the GPT-2 family not being pad-capable)
    and ``--prefix-cache on`` (the scatter arm). 8 concurrent greedy
    requests of one prompt length and 2 of other lengths: each one's ids
    equal its solo ids; a prompt sent alone twice: the second hits the
    scatter arm and equals the cold ids. Reports the scheduler's stats.
    Returns the launches."""
    from pytorch_distributed_template_tpu_torch.engine.serving import (
        BatchedGenerationService, GenerationService,
    )

    sizes = dict(STATIC_SERVE, **(sizes or {}))
    ckpt = Path(base) / "checkpoint-epoch1"
    gen = torch.Generator().manual_seed(seed + 16)
    launches = dict.fromkeys(("flash_fwd", "paged_attn", "expert_ffn"), 0)
    with _TF32(False, False):
        run = ServeRun(["-r", str(ckpt), "-s", str(work / "static_run"),
                        "--port", "0", "--device", str(device),
                        "--scheduler", "auto", "--prefix-cache", "on",
                        "--max-batch", str(sizes["batch"]),
                        "--batch-window-ms", str(sizes["window_ms"]),
                        "--set", "arch;args;bfloat16", "false"])
        try:
            svc = run.service
            if not isinstance(svc, BatchedGenerationService):
                raise AssertionError(f"21b: --scheduler auto picked "
                                     f"{type(svc).__name__}")
            vocab = svc.model.vocab_size
            prompts = [torch.randint(0, vocab, (n,), generator=gen).tolist()
                       for n in [sizes["prompt"]] * sizes["batch"]
                       + list(sizes["others"])]
            bodies = [{"prompt_ids": p, "max_new_tokens": sizes["new"]}
                      for p in prompts]
            _zero_counts()
            t0 = time.perf_counter()
            served = _concurrent(lambda b: stream_request(run, b), bodies)
            wall = time.perf_counter() - t0
            counts = _launch_counts()
            for k in launches:
                launches[k] += counts[k]
            batches = dict(svc.stats)
            solo = GenerationService.from_model(svc.model, device=device)
            alone = [solo.generate(prompt_ids=p,
                                   max_new_tokens=sizes["new"])["ids"]
                     for p in prompts]
            for i, (r, want) in enumerate(zip(served, alone)):
                if r["ids"] != want:
                    raise AssertionError(f"21b: request {i} served in a "
                                         "batch differs from its solo run")
            _zero_counts()
            again = [stream_request(run, bodies[0]) for _ in range(2)]
            counts = _launch_counts()
            for k in launches:
                launches[k] += counts[k]
            pool = svc.prefix_cache_stats()
            if not (pool["batch1_scatter_requests"] >= 2
                    and pool["prefix_hit_tokens"] > 0
                    and pool["warm_admit_copy_bytes"] > 0):
                raise AssertionError(f"21b: the repeated request did not "
                                     f"hit the scatter arm: {pool}")
            if any(r["ids"] != alone[0] for r in again):
                raise AssertionError("21b: the warm (scatter) request's "
                                     "ids differ from the cold ids")
            metrics = json.loads(_http_get(run, "/metrics?format=json"))
            health = json.loads(_http_get(run, "/healthz"))
            n_layer = svc.model.n_layer
            if counts["flash_fwd"] != n_layer:
                raise AssertionError(f"21b: B1 launched {counts['flash_fwd']}"
                                     " times for the repeat pair (one cold "
                                     f"prefill of {n_layer} layers)")
            log("[static_serve] " + json.dumps({
                "scheduler": health["scheduler"], "requests": len(bodies),
                "new_tokens": sum(len(r["ids"]) for r in served),
                "wall_s": wall,
                "tokens_per_s": sum(len(r["ids"]) for r in served) / wall,
                "ttft_ms": [r["ttft_s"] * 1e3 for r in served],
                "stats_after_wave": batches,
                "stats": metrics["stats"], "healthz_batching":
                    health["batching"],
                "pool": {k: pool[k] for k in (
                    "prefix_hit_tokens", "batch1_scatter_requests",
                    "warm_admit_copy_bytes", "prefix_inserted_blocks",
                    "pool_fallback_gpt2_layout")},
                "launches": launches, "solo_equal": True,
                "warm_equal_cold": True, "card": card}))
            if batches["max_batch_size"] < 2:
                raise AssertionError(f"21b: no request shared a batch: "
                                     f"{batches}")
        finally:
            run.close()
    gc.collect()
    _empty_cache(device)
    return launches


def _http_get(run, path: str) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://{run.host}:{run.port}{path}",
                                timeout=120) as r:
        return r.read().decode()


def _quantize(src, out, device="cuda") -> Path:
    from pytorch_distributed_template_tpu_torch.tools import (
        quantize_checkpoint,
    )

    return quantize_checkpoint.main(["-r", str(src), "-o", str(out),
                                     "--device", str(device), "-s",
                                     str(Path(out) / "log")])


def phase_bytelm_quant(card: str, keep=BYTELM_KEEP, device="cuda",
                       work=WORK) -> dict:
    """21c: the JAX docstring's workflow on phase 12's ``bytelm_stdlib``
    model: ``tools/quantize_checkpoint.py``, then ``generate.py --prompt
    "def main(" --speculative 4`` on the w8a16 artifact (B1 once per cold
    prefill phase, ``n_layer`` launches). Reports the weight bytes dense
    and w8a16 and the acceptance rate. Returns the launches."""
    from pytorch_distributed_template_tpu_torch.checkpoint import (
        load_serving_meta,
    )

    n_layer = int(json.loads((Path(keep) / "config.json").read_text())[
        "arch"]["args"]["n_layer"])
    t0 = time.perf_counter()
    art = _quantize(Path(keep) / "checkpoint", work / "bytelm_w8a16",
                    device)
    quant_s = time.perf_counter() - t0
    meta = load_serving_meta(art)
    resp, wall, counts = _gen_cli(["-r", art, "-s", work / "bytelm_gen",
                                   "--prompt", "def main(",
                                   "--max-new-tokens", 64,
                                   "--speculative", GPT2_SPEC_DRAFT,
                                   "--device", device])
    st = resp["speculative"]
    _check_ids(resp["ids"], 256, 64, "(21c)")
    if counts["flash_fwd"] < n_layer or counts["flash_fwd"] % n_layer:
        raise AssertionError(f"21c: B1 launched {counts['flash_fwd']} "
                             f"times ({n_layer} per cold prefill)")
    log("[bytelm_w8a16] " + json.dumps({
        "dense_weight_bytes": meta["dense_bytes"],
        "w8a16_weight_bytes": meta["w8a16_bytes"],
        "ratio": meta["w8a16_bytes"] / meta["dense_bytes"],
        "quantize_s": quant_s, "generate_wall_s": wall,
        "text": resp.get("text"), "speculative": st,
        "acceptance_rate": (st["tokens_emitted"] - st["model_calls"])
        / max(st["model_calls"] * GPT2_SPEC_DRAFT, 1),
        "launches": counts, "card": card}))
    return counts


def phase_moelm_generate(card: str, keep=MOELM_KEEP, device="cuda",
                         work=WORK, new: int = 16) -> dict:
    """21d: phase 7's ``moelm_stdlib`` model through ``generate.py`` in
    f32 without TF32: B5 ``n_moe`` times per model call (at decode
    capacities C = 1), B1 ``n_layer`` times for the cold prefill, card ids
    == CPU ids for ``new`` tokens. Returns the launches."""
    ckpt = Path(keep) / "checkpoint"
    cfg = json.loads((Path(keep) / "config.json").read_text())
    args = cfg["arch"]["args"]
    n_layer = int(args["n_layer"])
    n_moe = n_layer // int(args.get("moe_every", 2))
    argv = ["-r", ckpt, "-s", work / "moe_gen", "--prompt", "def main(",
            "--max-new-tokens", new, "--set", "arch;args;bfloat16", "false"]
    with _TF32(False, False):
        resp, wall, counts = _gen_cli(argv + ["--device", device])
        cpu, _, _ = _gen_cli(argv + ["--device", "cpu"])
    calls = new            # one prefill, new - 1 decode steps
    if counts["expert_ffn"] != n_moe * calls:
        raise AssertionError(f"21d: B5 launched {counts['expert_ffn']} "
                             f"times for {calls} model calls of {n_moe} "
                             "MoE blocks")
    if counts["flash_fwd"] != n_layer:
        raise AssertionError(f"21d: B1 launched {counts['flash_fwd']} "
                             f"times for one cold prefill of {n_layer} "
                             "layers")
    if resp["ids"] != cpu["ids"]:
        raise AssertionError(f"21d: card ids {resp['ids']} differ from CPU "
                             f"ids {cpu['ids']}")
    log("[moelm_generate] " + json.dumps({
        "ids": resp["ids"], "text": resp.get("text"), "wall_s": wall,
        "model_calls": calls, "launches": counts,
        "card_ids_equal_cpu": True, "card": card}))
    return counts


def phase_mistral_w8a16(card: str, model_path, config=SERVE_CONFIG,
                        device="cuda", work=WORK, sizes=None,
                        seed: int = 0, arch=MAIN_ARCH,
                        arch_args=None) -> int:
    """21e: phase 4's Mistral-7B artifact (12 of 32 layers, ``MAIN_ARGS``)
    quantized to w8a16, its bf16 prefill logits (1024 tokens) against the
    dense model on the dequantized weights within ``W8A16_LOGIT_RTOL``,
    while the control (``W8A16_CONTROL_PROJ``'s scale zeroed) lands at 2 x
    ``W8A16_LOGIT_RTOL`` or more; reported beside them the same scale
    rolled by one channel and the dense model on the artifact's own
    weights (the quantization error). Then served by the continuous engine over the paged pool under cell
    (e)'s traffic (ServeWave's exact B4 / B1 counts; weight bytes, peak
    memory, TTFT and ms/token beside phase 5's). Returns B4's launches."""
    from pytorch_distributed_template_tpu_torch.checkpoint import (
        load_serving_meta,
    )
    from pytorch_distributed_template_tpu_torch.config.registry import (
        MODELS,
    )
    from pytorch_distributed_template_tpu_torch.engine.serving import (
        _assign, load_serving_model,
    )
    from pytorch_distributed_template_tpu_torch.models.quant import (
        dequantize_params_w8,
    )

    sizes = dict(SERVE_SIZES, **(sizes or {}))
    dense_args = dict(MAIN_ARGS if arch_args is None else arch_args)
    t0 = time.perf_counter()
    art = _quantize(model_path, work / "mistral_w8a16", device)
    quant_s = time.perf_counter() - t0
    meta = load_serving_meta(art)
    args = dict(dense_args, quant="w8a16")
    # the tool verified what it wrote; ServeRun's load verifies it again
    qm = load_serving_model({"type": arch, "args": args}, art, device,
                            verify=False)
    ids = torch.randint(0, qm.vocab_size, (sizes["logit_prompt"],),
                        generator=torch.Generator().manual_seed(seed + 21))

    def prefill(m):
        cache = m.new_cache(1, len(ids) + 1)
        return m(ids[None].to(device), cache=cache, prefill=True)[:, -1]

    with torch.no_grad():
        got = prefill(qm)
        # the controls: one projection's scale zeroed (the check must
        # see it) and rolled by one channel (reported), then put back
        proj = qm.get_submodule(W8A16_CONTROL_PROJ)
        keep = proj.scale.clone()
        proj.scale.zero_()
        zeroed = prefill(qm)
        proj.scale.copy_(keep.roll(1))
        rolled = prefill(qm)
        proj.scale.copy_(keep)
        deq = dequantize_params_w8(qm.state_dict())
        del qm
        dm = _assign(MODELS.get(arch)(**dense_args, device="meta"),
                     deq, arch, art, device)
        del deq
        ref = prefill(dm)
        del dm
        # the quantization error itself: the dense model on the
        # artifact's own (unquantized) weights
        om = load_serving_model({"type": arch, "args": dense_args},
                                model_path, device, verify=False)
        dense = prefill(om)
        del om
    scale = ref.abs().max().item()

    def rel(x):
        return (x - ref).abs().max().item() / scale

    err = (got - ref).abs().max().item()
    logit_row = {"prompt_len": len(ids), "logits_max_abs_diff": err,
                 "logits_max_abs": scale, "rel": err / scale,
                 "rtol": W8A16_LOGIT_RTOL,
                 "same_argmax": bool(got.argmax() == ref.argmax()),
                 "control_proj": W8A16_CONTROL_PROJ,
                 "control_scale_zeroed_rel": rel(zeroed),
                 "control_scale_rolled_rel": rel(rolled),
                 "dense_unquantized_rel": rel(dense)}
    if not (torch.isfinite(got).all() and err <= W8A16_LOGIT_RTOL * scale):
        raise AssertionError(f"21e: the w8a16 prefill logits differ from "
                             f"the dequantized dense model's: {logit_row}")
    if logit_row["control_scale_zeroed_rel"] < 2 * W8A16_LOGIT_RTOL:
        raise AssertionError(f"21e: the control (one projection's scale "
                             f"zeroed) passes the check: {logit_row}")
    del got, ref, zeroed, rolled, dense
    gc.collect()
    _empty_cache(device)
    cfg = json.loads(Path(config).read_text())
    cfg["arch"] = {"type": arch, "args": args}
    (work / "serve_w8a16.json").write_text(json.dumps(cfg))
    base = ["-r", str(art), "-c", str(work / "serve_w8a16.json"), "-s", str(work / "w8_run"),
            "--port", "0", "--max-batch", str(sizes["slots"]),
            "--decode-chunk", str(sizes["chunk"]), "--device", str(device)]
    waves = ServeWave(card, device)
    run = ServeRun(base)
    try:
        svc = run.service
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in svc.model.state_dict().values())
        prompts = _cell_e_prompts(svc.model.vocab_size, sizes, seed)
        _mix_e(run, waves, "e_w8a16", sizes, prompts)
    finally:
        run.close()
    log("[mistral_w8a16] " + json.dumps({
        "dense_weight_bytes": meta["dense_bytes"],
        "w8a16_weight_bytes": meta["w8a16_bytes"],
        "served_weight_bytes": weight_bytes, "quantize_s": quant_s,
        "logits": logit_row, "card": card}))
    del run
    gc.collect()
    _empty_cache(device)
    return waves.b4_launches


# ---------------------------------------------------------------------------
# slice 17: page shipping between roles and the KV spill tiers (B4 over
# pages that arrive by a host-to-device copy)
# ---------------------------------------------------------------------------

# 22a: phase 3b's small f32 Llama without its window (whole prompts stay in
# the radix and ship), block 8, one request at a time
SHIP_REF_ARCH = dict(REF_ARCH, window=0)
SHIP_REF_PROMPTS = (29, 44, 70)
SHIP_REF_NEW = 12
# 22b / 22c over phase 4's artifact: 22c's decode server holds
# ``small_pool`` pages (cell (e)'s prompts take ~250 with their decodes)
# over a host tier of ``host_spill`` pages whose overflow goes to disk
# (``disk_spill`` pages); its ``first`` prompts are asked again after the
# others evicted them; ``ttft_prompt`` tokens for the TTFT pair
SHIP_SIZES = {"small_pool": 160, "host_spill": 16, "disk_spill": 512,
              "first": 2, "ttft_prompt": 1024}
# a compared wave's batching window: the wave's requests, sent in order
# SHIP_GAP_S apart, are all pending at the engine's first tick, so two
# servers schedule one wave alike
SHIP_WINDOW_S = 0.6
SHIP_GAP_S = 0.05


def _post_any(run: ServeRun, path: str, body, headers=None) -> tuple:
    """One POST whatever its status: ``(status, response headers, body
    bytes, seconds)``."""
    import http.client

    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    conn = http.client.HTTPConnection(run.host, run.port, timeout=1200)
    t0 = time.perf_counter()
    conn.request("POST", path, body=data, headers=dict(headers or {}))
    resp = conn.getresponse()
    out = resp.read()
    dt = time.perf_counter() - t0
    conn.close()
    return resp.status, dict(resp.getheaders()), out, dt


def _post(run: ServeRun, path: str, body, headers=None) -> tuple:
    """One POST: ``(response headers, body bytes, seconds)``; any status
    but 200 raises."""
    status, hdrs, out, dt = _post_any(run, path, body, headers)
    if status != 200:
        raise AssertionError(f"POST {path}: {status} {out[:500]!r}")
    return hdrs, out, dt


def _admit(run: ServeRun, blob: bytes, headers=None) -> tuple:
    """``POST /admit_pages``: ``(receipt, seconds)``."""
    _, out, dt = _post(run, "/admit_pages", blob,
                       {"Content-Type": "application/octet-stream",
                        **(headers or {})})
    return json.loads(out), dt


def _metrics(run: ServeRun) -> dict:
    return json.loads(_http_get(run, "/metrics?format=json"))


def _ordered_wave(run: ServeRun, bodies) -> list:
    """The bodies as one wave of streamed requests, sent in order
    ``SHIP_GAP_S`` apart inside a ``SHIP_WINDOW_S`` batching window."""
    import threading

    svc = run.service
    window, svc._window_s = svc._window_s, SHIP_WINDOW_S
    out = [None] * len(bodies)

    def one(i):
        out[i] = stream_request(run, bodies[i])

    try:
        threads = []
        for i in range(len(bodies)):
            threads.append(threading.Thread(target=one, args=(i,),
                                            daemon=True))
            threads[-1].start()
            time.sleep(SHIP_GAP_S)
        for th in threads:
            th.join(1200)
    finally:
        svc._window_s = window
    if any(r is None for r in out):
        raise AssertionError("a request of an ordered wave failed")
    return out


def _prefill_calls(pf, ids) -> int:
    """Model calls the batch-1 paged prefill of ``ids`` makes on ``pf``
    now: none when every full block is pooled, else one per ring-slack
    chunk of the uncached suffix and one for the rest."""
    cached = pf.cached_block_count(ids)
    if cached >= len(ids) // pf.block:
        return 0
    left = len(ids) - min(cached, (len(ids) - 1) // pf.block) * pf.block
    calls = 1
    while pf.window and left > pf.ring_slack_tokens:
        left -= pf.ring_slack_tokens
        calls += 1
    return calls


def _counted_prefills(label, run: ServeRun, prompts, device,
                      headers=None) -> tuple:
    """``POST /prefill`` of each prompt in order (the batch-1 paged prefill
    of what is not pooled, then the export): B4 = n_layer x those model
    calls, all on the wgmma arm on the card, and B1 0. Returns ``(bodies,
    seconds, B4 launches)``."""
    from pytorch_distributed_template_tpu_torch.ops.flash import (
        FLASH_FWD, PAGED_ARM_LAUNCHES, PAGED_ATTN,
    )

    pf, n_layer = run.service._prefix, run.service.model.n_layer
    _sync(device)
    _zero_counts()
    arms0 = dict(PAGED_ARM_LAUNCHES)
    calls, blobs, secs = 0, [], []
    for ids in prompts:
        calls += _prefill_calls(pf, ids)
        hdrs, blob, dt = _post(run, "/prefill", {"prompt_ids": ids},
                               headers)
        if int(hdrs["X-Ship-Blocks"]) != len(ids) // pf.block:
            raise AssertionError(f"({label}) {hdrs['X-Ship-Blocks']} blocks "
                                 f"shipped of a {len(ids)}-token prompt")
        blobs.append(blob)
        secs.append(dt)
    _sync(device)
    arms = {a: PAGED_ARM_LAUNCHES[a] - arms0[a] for a in arms0}
    want = n_layer * calls
    is_cuda = torch.device(device).type == "cuda"
    if (PAGED_ATTN.launches != want or FLASH_FWD.launches
            or (is_cuda and arms != {"wgmma": want, "decode": 0,
                                     "cuda_cores": 0})):
        raise AssertionError(
            f"({label}) prefills of {calls} model calls: B4 "
            f"{PAGED_ATTN.launches} (arms {arms}), B1 {FLASH_FWD.launches}")
    return blobs, secs, PAGED_ATTN.launches


def _check_b4_over_pages(label, pf, ids, seed: int, t: int = 16) -> float:
    """B4 over the pages ``pf`` holds for ``ids`` (pages that came in by a
    host-to-device copy) against its plain version on the same inputs:
    ``t`` random query lanes at the chain's end over layer 0's leaves,
    within phase 2b's limits (``TOL``). Its launch is not the path's.
    Returns the max abs error."""
    from pytorch_distributed_template_tpu_torch.ops.flash import (
        PAGED_ATTN, paged_attention, paged_attention_ref,
    )

    _, blocks = pf.index.match(ids)
    layer, model = pf.pool.layers[0], pf.model
    dev, dtype = layer.k.device, model.dtype
    gen = torch.Generator().manual_seed(seed)
    hq = layer.k.shape[2] * (model.n_head // model.n_kv_head)
    q = torch.randn((1, t, hq, layer.k.shape[3]), generator=gen)
    tables = torch.full((1, pf.nb_max), -1, dtype=torch.int32)
    tables[0, :len(blocks)] = torch.tensor(blocks, dtype=torch.int32)
    starts = torch.tensor([len(blocks) * pf.block - t], dtype=torch.int32)
    pads = torch.zeros((1,), dtype=torch.int32)
    q = q.to(dev, dtype)
    tables, starts, pads = (x.to(dev) for x in (tables, starts, pads))
    kw = dict(window=pf.window, k_scale=layer.k_scale, v_scale=layer.v_scale)
    launches = PAGED_ATTN.launches
    with torch.no_grad():
        out = paged_attention(q, layer.k, layer.v, tables, starts, pads,
                              **kw)
        f32 = ((lambda x: x) if layer.k_scale is not None
               else (lambda x: x.float()))
        ref = paged_attention_ref(q.float(), f32(layer.k), f32(layer.v),
                                  tables, starts, pads, **kw)
    PAGED_ATTN.launches = launches
    atol, rtol, _ = TOL[dtype]
    diff = (out.float() - ref).abs()
    err = diff.max().item()
    if not torch.isfinite(out).all() or (
            diff - rtol * ref.abs()).max().item() > atol:
        raise AssertionError(f"({label}) B4 over imported pages disagrees "
                             f"with its plain version: max err {err:.3e}")
    return err


def phase_ship_reference(device="cuda") -> dict:
    """22a: phase 3b's small f32 Llama (its window off) on ``device`` and
    on the CPU, f32 and int8 pools, one request at a time. A payload
    exported on the card imports into a CPU pool and one exported on the
    CPU imports on the card; each decodes the colocated greedy ids (equal
    on both sides). The card's ``serialize_pages`` of a set of leaves is
    byte-equal to the CPU's (as they are, and cast to bf16); B4 over the
    imported pages agrees with its plain version. Returns B4's max error
    per pool."""
    import pytorch_distributed_template_tpu_torch.models  # noqa: F401
    from pytorch_distributed_template_tpu_torch.config.registry import MODELS
    from pytorch_distributed_template_tpu_torch.engine.kvcache import (
        deserialize_pages, serialize_pages,
    )
    from pytorch_distributed_template_tpu_torch.engine.serving import (
        GenerationService,
    )

    rng = np.random.default_rng(22)
    prompts = [[int(x) for x in rng.integers(
        0, SHIP_REF_ARCH["vocab_size"], n)] for n in SHIP_REF_PROMPTS]
    block = PAGED_REF_POOL["block_tokens"]
    errs = {}
    for kv_quant in ("", "int8"):
        label = kv_quant or "f32"
        cpu_model = MODELS.get("Llama")(**SHIP_REF_ARCH, kv_quant=kv_quant,
                                        device="cpu")
        cpu_model.init_weights(torch.Generator().manual_seed(2))
        dev_model = MODELS.get("Llama")(**SHIP_REF_ARCH, kv_quant=kv_quant,
                                        device=device)
        dev_model.load_state_dict(cpu_model.state_dict())
        models = {"card": (dev_model, device), "cpu": (cpu_model, "cpu")}

        def service(side):
            model, dev = models[side]
            return GenerationService.from_model(
                model, device=dev, prefix_cache=dict(PAGED_REF_POOL))

        src = {side: service(side) for side in models}
        dst = {side: service(side) for side in models}
        for i, ids in enumerate(prompts):
            colo = {side: s.generate(prompt_ids=ids,
                                     max_new_tokens=SHIP_REF_NEW)["ids"]
                    for side, s in src.items()}
            if colo["card"] != colo["cpu"]:
                raise AssertionError(f"22a ({label}): colocated ids differ "
                                     f"on the card and the CPU: {colo}")
            blobs = {side: serialize_pages(s._prefix.export_pages(ids))
                     for side, s in src.items()}
            for to, frm in (("cpu", "card"), ("card", "cpu")):
                receipt = dst[to].import_remote_pages(blobs[frm])
                if receipt["imported_blocks"] != len(ids) // block:
                    raise AssertionError(f"22a ({label}): {frm} -> {to} "
                                         f"imported {receipt}")
                got = dst[to].generate(prompt_ids=ids,
                                       max_new_tokens=SHIP_REF_NEW)["ids"]
                if got != colo["cpu"]:
                    raise AssertionError(
                        f"22a ({label}): pages shipped {frm} -> {to} "
                        f"decode {got}, colocated {colo['cpu']}")
            # the same leaves serialized on the card and on the CPU
            payload = deserialize_pages(blobs["cpu"])
            for cast in (None, torch.bfloat16):
                leaves = {k: v.to(cast) if cast is not None
                          and v.dtype == torch.float32 else v
                          for k, v in payload["leaves"].items()}
                on_card = dict(payload, leaves={
                    k: v.to(device) for k, v in leaves.items()})
                if serialize_pages(on_card) != serialize_pages(
                        dict(payload, leaves=leaves)):
                    raise AssertionError(f"22a ({label}): serialize_pages "
                                         f"differs on the card ({cast})")
            errs[label] = max(errs.get(label, 0.0), _check_b4_over_pages(
                f"22a {label}", dst["card"]._prefix, ids, seed=i))
    log("[ship-reference] small f32 Llama (D 64, block 8), prompts "
        f"{list(SHIP_REF_PROMPTS)}, {SHIP_REF_NEW} greedy tokens each: card "
        "-> CPU and CPU -> card imports decode the colocated ids (f32 and "
        "int8 pools); serialize_pages byte-equal on both sides (f32, bf16, "
        "int8 leaves); B4 over imported pages, max abs err "
        + json.dumps(errs))
    return errs


def _handoff(label, device, waves, servers, prompts, sizes) -> dict:
    """22b over one pool layout, in order: every prompt ``POST /prefill``
    to the prefill server and the body relayed to the decode server's
    ``/admit_pages``; the colocated server computes the same pages
    (``/prefill`` on a ``both`` replica runs the same batch-1 prefill in
    the same order); then each of the two answers the prompts as one
    ordered wave, and the decode server's ids must equal the colocated warm
    repeat's. The bytes: every block the prefill server shipped is counted
    out, each the decode pool lacked is counted in, the rest it held
    already (the shared prefix)."""
    pre, dec, colo = servers["prefill"], servers["decode"], servers["both"]
    blobs, prefill_s, b4 = _counted_prefills(f"{label} prefill", pre,
                                             prompts, device)
    receipts, admit_s = zip(*[_admit(dec, blob) for blob in blobs])
    _, _, b4c = _counted_prefills(f"{label} colocated prefill", colo,
                                  prompts, device)
    err = _check_b4_over_pages(f"{label} decode pool", dec.service._prefix,
                               prompts[-1], seed=3)
    bodies = [{"prompt_ids": p, "max_new_tokens": sizes["new"]}
              for p in prompts]
    dsvc = dec.service
    pf = dsvc._prefix
    shipped = waves.run(f"{label}_decode", dsvc,
                        lambda: _ordered_wave(dec, bodies), sizes["new"],
                        copy_bytes=pf.counter("page_ship_in_bytes"))
    warm = waves.run(f"{label}_colocated_warm", colo.service,
                     lambda: _ordered_wave(colo, bodies), sizes["new"])
    bad = [i for i, (a, b) in enumerate(zip(shipped, warm))
           if a["ids"] != b["ids"]]
    if bad:
        raise AssertionError(f"({label}) shipped ids differ from the "
                             f"colocated warm repeat's for prompts {bad}")
    pm, dm = _metrics(pre), _metrics(dec)
    sent = sum(len(p) // pf.block for p in prompts) * pf.page_bytes
    held = sum(r["cached_tokens"] // pf.block - r["imported_blocks"]
               for r in receipts) * pf.page_bytes
    got = sum(r["bytes"] for r in receipts)
    if not (pm["page_ship_out_bytes_total"] == sent
            and dm["page_ship_in_bytes_total"] == got
            and got + held == sent):
        raise AssertionError(
            f"({label}) ship bytes: out {pm['page_ship_out_bytes_total']} "
            f"(want {sent}), in {dm['page_ship_in_bytes_total']} + "
            f"{held} already pooled (receipts {got})")
    return {"shipped": [r["ids"] for r in shipped],
            "warm": [r["ids"] for r in warm], "b4": b4 + b4c,
            "b4_err": err, "prefill_ms": [s * 1e3 for s in prefill_s],
            "admit_ms": [s * 1e3 for s in admit_s],
            "out_bytes": pm["page_ship_out_bytes_total"],
            "in_bytes": dm["page_ship_in_bytes_total"], "held_bytes": held,
            "page_bytes": pf.page_bytes,
            "payload_bytes": [len(b) for b in blobs]}


#: (aa)'s shipped 1024-token TTFT and the colocated cold one before this
#: split was traced (F22d: NVIDIA H100 80GB HBM3, 700.00 W)
SHIP_TTFT_BEFORE_MS = {"shipped": 554.1, "colocated_cold": 238.3}
#: the stitched segments must explain this share of the client's e2e
SHIP_MIN_COVERAGE = 0.9


def _traced_handoff(waves, servers, z_ship, z_cold, sizes, device, work,
                    seed: int) -> dict:
    """22b's TTFT pair: ``z_ship`` shipped (``/prefill`` on the prefill
    server, ``/admit_pages`` on the decode server, then ``/generate``
    there) under one ``X-Request-Id``, ``z_cold`` served cold by the
    colocated server. The script records the client's side as the fleet
    router would (``request``, ``admission_wait``, ``page_ship`` and
    ``proxy`` spans of a tracer named ``router``) and stitches them with the
    two servers' ``spans.jsonl`` (``reqtrace.stitch_spans``, each server's
    records tagged with its role). Hard: the shipped request's fingerprint
    has ``ship``, it has its complete event, and the stitched segments
    cover ``SHIP_MIN_COVERAGE`` of the client's e2e. Returns the readings
    and B4's launches (``"b4"``)."""
    from pytorch_distributed_template_tpu_torch.observability import (
        reqtrace,
    )

    rid = f"ship-ttft-{seed}"
    hdr = {"X-Request-Id": rid}
    dec = servers["decode"]
    dsvc = dec.service
    client = reqtrace.RequestTracer(work / "ship" / "client" / "spans.jsonl",
                                    process="router")
    box = {}
    try:
        t_req = time.monotonic()
        client.add(rid, "admission_wait", t_req, t_req)
        (blob,), (pre_s,), b4 = _counted_prefills(
            "22b ttft prefill", servers["prefill"], [z_ship], device,
            headers=hdr)
        receipt, admit_s = _admit(dec, blob, hdr)
        client.add(rid, "page_ship", t_req, time.monotonic(),
                   blocks=receipt["imported_blocks"])

        def drive():
            box["t0"] = time.monotonic()
            out = [stream_request(dec, {"prompt_ids": z_ship,
                                        "max_new_tokens": sizes["new"]},
                                  hdr)]
            box["t1"] = time.monotonic()
            return out

        first = waves.run(
            "22b_ttft_shipped", dsvc, drive, sizes["new"],
            copy_bytes=dsvc._prefix.counter("page_ship_in_bytes"))[0]
        client.add(rid, "proxy", box["t0"], box["t1"], replica="decode")
        client.add(rid, "request", t_req, box["t1"])
    finally:
        client.close()
    e2e = box["t1"] - t_req
    colo = waves.run(
        "22b_ttft_colocated", servers["both"].service,
        lambda: [stream_request(servers["both"], {
            "prompt_ids": z_cold, "max_new_tokens": sizes["new"]})],
        sizes["new"])[0]
    if "ship" not in first["serve_path"].split("_"):
        raise AssertionError(f"22b: the shipped request served on "
                             f"{first['serve_path']} (no ship)")
    check_traced(dec, [first], "22b ttft")
    spans = [r for r in reqtrace.load_spans([client.path])
             + servers["prefill"].spans("prefill") + dec.spans("decode")
             if r.get("rid") == rid]
    stitched = reqtrace.stitch_spans(spans, client_e2e_by_rid={rid: e2e})
    row = stitched["requests"][0]
    if not (row["stitched"] and row["coverage"] >= SHIP_MIN_COVERAGE):
        raise AssertionError(f"22b: the shipped request's stitched spans "
                             f"cover {row.get('coverage')} of its e2e "
                             f"(need {SHIP_MIN_COVERAGE}): {row}")
    named = {}
    for r in sorted(spans, key=lambda r: r["t"]):
        named.setdefault(r["name"], r)
    seg = row["segments"]

    def dur(name):
        return named[name]["dur_ms"] if name in named else "not traced"

    split = {
        "prefill_http_ms": dur("prefill_http"),
        "prefill_export_ms": dur("prefill_export"),
        "admit_http_ms": dur("admit_http"), "http_ms": dur("http"),
        "queue_wait_ms": dur("queue_wait"), "tier_ms": dur("tier"),
        "admit_segment_ms": seg.get("admit", 0.0) * 1e3,
        "first_token_ms_after_start": (named["first_token"]["t"]
                                       - named["request"]["t"]) * 1e3,
        "decode_segment_ms": seg.get("decode", 0.0) * 1e3}
    out = {"prompt_len": len(z_ship), "payload_bytes": len(blob),
           "prefill_ms": pre_s * 1e3, "admit_ms": admit_s * 1e3,
           "decode_ttft_ms": first["ttft_s"] * 1e3,
           "shipped_ttft_ms": (pre_s + admit_s + first["ttft_s"]) * 1e3,
           "colocated_ttft_ms": colo["ttft_s"] * 1e3,
           "ship_mb_per_s": len(blob) / 2 ** 20 / admit_s,
           "before_ms": SHIP_TTFT_BEFORE_MS, "rid": rid,
           "serve_path": first["serve_path"],
           "client_e2e_ms": e2e * 1e3, "coverage": row["coverage"],
           "residual_ms": row["residual_s"] * 1e3,
           "segments_ms": {k: v * 1e3 for k, v in seg.items()},
           "spans_ms": split, "b4": b4}
    log("[ship-trace] " + json.dumps({k: v for k, v in out.items()
                                      if k != "b4"}))
    return out


def phase_ship(card: str, model_path, config=SERVE_CONFIG, device="cuda",
               work=WORK, sizes=None, seed: int = 0, arch=MAIN_ARCH,
               arch_args=None, cold=None, model=None) -> int:
    """22b and 22c: phase 4's artifact (``MAIN_ARGS``), loaded once per KV
    type and served by the port's ``serve.py`` in this process as a ``--role
    prefill`` server, a ``--role decode`` server and a colocated one, each
    with its own pool. 22b: cell (e)'s 8 prompts handed off (``_handoff``),
    their agreement with a cold (e) wave reported (``cold``: phase 5's
    ids of the same prompts; None runs the wave on a fourth server), the TTFT
    of a shipped request against a colocated cold one, then cell (g)'s mix
    over int8 pools (the scales ship with the pages; the first int8
    server loads through ``serving.kv_quant``, the others serve its
    weights). 22c: a decode server with ``small_pool`` pages over a host
    tier and a disk tier under ``work``: the first prompts' pages, evicted
    by the others' imports, are promoted when those prompts come again,
    with their first ids, some read back from disk, none failing its
    checksum; a
    ``corrupt_spill`` fault makes the tier's latest entry read as a miss,
    and the request then gives the ids of a server holding only the
    blocks that verified. ``model``: the artifact's weights already
    loaded (else loaded here). Returns B4's launches on the path."""
    from pytorch_distributed_template_tpu_torch.engine.kvcache import (
        deserialize_pages, serialize_pages,
    )
    from pytorch_distributed_template_tpu_torch.engine.serving import (
        load_serving_model,
    )
    from pytorch_distributed_template_tpu_torch.resilience import faults

    sizes = {**SERVE_SIZES, **SHIP_SIZES, **(sizes or {})}
    args = dict(MAIN_ARGS if arch_args is None else arch_args)
    t0 = time.perf_counter()
    own = model is None
    if own:
        # phase 5's ServeRun verified the artifact's manifest already
        model = load_serving_model({"type": arch, "args": args}, model_path,
                                   device, verify=False)
    load_s = time.perf_counter() - t0
    waves = ServeWave(card, device)
    prompts = _cell_e_prompts(model.vocab_size, sizes, seed)
    gen = torch.Generator().manual_seed(seed + 22)

    def fresh(n):
        return torch.randint(0, model.vocab_size, (n,),
                             generator=gen).tolist()

    def argv(name, *extra):
        return ["-r", str(model_path), "-c", str(config), "-s",
                str(work / "ship" / name), "--port", "0", "--max-batch",
                str(sizes["slots"]), "--decode-chunk", str(sizes["chunk"]),
                "--device", str(device)] + list(extra)

    runs = []

    def serve(name, m, *extra):
        runs.append(ServeRun(argv(name, *extra), model=m))
        return runs[-1]

    report = {"load_s": load_s, "card": card}
    b4 = 0
    try:
        # ---- 22b: the handoff, bf16 pool ---------------------------------
        t22b = time.perf_counter()
        servers = {"prefill": serve("prefill", model, "--role", "prefill"),
                   "decode": serve("decode", model, "--role", "decode"),
                   "both": serve("both", model)}
        if cold is None:
            cold = [r["ids"] for r in _mix_e(serve("cold", model), waves,
                                              "22b_cold", sizes, prompts)]
        out = _handoff("22b", device, waves, servers, prompts, sizes)
        b4 += out.pop("b4")
        agree = [a == c for a, c in zip(out["warm"], cold)]
        same_tokens = sum(x == y for a, c in zip(out["warm"], cold)
                          for x, y in zip(a, c))
        report["22b"] = dict(
            {k: v for k, v in out.items() if k not in ("shipped", "warm")},
            prompts_equal_to_cold=sum(agree),
            tokens_equal_to_cold=same_tokens,
            tokens=sum(len(a) for a in out["warm"]))
        # TTFT: a fresh prompt shipped (prefill + relay + admit + the
        # decode server's first token) against a fresh one served cold, the
        # shipped one traced end to end under one request id
        z_ship, z_cold = fresh(sizes["ttft_prompt"]), fresh(
            sizes["ttft_prompt"])
        report["22b"]["ttft"] = _traced_handoff(
            waves, servers, z_ship, z_cold, sizes, device, work, seed)
        b4 += report["22b"]["ttft"].pop("b4")
        report["22b"]["s"] = time.perf_counter() - t22b
        # the bf16 prefill server stays: 22c's payloads are its exports
        keep = servers["prefill"]
        for run in runs[1:]:
            run.close()
        del runs[1:]
        gc.collect()
        _empty_cache(device)
        # ---- 22b: cell (g)'s mix over int8 pools --------------------------
        # the first server loads the int8-KV model through the config
        # path (serving.kv_quant); the other two serve its weights
        t22g = time.perf_counter()
        int8 = ("--set", "serving;kv_quant", "int8")
        first8 = serve("prefill8", None, "--role", "prefill", *int8)
        model8 = first8.service.model
        if model8.kv_quant != "int8" or \
                first8.service._prefix.pool.layers[0].k_scale is None:
            raise AssertionError("22b (g): the int8 pool was not configured")
        servers = {"prefill": first8,
                   "decode": serve("decode8", model8, "--role", "decode",
                                   *int8),
                   "both": serve("both8", model8, *int8)}
        out = _handoff("22b_int8", device, waves, servers, prompts, sizes)
        b4 += out.pop("b4")
        report["22b_int8"] = dict(
            {k: v for k, v in out.items() if k not in ("shipped", "warm")},
            s=time.perf_counter() - t22g)
        for run in runs[1:]:
            run.close()
        del runs[1:], servers, first8, model8
        gc.collect()
        _empty_cache(device)
        # ---- 22c: the tiers -----------------------------------------------
        # the prompts sharing no prefix come first: their pages are the
        # oldest in the small pool, and the others' imports evict them
        t22c = time.perf_counter()
        n_shared = len(sizes["shared_suffix"])
        order = prompts[n_shared:] + prompts[:n_shared]
        blobs, _, n = _counted_prefills("22c prefill", keep, order, device)
        b4 += n
        dec = serve(
            "decode_small", model, "--role", "decode",
            "--set", "serving;prefix_cache;pool_blocks",
            str(sizes["small_pool"]),
            "--spill-blocks", str(sizes["host_spill"]),
            "--spill-dir", str(work / "ship" / "spill"),
            "--spill-disk-blocks", str(sizes["disk_spill"]))
        dsvc = dec.service
        pf = dsvc._prefix

        def alone(label, ids, paths=None):
            promoted0 = pf.counter("tier_promoted_blocks")
            out = waves.run(
                label, dsvc, lambda: [stream_request(dec, {
                    "prompt_ids": ids, "max_new_tokens": sizes["new"]})],
                sizes["new"],
                copy_bytes=pf.counter("page_ship_in_bytes"))[0]
            if paths is not None:
                paths.append((out["serve_path"], pf.counter(
                    "tier_promoted_blocks") - promoted0))
            return out["ids"]

        k = sizes["first"]
        firsts = []
        for i in range(k):
            _admit(dec, blobs[i])
            firsts.append(alone(f"22c_first_{i}", order[i]))
        for blob in blobs[k:]:
            _admit(dec, blob)
        st = pf.stats_snapshot()
        evicted = [len(p) // pf.block - pf.cached_block_count(p)
                   for p in order[:k]]
        if not (st["tier_demoted_blocks"] > 0 and all(evicted)
                and st["tier_disk_blocks"] > 0):
            raise AssertionError(
                f"22c: the others' imports did not evict the first prompts "
                f"to the tiers ({evicted} blocks gone; demoted "
                f"{st['tier_demoted_blocks']}, {st['tier_disk_blocks']} on "
                "disk)")
        disk0 = pf.spill.disk_hits
        again_paths = []
        again = [alone(f"22c_again_{i}", order[i], again_paths)
                 for i in range(k)]
        # a request that read pages brought back up the tiers says so in
        # its serve path (one whose promoted block it cannot use, the
        # prompt's last, does not)
        flagged = ["promote" in fp.split("_") for fp, _ in again_paths]
        if not any(flagged) or any(f and not n for f, (_, n) in zip(
                flagged, again_paths)):
            raise AssertionError(f"22c: (serve path, blocks promoted) of the "
                                 f"repeated requests: {again_paths}")
        st2 = pf.stats_snapshot()
        promoted = st2["tier_promoted_blocks"] - st["tier_promoted_blocks"]
        # the sound promotions read pages back from disk too, every one
        # verified (a broken disk read would read as corrupt)
        from_disk = pf.spill.disk_hits - disk0
        sound_failures = (st2["tier_checksum_failures"]
                          - st["tier_checksum_failures"])
        if (again != firsts or promoted <= 0 or from_disk <= 0
                or sound_failures):
            raise AssertionError(
                f"22c: promoted ids equal the first answers: "
                f"{[a == b for a, b in zip(again, firsts)]}, "
                f"{promoted} blocks promoted, {from_disk} read from disk, "
                f"{sound_failures} checksum failures")
        # corrupt_spill: the tier's latest entry is flipped at the next tier
        # event (this request's promotion), which then reads it as a miss
        key = list(next(reversed(pf.spill._host)))
        q = key + fresh(5)
        os.environ["PDT_FAULTS"] = "corrupt_spill@evt:1"
        faults.reset()
        try:
            hit0 = pf.counter("prefix_hit_tokens")
            fail0 = pf.counter("tier_checksum_failures")
            got = alone("22c_corrupt", q)
            held = (pf.counter("prefix_hit_tokens") - hit0) // pf.block
            failures = pf.counter("tier_checksum_failures") - fail0
        finally:
            del os.environ["PDT_FAULTS"]
            faults.reset()
        if failures < 1 or held * pf.block >= len(key):
            raise AssertionError(f"22c: the corrupt entry was not read as a "
                                 f"miss ({failures} failures, {held} blocks "
                                 f"served of {len(key) // pf.block})")
        # the reference: a server holding only the blocks that verified
        _, raw, _ = _post(dec, "/export_pages", {"prompt_ids": q})
        payload = deserialize_pages(raw)
        payload.update(n_blocks=held, token_ids=q[:held * pf.block],
                       leaves={p: t[:held]
                               for p, t in payload["leaves"].items()})
        ref_run = serve("verified", model)
        _admit(ref_run, serialize_pages(payload))
        ref = waves.run(
            "22c_verified_reference", ref_run.service,
            lambda: [stream_request(ref_run, {
                "prompt_ids": q, "max_new_tokens": sizes["new"]})],
            sizes["new"],
            copy_bytes=ref_run.service._prefix.counter(
                "page_ship_in_bytes"))[0]["ids"]
        if got != ref:
            raise AssertionError("22c: after a corrupt spill the ids differ "
                                 "from a server holding the verified blocks")
        st3 = pf.stats_snapshot()
        secs = pf.tier_seconds
        report["22c"] = {
            "pool_blocks": pf.pool_blocks,
            "after_imports": {k2: st[k2] for k2 in (
                "tier_demoted_blocks", "tier_host_blocks",
                "tier_disk_blocks")},
            "evicted_first_blocks": evicted, "promoted_blocks": promoted,
            "promoted_from_disk": from_disk,
            "promote_checksum_failures": sound_failures,
            "again_equal_first": True, "again_paths": again_paths,
            "corrupt_blocks_served": held,
            "corrupt_checksum_failures": failures,
            "corrupt_equal_verified_reference": True,
            **{k2: st3[k2] for k2 in (
                "tier_demoted_blocks", "tier_promoted_blocks",
                "tier_checksum_failures", "tier_host_blocks",
                "tier_disk_blocks", "tier_exhaust_drops",
                "tier_demote_errors", "prefix_evictions")},
            "demote_ms_per_block": secs["demote"] * 1e3 / max(
                st3["tier_demoted_blocks"], 1),
            "promote_ms_per_block": secs["promote"] * 1e3 / max(
                st3["tier_promoted_blocks"], 1),
            "page_bytes": pf.page_bytes, "s": time.perf_counter() - t22c}
    finally:
        for run in runs:
            run.close()
        runs.clear()
    if own:
        del model
    gc.collect()
    _empty_cache(device)
    report["b4_launches"] = waves.b4_launches + b4
    log("[ship] " + json.dumps(report))
    return waves.b4_launches + b4


# ---------------------------------------------------------------------------
# slice 18: request tracing, deadlines, SLOs, brownout, /metrics, /profile
# and the shadow auditor on the serving engines (phase 23, cell (ab))
# ---------------------------------------------------------------------------

# phase 23 on phase 4's artifact: cell (e)'s prompts as one ordered wave on an
# untraced and a traced server in turns (off, on, on, off); the deadline
# probes (a ``deadline_ms`` budget against a ``slow_ms`` sleep of the third
# scheduler round); a ``burst`` of ``burst_prompt``-token requests of
# ``burst_new`` tokens on 8 slots under brownout, a speculative request of
# draft ``spec`` inside it; ``audit_new`` greedy tokens for each of cell (e)'s
# 8 prompts on the f32 audit model, then the corrupt_page probe (a
# ``corrupt_prompt``-token prompt and its extension); the profile closes
# after ``profile_steps`` scheduler chunks (or ``profile_timeout_s``); the
# ladder holds a level ``brownout_dwell_s`` before it may step down: longer
# than the burst's tail, so the scrapes at idle (not its last rounds) bring
# the level down (at 0.5 s and at 2 s it fell during the tail on an H100)
OBS_SIZES = {"burst": 16, "burst_prompt": 128, "burst_new": 32, "spec": 4,
             "audit_new": 16, "corrupt_prompt": 256, "deadline_ms": 1500,
             "slow_ms": 2000, "deadline_new": 64, "profile_steps": 4,
             "profile_timeout_s": 60, "brownout_dwell_s": 4.0}
# the audit's hard check runs in f32 (bf16 batched paged waves and batch-1
# replays legitimately flip a greedy argmax now and then): Mistral at its
# widths cut to 2 layers, as phase 19b builds it
OBS_AUDIT_ARCH = {"n_layer": 2, "bfloat16": False}
# SLO thresholds below any TTFT the card gives: every served request breaches
OBS_SLO_S = 1e-6
# a divergence whose top-2 logit gap at the first differing token is within
# this share of the logits' scale is a tie (f32 summation order), not a fault
OBS_TIE_REL = 1e-5
# B4's kernel symbols (csrc/paged_attn.cu), looked for in the profile
B4_SYMBOLS = ("paged_attn_kernel", "paged_combine_kernel", "paged_attn_wgmma",
              "paged_attn_decode")


def _sync_counted_wave(label, waves: ServeWave, run: ServeRun, bodies,
                       sizes, device) -> dict:
    """One ordered wave of ``bodies`` (counted by ``waves``) with
    ``torch.cuda.set_sync_debug_mode("warn")`` on: every synchronising call
    of the engine thread is a warning, counted per scheduler round and
    keyed by what the round did (decode chunks, admission calls, streamed
    prefill chunks), so two servers' rounds of one kind compare."""
    import warnings

    svc = run.service
    is_cuda = torch.device(device).type == "cuda"
    rounds, box = [], {"w": []}
    tick = svc._tick

    def counted(pending):
        st = svc.stats
        n0 = len(box["w"])
        k0 = (st["chunks"], st["admit_calls"], st["prefill_chunks"])
        try:
            tick(pending)
        finally:
            key = (st["chunks"] - k0[0], st["admit_calls"] - k0[1],
                   st["prefill_chunks"] - k0[2])
            rounds.append((key, len(box["w"]) - n0))

    def drive():
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            box["w"] = w
            if is_cuda:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                return _ordered_wave(run, bodies)
            finally:
                if is_cuda:
                    torch.cuda.set_sync_debug_mode(0)

    svc._tick = counted
    try:
        results = waves.run(label, svc, drive, sizes["new"])
    finally:
        del svc._tick
    ticks = sum(k[0] for k, _ in rounds)
    syncs = sum(n for _, n in rounds)
    n_new = sum(len(r["ids"]) - r["first_delta"] for r in results)
    return {"ids": [r["ids"] for r in results], "rounds": rounds,
            "ttft_ms": sum(r["ttft_s"] for r in results) * 1e3
            / len(results),
            "ms_per_token": sum((r["total_s"] - r["ttft_s"])
                                for r in results) * 1e3 / max(n_new, 1),
            "syncs": syncs, "decode_ticks": ticks,
            "syncs_per_decode_tick": syncs / max(ticks, 1)}


def _capture_during(run: ServeRun, sizes, request) -> tuple:
    """``POST /profile`` in a thread; once its capture holds the
    profiler, a second ``POST /profile`` (which must meet 409), then
    ``request()``, whose chunks the window sees. Returns the capture's
    response, the second's and the request's."""
    import threading

    box = {}
    pt = threading.Thread(target=lambda: box.update(r=_post_any(
        run, f"/profile?steps={sizes['profile_steps']}&timeout_s="
             f"{sizes['profile_timeout_s']}", {})), daemon=True)
    pt.start()
    busy = run.server.RequestHandlerClass.profiler._lock
    _wait_for(lambda: busy.locked() or not pt.is_alive(),
              "the profile capture to start")
    second = _post_any(run, "/profile?steps=0", {})
    during = request()
    pt.join(600)
    return box["r"], second, during


def _profile_report(response, second) -> dict:
    """A ``POST /profile`` response and its trace file: the event count by
    category and B4's kernel events by symbol."""
    status, _, raw, _ = response
    out = json.loads(raw)
    events = json.loads(Path(out["trace_file"]).read_text()).get(
        "traceEvents") or []
    cats = {}
    for e in events:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    return {"status": status, "second": second[0],
            "steps_observed": out.get("steps_observed"),
            "events": len(events), "by_category": cats,
            "b4_events": sum(any(sym in str(e.get("name", ""))
                                 for sym in B4_SYMBOLS) for e in events)}


def _path_level(fp: str) -> int:
    """The brownout level a serve-path fingerprint carries (its ``b<n>``
    token; 0 without one)."""
    return max((int(t[1:]) for t in fp.split("_")
                if t[:1] == "b" and t[1:].isdigit()), default=0)


def _audit_drain(run: ServeRun, timeout: float = 600.0) -> dict:
    """Wait for the server's shadow auditor to finish its replays; its
    counters."""
    auditor = run.server.RequestHandlerClass.auditor
    if not auditor.drain(timeout):
        raise AssertionError("the shadow auditor did not drain")
    return auditor.stats()


def _divergence_margin(model, bundle: dict) -> dict:
    """The top-2 logit gap where a divergence bundle's served and replayed
    ids first differ (the reference's prefix fed plainly), against the
    logits' scale."""
    i = bundle["first_divergence"]
    ids = bundle["prompt_ids"] + bundle["replay_ids"][:i]
    with torch.no_grad():
        logits = model(torch.tensor([ids], device=model.device))[0, -1]
    top = torch.topk(logits.float(), 2).values
    gap = (top[0] - top[1]).item()
    scale = logits.abs().max().item()
    return {"first_divergence": i, "top2_gap": gap, "logit_scale": scale,
            "tie": gap <= OBS_TIE_REL * scale}


def phase_serve_observe(card: str, model_path, config=SERVE_CONFIG,
                        device="cuda", work=WORK, sizes=None, seed: int = 0,
                        arch=MAIN_ARCH, arch_args=None, model=None,
                        audit_arch=None) -> dict:
    """23: the observability layer and brownout on phase 4's artifact
    (``MAIN_ARGS``; ``model``: its weights already loaded) through the
    port's ``serve.py`` in this process. Hard checks:

    1. cell (e)'s prompts as ordered waves on a ``--reqtrace off`` server
       and a traced one (the defaults, ``--slo-ttft-s`` / ``--slo-e2e-s``
       set) in turns: equal ids wave for wave, and no scheduler round of
       the traced server makes more synchronising calls than one of the
       same kind on the untraced server (TTFT and ms/token reported);
    2. ``X-Deadline-Ms: tomorrow`` a 400, ``1`` a 504 with
       ``X-Deadline-Expired: 1``, a budget that runs out in a
       ``slow_decode`` round a 200 with the header, ``stop_reason:
       "deadline"`` and fewer tokens; ``deadline_expired_total`` +2;
    3. every served request of the traced server breaches its SLO, and a
       ``slow_request_<rid>.json`` holds a span timeline;
    4. ``--brownout on --brownout-queue-norm 0.5`` under the burst: the
       level rises, a speculative request is served without speculation on
       a ``b<level>`` path, burst requests carry ``b<level>``, and the
       level falls to 0 through ``/metrics`` scrapes;
    5. the Prometheus text lints clean with the SLO, brownout, serve-path
       and histogram families;
    6. ``POST /profile?steps=4`` during the burst answers 200 with B4's
       kernels in its trace (on the card), a second capture 409;
    7. the f32 audit model (``audit_arch``) audited at rate 1 over 8 greedy
       requests: all matched (a divergence at tie level is reported);
       ``corrupt_page`` armed after ``faults.reset()`` is caught: a
       divergence, ``/healthz`` degraded, a bundle; the bf16 artifact's
       verdict (the brownout server audits at floor 1) is reported;
    8. B4 launched n_layer x the model calls of each server, B1 n_layer x
       the audit replays (their plain prefills), nothing else.

    Returns ``{"paged_attn": B4 launches, "flash_fwd": B1 launches}``."""
    from pytorch_distributed_template_tpu_torch.config.registry import (
        MODELS,
    )
    from pytorch_distributed_template_tpu_torch.engine.serving import (
        load_serving_model,
    )
    from pytorch_distributed_template_tpu_torch.ops.flash import (
        FLASH_FWD, PAGED_ATTN,
    )
    from pytorch_distributed_template_tpu_torch.resilience import faults
    from pytorch_distributed_template_tpu_torch.utils.promtext import (
        lint_exposition,
    )
    import threading

    sizes = {**SERVE_SIZES, **OBS_SIZES, **(sizes or {})}
    args = dict(MAIN_ARGS if arch_args is None else arch_args)
    t_phase = time.perf_counter()
    own = model is None
    if own:
        model = load_serving_model({"type": arch, "args": args}, model_path,
                                   device, verify=False)
    n_layer = model.n_layer
    prompts = _cell_e_prompts(model.vocab_size, sizes, seed)
    gen = torch.Generator().manual_seed(seed + 23)
    is_cuda = torch.device(device).type == "cuda"

    def fresh(n):
        return torch.randint(0, model.vocab_size, (n,),
                             generator=gen).tolist()

    def argv(name, cfg, *extra):
        return ["-r", str(model_path), "-c", str(cfg), "-s",
                str(work / "observe" / name), "--port", "0", "--max-batch",
                str(sizes["slots"]), "--decode-chunk", str(sizes["chunk"]),
                "--device", str(device)] + list(extra)

    runs = []

    def serve(name, m, *extra, cfg=config):
        runs.append(ServeRun(argv(name, cfg, *extra), model=m))
        return runs[-1]

    report = {"card": card}
    b4 = b1 = 0
    try:
        # ---- 1: the cost of tracing, waves in turns ----------------------
        off = serve("untraced", model, "--reqtrace", "off")
        on = serve("traced", model, "--slo-ttft-s", str(OBS_SLO_S),
                   "--slo-e2e-s", str(OBS_SLO_S))
        waves = ServeWave(card, device)
        bodies = [{"prompt_ids": p, "max_new_tokens": sizes["new"]}
                  for p in prompts]
        turns = {label: _sync_counted_wave(label, waves, run, bodies, sizes,
                                           device)
                 for label, run in (("off_1", off), ("on_1", on),
                                    ("on_2", on), ("off_2", off))}
        b4 += waves.b4_launches
        for a, b in (("off_1", "on_1"), ("off_2", "on_2")):
            if turns[a]["ids"] != turns[b]["ids"]:
                raise AssertionError(f"23: the traced wave {b}'s ids differ "
                                     f"from the untraced {a}'s")
        kinds = {}
        for label, t in turns.items():
            side = label.split("_")[0]
            for key, n in t["rounds"]:
                kinds.setdefault(key, {}).setdefault(side, []).append(n)
        worse = {str(k): v for k, v in kinds.items()
                 if "on" in v and "off" in v and max(v["on"]) > max(v["off"])}
        if worse:
            raise AssertionError(f"23: traced rounds synchronise more than "
                                 f"untraced ones of the same kind: {worse}")
        report["tracing"] = {
            label: {k: t[k] for k in ("ttft_ms", "ms_per_token", "syncs",
                                      "decode_ticks",
                                      "syncs_per_decode_tick")}
            for label, t in turns.items()}
        report["tracing"]["round_kinds_compared"] = sum(
            "on" in v and "off" in v for v in kinds.values())
        if not is_cuda:
            report["tracing"]["syncs"] = "not measured (no card)"
        off.close()
        runs.remove(off)
        # ---- 2: deadlines --------------------------------------------------
        svc = on.service
        m0 = _metrics(on)
        probe = {"prompt_ids": fresh(sizes["burst_prompt"]),
                 "max_new_tokens": sizes["deadline_new"]}
        bad = _post_any(on, "/generate", probe, {"X-Deadline-Ms": "tomorrow"})
        spent = _post_any(on, "/generate", probe, {"X-Deadline-Ms": "1"})
        faults.reset()
        faults.configure(f"slow_decode@tick:{svc.stats['chunks'] + 2}:"
                         f"{sizes['slow_ms']}ms")
        try:
            cut = _post_any(on, "/generate", dict(
                probe, prompt_ids=fresh(sizes["burst_prompt"])),
                {"X-Deadline-Ms": str(sizes["deadline_ms"])})
        finally:
            faults.reset()
        cut_out = json.loads(cut[2])
        m1 = _metrics(on)
        expired = (m1["deadline_expired_total"]
                   - m0["deadline_expired_total"])
        report["deadlines"] = {
            "tomorrow": bad[0], "one_ms": spent[0],
            "one_ms_header": spent[1].get("X-Deadline-Expired"),
            "mid_decode": cut[0],
            "mid_decode_header": cut[1].get("X-Deadline-Expired"),
            "mid_decode_stop_reason": cut_out.get("stop_reason"),
            "mid_decode_tokens": len(cut_out.get("ids") or ()),
            "asked": sizes["deadline_new"], "deadline_expired": expired}
        d = report["deadlines"]
        if not (d["tomorrow"] == 400 and d["one_ms"] == 504
                and d["one_ms_header"] == "1" and d["mid_decode"] == 200
                and d["mid_decode_header"] == "1"
                and d["mid_decode_stop_reason"] == "deadline"
                and 0 < d["mid_decode_tokens"] < d["asked"]
                and expired == 2):
            raise AssertionError(f"23: deadlines {d}")
        # ---- 3 and 5: SLOs and the Prometheus text -------------------------
        served = 2 * len(bodies)
        dumps = sorted(on.run_dir.rglob("slow_request_*.json"))
        timeline = (json.loads(dumps[0].read_text()).get("timeline")
                    if dumps else None)
        report["slo"] = {k: m1[k] for k in (
            "slo_breach_total", "slo_ttft_breach_total",
            "slo_e2e_breach_total", "slo_dumps_written")}
        report["slo"]["served"] = served
        if not (m1["slo_breach_total"] == served and timeline):
            raise AssertionError(f"23: SLO {report['slo']}, dumps {dumps}")
        text = _http_get(on, "/metrics")
        fams = {line.split()[2] for line in text.splitlines()
                if line.startswith("# TYPE ")}
        lint = lint_exposition(text)
        need = ["pdt_serve_slo_breach_total", "pdt_serve_brownout_level",
                "pdt_serve_ttft_seconds", "pdt_serve_e2e_seconds"]
        if (lint or not all(f in fams for f in need)
                or not any(f.startswith("pdt_serve_serve_path_")
                           for f in fams)
                or f"# TYPE pdt_serve_ttft_seconds histogram" not in text):
            raise AssertionError(f"23: /metrics lint {lint}, families "
                                 f"{sorted(fams)}")
        report["metrics"] = {"families": len(fams), "lint_violations": 0}
        on.close()
        runs.remove(on)
        # ---- 4 and 6: brownout under a burst, /profile inside it -----------
        bo = serve("brownout", model, "--brownout", "on",
                   "--brownout-queue-norm", "0.5", "--brownout-dwell-s",
                   str(sizes["brownout_dwell_s"]), "--audit", "on",
                   "--audit-sample-rate", "0.01", "--audit-floor", "1")
        svc = bo.service
        _sync(device)
        _zero_counts()
        calls0 = svc.stats["model_calls"]
        burst = [{"prompt_ids": fresh(sizes["burst_prompt"]),
                  "max_new_tokens": sizes["burst_new"]}
                 for _ in range(sizes["burst"])]
        box = {}

        def run_burst():
            box["r"] = _concurrent(lambda b: stream_request(bo, b), burst)

        th = threading.Thread(target=run_burst, daemon=True)
        th.start()
        _wait_for(lambda: svc.brownout_level >= 1 or not th.is_alive(),
                  "the brownout level to rise")
        level = svc.brownout_level
        captured, second, spec = _capture_during(bo, sizes, lambda: _post_any(
            bo, "/generate", {"prompt_ids": fresh(sizes["burst_prompt"]),
                              "max_new_tokens": sizes["burst_new"],
                              "speculative": sizes["spec"]}))
        th.join(1200)
        spec_out = json.loads(spec[2])
        paths = [r["serve_path"] for r in box.get("r") or ()]
        browned = [fp for fp in paths if _path_level(fp)]
        # the profile: B4's kernels by symbol in the trace file (a capture
        # that holds none is reported and taken once more, around one
        # more request)
        report["profile"] = _profile_report(captured, second)
        if is_cuda and not report["profile"]["b4_events"]:
            log("[observe] a capture without B4 kernel events: "
                + json.dumps(report["profile"]))
            again, second, _ = _capture_during(bo, sizes, lambda: _post_any(
                bo, "/generate", {"prompt_ids": fresh(sizes["burst_prompt"]),
                                  "max_new_tokens": sizes["burst_new"]}))
            report["profile"] = dict(_profile_report(again, second),
                                     first=report["profile"])
        p23 = report["profile"]
        if not (p23["status"] == 200 and p23["second"] == 409
                and p23["events"] and (p23["b4_events"] or not is_cuda)):
            raise AssertionError(f"23: /profile {p23}")
        if not is_cuda:
            p23["b4_events"] = "not measured (no card)"
        # idle: the ladder falls one level per dwell through the scrapes
        level_idle = svc.brownout_level
        decay_t0 = time.perf_counter()
        while _metrics(bo)["brownout_level"] > 0:
            if time.perf_counter() - decay_t0 > 60:
                raise AssertionError("23: the brownout level did not fall "
                                     "to 0 after the burst")
            time.sleep(0.1)
        decay_s = time.perf_counter() - decay_t0
        stats_bo = _audit_drain(bo)
        _sync(device)
        calls = svc.stats["model_calls"] - calls0
        sp_fp = spec_out.get("serve_path", "")
        report["brownout"] = {
            "level_seen": level, "level_at_idle": level_idle,
            "peak": _metrics(bo).get("brownout_peak_level"),
            "spec_path": sp_fp,
            "spec_stripped": "speculative" not in spec_out,
            "burst_paths": sorted(set(paths)),
            "burst_browned_out": len(browned), "decay_s": decay_s,
            "clamped": svc.stats["brownout_clamped"]}
        if not (level >= 1 and level_idle >= 1
                and len(paths) == sizes["burst"] and browned
                and spec[0] == 200 and "speculative" not in spec_out
                and "spec" not in sp_fp.split("_")
                and _path_level(sp_fp) >= 1):
            raise AssertionError(f"23: brownout {report['brownout']}")
        replays = stats_bo["audit_sampled_total"]
        if (PAGED_ATTN.launches != n_layer * calls or calls == 0
                or FLASH_FWD.launches != n_layer * replays):
            raise AssertionError(
                f"23 brownout: B4 {PAGED_ATTN.launches} for {calls} model "
                f"calls, B1 {FLASH_FWD.launches} for {replays} replays "
                f"({n_layer} layers)")
        b4 += PAGED_ATTN.launches
        b1 += FLASH_FWD.launches
        report["audit_bf16"] = {k: stats_bo[k] for k in (
            "audit_sampled_total", "audit_matched_total",
            "token_divergence_total", "audit_error_total")}
        bo.close()
        runs.remove(bo)
        # ---- 7: the auditor on the f32 model -------------------------------
        a_args = dict(args, **(OBS_AUDIT_ARCH if audit_arch is None
                               else audit_arch))
        m32 = MODELS.get(arch)(**a_args, device=device)
        m32.init_weights(torch.Generator(device=device).manual_seed(seed + 3))
        m32.eval()
        cfg = json.loads(Path(config).read_text())
        cfg["arch"] = {"type": arch, "args": a_args}
        cfg32 = work / "observe" / "audit32.json"
        cfg32.parent.mkdir(parents=True, exist_ok=True)
        cfg32.write_text(json.dumps(cfg))
        a32 = serve("audit32", m32, "--audit", "on", "--audit-sample-rate",
                    "1.0", "--audit-floor", "1", cfg=cfg32)
        svc = a32.service
        _sync(device)
        _zero_counts()
        calls0 = svc.stats["model_calls"]
        clean = _ordered_wave(a32, [{"prompt_ids": p,
                                     "max_new_tokens": sizes["audit_new"]}
                                    for p in prompts])
        stats_a = _audit_drain(a32)
        report["audit_f32"] = {k: stats_a[k] for k in (
            "audit_sampled_total", "audit_matched_total",
            "token_divergence_total", "audit_error_total")}
        if stats_a["token_divergence_total"]:
            bundle = json.loads(sorted(a32.run_dir.rglob(
                "divergence_*.json"))[0].read_text())
            margin = _divergence_margin(m32, bundle)
            report["audit_f32"]["margin"] = margin
            if not margin["tie"]:
                raise AssertionError(f"23: the f32 audit diverged: "
                                     f"{report['audit_f32']}")
        if stats_a["audit_sampled_total"] != len(clean) or \
                stats_a["audit_error_total"]:
            raise AssertionError(f"23: the f32 audit {report['audit_f32']}")
        # corrupt_page: armed after reset (a previous adoption must not
        # have taken the ordinal); the first adoption's block is overwritten
        # before the next round, and the extension reads it
        q = fresh(sizes["corrupt_prompt"])
        faults.reset()
        faults.configure("corrupt_page@evt:1")
        try:
            for ids in (q, q + fresh(8)):
                stream_request(a32, {"prompt_ids": ids,
                                     "max_new_tokens": sizes["audit_new"]})
        finally:
            faults.reset()
        stats_c = _audit_drain(a32)
        health = json.loads(_http_get(a32, "/healthz"))
        bundles = sorted(a32.run_dir.rglob("divergence_*.json"))
        report["audit_corrupt"] = {
            "divergences": stats_c["token_divergence_total"]
            - stats_a["token_divergence_total"],
            "healthz": health["status"], "bundles": len(bundles)}
        if not (report["audit_corrupt"]["divergences"] >= 1
                and health["status"] == "degraded" and bundles):
            raise AssertionError(f"23: corrupt_page not caught: "
                                 f"{report['audit_corrupt']}")
        _sync(device)
        calls = svc.stats["model_calls"] - calls0
        replays = stats_c["audit_sampled_total"]
        if (PAGED_ATTN.launches != m32.n_layer * calls or calls == 0
                or FLASH_FWD.launches != m32.n_layer * replays):
            raise AssertionError(
                f"23 audit: B4 {PAGED_ATTN.launches} for {calls} model "
                f"calls, B1 {FLASH_FWD.launches} for {replays} replays "
                f"({m32.n_layer} layers)")
        b4 += PAGED_ATTN.launches
        b1 += FLASH_FWD.launches
        a32.close()
        runs.remove(a32)
        del m32
    finally:
        for run in runs:
            run.close()
        runs.clear()
        faults.reset()
    if own:
        del model
    gc.collect()
    _empty_cache(device)
    report.update(b4_launches=b4, b1_launches=b1,
                  s=time.perf_counter() - t_phase)
    log("[observe] " + json.dumps(report))
    return {"paged_attn": b4, "flash_fwd": b1}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name} | nvidia-smi: {card}")
    t_start = time.perf_counter()
    times = {}

    def timed(phase, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        times[phase] = time.perf_counter() - t0
        log(f"[time] phase {phase}: {times[phase]:.1f} s | {card}")
        return out

    from pytorch_distributed_template_tpu_torch.data import native

    timed("1", phase_build)
    rows = timed("2", phase_kernel)
    paged_rows = timed("2b", phase_paged_kernel)
    bwd_rows = timed("2c", phase_bwd_kernel)
    ffn_rows = timed("2d", phase_expert_ffn_kernel)
    timed("3", phase_reference)
    timed("3b", phase_paged_reference)
    timed("3c", phase_train_reference)
    timed("3d", phase_moe_train_reference)
    timed("3e", lambda: (phase_optim_reference(), phase_optim_full(card)))
    flash_launches = timed("4", phase_main, card, arch_args=MAIN_ARGS,
                           keep_artifact=True)
    # the serving config with the artifact's depth (``-c`` overlays arch)
    serve_cfg = _serve_config(SERVE_CONFIG, MAIN_ARGS, WORK / "serve.json")
    served = {}
    paged_launches = timed("5", phase_serve, card, WORK / "art" / "model",
                           config=serve_cfg, record=served)
    train_launches = timed("6", phase_train, card, keep=GPT2_BASE)
    moe_launches = timed("7", phase_moe_train, card, keep=MOELM_KEEP)
    timed("8", phase_lenet_reference)
    timed("9", phase_mnist, card)
    obs_launches = timed("10", phase_observe, card)
    res_launches = timed("11", phase_resilience, card)
    native.CALLS.reset()
    lm_launches = timed("12", phase_lm_configs, card,
                        keep_data=WORK / "bert_keep" / "data",
                        keep_byte=BYTELM_KEEP)
    gathers = {"12": native.CALLS.calls}
    native.CALLS.reset()
    timed("13", phase_digits, card)
    gathers["13"] = native.CALLS.calls
    timed("14a", phase_seq_ops, card)
    rows += timed("14a-kernels", phase_kernel, SEQ_KERNEL_SHAPES)
    bwd_rows += timed("14a-bwd", phase_bwd_kernel, SEQ_BWD_SHAPES)
    seq_launches = timed("14b", phase_seq_train, card)
    timed("14c", phase_seq_nccl, card)
    timed("15a", phase_image_reference)
    rows += timed("15b", phase_kernel, VIT_KERNEL_SHAPES)
    bwd_rows += timed("15b-bwd", phase_bwd_kernel, VIT_BWD_SHAPES)
    timed("15c", phase_cifar, card)
    timed("15d", phase_resnet50, card)
    vit_launches = timed("15e", phase_vit, card)
    timed("15f", phase_seq_nccl, card, runs=IMAGE_NCCL,
          common=IMAGE_NCCL_COMMON, corpus_bytes=0, tag="image_nccl")
    timed("16a", phase_bert_reference)
    rows += timed("16b", phase_kernel, BERT_KERNEL_SHAPES)
    bwd_rows += timed("16b-bwd", phase_bwd_kernel, BERT_BWD_SHAPES)
    bert_launches = timed("16c-16d", phase_bert_mlm, card)
    cls_launches = timed("16e", phase_bert_cls, card)
    lora_launches = timed("16f", phase_lora_gpt2, card, drop_base=False)
    llama_launches = timed("16g", phase_lora_llama, card)
    timed("17a", phase_pipe_reference)
    pp_launches = timed("17b", phase_pp_train, card)
    timed("17c", phase_pp_nccl, card)
    timed("17d", phase_hf_import, card, drop_base=False)
    rows += timed("18a", phase_kernel, TP_KERNEL_SHAPES)
    bwd_rows += timed("18a-bwd", phase_bwd_kernel, TP_BWD_SHAPES)
    tp_rows = timed("18b", phase_tp_nccl, card)
    tp_rows.update({f"full_{k}": v for k, v in
                    timed("18c", phase_tp_full, card).items()})
    # rank 0's launches in the 18b/18c ranks (other processes)
    tp_launches = dict(zip(FLASH_KERNELS, (
        sum(row["launches_per_rank"][0][i] for row in tp_rows.values())
        for i in range(3))))
    rows += timed("19a", phase_kernel, TP_SERVE_KERNEL_SHAPES)
    paged_rows += timed("19a-paged", phase_paged_kernel, TP_PAGED_SHAPES)
    serve_rows = list(timed("19b", phase_tp_serve, card).values())
    serve_rows += [r for r in timed(
        "19c", phase_tp_serve_full, card, WORK / "art" / "model",
        config=serve_cfg).values() if "launches_here" in r]
    # the card-0 process's launches in 19b/19c (rank 0 of a TP group)
    serve_launches = _rank0_launches(serve_rows)
    paged_launches += serve_launches["paged_attn"]
    flash_launches += serve_launches["flash_fwd"]
    paged_launches += timed("20a", phase_moe_serve, card)["paged_attn"]
    ep_rows = timed("20b", phase_ep_nccl, card)
    ep_rows.update({f"full_{k}": v for k, v in
                    timed("20c", phase_ep_full, card).items()})
    # rank 0's launches in the 20b/20c ranks
    for i, kern in enumerate(FLASH_KERNELS):
        tp_launches[kern] += sum(row["launches_per_rank"][0][i]
                                 for row in ep_rows.values())
    t21 = time.perf_counter()
    rows += timed("21a-kernels", phase_kernel, GPT2_SERVE_KERNEL_SHAPES)
    ffn_rows += timed("21a-ffn", phase_expert_ffn_kernel, FFN_DECODE_SHAPES)
    timed("21a", phase_gpt2_serve_reference)
    gen21 = timed("21b", phase_gpt2_generate, card)["launches"]
    static21 = timed("21b-serve", phase_gpt2_static_serve, card)
    byte21 = timed("21c", phase_bytelm_quant, card)
    moe21 = timed("21d", phase_moelm_generate, card)
    paged_launches += timed("21e", phase_mistral_w8a16, card,
                            WORK / "art" / "model")
    timed("22a", phase_ship_reference)
    # phases 22 and 23 serve one load of phase 4's artifact
    from pytorch_distributed_template_tpu_torch.engine.serving import (
        load_serving_model,
    )

    art = timed("22-load", load_serving_model,
                {"type": MAIN_ARCH, "args": MAIN_ARGS}, WORK / "art" / "model",
                "cuda", verify=False)
    paged_launches += timed("22", phase_ship, card, WORK / "art" / "model",
                            config=serve_cfg, cold=served["e_ids"],
                            model=art)
    observed = timed("23", phase_serve_observe, card, WORK / "art" / "model",
                     config=serve_cfg, model=art)
    del art
    gc.collect()
    torch.cuda.empty_cache()
    paged_launches += observed["paged_attn"]
    flash_launches += observed["flash_fwd"]
    slice16 = {k: gen21[k] + static21[k] + byte21[k] + moe21[k]
               for k in ("flash_fwd", "expert_ffn")}
    flash_launches += slice16["flash_fwd"]
    moe_launches["expert_ffn"] += slice16["expert_ffn"]
    log(f"[time] phase 21 in {time.perf_counter() - t21:.1f} s | {card}; "
        f"launches " + json.dumps(slice16))
    if any(pp_launches.values()):
        raise AssertionError(f"the pipelined trunk launched a kernel: "
                             f"{pp_launches}")
    log("[native] gathers " + json.dumps(gathers))
    if not all(gathers.values()):
        raise AssertionError(f"the native batcher did not gather in every "
                             f"phase: {gathers}")
    log("[time] " + json.dumps({"phases_s": times, "card": card}))
    shutil.rmtree(WORK)
    log(f"[device] all phases in {time.perf_counter() - t_start:.1f} s")
    kernels = []
    for kern in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        train_launches[kern] += (obs_launches[kern] + res_launches[kern]
                                 + lm_launches[kern] + seq_launches[kern]
                                 + vit_launches[kern] + bert_launches[kern]
                                 + cls_launches[kern] + lora_launches[kern]
                                 + llama_launches[kern] + tp_launches[kern])
    flash_launches += train_launches["flash_fwd"] + moe_launches["flash_fwd"]
    for kernel, source, replaces, launches, shapes in (
            ("flash_fwd", KERNEL_SOURCE, KERNEL_REPLACES, flash_launches,
             rows),
            ("paged_attn", PAGED_SOURCE, PAGED_REPLACES, paged_launches,
             paged_rows),
            *((kern, BWD_SOURCE, BWD_REPLACES[kern],
               train_launches[kern] + moe_launches[kern],
               [r for r in bwd_rows if r["kernel"] == kern])
              for kern in ("flash_bwd_dkv", "flash_bwd_dq")),
            ("expert_ffn", FFN_SOURCE, FFN_REPLACES,
             moe_launches["expert_ffn"], ffn_rows)):
        head = shapes[0]
        kernels.append({
            "name": kernel, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            "ms": head["kernel_ms"], "plain_ms": head["ref_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "pct_of_bound": head["pct_of_bound"],
            "x_library": head["x_library"], "shapes": shapes})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sp-child"]:
        sys.exit(seq_child(sys.argv[2]))
    if sys.argv[1:2] == ["--tp-child"]:
        sys.exit(tp_child(sys.argv[2]))
    if sys.argv[1:2] == ["--tp-serving"]:
        sys.exit(tp_serving_main())
    if sys.argv[1:2] == ["--moe-ep"]:
        sys.exit(moe_ep_main())
    sys.exit(main())
