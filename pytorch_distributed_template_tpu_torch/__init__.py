"""PyTorch/CUDA port of ``pytorch_distributed_template_tpu``.

The JAX package beside this one is the reference; this package mirrors its
module names and holds each ported module to it. It imports ``torch`` and
never ``jax`` or anything of the JAX package. Entry points run on CUDA
unless the caller passes ``device="cpu"`` (``--device cpu``).

Ported so far: one-shot generation (``generate.py`` ->
``engine.serving.GenerationService``) for the Llama family, with prefill
attention on the hand-written CUDA kernel ``csrc/flash_fwd.cu``.
"""
