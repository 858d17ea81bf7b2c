"""Attention ops: plain PyTorch references and the hand-written CUDA
flash-attention forward kernel."""
