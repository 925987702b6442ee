"""Tensor ops of the render path, plus the hand-written CUDA tonemap
kernel (ops/tonemap.py)."""
