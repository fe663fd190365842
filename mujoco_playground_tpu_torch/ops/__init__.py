"""Kernels (hand-written CUDA for Hopper) and their plain PyTorch twins."""
