"""Kernel library of the port: plain functions on tensors, each with a
hand-written CUDA kernel for the card and a plain PyTorch version for CPU
tensors."""
