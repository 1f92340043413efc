"""Tensor operations, with the hand-written CUDA kernels beside their plain versions."""
