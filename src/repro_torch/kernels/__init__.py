"""Kernel layer: the hand-written CUDA kernels, their plain versions, backends."""
