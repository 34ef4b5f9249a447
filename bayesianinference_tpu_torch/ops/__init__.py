"""Numerical building blocks: NS bookkeeping, adaptive-Metropolis chains,
and the GP kernels (two of them hand-written CUDA)."""
