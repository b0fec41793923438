"""PyTorch / CUDA port of the monocular SLAM main path of `morb_slam_tpu`.

The package mirrors the JAX package's module names. It imports torch, numpy
and scipy only: never `jax`, never `morb_slam_tpu`. Hand-written CUDA kernels
(`csrc/`) carry the per-frame device loops; each sits behind a wrapper that
runs the plain PyTorch version of the same function for CPU tensors.
"""
