"""PyTorch/CUDA port of the Point-NeRF system in pointnerf2studio_tpu.

The JAX package beside it is the reference; each module here mirrors its
counterpart's path. Hand-written CUDA kernels live in `csrc/` and are
built with nvcc for sm_90a at first use (ops/_cuda.py). This package
never imports JAX.
"""
