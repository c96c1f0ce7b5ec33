"""PyTorch/CUDA port of `repro` for NVIDIA Hopper.

Keeps the JAX package's subpackage layout (`configs`, `core`, `kernels`,
`models`, `obs`, `serve`, `launch`) so that every module's counterpart is
found under the same path.  Imports `torch`, never `jax` or `repro`.
"""
