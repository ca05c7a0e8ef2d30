"""PyTorch/CUDA port of geosplatting_tpu.

Mirrors the JAX package's layout (graphics/, ops/, models/, train/). Every
Pallas kernel of the JAX package is a hand-written CUDA kernel here
(``csrc/``), built at first use by ``_kernels``; each has a plain PyTorch
version beside it that runs for CPU tensors.
"""
