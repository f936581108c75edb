"""PyTorch/CUDA port of the serving system, beside the JAX package.

It mirrors the JAX package's module layout, imports nothing of it, and runs
its attention kernels as hand-written CUDA for Hopper (``csrc/``)."""
