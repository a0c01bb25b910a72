"""PyTorch/CUDA port of automodel_tpu for NVIDIA Hopper (H100).

The package mirrors ``automodel_tpu``'s layout (ops, models, training, optim, data,
config, loggers, utils, recipes) and keeps its public signatures and tensor layouts.
Hand-written CUDA kernels live in ``csrc/`` and are built and bound by ``kernels/``.
It imports torch, numpy and the standard library, never JAX or ``automodel_tpu``.
"""
