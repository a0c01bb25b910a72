"""Mixture-of-Experts (counterpart of ``automodel_tpu/moe/``): routing, grouped experts
with the grouped GEMM kernels, the dense dispatcher, load-balance metrics."""
