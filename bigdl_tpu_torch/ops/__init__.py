"""Kernels of the port (counterpart of ``bigdl_tpu/ops/pallas``): each
module holds a wrapper that launches a hand-written Hopper kernel on CUDA
tensors and its plain PyTorch version for CPU tensors."""
