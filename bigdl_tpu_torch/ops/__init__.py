"""Kernels of the port (counterpart of ``bigdl_tpu/ops/pallas``): each
module holds a wrapper that launches a hand-written Hopper kernel on CUDA
tensors and its plain PyTorch version for CPU tensors. Shared numeric
helpers (counterpart of ``bigdl_tpu/ops/__init__.py``) live here."""
from __future__ import annotations

import torch

__all__ = ["pow_neg_beta"]


def pow_neg_beta(s, beta: float):
    """s**(-beta) through square roots for the betas the model zoo uses:
    LRN's 0.75 is rsqrt(s)·sqrt(rsqrt(s)), 0.5 is rsqrt(s), 1 is 1/s;
    any other beta takes ``pow``. (The CUDA kernels of ``csrc/lrn.cu``
    branch the same way.)"""
    if beta == 0.75:
        r = torch.rsqrt(s)
        return r * torch.sqrt(r)
    if beta == 0.5:
        return torch.rsqrt(s)
    if beta == 1.0:
        return 1.0 / s
    return torch.pow(s, -beta)
