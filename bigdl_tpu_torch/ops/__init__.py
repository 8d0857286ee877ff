"""Kernels of the port (counterpart of ``bigdl_tpu/ops/pallas``): each
module holds a wrapper that launches a hand-written Hopper kernel on CUDA
tensors and its plain PyTorch version for CPU tensors. Shared numeric
helpers (counterpart of ``bigdl_tpu/ops/__init__.py``) live here."""
from __future__ import annotations

import torch

__all__ = ["pow_neg_beta", "padded_head_dim"]

#: head dims the attention kernels are built for; past 256 the flash
#: kernels and the paged row-tile kernel take every multiple of 64
_BUILT_HEAD_DIMS = (32, 64, 128, 192, 256)


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


def padded_head_dim(d: int) -> int:
    """The head dim the attention kernels run a D-wide call at: the
    smallest of (32, 64, 128, 192, 256) not below D, past 256 the next
    multiple of 64 (D 16 -> 32, 96 -> 128, 288 -> 320). Flash pads q, k
    and v to it on the host; the paged kernels stage zeros up to it
    (``built_dim`` in csrc/paged_attention.cu). Zero columns add exact
    zeros to every q·k, so the scores are those of a D-wide kernel."""
    if d > 256:
        return -(-d // 64) * 64
    return next(w for w in _BUILT_HEAD_DIMS if w >= d)
