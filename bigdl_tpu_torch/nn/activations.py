"""Activations (counterpart of ``bigdl_tpu/nn/activations.py``)."""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Module

__all__ = ["ReLU", "LogSoftMax"]


class ReLU(Module):
    def forward(self, x):
        return torch.relu(x)


class LogSoftMax(Module):
    """Log-probabilities over the last axis, always in (at least) f32."""

    def forward(self, x):
        f32 = torch.promote_types(x.dtype, torch.float32)
        return torch.log_softmax(x.to(f32), dim=-1)
