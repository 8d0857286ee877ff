"""LayerNorm (counterpart of ``LayerNorm`` in
``bigdl_tpu/nn/normalization.py``)."""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn import init as init_mod
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.tensor import resolve_device

__all__ = ["LayerNorm"]


class LayerNorm(Module):
    """Normalization over the trailing feature axis; statistics in f32,
    output in the input's dtype."""

    def __init__(self, n_output: int, eps: float = 1e-5, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.n_output, self.eps = n_output, eps
        self.weight = torch.nn.Parameter(
            init_mod.ones((n_output,), device=device))
        self.bias = torch.nn.Parameter(
            init_mod.zeros((n_output,), device=device))

    def forward(self, x):
        f32 = torch.promote_types(x.dtype, torch.float32)
        xs = x.to(f32)
        mean = xs.mean(dim=-1, keepdim=True)
        var = xs.var(dim=-1, unbiased=False, keepdim=True)
        y = (xs - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight.to(f32) + self.bias.to(f32)
        return y.to(x.dtype)
