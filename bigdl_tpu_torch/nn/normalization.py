"""LayerNorm and cross-map LRN (counterparts of ``LayerNorm``,
``SpatialCrossMapLRN`` and ``ReLUCrossMapLRN`` in
``bigdl_tpu/nn/normalization.py``)."""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn import init as init_mod
from bigdl_tpu_torch.nn.containers import Sequential
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops import lrn as lrn_ops
from bigdl_tpu_torch.tensor import resolve_device

__all__ = ["LayerNorm", "SpatialCrossMapLRN", "ReLUCrossMapLRN"]


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


class SpatialCrossMapLRN(Module):
    """Local response normalisation across channels (counterpart of
    ``SpatialCrossMapLRN`` in ``bigdl_tpu/nn/normalization.py``):
    y = x / (k + alpha/size · Σ_win x²)^beta over NCHW, through
    ``ops.lrn.lrn`` — the hand-written kernels on a CUDA tensor, their
    plain versions on a CPU one."""

    def __init__(self, size: int = 5, alpha: float = 1.0,
                 beta: float = 0.75, k: float = 1.0):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        return lrn_ops.lrn(x, self.size, self.alpha, self.beta, self.k)

    def extra_repr(self):
        return f"{self.size}, {self.alpha}, {self.beta}, {self.k}"


class ReLUCrossMapLRN(Sequential):
    """ReLU then ``SpatialCrossMapLRN`` in one pass over the activation
    (``ops.lrn.lrn(..., relu=True)``; counterpart of ``ReLUCrossMapLRN``
    in ``bigdl_tpu/nn/normalization.py``). A Sequential of the two
    parameterless children, so the tree and the child names are those of
    the two modules run in order, which it equals."""

    def __init__(self, relu: Module, lrn: SpatialCrossMapLRN):
        super().__init__(relu, lrn)

    def forward(self, x):
        m = self[1]
        return lrn_ops.lrn(x, m.size, m.alpha, m.beta, m.k, relu=True)
